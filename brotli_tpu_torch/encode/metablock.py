"""Metablock serialization: headers, uncompressed blocks, trivial path.

The full block-split/context-modeled path (storeMetaBlock) lives in
metablock_full.py; this module holds the shared header encoding and the
trivial single-block-type path (metablock.ts:222-389).
"""

from __future__ import annotations

from ..constants import (
    BLOCK_LENGTH_N_BITS,
    BLOCK_LENGTH_OFFSET,
    NUM_BLOCK_LEN_SYMBOLS,
    NUM_COMMAND_SYMBOLS,
    NUM_LITERAL_SYMBOLS,
)
from .bitwriter import BitWriter, store_var_len_uint8
from .command import Command, store_command_extra
from .entropy import build_and_store_huffman_tree

_BLEN_OFFSET = BLOCK_LENGTH_OFFSET.tolist()
_BLEN_NBITS = BLOCK_LENGTH_N_BITS.tolist()


def block_length_prefix_code(length: int) -> int:
    code = 20 if length >= 753 else (14 if length >= 177 else (7 if length >= 41 else 0))
    while code < NUM_BLOCK_LEN_SYMBOLS - 1 and length >= _BLEN_OFFSET[code + 1]:
        code += 1
    return code


def get_block_length_code(length: int) -> tuple[int, int, int]:
    code = block_length_prefix_code(length)
    return code, _BLEN_NBITS[code], length - _BLEN_OFFSET[code]


def encode_mlen(length: int) -> tuple[int, int, int]:
    """(bits_value, num_bits, mnibbles-4) for MLEN (metablock.ts:222-231)."""
    lg = 1 if length == 1 else (length - 1).bit_length()
    mnibbles = (16 if lg < 16 else lg + 3) // 4
    return length - 1, mnibbles * 4, mnibbles - 4


def store_compressed_metablock_header(w: BitWriter, is_last: bool, length: int) -> None:
    w.write(1, 1 if is_last else 0)
    if is_last:
        w.write(1, 0)  # not empty
    bits, num_bits, nibbles = encode_mlen(length)
    w.write(2, nibbles)
    w.write(num_bits, bits)
    if not is_last:
        w.write(1, 0)  # compressed


def store_uncompressed_metablock(
    w: BitWriter, data, position: int, mask: int, length: int, is_final: bool
) -> None:
    # header: ISLAST=0, MLEN, ISUNCOMPRESSED=1
    w.write(1, 0)
    bits, num_bits, nibbles = encode_mlen(length)
    w.write(2, nibbles)
    w.write(num_bits, bits)
    w.write(1, 1)
    w.align_to_byte()
    masked = position & mask
    if masked + length > mask + 1:  # ring wrap (streaming path)
        first = mask + 1 - masked
        w.write_bytes(bytes(data[masked : masked + first]))
        length -= first
        masked = 0
    w.write_bytes(bytes(data[masked : masked + length]))
    if is_final:
        w.write(1, 1)  # ISLAST
        w.write(1, 1)  # ISEMPTY
        w.align_to_byte()


def store_metablock_trivial(
    w: BitWriter,
    data,
    start_pos: int,
    length: int,
    mask: int,
    is_last: bool,
    commands: list[Command],
    dist_alphabet_size: int,
    npostfix: int = 0,
    ndirect: int = 0,
) -> None:
    """Single block type, no context modeling (metablock.ts:290-389)."""
    store_compressed_metablock_header(w, is_last, length)

    lit_hist = [0] * NUM_LITERAL_SYMBOLS
    cmd_hist = [0] * NUM_COMMAND_SYMBOLS
    dist_hist = [0] * dist_alphabet_size
    pos = start_pos
    for cmd in commands:
        cmd_hist[cmd.cmd_prefix] += 1
        for j in range(cmd.insert_len):
            lit_hist[data[(pos + j) & mask]] += 1
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        pos += copy_len
        if copy_len and cmd.cmd_prefix >= 128:
            dist_hist[cmd.dist_prefix & 0x3FF] += 1

    store_var_len_uint8(w, 0)  # NBLTYPESL - 1
    store_var_len_uint8(w, 0)  # NBLTYPESI - 1
    store_var_len_uint8(w, 0)  # NBLTYPESD - 1
    w.write(2, npostfix)
    w.write(4, ndirect >> npostfix)
    store_var_len_uint8(w, 0)  # NTREESL - 1 (single literal tree)
    w.write(2, 0)              # context mode LSB6
    store_var_len_uint8(w, 0)  # NTREESD - 1

    lit_depths, lit_bits = build_and_store_huffman_tree(w, lit_hist, NUM_LITERAL_SYMBOLS)
    cmd_depths, cmd_bits = build_and_store_huffman_tree(w, cmd_hist, NUM_COMMAND_SYMBOLS)
    dist_depths, dist_bits = build_and_store_huffman_tree(w, dist_hist, dist_alphabet_size)

    pos = start_pos
    for cmd in commands:
        cp = cmd.cmd_prefix
        w.write(cmd_depths[cp], cmd_bits[cp])
        store_command_extra(w, cmd)
        for j in range(cmd.insert_len):
            lit = data[(pos + j) & mask]
            w.write(lit_depths[lit], lit_bits[lit])
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        pos += copy_len
        if copy_len and cp >= 128:
            dist_code = cmd.dist_prefix & 0x3FF
            w.write(dist_depths[dist_code], dist_bits[dist_code])
            w.write(cmd.dist_prefix >> 10, cmd.dist_extra)

    if is_last:
        w.align_to_byte()
