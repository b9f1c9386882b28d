"""Shared-table sharded encode: the TPU-throughput encoding layout.

Splits an input into fixed-size chunks and encodes each as an independent
Brotli stream (or as splice-able fragments of one stream), with ONE set of
Huffman tables built from the *global* symbol histograms and re-declared
identically in every chunk's metablock.  This is valid RFC 7932 output —
each metablock always carries its own tree description — the tables are
simply chosen once for all chunks instead of per chunk.

Why: the Pallas lockstep decoder (ops/pallas_decode2.py) decodes 1024
streams in SIMD lockstep; per-element Huffman lookups are only cheap on the
VPU when all lanes share the same table (row-replicated table vregs +
`tpu.dynamic_gather` along lanes).  Shared tables turn every per-lane
lookup into a handful of vector ops instead of an O(table) one-hot sweep.

Cost: a few hundred bytes of repeated tree headers per chunk plus slightly
suboptimal per-chunk code lengths — negligible at 16-64 KB chunks.

Reference parity notes: chunk pipeline mirrors the reference's q1 fast path
(encode.ts:140-179) per chunk; table build/storage is the reference's
entropy-encode.ts machinery, factored so build happens once.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import NUM_COMMAND_SYMBOLS, NUM_LITERAL_SYMBOLS
from .backward_refs import create_backward_references
from .bitwriter import BitWriter, encode_window_bits, store_var_len_uint8
from .command import Command, store_command_extra
from .entropy import build_huffman_code, store_huffman_tree
from .matching import SimpleHasher
from .metablock import store_compressed_metablock_header
from .params import make_params

_NO_MASK = (1 << 62) - 1


@dataclass
class SharedTables:
    lit: tuple[list[int], list[int], int, list[int]]   # depths, bits, count, s4
    cmd: tuple[list[int], list[int], int, list[int]]
    dist: tuple[list[int], list[int], int, list[int]]
    dist_alphabet_size: int
    npostfix: int
    ndirect: int


def _chunk_commands(
    chunk: bytes, quality: int, npostfix: int, ndirect: int, first: bool = True,
    max_distance: int | None = None,
):
    padded = chunk + b"\x00" * 8
    hasher = SimpleHasher(quality)
    # Non-first chunks of a spliced stream inherit the decoder's distance
    # ring from the previous chunk; a sentinel cache suppresses short codes
    # until 4 real distances are pushed (same scheme as encode_fragment).
    dist_cache = [4, 11, 15, 16] if first else [-(1 << 30)] * 4
    commands, _, last_insert = create_backward_references(
        len(chunk), 0, padded, _NO_MASK, hasher, dist_cache, 0,
        quality, npostfix, ndirect, max_match_distance=max_distance,
    )
    if last_insert > 0:
        from .api import _merge_trailing_literals

        commands = _merge_trailing_literals(commands, last_insert, len(chunk))
    elif not commands:
        from .api import _merge_trailing_literals

        commands = _merge_trailing_literals(commands, 0, len(chunk))
    return commands


def _accumulate_histograms(chunk, commands, lit_hist, cmd_hist, dist_hist):
    pos = 0
    for cmd in commands:
        cmd_hist[cmd.cmd_prefix] += 1
        for j in range(cmd.insert_len):
            lit_hist[chunk[pos + j]] += 1
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        pos += copy_len
        if copy_len and cmd.cmd_prefix >= 128:
            dist_hist[cmd.dist_prefix & 0x3FF] += 1


def build_shared_tables(
    chunks: list[bytes],
    commands_per_chunk: list[list[Command]],
    dist_alphabet_size: int,
    npostfix: int,
    ndirect: int,
) -> SharedTables:
    lit_hist = [0] * NUM_LITERAL_SYMBOLS
    cmd_hist = [0] * NUM_COMMAND_SYMBOLS
    dist_hist = [0] * dist_alphabet_size
    for chunk, commands in zip(chunks, commands_per_chunk):
        _accumulate_histograms(chunk, commands, lit_hist, cmd_hist, dist_hist)
    return SharedTables(
        lit=build_huffman_code(lit_hist, NUM_LITERAL_SYMBOLS),
        cmd=build_huffman_code(cmd_hist, NUM_COMMAND_SYMBOLS),
        dist=build_huffman_code(dist_hist, dist_alphabet_size),
        dist_alphabet_size=dist_alphabet_size,
        npostfix=npostfix,
        ndirect=ndirect,
    )


def store_metablock_trivial_fixed(
    w: BitWriter,
    data: bytes,
    length: int,
    is_last: bool,
    commands: list[Command],
    tables: SharedTables,
) -> None:
    """store_metablock_trivial with externally-provided Huffman codes.

    Mirrors metablock.ts:290-389 except the codes are not rebuilt from this
    metablock's histogram — they are the shared global codes.
    """
    store_compressed_metablock_header(w, is_last, length)
    store_var_len_uint8(w, 0)  # NBLTYPESL - 1
    store_var_len_uint8(w, 0)  # NBLTYPESI - 1
    store_var_len_uint8(w, 0)  # NBLTYPESD - 1
    w.write(2, tables.npostfix)
    w.write(4, tables.ndirect >> tables.npostfix)
    store_var_len_uint8(w, 0)  # NTREESL - 1
    w.write(2, 0)              # context mode LSB6
    store_var_len_uint8(w, 0)  # NTREESD - 1

    lit_depths, lit_bits, lc, ls4 = tables.lit
    cmd_depths, cmd_bits, cc, cs4 = tables.cmd
    dist_depths, dist_bits, dc, ds4 = tables.dist
    store_huffman_tree(w, lit_depths, NUM_LITERAL_SYMBOLS, lc, ls4)
    store_huffman_tree(w, cmd_depths, NUM_COMMAND_SYMBOLS, cc, cs4)
    store_huffman_tree(w, dist_depths, tables.dist_alphabet_size, dc, ds4)

    pos = 0
    for cmd in commands:
        cp = cmd.cmd_prefix
        w.write(cmd_depths[cp], cmd_bits[cp])
        store_command_extra(w, cmd)
        for j in range(cmd.insert_len):
            lit = data[pos + j]
            w.write(lit_depths[lit], lit_bits[lit])
        pos += cmd.insert_len
        copy_len = cmd.copy_length()
        pos += copy_len
        if copy_len and cp >= 128:
            dist_code = cmd.dist_prefix & 0x3FF
            w.write(dist_depths[dist_code], dist_bits[dist_code])
            w.write(cmd.dist_prefix >> 10, cmd.dist_extra)


def encode_sharded(
    data: bytes,
    *,
    chunk_size: int = 32768,
    quality: int = 1,
    lgwin: int | None = None,
    max_distance: int | None = None,
) -> list[bytes]:
    """Encode `data` as independent same-table chunk streams.

    Returns one standalone Brotli stream per chunk; all chunks carry
    bit-identical Huffman tree declarations (decode-side table sharing).
    Any standard Brotli decoder round-trips each chunk; our device decoder
    decodes the whole list in lockstep.

    max_distance caps match distances (still standard RFC 7932 output);
    pass ops.pallas_resolve.MAX_DEVICE_DISTANCE to keep every stream
    resolvable by the on-device LZ kernel's VMEM history window.
    """
    data = bytes(data)
    params = make_params(quality, lgwin, None, min(len(data), chunk_size))
    if len(data) == 0:
        from .api import _encode_empty

        return [_encode_empty()]
    chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]
    commands = [
        _chunk_commands(c, params.quality, params.dist.npostfix,
                        params.dist.ndirect, max_distance=max_distance)
        for c in chunks
    ]
    tables = build_shared_tables(
        chunks, commands, params.dist_alphabet_size,
        params.dist.npostfix, params.dist.ndirect,
    )
    out: list[bytes] = []
    hdr_nbits, hdr_value = encode_window_bits(params.lgwin, False)
    for chunk, cmds in zip(chunks, commands):
        w = BitWriter()
        w.write(hdr_nbits, hdr_value)
        store_metablock_trivial_fixed(w, chunk, len(chunk), True, cmds, tables)
        w.align_to_byte()
        out.append(w.finish())
    return out


def encode_sharded_concat(
    data: bytes,
    *,
    chunk_size: int = 32768,
    quality: int = 1,
    lgwin: int | None = None,
) -> bytes:
    """Single-stream variant: chunks spliced into ONE valid Brotli stream.

    Non-last chunks end with an empty metadata block whose header re-aligns
    the reader to a byte boundary (RFC 9.2), so byte concatenation is valid
    (same scheme as encode_fragment).
    """
    data = bytes(data)
    params = make_params(quality, lgwin, None, min(len(data), chunk_size))
    if len(data) == 0:
        from .api import _encode_empty

        return _encode_empty()
    chunks = [data[i : i + chunk_size] for i in range(0, len(data), chunk_size)]
    commands = [
        _chunk_commands(
            c, params.quality, params.dist.npostfix, params.dist.ndirect,
            first=(k == 0),
        )
        for k, c in enumerate(chunks)
    ]
    tables = build_shared_tables(
        chunks, commands, params.dist_alphabet_size,
        params.dist.npostfix, params.dist.ndirect,
    )
    out = bytearray()
    hdr_nbits, hdr_value = encode_window_bits(params.lgwin, False)
    for k, (chunk, cmds) in enumerate(zip(chunks, commands)):
        last = k == len(chunks) - 1
        w = BitWriter()
        if k == 0:
            w.write(hdr_nbits, hdr_value)
        store_metablock_trivial_fixed(w, chunk, len(chunk), last, cmds, tables)
        if not last:
            # empty metadata block: ISLAST=0, MNIBBLES=3(=0), reserved,
            # MSKIPBYTES=0 — forces byte alignment for the next chunk
            w.write(1, 0)
            w.write(2, 3)
            w.write(1, 0)
            w.write(2, 0)
        w.align_to_byte()
        out.extend(w.finish())
    return bytes(out)
