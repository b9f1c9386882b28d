"""Canonical Huffman decode tables (two-level, root-8) + code reading.

Table entries are packed int32 ``(nbits << 16) | payload``:
  * leaf in root table: nbits <= root_bits, payload = symbol
  * subtable pointer:   nbits = root_bits + sub_bits, payload = relative
    offset from the table base to the subtable (minus the root slot index)
  * leaf in subtable:   nbits = code_len - root_bits, payload = symbol

This single-int32 packing is chosen because it is exactly what the Pallas
decode kernel gathers from VMEM — host and device share the layout.
Behavioral contract follows RFC 7932 sections 3.2-3.5 (reference:
engine.ts:1704-1762 buildHuffmanTable, 382-487 simple/complex readers).
"""

from __future__ import annotations

from .bitreader import BitReader, BrotliError
from ..constants import (
    CODE_LENGTH_CODE_ORDER,
    CODE_LENGTH_CODE_LENGTHS,
    MAX_HUFFMAN_TABLE_SIZE,
)

MAX_CODE_LENGTH = 15


def _next_key(key: int, length: int) -> int:
    """Advance a bit-reversed canonical code key to the next code."""
    step = 1 << (length - 1)
    while key & step:
        step >>= 1
    return (key & (step - 1)) + step


def _next_table_bit_size(count: list[int], length: int, root_bits: int) -> int:
    left = 1 << (length - root_bits)
    while length < MAX_CODE_LENGTH:
        left -= count[length]
        if left <= 0:
            break
        length += 1
        left <<= 1
    return length - root_bits


def build_huffman_table(
    table: list[int], table_off: int, root_bits: int, code_lengths: list[int]
) -> int:
    """Fill `table` starting at `table_off`; return total entries used."""
    count = [0] * (MAX_CODE_LENGTH + 1)
    for ln in code_lengths:
        count[ln] += 1
    # counting-sort symbols by (length, symbol)
    offsets = [0] * (MAX_CODE_LENGTH + 2)
    for ln in range(1, MAX_CODE_LENGTH + 1):
        offsets[ln + 1] = offsets[ln] + count[ln]
    sorted_syms = [0] * offsets[MAX_CODE_LENGTH + 1]
    num_used = offsets[MAX_CODE_LENGTH + 1]
    fill = offsets[:]
    for sym, ln in enumerate(code_lengths):
        if ln:
            sorted_syms[fill[ln]] = sym
            fill[ln] += 1

    table_size = 1 << root_bits
    total_size = table_size
    if num_used == 1:  # degenerate code: 0 bits per symbol
        sym = sorted_syms[0]
        for i in range(total_size):
            table[table_off + i] = sym
        return total_size

    key = 0
    symbol = 0
    step = 1
    for ln in range(1, root_bits + 1):
        step <<= 1
        while count[ln] > 0:
            item = (ln << 16) | sorted_syms[symbol]
            symbol += 1
            pos = table_size
            while pos > 0:
                pos -= step
                table[table_off + key + pos] = item
            key = _next_key(key, ln)
            count[ln] -= 1

    mask = total_size - 1
    low = -1
    cur_off = table_off
    sub_size = table_size
    for ln in range(root_bits + 1, MAX_CODE_LENGTH + 1):
        step <<= 1
        while count[ln] > 0:
            if (key & mask) != low:
                cur_off += sub_size
                sub_bits = _next_table_bit_size(count, ln, root_bits)
                sub_size = 1 << sub_bits
                total_size += sub_size
                low = key & mask
                table[table_off + low] = ((sub_bits + root_bits) << 16) | (
                    cur_off - table_off - low
                )
            item = ((ln - root_bits) << 16) | sorted_syms[symbol]
            symbol += 1
            pos = sub_size
            sub_step = 1 << (ln - root_bits)
            base = cur_off + (key >> root_bits)
            while pos > 0:
                pos -= sub_step
                table[base + pos] = item
            key = _next_key(key, ln)
            count[ln] -= 1
    return total_size


def read_symbol(table: list[int], offset: int, br: BitReader) -> int:
    v = br.peek(15)
    slot = offset + (v & 0xFF)
    entry = table[slot]
    bits = entry >> 16
    if bits <= 8:
        br.bitpos += bits
        return entry & 0xFFFF
    slot += entry & 0xFFFF  # relative subtable offset (pre-bakes -root_slot)
    entry = table[slot + ((v & ((1 << bits) - 1)) >> 8)]
    br.bitpos += (entry >> 16) + 8
    return entry & 0xFFFF


# ---------------------------------------------------------------------------
# Reading a prefix code description from the stream (RFC 3.4 / 3.5)
# ---------------------------------------------------------------------------

# 4-bit lookup for the fixed code over code-length-code lengths (values 0-5).
_FIXED_CLCL_TABLE = [0] * 16
build_huffman_table(_FIXED_CLCL_TABLE, 0, 4, list(CODE_LENGTH_CODE_LENGTHS))


def _read_code_lengths(
    clcl: list[int], num_symbols: int, br: BitReader
) -> list[int]:
    """Read the main code's lengths using the code-length code (RFC 3.5)."""
    code_lengths = [0] * num_symbols
    table = [0] * 32
    build_huffman_table(table, 0, 5, clcl)
    symbol = 0
    prev_len = 8
    repeat = 0
    repeat_len = 0
    space = 32768
    while symbol < num_symbols and space > 0:
        p = br.peek(5)
        entry = table[p]
        br.bitpos += entry >> 16
        code_len = entry & 0xFFFF
        if code_len < 16:
            repeat = 0
            code_lengths[symbol] = code_len
            symbol += 1
            if code_len:
                prev_len = code_len
                space -= 32768 >> code_len
        else:
            extra_bits = code_len - 14  # 16 -> 2 bits, 17 -> 3 bits
            new_len = prev_len if code_len == 16 else 0
            if repeat_len != new_len:
                repeat = 0
                repeat_len = new_len
            old_repeat = repeat
            if repeat > 0:
                repeat = (repeat - 2) << extra_bits
            repeat += br.read(extra_bits) + 3
            delta = repeat - old_repeat
            if symbol + delta > num_symbols:
                raise BrotliError(-2, "code-length repeat overflow")
            for _ in range(delta):
                code_lengths[symbol] = repeat_len
                symbol += 1
            if repeat_len:
                space -= delta << (15 - repeat_len)
    if space != 0:
        raise BrotliError(-18, "unused code-length space")
    return code_lengths


def read_huffman_code(
    alphabet_size_max: int,
    alphabet_size_limit: int,
    table: list[int],
    table_off: int,
    br: BitReader,
) -> int:
    """Read one prefix-code description and build its decode table."""
    simple_or_skip = br.read(2)
    if simple_or_skip == 1:  # simple code, 1-4 symbols
        max_bits = (alphabet_size_max - 1).bit_length()
        num_symbols = br.read(2) + 1
        symbols = []
        for _ in range(num_symbols):
            sym = br.read(max_bits)
            if sym >= alphabet_size_limit:
                raise BrotliError(-15, "symbol out of range")
            symbols.append(sym)
        if len(set(symbols)) != num_symbols:
            raise BrotliError(-7, "duplicate simple-code symbol")
        code_lengths = [0] * alphabet_size_limit
        shape = num_symbols
        if num_symbols == 4 and br.read(1):
            shape = 5
        lengths_by_shape = {
            1: [1],  # degenerate: build_huffman_table emits the 0-bit form
            2: [1, 1],
            3: [1, 2, 2],
            4: [2, 2, 2, 2],
            5: [1, 2, 3, 3],
        }
        for sym, ln in zip(symbols, lengths_by_shape[shape]):
            code_lengths[sym] = ln
        return build_huffman_table(table, table_off, 8, code_lengths)

    # complex code: read code-length-code lengths starting at skip
    clcl = [0] * 18
    space = 32
    num_codes = 0
    for i in range(simple_or_skip, 18):
        idx = int(CODE_LENGTH_CODE_ORDER[i])
        p = br.peek(4)
        entry = _FIXED_CLCL_TABLE[p]
        br.bitpos += entry >> 16
        v = entry & 0xFFFF
        clcl[idx] = v
        if v:
            space -= 32 >> v
            num_codes += 1
            if space <= 0:
                break
    if space != 0 and num_codes != 1:
        raise BrotliError(-4, "corrupted code-length code")
    code_lengths = _read_code_lengths(clcl, alphabet_size_limit, br)
    return build_huffman_table(table, table_off, 8, code_lengths)


def tree_group_alloc_size(alphabet_size_limit: int, n: int) -> int:
    max_table = int(MAX_HUFFMAN_TABLE_SIZE[(alphabet_size_limit + 31) >> 5])
    return n + n * max_table
