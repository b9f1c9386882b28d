"""RFC 7932 (Brotli) format constants, shared by encoder and decoder.

Unlike the reference — which carries separate copies of every prefix-code
table on each side (see the reference library's src/encode/command.ts:11-27 vs
src/decode/engine.ts:22-23, and the CHANGELOG 0.0.3 bug a mismatch caused) —
this framework derives every table once, programmatically, from the RFC
definitions, and both pipelines import it.  All arrays are NumPy so the JAX
ops layer can lift them onto the device unchanged.
"""

from __future__ import annotations

import numpy as np

# --------------------------------------------------------------------------
# Window / stream limits
# --------------------------------------------------------------------------
MIN_WINDOW_BITS = 10
MAX_WINDOW_BITS = 24
MAX_LARGE_WINDOW_BITS = 30
MAX_METABLOCK_SIZE = 1 << 24  # MLEN is at most 16 MiB

NUM_LITERAL_SYMBOLS = 256
NUM_COMMAND_SYMBOLS = 704
NUM_BLOCK_LEN_SYMBOLS = 26
MAX_NUM_BLOCK_TYPES = 256
NUM_DISTANCE_SHORT_CODES = 16
MAX_NPOSTFIX = 3
MAX_NDIRECT = 120
# 16 + 120 + (48 << 3) = 520 for the standard window; 544 covers large window.
MAX_DISTANCE_ALPHABET_SIZE = 544

# --------------------------------------------------------------------------
# Code-length code (RFC 3.5): order in which code-length code lengths appear,
# and the fixed prefix code over values 0..5 used to read them.
# --------------------------------------------------------------------------
CODE_LENGTH_CODE_ORDER = np.array(
    [1, 2, 3, 4, 0, 5, 17, 6, 16, 7, 8, 9, 10, 11, 12, 13, 14, 15], dtype=np.int32
)
CODE_LENGTH_REPEAT_CODE = 16  # sym 16: repeat previous non-zero length
CODE_LENGTH_ZERO_REPEAT = 17  # sym 17: run of zero lengths

# Fixed code for the code-length code's own lengths: value -> code length.
# Codes (canonical, LSB-first on the wire): 0:'00', 3:'01'(rev:10), 4:'10',
# 2:'110', 1:'1110', 5:'1111'.
CODE_LENGTH_CODE_LENGTHS = np.array([2, 4, 3, 2, 2, 4], dtype=np.int32)

# --------------------------------------------------------------------------
# Block-count code (RFC 6): 26 symbols -> (offset, nbits)
# --------------------------------------------------------------------------
BLOCK_LENGTH_N_BITS = np.array(
    [2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 24],
    dtype=np.int32,
)
BLOCK_LENGTH_OFFSET = np.concatenate(
    ([1], 1 + np.cumsum(1 << BLOCK_LENGTH_N_BITS[:-1]))
).astype(np.int32)

# --------------------------------------------------------------------------
# Insert & copy length codes (RFC 5)
# --------------------------------------------------------------------------
INSERT_LENGTH_N_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 12, 14, 24],
    dtype=np.int32,
)
COPY_LENGTH_N_BITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 7, 8, 9, 10, 24],
    dtype=np.int32,
)
INSERT_LENGTH_OFFSET = np.concatenate(
    ([0], np.cumsum(1 << INSERT_LENGTH_N_BITS[:-1]))
).astype(np.int32)
COPY_LENGTH_OFFSET = np.concatenate(
    ([2], 2 + np.cumsum(1 << COPY_LENGTH_N_BITS[:-1]))
).astype(np.int32)

# The 704 insert-and-copy codes form 11 cells of 64.  Cells 0/1 are the
# implicit-distance-zero duplicates of (insert 0-7, copy 0-7/8-15); cells 2-10
# enumerate the 3x3 insert/copy range grid.
_CELL_INSERT_HIGH = np.array([0, 0, 8, 8, 0, 16, 8, 16, 16], dtype=np.int32)
_CELL_COPY_HIGH = np.array([0, 8, 0, 8, 16, 0, 16, 8, 16], dtype=np.int32)


def _build_cmd_lut() -> np.ndarray:
    """cmd code -> (insert_code, copy_code, uses_implicit_dist0, dist_ctx)."""
    cmd = np.arange(NUM_COMMAND_SYMBOLS, dtype=np.int32)
    cell = cmd >> 6
    implicit = cell < 2
    range_idx = np.where(implicit, cell, cell - 2)
    insert_code = _CELL_INSERT_HIGH[range_idx] | ((cmd >> 3) & 7)
    copy_code = _CELL_COPY_HIGH[range_idx] | (cmd & 7)
    copy_off = COPY_LENGTH_OFFSET[copy_code]
    dist_ctx = np.minimum(copy_off, 5) - 2  # 0..3 by copy length 2,3,4,>=5
    return np.stack(
        [insert_code, copy_code, implicit.astype(np.int32), dist_ctx], axis=1
    )


# (704, 4) int32: columns insert_code, copy_code, implicit_dist0, dist_ctx
CMD_LUT = _build_cmd_lut()


def combine_length_codes(ins_code: int, copy_code: int, use_last_distance: bool) -> int:
    """Inverse of CMD_LUT: (insert code, copy code) -> command code."""
    bits64 = ((ins_code & 7) << 3) | (copy_code & 7)
    if use_last_distance and ins_code < 8 and copy_code < 16:
        # cells 0/1: implicit-last-distance encodings (insert 0-7, copy 0-15)
        return bits64 if copy_code < 8 else (bits64 | 64)
    cell_of = {  # (insert_high, copy_high) -> cell
        (0, 0): 2, (0, 1): 3, (1, 0): 4, (1, 1): 5,
        (0, 2): 6, (2, 0): 7, (1, 2): 8, (2, 1): 9, (2, 2): 10,
    }
    return (cell_of[(ins_code >> 3, copy_code >> 3)] << 6) | bits64


def get_insert_length_code(insertlen: int) -> int:
    if insertlen < 6:
        return insertlen
    if insertlen < 130:
        nbits = (insertlen - 2).bit_length() - 2  # floor(log2(insertlen-2)) - 1
        return (nbits << 1) + ((insertlen - 2) >> nbits) + 2
    if insertlen < 2114:
        return (insertlen - 66).bit_length() - 1 + 10
    if insertlen < 6210:
        return 21
    if insertlen < 22594:
        return 22
    return 23


def get_copy_length_code(copylen: int) -> int:
    if copylen < 10:
        return copylen - 2
    if copylen < 134:
        nbits = (copylen - 6).bit_length() - 2
        return (nbits << 1) + ((copylen - 6) >> nbits) + 4
    if copylen < 2118:
        return (copylen - 70).bit_length() - 1 + 12
    return 23


# --------------------------------------------------------------------------
# Distance short codes (RFC 4): index into the last-distance ring + delta
# --------------------------------------------------------------------------
DISTANCE_SHORT_CODE_INDEX = np.array(
    [0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1], dtype=np.int32
)  # 0 = last distance, 1 = second-to-last, ...
DISTANCE_SHORT_CODE_DELTA = np.array(
    [0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3], dtype=np.int32
)
INITIAL_DISTANCE_RING = (16, 15, 11, 4)  # 4th-to-last .. last


def distance_alphabet_size(npostfix: int, ndirect: int, max_ndist_bits: int) -> int:
    return 16 + ndirect + 2 * (max_ndist_bits << npostfix)


def max_distance_bits(lgwin: int, large_window: bool = False) -> int:
    return 62 if large_window else 24


# --------------------------------------------------------------------------
# Static dictionary layout (RFC 8)
# --------------------------------------------------------------------------
DICT_MIN_WORD_LENGTH = 4
DICT_MAX_WORD_LENGTH = 24
DICT_SIZE_BITS_BY_LENGTH = np.array(
    [0, 0, 0, 0, 10, 10, 11, 11, 10, 10, 10, 10, 10, 9, 9, 8, 7, 7, 8, 7, 7, 6, 6, 5, 5],
    dtype=np.int32,
)
DICT_OFFSETS_BY_LENGTH = np.zeros(26, dtype=np.int32)
for _l in range(4, 25):
    DICT_OFFSETS_BY_LENGTH[_l + 1] = DICT_OFFSETS_BY_LENGTH[_l] + _l * (
        1 << DICT_SIZE_BITS_BY_LENGTH[_l]
    )
DICT_OFFSETS_BY_LENGTH[4] = 0  # lengths 0..3 unused
DICT_SIZE = int(DICT_OFFSETS_BY_LENGTH[25])  # 122784
NUM_TRANSFORMS = 121

# Literal context modes (RFC 7.1)
CONTEXT_LSB6 = 0
CONTEXT_MSB6 = 1
CONTEXT_UTF8 = 2
CONTEXT_SIGNED = 3
LITERAL_CONTEXT_BITS = 6
DISTANCE_CONTEXT_BITS = 2

# Huffman limits
HUFFMAN_MAX_CODE_LENGTH = 15
HUFFMAN_CODE_LENGTH_CODE_LENGTH_MAX = 5
HUFFMAN_TABLE_BITS = 8  # root bits of the decoder's two-level tables


# Upper bound on two-level decode-table size, indexed by (alphabet+31)>>5
# (same bound Google's decoders use; engine.ts:16 carries the identical table).
MAX_HUFFMAN_TABLE_SIZE = np.array(
    [256, 402, 436, 468, 500, 534, 566, 598, 630, 662, 694, 726, 758, 790, 822,
     854, 886, 920, 952, 984, 1016, 1048, 1080],
    dtype=np.int32,
)


def max_huffman_table_size(alphabet_limit: int) -> int:
    return int(MAX_HUFFMAN_TABLE_SIZE[(alphabet_limit + 31) >> 5])
