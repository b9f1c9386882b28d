"""RFC 7932 Brotli decoder — host (golden) implementation.

This is the framework's reference-grade decoder: it decodes the full format
(all window sizes incl. large-window extension, metadata/uncompressed blocks,
context maps, static + compound dictionaries) and anchors every other
component — the encoder's round-trip tests and the Pallas lockstep decode
kernel are validated against it, and it bootstraps the static dictionary.

Architectural choices vs the reference (engine.ts):
  * batch decoder: the whole output lives in one buffer, so there is no ring
    buffer, no output fences, and no resumable state machine — back-references
    are plain slices because distances never exceed min(pos, window-16);
  * tables are flat int32 lists shared bit-for-bit with the TPU kernel layout.

Behavioral parity notes cite the reference library's src/decode/engine.ts.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import (
    BLOCK_LENGTH_N_BITS,
    BLOCK_LENGTH_OFFSET,
    CMD_LUT,
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    DISTANCE_SHORT_CODE_DELTA,
    DISTANCE_SHORT_CODE_INDEX,
    INSERT_LENGTH_N_BITS,
    INSERT_LENGTH_OFFSET,
    NUM_COMMAND_SYMBOLS,
    NUM_LITERAL_SYMBOLS,
    distance_alphabet_size,
)
from .bitreader import BitReader, BrotliError
from .huffman import (
    build_huffman_table,
    read_huffman_code,
    read_symbol,
    tree_group_alloc_size,
)
from . import dictionary as static_dict
from .transforms import NUM_TRANSFORMS, transform_word

# Python-native copies of the hot tables (scalar indexing speed).
_INS_NBITS = INSERT_LENGTH_N_BITS.tolist()
_INS_OFFSET = INSERT_LENGTH_OFFSET.tolist()
_CP_NBITS = COPY_LENGTH_N_BITS.tolist()
_CP_OFFSET = COPY_LENGTH_OFFSET.tolist()
_BLEN_NBITS = BLOCK_LENGTH_N_BITS.tolist()
_BLEN_OFFSET = BLOCK_LENGTH_OFFSET.tolist()
_CMD_INS_CODE = CMD_LUT[:, 0].tolist()
_CMD_CP_CODE = CMD_LUT[:, 1].tolist()
_CMD_IMPLICIT = CMD_LUT[:, 2].tolist()
_CMD_DIST_CTX = CMD_LUT[:, 3].tolist()
_SHORT_IDX = DISTANCE_SHORT_CODE_INDEX.tolist()
_SHORT_DELTA = DISTANCE_SHORT_CODE_DELTA.tolist()

_CONTEXT_LUT: list[int] = np.load(
    Path(__file__).resolve().parent.parent / "data" / "context_lut.npy"
).tolist()

_HUGE_BLOCK_LENGTH = 1 << 28


def _decode_window_bits(br: BitReader, large_window_enabled: bool) -> tuple[int, bool]:
    """Returns (wbits, is_large_window). Reference: engine.ts:91-124."""
    if br.read(1) == 0:
        return 16, False
    n = br.read(3)
    if n != 0:
        return 17 + n, False
    n = br.read(3)
    if n != 0:
        if n == 1:
            if not large_window_enabled:
                raise BrotliError(-11, "large window stream, not enabled")
            if br.read(1) == 1:
                raise BrotliError(-11, "invalid reserved window bit")
            w = br.read(6)
            if w < 10 or w > 30:
                raise BrotliError(-11, "invalid large window bits")
            return w, True
        return 8 + n, False
    return 17, False


def _var_len_uint8(br: BitReader) -> int:
    """NBLTYPES-style variable code minus one (engine.ts:190-203)."""
    if br.read(1) == 0:
        return 0
    n = br.read(3)
    if n == 0:
        return 1
    return br.read(n) + (1 << n)


def _inverse_mtf(values: list[int]) -> None:
    mtf = list(range(256))
    for i, idx in enumerate(values):
        v = mtf[idx]
        values[i] = v
        if idx:
            del mtf[idx]
            mtf.insert(0, v)


def _read_code_table(alpha_max: int, alpha_limit: int, br: BitReader) -> list[int]:
    table = [0] * tree_group_alloc_size(alpha_limit, 1)
    read_huffman_code(alpha_max, alpha_limit, table, 0, br)
    return table


def _decode_context_map(size: int, br: BitReader) -> tuple[int, list[int]]:
    """Returns (num_trees, map). Reference: engine.ts:488-558."""
    num_trees = _var_len_uint8(br) + 1
    if num_trees == 1:
        return 1, [0] * size
    use_rle = br.read(1)
    max_run_prefix = br.read(4) + 1 if use_rle else 0
    alphabet = num_trees + max_run_prefix
    table = _read_code_table(alphabet, alphabet, br)
    cmap: list[int] = [0] * size
    i = 0
    while i < size:
        code = read_symbol(table, 0, br)
        if code == 0:
            i += 1
        elif code <= max_run_prefix:
            reps = (1 << code) + br.read(code)
            if i + reps > size:
                raise BrotliError(-3, "context-map run overflow")
            i += reps
        else:
            cmap[i] = code - max_run_prefix
            i += 1
    if br.read(1):
        _inverse_mtf(cmap)
    return num_trees, cmap


def _calc_distance_lut(alphabet_limit: int, npostfix: int, ndirect: int):
    """(extra_bits, offset) per distance code >= 16 (engine.ts:702-726)."""
    extra = [0] * alphabet_limit
    offset = [0] * alphabet_limit
    postfix = 1 << npostfix
    i = 16
    for j in range(ndirect):
        extra[i] = 0
        offset[i] = j + 1
        i += 1
    bits, half = 1, 0
    while i < alphabet_limit:
        base = ndirect + ((((2 + half) << bits) - 4) << npostfix) + 1
        for j in range(postfix):
            if i >= alphabet_limit:
                break
            extra[i] = bits
            offset[i] = base + j
            i += 1
        bits += half
        half ^= 1
    return extra, offset


class _MetablockState:
    """Per-metablock entropy state (trees, block splits, context maps)."""

    __slots__ = (
        "num_types", "block_len", "btype", "btype_prev",
        "type_tables", "len_tables",
        "context_modes", "cmap", "dist_cmap",
        "lit_group", "cmd_group", "dist_group",
        "trivial_literal", "npostfix", "ndirect",
        "dist_extra", "dist_offset",
    )

    def __init__(self, br: BitReader, large_window: bool):
        self.num_types = [0, 0, 0]
        self.block_len = [0, 0, 0]
        self.btype = [0, 0, 0]
        self.btype_prev = [1, 1, 1]
        self.type_tables: list[list[int] | None] = [None, None, None]
        self.len_tables: list[list[int] | None] = [None, None, None]
        for c in range(3):
            n = _var_len_uint8(br) + 1
            self.num_types[c] = n
            if n >= 2:
                self.type_tables[c] = _read_code_table(n + 2, n + 2, br)
                self.len_tables[c] = _read_code_table(26, 26, br)
                self.block_len[c] = self._read_block_length(br, c)
            else:
                self.block_len[c] = _HUGE_BLOCK_LENGTH

        self.npostfix = br.read(2)
        self.ndirect = br.read(4) << self.npostfix
        self.context_modes = [br.read(2) for _ in range(self.num_types[0])]
        num_lit_trees, self.cmap = _decode_context_map(self.num_types[0] << 6, br)
        self.trivial_literal = all(
            v == (j >> 6) for j, v in enumerate(self.cmap)
        )
        num_dist_trees, self.dist_cmap = _decode_context_map(self.num_types[2] << 2, br)

        self.lit_group = [
            _read_code_table(NUM_LITERAL_SYMBOLS, NUM_LITERAL_SYMBOLS, br)
            for _ in range(num_lit_trees)
        ]
        self.cmd_group = [
            _read_code_table(NUM_COMMAND_SYMBOLS, NUM_COMMAND_SYMBOLS, br)
            for _ in range(self.num_types[1])
        ]
        dist_alpha_max = distance_alphabet_size(self.npostfix, self.ndirect, 24)
        dist_alpha_limit = dist_alpha_max
        if large_window:
            dist_alpha_max = distance_alphabet_size(self.npostfix, self.ndirect, 62)
            dist_alpha_limit = _large_window_alphabet_limit(
                0x7FFFFFFC, self.npostfix, self.ndirect
            )
        self.dist_group = [
            _read_code_table(dist_alpha_max, dist_alpha_limit, br)
            for _ in range(num_dist_trees)
        ]
        self.dist_extra, self.dist_offset = _calc_distance_lut(
            dist_alpha_limit, self.npostfix, self.ndirect
        )

    def _read_block_length(self, br: BitReader, c: int) -> int:
        code = read_symbol(self.len_tables[c], 0, br)
        return _BLEN_OFFSET[code] + br.read(_BLEN_NBITS[code])

    def block_switch(self, br: BitReader, c: int) -> None:
        """Reference: engine.ts:559-581."""
        sym = read_symbol(self.type_tables[c], 0, br)
        length = self._read_block_length(br, c)
        if sym == 0:
            bt = self.btype_prev[c]
        elif sym == 1:
            bt = self.btype[c] + 1
        else:
            bt = sym - 2
        if bt >= self.num_types[c]:
            bt -= self.num_types[c]
        self.btype_prev[c] = self.btype[c]
        self.btype[c] = bt
        self.block_len[c] = length


def _large_window_alphabet_limit(max_distance: int, npostfix: int, ndirect: int) -> int:
    """engine.ts:77-85 calculateDistanceAlphabetLimit."""
    if max_distance < ndirect + (2 << npostfix):
        raise BrotliError(-23, "max distance too small")
    offset = ((max_distance - ndirect) >> npostfix) + 4
    ndistbits = offset.bit_length() - 1 - 1
    group = ((ndistbits - 1) << 1) | ((offset >> ndistbits) & 1)
    return ((group - 1) << npostfix) + (1 << npostfix) + ndirect + 16


class _Output:
    """Growable output buffer with LZ copy helpers."""

    __slots__ = ("buf", "pos")

    def __init__(self):
        self.buf = bytearray(1 << 16)
        self.pos = 0

    def _ensure(self, need: int) -> None:
        if need > len(self.buf):
            grow = max(need - len(self.buf), len(self.buf))
            self.buf.extend(bytes(grow))

    def append(self, data: bytes) -> None:
        end = self.pos + len(data)
        self._ensure(end)
        self.buf[self.pos : end] = data
        self.pos = end

    def copy_within(self, distance: int, length: int) -> None:
        pos = self.pos
        self._ensure(pos + length)
        buf = self.buf
        src = pos - distance
        if distance >= length:
            buf[pos : pos + length] = buf[src : src + length]
        elif distance == 1:
            buf[pos : pos + length] = buf[pos - 1 : pos] * length
        else:
            # overlapping: seed one period then double from the destination
            buf[pos : pos + distance] = buf[src:pos]
            written = distance
            while written < length:
                n = min(written, length - written)
                buf[pos + written : pos + written + n] = buf[pos : pos + n]
                written += n
        self.pos = pos + length


def decode(
    data: bytes,
    *,
    custom_dictionary: bytes | list[bytes] | None = None,
    large_window: bool = False,
) -> bytes:
    """Decode a complete Brotli stream to bytes."""
    br = BitReader(bytes(data))
    out = _Output()

    # compound (custom) dictionary chunks, reference engine.ts:142-159
    cd_chunks: list[bytes] = []
    if custom_dictionary is not None:
        cd_chunks = (
            [bytes(custom_dictionary)]
            if isinstance(custom_dictionary, (bytes, bytearray, memoryview))
            else [bytes(c) for c in custom_dictionary]
        )
        if len(cd_chunks) > 15:
            raise BrotliError(-27, "too many dictionary chunks")
    cd_offsets = [0]
    for c in cd_chunks:
        cd_offsets.append(cd_offsets[-1] + len(c))
    cd_total = cd_offsets[-1]

    wbits, is_large = _decode_window_bits(br, large_window)
    max_backward = (1 << wbits) - 16

    dist_rb = [16, 15, 11, 4]
    dist_rb_idx = 3

    input_end = False
    while not input_end:
        br.check_health()
        input_end = bool(br.read(1))
        if input_end and br.read(1):
            break  # ISLAST + ISLASTEMPTY
        mbl, is_uncompressed, is_metadata = _read_metablock_length(br, input_end)
        if is_metadata:
            br.jump_to_byte_boundary()
            br.copy_bytes(mbl)
            continue
        if mbl == 0:
            continue
        if is_uncompressed:
            br.jump_to_byte_boundary()
            out.append(br.copy_bytes(mbl))
            continue

        st = _MetablockState(br, is_large)
        dist_rb_idx = _command_loop(
            br, st, out, mbl, max_backward,
            dist_rb, dist_rb_idx, cd_chunks, cd_offsets, cd_total,
        )

    br.jump_to_byte_boundary()
    br.check_health(end_of_stream=True)
    return bytes(out.buf[: out.pos])


def _read_metablock_length(br: BitReader, input_end: bool) -> tuple[int, bool, bool]:
    """Reference: engine.ts:204-255 (ISLAST bits already consumed)."""
    size_nibbles = br.read(2) + 4
    if size_nibbles == 7:  # metadata
        if br.read(1) != 0:
            raise BrotliError(-6, "corrupted reserved bit")
        size_bytes = br.read(2)
        if size_bytes == 0:
            return 0, False, True
        mbl = 0
        for i in range(size_bytes):
            bits = br.read(8)
            if bits == 0 and i + 1 == size_bytes and size_bytes > 1:
                raise BrotliError(-8, "exuberant nibble")
            mbl += bits << (i * 8)
        return mbl + 1, False, True
    mbl = 0
    for i in range(size_nibbles):
        bits = br.read(4)
        if bits == 0 and i + 1 == size_nibbles and size_nibbles > 4:
            raise BrotliError(-8, "exuberant nibble")
        mbl += bits << (i * 4)
    mbl += 1
    is_uncompressed = bool(br.read(1)) if not input_end else False
    return mbl, is_uncompressed, False


def _command_loop(
    br: BitReader,
    st: _MetablockState,
    out: _Output,
    mbl: int,
    max_backward: int,
    dist_rb: list[int],
    dist_rb_idx: int,
    cd_chunks: list[bytes],
    cd_offsets: list[int],
    cd_total: int,
) -> int:
    """Decode one compressed metablock's command stream.

    Mirrors the fused pipeline of engine.ts:1059-1438 without the
    fence/resume machinery. Returns the updated distance-ring index.
    """
    lut = _CONTEXT_LUT
    cmap = st.cmap
    dist_cmap = st.dist_cmap
    lit_group = st.lit_group
    cmd_group = st.cmd_group
    dist_group = st.dist_group
    dist_extra = st.dist_extra
    dist_offset_tab = st.dist_offset
    block_len = st.block_len
    npostfix = st.npostfix
    buf = out.buf

    cmd_table = cmd_group[0]
    trivial = st.trivial_literal
    lit_table = lit_group[cmap[0]]
    clo = st.context_modes[0] << 9
    cmap_slice = 0
    dist_cmap_slice = 0

    while mbl > 0:
        # --- command symbol ---
        if block_len[1] == 0:
            st.block_switch(br, 1)
            cmd_table = cmd_group[st.btype[1]]
        block_len[1] -= 1
        cmd = read_symbol(cmd_table, 0, br)
        ins_code = _CMD_INS_CODE[cmd]
        cp_code = _CMD_CP_CODE[cmd]
        insert_len = _INS_OFFSET[ins_code] + br.read(_INS_NBITS[ins_code])
        copy_len = _CP_OFFSET[cp_code] + br.read(_CP_NBITS[cp_code])

        # --- literals ---
        if insert_len > 0:
            out._ensure(out.pos + insert_len)
            buf = out.buf
            pos = out.pos
            j = 0
            if trivial:
                while j < insert_len:
                    if block_len[0] == 0:
                        st.block_switch(br, 0)
                        bt = st.btype[0]
                        cmap_slice = bt << 6
                        lit_table = lit_group[cmap[cmap_slice]]
                        clo = st.context_modes[bt] << 9
                    batch = min(insert_len - j, block_len[0])
                    block_len[0] -= batch
                    j += batch
                    for _ in range(batch):
                        buf[pos] = read_symbol(lit_table, 0, br)
                        pos += 1
            else:
                p1 = buf[pos - 1] if pos > 0 else 0
                p2 = buf[pos - 2] if pos > 1 else 0
                while j < insert_len:
                    if block_len[0] == 0:
                        st.block_switch(br, 0)
                        bt = st.btype[0]
                        cmap_slice = bt << 6
                        clo = st.context_modes[bt] << 9
                    batch = min(insert_len - j, block_len[0])
                    block_len[0] -= batch
                    j += batch
                    clo2 = clo + 256
                    for _ in range(batch):
                        ctx = lut[clo + p1] | lut[clo2 + p2]
                        sym = read_symbol(lit_group[cmap[cmap_slice + ctx]], 0, br)
                        buf[pos] = sym
                        pos += 1
                        p2 = p1
                        p1 = sym
            out.pos = pos
            mbl -= insert_len
            if mbl <= 0:
                break

        # --- distance ---
        if _CMD_IMPLICIT[cmd]:
            distance_code = -1
            distance = dist_rb[dist_rb_idx]
        else:
            if block_len[2] == 0:
                st.block_switch(br, 2)
                dist_cmap_slice = st.btype[2] << 2
            block_len[2] -= 1
            tree_idx = dist_cmap[dist_cmap_slice + _CMD_DIST_CTX[cmd]]
            distance_code = read_symbol(dist_group[tree_idx], 0, br)
            if distance_code < 16:
                idx = (dist_rb_idx - _SHORT_IDX[distance_code]) & 3
                distance = dist_rb[idx] + _SHORT_DELTA[distance_code]
                if distance < 1:
                    raise BrotliError(-12, "non-positive distance")
            else:
                bits = br.read(dist_extra[distance_code])
                distance = dist_offset_tab[distance_code] + (bits << npostfix)

        max_distance = min(out.pos, max_backward)
        if distance > max_distance:
            # --- dictionary reference ---
            if distance > 0x7FFFFFFC:
                raise BrotliError(-9, "invalid backward reference")
            address = distance - max_distance - 1 - cd_total
            if address < 0:
                # compound dictionary (engine.ts:964-1011)
                cd_addr = -address - 1
                if cd_addr + copy_len > cd_total:
                    raise BrotliError(-9, "compound dictionary overflow")
                dist_rb_idx = (dist_rb_idx + 1) & 3
                dist_rb[dist_rb_idx] = distance
                chunk_idx = 0
                while cd_addr >= cd_offsets[chunk_idx + 1]:
                    chunk_idx += 1
                copied = 0
                while copied < copy_len:
                    off_in = cd_addr - cd_offsets[chunk_idx]
                    n = min(
                        copy_len - copied,
                        len(cd_chunks[chunk_idx]) - off_in,
                    )
                    out.append(cd_chunks[chunk_idx][off_in : off_in + n])
                    copied += n
                    cd_addr += n
                    if copied < copy_len:
                        chunk_idx += 1
                mbl -= copy_len
            else:
                word_len = copy_len
                if word_len > 31:
                    raise BrotliError(-9, "invalid backward reference")
                shift = static_dict.size_bits(word_len)
                if shift == 0:
                    raise BrotliError(-9, "invalid backward reference")
                word_idx = address & ((1 << shift) - 1)
                transform_idx = address >> shift
                if transform_idx >= NUM_TRANSFORMS:
                    raise BrotliError(-9, "invalid transform index")
                word = static_dict.get_word(word_len, word_idx)
                transformed = transform_word(word, transform_idx)
                out.append(transformed)
                mbl -= len(transformed)
            buf = out.buf
            continue

        # --- regular copy ---
        if distance_code > 0:
            dist_rb_idx = (dist_rb_idx + 1) & 3
            dist_rb[dist_rb_idx] = distance
        if copy_len > mbl:
            raise BrotliError(-9, "copy length exceeds metablock")
        out.copy_within(distance, copy_len)
        buf = out.buf
        mbl -= copy_len

    if mbl < 0:
        raise BrotliError(-9, "metablock length exceeded")
    return dist_rb_idx
