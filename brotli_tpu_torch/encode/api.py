"""One-shot and streaming encode API.

Pipeline dispatch matches the reference (encode.ts:50-287):
  empty -> 2-byte stream; q0 or <64 B -> uncompressed metablocks;
  q1 -> fast path (simple hasher + trivial metablock);
  q2-11 -> standard path (hasher by quality, full metablock store).
"""

from __future__ import annotations

import math

from .backward_refs import create_backward_references
from .bitwriter import BitWriter, encode_window_bits
from .command import Command, make_insert_command
from .matching import SimpleHasher
from .params import (
    EncoderParams,
    HQ_ZOPFLIFICATION_QUALITY,
    ZOPFLIFICATION_QUALITY,
    make_params,
)
from .metablock import store_metablock_trivial, store_uncompressed_metablock

_NO_MASK = (1 << 62) - 1  # one-shot path: input is not a ring buffer


def _padded(data: bytes) -> bytes:
    """Hashers may read up to 8 bytes past a position (zero-fill, like JS)."""
    return data + b"\x00" * 8


def encode(
    data: bytes,
    *,
    quality: int | None = None,
    lgwin: int | None = None,
    mode: int | None = None,
    size_hint: int | None = None,
    honor_lgwin: bool = False,
) -> bytes:
    """One-shot encode.  honor_lgwin=True searches matches across the full
    (1<<lgwin)-16 window instead of replicating the reference's
    lgwin-independent 4 MB cap (bit-exact mode keeps the quirk)."""
    params = make_params(quality, lgwin, mode, size_hint, honor_lgwin)
    data = bytes(data)

    if len(data) == 0:
        return _encode_empty()
    if params.quality == 0 or len(data) < 64:
        return _encode_uncompressed(data)
    if params.quality == 1:
        return _encode_fast(data, params)
    return _encode_standard(data, params)


def _encode_empty() -> bytes:
    w = BitWriter()
    nbits, value = encode_window_bits(10, False)
    w.write(nbits, value)
    w.write(1, 1)  # ISLAST
    w.write(1, 1)  # ISEMPTY
    w.align_to_byte()
    return w.finish()


def _encode_uncompressed(data: bytes) -> bytes:
    w = BitWriter()
    n = len(data)
    lgwin = max(10, min(24, 10 if n <= 1 else math.ceil(math.log2(n)) + 1))
    nbits, value = encode_window_bits(lgwin, False)
    w.write(nbits, value)
    max_block = (1 << 24) - 1
    pos = 0
    while pos < n:
        block = min(n - pos, max_block)
        is_last = pos + block >= n
        store_uncompressed_metablock(w, data, pos, n - 1, block, is_last)
        pos += block
    return w.finish()


def _encode_fast(data: bytes, params: EncoderParams) -> bytes:
    w = BitWriter()
    nbits, value = encode_window_bits(params.lgwin, False)
    w.write(nbits, value)
    hasher = SimpleHasher(params.quality)
    dist_cache = [4, 11, 15, 16]
    padded = _padded(data)
    block_size = 1 << params.lgblock
    pos = 0
    while pos < len(data):
        block_len = min(len(data) - pos, block_size)
        is_last = pos + block_len >= len(data)
        commands, _, _ = create_backward_references(
            block_len, pos, padded, _NO_MASK, hasher, dist_cache, 0,
            params.quality, params.dist.npostfix, params.dist.ndirect,
        )
        store_metablock_trivial(
            w, data, pos, block_len, _NO_MASK, is_last, commands,
            params.dist_alphabet_size, params.dist.npostfix, params.dist.ndirect,
        )
        pos += block_len
    return w.finish()


def _merge_trailing_literals(
    commands: list[Command], last_insert_len: int, metablock_len: int
) -> list[Command]:
    """Fold trailing literals into the command list (encode.ts:248-266)."""
    if last_insert_len > 0:
        if not commands:
            commands = [make_insert_command(metablock_len)]
        else:
            last = commands[-1]
            if last.copy_length() == 0:
                last.insert_len += last_insert_len
            else:
                commands.append(make_insert_command(last_insert_len))
    elif not commands:
        commands = [make_insert_command(metablock_len)]
    return commands


def _make_hasher(params: EncoderParams, input_len: int):
    if params.quality <= 4:
        return SimpleHasher(params.quality)
    if params.quality <= 9:
        from .hash_chains import HashChainHasher

        return HashChainHasher(params.quality, params.lgwin)
    from .hash_binary_tree import BinaryTreeHasher

    return BinaryTreeHasher(params.lgwin, input_len)


def _encode_standard(data: bytes, params: EncoderParams) -> bytes:
    w = BitWriter()
    nbits, value = encode_window_bits(params.lgwin, params.large_window)
    w.write(nbits, value)
    hasher = _make_hasher(params, len(data))
    dist_cache = [4, 11, 15, 16]
    padded = _padded(data)
    max_metablock = 1 << 24
    pos = 0
    while pos < len(data):
        mb_len = min(len(data) - pos, max_metablock)
        is_last = pos + mb_len >= len(data)
        last_insert_len = 0
        if params.quality >= ZOPFLIFICATION_QUALITY:
            from .backward_refs_hq import (
                create_hq_zopfli_backward_references,
                create_zopfli_backward_references,
            )

            fn = (
                create_hq_zopfli_backward_references
                if params.quality >= HQ_ZOPFLIFICATION_QUALITY
                else create_zopfli_backward_references
            )
            commands, _, last_insert_len = fn(
                mb_len, pos, padded, _NO_MASK, hasher, dist_cache, 0,
                params.dist.npostfix, params.dist.ndirect,
                max_window=(1 << params.lgwin) - 16
                if params.honor_lgwin else None,
            )
        else:
            commands, _, last_insert_len = create_backward_references(
                mb_len, pos, padded, _NO_MASK, hasher, dist_cache, 0,
                params.quality, params.dist.npostfix, params.dist.ndirect,
                use_dictionary=params.quality >= 4,
                real_max_backward=(1 << params.lgwin) - 16,
                max_window=(1 << params.lgwin) - 16
                if params.honor_lgwin else None,
            )
        commands = _merge_trailing_literals(commands, last_insert_len, mb_len)

        from .metablock_full import store_metablock

        prelude = (data[pos - 1], data[pos - 2]) if pos >= 2 else (0, 0)
        store_metablock(
            w, data, pos, mb_len, _NO_MASK, is_last, commands,
            params.dist_alphabet_size, params.quality,
            params.dist.npostfix, params.dist.ndirect, params.mode,
            context_prelude=prelude,
        )
        pos += mb_len
    return w.finish()


def encode_fragment(
    data: bytes,
    *,
    quality: int | None = None,
    lgwin: int | None = None,
    mode: int | None = None,
    first: bool = True,
    last: bool = True,
    context_prelude: tuple[int, int] = (0, 0),
    out_offset: int = 0,
) -> bytes:
    """Encode one shard of a larger stream as a byte-aligned fragment.

    `out_offset` is the decoder output position where this fragment begins
    (sum of preceding shard lengths); it anchors static-dictionary distance
    addressing at quality >= 4.

    Concatenating fragments (first=True for shard 0, last=True for the final
    shard) yields one valid Brotli stream: each non-last fragment ends with an
    empty metadata block, whose header forces the decoder to a byte boundary
    (RFC 9.2), so fragments can be encoded independently — with the LZ window
    reset at shard boundaries — and spliced by plain concatenation.  This is
    the metablock-sharding scheme of SURVEY.md section 2.3.
    """
    params = make_params(quality, lgwin, mode, len(data))
    data = bytes(data)
    w = BitWriter()
    if first:
        nbits, value = encode_window_bits(params.lgwin, params.large_window)
        w.write(nbits, value)
    if len(data) == 0:
        if last:
            w.write(1, 1)
            w.write(1, 1)
        else:  # empty metadata block re-aligns the reader
            w.write(1, 0)
            w.write(2, 3)
            w.write(1, 0)
            w.write(2, 0)
        w.align_to_byte()
        return w.finish()

    padded = _padded(data)
    # Non-first fragments cannot assume the decoder's distance ring (it
    # carries over from the previous shard): a sentinel cache suppresses
    # short/implicit distance codes until 4 real distances are pushed, at
    # which point encoder cache and decoder ring provably agree.
    dist_cache = [4, 11, 15, 16] if first else [-(1 << 30)] * 4
    n = len(data)
    if params.quality == 0:
        pos = 0
        max_block = (1 << 24) - 1
        while pos < n:
            block = min(n - pos, max_block)
            is_final = last and pos + block >= n
            store_uncompressed_metablock(w, data, pos, n - 1, block, is_final)
            pos += block
    else:
        hasher = _make_hasher(params, n)
        block_size = 1 << params.lgblock if params.quality == 1 else 1 << 24
        pos = 0
        while pos < n:
            block_len = min(n - pos, block_size)
            is_last_mb = last and pos + block_len >= n
            last_insert_len = 0
            if params.quality >= ZOPFLIFICATION_QUALITY:
                from .backward_refs_hq import (
                    create_hq_zopfli_backward_references,
                    create_zopfli_backward_references,
                )

                fn = (
                    create_hq_zopfli_backward_references
                    if params.quality >= HQ_ZOPFLIFICATION_QUALITY
                    else create_zopfli_backward_references
                )
                commands, _, last_insert_len = fn(
                    block_len, pos, padded, _NO_MASK, hasher, dist_cache, 0,
                    params.dist.npostfix, params.dist.ndirect,
                )
            else:
                commands, _, last_insert_len = create_backward_references(
                    block_len, pos, padded, _NO_MASK, hasher, dist_cache, 0,
                    params.quality, params.dist.npostfix, params.dist.ndirect,
                    # dictionary addressing needs the true decoder output
                    # position; only the first fragment knows it implicitly
                    use_dictionary=params.quality >= 4
                    and (first or out_offset > 0),
                    real_max_backward=(1 << params.lgwin) - 16,
                    out_offset=out_offset,
                )
            commands = _merge_trailing_literals(commands, last_insert_len, block_len)
            if params.quality == 1:
                store_metablock_trivial(
                    w, data, pos, block_len, _NO_MASK, is_last_mb, commands,
                    params.dist_alphabet_size,
                    params.dist.npostfix, params.dist.ndirect,
                )
            else:
                from .metablock_full import store_metablock

                prelude = (
                    (data[pos - 1], data[pos - 2]) if pos >= 2 else context_prelude
                )
                store_metablock(
                    w, data, pos, block_len, _NO_MASK, is_last_mb, commands,
                    params.dist_alphabet_size, params.quality,
                    params.dist.npostfix, params.dist.ndirect, params.mode,
                    context_prelude=prelude,
                )
            pos += block_len
    if not last:
        # empty metadata block: ISLAST=0, MNIBBLES=3, reserved=0, MSKIPBYTES=0;
        # its header byte-aligns the reader (decode side jumps to boundary).
        w.write(1, 0)
        w.write(2, 3)
        w.write(1, 0)
        w.write(2, 0)
        w.align_to_byte()
    return w.finish()


class Encoder:
    """Streaming encoder: accumulate via update(), flush with finish().

    Mirrors the reference BrotliEncoder (encode.ts:290-490): per-lgblock
    block processing on a ring buffer; always stores trivial metablocks.
    """

    def __init__(
        self,
        *,
        quality: int | None = None,
        lgwin: int | None = None,
        mode: int | None = None,
        size_hint: int | None = None,
    ):
        self.params = make_params(quality, lgwin, mode, size_hint)
        size = 1 << self.params.lgwin
        self.ring = bytearray(size + 8)  # +8: hash read slack at the seam
        self.mask = size - 1
        self.dist_cache = [4, 11, 15, 16]
        self.input_pos = 0
        self.last_processed = 0
        self.last_insert_len = 0
        self.writer = BitWriter()
        self.hasher = None
        self._initialized = False
        self._last_emitted = False

    def _init(self) -> None:
        if self._initialized:
            return
        nbits, value = encode_window_bits(self.params.lgwin, self.params.large_window)
        self.writer.write(nbits, value)
        self.hasher = _make_hasher(self.params, None)  # full-window forest
        self._initialized = True

    def update(self, chunk: bytes) -> bytes:
        self._init()
        for i, b in enumerate(bytes(chunk)):
            self.ring[(self.input_pos + i) & self.mask] = b
        self.input_pos += len(chunk)
        out = bytearray()
        block_size = 1 << self.params.lgblock
        while self.input_pos - self.last_processed >= block_size:
            out.extend(self._process_block(block_size, False))
        return bytes(out)

    def finish(self) -> bytes:
        self._init()
        remaining = self.input_pos - self.last_processed
        if remaining > 0:
            return self._process_block(remaining, True)
        if not self._last_emitted:
            self.writer.write(1, 1)
            self.writer.write(1, 1)
            self.writer.align_to_byte()
            self._last_emitted = True
        return self.writer.take_bytes() + (
            bytes([self.writer.acc & 0xFF]) if self.writer.nbits else b""
        )

    def _process_block(self, block_len: int, is_last: bool) -> bytes:
        pos = self.last_processed
        if self.params.quality >= ZOPFLIFICATION_QUALITY:
            from .backward_refs_hq import (
                create_hq_zopfli_backward_references,
                create_zopfli_backward_references,
            )

            if self.params.quality >= HQ_ZOPFLIFICATION_QUALITY:
                commands, _, last_insert_len = create_hq_zopfli_backward_references(
                    block_len, pos, self.ring, self.mask, self.hasher,
                    self.dist_cache, self.last_insert_len,
                    self.params.dist.npostfix, self.params.dist.ndirect,
                )
            else:
                commands, _, last_insert_len = create_zopfli_backward_references(
                    block_len, pos, self.ring, self.mask, self.hasher,
                    self.dist_cache, self.last_insert_len,
                    self.params.dist.npostfix, self.params.dist.ndirect,
                )
        else:
            commands, _, last_insert_len = create_backward_references(
                block_len, pos, self.ring, self.mask, self.hasher,
                self.dist_cache, self.last_insert_len, self.params.quality,
                self.params.dist.npostfix, self.params.dist.ndirect,
            )
        commands = _merge_trailing_literals(commands, last_insert_len, block_len)
        store_metablock_trivial(
            self.writer, self.ring, pos, block_len, self.mask, is_last,
            commands, self.params.dist_alphabet_size,
            self.params.dist.npostfix, self.params.dist.ndirect,
        )
        self.last_processed += block_len
        self.last_insert_len = 0
        if is_last:
            self._last_emitted = True
            self.writer.align_to_byte()
            return self.writer.take_bytes()
        return self.writer.take_bytes()
