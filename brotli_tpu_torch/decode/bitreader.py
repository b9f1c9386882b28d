"""LSB-first bit reader over a byte buffer.

Design differs from the reference's 16-bit-half accumulator machine
(engine.ts:1805-1833): we precompute the input as 32-bit little-endian words
and index directly by absolute bit position.  This mirrors the layout the
Pallas decode kernel uses (u32 lanes + shift/mask extraction), so the host
path and the device kernel share one addressing scheme.
"""

from __future__ import annotations

import numpy as np


class BrotliError(Exception):
    """Decoding error; `code` follows the reference's negative error codes."""

    def __init__(self, code: int, message: str = ""):
        super().__init__(f"Brotli error code: {code}" + (f" ({message})" if message else ""))
        self.code = code


class BitReader:
    __slots__ = ("data", "total_bits", "words", "bitpos", "_fast_words")

    def __init__(self, data: bytes):
        self.data = data
        self.total_bits = len(data) * 8
        # 4 words of zero slack past the input, exactly like the native
        # decoder (decoder.cpp BitReader: (len+3)/4 + 4 words, fast = n-2):
        # truncated streams read zero padding until either a format error
        # fires or the slack runs out (-10), and the two decoders must take
        # the SAME branch (error-code parity is tested).
        pad = (-len(data)) % 4 + 16
        self.words = np.frombuffer(data + b"\x00" * pad, dtype="<u4").tolist()
        # any word index >= this implies bitpos is past end of input
        self._fast_words = len(self.words) - 2
        self.bitpos = 0

    def peek(self, nbits: int) -> int:
        """Peek up to 32 bits (trailing pad bits read as zeros)."""
        bp = self.bitpos
        w = bp >> 5
        words = self.words
        if w >= self._fast_words:
            raise BrotliError(-10, "unexpected end of input")
        return ((words[w] | (words[w + 1] << 32)) >> (bp & 31)) & ((1 << nbits) - 1)

    def read(self, nbits: int) -> int:
        bp = self.bitpos
        w = bp >> 5
        words = self.words
        if w >= self._fast_words:
            raise BrotliError(-10, "unexpected end of input")
        self.bitpos = bp + nbits
        return ((words[w] | (words[w + 1] << 32)) >> (bp & 31)) & ((1 << nbits) - 1)

    def skip(self, nbits: int) -> None:
        self.bitpos += nbits

    def jump_to_byte_boundary(self) -> None:
        """Align to byte; non-zero pad bits are a format error (-5)."""
        pad = (-self.bitpos) % 8
        if pad and self.read(pad) != 0:
            raise BrotliError(-5, "corrupted padding bits")

    def byte_pos(self) -> int:
        assert self.bitpos % 8 == 0
        return self.bitpos >> 3

    def copy_bytes(self, n: int) -> bytes:
        """Byte-aligned raw copy (uncompressed metablocks, metadata skip)."""
        start = self.byte_pos()
        if start + n > len(self.data):
            raise BrotliError(-10, "unexpected end of input")
        self.bitpos += n * 8
        return self.data[start : start + n]

    def check_health(self, end_of_stream: bool = False) -> None:
        if self.bitpos > self.total_bits:
            raise BrotliError(-10, "read past end of input")
