"""LSB-first bit writer.

Host implementation keeps a small integer accumulator and flushes whole
bytes; the device path represents the same stream as parallel (nbits, value)
symbol arrays packed by the ops.bitpack prefix-sum kernel — both produce
identical bytes.  Semantics match the reference writer
(the reference library's src/encode/bit-writer.ts): whole-byte `take_bytes` flushing
for streaming, byte-aligned raw writes, zero padding on align.
"""

from __future__ import annotations


class BitWriter:
    __slots__ = ("out", "acc", "nbits", "_flushed")

    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0
        self._flushed = 0

    def write(self, nbits: int, value: int) -> None:
        self.acc |= (value & ((1 << nbits) - 1)) << self.nbits
        n = self.nbits + nbits
        acc = self.acc
        out = self.out
        while n >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            n -= 8
        self.acc = acc
        self.nbits = n

    def write_pairs(self, pairs) -> None:
        """Write an iterable of (nbits, value) pairs."""
        for nbits, value in pairs:
            self.write(nbits, value)

    def align_to_byte(self) -> int:
        pad = (-self.nbits) % 8
        if pad:
            self.write(pad, 0)
        return pad

    def write_bytes(self, data: bytes) -> None:
        assert self.nbits == 0, "write_bytes requires byte alignment"
        self.out.extend(data)

    @property
    def bit_pos(self) -> int:
        return len(self.out) * 8 + self.nbits

    def take_bytes(self) -> bytes:
        """Newly completed whole bytes since last call (streaming flush)."""
        chunk = bytes(self.out[self._flushed :])
        self._flushed = len(self.out)
        return chunk

    def finish(self) -> bytes:
        if self.nbits:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.nbits = 0
        return bytes(self.out)


def encode_window_bits(lgwin: int, large_window: bool) -> tuple[int, int]:
    """(nbits, value) for the stream's WBITS header field (RFC 9.1)."""
    if large_window:
        return 14, ((lgwin & 0x3F) << 8) | 0x11
    if lgwin == 16:
        return 1, 0
    if lgwin == 17:
        return 7, 1
    if 17 < lgwin <= 24:
        return 4, ((lgwin - 17) << 1) | 0x01
    return 7, ((lgwin - 8) << 4) | 0x01  # lgwin 10-15


def store_var_len_uint8(w: BitWriter, n: int) -> None:
    """NBLTYPES-style variable-length code (RFC 9.2)."""
    if n == 0:
        w.write(1, 0)
    else:
        nbits = n.bit_length() - 1
        w.write(1, 1)
        w.write(3, nbits)
        w.write(nbits, n - (1 << nbits))
