"""Brotli static dictionary (RFC 7932 Appendix A): 122,784 bytes.

Shipped brotli-compressed (data/dictionary.br, ~52 KB) and bootstrapped by
our own decoder, exactly as the reference does (dictionary.ts:32-45,
engine.ts:2060-2082): the compressed blob contains no dictionary references,
so a dictionary-less decode suffices.  The decoded bytes are cached to
data/dictionary.bin on first use; on TPU the raw dictionary lives in HBM and
is broadcast to every chip once per process (see brotli_tpu.parallel).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import (
    DICT_OFFSETS_BY_LENGTH,
    DICT_SIZE_BITS_BY_LENGTH,
    DICT_SIZE,
)

_DATA = Path(__file__).resolve().parent.parent / "data"
_dictionary: bytes | None = None


def get_dictionary() -> bytes:
    global _dictionary
    if _dictionary is None:
        cached = _DATA / "dictionary.bin"
        if cached.exists():
            _dictionary = cached.read_bytes()
        else:
            from .engine import decode  # deferred: bootstrap via our own decoder

            _dictionary = decode((_DATA / "dictionary.br").read_bytes())
            try:
                cached.write_bytes(_dictionary)
            except OSError:
                pass
        if len(_dictionary) != DICT_SIZE:
            raise RuntimeError(
                f"static dictionary decoded to {len(_dictionary)} bytes, "
                f"expected {DICT_SIZE}"
            )
    return _dictionary


def get_word(word_len: int, word_idx: int) -> bytes:
    data = get_dictionary()
    off = int(DICT_OFFSETS_BY_LENGTH[word_len]) + word_idx * word_len
    return data[off : off + word_len]


def size_bits(word_len: int) -> int:
    if word_len < 0 or word_len > 24:
        return 0
    return int(DICT_SIZE_BITS_BY_LENGTH[word_len])
