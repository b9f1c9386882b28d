"""RFC 7932 Appendix B word transforms (121 transforms).

Transform op codes: 0 identity, 1-9 omit last N, 10 uppercase-first,
11 uppercase-all, 12-20 omit first N, 21/22 UTF-8 scalar shift (large-window
dictionaries only; params are zero for the RFC set).
Reference behavior: engine.ts:1557-1675.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

_DATA = Path(__file__).resolve().parent.parent / "data"

_npz = np.load(_DATA / "transforms.npz")
TRIPLETS: np.ndarray = _npz["triplets"]  # (121, 3) prefix_idx, op, suffix_idx
_STORAGE: bytes = _npz["storage"].tobytes()
_HEADS: np.ndarray = _npz["heads"]  # (51,) segment start offsets
NUM_TRANSFORMS = TRIPLETS.shape[0]

# Materialize as python tuples for the host decoder's scalar loop.
_SEGMENTS = [
    _STORAGE[int(_HEADS[i]) : int(_HEADS[i + 1])] for i in range(len(_HEADS) - 1)
] + [b""]
TRANSFORM_LIST: list[tuple[bytes, int, bytes]] = [
    (_SEGMENTS[int(p)], int(op), _SEGMENTS[int(s)]) for p, op, s in TRIPLETS
]

OMIT_LAST_BASE = 0  # ops 1-9
UPPERCASE_FIRST = 10
UPPERCASE_ALL = 11
OMIT_FIRST_BASE = 11  # ops 12-20 omit first (op - 11)


def _uppercase_span(buf: bytearray, start: int, length: int, first_only: bool) -> None:
    """UTF-8-aware uppercasing used by transforms 10/11."""
    off = start
    remaining = 1 if first_only else length
    end = start + length
    while remaining > 0 and off < end:
        c0 = buf[off]
        if c0 < 0xC0:
            if 97 <= c0 <= 122:
                buf[off] ^= 32
            off += 1
            remaining -= 1
        elif c0 < 0xE0:
            if off + 1 < end:
                buf[off + 1] ^= 32
            off += 2
            remaining -= 2
        else:
            if off + 2 < end:
                buf[off + 2] ^= 5
            off += 3
            remaining -= 3
        if first_only:
            break


def transform_word(word: bytes, transform_idx: int) -> bytes:
    """Apply transform `transform_idx` to a raw dictionary word."""
    prefix, op, suffix = TRANSFORM_LIST[transform_idx]
    word_len = len(word)
    omit_first = op - 11 if 12 <= op <= 20 else 0
    omit_last = op if 1 <= op <= 9 else 0
    if omit_first > word_len:
        omit_first = word_len
    body = bytearray(word[omit_first : word_len - omit_last if omit_last else word_len])
    if op == UPPERCASE_FIRST:
        _uppercase_span(body, 0, len(body), first_only=True)
    elif op == UPPERCASE_ALL:
        _uppercase_span(body, 0, len(body), first_only=False)
    return prefix + bytes(body) + suffix
