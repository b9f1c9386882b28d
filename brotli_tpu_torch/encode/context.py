"""Encode-side literal context model (context.ts).

The 2048-entry LUT asset is shared with the decoder.  chooseContextMode is
the reference's sampling heuristic (context.ts:179-227) — deliberately NOT
Google's algorithm, but it reaches the bitstream, so it is replicated.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

CONTEXT_LSB6 = 0
CONTEXT_MSB6 = 1
CONTEXT_UTF8 = 2
CONTEXT_SIGNED = 3
NUM_LITERAL_CONTEXTS = 64
NUM_DISTANCE_CONTEXTS = 4

_LUT: list[int] = np.load(
    Path(__file__).resolve().parent.parent / "data" / "context_lut.npy"
).tolist()


def get_context_lut(mode: int) -> list[int]:
    return _LUT[mode << 9 : (mode << 9) + 512]


def get_context(p1: int, p2: int, lut: list[int]) -> int:
    return lut[p1] | lut[256 + p2]


def choose_context_mode(data, start: int, length: int) -> int:
    ascii_count = 0
    utf8_lead = 0
    utf8_cont = 0
    signed_pattern = 0
    sample_size = min(length, 1024)
    step = max(1, length // sample_size) if sample_size else 1
    i = 0
    while i < length:
        byte = data[start + i]
        if byte < 128:
            ascii_count += 1
            if i > 0:
                if abs(byte - data[start + i - 1]) < 16:
                    signed_pattern += 1
        elif byte >= 192:
            utf8_lead += 1
        else:
            utf8_cont += 1
        i += step
    total = ascii_count + utf8_lead + utf8_cont
    if total == 0:
        return CONTEXT_LSB6
    if utf8_lead > 0 and utf8_cont > utf8_lead * 0.5:
        return CONTEXT_UTF8
    if signed_pattern > total * 0.3:
        return CONTEXT_SIGNED
    if ascii_count > total * 0.7:
        return CONTEXT_UTF8
    return CONTEXT_LSB6
