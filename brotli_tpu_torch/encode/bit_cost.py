"""Histogram bit-cost estimation (bit-cost.ts).

Float accumulation order is preserved (sequential adds over symbol index) —
these costs drive clustering decisions that reach the bitstream, and
reordering f64 sums changes low bits and therefore decisions.
"""

from __future__ import annotations

import math

from .cost_model import fast_log2

ONE_SYMBOL_COST = 12
TWO_SYMBOL_COST = 20
THREE_SYMBOL_COST = 28
FOUR_SYMBOL_COST = 37
CODE_LENGTH_CODES = 18
REPEAT_ZERO = 17


def bits_entropy(histogram) -> float:
    total = 0
    retval = 0.0
    for p in histogram:
        if p > 0:
            total += p
            retval -= p * fast_log2(p)
    if total > 0:
        retval += total * fast_log2(total)
    if retval < total:
        retval = float(total)
    return retval


def population_cost(data, total_count: int) -> float:
    size = len(data)
    if total_count == 0:
        return ONE_SYMBOL_COST

    s = []
    for i in range(size):
        if data[i] > 0:
            s.append(i)
            if len(s) > 4:
                break
    count = len(s)

    if count == 1:
        return ONE_SYMBOL_COST
    if count == 2:
        return TWO_SYMBOL_COST + total_count
    if count == 3:
        h0, h1, h2 = data[s[0]], data[s[1]], data[s[2]]
        return THREE_SYMBOL_COST + 2 * (h0 + h1 + h2) - max(h0, h1, h2)
    if count == 4:
        histo = sorted((data[s[0]], data[s[1]], data[s[2]], data[s[3]]), reverse=True)
        h23 = histo[2] + histo[3]
        return FOUR_SYMBOL_COST + 3 * h23 + 2 * (histo[0] + histo[1]) - max(h23, histo[0])

    bits = 0.0
    max_depth = 1
    depth_histo = [0] * CODE_LENGTH_CODES
    log2total = fast_log2(total_count)
    i = 0
    while i < size:
        if data[i] > 0:
            log2p = log2total - fast_log2(data[i])
            depth = math.floor(log2p + 0.5)  # JS Math.round (half-up)
            bits += data[i] * log2p
            if depth > 15:
                depth = 15
            if depth > max_depth:
                max_depth = depth
            depth_histo[depth] += 1
            i += 1
        else:
            reps = 1
            k = i + 1
            while k < size and data[k] == 0:
                reps += 1
                k += 1
            i += reps
            if i == size:
                break
            if reps < 3:
                depth_histo[0] += reps
            else:
                reps -= 2
                while reps > 0:
                    depth_histo[REPEAT_ZERO] += 1
                    bits += 3
                    reps >>= 3
    bits += 18 + 2 * max_depth
    bits += bits_entropy(depth_histo)
    return bits
