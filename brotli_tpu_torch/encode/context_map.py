"""Context-map serialization: MTF + zero-RLE + prefix code (context-map.ts)."""

from __future__ import annotations

from .bitwriter import BitWriter, store_var_len_uint8
from .entropy import build_and_store_huffman_tree


def move_to_front_transform(values: list[int]) -> list[int]:
    if not values:
        return []
    mtf = list(range(max(values) + 1))
    out = []
    for v in values:
        idx = mtf.index(v)
        out.append(idx)
        if idx:
            del mtf[idx]
            mtf.insert(0, v)
    return out


def run_length_code_zeros(
    values: list[int], max_run_length_prefix: int
) -> tuple[list[int], int]:
    """Returns (packed symbols: sym | extra<<9, max_prefix)."""
    max_reps = 0
    i = 0
    n = len(values)
    while i < n:
        while i < n and values[i] != 0:
            i += 1
        reps = 0
        while i < n and values[i] == 0:
            reps += 1
            i += 1
        max_reps = max(max_reps, reps)
    max_prefix = max_reps.bit_length() - 1 if max_reps > 0 else 0
    max_prefix = min(max_prefix, max_run_length_prefix)

    out = []
    i = 0
    while i < n:
        if values[i] != 0:
            out.append(values[i] + max_prefix)
            i += 1
        else:
            reps = 1
            k = i + 1
            while k < n and values[k] == 0:
                reps += 1
                k += 1
            i += reps
            while reps != 0:
                if reps < (2 << max_prefix):
                    prefix = reps.bit_length() - 1
                    extra = reps - (1 << prefix)
                    out.append(prefix | (extra << 9))
                    break
                else:
                    out.append(max_prefix | (((1 << max_prefix) - 1) << 9))
                    reps -= (2 << max_prefix) - 1
    return out, max_prefix


def encode_context_map(
    w: BitWriter, context_map: list[int], num_clusters: int
) -> None:
    store_var_len_uint8(w, num_clusters - 1)
    if num_clusters == 1:
        return
    mtf = move_to_front_transform(context_map)
    rle_symbols, max_prefix = run_length_code_zeros(mtf, 6)
    histogram = [0] * (num_clusters + max_prefix)
    for s in rle_symbols:
        histogram[s & 0x1FF] += 1
    use_rle = max_prefix > 0
    w.write(1, 1 if use_rle else 0)
    if use_rle:
        w.write(4, max_prefix - 1)
    depths, bits = build_and_store_huffman_tree(
        w, histogram, num_clusters + max_prefix
    )
    for s in rle_symbols:
        sym = s & 0x1FF
        w.write(depths[sym], bits[sym])
        if 0 < sym <= max_prefix:
            w.write(sym, s >> 9)
    w.write(1, 1)  # IMTF flag
