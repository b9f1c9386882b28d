"""Block splitting (block-splitter.ts): k-means-style entropy clustering +
Viterbi-ish boundary DP over per-symbol insert costs.

The seed-7 LCG, stride/cost constants, prologue discount, and float order are
all bitstream-reaching decisions and are replicated exactly.  The DP inner
loop is vectorized with NumPy float64 — elementwise ops match JS f64
arithmetic bit-for-bit (no reassociation).
"""

from __future__ import annotations

import numpy as np

from .cluster import ClusterHistogram, cluster_histograms
from .cost_model import fast_log2

MIN_LENGTH_FOR_BLOCK_SPLITTING = 128
MAX_NUMBER_OF_BLOCK_TYPES = 256
ITER_MUL_FOR_REFINING = 2
MIN_ITERS_FOR_REFINING = 100


class BlockSplit:
    __slots__ = ("num_types", "types", "lengths", "num_blocks")

    def __init__(self):
        self.num_types = 1
        self.types: list[int] = []
        self.lengths: list[int] = []
        self.num_blocks = 0


class _Rand:
    __slots__ = ("value",)

    def __init__(self, seed=7):
        self.value = seed

    def next(self) -> int:
        # 31-bit LCG with int32 wrap, exactly block-splitter.ts:35-40
        v = (self.value * 16807) & 0xFFFFFFFF
        if v >= 0x80000000:
            v -= 0x100000000  # JS |0 -> signed int32
        if v < 0:
            v += 0x7FFFFFFF
        self.value = v
        return v


def _initial_entropy_codes(data, length, stride, num_histograms, histograms):
    seed = _Rand(7)
    block_length = length // num_histograms
    for h in histograms[:num_histograms]:
        h.clear()
    for i in range(num_histograms):
        pos = (length * i) // num_histograms
        if i != 0:
            pos += seed.next() % block_length
        if pos + stride >= length:
            pos = length - stride - 1
        h = histograms[i]
        for j in range(stride):
            if pos + j >= length:
                break
            h.data[data[pos + j]] += 1
            h.total_count += 1


def _refine_entropy_codes(data, length, stride, num_histograms, histograms, tmp):
    iters = ITER_MUL_FOR_REFINING * (length // stride) + MIN_ITERS_FOR_REFINING
    seed = _Rand(7)
    iters = ((iters + num_histograms - 1) // num_histograms) * num_histograms
    for it in range(iters):
        tmp.clear()
        if stride >= length:
            for j in range(length):
                tmp.data[data[j]] += 1
                tmp.total_count += 1
        else:
            pos = seed.next() % (length - stride + 1)
            for j in range(stride):
                tmp.data[data[pos + j]] += 1
                tmp.total_count += 1
        histograms[it % num_histograms].add(tmp)


def _find_blocks(data, length, block_switch_bitcost, num_histograms, histograms, block_id):
    if num_histograms <= 1:
        block_id[:length] = [0] * length
        return 1
    alphabet_size = len(histograms[0].data)

    # insert_cost[sym, j] = log2(total_j) - bitCost(count_j[sym])
    totals = np.array(
        [fast_log2(h.total_count) for h in histograms[:num_histograms]],
        dtype=np.float64,
    )
    counts = np.stack([h.data[:alphabet_size] for h in histograms[:num_histograms]])
    log2_counts = np.where(
        counts == 0,
        2.0,  # bitCost(0) = fastLog2(1) + 2 = 2
        _vector_fast_log2(counts),
    )
    insert_cost = totals[None, :] - log2_counts.T  # (alphabet, num_histograms)

    cost = np.zeros(num_histograms, dtype=np.float64)
    switch_signal = np.zeros((length, num_histograms), dtype=bool)
    num_blocks = 1
    PROLOGUE = 2000
    MULTIPLIER = 0.07 / 2000

    data_arr = np.asarray(data)
    for byte_ix in range(length):
        symbol = data_arr[byte_ix]
        block_switch_cost = block_switch_bitcost
        if byte_ix < PROLOGUE:
            block_switch_cost *= 0.77 + MULTIPLIER * byte_ix
        cost += insert_cost[symbol]
        k_min = int(np.argmin(cost))
        min_cost = cost[k_min]
        block_id[byte_ix] = k_min
        cost -= min_cost
        over = cost >= block_switch_cost
        cost[over] = block_switch_cost
        switch_signal[byte_ix] = over

    byte_ix = length - 1
    cur_id = block_id[byte_ix]
    while byte_ix > 0:
        byte_ix -= 1
        if switch_signal[byte_ix, cur_id]:
            if cur_id != block_id[byte_ix]:
                cur_id = block_id[byte_ix]
                num_blocks += 1
        block_id[byte_ix] = cur_id
    return num_blocks


def _vector_fast_log2(counts: np.ndarray) -> np.ndarray:
    """fastLog2 per element: exact table <256, log() otherwise."""
    from .cost_model import _LOG2_TABLE

    table = np.array(_LOG2_TABLE, dtype=np.float64)
    small = counts < 256
    out = np.empty(counts.shape, dtype=np.float64)
    out[small] = table[counts[small]]
    big = ~small
    if big.any():
        out[big] = np.log(counts[big].astype(np.float64)) * 1.4426950408889634
    return out


def _remap_block_ids(block_ids, length, num_histograms) -> int:
    INVALID = 256
    new_id = [INVALID] * num_histograms
    next_id = 0
    for i in range(length):
        b = block_ids[i]
        if new_id[b] == INVALID:
            new_id[b] = next_id
            next_id += 1
    for i in range(length):
        block_ids[i] = new_id[block_ids[i]]
    return next_id


def _build_block_histograms(data, length, block_ids, num_histograms, histograms):
    for h in histograms[:num_histograms]:
        h.clear()
    for i in range(length):
        h = histograms[block_ids[i]]
        h.data[data[i]] += 1
        h.total_count += 1


def split_byte_vector(
    data, length, alphabet_size, symbols_per_histogram, max_histograms,
    sampling_stride, block_switch_cost, quality, split: BlockSplit,
) -> None:
    num_histograms = length // symbols_per_histogram + 1
    if num_histograms > max_histograms:
        num_histograms = max_histograms
    if length == 0:
        split.num_types = 1
        return
    if length < MIN_LENGTH_FOR_BLOCK_SPLITTING:
        split.num_types = 1
        split.types.append(0)
        split.lengths.append(length)
        split.num_blocks += 1
        return

    histograms = [ClusterHistogram(alphabet_size) for _ in range(num_histograms + 1)]
    tmp = histograms[num_histograms]
    _initial_entropy_codes(data, length, sampling_stride, num_histograms, histograms)
    _refine_entropy_codes(data, length, sampling_stride, num_histograms, histograms, tmp)

    block_ids = [0] * length
    iters = 3 if quality < 10 else 10
    num_blocks = 0
    for _ in range(iters):
        num_blocks = _find_blocks(
            data, length, block_switch_cost, num_histograms, histograms, block_ids
        )
        num_histograms = _remap_block_ids(block_ids, length, num_histograms)
        _build_block_histograms(data, length, block_ids, num_histograms, histograms)

    _cluster_blocks(data, length, num_blocks, block_ids, alphabet_size, split)


def _cluster_blocks(data, length, num_blocks, block_ids, alphabet_size, split):
    block_lengths = [0] * num_blocks
    block_idx = 0
    for i in range(length):
        block_lengths[block_idx] += 1
        if i + 1 == length or block_ids[i] != block_ids[i + 1]:
            block_idx += 1

    block_histograms = []
    symbols = list(range(num_blocks))
    pos = 0
    for i in range(num_blocks):
        h = ClusterHistogram(alphabet_size)
        for _ in range(block_lengths[i]):
            h.data[data[pos]] += 1
            h.total_count += 1
            pos += 1
        h.bit_cost = h.compute_bit_cost()
        block_histograms.append(h)

    out = [ClusterHistogram(alphabet_size) for _ in range(num_blocks)]
    cluster_histograms(
        block_histograms, num_blocks, MAX_NUMBER_OF_BLOCK_TYPES, out, symbols
    )

    INVALID = -1
    new_index = [INVALID] * num_blocks
    next_index = 0
    cur_length = 0
    for i in range(num_blocks):
        cur_length += block_lengths[i]
        if i + 1 == num_blocks or symbols[i] != symbols[i + 1]:
            sym = symbols[i]
            if new_index[sym] == INVALID:
                new_index[sym] = next_index
                next_index += 1
            split.types.append(new_index[sym])
            split.lengths.append(cur_length)
            cur_length = 0
    split.num_blocks = len(split.types)
    split.num_types = next_index


def split_block(
    commands, data, offset, mask, quality,
    literal_split: BlockSplit, command_split: BlockSplit, distance_split: BlockSplit,
) -> None:
    """Extract the 3 symbol streams and split each (block-splitter.ts:394-464)."""
    literals = []
    cmd_codes = []
    dist_codes = []
    pos = offset
    for cmd in commands:
        for _ in range(cmd.insert_len):
            literals.append(data[pos & mask])
            pos += 1
        cmd_codes.append(cmd.cmd_prefix)
        if cmd.cmd_prefix >= 128:
            dist_codes.append(cmd.dist_prefix & 0x3FF)
        pos += cmd.copy_length()

    if literals:
        split_byte_vector(
            literals, len(literals), 256, 512, 64, 70, 26.0, quality, literal_split
        )
    else:
        literal_split.num_types = 1
        literal_split.num_blocks = 0
    if cmd_codes:
        split_byte_vector(
            cmd_codes, len(cmd_codes), 704, 1024, 64, 50, 28.1, quality, command_split
        )
    else:
        command_split.num_types = 1
        command_split.num_blocks = 0
    if dist_codes:
        split_byte_vector(
            dist_codes, len(dist_codes), 544, 512, 64, 50, 28.1, quality, distance_split
        )
    else:
        distance_split.num_types = 1
        distance_split.num_blocks = 0
