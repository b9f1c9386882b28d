"""Zopfli optimal parse (qualities 10-11), reference backward-references-hq.ts.

q10: single pass with a heuristic literal-cost model.
q11: match pre-collection, then two DP iterations (literal-cost model, then
actual command histograms).  Decision-critical quirks preserved:
  * max backward hardcoded to (1<<22)-16,
  * queue of 8 start positions sorted by costdiff.
Documented divergences (both FIX reference bugs, per the north star's
"size <= reference" contract; see inline comments):
  * distance cache reconstruction continues from the pre-block cache instead
    of reading OOB (backward-references-hq.ts:232),
  * hasher-match distance costs use the prefix-encoded distance SYMBOL, not
    the raw (dist+15) value as a cost index (backward-references-hq.ts:340),
    which in the reference NaN-poisons half of all far matches.
"""

from __future__ import annotations

import math

from ..constants import (
    COPY_LENGTH_N_BITS,
    INSERT_LENGTH_N_BITS,
    combine_length_codes,
    get_copy_length_code,
    get_insert_length_code,
)
from .command import Command, make_command, prefix_encode_copy_distance
from .cost_model import INFINITY_COST, ZopfliCostModel
from .matching import find_match_length
from .hash_binary_tree import BinaryTreeHasher

MAX_BACKWARD_LIMIT = (1 << 22) - 16
LONG_COPY_QUICK_STEP = 16384
_DIST_CACHE_INDEX = [0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1]
_DIST_CACHE_OFFSET = [0, 0, 0, 0, -1, 1, -2, 2, -3, 3, -1, 1, -2, 2, -3, 3]
_INS_EXTRA = INSERT_LENGTH_N_BITS.tolist()
_CP_EXTRA = COPY_LENGTH_N_BITS.tolist()

NEXT_END = 0xFFFFFFFF


def max_zopfli_len(quality: int) -> int:
    return 150 if quality <= 10 else 325


def max_zopfli_candidates(quality: int) -> int:
    return 1 if quality <= 10 else 5


class ZopfliNode:
    __slots__ = ("length", "distance", "dcode_insert_length", "cost", "shortcut")

    def __init__(self):
        self.reset()

    def reset(self):
        self.length = 1
        self.distance = 0
        self.dcode_insert_length = 0
        self.cost = INFINITY_COST
        self.shortcut = 0

    def copy_length(self) -> int:
        return self.length & 0x1FFFFFF

    def length_code(self) -> int:
        return self.copy_length() + 9 - (self.length >> 25)

    def distance_code(self) -> int:
        short = self.dcode_insert_length >> 27
        return self.distance + 15 if short == 0 else short - 1

    def insert_length(self) -> int:
        return self.dcode_insert_length & 0x7FFFFFF

    def command_length(self) -> int:
        return self.copy_length() + self.insert_length()


class _PosData:
    __slots__ = ("pos", "distance_cache", "costdiff", "cost")

    def __init__(self, pos=0, distance_cache=(0, 0, 0, 0), costdiff=INFINITY_COST, cost=INFINITY_COST):
        self.pos = pos
        self.distance_cache = list(distance_cache)
        self.costdiff = costdiff
        self.cost = cost


class StartPosQueue:
    def __init__(self):
        self.q = [_PosData() for _ in range(8)]
        self.idx = 0

    def push(self, pos, cost, costdiff, distance_cache) -> None:
        offset = (~self.idx) & 7
        self.idx += 1
        self.q[offset] = _PosData(pos, list(distance_cache), costdiff, cost)
        for i in range(1, self.size()):
            a = (offset + i - 1) & 7
            b = (offset + i) & 7
            if self.q[a].costdiff > self.q[b].costdiff:
                self.q[a], self.q[b] = self.q[b], self.q[a]

    def size(self) -> int:
        return min(self.idx, 8)

    def at(self, k: int) -> _PosData:
        return self.q[(k - self.idx) & 7]


def _compute_distance_shortcut(block_start, pos, nodes,
                               max_window=MAX_BACKWARD_LIMIT) -> int:
    if pos == 0:
        return 0
    node = nodes[pos]
    clen = node.copy_length()
    ilen = node.insert_length()
    dist = node.distance
    if (
        dist + clen <= block_start + pos
        and dist <= max_window
        and node.distance_code() > 0
    ):
        return pos
    return nodes[pos - clen - ilen].shortcut


def _compute_distance_cache(pos, starting_cache, nodes, out_cache) -> None:
    idx = 0
    p = nodes[pos].shortcut
    while idx < 4 and p > 0:
        node = nodes[p]
        out_cache[idx] = node.distance
        idx += 1
        p = nodes[p - node.copy_length() - node.insert_length()].shortcut
    filled = idx
    while idx < 4:
        # Deliberate divergence from the reference: backward-references-hq.ts:232
        # indexes startingDistCache at (2*idx - 4), which for an empty shortcut
        # chain reads OOB (JS yields 0) and poisons the DP's view of the initial
        # distance ring -> the reference emits corrupt q10/11 streams on inputs
        # with early matches at distances 1-7 (unexercised by its fuzz corpus).
        # We continue from the pre-block cache in order, like Google's C
        # ComputeDistanceCache (brotli/c/enc/backward_references_hq.c).
        out_cache[idx] = starting_cache[idx - filled]
        idx += 1


def _evaluate_node(block_start, pos, starting_cache, model, queue, nodes,
                   max_window=MAX_BACKWARD_LIMIT) -> None:
    node_cost = nodes[pos].cost
    nodes[pos].shortcut = _compute_distance_shortcut(
        block_start, pos, nodes, max_window
    )
    if node_cost <= model.get_literal_costs(0, pos):
        cache = [0, 0, 0, 0]
        _compute_distance_cache(pos, starting_cache, nodes, cache)
        queue.push(pos, node_cost, node_cost - model.get_literal_costs(0, pos), cache)


def _compute_minimum_copy_length(start_cost, nodes, num_bytes, pos) -> int:
    min_cost = start_cost
    ln = 2
    next_len_bucket = 4
    next_len_offset = 10
    while pos + ln <= num_bytes and nodes[pos + ln].cost <= min_cost:
        ln += 1
        if ln == next_len_offset:
            min_cost += 1.0
            next_len_offset += next_len_bucket
            next_len_bucket *= 2
    return ln


def _update_zopfli_node(nodes, pos, start_pos, ln, len_code, dist, short_code, cost):
    node = nodes[pos + ln]
    node.length = ln | ((ln + 9 - len_code) << 25)
    node.distance = dist
    node.dcode_insert_length = (short_code << 27) | (pos - start_pos)
    node.cost = cost


def _update_nodes(
    num_bytes, block_start, pos, data, mask, quality,
    starting_cache, matches, model, queue, nodes,
    npostfix=0, ndirect=0, max_window=MAX_BACKWARD_LIMIT,
) -> int:
    cur_ix = block_start + pos
    cur = cur_ix & mask
    max_distance = min(cur_ix, max_window)
    max_len = num_bytes - pos
    max_zlen = max_zopfli_len(quality)
    max_iters = max_zopfli_candidates(quality)

    _evaluate_node(block_start, pos, starting_cache, model, queue, nodes,
                   max_window)

    posdata0 = queue.at(0)
    min_cost = (
        posdata0.cost + model.get_min_cost_cmd()
        + model.get_literal_costs(posdata0.pos, pos)
    )
    min_len = _compute_minimum_copy_length(min_cost, nodes, num_bytes, pos)

    result = 0
    for k in range(min(max_iters, queue.size())):
        posdata = queue.at(k)
        start = posdata.pos
        ins_code = get_insert_length_code(pos - start)
        base_cost = (
            posdata.costdiff + _INS_EXTRA[ins_code] + model.get_literal_costs(0, pos)
        )

        # distance-cache candidates
        best_len = min_len - 1
        for j in range(16):
            if best_len >= max_len:
                break
            backward = posdata.distance_cache[_DIST_CACHE_INDEX[j]] + _DIST_CACHE_OFFSET[j]
            if backward <= 0 or backward > max_distance:
                continue
            prev = (cur_ix - backward) & mask
            if cur + best_len > mask:
                break
            if data[prev + best_len] != data[cur + best_len]:
                continue
            ln = find_match_length(data, prev, cur, max_len)
            if ln >= 4:
                dist_cost = base_cost + model.get_distance_cost(j)
                for l in range(best_len + 1, ln + 1):
                    copy_code = get_copy_length_code(l)
                    cmd_code = combine_length_codes(ins_code, copy_code, j == 0)
                    cost = (
                        (base_cost if cmd_code < 128 else dist_cost)
                        + _CP_EXTRA[copy_code]
                        + model.get_command_cost(cmd_code)
                    )
                    if cost < nodes[pos + l].cost:
                        _update_zopfli_node(nodes, pos, start, l, l, backward, j + 1, cost)
                        result = max(result, l)
                    best_len = l

        if k >= 2:
            continue

        # hasher matches
        match_len = min_len
        for m in matches:
            dist = m.distance
            is_dict = dist > max_distance
            # Deliberate divergence from the reference: backward-references-
            # hq.ts:340-345 prices a match at costDist[dist + 15], a raw
            # distance used as a SYMBOL index — any dist in [529,1008] mod
            # 1024 reads past the 544-entry cost array (NaN cost in JS), so
            # the reference's own Zopfli silently rejects ~half of all far
            # matches and q10/11 compress WORSE than q9 on text.  Google's C
            # (backward_references_hq.c UpdateNodes) prefix-encodes the
            # distance to its real symbol first; we do the same, which is
            # also what makes pass-2 costs (histograms of real symbols)
            # consistent.  Measured: alice29 q11 59390 -> ~49K bytes.
            dist_sym, _, nbits = prefix_encode_copy_distance(
                dist + 15, ndirect, npostfix
            )
            dist_cost = base_cost + nbits + model.get_distance_cost(dist_sym & 0x3FF)
            max_match_len = m.length
            if match_len < max_match_len and (is_dict or max_match_len > max_zlen):
                match_len = max_match_len
            while match_len <= max_match_len:
                len_code = m.length + m.len_code_delta if is_dict else match_len
                copy_code = get_copy_length_code(len_code)
                cmd_code = combine_length_codes(ins_code, copy_code, False)
                cost = dist_cost + _CP_EXTRA[copy_code] + model.get_command_cost(cmd_code)
                if cost < nodes[pos + match_len].cost:
                    _update_zopfli_node(
                        nodes, pos, start, match_len, len_code, dist, 0, cost
                    )
                    result = max(result, match_len)
                match_len += 1
    return result


def _compute_shortest_path(num_bytes, nodes) -> None:
    index = num_bytes
    while nodes[index].insert_length() == 0 and nodes[index].length == 1:
        index -= 1
    nodes[index].cost = NEXT_END
    while index != 0:
        ln = nodes[index].command_length()
        index -= ln
        nodes[index].cost = ln


def _create_commands_from_path(
    num_bytes, block_start, nodes, dist_cache, last_insert_len, npostfix,
    ndirect, max_window=MAX_BACKWARD_LIMIT,
) -> tuple[list[Command], int, int]:
    commands: list[Command] = []
    num_literals = 0
    pos = 0
    offset = nodes[0].cost
    is_first = True
    while offset != NEXT_END and offset != 0:
        nxt = nodes[pos + int(offset)]
        copy_len = nxt.copy_length()
        insert_len = nxt.insert_length()
        pos += insert_len
        if is_first:
            insert_len += last_insert_len
            is_first = False
        distance = nxt.distance
        len_code = nxt.length_code()
        dist_code = nxt.distance_code()
        commands.append(
            make_command(insert_len, copy_len, len_code - copy_len, dist_code,
                         ndirect, npostfix)
        )
        dictionary_start = min(block_start + pos, max_window)
        if not (distance > dictionary_start) and dist_code > 0:
            dist_cache[3] = dist_cache[2]
            dist_cache[2] = dist_cache[1]
            dist_cache[1] = dist_cache[0]
            dist_cache[0] = distance
        num_literals += insert_len
        pos += copy_len
        offset = nxt.cost
    return commands, num_literals, num_bytes - pos


def _trim_long_matches(matches, max_zlen):
    if matches:
        longest = matches[-1]
        if longest.length > max_zlen:
            return [longest]
    return matches


def create_zopfli_backward_references(
    num_bytes, position, data, mask, hasher: BinaryTreeHasher,
    dist_cache, last_insert_len, npostfix=0, ndirect=0, quality=10,
    max_window: int | None = None,
) -> tuple[list[Command], int, int]:
    mw = MAX_BACKWARD_LIMIT if max_window is None else max_window
    max_zlen = max_zopfli_len(quality)
    nodes = [ZopfliNode() for _ in range(num_bytes + 1)]
    nodes[0].length = 0
    nodes[0].cost = 0.0
    model = ZopfliCostModel(num_bytes, 544)
    model.set_from_literal_costs(position, data, mask)
    queue = StartPosQueue()
    i = 0
    while i + 3 < num_bytes:
        pos = position + i
        max_distance = min(pos, mw)
        matches = hasher.find_all_matches(data, mask, pos, num_bytes - i, max_distance)
        matches = _trim_long_matches(matches, max_zlen)
        skip = _update_nodes(
            num_bytes, position, i, data, mask, quality,
            dist_cache, matches, model, queue, nodes, npostfix, ndirect, mw,
        )
        if skip >= LONG_COPY_QUICK_STEP:
            i += skip - 1
        elif len(matches) == 1 and matches[0].length > max_zlen:
            i += matches[0].length - 1
        i += 1
    _compute_shortest_path(num_bytes, nodes)
    return _create_commands_from_path(
        num_bytes, position, nodes, dist_cache, last_insert_len, npostfix,
        ndirect, mw,
    )


def create_hq_zopfli_backward_references(
    num_bytes, position, data, mask, hasher: BinaryTreeHasher,
    dist_cache, last_insert_len, npostfix=0, ndirect=0,
    max_window: int | None = None,
) -> tuple[list[Command], int, int]:
    quality = 11
    mw = MAX_BACKWARD_LIMIT if max_window is None else max_window
    max_zlen = max_zopfli_len(quality)

    # pass A: collect matches for every position
    all_matches: list[list] = [[] for _ in range(num_bytes)]
    match_idx = 0
    i = 0
    while i + 3 < num_bytes:
        pos = position + i
        max_distance = min(pos, mw)
        matches = hasher.find_all_matches(data, mask, pos, num_bytes - i, max_distance)
        if matches and matches[-1].length > max_zlen:
            longest = matches[-1]
            skip = longest.length - 1
            all_matches[match_idx] = [longest]
            match_idx += 1
            j = 0
            while j < skip and i + j + 1 < num_bytes:
                all_matches[match_idx] = []
                match_idx += 1
                j += 1
            i += skip + 1
            continue
        all_matches[match_idx] = matches
        match_idx += 1
        i += 1

    orig_dist_cache = list(dist_cache)
    orig_last_insert_len = last_insert_len
    model = ZopfliCostModel(num_bytes, 544)
    commands: list[Command] = []
    num_literals = 0
    final_last_insert_len = last_insert_len
    nodes = [ZopfliNode() for _ in range(num_bytes + 1)]

    for iteration in range(2):
        if iteration > 0:
            for n in nodes:
                n.reset()
        nodes[0].length = 0
        nodes[0].cost = 0.0
        dist_cache[:] = orig_dist_cache
        last_insert_len = orig_last_insert_len
        if iteration == 0:
            model.set_from_literal_costs(position, data, mask)
        else:
            model.set_from_commands(position, data, mask, commands, orig_last_insert_len)
        queue = StartPosQueue()
        i = 0
        while i + 3 < num_bytes:
            matches = all_matches[i]
            skip = _update_nodes(
                num_bytes, position, i, data, mask, quality,
                dist_cache, matches, model, queue, nodes, npostfix, ndirect,
                mw,
            )
            if skip >= LONG_COPY_QUICK_STEP:
                i += skip - 1
            elif len(matches) == 1 and matches[0].length > max_zlen:
                i += matches[0].length - 1
            i += 1
        _compute_shortest_path(num_bytes, nodes)
        commands, num_literals, final_last_insert_len = _create_commands_from_path(
            num_bytes, position, nodes, dist_cache, last_insert_len, npostfix,
            ndirect, mw,
        )
    return commands, num_literals, final_last_insert_len
