"""Binary-tree hasher (qualities 10-11), reference hash-binary-tree.ts.

Each 17-bit bucket roots a binary tree over window positions ordered
lexicographically; every probe re-roots the tree at the probing position
(when a full-depth comparison is possible).  The traversal ORDER defines the
match set the Zopfli DP sees, so it is replicated exactly.
"""

from __future__ import annotations

from .hash_chains import BackwardMatch
from .matching import backward_reference_score, find_match_length, hash_bytes_h4

BUCKET_BITS = 17
MAX_TREE_COMP_LENGTH = 128
MAX_TREE_SEARCH_DEPTH = 64
WINDOW_GAP = 16


class BinaryTreeHasher:
    def __init__(self, lgwin: int, input_size: int | None = None):
        self.window_mask = (1 << lgwin) - 1
        self.invalid_pos = (0x100000000 - self.window_mask) & 0xFFFFFFFF
        self.buckets = [self.invalid_pos] * (1 << BUCKET_BITS)
        num_nodes = (
            min(input_size, 1 << lgwin) if input_size is not None else 1 << lgwin
        )
        self.forest = [self.invalid_pos] * (2 * num_nodes)

    def store_and_find_matches(
        self, data, cur_ix, mask, max_length, max_backward, matches
    ):
        cur = cur_ix & mask
        max_comp_len = min(max_length, MAX_TREE_COMP_LENGTH)
        reroot = max_length >= MAX_TREE_COMP_LENGTH
        key = hash_bytes_h4(data, cur, BUCKET_BITS)
        forest = self.forest
        wmask = self.window_mask
        invalid = self.invalid_pos

        prev_ix = self.buckets[key]
        node_left = 2 * (cur_ix & wmask)
        node_right = 2 * (cur_ix & wmask) + 1
        best_len_left = 0
        best_len_right = 0
        best_len = 1 if matches is not None else 0
        result = matches if matches is not None else []

        if reroot:
            self.buckets[key] = cur_ix

        for _ in range(MAX_TREE_SEARCH_DEPTH):
            if prev_ix == invalid:
                if reroot:
                    forest[node_left] = invalid
                    forest[node_right] = invalid
                break
            backward = cur_ix - prev_ix
            prev = prev_ix & mask
            if backward <= 0 or backward > max_backward:
                if reroot:
                    forest[node_left] = invalid
                    forest[node_right] = invalid
                break
            cur_len = min(best_len_left, best_len_right)
            ln = cur_len + find_match_length(
                data, cur + cur_len, prev + cur_len, max_length - cur_len
            )
            if matches is not None and ln > best_len:
                best_len = ln
                result.append(
                    BackwardMatch(backward, ln, backward_reference_score(ln, backward))
                )
            if ln >= max_comp_len:
                if reroot:
                    forest[node_left] = forest[2 * (prev_ix & wmask)]
                    forest[node_right] = forest[2 * (prev_ix & wmask) + 1]
                break
            if data[cur + ln] > data[prev + ln]:
                best_len_left = ln
                if reroot:
                    forest[node_left] = prev_ix
                node_left = 2 * (prev_ix & wmask) + 1
                prev_ix = forest[node_left]
            else:
                best_len_right = ln
                if reroot:
                    forest[node_right] = prev_ix
                node_right = 2 * (prev_ix & wmask)
                prev_ix = forest[node_right]
        return result

    def find_all_matches(
        self, data, mask, cur_ix, max_length, max_backward
    ) -> list[BackwardMatch]:
        cur = cur_ix & mask
        matches: list[BackwardMatch] = []
        best_len = 1
        stop = cur_ix - 64 if cur_ix > 64 else 0
        i = cur_ix - 1
        while i > stop and best_len <= 2:
            backward = cur_ix - i
            if backward > max_backward:
                break
            prev = i & mask
            if data[cur] != data[prev] or data[cur + 1] != data[prev + 1]:
                i -= 1
                continue
            ln = find_match_length(data, prev, cur, max_length)
            if ln > best_len:
                best_len = ln
                matches.append(
                    BackwardMatch(backward, ln, backward_reference_score(ln, backward))
                )
            i -= 1
        if best_len < max_length:
            tree_matches = self.store_and_find_matches(
                data, cur_ix, mask, max_length, max_backward, []
            )
            for m in tree_matches:
                if m.length > best_len:
                    best_len = m.length
                    matches.append(m)
        else:
            self.store_and_find_matches(
                data, cur_ix, mask, max_length, max_backward, None
            )
        matches.sort(key=lambda m: m.length)  # stable
        return matches

    def store(self, data, mask, ix) -> None:
        max_backward = self.window_mask - WINDOW_GAP + 1
        self.store_and_find_matches(
            data, ix, mask, MAX_TREE_COMP_LENGTH, max_backward, None
        )

    def store_range(self, data, mask, ix_start, ix_end) -> None:
        i = ix_start
        j = ix_start
        if ix_start + 63 <= ix_end:
            i = ix_end - 63
        if ix_start + 512 <= i:
            while j < i:
                self.store(data, mask, j)
                j += 8
        while i < ix_end:
            self.store(data, mask, i)
            i += 1

    def stitch_to_previous_block(self, num_bytes, position, ring, mask) -> None:
        if num_bytes >= 3 and position >= MAX_TREE_COMP_LENGTH:
            i_start = position - MAX_TREE_COMP_LENGTH + 1
            i_end = min(position, i_start + num_bytes)
            for i in range(i_start, i_end):
                max_backward = self.window_mask - max(WINDOW_GAP - 1, position - i)
                self.store_and_find_matches(
                    ring, i, mask, MAX_TREE_COMP_LENGTH, max_backward, None
                )
