"""Hash-chain hasher (qualities 5-9), reference hash-chains.ts.

Bucket heads + per-position chain links; probes the extended distance cache
first, then walks at most 1<<block_bits chain links.  Uninitialized buckets
and chains read as 0 — a deliberate parity with the reference's zero-filled
typed arrays, since spurious position-0 probes affect match choice.
"""

from __future__ import annotations

from .matching import (
    MIN_MATCH_LEN,
    SearchResult,
    backward_reference_score,
    backward_reference_score_using_last_distance,
    find_match_length,
    hash_bytes_h4,
    prepare_distance_cache,
)


class BackwardMatch:
    __slots__ = ("distance", "length", "score", "len_code_delta")

    def __init__(self, distance, length, score=0, len_code_delta=0):
        self.distance = distance
        self.length = length
        self.score = score
        self.len_code_delta = len_code_delta


class HashChainHasher:
    def __init__(self, quality: int, lgwin: int):
        if quality < 7:
            self.bucket_bits = 14
            self.num_last_distances = 4
        elif quality < 9:
            self.bucket_bits = 15
            self.num_last_distances = 10
        else:
            self.bucket_bits = 15
            self.num_last_distances = 16
        self.block_bits = quality - 1
        self.window_mask = (1 << lgwin) - 1
        self.buckets = [0] * (1 << self.bucket_bits)
        self.chains = [0] * (1 << lgwin)

    def store(self, data, mask: int, ix: int) -> None:
        key = hash_bytes_h4(data, ix & mask, self.bucket_bits)
        minor = ix & self.window_mask
        self.chains[minor] = self.buckets[key]
        self.buckets[key] = ix

    def store_range(self, data, mask, ix_start, ix_end) -> None:
        for i in range(ix_start, ix_end):
            self.store(data, mask, i)

    def find_longest_match(
        self, data, mask, dist_cache, cur_ix, max_length, max_backward, out: SearchResult
    ) -> None:
        cur = cur_ix & mask
        best_len = out.len
        best_score = out.score
        key = hash_bytes_h4(data, cur, self.bucket_bits)
        minor = cur_ix & self.window_mask
        out.len_code_delta = 0
        prepare_distance_cache(dist_cache, self.num_last_distances)

        for i in range(self.num_last_distances):
            backward = dist_cache[i]
            if backward <= 0 or backward > max_backward:
                continue
            prev = (cur_ix - backward) & mask
            if data[prev + best_len] != data[cur + best_len]:
                continue
            ln = find_match_length(data, prev, cur, max_length)
            if ln >= MIN_MATCH_LEN:
                score = backward_reference_score_using_last_distance(ln)
                if score > best_score:
                    best_len = ln
                    best_score = score
                    out.len = ln
                    out.distance = backward
                    out.score = score

        chains = self.chains
        wmask = self.window_mask
        chains[minor] = self.buckets[key]
        self.buckets[key] = cur_ix
        prev_ix = chains[minor]
        for _ in range(1 << self.block_bits):
            backward = cur_ix - prev_ix
            if backward <= 0 or backward > max_backward:
                break
            prev = prev_ix & mask
            if data[prev + best_len] != data[cur + best_len]:
                prev_ix = chains[prev_ix & wmask]
                continue
            ln = find_match_length(data, prev, cur, max_length)
            if ln >= MIN_MATCH_LEN:
                score = backward_reference_score(ln, backward)
                if score > best_score:
                    best_len = ln
                    best_score = score
                    out.len = ln
                    out.distance = backward
                    out.score = score
            prev_ix = chains[prev_ix & wmask]

    def find_all_matches(
        self, data, mask, dist_cache, cur_ix, max_length, max_backward
    ) -> list[BackwardMatch]:
        cur = cur_ix & mask
        matches: list[BackwardMatch] = []
        key = hash_bytes_h4(data, cur, self.bucket_bits)
        minor = cur_ix & self.window_mask
        best_len = 0
        prepare_distance_cache(dist_cache, self.num_last_distances)
        for i in range(self.num_last_distances):
            backward = dist_cache[i]
            if backward <= 0 or backward > max_backward:
                continue
            prev = (cur_ix - backward) & mask
            ln = find_match_length(data, prev, cur, max_length)
            if ln >= MIN_MATCH_LEN and ln > best_len:
                best_len = ln
                matches.append(
                    BackwardMatch(
                        backward, ln, backward_reference_score_using_last_distance(ln)
                    )
                )
        chains = self.chains
        chains[minor] = self.buckets[key]
        self.buckets[key] = cur_ix
        prev_ix = chains[minor]
        for _ in range(1 << self.block_bits):
            backward = cur_ix - prev_ix
            if backward <= 0 or backward > max_backward:
                break
            prev = prev_ix & mask
            ln = find_match_length(data, prev, cur, max_length)
            if ln >= MIN_MATCH_LEN and ln > best_len:
                best_len = ln
                matches.append(
                    BackwardMatch(backward, ln, backward_reference_score(ln, backward))
                )
            prev_ix = chains[prev_ix & self.window_mask]
        matches.sort(key=lambda m: m.length)  # stable, matches insertion sort
        return matches
