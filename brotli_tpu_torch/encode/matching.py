"""Match finding primitives: hashes, match length, scoring.

Decision-critical: scores and hash functions must match the reference
(match.ts) exactly, because they choose which matches are emitted and that
reaches the bitstream.  The ops.hashing device kernels vectorize the same
functions across all positions.
"""

from __future__ import annotations

LITERAL_BYTE_SCORE = 135
DISTANCE_BIT_PENALTY = 30
SCORE_BASE = DISTANCE_BIT_PENALTY * 8 * 4
HASH_MUL_32 = 0x1E35A7BD
MIN_MATCH_LEN = 4


def log2_floor_nonzero(n: int) -> int:
    return n.bit_length() - 1


def backward_reference_score(copy_length: int, backward_distance: int) -> int:
    return (
        SCORE_BASE
        + LITERAL_BYTE_SCORE * copy_length
        - DISTANCE_BIT_PENALTY * log2_floor_nonzero(backward_distance)
    )


def backward_reference_score_using_last_distance(copy_length: int) -> int:
    return LITERAL_BYTE_SCORE * copy_length + SCORE_BASE + 15


def backward_reference_penalty_using_last_distance(distance_short_code: int) -> int:
    return 39 + ((0x1CA10 >> (distance_short_code & 0xE)) & 0xE)


def find_match_length(data, s1: int, s2: int, limit: int) -> int:
    matched = 0
    while matched < limit and data[s1 + matched] == data[s2 + matched]:
        matched += 1
    return matched


def hash_bytes_h5(data, pos: int, bucket_bits: int) -> int:
    """5-byte hash used by the simple and chain hashers (match.ts:177-186)."""
    h32 = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16) | (data[pos + 3] << 24)
    h = ((h32 ^ (data[pos + 4] << 24)) * HASH_MUL_32) & 0xFFFFFFFF
    return h >> (32 - bucket_bits)


def hash_bytes_h4(data, pos: int, bucket_bits: int) -> int:
    h32 = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16) | (data[pos + 3] << 24)
    return ((h32 * HASH_MUL_32) & 0xFFFFFFFF) >> (32 - bucket_bits)


def prepare_distance_cache(dist_cache: list[int], num_distances: int) -> None:
    if num_distances > 4:
        last = dist_cache[0]
        dist_cache[4:10] = [last - 1, last + 1, last - 2, last + 2, last - 3, last + 3]
        if num_distances > 10:
            nxt = dist_cache[1]
            dist_cache[10:16] = [nxt - 1, nxt + 1, nxt - 2, nxt + 2, nxt - 3, nxt + 3]


class SearchResult:
    __slots__ = ("len", "distance", "score", "len_code_delta")

    def __init__(self):
        self.reset()

    def reset(self):
        self.len = 0
        self.distance = 0
        self.score = 0
        self.len_code_delta = 0


class SimpleHasher:
    """Single-entry forgetful hash table, quality 2-4 (hash-simple.ts).

    Quality 1 also uses this (bucket bits 17).
    """

    HASH_LEN = 5

    def __init__(self, quality: int):
        self.bucket_bits = 16 if quality == 2 else 17
        self.buckets = [0] * (1 << self.bucket_bits)

    def store(self, data, mask: int, ix: int) -> None:
        self.buckets[hash_bytes_h5(data, ix & mask, self.bucket_bits)] = ix

    def store_range(self, data, mask, ix_start, ix_end) -> None:
        for i in range(ix_start, ix_end):
            self.store(data, mask, i)

    def find_longest_match(
        self, data, mask: int, dist_cache, cur_ix: int,
        max_length: int, max_backward: int, out: SearchResult,
    ) -> None:
        cur = cur_ix & mask
        best_len = out.len
        best_score = out.score
        key = hash_bytes_h5(data, cur, self.bucket_bits)
        out.len_code_delta = 0

        cached = dist_cache[0]
        if 0 < cached <= max_backward:
            prev = (cur_ix - cached) & mask
            if data[prev + best_len] == data[cur + best_len]:
                ln = find_match_length(data, prev, cur, max_length)
                if ln >= MIN_MATCH_LEN:
                    score = backward_reference_score_using_last_distance(ln)
                    if score > best_score:
                        best_len = ln
                        best_score = score
                        out.len = ln
                        out.distance = cached
                        out.score = score

        prev_ix = self.buckets[key]
        self.buckets[key] = cur_ix
        backward = cur_ix - prev_ix
        if backward == 0 or backward > max_backward:
            return
        prev = prev_ix & mask
        if data[prev + best_len] != data[cur + best_len]:
            return
        ln = find_match_length(data, prev, cur, max_length)
        if ln >= MIN_MATCH_LEN:
            score = backward_reference_score(ln, backward)
            if score > best_score:
                out.len = ln
                out.distance = backward
                out.score = score
