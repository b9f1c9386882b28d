"""Greedy backward-reference selection (qualities 1-9).

Semantics follow the reference scan loop (backward-references.ts:14-134)
exactly — including its quirks that reach the bitstream:
  * max backward window hardcoded to (1<<22)-16 regardless of lgwin,
  * greedy match length capped at 128,
  * q<=2 stores only every 4th position of a match body,
  * store end = min(pos+len, pos_end-4).
"""

from __future__ import annotations

from .command import Command, distance_to_code, make_command, make_insert_command
from .matching import SearchResult

GREEDY_MAX_WINDOW = (1 << 22) - 16  # reference quirk: lgwin-independent


def create_backward_references(
    num_bytes: int,
    position: int,
    data,
    mask: int,
    hasher,
    dist_cache: list[int],
    last_insert_len: int,
    quality: int,
    npostfix: int = 0,
    ndirect: int = 0,
    use_dictionary: bool = False,
    real_max_backward: int | None = None,
    out_offset: int = 0,
    max_match_distance: int | None = None,
    max_window: int | None = None,
) -> tuple[list[Command], int, int]:
    """Returns (commands, num_literals, trailing_insert_len).

    With use_dictionary, positions without an LZ match probe the static
    dictionary (encode/static_dict.py); real_max_backward must then be the
    decoder's window clamp (1<<lgwin)-16 so emitted distances land in the
    dictionary address space.

    max_match_distance caps LZ match distances below the format window —
    used by the sharded TPU layout so every emitted distance fits the
    device resolve kernel's VMEM history ring (ops/pallas_resolve.py).

    max_window overrides the reference's lgwin-independent (1<<22)-16 quirk
    (backward-references.ts:31) — the lgwin-honoring mode SURVEY section 5
    requires (pass (1<<lgwin)-16)."""
    commands: list[Command] = []
    num_literals = 0
    insert_len = last_insert_len
    pos = position
    pos_end = position + num_bytes
    result = SearchResult()
    if use_dictionary:
        from .static_dict import find_dictionary_match

    while pos < pos_end:
        max_len = pos_end - pos
        if max_len < 4:
            insert_len += max_len
            pos += max_len
            break
        max_backward = min(
            pos, GREEDY_MAX_WINDOW if max_window is None else max_window
        )
        if max_match_distance is not None:
            max_backward = min(max_backward, max_match_distance)
        result.reset()
        hasher.find_longest_match(
            data, mask, dist_cache, pos, min(max_len, 128), max_backward, result
        )
        if use_dictionary and result.len < 4:
            dm = find_dictionary_match(data, pos, max_len)
            if dm is not None:
                word_len, word_idx = dm
                max_distance = min(out_offset + pos, real_max_backward)
                distance = max_distance + 1 + word_idx
                commands.append(
                    make_command(
                        insert_len, word_len, 0, distance + 15,
                        ndirect, npostfix,
                    )
                )
                num_literals += insert_len
                # dictionary references do not update the distance ring
                store_end = min(pos + word_len, pos_end - 4)
                step = 4 if quality <= 2 else 1
                for i in range(pos + 1, store_end, step):
                    hasher.store(data, mask, i)
                pos += word_len
                insert_len = 0
                continue
        if result.len >= 4 and result.score > 0 and result.distance > 0:
            distance = result.distance
            match_len = result.len
            if distance > pos:
                insert_len += 1
                pos += 1
                continue
            dist_code = distance_to_code(distance, dist_cache)
            commands.append(
                make_command(
                    insert_len, match_len, result.len_code_delta, dist_code,
                    ndirect, npostfix,
                )
            )
            num_literals += insert_len
            if dist_code > 0:
                dist_cache[3] = dist_cache[2]
                dist_cache[2] = dist_cache[1]
                dist_cache[1] = dist_cache[0]
                dist_cache[0] = distance
            store_end = min(pos + match_len, pos_end - 4)
            step = 4 if quality <= 2 else 1
            for i in range(pos + 1, store_end, step):
                hasher.store(data, mask, i)
            pos += match_len
            insert_len = 0
        else:
            insert_len += 1
            pos += 1

    if insert_len > 0:
        commands.append(make_insert_command(insert_len))
        num_literals += insert_len
        insert_len = 0
    return commands, num_literals, insert_len
