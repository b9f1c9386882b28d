"""Encoder-side static-dictionary matching (identity transforms).

The reference ships a static-dictionary encoder that nothing calls
(static-dict.ts:44-149, dead code); this is a live implementation per the
north-star requirement ("static-dictionary matches enabled" at q5).

Exact-match only, identity transform (index 0): a dictionary word of
length L at index W is referenced by emitting a normal copy of length L
with distance = max_distance + 1 + W, where max_distance =
min(stream_position, window_size - 16) is the DECODER's clamp
(engine.ts:903-945 / our decode.engine dict branch).  Dictionary
references do not update the distance ring on either side.
"""

from __future__ import annotations

import functools

from ..constants import DICT_OFFSETS_BY_LENGTH, DICT_SIZE_BITS_BY_LENGTH

MIN_DICT_WORD = 4
MAX_DICT_WORD = 10   # longer exact matches are vanishingly rare


@functools.lru_cache(maxsize=1)
def _word_tables() -> dict[int, dict[bytes, int]]:
    from ..decode.dictionary import get_dictionary

    data = get_dictionary()
    tables: dict[int, dict[bytes, int]] = {}
    for length in range(MIN_DICT_WORD, MAX_DICT_WORD + 1):
        nwords = 1 << int(DICT_SIZE_BITS_BY_LENGTH[length])
        off = int(DICT_OFFSETS_BY_LENGTH[length])
        t: dict[bytes, int] = {}
        for idx in range(nwords):
            w = data[off + idx * length : off + (idx + 1) * length]
            t.setdefault(w, idx)
        tables[length] = t
    return tables


def find_dictionary_match(data, pos: int, max_len: int):
    """Longest identity-transform dictionary word matching data[pos:].

    Returns (length, word_index) or None."""
    tables = _word_tables()
    hi = min(max_len, MAX_DICT_WORD)
    for length in range(hi, MIN_DICT_WORD - 1, -1):
        idx = tables[length].get(bytes(data[pos : pos + length]))
        if idx is not None:
            return length, idx
    return None
