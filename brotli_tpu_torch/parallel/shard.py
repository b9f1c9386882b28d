"""Parallel encode via independent metablock shards (SURVEY.md section 2.3).

A file is split into window-independent shards; each shard is encoded as a
byte-aligned fragment (encode_fragment: non-last fragments end with an empty
metadata block whose header re-aligns the reader), and the compressed stream
is the ordered concatenation.  Shards are embarrassingly parallel — here over
host processes; the device encode path will slot into the same interface.
"""

from __future__ import annotations

from concurrent.futures import ProcessPoolExecutor

from ..encode.api import encode_fragment


def shard_file(data: bytes, shard_size: int) -> list[bytes]:
    return [data[i : i + shard_size] for i in range(0, max(len(data), 1), shard_size)]


def _encode_one(args):
    shard, quality, lgwin, mode, first, last, prelude, out_offset = args
    return encode_fragment(
        shard, quality=quality, lgwin=lgwin, mode=mode, first=first, last=last,
        context_prelude=prelude, out_offset=out_offset,
    )


def parallel_encode(
    data: bytes,
    *,
    quality: int = 5,
    lgwin: int | None = None,
    mode: int | None = None,
    shard_size: int = 1 << 20,
    num_workers: int | None = None,
) -> bytes:
    """Encode `data` as an ordered concatenation of independent fragments."""
    data = bytes(data)
    shards = shard_file(data, shard_size)
    jobs = []
    for i, s in enumerate(shards):
        # literal-context prelude: the 2 bytes preceding this shard
        off = i * shard_size
        prelude = (
            (data[off - 1], data[off - 2]) if off >= 2 else (0, 0)
        )
        jobs.append(
            (s, quality, lgwin, mode, i == 0, i == len(shards) - 1, prelude, off)
        )
    if len(jobs) == 1 or (num_workers is not None and num_workers <= 1):
        frags = [_encode_one(j) for j in jobs]
    else:
        with ProcessPoolExecutor(max_workers=num_workers) as pool:
            frags = list(pool.map(_encode_one, jobs))
    return b"".join(frags)
