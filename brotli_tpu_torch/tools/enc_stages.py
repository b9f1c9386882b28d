"""Where the time of one device encode goes, with the match and record
stages as CUDA kernels and as their plain PyTorch versions.

    python3 -m brotli_tpu_torch.tools.enc_stages [--settings a,b,c]

For each setting (`default`: 1024 x 32 KB at the default knobs; `bench`:
the same bytes at the reference bench's encode setting; `v3`: 1024 x 4 KB
at the v3 cell's setting) it encodes the corpus through
utils.profiling.profile_device_encode four times in turns: the plain
stages (find_matches_ref and build_records_ref in the kernels' place),
the kernels, the kernels, the plain stages.  Each run prints its stages
(CUDA events at each stage's ends: upload, matches, parse, records, host
tables, pack, assembly) and its wall (host clock); the streams of every
run must be byte-identical.  A warm-up encode of each kind comes first.
Prints the card's name and power limit; the last line is the runs as
JSON.  Needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess

SETTINGS = {
    "default": (32768, dict()),
    # bench.py:62-67, :285-291
    "bench": (32768, dict(chain_depth=4, table_groups=8, lit_ctx_trees=8,
                          hist_stride=16, sample_stride=2048)),
    # bench.py:68-72, 336-344, one of the v3 cell's six encodes
    "v3": (4096, dict(max_distance=1008, chain_depth=4, table_groups=1,
                      lit_ctx_trees=8)),
}


@contextlib.contextmanager
def plain_stages():
    """The encoder's match and record stages run as their plain PyTorch
    versions while the context is open (device_stages looks both up in
    ops/device_encode by name at each call)."""
    from ..ops import device_encode as E

    saved = E.find_matches, E.build_records
    E.find_matches, E.build_records = E.find_matches_ref, E.build_records_ref
    try:
        yield
    finally:
        E.find_matches, E.build_records = saved


def encode(data: bytes, chunk: int, knobs: dict, plain: bool):
    """(streams, {stage: ms}, wall s) of one profiled encode on the card."""
    from ..utils.profiling import profile_device_encode

    ctx = plain_stages() if plain else contextlib.nullcontext()
    with ctx:
        streams, phases, summary, _ = profile_device_encode(
            data, "cuda", chunk_size=chunk, **knobs)
    return (streams, {p.name: p.seconds * 1e3 for p in phases},
            summary["wall_s"])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings", default=",".join(SETTINGS))
    args = ap.parse_args()
    from ..utils.benchmarks import corpus

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    out = {}
    for name in args.settings.split(","):
        chunk, knobs = SETTINGS[name]
        data = corpus(1024 * chunk)
        for plain in (True, False):
            encode(data, chunk, knobs, plain)          # warm-up
        runs, first = [], None
        for plain in (True, False, False, True):
            streams, stages, wall = encode(data, chunk, knobs, plain)
            first = first or streams
            if streams != first:
                raise RuntimeError(f"{name}: the streams of the "
                                   f"{'plain' if plain else 'kernel'} "
                                   "stages differ")
            kind = "plain stages" if plain else "kernels"
            runs.append({"stages": kind, "stages_ms": stages,
                         "wall_ms": wall * 1e3})
            parts = ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
            print(f"[enc stages] {card}: {name} ({len(data)} B, {knobs}), "
                  f"{kind}: {parts} ms; stages sum "
                  f"{sum(stages.values()):.4f} ms; wall {wall * 1e3:.3f} ms "
                  f"({len(data) / wall / 1e6:.3f} MB/s, host clock)")
        ratio = sum(map(len, first)) / len(data)
        print(f"[enc stages] {name}: the 4 runs' streams byte-identical, "
              f"ratio {ratio:.6f}")
        out[name] = {"bytes": len(data), "knobs": knobs, "ratio": ratio,
                     "runs": runs}
    print(json.dumps({"card": card, "settings": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
