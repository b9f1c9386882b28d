"""Where the host time of one decode_batch_v3_full call goes.

    PYTHONPATH=. python3 brotli_tpu_torch/tools/v3_host_profile.py [--lanes N]
        [--device D]

Builds chip_smoke.py's [v3 full] lanes (N lanes, 1024 by default, of three
64 KB streams: a streaming Encoder(quality=5, lgwin=18) fed 1 KB updates
in 16 KB metablocks, a spliced parallel_encode stream, an uncompressed
one), decodes them once to build and warm up, then once under cProfile,
and prints the call's wall (host clock) and the cumulative time of the
functions that make up a round: the header walk (Python: its bit
reader; C++: walk_units), the table parse and binning (Python:
_MetablockState, _sig_of, assemble_v3; C++: preflight_units_v3_native),
the staging, the kernel and the copies back.  It profiles the package that PYTHONPATH names (the checkout's root
above); a function that package lacks prints as absent, so the script
runs the same against an older checkout named there.  The last line is
the same as JSON.  The device defaults to cuda; prints the card's name
and power limit there.
"""

from __future__ import annotations

import argparse
import cProfile
import json
import os
import pstats
import subprocess
import sys
import time

import torch

# (file suffix, function name) of the functions a round is made of
WATCH = [
    ("ops/decode3.py", "decode_batch_v3_full"),
    ("decode/bitreader.py", "__init__"),
    ("ops/preflight3_native.py", "walk_units"),
    ("decode/engine.py", "__init__"),
    ("ops/preflight3.py", "_sig_of"),
    ("ops/preflight3.py", "assemble_v3"),
    ("ops/preflight3_native.py", "preflight_units_v3_native"),
    ("ops/preflight3_native.py", "parse_units"),
    ("ops/preflight3_native.py", "_assemble"),
    ("ops/decode3.py", "run_batch_v3"),
    ("ops/decode3.py", "batch_to_torch_v3"),
    ("ops/decode3.py", "decode3"),
    ("ops/decode3.py", "_lanes"),
    ("decode/__init__.py", "decode"),
]


def lanes(n: int) -> tuple[bytes, list[bytes]]:
    import brotli_tpu_torch as T
    from brotli_tpu_torch.utils.benchmarks import corpus

    text = corpus(65536)
    enc = T.Encoder(quality=5, lgwin=18)
    enc.params.lgblock = 14   # 16 KB metablocks
    streaming = b"".join(enc.update(text[i: i + 1024])
                         for i in range(0, len(text), 1024)) + enc.finish()
    spliced = T.parallel_encode(text, shard_size=16384, quality=5,
                                num_workers=1)
    unc = T.host_encode(text, quality=0)
    third = -(-n // 3)
    return text, ([streaming] * third + [spliced] * third
                  + [unc] * third)[:n]


def card() -> str:
    if not torch.cuda.is_available():
        return "no CUDA card"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import brotli_tpu_torch as T

    root = os.path.dirname(os.path.dirname(T.__file__))
    text, streams = lanes(args.lanes)

    def call():
        got = T.decode_batch_v3_full(streams, device=args.device)
        if args.device != "cpu":
            torch.cuda.synchronize()
        return got

    T.decode_batch_v3_full(streams[:3], device=args.device)   # build, warm up
    fb0 = T.fallback_stats()["lanes_fallback"]
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    got = call()
    prof.disable()
    wall = time.perf_counter() - t0
    fell = T.fallback_stats()["lanes_fallback"] - fb0
    if any(g != text for g in got) or fell:
        print(f"v3_host_profile: output wrong or {fell} fallback lanes",
              file=sys.stderr)
        return 1
    stats = pstats.Stats(prof)
    cum = {}
    for (path, _, name), (_, ncalls, _, ct, _) in stats.stats.items():
        for suffix, want in WATCH:
            if name == want and path.endswith(suffix):
                key = f"{suffix}:{name}"
                c, t = cum.get(key, (0, 0.0))
                cum[key] = (c + ncalls, t + ct)
    who = f"{card()}, os.cpu_count() {os.cpu_count()}"
    print(f"[v3 host profile] {who}: package {root}; {len(streams)} lanes x "
          f"{len(text)} B through decode_batch_v3_full(device="
          f"{args.device!r}) in {wall:.3f} s (host clock, under cProfile), "
          "0 fallback lanes")
    for suffix, name in WATCH:
        key = f"{suffix}:{name}"
        if key in cum:
            n, t = cum[key]
            print(f"  {key:50s} {n:8d} calls {t:9.3f} s cumulative "
                  f"({100 * t / wall:5.1f}%)")
        else:
            print(f"  {key:50s} absent")
    stats.sort_stats("tottime").print_stats(12)
    print(json.dumps({"package": root, "wall_s": wall, "lanes": len(streams),
                      "card": who,
                      "cumulative_s": {k: v[1] for k, v in cum.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
