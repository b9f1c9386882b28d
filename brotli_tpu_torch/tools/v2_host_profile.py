"""Where the host time of the v2 round trip's native host half goes.

    PYTHONPATH=. python3 brotli_tpu_torch/tools/v2_host_profile.py
        [--rounds R] [--threads 1,2,4,8] [--streams FILE]

On the v2 cell (4 x 1024 x 8 KB encode_sharded streams of the corpus,
chip_smoke.py's main-path batch) it times, on one card:

* the staging at each thread count (ops/preflight2_native.N_THREADS), R
  rounds: the host clock of `stage_host` split into the native plan and
  fill (brotli_v2_plan, brotli_v2_fill), and `to_device` (the copy and
  what the card does to the words) between CUDA events;
* the unpack (`collect_lanes_pinned`), R rounds with each round's output
  dropped before the next, then R rounds with every output kept: new
  Python bytes need pages the process does not hold yet, which the host
  must fault in; and, apart, the pinned allocations with the copies back
  and one synchronise.

It profiles the package that PYTHONPATH names (the checkout's root above),
so it runs the same against another checkout of the port named there.
`--streams FILE` keeps the encoded streams in FILE (written when it is
missing), so that runs against two checkouts skip the host encode.  Prints
the card's name and power limit; the last line is the medians as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

GROUPS = 4
CHUNK = 8192


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def cell_streams(path: str | None) -> list[bytes]:
    """The v2 cell's 1024 distinct streams (the batch repeats them
    GROUPS times), from `path` when it holds them."""
    if path and Path(path).exists():
        with np.load(path) as z:
            buf, ends = z["buf"].tobytes(), z["ends"]
        return [buf[a:b] for a, b in zip([0, *ends[:-1]], ends)]
    from brotli_tpu_torch.encode.sharded import encode_sharded
    from brotli_tpu_torch.utils.benchmarks import corpus

    streams = encode_sharded(corpus(1024 * CHUNK), chunk_size=CHUNK,
                             max_distance=2032)
    if path:
        np.savez(path, buf=np.frombuffer(b"".join(streams), np.uint8),
                 ends=np.cumsum([len(s) for s in streams]))
    return streams


class Timed:
    """The native library with its two entries timed (host clock)."""

    def __init__(self, lib, names):
        self.lib, self.seconds = lib, {n: 0.0 for n in names}
        for n in names:
            setattr(self, n, self._wrap(n, getattr(lib, n)))

    def _wrap(self, name, fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            self.seconds[name] += time.perf_counter() - t
            return out
        return run


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--threads", default="1,2,4,8")
    ap.add_argument("--streams", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("v2_host_profile: no CUDA card", file=sys.stderr)
        return 1
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import preflight2_native as N

    card_s = card()
    print(f"[v2 host] {card_s}; package {Path(brotli_tpu_torch.__file__).parent}")
    streams = cell_streams(args.streams) * GROUPS
    dev = torch.device("cuda")
    N.stage_v2_native(streams, dev)           # build, warm up
    timed = Timed(N._lib(), ("brotli_v2_plan", "brotli_v2_fill"))
    N._LIB = timed
    out: dict = {"card": card_s, "stage": {}}
    staged = None
    try:
        for threads in map(int, args.threads.split(",")):
            N.N_THREADS = threads
            rows = []
            for _ in range(args.rounds):
                for k in timed.seconds:
                    timed.seconds[k] = 0.0
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hs = N.stage_host(streams, pin=True)
                t1 = time.perf_counter()
                ev[0].record()
                staged = N.to_device(hs, dev)
                ev[1].record()
                ev[1].synchronize()
                rows.append((t1 - t0, timed.seconds["brotli_v2_plan"],
                             timed.seconds["brotli_v2_fill"],
                             ev[0].elapsed_time(ev[1]) / 1e3))
            med = [statistics.median(c) * 1e3 for c in zip(*rows)]
            out["stage"][threads] = dict(zip(
                ("stage_host_ms", "plan_ms", "fill_ms", "to_device_ms"), med))
            print(f"[v2 host] {card_s}: {threads} threads, median of "
                  f"{args.rounds}: stage_host {med[0]:.3f} ms (plan "
                  f"{med[1]:.3f}, fill {med[2]:.3f}), to_device {med[3]:.3f} "
                  f"ms; host buffer {hs.buf.numel() * 4 / 1e6:.3f} MB, Wpad "
                  f"{staged.tb.wpad}")
    finally:
        N._LIB = timed.lib
    N.N_THREADS = max(map(int, args.threads.split(",")))

    outs = D.run_batch_e2e(staged)
    torch.cuda.synchronize()
    copies = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in outs]
        torch.cuda.current_stream().synchronize()
        copies.append(time.perf_counter() - t0)
        del host
    unpack = {"dropped": [], "kept": []}
    kept = []
    for how in ("dropped", "kept"):
        for _ in range(args.rounds):
            t0 = time.perf_counter()
            got = D.collect_lanes_pinned(staged, streams, *outs)
            unpack[how].append(time.perf_counter() - t0)
            if how == "kept":
                kept.append(got)
            del got
    out["unpack"] = {
        "pinned_copies_ms": statistics.median(copies) * 1e3,
        **{f"{k}_ms": statistics.median(v) * 1e3 for k, v in unpack.items()}}
    u = out["unpack"]
    print(f"[v2 host] {card_s}: unpack, median of {args.rounds}: pinned "
          f"buffers, copies back and a synchronise {u['pinned_copies_ms']:.3f} "
          f"ms; collect_lanes_pinned {u['dropped_ms']:.3f} ms with each "
          f"output dropped, {u['kept_ms']:.3f} ms with every output kept "
          f"({', '.join(f'{s * 1e3:.2f}' for s in unpack['kept'])})")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
