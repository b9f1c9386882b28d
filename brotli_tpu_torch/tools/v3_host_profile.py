"""Where the host time of the v3 round trip goes.

    PYTHONPATH=. python3 brotli_tpu_torch/tools/v3_host_profile.py
        [--cell main|full] [--rounds R] [--lanes N] [--groups G]
        [--device D] [--cprofile]

`--cell main` (chip_smoke.py's v3 cell: 6 x 1024 x 4 KB encoded on the
card with the reference bench's full-format knobs; G groups of 1024
streams, 6 by default) prints medians of R
runs (5 by default) of each part of one decode_batch_v3 call:

* where the package has it, the yardstick's host half
  (utils/profiling._old_decode_v3: ops/preflight3_native.py and
  ops/decode3.py's yardstick functions): `stage_streams` (the join),
  `parse_units` (the C++ parse and binning) at 1, 4 and 8 threads,
  `_assemble` (numpy), `batch_to_torch_v3`, the kernel (`decode3`),
  `_lanes` (the pageable copies back) and the per-lane `bytes`, with each
  call's outputs dropped (the calls at 1 and 8 threads) and with every
  call's kept (at 4);
* where the package has it, the native staging (ops/stage3_native.py):
  `stage_host` split into its plan and fill (the native entries, host
  clock) at 1, 4 and 8 threads, `to_device` (CUDA events), the kernel on
  that batch, and `collect_lanes_v3_pinned` with outputs dropped and kept;
* the whole `decode_batch_v3` call.

`--cell full` (chip_smoke.py's [v3 full] lanes: N, 1024 by default, of
three 64 KB streams, 4 rounds) decodes them once to build and warm up,
then R times through decode_batch_v3_full, each part of a round timed by
wrapping the module functions the driver calls (each through a
synchronise): the header walk, the staging (the yardstick's
`preflight_units_v3_native`, split into `parse_units` and `_assemble`, and
`batch_to_torch_v3`; or the native staging), the kernel, the copies back,
and the host history copies (the yardstick's: from the walk's end to the
preflight's start, where it builds each unit's earlier output as `bytes`;
the native path's: its device history's appends and prefix gathers); the
medians a round.  `--cprofile` adds a cProfile of one call.

It profiles the package that PYTHONPATH names (the checkout's root above),
and a part the package lacks prints as absent, so it runs the same
against an older checkout named there.  The device defaults to cuda;
prints the card's name and power limit there.  The last line is the
medians as JSON.
"""

from __future__ import annotations

import argparse
import cProfile
import importlib
import json
import os
import pstats
import statistics
import subprocess
import sys
import time

import torch

# chip_smoke.py's v3 cell
V3_BENCH = dict(chunk_size=4096, max_distance=1008, chain_depth=4,
                table_groups=1, lit_ctx_trees=8)
V3_GROUPS = 6


def card() -> str:
    if not torch.cuda.is_available():
        return "no CUDA card"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


def full_lanes(n: int) -> tuple[bytes, list[bytes]]:
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


def main_streams(device: str, groups: int) -> tuple[bytes, list[bytes]]:
    import brotli_tpu_torch as T
    from brotli_tpu_torch.utils.benchmarks import corpus

    piece = 1024 * V3_BENCH["chunk_size"]
    data = corpus(groups * piece)
    streams = []
    for g in range(groups):
        streams += T.encode_device_batch(data[g * piece:(g + 1) * piece],
                                         device=device, **V3_BENCH)
    return data, streams


def _module(name: str):
    try:
        return importlib.import_module(f"brotli_tpu_torch.ops.{name}")
    except ImportError:
        return None


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def _med_ms(xs) -> float:
    return statistics.median(xs) * 1e3


class Spy:
    """mod.<name> wrapped for each (mod, name) present: each call's host
    clock through a synchronise before and after, in call order."""

    def __init__(self, device: str, targets):
        self.device = device
        self.calls: list[tuple[str, float, float]] = []  # name, start, s
        self.targets = [(m, n) for m, n in targets
                        if m is not None and hasattr(m, n)]
        self.orig = {}

    def _wrap(self, name, fn):
        def run(*a, **k):
            _sync(self.device)
            t = time.perf_counter()
            out = fn(*a, **k)
            _sync(self.device)
            self.calls.append((name, t, time.perf_counter() - t))
            return out
        return run

    def __enter__(self):
        for m, n in self.targets:
            self.orig[(m, n)] = getattr(m, n)
            setattr(m, n, self._wrap(n, self.orig[(m, n)]))
        return self

    def __exit__(self, *exc):
        for (m, n), fn in self.orig.items():
            setattr(m, n, fn)


def run_main(args, card_s: str) -> dict:
    import brotli_tpu_torch as T

    D3 = _module("decode3")
    S3 = _module("stage3_native")
    dev, R = args.device, args.rounds
    groups = args.groups
    data, streams = main_streams(dev, groups)
    want = [data[i: i + V3_BENCH["chunk_size"]]
            for i in range(0, len(data), V3_BENCH["chunk_size"])]
    dict_dev = T.stage_dictionary(dev)
    got = T.decode_batch_v3(streams, device=dev, max_groups=groups,
                            dict_dev=dict_dev)            # build, warm up
    assert got == want, "decode_batch_v3 differs from the input"
    del got
    res: dict = {"card": card_s, "streams": len(streams)}
    P = importlib.import_module("brotli_tpu_torch.utils.profiling")
    if hasattr(P, "_old_decode_v3"):
        res["old_ms"] = run_main_old(P, streams, dict_dev, want, dev, R,
                                     card_s, groups)
    if S3 is not None:
        res["new_ms"] = run_main_new(S3, D3, streams, dict_dev, want, dev, R,
                                     card_s, groups)
    # the whole call
    whole = []
    for _ in range(R):
        _sync(dev)
        t0 = time.perf_counter()
        got = T.decode_batch_v3(streams, device=dev, max_groups=groups,
                                dict_dev=dict_dev)
        _sync(dev)
        whole.append(time.perf_counter() - t0)
        assert got == want
        del got
    res["whole_ms"] = _med_ms(whole)
    print(f"[v3 host main] {card_s}: whole decode_batch_v3 call, median of "
          f"{R}: {res['whole_ms']:.3f} ms ({len(data) / statistics.median(whole) / 1e6:.1f} "
          f"MB/s); {', '.join(f'{x * 1e3:.2f}' for x in whole)}")
    return res


def run_main_old(P, streams, dict_dev, want, dev, R, card_s,
                 groups) -> dict:
    """The yardstick's host half (utils/profiling._old_decode_v3, its
    parts through a synchronise): R calls with the parse on each of 1, 4
    and 8 threads.  The calls at 4 threads keep every call's outputs, the
    others drop each call's before the next."""
    N3 = _module("preflight3_native")
    t: dict[str, list] = {}
    kept = []
    threads0 = N3.N_THREADS
    try:
        for k in (1, 4, 8):
            N3.N_THREADS = k
            for _ in range(R):
                parts = P._Parts(dev)
                got = P._old_decode_v3(streams, dev, groups, dict_dev, parts)
                assert got == want, "the yardstick's half differs"
                if k == 4:
                    kept.append(got)
                del got
                for name, sec in parts.s.items():
                    if name == "parse_units":
                        name = f"parse_{k}"
                    elif name == "per-lane bytes":
                        name = "bytes_kept" if k == 4 else "bytes_dropped"
                    elif name == "kernel":
                        name = "decode3"
                    t.setdefault(name, []).append(sec)
    finally:
        N3.N_THREADS = threads0
    del kept
    o = {k: _med_ms(v) for k, v in t.items()}
    print(f"[v3 host main] {card_s}: yardstick, median of {R} calls at each "
          f"parse thread count: stage_streams {o['stage_streams']:.3f} ms; "
          f"parse_units {o['parse_1']:.3f} / {o['parse_4']:.3f} / "
          f"{o['parse_8']:.3f} ms at 1 / 4 / 8 threads; _assemble "
          f"{o['_assemble']:.3f} ms; batch_to_torch_v3 "
          f"{o['batch_to_torch_v3']:.3f} ms; kernel {o['decode3']:.3f} ms; "
          f"_lanes {o['_lanes']:.3f} ms; per-lane bytes "
          f"{o['bytes_dropped']:.3f} ms dropped, {o['bytes_kept']:.3f} ms kept")
    return o


class Timed:
    """A native library with some entries timed (host clock)."""

    def __init__(self, lib, names):
        self.lib, self.seconds = lib, {n: 0.0 for n in names}
        for n in names:
            setattr(self, n, self._wrap(n, getattr(lib, n)))

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def _wrap(self, name, fn):
        def run(*args):
            t = time.perf_counter()
            out = fn(*args)
            self.seconds[name] += time.perf_counter() - t
            return out
        return run


def run_main_new(S3, D3, streams, dict_dev, want, dev, R, card_s,
                 groups) -> dict:
    """The native staging's parts on the v3 cell."""
    lib = S3._lib()
    timed = Timed(lib, ("brotli_v3_plan", "brotli_v3_fill"))
    t = {}
    threads0 = S3.N_THREADS
    S3._LIB = timed
    try:
        for k in (1, 4, 8):
            S3.N_THREADS = k
            rows = []
            for _ in range(R):
                for name in timed.seconds:
                    timed.seconds[name] = 0.0
                t0 = time.perf_counter()
                hs = S3.stage_host(streams, max_groups=groups,
                                   pin=dev != "cpu", with_dict=False)
                rows.append((time.perf_counter() - t0,
                             timed.seconds["brotli_v3_plan"],
                             timed.seconds["brotli_v3_fill"]))
            for name, col in zip(("stage_host", "plan", "fill"), zip(*rows)):
                t[f"{name}_{k}"] = _med_ms(col)
    finally:
        S3._LIB = lib
        S3.N_THREADS = threads0
    to_dev, kern, drop, keep = [], [], [], []
    kept = []
    for _ in range(R):
        hs = S3.stage_host(streams, max_groups=groups, pin=dev != "cpu",
                           with_dict=False)
        _sync(dev)
        t0 = time.perf_counter()
        staged = S3.to_device(hs, torch.device(dev), dict_dev=dict_dev)
        _sync(dev)
        to_dev.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        out, status = D3.decode3(staged.tb)
        _sync(dev)
        kern.append(time.perf_counter() - t0)
        for how, acc in (("dropped", drop), ("kept", keep)):
            t0 = time.perf_counter()
            got = D3.collect_lanes_v3_pinned(staged, streams, out, status)
            acc.append(time.perf_counter() - t0)
            assert got == want
            if how == "kept":
                kept.append(got)
            del got
    del kept
    t.update(to_device=_med_ms(to_dev), decode3=_med_ms(kern),
             collect_dropped=_med_ms(drop), collect_kept=_med_ms(keep))
    print(f"[v3 host main] {card_s}: native staging, median of {R}: "
          + "; ".join(f"{k} threads: stage_host {t[f'stage_host_{k}']:.3f} ms "
                      f"(plan {t[f'plan_{k}']:.3f}, fill {t[f'fill_{k}']:.3f})"
                      for k in (1, 4, 8))
          + f"; to_device {t['to_device']:.3f} ms; kernel {t['decode3']:.3f} "
          f"ms ({staged.tb.groups} groups of {staged.tb.width}); "
          f"collect_lanes_v3_pinned {t['collect_dropped']:.3f} ms dropped, "
          f"{t['collect_kept']:.3f} ms kept")
    return t


# parts of a decode_batch_v3_full round, by the function the driver calls
FULL_PARTS = [
    ("decode3", "walk_units"),                  # yardstick
    ("decode3", "preflight_units_v3_native"),
    ("preflight3_native", "parse_units"),
    ("preflight3_native", "_assemble"),
    ("decode3", "batch_to_torch_v3"),
    ("decode3", "decode3"),
    ("decode3", "_lanes"),
    ("stage3_native", "walk_ptrs"),             # native staging
    ("stage3_native", "stage_units_v3_native"),
    ("stage3_native", "plan_and_fill"),
    ("stage3_native", "to_device"),
    ("decode3", "_to_host"),
    ("stage3_native", "DeviceHistory.append"),
    ("stage3_native", "DeviceHistory.prefix"),
    ("stage3_native", "DeviceHistory.fetch"),
]
WALKS = ("walk_units", "walk_ptrs")


def _targets():
    out = []
    for mod_name, attr in FULL_PARTS:
        m = _module(mod_name)
        if m is None:
            continue
        if "." in attr:
            cls, meth = attr.split(".")
            if hasattr(m, cls):
                out.append((getattr(m, cls), meth))
        else:
            out.append((m, attr))
    return out


def run_full(args, card_s: str) -> dict:
    import brotli_tpu_torch as T

    dev, R = args.device, args.rounds
    text, streams = full_lanes(args.lanes)
    T.decode_batch_v3_full(streams[:3], device=dev)   # build, warm up
    per_round: dict = {}
    walls, hist_copies = [], {}
    for _ in range(R):
        fb0 = T.fallback_stats()["lanes_fallback"]
        with Spy(dev, _targets()) as spy:
            _sync(dev)
            t0 = time.perf_counter()
            got = T.decode_batch_v3_full(streams, device=dev)
            _sync(dev)
            walls.append(time.perf_counter() - t0)
        fell = T.fallback_stats()["lanes_fallback"] - fb0
        assert all(g == text for g in got) and not fell, "v3 full differs"
        del got
        rnd, sums, walk_end = -1, {}, None
        for name, start, s in spy.calls:
            if name in WALKS:
                rnd += 1
                walk_end = start + s
            elif name == "preflight_units_v3_native" and walk_end is not None:
                # the yardstick builds each unit's earlier output as bytes
                # between its walk and its preflight
                key = (rnd, "host history copies")
                sums[key] = sums.get(key, 0.0) + start - walk_end
            key = (max(rnd, 0), name)
            sums[key] = sums.get(key, 0.0) + s
        for key, s in sums.items():
            per_round.setdefault(key, []).append(s)
    res = {"card": card_s, "lanes": len(streams), "wall_ms": _med_ms(walls),
           "rounds": {}}
    for (r, name), xs in sorted(per_round.items()):
        res["rounds"].setdefault(str(r), {})[name] = _med_ms(xs)
    print(f"[v3 host full] {card_s}: {len(streams)} lanes x {len(text)} B "
          f"through decode_batch_v3_full(device={dev!r}), median of {R}: "
          f"{res['wall_ms']:.3f} ms ({', '.join(f'{w * 1e3:.2f}' for w in walls)});"
          " 0 fallback lanes")
    for r, parts in res["rounds"].items():
        print(f"[v3 host full] {card_s}: round {r}: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in parts.items()))
    if args.cprofile:
        prof = cProfile.Profile()
        prof.enable()
        T.decode_batch_v3_full(streams, device=dev)
        _sync(dev)
        prof.disable()
        pstats.Stats(prof).sort_stats("cumulative").print_stats(25)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=("main", "full"), default="full")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--groups", type=int, default=V3_GROUPS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cprofile", action="store_true")
    args = ap.parse_args()
    if args.device != "cpu" and not torch.cuda.is_available():
        print("v3_host_profile: no CUDA card", file=sys.stderr)
        return 1
    import brotli_tpu_torch as T

    root = os.path.dirname(os.path.dirname(T.__file__))
    card_s = f"{card()}, os.cpu_count() {os.cpu_count()}"
    print(f"[v3 host] {card_s}; package {root}")
    res = (run_main if args.cell == "main" else run_full)(args, card_s)
    res["package"] = root
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
