"""Where a lane of the per-lane-table decode kernels spends its time on the
card.

    python3 -m brotli_tpu_torch.tools.dd_phases [--shapes main,long]

Builds csrc/device_decode.cu a second time with -DDD_PHASE_CLOCKS, into a
library of its own in brotli_tpu_torch/build/ (never the main path's).  In
that build a lane's leader thread sums the clock64() cycles of each phase
of its lane (device_decode.cuh DDPhase) and counts its events, and the
kernel writes both to a device array a lane.  The phases (PHASES):

    stage    the table row into shared memory (the shared form: compacted,
             while the words ring fills by cp.async)
    command  the command symbol and its insert and copy extra bits
    fast literals  the shared form's fast inserts: sub-groups of literals
             read from the one-level table, and their stores
    literals the other inserts' literal symbols and their stores
    distance the distance symbol, its extra bits and the ring
    copy     the copy's bytes
    words    moves of the bit reader to another word, timed inside the
             phase that makes them and taken out of it (the direct form:
             loads from device memory; the shared form: ring reads, a
             refill's issue or wait)
    flush    the shared form's window to the output row at the lane's end

and the events (EVENTS): literals, commands, copies, copied bytes, word
moves, literals on the fast path, lanes decoded by the direct form
instead of the shared one's fast path.  The 32 threads of a lane run one
chain, so the leader's cycles are the lane's, and with
every lane resident at once the kernel's time is its slowest lane's.

Shapes (SHAPES): "main", chip_smoke.py's [device decode] batch (1024
pieces of 8 KB of the corpus, piece i compressed alone by host_encode at
quality 1 + i % 4), and "long", 64 pieces of 64 KB at quality 1 + i % 3
(rows 8x the shared form's window).  For each form and shape it prints a
JSON line: the cycles a lane spends in each phase and its share, the
events a lane, the slowest lane's cycles, phases and events, and the
instrumented launch's time; every instrumented output equals the main
build's of the same form.  Then the main build's two forms timed in turns
(direct, shared, shared, direct; time_device_fn, CUDA events) and nvcc's
registers, stack and spills of both kernels when this process built the
main library.  The instrumented build is launched from its own library
through ops/device_decode._launch, so the wrappers' launch counts and
library stay as they are.

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from .. import build
from ..ops import device_decode as DD
from ..utils.benchmarks import corpus, time_device_fn

PHASES = ("stage", "command", "literals", "distance", "copy", "words",
          "flush", "fast literals")
EVENTS = ("literals", "commands", "copies", "copied bytes", "word moves",
          "fast literals", "restarts")
# form: (its index in the clocks, its wrapper, its entry in the library)
FORMS = {"direct": (0, DD.device_decode_direct,
                    "brotli_torch_device_decode_direct"),
         "shared": (1, DD.device_decode, "brotli_torch_device_decode")}
# tag: (lanes, bytes a piece, qualities: piece i at quals[i % len(quals)])
SHAPES = {"main": (1024, 8192, (1, 2, 3, 4)),
          "long": (64, 65536, (1, 2, 3))}


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def encode_piece(job: tuple[bytes, int]) -> bytes:
    """One piece compressed alone by the port's host encoder (its own
    tables); a worker process's task."""
    from .. import host_encode

    piece, quality = job
    return host_encode(piece, quality=quality)


def pieces_and_streams(shape: str, workers: int = 8):
    """corpus(lanes * piece) in pieces, piece i compressed alone at
    quals[i % len(quals)] over `workers` spawned processes (none touches
    the card): (pieces, streams, qualities, encode seconds)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    lanes, size, quals = SHAPES[shape]
    data = corpus(lanes * size)
    pieces = [data[i * size: (i + 1) * size] for i in range(lanes)]
    qual = [quals[i % len(quals)] for i in range(lanes)]
    workers = max(1, min(workers, os.cpu_count() or 1))
    t0 = time.perf_counter()
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        streams = list(pool.map(encode_piece, zip(pieces, qual),
                                chunksize=max(1, lanes // (4 * workers))))
    return pieces, streams, qual, time.perf_counter() - t0


def phase_lib() -> ctypes.CDLL:
    """device_decode.cu with the phase clocks, built at first use."""
    name = "brotli_tpu_torch_dd_phases"
    if name not in build._libs:
        nvcc = build._nvcc()
        path = build._build(
            name, [nvcc, *build.NVCC_FLAGS, "-DDD_PHASE_CLOCKS"],
            [nvcc, *build.NVCC_LINK_FLAGS], [build.CSRC / "device_decode.cu"])
        entry = build._DEVICE_DECODE_ARGS + [ctypes.c_int, ctypes.c_void_p]
        build._load(name, path, {
            "brotli_torch_device_decode": entry,
            "brotli_torch_device_decode_direct": entry,
            "brotli_torch_device_decode_config": [ctypes.c_void_p],
            "brotli_torch_device_decode_clocks": [ctypes.c_void_p] * 3,
        })
    return build._libs[name]


def read_clocks(lib) -> tuple[np.ndarray, np.ndarray]:
    """Each lane's cycles by phase (2 forms, lanes, PHASES) and events
    (2, lanes, EVENTS) since the last read, then zeroed."""
    n = np.zeros(1, np.int32)
    lanes = 4096
    cyc = np.zeros((2, lanes, len(PHASES)), np.uint64)
    ev = np.zeros((2, lanes, len(EVENTS)), np.uint32)
    rc = lib.brotli_torch_device_decode_clocks(cyc.ctypes.data, ev.ctypes.data,
                                               n.ctypes.data)
    if rc or int(n[0]) != lanes:
        raise RuntimeError(f"reading the clocks failed: cudaError {rc}, "
                           f"{int(n[0])} lanes")
    return cyc, ev


def run(lib, form: str, db):
    """One launch of an instrumented form from `lib`, synchronised."""
    out = DD._launch(db, FORMS[form][2], lib)
    torch.cuda.synchronize()
    return out


def summary(cyc: np.ndarray, ev: np.ndarray, lane: int | None = None) -> dict:
    """(lanes, PHASES) cycles and (lanes, EVENTS) counts -> the mean lane's
    split, the slowest lane's and, given `lane`, that lane's."""
    c = cyc.astype(np.float64)
    tot = c.sum(1)
    mean = c.mean(0)
    slow = int(tot.argmax())
    syms = ev[:, 0].astype(np.float64) + ev[:, 1]

    def phases(row):
        t = float(row.sum()) or 1.0
        return {n: [round(float(x), 1), round(float(x) / t, 4)]
                for n, x in zip(PHASES, row) if x > 0}

    def one(k):
        return {"lane": k, "cycles": int(tot[k]), "phases": phases(c[k]),
                "events": {n: int(x) for n, x in zip(EVENTS, ev[k])}}

    out = {"cycles_a_lane": round(float(tot.mean()), 1),
           "phases": phases(mean),
           "events_a_lane": {n: round(float(x), 1)
                             for n, x in zip(EVENTS, ev.mean(0))},
           "cycles_a_symbol": round(float(tot.sum() / max(1.0, syms.sum())), 1),
           "slowest": one(slow)}
    if lane is not None and lane != slow:
        out["lane"] = one(lane)
    return out


def phase_split(db, lib=None) -> dict:
    """Both forms' phase splits on a staged CUDA batch, each instrumented
    output equal to the main build's: {form: summary + instrumented_ms}."""
    lib = lib or phase_lib()
    out = {}
    read_clocks(lib)
    slow = None  # the direct form's slowest lane, shown for both forms
    for form, (k, fn, _) in FORMS.items():
        want = fn(db)
        ms = time_device_fn(lambda: run(lib, form, db), rep=1, samples=1,
                            warm_up=False) * 1e3
        cyc, ev = read_clocks(lib)
        got = run(lib, form, db)
        read_clocks(lib)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise RuntimeError(f"instrumented {form} form != the main build's")
        n = min(db.n_lanes, cyc.shape[1])
        out[form] = {"instrumented_ms": round(ms, 4),
                     **summary(cyc[k, :n], ev[k, :n], slow)}
        if slow is None:
            slow = out[form]["slowest"]["lane"]
    return out


def in_turns(db) -> dict:
    """The main build's forms in turns (direct, shared, shared, direct),
    time_device_fn's best of 3 windows of 5 each, outputs equal."""
    a, b = DD.device_decode_direct(db), DD.device_decode(db)
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise RuntimeError("device_decode_kernel != device_decode_direct_kernel")
    order = ["direct", "shared", "shared", "direct"]
    ms = [time_device_fn(lambda f=FORMS[k][1]: f(db)) * 1e3 for k in order]
    return {"order": order, "ms": [round(x, 4) for x in ms],
            "direct_ms": (ms[0] + ms[3]) / 2, "shared_ms": (ms[1] + ms[2]) / 2}


def ptxas(log: str) -> dict:
    """nvcc -Xptxas -v lines of the two kernels: registers, stack, spills."""
    out, name = {}, None
    for line in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in line:
                name = line.split(key, 1)[1].split("'")[0].strip()
        short = next((k for k in ("device_decode_direct_kernel",
                                  "device_decode_kernel")
                      if name and k in name), None)
        if short and ("stack frame" in line or "registers" in line
                      or "smem" in line):
            out.setdefault(short, []).append(line.split(":", 1)[-1].strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", default="main,long",
                    help="comma-separated SHAPES tags")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dd_phases: needs a CUDA card")
    c = card()
    print(f"[card] {c}")
    build.kernels_lib()
    print(json.dumps({"ptxas": ptxas(build.last_build_log.get(
        "brotli_tpu_torch_kernels", "")), "launch": DD.launch_config()}))
    lib = phase_lib()
    for tag in args.shapes.split(","):
        pieces, streams, qual, enc_s = pieces_and_streams(tag)
        pre = DD.preflight_native(streams)
        if any(p is None for p in pre):
            raise RuntimeError(f"{tag}: the preflight refused a stream")
        db = DD.stage_batch(pre, "cuda")
        split = phase_split(db, lib)
        for form, s in split.items():
            print(json.dumps({"shape": tag, "form": form, "card": c, **s}))
        turns = in_turns(db)
        print(json.dumps({"shape": tag, "card": c, "encode_s": round(enc_s, 3),
                          "in_turns": turns}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
