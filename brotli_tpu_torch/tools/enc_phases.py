"""Where a lane of the encoder's match, record and parse kernels spends its
time on the card.

    python3 -m brotli_tpu_torch.tools.enc_phases [--parse-only]

Builds csrc/matches.cu and csrc/records.cu a second time with
-DENC_PHASE_CLOCKS, into a library of its own in brotli_tpu_torch/build/
(never the main path's), and csrc/parse.cu the same way into another.  In that build a lane's leader thread adds the
clock64() cycles of each phase of the lane to a device counter; a phase
ends at a barrier, so the leader's cycles are the lane's (the direct
record kernel's lane is a warp).  The match
kernels' phases (MATCH_PHASES: matches.cu MATCH_PH_*):

    load         the lane's bytes into shared memory as words
    ids          the ids 0..n2-1 before each sort
    sort k count / scan / scatter   radix pass k (0-2 the 4-byte hash,
                 3-5 the 7-byte one): the digit counts, their offsets, the
                 stable scatter
    neighbours   each sorted id's best candidate (both hashes)
    hash2 merge  the first pass's distances stashed and merged
    lengths      a length from each position's distance
    runs         the byte runs at distance 4
    extension    the doubling rounds at strides 8..256
    store        the clamp to n_valid and the store of mlen and mdist

The record kernels' (REC_PHASES: records.cu REC_PH_*): the constant
table's staging; forward (the running maximum of copy ends, the insert
lengths); backward (the codes, the suffix minima and the rows); and, in
the block kernel, the tile maxima before the backward tiles, the tile
loads into shared memory and the coalesced row stores.

Shapes: 1024 x 32 KB of the corpus at the default knobs and at the
bench's chain_depth=4 (records with literal contexts there, as the bench
setting's trees), and 1024 x 4 KB at the v3 cell's knobs (max_distance
1008, chain_depth 4; literal contexts).  For each kernel (the direct one,
the first design, and the block kernel) it prints a JSON line a shape:
the cycles a lane spends in each phase and its share, and the
instrumented launch's time.  Every output equals the plain version's.
Then the main path's builds of both forms timed in turns (direct, new,
new, direct; time_device_fn, CUDA events).

The parse kernels' phases (PARSE_PHASES: parse.cu PARSE_PH_*), on the
match kernel's output at the same three shapes and the default lazy and
gate knobs: the direct kernel's wait for a window's loads, its gate
(scores, shuffles, ballots), its copy walk with the ring and its stores;
parse_kernel's leader is warp 0's thread 0: the speculative walks of
tile k's segments, the walk (the resolution), the copy list with the
words' entry frontiers and the words, then "gate": its wait at the barrier
for the gate warps (tile k + 1's copies, take words and succ) beyond its
own work, then the codes (the ring's prefix count) and the stores.  Beside them the copies a lane,
the instrumented launch's time, both forms of the main build in turns
with the bound (bytes: mlen, mdist and n_valid in, is_cs, is_lit and
dcode_short out, at 3.35 TB/s), and parse_kernel's launch shape.  Every
output equals greedy_parse_ref's.  `--parse-only` runs only this part.

Needs a CUDA card and nvcc; prints the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import numpy as np
import torch

from .. import build
from ..ops import device_encode as E
from ..utils.benchmarks import corpus, time_device_fn

MATCH_PHASES = (("load", "ids")
                + tuple(f"sort {k} {step}" for k in range(6)
                        for step in ("count", "scan", "scatter"))
                + ("neighbours", "hash2 merge", "lengths", "runs",
                   "extension", "store"))
REC_PHASES = ("table", "forward", "backward", "tile maxima", "tile loads",
              "stores")
PARSE_PHASES = ("load wait", "gate", "walk", "stores", "speculation",
                "list and words", "codes")
KERNELS = ("direct", "new")
# (tag, bytes a lane, match knobs, records with literal contexts)
SHAPES = (("1024x32KB default", 32768, {}, False),
          ("1024x32KB chain_depth 4", 32768, {"chain_depth": 4}, True),
          ("1024x4KB v3 cell", 4096, {"max_distance": 1008,
                                      "chain_depth": 4}, True))
LANES = 1024


def phase_lib() -> ctypes.CDLL:
    """matches.cu and records.cu with the phase clocks, built at first use."""
    name = "brotli_tpu_torch_enc_phases"
    if name not in build._libs:
        nvcc = build._nvcc()
        path = build._build(
            name, [nvcc, *build.NVCC_FLAGS, "-DENC_PHASE_CLOCKS"],
            [nvcc, *build.NVCC_LINK_FLAGS],
            [build.CSRC / "matches.cu", build.CSRC / "records.cu"])
        matches = build._MATCHES_ARGS + [ctypes.c_void_p]
        records = build._RECORDS_ARGS + [ctypes.c_int, ctypes.c_void_p]
        build._load(name, path, {
            "brotli_torch_matches": matches,
            "brotli_torch_matches_direct": matches,
            "brotli_torch_records": records,
            "brotli_torch_records_direct": records,
            "brotli_torch_matches_clocks": [ctypes.c_void_p],
            "brotli_torch_records_clocks": [ctypes.c_void_p],
        })
    return build._libs[name]


def parse_phase_lib() -> ctypes.CDLL:
    """parse.cu with the phase clocks, built at first use."""
    name = "brotli_tpu_torch_parse_phases"
    if name not in build._libs:
        nvcc = build._nvcc()
        path = build._build(
            name, [nvcc, *build.NVCC_FLAGS, "-DENC_PHASE_CLOCKS"],
            [nvcc, *build.NVCC_LINK_FLAGS], [build.CSRC / "parse.cu"])
        entry = build._PARSE_ARGS + [ctypes.c_void_p]
        build._load(name, path, {
            "brotli_torch_parse": entry,
            "brotli_torch_parse_direct": entry,
            "brotli_torch_parse_config": [ctypes.c_void_p],
            "brotli_torch_parse_clocks": [ctypes.c_void_p],
        })
    return build._libs[name]


def clocks(lib, which: str, n_phases: int) -> np.ndarray:
    """The counters since the last read, (2 kernels, n_phases), zeroed."""
    out = np.zeros((2, n_phases), np.uint64)
    rc = getattr(lib, f"brotli_torch_{which}_clocks")(out.ctypes.data)
    if rc:
        raise RuntimeError(f"reading the {which} clocks failed: cudaError {rc}")
    return out


def run(lib, fn, *args):
    """One launch of an instrumented entry, through the wrapper `fn`'s
    argument list, synchronised."""
    saved = build._libs["brotli_tpu_torch_kernels"]
    build._libs["brotli_tpu_torch_kernels"] = lib
    try:
        out = fn(*args)
    finally:
        build._libs["brotli_tpu_torch_kernels"] = saved
    torch.cuda.synchronize()
    return out


def ptxas(log: str) -> dict:
    """nvcc -Xptxas -v lines of the six kernels: registers, stack,
    spills."""
    out, name = {}, None
    for line in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in line:
                name = line.split(key, 1)[1].split("'")[0].strip()
        short = next((k for k in ("match_direct_kernel", "match_kernel",
                                  "records_direct_kernel", "records_kernel",
                                  "parse_direct_kernel", "parse_kernel")
                      if name and k in name), None)
        if short and ("stack frame" in line or "registers" in line):
            out.setdefault(short, []).append(line.split(":", 1)[-1].strip())
    return out


def split(cyc: np.ndarray, names, lanes: int) -> dict:
    """Cycles a lane by phase and each one's share, the phases that ran."""
    per = cyc.astype(np.float64) / lanes
    total = float(per.sum())
    return {"cycles_a_lane": round(total, 1),
            "phases": {n: [round(float(c), 1), round(float(c) / total, 4)]
                       for n, c in zip(names, per) if c > 0}}


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parse-only", action="store_true",
                    help="only the parse kernels' phases and times")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("enc_phases: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    build.kernels_lib()
    print(json.dumps({"ptxas": ptxas(build.last_build_log.get(
        "brotli_tpu_torch_kernels", ""))}))
    if not args.parse_only:
        match_records(card)
    parse_phases(card)
    return 0


def match_records(card: str) -> None:
    """The match and record kernels' phases and times at SHAPES."""
    lib = phase_lib()
    fns = {"direct": (E.find_matches_direct, E.build_records_direct),
           "new": (E.find_matches, E.build_records)}
    cuda = torch.device("cuda")
    data = corpus(LANES * 32768)
    for tag, chunk, mkw, lit_ctx in SHAPES:
        data_t, _, n_valid = E.stage_input(data[: LANES * chunk], chunk, cuda)
        ref_m = E.find_matches_ref(data_t, n_valid, **mkw)
        ins = (data_t, *ref_m, *E.greedy_parse(*ref_m, n_valid), n_valid)
        ref_r = E.build_records_ref(*ins, lit_ctx=lit_ctx)
        clocks(lib, "matches", len(MATCH_PHASES))
        clocks(lib, "records", len(REC_PHASES))
        for k, kernel in enumerate(KERNELS):
            fm, fr = fns[kernel]
            t0 = time_device_fn(lambda: run(lib, fm, data_t, n_valid,
                                            *_margs(mkw)), rep=1, samples=1,
                                warm_up=False) * 1e3
            mc = clocks(lib, "matches", len(MATCH_PHASES))[k]
            got = run(lib, fm, data_t, n_valid, *_margs(mkw))
            clocks(lib, "matches", len(MATCH_PHASES))
            if not same(got, ref_m):
                raise RuntimeError(f"instrumented {kernel} match kernel != "
                                   f"find_matches_ref at {tag}")
            t1 = time_device_fn(lambda: run(lib, fr, *ins, lit_ctx),
                                rep=1, samples=1, warm_up=False) * 1e3
            rc = clocks(lib, "records", len(REC_PHASES))[k]
            got = run(lib, fr, *ins, lit_ctx)
            clocks(lib, "records", len(REC_PHASES))
            if not same(got, ref_r):
                raise RuntimeError(f"instrumented {kernel} record kernel != "
                                   f"build_records_ref at {tag}")
            print(json.dumps({"shape": tag, "kernel": f"match {kernel}",
                              "instrumented_ms": round(t0, 4),
                              **split(mc, MATCH_PHASES, LANES)}))
            print(json.dumps({"shape": tag, "kernel": f"records {kernel}",
                              "lit_ctx": lit_ctx,
                              "instrumented_ms": round(t1, 4),
                              **split(rc, REC_PHASES, LANES)}))
        times = {}
        for what, pair in (("matches", (lambda f: f(data_t, n_valid,
                                                     *_margs(mkw)))),
                           ("records", (lambda f: f(*ins, lit_ctx)))):
            idx = 0 if what == "matches" else 1
            for kernel in KERNELS:
                out = pair(fns[kernel][idx])
                if not same(out, ref_m if idx == 0 else ref_r):
                    raise RuntimeError(f"{kernel} {what} kernel != plain at "
                                       f"{tag}")
            order = ["direct", "new", "new", "direct"]
            turns = [time_device_fn(lambda f=fns[kn][idx]: pair(f)) * 1e3
                     for kn in order]
            times[what] = {"order": order,
                           "ms": [round(t, 4) for t in turns]}
        print(json.dumps({"shape": tag, "card": card, "in_turns": times}))


def parse_phases(card: str) -> None:
    """Both parse kernels at SHAPES, on the main build's matches: the
    instrumented build's phase split, then the main build in turns."""
    lib = parse_phase_lib()
    forms = {"direct": E.greedy_parse_direct, "new": E.greedy_parse}
    threads, smem, per_sm, regs, tile = E.parse_config()
    print(json.dumps({"parse_kernel": {
        "threads": threads, "static_shared_bytes": smem,
        "blocks_an_sm": per_sm, "registers": regs, "tile": tile}}))
    cuda = torch.device("cuda")
    data = corpus(LANES * 32768)
    for tag, chunk, mkw, _ in SHAPES:
        data_t, _, n_valid = E.stage_input(data[: LANES * chunk], chunk, cuda)
        ins = (*E.find_matches(data_t, n_valid, **mkw), n_valid)
        ref = E.greedy_parse_ref(*ins)
        copies = int(ref[0].sum().item()) / LANES
        clocks(lib, "parse", len(PARSE_PHASES))
        for k, kernel in enumerate(KERNELS):
            fn = forms[kernel]
            t = time_device_fn(lambda: run(lib, fn, *ins), rep=1, samples=1,
                               warm_up=False) * 1e3
            pc = clocks(lib, "parse", len(PARSE_PHASES))[k]
            got = run(lib, fn, *ins)
            clocks(lib, "parse", len(PARSE_PHASES))
            if not same(got, ref):
                raise RuntimeError(f"instrumented {kernel} parse kernel != "
                                   f"greedy_parse_ref at {tag}")
            print(json.dumps({"shape": tag, "kernel": f"parse {kernel}",
                              "copies_a_lane": copies,
                              "instrumented_ms": round(t, 4),
                              **split(pc, PARSE_PHASES, LANES)}))
        for kernel in KERNELS:
            if not same(forms[kernel](*ins), ref):
                raise RuntimeError(f"{kernel} parse kernel != plain at {tag}")
        order = ["direct", "new", "new", "direct"]
        turns = [time_device_fn(lambda f=forms[kn]: f(*ins)) * 1e3
                 for kn in order]
        bound = (14 * ins[0].numel() + 4 * LANES) / 3.35e9
        print(json.dumps({"shape": tag, "card": card, "in_turns": {
            "parse": {"order": order, "ms": [round(x, 4) for x in turns]}},
            "bound_ms": round(bound, 6), "bound_by": "bytes"}))


def _margs(mkw: dict) -> tuple:
    return (mkw.get("hash_stride", 1), mkw.get("max_distance"),
            mkw.get("chain_depth", 2), mkw.get("hash2", False))


if __name__ == "__main__":
    raise SystemExit(main())
