"""Where a step of the Zopfli DP kernels spends its time on the card.

    python3 -m brotli_tpu_torch.tools.zopfli_phases

Builds csrc/zopfli.cu a second time with -DZOPFLI_PHASE_CLOCKS, into a
library of its own in brotli_tpu_torch/build/.  In that build every step
of both kernels adds the clock64() cycles of each of its phases (the
`Steps::mark` calls of csrc/zopfli.cuh) to a device counter:

    0 node       the node at pos and its shortcut
    1 cache      the distance cache (direct: the walk; window: one record,
                 and the leader's stores of the shortcut and the record)
    2 queue      the queue push (direct: the leader's, in shared memory,
                 and a sync; window: in registers)
    3 min len    the minimum copy length
    4 cands      the 16 distance-cache candidates (direct: all of it;
                 window: the one round that tests a byte of each)
    5 cand runs  the window kernel's surviving candidates, but for
    9 cand relax   their relaxations
    6 matches    the hasher's matches (direct: and their relaxations), but
                 for (window kernel)
    10 match relax their relaxations
    7 loop       the rest: result, the positions the host skips
    8 slide      the window's slides

Runs each kernel once on each batch (1 x 64 KB and 32 x 8 KB of the
corpus, as chip_smoke.py's [zopfli] phase), checks the two kernels' node
arrays equal, and prints, a JSON line per batch and kernel, the cycles a
visited position spends in each phase (summed over the 32 threads of the
lane's warp, over 32) and its share; then both kernels' times as built for
the main path (time_device_fn, CUDA events, in turns direct, window,
window, direct), the instrumented ones, and the window kernel's at windows
of 256-2048 slots (each == the direct kernel).  First it counts both
kernels' memory instructions by address space in the SASS (cuobjdump).  Needs a CUDA card and nvcc;
prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from .. import build
from ..ops import device_zopfli as Z
from ..utils.benchmarks import corpus, time_device_fn

PHASES = ("node", "cache", "queue", "min len", "cands", "cand runs",
          "matches", "loop", "slide", "cand relax", "match relax",
          "cand loads")
WINDOWS = (256, 512, 1024, 2048)
BATCHES = ((1, 65536), (32, 8192))   # lanes x bytes


def phase_lib() -> ctypes.CDLL:
    """csrc/zopfli.cu with the phase clocks, built at first use."""
    name = "brotli_tpu_torch_zopfli_phases"
    if name not in build._libs:
        nvcc = build._nvcc()
        path = build._build(name, [nvcc, *build.NVCC_FLAGS, "-DZOPFLI_PHASE_CLOCKS"],
                            [nvcc, *build.NVCC_LINK_FLAGS],
                            [build.CSRC / "zopfli.cu"])
        build._load(name, path, {
            "brotli_torch_zopfli": build._ZOPFLI_ARGS + [ctypes.c_void_p],
            "brotli_torch_zopfli_direct":
                build._ZOPFLI_DIRECT_ARGS + [ctypes.c_void_p],
            "brotli_torch_zopfli_clocks": [ctypes.c_void_p],
        })
    return build._libs[name]


def clocks(lib) -> np.ndarray:
    """The counters since the last read, (2 kernels, 12 phases), zeroed."""
    out = np.zeros((2, len(PHASES)), np.uint64)
    rc = lib.brotli_torch_zopfli_clocks(out.ctypes.data)
    if rc:
        raise RuntimeError(f"reading the phase clocks failed: cudaError {rc}")
    return out


def run(lib, zb: Z.ZopfliBatch, window: bool) -> Z.ZopfliNodes:
    """One launch of the instrumented window or direct kernel."""
    out = Z._alloc_nodes(zb)
    stream = torch.cuda.current_stream(zb.device).cuda_stream
    if window:
        args, rec = Z._c_args_win(zb, out, *Z.card_config(zb))
        rc = lib.brotli_torch_zopfli(*args, stream)
    else:
        sms = torch.cuda.get_device_properties(zb.device).multi_processor_count
        rc = lib.brotli_torch_zopfli_direct(*Z._c_args(zb, out, sms), stream)
    if rc:
        raise RuntimeError(f"instrumented launch failed: cudaError {rc}")
    torch.cuda.synchronize()
    return out


def sass_counts() -> dict:
    """Memory instructions of both kernels in the main path's library by
    address space, from `cuobjdump -sass`: shared (LDS/STS), global
    (LDG/STG), generic (LD/ST), local (LDL/STL)."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    lib = build.BUILD_DIR / "libbrotli_tpu_torch_kernels.so"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ", 1)[1].strip()
            name = next((k for k in ("zopfli_direct_kernel", "zopfli_kernel")
                         if k in fn), None)
            continue
        op = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z]+)[.\s]", line)
        if name and op and op.group(1) in ("LDS", "STS", "LDG", "STG", "LD",
                                           "ST", "LDL", "STL"):
            row = counts.setdefault(name, {})
            row[op.group(1)] = row.get(op.group(1), 0) + 1
    return counts


def launch_at(zb: Z.ZopfliBatch, window: int) -> Z.ZopfliNodes:
    """The main path's window kernel at a window of `window` slots (the
    grid card_config gives)."""
    out = Z._alloc_nodes(zb)
    args, rec = Z._c_args_win(zb, out, Z.card_config(zb)[0], window)
    Z._run("brotli_torch_zopfli", args, zb, f"window {window}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("zopfli_phases: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}")
    lib = phase_lib()
    clocks(lib)
    build.kernels_lib()
    print(json.dumps({"sass_memory_instructions": sass_counts()}))
    for lanes, width in BATCHES:
        data = corpus(65536 + lanes * width)[65536 if lanes > 1 else 0:]
        zb = Z.stage_zopfli([data[i * width:(i + 1) * width]
                             for i in range(lanes)], device="cuda")
        steps = int(zb.active.sum())
        outs = {}
        for kernel, window in (("direct", False), ("window", True)):
            outs[kernel] = run(lib, zb, window)
            cyc = clocks(lib)[int(window)].astype(np.float64) / 32 / steps
            print(json.dumps({
                "batch": f"{lanes}x{width}", "kernel": kernel,
                "visited": steps, "cycles_a_step": round(float(cyc.sum()), 1),
                "phases": {p: [round(float(c), 1),
                               round(float(c / cyc.sum()), 4)]
                           for p, c in zip(PHASES, cyc)}}))
        for a, b, name in zip(outs["direct"], outs["window"],
                              Z.ZopfliNodes._fields):
            if not torch.equal(a, b):
                raise RuntimeError(f"window != direct kernel in {name} at "
                                   f"{lanes}x{width}")
        lw, ld = (lambda: Z._launch(zb)), (lambda: Z._launch_direct(zb))
        turns = [time_device_fn(f) * 1e3 for f in (ld, lw, lw, ld)]
        inst = [time_device_fn(lambda w=w: run(lib, zb, w), rep=1) * 1e3
                for w in (False, True)]
        sweep = {}
        for win in WINDOWS:
            got = launch_at(zb, win)
            if not all(torch.equal(a, b) for a, b in zip(got, outs["direct"])):
                raise RuntimeError(f"window {win} != direct at {lanes}x{width}")
            sweep[win] = round(time_device_fn(lambda: launch_at(zb, win)) * 1e3, 4)
        print(json.dumps({
            "batch": f"{lanes}x{width}", "card": card,
            "window_config": Z.card_config(zb), "ms_by_window": sweep,
            "ms_turns_direct_window_window_direct": [round(t, 4) for t in turns],
            "ms_direct": round((turns[0] + turns[3]) / 2, 4),
            "ms_window": round((turns[1] + turns[2]) / 2, 4),
            "ms_instrumented_direct_window": [round(t, 4) for t in inst]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
