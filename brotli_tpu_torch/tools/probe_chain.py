"""The v2 row probe's chain on the card: cycles a row against the SASS.

    python3 -m brotli_tpu_torch.tools.probe_chain

Each of probe_v2's 1024 tile elements runs its 2048 rows as one chain of
dependent operations (csrc/probe.cu), so a row can take no less than the
latency of that chain.  This prints, for levels 4 and 5 of
`probe_v2_kernel` (csrc/probe.cu, built for the main path by build.py):

* from `cuobjdump -sass` of the built library, each loop of the kernel
  that stores a row (STG): its SASS instructions, the rows an iteration
  runs (its STG stores; at level 5 also its LDS, the lane gather), and
  the dependent instructions an iteration adds to the longest chain of
  register and predicate dependences when the body runs again and again
  (the loop-carried chain), so also a row's;
* the probe's ns a row (tools/probe.run_probe_v2: CUDA events, best of 3
  windows of 20 launches), the SM clock that nvidia-smi reads while the
  probe runs (`clocks.sm`, sampled every 50 ms over ~1 s of launches),
  and so the cycles a row and the cycles a dependent instruction.

Needs a CUDA card, nvcc and cuobjdump.  Prints the card's name and power
limit, then one JSON line a level; `--sass-dir DIR` also writes each
level's SASS listing into DIR.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import threading
import time
from pathlib import Path

import torch

from .. import build
from . import probe as P

# opcodes whose first operand is no register they write
NO_DEST = ("ST", "STS", "STG", "STL", "RED", "BRA", "BAR", "EXIT", "RET",
           "CALL", "BSYNC", "BSSY", "WARPSYNC", "NOP", "MEMBAR", "DEPBAR",
           "ERRBAR", "YIELD", "BPT", "CCTL", "LDGDEPBAR", "JMP", "BREAK",
           "BMOV", "SYNCS", "ARRIVES", "FENCE")
_REG = re.compile(r"\b(U?R\d+|U?P\d+)\b")
_PRED = re.compile(r"U?P(\d+|T)")
_DEST = re.compile(r"U?R(\d+|Z)|U?P(\d+|T)")
_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]


def sm_clock_mhz(fn, seconds: float = 1.0) -> list[int]:
    """clocks.sm in MHz, sampled by `nvidia-smi -lms 50` while fn() runs
    back to back on the card for about `seconds`: only the samples read
    between the first launch and the last synchronise.  The sampler
    process is ended before this returns."""
    fn()
    torch.cuda.synchronize()
    start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    n = max(1, int(seconds / max(time.perf_counter() - start, 1e-6)))
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "-lms", "50",
         "--format=csv,noheader,nounits"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    samples: list[tuple[float, int]] = []

    def read():
        for line in proc.stdout:
            if line.strip().isdigit():
                samples.append((time.perf_counter(), int(line)))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        time.sleep(0.5)       # the sampler's own start-up
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        reader.join(timeout=30)
        proc.stdout.close()
    got = [mhz for t, mhz in samples if t0 <= t <= t1]
    if not got:
        raise RuntimeError("no clocks.sm sample fell inside the probe's run")
    return got


def parse_sass(text: str) -> list[tuple[int, str, list[str], list[str], str]]:
    """(address, opcode, registers read, registers written, operands) of
    each instruction of one function's SASS.  A guarded instruction reads
    its guard and, as it may keep the old value, its destinations."""
    out = []
    for m in _LINE.finditer(text):
        addr, body = int(m.group(1), 16), m.group(2)
        guard = None
        g = re.match(r"@(!?)(U?P\w+)\s+", body)
        if g:
            guard, body = g.group(2), body[g.end():]
        parts = body.split(None, 1)
        op = parts[0]
        ops = [o.strip() for o in parts[1].split(",")] if len(parts) > 1 else []
        base = op.split(".")[0]
        # destinations: the first operand; also the second where it is a
        # predicate (ISETP's and PLOP3's pair, IADD3's and LEA's carry
        # out) or LOP3's register beside a predicate result
        n_dest = 0
        if ops and base not in NO_DEST and _DEST.fullmatch(ops[0]):
            n_dest = 1
            if len(ops) > 1 and (_PRED.fullmatch(ops[1]) or (
                    base == "LOP3" and _PRED.fullmatch(ops[0])
                    and _DEST.fullmatch(ops[1]))):
                n_dest = 2
        dests = [o for o in ops[:n_dest] if _REG.fullmatch(o)]
        if dests and (".64" in op or ".WIDE" in op):
            dests.append(_pair(dests[0]))
        srcs = []
        for o in ops[n_dest:]:
            for m in _REG.finditer(o):
                srcs.append(m.group(1))
                if o.startswith(".64", m.end()):     # a 64-bit address
                    srcs.append(_pair(m.group(1)))
        if guard and guard not in ("PT", "UPT"):
            srcs.append(guard)
            srcs.extend(dests)
        out.append((addr, op, srcs, dests, " ".join(ops)))
    return out


def _pair(reg: str) -> str:
    m = re.fullmatch(r"(U?R)(\d+)", reg)
    return f"{m.group(1)}{int(m.group(2)) + 1}" if m else reg


def chain_per_iteration(body, iters: int = 16) -> float:
    """Dependent instructions the longest dependence chain gains an
    iteration when `body` runs `iters` times in a row (its growth from
    the middle iteration to the last)."""
    depth: dict[str, int] = {}
    longest, mid = 0, 0
    for it in range(iters):
        for _, _, srcs, dests, _ in body:
            d = 1 + max((depth.get(r, 0) for r in srcs), default=0)
            for r in dests:
                depth[r] = d
            longest = max(longest, d)
        if it == iters // 2 - 1:
            mid = longest
    return (longest - mid) / (iters - iters // 2)


def loops(insts) -> list[dict]:
    """Each loop closed by a backward branch: its body and counts."""
    found = []
    for addr, op, _, _, operands in insts:
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)", operands)
        if not m or int(m.group(1), 16) > addr:
            continue
        lo = int(m.group(1), 16)
        body = [x for x in insts if lo <= x[0] <= addr]
        found.append({"start": hex(lo), "end": hex(addr),
                      "instructions": len(body),
                      "stg": sum(x[1].startswith("STG") for x in body),
                      "lds": sum(x[1].startswith("LDS") for x in body),
                      "chain": chain_per_iteration(body)})
    return found


def kernel_sass(level: int) -> str:
    """The SASS of probe_v2_kernel<level> in the main path's library."""
    lib = build.BUILD_DIR / "libbrotli_tpu_torch_kernels.so"
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    name = f"probe_v2_kernelILi{level}E"
    blocks = re.split(r"\n\s*Function : ", sass)
    mine = [b for b in blocks if b.split("\n", 1)[0].find(name) >= 0]
    if len(mine) != 1:
        raise RuntimeError(f"{len(mine)} SASS functions named {name}")
    return mine[0]


def analyse(level: int, sass_dir: Path | None = None) -> dict:
    """The row loops of probe_v2_kernel<level>; with `sass_dir`, its SASS
    written there as probe_v2_kernel_L<level>.sass."""
    text = kernel_sass(level)
    if sass_dir is not None:
        sass_dir.mkdir(parents=True, exist_ok=True)
        (sass_dir / f"probe_v2_kernel_L{level}.sass").write_text(text)
    insts = parse_sass(text)
    rows = [lp for lp in loops(insts) if lp["stg"]]
    if not rows:
        raise RuntimeError(f"level {level}: no loop stores a row")
    for lp in rows:
        lp["chain_a_row"] = lp["chain"] / lp["stg"]
    return {"instructions": len(insts), "row_loops": rows}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="probe_chain")
    ap.add_argument("--sass-dir", type=Path, default=None,
                    help="write each level's SASS listing here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_chain: needs a CUDA card")
    card_str = card()
    print(f"[card] {card_str}")
    build.kernels_lib()
    a = torch.from_numpy(P.probe_inputs()[0]).cuda()
    for level in (4, 5):
        sass = analyse(level, args.sass_dir)
        _, ns = P.run_probe_v2(level)
        mhz = sm_clock_mhz(lambda lv=level: P.probe_v2(a, lv))
        clock = sorted(mhz)[len(mhz) // 2]
        cycles = ns * clock / 1e3
        # the loop that runs the most rows an iteration: the unrolled one
        main_loop = max(sass["row_loops"], key=lambda lp: lp["stg"])
        print(json.dumps({
            "level": level, "card": card_str, "ns_a_row": ns,
            "sm_clock_mhz_median": clock, "sm_clock_mhz_samples": mhz,
            "cycles_a_row": cycles, **sass,
            "dependent_instructions_a_row": main_loop["chain_a_row"],
            "cycles_a_dependent_instruction":
                cycles / main_loop["chain_a_row"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
