#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brotli_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. build  -- nvcc compiles brotli_tpu_torch/csrc/*.cu (sm_90a) at first use,
   and prints nvcc's registers, stack and spills of the queued and direct
   entropy kernels, the windowed and direct v3 kernels, the warp and
   direct resolve kernels and the window and direct Zopfli DP kernels;
2. kernel == plain version on the card, bit for bit (tokens, counts,
   phases, words consumed, bytes, flags), one group of 1024 x 1 KB streams;
   the direct entropy and resolve kernels too; then both resolve kernels
   on those tokens broken on purpose (starved and malformed lanes, a count
   above the token slots, an mlen above the slot or 0), whole tensors;
3. main path -- decode_batch_device_e2e(device="cuda") on the bench's e2e
   shape, 4 groups x 1024 streams x 8192 B = 33.6 MB, must equal the input
   with no host fallback, staged once by the native preflight
   (ops/preflight2_native.stage_v2_native: one pinned buffer, one copy)
   and never by the numpy one, unpacked through pinned buffers
   (collect_lanes_pinned), and both kernels must have launched (the
   direct kernels never);
4. far distances -- 256 x 8 KB streams encoded without a distance cap (the
   reference's resolve ring flags these) decode with no fallback; both
   resolve kernels timed in turns on their tokens, and the resolve kernel
   at a 64-byte window, where copies read the slot back (its far path),
   equal to the plain version;
5. times with CUDA events: each kernel on the staged main-path batch (each
   in turns with its direct form: direct, new, new, direct) and its plain
   PyTorch version at the same shape, held bit for bit against both forms;
   the resolve kernel at windows of 1-16 KB, each equal to the plain
   version; then both resolve kernels in turns on synthetic lanes of the
   same size, all literals or all copies, equal to the bytes they spell;
6. enc kernels == plain versions on the card, bit for bit: both pack
   kernels (the segmented one and the serial one; words, widx, avail, tail
   limbs, ovf), 1024 x 2 KB, for the three literal-tree branches (one
   tree; context-mapped trees in two table groups; block types), and on
   1024 lanes of random records, half of which overflow the buffer; then
   the whole encode of the 2 KB batch on the card against the same encode
   on the CPU, stream for stream, per branch;
7. enc main path -- encode_device_batch(device="cuda") of 1024 x 32 KB =
   33.6 MB at the default knobs, decoded back through
   decode_batch_device_e2e(device="cuda"): equal to the input, no host
   fallback on either side, all six kernels launched (matches, parse,
   records and pack once each; no direct form); CUDA events around each
   stage inside that
   one encode (upload, matches, parse, records, host tables, pack,
   assembly); the streams byte-identical to an encode of the same bytes
   whose match and record stages are the plain versions;
8. parse kernels == plain version on the card, bit for bit (is_cs, is_lit,
   dcode_short): the main path's parse_kernel and its direct form (the
   first design, greedy_parse_direct) at both lazy/gate knob sets over the
   matches of three match-finder settings at 1024 x 2 KB and on hand-made
   edge lanes (a wrapped copy end, copies across tiles, n_valid past n and
   below 0; n = 4096 and an unaligned 3999); at the main encode's 1024 x
   32 KB and the v3 cell's 1024 x 4 KB both kernels equal at every case
   and the plain version once a shape; both kernels timed in turns (direct,
   new, new, direct) at 1024 x 32 KB (default and chain depth 4 matches)
   and 1024 x 4 KB beside the bound, with parse_kernel's launch shape;
9. match and record kernels == plain versions on the card, bit for bit
   (mlen, mdist; rec0, rec1, n_records), the main path's (match_kernel,
   records_kernel) and their direct forms (the first designs): under each
   match setting of phase 8, hash2 and hash_stride 2 (records with and
   without literal contexts, on the parse kernel's output), at 1024 x 2
   KB, at the main encode's 1024 x 32 KB and at the v3 cell's 1024 x 4 KB;
   at the last two, both forms of each kernel timed in turns (direct, new,
   new, direct) beside the plain version and the bound;
10. enc times -- the segmented and the serial pack kernel on the main
   path's records in turns, and the plain version against the main path's
   kernel output and the serial kernel's; then the encoder's host half,
   the yardstick's (numpy staging and pageable copies, the lane features'
   loop, each header built twice, the (lanes, maxH + rows + 2) word table)
   against the new one (one pinned upload laid out on the card, lane
   features counted on the card, the context-map clusterings over C++
   threads, each distinct header built once in C++, the pack inputs in
   one pinned copy, the compact assembly and pinned fetch) in turns at the
   default, bench and v3 settings
   (tools/enc_host_profile.profile_setting: first calls apart, then 5
   runs split into parts and 5 whole runs of each, in turns; each part's
   median and best), the streams byte-identical, no lane host-encoded;
11. enc bench config -- the reference bench's encode setting at the same
   shape: one launch each of matches, parse, records and pack counted,
   the streams byte-identical to the plain stages' encode, every stream
   decodes to
   its chunk through decode_batch_v3(device="cuda", max_groups=8) with no
   fallback, no ovf lane, ratio, stage times, and the plain pack against
   both pack kernels bit for bit at the widest table indexing (8 groups x
   8 trees);
12. v3 kernel == plain version on the card, bit for bit over the bytes and
   all 16 status rows: 1024 x 1 KB port-encoded streams (4 context-mapped
   trees, 2 table groups), host q9/q11 encodes with tree groups and block
   switching in all three categories, one static-dictionary word per
   transform (121) over a group, the compound-dictionary streams, and a
   batch with one poisoned and one truncated lane (both must flag); the
   direct v3 kernel on each too; each batch also staged natively in groups
   of 128 lanes (stage_v3_native), each stream's bytes and status rows
   there equal to the groups of 1024 (the poisoned batch's narrow run held
   to the plain version too); then the host q9/q11 encodes 256 times
   each (1024 lanes, copies from further back than the v3 cell's), the
   windowed kernel equal to the direct one and timed in turns with it;
13. v3 main path -- the reference bench's full-format shape: 6 groups x
   1024 x 4096 B = 25,165,824 B encoded on the card by encode_device_batch
   (lit_ctx_trees=8; one launch each of matches and records a call,
   counted from 0), decoded by decode_batch_v3(device="cuda",
   max_groups=6, dict_dev=stage_dictionary("cuda")): equal to the input,
   no fallback, the decode3 kernel launched on the staged dictionary,
   staged once by the native staging (stage3_native: plan and fill into
   one pinned buffer, one copy) and never by the yardstick's preflight,
   unpacked by collect_lanes_v3_pinned; host clock of the call's parts;
   then the old host half (the yardstick: the joined streams, the native
   parse, numpy staging, pageable copies, the lane loop) once, its output
   equal to the new one's (utils.profiling.profile_v3_decode: first calls
   apart, the new half's best of 5, each part's host clock); the native
   staging at width 1024 equal field for field to batch_to_torch_v3 of the
   yardstick's preflight; 100 of the streams (one table set: one group of
   128 lanes) bit-exact; the yardstick's preflight (best of 3) and the
   Python one (once), their V3Batches equal field for field;
14. v3 times with CUDA events on the staged main batch: the kernel at
   use_dict=False (the bench's timed setting) at the main path's groups
   of 128 lanes in turns with the yardstick's groups of 1024 and with the
   direct kernel, and at use_dict=True; the output allocation and fill
   alone; the plain version once, equal to every run lane for lane;
15. v3 block types -- 1024 x 4 KB encoded on the card with block
   switching (lit_ctx_trees=4, block_types=3, block_seg=512), each stream
   with initial block lengths of its own, through decode_batch_v3(device=
   "cuda") at the port's cap: the groups of the Python preflight's binning
   (over the cap) and of the native one, bit-exact output, 0 fallback
   lanes, one decode3 launch counted from 0, the call's host clock (the
   native staging apart) against the host decoder's;
16. v3 full -- decode_batch_v3_full(device="cuda") on 1024 lanes of three
   64 KB streams (a streaming Encoder(quality=5, lgwin=18) fed 1 KB updates
   in 16 KB metablocks, a spliced parallel_encode stream, an uncompressed
   one):
   equal to the input, no fallback, one kernel launch per round, the
   direct kernel never; the call's host clock with the native header
   walk's, staging's and kernel's shares, against the host decoder's;
   each round's groups of 128 beside the Python preflight's binning of
   the same units; the old host half once, its output equal to the new
   one's (each stream's output kept on the card between rounds; the new
   one's best of 5); then
   each round's batch through both kernels, equal, timed in turns;
17. caps -- the group-cap sweep at 12, 16, 24 and 32 groups: v2, the
   main-path streams G times, both v2 kernels (resolve in turns with its
   direct form); v3, the staged v3 cell
   tiled to G groups, decode3; kernel times, MB/s, peak device memory,
   bytes equal to the input on the card and no flagged lane;
   then sparse batches the caps put on the card, 32 streams whose tables
   all differ (32 groups of one live lane each, under the native binning
   and the Python preflight's; v3 groups of 128 lanes: v2 8 KB, v3 32 KB
   with block switching and a table group a stream, v3 full 64 KB in four
   metablocks), through the drivers at the port's caps: equal to the
   input, no fallback, the groups, the call's host clock, peak device
   memory and kernel times (the v2 resolve in turns with its direct
   form), against the host decoder on the same streams; on the v3 paths
   then the old host half once, its output equal to the new one's (the
   new one's best of 5);
18. probes -- run_probe_v2 at every level and run_probe_v2b at every
   variant of the TPU scripts, launches counted from 0; each kernel's
   outputs held against its plain version bit for bit; ns per row;
19. profile -- profile_e2e_decode on the main-path batch: the round trip's
   old host half (the numpy preflight, batch_to_torch, collect_lanes)
   against the new one (stage_v2_native, collect_lanes_pinned), the first
   call of each apart, then best of 5 each in turns: preflight, staging
   H2D, kernels, unpack + D2H and the whole round trip, and each half's
   device busy share from torch.profiler over one round trip (Chrome
   traces in brotli_tpu_torch/build/trace/old and /new); the two outputs
   equal and equal to the input;
20. multi v2 -- the v2 cell's 4 groups through decode_batches_multichip
   over 4 logical slots (4 CUDA streams on one card): bit-exact, 0
   fallback lanes, 4 entropy and 4 resolve launches; the wall against the
   same groups through one slot (best of 3 each, in turns); one profiled
   4-slot call: the device's busy share and the time kernels of two
   streams ran at once (Chrome trace in brotli_tpu_torch/build/trace/
   multi_v2/), and the same overlap from CUDA events around the kernels'
   wrappers on each slot's stream;
21. multi enc -- 4 x 1024 x 32 KB (128 MiB) through
   encode_batches_multichip over 4 slots: each piece byte-identical to
   encode_device_batch of it, decoded back through
   decode_batches_multichip with 0 fallback lanes, 4 launches of each of
   matches, parse, records, pack, entropy, resolve;
22. multi v3 -- the v3 cell's first 2,048 streams through
   decode_batch_v3_multichip over 4 slots in groups of 512, the dictionary
   staged once: bit-exact, 0 fallback lanes, 4 decode3 launches;
23. multihost -- brotli_tpu_torch.tools.multihost_sim on the card: 2
   processes x 2 slots over gloo, 4 x 1024 x 8 KB encoded on the card and
   decoded back; every process's lists equal the input and the
   single-process encode;
24. dryrun -- entry.dryrun_multichip(4) on the card;
25. entry() -- the port's entry point called once and synchronised;
26. zopfli -- the q10 Zopfli DP's window kernel (csrc/zopfli.cu
   zopfli_kernel, built with -fmad=false) == its direct kernel
   (zopfli_direct_kernel) == zopfli_dp_ref on CUDA tensors, every node
   array, result and count bit for bit, 2 lanes x 2 KB;
   zopfli_commands_device(device="cuda") on 64 KB of the corpus, on the
   51,900-B runs input (utils.benchmarks.runs_input) and on bytes(20000)
   (whose runs reach the host's quick step) == the port's host q10 parse
   (commands and last insert), one window-kernel launch and no direct one
   each, counted from 0; then the two kernels equal and timed in turns
   (direct, window, window, direct) at 1 x 64 KB (the window kernel ==
   zopfli_dp_ref there too, the plain version timed once), at 32 lanes x
   8 KB from distinct corpus offsets (each lane's backtrack == the
   host's) and on the runs input, each with its launch shape (blocks,
   window, shared memory); the host parse's times on the same inputs
   (host clock, the 64 KB three times);
27. device decode (run after phase 17) -- 1024 x 8 KB pieces of the
   corpus, each compressed alone by host_encode at quality 1 + i % 4 (its
   own tables; over 8 spawned processes, the wall printed;
   tools/dd_phases.py's batch): decode_batch_device(device="cuda") ==
   the pieces with one device_decode_kernel launch and none of
   device_decode_direct_kernel counted from 0, its fallback lanes
   exactly the lanes the kernel flags, which are exactly the quality-4
   lanes (static-dictionary references, which the round-1 decode leaves
   to the host), the quality 1-3 streams alone with 0 fallback lanes;
   both kernels == device_decode_ref on the same CUDA tensors (out, pos,
   err), the plain version run once; each kernel's phase split (cycles a
   lane by phase from an instrumented build, tools/dd_phases.py); both
   timed in turns (direct, new, new, direct) beside the bound; the host
   half split (preflight, staging, kernel, unpack); decode_batch_v3 on
   the same batch (its lanes host-decoded); sharded_decode_batch over 4
   logical slots == the pieces, one launch a slot; then 64 x 64 KB
   pieces at quality 1-3 (rows 8x the new kernel's window): the two
   kernels equal, every lane == its piece, the phase split and both in
   turns, no plain run.

Each of phases 20-24 sets the launch counters to 0 just before it and
reads them just after; the kernel line gives them as `multi_launches`.
Every phase ends with a `[wall] [phase]` line, its host clock.
Phase 26 sets the DP kernels' counters to 0 just before each main-path
call of zopfli_commands_device and reads them just after.

Kernel times come from utils.benchmarks.time_device_fn (CUDA events) and
the encoder's stage times from utils.profiling.profile_device_encode,
inside the main encode.  Every timing line carries the card's name and
power limit.  The line before the last is a JSON object describing the
kernels, with each one's bound: the least time the card could take, the
larger of its bytes (inputs read once, outputs written once, counted from
this run's data) over 3.35 TB/s and its integer operations over 67 T/s
(the float32 rate outside the tensor cores, the nearest published peak:
a lower bound on the time); the Zopfli DP's operations are float64, over
34 TFLOP/s.  The last line is {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero and prints no result.  It imports
nothing of JAX and nothing of the JAX package (brotli_tpu): it checks both
before and after its phases.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT_OPS = 67e12            # float32 outside the tensor cores, ops/s
CHUNK = 8192
RESOLVE_WINDOWS = (1024, 2048, 4096, 8192, 16384)  # swept in [times]
GROUPS = 4
MAX_DISTANCE = 2032        # bench.py's e2e encode setting
REF_RING_LIMIT = 4096 - 16  # pallas_resolve.MAX_DEVICE_DISTANCE
ENC_CHUNK = 32768           # device_encode.CHUNK_N
# the reference bench's encode setting (bench.py:62-67, :285-291)
ENC_BENCH = dict(chain_depth=4, table_groups=8, lit_ctx_trees=8,
                 hist_stride=16, sample_stride=2048)
# the reference bench's full-format setting (bench.py:68-72, 336-344)
V3_BENCH = dict(chunk_size=4096, max_distance=1008, chain_depth=4,
                table_groups=1, lit_ctx_trees=8)
V3_GROUPS = 6
# Crafted streams (tests/test_torch_decode3.py builds them with brotli_tpu's
# bit writer): one static-dictionary word per transform, all 121; the
# compound-dictionary copies with their dictionaries (the last one runs
# past the dictionary's end and must flag); a copy whose distance is past
# the window and the dictionary range (must flag).
DICT_121 = bytes.fromhex(
    "1b900400200060030e5caa5587261a1b5687f9d56f0a07e1c3e7851e2ef65de47eb8e0"
    "45470f46f42feadebab8f7b418ebe818e80e8cec70d99d46e5fa6ab52e341b67c3b46e"
    "fa1e6a1d55f6da1cf0dd1a70178c6048460353dd74b84b11ef1655ac576bd33e510793"
    "80719a51c0cb238fa6c46b4defda29e483a5a3c03d53e83a29bf27ff195ae0c285cf8c"
    "c0dc4b9cc91162913143a10c57cda0d939ba23f741c321cc42e60ca79e415d722c36f6"
    "ea5cb2cf5bff4138a0aa0b167b220a208386728c6128258d0de68977d208491d5c2dca"
    "d8657dcb623d37347c479290e619da54c7c0760e84e98133a56aafd6f23688bf437e7c"
    "88a0e914b615048f58fa10c71f157db628c0a54b28a28925ba711190b0322a6e984c71"
    "f42cbda24bbb89f5987297b6cade6c51bd5db477ec029f9bc357d0888b25f252cc64ed"
    "39dd91d212955d02bb17d9304b5e0c")
COMPOUND = [
    ([bytes.fromhex("1b0a000020c3c4c6c293b07401"),
      bytes.fromhex("1b050000a0f0f24292900c")],
     b"hello world dictionary content!"),
    ([bytes.fromhex("1b0c000020422299a008")], [b"AAAABBBB", b"CCCCDDDD"]),
]
COMPOUND_OVERFLOW = (bytes.fromhex("1b12000020c3c4c6429b90d402"), b"tiny")
POISONED = bytes.fromhex("1b0b0000c003c6f6a64397f08172ba0f000001")

# one knob set per literal-tree branch of the pack kernel
ENC_PLAIN_SETS = {
    "one tree": dict(),
    "ctx trees, 2 groups": dict(table_groups=2, lit_ctx_trees=4),
    "block types": dict(lit_ctx_trees=4, block_types=3, block_seg=512),
}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def corpus(n_bytes: int) -> bytes:
    """The JAX package's sorted .py sources then the static dictionary,
    tiled, read as files (utils/benchmarks.corpus)."""
    from brotli_tpu_torch.utils.benchmarks import corpus as repo_corpus

    return repo_corpus(n_bytes)


def device_ms(fn) -> float:
    """Device milliseconds per call of fn(): time_device_fn's best of 3
    windows of 5 calls between CUDA events, after a warm-up call."""
    from brotli_tpu_torch.utils.benchmarks import time_device_fn

    return time_device_fn(fn) * 1e3


def plain_ms(fn) -> float:
    """One run of a plain version, CUDA events around it, no warm-up."""
    from brotli_tpu_torch.utils.benchmarks import time_device_fn

    return time_device_fn(fn, rep=1, samples=1, warm_up=False) * 1e3


def in_turns(new, old) -> dict:
    """device_ms of two versions of a kernel in turns (old, new, new, old):
    the means and the four times."""
    o1, n1, n2, o2 = device_ms(old), device_ms(new), device_ms(new), device_ms(old)
    return {"new": (n1 + n2) / 2, "old": (o1 + o2) / 2, "turns": (o1, n1, n2, o2)}


def turns_str(t: dict) -> str:
    o1, n1, n2, o2 = t["turns"]
    return (f"{t['new']:.4f} ms (direct kernel {t['old']:.4f} ms, "
            f"{t['old'] / t['new']:.2f}x; in turns direct {o1:.4f}, new "
            f"{n1:.4f}, new {n2:.4f}, direct {o2:.4f})")


def bound_ms(n_bytes: float, n_ops: float = 0.0) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / HBM_BPS * 1e3, n_ops / INT_OPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def check_no_reference_imports() -> None:
    """Neither JAX nor the JAX package (brotli_tpu) was imported."""
    bad = sorted(m for m in sys.modules
                 if m in ("jax", "brotli_tpu")
                 or m.startswith(("jax.", "brotli_tpu.")))
    check(not bad, f"the port imported {bad[:5]}")


def max_abs_err(a, b) -> int:
    err = 0
    for x, y in zip(a, b):
        check(x.shape == y.shape, f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        if x.numel():
            err = max(err, int((x.to(torch.int64) - y.to(torch.int64))
                               .abs().max().item()))
    return err


@contextlib.contextmanager
def spied(mod, *names):
    """mod.<name> for each of `names` wrapped: each call's host clock,
    through a synchronise before and after, adds to s[name], and its first
    argument and result go to calls[name]."""
    s = {n: 0.0 for n in names}
    calls = {n: [] for n in names}
    orig = {n: getattr(mod, n) for n in names}

    def wrap(n):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = orig[n](*a, **k)
            torch.cuda.synchronize()
            s[n] += time.perf_counter() - t
            calls[n].append((a[0] if a else None, out))
            return out
        return run

    for n in names:
        setattr(mod, n, wrap(n))
    try:
        yield s, calls
    finally:
        for n in names:
            setattr(mod, n, orig[n])


def batch_diff(a, b) -> list[str]:
    """The fields in which two V3Batches differ (arrays: dtype, shape and
    every value)."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            same = (isinstance(y, np.ndarray) and x.dtype == y.dtype
                    and x.shape == y.shape and bool((x == y).all()))
        else:
            same = x == y
        if not same:
            diff.append(f.name)
    return diff


def python_groups(streams: list[bytes]) -> int:
    """The groups that the Python preflight's binning (ops/preflight3.py:
    _sig_of and maxbw, as assemble_v3) makes of single-metablock streams,
    whatever the cap."""
    from brotli_tpu_torch.ops.preflight3 import NSTREAM, preflight_one_v3

    keys = Counter()
    for x in streams:
        pre = preflight_one_v3(x)
        check(pre is not None, "preflight_one_v3 refused a stream")
        keys[pre.sig + pre.maxbw.to_bytes(4, "little")] += 1
    return sum(-(-c // NSTREAM) for c in keys.values())


def python_groups_at(streams: list[bytes], stream, bit, maxbw) -> int:
    """The same for one round of decode_batch_v3_full: unit u's
    _MetablockState read at bit bit[u] of streams[stream[u]], binned by
    _sig_of and maxbw (each distinct stream and bit read once)."""
    from brotli_tpu_torch.decode.bitreader import BitReader
    from brotli_tpu_torch.decode.engine import _MetablockState
    from brotli_tpu_torch.ops.preflight3 import NSTREAM, _sig_of

    sigs, keys = {}, Counter()
    for s_i, b, mb in zip(stream, bit, maxbw):
        at = (int(s_i), int(b))
        if at not in sigs:
            br = BitReader(streams[at[0]])
            br.bitpos = at[1]
            sigs[at] = _sig_of(_MetablockState(br, large_window=False))
        keys[sigs[at] + int(mb).to_bytes(4, "little")] += 1
    return sum(-(-c // NSTREAM) for c in keys.values())


@contextlib.contextmanager
def round_units(streams: list[bytes]):
    """decode_batch_v3_full's rounds: yields a list that gains, for each
    call of stage_units_v3_native, the Python preflight's groups for the
    round's units (python_groups_at) after the call."""
    from brotli_tpu_torch.ops import stage3_native as S3

    orig, groups = S3.stage_units_v3_native, []

    def run(src, stream, bit, mlen, maxbw, *a, **k):
        out = orig(src, stream, bit, mlen, maxbw, *a, **k)
        groups.append((stream.copy(), np.asarray(bit).copy(),
                       np.asarray(maxbw).copy()))
        return out

    S3.stage_units_v3_native = run
    try:
        yield groups
    finally:
        S3.stage_units_v3_native = orig
    groups[:] = [python_groups_at(streams, *g) for g in groups]


def ptxas_report(log: str) -> dict:
    """nvcc -Xptxas -v output -> {entry function: its stack, spill and
    register lines}."""
    out, name = {}, None
    for line in log.splitlines():
        for key in ("Compiling entry function '", "Function properties for "):
            if key in line:
                name = line.split(key, 1)[1].split("'")[0].strip()
        if name and ("stack frame" in line or "registers" in line):
            out.setdefault(name, []).append(line.split(":", 1)[-1].strip())
    return out


def phase_build(tag: str) -> None:
    """nvcc's kernel library and, beside it, g++'s v2 preflight library
    (the main path's host half, so [main] times no build) and the phase
    clocks' build of device_decode.cu (tools/dd_phases.py)."""
    from concurrent.futures import ThreadPoolExecutor

    from brotli_tpu_torch import build
    from brotli_tpu_torch.ops import preflight2_native
    from brotli_tpu_torch.tools import dd_phases

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        host = pool.submit(preflight2_native._lib)
        clocks = pool.submit(dd_phases.phase_lib)  # [device decode]'s split
        build.kernels_lib()
        host.result()
        clocks.result()
    dt = time.perf_counter() - t0
    print(f"[build] kernels and the v2 preflight library built and loaded "
          f"in {dt:.3f} s ({tag})")
    log = build.last_build_log.get("brotli_tpu_torch_kernels", "")
    for name, lines in sorted(ptxas_report(log).items()):
        short = next((k for k in ("decode2_direct_kernel", "decode2_kernel",
                                  "decode3_direct_kernel", "decode3_kernel",
                                  "resolve_direct_kernel", "resolve_kernel",
                                  "zopfli_direct_kernel", "zopfli_kernel",
                                  "match_direct_kernel", "match_kernel",
                                  "records_direct_kernel", "records_kernel",
                                  "device_decode_direct_kernel",
                                  "device_decode_kernel")
                      if k in name), None)
        if short:
            print(f"[build] {short}: {'; '.join(lines)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")


def phase_kernel_vs_plain() -> dict:
    """Both kernels against their plain versions on CUDA tensors."""
    from brotli_tpu_torch import encode_sharded
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    data = corpus(1024 * 1024)
    streams = encode_sharded(data, chunk_size=1024, max_distance=MAX_DISTANCE)
    check(len(streams) == 1024, f"{len(streams)} streams, want 1024")
    batch = D.preflight_shared(streams, groups=1)
    check(batch is not None, "preflight_shared refused the 1 KB batch")
    tb = D.batch_to_torch(batch, "cuda")
    n0, r0 = D.KERNEL_LAUNCHES, R.KERNEL_LAUNCHES
    ker = D.entropy_decode(tb)
    direct = D.entropy_decode_direct(tb)
    ref = D.entropy_decode_ref(tb)
    torch.cuda.synchronize()
    e_err = max_abs_err(ker, ref)
    check(e_err == 0, f"entropy kernel != plain version (max abs err {e_err})")
    d_err = max_abs_err(direct, ref)
    check(d_err == 0, f"direct entropy kernel != plain version ({d_err})")
    tok, count, phase, _ = ker
    check(bool((phase == D.DONE).all()), "entropy kernel left lanes not DONE")
    rd0 = R.DIRECT_LAUNCHES
    out_k, err_k = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
    res_d = R.resolve_tokens_direct(tok, count, tb.mlen, tb.max_mlen)
    out_r, err_r = R.resolve_tokens_ref(tok, count, tb.mlen, tb.max_mlen)
    torch.cuda.synchronize()
    r_err = max_abs_err((out_k, err_k), (out_r, err_r))
    check(r_err == 0, f"resolve kernel != plain version (max abs err {r_err})")
    rd_err = max_abs_err(res_d, (out_r, err_r))
    check(rd_err == 0, f"direct resolve kernel != plain version ({rd_err})")
    check(D.KERNEL_LAUNCHES > n0 and R.KERNEL_LAUNCHES > r0
          and R.DIRECT_LAUNCHES > rd0,
          "a kernel wrapper did not count its launch")
    outs, errs = R.unpack_resolved(out_k, err_k, batch.mlens)
    check(not errs.any(), "resolve flagged lanes of the 1 KB batch")
    check(b"".join(outs) == data, "1 KB batch bytes differ from the input")
    b_err = broken_lanes_vs_plain(tok, count, tb.mlen, tb.max_mlen)
    print(f"[kernel==plain] 1024 lanes x 1 KB: entropy max_abs_err {e_err} "
          f"(direct entropy kernel {d_err}), resolve max_abs_err {r_err} "
          f"(direct resolve kernel {rd_err}; exact equality required)")
    return {"entropy": e_err, "resolve": max(r_err, b_err)}


BAD_TAG2 = (2 << 30) | 1           # a tag-2 token with nothing pending
BAD_DIST = (3 << 30) | (5 << 22) | 0x3FFFFF  # a fused copy from far back


def broken_lanes_vs_plain(tok, count, mlen, max_mlen: int) -> int:
    """Both resolve kernels against the plain version on lanes broken on
    purpose, whole tensors (the bytes a flagged lane wrote before its
    fault, zeros after, and the flags): from a batch's tokens, lanes whose
    last 3 tokens are dropped (starved), given a tag-2 with nothing pending or a copy from
    before the lane's start at a seeded token (malformed), a count above
    the token slots, an mlen above the slot, or mlen 0."""
    from brotli_tpu_torch.ops import resolve as R

    rng = np.random.default_rng(8)
    tok, count, mlen = tok.clone(), count.clone(), mlen.clone()
    n = tok.shape[1]
    lanes = torch.arange(n, device=tok.device)
    at = torch.from_numpy(rng.integers(0, 1 << 30, n)).to(tok.device)
    at = at % count.clamp(min=1)
    kind = lanes % 8
    for k, word in ((1, BAD_TAG2), (2, BAD_DIST)):
        sel = kind == k
        tok[at[sel], lanes[sel]] = torch.tensor(word, dtype=torch.int64).to(
            torch.int32).to(tok.device)
    count = torch.where(kind == 3, (count - 3).clamp(min=0), count)  # starved
    count = torch.where(kind == 4, count + tok.shape[0], count)  # past cap
    mlen = torch.where(kind == 5, max_mlen + 1, mlen)            # past slot
    mlen = torch.where(kind == 6, 0, mlen)
    want = R.resolve_tokens_ref(tok, count, mlen, max_mlen)
    got = [f(tok, count, mlen, max_mlen)
           for f in (R.resolve_tokens, R.resolve_tokens_direct)]
    torch.cuda.synchronize()
    errs = [max_abs_err(g, want) for g in got]
    check(errs == [0, 0], f"resolve kernels != plain version on broken "
          f"lanes: max_abs_err {errs}")
    flags = want[1].cpu()
    n_st = int((flags == R.ERR_STARVED).sum())
    n_mal = int((flags == R.ERR_MALFORMED).sum())
    partial = int(((flags != 0) & (want[0].cpu() != 0).any(dim=1)).sum())
    check(n_st > 0 and n_mal > 0 and partial > 0,
          f"broken lanes: {n_st} starved, {n_mal} malformed, {partial} "
          "flagged with bytes: a case not exercised")
    print(f"[kernel==plain] {n} broken lanes: {n_st} starved, {n_mal} "
          f"malformed ({partial} flagged lanes hold partial bytes): resolve "
          f"kernel and direct kernel max_abs_err {errs[0]}, {errs[1]} "
          "against the plain version (exact equality of whole tensors)")
    return max(errs)


def main_path_streams() -> tuple[bytes, list[bytes]]:
    from brotli_tpu_torch import encode_sharded

    data = corpus(1024 * CHUNK)
    t0 = time.perf_counter()
    streams = encode_sharded(data, chunk_size=CHUNK, max_distance=MAX_DISTANCE)
    dt = time.perf_counter() - t0
    comp = sum(map(len, streams))
    print(f"[main] host encode of {len(data)} B into {len(streams)} streams: "
          f"{dt:.3f} s (host clock), ratio {comp / len(data):.4f}")
    check(len(streams) == 1024, f"{len(streams)} streams, want 1024")
    return data, streams


def phase_main_path(data: bytes, streams: list[bytes]) -> dict:
    """decode_batch_device_e2e on 4 x 1024 x 8 KB, counting launches; the
    batch staged by the native preflight (stage_v2_native, once), never by
    the numpy one."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import preflight2_native as N
    from brotli_tpu_torch.ops import resolve as R

    batch = streams * GROUPS
    expect = data * GROUPS
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    D.KERNEL_LAUNCHES = 0
    R.KERNEL_LAUNCHES = 0
    D.DIRECT_LAUNCHES = 0
    R.DIRECT_LAUNCHES = 0
    with spied(N, "stage_v2_native") as (_, native), \
            spied(D, "preflight_shared", "preflight_binned") as (_, numpy_):
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_device_e2e(batch, device="cuda",
                                                       groups=GROUPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    launches = {"entropy": D.KERNEL_LAUNCHES, "resolve": R.KERNEL_LAUNCHES}
    check(D.DIRECT_LAUNCHES == 0 and R.DIRECT_LAUNCHES == 0,
          "the main path launched a direct kernel")
    check(len(native["stage_v2_native"]) == 1
          and not any(numpy_.values()),
          "the main path did not stage through stage_v2_native alone")
    staged = native["stage_v2_native"][0][1]
    del native, numpy_
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(len(got) == len(batch), "wrong number of outputs")
    check(b"".join(got) == expect, "main-path output differs from the input")
    check(fell == 0, f"{fell} lanes fell back to the host decoder")
    check(launches["entropy"] >= 1 and launches["resolve"] >= 1,
          f"a kernel of the path never launched: {launches}")
    print(f"[main] {len(expect)} B decoded bit-exact through device='cuda', "
          f"staged by stage_v2_native ({staged.groups} groups, Wpad "
          f"{staged.tb.wpad}), 0 fallback lanes, launches {launches}; whole "
          f"call {dt:.3f} s (host clock: preflight, copies, kernels, unpack; "
          "the path's first call)")
    return launches


def phase_far(card_str: str) -> dict:
    """Copies further back than the reference ring's 4080 B decode here;
    both resolve kernels timed in turns on the batch's tokens; then the
    resolve kernel at a 64-byte window, where copies read their slot back
    (the window's far path), against the plain version."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    data = corpus(256 * CHUNK)
    streams = brotli_tpu_torch.encode_sharded(data, chunk_size=CHUNK)
    batch = D.preflight_shared(streams, groups=1)
    check(batch is not None, "preflight_shared refused the far batch")
    tok, count, _ = D.run_batch(batch, "cuda")
    t = tok.to(torch.int64) & 0xFFFFFFFF
    valid = torch.arange(t.shape[0], device=t.device)[:, None] < count[None, :]
    dist = torch.where((t >> 30) == 3, t & 0x3FFFFF,
                       torch.where((t >> 30) == 2, t & 0x3FFFFFFF, 0))
    far_lanes = int(((dist > REF_RING_LIMIT) & valid).any(dim=0).sum().item())
    check(far_lanes > 0, "no lane has a copy beyond 4080 B: case not exercised")
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(b"".join(got) == data, "far-distance output differs from the input")
    check(fell == 0, f"{fell} far-distance lanes fell back to the host")
    print(f"[far] 256 x 8 KB without max_distance: {far_lanes} lanes copy "
          "from beyond 4080 B; decoded bit-exact, 0 fallback lanes")
    tb = D.batch_to_torch(batch, "cuda")
    args = (tok, count, tb.mlen, tb.max_mlen)
    st = {}
    turns = in_turns(
        lambda: st.__setitem__("n", R.resolve_tokens(*args)),
        lambda: st.__setitem__("o", R.resolve_tokens_direct(*args)))
    # a fused copy further back than the window and its own length reads
    # every source byte from the slot: the far path
    fused_len = (t >> 22) & 0xFF
    far_reads = int(((t >> 30 == 3) & (dist > R.WINDOW_MIN + fused_len)
                     & valid).sum().item())
    check(far_reads > 0, "no copy reaches past a 64-byte window")
    own = R.launch_config
    R.launch_config = lambda *a: R.WINDOW_MIN
    try:
        small = R.resolve_tokens(*args)
    finally:
        R.launch_config = own
    want = R.resolve_tokens_ref(*args)
    errs = [max_abs_err(x, want) for x in (st["n"], st["o"], small)]
    check(errs == [0, 0, 0], f"[far] resolve kernels != plain version "
          f"(own window, direct, 64-byte window): {errs}")
    print(f"[far] {card_str}: resolve kernel {turns_str(turns)} on these "
          f"tokens; "
          f"at a {R.WINDOW_MIN}-byte window {far_reads} fused copies read "
          "every source byte back from the slot (the far path); all three "
          "equal the plain version bit for bit")
    return {"err": max(errs), "ms": turns["new"],
            "direct_ms": turns["old"]}


def phase_times(streams: list[bytes], card_str: str) -> dict:
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    batch_streams = streams * GROUPS
    t0 = time.perf_counter()
    batch = D.preflight_shared(batch_streams, groups=GROUPS, rate_sort=True)
    pre_ms = (time.perf_counter() - t0) * 1e3
    check(batch is not None, "preflight_shared refused the main batch")
    tb = D.batch_to_torch(batch, "cuda")
    total = int(batch.mlens.sum())
    state = {}

    def ent():
        state["e"] = D.entropy_decode(tb)

    def res():
        tok, count, _, _ = state["e"]
        state["r"] = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)

    ent_t = in_turns(ent, lambda: state.__setitem__(
        "d", D.entropy_decode_direct(tb)))
    ent_ms = ent_t["new"]
    res_t = in_turns(res, lambda: state.__setitem__(
        "rd", R.resolve_tokens_direct(*state["e"][:2], tb.mlen, tb.max_mlen)))
    res_ms = res_t["new"]
    # the wrappers zero their token and byte outputs; that fill is inside
    # the times above, so it is timed alone too
    ent_fill = device_ms(lambda: D._alloc_outputs(tb))
    res_fill = device_ms(lambda: R._alloc_outputs(state["e"][0], tb.max_mlen))
    mbps = total / ((ent_ms + res_ms) * 1e-3) / 1e6
    lanes = D.lanes_per_warp(tb.n_lanes, D.sm_count(tb.device))
    props = torch.cuda.get_device_properties(tb.device)
    window = R.launch_config(tb.n_lanes, tb.max_mlen,
                             props.multi_processor_count,
                             props.shared_memory_per_multiprocessor,
                             props.max_threads_per_multi_processor)
    print(f"[times] {card_str}: entropy kernel {turns_str(ent_t)}, "
          f"{lanes} lanes a warp; resolve kernel {turns_str(res_t)}, "
          f"window {window} B a lane; per "
          f"{total} B batch (time_device_fn: CUDA events, best of 3 windows "
          f"of 5 each; of which output allocation and zero-fill "
          f"{ent_fill:.4f} ms and {res_fill:.4f} ms)")
    print(f"[times] {card_str}: e2e device decode {mbps:.2f} MB/s "
          "(decoded bytes / both kernels' device time, batch staged)")
    print(f"[times] {card_str}: host preflight {pre_ms:.3f} ms for "
          f"{len(batch_streams)} streams (host clock, apart from the above)")

    # the plain versions once each, on CUDA tensors at the same shape (their
    # PyTorch ops are warm from the kernel == plain phase)
    pe = plain_ms(lambda: state.__setitem__("pe", D.entropy_decode_ref(tb)))
    tok, count, _, widx = state["e"]
    pr = plain_ms(lambda: state.__setitem__(
        "pr", R.resolve_tokens_ref(tok, count, tb.mlen, tb.max_mlen)))
    errs = {"entropy": max_abs_err(state["e"], state["pe"]),
            "resolve": max_abs_err(state["r"], state["pr"])}
    check(errs == {"entropy": 0, "resolve": 0},
          f"kernel != plain version on the main-path batch: {errs}")
    d_err = max_abs_err(state["d"], state["pe"])
    check(d_err == 0, f"direct entropy kernel != plain version on the "
          f"main-path batch: {d_err}")
    rd_err = max_abs_err(state["rd"], state["pr"])
    check(rd_err == 0, f"direct resolve kernel != plain version on the "
          f"main-path batch: {rd_err}")
    print(f"[times] {card_str}: plain entropy {pe:.3f} ms, plain resolve "
          f"{pr:.3f} ms on the same batch (CUDA events, one run each)")
    # the resolve kernel at other windows (through a patched launch_config)
    own, sweep = R.launch_config, {}
    for w in RESOLVE_WINDOWS:
        R.launch_config = lambda *a, w=w: w
        try:
            sweep[w] = device_ms(res)
        finally:
            R.launch_config = own
        check(max_abs_err(state["r"], state["pr"]) == 0,
              f"resolve kernel at a {w}-byte window != plain version")
    print(f"[times] {card_str}: resolve kernel at a window of "
          + ", ".join(f"{w} B {t:.4f} ms" for w, t in sweep.items())
          + f" (launch_config's is {window} B); each equal to the plain "
          "version")
    # bounds: the words each lane consumed, the tables and per-lane scalars
    # in, the tokens produced and three status words a lane out; then the
    # tokens and counts in, the decoded bytes and a flag a lane out
    n = tb.n_lanes
    tokens = int(count.to(torch.int64).sum().item())
    words = int(widx.to(torch.int64).sum().item())
    tables = sum(t.numel() for t in (tb.lit, tb.cmd, tb.dist, tb.dx,
                                     tb.consts))
    ent_bound = bound_ms(4 * (words + tables + 2 * n + tokens + 3 * n))
    res_bound = bound_ms(4 * (tokens + 2 * n + n) + total)
    print(f"[times] {card_str}: bound entropy {ent_bound[0]:.6f} ms "
          f"({words} words consumed, {tokens} tokens; {ent_bound[1]}), "
          f"resolve {res_bound[0]:.6f} ms ({total} B out; {res_bound[1]})")
    return {"entropy_ms": ent_ms, "resolve_ms": res_ms,
            "direct_entropy_ms": ent_t["old"],
            "direct_resolve_ms": res_t["old"],
            "plain_entropy_ms": pe, "plain_resolve_ms": pr,
            "entropy_bound": ent_bound, "resolve_bound": res_bound,
            "errs": errs}


def phase_resolve_synthetic(card_str: str) -> None:
    """What a step and a copy cost: both resolve kernels in turns on two
    batches of the v2 cell's size (4096 lanes of 8192 B, bytes from seed
    0), one all 3-byte literals, the other one literal and then fused
    3-byte copies from 3 back, so as many tokens and steps with no copy or
    with every token a copy.  Both equal the bytes the tokens spell."""
    from brotli_tpu_torch.ops import resolve as R

    n, mlen = GROUPS * 1024, CHUNK
    k = -(-mlen // 3)
    b = np.random.default_rng(0).integers(0, 256, (k, n, 3), dtype=np.uint32)
    lits = (3 << 24) | b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    cps = lits.copy()
    cps[1:] = (3 << 30) | (3 << 22) | 3
    spelled = {"literals": b.transpose(1, 0, 2).reshape(n, 3 * k),
               "copies": np.tile(b[0], k)}
    m = torch.full((n,), mlen, dtype=torch.int32, device="cuda")
    count = torch.full((n,), k, dtype=torch.int32, device="cuda")
    for name, t in (("literals", lits), ("copies", cps)):
        args = (torch.from_numpy(t.view(np.int32)).cuda(), count, m, mlen)
        st = {}
        turns = in_turns(
            lambda: st.__setitem__("n", R.resolve_tokens(*args)),
            lambda: st.__setitem__("o", R.resolve_tokens_direct(*args)))
        want = torch.from_numpy(
            spelled[name][:, :mlen].astype(np.uint8)).cuda()
        for out, err in (st["n"], st["o"]):
            check(torch.equal(out, want) and not bool(err.any()),
                  f"synthetic {name}: a resolve kernel's bytes or flags")
        print(f"[synthetic] {card_str}: {n} lanes x {mlen} B, {k} tokens a "
              f"lane ({k / 32:.1f} steps of 32), all {name}: resolve kernel "
              f"{turns_str(turns)}; both kernels spell the tokens' bytes, "
              "0 flagged lanes")


def enc_pack_batch(data: bytes, chunk: int, table_groups: int = 1,
                   lit_ctx_trees: int = 1, block_types: int = 1,
                   block_seg: int = 2048):
    """The pack kernel's inputs for `data`, made on the card by the port's
    encoder stages (no kernel launched)."""
    from brotli_tpu_torch.ops import device_encode as E

    state = E._encode_start(data, torch.device("cuda"), chunk, 1, 256,
                            lit_ctx=lit_ctx_trees > 1,
                            block_types=block_types, block_seg=block_seg)
    return E.prepare_pack(state, 22, table_groups, lit_ctx_trees)


def ovf_pack_batch(seed: int = 17):
    """1024 lanes of 256 random records of every kind against random
    tables of two groups with two literal trees: symbol codes up to 15 bits
    and extras up to 24, so the first 512 lanes (a 15-bit distance code and
    21-24 extra bits every row) overflow the buffer; lane 5 names a group
    outside the table stack.  On the card."""
    from brotli_tpu_torch.ops import device_encode as E

    rng = np.random.default_rng(seed)
    rows, lanes, G, nt = 256, 1024, 2, 2
    kind = rng.integers(0, 4, (rows, lanes))
    code = np.select(
        [kind == E.K_CMD, kind == E.K_DIST, kind == E.K_LIT],
        [rng.integers(0, 704, (rows, lanes)),
         rng.integers(0, 64, (rows, lanes)),
         rng.integers(0, 1 << 26, (rows, lanes)) & ~0x3F00], 0)
    kind[:, :512] = E.K_DIST
    code[:, :512] = rng.integers(56, 64, (rows, 512))
    rec0 = np.where(kind == 0, 0, (kind << 28) | code).astype(np.int32)
    rec1 = rng.integers(0, 1 << 32, (rows, lanes), dtype=np.uint64)
    tabk = E._tab_chunks(nt)
    nbits = rng.integers(1, 16, (G, tabk * 128))
    nbits[:, nt * 256 + 704:] = 15
    bits = rng.integers(0, 1 << 15, (G, tabk * 128)) & ((1 << nbits) - 1)
    cmap = rng.integers(0, nt, (G, 128)).astype(np.int32)
    cmap[:, 127] = [0, 1]
    grp = rng.integers(0, G, lanes).astype(np.int32)
    grp[5] = G
    initav = rng.integers(0, 32, lanes).astype(np.int32)
    init0 = (rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
             & ((1 << initav.astype(np.uint64)) - 1)).astype(np.uint32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return E.PackBatch(
        rec0=put(rec0), rec1=put(rec1.astype(np.uint32).view(np.int32)),
        tab=put(((nbits << 16) | bits).astype(np.int32)), cmap=put(cmap),
        consts=put(E._pack_consts()[0]), grp=put(grp),
        init0=put(init0.view(np.int32)), initav=put(initav), sw=None,
        stype=None, nt=nt, nbt=1, pseg=2048, nseg=1)


def phase_enc_kernel_vs_plain() -> int:
    """Both pack kernels against pack_records_ref on CUDA tensors."""
    from brotli_tpu_torch.ops import device_encode as E

    data = corpus(1024 * 2048)
    worst = 0
    batches = [(f"1024 lanes x 2 KB, {name}",
                enc_pack_batch(data, 2048, **kw)[0])
               for name, kw in ENC_PLAIN_SETS.items()]
    batches.append(("1024 lanes x 256 random records (ovf)", ovf_pack_batch()))
    for name, pb in batches:
        ref = E.pack_records_ref(pb)
        n_ovf = int(ref[1][5].sum().item())
        check(n_ovf == (511 if "ovf" in name else 0),
              f"{n_ovf} ovf lanes in the {name} batch")
        errs = []
        for kernel in (E.pack_records, E.pack_records_serial):
            ker = kernel(pb)
            torch.cuda.synchronize()
            errs.append(max_abs_err(ker, ref))
        check(errs == [0, 0], f"pack kernels != plain version ({name}): "
              f"segmented {errs[0]}, serial {errs[1]}")
        worst = max(worst, *errs)
        print(f"[enc kernel==plain] {name}: max_abs_err {errs[0]} (segmented "
              f"pack), {errs[1]} (serial pack) over words and status, "
              f"{n_ovf} ovf lanes (exact equality required)")
    return worst


def phase_enc_card_vs_cpu() -> None:
    """encode_device_batch on the card == on the CPU (whose stages the tests
    hold against JAX), per knob set.  Only the float32 block typing may
    differ (a segment type that flips); such streams must still decode."""
    import brotli_tpu_torch

    data = corpus(1024 * 2048)
    for name, kw in ENC_PLAIN_SETS.items():
        t0 = time.perf_counter()
        card_s = brotli_tpu_torch.encode_device_batch(
            data, device="cuda", chunk_size=2048, **kw)
        cpu_s = brotli_tpu_torch.encode_device_batch(
            data, device="cpu", chunk_size=2048, **kw)
        differ = [i for i, (a, b) in enumerate(zip(card_s, cpu_s)) if a != b]
        check(len(card_s) == len(cpu_s), f"{name}: stream counts differ")
        check(not differ or "block_types" in kw,
              f"{name}: card and CPU streams differ at lanes {differ[:8]}")
        for i in differ:
            check(brotli_tpu_torch.host_decode(card_s[i])
                  == data[i * 2048:(i + 1) * 2048],
                  f"{name}: card stream {i} does not decode to its chunk")
        print(f"[enc card==cpu] 1024 lanes x 2 KB, {name}: {len(differ)} of "
              f"{len(card_s)} streams differ from the CPU encode "
              f"({time.perf_counter() - t0:.3f} s, host clock)")


def encode_counted(data: bytes, **kw) -> tuple[list[bytes], float, dict]:
    """encode_device_batch on the card through profile_device_encode, the
    match, parse, record and pack launches counted from 0 and the stages
    timed inside that encode, then the same encode with the plain match and
    record stages, whose streams must be the same; returns (streams,
    host-clock s, what was seen: launches, phases,
    the pack kernel's input `pb` and output `pack_out`, the encode's
    state).  The launch counts are read before anything else launches the
    kernels."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import device_encode as E
    from brotli_tpu_torch.tools.enc_stages import plain_stages
    from brotli_tpu_torch.utils.profiling import profile_device_encode

    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    E.KERNEL_LAUNCHES = 0
    E.PARSE_LAUNCHES = 0
    E.MATCH_LAUNCHES = 0
    E.RECORD_LAUNCHES = 0
    E.MATCH_DIRECT_LAUNCHES = E.RECORD_DIRECT_LAUNCHES = 0
    E.PARSE_DIRECT_LAUNCHES = 0
    streams, phases, summary, state = profile_device_encode(
        data, "cuda", chunk_size=ENC_CHUNK, **kw)
    check(E.MATCH_DIRECT_LAUNCHES == E.RECORD_DIRECT_LAUNCHES
          == E.PARSE_DIRECT_LAUNCHES == 0,
          "the encode launched a direct match, parse or record kernel")
    seen = {"launches": E.KERNEL_LAUNCHES,
            "parse_launches": E.PARSE_LAUNCHES,
            "match_launches": E.MATCH_LAUNCHES,
            "record_launches": E.RECORD_LAUNCHES, "phases": phases,
            "pb": state["pb"], "pack_out": (state["words"], state["status"]),
            "state": state}
    fell = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - enc0
    check(len(streams) == 1024, f"{len(streams)} streams, want 1024")
    check(fell == 0, f"{fell} lanes overflowed (host-encoded)")
    check(seen["launches"] == 1,
          f"the pack kernel launched {seen['launches']} times, want 1")
    check(seen["parse_launches"] == 1,
          f"the parse kernel launched {seen['parse_launches']} times, want 1")
    check(seen["match_launches"] == 1 and seen["record_launches"] == 1,
          f"the match and record kernels launched {seen['match_launches']} "
          f"and {seen['record_launches']} times, want 1 each")
    with plain_stages():
        plain = brotli_tpu_torch.encode_device_batch(
            data, device="cuda", chunk_size=ENC_CHUNK, **kw)
    check(plain == streams, "the streams differ from those of the plain "
          "match and record stages")
    sizes = E.stream_sizes(state)
    check(list(sizes) == [len(s) for s in streams],
          "stream_sizes disagrees with the streams' lengths")
    return streams, summary["wall_s"], seen


def enc_breakdown(seen: dict) -> str:
    """Milliseconds per stage (profile_device_encode), in a line that names
    them, and their sum."""
    parts = ", ".join(f"{p.name} {p.seconds * 1e3:.4f} ms"
                      for p in seen["phases"])
    total = sum(p.seconds for p in seen["phases"]) * 1e3
    return f"{parts}; stages sum {total:.4f} ms"


def pack_vs_plain(seen: dict, what: str) -> tuple[int, float]:
    """The plain pack on the PackBatch an encode built, against the
    segmented kernel's output in that encode and against the serial
    kernel's on the same batch, bit for bit; returns (max_abs_err, plain
    ms)."""
    from brotli_tpu_torch.ops import device_encode as E

    out = {}
    ms = plain_ms(lambda: out.__setitem__("p", E.pack_records_ref(seen["pb"])))
    err = max_abs_err(seen["pack_out"], out["p"])
    check(err == 0, f"pack kernel != plain version at {what}: {err}")
    serial_err = max_abs_err(E.pack_records_serial(seen["pb"]), out["p"])
    check(serial_err == 0,
          f"serial pack kernel != plain version at {what}: {serial_err}")
    return max(err, serial_err), ms


def pack_bound(seen: dict) -> tuple[float, str]:
    """The pack kernel's bound on an encode's PackBatch: the non-PAD records
    (rec0 and rec1) and the tables in, the words written and six status
    words a lane out."""
    pb = seen["pb"]
    words, status = seen["pack_out"]
    n_rec = int((((pb.rec0 >> 28) & 0xF) != 0).sum().item())
    tables = sum(t.numel() for t in (pb.tab, pb.cmap, pb.consts, pb.grp,
                                     pb.init0, pb.initav, pb.sw, pb.stype)
                 if t is not None)
    written = int(status[0].to(torch.int64).sum().item())
    return bound_ms(4 * (2 * n_rec + tables + written + 6 * pb.n_lanes))


def phase_enc_main(data: bytes, card_str: str):
    """encode_device_batch -> decode_batch_device_e2e on the card, the
    encode's stages timed inside it."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    dec0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    D.KERNEL_LAUNCHES = 0
    R.KERNEL_LAUNCHES = 0
    D.DIRECT_LAUNCHES = 0
    R.DIRECT_LAUNCHES = 0
    streams, enc_s, seen = encode_counted(data)
    t0 = time.perf_counter()
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = {"matches": seen["match_launches"],
                "parse": seen["parse_launches"],
                "records": seen["record_launches"], "pack": seen["launches"],
                "entropy": D.KERNEL_LAUNCHES, "resolve": R.KERNEL_LAUNCHES}
    check(D.DIRECT_LAUNCHES == 0 and R.DIRECT_LAUNCHES == 0,
          "the encode main path's decode launched a direct kernel")
    dec_fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - dec0
    check(b"".join(got) == data, "encode -> decode differs from the input")
    check(dec_fell == 0, f"{dec_fell} lanes fell back to the host decoder")
    check(min(launches.values()) >= 1,
          f"a kernel of the path never launched: {launches}")
    ratio = sum(map(len, streams)) / len(data)
    print(f"[enc main] {len(data)} B encoded on the card in {enc_s:.3f} s "
          f"({len(data) / enc_s / 1e6:.3f} MB/s, host clock, whole "
          f"encode_device_batch), ratio {ratio:.6f}; decoded back bit-exact "
          f"in {dec_s:.3f} s; 0 ovf lanes, 0 decode fallback lanes, "
          f"stream_sizes equals every stream's length, streams "
          f"byte-identical to the plain match and record stages' encode, "
          f"launches {launches}")
    line = enc_breakdown(seen)
    print(f"[enc times] {card_str}: default knobs, inside that encode "
          f"(profile_device_encode: CUDA events at each stage's ends, one "
          f"run): {line}; whole encode {enc_s * 1e3:.3f} ms (host clock)")
    return launches, seen


def phase_enc_bench(data: bytes, card_str: str) -> tuple[int, dict]:
    """The reference bench's encode setting: the streams decoded back
    through the v3 kernel, the kernels counted and the pack kernel held
    against its plain version at this shape; returns (pack max_abs_err,
    the match, parse and record launches)."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3

    streams, dt, seen = encode_counted(data, **ENC_BENCH)
    launches = {"matches": seen["match_launches"],
                "parse": seen["parse_launches"],
                "records": seen["record_launches"]}
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    n0 = D3.KERNEL_LAUNCHES
    t0 = time.perf_counter()
    got = brotli_tpu_torch.decode_batch_v3(streams, device="cuda",
                                           max_groups=8)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(b"".join(got) == data, "bench-config streams do not decode to "
          "their chunks through decode_batch_v3")
    check(fell == 0, f"{fell} bench-config lanes fell back to the host")
    check(D3.KERNEL_LAUNCHES > n0, "decode_batch_v3 did not launch decode3")
    ratio = sum(map(len, streams)) / len(data)
    print(f"[enc bench-config] {card_str}: {ENC_BENCH}: {len(streams)} "
          f"streams decode to their chunks through "
          f"decode_batch_v3(device='cuda') in "
          f"{dec_s:.3f} s (host clock), 0 fallback lanes, 0 ovf lanes, ratio "
          f"{ratio:.6f}, encode {dt:.3f} s ({len(data) / dt / 1e6:.3f} MB/s, "
          f"host clock), launches: matches {seen['match_launches']}, parse "
          f"{seen['parse_launches']}, records {seen['record_launches']}, pack "
          f"{seen['launches']}; streams byte-identical to the plain match "
          f"and record stages' encode")
    line = enc_breakdown(seen)
    print(f"[enc times] {card_str}: bench setting, inside that encode "
          f"(profile_device_encode, one run): {line}")
    err, plain = pack_vs_plain(seen, "the bench setting")
    print(f"[enc kernel==plain] 1024 lanes x 32 KB, bench setting "
          f"({seen['pb'].tab.shape[0]} groups x {seen['pb'].nt} trees): "
          f"max_abs_err {err} over words and status (segmented and serial "
          f"pack); plain pack {plain:.3f} ms (CUDA events, one run)")
    return err, launches


def phase_enc_halves(card_str: str) -> dict:
    """The encoder's old host half (the yardstick,
    tools/enc_host_profile.old_half) against the new one
    (encode_device_batch) in turns at the default, bench and v3 settings:
    first calls apart, then 5 runs split into parts and 5 whole runs of
    each; the streams byte-identical (profile_setting raises otherwise)
    and no lane host-encoded."""
    import brotli_tpu_torch
    from brotli_tpu_torch.tools.enc_host_profile import (profile_setting,
                                                         report)

    out = {}
    for setting in ("default", "bench", "v3"):
        fb0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
        rep = profile_setting(setting, rounds=5)
        fell = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - fb0
        check(fell == 0, f"[enc times] {setting}: {fell} lanes host-encoded")
        check(set(rep["halves"]) == {"old", "new"},
              f"[enc times] {setting}: halves {sorted(rep['halves'])}")
        report(setting, rep, card_str, tag="enc times")
        print(f"[enc times] {card_str}: {setting}: the old and the new "
              f"half's streams byte-identical in every run, ratio "
              f"{rep['ratio']:.6f}, 0 ovf lanes")
        out[setting] = rep
    return out


# the parse's lazy / gate knob sets, and match-finder settings whose
# matches it parses (default; the bench's chain depth; the v3 cell's
# distance cap)
PARSE_KNOBS = [((105, 175), 9), ((60, 120), 12)]
PARSE_MATCH_SETS = {"default": dict(),
                    "chain_depth 4": dict(chain_depth=4),
                    "max_distance 1008": dict(chain_depth=4,
                                              max_distance=1008)}


def parse_inputs(data: bytes, chunk: int, **match_kw):
    """(mlen, mdist, n_valid) on the card, as the encode's first stage
    gives them to the parse."""
    from brotli_tpu_torch.ops import device_encode as E

    data_t, _, n_valid = E.stage_input(data, chunk, torch.device("cuda"))
    mlen, mdist = E.find_matches(data_t, n_valid, **match_kw)
    return mlen, mdist, n_valid


def parse_edge_lanes(n: int):
    """(mlen, mdist, n_valid) on the card: 8 hand-made lanes of n >= 3200
    positions (several of parse_kernel's 1,024-position tiles) for the parse
    kernels' edges (numpy, seed 31): a copy end that wraps past int32, a
    copy to the lane's end from position 100, copies across tile edges and
    onto them, mdist <= 0 at copy starts, a take at every position, n_valid
    past n and below 0, a copy past the lane's end."""
    rng = np.random.default_rng(31)
    mlen = np.zeros((8, n), np.int32)
    mdist = np.zeros((8, n), np.int32)
    nv = np.full(8, n, np.int32)
    mlen[0, 1500], mdist[0, 1500] = 2**31 - 301, 2   # 1500 + len wraps
    mlen[0, 1600], mdist[0, 1600] = 50, 9
    mlen[1, 100], mdist[1, 100] = 2**31 - 1001, 1
    for p, ln in ((5, 2100), (2105, 967), (3072, 30), (3199, 10)):
        mlen[2, p], mdist[2, p] = ln, 6
    for k, d in enumerate((4, 0, 11, -5, 11, 0, 4)):
        mlen[3, 1000 + 30 * k], mdist[3, 1000 + 30 * k] = 10, d
    mlen[4] = 4
    mdist[4] = rng.choice(np.array([4, 11, 15, 16, 5, 7], np.int32), n)
    live = rng.random(n) < 0.4
    mlen[5] = np.where(live, rng.integers(4, 40, n), 0)
    mdist[5] = np.where(live, rng.integers(1, 20, n), 0)
    nv[5], nv[6] = 5 * n, -3
    mlen[6, 50:60], mdist[6, 50:60] = 8, 2
    mlen[7, n - 20], mdist[7, n - 20] = 100, 7
    return tuple(torch.from_numpy(a).cuda() for a in (mlen, mdist, nv))


def parse_forms(ins, lazy, gate, ref=None) -> int:
    """greedy_parse (parse_kernel) against greedy_parse_direct on the same
    inputs, and both against `ref` (greedy_parse_ref's output) where one is
    given: max_abs_err over is_cs, is_lit, dcode_short."""
    from brotli_tpu_torch.ops import device_encode as E

    new = E.greedy_parse(*ins, lazy, gate)
    old = E.greedy_parse_direct(*ins, lazy, gate)
    err = max_abs_err(new, old)
    if ref is not None:
        err = max(err, max_abs_err(new, ref), max_abs_err(old, ref))
    return err


def phase_parse_kernel_vs_plain(enc_data: bytes, card_str: str) -> dict:
    """greedy_parse's kernel (parse_kernel) and its direct form (the first
    design) against greedy_parse_ref on CUDA tensors, bit for bit: both
    knob sets for each match setting at 1024 x 2 KB and on hand-made edge
    lanes (n = 4096, and 3999 for the unaligned rows); at the main encode's
    1024 x 32 KB and the v3 cell's 1024 x 4 KB the two kernels equal at
    every case and the plain version once a shape (default knobs, the
    shape's own matches).  Then both kernels in turns (direct, new, new,
    direct) at 1024 x 32 KB (default and chain_depth 4 matches) and 1024 x
    4 KB, each with its bound."""
    from brotli_tpu_torch.ops import device_encode as E

    data = corpus(1024 * 2048)
    worst = 0
    for mname, mkw in PARSE_MATCH_SETS.items():
        ins = parse_inputs(data, 2048, **mkw)
        for lazy, gate in PARSE_KNOBS:
            ref = E.greedy_parse_ref(*ins, lazy, gate)
            err = parse_forms(ins, lazy, gate, ref)
            check(err == 0, f"parse kernels != plain version ({mname}, lazy "
                  f"{lazy}, gate {gate}): {err}")
            worst = max(worst, err)
            print(f"[parse kernel==plain] 1024 lanes x 2 KB, matches "
                  f"{mname}, lazy {lazy}, min_gate {gate}: max_abs_err {err} "
                  f"over is_cs, is_lit, dcode_short, parse_kernel and "
                  f"parse_direct_kernel ({int(ref[0].sum())} copies; exact "
                  "equality required)")
    for n in (4096, 3999):
        ins = parse_edge_lanes(n)
        for lazy, gate in PARSE_KNOBS:
            err = parse_forms(ins, lazy, gate,
                              E.greedy_parse_ref(*ins, lazy, gate))
            check(err == 0, f"parse kernels != plain version on the edge "
                  f"lanes (n {n}, lazy {lazy}): {err}")
        print(f"[parse kernel==plain] 8 edge lanes x {n} B (a wrapped copy "
              f"end, copies across tiles, n_valid past n and below 0), both "
              f"knob sets: max_abs_err 0, both kernels")
    res = {}
    for tag, chunk, plain_mkw in (("main", ENC_CHUNK, {}), ("v3", 4096,
                                                           V3_MATCH)):
        for mname, mkw in PARSE_MATCH_SETS.items():
            ins = parse_inputs(enc_data[: 1024 * chunk], chunk, **mkw)
            for lazy, gate in PARSE_KNOBS:
                ref = None
                if mkw == plain_mkw and (lazy, gate) == PARSE_KNOBS[0]:
                    out = {}
                    pms = plain_ms(lambda: out.__setitem__(
                        "p", E.greedy_parse_ref(*ins, lazy, gate)))
                    ref = out["p"]
                    res[tag] = {"plain_ms": pms,
                                "copies": int(ref[0].sum()) / 1024}
                err = parse_forms(ins, lazy, gate, ref)
                check(err == 0, f"parse kernels differ at 1024 x {chunk} B "
                      f"({mname}, lazy {lazy}): {err}")
                worst = max(worst, err)
            timed = (tag == "main" and mname in ("default", "chain_depth 4")
                     or tag == "v3" and mkw == V3_MATCH)
            if not timed:
                continue
            turns = in_turns(lambda: E.greedy_parse(*ins),
                             lambda: E.greedy_parse_direct(*ins))
            # bytes: mlen, mdist and n_valid in; is_cs, is_lit (1 B) and
            # dcode (4 B) out
            n = ins[0].numel()
            bound = bound_ms(14 * n + 4 * ins[2].numel())
            key = tag if mname != "chain_depth 4" else "cd4"
            res[key] = {**res.get(key, {}), "turns": turns, "bound": bound}
            print(f"[enc times] {card_str}: parse kernel at 1024 x {chunk} B, "
                  f"matches {mname}: {turns_str(turns)} (time_device_fn: CUDA "
                  f"events, best of 3 windows of 5 each); bound "
                  f"{bound[0]:.6f} ms ({bound[1]}), "
                  f"{100 * bound[0] / turns['new']:.2f}% of it (direct "
                  f"{100 * bound[0] / turns['old']:.2f}%)")
        print(f"[parse kernel==plain] 1024 lanes x {chunk} B: parse_kernel == "
              f"parse_direct_kernel at every match and knob set, both == "
              f"greedy_parse_ref at the default knobs on the "
              f"{plain_mkw or 'default'} matches "
              f"({res[tag]['copies']:.1f} copies a lane; plain "
              f"{res[tag]['plain_ms']:.3f} ms, CUDA events, one run)")
    threads, smem, per_sm, regs, tile = E.parse_config()
    print(f"[enc times] {card_str}: parse_kernel {threads} threads a lane, "
          f"tiles of {tile} positions, {smem} B static shared memory, "
          f"{per_sm} blocks an SM, {regs} registers a thread, a persistent "
          f"grid (direct: a warp a lane)")
    return {"err": worst, "ms": res["main"]["turns"]["new"],
            "direct_ms": res["main"]["turns"]["old"],
            "plain_ms": res["main"]["plain_ms"], "bound": res["main"]["bound"],
            "ms_cd4": res["cd4"]["turns"]["new"],
            "direct_ms_cd4": res["cd4"]["turns"]["old"],
            "ms_4k": res["v3"]["turns"]["new"],
            "direct_ms_4k": res["v3"]["turns"]["old"],
            "plain_ms_4k": res["v3"]["plain_ms"],
            "bound_ms_4k": res["v3"]["bound"][0],
            "config": {"threads": threads, "static_shared_bytes": smem,
                       "blocks_an_sm": per_sm, "registers": regs,
                       "tile": tile}}


# the match settings of the match and record kernels' checks: the
# parse's, the 7-byte hash and the strided hash
MATCH_SETS = {**PARSE_MATCH_SETS,
              "hash2": dict(chain_depth=4, hash2=True),
              "hash_stride 2": dict(hash_stride=2)}
V3_MATCH = dict(max_distance=V3_BENCH["max_distance"],
                chain_depth=V3_BENCH["chain_depth"])


def match_bound(data_t, n_valid) -> tuple[float, str]:
    """The match kernel's bytes: each lane's N + 12 data bytes and n_valid
    in, mlen and mdist out."""
    B, npad = data_t.shape
    return bound_ms(B * npad + 4 * B + 8 * B * (npad - 12))


def records_bound(mlen) -> tuple[float, str]:
    """The record kernel's bytes: the data (N bytes a lane), mlen, mdist,
    dcode_short (4 B), is_cs and is_lit (1 B), n_valid and the code table
    in; rec0 and rec1 (N + 1 rows) and n_records out."""
    B, N = mlen.shape
    return bound_ms(B * N * 15 + 4 * B + 4 * 1072 + 8 * B * (N + 1) + 4 * B)


def match_forms(data_t, n_valid, mkw: dict):
    """match_kernel and match_direct_kernel against find_matches_ref on
    the same inputs; returns (max_abs_err over both, the plain output)."""
    from brotli_tpu_torch.ops import device_encode as E

    ref = E.find_matches_ref(data_t, n_valid, **mkw)
    err = max(max_abs_err(E.find_matches(data_t, n_valid, **mkw), ref),
              max_abs_err(E.find_matches_direct(data_t, n_valid, **mkw), ref))
    return err, ref


def record_forms(ins, lit_ctx: bool) -> int:
    """records_kernel and records_direct_kernel against build_records_ref
    on the same inputs: max_abs_err over both."""
    from brotli_tpu_torch.ops import device_encode as E

    ref = E.build_records_ref(*ins, lit_ctx=lit_ctx)
    return max(max_abs_err(E.build_records(*ins, lit_ctx=lit_ctx), ref),
               max_abs_err(E.build_records_direct(*ins, lit_ctx=lit_ctx), ref))


def phase_match_record_kernels(enc_data: bytes, card_str: str) -> dict:
    """find_matches' and build_records' kernels (match_kernel,
    records_kernel) and their direct forms (the first designs) against the
    plain versions on CUDA tensors, under every match setting of MATCH_SETS
    (records with and without literal contexts, on the parse kernel's
    output), at 1024 x 2 KB, at the main encode's 1024 x 32 KB and at the
    v3 cell's 1024 x 4 KB; at the last two, both forms of each kernel timed
    in turns (direct, new, new, direct) beside the plain version (one run)
    and the bound."""
    from brotli_tpu_torch.ops import device_encode as E

    cuda = torch.device("cuda")
    worst = {"matches": 0, "records": 0}
    res = {}
    for tag, chunk, data in (("2k", 2048, corpus(1024 * 2048)),
                             ("main", ENC_CHUNK, enc_data),
                             ("v3", V3_BENCH["chunk_size"], enc_data)):
        data_t, _, n_valid = E.stage_input(data[: 1024 * chunk], chunk, cuda)
        for mname, mkw in MATCH_SETS.items():
            err, (mlen, mdist) = match_forms(data_t, n_valid, mkw)
            ins = (data_t, mlen, mdist, *E.greedy_parse(mlen, mdist, n_valid),
                   n_valid)
            rerr = [record_forms(ins, lit_ctx) for lit_ctx in (False, True)]
            torch.cuda.synchronize()
            check(err == 0, f"match kernels != plain version ({mname}, "
                  f"1024 x {chunk} B): {err}")
            check(rerr == [0, 0], f"record kernels != plain version "
                  f"({mname}, 1024 x {chunk} B): {rerr}")
            worst["matches"] = max(worst["matches"], err)
            worst["records"] = max(worst["records"], *rerr)
            print(f"[matches kernel==plain] 1024 lanes x {chunk} B, {mname}: "
                  f"max_abs_err {err} over mlen, mdist, match_kernel and "
                  f"match_direct_kernel ({int((mlen > 0).sum())} matches; "
                  "exact equality required)")
            print(f"[records kernel==plain] 1024 lanes x {chunk} B, matches "
                  f"{mname}, lit_ctx False / True: max_abs_err {rerr[0]} / "
                  f"{rerr[1]} over rec0, rec1, n_records, records_kernel and "
                  "records_direct_kernel (exact equality required)")
        if tag == "2k":
            continue
        mkw, lit_ctx = ({}, False) if tag == "main" else (V3_MATCH, True)
        out = {}
        mt = in_turns(lambda: E.find_matches(data_t, n_valid, **mkw),
                      lambda: E.find_matches_direct(data_t, n_valid, **mkw))
        plain = plain_ms(lambda: out.__setitem__(
            "m", E.find_matches_ref(data_t, n_valid, **mkw)))
        mlen, mdist = out["m"]
        ins = (data_t, mlen, mdist, *E.greedy_parse(mlen, mdist, n_valid),
               n_valid)
        rt = in_turns(lambda: E.build_records(*ins, lit_ctx=lit_ctx),
                      lambda: E.build_records_direct(*ins, lit_ctx=lit_ctx))
        rplain = plain_ms(lambda: out.__setitem__(
            "r", E.build_records_ref(*ins, lit_ctx=lit_ctx)))
        bound, rbound = match_bound(data_t, n_valid), records_bound(mlen)
        threads, smem = E.match_config(chunk)
        dthreads, dsmem = E.match_config(chunk, direct=True)
        rthreads, rsmem, rper_sm = E.records_config(chunk)
        knobs = mkw or "default knobs"
        print(f"[enc times] {card_str}: match kernel at 1024 x {chunk} B, "
              f"{knobs}: {turns_str(mt)} (time_device_fn: CUDA events, best "
              f"of 3 windows of 5 each); match_kernel {threads} threads, "
              f"{smem} B dynamic shared memory a block, a block a lane "
              f"(direct {dthreads}, {dsmem} B); plain find_matches_ref "
              f"{plain:.3f} ms (CUDA events, one run); bound "
              f"{bound[0]:.6f} ms ({bound[1]}), {100 * bound[0] / mt['new']:.2f}"
              f"% of it (direct {100 * bound[0] / mt['old']:.2f}%)")
        print(f"[enc times] {card_str}: record kernel at 1024 x {chunk} B, "
              f"lit_ctx {lit_ctx}: {turns_str(rt)} (the same timer); "
              f"records_kernel {rthreads} threads a lane, {rsmem} B dynamic "
              f"shared memory, {rper_sm} blocks an SM, a persistent grid "
              f"(direct: a warp a lane); plain build_records_ref "
              f"{rplain:.3f} ms (one run); bound {rbound[0]:.6f} ms "
              f"({rbound[1]}), {100 * rbound[0] / rt['new']:.2f}% of it "
              f"(direct {100 * rbound[0] / rt['old']:.2f}%)")
        res[tag] = {"ms": mt["new"], "direct_ms": mt["old"], "plain_ms": plain,
                    "bound": bound, "rms": rt["new"], "rdirect_ms": rt["old"],
                    "rplain_ms": rplain, "rbound": rbound}
    return {"match_err": worst["matches"], "record_err": worst["records"],
            **res}


def phase_enc_times(seen: dict, card_str: str) -> dict:
    """The segmented and the serial pack kernel on the main path's
    PackBatch, timed in turns (segmented, serial, serial, segmented), and
    the plain version against the main path's kernel output."""
    from brotli_tpu_torch.ops import device_encode as E

    pb = seen["pb"]
    seg1 = device_ms(lambda: E.pack_records(pb))
    ser1 = device_ms(lambda: E.pack_records_serial(pb))
    ser2 = device_ms(lambda: E.pack_records_serial(pb))
    seg2 = device_ms(lambda: E.pack_records(pb))
    pack_ms, serial_ms = (seg1 + seg2) / 2, (ser1 + ser2) / 2
    err, plain = pack_vs_plain(seen, "the main shape")
    bound = pack_bound(seen)
    print(f"[enc times] {card_str}: segmented pack kernel {pack_ms:.4f} ms "
          f"({seg1:.4f}, {seg2:.4f}), serial pack kernel {serial_ms:.4f} ms "
          f"({ser1:.4f}, {ser2:.4f}), serial / segmented "
          f"{serial_ms / pack_ms:.2f}x, per {ENC_CHUNK * 1024} B batch "
          f"(time_device_fn: CUDA events, best of 3 windows of 5 each, in "
          f"turns segmented, serial, serial, segmented, on the main path's "
          f"records); plain pack {plain:.3f} ms on the same batch (CUDA "
          f"events, one run), max_abs_err {err} (both kernels); bound "
          f"{bound[0]:.6f} ms ({bound[1]})")
    return {"pack_ms": pack_ms, "serial_ms": serial_ms,
            "plain_pack_ms": plain, "err": err, "bound": bound}


def dictmix(n: int) -> bytes:
    """Half static-dictionary text, half sources: streams with several
    trees, context modes and block types at q9/q11."""
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    dic = (ROOT / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()
    return dic[8000: 8000 + n // 2] + src[50000: 50000 + n // 2]


def v3_kernel_vs_plain(tag: str, streams: list[bytes], expect: list,
                       flag: set = frozenset(), custom_dictionary=None,
                       plain_128: bool = False) -> int:
    """decode3 and decode3_direct against decode3_ref on one staged batch,
    bit for bit over the bytes and the 16 status rows; lanes in `flag`
    must flag and the others decode to `expect`.  The batch staged by the
    yardstick (preflight_v3_native, batch_to_torch_v3: groups of 1024) and
    by the native staging (stage_v3_native: groups of 128) gives each
    stream the same bytes and status rows through decode3 (with
    `plain_128`, the narrow batch through decode3_ref too)."""
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import stage3_native as S3
    from brotli_tpu_torch.ops.preflight3_native import preflight_v3_native

    batch = preflight_v3_native(streams, max_groups=8)
    check(batch is not None, f"{tag}: preflight_v3_native refused the batch")
    tb = D3.batch_to_torch_v3(batch, "cuda", custom_dictionary)
    narrow = S3.stage_v3_native(streams, "cuda", max_groups=8,
                                custom_dictionary=custom_dictionary)
    check(narrow is not None, f"{tag}: stage_v3_native refused the batch")
    n0 = D3.KERNEL_LAUNCHES
    ker = D3.decode3(tb)
    ker128 = D3.decode3(narrow.tb)
    direct = D3.decode3_direct(tb)
    ref = D3.decode3_ref(tb)
    torch.cuda.synchronize()
    check(D3.KERNEL_LAUNCHES == n0 + 2, "decode3 did not count its launches")
    err = max_abs_err(ker, ref)
    check(err == 0, f"{tag}: decode3 kernel != plain version ({err})")
    d_err = max_abs_err(direct, ref)
    check(d_err == 0, f"{tag}: direct decode3 kernel != plain version "
          f"({d_err})")
    if plain_128:
        n_err = max_abs_err(ker128, D3.decode3_ref(narrow.tb))
        check(n_err == 0, f"{tag}: decode3 kernel != plain version at width "
              f"128 ({n_err})")
        err = max(err, n_err)
    out = ker[0][:, tb.hrb:].cpu().numpy()
    status = ker[1].cpu().numpy()
    out128 = ker128[0].cpu().numpy()
    status128 = ker128[1].cpu().numpy()
    at128 = {int(i): slot for slot, i in enumerate(narrow.perm) if i >= 0}
    flagged = set()
    for slot in range(tb.n_lanes):
        i = int(batch.perm[slot])
        if i < 0:
            continue
        m, s128 = int(batch.mlens[slot]), at128[i]
        check((status[:, slot] == status128[:, s128]).all()
              and (out[slot, :m] == out128[s128, :m]).all(),
              f"{tag}: stream {i} decodes otherwise at width 128")
        if status[0, slot] != 0 or status[4, slot] > batch.n_words[slot] + 4:
            flagged.add(i)
        else:
            check(out[slot, :m].tobytes() == expect[i],
                  f"{tag}: stream {i} decodes wrong")
    check(flagged == set(flag), f"{tag}: lanes {sorted(flagged)} flagged, "
          f"want {sorted(flag)}")
    print(f"[v3 kernel==plain] {tag}: {len(streams)} streams in "
          f"{batch.groups} groups of 1024 ({narrow.groups} of 128), "
          f"max_abs_err {err} over bytes and 16 status rows (direct kernel "
          f"{d_err}; exact equality required), each stream's bytes and "
          f"status rows equal at both widths"
          f"{' (width 128 held to the plain version too)' if plain_128 else ''}"
          f", flagged lanes {sorted(flagged)}")
    return max(err, d_err)


def v3_pair_times(tag: str, tb, card_str: str, use_dict: bool = True) -> dict:
    """decode3 against decode3_direct on a staged batch: equal bit for bit
    (the direct kernel is held to decode3_ref elsewhere), then both timed
    in turns."""
    from brotli_tpu_torch.ops import decode3 as D3

    err = max_abs_err(D3.decode3(tb, use_dict), D3.decode3_direct(tb, use_dict))
    check(err == 0, f"{tag}: decode3 kernel != direct kernel ({err})")
    t = in_turns(lambda: D3.decode3(tb, use_dict),
                 lambda: D3.decode3_direct(tb, use_dict))
    total = int(tb.scal[1].to(torch.int64).sum().item())
    print(f"[v3 times] {card_str}: {tag}: decode3 kernel {turns_str(t)} per "
          f"{total} B ({total / (t['new'] * 1e-3) / 1e6:.2f} MB/s; "
          f"time_device_fn, use_dict={use_dict}), launch_config (lanes a "
          f"warp, window, table entries) {v3_config(tb)}; equal to the "
          "direct kernel's output bit for bit")
    return t


def v3_config(tb) -> tuple:
    """decode3's launch_config for a staged batch on this card."""
    from brotli_tpu_torch.ops import decode3 as D3

    props = torch.cuda.get_device_properties(tb.device)
    return D3.launch_config(tb, props.multi_processor_count,
                            props.shared_memory_per_multiprocessor)


def phase_v3_kernel_vs_plain(card_str: str) -> int:
    """The v3 batches against the plain version; then the host q9/q11
    encodes, each 256 times, timed against the direct kernel."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops.preflight3_native import preflight_v3_native

    enc, dec = brotli_tpu_torch.host_encode, brotli_tpu_torch.host_decode
    data = corpus(1024 * 1024)
    port = brotli_tpu_torch.encode_device_batch(
        data, device="cuda", chunk_size=1024, lit_ctx_trees=4, table_groups=2)
    chunks = [data[i: i + 1024] for i in range(0, len(data), 1024)]
    worst = v3_kernel_vs_plain("1024 x 1 KB port-encoded, 4 ctx trees, "
                               "2 table groups", port, chunks)
    # block types [2,2,2], [3,1,1], [2,1,2], [2,1,1]; 9, 10, 9 and 11
    # literal trees
    texts = [dictmix(8192), dictmix(6144), dictmix(6144), corpus(6144)]
    host = [enc(texts[0], quality=9), enc(texts[1], quality=11),
            enc(texts[2], quality=9), enc(texts[3], quality=11)]
    worst = max(worst, v3_kernel_vs_plain(
        "host q9/q11 encodes (tree groups, block switching)", host, texts))
    batch = preflight_v3_native(host * 256, max_groups=8)
    check(batch is not None, "preflight_v3_native refused the host q9/q11 "
          "lanes")
    tb = D3.batch_to_torch_v3(batch, "cuda")
    out, status = D3.decode3(tb)
    out = out.cpu().numpy()
    check(not status[0].any().item(), "a host q9/q11 lane flagged")
    for slot in range(tb.n_lanes):
        i = int(batch.perm[slot])
        if i >= 0:
            check(out[slot, : batch.mlens[slot]].tobytes() == texts[i % 4],
                  f"host q9/q11 lane {i} decodes wrong")
    v3_pair_times("host q9/q11 encodes x 256 (1024 lanes)", tb, card_str)
    worst = max(worst, v3_kernel_vs_plain(
        "121 dictionary transforms x 1024", [DICT_121] * 1024,
        [dec(DICT_121)] * 1024))
    for streams, cd in COMPOUND:
        worst = max(worst, v3_kernel_vs_plain(
            "compound dictionary", streams,
            [dec(x, custom_dictionary=cd) for x in streams],
            custom_dictionary=cd))
    s, cd = COMPOUND_OVERFLOW
    worst = max(worst, v3_kernel_vs_plain(
        "compound dictionary overflow", [s], [None], {0},
        custom_dictionary=cd))
    bad = port[:64]
    cut = bad[5][: len(bad[5]) * 3 // 4]   # the body's end is missing
    worst = max(worst, v3_kernel_vs_plain(
        "poisoned + truncated lanes", bad[:5] + [cut] + bad[6:] + [POISONED],
        chunks[:64] + [None], {5, 64}, plain_128=True))
    return worst


def v3_main_streams(card_str: str) -> tuple[bytes, list[bytes], dict]:
    """6 x 1024 x 4 KB, one encode_device_batch call per group; returns
    (bytes, streams, the match, parse and record launches, counted from
    0; no direct parse launch)."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import device_encode as E

    piece = 1024 * V3_BENCH["chunk_size"]
    data = corpus(V3_GROUPS * piece)
    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    E.MATCH_LAUNCHES = E.RECORD_LAUNCHES = E.PARSE_LAUNCHES = 0
    E.PARSE_DIRECT_LAUNCHES = 0
    t0 = time.perf_counter()
    streams = []
    for g in range(V3_GROUPS):
        streams += brotli_tpu_torch.encode_device_batch(
            data[g * piece:(g + 1) * piece], device="cuda", **V3_BENCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"matches": E.MATCH_LAUNCHES, "parse": E.PARSE_LAUNCHES,
                "records": E.RECORD_LAUNCHES}
    fell = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - enc0
    check(fell == 0, f"{fell} v3 main lanes overflowed (host-encoded)")
    check(len(streams) == V3_GROUPS * 1024, f"{len(streams)} streams")
    check(launches == dict.fromkeys(("matches", "parse", "records"),
                                    V3_GROUPS)
          and E.PARSE_DIRECT_LAUNCHES == 0,
          f"[v3 main] encode launches {launches} (direct parse "
          f"{E.PARSE_DIRECT_LAUNCHES}), want {V3_GROUPS} each, no direct")
    print(f"[v3 main] {card_str}: {len(data)} B encoded on the card by "
          f"{V3_GROUPS} encode_device_batch calls ({V3_BENCH}) in {dt:.3f} s (host "
          f"clock), ratio {sum(map(len, streams)) / len(data):.6f}, "
          f"launches {launches} (counted from 0)")
    return data, streams, launches


def tb_diff(a, b) -> list[str]:
    """The fields in which two V3TorchBatches differ (tensors: dtype,
    shape and every value)."""
    diff = []
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            same = (isinstance(y, torch.Tensor) and x.dtype == y.dtype
                    and x.shape == y.shape and bool(torch.equal(x, y)))
        elif isinstance(x, np.ndarray):
            same = (x.dtype == y.dtype and x.shape == y.shape
                    and bool((x == y).all()))
        else:
            same = x == y
        if not same:
            diff.append(f.name)
    return diff


def print_halves(tag: str, rep: dict, card_str: str, what: str = "") -> None:
    """profile_v3_decode's report: each half's parts, first call and best
    of the timed runs (the new half's alone: the old one runs once)."""
    total = rep["bytes"]
    for name, when, label in (
            ("old", "first", "the yardstick's host half, its one call"),
            ("new", "first", "the native staging, pinned unpack, first call"),
            ("new", "best", "the native staging, pinned unpack, best of 5")):
        parts = rep[name][when]
        print(f"[{tag}] {card_str}: {what}{name} ({label}): call "
              f"{parts['call'] * 1e3:.3f} ms ({total / parts['call'] / 1e6:.1f} "
              "MB/s); " + ", ".join(f"{k} {v * 1e3:.3f} ms"
                                    for k, v in parts.items() if k != "call"))
    print(f"[{tag}] {card_str}: {what}old and new outputs equal and equal "
          f"to the input, {total} B, 0 fallback lanes (host clock, each part "
          "through a synchronise)")


def phase_v3_main(data: bytes, streams: list[bytes], card_str: str):
    """decode_batch_v3 on the main shape with the static dictionary staged
    once beforehand (dict_dev), the decode3 launches counted from 0, the
    kernel seen to read the staged dictionary tensor itself (no upload in
    the call), staged once by the native staging (stage3_native: one plan
    and fill, one copy) and never by the yardstick's preflight, unpacked by
    collect_lanes_v3_pinned.  Then the old host half once, its output equal
    to the new one's (utils.profiling.profile_v3_decode, the new one best
    of 5); the native staging at
    width 1024 equal field for field to batch_to_torch_v3 of the
    yardstick's preflight; 100 of the streams (one table set, one group
    of 128 lanes) bit-exact; the yardstick's native preflight (best of 3)
    and the Python one (once) on the same streams, their V3Batches equal
    field for field."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import preflight3_native as N3
    from brotli_tpu_torch.ops import stage3_native as S3
    from brotli_tpu_torch.ops.preflight3 import preflight_v3
    from brotli_tpu_torch.utils.profiling import profile_v3_decode

    dict_dev = brotli_tpu_torch.stage_dictionary("cuda")
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    with (spied(S3, "plan_and_fill", "to_device") as (split, calls),
          spied(D3, "decode3", "collect_lanes_v3_pinned") as (split3, calls3),
          spied(N3, "parse_units", "_assemble") as (_, old_calls)):
        D3.KERNEL_LAUNCHES = 0
        D3.DIRECT_LAUNCHES = 0
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_v3(streams, device="cuda",
                                               max_groups=V3_GROUPS,
                                               dict_dev=dict_dev)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = D3.KERNEL_LAUNCHES
    staged = calls["to_device"][0][1]
    dicts = [tb.dict for tb, _ in calls3["decode3"]]
    n_fill = len(calls["plan_and_fill"])
    n_old = sum(map(len, old_calls.values()))
    del calls, calls3, old_calls
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(b"".join(got) == data, "v3 main output differs from the input")
    check(fell == 0, f"{fell} v3 main lanes fell back to the host decoder")
    check(launches >= 1, "decode3 never launched on the v3 main path")
    check(D3.DIRECT_LAUNCHES == 0, "the v3 main path launched the direct "
          "kernel")
    check(n_fill == 1 and n_old == 0, f"[v3 main] {n_fill} native stagings, "
          f"{n_old} calls of the yardstick's preflight")
    check(staged.tb.n_lanes == V3_GROUPS * 1024 and staged.tb.width == 128,
          "v3 main batch is not 6 x 1024 lanes in groups of 128")
    check(len(dicts) == launches and all(d is dict_dev for d in dicts),
          "decode_batch_v3 did not decode from the staged dictionary")
    parts = {**split, **split3}
    rest = dt - sum(parts.values())
    print(f"[v3 main] {card_str}: {len(data)} B decoded bit-exact through "
          f"decode_batch_v3(device='cuda', dict_dev=stage_dictionary('cuda')), "
          f"0 fallback lanes, decode3 launches {launches}, each on the "
          f"staged dictionary tensor, {staged.groups} groups of 128 lanes, "
          f"{staged.parses} table sections parsed for {len(streams)} "
          f"streams; whole call {dt:.3f} s (host clock, a first call), of "
          f"which plan and fill {parts['plan_and_fill']:.4f} s, to_device "
          f"{parts['to_device']:.4f} s, kernel {parts['decode3']:.4f} s, "
          f"collect_lanes_v3_pinned {parts['collect_lanes_v3_pinned']:.4f} "
          f"s, the rest {rest:.4f} s (each through a synchronise)")
    rep = profile_v3_decode(streams, max_groups=V3_GROUPS, dict_dev=dict_dev)
    check(rep["same"] and rep["fallback_lanes"] == 0
          and b"".join(rep["out"]) == data,
          "[v3 main] the old and the new host halves' outputs differ")
    print_halves("v3 main", rep, card_str)
    wide = S3.stage_v3_native(streams, "cuda", max_groups=V3_GROUPS,
                              width=1024)
    nat = []
    for _ in range(3):
        t0 = time.perf_counter()
        batch = N3.preflight_v3_native(streams, max_groups=V3_GROUPS)
        nat.append(time.perf_counter() - t0)
    diff = tb_diff(D3.batch_to_torch_v3(batch, "cuda"), wide.tb)
    check(not diff, f"[v3 main] the native staging at width 1024 and the "
          f"yardstick's differ in {diff}")
    # one table set in one group of 128 lanes, fewer slots than the fill
    # spreads over its threads: every lane's words must be written
    few = 100
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    with spied(S3, "to_device") as (_, calls):
        got = brotli_tpu_torch.decode_batch_v3(streams[:few], device="cuda",
                                               dict_dev=dict_dev)
    one = calls["to_device"][0][1]
    del calls
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(one.groups == 1 and fell == 0
          and b"".join(got) == data[: few * (len(data) // len(streams))],
          f"[v3 main] {few} streams of one table set in {one.groups} "
          f"group(s): not bit-exact, or {fell} lanes fell back")
    print(f"[v3 main] {card_str}: {few} streams of one table set in one "
          f"group of 128 lanes decoded bit-exact, 0 fallback lanes")
    t0 = time.perf_counter()
    ref = preflight_v3(streams, max_groups=V3_GROUPS)
    py_s = time.perf_counter() - t0
    diff = batch_diff(batch, ref)
    check(not diff, f"[v3 main] the native and the Python preflight differ "
          f"in {diff}")
    print(f"[v3 main] {card_str}, os.cpu_count() {os.cpu_count()}: the "
          f"native staging at width 1024 equals batch_to_torch_v3 of the "
          f"yardstick's preflight field for field; yardstick preflight of "
          f"the {len(streams)} streams: preflight_v3_native "
          f"{min(nat):.4f} s (best of 3: {', '.join(f'{x:.4f}' for x in nat)}; "
          f"{N3.N_THREADS} threads), preflight_v3 (Python) {py_s:.3f} s "
          f"(once), {py_s / min(nat):.1f}x; the two V3Batches equal field "
          f"for field ({batch.groups} groups)")
    return launches, batch, staged


def phase_v3_block_types(card_str: str) -> int:
    """1024 x 4 KB streams encoded on the card with block switching (the
    "block types" knobs of ENC_PLAIN_SETS), each with initial block
    lengths of its own, through decode_batch_v3(device="cuda") at the
    port's cap: the Python preflight's groups (one key a stream, over the
    cap) against the native preflight's, the output bit-exact with no
    fallback lane, and the call's host clock against the host decoder's."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import stage3_native as S3

    knobs = ENC_PLAIN_SETS["block types"]
    data = corpus(1024 * 4096)
    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    streams = brotli_tpu_torch.encode_device_batch(
        data, device="cuda", chunk_size=4096, **knobs)
    torch.cuda.synchronize()
    check(brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] == enc0,
          "[v3 block types] lanes overflowed (host-encoded)")
    want = [data[i: i + 4096] for i in range(0, len(data), 4096)]
    t0 = time.perf_counter()
    old = python_groups(streams)
    old_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = [brotli_tpu_torch.host_decode(x) for x in streams]
    host_s = time.perf_counter() - t0
    check(host == want, "[v3 block types] the host decoder differs")
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    with spied(S3, "plan_and_fill", "to_device") as (split, calls):
        D3.KERNEL_LAUNCHES = 0
        D3.DIRECT_LAUNCHES = 0
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_v3(streams, device="cuda")
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
        launches = D3.KERNEL_LAUNCHES
    check(len(calls["to_device"]) == 1, "[v3 block types] the native "
          "staging refused the batch")
    batch = calls["to_device"][0][1]
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(got == want, "[v3 block types] output differs from the input")
    check(fell == 0, f"[v3 block types] {fell} lanes fell back")
    check(launches == 1 and D3.DIRECT_LAUNCHES == 0,
          f"[v3 block types] decode3 launches {launches}")
    check(batch.groups < old, "[v3 block types] no fewer groups")
    print(f"[v3 block types] {card_str}: {len(streams)} x 4096 B encoded on "
          f"the card ({knobs}): Python preflight's binning {old} groups of "
          f"1024 (over the cap of {D3.GROUP_CAP_V3}; counted in {old_s:.3f} "
          f"s), native {batch.groups} groups of {batch.tb.width} "
          f"({batch.parses} table sections parsed); decoded bit-exact "
          f"through decode_batch_v3(device='cuda') in {dev_s:.3f} s (host "
          f"clock, of which native plan and fill "
          f"{split['plan_and_fill']:.4f} s, to_device "
          f"{split['to_device']:.4f} s), 0 fallback lanes, decode3 launches "
          f"{launches}; host decoder on the same streams {host_s:.3f} s")
    return launches


def same_lanes(a, perm_a, b, perm_b) -> bool:
    """Two decode3 runs of one batch's streams in two layouts: each
    stream's status rows and slot bytes equal."""
    at_b = np.full(int(max(perm_a.max(), perm_b.max())) + 1, -1, np.int64)
    at_b[perm_b[perm_b >= 0]] = np.flatnonzero(perm_b >= 0)
    la = np.flatnonzero(perm_a >= 0)
    lb = torch.from_numpy(at_b[perm_a[la]]).to(a[0].device)
    la = torch.from_numpy(la).to(a[0].device)
    w = min(a[0].shape[1], b[0].shape[1])
    return (torch.equal(a[1][:, la], b[1][:, lb])
            and torch.equal(a[0][la, :w], b[0][lb, :w]))


def phase_v3_times(batch, staged, card_str: str) -> dict:
    """decode3 on the v3 cell at both widths: the main path's groups of
    128 lanes (staged by stage_v3_native) and the yardstick's of 1024
    (batch_to_torch_v3), in turns with each other and with the direct
    kernel; the plain version once, equal to every run."""
    from brotli_tpu_torch.ops import decode3 as D3

    tb = D3.batch_to_torch_v3(batch, "cuda")
    tb128 = staged.tb
    total = int(batch.mlens.sum())
    state = {}
    t = in_turns(lambda: state.__setitem__("nd", D3.decode3(tb128, False)),
                 lambda: state.__setitem__("w", D3.decode3(tb, False)))
    ms_nd, ms_1024 = t["new"], t["old"]
    td = in_turns(lambda: state.__setitem__("nd", D3.decode3(tb128, False)),
                  lambda: state.__setitem__("o", D3.decode3_direct(tb, False)))
    ms_d = device_ms(lambda: state.__setitem__("d", D3.decode3(tb128, True)))
    fill = device_ms(lambda: D3._alloc_outputs(tb128))
    plain = plain_ms(lambda: state.__setitem__("p", D3.decode3_ref(tb, False)))
    err = max(max_abs_err(state["w"], state["p"]),
              max_abs_err(state["o"], state["p"]))
    check(err == 0, f"decode3 != plain version on the v3 main batch: {err}")
    check(same_lanes(state["nd"], staged.perm, state["p"], batch.perm)
          and same_lanes(state["d"], staged.perm, state["p"], batch.perm),
          "decode3 at width 128 != the plain version on the v3 main batch")
    # bound: the words each lane consumed, the tables and scalars in, the
    # decoded bytes and the 16 status rows out
    words = int(state["nd"][1][4].to(torch.int64).sum().item())
    tables = sum(t.numel() for t in (tb128.lit, tb128.cmd, tb128.dist,
                                     tb128.bsw, tb128.cmap, tb128.dx,
                                     tb128.consts, tb128.lut, tb128.tfm,
                                     tb128.scal))
    bound = bound_ms(4 * (words + tables) + total + 4 * 16 * tb128.n_lanes)
    print(f"[v3 times] {card_str}: v3 cell: decode3 kernel at width 128 "
          f"(the main path's) against width 1024 {turns_str(t)}, against "
          f"the direct kernel (width 1024) {turns_str(td)}, at "
          f"use_dict=False; launch_config {v3_config(tb128)} (width 1024: "
          f"{v3_config(tb)})")
    print(f"[v3 times] {card_str}: decode3 kernel {ms_nd:.4f} ms at "
          f"use_dict=False, {ms_d:.4f} ms at use_dict=True, per {total} B "
          f"batch ({total / (ms_nd * 1e-3) / 1e6:.2f} MB/s at use_dict=False; "
          f"time_device_fn: CUDA events, best of 3 windows of 5, of which "
          f"output allocation and fill {fill:.4f} ms timed alone); bound "
          f"{bound[0]:.6f} ms ({words} words consumed; {bound[1]})")
    print(f"[v3 times] {card_str}: plain decode3_ref {plain:.3f} ms on the "
          f"same batch (CUDA events, one run), max_abs_err {err}; every "
          "stream's bytes and status rows equal at both widths")
    return {"ms": ms_nd, "ms_1024": ms_1024, "ms_dict": ms_d,
            "direct_ms": td["old"], "plain_ms": plain, "err": err,
            "bound": bound, "tb": tb}


def phase_v3_full(card_str: str) -> int:
    """decode_batch_v3_full on 1024 lanes of multi-metablock streams; the
    old host half once, its output equal to the new one's; each round's
    batch through both kernels."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import stage3_native as S3
    from brotli_tpu_torch.utils.profiling import profile_v3_decode

    text = corpus(65536)
    enc = brotli_tpu_torch.Encoder(quality=5, lgwin=18)
    enc.params.lgblock = 14   # 16 KB metablocks
    streaming = b"".join(enc.update(text[i: i + 1024])
                         for i in range(0, len(text), 1024)) + enc.finish()
    spliced = brotli_tpu_torch.parallel_encode(text, shard_size=16384,
                                               quality=5, num_workers=1)
    unc = brotli_tpu_torch.host_encode(text, quality=0)
    for s in (streaming, spliced, unc):
        check(brotli_tpu_torch.host_decode(s) == text, "a v3 full stream "
              "does not host-decode")
    lanes = [streaming] * 342 + [spliced] * 341 + [unc] * 341
    t0 = time.perf_counter()
    host = [brotli_tpu_torch.host_decode(x) for x in lanes]
    host_s = time.perf_counter() - t0
    check(all(h == text for h in host), "v3 full: the host decoder differs")
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    with (spied(D3, "run_staged_v3", "_to_host") as (s, calls),
          spied(S3, "walk_ptrs", "plan_and_fill", "to_device") as (s3, _),
          round_units(lanes) as py_groups):
        D3.KERNEL_LAUNCHES = 0
        D3.DIRECT_LAUNCHES = 0
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_v3_full(lanes, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = D3.KERNEL_LAUNCHES
    rounds = [batch for batch, _ in calls["run_staged_v3"]]
    del calls
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(all(g == text for g in got), "v3 full output differs from the input")
    check(fell == 0, f"{fell} v3 full lanes fell back to the host decoder")
    check(launches == len(rounds) == len(py_groups) >= 2,
          f"{launches} decode3 launches for {len(rounds)} rounds")
    check(D3.DIRECT_LAUNCHES == 0, "decode_batch_v3_full launched the "
          "direct kernel")
    groups = [b.groups for b in rounds]
    check(all(b.tb.n_lanes <= 1024 * o for b, o in zip(rounds, py_groups)),
          "v3 full: more lanes than the Python preflight's binning")
    print(f"[v3 full] {card_str}: 1024 lanes x 64 KB (streaming 16 KB "
          f"metablocks, spliced 16 KB fragments, uncompressed) decoded "
          f"bit-exact through decode_batch_v3_full(device='cuda') in "
          f"{dt:.3f} s (host clock, a first call), of which native header "
          f"walk {s3['walk_ptrs']:.3f} s, native plan and fill "
          f"{s3['plan_and_fill']:.3f} s, to_device {s3['to_device']:.3f} s "
          f"and run_staged_v3 (kernel) {s['run_staged_v3']:.3f} s, status "
          f"copies {s['_to_host']:.3f} s; host decoder on the same "
          f"lanes {host_s:.3f} s; 0 fallback lanes, {len(rounds)} rounds, "
          f"{launches} launches; groups of 128 a round {groups} (the Python "
          f"preflight's binning, groups of 1024: {py_groups})")
    rep = profile_v3_decode(lanes, full=True)
    check(rep["same"] and rep["fallback_lanes"] == 0
          and all(g == text for g in rep["out"]),
          "[v3 full] the old and the new host halves' outputs differ")
    print_halves("v3 full", rep, card_str)
    new = old = 0.0
    for k, batch in enumerate(rounds):
        tb = batch.tb
        t = v3_pair_times(f"v3 full round {k + 1} (history prefix {tb.hrb} "
                          f"B, {tb.groups} groups of {tb.width})", tb,
                          card_str)
        new, old = new + t["new"], old + t["old"]
    print(f"[v3 times] {card_str}: v3 full, {len(rounds)} rounds: decode3 "
          f"kernel {new:.4f} ms, direct kernel {old:.4f} ms "
          f"({old / new:.2f}x)")
    return launches


CAP_SWEEP = (12, 16, 24, 32)


def phase_caps(data: bytes, streams: list[bytes], v3_tb, v3_rows,
               card_str: str) -> None:
    """The group-cap sweep at CAP_SWEEP groups: v2, the main-path streams
    G times through preflight_shared, both v2 kernels; v3, the staged
    6-group cell tiled to G groups (lane l decodes the cell's lane l mod
    6144), decode3.  Only the kernels are timed; the bytes on the card
    must equal the input, with no flagged lane; peak device memory from
    the staging on."""
    import dataclasses

    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import resolve as R

    rows = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(
        -1, CHUNK).cuda()
    for G in CAP_SWEEP:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        batch = D.preflight_shared(streams * G, groups=G, rate_sort=True)
        check(batch is not None, f"preflight_shared refused {G} groups")
        tb = D.batch_to_torch(batch, "cuda")
        st = {}

        def ent():
            st["e"] = D.entropy_decode(tb)

        def res():
            tok, count, _, _ = st["e"]
            st["r"] = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)

        e_ms = device_ms(ent)
        res()
        _, _, phase, widx = st["e"]
        resolved, err = st["r"]
        want = rows[torch.from_numpy(batch.perm % len(streams)).cuda()]
        over = D.lane_overran(batch, widx.cpu().numpy())
        check(torch.equal(resolved, want), f"v2 at {G} groups: bytes differ")
        check(bool((phase == D.DONE).all()) and not bool(err.any())
              and not over.any(), f"v2 at {G} groups: flagged lanes")
        # the main path's peak: read before the direct kernel's turns
        peak2 = torch.cuda.max_memory_allocated() / 2**30
        r_t = in_turns(res, lambda: st.__setitem__(
            "rd", R.resolve_tokens_direct(*st["e"][:2], tb.mlen, tb.max_mlen)))
        r_ms = r_t["new"]
        check(torch.equal(st["r"][0], want)
              and max_abs_err(st["rd"], st["r"]) == 0,
              f"v2 at {G} groups: the resolve kernels' bytes or flags differ")
        total = int(batch.mlens.sum())
        mbps2 = total / ((e_ms + r_ms) * 1e-3) / 1e6
        del tb, st, resolved, err, want, batch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n = G * 1024
        lane = torch.arange(n, device="cuda") % v3_tb.n_lanes
        grp = torch.arange(G) % v3_tb.groups
        reps = -(-G // v3_tb.groups)
        tbG = dataclasses.replace(
            v3_tb, wt=v3_tb.wt[:, lane].contiguous(),
            scal=v3_tb.scal[:, lane].contiguous(),
            cfg=v3_tb.cfg[grp.cuda()].contiguous(),
            cfg_host=v3_tb.cfg_host[grp.numpy()], groups=G,
            # the per-group block-switch and distance tables by group count
            # (the config rows keep pointing at the cell's own groups')
            bsw=v3_tb.bsw.repeat(reps)[: G * D3.BSW_N].contiguous(),
            dx=v3_tb.dx.repeat(reps)[: G * D3.DX_N].contiguous())
        st = {}
        d_ms = device_ms(lambda: st.__setitem__("o", D3.decode3(tbG, False)))
        o, status = st["o"]
        check(torch.equal(o[:, tbG.hrb: tbG.hrb + 4096], v3_rows[lane]),
              f"v3 at {G} groups: bytes differ")
        check(not bool(status[0].any()), f"v3 at {G} groups: flagged lanes")
        peak3 = torch.cuda.max_memory_allocated() / 2**30
        mbps3 = n * 4096 / (d_ms * 1e-3) / 1e6
        print(f"[caps] {card_str}: {G} groups: v2 {total} B, entropy "
              f"{e_ms:.4f} ms ({D.lanes_per_warp(n, D.sm_count(o.device))} "
              f"lanes a warp) + resolve {turns_str(r_t)} = {mbps2:.2f} "
              f"MB/s, peak device memory "
              f"{peak2:.3f} GiB; v3 {n * 4096} B, decode3 {d_ms:.4f} ms = "
              f"{mbps3:.2f} MB/s (launch_config {v3_config(tbG)}), peak "
              f"{peak3:.3f} GiB; bytes equal the input on the card, 0 "
              "flagged lanes (time_device_fn, kernels only)")
        del tbG, st, o, status


SPARSE = 32   # streams of a sparse batch, each with tables of its own


def sparse_run(name: str, streams: list[bytes], want: list[bytes], decode,
               mod, runner: str, kernel_ms, card_str: str,
               full: bool | None = None) -> None:
    """One sparse batch through `decode` (a driver at the port's cap) on
    the card: the host clock of the call, peak device memory, the rounds'
    groups (on the v3 paths, `full` False or True, beside the Python
    preflight's binning of each round's units) and the kernels' time on
    each staged round (`kernel_ms`); against the host decoder on the same
    streams, which is what the driver did at the reference's cap.  Output
    equal to the input, no fallback lane.  On the v3 paths, then the old
    host half once, its output equal to the new one's (profile_v3_decode,
    the new one best of 5)."""
    import brotli_tpu_torch
    from brotli_tpu_torch.utils.profiling import profile_v3_decode

    t0 = time.perf_counter()
    host = [brotli_tpu_torch.host_decode(x) for x in streams]
    host_s = time.perf_counter() - t0
    check(host == want, f"{name}: the host decoder differs from the input")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    with spied(mod, runner) as (_, calls), round_units(streams) as py_rounds:
        t0 = time.perf_counter()
        got = decode(streams)
        torch.cuda.synchronize()
        dev_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    batches = [b for b, _ in calls[runner]]
    del calls
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(got == want, f"{name}: output differs from the input")
    check(fell == 0, f"{name}: {fell} lanes fell back to the host decoder")
    groups = [b.groups for b in batches]
    if full is None:
        old = [SPARSE] * len(batches)
    else:
        old = py_rounds if full else [python_groups(streams)]
    check(groups == old == [SPARSE] * len(batches), f"{name}: rounds of "
          f"{groups} groups, the Python binning's {old}, not {SPARSE}")
    ms = [kernel_ms(b) for b in batches]
    lanes = [b.tb.n_lanes for b in batches]
    print(f"[caps sparse] {card_str}: {name}: {len(streams)} streams, "
          f"{sum(map(len, want))} B, {len(batches)} round(s) of {groups} "
          f"groups, {lanes} lanes (the Python preflight's binning: {old} "
          f"groups of 1024): {dev_s:.3f} s through the driver at the port's "
          f"cap (host clock, a first call), kernels {sum(ms):.4f} ms "
          f"({', '.join(f'{m:.4f}' for m in ms)}; time_device_fn), peak "
          f"device memory {peak:.3f} GiB, 0 fallback lanes; host decoder on "
          f"the same streams {host_s:.3f} s")
    if full is not None:
        rep = profile_v3_decode(streams, full=full)
        check(rep["same"] and rep["fallback_lanes"] == 0
              and rep["out"] == want,
              f"{name}: the old and the new host halves' outputs differ")
        print_halves("caps sparse", rep, card_str, f"{name}: ")


def phase_caps_sparse(data: bytes, card_str: str) -> None:
    """Batches the caps let onto the card that the reference's caps sent
    to the host: SPARSE streams whose tables all differ.  v2, one 8 KB
    encode_sharded stream of its own text each (preflight_binned's bins);
    v3, 32 KB streams encoded on the card with block switching, a table
    group a stream (table_groups=SPARSE: each lane's trees its own); v3
    full, 64 KB streams of four 16 KB metablocks by a streaming host
    Encoder, one text each (history prefixes up to 48 KB).  Each makes a
    group a stream under the native binning and under the Python
    preflight's."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import resolve as R

    def v2_ms(staged):
        tb = staged.tb

        def both():
            tok, count, _, _ = D.entropy_decode(tb)
            R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
        ms = device_ms(both)
        args = (*D.entropy_decode(tb)[:2], tb.mlen, tb.max_mlen)
        st = {}
        t = in_turns(lambda: st.__setitem__("n", R.resolve_tokens(*args)),
                     lambda: st.__setitem__("o", R.resolve_tokens_direct(*args)))
        err = max_abs_err(st["n"], st["o"])
        check(err == 0, f"sparse v2: resolve kernel != direct kernel ({err})")
        print(f"[caps sparse] {card_str}: v2 round of {staged.groups} groups: "
              f"resolve kernel {turns_str(t)}, equal to the direct kernel's "
              "output bit for bit")
        return ms

    def v3_ms(staged):
        return device_ms(lambda: D3.decode3(staged.tb))

    want = [data[i * CHUNK: (i + 1) * CHUNK] for i in range(SPARSE)]
    v2 = [brotli_tpu_torch.encode_sharded(w, chunk_size=CHUNK,
                                          max_distance=MAX_DISTANCE)[0]
          for w in want]
    sparse_run("v2, 8 KB streams", v2, want,
               lambda s: brotli_tpu_torch.decode_batch_device_e2e(
                   s, device="cuda"), D, "run_batch_e2e", v2_ms, card_str)
    text = corpus(SPARSE * ENC_CHUNK)
    v3 = brotli_tpu_torch.encode_device_batch(
        text, device="cuda", chunk_size=ENC_CHUNK, table_groups=SPARSE,
        lit_ctx_trees=4, block_types=3, block_seg=512)
    want = [text[i: i + ENC_CHUNK] for i in range(0, len(text), ENC_CHUNK)]
    sparse_run("v3, 32 KB streams", v3, want,
               lambda s: brotli_tpu_torch.decode_batch_v3(s, device="cuda"),
               D3, "run_staged_v3", v3_ms, card_str, full=False)
    text = corpus(SPARSE * 65536 + 65536)[65536:]
    want, full = [], []
    for i in range(SPARSE):
        want.append(text[i * 65536: (i + 1) * 65536])
        enc = brotli_tpu_torch.Encoder(quality=5, lgwin=18)
        enc.params.lgblock = 14   # 16 KB metablocks
        full.append(enc.update(want[-1]) + enc.finish())
    sparse_run("v3 full, 64 KB streams", full, want,
               lambda s: brotli_tpu_torch.decode_batch_v3_full(
                   s, device="cuda"), D3, "run_staged_v3", v3_ms, card_str,
               full=True)


DD_LANES = 1024   # [device decode]: independently compressed streams
DD_PIECE = 8192   # bytes a stream


def dd_streams(card_str: str, shape: str = "main"):
    """dd_phases.SHAPES[shape]'s batch: corpus pieces, piece i compressed
    alone (its own tables) by host_encode on 8 spawned processes (none
    touches the card): the pieces, their streams and qualities."""
    from brotli_tpu_torch.tools import dd_phases

    lanes, size, _ = dd_phases.SHAPES[shape]
    pieces, streams, qual, enc_s = dd_phases.pieces_and_streams(shape)
    print(f"[device decode] {card_str}: {lanes} x {size} B pieces encoded "
          f"alone by host_encode at quality {min(qual)}-{max(qual)}: "
          f"{enc_s:.3f} s (host clock, 8 spawned processes); "
          f"{sum(map(len, streams))} B of streams")
    return pieces, streams, qual


def dd_bound(db, pre) -> tuple[float, str]:
    """Bytes the per-lane-table decode must move, each once: the words;
    of each lane's table row only what its code can address (the 256 root
    entries and the second-level entries of each Huffman table, which are
    never 0 where padding is, and 16 + ndirect + (48 << npostfix)
    distance extras and offsets); the scalars it reads; the LUT's 64
    entries; out, pos and err written."""
    from brotli_tpu_torch.ops import device_decode as DD

    tabs = db.tabs.cpu().numpy()
    n_tab = 0
    for at, size in ((DD.LIT_AT, DD.LIT_TABLE_SIZE),
                     (DD.CMD_AT, DD.CMD_TABLE_SIZE),
                     (DD.DIST_AT, DD.DIST_TABLE_SIZE)):
        n_tab += 256 * db.n_lanes + int(np.count_nonzero(
            tabs[:, at + 256: at + size]))
    n_tab += sum(2 * (16 + p.ndirect + (48 << p.npostfix)) for p in pre)
    n_in = 4 * (db.body.numel() + n_tab + 6 * db.n_lanes + 64)
    return bound_ms(n_in + db.n_lanes * (db.out_size + 4 + 1))


def dd_phase_lines(tag: str, db, card_str: str) -> dict:
    """tools/dd_phases.py's split of both kernels on the staged batch
    (an instrumented build of its own; each output == the main build's)."""
    from brotli_tpu_torch.tools import dd_phases

    split = dd_phases.phase_split(db)
    for form, sp in split.items():
        print(f"[device decode] {card_str}: dd_phases {tag} {form}: "
              + json.dumps(sp))
    return split


def phase_device_decode(card_str: str) -> dict:
    """The per-lane-table decode on 1024 independently compressed 8 KB
    streams: decode_batch_device (the main path, launches counted from
    0), both kernels == device_decode_ref on the same CUDA tensors and
    timed in turns against the bound, the phase split of each, the host
    half split, decode_batch_v3 on the same batch, sharded_decode_batch
    over 4 logical slots; then 64 x 64 KB rows (8x the shared kernel's
    window), both kernels equal and timed in turns, no plain run."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import device_decode as DD

    pieces, streams, qual = dd_streams(card_str)
    q4 = np.array(qual) == 4
    # the main path: the user's entry point, launches counted from 0
    zero_launches()
    out, fell, _ = fallback_deltas(lambda: brotli_tpu_torch.decode_batch_device(
        streams, device="cuda"))
    torch.cuda.synchronize()
    launches, direct_launches = DD.KERNEL_LAUNCHES, DD.DIRECT_LAUNCHES
    check(launches == 1 and direct_launches == 0,
          f"decode_batch_device: {launches} kernel launches, "
          f"{direct_launches} of the direct kernel")
    check(out == pieces, "decode_batch_device: output differs from the input")

    pre = DD.preflight_native(streams)
    check(all(p is not None for p in pre), "preflight refused a stream")
    db = DD.stage_batch(pre, "cuda")
    got = DD.device_decode(db)
    direct = DD.device_decode_direct(db)
    # the plain version once (its steps replay as CUDA graphs; the capture
    # is inside the interval)
    ref = []
    plain = plain_ms(lambda: ref.append(DD.device_decode_ref(db)))
    ref = ref[0]
    err = max_abs_err(got, ref)
    direct_err = max_abs_err(direct, ref)
    check(err == 0 and direct_err == 0,
          f"device_decode kernels != device_decode_ref ({err}, {direct_err})")
    flagged = got[2].cpu().numpy()
    pos = got[1].cpu().numpy()
    mlens = np.array([p.mlen for p in pre])
    # round 1 leaves static-dictionary references to the host: the
    # quality-4 streams have them, the others none
    check(fell == int(flagged.sum()) and (flagged == q4).all()
          and (pos[~flagged] == mlens[~flagged]).all(),
          f"decode_batch_device: {fell} fallback lanes, {int(flagged.sum())} "
          f"flagged ({int(flagged[~q4].sum())} below quality 4, "
          f"{int((~flagged[q4]).sum())} quality-4 lanes not)")
    print(f"[device decode] {card_str}: decode_batch_device == the pieces, "
          f"{launches} launch of device_decode_kernel and {direct_launches} "
          f"of device_decode_direct_kernel (counted from 0); {fell} fallback "
          f"lanes, exactly the lanes the kernel flags: the {int(q4.sum())} "
          "quality-4 lanes (static-dictionary references, left to the host "
          f"as in the JAX kernel), 0 of the {int((~q4).sum())} others; both "
          "kernels == device_decode_ref on the same CUDA tensors (out, pos, "
          "err)")
    lower = [s for s, q in zip(streams, qual) if q < 4]
    got_low, fell_low, _ = fallback_deltas(
        lambda: brotli_tpu_torch.decode_batch_device(lower, device="cuda"))
    check(got_low == [p for p, q in zip(pieces, qual) if q < 4]
          and fell_low == 0, f"quality 1-3 lanes: {fell_low} fallback lanes")
    print(f"[device decode] {card_str}: the {len(lower)} quality 1-3 streams "
          "through decode_batch_device: equal to their pieces, 0 fallback "
          "lanes")

    split = dd_phase_lines("1024x8KB", db, card_str)
    turns = in_turns(lambda: DD.device_decode(db),
                     lambda: DD.device_decode_direct(db))
    ms, direct_ms = turns["new"], turns["old"]
    bound = dd_bound(db, pre)
    # the host half, each part through a synchronise (best of 3)
    parts = {"preflight": lambda: DD.preflight_native(streams),
             "staging": lambda: DD.stage_batch(pre, "cuda"),
             "kernel": lambda: DD.device_decode(db),
             "unpack": lambda: DD.collect_results(
                 [None] * len(streams), streams, list(range(len(streams))),
                 *DD.fetch_outputs(*got))}
    split_ms = {k: min(wall_s(f) for _ in range(3)) * 1e3
                for k, f in parts.items()}
    whole = min(wall_s(lambda: brotli_tpu_torch.decode_batch_device(
        streams, device="cuda")) for _ in range(3)) * 1e3
    cfg = DD.launch_config()
    print(f"[device decode] {card_str}: device_decode_kernel "
          f"{turns_str(turns)} (time_device_fn) at {DD_LANES} x {DD_PIECE} B, "
          f"bound {bound[0]:.6f} ms ({bound[1]}), {bound[0] / ms:.4%} of it "
          f"(direct {bound[0] / direct_ms:.4%}); launch {cfg}; plain "
          f"version {plain:.1f} ms (CUDA events, once); host half (best of 3, "
          "host clock through a synchronise): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in split_ms.items())
          + f"; whole decode_batch_device {whole:.3f} ms")

    t0 = time.perf_counter()
    v3, v3_fell, _ = fallback_deltas(lambda: brotli_tpu_torch.decode_batch_v3(
        streams, device="cuda"))
    v3_s = time.perf_counter() - t0
    check(v3 == pieces, "decode_batch_v3: output differs from the input")
    print(f"[device decode] {card_str}: decode_batch_v3 on the same batch: "
          f"{v3_s:.3f} s (host clock), {v3_fell} of {DD_LANES} lanes "
          "host-decoded")

    mesh = brotli_tpu_torch.get_mesh(SLOTS, "cuda", logical=True)
    DD.KERNEL_LAUNCHES = DD.DIRECT_LAUNCHES = 0
    t0 = time.perf_counter()
    sharded, sh_fell, _ = fallback_deltas(
        lambda: brotli_tpu_torch.sharded_decode_batch(streams, mesh))
    sh_s = time.perf_counter() - t0
    sh_launches = DD.KERNEL_LAUNCHES
    check(sharded == pieces and sh_launches == SLOTS and sh_fell == fell
          and DD.DIRECT_LAUNCHES == 0,
          f"sharded_decode_batch: {sh_launches} launches, {sh_fell} "
          "fallback lanes, or output differs")
    print(f"[device decode] {card_str}: sharded_decode_batch over {SLOTS} "
          f"logical slots == the pieces, {sh_launches} launches (counted from "
          f"0), {sh_fell} fallback lanes, {sh_s:.3f} s (host clock)")

    # rows longer than the window: the flushes, the ring's refills and
    # copies read back from the row; no plain run (minutes at 64 KB)
    lpieces, lstreams, _ = dd_streams(card_str, "long")
    lpre = DD.preflight_native(lstreams)
    check(all(p is not None for p in lpre), "preflight refused a 64 KB stream")
    ldb = DD.stage_batch(lpre, "cuda")
    lgot, ldirect = DD.device_decode(ldb), DD.device_decode_direct(ldb)
    long_err = max_abs_err(lgot, ldirect)
    lout, lpos, lflag = DD.fetch_outputs(*lgot)
    check(long_err == 0 and not lflag.any()
          and all(bytes(lout[k, : lpos[k]]) == p
                  for k, p in enumerate(lpieces)),
          f"64 KB rows: kernel != direct kernel ({long_err}) or != the pieces")
    long_split = dd_phase_lines("64x64KB", ldb, card_str)
    lturns = in_turns(lambda: DD.device_decode(ldb),
                      lambda: DD.device_decode_direct(ldb))
    lbound = dd_bound(ldb, lpre)
    print(f"[device decode] {card_str}: {len(lpieces)} x 64 KB rows: "
          "device_decode_kernel == device_decode_direct_kernel, every lane "
          f"== its piece; {turns_str(lturns)} (time_device_fn), bound "
          f"{lbound[0]:.6f} ms ({lbound[1]})")
    return {"launches": launches, "err": err, "direct_err": direct_err,
            "ms": ms, "direct_ms": direct_ms, "turns": turns["turns"],
            "plain_ms": plain, "bound": bound, "host_ms": split_ms,
            "whole_ms": whole, "sharded_launches": sh_launches,
            "fallback_lanes": fell, "long_err": long_err,
            "ms_64k": lturns["new"], "direct_ms_64k": lturns["old"],
            "bound_ms_64k": lbound[0], "config": cfg,
            "cycles": {f"{tag} {form}": sp["slowest"]["cycles"]
                       for tag, sv in (("1024x8KB", split),
                                       ("64x64KB", long_split))
                       for form, sp in sv.items()}}


# ---------------------------------------------------------------------------
# the scale-out layer: N device slots, each a CUDA stream on this card
# ---------------------------------------------------------------------------

SLOTS = 4


def launches_now() -> dict:
    """The main-path kernels' launch counters."""
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import device_decode as DD
    from brotli_tpu_torch.ops import device_encode as E
    from brotli_tpu_torch.ops import device_zopfli as Z
    from brotli_tpu_torch.ops import resolve as R

    return {"entropy": D.KERNEL_LAUNCHES, "resolve": R.KERNEL_LAUNCHES,
            "matches": E.MATCH_LAUNCHES, "parse": E.PARSE_LAUNCHES,
            "records": E.RECORD_LAUNCHES, "pack": E.KERNEL_LAUNCHES,
            "decode3": D3.KERNEL_LAUNCHES, "zopfli": Z.KERNEL_LAUNCHES,
            "device_decode": DD.KERNEL_LAUNCHES}


def zero_launches() -> None:
    """Every launch counter of the kernels to 0, the direct forms' too."""
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import device_decode as DD
    from brotli_tpu_torch.ops import device_encode as E
    from brotli_tpu_torch.ops import device_zopfli as Z
    from brotli_tpu_torch.ops import resolve as R

    for mod, names in ((D, ("KERNEL_LAUNCHES", "DIRECT_LAUNCHES")),
                       (R, ("KERNEL_LAUNCHES", "DIRECT_LAUNCHES")),
                       (D3, ("KERNEL_LAUNCHES", "DIRECT_LAUNCHES")),
                       (E, ("KERNEL_LAUNCHES", "PARSE_LAUNCHES",
                            "SERIAL_PACK_LAUNCHES", "MATCH_LAUNCHES",
                            "RECORD_LAUNCHES", "MATCH_DIRECT_LAUNCHES",
                            "RECORD_DIRECT_LAUNCHES",
                            "PARSE_DIRECT_LAUNCHES")),
                       (Z, ("KERNEL_LAUNCHES", "DIRECT_LAUNCHES")),
                       (DD, ("KERNEL_LAUNCHES", "DIRECT_LAUNCHES"))):
        for name in names:
            setattr(mod, name, 0)


def no_direct_launches(what: str) -> None:
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import decode3 as D3
    from brotli_tpu_torch.ops import device_decode as DD
    from brotli_tpu_torch.ops import device_encode as E
    from brotli_tpu_torch.ops import device_zopfli as Z
    from brotli_tpu_torch.ops import resolve as R

    check(D.DIRECT_LAUNCHES == R.DIRECT_LAUNCHES == D3.DIRECT_LAUNCHES
          == E.SERIAL_PACK_LAUNCHES == Z.DIRECT_LAUNCHES
          == DD.DIRECT_LAUNCHES
          == E.MATCH_DIRECT_LAUNCHES == E.RECORD_DIRECT_LAUNCHES
          == E.PARSE_DIRECT_LAUNCHES == 0,
          f"{what} launched a direct or serial kernel")


def wall_s(fn) -> float:
    """Host clock of fn() through a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def fallback_deltas(fn):
    """(fn(), decode fallback lanes, encode fallback lanes) over fn()."""
    import brotli_tpu_torch

    d0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    e0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    out = fn()
    return (out, brotli_tpu_torch.fallback_stats()["lanes_fallback"] - d0,
            brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - e0)


def wrapper_intervals(fn) -> list[tuple[str, int, float, float]]:
    """Run fn() with CUDA events recorded on the current stream around
    every entropy_decode and resolve_tokens call; returns ("kernel",
    stream id, start us, end us) per call, from one base event, in
    utils/profiling.device_intervals' form."""
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    marks = []

    def timed(f):
        def run(*a, **k):
            stream = torch.cuda.current_stream()
            ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ends[0].record(stream)
            out = f(*a, **k)
            ends[1].record(stream)
            marks.append((stream.stream_id, *ends))
            return out
        return run

    entropy, resolve = D.entropy_decode, R.resolve_tokens
    base = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    base.record()
    D.entropy_decode, R.resolve_tokens = timed(entropy), timed(resolve)
    try:
        fn()
    finally:
        D.entropy_decode, R.resolve_tokens = entropy, resolve
    torch.cuda.synchronize()
    return [("kernel", sid, base.elapsed_time(e0) * 1e3,
             base.elapsed_time(e1) * 1e3) for sid, e0, e1 in marks]


def phase_multi_v2(data: bytes, streams: list[bytes], card_str: str) -> dict:
    """The v2 cell (4 x 1024 x 8 KB) through decode_batches_multichip over
    SLOTS logical slots, one 1024-stream group a slot: bytes, fallback,
    launches; then its wall against the same groups through one slot
    (best of 3 each, in turns), one profiled 4-slot call (the device's
    busy share and the time kernels of two streams ran at once, from the
    trace), and one with CUDA events around the kernels' wrappers (the
    same overlap, where the trace holds no kernel events)."""
    from brotli_tpu_torch.parallel.mesh import decode_batches_multichip, get_mesh
    from brotli_tpu_torch.utils.profiling import (device_intervals,
                                                  stream_overlap, trace)

    batch = streams * GROUPS
    mesh = get_mesh(SLOTS, "cuda", logical=True)
    one = get_mesh(1, "cuda", logical=True)
    check(len({s.stream.cuda_stream for s in mesh}) == SLOTS,
          "the logical slots do not have streams of their own")
    zero_launches()
    t0 = time.perf_counter()
    got, fell, _ = fallback_deltas(lambda: decode_batches_multichip(batch, mesh))
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    launches = launches_now()
    no_direct_launches("[multi v2]")
    check(b"".join(got) == data * GROUPS, "[multi v2] output differs")
    check(fell == 0, f"[multi v2] {fell} fallback lanes")
    check(launches["entropy"] == GROUPS and launches["resolve"] == GROUPS,
          f"[multi v2] launches {launches}, want {GROUPS} of each")
    walls = {"4": [], "1": []}
    for _ in range(3):
        walls["4"].append(wall_s(lambda: decode_batches_multichip(batch, mesh)))
        walls["1"].append(wall_s(lambda: decode_batches_multichip(batch, one)))
    out_dir = ROOT / "brotli_tpu_torch" / "build" / "trace" / "multi_v2"
    with trace(out_dir):
        t0 = time.perf_counter()
        decode_batches_multichip(batch, mesh)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ov = stream_overlap(device_intervals(out_dir / "trace.json"))
    # the profiler's busy share only where its trace holds the kernels
    busy = ov["busy_s"] / window if ov["streams"] else None
    t0 = time.perf_counter()
    ev = stream_overlap(wrapper_intervals(
        lambda: decode_batches_multichip(batch, mesh)))
    ev_window = time.perf_counter() - t0
    w4, w1 = min(walls["4"]), min(walls["1"])
    print(f"[multi v2] {card_str}: {len(batch)} streams, {len(data) * GROUPS} B "
          f"over {SLOTS} slots (CUDA streams of cuda:0), bit-exact, 0 "
          f"fallback lanes, launches {launches}; first call {first:.3f} s; "
          f"best of 3 (host clock): {SLOTS} slots {w4:.4f} s "
          f"({', '.join(f'{x:.4f}' for x in walls['4'])}), 1 slot {w1:.4f} s "
          f"({', '.join(f'{x:.4f}' for x in walls['1'])}), {w1 / w4:.3f}x")
    trace_ov = (f"{ov['overlap_s'] * 1e3:.4f} ms" if ov["streams"] else
                "not measured (the trace holds no kernel events)")
    print(f"[multi v2] {card_str}: profiled {SLOTS}-slot call {window:.4f} s "
          f"(host clock): device busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'} (union of "
          f"kernels, copies, fills in the torch.profiler trace), kernels of "
          f"two or more streams at once {trace_ov}, kernel streams "
          f"{ov['streams']}; trace in {out_dir.relative_to(ROOT)}")
    print(f"[multi v2] {card_str}: {SLOTS}-slot call {ev_window:.4f} s (host "
          f"clock) with CUDA events around each entropy and resolve call on "
          f"its slot's stream (each interval also holds its outputs' "
          f"allocation): those intervals cover {ev['busy_s'] * 1e3:.4f} ms "
          f"({ev['busy_s'] / ev_window:.4f} of the call), two or more "
          f"streams at once {ev['overlap_s'] * 1e3:.4f} ms, over "
          f"{len(ev['streams'])} streams")
    return {k: launches[k] for k in ("entropy", "resolve")}


def phase_multi_enc(card_str: str) -> dict:
    """SLOTS x 1024 x 32 KB (128 MiB) of corpus through
    encode_batches_multichip over SLOTS logical slots at the default knobs:
    each piece's streams byte-identical to encode_device_batch of that
    piece, decoded back through decode_batches_multichip with 0 fallback
    lanes; host-clock walls of each."""
    import brotli_tpu_torch
    from brotli_tpu_torch.parallel.mesh import (decode_batches_multichip,
                                                encode_batches_multichip,
                                                get_mesh)

    piece = 1024 * ENC_CHUNK
    data = corpus(SLOTS * piece)
    mesh = get_mesh(SLOTS, "cuda", logical=True)
    zero_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, _, efell = fallback_deltas(
        lambda: encode_batches_multichip(data, mesh, chunk_size=ENC_CHUNK))
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    enc_l = launches_now()
    t0 = time.perf_counter()
    back, dfell, _ = fallback_deltas(
        lambda: decode_batches_multichip(got, mesh))
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = launches_now()
    no_direct_launches("[multi enc]")
    check(efell == 0, f"[multi enc] {efell} lanes host-encoded")
    check(all(enc_l[k] == SLOTS
              for k in ("matches", "parse", "records", "pack")),
          f"[multi enc] encode launches {enc_l}, want {SLOTS} of matches, "
          "parse, records and pack")
    check(b"".join(back) == data, "[multi enc] round trip differs")
    check(dfell == 0, f"[multi enc] {dfell} decode fallback lanes")
    check(launches["entropy"] == SLOTS and launches["resolve"] == SLOTS,
          f"[multi enc] decode launches {launches}")
    t0 = time.perf_counter()
    for k in range(SLOTS):
        single = brotli_tpu_torch.encode_device_batch(
            data[k * piece:(k + 1) * piece], device="cuda",
            chunk_size=ENC_CHUNK)
        check(single == got[k * 1024:(k + 1) * 1024],
              f"[multi enc] piece {k} differs from encode_device_batch")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    print(f"[multi enc] {card_str}: {len(data)} B over {SLOTS} slots, "
          f"{len(got)} streams, ratio {sum(map(len, got)) / len(data):.6f}; "
          f"encode_batches_multichip {enc_s:.3f} s (host clock, first "
          f"call), each piece byte-identical to encode_device_batch of it "
          f"({SLOTS} such calls in turn {one_s:.3f} s); decoded back "
          f"bit-exact by decode_batches_multichip in {dec_s:.3f} s; 0 ovf "
          f"lanes, 0 fallback lanes; launches {launches}")
    return {k: launches[k] for k in ("matches", "parse", "records", "pack",
                                     "entropy", "resolve")}


def phase_multi_v3(data: bytes, streams: list[bytes], card_str: str) -> dict:
    """The v3 cell's first 2,048 streams through decode_batch_v3_multichip
    over SLOTS logical slots, groups of 512, the dictionary staged once."""
    from brotli_tpu_torch.parallel.mesh import (broadcast_dictionary_chunks,
                                                decode_batch_v3_multichip,
                                                get_mesh)

    mesh = get_mesh(SLOTS, "cuda", logical=True)
    bcast = broadcast_dictionary_chunks(mesh)
    check(len(bcast) == 1, f"the dictionary was staged {len(bcast)} times "
          "for one card")
    zero_launches()
    t0 = time.perf_counter()
    got, fell, _ = fallback_deltas(lambda: decode_batch_v3_multichip(
        streams, mesh, group_size=512, dict_bcast=bcast))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launches_now()
    no_direct_launches("[multi v3]")
    check(b"".join(got) == data, "[multi v3] output differs from the input")
    check(fell == 0, f"[multi v3] {fell} fallback lanes")
    check(launches["decode3"] == len(streams) // 512,
          f"[multi v3] decode3 launches {launches['decode3']}")
    print(f"[multi v3] {card_str}: {len(streams)} streams, {len(data)} B "
          f"through decode_batch_v3_multichip over {SLOTS} slots, groups of "
          f"512, one staged dictionary: bit-exact, 0 fallback lanes, decode3 "
          f"launches {launches['decode3']}; {dt:.3f} s (host clock; the "
          "groups run in turn, each behind its host preflight)")
    return {"decode3": launches["decode3"]}


def phase_multihost(card_str: str) -> None:
    """tools/multihost_sim.py on the card: 2 processes x 2 logical slots on
    cuda:0 over gloo, 4 x 1024 x 8 KB encoded on the card and decoded
    back; every process's lists equal the input and the single-process
    port's encode.  A timeout or a non-zero exit fails the run."""
    from brotli_tpu_torch.parallel.mesh import (encode_batches_multichip,
                                                get_mesh)
    from brotli_tpu_torch.tools.multihost_sim import list_digest

    torch.cuda.empty_cache()   # the workers share this card
    cmd = [sys.executable, "-m", "brotli_tpu_torch.tools.multihost_sim",
           "--device", "cuda", "--streams", str(GROUPS * 1024),
           "--chunk", str(CHUNK), "--timeout", "240"]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    dt = time.perf_counter() - t0
    lines = r.stdout.strip().splitlines()
    check(r.returncode == 0, f"[multihost] rc {r.returncode}: {lines[-1:]} "
          f"{r.stderr[-2000:]}")
    rows = [json.loads(x) for x in lines if x.startswith("{")]
    workers, summary = rows[:-1], rows[-1]
    data = corpus(GROUPS * 1024 * CHUNK)
    single = encode_batches_multichip(data, get_mesh(1, "cuda"),
                                      chunk_size=CHUNK)
    want = list_digest([data[i:i + CHUNK] for i in range(0, len(data), CHUNK)])
    check(summary["multihost_sim"] == "ok" and len(workers) == 2,
          f"[multihost] {summary}")
    for w in workers:
        check(w["streams_sha256"] == list_digest(single),
              f"[multihost] process {w['process']}'s streams differ from "
              "the single-process encode")
        check(w["decoded_sha256"] == want,
              f"[multihost] process {w['process']}'s output differs")
    print(f"[multihost] {card_str}: 2 processes x 2 slots on cuda:0 (gloo): "
          f"{len(data)} B encoded on the card and decoded back, every "
          f"process's lists equal the input and the single-process encode; "
          f"workers {', '.join('%.3f' % w['wall_s'] for w in workers)} s "
          f"of work each, whole simulation {dt:.3f} s (host clock, process "
          "start-up included)")


def phase_dryrun(card_str: str) -> None:
    from brotli_tpu_torch.entry import dryrun_multichip

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    walls = dryrun_multichip(SLOTS, timeout_s=240)
    print(f"[dryrun] {card_str}: dryrun_multichip({SLOTS}) on the card in "
          f"{time.perf_counter() - t0:.3f} s (host clock): "
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items()))


# integer operations of one row for one tile element, counted from the
# TPU scripts' row bodies (tools/probe_v2.py:20-48, tools/probe_v2b.py:
# 22-27).  probe_v2: level 1 xor, add, add, and (4); each of the 4 peeks
# and, shift, sub, shift, compare, select, or, and, add (9); the consume
# shift, compare, 3 selects, and, two funnels of 5, a shift (12); the
# store (1); the gather and, load, add (3).  probe_v2b: xor, add, shift,
# add, one add a further carry, the store.
V2_ROW_OPS = {1: 4, 2: 40, 3: 52, 4: 53, 5: 56}
V2B_ROW_OPS = {4: 7, 18: 21}


def phase_probes(card_str: str) -> dict:
    """Both probes at every level and variant through run_probe_*, the
    launches counted from 0; then each kernel's outputs against its plain
    version, bit for bit."""
    from brotli_tpu_torch.tools import probe as P

    # the inputs run_probe_* take
    a, wt = (torch.from_numpy(x).cuda() for x in P.probe_inputs())
    P.PROBE_V2_LAUNCHES = 0
    P.PROBE_V2B_LAUNCHES = 0
    v2 = {label: P.run_probe_v2(level) for label, level in P.V2_LEVELS}
    v2b = {label: P.run_probe_v2b(variant)
           for label, variant in P.V2B_VARIANTS}
    torch.cuda.synchronize()
    launches = {"probe_v2": P.PROBE_V2_LAUNCHES,
                "probe_v2b": P.PROBE_V2B_LAUNCHES}
    check(min(launches.values()) >= 1, f"a probe never launched: {launches}")
    res = {"launches": launches}
    for label, level in P.V2_LEVELS:
        (outs, ns), ref = v2[label], {}
        ms = plain_ms(lambda: ref.__setitem__("p", P.probe_v2_ref(a, level)))
        err = max_abs_err(outs, ref["p"])
        check(err == 0, f"probe_v2 {label}: kernel != plain version ({err})")
        print(f"[probe] {card_str}: probe_v2  {label:44s} {ns:9.3f} ns/row "
              f"(CUDA events, best of 3 windows of 20 launches, {P.V2_ROWS} "
              f"rows); plain {ms:.3f} ms; max_abs_err {err} over b0, b1, b2, "
              "q and staging")
        if level == 5:
            n = P.V2_ROWS * P.TILE[0] * P.TILE[1]
            res["probe_v2"] = dict(
                ms=ns * P.V2_ROWS / 1e6, plain_ms=ms, err=err,
                bound=bound_ms(4 * (1024 + 4 * 1024 + outs[1].numel()),
                               n * V2_ROW_OPS[level]))
    for label, variant in P.V2B_VARIANTS:
        (outs, ns), ref = v2b[label], {}
        ms = plain_ms(lambda: ref.__setitem__(
            "p", P.probe_v2b_ref(a, wt, **variant)))
        err = max_abs_err(outs, ref["p"])
        check(err == 0, f"probe_v2b {label}: kernel != plain version ({err})")
        print(f"[probe] {card_str}: probe_v2b {label:44s} {ns:9.3f} ns/row "
              f"(CUDA events, best of 3 windows of 20 launches, "
              f"{P.V2B_ROWS} rows); plain {ms:.3f} ms; max_abs_err {err} over "
              f"the output rows and the blocks and fill per tile row "
              f"{outs[1][:, 0].tolist()} {outs[1][:, 1].tolist()}")
        if variant.get("dma_out"):
            # the refills' rows (16 KB a tile row each) and the tile in,
            # the output and stat out
            refills = int(((outs[1][:, 1] - P.WIN) // P.REFILL).sum().item())
            n = P.V2B_ROWS * P.TILE[0] * P.TILE[1]
            res["probe_v2b"] = dict(
                ms=ns * P.V2B_ROWS / 1e6, plain_ms=ms, err=err,
                bound=bound_ms(4 * (1024 + refills * P.REFILL * 128
                                    + outs[0].numel() + outs[1].numel()),
                               n * V2B_ROW_OPS[variant["ncarry"]]))
    return res


def phase_profile(data: bytes, streams: list[bytes], card_str: str) -> None:
    """profile_e2e_decode on the main-path batch (4 x 1024 x 8 KB): the
    reference's numpy host half against the native one, in turns."""
    from brotli_tpu_torch.utils.profiling import phase_report, profile_e2e_decode

    rep = profile_e2e_decode(streams * GROUPS, "cuda", groups=GROUPS)
    check(rep["fallback_lanes"] == 0,
          f"{rep['fallback_lanes']} lanes fell back to the host decoder")
    check(rep["same"], "the old and the new host halves' outputs differ")
    check(b"".join(rep["out"]) == data * GROUPS,
          "the round trip's output differs from the input")
    total = rep["bytes"]
    for name, what in (("old", "numpy preflight, batch_to_torch, "
                                "collect_lanes"),
                       ("new", "stage_v2_native (one pinned copy), "
                                "collect_lanes_pinned")):
        r = rep[name]
        for when in ("first", "best"):
            label = ("first call" if when == "first"
                     else "best of 5, in turns with the other half")
            print(f"[profile] {card_str}: {name} host half ({what}), {label}:")
            for line in phase_report(r[when], total).splitlines():
                print(f"[profile] {card_str}:   {name} {line}")
        busy = r["busy"]
        top = sorted(r["device_s_by_name"].items(), key=lambda kv: -kv[1])[:4]
        top_s = "; ".join(f"{k.split('(')[0]} {v * 1e3:.4f} ms" for k, v in top)
        best = {p.name: p.seconds for p in r["best"]}
        print(f"[profile] {card_str}: {name}: device busy share "
              f"{'not measured' if busy is None else f'{busy:.4f}'} of a "
              f"profiled round trip ({r['window_s'] * 1e3:.3f} ms host "
              f"clock, preflight included; torch.profiler device time over "
              f"it); kernels {total / (best['entropy kernel'] + best['resolve kernel']) / 1e6:.2f} "
              f"MB/s, best round trip {total / best['round trip'] / 1e6:.2f} "
              f"MB/s; top device time: {top_s}")
    print(f"[profile] {card_str}: old and new outputs equal, "
          f"{total} B, 0 fallback lanes")


# ---------------------------------------------------------------------------
# the quality-10 Zopfli DP
# ---------------------------------------------------------------------------

FP64_OPS = 34e12            # float64 outside the tensor cores, FLOP/s
ZOPFLI_MAIN = 65536         # the driver's shape: one stream, B = 1
ZOPFLI_LANES, ZOPFLI_LANE = 32, 8192
ZOPFLI_PLAIN = (2, 2048)    # lanes x bytes of the kernel == plain check


def host_q10(data: bytes) -> tuple[list, int, float]:
    """The port's host create_zopfli_backward_references on `data`: its
    commands as tuples, its last insert, and its host-clock seconds."""
    from brotli_tpu_torch.encode.api import _NO_MASK, _padded
    from brotli_tpu_torch.encode.backward_refs_hq import (
        create_zopfli_backward_references)
    from brotli_tpu_torch.encode.hash_binary_tree import BinaryTreeHasher

    t0 = time.perf_counter()
    n = len(data)
    cmds, _, last = create_zopfli_backward_references(
        n, 0, _padded(data), _NO_MASK, BinaryTreeHasher(22, n),
        [4, 11, 15, 16], 0)
    return cmd_tuples(cmds), last, time.perf_counter() - t0


def cmd_tuples(cmds) -> list:
    return [(c.insert_len, c.copy_len, c.dist_extra, c.cmd_prefix,
             c.dist_prefix) for c in cmds]


def zopfli_bound(zb, nodes) -> tuple[float, str]:
    """Bytes: every input and output tensor once.  Operations: two float64
    adds and a compare for each length this run's DP tried (`tried`), at
    the card's float64 rate outside the tensor cores."""
    ins = (zb.data, zb.lit_cost, zb.cost_cmd, zb.cost_dist, zb.min_cost_cmd,
           zb.start_cache, zb.n_valid, zb.moff, zb.mlen, zb.mdist,
           zb.mdelta, zb.active)
    n_bytes = sum(t.numel() * t.element_size() for t in (*ins, *nodes))
    t_bytes = n_bytes / HBM_BPS * 1e3
    t_ops = 3 * int(nodes.tried.sum()) / FP64_OPS * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def nodes_err(a, b) -> float:
    """Largest difference over two ZopfliNodes (cost as float64)."""
    err = float((a.cost - b.cost).abs().max().item())
    return max(err, float(max_abs_err(a[1:], b[1:])))


def zopfli_config(zb) -> str:
    """The window kernel's launch shape for `zb` on this card."""
    from brotli_tpu_torch.ops import device_zopfli as Z

    blocks, window = Z.card_config(zb)
    return (f"{blocks} block(s) of 32 threads, window {window} slots, "
            f"{Z.TABLE_BYTES + Z.SLOT_BYTES * window} B dynamic shared "
            "memory a block")


def zopfli_pair(zb, what: str, card_str: str) -> dict:
    """The window kernel (zopfli_dp) == the direct kernel
    (zopfli_dp_direct) on `zb`, every output bit for bit, then both timed
    in turns (direct, window, window, direct)."""
    from brotli_tpu_torch.ops import device_zopfli as Z

    new, old = Z.zopfli_dp(zb), Z.zopfli_dp_direct(zb)
    err = nodes_err(new, old)
    check(err == 0 and all(torch.equal(a, b) for a, b in zip(new, old)),
          f"zopfli window kernel != direct kernel at {what} ({err})")
    t = in_turns(lambda: Z._launch(zb), lambda: Z._launch_direct(zb))
    bound = zopfli_bound(zb, new)
    print(f"[zopfli times] {card_str}: {what}: window kernel "
          f"{turns_str(t)}, == direct bit for bit; "
          f"{int(new.tried.sum())} lengths tried; bound {bound[0]:.6f} ms "
          f"({bound[1]}), {100 * bound[0] / t['new']:.5f}% of it (direct "
          f"{100 * bound[0] / t['old']:.5f}%); {zopfli_config(zb)}")
    return {"nodes": new, "ms": t["new"], "direct_ms": t["old"],
            "bound": bound}


def phase_zopfli(card_str: str) -> dict:
    """The window DP kernel == the direct kernel == zopfli_dp_ref on
    CUDA tensors (2 lanes x 2 KB); zopfli_commands_device(device="cuda")
    on 64 KB, on the 51,900-B runs input and on bytes(20000) == the host
    q10 parse, one window-kernel launch each, counted from 0, and no
    direct launch; the two kernels equal and timed in turns at 1 x 64 KB
    (where the plain version runs too), 32 x 8 KB (each lane's backtrack
    == the host's) and the runs input; the host parse's times on the same
    inputs."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import device_zopfli as Z
    from brotli_tpu_torch.utils.benchmarks import runs_input

    big = corpus(ZOPFLI_MAIN + ZOPFLI_LANES * ZOPFLI_LANE)
    main, rest = big[:ZOPFLI_MAIN], big[ZOPFLI_MAIN:]
    lanes = [rest[i * ZOPFLI_LANE: (i + 1) * ZOPFLI_LANE]
             for i in range(ZOPFLI_LANES)]
    n_small, w_small = ZOPFLI_PLAIN
    small = Z.stage_zopfli([lane[:w_small] for lane in lanes[:n_small]],
                           device="cuda")
    ker, old = Z.zopfli_dp(small), Z.zopfli_dp_direct(small)
    out = {}
    plain_small = plain_ms(lambda: out.__setitem__("p",
                                                   Z.zopfli_dp_ref(small)))
    err = max(nodes_err(ker, out["p"]), nodes_err(old, out["p"]))
    check(err == 0 and all(torch.equal(a, b) and torch.equal(c, b)
                           for a, c, b in zip(ker, old, out["p"])),
          f"zopfli kernels != plain version ({err})")
    small_ms = device_ms(lambda: Z._launch(small))
    print(f"[zopfli kernel==plain] {n_small} lanes x {w_small} B: "
          f"max_abs_err {err} over cost, nlen, ndist, ndci, nsc, result and "
          f"tried, window and direct kernel (exact equality required); "
          f"{card_str}: window kernel {small_ms:.4f} ms, plain zopfli_dp_ref "
          f"{plain_small:.3f} ms (CUDA events, one run); "
          f"{zopfli_config(small)}")

    runs = runs_input()
    commands = {}
    for name, data in (("64 KB", main), ("runs", runs),
                       ("bytes(20000)", bytes(20000))):
        want, want_last, host_s = host_q10(data)
        Z.KERNEL_LAUNCHES = Z.DIRECT_LAUNCHES = 0
        t0 = time.perf_counter()
        cmds, last = brotli_tpu_torch.zopfli_commands_device(data,
                                                             device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (Z.KERNEL_LAUNCHES, Z.DIRECT_LAUNCHES)
        check(launches == (1, 0), f"zopfli_commands_device({name}) launched "
              f"{launches} window / direct kernels, not (1, 0)")
        check((cmd_tuples(cmds), last) == (want, want_last),
              f"zopfli_commands_device({name}) != the host q10 parse")
        commands[name] = (launches[0], wall, host_s, len(want), last)
    launches = commands["64 KB"][0]
    host_runs = [commands["64 KB"][2]] + [host_q10(main)[2] for _ in range(2)]
    t0 = time.perf_counter()
    zb = Z.stage_zopfli([main], device="cuda")
    stage_s = time.perf_counter() - t0
    m = zopfli_pair(zb, f"1 x {len(main)} B", card_str)
    plain = plain_ms(lambda: out.__setitem__("m", Z.zopfli_dp_ref(zb)))
    err_main = nodes_err(m["nodes"], out["m"])
    check(err_main == 0 and all(torch.equal(a, b)
                                for a, b in zip(m["nodes"], out["m"])),
          f"zopfli kernel != plain version at 1 x 64 KB ({err_main})")
    for name, (n_launch, wall, host_s, n_cmds, last) in commands.items():
        print(f"[zopfli main] {card_str}: zopfli_commands_device({name}, "
              f"device='cuda') == host q10 ({n_cmds} commands, last insert "
              f"{last}), {n_launch} window-kernel launch (counted from 0), 0 "
              f"direct, wall {wall:.3f} s (host clock: staging with match "
              f"collection, DP, backtrack); host q10 parse {host_s:.3f} s")
    print(f"[zopfli main] {card_str}: 64 KB staging with match collection "
          f"{stage_s:.3f} s; host q10 parse {min(host_runs):.3f} s best of 3 "
          f"({', '.join(f'{t:.3f}' for t in host_runs)} s); plain "
          f"zopfli_dp_ref {plain:.3f} ms on the 1 x 64 KB batch (CUDA "
          f"events, one run), max_abs_err {err_main} against the kernels")

    zb32 = Z.stage_zopfli(lanes, device="cuda")
    m32 = zopfli_pair(zb32, f"{ZOPFLI_LANES} x {ZOPFLI_LANE} B", card_str)
    host32 = []
    for b, lane in enumerate(lanes):
        want_b, last_b, secs = host_q10(lane)
        host32.append(secs)
        got, got_last = Z.backtrack(m32["nodes"], b, len(lane))
        check((cmd_tuples(got), got_last) == (want_b, last_b),
              f"zopfli lane {b} of {ZOPFLI_LANES} x {ZOPFLI_LANE} B != host")
    print(f"[zopfli main] {card_str}: every lane's backtrack of "
          f"{ZOPFLI_LANES} x {ZOPFLI_LANE} B == host q10; host q10 parse "
          f"{sum(host32):.3f} s for the lanes one after another "
          f"({min(host32):.3f}-{max(host32):.3f} s a lane)")
    mr = zopfli_pair(Z.stage_zopfli([runs], device="cuda"),
                     f"the runs input, 1 x {len(runs)} B", card_str)
    return {"launches": launches, "err": max(err, err_main), "ms": m["ms"],
            "direct_ms": m["direct_ms"], "plain_ms": plain,
            "plain_small_ms": plain_small, "bound": m["bound"],
            "small_ms": small_ms, "ms32": m32["ms"],
            "direct_ms32": m32["direct_ms"], "bound32": m32["bound"],
            "ms_runs": mr["ms"], "direct_ms_runs": mr["direct_ms"],
            "host_s": min(host_runs), "host32_s": sum(host32)}


def phase_entry() -> None:
    """The port's entry(): the entropy kernel on a staged 32-stream batch."""
    from brotli_tpu_torch.entry import entry
    from brotli_tpu_torch.ops import decode2 as D

    fn, args = entry()
    tok, count, phase, _ = fn(*args)
    torch.cuda.synchronize()
    check(bool((phase[:32] == D.DONE).all()) and bool((count[:32] > 0).all()),
          "entry(): a lane of the example batch did not decode")
    print(f"[entry] entry() -> {fn.__name__} on {args[0].n_lanes} lanes "
          f"({int((count > 0).sum())} streams), every stream DONE")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    import brotli_tpu_torch  # noqa: F401  (fails outside a checkout)

    check_no_reference_imports()
    t_run = time.perf_counter()
    card_str = card()
    print(f"[card] {card_str}")

    def walled(tag, fn, *args):
        """fn(*args), then its host-clock wall as a [wall] line."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[wall] [{tag}] {time.perf_counter() - t0:.3f} s ({card_str})")
        return out

    walled("build", phase_build, card_str)
    errs = walled("kernel==plain", phase_kernel_vs_plain)
    probes = walled("probe", phase_probes, card_str)
    data, streams = walled("main encode", main_path_streams)
    launches = walled("main", phase_main_path, data, streams)
    far = walled("far", phase_far, card_str)
    times = walled("times", phase_times, streams, card_str)
    walled("synthetic", phase_resolve_synthetic, card_str)
    walled("profile", phase_profile, data, streams, card_str)
    enc_err = walled("enc kernel==plain", phase_enc_kernel_vs_plain)
    walled("enc card==cpu", phase_enc_card_vs_cpu)
    enc_data = corpus(1024 * ENC_CHUNK)
    enc_launches, enc_seen = walled("enc main", phase_enc_main, enc_data,
                                    card_str)
    parse = walled("parse kernel==plain", phase_parse_kernel_vs_plain,
                   enc_data, card_str)
    mr = walled("matches/records kernel==plain", phase_match_record_kernels,
                enc_data, card_str)
    enc_times = walled("enc times", phase_enc_times, enc_seen, card_str)
    del enc_seen
    walled("enc halves", phase_enc_halves, card_str)
    bench_err, bench_launches = walled("enc bench-config", phase_enc_bench,
                                       enc_data, card_str)
    del enc_data
    v3_err = walled("v3 kernel==plain", phase_v3_kernel_vs_plain, card_str)
    v3_data, v3_streams, v3_enc_launches = walled("v3 encode",
                                                  v3_main_streams, card_str)
    v3_launches, v3_batch, v3_staged = walled("v3 main", phase_v3_main,
                                              v3_data, v3_streams, card_str)
    # each lane's expected bytes, in the staged batch's lane order
    v3_rows = torch.frombuffer(bytearray(v3_data), dtype=torch.uint8).view(
        -1, V3_BENCH["chunk_size"])[torch.from_numpy(v3_batch.perm)].cuda()
    # the first 2,048 streams and their bytes for [multi v3]
    v3_multi = (v3_data[:2048 * V3_BENCH["chunk_size"]], v3_streams[:2048])
    del v3_data, v3_streams
    v3_times = walled("v3 times", phase_v3_times, v3_batch, v3_staged,
                      card_str)
    del v3_batch, v3_staged
    bt_launches = walled("v3 block types", phase_v3_block_types, card_str)
    walled("v3 full", phase_v3_full, card_str)
    walled("caps", phase_caps, data, streams, v3_times.pop("tb"), v3_rows,
           card_str)
    del v3_rows
    walled("caps sparse", phase_caps_sparse, data, card_str)
    dd = walled("device decode", phase_device_decode, card_str)
    # the scale-out layer: each phase counts its launches from 0
    multi = {
        "multi v2": walled("multi v2", phase_multi_v2, data, streams,
                           card_str),
        "multi enc": walled("multi enc", phase_multi_enc, card_str),
        "multi v3": walled("multi v3", phase_multi_v3, *v3_multi, card_str)}
    del v3_multi
    walled("multihost", phase_multihost, card_str)
    walled("dryrun", phase_dryrun, card_str)
    walled("entry", phase_entry)
    zopfli = walled("zopfli", phase_zopfli, card_str)
    check_no_reference_imports()

    def row(name, source, replaces, n, err, ms, plain, bound):
        key = {"entropy_decode": "entropy", "resolve_tokens": "resolve",
               "greedy_parse": "parse", "pack_records": "pack",
               "decode3": "decode3", "zopfli_dp": "zopfli",
               "find_matches": "matches",
               "build_records": "records",
               "device_decode": "device_decode"}.get(name)
        return {"name": name, "route": "cuda",
                "source": f"brotli_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None,
                # launches on the scale-out phases, each counted from 0
                "multi_launches": {tag: c[key] for tag, c in multi.items()
                                   if key in c}}

    pv2, pv2b = probes["probe_v2"], probes["probe_v2b"]
    kernels = [
        {**row("entropy_decode", "decode2.cu",
               "brotli_tpu/ops/pallas_decode2.py:158", launches["entropy"],
               max(errs["entropy"], times["errs"]["entropy"]),
               times["entropy_ms"], times["plain_entropy_ms"],
               times["entropy_bound"]),
         "direct_ms": times["direct_entropy_ms"]},
        {**row("resolve_tokens", "resolve.cu",
               "brotli_tpu/ops/pallas_resolve.py:127", launches["resolve"],
               max(errs["resolve"], times["errs"]["resolve"], far["err"]),
               times["resolve_ms"], times["plain_resolve_ms"],
               times["resolve_bound"]),
         "direct_ms": times["direct_resolve_ms"]},
        # ms, plain_ms and bound at the main encode's 1024 x 32 KB; direct_ms:
        # the first design in turns with it; chain depth 4's matches and the
        # v3 cell's 1024 x 4 KB beside them; launches on [enc bench-config]
        # and [v3 main] (6 encodes), each counted from 0
        {**row("greedy_parse", "parse.cu",
               "brotli_tpu/ops/device_encode.py:325", enc_launches["parse"],
               parse["err"], parse["ms"], parse["plain_ms"], parse["bound"]),
         **{k: parse[k] for k in ("direct_ms", "ms_cd4", "direct_ms_cd4",
                                  "ms_4k", "direct_ms_4k", "plain_ms_4k",
                                  "bound_ms_4k", "config")},
         "bench_launches": bench_launches["parse"],
         "v3_launches": v3_enc_launches["parse"]},
        {**row("pack_records", "pack.cu",
               "brotli_tpu/ops/device_encode.py:689", enc_launches["pack"],
               max(enc_err, enc_times["err"], bench_err),
               enc_times["pack_ms"], enc_times["plain_pack_ms"],
               enc_times["bound"]),
         "serial_ms": enc_times["serial_ms"]},
        {**row("decode3", "decode3.cu",
               "brotli_tpu/ops/pallas_decode3.py:532", v3_launches,
               max(v3_err, v3_times["err"]), v3_times["ms"],
               v3_times["plain_ms"], v3_times["bound"]),
         "direct_ms": v3_times["direct_ms"],
         # ms: the main path's groups of 128 lanes; ms_1024: the
         # yardstick's groups of 1024, in turns with it
         "ms_1024": v3_times["ms_1024"],
         # launches on [v3 block types], counted from 0
         "block_types_launches": bt_launches},
        # ms, plain_ms and bound at the main encode's 1024 x 32 KB; the
        # v3 cell's 1024 x 4 KB beside them; direct_ms: the first design in
        # turns with the new one; launches on [enc bench-config] and [v3
        # main] (6 encodes), each counted from 0
        {**row("find_matches", "matches.cu",
               "brotli_tpu/ops/device_encode.py:157", enc_launches["matches"],
               mr["match_err"], mr["main"]["ms"], mr["main"]["plain_ms"],
               mr["main"]["bound"]),
         "direct_ms": mr["main"]["direct_ms"],
         "ms_4k": mr["v3"]["ms"], "direct_ms_4k": mr["v3"]["direct_ms"],
         "plain_ms_4k": mr["v3"]["plain_ms"],
         "bound_ms_4k": mr["v3"]["bound"][0],
         "bench_launches": bench_launches["matches"],
         "v3_launches": v3_enc_launches["matches"]},
        {**row("build_records", "records.cu",
               "brotli_tpu/ops/device_encode.py:424", enc_launches["records"],
               mr["record_err"], mr["main"]["rms"], mr["main"]["rplain_ms"],
               mr["main"]["rbound"]),
         "direct_ms": mr["main"]["rdirect_ms"],
         "ms_4k": mr["v3"]["rms"], "direct_ms_4k": mr["v3"]["rdirect_ms"],
         "plain_ms_4k": mr["v3"]["rplain_ms"],
         "bound_ms_4k": mr["v3"]["rbound"][0],
         "bench_launches": bench_launches["records"],
         "v3_launches": v3_enc_launches["records"]},
        row("probe_v2", "probe.cu", "tools/probe_v2.py:15",
            probes["launches"]["probe_v2"], pv2["err"], pv2["ms"],
            pv2["plain_ms"], pv2["bound"]),
        row("probe_v2b", "probe.cu", "tools/probe_v2b.py:17",
            probes["launches"]["probe_v2b"], pv2b["err"], pv2b["ms"],
            pv2b["plain_ms"], pv2b["bound"]),
        # ms, plain_ms and bound at 1 x 64 KB; host_ms: the host q10 parse
        {**row("zopfli_dp", "zopfli.cu",
               "brotli_tpu/ops/device_zopfli.py:166", zopfli["launches"],
               zopfli["err"], zopfli["ms"], zopfli["plain_ms"],
               zopfli["bound"]),
         "direct_ms": zopfli["direct_ms"], "ms_2x2k": zopfli["small_ms"],
         "plain_ms_2x2k": zopfli["plain_small_ms"], "ms_32x8k": zopfli["ms32"],
         "direct_ms_32x8k": zopfli["direct_ms32"],
         "bound_ms_32x8k": zopfli["bound32"][0],
         "ms_runs": zopfli["ms_runs"],
         "direct_ms_runs": zopfli["direct_ms_runs"],
         "host_ms": zopfli["host_s"] * 1e3,
         "host_ms_32x8k": zopfli["host32_s"] * 1e3},
        # at 1024 x 8 KB independently compressed streams; host_ms: the
        # host half's parts; sharded_launches: [device decode]'s 4 slots;
        # direct: the first design, kept and timed in turns with it (no launch
        # on the main path); *_64k: 64 x 64 KB rows, in turns
        {**row("device_decode", "device_decode.cu",
               "brotli_tpu/ops/device_decode.py:204", dd["launches"],
               max(dd["err"], dd["long_err"]), dd["ms"], dd["plain_ms"],
               dd["bound"]),
         "direct_ms": dd["direct_ms"], "turns": dd["turns"],
         "ms_64k": dd["ms_64k"], "direct_ms_64k": dd["direct_ms_64k"],
         "bound_ms_64k": dd["bound_ms_64k"], "config": dd["config"],
         "slowest_lane_cycles": dd["cycles"],
         "direct": {**row("device_decode_direct", "device_decode.cu",
                          "brotli_tpu/ops/device_decode.py:204", 0,
                          dd["direct_err"], dd["direct_ms"], dd["plain_ms"],
                          dd["bound"]), "multi_launches": {}},
         "host_ms": dd["host_ms"], "whole_ms": dd["whole_ms"],
         "fallback_lanes": dd["fallback_lanes"],
         "sharded_launches": dd["sharded_launches"]},
    ]
    print(f"[wall] whole run {time.perf_counter() - t_run:.3f} s (host clock, "
          "builds included)")
    print(f"[card] {card()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
