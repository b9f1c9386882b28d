#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (brotli_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. build  -- nvcc compiles brotli_tpu_torch/csrc/*.cu (sm_90a) at first use;
2. kernel == plain version on the card, bit for bit (tokens, counts,
   phases, words consumed, bytes, flags), one group of 1024 x 1 KB streams;
3. main path -- decode_batch_device_e2e(device="cuda") on the bench's e2e
   shape, 4 groups x 1024 streams x 8192 B = 33.6 MB, must equal the input
   with no host fallback, and both kernels must have launched;
4. far distances -- 256 x 8 KB streams encoded without a distance cap (the
   reference's resolve ring flags these) decode with no fallback;
5. times with CUDA events: each kernel on the staged main-path batch and
   its plain PyTorch version at the same shape;
6. enc kernel == plain version on the card, bit for bit (words, widx,
   avail, tail limbs, ovf), 1024 x 2 KB, for the three literal-tree
   branches (one tree; context-mapped trees in two table groups; block
   types), then the whole encode of that batch on the card against the
   same encode on the CPU, stream for stream, per branch;
7. enc main path -- encode_device_batch(device="cuda") of 1024 x 32 KB =
   33.6 MB at the default knobs, decoded back through
   decode_batch_device_e2e(device="cuda"): equal to the input, no host
   fallback on either side, all three kernels launched; CUDA events around
   each stage inside that one encode;
8. enc times -- the pack kernel on the main path's records, and its plain
   version against the main path's kernel output;
9. enc bench config -- the reference bench's encode setting at the same
   shape: one pack launch counted, every stream decodes to its chunk
   through decode_batch_v3(device="cuda", max_groups=8) with no fallback,
   no ovf lane, ratio, stage times, and the plain pack against the kernel
   bit for bit at the widest table indexing (8 groups x 8 trees);
10. v3 kernel == plain version on the card, bit for bit over the bytes and
   all 16 status rows: 1024 x 1 KB port-encoded streams (4 context-mapped
   trees, 2 table groups), host q9/q11 encodes with tree groups and block
   switching in all three categories, one static-dictionary word per
   transform (121) over a group, the compound-dictionary streams, and a
   batch with one poisoned and one truncated lane (both must flag);
11. v3 main path -- the reference bench's full-format shape: 6 groups x
   1024 x 4096 B = 25,165,824 B encoded on the card by encode_device_batch
   (lit_ctx_trees=8), decoded by decode_batch_v3(device="cuda",
   max_groups=6): equal to the input, no fallback, the decode3 kernel
   launched; host clock of the call with the preflight apart;
12. v3 times with CUDA events on the staged main batch: the kernel at
   use_dict=False (the bench's timed setting) and True, the output
   allocation and fill alone, and the plain version once, equal to it;
13. v3 full -- decode_batch_v3_full(device="cuda") on 1024 lanes of three
   64 KB streams (a streaming Encoder(quality=5, lgwin=18) fed 1 KB updates
   in 16 KB metablocks, a spliced parallel_encode stream, an uncompressed
   one):
   equal to the input, no fallback, one kernel launch per round;
14. probes -- run_probe_v2 at every level and run_probe_v2b at every
   variant of the TPU scripts, launches counted from 0; each kernel's
   outputs held against its plain version bit for bit; ns per row;
15. profile -- profile_e2e_decode on the main-path batch: per-phase times
   and the device's busy share from torch.profiler (Chrome trace in
   brotli_tpu_torch/build/trace/);
16. entry() -- the port's entry point called once and synchronised.

Kernel times come from utils.benchmarks.time_device_fn (CUDA events) and
the encoder's stage times from utils.profiling.profile_device_encode,
inside the main encode.  Every timing line carries the card's name and
power limit.  The line before the last is a JSON object describing the
kernels, with each one's bound: the least time the card could take, the
larger of its bytes (inputs read once, outputs written once, counted from
this run's data) over 3.35 TB/s and its integer operations over 67 T/s
(the float32 rate outside the tensor cores, the nearest published peak:
a lower bound on the time).  The last line is {"ok": true, "device": {...}}.
Without a CUDA card it exits non-zero and prints no result.  It imports
nothing of JAX and nothing of the JAX package (brotli_tpu): it checks both
before and after its phases.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BPS = 3.35e12          # H100 SXM device memory, bytes/s
INT_OPS = 67e12            # float32 outside the tensor cores, ops/s
CHUNK = 8192
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
    """The package's sorted .py sources then the static dictionary, tiled."""
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    base = src + (ROOT / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def device_ms(fn) -> float:
    """Device milliseconds per call of fn(): time_device_fn's best of 3
    windows of 5 calls between CUDA events, after a warm-up call."""
    from brotli_tpu_torch.utils.benchmarks import time_device_fn

    return time_device_fn(fn) * 1e3


def plain_ms(fn) -> float:
    """One run of a plain version, CUDA events around it, no warm-up."""
    from brotli_tpu_torch.utils.benchmarks import time_device_fn

    return time_device_fn(fn, rep=1, samples=1, warm_up=False) * 1e3


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


def phase_build(tag: str) -> None:
    from brotli_tpu_torch import build

    t0 = time.perf_counter()
    build.kernels_lib()
    dt = time.perf_counter() - t0
    print(f"[build] kernels built and loaded in {dt:.3f} s ({tag})")
    for line in build.last_build_log.get("brotli_tpu_torch_kernels", "").splitlines():
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
    ref = D.entropy_decode_ref(tb)
    torch.cuda.synchronize()
    e_err = max_abs_err(ker, ref)
    check(e_err == 0, f"entropy kernel != plain version (max abs err {e_err})")
    tok, count, phase, _ = ker
    check(bool((phase == D.DONE).all()), "entropy kernel left lanes not DONE")
    out_k, err_k = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
    out_r, err_r = R.resolve_tokens_ref(tok, count, tb.mlen, tb.max_mlen)
    torch.cuda.synchronize()
    r_err = max_abs_err((out_k, err_k), (out_r, err_r))
    check(r_err == 0, f"resolve kernel != plain version (max abs err {r_err})")
    check(D.KERNEL_LAUNCHES > n0 and R.KERNEL_LAUNCHES > r0,
          "a kernel wrapper did not count its launch")
    outs, errs = R.unpack_resolved(out_k, err_k, batch.mlens)
    check(not errs.any(), "resolve flagged lanes of the 1 KB batch")
    check(b"".join(outs) == data, "1 KB batch bytes differ from the input")
    print(f"[kernel==plain] 1024 lanes x 1 KB: entropy max_abs_err {e_err}, "
          f"resolve max_abs_err {r_err} (exact equality required)")
    return {"entropy": e_err, "resolve": r_err}


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
    """decode_batch_device_e2e on 4 x 1024 x 8 KB, counting launches."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D
    from brotli_tpu_torch.ops import resolve as R

    batch = streams * GROUPS
    expect = data * GROUPS
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    D.KERNEL_LAUNCHES = 0
    R.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    got = brotli_tpu_torch.decode_batch_device_e2e(batch, device="cuda",
                                                   groups=GROUPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"entropy": D.KERNEL_LAUNCHES, "resolve": R.KERNEL_LAUNCHES}
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(len(got) == len(batch), "wrong number of outputs")
    check(b"".join(got) == expect, "main-path output differs from the input")
    check(fell == 0, f"{fell} lanes fell back to the host decoder")
    check(launches["entropy"] >= 1 and launches["resolve"] >= 1,
          f"a kernel of the path never launched: {launches}")
    print(f"[main] {len(expect)} B decoded bit-exact through device='cuda', "
          f"0 fallback lanes, launches {launches}; whole call {dt:.3f} s "
          "(host clock: preflight, copies, kernels, unpack)")
    return launches


def phase_far() -> None:
    """Copies further back than the reference ring's 4080 B decode here."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode2 as D

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

    ent_ms = device_ms(ent)
    res_ms = device_ms(res)
    # the wrappers zero their token and byte outputs; that fill is inside
    # the times above, so it is timed alone too
    ent_fill = device_ms(lambda: D._alloc_outputs(tb))
    res_fill = device_ms(lambda: R._alloc_outputs(state["e"][0], tb.max_mlen))
    mbps = total / ((ent_ms + res_ms) * 1e-3) / 1e6
    print(f"[times] {card_str}: entropy kernel {ent_ms:.4f} ms, resolve kernel "
          f"{res_ms:.4f} ms per {total} B batch (time_device_fn: CUDA events, "
          f"best of 3 windows of 5; of which output allocation and zero-fill "
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
    print(f"[times] {card_str}: plain entropy {pe:.3f} ms, plain resolve "
          f"{pr:.3f} ms on the same batch (CUDA events, one run each)")
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
            "plain_entropy_ms": pe, "plain_resolve_ms": pr,
            "entropy_bound": ent_bound, "resolve_bound": res_bound,
            "errs": errs}


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


def phase_enc_kernel_vs_plain() -> int:
    """The pack kernel against pack_records_ref on CUDA tensors."""
    from brotli_tpu_torch.ops import device_encode as E

    data = corpus(1024 * 2048)
    worst = 0
    for name, kw in ENC_PLAIN_SETS.items():
        pb = enc_pack_batch(data, 2048, **kw)[0]
        ker = E.pack_records(pb)
        ref = E.pack_records_ref(pb)
        torch.cuda.synchronize()
        err = max_abs_err(ker, ref)
        check(err == 0, f"pack kernel != plain version ({name}): {err}")
        check(not bool(ker[1][5].any()), f"ovf lanes in the {name} batch")
        worst = max(worst, err)
        print(f"[enc kernel==plain] 1024 lanes x 2 KB, {name}: max_abs_err "
              f"{err} over words and status (exact equality required)")
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
    pack launches counted from 0 and the stages timed inside that encode;
    returns (streams, host-clock s, what was seen: launches, phases, the
    pack kernel's input `pb` and output `pack_out`, the encode's state).
    The launch count is read before anything else launches the kernel."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import device_encode as E
    from brotli_tpu_torch.utils.profiling import profile_device_encode

    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    E.KERNEL_LAUNCHES = 0
    streams, phases, summary, state = profile_device_encode(
        data, "cuda", chunk_size=ENC_CHUNK, **kw)
    seen = {"launches": E.KERNEL_LAUNCHES, "phases": phases,
            "pb": state["pb"], "pack_out": (state["words"], state["status"]),
            "state": state}
    fell = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - enc0
    check(len(streams) == 1024, f"{len(streams)} streams, want 1024")
    check(fell == 0, f"{fell} lanes overflowed (host-encoded)")
    check(seen["launches"] == 1,
          f"the pack kernel launched {seen['launches']} times, want 1")
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
    """The plain pack on the PackBatch an encode built, against the kernel's
    output in that encode, bit for bit; returns (max_abs_err, plain ms)."""
    from brotli_tpu_torch.ops import device_encode as E

    out = {}
    ms = plain_ms(lambda: out.__setitem__("p", E.pack_records_ref(seen["pb"])))
    err = max_abs_err(seen["pack_out"], out["p"])
    check(err == 0, f"pack kernel != plain version at {what}: {err}")
    return err, ms


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
    streams, enc_s, seen = encode_counted(data)
    t0 = time.perf_counter()
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    launches = {"pack": seen["launches"], "entropy": D.KERNEL_LAUNCHES,
                "resolve": R.KERNEL_LAUNCHES}
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
          f"stream_sizes equals every stream's length, launches {launches}")
    line = enc_breakdown(seen)
    print(f"[enc times] {card_str}: default knobs, inside that encode "
          f"(profile_device_encode: CUDA events at each stage's ends, one "
          f"run): {line}; whole encode {enc_s * 1e3:.3f} ms (host clock)")
    return launches, seen


def phase_enc_bench(data: bytes, card_str: str) -> int:
    """The reference bench's encode setting: the streams decoded back
    through the v3 kernel, the pack kernel counted and held against its
    plain version at this shape."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3

    streams, dt, seen = encode_counted(data, **ENC_BENCH)
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
          f"host clock), pack launches {seen['launches']}")
    line = enc_breakdown(seen)
    print(f"[enc times] {card_str}: bench setting, inside that encode "
          f"(profile_device_encode, one run): {line}")
    err, plain = pack_vs_plain(seen, "the bench setting")
    print(f"[enc kernel==plain] 1024 lanes x 32 KB, bench setting "
          f"({seen['pb'].tab.shape[0]} groups x {seen['pb'].nt} trees): "
          f"max_abs_err {err} over words and status; plain pack {plain:.3f} "
          "ms (CUDA events, one run)")
    return err


def phase_enc_times(seen: dict, card_str: str) -> dict:
    """The pack kernel on the main path's PackBatch, and its plain version
    against the main path's kernel output."""
    from brotli_tpu_torch.ops import device_encode as E

    pack_ms = device_ms(lambda: E.pack_records(seen["pb"]))
    err, plain = pack_vs_plain(seen, "the main shape")
    bound = pack_bound(seen)
    print(f"[enc times] {card_str}: pack kernel {pack_ms:.4f} ms per "
          f"{ENC_CHUNK * 1024} B batch (time_device_fn: CUDA events, best of "
          f"3 windows of 5, on the main path's records); plain pack "
          f"{plain:.3f} ms on the same batch (CUDA events, one run), "
          f"max_abs_err {err}; bound {bound[0]:.6f} ms ({bound[1]})")
    return {"pack_ms": pack_ms, "plain_pack_ms": plain, "err": err,
            "bound": bound}


def dictmix(n: int) -> bytes:
    """Half static-dictionary text, half sources: streams with several
    trees, context modes and block types at q9/q11."""
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    dic = (ROOT / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()
    return dic[8000: 8000 + n // 2] + src[50000: 50000 + n // 2]


def v3_kernel_vs_plain(tag: str, streams: list[bytes], expect: list,
                       flag: set = frozenset(), custom_dictionary=None) -> int:
    """decode3 against decode3_ref on one staged batch, bit for bit over
    the bytes and the 16 status rows; lanes in `flag` must flag and the
    others decode to `expect`."""
    from brotli_tpu_torch.ops import decode3 as D3

    batch = D3.preflight_v3(streams, max_groups=8)
    check(batch is not None, f"{tag}: preflight_v3 refused the batch")
    tb = D3.batch_to_torch_v3(batch, "cuda", custom_dictionary)
    n0 = D3.KERNEL_LAUNCHES
    ker = D3.decode3(tb)
    ref = D3.decode3_ref(tb)
    torch.cuda.synchronize()
    check(D3.KERNEL_LAUNCHES == n0 + 1, "decode3 did not count its launch")
    err = max_abs_err(ker, ref)
    check(err == 0, f"{tag}: decode3 kernel != plain version ({err})")
    out = ker[0][:, tb.hrb:].cpu().numpy()
    status = ker[1].cpu().numpy()
    flagged = set()
    for slot in range(tb.n_lanes):
        i = int(batch.perm[slot])
        if i < 0:
            continue
        if status[0, slot] != 0 or status[4, slot] > batch.n_words[slot] + 4:
            flagged.add(i)
        else:
            check(out[slot, : batch.mlens[slot]].tobytes() == expect[i],
                  f"{tag}: stream {i} decodes wrong")
    check(flagged == set(flag), f"{tag}: lanes {sorted(flagged)} flagged, "
          f"want {sorted(flag)}")
    print(f"[v3 kernel==plain] {tag}: {len(streams)} streams in "
          f"{batch.groups} groups, max_abs_err {err} over bytes and 16 status "
          f"rows (exact equality required), flagged lanes {sorted(flagged)}")
    return err


def phase_v3_kernel_vs_plain() -> int:
    import brotli_tpu_torch

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
        chunks[:64] + [None], {5, 64}))
    return worst


def v3_main_streams(card_str: str) -> tuple[bytes, list[bytes]]:
    """6 x 1024 x 4 KB, one encode_device_batch call per group."""
    import brotli_tpu_torch

    piece = 1024 * V3_BENCH["chunk_size"]
    data = corpus(V3_GROUPS * piece)
    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    t0 = time.perf_counter()
    streams = []
    for g in range(V3_GROUPS):
        streams += brotli_tpu_torch.encode_device_batch(
            data[g * piece:(g + 1) * piece], device="cuda", **V3_BENCH)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fell = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] - enc0
    check(fell == 0, f"{fell} v3 main lanes overflowed (host-encoded)")
    check(len(streams) == V3_GROUPS * 1024, f"{len(streams)} streams")
    print(f"[v3 main] {card_str}: {len(data)} B encoded on the card by "
          f"{V3_GROUPS} encode_device_batch calls ({V3_BENCH}) in {dt:.3f} s (host "
          f"clock), ratio {sum(map(len, streams)) / len(data):.6f}")
    return data, streams


def phase_v3_main(data: bytes, streams: list[bytes], card_str: str):
    """decode_batch_v3 on the main shape, the decode3 launches counted from
    0 and the host preflight timed inside the call."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3

    seen = {}
    preflight = D3.preflight_v3

    def timed_preflight(*a, **k):
        t = time.perf_counter()
        seen["batch"] = preflight(*a, **k)
        seen["pre_s"] = time.perf_counter() - t
        return seen["batch"]

    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    D3.preflight_v3 = timed_preflight
    try:
        D3.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_v3(streams, device="cuda",
                                               max_groups=V3_GROUPS)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = D3.KERNEL_LAUNCHES
    finally:
        D3.preflight_v3 = preflight
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(b"".join(got) == data, "v3 main output differs from the input")
    check(fell == 0, f"{fell} v3 main lanes fell back to the host decoder")
    check(launches >= 1, "decode3 never launched on the v3 main path")
    check(seen["batch"].groups == V3_GROUPS, "v3 main batch is not 6 groups")
    print(f"[v3 main] {card_str}: {len(data)} B decoded bit-exact through "
          f"decode_batch_v3(device='cuda'), 0 fallback lanes, decode3 "
          f"launches {launches}; whole call {dt:.3f} s (host clock), of which "
          f"host preflight {seen['pre_s']:.3f} s")
    return launches, seen["batch"]


def phase_v3_times(batch, card_str: str) -> dict:
    from brotli_tpu_torch.ops import decode3 as D3

    tb = D3.batch_to_torch_v3(batch, "cuda")
    total = int(batch.mlens.sum())
    state = {}
    ms_nd = device_ms(lambda: state.__setitem__("nd", D3.decode3(tb, False)))
    ms_d = device_ms(lambda: state.__setitem__("d", D3.decode3(tb, True)))
    fill = device_ms(lambda: D3._alloc_outputs(tb))
    plain = plain_ms(lambda: state.__setitem__("p", D3.decode3_ref(tb, False)))
    err = max(max_abs_err(state["nd"], state["p"]),
              max_abs_err(state["d"], state["p"]))
    check(err == 0, f"decode3 != plain version on the v3 main batch: {err}")
    # bound: the words each lane consumed, the tables and scalars in, the
    # decoded bytes and the 16 status rows out
    words = int(state["nd"][1][4].to(torch.int64).sum().item())
    tables = sum(t.numel() for t in (tb.lit, tb.cmd, tb.dist, tb.bsw, tb.cmap,
                                     tb.dx, tb.consts, tb.lut, tb.tfm,
                                     tb.scal))
    bound = bound_ms(4 * (words + tables) + total + 4 * 16 * tb.n_lanes)
    print(f"[v3 times] {card_str}: decode3 kernel {ms_nd:.4f} ms at "
          f"use_dict=False, {ms_d:.4f} ms at use_dict=True, per {total} B "
          f"batch ({total / (ms_nd * 1e-3) / 1e6:.2f} MB/s at use_dict=False; "
          f"time_device_fn: CUDA events, best of 3 windows of 5, of which "
          f"output allocation and fill {fill:.4f} ms timed alone); bound "
          f"{bound[0]:.6f} ms ({words} words consumed; {bound[1]})")
    print(f"[v3 times] {card_str}: plain decode3_ref {plain:.3f} ms on the "
          f"same batch (CUDA events, one run), max_abs_err {err}")
    return {"ms": ms_nd, "ms_dict": ms_d, "plain_ms": plain, "err": err,
            "bound": bound}


def phase_v3_full(card_str: str) -> int:
    """decode_batch_v3_full on 1024 lanes of multi-metablock streams."""
    import brotli_tpu_torch
    from brotli_tpu_torch.ops import decode3 as D3

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
    rounds = []
    run = D3.run_batch_v3

    def counted(*a, **k):
        rounds.append(1)
        return run(*a, **k)

    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    D3.run_batch_v3 = counted
    try:
        D3.KERNEL_LAUNCHES = 0
        t0 = time.perf_counter()
        got = brotli_tpu_torch.decode_batch_v3_full(lanes, device="cuda")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = D3.KERNEL_LAUNCHES
    finally:
        D3.run_batch_v3 = run
    fell = brotli_tpu_torch.fallback_stats()["lanes_fallback"] - fb0
    check(all(g == text for g in got), "v3 full output differs from the input")
    check(fell == 0, f"{fell} v3 full lanes fell back to the host decoder")
    check(launches == len(rounds) >= 2,
          f"{launches} decode3 launches for {len(rounds)} rounds")
    print(f"[v3 full] {card_str}: 1024 lanes x 64 KB (streaming 16 KB "
          f"metablocks, spliced 16 KB fragments, uncompressed) decoded bit-exact through "
          f"decode_batch_v3_full(device='cuda') in {dt:.3f} s (host clock), "
          f"0 fallback lanes, {len(rounds)} rounds, {launches} launches")
    return launches


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


def phase_profile(streams: list[bytes], card_str: str) -> None:
    """profile_e2e_decode on the main-path batch (4 x 1024 x 8 KB)."""
    from brotli_tpu_torch.utils.profiling import phase_report, profile_e2e_decode

    phases, summ = profile_e2e_decode(streams * GROUPS, "cuda", groups=GROUPS)
    check(summ["err_lanes"] == 0, f"{summ['err_lanes']} lanes flagged")
    for line in phase_report(phases, summ["bytes"]).splitlines():
        print(f"[profile] {card_str}: {line}")
    busy = summ["device_busy"]
    top = sorted(summ["device_s_by_name"].items(), key=lambda kv: -kv[1])[:4]
    top_s = "; ".join(f"{k.split('(')[0]} {v * 1e3:.4f} ms" for k, v in top)
    print(f"[profile] {card_str}: device busy share "
          f"{'not measured' if busy is None else f'{busy:.4f}'} of the "
          f"profiled pass ({summ['profiled_window_s'] * 1e3:.3f} ms host "
          f"clock; torch.profiler device time over it); kernels "
          f"{summ['kernels_mbps']:.2f} MB/s, whole round trip "
          f"{summ['e2e_mbps']:.2f} MB/s; top device time: {top_s}")


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
    phase_build(card_str)
    errs = phase_kernel_vs_plain()
    probes = phase_probes(card_str)
    data, streams = main_path_streams()
    launches = phase_main_path(data, streams)
    phase_far()
    times = phase_times(streams, card_str)
    phase_profile(streams, card_str)
    enc_err = phase_enc_kernel_vs_plain()
    phase_enc_card_vs_cpu()
    enc_data = corpus(1024 * ENC_CHUNK)
    enc_launches, enc_seen = phase_enc_main(enc_data, card_str)
    enc_times = phase_enc_times(enc_seen, card_str)
    del enc_seen
    bench_err = phase_enc_bench(enc_data, card_str)
    del enc_data
    v3_err = phase_v3_kernel_vs_plain()
    v3_data, v3_streams = v3_main_streams(card_str)
    v3_launches, v3_batch = phase_v3_main(v3_data, v3_streams, card_str)
    del v3_data, v3_streams
    v3_times = phase_v3_times(v3_batch, card_str)
    del v3_batch
    phase_v3_full(card_str)
    phase_entry()
    check_no_reference_imports()

    def row(name, source, replaces, n, err, ms, plain, bound):
        return {"name": name, "route": "cuda",
                "source": f"brotli_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": n, "max_abs_err": err,
                "ms": ms, "plain_ms": plain, "bound_ms": bound[0],
                "bound_by": bound[1], "library_ms": None}

    pv2, pv2b = probes["probe_v2"], probes["probe_v2b"]
    kernels = [
        row("entropy_decode", "decode2.cu",
            "brotli_tpu/ops/pallas_decode2.py:158", launches["entropy"],
            max(errs["entropy"], times["errs"]["entropy"]),
            times["entropy_ms"], times["plain_entropy_ms"],
            times["entropy_bound"]),
        row("resolve_tokens", "resolve.cu",
            "brotli_tpu/ops/pallas_resolve.py:127", launches["resolve"],
            max(errs["resolve"], times["errs"]["resolve"]),
            times["resolve_ms"], times["plain_resolve_ms"],
            times["resolve_bound"]),
        row("pack_records", "pack.cu", "brotli_tpu/ops/device_encode.py:689",
            enc_launches["pack"], max(enc_err, enc_times["err"], bench_err),
            enc_times["pack_ms"], enc_times["plain_pack_ms"],
            enc_times["bound"]),
        row("decode3", "decode3.cu", "brotli_tpu/ops/pallas_decode3.py:532",
            v3_launches, max(v3_err, v3_times["err"]), v3_times["ms"],
            v3_times["plain_ms"], v3_times["bound"]),
        row("probe_v2", "probe.cu", "tools/probe_v2.py:15",
            probes["launches"]["probe_v2"], pv2["err"], pv2["ms"],
            pv2["plain_ms"], pv2["bound"]),
        row("probe_v2b", "probe.cu", "tools/probe_v2b.py:17",
            probes["launches"]["probe_v2b"], pv2b["err"], pv2b["ms"],
            pv2b["plain_ms"], pv2b["bound"]),
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
