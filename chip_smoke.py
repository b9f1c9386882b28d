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
   its plain PyTorch version at the same shape.

Every timing line carries the card's name and power limit.  The line before
the last is a JSON object describing the kernels; the last line is
{"ok": true, "device": {...}}.  Without a CUDA card it exits non-zero and
prints no result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CHUNK = 8192
GROUPS = 4
MAX_DISTANCE = 2032        # bench.py's e2e encode setting
REF_RING_LIMIT = 4096 - 16  # pallas_resolve.MAX_DEVICE_DISTANCE


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


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device milliseconds of fn() over reps runs (CUDA events)."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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

    ent_ms = cuda_ms(ent, 5)
    res_ms = cuda_ms(res, 5)
    # the wrappers zero their token and byte outputs; that fill is inside
    # the times above, so it is timed alone too
    ent_fill = cuda_ms(lambda: D._alloc_outputs(tb), 5)
    res_fill = cuda_ms(lambda: R._alloc_outputs(state["e"][0], tb.max_mlen), 5)
    mbps = total / ((ent_ms + res_ms) * 1e-3) / 1e6
    print(f"[times] {card_str}: entropy kernel {ent_ms:.4f} ms, resolve kernel "
          f"{res_ms:.4f} ms per {total} B batch (CUDA events, mean of 5; "
          f"of which output allocation and zero-fill {ent_fill:.4f} ms and "
          f"{res_fill:.4f} ms)")
    print(f"[times] {card_str}: e2e device decode {mbps:.2f} MB/s "
          "(decoded bytes / both kernels' device time, batch staged)")
    print(f"[times] {card_str}: host preflight {pre_ms:.3f} ms for "
          f"{len(batch_streams)} streams (host clock, apart from the above)")

    # the plain versions once each, on CUDA tensors at the same shape (their
    # PyTorch ops are warm from the kernel == plain phase)
    pe = cuda_ms(lambda: state.__setitem__("pe", D.entropy_decode_ref(tb)), 1,
                 warm_up=False)
    tok, count, _, _ = state["e"]
    pr = cuda_ms(lambda: state.__setitem__(
        "pr", R.resolve_tokens_ref(tok, count, tb.mlen, tb.max_mlen)), 1,
        warm_up=False)
    errs = {"entropy": max_abs_err(state["e"], state["pe"]),
            "resolve": max_abs_err(state["r"], state["pr"])}
    check(errs == {"entropy": 0, "resolve": 0},
          f"kernel != plain version on the main-path batch: {errs}")
    print(f"[times] {card_str}: plain entropy {pe:.3f} ms, plain resolve "
          f"{pr:.3f} ms on the same batch (CUDA events, one run each)")
    return {"entropy_ms": ent_ms, "resolve_ms": res_ms,
            "plain_entropy_ms": pe, "plain_resolve_ms": pr,
            "errs": errs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing run",
              file=sys.stderr)
        return 1
    import brotli_tpu_torch  # noqa: F401  (fails outside a checkout)

    check("jax" not in sys.modules, "the port imported jax")
    card_str = card()
    print(f"[card] {card_str}")
    phase_build(card_str)
    errs = phase_kernel_vs_plain()
    data, streams = main_path_streams()
    launches = phase_main_path(data, streams)
    phase_far()
    times = phase_times(streams, card_str)
    check("jax" not in sys.modules, "the port imported jax")

    kernels = [
        {"name": "entropy_decode", "route": "cuda",
         "source": "brotli_tpu_torch/csrc/decode2.cu",
         "replaces": "brotli_tpu/ops/pallas_decode2.py:158",
         "launches": launches["entropy"],
         "max_abs_err": max(errs["entropy"], times["errs"]["entropy"]),
         "ms": times["entropy_ms"], "plain_ms": times["plain_entropy_ms"]},
        {"name": "resolve_tokens", "route": "cuda",
         "source": "brotli_tpu_torch/csrc/resolve.cu",
         "replaces": "brotli_tpu/ops/pallas_resolve.py:127",
         "launches": launches["resolve"],
         "max_abs_err": max(errs["resolve"], times["errs"]["resolve"]),
         "ms": times["resolve_ms"], "plain_ms": times["plain_resolve_ms"]},
    ]
    print(f"[card] {card()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
