"""Benchmark helpers: significance testing and a CUDA-event timer.

`welch_t_test` and `compare_timings` are copies of
brotli_tpu/utils/benchmarks.py (the reference library's decode bench
builds Welch's t-test into the benchmark, so a speedup is reported only
when it is significant).

`time_device_fn` times a function on the card with CUDA events.  `corpus`
is the in-repo data the smoke run, the multi-device dryrun and the
multi-process simulation encode and decode.  The
reference's `measure_rtt` is left out: it measured the round trip of a
remote TPU tunnel, which the reference subtracted from every time.  A CUDA
event is recorded on the card's own stream, so no host round trip sits in
the interval and there is nothing to subtract.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path

import torch


def welch_t_test(a: list[float], b: list[float]) -> tuple[float, float]:
    """Welch's unequal-variance t-test; returns (t, dof)."""
    na, nb = len(a), len(b)
    if na < 2 or nb < 2:
        raise ValueError(
            f"welch_t_test needs >=2 samples per side (got {na}, {nb})"
        )
    ma = sum(a) / na
    mb = sum(b) / nb
    va = sum((x - ma) ** 2 for x in a) / (na - 1)
    vb = sum((x - mb) ** 2 for x in b) / (nb - 1)
    sa, sb = va / na, vb / nb
    denom = math.sqrt(sa + sb) or 1e-12
    t = (ma - mb) / denom
    dof_num = (sa + sb) ** 2
    dof_den = (sa * sa) / (na - 1) + (sb * sb) / (nb - 1)
    dof = dof_num / dof_den if dof_den else float(na + nb - 2)
    return t, dof


@dataclass
class Comparison:
    mean_a: float
    mean_b: float
    speedup: float
    t_stat: float
    dof: float
    significant: bool


def compare_timings(a: list[float], b: list[float],
                    t_critical: float = 2.0) -> Comparison:
    """Compare two timing samples; significant when |t| > t_critical
    (~alpha 0.05 for reasonable sample sizes, as the reference uses).

    Samples too small for a t-test (n < 2) report means only, never
    significance."""
    if not a or not b:
        raise ValueError("compare_timings needs non-empty samples")
    ma = sum(a) / len(a)
    mb = sum(b) / len(b)
    if len(a) < 2 or len(b) < 2:
        return Comparison(
            mean_a=ma, mean_b=mb,
            speedup=ma / mb if mb else float("inf"),
            t_stat=float("nan"), dof=0.0, significant=False,
        )
    t, dof = welch_t_test(a, b)
    return Comparison(
        mean_a=ma, mean_b=mb,
        speedup=ma / mb if mb else float("inf"),
        t_stat=t, dof=dof, significant=abs(t) > t_critical,
    )


# cycles of the spin kernel that holds the stream before a window (about
# 10 ms at the H100's 1.98 GHz boost clock)
HOLD_CYCLES = 20_000_000


def time_device_fn(fn, *args, rep: int = 5, samples: int = 3,
                   warm_up: bool = True) -> float:
    """Seconds per call of `fn(*args)` on the card: one untimed call
    (unless `warm_up` is False), then `samples` windows of `rep` calls
    between two CUDA events on the current stream; the best window's mean.

    Before each window a spin kernel holds the stream, so the host queues
    the window's launches ahead of the card and a kernel shorter than its
    own launch overhead is timed back to back, not at the host's pace.
    `fn` launches its work on the current stream.  Raises when no card is
    present or when a tensor argument lies elsewhere than on the card: a
    CPU time is never returned under this name."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_device_fn needs a CUDA card: "
                           "torch.cuda.is_available() is False")
    for a in args:
        if isinstance(a, torch.Tensor) and a.device.type != "cuda":
            raise ValueError(f"time_device_fn: an argument is on {a.device}, "
                             "not on the card")
    if rep < 1 or samples < 1:
        raise ValueError("rep and samples must be >= 1")
    if warm_up:
        fn(*args)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        for _ in range(rep):
            fn(*args)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / rep)
    return best / 1e3


REPO = Path(__file__).resolve().parents[2]


def corpus(n_bytes: int) -> bytes:
    """`n_bytes` of in-repo data: the reference package's sorted .py
    sources, then the static dictionary, tiled (files read as bytes; the
    reference package is not imported)."""
    src = b"".join(p.read_bytes()
                   for p in sorted((REPO / "brotli_tpu").rglob("*.py")))
    base = src + (REPO / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def runs_input(seed: int = 0, repeats: int = 3, rand: int = 300,
               run: int = 17000) -> bytes:
    """`repeats` times (51,900 B by default): `rand` random bytes, drawn
    anew each time from numpy.random.default_rng(seed), then a run of `run`
    zero bytes.  Each run gives the q10 parse a match longer than its
    quick-step threshold (16,384), whose skip the long-match skip of its
    match collection takes too."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return b"".join(rng.integers(0, 256, rand, np.uint8).tobytes()
                    + bytes(run) for _ in range(repeats))
