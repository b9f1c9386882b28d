"""Profiling: a torch.profiler trace, and per-phase timing of the device
decode round trip and of the device encode.  The counterpart of
brotli_tpu/utils/profiling.py (`Phase` and `phase_report` are copies).

Device phases are intervals between CUDA events on the current stream; host
phases are host-clock intervals.  The device's busy share comes from the
profiler's device activity (kernels and copies) over the profiled window;
where `key_averages()` holds no device time it is None, reported as "not
measured", never a host number.  The trace and the profilers raise
without a card: the CPU has no device time to report.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import Any

import torch

DEFAULT_TRACE_DIR = Path(__file__).resolve().parent.parent / "build" / "trace"


def _require_card(device: torch.device | str) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"profiling times the card; device {str(device)!r} "
                         "has no device time")
    if not torch.cuda.is_available():
        raise RuntimeError("profiling needs a CUDA card: "
                           "torch.cuda.is_available() is False")
    return dev


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Profile the enclosed work with torch.profiler (CPU and CUDA
    activities); yields the profiler and, on exit, writes the Chrome trace
    to `log_dir`/trace.json (default brotli_tpu_torch/build/trace)."""
    _require_card("cuda")
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir) if log_dir is not None else DEFAULT_TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / "trace.json"))


def device_times(prof) -> dict[str, float]:
    """Device seconds by name (kernels, copies, fills) from a finished
    profiler's key_averages(); empty when it recorded no device activity."""
    times: dict[str, float] = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us:
            times[evt.key] = times.get(evt.key, 0.0) + us / 1e6
    return times


def busy_share(prof, window_s: float) -> float | None:
    """The device's busy share of a profiled window: the profiler's device
    time over the window's host-clock length; None (not measured) when
    the profiler saw no device time."""
    total = sum(device_times(prof).values())
    if total <= 0 or window_s <= 0:
        return None
    return total / window_s


@dataclasses.dataclass
class Phase:
    """One timed pipeline phase."""

    name: str
    seconds: float
    kind: str                     # "host" | "device"
    extra: dict[str, Any] = dataclasses.field(default_factory=dict)


def phase_report(phases: list[Phase], total_bytes: int | None = None) -> str:
    """Aligned text table of a phase list; per-phase MB/s when sized."""
    width = max(len(p.name) for p in phases)
    lines = []
    for p in phases:
        rate = ""
        if total_bytes and p.seconds > 0:
            rate = f"  {total_bytes / p.seconds / 1e6:8.1f} MB/s"
        ex = "  ".join(f"{k}={v}" for k, v in p.extra.items())
        lines.append(f"{p.name:<{width}}  {p.seconds * 1e3:9.2f} ms"
                     f"  [{p.kind}]{rate}  {ex}".rstrip())
    return "\n".join(lines)


def profile_e2e_decode(streams: list[bytes],
                       device: torch.device | str = "cuda",
                       groups: int | None = None,
                       trace_dir: str | Path | None = None):
    """Per-phase timing of the port's v2 decode round trip on `streams`.

    Returns (phases, summary).  Phases: the host preflight (host clock),
    staging H2D, the entropy kernel and the resolve kernel (CUDA events),
    and the unpack with its device-to-host copy (host clock).  One
    profiled pass runs first (it also warms up); the summary carries its
    device busy share and device time per kernel, then the timed pass's
    bytes, rates and flagged lanes."""
    from ..ops import decode2 as D
    from ..ops import resolve as R

    dev = _require_card(device)
    if groups is None:
        groups = min(D.MAX_GROUPS, -(-len(streams) // D.NSTREAM))
    t0 = time.perf_counter()
    batch = D.preflight_shared(streams, groups=groups, rate_sort=True)
    pre_s = time.perf_counter() - t0
    if batch is None:
        raise ValueError("streams are not eligible for the shared-table path")

    def chain(mark):
        tb = D.batch_to_torch(batch, dev)
        mark()
        tok, count, phase, widx = D.entropy_decode(tb)
        mark()
        resolved, err = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
        mark()
        return phase, widx, resolved, err

    def unpack(phase, widx, resolved, err):
        outs, errs = R.unpack_resolved(resolved, err, batch.mlens)
        bad = ((phase.cpu().numpy() != D.DONE) | (errs != 0)
               | D.lane_overran(batch, widx.cpu().numpy()))
        return outs, int(bad.sum())   # pad lanes (mlen 0) end DONE

    with trace(trace_dir) as prof:
        t0 = time.perf_counter()
        unpack(*chain(lambda: None))
        window = time.perf_counter() - t0
    busy = busy_share(prof, window)
    by_name = device_times(prof)

    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    events[0].record()
    marks = iter(events[1:])
    out = chain(lambda: next(marks).record())
    events[-1].synchronize()
    t0 = time.perf_counter()
    _, err_lanes = unpack(*out)
    unpack_s = time.perf_counter() - t0
    dev_s = [events[i].elapsed_time(events[i + 1]) / 1e3 for i in range(3)]
    total = int(batch.mlens.sum())
    phases = [
        Phase("preflight", pre_s, "host", {"streams": len(streams)}),
        Phase("staging H2D", dev_s[0], "device"),
        Phase("entropy kernel", dev_s[1], "device"),
        Phase("resolve kernel", dev_s[2], "device"),
        Phase("unpack + D2H", unpack_s, "host"),
    ]
    summary = {
        "bytes": total,
        "err_lanes": err_lanes,
        "kernels_mbps": total / (dev_s[1] + dev_s[2]) / 1e6,
        "e2e_mbps": total / sum(p.seconds for p in phases) / 1e6,
        "device_busy": busy,
        "profiled_window_s": window,
        "device_s_by_name": by_name,
    }
    return phases, summary


# encode_device_batch's stages as it reports them, and the phase names here
ENCODE_STAGES = {"matches": "upload + matches", "parse": "parse",
                 "records": "records", "host tables": "host tables",
                 "pack": "pack kernel", "assembly": "assembly + fetch"}


def profile_device_encode(data: bytes, device: torch.device | str = "cuda",
                          **knobs):
    """One encode_device_batch(data, device, **knobs) with its stages timed.

    Returns (streams, phases, summary, state): the encode's streams; one
    phase per stage, each the interval between CUDA events recorded on the
    stream at its ends (the host-tables stage is host work the stream waits
    for, so its interval spans that host time); the summary's host-clock
    wall, MB/s and ratio; and the encode's state, which keeps the pack
    kernel's input (`pb`) and output (`words`, `status`)."""
    from ..ops import device_encode as E

    dev = _require_card(device)
    marks: list[tuple[str, Any]] = []
    seen: dict[str, Any] = {}

    def on_stage(name: str, state: dict) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
        seen["state"] = state

    start = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    streams = E.encode_device_batch(data, device=dev, on_stage=on_stage,
                                    **knobs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    phases = []
    prev = start
    for name, ev in marks:
        kind = "host" if name == "host tables" else "device"
        phases.append(Phase(ENCODE_STAGES[name],
                            prev.elapsed_time(ev) / 1e3, kind))
        prev = ev
    summary = {
        "bytes": len(data),
        "wall_s": wall,
        "encode_mbps": len(data) / wall / 1e6,
        "ratio": sum(map(len, streams)) / max(1, len(data)),
        "stages_s": sum(p.seconds for p in phases),
    }
    return streams, phases, summary, seen.get("state")
