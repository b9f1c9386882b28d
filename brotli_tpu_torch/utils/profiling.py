"""Profiling: a torch.profiler trace, and per-phase timing of the device
decode round trip and of the device encode.  The counterpart of
brotli_tpu/utils/profiling.py (`Phase` and `phase_report` are copies).

Device phases are intervals between CUDA events on the current stream; host
phases are host-clock intervals.  `device_intervals` and `stream_overlap`
read a trace's device activity by stream: how long the device was busy and
how long kernels of two streams ran at once (parallel/mesh.py's slots).  The device's busy share comes from the
profiler's device activity (kernels and copies) over the profiled window;
where `key_averages()` holds no device time it is None, reported as "not
measured", never a host number.  The trace and the profilers raise
without a card: the CPU has no device time to report.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
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


def device_intervals(trace_json: str | Path
                     ) -> list[tuple[str, int, float, float]]:
    """(category, stream, start us, end us) of every kernel, copy and fill
    in a Chrome trace that trace() wrote."""
    events = json.loads(Path(trace_json).read_text())["traceEvents"]
    out = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                    "gpu_memset"):
            stream = e.get("args", {}).get("stream", e.get("tid", -1))
            t = float(e["ts"])
            out.append((e["cat"], int(stream), t, t + float(e["dur"])))
    return out


def stream_overlap(intervals) -> dict:
    """Device seconds with any activity (`busy_s`), and with kernels of two
    or more streams running at once (`overlap_s`), from device_intervals;
    `streams`: the streams that ran kernels."""
    points = []
    for cat, stream, t0, t1 in intervals:
        points += [(t0, 1, cat, stream), (t1, -1, cat, stream)]
    points.sort(key=lambda p: (p[0], p[1]))
    active: dict[tuple[str, int], int] = {}
    busy = overlap = 0.0
    last = None
    for t, step, cat, stream in points:
        if last is not None and active:
            kernel_streams = {s for (c, s), n in active.items()
                              if c == "kernel" and n}
            busy += t - last
            if len(kernel_streams) >= 2:
                overlap += t - last
        last = t
        key = (cat, stream)
        active[key] = active.get(key, 0) + step
        if not active[key]:
            del active[key]
    return {"busy_s": busy / 1e6, "overlap_s": overlap / 1e6,
            "streams": sorted({s for c, s, _, _ in intervals if c == "kernel"})}


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
                       trace_dir: str | Path | None = None,
                       rounds: int = 5) -> dict:
    """Per-phase timing of the port's v2 decode round trip on `streams`,
    its two host halves in turns: "old", the reference's numpy staging
    (stage_v2, batch_to_torch: eight pageable copies) and unpack
    (host_phases, collect_lanes); "new", the native staging
    (preflight2_native.stage_host, to_device: one pinned copy) and the
    pinned unpack (collect_lanes_pinned).

    Phases of a call: the host preflight (host clock), staging H2D, the
    entropy kernel and the resolve kernel (CUDA events), the unpack with
    its device-to-host copies (host clock, after a synchronise), and the
    whole call's host clock ("round trip").  Each half runs once first
    (reported apart: it builds the native library and allocates the
    pinned buffers), then `rounds` times, the two in turns; "best" is each
    phase's best of those.  Then one profiled call of each: the device's
    busy share of its host clock and the device time by name (Chrome
    traces under `trace_dir`/old and /new).  Returns {"bytes",
    "fallback_lanes", "out" (the new half's first output), "same" (the two
    halves' first outputs equal), "old": ..., "new": ...}, each half's
    "first" and "best" phases, "busy", "window_s" and "device_s_by_name"."""
    from ..ops import decode2 as D
    from ..ops import preflight2_native as N
    from ..ops import resolve as R

    dev = _require_card(device)
    root = Path(trace_dir) if trace_dir is not None else DEFAULT_TRACE_DIR

    def old_stage():
        return D.stage_v2(streams, groups)

    def new_stage():
        return N.stage_host(streams, groups, pin=True)

    def old_put(batch):
        return batch, D.batch_to_torch(batch, dev)

    def new_put(hs):
        staged = N.to_device(hs, dev)
        return staged, staged.tb

    def old_unpack(batch, outs):
        resolved, err, phase, widx = outs
        return D.collect_lanes(batch, streams, D.host_phases(batch, phase, widx),
                               resolved, err)

    def new_unpack(staged, outs):
        return D.collect_lanes_pinned(staged, streams, *outs)

    halves = {"old": (old_stage, old_put, old_unpack),
              "new": (new_stage, new_put, new_unpack)}

    def call(name):
        stage, put, unpack = halves[name]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        host = stage()
        if host is None:
            raise ValueError("the v2 staging refused the streams")
        t1 = time.perf_counter()
        ev[0].record()
        batch, tb = put(host)
        ev[1].record()
        tok, count, phase, widx = D.entropy_decode(tb)
        ev[2].record()
        resolved, err = R.resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
        ev[3].record()
        ev[3].synchronize()
        t2 = time.perf_counter()
        out = unpack(batch, (resolved, err, phase, widx))
        t3 = time.perf_counter()
        dev_s = [ev[i].elapsed_time(ev[i + 1]) / 1e3 for i in range(3)]
        phases = [Phase("preflight", t1 - t0, "host",
                        {"streams": len(streams)}),
                  Phase("staging H2D", dev_s[0], "device"),
                  Phase("entropy kernel", dev_s[1], "device"),
                  Phase("resolve kernel", dev_s[2], "device"),
                  Phase("unpack + D2H", t3 - t2, "host"),
                  Phase("round trip", t3 - t0, "host")]
        return phases, out

    fb0 = D.fallback_stats()["lanes_fallback"]
    res: dict[str, dict] = {}
    outs = {}
    for name in halves:
        first, outs[name] = call(name)
        res[name] = {"first": first, "runs": []}
    for r in range(rounds):
        for name in (("old", "new") if r % 2 == 0 else ("new", "old")):
            res[name]["runs"].append(call(name)[0])
    for name, rr in res.items():
        runs = rr.pop("runs")
        rr["best"] = [dataclasses.replace(ph, seconds=min(
            run[k].seconds for run in runs)) for k, ph in enumerate(runs[0])]
        with trace(root / name) as prof:
            t0 = time.perf_counter()
            call(name)
            window = time.perf_counter() - t0
        rr["busy"] = busy_share(prof, window)
        rr["window_s"] = window
        rr["device_s_by_name"] = device_times(prof)
    return {"bytes": sum(map(len, outs["new"])),
            "fallback_lanes": D.fallback_stats()["lanes_fallback"] - fb0,
            "out": outs["new"], "same": outs["old"] == outs["new"], **res}


# encode_device_batch's stages as it reports them, and the phase names here
ENCODE_STAGES = {"upload": "upload", "matches": "matches", "parse": "parse",
                 "records": "records", "host tables": "host tables",
                 "pack": "pack kernel", "assembly": "assembly + fetch"}


def profile_device_encode(data: bytes, device: torch.device | str = "cuda",
                          **knobs):
    """One encode_device_batch(data, device, **knobs) with its stages timed.

    Returns (streams, phases, summary, state): the encode's streams; one
    phase per stage, each the interval between CUDA events recorded on the
    stream at its ends (the upload's numpy staging and pageable copy, and
    the host-tables stage, are host work the stream waits for, so their
    intervals span that host time); the summary's host-clock
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
        kind = "host" if name in ("upload", "host tables") else "device"
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
