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

import numpy as np
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


class _Parts:
    """Host-clock parts of one call, each through a synchronise of
    `device` (none on the CPU): timed blocks, and wrapped functions (their
    outermost calls only, so a wrapped function that another one calls
    counts in its caller's)."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.s: dict[str, float] = {}
        self.depth = 0
        self.cuda = torch.device(device).type == "cuda"

    def add(self, name: str, seconds: float) -> None:
        self.s[name] = self.s.get(name, 0.0) + seconds

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def part(self, name: str):
        self._sync()
        t = time.perf_counter()
        yield
        self._sync()
        self.add(name, time.perf_counter() - t)

    @contextlib.contextmanager
    def wrapping(self, targets):
        """targets: (owner, attribute, part name); each owner.attribute
        timed under its part name while the block runs."""
        saved = [(o, a, getattr(o, a)) for o, a, _ in targets]

        def wrap(fn, name):
            def run(*args, **kw):
                if self.depth:
                    return fn(*args, **kw)
                self.depth += 1
                try:
                    with self.part(name):
                        return fn(*args, **kw)
                finally:
                    self.depth -= 1
            return run

        for (o, a, fn), (_, _, name) in zip(saved, targets):
            setattr(o, a, wrap(fn, name))
        try:
            yield self
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)


def _old_decode_v3(streams, dev, max_groups, dict_dev, parts: _Parts):
    """decode_batch_v3 through the yardstick's host half: the joined
    streams, the native parse and binning, the numpy staging
    (preflight3_native._assemble), batch_to_torch_v3's pageable copies,
    _lanes and a bytes a lane."""
    from ..decode import decode as host_decode
    from ..ops import decode3 as D3
    from ..ops import preflight3_native as N3

    with parts.part("stage_streams"):
        st = N3.stage_streams(streams)
    ids = np.arange(len(streams), dtype=np.int64)
    with parts.part("parse_units"):
        parsed = N3.parse_units(st, ids, max_bins=max_groups)
    if (parsed.units[:, 0] != 1).any():
        raise ValueError("the yardstick's preflight refused the streams")
    with parts.part("_assemble"):
        batch = N3._assemble(st, parsed, ids, ids, parsed.units[:, 1],
                             max_groups, 64)
    if batch is None:
        raise ValueError("the yardstick's preflight refused the batch")
    with parts.part("batch_to_torch_v3"):
        tb = D3.batch_to_torch_v3(batch, dev, dict_dev=dict_dev)
    with parts.part("kernel"):
        out, status = D3.decode3(tb)
    with parts.part("_lanes"):
        stn, raw = D3._lanes(batch, out[:, tb.hrb:], status)
    with parts.part("per-lane bytes"):
        results: list = [None] * batch.n_streams
        fell = 0
        for slot in range(batch.groups * D3.NSTREAM):
            i = int(batch.perm[slot])
            if i < 0:
                continue
            if stn[0, slot] != 0:
                fell += 1
                results[i] = host_decode(streams[i])
            else:
                results[i] = raw[slot, : batch.mlens[slot]].tobytes()
    D3._note_fallbacks(batch.n_streams, fell)
    return results


def _old_decode_v3_full(streams, dev, max_groups, dict_dev, parts: _Parts):
    """decode_batch_v3_full through the yardstick's host half: the joined
    streams' native walk, each unit's earlier output as bytes on the host,
    preflight_units_v3_native (native parse, numpy staging), batch_to_torch_v3
    (the prefixes uploaded pageable), _lanes and the outputs grown on the
    host."""
    from ..decode import decode as host_decode
    from ..ops import decode3 as D3
    from ..ops import preflight3_native as N3

    n = len(streams)
    with parts.part("stage_streams"):
        staged = N3.stage_streams(streams)
    outs = [bytearray() for _ in range(n)]
    bitpos = np.zeros(n, np.int64)
    rings = [(4, 11, 15, 16)] * n
    maxbw = np.zeros(n, np.int64)
    live = np.ones(n, bool)
    failed = np.zeros(n, bool)
    while True:
        todo = np.flatnonzero(live)
        if not todo.size:
            break
        with parts.part("walk"):
            walked = N3.walk_units(staged, todo, bitpos[todo])
            wu = walked.units
            first = bitpos[todo] == 0
            maxbw[todo[first]] = wu[first, 3]
            for k in np.flatnonzero(wu[:, 5]):
                outs[todo[k]] += walked.copy_of(k)
        failed[todo[wu[:, 0] < 0]] = True
        live[todo[wu[:, 0] != 1]] = False
        found = wu[:, 0] == 1
        if not found.any():
            break
        unit_i = todo[found].tolist()
        is_last = dict(zip(unit_i, wu[found, 4].astype(bool).tolist()))
        idx = np.asarray(unit_i, np.int64)
        with parts.part("history copies"):
            hists = [bytes(outs[i]) for i in unit_i]
            extras = np.array(
                [(len(h), h[-1] if h else 0, h[-2] if len(h) >= 2 else 0,
                  *rings[i]) for i, h in zip(unit_i, hists)], np.int64).T
        with parts.part("preflight_units_v3_native"):
            batch = N3.preflight_units_v3_native(N3.V3Units(
                streams=staged, stream=idx, bit=wu[found, 2],
                mlen=wu[found, 1], maxbw=maxbw[idx], extras=extras,
                hist=hists), max_groups=max_groups)
        placed = set() if batch is None else set(
            batch.perm[batch.perm >= 0].tolist())
        for i in unit_i:
            if i not in placed:
                failed[i] = True
                live[i] = False
        if batch is None:
            break
        with parts.part("batch_to_torch_v3"):
            tb = D3.batch_to_torch_v3(batch, dev, dict_dev=dict_dev)
        with parts.part("kernel"):
            out, status = D3.decode3(tb)
        with parts.part("_lanes and appends"):
            st, raw = D3._lanes(batch, out[:, tb.hrb:], status)
            for slot in range(batch.groups * D3.NSTREAM):
                i = int(batch.perm[slot])
                if i < 0:
                    continue
                if st[0, slot] != 0:
                    failed[i] = True
                    live[i] = False
                    continue
                outs[i] += raw[slot, : batch.mlens[slot]].tobytes()
                rings[i] = tuple(int(st[6 + k, slot]) for k in range(4))
                if is_last[i]:
                    live[i] = False
                else:
                    w0 = int(staged.n_words[i]) - int(batch.n_words[slot])
                    bitpos[i] = (32 * w0 + 32 * int(st[4, slot])
                                 - int(st[5, slot]))
    D3._note_fallbacks(n, int(failed.sum()))
    return [host_decode(streams[i]) if failed[i] else bytes(outs[i])
            for i in range(n)]


def profile_v3_decode(streams: list[bytes], device: torch.device | str = "cuda",
                      *, full: bool = False, max_groups: int | None = None,
                      dict_dev=None, rounds: int = 5) -> dict:
    """The v3 round trip's two host halves on `streams`: "old",
    the yardstick's (the joined streams, the native parse with numpy
    staging in the TPU's layout, pageable copies, a Python loop over the
    lanes; on the full path each unit's earlier output rebuilt as bytes on
    the host every round), and "new", the drivers themselves
    (decode_batch_v3, or decode_batch_v3_full with `full`: the native
    staging into one pinned buffer, the pinned unpack, the history kept on
    the card).  Each half runs once first, its output compared; then the
    new one runs `rounds` times more and "best" is each part's best of
    those, host clock through a synchronise.  Returns {"bytes",
    "fallback_lanes", "out" (the new half's first output), "same" (the
    halves' outputs equal), "old": {"first"}, "new": {"first", "best"}}:
    part name -> seconds, "call" the whole call."""
    from ..ops import decode3 as D3
    from ..ops import stage3_native as S3
    from ..ops.decode2 import fallback_stats

    dev = _require_card(device)
    if max_groups is None:
        max_groups = D3.GROUP_CAP_V3

    def new_parts(parts: _Parts):
        H = S3.DeviceHistory
        return parts.wrapping([
            (S3, "walk_ptrs", "walk"),
            (H, "append_copies", "history (device)"),
            (H, "append", "history (device)"),
            (H, "prefix", "history (device)"),
            (S3, "plan_and_fill", "plan_and_fill"),
            (S3, "to_device", "to_device"),
            (D3, "decode3", "kernel"),
            (D3, "_to_host", "status copy"),
            (D3, "collect_lanes_v3_pinned", "collect_lanes_v3_pinned"),
            (H, "fetch", "fetch")])

    def call(name):
        parts = _Parts(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if name == "old":
            old = _old_decode_v3_full if full else _old_decode_v3
            out = old(streams, dev, max_groups, dict_dev, parts)
        else:
            fn = D3.decode_batch_v3_full if full else D3.decode_batch_v3
            with new_parts(parts):
                out = fn(streams, device=dev, max_groups=max_groups,
                         dict_dev=dict_dev)
        torch.cuda.synchronize()
        parts.add("call", time.perf_counter() - t0)
        return parts.s, out

    fb0 = fallback_stats()["lanes_fallback"]
    res: dict[str, dict] = {}
    outs = {}
    for name in ("old", "new"):
        first, outs[name] = call(name)
        res[name] = {"first": first}
    runs = [call("new")[0] for _ in range(rounds)]
    res["new"]["best"] = {k: min(run[k] for run in runs) for k in runs[0]}
    return {"bytes": sum(map(len, outs["new"])),
            "fallback_lanes": fallback_stats()["lanes_fallback"] - fb0,
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
