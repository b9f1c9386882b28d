"""Where the host time of one device encode goes, part by part, for the
yardstick's host half and the new one.

    python3 -m brotli_tpu_torch.tools.enc_host_profile
        [--setting default|bench|v3[,...]] [--rounds R] [--device D]

The settings are tools/enc_stages.py's `SETTINGS` (`default`: 1024 x 32 KB
at the default knobs; `bench`: the same bytes at the reference bench's
encode setting, 8 table groups x 8 trees; `v3`: 1024 x 4 KB at the v3
cell's setting), each on `utils.benchmarks.corpus`.

Two halves of one encode, each a list of parts timed on the host clock
through a synchronise before and after (so a part's device work is in it):

* "old", the yardstick: `old_half` below runs ops/device_encode.py's
  retained functions (`_encode_start` staging through `stage_input`:
  numpy staging and a pageable copy; `prepare_pack`: the record sample
  fetched, the lane features' `np.add.at` loop in `_cluster_lanes`, the
  k-means, `group_hist` and its fetch, each group's
  `_group_tables_from_hists`, `_headers` building each header twice, the
  pageable pack-input copies and the zero-filled transposes; the pack
  kernel; `assemble_streams`' (lanes, maxH + rows + 2) word table;
  `_old_encode_finish`'s pageable fetch and cut into `bytes`), each
  timed by wrapping it;
* "new", `encode_device_batch` itself, its parts timed by wrapping the
  functions it calls.

A part wrapped inside another is taken out of the outer one's time, so
the parts add up to the call (less the time outside every part).
Each half runs once first (reported apart), then R times (5 by default)
split into parts and R times whole (no synchronise inside), the two halves
in turns; each part prints its median and best.  The streams of every run
must equal the first run's of the old half.  The headers' builds are
counted and timed one by one (`_header_bits`).  Prints the card's name and
power limit; the last line is the results as JSON.  The device defaults
to cuda.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch

from .enc_stages import SETTINGS

# encode_device_batch's defaults for the knobs SETTINGS may leave out
DEFAULTS = dict(sample_stride=256, hash_stride=1, max_distance=None,
                chain_depth=2, table_groups=1, lit_ctx_trees=1,
                hist_stride=8, lgwin=22)

# the old half's parts: (module, function) -> part name; prepare_pack's
# own part is what its wrapped callees leave: the sample fetch, the
# histogram's fetch, the pageable copies and the transposes
OLD_PARTS = [
    ("E", "stage_input", "staging + H2D"),
    ("E", "device_stages", "device stages"),
    ("E", "prepare_pack", "fetches, copies, transposes"),
    ("E", "_cluster_lanes", "lane features"),
    ("H", "_cluster_rows", "k-means"),
    ("E", "group_hist", "group_hist"),
    ("E", "_group_tables_from_hists", "tables"),
    ("E", "_headers", "headers"),
    ("E", "pack_records", "pack kernel"),
    ("E", "assemble_streams", "assembly"),
    ("E", "_old_encode_finish", "fetch + cut"),
]

# the new half's parts
NEW_PARTS = [
    ("E", "_pin_input", "staging (host)"),
    ("E", "_lay_out", "H2D + lay-out"),
    ("E", "device_stages", "device stages"),
    ("E", "lane_features", "lane features + fetch"),
    ("H", "_cluster_rows", "k-means"),
    ("E", "_group_hist_fetch", "group_hist + fetch"),
    ("E", "_group_tables_all", "tables"),
    ("E", "_headers_once", "headers"),
    ("E", "_to_device", "H2D copies"),   # the lanes' groups, the pack inputs
    ("E", "_transpose_records", "transposes"),
    ("E", "pack_records", "pack kernel"),
    ("E", "_assemble_compact", "assembly"),
    ("E", "_fetch_compact", "fetch"),
    ("E", "_cut_streams", "cut"),
]


def card() -> str:
    if not torch.cuda.is_available():
        return "no CUDA card"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "?"


class Timer:
    """Host-clock parts through a synchronise of the device (none when
    `split` is False: then only the whole call is timed).  A part opened
    inside another is taken out of the outer part's time."""

    def __init__(self, device: torch.device, split: bool = True):
        self.s: dict[str, float] = {}
        self.split = split
        self.cuda = device.type == "cuda"
        self.inner: list[float] = []   # the open parts' nested seconds

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def add(self, name: str, seconds: float) -> None:
        self.s[name] = self.s.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def part(self, name: str):
        if not self.split:
            yield
            return
        self.sync()
        self.inner.append(0.0)
        t = time.perf_counter()
        try:
            yield
        finally:
            self.sync()
            dt = time.perf_counter() - t
            self.add(name, dt - self.inner.pop())
            if self.inner:
                self.inner[-1] += dt

    @contextlib.contextmanager
    def wrapping(self, targets):
        """targets: (owner, attribute, part name), each owner.attribute
        timed under its part name while the block runs."""
        saved = [(o, a, getattr(o, a)) for o, a, _ in targets]

        def wrap(fn, name):
            def run(*args, **kw):
                with self.part(name):
                    return fn(*args, **kw)
            return run

        for (o, a, fn), (_, _, name) in zip(saved, targets):
            setattr(o, a, wrap(fn, name))
        try:
            yield self
        finally:
            for o, a, fn in saved:
                setattr(o, a, fn)


@contextlib.contextmanager
def header_log(log: list):
    """Each header build's host seconds appended to `log`: the yardstick's
    `_headers` builds through `_header_bits`, the new half's
    `_headers_once` through `_header_words_native` (ops/device_encode's
    names of both)."""
    from ..ops import device_encode as E

    saved = [(name, getattr(E, name)) for name in
             ("_header_bits", "_header_words_native") if hasattr(E, name)]

    def timed(orig):
        def build(*args, **kw):
            t = time.perf_counter()
            w = orig(*args, **kw)
            log.append(time.perf_counter() - t)
            return w
        return build

    for name, orig in saved:
        setattr(E, name, timed(orig))
    try:
        yield
    finally:
        for name, orig in saved:
            setattr(E, name, orig)


def _targets(parts: list, tm: Timer) -> list:
    from ..ops import device_encode as E
    from ..ops import encode_host as H

    mods = {"E": E, "H": H}
    return [(mods[m], f, name) for m, f, name in parts] if tm.split else []


def old_half(data: bytes, chunk: int, knobs: dict, dev: torch.device,
             tm: Timer) -> list[bytes]:
    """The yardstick's host half: `_encode_start` with `stage_input`'s
    staging in `stage_upload`'s place, then `prepare_pack`, the pack,
    `assemble_streams` and `_old_encode_finish`, each OLD_PARTS function
    a part of `tm`."""
    from ..ops import device_encode as E

    kw = {**DEFAULTS, **knobs}

    def upload(data, chunk_size, device):
        return (*E.stage_input(data, chunk_size, device), None)

    with tm.wrapping(_targets(OLD_PARTS, tm)), \
            mock.patch.object(E, "stage_upload", upload):
        state = E._encode_start(
            data, dev, chunk, kw["hash_stride"], kw["sample_stride"],
            kw["max_distance"], kw["chain_depth"],
            lit_ctx=kw["lit_ctx_trees"] > 1, hist_stride=kw["hist_stride"])
        pb, hdr, h_np = E.prepare_pack(state, kw["lgwin"],
                                       kw["table_groups"],
                                       kw["lit_ctx_trees"])
        words, status = E.pack_records(pb)
        state.update(h_np=h_np, lgwin=kw["lgwin"], status=status,
                     swords=E.assemble_streams(words, status, *hdr))
        return E._old_encode_finish(state)


def new_half(data: bytes, chunk: int, knobs: dict, dev: torch.device,
             tm: Timer) -> list[bytes]:
    """encode_device_batch, its parts timed by wrapping the functions it
    calls."""
    from ..ops import device_encode as E

    with tm.wrapping(_targets(NEW_PARTS, tm)):
        return E.encode_device_batch(data, device=dev, chunk_size=chunk,
                                     **knobs)


def run(name: str, half, data, chunk, knobs, dev, split: bool):
    """(streams, {part: s}, header builds' s) of one call of a half."""
    tm = Timer(dev, split)
    builds: list[float] = []
    with header_log(builds):
        tm.sync()
        t0 = time.perf_counter()
        out = half(data, chunk, knobs, dev, tm)
        tm.sync()
    tm.add("call", time.perf_counter() - t0)
    return out, tm.s, builds


def profile_setting(setting: str, rounds: int = 5,
                    device: str | torch.device = "cuda",
                    data: bytes | None = None) -> dict:
    """Both halves at one setting, in turns (see the module's docstring);
    raises if any run's streams differ from the old half's first.  Returns
    {"bytes", "knobs", "chunk", "ratio", "halves": {half: {"first": {part:
    s}, "median": {...}, "best": {...}, "whole_median", "whole_best" (s),
    "header_builds" (a call), "header_build_ms" (median)}}}."""
    from ..utils.benchmarks import corpus

    chunk, knobs = SETTINGS[setting]
    dev = torch.device(device)
    if data is None:
        data = corpus(1024 * chunk)
    halves = {"old": old_half, "new": new_half}
    res: dict[str, dict] = {}
    want = None
    for name, half in halves.items():
        out, first, builds = run(name, half, data, chunk, knobs, dev, True)
        want = want or out
        if out != want:
            raise RuntimeError(f"{setting}: the {name} half's streams differ "
                               "from the old half's")
        res[name] = {"first": first, "split": [], "whole": [],
                     "builds": len(builds), "build_s": list(builds)}
    order = list(halves)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            for split in (True, False):
                out, parts, builds = run(name, halves[name], data, chunk,
                                         knobs, dev, split)
                if out != want:
                    raise RuntimeError(f"{setting}: round {r}: the {name} "
                                       "half's streams differ")
                key = "split" if split else "whole"
                res[name][key].append(parts)
                if split:
                    res[name]["build_s"] += builds
    summary = {}
    for name, rr in res.items():
        names = list(rr["first"])
        summary[name] = {
            "first": rr["first"],
            "median": {k: statistics.median(p.get(k, 0.0) for p in rr["split"])
                       for k in names},
            "best": {k: min(p.get(k, 0.0) for p in rr["split"])
                     for k in names},
            "whole_median": statistics.median(p["call"] for p in rr["whole"]),
            "whole_best": min(p["call"] for p in rr["whole"]),
            "header_builds": rr["builds"],
            "header_build_ms": statistics.median(rr["build_s"]) * 1e3
            if rr["build_s"] else 0.0,
        }
    return {"bytes": len(data), "knobs": knobs, "chunk": chunk,
            "halves": summary,
            "ratio": sum(map(len, want)) / len(data)}


def report(setting: str, rep: dict, card_s: str, tag: str = "enc host"):
    """Print one line per half: each part's median and best (ms), the
    whole call's, the headers' builds."""
    for name, h in rep["halves"].items():
        parts = ", ".join(
            f"{k} {h['median'][k] * 1e3:.3f} ({h['best'][k] * 1e3:.3f})"
            for k in h["median"] if k != "call")
        first = ", ".join(f"{k} {v * 1e3:.3f}" for k, v in h["first"].items())
        print(f"[{tag}] {card_s}: {setting} ({rep['bytes']} B, "
              f"{rep['knobs']}), {name} half, median (best) of the split "
              f"runs, ms: {parts}; split call {h['median']['call'] * 1e3:.3f} "
              f"({h['best']['call'] * 1e3:.3f}); whole call without "
              f"synchronises {h['whole_median'] * 1e3:.3f} "
              f"({h['whole_best'] * 1e3:.3f}) ms, "
              f"{rep['bytes'] / h['whole_median'] / 1e6:.3f} MB/s; "
              f"{h['header_builds']} header builds a call, "
              f"{h['header_build_ms']:.3f} ms each (median); first call: "
              f"{first}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--setting", default="default",
                    help="default, bench or v3, or several joined by commas")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--lanes", type=int, default=1024,
                    help="chunks of the corpus a batch (a CPU check runs "
                         "a few)")
    args = ap.parse_args()
    from ..utils.benchmarks import corpus

    card_s = card()
    print(f"[card] {card_s}")
    out = {"card": card_s}
    for setting in args.setting.split(","):
        data = corpus(args.lanes * SETTINGS[setting][0])
        rep = profile_setting(setting, args.rounds, args.device, data)
        report(setting, rep, card_s)
        out[setting] = {k: v for k, v in rep.items()}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
