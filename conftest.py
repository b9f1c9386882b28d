"""Tier-1's test scheduling: files to the pytest-xdist workers longest
first, and a cap on each worker's OpenMP threads.

Tier-1 runs `pytest -n 6 --dist loadfile`: each test file goes whole to one
worker. pytest-xdist 3.8 queues the files by their test count, largest
first, so a file of a few long tests (a JAX interpret-mode reference run)
starts behind many short files and sets the wall. Here the queue follows
FILE_SECONDS, the measured seconds of each file's tests, longest first
(LPT scheduling). A file with no row goes out before every file with one,
so a new file never starts last. Any other `--dist` is left to xdist.

FILE_SECONDS holds every `tests/test_*.py`; a new test file adds its row in
the same change (`tests/test_torch_schedule.py` checks that). To refresh
the table, run tier-1 (it writes `--junitxml=/tmp/_t1.xml`), then

    python3 conftest.py /tmp/_t1.xml

which prints the table from the XML's per-test times, summed by file.
With `-v`, a tier-1 run prints when each worker takes and finishes each
file.

In an xdist worker, importing this module also sets OMP_NUM_THREADS to
the host's cores over the workers. With six torch OpenMP pools as wide as
the host, tier-1's workers summed ~7,150 s (files longest first); with
the cap, ~4,200 s.

This module imports no JAX, torch or package of this repo, and `xdist`
only inside the hook: pytest loads it before `tests/conftest.py`, which
sets JAX's environment before JAX starts, and where pytest-xdist is
missing (or `-p no:xdist`) the hook is never called.
"""

import os
import time

import pytest


def _cap_worker_threads():
    """In a pytest-xdist worker, cap torch's OpenMP threads to the cores
    over the workers. A value the caller set wins; outside a worker
    nothing changes."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return
    threads = max(1, len(os.sched_getaffinity(0)) // int(workers))
    os.environ.setdefault("OMP_NUM_THREADS", str(threads))


_cap_worker_threads()

# Seconds of each file's tests (setup, call and teardown summed), from the
# junit XML of one tier-1 run with this module in place (ROADMAP's command:
# 6 workers on an 8-core CPU host); 3,497.80 s in all. A file that runs
# after another file on its worker has compiled the same JAX shapes takes
# less. The 0.00 rows ran no test: their collection failed there, for want
# of the reference's fixture files.
FILE_SECONDS = {
    "tests/test_torch_decode3_e2e.py": 621.16,
    "tests/test_torch_parallel.py": 539.73,
    "tests/test_torch_decode3_cases.py": 427.67,
    "tests/test_torch_encode_e2e.py": 396.60,
    "tests/test_torch_decode3.py": 345.58,
    "tests/test_torch_encode_stages.py": 304.53,
    "tests/test_torch_pack.py": 141.71,
    "tests/test_torch_zopfli.py": 98.31,
    "tests/test_torch_resolve.py": 96.04,
    "tests/test_torch_device_decode.py": 82.02,
    "tests/test_torch_parse.py": 75.87,
    "tests/test_font_and_dict.py": 65.60,
    "tests/test_torch_decode2.py": 46.86,
    "tests/test_torch_e2e.py": 38.36,
    "tests/test_native_tables.py": 34.76,
    "tests/test_pallas_decode3.py": 29.01,
    "tests/test_torch_preflight3_native.py": 28.71,
    "tests/test_torch_encode_host_native.py": 28.67,
    "tests/test_torch_multihost.py": 24.04,
    "tests/test_torch_host_copy.py": 20.39,
    "tests/test_torch_stage3_native.py": 19.76,
    "tests/test_torch_preflight2_native.py": 13.20,
    "tests/test_torch_probe.py": 12.60,
    "tests/test_torch_schedule.py": 12.03,
    "tests/test_torch_zopfli_step.py": 6.65,
    "tests/test_torch_encode_split.py": 2.07,
    "tests/test_torch_encode_kernels.py": 1.32,
    "tests/test_utils.py": 0.39,
    "tests/test_torch_group_caps.py": 0.06,
    "tests/test_encoder_parity.py": 0.02,
    "tests/test_device_zopfli.py": 0.02,
    "tests/test_huffman.py": 0.02,
    "tests/test_interpret_gate.py": 0.01,
    "tests/test_torch_device_decode_card.py": 0.00,
    "tests/test_decode_vectors.py": 0.00,
    "tests/test_determinism.py": 0.00,
    "tests/test_device_decode.py": 0.00,
    "tests/test_device_encode.py": 0.00,
    "tests/test_pallas_decode2.py": 0.00,
    "tests/test_pallas_resolve.py": 0.00,
    "tests/test_parallel.py": 0.00,
    "tests/test_roundtrip.py": 0.00,
    "tests/test_torch_parallel_card.py": 0.00,
}


def order_by_seconds(files, seconds=FILE_SECONDS):
    """Return `files` in the order to hand them out.

    Files without a row in `seconds` come first, in their given order; then
    the rest, longest first (ties keep their given order).
    """
    unknown = [f for f in files if f not in seconds]
    known = sorted((f for f in files if f in seconds), key=lambda f: -seconds[f])
    return unknown + known


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    """Queue `--dist loadfile` work longest first; leave any other mode to xdist."""
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class LongestFirstScheduling(LoadFileScheduling):
        """LoadFileScheduling whose work queue follows `order_by_seconds`.

        With `-v` it prints when each worker takes and finishes each file,
        in seconds from the first file handed out.
        """

        _t0 = None

        def _say(self, node, what, scope):
            if config.option.verbose > 0:
                config.pluginmanager.get_plugin("terminalreporter").write_line(
                    f"[{node.gateway.id}] {what} {scope} at "
                    f"{time.monotonic() - self._t0:.1f} s")

        def _assign_work_unit(self, node):
            # `schedule` fills the queue (by test count) and then assigns the
            # first units; reorder it once, before the first unit goes out.
            if self._t0 is None:
                self._t0 = time.monotonic()
                for scope in order_by_seconds(list(self.workqueue)):
                    self.workqueue.move_to_end(scope)
            scope = next(iter(self.workqueue))
            super()._assign_work_unit(node)
            self._say(node, "takes", scope)

        def mark_test_complete(self, node, item_index, duration=0):
            super().mark_test_complete(node, item_index, duration)
            scope = self._split_scope(self.registered_collections[node][item_index])
            if all(self.assigned_work[node][scope].values()):
                self._say(node, "finishes", scope)

    return LongestFirstScheduling(config, log)


def seconds_from_junit(path):
    """Sum a junit XML's testcase times by test file: {"tests/x.py": s}."""
    import xml.etree.ElementTree as ET

    totals = {}
    for case in ET.parse(path).iter("testcase"):
        # classname is the dotted module path, then any class: tests.test_x[.Cls]
        parts = case.get("classname", "").split(".")
        if parts == [""]:  # a collection error: the module is its name
            parts = case.get("name", "").split(".")
        modules = [i for i, p in enumerate(parts) if p.startswith("test_")]
        if not modules:
            continue
        name = "/".join(parts[: modules[0] + 1]) + ".py"
        totals[name] = totals.get(name, 0.0) + float(case.get("time", 0.0))
    return totals


if __name__ == "__main__":
    import sys

    table = seconds_from_junit(sys.argv[1])
    print("FILE_SECONDS = {")
    for name in order_by_seconds(sorted(table), table):
        print(f'    "{name}": {table[name]:.2f},')
    print("}")
    print(f"# {sum(table.values()):.2f} s over {len(table)} files")
