"""The root conftest.py: longest-first scheduling of test files, and the
cap on an xdist worker's OpenMP threads.

Under `--dist loadfile`, its `pytest_xdist_make_scheduler` hook returns a
LoadFileScheduling whose work queue follows FILE_SECONDS, longest first,
with files that have no row first; any other `--dist` gets None, so xdist
decides. In a worker, importing it sets OMP_NUM_THREADS to the cores over
the workers. These tests call the hook and the scheduler directly with
stand-in configs and nodes, import the module in subprocesses, and run
pytest in subprocesses on a tiny tree of their own; none needs the session
around them to run under xdist.
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]


def _load_root_conftest():
    spec = importlib.util.spec_from_file_location(
        "root_conftest_under_test", ROOT / "conftest.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


RC = _load_root_conftest()
TABLE = {"tests/a.py": 10.0, "tests/b.py": 300.0, "tests/c.py": 45.5,
         "tests/d.py": 45.5}


@pytest.mark.parametrize(
    "files, expected",
    [
        (["tests/a.py", "tests/b.py", "tests/c.py"],
         ["tests/b.py", "tests/c.py", "tests/a.py"]),
        # no row: first, in the given order, before the longest known file
        (["tests/a.py", "tests/new2.py", "tests/b.py", "tests/new1.py"],
         ["tests/new2.py", "tests/new1.py", "tests/b.py", "tests/a.py"]),
        # equal seconds keep their given order
        (["tests/d.py", "tests/a.py", "tests/c.py"],
         ["tests/d.py", "tests/c.py", "tests/a.py"]),
        (["tests/c.py", "tests/d.py"], ["tests/c.py", "tests/d.py"]),
        ([], []),
    ],
)
def test_order_by_seconds(files, expected):
    assert RC.order_by_seconds(files, TABLE) == expected


def test_every_test_file_has_a_row():
    present = {p.relative_to(ROOT).as_posix()
               for p in (ROOT / "tests").glob("test_*.py")}
    table = set(RC.FILE_SECONDS)
    assert not present - table, "measure these files and add their rows"
    assert not table - present, "rows of files that are gone"
    assert all(s >= 0 for s in RC.FILE_SECONDS.values())
    # the table reads longest first, as it hands out
    seconds = list(RC.FILE_SECONDS.values())
    assert seconds == sorted(seconds, reverse=True)


class _Config:
    """What the hook and LoadScopeScheduling read of a pytest config."""

    def __init__(self, dist, workers=2):
        self.values = {"dist": dist, "tx": [f"{workers}*popen"]}

        class option:
            verbose = -1
            loadscopereorder = True

        self.option = option

    def getvalue(self, name):
        return self.values[name]


class _Node:
    """A worker as the scheduler sees it: it records the indices it is sent."""

    def __init__(self, name, journal):
        self.name = name
        self.gateway = type("Gateway", (), {"id": name})
        self.sent = []
        self.journal = journal  # every node's sends, in order
        self.shutting_down = False

    def send_runtest_some(self, indices):
        self.sent.extend(indices)
        self.journal.extend(indices)

    def shutdown(self):
        self.shutting_down = True


@pytest.mark.parametrize("dist", ["load", "loadscope", "loadgroup",
                                  "worksteal", "each", "no"])
def test_hook_leaves_other_modes_to_xdist(dist):
    assert RC.pytest_xdist_make_scheduler(_Config(dist), None) is None


def test_hook_loadfile_scheduler():
    pytest.importorskip("xdist")
    from xdist.scheduler import LoadFileScheduling

    sched = RC.pytest_xdist_make_scheduler(_Config("loadfile"), None)
    assert isinstance(sched, LoadFileScheduling)


# rows of distinct seconds, in no order
SIM_TABLE = {"tests/s1.py": 5.0, "tests/s2.py": 900.0, "tests/s3.py": 60.0,
             "tests/s4.py": 300.0, "tests/s5.py": 0.5, "tests/s6.py": 120.0}


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_scheduler_hands_out_longest_first(workers, monkeypatch):
    """A whole run with stand-in workers: the files go out in
    order_by_seconds' order, each whole to one worker, every test once."""
    pytest.importorskip("xdist")
    for f, seconds in SIM_TABLE.items():
        monkeypatch.setitem(RC.FILE_SECONDS, f, seconds)
    files = ["tests/test_not_in_table.py"] + list(SIM_TABLE)
    # test counts unlike the seconds, so xdist's own order would differ
    collection = [f"{f}::t{i}" for k, f in enumerate(files)
                  for i in range(1 + (k * 5) % 7)]
    from xdist.remote import Producer

    sched = RC.pytest_xdist_make_scheduler(_Config("loadfile", workers),
                                           Producer("sched", enabled=False))
    journal = []
    nodes = [_Node(f"gw{i}", journal) for i in range(workers)]
    for node in nodes:
        sched.add_node(node)
    for node in nodes:
        sched.add_node_collection(node, collection)
    sched.schedule()

    done = set()
    while len(done) < len(collection):
        progressed = False
        for node in nodes:
            # a worker runs a test only once the one after it has come, or
            # it is shut down (xdist/remote.py, run_one_test)
            todo = [i for i in node.sent if i not in done]
            if len(todo) >= 2 or (todo and node.shutting_down):
                done.add(todo[0])
                sched.mark_test_complete(node, todo[0])
                progressed = True
        assert progressed, "no worker can run a test"
    handed = []  # files in the order they went out
    for i in journal:
        f = collection[i].split("::")[0]
        if f not in handed:
            handed.append(f)
    assert handed == ["tests/test_not_in_table.py", "tests/s2.py",
                      "tests/s4.py", "tests/s6.py", "tests/s3.py",
                      "tests/s1.py", "tests/s5.py"]
    assert sorted(i for n in nodes for i in n.sent) == list(range(len(collection)))
    for f in files:  # each file whole to one worker
        owners = {n.name for n in nodes
                  for i in n.sent if collection[i].startswith(f + "::")}
        assert len(owners) == 1


def test_import_leaves_heavy_modules_out():
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('c', {str(ROOT / 'conftest.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "heavy = {'jax', 'torch', 'brotli_tpu', 'brotli_tpu_torch', 'xdist'}\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in heavy))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


CORES = len(os.sched_getaffinity(0))


@pytest.mark.parametrize("env, omp", [
    # a worker of as many workers as cores: one thread
    ({"PYTEST_XDIST_WORKER_COUNT": str(CORES)}, "1"),
    # a lone worker: every core
    ({"PYTEST_XDIST_WORKER_COUNT": "1"}, str(CORES)),
    # not a worker: nothing set
    ({}, "None"),
    # the caller's value wins
    ({"PYTEST_XDIST_WORKER_COUNT": str(CORES), "OMP_NUM_THREADS": "3"}, "3"),
])
def test_worker_thread_cap(env, omp):
    code = (
        "import importlib.util, os\n"
        f"spec = importlib.util.spec_from_file_location('c', {str(ROOT / 'conftest.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(os.environ.get('OMP_NUM_THREADS'))\n"
    )
    base = {k: v for k, v in os.environ.items()
            if k not in ("PYTEST_XDIST_WORKER_COUNT", "OMP_NUM_THREADS")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env={**base, **env})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == omp


def test_seconds_from_junit(tmp_path):
    xml = tmp_path / "t.xml"
    xml.write_text(
        '<testsuites><testsuite name="pytest">'
        '<testcase classname="tests.test_a" name="t1" time="1.5"/>'
        '<testcase classname="tests.test_a.TestCls" name="t2" time="2.25"/>'
        '<testcase classname="tests.test_b" name="t1" time="0.5"/>'
        '<testcase classname="" name="tests.test_c" time="0.0"/>'
        "</testsuite></testsuites>"
    )
    assert RC.seconds_from_junit(xml) == {"tests/test_a.py": 3.75,
                                          "tests/test_b.py": 0.5,
                                          "tests/test_c.py": 0.0}


def _tiny_tree(tmp_path):
    """A root with this conftest.py, an ini file and three one-test files:
    two named as rows of the table, one with no row."""
    (tmp_path / "conftest.py").write_text((ROOT / "conftest.py").read_text())
    (tmp_path / "pytest.ini").write_text("[pytest]\n")
    (tmp_path / "tests").mkdir()
    ranked = list(RC.FILE_SECONDS)
    names = ["tests/test_zz_no_row.py", ranked[-1], ranked[0]]
    for name in names:
        (tmp_path / name).write_text("def test_one():\n    pass\n")
    return names


def _pytest(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "pytest", "tests", "-p", "no:cacheprovider",
         *args],
        capture_output=True, text=True, timeout=300, cwd=tmp_path,
    )


def test_runs_without_xdist(tmp_path):
    """With no xdist plugin, the hook is optional and pytest does not
    reject it."""
    _tiny_tree(tmp_path)
    out = _pytest(tmp_path, "-p", "no:xdist", "-q")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "3 passed" in out.stdout


def test_controller_queues_longest_first(tmp_path):
    """Under `-n 2 --dist loadfile -v` the controller loads the root
    conftest, hands out the unknown file, then the longest, then the
    shortest, and says when each worker takes and finishes each file."""
    pytest.importorskip("xdist")
    names = _tiny_tree(tmp_path)
    out = _pytest(tmp_path, "-p", "xdist", "-n", "2", "--dist", "loadfile",
                  "-v")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "3 passed" in out.stdout
    said = [line.split() for line in out.stdout.splitlines()
            if line.startswith("[gw") and line.endswith(" s")]
    taken = [words[2] for words in said if words[1] == "takes"]
    assert taken == [names[0], names[2], names[1]]
    assert sorted(words[2] for words in said
                  if words[1] == "finishes") == sorted(names)
