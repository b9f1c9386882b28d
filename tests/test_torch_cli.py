"""The port's command line (brotli_tpu_torch/cli.py) and top-level names
against the JAX package's (brotli_tpu/cli.py, brotli_tpu/__init__.py).

Each CLI case runs `brotli_tpu.cli.main` and `brotli_tpu_torch.cli.main`
on the same input file, each in a directory of its own, and compares the
files written, the return codes and the stderr lines (the directory
removed); where the JAX CLI raises, the port raises the same exception
type with the same message.  The inputs are made here from a numpy seed:
the words of test_torch_host_copy.py's corpus, then random bytes.

Tolerance: exact equality of bytes, codes and messages.
"""

import json
import os
from pathlib import Path
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import brotli_tpu
import brotli_tpu_torch
from brotli_tpu import cli as ref_cli
from brotli_tpu_torch import cli as port_cli
from test_torch_host_copy import _corpus

ROOT = Path(__file__).resolve().parents[1]


def _input(n: int, seed: int) -> bytes:
    """n bytes: seeded text, its last eighth random bytes."""
    tail = n // 8
    rng = np.random.default_rng(seed)
    return _corpus(n - tail, seed) + rng.integers(
        0, 256, tail, dtype=np.uint8).tobytes()


# (id, argv with {in} / {out} for the paths, input size, input name,
#  whether the input is first host-encoded)
CASES = [
    ("encode default", ["encode", "{in}"], 4096, "data.bin", False),
    ("encode q0", ["encode", "-q", "0", "{in}"], 4096, "data.bin", False),
    ("encode q1", ["encode", "-q", "1", "{in}"], 4096, "data.bin", False),
    ("encode q5", ["encode", "-q", "5", "{in}"], 4096, "data.bin", False),
    ("encode q9", ["encode", "--quality", "9", "{in}"], 4096, "data.bin",
     False),
    ("encode lgwin 16", ["encode", "-q", "5", "--lgwin", "16", "{in}"],
     4096, "data.bin", False),
    ("encode mode 1", ["encode", "-q", "5", "--mode", "1", "{in}"], 4096,
     "data.bin", False),
    ("encode mode 2", ["encode", "-q", "5", "--mode", "2", "{in}"], 4096,
     "data.bin", False),
    ("encode sharded", ["encode", "--sharded", "{in}"], 16384, "data.bin",
     False),
    ("encode empty", ["encode", "{in}"], 0, "empty.bin", False),
    ("encode to outfile", ["encode", "-q", "3", "{in}", "{out}"], 4096,
     "data.bin", False),
    ("decode .br", ["decode", "{in}"], 8192, "data.bin.br", True),
    ("decode other suffix", ["decode", "{in}"], 8192, "data.dat", True),
    ("decode to outfile", ["decode", "{in}", "{out}"], 8192, "data.br",
     True),
    ("decode max size at the size",
     ["decode", "--max-output-size", "8192", "{in}"], 8192, "data.bin.br",
     True),
    ("decode max size below the size",
     ["decode", "--max-output-size", "8191", "{in}"], 8192, "data.bin.br",
     True),
]


def _run(main, argv: list[str], tmp: Path, name: str, data: bytes, capsys):
    """main(argv) in `tmp`: (return code or the exception raised, the
    files tmp holds afterwards, stderr with tmp's path removed)."""
    tmp.mkdir()
    (tmp / name).write_bytes(data)
    args = [a.format(**{"in": str(tmp / name), "out": str(tmp / "out.x")})
            for a in argv]
    capsys.readouterr()
    try:
        rc = main(args)
    except Exception as e:  # noqa: BLE001  (compared between the two sides)
        rc = e
    err = capsys.readouterr().err.replace(str(tmp) + os.sep, "")
    files = {p.name: p.read_bytes() for p in sorted(tmp.iterdir())}
    return rc, files, err


@pytest.mark.parametrize("argv,n,name,compressed",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_cli_matches_jax(argv, n, name, compressed, tmp_path, capsys):
    seed = len(name) + n
    data = _input(n, seed)
    if compressed:
        data = brotli_tpu.encode(data, quality=2)
    ref = _run(ref_cli.main, argv, tmp_path / "jax", name, data, capsys)
    port = _run(port_cli.main, argv, tmp_path / "port", name, data, capsys)
    if isinstance(ref[0], Exception):
        assert isinstance(port[0], Exception), port[0]
        assert type(port[0]).__name__ == type(ref[0]).__name__
        assert str(port[0]) == str(ref[0])
        assert getattr(port[0], "code", None) == getattr(ref[0], "code", None)
    else:
        assert port[0] == ref[0] == 0
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # the case did what it names: a new file beside the input, or none
    # where the CLI raised
    assert len(ref[1]) == (1 if isinstance(ref[0], Exception) else 2)
    if compressed and not isinstance(ref[0], Exception):
        out = next(v for k, v in port[1].items() if k != name)
        assert out == _input(n, seed)


def test_top_level_names_match_jax():
    """Every name the JAX package exports, the port exports; the codec
    functions give equal results on one input."""
    missing = sorted(set(brotli_tpu.__all__) - set(brotli_tpu_torch.__all__))
    assert not missing, missing
    for name in brotli_tpu_torch.__all__:
        assert hasattr(brotli_tpu_torch, name), name
    assert brotli_tpu_torch.__version__ == brotli_tpu.__version__
    data = _input(6000, 7)
    for quality in (4, 11):
        stream = brotli_tpu_torch.encode(data, quality=quality)
        assert stream == brotli_tpu.encode(data, quality=quality)
        assert brotli_tpu_torch.decode(stream) == brotli_tpu.decode(stream) \
            == data
        assert brotli_tpu_torch.decoded_size(stream) \
            == brotli_tpu.decoded_size(stream)
    one = brotli_tpu_torch.encode(data, quality=1)
    assert brotli_tpu_torch.decoded_size(one) == brotli_tpu.decoded_size(one)
    assert brotli_tpu_torch.decoded_size(b"") == brotli_tpu.decoded_size(b"")
    kw = dict(quality=5, first=True, last=False)
    assert brotli_tpu_torch.encode_fragment(data, **kw) \
        == brotli_tpu.encode_fragment(data, **kw)
    spliced = brotli_tpu_torch.encode_sharded_concat(data, chunk_size=2048)
    assert spliced == brotli_tpu.encode_sharded_concat(data, chunk_size=2048)
    assert brotli_tpu_torch.decode(spliced) == data
    assert brotli_tpu_torch.decode is brotli_tpu_torch.host_decode
    assert brotli_tpu_torch.encode is brotli_tpu_torch.host_encode


def test_cli_runs_without_the_reference(tmp_path):
    """`python -m brotli_tpu_torch.cli` (the module run as __main__, as -m
    runs it) encodes and decodes files, plain and --sharded, in a process
    that cannot import jax, jaxlib or brotli_tpu, and imports neither."""
    code = textwrap.dedent("""
        import importlib.abc, json, runpy, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "jaxlib", "brotli_tpu") or name.startswith(
                        ("jax.", "jaxlib.", "brotli_tpu.")):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        for argv in json.loads(sys.argv[1]):
            sys.argv = ["brotli_tpu_torch.cli", *argv]
            try:
                runpy.run_module("brotli_tpu_torch.cli", run_name="__main__")
            except SystemExit as e:
                assert e.code == 0, (argv, e.code)
            else:
                raise AssertionError("no SystemExit")
        bad = [m for m in sys.modules if m in ("jax", "brotli_tpu")
               or m.startswith(("jax.", "brotli_tpu."))]
        assert not bad, bad
        print("ok")
    """)
    data = _input(20000, 3)
    src = tmp_path / "data.bin"
    src.write_bytes(data)
    runs = [["encode", "-q", "5", str(src)],
            ["decode", str(src) + ".br", str(tmp_path / "back.bin")],
            ["encode", "--sharded", str(src), str(tmp_path / "s.br")],
            ["decode", str(tmp_path / "s.br")]]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(runs)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
    lines = proc.stderr.strip().splitlines()
    assert lines[-4:] == [
        f"20000 -> {(tmp_path / 'data.bin.br').stat().st_size} bytes "
        f"({src}.br)",
        f"{(tmp_path / 'data.bin.br').stat().st_size} -> 20000 bytes "
        f"({tmp_path / 'back.bin'})",
        f"20000 -> {(tmp_path / 's.br').stat().st_size} bytes "
        f"({tmp_path / 's.br'})",
        f"{(tmp_path / 's.br').stat().st_size} -> 20000 bytes "
        f"({tmp_path / 's'})"], proc.stderr
    assert (tmp_path / "back.bin").read_bytes() == data
    assert (tmp_path / "s").read_bytes() == data
    assert (tmp_path / "data.bin.br").read_bytes() \
        == brotli_tpu.encode(data, quality=5)
    assert (tmp_path / "s.br").read_bytes() \
        == brotli_tpu.encode_sharded_concat(data)
