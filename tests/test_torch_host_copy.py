"""The port's own copy of the host codec against the JAX package's
original, and the port's independence from it.

brotli_tpu_torch keeps copies of brotli_tpu's constants, data, decode/,
encode/, native/ and parallel/shard.py, and of the numpy host halves of the
ops modules (ops/preflight2.py, ops/preflight3.py, ops/encode_host.py).
Each side here runs its own code on the same inputs, made in this file
from a numpy seed: no staged batch of one package goes into the other.

Tolerance: exact equality of streams, decoded bytes, error codes, staged
arrays and tables.
"""

import dataclasses
import os
from pathlib import Path
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import brotli_tpu
import brotli_tpu_torch
from brotli_tpu.encode.api import Encoder as RefEncoder
from brotli_tpu.encode.sharded import encode_sharded as ref_encode_sharded
from brotli_tpu.ops import device_decode as DD
from brotli_tpu.ops import device_encode as JE
from brotli_tpu.ops import pallas_decode2 as P2
from brotli_tpu.ops import pallas_decode3 as P3
from brotli_tpu.parallel.shard import parallel_encode as ref_parallel_encode
from brotli_tpu_torch.ops import encode_host as TH
from brotli_tpu_torch.ops import preflight2 as T2
from brotli_tpu_torch.ops import preflight3 as T3

ROOT = Path(__file__).resolve().parents[1]
WORDS = ("the of and to in is that for it as with was on be by this are from "
         "at or an which have not but they his her all were when there can "
         "brotli stream window metablock literal distance copy insert tree "
         "Huffman context dictionary transform lane kernel decode encode")


def _corpus(n: int, seed: int = 0) -> bytes:
    """Seeded text with numbers, punctuation and a little binary."""
    rng = np.random.default_rng(seed)
    vocab = WORDS.split()
    out, size = [], 0
    while size < n:
        k = int(rng.integers(4, 14))
        line = " ".join(vocab[i] for i in rng.integers(0, len(vocab), k))
        line += f" {int(rng.integers(0, 10 ** 6))}{'.,;:!?'[int(rng.integers(6))]}\n"
        if rng.random() < 0.05:
            line += rng.integers(0, 256, int(rng.integers(8, 64)),
                                 dtype=np.uint8).tobytes().decode("latin-1")
        out.append(line.encode("latin-1"))
        size += len(out[-1])
    return b"".join(out)[:n]


@pytest.mark.parametrize("quality", range(12))
def test_host_encode_identical(quality):
    data = _corpus(2048, seed=quality)
    port = brotli_tpu_torch.host_encode(data, quality=quality)
    assert port == brotli_tpu.encode(data, quality=quality)
    assert brotli_tpu_torch.host_decode(port) == brotli_tpu.decode(port) \
        == data


def _streams(kind: str, data: bytes):
    """(port streams, reference streams) of one host encoder."""
    if kind == "sharded":
        kw = dict(chunk_size=1024, max_distance=1008)
        return (brotli_tpu_torch.encode_sharded(data, **kw),
                ref_encode_sharded(data, **kw))
    if kind == "streaming q5":
        out = []
        for cls in (brotli_tpu_torch.Encoder, RefEncoder):
            enc = cls(quality=5, lgwin=18)
            enc.params.lgblock = 11
            out.append([b"".join(enc.update(data[i: i + 700])
                                 for i in range(0, len(data), 700))
                        + enc.finish()])
        return out
    kw = dict(quality=5, shard_size=2048, num_workers=1)
    return ([brotli_tpu_torch.parallel_encode(data, **kw)],
            [ref_parallel_encode(data, **kw)])


@pytest.mark.parametrize("kind", ["sharded", "streaming q5", "parallel"])
def test_host_encoders_identical(kind):
    data = _corpus(6144, seed=20)
    port, ref = _streams(kind, data)
    assert port == ref
    got = [brotli_tpu_torch.host_decode(s) for s in port]
    assert got == [brotli_tpu.decode(s) for s in ref]
    assert b"".join(got) == data


@pytest.mark.parametrize("case", ["truncated", "flipped", "garbage",
                                  "max_output_size"])
def test_malformed_stream_same_error(case):
    data = _corpus(3000, seed=30)
    stream = brotli_tpu.encode(data, quality=6)
    kw = {}
    if case == "truncated":
        stream = stream[: len(stream) // 2]
    elif case == "flipped":
        stream = stream[:40] + bytes([stream[40] ^ 0x5A]) + stream[41:]
    elif case == "garbage":
        stream = bytes(np.random.default_rng(31).integers(
            0, 256, 64, dtype=np.uint8))
    else:
        kw = dict(max_output_size=100)
    codes = []
    for decode, err in ((brotli_tpu_torch.host_decode,
                         brotli_tpu_torch.BrotliError),
                        (brotli_tpu.decode, brotli_tpu.BrotliError)):
        try:
            decode(stream, **kw)
            codes.append(None)
        except err as e:
            codes.append(e.code)
    assert codes[0] == codes[1]
    assert codes[0] is not None and codes[0] < 0


def _assert_same(a, b, path="batch"):
    """Field by field: arrays equal in value and dtype, dataclasses and
    containers recursively, scalars equal."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}[{k!r}]")
    else:
        assert a == b, path


def test_preflight_shared_identical():
    data = _corpus(16384, seed=40)
    streams = ref_encode_sharded(data, chunk_size=512, max_distance=496)
    for kw in (dict(), dict(groups=2, rate_sort=True)):
        _assert_same(T2.preflight_shared(streams, **kw),
                     P2.preflight_shared(streams, **kw))
    _assert_same(T2.preflight_many(streams[:4]),
                 DD.preflight_many(streams[:4]))
    _assert_same(T2.preflight(streams[0]), DD.preflight(streams[0]))


def test_preflight_binned_identical():
    a = ref_encode_sharded(_corpus(8192, seed=41), chunk_size=512)
    b = ref_encode_sharded(bytes(range(256)) * 24, chunk_size=512)
    mixed = [s for pair in zip(a, b) for s in pair]
    port, ref = T2.preflight_binned(mixed), P2.preflight_binned(mixed)
    assert port is not None
    _assert_same(port, ref)
    assert T2.lane_overran(port[0], np.arange(port[0].groups * 1024)).tolist() \
        == P2.lane_overran(ref[0], np.arange(ref[0].groups * 1024)).tolist()
    assert T2.MAX_GROUPS == P2.MAX_GROUPS and T2.WIDX_SLACK == P2.WIDX_SLACK


def test_preflight_v3_identical():
    texts = [_corpus(3000, seed=s) for s in (42, 43, 44)]
    streams = ([brotli_tpu.encode(t, quality=q) for t, q in
                zip(texts, (9, 11, 5))]
               + brotli_tpu_torch.encode_device_batch(
                   b"".join(texts)[:4096], device="cpu", chunk_size=1024,
                   lit_ctx_trees=4))
    port, ref = T3.preflight_v3(streams, max_groups=8), \
        P3.preflight_v3(streams, max_groups=8)
    assert port is not None and port.groups >= 2
    _assert_same(port, ref)
    _assert_same(T3._dict_chunks(), P3._dict_chunks())
    _assert_same(T3._transform_tables(), P3._transform_tables())
    _assert_same(T3._context_lut_chunks(), P3._context_lut_chunks())
    _assert_same(T3._build_consts(), P3._build_consts())
    st = T3.preflight_one_v3(streams[0]).st
    assert T3._caps_full_ok(st) == P3._caps_full_ok(st)
    assert T3._compound_flat([b"ab", b"c"]) == P3._compound_flat([b"ab", b"c"])


def test_device_encode_host_steps_identical():
    rng = np.random.default_rng(50)
    lit = rng.integers(0, 40, (2 * 64, 256)) * (rng.random((128, 256)) < 0.3)
    cmd = rng.integers(1, 50, 704)
    dist = rng.integers(1, 50, 64)
    for nt, rows in ((1, 64), (4, 64), (4, 128)):
        port = TH._group_tables_from_hists(lit[:rows], cmd, dist, nt)
        ref = JE._group_tables_from_hists(lit[:rows], cmd, dist, nt)
        _assert_same(port, ref, f"tables nt={nt}")
        _assert_same(TH._pack_symbol_table(port, nt),
                     JE._pack_symbol_table(ref, nt))
    tables = TH._group_tables_from_hists(lit[:64], cmd, dist, 4)
    tables["mode"] = 2
    assert TH._header_bits(1000, 18, tables).finish() \
        == JE._header_bits(1000, 18, tables).finish()
    # lanes of records: kind (bits 28-31) and a literal byte
    kinds = rng.choice([TH.K_LIT, TH.K_CMD, TH.K_DIST], (64, 128))
    rec0 = ((kinds << 28) | rng.integers(0, 256, (64, 128))).astype(np.int64)
    _assert_same(TH._cluster_lanes(rec0, 3, 60),
                 JE._cluster_lanes(rec0, 3, 60))
    seg_type = rng.integers(0, 3, (64, 16))
    seg_cnt = rng.integers(0, 3000, (64, 16))
    group_of = rng.integers(0, 2, 64)
    port = TH._plan_block_switches(seg_type, seg_cnt, 60, group_of, 2, 3)
    _assert_same(port, JE._plan_block_switches(seg_type, seg_cnt, 60,
                                               group_of, 2, 3))
    split = dict(nbt=3, first_blen=int(port[1][0]), t0=int(port[2][0]),
                 **port[3][0])
    tables["cmap"] = np.tile(tables["cmap"], 3)
    assert TH._header_bits(4096, 22, tables, split).finish() \
        == JE._header_bits(4096, 22, tables, split).finish()
    flat = rng.integers(0, 9, 2 * TH._hg(3) + 1)
    _assert_same(TH._split_group_hist(flat, 1, 3),
                 JE._split_group_hist(flat, 1, 3))
    _assert_same(TH._pack_consts(), JE._pack_consts())
    for name in ("B_LANES", "CHUNK_N", "MATCH_CAP", "MAX_LEN", "CELL",
                 "HASH_MUL", "K_PAD", "K_CMD", "K_LIT", "K_DIST", "PACK_BR",
                 "DIST_ALPHABET", "_HIST_STRIDE_DEFAULT"):
        assert getattr(TH, name) == getattr(JE, name), name
    assert TH._tab_chunks(5) == JE._tab_chunks(5)


def test_port_runs_without_the_reference():
    """A process that cannot import jax or brotli_tpu runs a CPU round trip
    through the port (device encode -> v2 decode, v3 decode, the host codec,
    parallel_encode's worker processes) and ends with neither imported."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "jaxlib", "brotli_tpu") or name.startswith(
                        ("jax.", "jaxlib.", "brotli_tpu.")):
                    raise ImportError("blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import brotli_tpu_torch as T
        from brotli_tpu_torch.native import get_lib

        data = open("brotli_tpu/decode/engine.py", "rb").read()[:4096]
        s = T.encode_device_batch(data, device="cpu", chunk_size=1024)
        assert b"".join(T.decode_batch_device_e2e(s, device="cpu")) == data
        s3 = T.encode_device_batch(data, device="cpu", chunk_size=1024,
                                   lit_ctx_trees=4)
        assert b"".join(T.decode_batch_v3(s3, device="cpu")) == data
        assert T.fallback_stats()["lanes_fallback"] == 0
        p = T.parallel_encode(data, quality=5, shard_size=1024, num_workers=2)
        assert T.host_decode(p) == data
        assert "brotli_tpu_torch/build/" in get_lib()._name
        bad = [m for m in sys.modules if m in ("jax", "brotli_tpu")
               or m.startswith(("jax.", "brotli_tpu."))]
        assert not bad, bad
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_no_reference_import_in_sources():
    """No file of the port, and not chip_smoke.py, imports brotli_tpu or
    jax."""
    pattern = re.compile(
        r"^\s*(from\s+(brotli_tpu|jax)(\.|\s)|import\s+(brotli_tpu|jax)\b"
        r"(?!_torch))", re.M)
    files = sorted((ROOT / "brotli_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 40
    hits = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
            for f in files for m in pattern.finditer(f.read_text())]
    assert not hits, hits
