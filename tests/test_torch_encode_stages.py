"""Stages of the port's device encoder (brotli_tpu_torch.ops.device_encode)
against the JAX functions of brotli_tpu.ops.device_encode, on the CPU.  The
match finder and the record builder are held in two forms: the plain
PyTorch version and the host build of their CUDA kernels' per-lane code.

Tolerance: exact equality for every stage, the float32 block typing
included (the test batches type every segment as JAX does).  Inputs are
made here with numpy from in-repo text and seeded bytes: text, a long zero
run (matches split at MAX_LEN), periodic data, random bytes, high bytes
(window words with the top bit set, so the hash multiplies wrap), a lane cut
short (a tail chunk whose length is not a multiple of the chunk size) and
an empty lane.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from brotli_tpu.constants import COPY_LENGTH_OFFSET, INSERT_LENGTH_OFFSET
from brotli_tpu.ops import device_encode as JE
from brotli_tpu_torch.ops import device_encode as TE

# JAX is the reference here; the machine with the card has none
jnp = pytest.importorskip("jax.numpy")

ROOT = Path(__file__).resolve().parents[1]
N = 1024


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _batch():
    """(data (8, N+12) uint8, n_valid (8,) int32) as numpy."""
    rng = np.random.default_rng(5)
    rows = [
        _source_text(N),
        bytes(N),
        (b"xyz" * N)[:N],
        rng.integers(0, 256, N, np.uint8).tobytes(),
        rng.integers(192, 256, N, np.uint8).tobytes(),
        _source_text(N, skip=40000),
        bytes(600) + _source_text(N - 600, skip=9000),
        _source_text(N, skip=70000),
    ]
    arr = np.zeros((len(rows), N + JE.MATCH_CAP + 4), np.uint8)
    arr[:, :N] = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, N)
    n_valid = np.full(len(rows), N, np.int32)
    n_valid[5] = 777          # a tail chunk
    n_valid[7] = 0            # an empty lane
    return arr, n_valid


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(jax_out, port_out):
    for a, b in zip(jax_out, port_out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.fixture(scope="module")
def batch():
    return _batch()


@pytest.fixture(scope="module")
def jax_parse(batch):
    """JAX matches and parse at the default knobs."""
    arr, nv = batch
    mlen, mdist = JE.find_matches(jnp.asarray(arr), jnp.asarray(nv))
    parse = JE.greedy_parse(mlen, mdist, jnp.asarray(nv))
    return mlen, mdist, parse


def test_code_helpers():
    rng = np.random.default_rng(1)
    x = rng.integers(0, 40000, (4, 256)).astype(np.int32)
    for table in (INSERT_LENGTH_OFFSET, COPY_LENGTH_OFFSET):
        _same([JE._code_from_offsets(jnp.asarray(x), table)],
              [TE.code_from_offsets(_t(x), table)])
    ins = rng.integers(0, 24, (4, 256)).astype(np.int32)
    cp = rng.integers(0, 24, (4, 256)).astype(np.int32)
    use = rng.integers(0, 2, (4, 256)).astype(bool)
    _same([JE._combine_length_codes(jnp.asarray(ins), jnp.asarray(cp),
                                    jnp.asarray(use))],
          [TE.combine_length_codes(_t(ins), _t(cp), _t(use))])
    v = rng.integers(1, 1 << 22, (4, 256)).astype(np.int32)
    v[0, :23] = 1 << np.arange(23) - (np.arange(23) == 22)
    _same([JE._ilog2(jnp.asarray(v))], [TE.ilog2(_t(v))])


@pytest.mark.parametrize("mode", [2, 3])
def test_literal_context(batch, mode):
    d32 = batch[0][:, :N].astype(np.int32)
    _same([JE._literal_context(jnp.asarray(d32), N, mode)],
          [TE.literal_context(_t(d32), N, mode)])


KNOBS = {
    "default": dict(),
    "depth4_hash2": dict(chain_depth=4, hash2=True),
    "stride2": dict(hash_stride=2),
    "max_distance": dict(max_distance=300),
}


# the port's forms of a stage: the plain PyTorch version (what a CPU
# tensor takes) and the host build of the CUDA kernel's per-lane code; the
# plain form keeps the test ids it had before the kernels
FORMS = {"plain": (TE.find_matches, TE.build_records),
         "host": (TE.find_matches_host, TE.build_records_host)}


def _form_cases(name, params):
    """parametrize(name + ",form", ...) over FORMS x params."""
    cases = [(p, f) for f in FORMS for p in params]
    ids = [str(p) if f == "plain" else f"{f}-{p}" for p, f in cases]
    return pytest.mark.parametrize(f"{name},form", cases, ids=ids)


_JAX_MATCHES = {}


def _jax_matches(arr, nv, name):
    """JAX's matches under KNOBS[name], computed once per knob set."""
    if name not in _JAX_MATCHES:
        kw = KNOBS[name]
        args = (kw.get("hash_stride", 1), kw.get("max_distance"),
                kw.get("chain_depth", 2), kw.get("hash2", False))
        _JAX_MATCHES[name] = (args, JE.find_matches(
            jnp.asarray(arr), jnp.asarray(nv), *args))
    return _JAX_MATCHES[name]


@_form_cases("name", list(KNOBS))
def test_find_matches(batch, name, form):
    arr, nv = batch
    args, j = _jax_matches(arr, nv, name)
    p = FORMS[form][0](_t(arr), _t(nv), *args)
    _same(j, p)
    mlen = p[0].numpy()
    assert mlen.max() == JE.MAX_LEN          # the zero run splits
    assert (mlen[7] == 0).all() and (mlen[5, 777:] == 0).all()


def test_hash_wraps_like_int32():
    """Window words with the top bit set: the int32 multiply wraps and the
    shift is arithmetic, in the hash and in the 7-byte hash."""
    arr = np.full((2, 64 + 12), 0xFF, np.uint8)
    arr[1, ::3] = 0x80
    nv = np.full(2, 64, np.int32)
    for hash2 in (False, True):
        j = JE.find_matches(jnp.asarray(arr), jnp.asarray(nv), hash2=hash2)
        _same(j, TE.find_matches(_t(arr), _t(nv), hash2=hash2))
        _same(j, TE.find_matches_host(_t(arr), _t(nv), hash2=hash2))


@pytest.mark.parametrize("lazy,min_gate", [((105, 175), 9), ((60, 120), 12)])
def test_greedy_parse(batch, lazy, min_gate):
    arr, nv = batch
    mlen, mdist = JE.find_matches(jnp.asarray(arr), jnp.asarray(nv))
    j = JE.greedy_parse(mlen, mdist, jnp.asarray(nv), lazy, min_gate)
    p = TE.greedy_parse(_t(mlen), _t(mdist), _t(nv), lazy, min_gate)
    _same(j, p)
    assert p[0].any() and (p[2].numpy() > 0).any()   # ring hits occur


@_form_cases("lit_ctx", [False, True])
def test_build_records(batch, jax_parse, lit_ctx, form):
    arr, nv = batch
    mlen, mdist, parse = jax_parse
    j = JE.build_records(jnp.asarray(arr), mlen, mdist, *parse,
                         jnp.asarray(nv), lit_ctx=lit_ctx)
    p = FORMS[form][1](_t(arr), _t(mlen), _t(mdist),
                       *[_t(x) for x in parse], _t(nv), lit_ctx=lit_ctx)
    _same(j, p)


@pytest.mark.parametrize("nbt,pseg", [(3, 256), (2, 512)])
def test_segment_stats(batch, jax_parse, nbt, pseg):
    arr, _ = batch
    is_lit = jax_parse[2][1]
    j = JE._segment_stats(jnp.asarray(arr), is_lit, nbt, pseg)
    p = TE.segment_stats(_t(arr), _t(is_lit), nbt, pseg)
    _same(j, p)
    assert len(np.unique(p[0].numpy())) > 1   # more than one type is used


def test_device_stages_flag_first_literals(batch):
    arr, nv = batch
    kw = dict(lit_ctx=True, nbt=3, pseg=256)
    j = JE._device_stages(jnp.asarray(arr), jnp.asarray(nv), **kw)
    p = TE.device_stages(_t(arr), _t(nv), **kw)
    _same(j, p)
    assert ((p[0].numpy() >> 26) & 1).sum() > 0


@pytest.mark.parametrize("nbt", [1, 3])
def test_group_hist(batch, nbt):
    arr, nv = batch
    rec0 = np.asarray(JE._device_stages(jnp.asarray(arr), jnp.asarray(nv),
                                        lit_ctx=True, nbt=nbt, pseg=256)[0])
    grp = np.asarray([0, 1, 1, 0, 1, 0, 0, 1], np.int32)
    signed = np.asarray([0, 0, 1, 1, 0, 1, 0, 0], np.int32)
    stride = 4
    btype = None
    if nbt > 1:
        cols = np.arange(0, rec0.shape[1], stride)
        seg = np.clip((cols - 1) // 256, 0, N // 256 - 1)
        btype = np.random.default_rng(2).integers(0, nbt, (8, N // 256))[:, seg]
        btype = btype.astype(np.int32)
    hist = JE._jitted_group_hist(2, stride, nbt)
    jargs = (jnp.asarray(rec0), jnp.asarray(grp), jnp.asarray(signed))
    j = hist(*jargs, *(() if btype is None else (jnp.asarray(btype),)))
    p = TE.group_hist(_t(rec0), _t(grp), _t(signed), 2, stride, nbt,
                      None if btype is None else _t(btype))
    _same([j], [p])
    assert int(p[:-1].sum()) > 0
