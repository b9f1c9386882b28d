"""LZ resolve of the PyTorch port (brotli_tpu_torch.ops.resolve) against the
JAX resolve kernel (brotli_tpu.ops.pallas_resolve, interpret mode) and the
native host resolver (brotli_tpu.native.lz_resolve_batch_v2).

Tolerance: exact equality of bytes and flags.  One difference is by design:
the JAX kernel keeps history in a ring of H bytes and flags copies further
back than H-16 (ERR_FAR_DIST); the port has no ring, so it decodes those
lanes, and their bytes must equal the host resolver's.

The corpus is built here (hand tokens, in-repo text, numpy-seeded token
streams); the JAX results are computed once per module.
"""

from pathlib import Path
import shutil

import numpy as np
import pytest
import torch

from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu.native import lz_resolve_batch_v2
from brotli_tpu.ops import pallas_decode2 as P2
from brotli_tpu.ops import pallas_resolve as PR
from brotli_tpu_torch.ops import decode2 as D
from brotli_tpu_torch.ops import resolve as R

ROOT = Path(__file__).resolve().parents[1]


def _lit(*bs):
    t = len(bs) << 24
    for k, b in enumerate(bs):
        t |= b << (8 * k)
    return t


def _fused(length, dist):
    return (3 << 30) | (length << 22) | dist


def _long_copy(length, dist):
    return [(1 << 30) | length, (2 << 30) | dist]


def _hand_lanes():
    """name -> (token column, mlen); the cases of test_pallas_resolve.py."""
    lanes = {
        "lits_and_fused": ([_lit(97, 98, 99), _lit(100), _fused(8, 4)], 12),
        "lits_with_pads": ([_lit(65, 66), 0, 0, _lit(67), 0, _lit(68, 69, 70)], 6),
        "long_form": ([_lit(120, 121), _lit(122), *_long_copy(9, 3)], 12),
        "far": ([_lit(7, 7, 7)] * 120 + [_fused(4, 300)], 364),
        "malformed_tag2": ([_lit(1, 2, 3), (2 << 30) | 2], 10),
    }
    for dist in range(1, 8):
        seed = bytes(range(65, 65 + dist))
        col = [_lit(*seed[i: i + 3]) for i in range(0, dist, 3)]
        lanes[f"dist{dist}"] = (col + [_fused(17, dist)], dist + 17)
    return lanes


def _rows(cols, n_rows):
    """Columns as (n_rows, 8, 128) u32 rows, lane i = column i."""
    toks = np.zeros((n_rows, 8, 128), np.uint32)
    for s, col in enumerate(cols):
        toks[: len(col), s // 128, s % 128] = col
    return toks


@pytest.fixture(scope="module")
def hand():
    """Hand tokens through the JAX kernel (H=256: distance 300 is far)."""
    lanes = _hand_lanes()
    names = list(lanes)
    cols = [lanes[k][0] for k in names]
    mlens = np.zeros(1024, np.int64)
    mlens[: len(names)] = [lanes[k][1] for k in names]
    toks = _rows(cols, 128)
    out, n_rows = PR.resolve_tokens_device(toks, mlens, H=256, DT=16,
                                           interpret=True)
    j_outs, j_errs = PR.unpack_resolved(np.asarray(out), n_rows, mlens)
    return names, toks, mlens, j_outs, j_errs


def _port_resolve(toks, mlens):
    tok, count = D.tokens_from_jax(toks)
    out, err = R.resolve_tokens_device(tok, count, mlens, "cpu")
    return R.unpack_resolved(out, err, mlens)


@pytest.mark.parametrize("name", list(_hand_lanes()))
def test_hand_tokens_match_jax(hand, name):
    names, toks, mlens, j_outs, j_errs = hand
    outs, errs = _port_resolve(toks, mlens)
    i = names.index(name)
    if j_errs[i] & PR.ERR_FAR_DIST:
        # the port has no ring: it decodes, as the host resolver does
        assert errs[i] == 0
        host, lens = lz_resolve_batch_v2(toks.reshape(toks.shape[0], -1),
                                         mlens, 1)
        assert outs[i] == bytes(host[i, : lens[i]])
    else:
        assert errs[i] == j_errs[i]
        if errs[i] == 0:
            assert outs[i] == j_outs[i]


def test_hand_tokens_expected_bytes(hand):
    names, toks, mlens, _, _ = hand
    outs, errs = _port_resolve(toks, mlens)
    got = dict(zip(names, zip(outs, errs)))
    assert got["lits_and_fused"] == (b"abcdabcdabcd", 0)
    assert got["lits_with_pads"] == (b"ABCDEF", 0)
    assert got["long_form"] == (b"xyz" * 4, 0)
    assert got["far"] == (b"\x07" * 364, 0)
    assert got["malformed_tag2"][1] == R.ERR_MALFORMED
    for dist in range(1, 8):
        seed = bytes(range(65, 65 + dist))
        assert got[f"dist{dist}"] == ((seed * 32)[: dist + 17], 0)


def test_tokens_ending_short_of_mlen_starve():
    # kept out of the JAX batch: there a lane that never completes holds
    # back the shared flush frontier, and its neighbours end flagged too
    cols = [[_lit(1, 2), _fused(3, 2)], [_lit(1, 2), (1 << 30) | 5]]
    mlens = np.array([9, 9] + [0] * 1022, np.int64)
    outs, errs = _port_resolve(_rows(cols, 2), mlens)
    assert errs[:2].tolist() == [R.ERR_STARVED] * 2
    assert outs[0][:5] == b"\x01\x02\x01\x02\x01"


def test_distance_outside_output_is_malformed():
    cols = [[_lit(1), _fused(4, 5)], [_lit(1, 2), _fused(3, 0)],
            [_lit(5), *_long_copy(300, 2)]]
    mlens = np.array([5, 5, 301] + [0] * 1021, np.int64)
    outs, errs = _port_resolve(_rows(cols, 4), mlens)
    assert errs[:3].tolist() == [R.ERR_MALFORMED] * 3


def test_bytes_past_mlen_are_dropped():
    """A token that runs past mlen ends the lane at exactly mlen bytes."""
    cols = [[_lit(1, 2, 3)], [_lit(9), _fused(10, 1)]]
    mlens = np.array([2, 4] + [0] * 1022, np.int64)
    outs, errs = _port_resolve(_rows(cols, 2), mlens)
    assert outs[:2] == [b"\x01\x02", b"\x09" * 4]
    assert errs[:2].tolist() == [0, 0]


@pytest.fixture(scope="module")
def kernel_tokens():
    """JAX entropy-kernel tokens of in-repo text (1 KB, 256 B chunks)."""
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    data = src[10000:11024]
    streams = encode_sharded(data, chunk_size=256, max_distance=400)
    batch = P2.preflight_shared(streams)
    tokens, phases = P2.run_batch(batch, interpret=True)
    return data, batch, tokens, phases


def test_port_resolves_jax_kernel_tokens_like_native(kernel_tokens):
    data, batch, tokens, phases = kernel_tokens
    assert (phases.reshape(-1)[: batch.n_streams] == P2.DONE).all()
    expected = np.zeros(P2.NSTREAM, np.int64)
    expected[: batch.n_streams] = batch.mlens[: batch.n_streams]
    host, lens = lz_resolve_batch_v2(tokens.reshape(tokens.shape[0], -1),
                                     expected.copy(), 2)
    outs, errs = _port_resolve(tokens, expected)
    assert not errs.any()
    for i in range(batch.n_streams):
        assert outs[i] == bytes(host[i, : lens[i]])
    assert b"".join(outs[: batch.n_streams]) == data


def _random_token_lanes(seed: int, n_lanes: int = 24):
    """numpy-seeded token columns: literals, fused and long-form copies
    with valid distances, plus lanes broken on purpose (malformed, short)."""
    rng = np.random.default_rng(seed)
    cols, mlens = [], []
    for lane in range(n_lanes):
        col, pos = [], 0
        for _ in range(int(rng.integers(1, 40))):
            kind = rng.integers(0, 3) if pos else 0
            if kind == 0:
                bs = rng.integers(0, 256, int(rng.integers(1, 4))).tolist()
                col.append(_lit(*bs))
                pos += len(bs)
            elif kind == 1:
                n = int(rng.integers(2, 256))
                col.append(_fused(n, int(rng.integers(1, pos + 1))))
                pos += n
            else:
                n = int(rng.integers(2, 600))
                col += _long_copy(n, int(rng.integers(1, pos + 1)))
                pos += n
            if rng.random() < 0.2:
                col.append(0)
        mlen = pos
        if lane % 6 == 4:
            mlen = pos + int(rng.integers(1, 9))        # starved
        elif lane % 6 == 5:
            col.insert(int(rng.integers(0, len(col))), (2 << 30) | 1)
        cols.append(col)
        mlens.append(mlen)
    return cols, np.array(mlens + [0] * (1024 - n_lanes), np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_tokens_match_native(seed):
    cols, mlens = _random_token_lanes(seed)
    toks = _rows(cols, max(map(len, cols)))
    outs, errs = _port_resolve(toks, mlens)
    host, lens = lz_resolve_batch_v2(toks.reshape(toks.shape[0], -1),
                                     mlens.copy(), 1)
    for i in range(len(cols)):
        if errs[i] == 0:
            assert lens[i] == mlens[i]
            assert outs[i] == bytes(host[i, : lens[i]])
        else:
            assert lens[i] == -1
    assert (errs[:len(cols)] != 0).sum() >= len(cols) // 6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_shim_matches_plain(seed):
    """csrc/resolve.cuh built by g++ == the plain PyTorch version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    cols, mlens = _random_token_lanes(seed)
    tok, count = D.tokens_from_jax(_rows(cols, max(map(len, cols))))
    max_mlen = int(mlens.max())
    mlen_t = torch.from_numpy(mlens.astype(np.int32))
    host = R.resolve_tokens_host(tok, count, mlen_t, max_mlen)
    ref = R.resolve_tokens_ref(tok, count, mlen_t, max_mlen)
    for a, b in zip(host, ref):
        assert torch.equal(a, b)


def test_sizes_beyond_the_buffers_are_bounded():
    """A count above the token slots, or an mlen above the output slot,
    never reaches past the buffers: the lane is cut or flagged."""
    tok, count = D.tokens_from_jax(_rows([[_lit(1, 2, 3)], [_lit(4, 5)]], 1))
    count[0] = 50                      # more tokens claimed than stored
    mlen = torch.zeros(1024, dtype=torch.int32)
    mlen[0], mlen[1] = 6, 9            # lane 1 outgrows the 8-byte slot
    impls = [R.resolve_tokens_ref]
    if shutil.which("g++") is not None:
        impls.append(R.resolve_tokens_host)
    for impl in impls:
        out, err = impl(tok, count, mlen, 8)
        assert err[:2].tolist() == [R.ERR_STARVED, R.ERR_MALFORMED]
        assert bytes(out[0, :3].tolist()) == b"\x01\x02\x03"


def test_resolve_rejects_bad_tensors():
    tok = torch.zeros((4, 1024), dtype=torch.int32)
    count = torch.zeros(1024, dtype=torch.int64)
    mlen = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="count"):
        R.resolve_tokens(tok, count, mlen, 0)


@pytest.mark.cuda
def test_resolve_kernel_matches_plain_on_card():
    """The CUDA kernel == the plain version on CUDA tensors (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    cols, mlens = _random_token_lanes(3, n_lanes=200)
    tok, count = D.tokens_from_jax(_rows(cols, max(map(len, cols))))
    dev = torch.device("cuda")
    mlen_t = torch.from_numpy(mlens.astype(np.int32)).to(dev)
    before = R.KERNEL_LAUNCHES
    ker = R.resolve_tokens(tok.to(dev), count.to(dev), mlen_t, int(mlens.max()))
    ref = R.resolve_tokens_ref(tok.to(dev), count.to(dev), mlen_t,
                               int(mlens.max()))
    assert R.KERNEL_LAUNCHES == before + 1
    for a, b in zip(ker, ref):
        assert torch.equal(a.cpu(), b.cpu())
