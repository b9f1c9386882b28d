"""The greedy parse of the port (brotli_tpu_torch.ops.device_encode
.greedy_parse) against the JAX function (brotli_tpu.ops.device_encode
.greedy_parse, an XLA scan), on the CPU.

Three versions meet here: JAX, the plain PyTorch loop `greedy_parse_ref`,
and the window walk of csrc/parse.cuh built for the CPU by g++ (the code
the CUDA kernel runs, with its warp as a loop).  Tolerance: exact equality
of all three outputs (is_cs, is_lit, dcode_short).  Inputs: the matches the
JAX match finder gives on the 8-lane batch of test_torch_encode_stages.py
(N = 1024: text, a zero run, periodic, random, high bytes, a 777-byte tail,
an empty lane), then hand-made lanes, made with numpy from a seed.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from brotli_tpu.ops import device_encode as JE
from brotli_tpu_torch.ops import device_encode as TE

ROOT = Path(__file__).resolve().parents[1]
N = 1024
KNOBS = [((105, 175), 9), ((60, 120), 12)]


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _batch():
    """test_torch_encode_stages._batch, built here too because that module
    skips where JAX is missing, as on the machine with the card: (data
    (8, N+12) uint8, n_valid (8,) int32) as numpy."""
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


def _hand_lanes():
    """(mlen, mdist, n_valid) of hand-made lanes, (8, N) and (8,) int32:

    0. all literals (no match anywhere);
    1. copies that end exactly at n_valid, and one that runs past it, then
       strong matches past n_valid (never taken);
    2. copies at the distances of the initial ring (4, 11, 15, 16), then
       repeats of pushed distances: short codes 0-3;
    3. strong matches at the lane's last positions, whose look-ahead reads
       past the end (scores 0 there), and a copy the next two beat;
    4. random lengths 4-70 at random distances 1-24 on 60% of positions:
       copies across window edges and frequent ring hits;
    5. one copy from position 0 over the whole lane;
    6. copies ending exactly on window edges (32, 64, ...);
    7. far weak matches (distance 2^12-2^14, length 4-6): the gate.
    """
    rng = np.random.default_rng(23)
    mlen = np.zeros((8, N), np.int32)
    mdist = np.zeros((8, N), np.int32)
    nv = np.full(8, N, np.int32)

    nv[1] = 700
    for p, ln in ((10, 20), (100, 40), (680, 20), (690, 30)):
        mlen[1, p], mdist[1, p] = ln, 7
    mlen[1, 650], mdist[1, 650] = 50, 3        # 650 + 50 = 700 = n_valid
    mlen[1, 702:760:5], mdist[1, 702:760:5] = 12, 5

    seq = [4, 11, 15, 16, 4, 9, 9, 4, 11, 9, 16, 15, 7, 7, 3, 9, 4, 100]
    for k, d in enumerate(seq):
        mlen[2, 8 + 20 * k], mdist[2, 8 + 20 * k] = 6, d

    mlen[3, N - 2:], mdist[3, N - 2:] = 4, 1
    mlen[3, N - 12], mdist[3, N - 12] = 4, 1
    mlen[3, N - 11], mdist[3, N - 11] = 9, 1   # beats N-12 by 675 >= 105
    mlen[3, N - 40], mdist[3, N - 40] = 5, 2

    live = rng.random(N) < 0.6
    mlen[4] = np.where(live, rng.integers(4, 71, N), 0)
    mdist[4] = np.where(live, rng.integers(1, 25, N), 0)
    nv[4] = 1000

    mlen[5, 0], mdist[5, 0] = N, 1

    for p in range(0, N, 64):
        mlen[6, p], mdist[6, p] = 32 if p % 128 else 64, 11

    far = rng.random(N) < 0.3
    mlen[7] = np.where(far, rng.integers(4, 7, N), 0)
    mdist[7] = np.where(far, rng.integers(1 << 12, 1 << 14, N), 0)
    return mlen, mdist, nv


@pytest.fixture(scope="module")
def inputs():
    """The encoder batch's JAX matches, then the hand-made lanes: (16, N)."""
    jnp = pytest.importorskip("jax.numpy")
    arr, nv = _batch()
    ml, md = JE.find_matches(jnp.asarray(arr), jnp.asarray(nv))
    hl, hd, hn = _hand_lanes()
    return (np.concatenate([np.asarray(ml), hl]),
            np.concatenate([np.asarray(md), hd]),
            np.concatenate([nv, hn]))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lazy,min_gate", KNOBS)
def test_parse_matches_jax(inputs, lazy, min_gate):
    """JAX == greedy_parse_ref == the host build of csrc/parse.cuh."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    jnp = pytest.importorskip("jax.numpy")
    mlen, mdist, nv = inputs
    want = [np.asarray(x) for x in JE.greedy_parse(
        jnp.asarray(mlen), jnp.asarray(mdist), jnp.asarray(nv), lazy,
        min_gate)]
    args = (_t(mlen), _t(mdist), _t(nv), lazy, min_gate)
    for got in (TE.greedy_parse(*args), TE.greedy_parse_host(*args)):
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a, b.numpy())
    is_cs, is_lit, dc = want
    # the hand lanes reach what they were made for
    assert not is_cs[8].any() and is_lit[8].all()
    assert is_cs[9, 650] and not is_cs[9, 700:].any()
    assert not is_lit[9, 700:].any()
    assert set(np.unique(dc[10][is_cs[10]])) == {-1, 0, 1, 2, 3}
    assert is_cs[11, N - 2] and is_cs[11, N - 11] and is_cs[11, N - 40]
    assert is_lit[11, N - 12] and not is_cs[11, N - 1]
    assert set(np.unique(dc[12][is_cs[12]])) >= {-1, 0, 1, 2}
    assert is_cs[13].sum() == 1 and not is_lit[13].any()
    # every position is a copy start, a literal, inside a copy or past
    # n_valid, and never two of the first two
    assert not (is_cs & is_lit).any()


def test_parse_rejects_bad_tensors(inputs):
    mlen, mdist, nv = (_t(x) for x in inputs)
    with pytest.raises(ValueError, match="mdist"):
        TE.greedy_parse(mlen, mdist.to(torch.int64), nv)
    with pytest.raises(ValueError, match="n_valid"):
        TE.greedy_parse(mlen, mdist, nv[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        TE.greedy_parse(mlen.t().contiguous().t(), mdist, nv)
    with pytest.raises(ValueError, match="mlen"):
        TE.greedy_parse(mlen[0], mdist[0], nv[:1])
    with pytest.raises(ValueError, match="host shim"):
        TE.greedy_parse_host(mlen.to("meta"), mdist.to("meta"), nv.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("lazy,min_gate", KNOBS)
def test_parse_kernel_matches_plain_on_card(lazy, min_gate):
    """The CUDA kernel == greedy_parse_ref on CUDA tensors (needs a card;
    no JAX: the matches come from the port's own match finder)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    arr, nv = _batch()
    hl, hd, hn = _hand_lanes()
    data, n_valid = torch.from_numpy(arr).cuda(), torch.from_numpy(nv).cuda()
    ml, md = TE.find_matches(data, n_valid)
    mlen = torch.cat([ml, torch.from_numpy(hl).cuda()])
    mdist = torch.cat([md, torch.from_numpy(hd).cuda()])
    n_valid = torch.cat([n_valid, torch.from_numpy(hn).cuda()])
    before = TE.PARSE_LAUNCHES
    ker = TE.greedy_parse(mlen, mdist, n_valid, lazy, min_gate)
    assert TE.PARSE_LAUNCHES == before + 1
    ref = TE.greedy_parse_ref(mlen, mdist, n_valid, lazy, min_gate)
    for a, b in zip(ker, ref):
        assert torch.equal(a.cpu(), b.cpu())
