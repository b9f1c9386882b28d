"""The greedy parse of the port (brotli_tpu_torch.ops.device_encode
.greedy_parse) against the JAX function (brotli_tpu.ops.device_encode
.greedy_parse, an XLA scan), on the CPU.

Four versions meet here: JAX, the plain PyTorch loop `greedy_parse_ref`,
and both kernels' per-lane code in csrc/parse.cuh built for the CPU by g++:
parse_kernel's tile phases (`greedy_parse_host`, the block's threads as
loops, at the card's tile of 1,024 positions and at tiles of 32-256, so
copies cross many tiles) and the first kernel's window walk
(`direct=True`, its warp as a loop).  Tolerance: exact equality of all
outputs (is_cs, is_lit, dcode_short).  Inputs: the matches the JAX match
finder gives on the 8-lane batch of test_torch_encode_stages.py (N = 1024:
text, a zero run, periodic, random, high bytes, a 777-byte tail, an empty
lane), then hand-made lanes, made with numpy from a seed.  JAX runs once a
knob set (module fixture `jax_parse`): its scan takes most of the file's
time.  The collapsed ring (parse_kernel's short codes as a prefix count of
pushes) is held against parse_copy's ring on seeded copy lists.
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
# host tiles and speculation segments below the card's PARSE_TILE and
# PARSE_SEG
TILES = [(32, 32), (96, 32), (256, 64), (1024, 32)]
I32_MAX = 2**31 - 1


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


def _edge_lanes():
    """(mlen, mdist, n_valid) of lanes for the tile form's edges, (8, N)
    and (8,) int32 (tiles of 32 cut them every 32 positions):

    0. a copy at 500 whose end wraps past int32 (frees every later
       position), then copies at 600 and 800;
    1. a copy at 100 whose end lies just below 2^31: it covers the rest of
       the lane, across every later tile;
    2. a copy over seven 32-position tiles (5 + 200), a copy from a tile's
       first position to the next tile's first (256 + 64), one from there,
       one from a tile's last position (383) into the next;
    3. copies whose mdist is 0 or negative, between copies at 4 and 11;
    4. a take at every position, length 4, distances from a small set:
       copy starts every 4 positions, ring hits at every k;
    5. n_valid past N (every position in the chunk), random copies;
    6. n_valid below 0: nothing taken, no literal;
    7. a copy that runs past the lane's end, after literals.
    """
    rng = np.random.default_rng(31)
    mlen = np.zeros((8, N), np.int32)
    mdist = np.zeros((8, N), np.int32)
    nv = np.full(8, N, np.int32)

    mlen[0, 10], mdist[0, 10] = 40, 3
    mlen[0, 500], mdist[0, 500] = I32_MAX - 300, 2   # 500 + len wraps
    for p in (600, 800):
        mlen[0, p], mdist[0, p] = 50, 9

    mlen[1, 100], mdist[1, 100] = I32_MAX - 1000, 1  # ends below 2^31

    for p, ln in ((5, 200), (256, 64), (320, 30), (383, 10)):
        mlen[2, p], mdist[2, p] = ln, 6

    for k, d in enumerate((4, 0, 11, -5, 11, 0, 4)):
        mlen[3, 40 + 30 * k], mdist[3, 40 + 30 * k] = 10, d

    mlen[4] = 4
    mdist[4] = rng.choice(np.array([4, 11, 15, 16, 5, 7], np.int32), N)

    live = rng.random(N) < 0.4
    mlen[5] = np.where(live, rng.integers(4, 40, N), 0)
    mdist[5] = np.where(live, rng.integers(1, 20, N), 0)
    nv[5] = 5000

    mlen[6, 50:60], mdist[6, 50:60] = 8, 2
    nv[6] = -3

    mlen[7, N - 20], mdist[7, N - 20] = 100, 7
    return mlen, mdist, nv


@pytest.fixture(scope="module")
def inputs():
    """The encoder batch's JAX matches, then the hand-made lanes and the
    tile edge lanes: (24, N)."""
    jnp = pytest.importorskip("jax.numpy")
    arr, nv = _batch()
    ml, md = JE.find_matches(jnp.asarray(arr), jnp.asarray(nv))
    hl, hd, hn = _hand_lanes()
    el, ed, en = _edge_lanes()
    return (np.concatenate([np.asarray(ml), hl, el]),
            np.concatenate([np.asarray(md), hd, ed]),
            np.concatenate([nv, hn, en]))


@pytest.fixture(scope="module")
def jax_parse(inputs):
    """JAX's greedy_parse of `inputs` at a knob set, computed once."""
    jnp = pytest.importorskip("jax.numpy")
    mlen, mdist, nv = inputs
    done = {}

    def get(lazy, min_gate):
        if (lazy, min_gate) not in done:
            done[lazy, min_gate] = [np.asarray(x) for x in JE.greedy_parse(
                jnp.asarray(mlen), jnp.asarray(mdist), jnp.asarray(nv),
                lazy, min_gate)]
        return done[lazy, min_gate]
    return get


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")


@pytest.mark.parametrize("lazy,min_gate", KNOBS)
def test_parse_matches_jax(inputs, jax_parse, lazy, min_gate):
    """JAX == greedy_parse_ref == parse_kernel's phases built for the host
    (the card's tile)."""
    _need_gxx()
    mlen, mdist, nv = inputs
    want = jax_parse(lazy, min_gate)
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


@pytest.mark.parametrize("tile,seg", TILES)
@pytest.mark.parametrize("lazy,min_gate", KNOBS)
def test_parse_tiles_match_jax(inputs, jax_parse, lazy, min_gate, tile, seg):
    """parse_kernel's phases in tiles of 32-256 positions and speculation
    segments of 32-128 == JAX: copies that start, end or wrap in other
    tiles and segments than their own, frontiers that skip whole tiles,
    the lane's path entering a segment's speculative path midway or
    stepping beside it."""
    _need_gxx()
    mlen, mdist, nv = inputs
    got = TE.greedy_parse_host(_t(mlen), _t(mdist), _t(nv), lazy, min_gate,
                               tile=tile, seg=seg)
    for a, b in zip(jax_parse(lazy, min_gate), got):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("lazy,min_gate", KNOBS)
def test_parse_direct_walk_matches_plain(inputs, jax_parse, lazy, min_gate):
    """The first kernel's window walk (greedy_parse_direct's per-lane code)
    == greedy_parse_ref == JAX."""
    _need_gxx()
    mlen, mdist, nv = inputs
    args = (_t(mlen), _t(mdist), _t(nv), lazy, min_gate)
    got = TE.greedy_parse_host(*args, direct=True)
    for a, b, c in zip(jax_parse(lazy, min_gate), TE.greedy_parse_ref(*args),
                       got):
        np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(a, c.numpy())


def test_parse_edge_lanes_reach_their_cases(inputs, jax_parse):
    """The tile edge lanes (rows 16-23) do what they were made for, in
    JAX's output."""
    is_cs, is_lit, dc = (x[16:] for x in jax_parse((105, 175), 9))
    # 0: the wrapped end frees everything after 500
    assert is_cs[0, 500] and is_lit[0, 501:600].all() and is_cs[0, 600]
    # 1: the copy at 100 covers the rest of the lane
    assert is_cs[1, 100] and not (is_cs[1, 101:] | is_lit[1, 101:]).any()
    # 2: copies from a tile's first and last positions
    assert is_cs[2, [5, 256, 320, 383]].all() and is_cs[2].sum() == 4
    # 3: mdist <= 0 at copy starts: code -1 (and pushed)
    starts = np.flatnonzero(is_cs[3])
    assert len(starts) == 7 and (dc[3, starts[[1, 3, 5]]] == -1).all()
    # 4: a copy every 4 positions, codes 0-3 and -1
    assert is_cs[4, ::4].all() and not is_cs[4, 1::4].any()
    assert set(np.unique(dc[4][is_cs[4]])) == {-1, 0, 1, 2, 3}
    # 5-7: n_valid past N, below 0; a copy past the lane's end
    assert is_lit[5].any() and is_cs[5].any()
    assert not (is_cs[6] | is_lit[6]).any()
    assert is_cs[7, N - 20] and not is_lit[7, N - 19:].any()


@pytest.mark.parametrize("n", [1, 67, 999, 2050])
def test_parse_tiles_odd_lengths(n):
    """Lanes whose length is no multiple of 4, 32 or the tile (the tail
    tile, the look-ahead past the lane's end), parse_kernel's phases at the
    card's tile and at 32 == the direct walk == greedy_parse_ref."""
    _need_gxx()
    rng = np.random.default_rng(n)
    live = rng.random((3, n)) < 0.5
    mlen = np.where(live, rng.integers(4, 90, (3, n)), 0).astype(np.int32)
    mdist = np.where(live, rng.integers(1, 12, (3, n)), 0).astype(np.int32)
    mlen[1, -1] = 50                       # a strong match at the last position
    nv = np.array([n, n // 2, n + 7], np.int32)
    args = (_t(mlen), _t(mdist), _t(nv))
    want = TE.greedy_parse_ref(*args)
    for got in (TE.greedy_parse_host(*args),
                TE.greedy_parse_host(*args, tile=32, seg=32),
                TE.greedy_parse_host(*args, direct=True)):
        for a, b in zip(want, got):
            assert torch.equal(a, b)


def _copy_lists():
    """Seeded copy distance lists: repeats of the last distance (code 0, no
    push), the initial ring's distances, distances <= 0, and ring hits at
    every depth."""
    rng = np.random.default_rng(17)
    small = rng.choice(np.array([4, 11, 15, 16, 4, 4, 7, 9], np.int32), 3000)
    mixed = rng.choice(np.array([-2, 0, 1, 3, 3, 3, 5, 8, 13, 21, 1 << 16],
                                np.int32), 3000)
    # each distance again after 0-4 others: hits at k = 0..3 and misses
    cyc = np.concatenate([np.roll(np.arange(1, 6, dtype=np.int32), -k)[:j + 1]
                          for k, j in zip(rng.integers(0, 5, 600),
                                          rng.integers(0, 5, 600))])
    return {"small": small, "mixed": mixed, "cycles": cyc,
            "empty": np.zeros(0, np.int32)}


@pytest.mark.parametrize("name", ["small", "mixed", "cycles", "empty"])
def test_parse_collapsed_ring_matches_parse_copy(name):
    """parse_kernel's short codes (a prefix count of pushes, the ring the
    last four pushed distances) == parse_copy's ring stepped copy by copy,
    at the card's tile and chunk (a copy a thread), and at tiles and
    chunks of 1-50 copies,
    where the ring is carried between tiles and the count between chunks."""
    _need_gxx()
    dist = _copy_lists()[name]
    want = TE.parse_ring_host(dist, collapsed=False)
    for tile_copies, threads in ((TE.PARSE_TILE, TE.PARSE_THREADS), (1, 1),
                                 (7, 3), (50, 32)):
        got = TE.parse_ring_host(dist, collapsed=True,
                                 tile_copies=tile_copies, threads=threads)
        np.testing.assert_array_equal(want, got)
    if name == "cycles":
        assert set(np.unique(want)) == {-1, 0, 1, 2, 3}
    if name == "mixed":
        assert (want[dist <= 0] == -1).all()


def test_parse_layout_matches_header():
    """PARSE_TILE, PARSE_SEG and PARSE_THREADS are csrc/parse.cuh's; the
    host form refuses a tile that is no multiple of 32 or above PARSE_TILE,
    and a segment that is no power of two from 32 up to the tile."""
    src = (ROOT / "brotli_tpu_torch" / "csrc" / "parse.cuh").read_text()
    for name in ("PARSE_TILE", "PARSE_THREADS"):
        assert f"constexpr int {name} = {getattr(TE, name)};" in src
    log = TE.PARSE_SEG.bit_length() - 1
    assert TE.PARSE_SEG == 1 << log
    assert f"constexpr int PARSE_SEG_LOG = {log};" in src
    _need_gxx()
    z = torch.zeros((1, 64), dtype=torch.int32)
    nv = torch.tensor([64], dtype=torch.int32)
    for tile, seg in ((48, 32), (2 * TE.PARSE_TILE, 32), (0, 32), (64, 48),
                      (64, 128), (64, 0)):
        with pytest.raises(ValueError, match="host shim"):
            TE.greedy_parse_host(z, z, nv, tile=tile, seg=seg)


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
