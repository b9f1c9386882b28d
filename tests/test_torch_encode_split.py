"""The block decompositions of the encoder's record builder and match
finder, on the CPU: the host builds of csrc/records.cuh and
csrc/matches.cuh (g++) run each lane in the order of the block kernels of
csrc/records.cu and csrc/matches.cu, with the split as a parameter, and are
held to the plain PyTorch versions (`build_records_ref`,
`find_matches_ref`).

Records: `build_records_host(..., segments=S)` cuts a lane into tiles of S
runs of REC_ITEMS (8) positions, where records_kernel has one run a thread
(S = 256); it takes the tiles' maxima of copy ends, then tile by tile from
the top the runs' running maximum, their aggregates of the suffix minima,
the exclusive suffix minimum and each run's rows.  Matches:
`find_matches_host(..., seg=K)` finds the byte runs' ends a segment of K
positions at a time with a suffix minimum over the segments' first stops,
and runs each extension round in tiles of K positions, every read of a
tile before its writes, as match_kernel does with a window of 32 positions
a ballot and a tile of EXT_ITEMS positions a thread.

Tolerance: exact equality of every output.  Inputs: the batches of
tests/test_torch_encode_kernels.py at N = 64, 1000, 2048 and 4096 (1000: a
lane that is no whole number of runs or tiles), and made-up parses whose
copies start on run and tile edges, skip whole segments, or span many;
lanes whose byte runs and 8-byte chains cross segment edges.
"""

import functools

import numpy as np
import pytest
import torch

from brotli_tpu_torch.ops import device_encode as TE
from test_torch_encode_kernels import _args, _records_inputs, _t, batch

SIZES = [64, 1000, 2048, 4096]
SEGMENTS = [1, 2, 3, 8, 32, 256]
SEGS = [1, 2, 3, 8, 32, 16384]
TAIL = TE.MATCH_CAP + 4


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def edge_parse(n: int, seed: int = 3):
    """(data, mlen, mdist, is_cs, is_lit, dcode_short, n_valid) of six
    lanes of made-up parses: copies of 8 back to back from 0 (a copy start
    on every run edge); copies of 5 at every multiple of 24 and 64 (the
    tile edges of 3 and 8 runs a tile); one copy from 5 over all but the
    last 10 positions; copies only in the last 8 positions (every segment
    below them empty); copies on the last position of a tile of 3, 8, 16,
    32 and 256 runs; random copies, each distance code kind (short codes 0-15
    and long ones).  Literals wherever no copy covers a position."""
    rng = np.random.default_rng(seed + n)
    lanes = 6
    cs = np.zeros((lanes, n), bool)
    ml = np.zeros((lanes, n), np.int32)

    def put(lane, starts, lengths):
        end = 0
        for p, L in zip(starts, lengths):
            if p < end or p >= n:
                continue
            cs[lane, p] = True
            ml[lane, p] = min(L, n - p)
            end = p + ml[lane, p]

    put(0, range(0, n, 8), [8] * n)
    put(1, sorted(set(range(0, n, 24)) | set(range(0, n, 64))), [5] * n)
    put(2, [5], [n - 10])
    put(3, [n - 8, n - 3], [4, 4])
    put(4, [23, 63, 127, 255, 2047], [4, 4, 4, 4, 9])
    starts = np.flatnonzero(rng.random(n) < 0.15)
    put(5, starts, rng.integers(4, 40, len(starts)))
    cover = np.zeros((lanes, n), bool)
    for lane, p in zip(*np.nonzero(cs)):
        cover[lane, p: p + ml[lane, p]] = True
    is_lit = ~cover
    mdist = np.where(cs, rng.integers(1, 30000, (lanes, n)), 0).astype(np.int32)
    dshort = np.where(cs, rng.integers(-1, 16, (lanes, n)), -1).astype(np.int32)
    n_valid = np.full(lanes, n, np.int32)
    n_valid[5] = n - 2
    data = batch(n, seed=seed)[0][:lanes]
    return (_t(data), _t(ml), _t(mdist), _t(cs), _t(is_lit), _t(dshort),
            _t(n_valid))


@functools.cache
def _records_case(n: int, which: str, lit_ctx: bool):
    ins = _records_inputs(n) if which == "batch" else edge_parse(n)
    return ins, TE.build_records_ref(*ins, lit_ctx=lit_ctx)


@pytest.mark.parametrize("segments", SEGMENTS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("which", ["batch", "edges"])
def test_records_split(which, n, segments):
    """The record kernel's split == build_records_ref, with and without
    literal contexts."""
    for lit_ctx in (False, True):
        ins, ref = _records_case(n, which, lit_ctx)
        _equal(ref, TE.build_records_host(*ins, lit_ctx=lit_ctx,
                                          segments=segments))


def test_records_edges_reach_the_edges():
    """The made-up parses put copy starts where the split has its edges,
    and leave whole tiles without one."""
    _, _, _, cs, _, _, _ = edge_parse(4096)
    cs = cs.numpy()
    assert cs[0, ::8].all()
    assert cs[1, 192] and cs[1, 2048 - 64] and cs[4, [255, 2047]].all()
    assert not cs[3, : 4096 - 8].any()
    assert cs[2].sum() == 1


def cross_batch(n: int, seed: int = 19):
    """(data (5, n+12) uint8, n_valid (5,) int32) whose byte runs and
    8-byte chains cross segment edges: runs of 1-70 random bytes; one byte
    repeated with a break every 33 positions (a run astride every window
    of 32); a 4-byte period from offset 3 broken at random places; an
    8-byte period shifted by 5 (chains at distance 8 that the extension
    rounds grow across tiles); text with a piece repeated at distance 24."""
    rng = np.random.default_rng(seed + n)
    rows = []
    out = bytearray()
    while len(out) < n:
        out += bytes([int(rng.integers(0, 256))]) * int(rng.integers(1, 71))
    rows.append(bytes(out[:n]))
    r1 = bytearray(b"x" * n)
    r1[::33] = b"y" * len(r1[::33])
    rows.append(bytes(r1))
    r2 = bytearray((b"abc" + b"wxyz" * n)[:n])
    for q in rng.integers(0, n, max(1, n // 97)):
        r2[q] = int(rng.integers(0, 256))
    rows.append(bytes(r2))
    rows.append((b"12345" + b"ABCDEFGH" * (n // 8 + 1))[:n])
    piece = rng.integers(32, 127, 24, np.uint8).tobytes()
    rows.append((piece * (n // 24 + 1))[:n])
    arr = np.zeros((len(rows), n + TAIL), np.uint8)
    arr[:, :n] = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, n)
    n_valid = np.full(len(rows), n, np.int32)
    n_valid[2] = n - 7
    return arr, n_valid


MATCH_KNOBS = {"default": {}, "depth4_hash2": dict(chain_depth=4, hash2=True),
               "stride2": dict(hash_stride=2)}


@functools.cache
def _matches_case(n: int, which: str, knobs: str):
    arr, nv = batch(n) if which == "batch" else cross_batch(n)
    data, n_valid = _t(arr), _t(nv)
    args = _args(MATCH_KNOBS[knobs])
    return data, n_valid, args, TE.find_matches_ref(data, n_valid, *args)


@pytest.mark.parametrize("seg", SEGS)
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("which", ["batch", "cross"])
def test_matches_split(which, n, seg):
    """The match kernel's split of the runs and the extension rounds ==
    find_matches_ref, under three knob sets."""
    for knobs in MATCH_KNOBS:
        data, n_valid, args, ref = _matches_case(n, which, knobs)
        _equal(ref, TE.find_matches_host(data, n_valid, *args, seg=seg))


def test_cross_batch_crosses_the_edges():
    """Runs astride the windows of 32 and matches chained by the extension
    rounds past a tile of 16 positions."""
    arr, nv = cross_batch(4096)
    data, n_valid = _t(arr), _t(nv)
    mlen, mdist = (x.numpy() for x in TE.find_matches_ref(data, n_valid))
    p = np.flatnonzero(mdist[1] == 4)
    assert ((p % 32) + mlen[1][p] > 32).any()
    assert (mlen[3] == TE.MAX_LEN).any() and (mdist[3][mlen[3] > 16] == 8).all()
    assert (mlen[4] > 2 * TE.MATCH_CAP).any()


@pytest.mark.cuda
def test_split_inputs_on_card():
    """match_kernel and records_kernel == their plain versions on the
    inputs above, on CUDA tensors, and on 32 KB lanes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    for n in SIZES + [32768]:
        arr, nv = cross_batch(n)
        data, n_valid = _t(arr).cuda(), _t(nv).cuda()
        for kw in MATCH_KNOBS.values():
            got = TE.find_matches(data, n_valid, *_args(kw))
            _equal([x.cpu() for x in got],
                    [x.cpu() for x in TE.find_matches_ref(data, n_valid,
                                                          *_args(kw))])
        ins = [t.cuda() for t in edge_parse(n)]
        for lit_ctx in (False, True):
            got = TE.build_records(*ins, lit_ctx=lit_ctx)
            _equal([x.cpu() for x in got],
                   [x.cpu() for x in TE.build_records_ref(*ins,
                                                          lit_ctx=lit_ctx)])
