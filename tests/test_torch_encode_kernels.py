"""The encoder's match finder and record builder: the per-lane code of
csrc/matches.cuh and csrc/records.cuh built for the CPU by g++
(`find_matches_host`, `build_records_host`) against the plain PyTorch
versions (`find_matches_ref`, `build_records_ref`), on the CPU; then, on a
card, each CUDA kernel against its plain version.

Tolerance: exact equality of every output.  No JAX here: the plain versions
are held against JAX in tests/test_torch_encode_stages.py.  Inputs are made
with numpy from a seed and from the repo's own sources, at N = 64, 1024,
2048 and 4096:

* source text, and a lane cut short (a tail chunk) and an empty lane;
* a zero run (byte runs past MAX_LEN, split at the cap);
* text with a period of 13 bytes, then of 17, then 13 again: 8-byte
  matches at a fixed distance chained by the extension rounds up to the
  cap, whose distance changes halfway through the lane;
* periods of 4 and 8 bytes (runs and hash matches at the same distance);
* random bytes, and bytes >= 0xC0 and 0xFF runs (window words with the top
  bit set: the int32 hash multiplies wrap);
* hand-made parse inputs for the records: random copies at short
  distances, a copy at the last positions, long inserts.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from brotli_tpu_torch.ops import device_encode as TE

ROOT = Path(__file__).resolve().parents[1]
SIZES = [64, 1024, 2048, 4096]
KNOBS = {
    "default": dict(),
    "depth4_hash2": dict(chain_depth=4, hash2=True),
    "stride2": dict(hash_stride=2),
    "max_distance": dict(max_distance=300),
    "depth1": dict(chain_depth=1),
    "depth4": dict(chain_depth=4),
}
TAIL = TE.MATCH_CAP + 4


def _text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu_torch").rglob("*.py")))
    return (src * (1 + (skip + n) // len(src)))[skip: skip + n]


def _periodic(n: int, periods) -> bytes:
    """Thirds of the lane repeating a text piece of each period in turn."""
    out = b""
    for k, per in enumerate(periods):
        piece = _text(per, skip=1000 * (k + 1))
        m = n // len(periods) if k < len(periods) - 1 else n - len(out)
        out += (piece * (m // per + 1))[:m]
    return out


def batch(n: int, seed: int = 7):
    """(data (10, n+12) uint8, n_valid (10,) int32) as numpy."""
    rng = np.random.default_rng(seed + n)
    rows = [
        _text(n),
        bytes(n),
        _periodic(n, (13, 17, 13)),
        _periodic(n, (4, 8)),
        rng.integers(0, 256, n, np.uint8).tobytes(),
        rng.integers(192, 256, n, np.uint8).tobytes(),
        (b"\xff" * (n // 2) + bytes(rng.integers(128, 256, n, np.uint8)))[:n],
        _text(n, skip=20000),
        _text(n, skip=50000),
        _periodic(n, (3, 29)),
    ]
    arr = np.zeros((len(rows), n + TAIL), np.uint8)
    arr[:, :n] = np.frombuffer(b"".join(rows), np.uint8).reshape(-1, n)
    n_valid = np.full(len(rows), n, np.int32)
    n_valid[7] = n - n // 3 - 5   # a tail chunk
    n_valid[8] = 0                # an empty lane
    return arr, n_valid


def hand_parse_inputs(n: int, seed: int = 11):
    """(mlen, mdist, n_valid) of made-up matches, (6, n) and (6,) int32:
    random copies of 4-70 bytes at distances 1-24 (frequent ring hits),
    copies only in the last eighth (long inserts), one copy at the last
    positions, far distances, one copy over the whole lane, none."""
    rng = np.random.default_rng(seed + n)
    mlen = np.zeros((6, n), np.int32)
    mdist = np.zeros((6, n), np.int32)
    live = rng.random(n) < 0.5
    mlen[0] = np.where(live, rng.integers(4, 71, n), 0)
    mdist[0] = np.where(live, rng.integers(1, 25, n), 0)
    tail = np.arange(n) >= n - n // 8
    mlen[1] = np.where(tail & live, rng.integers(4, 9, n), 0)
    mdist[1] = np.where(tail & live, rng.integers(1, 9, n), 0)
    mlen[2, n - 4], mdist[2, n - 4] = 4, 2
    far = rng.random(n) < 0.2
    mlen[3] = np.where(far, rng.integers(4, 300, n), 0)
    mdist[3] = np.where(far, rng.integers(1, 1 << 15, n), 0)
    mlen[4, 0], mdist[4, 0] = n, 1
    nv = np.full(6, n, np.int32)
    nv[0] = n - 3
    return mlen, mdist, nv


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _args(kw: dict) -> tuple:
    return (kw.get("hash_stride", 1), kw.get("max_distance"),
            kw.get("chain_depth", 2), kw.get("hash2", False))


def _records_inputs(n: int):
    """Record-builder inputs: the batch's matches under two knob sets and
    the hand-made matches, each parsed by the parse kernel's host build."""
    arr, nv = batch(n)
    parts = []
    for kw in (dict(), dict(chain_depth=4, hash2=True)):
        ml, md = TE.find_matches_host(_t(arr), _t(nv), *_args(kw))
        parts.append((arr, ml, md, nv))
    hl, hd, hn = hand_parse_inputs(n)
    harr = batch(n, seed=3)[0][:6]
    parts.append((harr, _t(hl), _t(hd), hn))
    data = _t(np.concatenate([p[0] for p in parts]))
    mlen = torch.cat([p[1] for p in parts])
    mdist = torch.cat([p[2] for p in parts])
    n_valid = _t(np.concatenate([p[3] for p in parts]))
    return (data, mlen, mdist, *TE.greedy_parse_host(mlen, mdist, n_valid),
            n_valid)


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", list(KNOBS))
def test_find_matches_host(n, name):
    arr, nv = batch(n)
    args = _args(KNOBS[name])
    ref = TE.find_matches(_t(arr), _t(nv), *args)   # CPU: the plain version
    host = TE.find_matches_host(_t(arr), _t(nv), *args)
    _equal(ref, host)
    mlen, mdist = (x.numpy() for x in ref)
    assert (mlen[8] == 0).all() and (mlen[7, nv[7]:] == 0).all()
    if n >= 1024:
        # the zero run splits at MAX_LEN; the periodic lane's 8-byte
        # matches chain past a round, at two distances (13 and 17, or 26
        # and 34 where only even positions are hashed)
        assert (mlen[1] == TE.MAX_LEN).any()
        chained = mlen[2] > 2 * TE.MATCH_CAP
        assert len(np.unique(mdist[2][chained])) >= 2
    if n >= 2048:
        # a third of the lane holds chains that reach the cap
        assert (mlen[2] == TE.MAX_LEN).any()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lit_ctx", [False, True])
def test_build_records_host(n, lit_ctx):
    ins = _records_inputs(n)
    ref = TE.build_records(*ins, lit_ctx=lit_ctx)    # CPU: the plain version
    _equal(ref, TE.build_records_host(*ins, lit_ctx=lit_ctx))
    rec0, _, n_rec = (x.numpy() for x in ref)
    kinds = (rec0 >> 28) & 0xF
    assert set(np.unique(kinds)) == {TE.K_PAD, TE.K_CMD, TE.K_LIT, TE.K_DIST}
    assert (n_rec == (kinds != TE.K_PAD).sum(axis=1)).all()
    assert n_rec[8] == 0 and rec0[8, 0] == 0          # the empty lane


def test_matches_reject_bad_input():
    arr, nv = (_t(x) for x in batch(64))
    with pytest.raises(ValueError, match="hash_stride"):
        TE.find_matches(arr, nv, hash_stride=4)
    with pytest.raises(ValueError, match="chain_depth"):
        TE.find_matches(arr, nv, chain_depth=0)
    with pytest.raises(ValueError, match="max_distance"):
        TE.find_matches(arr, nv, max_distance=-1)
    with pytest.raises(ValueError, match="data_u8"):
        TE.find_matches(torch.zeros((2, TE.CHUNK_N + TAIL + 1), dtype=torch.uint8),
                        nv[:2])
    with pytest.raises(ValueError, match="n_valid"):
        TE.find_matches(arr, nv.to(torch.int64))
    with pytest.raises(ValueError, match="contiguous"):
        TE.find_matches_host(arr.t().contiguous().t(), nv)
    with pytest.raises(ValueError, match="host shim"):
        TE.find_matches_host(arr.to("meta"), nv.to("meta"))


def test_records_reject_bad_input():
    ins = list(_records_inputs(64))
    with pytest.raises(ValueError, match="is_cs"):
        TE.build_records(*ins[:3], ins[3].to(torch.int32), *ins[4:])
    with pytest.raises(ValueError, match="n_valid"):
        TE.build_records(*ins[:6], ins[6][:-1])
    with pytest.raises(ValueError, match="data_u8"):
        TE.build_records(ins[0][:, :32].contiguous(), *ins[1:])
    with pytest.raises(ValueError, match="host shim"):
        TE.build_records_host(*(t.to("meta") for t in ins))


def _card_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")


@pytest.mark.cuda
def test_match_kernel_matches_plain_on_card():
    """csrc/matches.cu's match_kernel and match_direct_kernel ==
    find_matches_ref on CUDA tensors, every size and knob set above and 32
    KB lanes."""
    _card_or_skip()
    for n in SIZES + [32768]:
        arr, nv = batch(n)
        data, n_valid = _t(arr).cuda(), _t(nv).cuda()
        for name, kw in KNOBS.items():
            before = TE.MATCH_LAUNCHES, TE.MATCH_DIRECT_LAUNCHES
            ker = TE.find_matches(data, n_valid, *_args(kw))
            direct = TE.find_matches_direct(data, n_valid, *_args(kw))
            assert (TE.MATCH_LAUNCHES, TE.MATCH_DIRECT_LAUNCHES) == (
                before[0] + 1, before[1] + 1)
            ref = TE.find_matches_ref(data, n_valid, *_args(kw))
            _equal(ker, ref)
            _equal(direct, ref)


@pytest.mark.cuda
def test_record_kernel_matches_plain_on_card():
    """csrc/records.cu's records_kernel and records_direct_kernel ==
    build_records_ref on CUDA tensors."""
    _card_or_skip()
    for n in SIZES:
        ins = [t.cuda() for t in _records_inputs(n)]
        for lit_ctx in (False, True):
            before = TE.RECORD_LAUNCHES, TE.RECORD_DIRECT_LAUNCHES
            ker = TE.build_records(*ins, lit_ctx=lit_ctx)
            direct = TE.build_records_direct(*ins, lit_ctx=lit_ctx)
            assert (TE.RECORD_LAUNCHES, TE.RECORD_DIRECT_LAUNCHES) == (
                before[0] + 1, before[1] + 1)
            ref = TE.build_records_ref(*ins, lit_ctx=lit_ctx)
            _equal(ker, ref)
            _equal(direct, ref)
