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
import re
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


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_direct_shim_matches_plain(seed):
    """The direct kernel's per-lane code (resolve.cuh resolve_lane) built by
    g++ == the plain PyTorch version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    cols, mlens = _random_token_lanes(seed)
    tok, count = D.tokens_from_jax(_rows(cols, max(map(len, cols))))
    max_mlen = int(mlens.max())
    mlen_t = torch.from_numpy(mlens.astype(np.int32))
    host = R.resolve_tokens_host(tok, count, mlen_t, max_mlen, direct=True)
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
        impls += [R.resolve_tokens_host,
                  lambda *a: R.resolve_tokens_host(*a, direct=True)]
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


# ---- the warp form (csrc/resolve.cuh resolve_lane_warp) ----
#
# Long lanes built with numpy from a seed: hundreds of tokens a lane, so a
# lane takes many 32-token steps, with tag-1/tag-2 pairs astride a step's
# edge, faults at the first, a middle and the last token of a step, a
# malformed token after mlen is reached, short-distance copies longer than
# a warp, copies longer than 255 bytes, mlen = 0 lanes, a count above the
# token slots and an mlen above the output slot.  The warp form must equal
# resolve_tokens_ref on whole tensors (bytes of flagged lanes and flags
# included) at windows small enough that copies read the slot back, and
# its good lanes the native host resolver's bytes.  Exact equality.

BAD_TAG2 = (2 << 30) | 1            # a tag-2 with nothing pending


def _lane_tokens(rng, n_tok: int, short_dist: bool = False):
    """A valid token column of about n_tok tokens and its byte count."""
    col, pos = [], 0
    while len(col) < n_tok:
        r = rng.random()
        if pos == 0 or r < 0.5:
            bs = rng.integers(0, 256, int(rng.integers(1, 4))).tolist()
            col.append(_lit(*bs))
            pos += len(bs)
        elif r < 0.6 or short_dist:
            n = int(rng.integers(33, 80))           # d < 32, len > 32
            col.append(_fused(n, int(rng.integers(1, min(pos, 31) + 1))))
            pos += n
        elif r < 0.92:
            n = int(rng.integers(0, 40))
            col.append(_fused(n, int(rng.integers(1, pos + 1))))
            pos += n
        else:
            n = int(rng.integers(256, 400))         # tag-1/tag-2 pair
            col += _long_copy(n, int(rng.integers(1, pos + 1)))
            pos += n
        if rng.random() < 0.05:
            col.append(0)
    return col, pos


def _pad_to(col, k, rng):
    """Literals until the column holds k tokens (for a token at index k)."""
    while len(col) < k:
        col.append(_lit(int(rng.integers(0, 256))))
    return col


def _long_lanes(seed: int):
    """name -> (token column, mlen, count or None), numpy-seeded."""
    rng = np.random.default_rng(seed)
    lanes = {}
    for i in range(6):
        col, pos = _lane_tokens(rng, int(rng.integers(200, 400)))
        lanes[f"long{i}"] = (col, pos, None)
    col, pos = _lane_tokens(rng, 300, short_dist=True)
    lanes["short_dist"] = (col, pos, None)
    for edge in (31, 63, 95):                      # tag-1 last in a step
        col = _pad_to([], edge, rng) + _long_copy(int(rng.integers(40, 900)), 7)
        tail, _ = _lane_tokens(rng, 100)
        lanes[f"pair_at_{edge}"] = (col + tail[1:], None, None)
    for at in (32, 48, 63, 64):                    # a fault at a step's
        col = _pad_to([], at, rng) + [BAD_TAG2] + [_lit(1, 2)] * 40
        lanes[f"fault_tag2_at_{at}"] = (col, None, None)
        col = _pad_to([], at, rng) + [_fused(5, 10 ** 6)] + [_lit(1)] * 40
        lanes[f"fault_dist_at_{at}"] = (col, None, None)
    # a tag-2 right after a long tag-2 copy (taken alone at a small window)
    # has nothing pending
    col = _pad_to([], 40, rng) + _long_copy(300, 3) + [BAD_TAG2, _lit(1)]
    lanes["fault_tag2_after_long_copy"] = (col, None, None)
    col, pos = _lane_tokens(rng, 120)
    lanes["malformed_after_mlen"] = (col + [BAD_TAG2, _fused(9, 10 ** 6)],
                                     pos, None)
    lanes["mlen0"] = ([_lit(1, 2, 3)] * 5, 0, None)
    lanes["mlen0_no_tokens"] = ([], 0, None)
    col, pos = _lane_tokens(rng, 150)
    lanes["starved"] = (col, pos + 50, None)
    col, pos = _lane_tokens(rng, 150)
    lanes["count_past_cap"] = (col, pos + 3, 10 ** 6)
    col, pos = _lane_tokens(rng, 60)
    lanes["mlen_past_slot"] = (col, -1, None)       # set to the slot + 1
    col, pos = _lane_tokens(rng, 200)
    lanes["cut_mid_copy"] = (col, pos - 7, None)
    return lanes


def _lane_mlen(col):
    """Bytes a valid column yields (None marks: resolve them all)."""
    pos, pend = 0, 0
    for t in col:
        tag = t >> 30
        if t == 0:
            continue
        if tag == 0:
            pos += (t >> 24) & 3
        elif tag == 1:
            pend = t & 0xFFFFFF
        elif tag == 2:
            pos += pend
            pend = 0
        else:
            pos += (t >> 22) & 0xFF
    return pos


@pytest.fixture(scope="module", params=[0, 1])
def long_lanes(request):
    """The long lanes as the port's tensors (PADs kept: count includes
    them) and as JAX rows for the native resolver."""
    lanes = _long_lanes(request.param)
    names = list(lanes)
    cols = [lanes[k][0] for k in names]
    mlens = np.array([_lane_mlen(c) if m is None else m
                      for c, m, _ in (lanes[k] for k in names)], np.int64)
    faulty = [k for k in names if k.startswith("fault")]
    for k in faulty:                               # ask past the fault
        mlens[names.index(k)] += 100
    slot = int(mlens.max())
    mlens[names.index("mlen_past_slot")] = slot + 1
    cap = max(map(len, cols))
    tok = np.zeros((cap, len(names)), np.uint32)
    for i, c in enumerate(cols):
        tok[: len(c), i] = c
    count = np.array([len(c) if lanes[k][2] is None else lanes[k][2]
                      for k, c in zip(names, cols)], np.int32)
    t = (torch.from_numpy(tok.view(np.int32)), torch.from_numpy(count),
         torch.from_numpy(mlens.astype(np.int32)), slot)
    return names, cols, mlens, t, R.resolve_tokens_ref(*t)


@pytest.mark.parametrize("window", [64, 256, 4096])
def test_warp_form_matches_plain_on_long_lanes(long_lanes, window):
    """The warp form (host shim) == resolve_tokens_ref, whole tensors."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    names, _, _, (tok, count, mlen, slot), ref = long_lanes
    host = R.resolve_tokens_host(tok, count, mlen, slot, window=window)
    assert torch.equal(host[1], ref[1])
    assert torch.equal(host[0], ref[0])
    flags = dict(zip(names, ref[1].tolist()))
    assert flags["mlen_past_slot"] == R.ERR_MALFORMED
    assert not host[0][names.index("mlen_past_slot")].any()
    assert flags["starved"] == R.ERR_STARVED
    assert flags["count_past_cap"] == R.ERR_STARVED
    assert flags["malformed_after_mlen"] == 0
    assert all(flags[k] == R.ERR_MALFORMED for k in names
               if k.startswith("fault"))
    assert all(flags[k] == 0 for k in names
               if k.startswith(("long", "pair", "mlen0", "short", "cut")))


def test_direct_form_matches_plain_on_long_lanes(long_lanes):
    """The direct kernel's per-lane code (host shim) on the same lanes ==
    resolve_tokens_ref, whole tensors."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    _, _, _, (tok, count, mlen, slot), ref = long_lanes
    host = R.resolve_tokens_host(tok, count, mlen, slot, direct=True)
    assert torch.equal(host[1], ref[1])
    assert torch.equal(host[0], ref[0])


def test_warp_form_good_lanes_match_native(long_lanes):
    """Lanes the warp form leaves unflagged hold the native resolver's
    bytes; the flagged ones are flagged there too."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    names, cols, mlens, (tok, count, mlen, slot), _ = long_lanes
    out, err = R.resolve_tokens_host(tok, count, mlen, slot, window=128)
    # the native resolver takes neither a count nor a slot, and flags a
    # lane whose last token runs past mlen (the port drops those bytes)
    keep = [i for i, k in enumerate(names)
            if k not in ("count_past_cap", "mlen_past_slot", "cut_mid_copy")]
    rows = _rows([cols[i] for i in keep], max(map(len, cols)))
    m = np.zeros(1024, np.int64)
    m[: len(keep)] = mlens[keep]
    host, lens = lz_resolve_batch_v2(rows.reshape(rows.shape[0], -1), m, 1)
    for j, i in enumerate(keep):
        if err[i] == 0:
            assert lens[j] == mlens[i]
            assert bytes(out[i, : mlens[i]].tolist()) == bytes(
                host[j, : lens[j]])
        else:
            assert lens[j] == -1


@pytest.mark.parametrize("window", [64, 2048])
def test_warp_form_on_jax_lanes(hand, kernel_tokens, window):
    """The hand lanes and the JAX entropy kernel's tokens through the warp
    form == the plain version (the far lane decodes: no ring)."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    _, toks, mlens, _, _ = hand
    _, batch, tokens, _ = kernel_tokens
    expected = np.zeros(P2.NSTREAM, np.int64)
    expected[: batch.n_streams] = batch.mlens[: batch.n_streams]
    for rows, ml in ((toks, mlens), (tokens, expected)):
        tok, count = D.tokens_from_jax(rows)
        mlen_t = torch.from_numpy(ml.astype(np.int32))
        host = R.resolve_tokens_host(tok, count, mlen_t, int(ml.max()),
                                     window=window)
        ref = R.resolve_tokens_ref(tok, count, mlen_t, int(ml.max()))
        assert torch.equal(host[0], ref[0]) and torch.equal(host[1], ref[1])


def test_launch_config_window():
    """The window: a power of two that fits the SM's shared memory for the
    blocks it holds at once, no larger than a slot needs."""
    # H100: 132 SMs, 233,472 B of shared memory and 2,048 threads an SM
    assert R.launch_config(4096, 8192, 132, 233472, 2048) == 4096
    assert R.launch_config(32768, 8192, 132, 233472, 2048) == 2048
    assert R.launch_config(256, 8192, 132, 233472, 2048) == 8192
    assert R.launch_config(256, 8190, 132, 233472, 2048) == 16384
    assert R.launch_config(1024, 1000, 132, 233472, 2048) == 1024
    assert R.launch_config(8, 0, 132, 233472, 2048) == R.WINDOW_MIN


def test_block_shape_matches_the_cuda_source():
    """launch_config's block shape is the one resolve.cu launches: lanes a
    block, token-ring bytes a lane, the smallest window."""
    src = "".join((ROOT / "brotli_tpu_torch" / "csrc" / f).read_text()
                  for f in ("resolve.cu", "resolve.cuh"))

    def const(name):
        m = re.search(rf"constexpr \w+ {name} = (\d+);", src)
        assert m, f"{name} not found in resolve.cu / resolve.cuh"
        return int(m.group(1))

    assert R.LANES_A_BLOCK == const("RESOLVE_WARPS")
    assert R.TOKQ_BYTES == 4 * const("TOKQ_CHUNKS") * const("WARP")
    assert R.WINDOW_MIN == const("RESOLVE_WIN_MIN")
    assert "RESOLVE_WARPS * ((size_t)win + 4 * TOKQ)" in src


@pytest.mark.cuda
def test_resolve_kernels_match_plain_on_long_lanes(long_lanes, monkeypatch):
    """On the card: resolve_kernel, the direct kernel, and resolve_kernel at
    a 64-byte window (copies read the slot back) == the plain version,
    whole tensors (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    _, _, _, (tok, count, mlen, slot), ref = long_lanes
    dev = torch.device("cuda")
    args = (tok.to(dev), count.to(dev), mlen.to(dev), slot)
    n0, d0 = R.KERNEL_LAUNCHES, R.DIRECT_LAUNCHES
    ker = R.resolve_tokens(*args)
    direct = R.resolve_tokens_direct(*args)
    monkeypatch.setattr(R, "launch_config", lambda *a: R.WINDOW_MIN)
    small = R.resolve_tokens(*args)
    assert (R.KERNEL_LAUNCHES, R.DIRECT_LAUNCHES) == (n0 + 2, d0 + 1)
    for got in (ker, direct, small):
        for a, b in zip(got, ref):
            assert torch.equal(a.cpu(), b.cpu())
