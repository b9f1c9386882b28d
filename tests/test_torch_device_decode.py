"""The port's per-lane-table decode (brotli_tpu_torch/ops/device_decode.py,
csrc/device_decode.cuh) and its sharded driver (parallel/mesh.py
sharded_decode_batch) against the JAX package's brotli_tpu/ops/
device_decode.py and brotli_tpu/parallel/mesh.py, on the CPU.

Tolerance: exact equality.  The plain PyTorch version
(`run_device_batch(..., device="cpu")`) and both kernels' per-lane code
built by g++ (`device_decode_host`: the shared form, at the card's words
ring and window and at rings of 16-64 words and windows of 64-1024 bytes,
and the direct form) must give the JAX kernel's out, pos and err array
for array, on well-formed lanes, on lanes broken by hand (each error
flag, a window too small, a truncated size, a table entry the compact
tables cannot hold), on seeded bit-flipped streams, where reads run past
a lane's words and tables, on rows longer than the window (copies
reaching past it), on a lane whose bit position goes back over words the
ring dropped, and on inserts that run past the row.  The drivers must
give the host decoder's bytes, and raise when the native preflight
cannot load.  Streams come from the port's host encoder on the in-repo
corpus (utils/benchmarks.corpus) and on seeded numpy bytes.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest

import brotli_tpu_torch
from brotli_tpu.ops import device_decode as JD
from brotli_tpu.parallel import mesh as JM
from brotli_tpu_torch import host_decode, host_encode
from brotli_tpu_torch.ops import device_decode as TD
from brotli_tpu_torch.ops.preflight2 import preflight_many
from brotli_tpu_torch.parallel import mesh as TM
from brotli_tpu_torch.utils.benchmarks import corpus


@lru_cache(maxsize=None)
def _lanes() -> tuple[bytes, ...]:
    """12 streams of 1-3 KB, each compressed alone at quality 1-4, an
    all-zeros lane and a byte ramp among them."""
    data = corpus(40000)
    out = [host_encode(data[3000 * i: 3000 * i + 1000 + 197 * i],
                       quality=1 + i % 4) for i in range(10)]
    out.append(host_encode(bytes(2000), quality=1))
    out.append(host_encode(bytes(range(256)) * 4, quality=2))
    return tuple(out)


def _fallbacks() -> int:
    return brotli_tpu_torch.fallback_stats()["lanes_fallback"]


def _shims(port_pre):
    """Both forms of the host shim on `port_pre`: the shared form at the
    card's ring and window, and the direct form."""
    db = TD.stage_batch(port_pre, "cpu")
    return [TD.fetch_outputs(*TD.device_decode_host(db)),
            TD.fetch_outputs(*TD.device_decode_host(db, direct=True))]


def _equal(want, got, rows=slice(None)):
    for w, g in zip(want, got):
        assert g.dtype == np.asarray(w).dtype and g.shape == w.shape
        np.testing.assert_array_equal(g[rows], np.asarray(w)[rows])


def _three_way(jax_pre, port_pre):
    """The JAX kernel's (out, pos, err) on `jax_pre`, and the plain version
    and the host shim's two forms on `port_pre`, each equal to it array
    for array."""
    want = JD.run_device_batch(jax_pre)
    plain = TD.run_device_batch(port_pre, device="cpu")
    for got in [plain] + _shims(port_pre):
        _equal(want, got)
    return want


def _pair(streams):
    """Each stream's preflight by the JAX package's Python parse and by the
    port's native batch parse; both accept the same streams."""
    jpre = [JD.preflight(s) for s in streams]
    tpre = preflight_many(list(streams))
    assert [p is None for p in jpre] == [p is None for p in tpre]
    keep = [i for i, p in enumerate(jpre) if p is not None]
    return [jpre[i] for i in keep], [tpre[i] for i in keep]


def test_wellformed_lanes_equal_jax():
    jpre, tpre = _pair(_lanes())
    assert len(tpre) == 12
    out, pos, err = _three_way(jpre, tpre)
    mlens = np.array([p.mlen for p in tpre])
    # the q4 lanes reference the static dictionary, which round 1 flags
    q4 = np.array([i % 4 == 3 for i in range(10)] + [False, False])
    assert (err == q4).all()
    assert (pos[~err] == mlens[~err]).all()
    for k in np.flatnonzero(~err):
        assert bytes(out[k, : pos[k]]) == host_decode(_lanes()[k])


def _flip(stream: bytes, rng, n_flips: int) -> bytes:
    b = bytearray(stream)
    for bit in rng.choice(8 * (len(b) - 2), n_flips, replace=False) + 16:
        b[bit >> 3] ^= 1 << (bit & 7)
    return bytes(b)


FLIP_SEEDS = (1, 2, 3, 4)


@lru_cache(maxsize=None)
def _flipped_runs():
    """Every seed's bit-flipped lanes in one batch (lanes are independent,
    so one JAX compile and one plain run serve all seeds): the JAX
    kernel's, the plain version's and the shim's (out, pos, err), and each
    seed's lanes in the batch."""
    jpre, tpre, rows, at = [], [], {}, 0
    for seed in FLIP_SEEDS:
        rng = np.random.default_rng(seed)
        streams = [_flip(s, rng, int(rng.integers(1, 4))) for s in _lanes()]
        j, t = _pair(streams)
        jpre += j
        tpre += t
        rows[seed] = slice(at, at + len(t))
        at += len(t)
    want = JD.run_device_batch(jpre)
    plain = TD.run_device_batch(tpre, device="cpu")
    return want, plain, _shims(tpre), rows, tpre


@pytest.mark.parametrize("seed", FLIP_SEEDS)
def test_bitflipped_lanes_equal_jax(seed):
    want, plain, shims, rows, _ = _flipped_runs()
    assert rows[seed].stop - rows[seed].start >= 4
    for got in [plain] + shims:
        _equal(want, got, rows[seed])


def _hand(which: str, p, **kw):
    """A copy of preflight result `p` (the JAX or the port's class)
    changed by `kw`, or its tables changed for `which`."""
    if which == "negative distance":
        off = p.dist_offset.copy()
        off[16:] = -5
        kw["dist_offset"] = off
    return dataclasses.replace(p, **kw)


HAND_CASES = ([("negative distance", {}), ("window", {"max_backward": 1})]
              + [("size", {"mlen": m}) for m in range(3, 120, 7)])


@lru_cache(maxsize=None)
def _hand_lanes():
    """HAND_CASES on the first three lanes, the JAX package's preflight
    results and the port's."""
    jpre, tpre = _pair(_lanes()[:3])
    jb = [_hand(w, jpre[k % 3], **kw) for k, (w, kw) in enumerate(HAND_CASES)]
    tb = [_hand(w, tpre[k % 3], **kw) for k, (w, kw) in enumerate(HAND_CASES)]
    return jb, tb


def test_hand_made_lanes_trip_each_flag():
    """distance < 1 (long-code offsets made negative), distance beyond the
    window (max_backward 1), and sizes cut inside a copy or an insert."""
    jb, tb = _hand_lanes()
    cases = HAND_CASES
    out, pos, err = _three_way(jb, tb)
    assert err[0] and err[1] and pos[0] < jb[0].mlen and pos[1] < jb[1].mlen
    cut = np.array([kw["mlen"] for _, kw in cases[2:]])
    err, pos = err[2:], pos[2:]
    # a copy past the size is flagged where it starts; an insert past it
    # writes its literals (pos beyond the size) and is flagged after
    assert (err & (pos < cut)).any() and (err & (pos > cut)).any()
    assert (pos[~err] == cut[~err]).all()


def test_plain_version_equals_shim_on_long_lanes():
    """Lanes longer than the JAX comparisons': 5 KB at q1-q3, and one
    with its window cut to 16 bytes, so a copy from further back flags."""
    n = 5120
    data = corpus(3 * n)
    streams = [host_encode(data[n * i: n * (i + 1)], quality=1 + i)
               for i in range(3)]
    pre = preflight_many(streams)
    pre.append(dataclasses.replace(pre[0], max_backward=16))
    db = TD.stage_batch(pre, "cpu")
    plain = TD.fetch_outputs(*TD.device_decode_ref(db))
    shim = TD.fetch_outputs(*TD.device_decode_host(db))
    for a, b in zip(plain, shim):
        np.testing.assert_array_equal(a, b)
    out, pos, err = plain
    assert not err[:3].any() and err[3]
    for k in range(3):
        assert bytes(out[k, : pos[k]]) == data[n * k: n * (k + 1)]


def test_decode_batch_device_mixed_batch_falls_back():
    """q0, q5, q11, an empty stream, two metablocks and a q4 stream beside
    eligible ones: every stream's bytes equal the host decoder's, and the
    lanes the preflight refuses or the kernel flags are counted."""
    data = corpus(20000)
    streams = [host_encode(data[:1500], quality=0),
               host_encode(data[1500:3000], quality=5),
               host_encode(data[3000:4000], quality=11),
               host_encode(b"", quality=1),
               brotli_tpu_torch.parallel_encode(data[4000:12000], quality=1,
                                                shard_size=4096),
               host_encode(data[12000:14000], quality=4),
               host_encode(data[14000:16000], quality=1),
               host_encode(data[16000:18000], quality=2)]
    pre = preflight_many(streams)
    lanes = [i for i, p in enumerate(pre) if p is not None]
    assert pre[3] is None and pre[4] is None and 5 in lanes
    flagged = JD.run_device_batch([JD.preflight(streams[i]) for i in lanes])[2]
    f0 = _fallbacks()
    got = brotli_tpu_torch.decode_batch_device(streams, device="cpu")
    assert _fallbacks() - f0 == len(streams) - len(lanes) + int(flagged.sum())
    assert got == JD.decode_batch_device(streams) == [host_decode(s)
                                                      for s in streams]


def test_decode_batch_device_counts_no_fallback_on_eligible_lanes():
    streams = [_lanes()[i] for i in (0, 1, 2, 4, 11)]
    f0 = _fallbacks()
    assert TD.decode_batch_device(streams, device="cpu") == [
        host_decode(s) for s in streams]
    assert _fallbacks() == f0


def test_decode_batch_device_cuda_raises_without_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TD.decode_batch_device(list(_lanes()[:2]))


def test_sharded_decode_batch_equals_jax():
    """11 streams, 9 of them eligible (300-700 B at q1-q4, so the plain
    version's four shards stay short): the port pads them to 12 lanes over
    4 CPU slots, JAX to 16 over its 8 virtual devices."""
    data = corpus(9000)
    streams = [host_encode(data[1000 * i: 1000 * i + 300 + 50 * i],
                           quality=1 + i % 4) for i in range(9)] + [
        brotli_tpu_torch.parallel_encode(corpus(3000), quality=1,
                                         shard_size=1024),
        host_encode(b"", quality=1)]
    assert sum(p is not None for p in preflight_many(streams)) == 9
    want = JM.sharded_decode_batch(streams)
    got = brotli_tpu_torch.sharded_decode_batch(streams,
                                                TM.get_mesh(4, device="cpu"))
    assert got == want == [host_decode(s) for s in streams]


def test_pad_batch_adds_empty_lanes():
    pre = preflight_many(list(_lanes()[:5]))
    padded = TM._pad_batch(pre, 4)
    assert len(padded) == 8 and len(TM._pad_batch(pre[:4], 4)) == 4
    assert [p.mlen for p in padded[5:]] == [0, 0, 0]
    assert padded[:5] == pre and pre[0].mlen > 0
    out, pos, err = TD.fetch_outputs(*TD.device_decode_host(
        TD.stage_batch(padded, "cpu")))
    assert (pos[5:] == 0).all() and not err[5:].any()


def test_stage_batch_layout():
    pre = preflight_many(list(_lanes()[:3]))
    db = TD.stage_batch(pre, "cpu")
    n_words = [p.words.shape[0] for p in pre]
    assert db.max_words == max(n_words)
    assert db.out_size == max(p.mlen for p in pre)
    scal = db.scal.numpy()
    assert scal[:, TD.S_NWORDS].tolist() == n_words
    assert scal[:, TD.S_AT].tolist() == [0, n_words[0], n_words[0] + n_words[1]]
    assert scal[:, TD.S_BIT].tolist() == [p.cmd_start_bit for p in pre]
    body = db.body.numpy().view(np.uint32)
    np.testing.assert_array_equal(body[n_words[0]: n_words[0] + n_words[1]],
                                  pre[1].words)
    tabs = db.tabs.numpy()
    np.testing.assert_array_equal(tabs[2, TD.CMD_AT: TD.DIST_AT],
                                  pre[2].cmd_table)
    np.testing.assert_array_equal(tabs[2, TD.DXO_AT:], pre[2].dist_offset)
    assert TD.TAB_N == 3718
    with pytest.raises(ValueError):
        TD.stage_batch(pre, "cpu", out_size=1)


def test_encode_sharded_device_is_encode_device_batch():
    data = corpus(1500)
    got = brotli_tpu_torch.encode_sharded_device(data, device="cpu",
                                                 chunk_size=512)
    want = brotli_tpu_torch.encode_device_batch(data, device="cpu",
                                                chunk_size=512)
    assert got == want
    assert b"".join(TD.decode_batch_device(got, device="cpu")) == data


def test_decode_batch_device_raises_without_native_preflight(monkeypatch):
    """A native library that fails to build or load raises: no batch
    decodes through the Python parser instead."""
    import brotli_tpu_torch.native as native

    def broken():
        raise RuntimeError("native library failed to build")

    monkeypatch.setattr(native, "get_lib", broken)
    with pytest.raises(RuntimeError, match="failed to build"):
        TD.decode_batch_device(list(_lanes()[:2]), device="cpu")


# ---- the shared form's per-lane logic: rings, windows, compaction ----

# the direct form, then the shared form at (words ring, window bytes): the
# card's sizes, and sizes the test lanes outgrow many times over
SIZES = ("direct", (1024, 8192), (16, 64), (32, 256), (64, 1024))
SETS = ("wellformed", "flipped", "hand", "wide", "long", "back", "past")
BACK_A, BACK_B = 5600, 900   # the back lane's 7-bit bytes, then its high ones


def _wide(p, read: bool = False):
    """p with entries the compact tables cannot hold (a command table's
    padding, the last distance code's extra bits), which the lane never
    reads: it decodes from its row where it lies, to the same bytes; with
    `read`, instead its literal root pointers' offsets 4096 higher, which
    the lane reads (past the table's end: INT32_MIN; compacted to 12 bits,
    they would point where they did)."""
    if read:
        lit = p.lit_table.copy()
        ptr = (lit[:256] >> 16) > 8
        assert ptr.any()
        lit[:256][ptr] += 0x1000
        return dataclasses.replace(p, lit_table=lit)
    cmd = p.cmd_table.copy()
    cmd[-1] = 0x7FFF0000
    dxe = p.dist_extra.copy()
    dxe[-1] = 300
    return dataclasses.replace(p, cmd_table=cmd, dist_extra=dxe)


def _extras(p):
    """p with 30 extra bits for every distance code that had any: past
    the fast path's 24, so the lane decodes again by the direct form."""
    dxe = p.dist_extra.copy()
    dxe[16:][dxe[16:] > 0] = 30
    return dataclasses.replace(p, dist_extra=dxe)


@lru_cache(maxsize=None)
def _back_data() -> bytes:
    """BACK_A seeded bytes below 128 (7-bit codes: the first BACK_A
    literals take more than 32760 bits), then BACK_B above 127 (codes
    longer than 8 bits, under the literal table's second level)."""
    rng = np.random.default_rng(5)
    return (rng.integers(0, 128, BACK_A, dtype=np.uint8).tobytes()
            + rng.integers(128, 256, BACK_B, dtype=np.uint8).tobytes())


def _back(p):
    """p with the first literal root entry whose second-level table holds
    only bytes above 127 sent past the table's end: the lane's first such
    byte reads INT32_MIN, whose length takes the bit position 32760 bits
    back, over words the ring has dropped."""
    t = p.lit_table
    for r in range(256):
        bits0, off = int(t[r]) >> 16, int(t[r]) & 0xFFFF
        sub = t[r + off: r + off + (1 << (bits0 - 8))] if bits0 > 8 else []
        if len(sub) and all((int(e) & 0xFFFF) >= 128 for e in sub):
            lit = t.copy()
            lit[r] = (bits0 << 16) | 0xFFF
            return dataclasses.replace(p, lit_table=lit)
    raise AssertionError("no second-level table of high bytes alone")


@lru_cache(maxsize=None)
def _new_runs():
    """The wide, long and back lanes in one batch (lanes are independent):
    the JAX kernel's outputs, the plain version's, the port's preflight
    results and each set's rows.  long: 3 x 4 KB of the corpus at
    quality 1-3, 4-64 times the small windows, with copies from further
    back than they hold."""
    n = 4096
    data = corpus(40000)[20000:]
    long = [host_encode(data[n * i: n * (i + 1)], quality=1 + i)
            for i in range(3)]
    jl, tl = _pair(long)
    jw, tw = _pair(_lanes()[:3])
    jb, tb = _pair([host_encode(_back_data(), quality=1)])
    jpre = ([_wide(p, k == 2) for k, p in enumerate(jw)] + [_extras(jw[0])]
            + jl + [_back(jb[0])])
    tpre = ([_wide(p, k == 2) for k, p in enumerate(tw)] + [_extras(tw[0])]
            + tl + [_back(tb[0])])
    rows = {"wide": slice(0, 4), "long": slice(4, 7), "back": slice(7, 8)}
    want = JD.run_device_batch(jpre)
    return want, TD.run_device_batch(tpre, device="cpu"), tpre, rows


@lru_cache(maxsize=None)
def _past_lanes():
    """The quality 1-3 lanes cut at one mlen, the batch's out_size, so an
    insert cut there runs its literals past the row onto its last byte."""
    jpre, tpre = _pair([s for i, s in enumerate(_lanes()) if i % 4 != 3])
    return ([dataclasses.replace(p, mlen=300) for p in jpre],
            [dataclasses.replace(p, mlen=300) for p in tpre])


@lru_cache(maxsize=None)
def _set_runs(name: str):
    """Lane set `name`: (the JAX kernel's outputs, the plain version's, the
    port's preflight results of the batch, the set's rows in it)."""
    if name == "flipped":
        want, plain, _, _, tpre = _flipped_runs()
        return want, plain, tpre, slice(None)
    if name in ("wide", "long", "back"):
        want, plain, tpre, rows = _new_runs()
        return want, plain, tpre, rows[name]
    jpre, tpre = {"wellformed": lambda: _pair(_lanes()),
                  "hand": _hand_lanes, "past": _past_lanes}[name]()
    want = JD.run_device_batch(jpre)
    return want, TD.run_device_batch(tpre, device="cpu"), tpre, slice(None)


def _size_id(size) -> str:
    return size if size == "direct" else f"ring{size[0]}-win{size[1]}"


@pytest.mark.parametrize("size", SIZES, ids=_size_id)
@pytest.mark.parametrize("lanes", SETS)
def test_shim_forms_equal_jax_and_plain(lanes, size):
    """Each lane set through the host shim's direct form and its shared
    form at each ring and window: the JAX kernel's out, pos and err, and
    the plain version's, array for array."""
    want, plain, tpre, rows = _set_runs(lanes)
    _equal(want, plain, rows)
    db = TD.stage_batch(tpre, "cpu")
    if size == "direct":
        got = TD.device_decode_host(db, direct=True)
    else:
        got = TD.device_decode_host(db, ring_words=size[0], window=size[1])
    _equal(want, TD.fetch_outputs(*got), rows)


def test_lane_sets_reach_their_paths():
    """The sets do what their names say: the long lanes decode whole and
    outgrow the small windows; the back lane's first BACK_A literals (at
    least 7 bits each) decode before its fault; a past lane runs beyond
    its row; the wide lanes hold entries the compact tables cannot."""
    want, _, tpre, rows = _new_runs()
    out, pos, err = (np.asarray(a) for a in want)
    n = 4096
    data = corpus(40000)[20000:]
    for k in range(3):
        assert not err[4 + k] and pos[4 + k] == n
        assert bytes(out[4 + k, :n]) == data[n * k: n * (k + 1)]
    assert bytes(out[7, :BACK_A]) == _back_data()[:BACK_A]
    assert bytes(out[7, :pos[7]]) != _back_data()[:pos[7]]
    assert tpre[7].words.shape[0] > 1024 // 32 + 64
    assert err[3] and pos[3] < tpre[3].mlen  # a far distance, flagged
    _, ppos, perr = (np.asarray(a) for a in _set_runs("past")[0])
    assert (ppos > 300).any() and (perr == (ppos != 300)).all()
    assert not err[:2].any() and (pos[:2] == [p.mlen for p in tpre[:2]]).all()
    assert bytes(out[2, :pos[2]]) != host_decode(_lanes()[2])[:pos[2]]
