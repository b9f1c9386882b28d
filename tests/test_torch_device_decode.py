"""The port's per-lane-table decode (brotli_tpu_torch/ops/device_decode.py,
csrc/device_decode.cuh) and its sharded driver (parallel/mesh.py
sharded_decode_batch) against the JAX package's brotli_tpu/ops/
device_decode.py and brotli_tpu/parallel/mesh.py, on the CPU.

Tolerance: exact equality.  The plain PyTorch version
(`run_device_batch(..., device="cpu")`) and the kernel's per-lane code
built by g++ (`device_decode_host`) must give the JAX kernel's out, pos
and err array for array, on well-formed lanes, on lanes broken by hand
(each error flag, a window too small, a truncated size) and on seeded
bit-flipped streams, where reads run past a lane's words and tables.  The
drivers must give the host decoder's bytes.  Streams come from the port's
host encoder on the in-repo corpus (utils/benchmarks.corpus).
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


def _three_way(jax_pre, port_pre):
    """The JAX kernel's (out, pos, err) on `jax_pre`, and the plain version
    and the host shim on `port_pre`, each equal to it array for array."""
    want = JD.run_device_batch(jax_pre)
    plain = TD.run_device_batch(port_pre, device="cpu")
    shim = TD.fetch_outputs(*TD.device_decode_host(
        TD.stage_batch(port_pre, "cpu")))
    for got in (plain, shim):
        for w, g in zip(want, got):
            assert g.dtype == np.asarray(w).dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))
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
    shim = TD.fetch_outputs(*TD.device_decode_host(
        TD.stage_batch(tpre, "cpu")))
    return want, plain, shim, rows


@pytest.mark.parametrize("seed", FLIP_SEEDS)
def test_bitflipped_lanes_equal_jax(seed):
    want, plain, shim, rows = _flipped_runs()
    assert rows[seed].stop - rows[seed].start >= 4
    for got in (plain, shim):
        for w, g in zip(want, got):
            assert g.dtype == np.asarray(w).dtype and g.shape == w.shape
            np.testing.assert_array_equal(g[rows[seed]],
                                          np.asarray(w)[rows[seed]])


def _hand(which: str, p, **kw):
    """A copy of preflight result `p` (the JAX or the port's class)
    changed by `kw`, or its tables changed for `which`."""
    if which == "negative distance":
        off = p.dist_offset.copy()
        off[16:] = -5
        kw["dist_offset"] = off
    return dataclasses.replace(p, **kw)


def test_hand_made_lanes_trip_each_flag():
    """distance < 1 (long-code offsets made negative), distance beyond the
    window (max_backward 1), and sizes cut inside a copy or an insert."""
    jpre, tpre = _pair(_lanes()[:3])
    cases = [("negative distance", {}), ("window", {"max_backward": 1})]
    cases += [("size", {"mlen": m}) for m in range(3, 120, 7)]
    jb = [_hand(w, jpre[k % 3], **kw) for k, (w, kw) in enumerate(cases)]
    tb = [_hand(w, tpre[k % 3], **kw) for k, (w, kw) in enumerate(cases)]
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
