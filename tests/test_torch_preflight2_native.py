"""The v2 round trip's native host half (ops/preflight2_native.py, C++
native/preflight2.cpp) against the port's copy of the reference's numpy
one (ops/decode2.stage_v2 + batch_to_torch, collect_lanes).

Tolerance: exact equality.  The native staging must give the tensors of
batch_to_torch(stage_v2(...), "cpu") field for field, with the same lane
permutation, word counts, decoded sizes, groups and table chunks, and
None exactly where stage_v2 gives None; the pinned unpack must give
collect_lanes' bytes and fallback count.  CPU only (numpy and g++); no
JAX run.  Streams come from the port's host encoder and device encoder
(its plain versions on CPU tensors) over in-repo bytes.
"""

from functools import lru_cache

import numpy as np
import pytest
import torch

import brotli_tpu_torch
from brotli_tpu_torch.encode.sharded import encode_sharded
from brotli_tpu_torch.ops import decode2 as D
from brotli_tpu_torch.ops import preflight2 as P2
from brotli_tpu_torch.ops import preflight2_native as N
from brotli_tpu_torch.ops.device_encode import encode_device_batch
from brotli_tpu_torch.utils.benchmarks import corpus

FIELDS = ("wt", "lit", "cmd", "dist", "dx", "consts", "start_bit", "mlen")
SCALARS = ("groups", "lit_k", "cmd_k", "dist_k", "npostfix", "ndirect",
           "maxbw", "max_mlen", "cap")


def assert_same(streams, groups=None, binned=True):
    """stage_v2_native == batch_to_torch(stage_v2) on the CPU; returns the
    native batch (None where both are None)."""
    if binned:
        old = D.stage_v2(streams, groups)
    else:
        old = P2.preflight_shared(streams, groups=groups or 1, rate_sort=True)
    new = N.stage_v2_native(streams, "cpu", groups, binned)
    assert (old is None) == (new is None)
    if old is None:
        return None
    tb = D.batch_to_torch(old, "cpu")
    for f in FIELDS:
        x, y = getattr(tb, f), getattr(new.tb, f)
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert torch.equal(x, y), f
        assert y.is_contiguous(), f
    for f in SCALARS:
        assert getattr(tb, f) == getattr(new.tb, f), f
    assert new.groups == old.groups and new.n_streams == old.n_streams
    np.testing.assert_array_equal(new.perm, old.perm)
    np.testing.assert_array_equal(new.n_words, old.n_words)
    np.testing.assert_array_equal(new.mlens, old.mlens)
    return new


@lru_cache(maxsize=None)
def _chunks(chunk: int, n: int, skip: int = 0) -> tuple[bytes, ...]:
    """n encode_sharded streams of `chunk` bytes of the corpus, one table
    set, the last chunk shorter (another header)."""
    data = corpus(skip + n * chunk - chunk // 3)[skip:]
    return tuple(encode_sharded(data, chunk_size=chunk, max_distance=2032))


@lru_cache(maxsize=None)
def _device_streams() -> tuple[bytes, ...]:
    """64 x 1 KB from the device encoder (plain versions) in four table
    groups: four table sets, interleaved over the lanes."""
    return tuple(encode_device_batch(corpus(64 * 1024), device="cpu",
                                     chunk_size=1024, table_groups=4))


@lru_cache(maxsize=None)
def _mixed() -> tuple[bytes, ...]:
    """20 encode_sharded outputs of 2-3 streams each, from texts of their
    own (20 table sets, 20+ distinct headers), interleaved by a seeded
    shuffle, so bins first appear out of order and a thread's remembered
    headers are evicted."""
    parts = []
    for k in range(20):
        text = corpus(40000 + k * 977)[-(700 + 90 * k):]
        parts += encode_sharded(text, chunk_size=300)
    order = np.random.default_rng(17).permutation(len(parts))
    return tuple(parts[i] for i in order)


@pytest.mark.parametrize("chunk, n, groups", [
    (2048, 64, None), (8192, 24, None),
    (2048, 1000, None), (8192, 1000, None),      # 1 group, tiled
    (2048, 1500, None), (8192, 2048, None),      # 2 groups
    (2048, 4096, None), (8192, 3000, None),      # 3-4 groups
    (2048, 700, 2), (8192, 64, 4),               # empty groups
])
def test_corpus_batches(chunk, n, groups):
    """Shared-table batches at 1-4 groups (the streams tiled, so many
    lanes share a rate and the sort's stability shows)."""
    base = _chunks(chunk, 64 if chunk == 2048 else 24)
    streams = [base[i % len(base)] for i in range(n)]
    new = assert_same(streams, groups)
    assert new.groups == (groups or -(-n // 1024))


def test_mixed_tables_bin():
    streams = list(_mixed())
    new = assert_same(streams)
    assert new.groups == 20
    assert D.preflight_shared(streams, rate_sort=True) is None
    assert N.stage_v2_native(streams, "cpu", binned=False) is None


def test_big_bin_takes_several_groups():
    """A bin of more than 1024 streams beside small ones."""
    big = _chunks(2048, 64)
    streams = [big[i % 64] for i in range(1300)] + list(_mixed()[:30])
    streams = [streams[i] for i in np.random.default_rng(5).permutation(
        len(streams))]
    new = assert_same(streams)
    assert new.groups > 2


def test_device_encoder_table_groups():
    streams = list(_device_streams())
    new = assert_same(streams)
    assert new.groups == 4
    assert_same(streams + list(_chunks(2048, 64)[:10]))


def test_shared_only():
    """binned=False: preflight_shared's layout or None (the multi-slot
    decode's groups)."""
    streams = list(_chunks(2048, 64))
    assert_same(streams, binned=False)
    assert_same(streams[:7], binned=False)
    assert assert_same(list(_device_streams()), binned=False) is None


def _multi_metablock(text: bytes) -> bytes:
    enc = brotli_tpu_torch.Encoder(quality=5, lgwin=18)
    enc.params.lgblock = 14   # 16 KB metablocks: the first is not last
    return enc.update(text) + enc.finish()


@pytest.mark.parametrize("case", ["empty", "q11", "short", "not_last"])
def test_ineligible_streams(case):
    """A stream preflight refuses makes the whole batch None in both."""
    good = list(_chunks(2048, 64)[:20])
    text = corpus(40000)
    bad = {
        "empty": lambda: b"",
        "q11": lambda: brotli_tpu_torch.host_encode(text[20000:22500],
                                                    quality=11),
        "short": lambda: good[3][:5],
        "not_last": lambda: _multi_metablock(text),
    }[case]()
    assert P2.preflight(bad) is None
    for at in (0, 11, 20):
        assert assert_same(good[:at] + [bad] + good[at:]) is None


def test_header_cuts_agree():
    """Every cut of a stream up to a few bytes past its header: eligible
    where preflight says so, and staged alike (both parsers meet the cut
    the same way)."""
    s = _chunks(2048, 64)[0]
    header = (P2.preflight(s).cmd_start_bit >> 3) + 1
    seen = set()
    for cut in range(1, header + 6):
        cut_s = s[:cut]
        seen.add(P2.preflight(cut_s) is None)
        assert_same([cut_s])
        assert_same([s, cut_s, s])
    assert seen == {True, False}


def test_header_dedup_reads_the_last_bits():
    """Streams whose headers share every whole byte and differ only in the
    bits of the last, partial one are parsed apart (the dedup's mask)."""
    heads = [(s, P2.preflight(s).cmd_start_bit) for s in _chunks(2048, 64)]
    s, bit = next((s, b) for s, b in heads if b & 7)
    nf = bit >> 3
    for k in range(bit & 7):
        t = s[:nf] + bytes([s[nf] ^ (1 << k)]) + s[nf + 1:]
        assert_same([s, t])
        assert_same([t, s, t])


def test_truncated_lane():
    """A stream cut in its body stages alike (its words end early; the
    unpack's lane_overran sends it to the host)."""
    streams = list(_chunks(2048, 64))
    streams[3] = streams[3][: len(streams[3]) // 2]
    new = assert_same(streams)
    assert new.n_words[np.flatnonzero(new.perm == 3)[0]] < new.n_words.max()


def test_group_cap():
    """More groups than GROUP_CAP: None in both, for one table set (too
    many streams) and for too many table sets."""
    one = _chunks(2048, 64)[0]
    assert assert_same([one] * (D.GROUP_CAP * 1024 + 1)) is None
    assert_same([one] * (D.GROUP_CAP * 1024))
    texts = [corpus(20000 + 613 * k)[-900:] for k in range(D.GROUP_CAP + 1)]
    sparse = [encode_sharded(t, chunk_size=1024)[0] for t in texts]
    assert assert_same(sparse) is None
    assert assert_same(sparse[:D.GROUP_CAP]).groups == D.GROUP_CAP


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_threads_agree(monkeypatch, threads):
    """One thread against many: the same batch (the headers each thread
    remembers differ, the parses do not)."""
    monkeypatch.setattr(N, "N_THREADS", threads)
    assert_same(list(_mixed()) + list(_chunks(2048, 64)))
    assert_same([_chunks(8192, 24)[i % 24] for i in range(3000)])


def _perturbed_outputs(staged):
    """The plain kernels' outputs on a native batch, with flags planted:
    a lane not DONE, a lane with resolve flags, a lane past its words,
    and pad lanes flagged every way."""
    tok, count, phase, widx = D.entropy_decode(staged.tb)
    resolved, err = D.resolve_tokens(tok, count, staged.tb.mlen,
                                     staged.tb.max_mlen)
    live = np.flatnonzero(staged.perm >= 0)
    pad = np.flatnonzero(staged.perm < 0)
    phase[int(live[2])] = D.ERR
    err[int(live[5])] = 2
    widx[int(live[7])] = int(staged.n_words[live[7]]) + P2.WIDX_SLACK + 1
    widx[int(live[9])] = int(staged.n_words[live[9]]) + P2.WIDX_SLACK
    phase[pad[:3]] = D.ERR
    err[pad[3:6]] = 4
    return resolved, err, phase, widx


@pytest.mark.parametrize("which", ["shared", "binned"])
def test_unpack_matches_collect_lanes(which):
    """collect_lanes_pinned == collect_lanes on CPU tensors: bytes in
    stream order, flagged lanes re-decoded on the host, pad lanes skipped,
    the same fallback count."""
    streams = list(_chunks(512, 30))
    if which == "binned":   # a second table set: two groups
        streams += _chunks(512, 12, skip=100000)
    old = D.stage_v2(streams)
    new = assert_same(streams)
    assert new.groups == (1 if which == "shared" else 2)
    resolved, err, phase, widx = _perturbed_outputs(new)

    def fallbacks():
        return brotli_tpu_torch.fallback_stats()["lanes_fallback"]

    f0 = fallbacks()
    got_old = D.collect_lanes(old, streams, D.host_phases(old, phase, widx),
                              resolved, err)
    f1 = fallbacks()
    got_new = D.collect_lanes_pinned(new, streams, resolved, err, phase, widx)
    f2 = fallbacks()
    assert got_new == got_old
    assert f2 - f1 == f1 - f0 == 3
    assert got_new == [brotli_tpu_torch.host_decode(s) for s in streams]


def test_round_trip_on_cpu():
    """decode_batch_device_e2e through the native host half: the data, no
    fallback lane."""
    data = corpus(50000)[-20000:]
    streams = encode_sharded(data, chunk_size=1000, max_distance=2032)
    f0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu")
    assert b"".join(got) == data
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == f0


def test_failed_build_raises(monkeypatch, tmp_path):
    """A library that does not build raises; nothing falls back."""
    (tmp_path / "preflight2.cpp").write_text("#error broken on purpose\n")
    (tmp_path / "decoder.cpp").write_bytes(
        (N._NATIVE / "decoder.cpp").read_bytes())
    monkeypatch.setattr(N, "_NATIVE", tmp_path)
    monkeypatch.setattr(N, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        N.stage_v2_native(list(_chunks(2048, 64)[:4]), "cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        N.stage_v2_native(list(_chunks(2048, 64)[:4]), "cuda")
