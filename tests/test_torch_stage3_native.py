"""The v3 decode's native staging (ops/stage3_native.py,
native/preflight3.cpp brotli_v3_plan / brotli_v3_fill) and its pinned
unpack and device history (ops/decode3.py) against the yardstick: the
native preflight with numpy staging (ops/preflight3_native.py) and
batch_to_torch_v3, and the JAX package's numpy preflight_v3.

* at width 1024, the staged tensors equal batch_to_torch_v3 of the
  yardstick field for field, on port-encoded context-mapped streams, host
  q9/q11 streams with block switching in all three categories, the
  dictionary and transform streams, compound-dictionary streams and
  device block-type streams; None exactly where the yardstick is None;
* the same against the JAX preflight_v3 where no two streams differ only
  in their initial block lengths;
* each round of decode_batch_v3_full (history prefix and extras
  included) against preflight_units_v3_native + batch_to_torch_v3 of the
  same units;
* 1 and 4 threads, a hash that makes every key collide, and the section
  reuse off give the same buffers;
* collect_lanes_v3_pinned against _lanes and the lane loop, with a
  poisoned and a truncated lane;
* groups of 128 and of 1024 lanes give every stream the same bytes and
  status rows, through the host shim's kernels and the plain version, on
  a sparse batch whose tables all differ;
* a failed build, and "cuda" without a card, raise.

Inputs are made here from in-repo text and the cases of
tests/test_torch_decode3.py; nothing of JAX is compiled (preflight_v3 is
numpy).  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch as T
from brotli_tpu.ops import pallas_decode3 as JP3
from brotli_tpu_torch.ops import decode3 as D3
from brotli_tpu_torch.ops import preflight3_native as N3
from brotli_tpu_torch.ops import stage3_native as S3
from brotli_tpu_torch.utils.benchmarks import corpus

import test_torch_decode3 as TD

_CACHE: dict = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _text(n: int, skip: int) -> bytes:
    return corpus(n + skip)[skip:]


def _streaming(data: bytes, block_bits: int) -> bytes:
    enc = T.Encoder(quality=5, lgwin=18)
    enc.params.lgblock = block_bits
    out = b"".join(enc.update(data[i: i + 1024])
                   for i in range(0, len(data), 1024))
    return out + enc.finish()


def _block_types() -> list[bytes]:
    """Device-encoded streams with 3 block types, each with initial block
    lengths of its own."""
    return _cached("btypes", lambda: T.encode_device_batch(
        _text(4 * 2048, 90000), device="cpu", chunk_size=2048,
        lit_ctx_trees=4, block_types=3, block_seg=512))


def _host_q() -> list[bytes]:
    """Host q9 with three block types in every category, q11, q5: three
    table sets."""
    return _cached("hostq", lambda: TD.case("host_q9_q11_q5")[0])


def _sparse() -> list[bytes]:
    """Streams whose tables all differ: q5, q9 with three block types in
    every category, q11."""
    return _host_q()


# name -> (streams, custom dictionary)
def _batch(name: str):
    if name == "block types":
        return _block_types(), None
    if name == "host q + ctx trees":
        return _host_q() + list(TD._port_ctx()) + _host_q()[:1], None
    streams, _, kw = TD.case(name)
    return streams, kw.get("custom_dictionary")


BATCHES = ["port_ctx_2groups", "host_q9_q11_q5", "dict_transforms",
           "far_copy", "poisoned", "truncated", "compound_d1",
           "compound_chunks", "block types", "host q + ctx trees"]


def _assert_same_tb(a, b, skip=()) -> None:
    for f in dataclasses.fields(a):
        if f.name in skip:
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert torch.equal(x, y), f.name
        elif isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert (x == y).all(), f.name
        else:
            assert x == y, f.name


@pytest.fixture
def poisoned_host_buffer(monkeypatch):
    """The staging's int32 buffers start as all ones, so that a field the
    fill never writes cannot pass as zeros."""
    empty = torch.empty

    def poisoned(*a, **k):
        t = empty(*a, **k)
        return t.fill_(-1) if t.dtype == torch.int32 else t

    monkeypatch.setattr(S3.torch, "empty", poisoned)


@pytest.mark.parametrize("name", BATCHES)
def test_staging_equals_yardstick_at_width_1024(name, poisoned_host_buffer):
    """Every tensor and scalar of the batch, and the lanes' streams, words
    and sizes, equal the yardstick's."""
    streams, cd = _batch(name)
    ref = N3.preflight_v3_native(streams, max_groups=8)
    assert ref is not None
    got = S3.stage_v3_native(streams, "cpu", max_groups=8, width=1024,
                             custom_dictionary=cd)
    _assert_same_tb(D3.batch_to_torch_v3(ref, "cpu", cd), got.tb)
    assert (got.perm == ref.perm).all() and (got.mlens == ref.mlens).all()
    assert (got.n_words == ref.n_words).all()
    assert got.n_streams == ref.n_streams == len(streams)


@pytest.mark.parametrize("n", [33, 120])
def test_one_group_of_one_table_set_is_filled_whole(n, monkeypatch,
                                                    poisoned_host_buffer):
    """33 to 128 streams of one table set: one group of 128 lanes, fewer
    slots than the fill spreads over threads, staged with N_THREADS = 4
    into a poisoned buffer.  Every lane's words and scalars equal the
    yardstick's, and every stream decodes through the host shim to the
    host decoder's bytes."""
    monkeypatch.setattr(S3, "N_THREADS", 4)
    base = list(TD._port_ctx())
    bins = N3.parse_units(N3.stage_streams(base),
                          np.arange(len(base))).units[:, 7]
    one = [x for x, b in zip(base, bins) if b == bins[0]]
    streams = (one * n)[:n]
    ref = D3.batch_to_torch_v3(N3.preflight_v3_native(streams), "cpu")
    got = S3.stage_v3_native(streams, "cpu")
    assert got.groups == 1 and got.tb.n_lanes == 128
    assert torch.equal(got.tb.wt, ref.wt[:, :128])
    assert torch.equal(got.tb.scal, ref.scal[:, :128])
    assert not ref.wt[:, 128:].any()
    out, status = D3.decode3_host(got.tb)
    assert not status[0].any()
    want = [T.host_decode(x) for x in one]
    assert D3.collect_lanes_v3_pinned(got, streams, out, status) == [
        want[i % len(one)] for i in range(n)]


def test_staged_dictionary_is_used():
    """dict_dev goes into the batch as it is; the copy holds no
    dictionary, and the other fields do not change."""
    streams, _ = _batch("dict_transforms")
    dict_dev = T.stage_dictionary("cpu")
    got = S3.stage_v3_native(streams, "cpu", width=1024, dict_dev=dict_dev)
    plain = S3.stage_v3_native(streams, "cpu", width=1024)
    assert got.tb.dict is dict_dev
    _assert_same_tb(plain.tb, got.tb)
    assert "dict" not in S3.FIELDS[: S3._NATIVE_FIELDS]
    hs = S3.stage_host(streams, with_dict=False)
    assert hs.widths[S3.FIELDS.index("dict")] == 0


def _refused() -> dict:
    k = {"multi-metablock": [_streaming(_text(3072, 80000), 10)],
         "uncompressed": [T.host_encode(_text(3000, 10000), quality=0)],
         "empty": [T.host_encode(b"", quality=5), b"", b"\x00"],
         "no streams": []}
    k["one refused"] = list(TD._port_ctx())[:3] + k["uncompressed"]
    return k


@pytest.mark.parametrize("name", ["multi-metablock", "uncompressed", "empty",
                                  "no streams", "one refused"])
def test_none_where_the_yardstick_is_none(name):
    streams = _refused()[name]
    assert N3.preflight_v3_native(streams, max_groups=8) is None
    assert S3.stage_v3_native(streams, "cpu", max_groups=8) is None
    assert S3.stage_v3_native(streams, "cpu", max_groups=8,
                              width=1024) is None


def test_group_budget_counts_lanes():
    """The cap counts 1024-lane groups' worth of lanes: three table sets
    are refused at two groups of 1024 by both layouts, and at width 128
    they fit in one group's worth of lanes where the yardstick needs
    three."""
    streams = _host_q()
    assert N3.preflight_v3_native(streams, max_groups=2) is None
    assert S3.stage_v3_native(streams, "cpu", max_groups=2,
                              width=1024) is None
    got = S3.stage_v3_native(streams, "cpu", max_groups=1)
    assert got.groups == 3 and got.tb.n_lanes == 384
    hs = S3.plan_and_fill(S3.StreamPtrs(streams), np.arange(3),
                          max_groups=1, width=1024)
    assert hs is None


def test_staging_equals_jax_preflight():
    """Streams no two of which differ only in their initial block
    lengths: the staging at width 1024 equals batch_to_torch_v3 of the
    JAX package's (numpy) preflight_v3."""
    streams, _ = _batch("host q + ctx trees")
    ref = JP3.preflight_v3(streams, max_groups=8)
    assert ref is not None and ref.groups == 5
    got = S3.stage_v3_native(streams, "cpu", max_groups=8, width=1024)
    _assert_same_tb(D3.batch_to_torch_v3(ref, "cpu"), got.tb)
    assert (got.perm == np.asarray(ref.perm)).all()


def _full_streams() -> dict:
    def make():
        data = _text(3072, 110000)
        return {"streaming": _streaming(data, 11),
                "spliced": T.parallel_encode(data, shard_size=1024,
                                             quality=5, num_workers=1),
                "1 KB metablocks": _streaming(data, 10),
                "uncompressed": T.host_encode(data, quality=0),
                "single": T.host_encode(data, quality=9)}
    return _cached("full", make)


@pytest.mark.parametrize("width", [1024, 128])
def test_full_rounds_equal_yardstick(width, monkeypatch):
    """decode_batch_v3_full over the full-path streams: each round's
    batch (history prefixes, positions, last two bytes and rings
    included) equals batch_to_torch_v3 of preflight_units_v3_native on
    the same units, whose earlier output is the data decoded so far (at
    width 128, the yardstick's lanes mapped by stream); the output equals
    the host decoder's, with no fallback."""
    streams = list(_full_streams().values())
    want = [T.host_decode(s) for s in streams]
    joined = N3.stage_streams(streams)
    rounds = []
    orig = S3.stage_units_v3_native

    def check(src, stream, bit, mlen, maxbw, rings, history, *a, **k):
        pos0 = history.lens[stream].copy()
        got = orig(src, stream, bit, mlen, maxbw, rings, history, *a, **k)
        hist = [want[i][:p] for i, p in zip(stream.tolist(), pos0.tolist())]
        extras = np.array([(len(h), h[-1] if h else 0,
                            h[-2] if len(h) >= 2 else 0) for h in hist],
                          np.int64).T
        ref = N3.preflight_units_v3_native(N3.V3Units(
            streams=joined, stream=stream, bit=bit, mlen=mlen, maxbw=maxbw,
            extras=np.concatenate([extras, rings]), hist=hist),
            max_groups=8)
        tb = D3.batch_to_torch_v3(ref, "cpu")
        if width == 1024:
            _assert_same_tb(tb, got.tb)
            assert (got.perm == ref.perm).all()
        else:
            at = {int(i): s for s, i in enumerate(got.perm) if i >= 0}
            for slot in np.flatnonzero(ref.perm >= 0):
                s = at[int(ref.perm[slot])]
                assert torch.equal(tb.scal[:, slot], got.tb.scal[:, s])
                if tb.hist is not None:
                    assert torch.equal(tb.hist[slot], got.tb.hist[s])
        rounds.append(got.tb.hrb)
        return got

    monkeypatch.setattr(S3, "WIDTH", width)
    monkeypatch.setattr(S3, "stage_units_v3_native", check)
    monkeypatch.setattr(D3, "decode3",
                        lambda tb, use_dict=True: D3.decode3_host(tb, use_dict))
    before = T.fallback_stats()["lanes_fallback"]
    assert T.decode_batch_v3_full(streams, device="cpu", max_groups=8) == want
    assert T.fallback_stats()["lanes_fallback"] == before
    assert len(rounds) >= 3 and rounds[0] == 0 and max(rounds) > 0


def test_full_path_equals_jax_driver(monkeypatch):
    """decode_batch_v3_full on a batch of every full-path stream, twice
    (streams of 0-3 rounds side by side in one device history), equals the
    JAX package's host decoder, the uncompressed streams included.  The
    kernel's per-lane code decodes (the host shim): the plain version's
    driver runs are tests/test_torch_decode3_e2e.py's."""
    streams = list(_full_streams().values()) * 2
    monkeypatch.setattr(D3, "decode3",
                        lambda tb, use_dict=True: D3.decode3_host(tb, use_dict))
    before = T.fallback_stats()["lanes_fallback"]
    got = T.decode_batch_v3_full(streams, device="cpu")
    assert got == [brotli_tpu.decode(s) for s in streams]
    assert T.fallback_stats()["lanes_fallback"] == before


def _host_buffers(hs):
    """Each field of the host buffer (the gaps between them are not
    written), and the per-lane arrays."""
    buf = hs.buf.numpy()
    return ([buf[o: o + w].copy() for o, w in zip(hs.seg, hs.widths)]
            + [hs.units, hs.slot_unit, hs.n_words, hs.mlens, hs.w0, hs.cfg])


def _distinct_sections(streams) -> int:
    """The table sections (the bits from the tables' first bit to the
    first command's) of the streams that the yardstick's parse takes, told
    apart bit for bit: the walk gives the first bit, the parse the last."""
    st = N3.stage_streams(streams)
    ids = np.arange(len(streams), dtype=np.int64)
    first = N3.walk_units(st, ids, np.zeros(len(streams), np.int64)).units
    units = N3.parse_units(st, ids, max_bins=64).units
    seen = set()
    for s, tb, row in zip(streams, first[:, 2].tolist(), units):
        if row[0] == 1:
            cb = int(row[2])
            bits = int.from_bytes(s, "little") >> tb & ((1 << cb - tb) - 1)
            seen.add((cb - tb, bits))
    return len(seen)


def test_threads_hash_and_reuse_agree(monkeypatch):
    """1, 3 and 4 threads, and a hash and-ed with 0 or 1 (every key
    collides, so memcmp alone tells table sets apart) stage the same
    bytes.  One thread parses each distinct table section once; more
    threads parse it at most once each."""
    # 312 units: the plan runs on two threads where it may run on more
    streams = (list(TD._port_ctx()) + _block_types() + _host_q()) * 24
    distinct = _distinct_sections(streams)
    assert distinct < len(streams) // 4
    monkeypatch.setattr(S3, "N_THREADS", 1)
    one = S3.stage_host(streams)
    ref = _host_buffers(one)
    assert int(one.meta[S3.M_PARSES]) == distinct
    for threads, mask in ((4, S3._HASH_MASK), (4, 0), (3, 1),
                          (1, S3._HASH_MASK)):
        monkeypatch.setattr(S3, "N_THREADS", threads)
        monkeypatch.setattr(S3, "_HASH_MASK", mask)
        hs = S3.stage_host(streams)
        for x, y in zip(_host_buffers(hs), ref):
            assert x.shape == y.shape and (x == y).all()
        assert distinct <= int(hs.meta[S3.M_PARSES]) <= threads * distinct


def test_section_reuse_checks_the_bits():
    """Streams whose headers differ but whose table sections are equal
    take one parse; a stream whose tables differ in one bit, and one cut
    inside its tables, are parsed on their own: every unit's status, bits,
    block lengths and bin equal the yardstick's parse, the plan parses
    each distinct section once, and the cut stream makes the batch
    None."""
    base = list(TD._port_ctx())
    s = base[0]
    cmd_bit = int(N3.parse_units(N3.stage_streams([s]), [0]).units[0, 2])
    flip = bytearray(s)
    flip[cmd_bit // 8 - 3] ^= 0x10
    streams = base + [bytes(flip), s[: cmd_bit // 8 - 2]] + base
    ref = N3.parse_units(N3.stage_streams(streams), np.arange(len(streams)),
                         max_bins=64)
    src = S3.StreamPtrs(streams)
    ids = np.arange(len(streams), dtype=np.int64)
    plan, meta, units = S3._plan(src, ids, None, None, None, False, 64, 128)
    assert not plan and meta[S3.M_STATUS] == S3.NONE
    assert (units == ref.units).all()
    assert int(meta[S3.M_PARSES]) == _distinct_sections(streams) <= 4
    assert S3.stage_v3_native(streams, "cpu", max_groups=64) is None
    assert N3.preflight_v3_native(streams, max_groups=64) is None


def _yardstick_collect(batch, streams, out, status):
    """The yardstick's unpack: _lanes, then a bytes a lane, a flagged lane
    re-decoded on the host."""
    st, raw = D3._lanes(batch, out, status)
    results = [None] * batch.n_streams
    fell = 0
    for slot in range(batch.groups * 1024):
        i = int(batch.perm[slot])
        if i < 0:
            continue
        if st[0, slot] != 0:
            fell += 1
            results[i] = D3.host_decode(streams[i])
        else:
            results[i] = raw[slot, : batch.mlens[slot]].tobytes()
    return results, fell


@pytest.mark.parametrize("width", [1024, 128])
def test_collect_lanes_pinned_equals_the_lane_loop(width, monkeypatch):
    """A batch with a poisoned lane and a truncated one: both flag (one by
    its err row, one by the words guard), both fall back, and every other
    lane's bytes equal the yardstick's unpack."""
    streams = list(TD._port_ctx())
    streams[1] = TD.truncate_body(streams[1])
    streams.append(TD.poisoned_stream())
    monkeypatch.setattr(D3, "host_decode",
                        lambda s, custom_dictionary=None: b"host" + s[:4])
    batch = N3.preflight_v3_native(streams, max_groups=8)
    out, status = D3.decode3_host(D3.batch_to_torch_v3(batch, "cpu"))
    want, fell = _yardstick_collect(batch, streams, out, status)
    assert fell == 2
    staged = S3.stage_v3_native(streams, "cpu", max_groups=8, width=width)
    out, status = D3.decode3_host(staged.tb)
    flags = D3.lane_flags(staged, status.numpy())
    bad = {int(staged.perm[s]) for s in np.flatnonzero(flags)}
    assert bad == {1, len(streams) - 1}
    before = T.fallback_stats()["lanes_fallback"]
    got = D3.collect_lanes_v3_pinned(staged, streams, out, status)
    assert got == want
    assert got[1] == b"host" + streams[1][:4]
    assert T.fallback_stats()["lanes_fallback"] == before + 2


def _by_stream(staged_or_batch, out, status) -> dict:
    perm = staged_or_batch.perm
    return {int(perm[s]): (status[:, s].tolist(),
                           out[s, : staged_or_batch.mlens[s]].numpy().tobytes())
            for s in np.flatnonzero(perm >= 0)}


@pytest.mark.parametrize("form", ["windowed", "direct", "plain"])
def test_widths_agree_on_a_sparse_batch(form):
    """Streams whose tables all differ: a group each, of 128 or of 1024
    lanes; every stream's bytes and 16 status rows are the same at both
    widths, through the windowed and the direct kernels' host code and
    the plain version, and equal the host decoder's bytes."""
    # the plain version over 1024-lane groups is slow on the CPU: the q9
    # and the q5 stream there
    streams = _sparse()[::2] if form == "plain" else _sparse()
    run = {"windowed": lambda tb: D3.decode3_host(tb, window=256),
           "direct": lambda tb: D3.decode3_host(tb, direct=True),
           "plain": D3.decode3_ref}[form]
    narrow = S3.stage_v3_native(streams, "cpu")
    wide = S3.stage_v3_native(streams, "cpu", width=1024)
    assert narrow.groups == wide.groups == len(streams)
    assert narrow.tb.n_lanes == 128 * len(streams)
    a = _by_stream(narrow, *run(narrow.tb))
    b = _by_stream(wide, *run(wide.tb))
    assert a == b
    assert all(a[i][0][0] == 0 and a[i][1] == T.host_decode(s)
               for i, s in enumerate(streams))


@pytest.mark.parametrize("width", [64, 96, 0])
def test_width_is_checked(width):
    """A width that is no multiple of 128 (the kernels' blocks would
    straddle two groups) is refused before any launch."""
    staged = S3.stage_v3_native(_sparse()[:2], "cpu")
    tb = dataclasses.replace(staged.tb, width=width, groups=2)
    for run in (D3.decode3_ref, D3.decode3_host, D3.decode3):
        with pytest.raises(ValueError, match="width"):
            run(tb)


def test_device_history_appends_and_prefixes():
    """Appends of uneven rows (the buffer grows and keeps its rows), right-
    aligned prefixes with zeros before a stream's first byte and for pad
    lanes, and one fetch, against the same bytes kept on the host."""
    rng = np.random.default_rng(7)
    n = 5
    h = S3.DeviceHistory(n, torch.device("cpu"))
    kept = [b""] * n
    for _ in range(6):
        idx = np.sort(rng.choice(n, size=3, replace=False))
        lengths = rng.integers(0, 3000, size=3)
        rows = torch.from_numpy(rng.integers(0, 256, (3, int(lengths.max()) + 5),
                                             dtype=np.uint8))
        h.append(idx, rows, lengths)
        for r, i in enumerate(idx):
            kept[i] += rows[r, : lengths[r]].numpy().tobytes()
        for hrb in (32, 4096):
            slots = np.array([3, -1, 0, 4, 1, 2])
            pre = h.prefix(slots, hrb)
            for k, i in enumerate(slots):
                want = kept[i][-hrb:] if i >= 0 and kept[i] else b""
                row = pre[k].numpy().tobytes()
                assert row == bytes(hrb - len(want)) + want
    got = h.fetch(np.arange(n))
    assert [got[i] for i in range(n)] == kept
    assert h.fetch(np.array([], np.int64)) == {}


def test_walk_ptrs_equals_walk_units():
    """The walk over streams where they lie equals the walk over the
    joined streams, from the first bit and from bits inside the streams
    (where most walks refuse), with the bytes they copy."""
    streams = list(_full_streams().values())
    joined = N3.stage_streams(streams)
    src = S3.StreamPtrs(streams)
    rng = np.random.default_rng(11)
    us = np.repeat(np.arange(len(streams)), 9)
    bits = np.concatenate([[0] + sorted(rng.integers(1, 8 * len(x), 8))
                           for x in streams])
    ref = N3.walk_units(joined, us, bits)
    got = S3.walk_ptrs(src, us, bits)
    assert (got.units == ref.units).all()
    assert set(got.units[:, 0].tolist()) >= {0, 1}
    for u in range(len(us)):
        o = int(got.copy_off[u])
        assert (got.copied[o: o + int(got.units[u, 5])].tobytes()
                == ref.copy_of(u))


def test_drivers_reach_no_yardstick(monkeypatch):
    """decode_batch_v3 and decode_batch_v3_full stage through the native
    staging alone (the yardstick's preflight, staging and unpack made to
    raise) and decode with no fallback (through the host shim's kernel
    code)."""
    def boom(*a, **k):
        raise AssertionError("the yardstick was reached")

    data = _text(2048, 120000)
    streams = T.encode_device_batch(data, device="cpu", chunk_size=1024,
                                    lit_ctx_trees=4)
    full = _full_streams()["1 KB metablocks"]
    monkeypatch.setattr(D3, "decode3",
                        lambda tb, use_dict=True: D3.decode3_host(tb, use_dict))
    for mod, name in ((N3, "parse_units"), (N3, "_assemble"),
                      (N3, "stage_streams"), (N3, "walk_units"),
                      (N3, "preflight_v3_native"), (D3, "batch_to_torch_v3"),
                      (D3, "_lanes")):
        monkeypatch.setattr(mod, name, boom)
    before = T.fallback_stats()["lanes_fallback"]
    assert b"".join(T.decode_batch_v3(streams, device="cpu")) == data
    assert T.decode_batch_v3_full([full], device="cpu") == [
        T.host_decode(full)]
    assert T.fallback_stats()["lanes_fallback"] == before


def test_failed_build_raises(monkeypatch, tmp_path):
    """A library that does not build raises; nothing falls back."""
    (tmp_path / "preflight3.cpp").write_text("#error broken on purpose\n")
    (tmp_path / "decoder.cpp").write_bytes(
        (N3._NATIVE / "decoder.cpp").read_bytes())
    monkeypatch.setattr(N3, "_NATIVE", tmp_path)
    monkeypatch.setattr(N3, "_LIB", None)
    monkeypatch.setattr(S3, "_LIB", None)
    with pytest.raises(RuntimeError, match="failed"):
        S3.stage_v3_native(_sparse()[:2], "cpu")


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        S3.stage_v3_native(_sparse()[:2], "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        T.decode_batch_v3_full(_sparse()[:2], device="cuda")
