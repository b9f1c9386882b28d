"""The device encoder's host half laid out for the card (ops/device_encode.py:
stage_upload, lane_features, _group_tables_all, _headers_once (each
distinct header built once, by the C++ _header_words_native),
prepare_pack_pinned, _assemble_compact and the new _encode_finish) against
the yardstick it replaces (stage_input, _cluster_lanes,
_group_tables_from_hists, _headers, prepare_pack, assemble_streams and
_old_encode_finish), on the CPU.

Tolerance: exact equality everywhere: the staged bytes, the lane groups
and modes, each distinct header's words, tail and bit count, the
PackBatch field for field, the streams and their sizes.  The buffers the
new half takes from torch.empty are poisoned (filled with a pattern) so a
byte it fails to write shows.  The knob sets are those of
tests/test_torch_encode_e2e.py, which holds the same driver against JAX.
"""

import numpy as np
import pytest
import torch

import brotli_tpu_torch
from brotli_tpu_torch.encode import encode as host_encode
from brotli_tpu_torch.ops import device_encode as E
from brotli_tpu_torch.ops import encode_host as H
from brotli_tpu_torch.parallel import mesh as M
from test_torch_encode_e2e import CHUNK, KNOBS

CPU = torch.device("cpu")


@pytest.fixture
def poisoned(monkeypatch):
    """torch.empty returns tensors filled with a pattern (0xA5 bytes)."""
    orig = torch.empty

    def empty(*args, **kw):
        t = orig(*args, **kw)
        if t.dtype == torch.bool:
            return t.fill_(True)
        if t.dtype.is_floating_point:
            return t.fill_(float("nan"))
        return t.view(torch.uint8).fill_(0xA5).view(t.dtype) \
            if t.numel() and t.is_contiguous() else t

    monkeypatch.setattr(torch, "empty", empty)


def _bytes(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, n, np.uint8).tobytes()


@pytest.mark.parametrize("chunk", [512, 2048, 4096])
@pytest.mark.parametrize("what", ["one chunk", "partial last", "1024 chunks"])
def test_staged_input_equals_stage_input(chunk, what, poisoned):
    n = {"one chunk": chunk - 37, "partial last": 5 * chunk + 11,
         "1024 chunks": 1024 * chunk}[what]
    data = _bytes(n, seed=chunk)
    want, want_nv, want_nv_t = E.stage_input(data, chunk, CPU)
    got, got_nv, got_nv_t, host = E.stage_upload(data, chunk, CPU)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)
    assert np.array_equal(got_nv, want_nv)
    assert torch.equal(got_nv_t, want_nv_t)
    assert host.numel() == len(data) and bytes(host.numpy()) == data


def _sample(n_lanes: int, cols: int, seed: int) -> np.ndarray:
    """A record sample: literal records of text-like and binary-like
    lanes, commands, distances and pads, with bits 28-31 set on some."""
    rng = np.random.default_rng(seed)
    kind = rng.choice([0, E.K_CMD, E.K_LIT, E.K_DIST], (n_lanes, cols),
                      p=[0.1, 0.2, 0.6, 0.1])
    text = rng.integers(32, 127, (n_lanes, cols))
    binary = rng.integers(0, 256, (n_lanes, cols))
    high = rng.random(n_lanes)[:, None] < 0.4
    byte = np.where(high, binary, text)
    ctx = rng.integers(0, 1 << 16, (n_lanes, cols)) << 8
    low = np.where(kind == E.K_LIT, byte | ctx,
                   rng.integers(0, 1 << 24, (n_lanes, cols)))
    return ((kind << 28) | low).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_lane_groups_and_modes(groups):
    sample = _sample(E.B_LANES, 129, seed=groups)
    n_chunks = 700
    want = H._cluster_lanes(sample, groups, n_chunks)
    feats = E.lane_features(torch.from_numpy(sample), n_chunks)
    assert feats.shape == (n_chunks, 32) and feats.dtype == np.int64
    got = H._cluster_lanes_feats(feats, groups, n_chunks)
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    if groups > 1:
        assert len(got[1]) > 1


def _hists(rows: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shapes = rng.dirichlet(np.full(256, 0.05), 6)
    pick = rng.integers(0, 6, rows)
    rows = [rng.multinomial(int(rng.integers(0, 4000)), shapes[p])
            for p in pick]
    return np.stack(rows).astype(np.int64)


@pytest.mark.parametrize("nt", [1, 2, 4, 8])
def test_group_tables_once(nt):
    rng = np.random.default_rng(nt)
    lit = _hists(64 * 3, seed=nt)
    cmd = rng.integers(0, 50, 704) * 8 + 1
    dist = rng.integers(0, 50, 64) * 8 + 1
    for rows in (64, 128, 192):
        want = H._group_tables_from_hists(lit[:rows], cmd, dist, nt)
        clustered = (H.cluster_groups_native(lit[None, :rows], 1)[0]
                     if nt > 1 else None)
        got = H._group_tables_once(lit[:rows], cmd, dist, nt, clustered)
        assert np.array_equal(got["cmap"], want["cmap"])
        assert got["lits"] == want["lits"]
        assert got["cmd"] == want["cmd"] and got["dist"] == want["dist"]


@pytest.mark.parametrize("threads", [1, 3, 8])
def test_cluster_groups_native(threads):
    """cluster_groups_native (the groups over C++ threads) == the native
    clustering of each group alone, map for map, on 64-row and 192-row
    (three block types) groups."""
    from brotli_tpu_torch.native import cluster_context_map_native

    for rows, groups in ((64, 1), (64, 5), (192, 1), (192, 2)):
        lit = _hists(rows * groups, seed=rows + groups).reshape(
            groups, rows, 256)
        lit[:, 5] = 0   # an empty context
        got = H.cluster_groups_native(lit, threads)
        for g in range(groups):
            n, cmap = cluster_context_map_native(lit[g], rows, 256)
            assert got[g][0] == n and got[g][1].tolist() == cmap


def test_group_tables_all_over_threads(monkeypatch):
    monkeypatch.setattr(E, "ENC_THREADS", 3)
    lit = _hists(64 * 5, seed=9)
    flat = np.concatenate(
        [np.concatenate([lit[g * 64:(g + 1) * 64].reshape(-1),
                         np.arange(768) % 7]) for g in range(5)]
        + [np.zeros(1, np.int64)])
    got = E._group_tables_all(flat, 5, 1, 4)
    want = [H._group_tables_from_hists(*H._split_group_hist(flat, g, 1), 4)
            for g in range(5)]
    for a, b in zip(got, want):
        assert np.array_equal(a["cmap"], b["cmap"])
        assert (a["lits"], a["cmd"], a["dist"]) == (b["lits"], b["cmd"],
                                                    b["dist"])


_STATES: dict = {}


def _state(name: str) -> tuple[dict, dict]:
    """The knob set's encode state after the device stages (cached)."""
    if name not in _STATES:
        make, kw = KNOBS[name]
        kw = {"chunk_size": CHUNK, **kw}
        state = E._encode_start(
            make(), CPU, kw["chunk_size"], kw.get("hash_stride", 1), 256,
            kw.get("max_distance"), kw.get("chain_depth", 2),
            lit_ctx=kw.get("lit_ctx_trees", 1) > 1,
            block_types=kw.get("block_types", 1),
            block_seg=kw.get("block_seg", 2048), hash2=kw.get("hash2", False),
            lazy=kw.get("lazy", (105, 175)), min_gate=kw.get("min_gate", 9))
        _STATES[name] = (state, kw)
    return _STATES[name]


def _tables_and_split(state: dict, groups: int, nt: int):
    """The new half's groups, tables and block-switch plan for a state."""
    feats = E.lane_features(state["rec0_sample"], state["n_chunks"])
    group_of, modes = H._cluster_lanes_feats(feats, groups, state["n_chunks"])
    nbt = state["block_types"]
    signed = (np.asarray(modes)[group_of] == 3).astype(np.int32)
    split, btype = None, None
    if nbt > 1:
        sw, first_blen, t0, group_splits = H._plan_block_switches(
            state["seg_type"].numpy(), state["seg_litcnt"].numpy(),
            state["n_chunks"], group_of, len(modes), nbt)
        split = (first_blen, t0, group_splits)
        pseg = state["block_seg"]
        nseg = state["chunk_size"] // pseg
        cols = np.arange(0, state["rec0"].shape[1], state["hist_stride"])
        btype = state["seg_type"][:, np.clip((cols - 1) // pseg, 0, nseg - 1)]
    flat = E._group_hist_fetch(state["rec0"], group_of, signed, len(modes),
                               state["hist_stride"], nbt, btype, [])
    tables = E._group_tables_all(flat, len(modes), nbt, nt)
    for j, t in enumerate(tables):
        t["mode"] = modes[j] if nt > 1 else 0
    return tables, group_of, split


def _header_bits_once(mlen: int, lgwin: int, tables: dict, split):
    """One _header_bits build as (its whole 32-bit words, the bits of its
    last partial word, their count): the writer's bit count read before
    finish() pads the last byte."""
    w = H._header_bits(mlen, lgwin, tables, split)
    bits = w.bit_pos
    raw = w.finish()
    words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4), "<u4")
    rem = bits % 32
    partial = int(words[bits // 32]) & ((1 << rem) - 1) if rem else 0
    return words[: bits // 32], partial, rem


@pytest.mark.parametrize("name", list(KNOBS))
def test_headers_built_once(name, monkeypatch):
    """_headers_once (each distinct header built once, in C++) == _headers
    (each built twice through _header_bits), and each distinct header's
    words, tail and bit count == one _header_bits build's."""
    state, kw = _state(name)
    tables, group_of, split = _tables_and_split(
        state, kw.get("table_groups", 1), kw.get("lit_ctx_trees", 1))
    builds = []
    orig = E._header_words_native

    def counted(*args):
        builds.append(args)
        got = orig(*args)
        want = _header_bits_once(*args)
        assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]
        return got

    monkeypatch.setattr(E, "_header_words_native", counted)
    got = E._headers_once(state, 22, tables, group_of, split)
    want = E._headers(state, 22, tables, group_of, split)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # one build a distinct header: the stack's rows
    assert len(builds) == want[4].shape[0]


def _random_tables(rng, nt: int, nbt: int) -> dict:
    """Random group tables in _group_tables_from_hists' form, some trees of
    0, 1, 2-4 and many symbols, and a random context map."""
    from brotli_tpu_torch.encode.entropy import build_huffman_code

    def code(n):
        k = rng.choice([0, 1, 2, 3, 4, 5, 40, n])
        h = np.zeros(n, np.int64)
        h[rng.choice(n, k, replace=False)] = rng.integers(1, 5000, k)
        return build_huffman_code(h.tolist(), n)

    cmap = rng.integers(0, nt, nbt * 64)
    cmap[:nt] = np.arange(nt)
    return dict(lits=[code(256) for _ in range(nt)], cmap=cmap,
                cmd=code(704), dist=code(64), mode=int(rng.choice([2, 3])))


@pytest.mark.parametrize("nbt", [1, 2, 3, 7])
def test_header_words_native_random(nbt):
    """The C++ header == _header_bits (one build) on random tables: every
    tree size class, context maps with long zero runs, block-split trees
    and first block lengths across the length codes."""
    rng = np.random.default_rng(nbt)
    for case in range(40):
        nt = int(rng.integers(1, 9))
        t = _random_tables(rng, nt, nbt)
        if case % 3 == 0:
            t["cmap"][nt:] = 0
        split = None
        if nbt > 1:
            split = dict(nbt=nbt, t0=int(rng.integers(0, nbt)),
                         first_blen=int(rng.integers(1, 16625)),
                         thist=rng.integers(0, 3, nbt + 2).tolist(),
                         lhist=rng.integers(0, 3, 26).tolist())
            split["thist"][2] += 1
            split["lhist"][0] += 1
        mlens = (1, 2, 100, 4096, 32768, 65537, 1 << 24)
        lgwins = (10, 16, 17, 22, 24)
        for k in range(3):   # every size and window over the cases
            mlen = mlens[(3 * case + k) % len(mlens)]
            lgwin = lgwins[(3 * case + k) % len(lgwins)]
            got = H._header_words_native(mlen, lgwin, t, split)
            want = _header_bits_once(mlen, lgwin, t, split)
            assert np.array_equal(got[0], want[0]) and got[1:] == want[1:]


def _pack_fields(pb) -> dict:
    return {k: v for k, v in pb.__dict__.items()}


@pytest.mark.parametrize("name", list(KNOBS))
def test_pack_batch_equal(name, poisoned):
    state, kw = _state(name)
    groups, nt = kw.get("table_groups", 1), kw.get("lit_ctx_trees", 1)
    want_pb, want_hdr, want_h = E.prepare_pack(state, 22, groups, nt)
    got_pb, got_hdr, got_h = E.prepare_pack_pinned(
        {**state, "pinned": []}, 22, groups, nt)
    for k, v in _pack_fields(want_pb).items():
        g = getattr(got_pb, k)
        if isinstance(v, torch.Tensor):
            assert g.dtype == v.dtype and torch.equal(g, v), k
            assert g.is_contiguous(), k
        else:
            assert g == v, k
    for a, b in zip(got_hdr, want_hdr):
        assert torch.equal(a, b)
    assert np.array_equal(got_h, want_h)


def _old_streams(state: dict, kw: dict):
    """The yardstick's half from the state on (prepare_pack,
    assemble_streams, _old_encode_finish): (streams, stream_sizes, the
    pack kernel's output)."""
    pb, hdr, h_np = E.prepare_pack(state, 22, kw.get("table_groups", 1),
                                   kw.get("lit_ctx_trees", 1))
    words, status = E.pack_records(pb)
    old = {**state, "pb": pb, "h_np": h_np, "lgwin": 22, "words": words,
           "status": status,
           "swords": E.assemble_streams(words, status, *hdr)}
    return E._old_encode_finish(old), E.stream_sizes(old), (words, status)


@pytest.mark.parametrize("name", list(KNOBS))
def test_streams_and_sizes_equal(name, poisoned):
    """The new assembly, fetch and cut on the pack kernel's output (the
    pack runs once: test_pack_batch_equal holds the two PackBatches
    equal, and tests/test_torch_encode_e2e.py runs the whole new driver)."""
    state, kw = _state(name)
    want, want_sizes, (words, status) = _old_streams(state, kw)
    new = {**state, "pinned": []}
    _, hdr, h_np = E.prepare_pack_pinned(new, 22, kw.get("table_groups", 1),
                                         kw.get("lit_ctx_trees", 1))
    new.update(h_np=h_np, hdr=hdr, lgwin=22, words=words, status=status,
               counts=E._lane_counts(status, hdr[0], state["n_chunks"]))
    sizes = E.stream_sizes(new)
    got = E._encode_finish(new)
    assert got == want
    assert np.array_equal(sizes, want_sizes)
    assert list(sizes) == [len(s) for s in got]


def test_overflowed_lane_host_encoded_and_counted(monkeypatch):
    state, kw = _state("groups2_mixed")
    want = _old_streams(state, kw)[0]
    orig = E.pack_records

    def flag(pb):
        words, status = orig(pb)
        status[5, 2] = 1
        return words, status

    monkeypatch.setattr(E, "pack_records", flag)
    before = E.encode_fallback_stats()
    new = {**state, "pinned": []}
    E._encode_mid(new, 22, kw["table_groups"], 1)
    got = E._encode_finish(new)
    after = E.encode_fallback_stats()
    assert after["lanes_fallback"] == before["lanes_fallback"] + 1
    assert after["lanes_total"] == before["lanes_total"] + len(got)
    data, chunk = state["data"], state["chunk_size"]
    assert got[2] == host_encode(data[2 * chunk: 3 * chunk], quality=2,
                                 lgwin=22)
    assert got[:2] + got[3:] == want[:2] + want[3:]
    assert brotli_tpu_torch.host_decode(got[2]) == data[2 * chunk: 3 * chunk]


def test_multichip_encode_equals_one_slot():
    chunk = 64
    step = E.B_LANES * chunk
    data = (_bytes(step // 2, seed=5)
            + KNOBS["default"][0]() * (2 * step // len(KNOBS["default"][0]())
                                       + 1))[: 2 * step + 3000]
    got = M.encode_batches_multichip(data, M.get_mesh(4, "cpu"),
                                     chunk_size=chunk, table_groups=2)
    single = []
    for off in range(0, len(data), step):
        single += brotli_tpu_torch.encode_device_batch(
            data[off: off + step], device="cpu", chunk_size=chunk,
            table_groups=2)
    assert got == single
    assert len(got) == -(-len(data) // chunk)
    assert b"".join(brotli_tpu_torch.host_decode(s) for s in got) == data
