"""The v3 decode's C++ host preflight (ops/preflight3_native.py,
native/preflight3.cpp) against the port's Python preflight
(ops/preflight3.py), which tests/test_torch_host_copy.py holds equal to the
JAX package's.

* unit for unit: every field of the native entropy state (the bin's
  tables, GroupCfg and the unit's scalars) equals `_MetablockState` read
  at the same bit, on accepted streams; both refuse the same streams,
  header truncations included;
* batches: equal to preflight_v3 / assemble_v3 field for field where no
  two streams differ only in their initial block lengths; on device
  block-type streams, fewer groups with the same bytes and per-lane
  status rows on the CPU decode, equal to the host decoder's;
* 1 and 4 threads, and a hash that makes every key collide, give the same
  result;
* the multi-metablock path's native header walk equals the host decoder's
  loop from every header of the full-path streams, truncations included.

Inputs are made here from a seed and in-repo text; nothing of JAX is
compiled.  Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest

import brotli_tpu_torch as T
from brotli_tpu_torch.decode import engine as E
from brotli_tpu_torch.decode.bitreader import BitReader, BrotliError
from brotli_tpu_torch.encode import metablock_full as MF
from brotli_tpu_torch.ops import decode3 as D3
from brotli_tpu_torch.ops import preflight3 as P
from brotli_tpu_torch.ops import preflight3_native as N
from brotli_tpu_torch.utils.benchmarks import corpus

LCH, CCH, DCH, BTCH, BLCH = P.LCH, P.CCH, P.DCH, P.BTCH, P.BLCH


def _text(n: int, skip: int) -> bytes:
    return corpus(n + skip)[skip:]


def _split_encode(data: bytes, k: int) -> bytes:
    """Host q9 with k block types in each category (round-robin blocks)."""
    def split(commands, data, offset, mask, quality, lit_s, cmd_s, dist_s):
        counts = (sum(c.insert_len for c in commands), len(commands),
                  sum(1 for c in commands if c.cmd_prefix >= 128))
        for bs, cnt, size in zip((lit_s, cmd_s, dist_s), counts, (8, 2, 2)):
            bs.lengths = [min(size, cnt - p) for p in range(0, cnt, size)]
            bs.types = [i % k for i in range(len(bs.lengths))]
            bs.num_blocks = len(bs.lengths)
            bs.num_types = max(1, min(k, len(bs.lengths)))

    orig = MF.split_block
    MF.split_block = split
    try:
        return T.host_encode(data, quality=9)
    finally:
        MF.split_block = orig


def _streaming(data: bytes, block_bits: int) -> bytes:
    enc = T.Encoder(quality=5, lgwin=18)
    enc.params.lgblock = block_bits
    out = b"".join(enc.update(data[i: i + 1024])
                   for i in range(0, len(data), 1024))
    return out + enc.finish()


_CACHE: dict = {}


def _cached(key, make):
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


def _kinds() -> dict:
    def make():
        texts = [_text(3000, 10000 * s) for s in range(1, 4)]
        return {
            "q5": [T.host_encode(texts[0], quality=5)],
            "q9": [T.host_encode(texts[1], quality=9)],
            "q11": [T.host_encode(texts[2], quality=11)],
            "ctx trees": T.encode_device_batch(
                _text(4096, 50000), device="cpu", chunk_size=1024,
                lit_ctx_trees=4),
            "block types": _block_type_streams(),
            "12 types": [_split_encode(_text(4000, 70000), 12)],
            "16 types": [_split_encode(_text(4000, 70000), 16)],
            "multi-metablock": [_streaming(_text(3072, 80000), 10)],
            "uncompressed": [T.host_encode(texts[0], quality=0)],
            "empty": [T.host_encode(b"", quality=5), b"", b"\x00"],
        }
    return _cached("kinds", make)


def _block_type_streams() -> list[bytes]:
    """Device-encoded streams with 3 block types, 2 KB each."""
    return _cached("btypes", lambda: T.encode_device_batch(
        _text(4 * 2048, 90000), device="cpu", chunk_size=2048,
        lit_ctx_trees=4, block_types=3, block_seg=512))


REFUSED = {"12 types", "16 types", "multi-metablock", "uncompressed",
           "empty"}


def _padded_eq(padded: np.ndarray, table) -> bool:
    t = np.asarray(table if table is not None else [], np.int64)
    return (t.shape[0] <= padded.shape[0]
            and (padded[: t.shape[0]] == t).all()
            and not padded[t.shape[0]:].any())


def _assert_state(parsed: N.Parsed, u: int, st, mlen: int, bit: int,
                  maxbw: int) -> None:
    """Every field of _MetablockState `st` against unit u's bin and
    scalars."""
    row = parsed.units[u]
    assert row[0] == 1
    assert (row[1], row[2], row[3]) == (mlen, bit, maxbw)
    assert row[4:7].tolist() == [min(b, 1 << 28) for b in st.block_len]
    b = int(row[7])
    cfg = parsed.cfg[b].tolist()
    assert cfg == [len(st.lit_group), len(st.cmd_group), len(st.dist_group),
                   *st.num_types, st.npostfix, st.ndirect, maxbw,
                   int(st.trivial_literal)]
    tab = parsed.pool[parsed.offsets[b]: parsed.offsets[b + 1]]
    off = 0

    def take(chunks):
        nonlocal off
        off += chunks * 128
        return tab[off - chunks * 128: off]

    for grp, ch in ((st.lit_group, LCH), (st.cmd_group, CCH),
                    (st.dist_group, DCH)):
        for t in grp:
            assert _padded_eq(take(ch), t)
    for c in range(3):
        assert (st.type_tables[c] is None) == (st.num_types[c] < 2)
        assert _padded_eq(take(BTCH), st.type_tables[c])
    for c in range(3):
        assert _padded_eq(take(BLCH), st.len_tables[c])
    lcm, dcm = P._lcmch(st.num_types[0]), P._dcmch(st.num_types[2])
    cm = take(lcm + dcm + 1)
    assert _padded_eq(cm[: lcm * 128], st.cmap)
    assert _padded_eq(cm[lcm * 128: (lcm + dcm) * 128], st.dist_cmap)
    assert _padded_eq(cm[(lcm + dcm) * 128:],
                      [m << 9 for m in st.context_modes])
    dx = take(5)
    n = len(st.dist_extra)
    assert (dx[:n] >> 26).tolist() == st.dist_extra
    assert (dx[:n] & ((1 << 26) - 1)).tolist() == st.dist_offset
    assert not dx[n:].any() and off == tab.shape[0]


def _assert_same_units(streams, parsed: N.Parsed) -> None:
    """Stream for stream: refused on both sides, or the same state."""
    for u, s in enumerate(streams):
        pre = P.preflight_one_v3(s)
        assert (pre is None) == (parsed.units[u, 0] != 1), u
        if pre is not None:
            _assert_state(parsed, u, pre.st, pre.mlen, pre.cmd_start_bit,
                          pre.maxbw)


def _parse(streams, **kw) -> N.Parsed:
    return N.parse_units(N.stage_streams(streams),
                         np.arange(len(streams)), max_bins=64, **kw)


@pytest.mark.parametrize("kind", ["q5", "q9", "q11", "ctx trees",
                                  "block types", "12 types", "16 types",
                                  "multi-metablock", "uncompressed",
                                  "empty"])
def test_units_match_python_state(kind):
    streams = _kinds()[kind]
    parsed = _parse(streams)
    _assert_same_units(streams, parsed)
    if kind in REFUSED:
        assert (parsed.units[:, 0] != 1).all() and parsed.n_bins == 0
        assert N.preflight_v3_native(streams, max_groups=64) is None
    else:
        assert (parsed.units[:, 0] == 1).all()


@pytest.mark.parametrize("kind", ["q9", "ctx trees"])
def test_header_truncations_agree(kind):
    """Every cut of a stream inside its header and table bytes: both
    preflights refuse it, or both read the same state."""
    s = _kinds()[kind][0]
    end = P.preflight_one_v3(s).cmd_start_bit // 8 + 1
    cuts = [s[:k] for k in range(end + 1)]
    parsed = _parse(cuts)
    _assert_same_units(cuts, parsed)
    assert (parsed.units[:8, 0] != 1).all() and parsed.units[-1, 0] == 1


def _metablocks(stream: bytes):
    """(table bit, command bit, mlen, state, earlier output, maxbw, end
    bit) of each compressed metablock, read by the host decoder's own
    loop."""
    br = BitReader(stream)
    wbits, _ = E._decode_window_bits(br, False)
    out = E._Output()
    ring, ring_idx = [16, 15, 11, 4], 3
    found = []
    input_end = False
    while not input_end:
        input_end = bool(br.read(1))
        if input_end and br.read(1):
            break
        mbl, is_unc, is_meta = E._read_metablock_length(br, input_end)
        if is_meta or is_unc:
            br.jump_to_byte_boundary()
            data = br.copy_bytes(mbl)
            if is_unc:
                out.append(data)
            continue
        if mbl == 0:
            continue
        bit = br.bitpos
        st = E._MetablockState(br, False)
        # a state of its own: the command loop moves st's block lengths
        again = BitReader(stream)
        again.bitpos = bit
        entry = (bit, br.bitpos, mbl, E._MetablockState(again, False),
                 bytes(out.buf[: out.pos]), (1 << wbits) - 16)
        ring_idx = E._command_loop(br, st, out, mbl, (1 << wbits) - 16,
                                   ring, ring_idx, [], [0], 0)
        found.append(entry + (br.bitpos,))
    return found


def _full_streams() -> dict:
    def make():
        data = _text(3072, 110000)
        return {
            "streaming": _streaming(data, 11),
            "spliced": T.parallel_encode(data, shard_size=1024, quality=5,
                                         num_workers=1),
            "1 KB metablocks": _streaming(data, 10),
            "12 types": _kinds()["12 types"][0],
        }
    return _cached("full", make)


@pytest.mark.parametrize("name", ["streaming", "spliced", "1 KB metablocks",
                                  "12 types"])
def test_full_path_rounds_match_python_state(name):
    """At every compressed metablock of the full-path streams, the native
    parse at its table bit equals _MetablockState read there."""
    stream = _full_streams()[name]
    mbs = _metablocks(stream)
    assert len(mbs) >= (1 if name == "12 types" else 2)
    st = N.stage_streams([stream])
    parsed = N.parse_units(st, np.zeros(len(mbs)), [m[0] for m in mbs],
                           [m[5] for m in mbs], full=True, max_bins=64)
    for u, (_, end, mlen, state, _, maxbw, _) in enumerate(mbs):
        _assert_state(parsed, u, state, 0, end, maxbw)


def _assert_same_batch(a, b) -> None:
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert (x == y).all(), f.name
        else:
            assert x == y, f.name


def test_batch_equals_preflight_v3():
    """Host q5/q9/q11 and device context-mapped streams, whose groups no
    block length splits: the whole V3Batch equals preflight_v3's, at a cap
    that holds them and at one that does not."""
    k = _kinds()
    streams = k["q9"] + k["ctx trees"] + k["q5"] + k["q11"] + k["ctx trees"]
    ref = P.preflight_v3(streams, max_groups=8)
    assert ref is not None and ref.groups == 4
    _assert_same_batch(N.preflight_v3_native(streams, max_groups=8), ref)
    assert P.preflight_v3(streams, max_groups=3) is None
    assert N.preflight_v3_native(streams, max_groups=3) is None
    assert N.preflight_v3_native([], max_groups=8) is None
    assert N.preflight_v3_native(streams + k["uncompressed"]) is None


def test_full_round_batches_equal_assemble_v3():
    """One round a metablock index over the full-path streams (histories,
    rings and positions of their own): the batch equals assemble_v3's."""
    streams = list(_full_streams().values())
    mbs = [_metablocks(s) for s in streams]
    staged = N.stage_streams(streams)
    for r in range(max(map(len, mbs))):
        entries, idx = [], []
        for i, m in enumerate(mbs):
            if r >= len(m):
                continue
            bit, end, mlen, state, hist, maxbw, _ = m[r]
            rings = (4 + i, 11 + r, 15, 16 + len(hist) % 7)
            words = np.frombuffer(streams[i] + bytes((-len(streams[i])) % 4
                                                     + 12), "<u4")
            entries.append(P._EntryV3(
                idx=i, st=state, words=words, bitpos=end, mlen=mlen,
                maxbw=maxbw, sig=P._sig_of(state), pos0=len(hist),
                p1=hist[-1] if hist else 0,
                p2=hist[-2] if len(hist) >= 2 else 0, rings=rings,
                hist=hist))
            idx.append((i, bit))
        ref = P.assemble_v3(entries, max_groups=8)
        units = N.V3Units(
            streams=staged, stream=np.array([i for i, _ in idx]),
            bit=np.array([b for _, b in idx]),
            mlen=np.array([e.mlen for e in entries]),
            maxbw=np.array([e.maxbw for e in entries]),
            extras=np.array([(e.pos0, e.p1, e.p2, *e.rings)
                             for e in entries]).T,
            hist=[e.hist for e in entries])
        _assert_same_batch(N.preflight_units_v3_native(units, max_groups=8),
                           ref)
        if r:
            assert ref.HR > 0


def test_block_type_batch():
    """Device block-type streams, each with its own initial block lengths:
    preflight_v3 makes a group a stream, the native preflight fewer.  Per
    lane (mapped through perm), the status rows and bytes of the CPU decode
    (the kernel's per-lane code built with g++) are the same under both
    binnings and equal the host decoder's; decode_batch_v3 takes them all
    on the device, with no fallback."""
    streams = _block_type_streams()
    old = P.preflight_v3(streams, max_groups=64)
    new = N.preflight_v3_native(streams, max_groups=64)
    assert old.groups == len(streams) and new.groups < old.groups
    want = [T.host_decode(s) for s in streams]

    def lanes(batch):
        out, status = D3.decode3_host(D3.batch_to_torch_v3(batch, "cpu"))
        got = {}
        for slot in np.flatnonzero(batch.perm >= 0):
            i = int(batch.perm[slot])
            got[i] = (status[:, slot].tolist(),
                      out[slot, : batch.mlens[slot]].numpy().tobytes())
        return got

    a, b = lanes(old), lanes(new)
    assert a == b
    assert all(b[i][0][0] == 0 and b[i][1] == want[i] for i in b)
    before = T.fallback_stats()["lanes_fallback"]
    assert T.decode_batch_v3(streams, device="cpu",
                             max_groups=new.groups) == want
    assert T.fallback_stats()["lanes_fallback"] == before


def test_threads_and_collisions_agree(monkeypatch):
    """1 and 4 threads, and a hash and-ed with 0 (every key collides, so
    memcmp alone tells the bins apart), give the same units and bins."""
    k = _kinds()
    streams = (k["ctx trees"] + k["block types"] + k["q9"] + k["12 types"]
               + k["q5"] + k["ctx trees"]) * 40
    monkeypatch.setattr(N, "N_THREADS", 1)
    one = _parse(streams)
    assert one.n_bins >= 4
    for threads, mask in ((4, N._HASH_MASK), (4, 0), (3, 1)):
        monkeypatch.setattr(N, "N_THREADS", threads)
        monkeypatch.setattr(N, "_HASH_MASK", mask)
        other = _parse(streams)
        assert (other.units == one.units).all() and other.n_bins == one.n_bins
        assert (other.cfg == one.cfg).all()
        assert (other.offsets == one.offsets).all()
        assert (other.pool == one.pool).all()
    first = {}
    for u, b in enumerate(one.units[:, 7]):
        first.setdefault(int(b), u)
    ok = sorted(b for b in first if b >= 0)
    assert ok == list(range(one.n_bins))
    assert [first[b] for b in ok] == sorted(first[b] for b in ok)


def test_over_the_bin_budget():
    """More bins than max_bins: the units are still parsed and binned, and
    no tables are written."""
    k = _kinds()
    streams = k["q5"] + k["q9"] + k["q11"]
    few = _parse(streams)
    capped = N.parse_units(N.stage_streams(streams), np.arange(3),
                           max_bins=2)
    assert capped.n_bins == few.n_bins == 3 and capped.cfg is None
    assert (capped.units == few.units).all()


def test_parse_units_checks_its_input():
    """A unit that names no stream of the batch, or a negative start bit,
    raises before the native call; a start bit past the stream's end is
    refused like any truncation."""
    st = N.stage_streams(_kinds()["q5"])
    for bad in ([1], [-1]):
        with pytest.raises(ValueError):
            N.parse_units(st, bad)
    with pytest.raises(ValueError):
        N.parse_units(st, [0], [-8], [1 << 16], full=True)
    far = N.parse_units(st, [0], [1 << 20], [1 << 16], full=True)
    assert far.units[0, 0] == -10 and far.n_bins == 0


def test_drivers_reach_no_python_state(monkeypatch):
    """decode_batch_v3 and decode_batch_v3_full read no _MetablockState and
    no _sig_of (both made to raise), and decode with no fallback."""
    def boom(*a, **k):
        raise AssertionError("the Python preflight was reached")

    data = _text(2048, 120000)
    streams = T.encode_device_batch(data, device="cpu", chunk_size=1024,
                                    lit_ctx_trees=4)
    full = _streaming(data, 10)
    monkeypatch.setattr(E._MetablockState, "__init__", boom)
    monkeypatch.setattr(P, "_sig_of", boom)
    monkeypatch.setattr(P, "preflight_one_v3", boom)
    before = T.fallback_stats()["lanes_fallback"]
    assert b"".join(T.decode_batch_v3(streams, device="cpu")) == data
    assert T.decode_batch_v3_full([full], device="cpu") == [data]
    assert T.fallback_stats()["lanes_fallback"] == before


def test_stage_streams_layout():
    """Each stream's words, zero-padded as preflight_one_v3 pads them."""
    streams = [b"", b"a", b"abcde", bytes(range(256)) * 3]
    st = N.stage_streams(streams)
    for s, off, n, nw in zip(streams, st.offsets, st.lens, st.n_words):
        want = np.frombuffer(s + bytes((-len(s)) % 4 + 12), "<u4")
        assert n == len(s) and off % 4 == 0
        assert (st.words[off // 4: off // 4 + nw] == want).all()


def _py_walk(stream: bytes, bit: int) -> tuple:
    """The header walk as the host decoder's loop reads it (decode/engine.py):
    from `bit` (0 = the window bits first) to the next compressed metablock.
    (status, MLEN, table bit, maxbw, ISLAST, bytes copied), with
    status 1 = compressed, 0 = ended, else the error code."""
    br = BitReader(stream)
    copied, maxbw = bytearray(), 0
    try:
        if bit == 0:
            wbits, _ = E._decode_window_bits(br, False)
            maxbw = (1 << wbits) - 16
        else:
            br.bitpos = bit
        while True:
            br.check_health()
            input_end = bool(br.read(1))
            if input_end and br.read(1):
                break
            mbl, is_unc, is_meta = E._read_metablock_length(br, input_end)
            if is_meta or is_unc:
                br.jump_to_byte_boundary()
                data = br.copy_bytes(mbl)
                if is_unc:
                    copied += data
            elif mbl:
                return (1, mbl, br.bitpos, maxbw, int(input_end),
                        bytes(copied))
            if input_end:
                break
    except BrotliError as e:
        return (e.code, 0, 0, maxbw, 0, bytes(copied))
    return (0, 0, 0, maxbw, 0, bytes(copied))


def _assert_walks(streams, bits) -> None:
    walked = N.walk_units(N.stage_streams(streams), np.arange(len(streams)),
                          bits)
    for u, (s, b) in enumerate(zip(streams, bits)):
        got = (*walked.units[u, :5].tolist(), walked.copy_of(u))
        assert got == _py_walk(s, int(b)), (u, b)


def _walk_streams() -> dict:
    f = _full_streams()
    return {"streaming": f["streaming"], "spliced": f["spliced"],
            "1 KB metablocks": f["1 KB metablocks"],
            "uncompressed": _kinds()["uncompressed"][0],
            "q9": _kinds()["q9"][0]}


@pytest.mark.parametrize("name", ["streaming", "spliced", "1 KB metablocks",
                                  "uncompressed", "q9"])
def test_header_walk_matches_host_loop(name):
    """From the stream's first bit and from the end of each compressed
    metablock: the native walk's status, MLEN, table bit, maxbw, ISLAST and
    copied uncompressed bytes equal the host decoder's loop's."""
    stream = _walk_streams()[name]
    bits = [0] + [m[6] for m in _metablocks(stream)]
    _assert_walks([stream] * len(bits), bits)
    if name == "uncompressed":
        # uncompressed metablocks only: one walk copies the whole output
        walked = N.walk_units(N.stage_streams([stream]), [0], [0])
        assert len(bits) == 1 and walked.units[0, 0] == 0
        assert walked.copy_of(0) == T.host_decode(stream)


def test_header_walk_refusals_agree():
    """Every cut of the spliced and the uncompressed stream, from the first
    bit and from the spliced stream's second header, empty streams, a
    large-window stream and last metadata blocks: both walks end, error or
    stop in the same place with the same bytes."""
    w = _walk_streams()
    streams, bits = [], []
    second = _metablocks(w["spliced"])[0][6]
    for s in (w["spliced"], w["uncompressed"]):
        for k in range(0, len(s) + 1, max(1, len(s) // 600)):
            streams.append(s[:k])
            bits.append(0)
    for k in range(second // 8, min(len(w["spliced"]), second // 8 + 400)):
        streams.append(w["spliced"][:k])
        bits.append(second)
    # a large window (refused), and streams that end in a last metadata
    # block, of 0 and of 1 byte (the walk stops there)
    odd = [b"\x11", b"\x11\x00\x00", b"\x1a", b"\x5a\x00\xab"]
    streams += _kinds()["empty"] + odd
    bits += [0] * 7
    _assert_walks(streams, bits)
    assert [_py_walk(s, 0)[0] for s in odd] == [-11, -11, 0, 0]
    codes = set(N.walk_units(N.stage_streams(streams), np.arange(len(streams)),
                             bits).units[:, 0].tolist())
    assert {-11, 0, 1} <= codes and any(c < 0 and c != -11 for c in codes)
