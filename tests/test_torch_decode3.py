"""v3 full-format decode of the PyTorch port (brotli_tpu_torch.ops.decode3)
against the JAX v3 kernel (brotli_tpu.ops.pallas_decode3, interpret mode).

Tolerance: exact equality.  On every lane the JAX kernel does not flag, the
decoded bytes and the status rows (err, r_lane, phase, mbl, widx, avail,
r0..r3) must be identical; the set of flagged lanes (err != 0, or a lane
that read past its own words) must be identical too.  The JAX kernel runs
at H=512 (a 512-byte ring), so the cases stay near 1 KB a lane and one of
them copies from beyond H-16 through the reference's far-fetch window.

The corpus is built here from in-repo files and numpy-seeded bytes.  The
JAX results are computed once per case (interpret mode costs seconds per
group).
"""

from functools import lru_cache
from pathlib import Path
import shutil

import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch
from brotli_tpu.encode import encode
from brotli_tpu.encode import metablock_full as MF
from brotli_tpu.ops import pallas_decode3 as P3
from brotli_tpu_torch.ops import decode2 as D2
from brotli_tpu_torch.ops import decode3 as D3

ROOT = Path(__file__).resolve().parents[1]
H = 512


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _dict_text(n: int, skip: int) -> bytes:
    return (ROOT / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()[
        skip: skip + n]


def round_robin_splitter(k: int, seg=(8, 2, 2)):
    """A block splitter for metablock_full that cuts the literal, command
    and distance streams into blocks of seg symbols with types 0..k-1 in
    turn: k block types in every category."""
    def split(commands, data, offset, mask, quality, lit_s, cmd_s, dist_s):
        counts = (sum(c.insert_len for c in commands), len(commands),
                  sum(1 for c in commands if c.cmd_prefix >= 128))
        for bs, cnt, size in zip((lit_s, cmd_s, dist_s), counts, seg):
            bs.lengths = [min(size, cnt - p) for p in range(0, cnt, size)]
            bs.types = [i % k for i in range(len(bs.lengths))]
            bs.num_blocks = len(bs.lengths)
            bs.num_types = max(1, min(k, len(bs.lengths)))
    return split


def encode_split(data: bytes, k: int, quality: int = 9) -> bytes:
    """brotli_tpu.encode with k block types in each category."""
    orig = MF.split_block
    MF.split_block = round_robin_splitter(k)
    try:
        return encode(data, quality=quality)
    finally:
        MF.split_block = orig


def _trivial_stream(data: bytes, commands) -> bytes:
    from brotli_tpu.encode.api import _NO_MASK
    from brotli_tpu.encode.bitwriter import BitWriter, encode_window_bits
    from brotli_tpu.encode.metablock import store_metablock_trivial

    w = BitWriter()
    nb, val = encode_window_bits(22, False)
    w.write(nb, val)
    store_metablock_trivial(w, data, 0, len(data), _NO_MASK, True, commands,
                            64, 0, 0)
    return w.finish()


def dictionary_stream(transforms) -> tuple[bytes, bytes]:
    """Static-dictionary words only, one a transform of `transforms`, of
    lengths 6-10 (as tests/test_pallas_decode3.py builds them)."""
    from brotli_tpu.decode import dictionary as sd
    from brotli_tpu.decode.transforms import transform_word
    from brotli_tpu.encode.command import make_command

    parts, commands, pos = [], [], 0
    for k, tf in enumerate(transforms):
        wlen = 6 + (k % 5)
        shift = sd.size_bits(wlen)
        widx = (37 * k) % (1 << shift)
        out = transform_word(sd.get_word(wlen, widx), tf)
        distance = min(pos, (1 << 22) - 16) + 1 + ((tf << shift) | widx)
        commands.append(make_command(0, wlen, 0, distance + 15, 0, 0))
        parts.append(out)
        pos += len(out)
    expected = b"".join(parts)
    return _trivial_stream(expected, commands), expected


def op_class_transforms(below: int = 121) -> list[int]:
    """The first transform of each op class (identity, omit-last,
    uppercase-first, uppercase-all, omit-first), among those < below."""
    from brotli_tpu.decode.transforms import TRANSFORM_LIST

    chosen, seen = [], set()
    for tf, (_, op, _) in enumerate(TRANSFORM_LIST[:below]):
        if op not in seen:
            chosen.append(tf)
            seen.add(op)
    return chosen


def poisoned_stream() -> bytes:
    """8 literals, then a copy whose distance is past the window and the
    whole dictionary range."""
    from brotli_tpu.encode.command import make_command

    bogus = (1 << 22) + (1 << 25)
    return _trivial_stream(b"ABCDEFGH????",
                           [make_command(8, 4, 0, bogus + 15, 0, 0)])


def compound_stream(insert: bytes, copy_len: int, back: int) -> bytes:
    """insert, then copy_len bytes from `back` bytes before the end of the
    compound dictionary (tests/test_font_and_dict.py)."""
    from brotli_tpu.encode.bitwriter import BitWriter, encode_window_bits
    from brotli_tpu.encode.command import make_command
    from brotli_tpu.encode.metablock import store_metablock_trivial
    from brotli_tpu.encode.params import make_params

    params = make_params(5, 22, 0, 64)
    cmds = [make_command(len(insert), copy_len, 0, len(insert) + back + 15,
                         params.dist.ndirect, params.dist.npostfix)]
    w = BitWriter()
    nb, val = encode_window_bits(params.lgwin, False)
    w.write(nb, val)
    mlen = len(insert) + copy_len
    store_metablock_trivial(
        w, insert + b"\x00" * copy_len, 0, mlen, (1 << 62) - 1, True, cmds,
        params.dist_alphabet_size, params.dist.npostfix, params.dist.ndirect,
    )
    w.align_to_byte()
    return w.finish()


def truncate_body(stream: bytes) -> bytes:
    """Drop 3/4 of the stream past its metablock header."""
    hdr = P3.preflight_one_v3(stream).cmd_start_bit // 8 + 1
    return stream[: hdr + (len(stream) - hdr) // 4]


@lru_cache(maxsize=None)
def _port_ctx() -> tuple[bytes, ...]:
    return tuple(brotli_tpu_torch.encode_device_batch(
        _source_text(6 * 1024, skip=60000), device="cpu", chunk_size=1024,
        lit_ctx_trees=4, table_groups=2))


def _dictmix(n: int) -> bytes:
    return _dict_text(n // 2, 8000) + _source_text(n // 2, skip=50000)


def _far_copy() -> bytes:
    """A 300-byte passage repeated 900 bytes later: at q11 a copy from
    further back than H-16."""
    a = _source_text(300, skip=81000)
    return a + _source_text(600, skip=90000) + a


D1 = b"hello world dictionary content!"
CHUNKS = [b"AAAABBBB", b"CCCCDDDD"]


@lru_cache(maxsize=None)
def case(name: str):
    """name -> (streams, expected bytes or None per stream, kwargs)."""
    if name == "port_ctx_2groups":
        s = list(_port_ctx())
        return s, [None] * len(s), {}
    if name == "host_q9_q11_q5":
        # three table signatures, three groups: q9 with three block types in
        # every category, q11 over dictionary text, q5
        a = _source_text(1200, skip=70000)
        b = _dictmix(1536)
        c = _source_text(900, skip=20000)
        return ([encode_split(a, 3), encode(b, quality=11), encode(c, quality=5)],
                [a, b, c], {})
    if name == "dict_transforms":
        # below 64: the JAX kernel reads transform meta of tfi >= 64 from
        # tfi - 64 (test_all_transforms_match_host)
        s, exp = dictionary_stream(op_class_transforms(64))
        return [s], [exp], {}
    if name == "far_copy":
        d = _far_copy()
        return [encode(d, quality=11)], [d], {}
    if name == "poisoned":
        return [poisoned_stream()], [None], {}
    if name == "truncated":
        # the port_ctx batch with one lane cut short: the same kernel shape
        s = list(_port_ctx())
        s[1] = truncate_body(s[1])
        return s, [None] * len(s), {}
    if name == "no_dict":
        s, exp = dictionary_stream(op_class_transforms(64))
        return [s], [exp], {"use_dict": False}
    if name == "compound_d1":
        s = [compound_stream(b"abc", 8, len(D1)), compound_stream(b"xy", 4, 4)]
        return s, [b"abc" + D1[:8], b"xy" + D1[-4:]], {"custom_dictionary": D1}
    if name == "compound_chunks":
        exp = b"!" + b"".join(CHUNKS)[-14:][:12]
        return [compound_stream(b"!", 12, 14)], [exp], {
            "custom_dictionary": CHUNKS}
    if name == "compound_overflow":
        return [compound_stream(b"abc", 16, 4)], [None], {
            "custom_dictionary": b"tiny"}
    raise KeyError(name)


# lanes each case must flag, by stream index
FLAGGED = {"poisoned": {0}, "truncated": {1}, "no_dict": {0},
           "compound_overflow": {0}}
CASES = ["port_ctx_2groups", "host_q9_q11_q5", "dict_transforms", "far_copy",
         "poisoned", "truncated", "no_dict", "compound_d1", "compound_chunks",
         "compound_overflow"]


@lru_cache(maxsize=None)
def staged(name: str):
    streams, _, kw = case(name)
    batch = P3.preflight_v3(list(streams), max_groups=8)
    assert batch is not None, name
    return batch


@lru_cache(maxsize=None)
def jax_run(name: str):
    """JAX run_batch_v3 (interpret) -> (status (16, n) int64, bytes (n, B))."""
    _, _, kw = case(name)
    batch = staged(name)
    out, n_out = P3.run_batch_v3(batch, H=H, interpret=True, **kw)
    G = batch.groups
    status = out[:, n_out:n_out + D3.STATUS_ROWS].reshape(G, 16, -1)
    status = status.transpose(1, 0, 2).reshape(16, -1).astype(np.int64)
    words = np.transpose(out[:, :n_out], (0, 2, 3, 1)).reshape(G * 1024, -1)
    raw = np.ascontiguousarray(words).astype("<u4").view(np.uint8)
    return status, raw.reshape(G * 1024, -1)


def flagged(batch, status: np.ndarray) -> np.ndarray:
    return (status[0] != 0) | (status[4] > batch.n_words.astype(np.int64) + 4)


def port_run(name: str, fn=D3.decode3):
    _, _, kw = case(name)
    tb = D3.batch_to_torch_v3(staged(name), "cpu", kw.get("custom_dictionary"))
    out, status = fn(tb, kw.get("use_dict", True))
    return out[:, tb.hrb:].numpy(), status.numpy().astype(np.int64)


@lru_cache(maxsize=None)
def plain_run(name: str):
    return port_run(name)


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax(name):
    """Lanes neither side flags: bytes and status rows equal.  Malformed
    lanes: the port flags exactly those, and so does JAX.  JAX may also
    flag a sound lane for a limit of the TPU kernel alone (its shared word
    window and flush frontier wait on a stalled neighbour, and its global
    stagnation counter then flags every live lane); the port decodes such a
    lane, and its bytes must equal the host decoder's."""
    streams, expected, _ = case(name)
    batch = staged(name)
    jstatus, jraw = jax_run(name)
    out, status = plain_run(name)
    jflag, flag = flagged(batch, jstatus), flagged(batch, status)
    slot_of = {int(batch.perm[s]): s for s in range(len(batch.perm))
               if batch.perm[s] >= 0}
    want = FLAGGED.get(name, set())
    assert {i for i, s in slot_of.items() if flag[s]} == want
    assert {i for i, s in slot_of.items() if jflag[s]} >= want
    assert not flag[batch.perm < 0].any() and not jflag[batch.perm < 0].any()
    clean = ~jflag
    np.testing.assert_array_equal(status[:10, clean], jstatus[:10, clean])
    assert (status[1, ~flag] == (batch.mlens[~flag] + 3) // 4).all()
    assert (status[2, ~flag] == P3.DONE).all()
    for i, slot in slot_of.items():
        if i in want:
            continue
        got = out[slot, : batch.mlens[slot]].tobytes()
        assert got == (expected[i] if expected[i] is not None
                       else brotli_tpu.decode(streams[i]))
        if not jflag[slot]:
            assert got == jraw[slot, : batch.mlens[slot]].tobytes()


@pytest.mark.parametrize("name", CASES)
def test_host_shim_matches_plain(name):
    """csrc/decode3.cuh built by g++ == the plain PyTorch version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    ref_out, ref_status = plain_run(name)
    out, status = port_run(name, D3.decode3_host)
    np.testing.assert_array_equal(status, ref_status)
    np.testing.assert_array_equal(out, ref_out)


WINDOWS = [64, 2048]  # the smallest window (every copy of more than 48
                     # bytes back reads the slot) and the v3 cell's kind


def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")


@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("name", CASES)
def test_windowed_shim_matches_plain_and_jax(name, window):
    """The windowed kernel's per-lane code (csrc/decode3.cuh Ring3: the
    window, its 16-byte flushes, the 8-byte and repeating copies, the far
    path to the slot, the look-ahead queue) built by g++ == the plain
    version bit for bit, and == JAX on every lane JAX does not flag."""
    needs_gxx()
    ref_out, ref_status = plain_run(name)
    _, _, kw = case(name)
    tb = D3.batch_to_torch_v3(staged(name), "cpu", kw.get("custom_dictionary"))
    out, status = D3.decode3_host(tb, kw.get("use_dict", True), window=window)
    out, status = out[:, tb.hrb:].numpy(), status.numpy().astype(np.int64)
    np.testing.assert_array_equal(status, ref_status)
    np.testing.assert_array_equal(out, ref_out)
    jstatus, jraw = jax_run(name)
    clean = ~flagged(staged(name), jstatus)
    np.testing.assert_array_equal(status[:10, clean], jstatus[:10, clean])
    mlens = staged(name).mlens
    for slot in np.flatnonzero(clean & (mlens > 0)):
        assert (out[slot, : mlens[slot]].tobytes()
                == jraw[slot, : mlens[slot]].tobytes())


@pytest.mark.parametrize("name", CASES)
def test_direct_shim_matches_plain(name):
    """The direct kernel's per-lane code (csrc/decode3.cuh Direct3) built
    by g++ == the plain version."""
    needs_gxx()
    ref_out, ref_status = plain_run(name)
    _, _, kw = case(name)
    tb = D3.batch_to_torch_v3(staged(name), "cpu", kw.get("custom_dictionary"))
    out, status = D3.decode3_host(tb, kw.get("use_dict", True), direct=True)
    np.testing.assert_array_equal(status.numpy(), ref_status)
    np.testing.assert_array_equal(out[:, tb.hrb:].numpy(), ref_out)


def overlap_stream() -> tuple[bytes, bytes]:
    """Copies of every kind the window backend tells apart: distances 1-7
    that repeat a pattern (distance < length), 8 and 9 (8 bytes a step
    over their own output), a copy no longer than its distance, and
    distances around a 64-byte window's reach (48): 47, 48, 49 and 150,
    whose source is in flushed output."""
    from brotli_tpu.encode.command import make_command

    plan = [(b"abcde", 40, 1), (b"xyz", 37, 3), (b"Qr", 50, 7),
            (b"!", 64, 8), (b"0123", 30, 9), (b"uvw", 100, 100),
            (b"ij", 20, 150), (b"k", 33, 47), (b"l", 33, 48), (b"m", 33, 49),
            (b"no", 17, 5)]
    data, commands = bytearray(), []
    for lits, n, d in plan:
        data += lits
        for _ in range(n):
            data.append(data[-d])
        commands.append(make_command(len(lits), n, 0, d + 15, 0, 0))
    return _trivial_stream(bytes(data), commands), bytes(data)


@pytest.mark.parametrize("window", [64, 128, 2048])
def test_windowed_copies_match_plain(window):
    """overlap_stream through the windowed shim and the plain version: the
    same bytes and status, and the stream's bytes."""
    needs_gxx()
    stream, expected = overlap_stream()
    assert brotli_tpu.decode(stream) == expected
    tb = D3.batch_to_torch_v3(P3.preflight_v3([stream]), "cpu")
    ref = D3.decode3_ref(tb)
    got = D3.decode3_host(tb, window=window)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert ref[1][0, 0] == 0
    assert got[0][0, : len(expected)].numpy().tobytes() == expected


def test_words_ending_at_wpad():
    """The word table cut to the most words any lane of port_ctx_2groups
    consumed, so the longest lanes' look-ahead reaches Wpad and stops
    there: the windowed shim == the plain version on the cut table too."""
    import dataclasses

    needs_gxx()
    tb = D3.batch_to_torch_v3(staged("port_ctx_2groups"), "cpu")
    last = int(plain_run("port_ctx_2groups")[1][4].max())
    assert last < tb.wpad
    cut = dataclasses.replace(tb, wt=tb.wt[:last].contiguous())
    ref = D3.decode3_ref(cut)
    assert int(ref[1][4].max()) == last
    got = D3.decode3_host(cut, window=64)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_launch_config_fits_the_card():
    """launch_config on an H100's figures (132 SMs, 228 KB of shared
    memory each): the lane map, a power-of-two window the slot needs no
    more of, the tables within their budget, and one wave's blocks within
    each SM's shared memory."""
    tb = D3.batch_to_torch_v3(staged("port_ctx_2groups"), "cpu")
    smem = 228 * 1024
    for sms in (132, 16):
        lpw, win, tab = D3.launch_config(tb, sms, smem)
        lpb = 4 * lpw
        blocks_per_sm = -(-(tb.n_lanes // lpb) // sms)
        per_block = lpb * win + 4 * D3.QUEUE_R * lpb + 4 * tab
        assert lpw == D2.lanes_per_warp(tb.n_lanes, sms)
        assert win & (win - 1) == 0 and D3.WINDOW_MIN <= win
        assert win <= max(D3.WINDOW_MIN, tb.hrb + tb.out_cap) * 2
        assert tab <= min(D3.table_ints(tb.cfg_host), D3.TABLE_BUDGET)
        room = (smem // blocks_per_sm - 1024 - 4 * D3.QUEUE_R * lpb)
        if room >= min(D3.WINDOW_PREF, tb.hrb + tb.out_cap) * lpb:
            assert win >= min(D3.WINDOW_PREF, tb.hrb + tb.out_cap)
        assert blocks_per_sm * (per_block + 1024) <= smem
    assert D3.launch_config(tb, 132, smem)[2] == D3.table_ints(tb.cfg_host)
    assert D3._fit(tb, 8, 132, smem, 256)[:2] == (8, 256)
    # a table that does not fit is left in global memory whole, and the
    # ones after it are staged where they fit
    sizes = D3._table_sizes(tb.cfg_host)
    cap = int(sizes[:, :3].sum(axis=1).max()) + 1
    assert D3.table_ints(tb.cfg_host, cap) <= cap
    # a batch too large for a WINDOW_PREF window keeps its tables
    big = D3._fit(tb, 32, 1, smem)
    assert big[2] == min(D3.table_ints(tb.cfg_host), D3.TABLE_BUDGET)


def test_all_transforms_match_host():
    """Every one of the 121 transforms, each on a dictionary word: plain
    version and host shim equal the host decoder.  (The JAX kernel gathers
    transform meta from its first 128-entry chunk only, so transforms
    64-120 take the meta of transform tfi - 64 there; the port does not
    copy that.)"""
    stream, expected = dictionary_stream(range(121))
    assert brotli_tpu.decode(stream) == expected
    batch = P3.preflight_v3([stream])
    tb = D3.batch_to_torch_v3(batch, "cpu")
    out, status = D3.decode3(tb)
    assert status[0, 0] == 0 and status[2, 0] == P3.DONE
    assert out[0, : len(expected)].numpy().tobytes() == expected
    if shutil.which("g++") is not None:
        h_out, h_status = D3.decode3_host(tb)
        assert torch.equal(h_out, out) and torch.equal(h_status, status)


def test_flag_codes():
    """The lane-local codes: ERR_STREAM for the poisoned distance and the
    compound overflow, ERR_FAR_DIST for a dictionary word without the
    dictionary."""
    assert plain_run("poisoned")[1][0, 0] == P3.ERR_STREAM
    assert plain_run("compound_overflow")[1][0, 0] == P3.ERR_STREAM
    assert plain_run("no_dict")[1][0, 0] == P3.ERR_FAR_DIST


def test_compound_dictionary_decodes():
    """decode_batch_v3 with a compound dictionary: no fallback for the
    valid streams; the overflowing one flags and the host fallback
    raises."""
    for name in ("compound_d1", "compound_chunks"):
        streams, expected, kw = case(name)
        before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
        got = brotli_tpu_torch.decode_batch_v3(streams, device="cpu", **kw)
        assert got == expected
        assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == before
    streams, _, kw = case("compound_overflow")
    with pytest.raises(brotli_tpu_torch.BrotliError):
        brotli_tpu_torch.decode_batch_v3(streams, device="cpu", **kw)


def test_dict_dev_decodes_like_an_upload(monkeypatch):
    """dict_dev (the dictionary staged once by stage_dictionary) gives the
    bytes and status of a call without it, and the host decoder's bytes,
    through decode_batch_v3 and decode_batch_v3_full; the batch takes the
    staged tensor itself, and the calls then stage no dictionary."""
    streams, expected, _ = case("dict_transforms")
    batch = staged("dict_transforms")
    dict_dev = brotli_tpu_torch.stage_dictionary("cpu")
    tb = D3.batch_to_torch_v3(batch, "cpu", dict_dev=dict_dev)
    assert tb.dict is dict_dev
    with_dev = D3.run_batch_v3(batch, "cpu", dict_dev=dict_dev)
    for a, b in zip(with_dev, D3.run_batch_v3(batch, "cpu")):
        assert torch.equal(a, b)
    assert int(with_dev[1][0].abs().sum()) == 0

    dicts = []
    decode3 = D3.decode3
    monkeypatch.setattr(D3, "decode3", lambda tb, *a: dicts.append(tb.dict)
                        or decode3(tb, *a))
    before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    full_in = streams * 3
    for fn, ins, want in ((D3.decode_batch_v3, streams, expected),
                          (D3.decode_batch_v3_full, full_in, expected * 3)):
        got = fn(ins, device="cpu", dict_dev=dict_dev)
        assert got == want == [brotli_tpu.decode(s) for s in ins]
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == before
    assert len(dicts) == 2 and all(d is dict_dev for d in dicts)


def test_dict_dev_rejects_a_bad_tensor():
    streams, _, _ = case("dict_transforms")
    good = D3.stage_dictionary("cpu")
    for bad in (good.to(torch.int32), good[:-512], good.reshape(-1, 512),
                good.numpy()):
        with pytest.raises((ValueError, TypeError), match="dict_dev"):
            D3.decode_batch_v3(streams, device="cpu", dict_dev=bad)
    with pytest.raises(ValueError, match="dict_dev"):
        D3.decode_batch_v3_full(streams, device="cpu",
                                dict_dev=good.to("meta"))


@pytest.mark.parametrize("name", ["decode_batch_v3", "decode_batch_v3_full"])
def test_decode_keywords_match_jax(name):
    """Every keyword of the JAX function but the TPU-only H and interpret
    exists on the port's."""
    import inspect

    jax_kw = set(inspect.signature(getattr(P3, name)).parameters)
    port_kw = set(inspect.signature(getattr(D3, name)).parameters)
    assert jax_kw - {"H", "interpret"} <= port_kw


def test_batch_to_torch_v3_layout():
    """Tables un-replicated per group at their config offsets, scal rows
    per lane, history right-aligned."""
    import dataclasses

    streams = list(_port_ctx()[:2]) + [encode_split(_source_text(1200, 70000), 3)]
    batch = P3.preflight_v3(streams, max_groups=8)
    tb = D3.batch_to_torch_v3(batch, "cpu")
    G = batch.groups
    assert tb.n_lanes == G * 1024 and tb.hist is None
    wt = tb.wt.numpy().view(np.uint32)
    for lane in (0, 1, 130, 1023, G * 1024 - 1):
        g, s = divmod(lane, 1024)
        np.testing.assert_array_equal(wt[:, lane],
                                      batch.wt[:, g * 8 + s // 128, s % 128])
        for r in range(P3.SCAL_ROWS):
            assert tb.scal[r, lane] == batch.scal[(g * P3.SCAL_ROWS + r) * 8
                                                  + s // 128, s % 128]
    cfg = tb.cfg.numpy()
    for g, c in enumerate(batch.configs):
        assert tuple(cfg[g, :10]) == (c.NL, c.NC, c.ND, c.NBT0, c.NBT1,
                                      c.NBT2, c.npostfix, c.ndirect, c.maxbw,
                                      int(c.trivial_lit))
    split = [i for i in range(G) if batch.configs[i].NBT0 == 3][0]
    st = P3.preflight_one_v3(streams[2]).st
    lit = tb.lit.numpy()
    for t, tree in enumerate(st.lit_group):
        off = cfg[split, D3.CFG_OFF_LIT] + t * P3.LCH * 128
        np.testing.assert_array_equal(lit[off: off + len(tree)], tree)
    cmap = tb.cmap.numpy()
    o = cfg[split, D3.CFG_OFF_CMAP]
    np.testing.assert_array_equal(cmap[o: o + len(st.cmap)], st.cmap)
    modes = o + (cfg[split, D3.CFG_LCMCH] + cfg[split, D3.CFG_DCMCH]) * 128
    assert list(cmap[modes: modes + 3]) == [m << 9 for m in st.context_modes]
    assert tb.dict.numel() % 512 == 0 and tb.tfs.numel() % 512 == 0
    assert bytes(tb.dict[:64].numpy()) == _dict_text(64, 0)
    # a history prefix lands right-aligned in hrb bytes
    e = P3._EntryV3(idx=0, st=st, words=P3.preflight_one_v3(streams[2]).words,
                    bitpos=P3.preflight_one_v3(streams[2]).cmd_start_bit,
                    mlen=1200, maxbw=(1 << 22) - 16, sig=P3._sig_of(st),
                    hist=b"xyz")
    hb = P3.assemble_v3([e, dataclasses.replace(e, idx=1, hist=b"")])
    tbh = D3.batch_to_torch_v3(hb, "cpu")
    assert tbh.hrb == 4 * hb.HR and tbh.hrb >= 3
    slot = int(np.flatnonzero(hb.perm == 0)[0])
    assert bytes(tbh.hist[slot, -3:].numpy()) == b"xyz"
    assert not tbh.hist[slot, :-3].any() and not tbh.hist[1 - slot].any()


def test_decode3_rejects_bad_tensors():
    tb = D3.batch_to_torch_v3(staged("poisoned"), "cpu")
    tb.scal = tb.scal.to(torch.int64)
    with pytest.raises(ValueError, match="scal"):
        D3.decode3(tb)
    tb = D3.batch_to_torch_v3(staged("poisoned"), "cpu")
    tb.cfg_host = tb.cfg_host.copy()
    tb.cfg_host[0, D3.CFG_OFF_LIT] = tb.lit.numel()
    with pytest.raises(ValueError, match="lit"):
        D3.decode3(tb)
    tb = D3.batch_to_torch_v3(staged("poisoned"), "cpu")
    tb.out_cap = 4
    with pytest.raises(ValueError, match="out_cap"):
        D3.decode3(tb)


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        brotli_tpu_torch.decode_batch_v3(case("far_copy")[0], device="cuda")


@pytest.mark.cuda
def test_kernel_matches_plain_on_card(monkeypatch):
    """The CUDA kernel == the plain version on CUDA tensors (needs a card),
    at its own launch config and at other lane maps and windows."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    for name in CASES:
        _, _, kw = case(name)
        tb = D3.batch_to_torch_v3(staged(name), "cuda",
                                  kw.get("custom_dictionary"))
        ud = kw.get("use_dict", True)
        before = D3.KERNEL_LAUNCHES
        ker = D3.decode3(tb, ud)
        ref = D3.decode3_ref(tb, ud)
        assert D3.KERNEL_LAUNCHES == before + 1
        for a, b in zip(ker, ref):
            assert torch.equal(a.cpu(), b.cpu()), name
        direct = D3.DIRECT_LAUNCHES
        others = []
        for lanes, window in ((1, 64), (4, 128), (32, 64)):
            with monkeypatch.context() as m:
                m.setattr(D3, "launch_config",
                          lambda tb, sms, smem, lanes=lanes, window=window:
                          D3._fit(tb, lanes, sms, smem, window))
                others.append(D3.decode3(tb, ud))
        others.append(D3.decode3_direct(tb, ud))
        assert D3.DIRECT_LAUNCHES == direct + 1
        for out in others:
            for a, b in zip(out, ref):
                assert torch.equal(a.cpu(), b.cpu()), name
