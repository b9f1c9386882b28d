"""Entropy decode of the PyTorch port (brotli_tpu_torch.ops.decode2) against
the JAX v2 kernel (brotli_tpu.ops.pallas_decode2, interpret mode).

Tolerance: exact equality.  The codec is integer code, so every lane's
token sequence, final phase, words consumed (widx) and overrun flag must be
identical.  The row a token sits on in the JAX output is a lockstep
artifact and is not compared: PAD rows are dropped (tokens_from_jax).

The corpus is built here from in-repo files and numpy-seeded bytes.  The
JAX results are computed once per module (interpret mode costs seconds per
call).
"""

from pathlib import Path
import shutil

import numpy as np
import pytest
import torch

import brotli_tpu
from brotli_tpu import constants as C
from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu.ops import pallas_decode2 as P2
from brotli_tpu_torch.ops import decode2 as D

ROOT = Path(__file__).resolve().parents[1]


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _random_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, np.uint8).tobytes()


def _long_copy_streams() -> tuple[list[bytes], list[bytes]]:
    """Same-table streams of one literal period then one copy longer than
    255 bytes, which the kernels carry as a tag-1/tag-2 pair.  The host
    encoder caps greedy matches at 128 bytes, so the commands are made
    here and stored the way encode_sharded stores its own."""
    from brotli_tpu.encode import sharded as S
    from brotli_tpu.encode.command import make_command
    from brotli_tpu.encode.params import make_params

    specs = [(b"abcdefgh", 3000), (b"0123456789", 2000), (b"xyz", 700)]
    chunks = [(p * (n // len(p) + 1))[:n] for p, n in specs]
    params = make_params(1, None, None, max(map(len, chunks)))
    npf, nd = params.dist.npostfix, params.dist.ndirect
    # distance code = distance + 15: an explicit (non-ring) distance
    cmds = [[make_command(len(p), n - len(p), 0, len(p) + 15, nd, npf)]
            for p, n in specs]
    tables = S.build_shared_tables(chunks, cmds, params.dist_alphabet_size,
                                   npf, nd)
    nbits, value = S.encode_window_bits(params.lgwin, False)
    streams = []
    for chunk, c in zip(chunks, cmds):
        w = S.BitWriter()
        w.write(nbits, value)
        S.store_metablock_trivial_fixed(w, chunk, len(chunk), True, c, tables)
        w.align_to_byte()
        streams.append(w.finish())
    return chunks, streams


def _batches() -> dict:
    text = _source_text(2048, skip=4000)
    text_streams = list(encode_sharded(text, chunk_size=256, max_distance=496))
    # a lane cut mid-body: the zero-padded word table lets it decode
    # padding to DONE, which only the widx overrun check catches
    text_streams[3] = text_streams[3][: len(text_streams[3]) // 2]
    return {
        "text_truncated": text_streams,
        "zeros": encode_sharded(bytes(1024), chunk_size=256),
        "random": encode_sharded(_random_bytes(768, seed=7), chunk_size=256),
        "long_copy": _long_copy_streams()[1],
    }


@pytest.fixture(scope="module")
def cases():
    """name -> (SharedBatch, JAX (tokens, phases, widx))."""
    out = {}
    for name, streams in _batches().items():
        batch = P2.preflight_shared(streams)
        assert batch is not None, name
        out[name] = (batch, P2.run_batch(batch, interpret=True, with_widx=True))
    return out


def _lane_tokens(tok: torch.Tensor, count: torch.Tensor, lane: int) -> list:
    col = tok[: int(count[lane]), lane].numpy().view(np.uint32)
    return col.tolist()


@pytest.mark.parametrize("name", ["text_truncated", "zeros", "random",
                                  "long_copy"])
def test_entropy_matches_jax(cases, name):
    batch, (jtok, jphase, jwidx) = cases[name]
    tb = D.batch_to_torch(batch, "cpu")
    tok, count, phase, widx = D.entropy_decode(tb)
    jt, jc = D.tokens_from_jax(jtok, cap=tb.cap)
    np.testing.assert_array_equal(count.numpy(), jc.numpy())
    np.testing.assert_array_equal(tok.numpy(), jt.numpy())
    np.testing.assert_array_equal(phase.numpy(), jphase.reshape(-1))
    np.testing.assert_array_equal(widx.numpy(), jwidx.reshape(-1))
    np.testing.assert_array_equal(P2.lane_overran(batch, widx.numpy()),
                                  P2.lane_overran(batch, jwidx))
    live = batch.mlens > 0
    assert (count.numpy()[live] > 0).all()


def test_truncated_lane_overran(cases):
    batch, (_, _, jwidx) = cases["text_truncated"]
    _, _, phase, widx = D.run_batch(batch, "cpu", with_widx=True)
    over = P2.lane_overran(batch, widx.numpy())
    assert over[3] and int(phase[3]) == P2.DONE
    assert not over[[i for i in range(batch.n_streams) if i != 3]].any()
    assert P2.lane_overran(batch, jwidx)[3]


def test_long_copies_take_tag1_tag2_pairs(cases):
    chunks, streams = _long_copy_streams()
    assert [brotli_tpu.decode(s) for s in streams] == chunks
    batch, _ = cases["long_copy"]
    tok, count, phase = D.run_batch(batch, "cpu")
    for lane in range(len(streams)):
        tags = [t >> 30 for t in _lane_tokens(tok, count, lane)]
        assert tags[-2:] == [1, 2]
        assert int(phase[lane]) == P2.DONE


@pytest.mark.parametrize("name", ["text_truncated", "zeros", "random",
                                  "long_copy"])
def test_host_shim_matches_plain(name):
    """csrc/decode2.cuh built by g++ == the plain PyTorch version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    batch = P2.preflight_shared(_batches()[name])
    tb = D.batch_to_torch(batch, "cpu")
    for a, b in zip(D.entropy_decode_host(tb), D.entropy_decode_ref(tb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("name", ["text_truncated", "zeros", "random",
                                  "long_copy"])
def test_queued_shim_matches_plain_and_jax(cases, name, lanes):
    """The queued kernel's per-lane code (csrc/decode2.cuh Queued2 and the
    look-ahead queue of csrc/queue.cuh) built by g++ == the plain version,
    and its tokens, counts, phases and words == JAX's."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    batch, (jtok, jphase, jwidx) = cases[name]
    tb = D.batch_to_torch(batch, "cpu")
    got = D.entropy_decode_host(tb, lanes)
    for a, b in zip(got, D.entropy_decode_ref(tb)):
        assert torch.equal(a, b)
    tok, count, phase, widx = got
    jt, jc = D.tokens_from_jax(jtok, cap=tb.cap)
    np.testing.assert_array_equal(count.numpy(), jc.numpy())
    np.testing.assert_array_equal(tok.numpy(), jt.numpy())
    np.testing.assert_array_equal(phase.numpy(), jphase.reshape(-1))
    np.testing.assert_array_equal(widx.numpy(), jwidx.reshape(-1))


@pytest.mark.parametrize("name", ["text_truncated", "zeros", "random",
                                  "long_copy"])
def test_direct_shim_matches_plain(name):
    """The direct kernel's per-lane code built by g++ == the plain
    version."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    tb = D.batch_to_torch(P2.preflight_shared(_batches()[name]), "cpu")
    for a, b in zip(D.entropy_decode_host(tb, direct=True),
                    D.entropy_decode_ref(tb)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["text_truncated", "random"])
def test_words_ending_at_wpad(name):
    """The word table cut to the most words any lane consumed, so the
    longest lanes' look-ahead reaches Wpad and stops there (and lanes that
    needed more run out): the queued shim == the plain version."""
    import dataclasses

    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    tb = D.batch_to_torch(P2.preflight_shared(_batches()[name]), "cpu")
    last = int(D.entropy_decode_ref(tb)[3].max())
    for k in (last, last - 3):
        cut = dataclasses.replace(tb, wt=tb.wt[:k].contiguous())
        ref = D.entropy_decode_ref(cut)
        assert int(ref[3].max()) == k
        for a, b in zip(D.entropy_decode_host(cut), ref):
            assert torch.equal(a, b)


def test_lanes_per_warp():
    """The lane map: about WARPS_PER_SM warps of lanes on each SM, a power
    of two from 1 to 32."""
    assert D.lanes_per_warp(4096, 132) == 4      # the v2 cell on an H100
    assert D.lanes_per_warp(6144, 132) == 4      # the v3 cell
    assert D.lanes_per_warp(1024, 132) == 1
    assert D.lanes_per_warp(32 * 1024, 132) == 32
    assert D.lanes_per_warp(1 << 20, 132) == 32
    for n in (1024, 3072, 12288, 20480):
        lpw = D.lanes_per_warp(n, 132)
        assert lpw & (lpw - 1) == 0
        assert n / (lpw * 132) <= D.WARPS_PER_SM


def test_batch_to_torch_layout():
    streams = encode_sharded(_source_text(1024), chunk_size=256)
    batch = P2.preflight_shared(streams, groups=2)
    tb = D.batch_to_torch(batch, "cpu")
    assert tb.n_lanes == 2048 and tb.groups == 2
    wt = tb.wt.numpy().view(np.uint32)
    for lane in (0, 1, 130, 1023, 1024, 2047):
        g, s = divmod(lane, 1024)
        np.testing.assert_array_equal(wt[:, lane],
                                      batch.wt[:, g * 8 + s // 128, s % 128])
        assert int(tb.mlen[lane]) == batch.mlens[lane]
    pres = P2._parse_dedup(streams)
    lit = tb.lit.numpy()
    np.testing.assert_array_equal(lit[0], lit[1])
    n = tb.lit_k * 128
    np.testing.assert_array_equal(lit[0], pres[0].lit_table[:n])
    want_dx = (pres[0].dist_extra << 26) | pres[0].dist_offset
    np.testing.assert_array_equal(tb.dx.numpy()[:544], want_dx)
    consts = tb.consts.numpy()
    np.testing.assert_array_equal(
        consts[0:24], (np.asarray(C.INSERT_LENGTH_N_BITS) << 20)
        | np.asarray(C.INSERT_LENGTH_OFFSET))
    np.testing.assert_array_equal(
        consts[64:88], (np.asarray(C.COPY_LENGTH_N_BITS) << 20)
        | np.asarray(C.COPY_LENGTH_OFFSET))
    np.testing.assert_array_equal(
        consts[96:112], (np.asarray(C.DISTANCE_SHORT_CODE_INDEX) << 4)
        | (np.asarray(C.DISTANCE_SHORT_CODE_DELTA) + 3))
    assert int(tb.start_bit[0]) == pres[0].cmd_start_bit & 31
    assert tb.cap == int(batch.mlens.max()) + 4


def test_binned_groups_use_their_own_tables():
    """Two table sets in one batch: each group decodes with its own."""
    a = encode_sharded(_source_text(768), chunk_size=256)
    b = encode_sharded(bytes(512), chunk_size=256)
    assert P2.preflight_shared(a + b) is None
    batch, perm = P2.preflight_binned(a + b)
    assert batch.groups == 2
    tok, count, phase = D.run_batch(batch, "cpu")
    for streams in (a, b):
        alone = P2.preflight_shared(streams)
        atok, acount, _ = D.run_batch(alone, "cpu")
        for i in range(len(streams)):
            src = i if streams is a else len(a) + i
            slot = int(np.flatnonzero(perm == src)[0])
            assert int(phase[slot]) == P2.DONE
            assert (_lane_tokens(tok, count, slot)
                    == _lane_tokens(atok, acount, i))


def test_token_cap_flags_lane():
    """A lane that would write past its token slots ends in ERR."""
    batch = P2.preflight_shared(encode_sharded(_source_text(512), chunk_size=256))
    tb = D.batch_to_torch(batch, "cpu")
    full_tok, full_count, _, _ = D.entropy_decode(tb)
    tb.cap = 5
    tok, count, phase, _ = D.entropy_decode(tb)
    assert (full_count[:2] > 5).all()
    assert (count[:2] == 5).all() and (phase[:2] == P2.ERR).all()
    assert torch.equal(tok[:, :2], full_tok[:5, :2])
    if shutil.which("g++") is not None:
        for a, b in zip(D.entropy_decode_host(tb), (tok, count, phase)):
            assert torch.equal(a, b)


def test_entropy_decode_rejects_bad_tensors():
    batch = P2.preflight_shared(encode_sharded(bytes(300), chunk_size=256))
    tb = D.batch_to_torch(batch, "cpu")
    tb.mlen = tb.mlen.to(torch.int64)
    with pytest.raises(ValueError, match="mlen"):
        D.entropy_decode(tb)


@pytest.mark.cuda
def test_entropy_kernel_matches_plain_on_card(monkeypatch):
    """The CUDA kernel == the plain version on CUDA tensors (needs a card),
    at its own lane map and at others."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    streams = encode_sharded(_source_text(16384), chunk_size=512,
                             max_distance=2032)
    tb = D.batch_to_torch(P2.preflight_shared(streams), "cuda")
    before = D.KERNEL_LAUNCHES
    ker = D.entropy_decode(tb)
    ref = D.entropy_decode_ref(tb)
    assert D.KERNEL_LAUNCHES == before + 1
    for a, b in zip(ker, ref):
        assert torch.equal(a.cpu(), b.cpu())
    direct = D.DIRECT_LAUNCHES
    others = []
    for lanes in (1, 2, 8, 16, 32):
        with monkeypatch.context() as m:
            m.setattr(D, "lanes_per_warp", lambda n, sms, lanes=lanes: lanes)
            others.append(D.entropy_decode(tb))
    others.append(D.entropy_decode_direct(tb))
    assert D.DIRECT_LAUNCHES == direct + 1
    for out in others:
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b.cpu())
