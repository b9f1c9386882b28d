"""The bit-pack kernels of the port (brotli_tpu_torch.ops.device_encode
.pack_records, the segmented scan, and pack_records_serial, the row
machine) against the JAX Pallas kernel (brotli_tpu.ops.device_encode
._build_pack, interpret mode), on the CPU.

On the CPU the kernels' code runs as the g++ host shim; the plain row
machine pack_records_ref is the yardstick, and pack_records_scan, the scan
formulation in plain PyTorch, is held against it and JAX as well.
Tolerance: exact equality, lane for lane: the body words (the JAX words on
rows whose key is not KEY_PAD, in key order), widx, avail, the three low
buffer limbs and the overflow flag.  The JAX kernel's keys and the words
it leaves on KEY_PAD rows are its own layout, not part of the contract.
Inputs are the records and tables the JAX encoder hands its kernel on
in-repo text, plus random records that overflow the buffer.
"""

from pathlib import Path
import shutil

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from brotli_tpu.ops import device_encode as JE
from brotli_tpu_torch.ops import device_encode as TE

ROOT = Path(__file__).resolve().parents[1]

CONFIGS = {
    "nt1": dict(),
    "nt4_groups2": dict(lit_ctx_trees=4, table_groups=2),
    "nbt3_seg512": dict(lit_ctx_trees=4, table_groups=2, block_types=3,
                        block_seg=512),
}


def _data() -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    rng = np.random.default_rng(9)
    binary = (np.sin(np.arange(1024) / 7.0) * 3e4).astype("<i2").tobytes()
    return (src[20000:22048] + binary + bytes(1024)
            + rng.integers(0, 256, 512, np.uint8).tobytes() + src[:1300])


def _to_port(args, nt, nbt, pseg, nseg) -> TE.PackBatch:
    """The JAX kernel's (rows, 8, 128) / replicated-table inputs in the
    port's layout: lane s = i*128 + j, one row of each 128-entry chunk."""
    rec0, rec1, tab, cmap, consts, grp, init0, initav = args[:8]

    def lanes(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(
            a.view(np.int32).reshape(a.shape[0] if a.ndim == 3 else 1, -1)))

    def flat(t):
        t = np.asarray(t, np.int32)
        k = t.shape[0] // 8
        return torch.from_numpy(np.array(t.reshape(k, 8, 128)[:, 0, :]
                                         .reshape(-1)))

    groups = np.asarray(tab).shape[0] // (8 * JE._tab_chunks(nt))
    sw = stype = None
    if nbt > 1:
        sw, stype = lanes(args[8]), lanes(args[9])
    return TE.PackBatch(
        rec0=lanes(rec0), rec1=lanes(rec1),
        tab=flat(tab).reshape(groups, -1), cmap=flat(cmap).reshape(groups, -1),
        consts=torch.from_numpy(np.asarray(consts, np.int32)[0].copy()),
        grp=lanes(grp)[0], init0=lanes(init0)[0], initav=lanes(initav)[0],
        sw=sw, stype=stype, nt=nt, nbt=nbt, pseg=pseg, nseg=nseg)


def _jax_result(keys, words, status):
    """JAX outputs as (compact words (rows, 1024), status (6, 1024)),
    checking that each lane's keys number its words 0..widx-1."""
    keys = np.asarray(keys).reshape(keys.shape[0], -1)
    words = np.asarray(words).view(np.int32).reshape(keys.shape)
    status = np.asarray(status).view(np.int32).reshape(8, -1)
    live = keys != JE.KEY_PAD
    assert (live.sum(axis=0) == status[0]).all()
    compact = np.zeros_like(words)
    row, lane = np.nonzero(live)
    compact[keys[row, lane], lane] = words[row, lane]
    return compact, status[:6]


@pytest.fixture(scope="module")
def cases():
    """name -> (PackBatch, JAX (compact words, status)), from the JAX
    encoder's own pack calls."""
    out = {}
    data = _data()
    orig = JE._jitted_pack
    for name, kw in CONFIGS.items():
        seen = {}

        def spy(*a, _seen=seen):
            run = orig(*a)

            def wrapped(*args):
                res = run(*args)
                _seen["args"], _seen["res"] = args, res
                return res
            return wrapped

        JE._jitted_pack = spy
        try:
            JE.encode_device_batch(data, chunk_size=1024, interpret=True, **kw)
        finally:
            JE._jitted_pack = orig
        nt = kw.get("lit_ctx_trees", 1)
        nbt = kw.get("block_types", 1)
        pseg = kw.get("block_seg", 2048)
        nseg = 1024 // pseg if nbt > 1 else 1
        out[name] = (_to_port(seen["args"], nt, nbt, pseg, nseg),
                     _jax_result(*seen["res"]))
    return out


def _random_arrays():
    """256 random records of every kind against random tables: symbol
    codes up to 15 bits and extras up to 24, so lanes overflow the buffer
    (ovf) and run past its 128 bits.  One lane names a group outside the
    table stack.  Returns the numpy arrays and the PackBatch."""
    rng = np.random.default_rng(17)
    rows, lanes, G, nt = 256, 1024, 2, 2
    kind = rng.integers(0, 4, (rows, lanes))
    code = np.select(
        [kind == JE.K_CMD, kind == JE.K_DIST, kind == JE.K_LIT],
        [rng.integers(0, 704, (rows, lanes)), rng.integers(0, 64, (rows, lanes)),
         rng.integers(0, 1 << 26, (rows, lanes)) & ~0x3F00],
        0)
    # the first half of the lanes: a 15-bit distance code and 21-24 extra
    # bits on every row, more than the one word a row can drain
    kind[:, :512] = JE.K_DIST
    code[:, :512] = rng.integers(56, 64, (rows, 512))
    rec0 = np.where(kind == 0, 0, (kind << 28) | code).astype(np.int32)
    rec1 = rng.integers(0, 1 << 32, (rows, lanes), dtype=np.uint64)
    rec1 = rec1.astype(np.uint32).view(np.int32)
    tabk = JE._tab_chunks(nt)
    nbits = rng.integers(1, 16, (G, tabk * 128))
    nbits[:, nt * 256 + 704:] = 15      # distance codes: 15 bits
    bits = rng.integers(0, 1 << 15, (G, tabk * 128)) & ((1 << nbits) - 1)
    tab = ((nbits << 16) | bits).astype(np.int32)
    cmap = rng.integers(0, nt, (G, 128)).astype(np.int32)
    cmap[:, 127] = [0, 1]
    grp = rng.integers(0, G, lanes).astype(np.int32)
    grp[5] = G
    initav = rng.integers(0, 32, lanes).astype(np.int32)
    init0 = (rng.integers(0, 1 << 32, lanes, dtype=np.uint64)
             & ((1 << initav.astype(np.uint64)) - 1)).astype(np.uint32)
    pb = TE.PackBatch(
        rec0=torch.from_numpy(rec0), rec1=torch.from_numpy(rec1),
        tab=torch.from_numpy(tab), cmap=torch.from_numpy(cmap),
        consts=torch.from_numpy(JE._pack_consts()[0].copy()),
        grp=torch.from_numpy(grp), init0=torch.from_numpy(init0.view(np.int32)),
        initav=torch.from_numpy(initav), sw=None, stype=None,
        nt=nt, nbt=1, pseg=2048, nseg=1)
    return (rec0, rec1, tab, cmap, grp, init0, initav), pb


def _random_case():
    """The random batch and the JAX kernel's result on it."""
    import jax.numpy as jnp

    (rec0, rec1, tab, cmap, grp, init0, initav), pb = _random_arrays()
    G, nt = tab.shape[0], 2

    def rep(t):   # (G, k*128) -> the JAX kernel's replicated layout
        k = t.shape[1] // 128
        return np.broadcast_to(t.reshape(G, k, 1, 128),
                               (G, k, 8, 128)).reshape(-1, 128)

    def sub(a):
        return jnp.asarray(a.reshape(a.shape[0], 8, 128) if a.ndim == 2
                           else a.reshape(8, 128))

    pack = JE._build_pack(1, True, G, nt)
    res = pack(sub(rec0), sub(rec1), jnp.asarray(rep(tab)),
               jnp.asarray(rep(cmap)), jnp.asarray(JE._pack_consts()),
               sub(grp), sub(init0.view(np.int32)), sub(initav))
    return pb, _jax_result(*res)


@pytest.fixture(scope="module")
def random_case():
    return _random_case()


def _check_against_jax(pb, jax_res):
    words, status = TE.pack_records(pb)
    jwords, jstatus = jax_res
    np.testing.assert_array_equal(status.numpy(), jstatus)
    np.testing.assert_array_equal(words.numpy(), jwords)
    return status.numpy()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_pack_matches_jax(cases, name):
    pb, jax_res = cases[name]
    status = _check_against_jax(pb, jax_res)
    assert status[0].max() > 0 and not status[5].any()


def test_pack_random_records_overflow_like_jax(random_case):
    pb, jax_res = random_case
    status = _check_against_jax(pb, jax_res)
    # lane 5's group has no table, so its codes have no bits and only the
    # extras fill its buffer
    want = np.arange(1024) < 512
    want[5] = False
    np.testing.assert_array_equal(status[5], want)


@pytest.mark.parametrize("name", list(CONFIGS) + ["random"])
def test_pack_scan_matches_plain_and_jax(cases, random_case, name):
    """pack_records_scan (cumsum and cummin over rows) == the row machine
    pack_records_ref == the JAX kernel, words and status; the random
    batch's ovf lanes included."""
    pb, (jwords, jstatus) = random_case if name == "random" else cases[name]
    scan = TE.pack_records_scan(pb, chunk=100)
    for a, b in zip(scan, TE.pack_records_ref(pb)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(scan[0].numpy(), jwords)
    np.testing.assert_array_equal(scan[1].numpy(), jstatus)


@pytest.mark.parametrize("name", list(CONFIGS) + ["random"])
def test_host_shim_matches_plain(cases, random_case, name):
    """csrc/pack.cuh built by g++ == the plain PyTorch version: the
    segmented kernel's four passes (which also check that no word is
    stored by two segments) and the serial kernel's row machine."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    pb = random_case[0] if name == "random" else cases[name][0]
    ref = TE.pack_records_ref(pb)
    for serial in (False, True):
        for a, b in zip(TE.pack_records_host(pb, serial=serial), ref):
            assert torch.equal(a, b)


def _row_rule(n_bits, initav):
    """Words emitted through each row by the row machine's rule: a row
    appends its bits, then one word leaves when 32 or more are held."""
    avail, w, out = initav, 0, []
    for nb in n_bits:
        avail += nb
        if avail >= 32:
            avail -= 32
            w += 1
        out.append(w)
    return out


@settings(max_examples=300, deadline=None, derandomize=True)
@given(n_bits=st.lists(st.integers(0, 4 * 63), min_size=1, max_size=700),
       initav=st.integers(0, 40),
       cuts=st.lists(st.integers(1, 700), max_size=6))
def test_scan_identity_matches_row_rule(n_bits, initav, cuts):
    """W_r = r + min(1, min_{j<=r} (F_j - j)) with F_j = S_j >> 5 is the row
    rule's count of words; and a segment's minimum, taken alone as (A, T)
    (csrc/pack.cuh pack_seg_count / pack_seg_min), gives the same prefix
    minimum once its start bit is known."""
    S = initav + np.cumsum(n_bits)
    r = np.arange(len(n_bits))
    M = np.minimum.accumulate((S >> 5) - r)
    W = r + np.minimum(M, 1)
    assert W.tolist() == _row_rule(n_bits, initav)

    bounds = sorted({0, len(n_bits), *[c for c in cuts if c < len(n_bits)]})
    s, m = initav, 1 << 30
    for lo, hi in zip(bounds, bounds[1:]):
        x = np.cumsum(n_bits[lo:hi])
        aj = (x >> 5) - np.arange(hi - lo)
        a = aj.min()
        t = (32 - (x & 31))[aj == a].max()
        m = min(m, (s >> 5) + a + int((s & 31) >= t) - lo)
        assert m == M[hi - 1]
        s += int(x[-1])


def test_pack_rejects_bad_tensors(cases):
    pb = cases["nbt3_seg512"][0]
    bad = TE.PackBatch(**{**pb.__dict__, "grp": pb.grp.to(torch.int64)})
    with pytest.raises(ValueError, match="grp"):
        TE.pack_records(bad)
    bad = TE.PackBatch(**{**pb.__dict__, "sw": None})
    with pytest.raises(ValueError, match="sw"):
        TE.pack_records(bad)
    with pytest.raises(ValueError, match="CUDA"):
        TE.pack_records_serial(pb)


def _on_card(pb):
    return TE.PackBatch(**{k: v.cuda() if isinstance(v, torch.Tensor) else v
                           for k, v in pb.__dict__.items()})


@pytest.mark.cuda
def test_pack_kernel_matches_plain_on_card(monkeypatch):
    """Both CUDA kernels, the segmented one and the serial one, == the
    plain version on CUDA tensors (needs a card; no JAX: the inputs come
    from the port's own encoder)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    seen = []
    orig = TE.pack_records
    monkeypatch.setattr(TE, "pack_records",
                        lambda pb: seen.append(pb) or orig(pb))
    for kw in CONFIGS.values():
        TE.encode_device_batch(_data(), chunk_size=1024, device="cpu", **kw)
    monkeypatch.undo()
    for pb in seen:
        on_card = _on_card(pb)
        before = TE.KERNEL_LAUNCHES, TE.SERIAL_PACK_LAUNCHES
        ker = TE.pack_records(on_card)
        serial = TE.pack_records_serial(on_card)
        assert (TE.KERNEL_LAUNCHES, TE.SERIAL_PACK_LAUNCHES) == (
            before[0] + 1, before[1] + 1)
        ref = TE.pack_records_ref(on_card)
        for a, b, c in zip(ker, serial, ref):
            assert torch.equal(a.cpu(), c.cpu()) and torch.equal(b.cpu(),
                                                                  c.cpu())


@pytest.mark.cuda
def test_pack_kernels_overflow_like_plain_on_card():
    """The random batch, half of whose lanes overflow: the segmented
    kernel's ovf lanes finish through the row machine."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    pb = _on_card(_random_arrays()[1])
    ref = TE.pack_records_ref(pb)
    assert int(ref[1][5].sum()) == 511
    for out in (TE.pack_records(pb), TE.pack_records_serial(pb)):
        for a, b in zip(out, ref):
            assert torch.equal(a.cpu(), b.cpu())
