"""The Zopfli DP of the port (brotli_tpu_torch.ops.device_zopfli) against
the host q10 parse (the port's create_zopfli_backward_references, the
DP's contract) and against the JAX DP (brotli_tpu.ops.device_zopfli
._build_dp under jax.enable_x64, on the CPU), where the JAX DP meets that
contract.

Three versions of the port's DP meet here: the plain PyTorch loop
`zopfli_dp_ref`, the per-lane code of csrc/zopfli.cuh built by g++
(`zopfli_dp_host`, the kernel's warp as loops), and, on a card only, the
CUDA kernel.  Tolerance: exact.  Node arrays bit for bit (cost as float64,
nlen and ndci as uint32 bit patterns), the per-position result and the
count of lengths tried; commands field for field and the last insert.

Inputs: slices of utils.benchmarks.corpus (the in-repo sources), lanes
made with a seeded numpy RNG, and hand-made node costs.  Where the JAX DP
departs from the host, the tests record it: short code 16 wraps its int32
dcode_insert_length (command 50 of corpus(1200) reads dist_prefix -17),
its match collection asserts at most MAXC = 64 matches a position, and it
caps the minimum-copy-length scan at 96 steps.

JAX is imported inside the tests that use it, so the card test runs
without it:
    python3 -m pytest --noconftest -m cuda tests/test_torch_zopfli.py
"""

import numpy as np
import pytest
import torch

from brotli_tpu_torch.encode import backward_refs_hq as TH
from brotli_tpu_torch.encode.api import _NO_MASK, _padded
from brotli_tpu_torch.encode.hash_binary_tree import BinaryTreeHasher
from brotli_tpu_torch.ops import device_zopfli as Z
from brotli_tpu_torch.utils.benchmarks import corpus

N_JAX = 1200   # the one JAX build: N = 1200, B = 2


def _text_1200() -> bytes:
    return corpus(1200)


def _clean_1200() -> bytes:
    """1200 B of the corpus whose DP holds no node with short code 16."""
    return corpus(8400)[7200:]


def _slice_8k() -> bytes:
    """8,192 B of the corpus with 66 matches at position 2014."""
    return corpus(208192)[200000:]


def _rng_lanes() -> list[bytes]:
    """Random bytes, then runs and periods that give long matches, long
    skips and every short distance code."""
    rng = np.random.default_rng(10)
    rand = rng.integers(0, 256, 700, np.uint8).tobytes()
    words = rng.integers(97, 101, 300, np.uint8).tobytes()
    return [rand + rand[:200] + bytes(300) + (b"abcdefghijk" * 40),
            words + rand[50:400] + words[:250] + b"xyz" * 60]


def _host(data: bytes):
    n = len(data)
    cmds, _, last = TH.create_zopfli_backward_references(
        n, 0, _padded(bytes(data)), _NO_MASK, BinaryTreeHasher(22, n),
        [4, 11, 15, 16], 0)
    return cmds, last


def _tuples(cmds):
    return [(c.insert_len, c.copy_len, c.dist_extra, c.cmd_prefix,
             c.dist_prefix) for c in cmds]


def _u32(t) -> np.ndarray:
    return np.asarray(t).astype(np.int64) & 0xFFFFFFFF


def _short16(nodes, lane) -> int:
    return int((_u32(nodes.ndci[lane]) >> 27 == 16).sum())


def _assert_same(a: Z.ZopfliNodes, b: Z.ZopfliNodes) -> None:
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


# ---------------------------------------------------------------------------
# the port's three versions and the host
# ---------------------------------------------------------------------------

LANE_SETS = {
    "text": lambda: [_text_1200(), _clean_1200()[:900]],
    "rng": _rng_lanes,
    "tiny": lambda: [b"", b"abc", b"abcd", b"aaaaa", b"abcabcab"],
}


@pytest.mark.parametrize("name", sorted(LANE_SETS))
def test_ref_equals_host_shim_and_host(name):
    """zopfli_dp_ref == zopfli_dp_host on every output, lanes of unequal
    length in one batch, and each lane's backtrack == the host's."""
    lanes = LANE_SETS[name]()
    zb = Z.stage_zopfli(lanes, device="cpu")
    ref = Z.zopfli_dp_ref(zb)
    _assert_same(ref, Z.zopfli_dp_host(zb))
    for b, data in enumerate(lanes):
        cmds, last = Z.backtrack(ref, b, len(data))
        host_cmds, host_last = _host(data)
        assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    assert int(ref.tried.sum()) > 0 or name == "tiny"


@pytest.mark.parametrize("name", ["text_1200", "slice_8k"])
def test_commands_equal_host(name):
    """zopfli_commands_device(device="cpu") gives the host's commands and
    last insert; the 8 KB slice has a position with more than 64 matches,
    which the JAX DP refuses."""
    data = {"text_1200": _text_1200, "slice_8k": _slice_8k}[name]()
    cmds, last = Z.zopfli_commands_device(data, device="cpu")
    host_cmds, host_last = _host(data)
    assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    if name == "slice_8k":
        moff = Z.collect_matches(data)[0]
        assert int(np.diff(moff).max()) == 66
        zb = Z.stage_zopfli([data], device="cpu")
        shim_cmds, shim_last = Z.backtrack(Z.zopfli_dp_host(zb), 0, len(data))
        assert (_tuples(shim_cmds), shim_last) == (_tuples(host_cmds),
                                                   host_last)


# ---------------------------------------------------------------------------
# the JAX DP
# ---------------------------------------------------------------------------

def _jax_matches(data: bytes):
    """JAX collect_matches on `data`, its MAXC raised past the corpus's
    66 (a module attribute; the JAX function is not changed)."""
    from brotli_tpu.ops import device_zopfli as JZ

    mp = pytest.MonkeyPatch()
    mp.setattr(JZ, "MAXC", 128)
    try:
        return JZ.collect_matches(data)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_nodes():
    """_build_dp(N = 1200, B = 2) on [clean_1200, text_1200], fed as
    zopfli_commands_device feeds it: node arrays (N + 1, B) as numpy."""
    import jax
    import jax.numpy as jnp

    from brotli_tpu.encode import backward_refs_hq as JH
    from brotli_tpu.encode.api import _NO_MASK as J_NO_MASK
    from brotli_tpu.encode.api import _padded as j_padded
    from brotli_tpu.encode.cost_model import ZopfliCostModel as JModel
    from brotli_tpu.ops import device_zopfli as JZ

    lanes = [_clean_1200(), _text_1200()]
    B, N = len(lanes), N_JAX
    m_len, m_dist, m_delta = (np.zeros((N, B, JZ.MAXC), np.int32)
                              for _ in range(3))
    n_m, active = np.zeros((N, B), np.int32), np.zeros((N, B), np.int32)
    data8 = np.zeros((B, N + JZ.PAD), np.int32)
    lit = np.zeros((B, N + 2), np.float64)
    for b, data in enumerate(lanes):
        m_len[:, b], m_dist[:, b], m_delta[:, b], n_m[:, b], active[:, b] = (
            JZ.collect_matches(data))
        padded = j_padded(data)
        model = JModel(N, 544)
        model.set_from_literal_costs(0, padded, J_NO_MASK)
        data8[b, : N + 8] = np.frombuffer(padded[: N + 8], np.uint8)
        lit[b] = model.literal_costs[: N + 2]
    cost_dist = np.full((B, 1024), np.inf)
    cost_dist[:, :544] = model.cost_dist
    with jax.enable_x64(True):
        dp = JZ._build_dp(N, B, JH.max_zopfli_len(10), JH.MAX_BACKWARD_LIMIT)
        out = jax.jit(dp)(
            jnp.asarray(data8), jnp.asarray(lit),
            jnp.asarray(np.tile(np.asarray(model.cost_cmd, np.float64),
                                (B, 1))),
            jnp.asarray(cost_dist),
            jnp.asarray(np.float64(model.get_min_cost_cmd())),
            jnp.asarray(np.tile(np.int32([4, 11, 15, 16]), (B, 1))),
            jnp.asarray(np.int32(N)), *(jnp.asarray(a) for a in (
                m_len, m_dist, m_delta, n_m, active)))
        return lanes, [np.asarray(x) for x in out]


def test_jax_node_arrays_equal_without_short_code_16(jax_nodes):
    """On a lane with no short-code-16 node the JAX DP's node arrays equal
    the port's, all five, bit for bit.  On corpus(1200), which has such
    nodes, JAX's costs, lengths, distances and dcode_insert_length bits
    still agree, but its shortcut test reads the int32 field's negative
    short code and its shortcuts differ at those nodes."""
    lanes, jout = jax_nodes
    ref = Z.zopfli_dp_ref(Z.stage_zopfli(lanes, device="cpu"))
    assert _short16(ref, 0) == 0 and _short16(ref, 1) == 8
    for b in range(2):
        for i, name in enumerate(("cost", "nlen", "ndist", "ndci", "nsc")):
            port = ref[i][b].numpy()
            jax_b = jout[i][:, b]
            if name in ("nlen", "ndci"):
                port, jax_b = _u32(port), _u32(jax_b)
            if b == 1 and name == "nsc":
                assert int((port != jax_b).sum()) == 8
            else:
                assert np.array_equal(port, jax_b), (b, name)


def test_jax_short_code_16_fault(jax_nodes):
    """corpus(1200): the port gives the host's 59 commands; JAX's
    backtrack over its own nodes differs in command 50 alone, whose
    dist_prefix reads -17 where the host's is 15 (16 << 27 wraps an int32)."""
    from brotli_tpu.encode import backward_refs_hq as JH

    data = _text_1200()
    _, jout = jax_nodes
    cost, nlen, ndist, ndci, nsc = (x[:, 1] for x in jout)
    nodes = []
    for i in range(len(data) + 1):
        node = JH.ZopfliNode()
        node.length, node.distance = int(nlen[i]), int(ndist[i])
        node.dcode_insert_length, node.cost = int(ndci[i]), float(cost[i])
        node.shortcut = int(nsc[i])
        nodes.append(node)
    JH._compute_shortest_path(len(data), nodes)
    jax_cmds, _, _ = JH._create_commands_from_path(
        len(data), 0, nodes, [4, 11, 15, 16], 0, 0, 0)
    host = _tuples(_host(data)[0])
    port = _tuples(Z.zopfli_commands_device(data, device="cpu")[0])
    jax_t = _tuples(jax_cmds)
    assert port == host and len(host) == 59
    assert [i for i in range(59) if jax_t[i] != host[i]] == [50]
    assert (jax_t[50][4], host[50][4]) == (-17, 15)


@pytest.mark.parametrize("name", ["text_1200", "clean_1200", "slice_8k"])
def test_collect_matches_equals_jax(name):
    """The port's compact match list == the JAX function's (N, MAXC)
    arrays, in order; on the 8 KB slice (66 matches at a position) JAX
    runs only with its MAXC raised."""
    from brotli_tpu.ops import device_zopfli as JZ

    data = {"text_1200": _text_1200, "clean_1200": _clean_1200,
            "slice_8k": _slice_8k}[name]()
    moff, mlen, mdist, mdelta, active = Z.collect_matches(data)
    if name == "slice_8k":
        with pytest.raises(AssertionError, match="raise MAXC"):
            JZ.collect_matches(data)
        j_len, j_dist, j_delta, j_n, j_active = _jax_matches(data)
    else:
        j_len, j_dist, j_delta, j_n, j_active = JZ.collect_matches(data)
    assert np.array_equal(np.diff(moff), j_n)
    assert np.array_equal(active, j_active.astype(bool))
    keep = np.arange(j_len.shape[1])[None, :] < j_n[:, None]
    for port, jax_a in ((mlen, j_len), (mdist, j_dist), (mdelta, j_delta)):
        assert np.array_equal(port, jax_a[keep])


# ---------------------------------------------------------------------------
# pieces where the port follows the host and JAX does not
# ---------------------------------------------------------------------------

def _min_len_nodes(kind: str):
    """(costs, n, pos, min_cost) whose scan runs past JAX's 96 steps."""
    n, pos, start = 600, 7, 30.0
    costs = np.full(n + 1, 1e30)
    if kind == "to_end":        # every node ahead is cheap: runs to n
        costs[pos + 2:] = start
    else:                       # costs climb with the host's +1.0 steps,
        ln, bucket, nxt, bound = 2, 4, 10, start   # equal at each step
        while pos + ln <= 300:
            costs[pos + ln] = bound
            ln += 1
            if ln == nxt:
                bound += 1.0
                nxt += bucket
                bucket *= 2
    return costs, n, pos, start


@pytest.mark.parametrize("kind", ["to_end", "bucket_steps"])
def test_min_copy_length_uncapped(kind):
    """The minimum-copy-length piece of the kernel (host shim) and of the
    plain version == the host's _compute_minimum_copy_length, on node
    costs that take more than 96 steps (JAX stops at 2 + 96)."""
    from brotli_tpu_torch.build import host_lib

    costs, n, pos, start = _min_len_nodes(kind)
    nodes = [TH.ZopfliNode() for _ in range(n + 1)]
    for node, c in zip(nodes, costs):
        node.cost = float(c)
    want = TH._compute_minimum_copy_length(start, nodes, n, pos)
    assert want - 2 > 96
    t = torch.from_numpy(costs)
    assert Z._min_copy_length(t, n, pos, start) == want
    assert host_lib().brotli_torch_zopfli_min_len_host(
        t.data_ptr(), n, pos, start) == want


def test_quick_step_recollection(monkeypatch):
    """The host's quick step with its threshold lowered to 24 (from 16384,
    which no in-repo text reaches) in both packages' host loop and driver:
    zopfli_commands_device re-collects the matches until its schedule
    agrees with the DP's results, and gives the host's commands, where the
    first pass alone does not."""
    monkeypatch.setattr(TH, "LONG_COPY_QUICK_STEP", 24)
    monkeypatch.setattr(Z, "LONG_COPY_QUICK_STEP", 24)
    data = corpus(3000)[1800:]
    passes = []
    dp = Z.zopfli_dp
    monkeypatch.setattr(Z, "zopfli_dp", lambda zb: passes.append(1) or dp(zb))
    cmds, last = Z.zopfli_commands_device(data, device="cpu")
    host_cmds, host_last = _host(data)
    assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
    assert len(passes) == 12
    first = Z.backtrack(dp(Z.stage_zopfli([data], device="cpu")), 0, len(data))
    assert _tuples(first[0]) != _tuples(host_cmds)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="is_available"):
        Z.zopfli_commands_device(b"abcdabcdabcd")
    with pytest.raises(RuntimeError, match="is_available"):
        Z.stage_zopfli([b"abcdabcd"], device="cuda")
    with pytest.raises(ValueError, match="quality"):
        Z.stage_zopfli([b"abcdabcd"], quality=11, device="cpu")


def _bad(zb: Z.ZopfliBatch, case: str) -> Z.ZopfliBatch:
    kw = dict(zb.__dict__)
    if case == "dtype":
        kw["lit_cost"] = zb.lit_cost.float()
    elif case == "shape":
        kw["cost_dist"] = zb.cost_dist[:, :544].contiguous()
    elif case == "device":
        kw["mlen"] = zb.mlen.to("meta")
    elif case == "contiguous":
        kw["moff"] = zb.moff.t().contiguous().t()
    elif case == "moff":
        kw["moff"] = zb.moff + 1
    elif case == "past_end":
        kw["mlen"] = zb.mlen.clone()
        kw["mlen"][-1] = 5000
    elif case == "distance":
        kw["mdist"] = zb.mdist.clone()
        kw["mdist"][0] = 0
    return Z.ZopfliBatch(**kw)


@pytest.mark.parametrize("case", ["dtype", "shape", "device", "contiguous",
                                  "moff", "past_end", "distance"])
def test_bad_batch_raises(case):
    """A tensor of the wrong dtype, shape, device or layout, and matches
    that would index past their lane, raise before any version runs."""
    zb = _bad(Z.stage_zopfli([_text_1200()[:300], b"abcabcabcabc"],
                             device="cpu"), case)
    for fn in (Z.zopfli_dp, Z.zopfli_dp_ref, Z.zopfli_dp_host):
        with pytest.raises(ValueError):
            fn(zb)


# ---------------------------------------------------------------------------
# the card (no JAX)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_kernel_equals_plain_on_card():
    """The CUDA kernel == zopfli_dp_ref on CUDA tensors, every output bit
    for bit, and the commands of the 8 KB slice through device="cuda" ==
    the host's (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    zb = Z.stage_zopfli([_text_1200(), *_rng_lanes()], device="cuda")
    before = Z.KERNEL_LAUNCHES
    ker = Z.zopfli_dp(zb)
    assert Z.KERNEL_LAUNCHES == before + 1
    _assert_same(ker, Z.zopfli_dp_ref(zb))
    data = _slice_8k()
    cmds, last = Z.zopfli_commands_device(data, device="cuda")
    host_cmds, host_last = _host(data)
    assert (_tuples(cmds), last) == (_tuples(host_cmds), host_last)
