"""The port's structure probes (brotli_tpu_torch.tools.probe) against the
TPU probes tools/probe_v2.py and tools/probe_v2b.py.

The TPU scripts run their benches when imported and print no result, so
each file's source runs here without its trailing `bench(...)` calls, in a
namespace where `pl.pallas_call` gets `interpret=True`, `jax.jit`'s
function records its inputs and result, `print` is silent and np.random is
seeded first; ROWS is cut (16 rows for probe_v2, 512 and 1024 for
probe_v2b, whose last copy needs 8 rows a block).  The JAX files are not
edited.

Tolerance: exact equality.  The TPU kernel returns carry[0] (probe_v2) or
the staging rows it copies out (probe_v2b); the port's plain version must
give the same bits, and the host-shim build of csrc/probe.cuh must equal
the plain version on every output (all four carries and the staging, the
output rows and the per-row block and fill counts).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from brotli_tpu_torch.tools import probe as P
from brotli_tpu_torch.tools import probe_chain as PC
from brotli_tpu_torch.utils import benchmarks as B

ROOT = Path(__file__).resolve().parents[1]


def _tpu_probe(name: str, rows: int):
    """(bench, calls): the TPU script's bench() at `rows` rows, run in
    interpret mode; calls collects (inputs, output) of each kernel call."""
    path = ROOT / "tools" / name
    src = path.read_text()
    body = src[: src.index('\nbench("')]
    calls = []

    class Pallas:
        def __getattr__(self, k):
            return getattr(pl, k)

        def pallas_call(self, *a, **k):
            return pl.pallas_call(*a, **dict(k, interpret=True))

    class Jax:
        def __getattr__(self, k):
            return getattr(jax, k)

        def jit(self, f):
            jf = jax.jit(f)

            def run(*args):
                out = jf(*args)
                calls.append(([np.asarray(x) for x in args], np.asarray(out)))
                return out
            return run

    ns: dict = {}
    np.random.seed(0)
    exec(compile(body, str(path), "exec"), ns)
    ns.update(pl=Pallas(), jax=Jax(), print=lambda *a, **k: None,
              ROWS=rows, BLOCK_ROWS=rows // ns["BLOCKS"])
    return ns["bench"], calls


@pytest.fixture(scope="module")
def tpu_v2():
    return _tpu_probe("probe_v2.py", 16)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("label,level", P.V2_LEVELS)
def test_probe_v2_matches_tpu(tpu_v2, label, level):
    bench, calls = tpu_v2
    bench(label, level)
    (a,), out = calls[-1]
    carry, staging = P.probe_v2_ref(torch.from_numpy(a), level, rows=16)
    np.testing.assert_array_equal(_u32(carry[0]), out)
    assert staging.shape == (2, 8, 128)
    if level >= 4:
        # the last row's store is b0 itself
        np.testing.assert_array_equal(_u32(staging[1]), out)


@pytest.mark.parametrize("rows", [512, 1024])
@pytest.mark.parametrize("label,variant", P.V2B_VARIANTS)
def test_probe_v2b_matches_tpu(label, variant, rows):
    """Rows 0-7 always, and the rest of the 32-row staging copy with
    dma_out (the TPU kernel leaves them unwritten without it)."""
    bench, calls = _tpu_probe("probe_v2b.py", rows)
    bench(label, **variant)
    (a, wt), out = calls[-1]
    got, stat = P.probe_v2b_ref(torch.from_numpy(a),
                                torch.from_numpy(wt.view(np.int32)),
                                rows=rows, **variant)
    n = rows // 64 if variant.get("dma_out") else 8
    np.testing.assert_array_equal(_u32(got)[:n], out[:n])
    # every block ran in every tile row
    assert stat[:, 0].tolist() == [64] * 8


@pytest.mark.parametrize("label,level", P.V2_LEVELS)
def test_probe_v2_host_shim_equals_plain(label, level):
    a = torch.from_numpy(P.probe_inputs(1)[0])
    ref = P.probe_v2_ref(a, level, rows=96)
    host = P.probe_v2_host(a, level, rows=96)
    for r, h in zip(ref, host):
        assert torch.equal(r, h)


@pytest.mark.parametrize("label,variant", P.V2B_VARIANTS)
def test_probe_v2b_host_shim_equals_plain(label, variant):
    a, wt = (torch.from_numpy(x) for x in P.probe_inputs(2))
    ref = P.probe_v2b_ref(a, wt, rows=1024, **variant)
    host = P.probe_v2b_host(a, wt, rows=1024, **variant)
    for r, h in zip(ref, host):
        assert torch.equal(r, h)


def test_probe_v2b_reduction_is_per_tile_row():
    """A tile row whose carry[0] starts at 0xFFFFFFFF stops the while +
    reduces loop in that row alone; the refill test reads its own row."""
    a, wt = (torch.from_numpy(x) for x in P.probe_inputs(3))
    a[5] = -1
    full = dict(P.V2B_VARIANTS[-1][1])
    ref = P.probe_v2b_ref(a, wt, rows=512, **full)
    host = P.probe_v2b_host(a, wt, rows=512, **full)
    for r, h in zip(ref, host):
        assert torch.equal(r, h)
    blocks = ref[1][:, 0].tolist()
    assert blocks[5] == 0 and blocks[:5] + blocks[6:] == [64] * 7


def test_probe_wrappers_take_plain_on_cpu():
    a, wt = (torch.from_numpy(x) for x in P.probe_inputs(4))
    n2, n2b = P.PROBE_V2_LAUNCHES, P.PROBE_V2B_LAUNCHES
    for x, y in zip(P.probe_v2(a, 5, rows=32), P.probe_v2_ref(a, 5, rows=32)):
        assert torch.equal(x, y)
    kw = P.V2B_VARIANTS[3][1]
    for x, y in zip(P.probe_v2b(a, wt, rows=512, **kw),
                    P.probe_v2b_ref(a, wt, rows=512, **kw)):
        assert torch.equal(x, y)
    outs, ns = P.run_probe_v2(2, device="cpu", rows=32)
    assert ns is None and outs[0].shape == (4, 8, 128)
    outs, ns = P.run_probe_v2b(kw, device="cpu", rows=512)
    assert ns is None and outs[1].shape == (8, 2)
    assert (P.PROBE_V2_LAUNCHES, P.PROBE_V2B_LAUNCHES) == (n2, n2b)


def test_probe_refuses_bad_arguments():
    a, wt = (torch.from_numpy(x) for x in P.probe_inputs(5))
    with pytest.raises(ValueError, match="level"):
        P.probe_v2(a, 6)
    with pytest.raises(ValueError, match="multiple"):
        P.probe_v2(a, 1, rows=100)
    with pytest.raises(ValueError, match="int32"):
        P.probe_v2(a.to(torch.int64), 1)
    with pytest.raises(ValueError, match="8 rows"):
        P.probe_v2b(a, wt, rows=256)
    with pytest.raises(ValueError, match="carries"):
        P.probe_v2b(a, wt, ncarry=5)
    with pytest.raises(ValueError, match="rows"):
        P.probe_v2b(a, wt[:100])


def test_timer_refuses_cpu():
    a = torch.zeros(4)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="not on the card"):
            B.time_device_fn(lambda x: x + 1, a)
    else:
        with pytest.raises(RuntimeError, match="CUDA card"):
            B.time_device_fn(lambda x: x + 1, a)


# A loop of cuobjdump -sass lines in its format: one row a pass, whose
# carried chain is b0 (R6) -> R9 (LOP3 with a predicate and a register
# result) -> R12 -> R16 (LDS) -> R7 (IADD) -> R6 (VIADD, LOP3), 6
# instructions; the counter R5 and its compare run beside it.
SASS_LOOP = """
        /*0200*/                   IMAD.MOV.U32 R5, RZ, RZ, RZ ;      /* 0x000000ffff057224 */
        /*0210*/                   VIADD R3, R7, 0x3039 ;             /* 0x0000303907037836 */
        /*0220*/                   LOP3.LUT R6, R6, R3, RZ, 0x3c, !PT ;
        /*0230*/                   LOP3.LUT P2, R9, R6, 0x1f, RZ, 0xc0, !PT ;
        /*0240*/                   IMAD.SHL.U32 R12, R9, 0x4, RZ ;
        /*0250*/                   LDS R16, [R12+UR5] ;
        /*0260*/                   IMAD.WIDE.U32 R12, R5, 0x400, R2 ;
        /*0270*/                   ISETP.NE.AND P3, PT, R5, 0x100, PT ;
        /*0280*/                   STG.E desc[UR6][R12.64], R6 ;
        /*0290*/               @P2 IADD3 R7, R7, R16, RZ ;
        /*02a0*/                   VIADD R5, R5, 0x1 ;
        /*02b0*/               @P3 BRA 0x210 ;                    /* 0xfffffff800383947 */
        /*02c0*/                   EXIT ;
        /*02d0*/                   BRA 0x2d0;
"""


def test_probe_chain_reads_sass():
    """tools/probe_chain.py's SASS reading on a hand-written loop: each
    instruction's sources and destinations, the loops closed by a backward
    branch, and the chain a pass adds."""
    insts = PC.parse_sass(SASS_LOOP)
    assert [i[0] for i in insts] == list(range(0x200, 0x2e0, 0x10))
    by_op = {i[0]: (i[2], i[3]) for i in insts}
    assert by_op[0x230] == (["R6"], ["P2", "R9"])
    assert by_op[0x250] == (["R12", "UR5"], ["R16"])
    assert by_op[0x260] == (["R5", "R2"], ["R12", "R13"])
    assert by_op[0x270] == (["R5"], ["P3"])
    assert by_op[0x280] == (["UR6", "R12", "R13", "R6"], [])
    # a guarded instruction also reads its guard and its old destination
    assert by_op[0x290] == (["R7", "R16", "P2", "R7"], ["R7"])
    assert by_op[0x2b0] == (["P3"], [])
    loops = PC.loops(insts)
    assert [(lp["start"], lp["end"], lp["instructions"], lp["stg"],
             lp["lds"]) for lp in loops] == [("0x210", "0x2b0", 11, 1, 1),
                                             ("0x2d0", "0x2d0", 1, 0, 0)]
    assert loops[0]["chain"] == 6.0
    assert PC.chain_per_iteration([]) == 0.0


@pytest.mark.cuda
def test_probes_on_card():
    """Every level and variant: kernel == plain version, bit for bit, and
    a launch counted each (needs a card)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    a, wt = (torch.from_numpy(x).cuda() for x in P.probe_inputs(6))
    for _, level in P.V2_LEVELS:
        n = P.PROBE_V2_LAUNCHES
        ker = P.probe_v2(a, level)
        assert P.PROBE_V2_LAUNCHES == n + 1
        for x, y in zip(ker, P.probe_v2_ref(a, level)):
            assert torch.equal(x, y)
    for _, variant in P.V2B_VARIANTS:
        n = P.PROBE_V2B_LAUNCHES
        ker = P.probe_v2b(a, wt, **variant)
        assert P.PROBE_V2B_LAUNCHES == n + 1
        for x, y in zip(ker, P.probe_v2b_ref(a, wt, **variant)):
            assert torch.equal(x, y)


def test_profilers_refuse_the_cpu():
    from brotli_tpu_torch.utils import profiling as PF

    with pytest.raises(ValueError, match="no device time"):
        PF.profile_e2e_decode([b"\x0b\x01\x80hello\x03"], device="cpu")
    with pytest.raises(ValueError, match="no device time"):
        PF.profile_device_encode(b"hello", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            with PF.trace():
                pass
        with pytest.raises(RuntimeError, match="CUDA card"):
            PF.profile_e2e_decode([b"x"], device="cuda")


def test_phase_report_arithmetic():
    from brotli_tpu_torch.utils.profiling import Phase, phase_report

    phases = [Phase("preflight", 0.5, "host", {"streams": 4}),
              Phase("entropy kernel", 0.002, "device")]
    lines = phase_report(phases, total_bytes=10_000_000).splitlines()
    assert lines[0] == ("preflight" + " " * 10 + "500.00 ms  [host]"
                        + " " * 6 + "20.0 MB/s  streams=4")
    assert lines[1] == ("entropy kernel" + " " * 7 + "2.00 ms  [device]"
                        + "    5000.0 MB/s")
    assert phase_report(phases[1:]) == ("entropy kernel" + " " * 7
                                        + "2.00 ms  [device]")


def test_busy_share_arithmetic():
    """Device time by name from key_averages(): device events only, summed
    per name; over the window; None where the profiler saw none."""
    from types import SimpleNamespace

    from brotli_tpu_torch.utils import profiling as PF

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Prof:
        def __init__(self, events):
            self.events = events

        def key_averages(self):
            return self.events

    def ev(key, dtype, us):
        return SimpleNamespace(key=key, device_type=dtype,
                               device_time_total=us)

    prof = Prof([ev("decode2_kernel", cuda, 3000.0), ev("aten::add", cpu,
                                                        9000.0),
                 ev("Memcpy HtoD", cuda, 1000.0)])
    assert PF.device_times(prof) == {"decode2_kernel": 0.003,
                                     "Memcpy HtoD": 0.001}
    assert PF.busy_share(prof, 0.008) == pytest.approx(0.5)
    assert PF.busy_share(Prof([ev("aten::add", cpu, 5.0)]), 0.008) is None


def test_entry_on_cpu():
    """entry(): the v2 entropy kernel's wrapper and a staged 32-stream
    batch; on CPU tensors fn is the plain version and decodes every lane."""
    from brotli_tpu_torch.entry import entry, example_shared_batch
    from brotli_tpu_torch.ops import decode2 as D

    fn, args = entry(device="cpu")
    assert fn is D.entropy_decode and args[0].device.type == "cpu"
    tok, count, phase, _ = fn(*args)
    data, streams, batch = example_shared_batch()
    assert len(streams) == 32
    assert (phase[:32] == D.DONE).all() and (count[:32] > 0).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry()
