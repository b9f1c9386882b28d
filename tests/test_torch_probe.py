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
