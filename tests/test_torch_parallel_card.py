"""The port's multi-device layer on a CUDA card (brotli_tpu_torch/parallel/
mesh.py): logical slots on one card, bytes equal to the CPU port's, the
dictionary staged once per device, a launch failure that propagates.

Needs a card: every test is marked `cuda` and skips where
torch.cuda.is_available() is False.  Imports nothing of JAX, so it runs
on a machine without it:
    python3 -m pytest --noconftest -m cuda tests/test_torch_parallel_card.py
Tolerance: exact equality.
"""

import pytest
import torch

import brotli_tpu_torch
from brotli_tpu_torch import build
from brotli_tpu_torch.ops import decode2 as D
from brotli_tpu_torch.ops import decode3 as D3
from brotli_tpu_torch.ops import resolve as R
from brotli_tpu_torch.parallel import mesh as TM
from brotli_tpu_torch.utils.benchmarks import corpus

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")


def test_logical_slots_have_distinct_streams(card):
    slots = TM.get_mesh(4, "cuda:0", logical=True)
    assert [s.device for s in slots] == [torch.device("cuda", 0)] * 4
    assert len({s.stream.cuda_stream for s in slots}) == 4
    assert torch.cuda.current_stream(0).cuda_stream not in \
        {s.stream.cuda_stream for s in slots}


def test_bytes_equal_the_cpu_port(card):
    """Encode over 4 slots on the card == over 2 CPU slots; the v2 decode
    over 4 slots gives the data back with both kernels launched once a
    group and no host fallback."""
    chunk = 1024
    data = corpus(2 * 1024 * chunk + 5000)
    mesh = TM.get_mesh(4, "cuda", logical=True)
    got = TM.encode_batches_multichip(data, mesh, chunk_size=chunk)
    ref = TM.encode_batches_multichip(data, TM.get_mesh(2, "cpu"),
                                      chunk_size=chunk)
    assert got == ref
    fb0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    e0, r0 = D.KERNEL_LAUNCHES, R.KERNEL_LAUNCHES
    out = TM.decode_batches_multichip(got, mesh)
    assert b"".join(out) == data
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == fb0
    groups = -(-len(got) // 1024)
    assert (D.KERNEL_LAUNCHES - e0, R.KERNEL_LAUNCHES - r0) == (groups, groups)


def test_dictionary_staged_once_per_device(card, monkeypatch):
    mesh = TM.get_mesh(4, "cuda", logical=True)
    bcast = TM.broadcast_dictionary_chunks(mesh)
    assert list(bcast) == sorted({s.device for s in mesh}, key=str)
    seen = []
    decode3 = D3.decode3

    def spy(tb, *a):
        seen.append(tb.dict)
        return decode3(tb, *a)

    monkeypatch.setattr(D3, "decode3", spy)
    data = corpus(8 * 512)
    streams = brotli_tpu_torch.encode_device_batch(
        data, device="cuda", chunk_size=512, lit_ctx_trees=4)
    out = TM.decode_batch_v3_multichip(streams, mesh, group_size=2,
                                       dict_bcast=bcast)
    assert b"".join(out) == data
    assert len(seen) == 4
    assert all(d is bcast[torch.device("cuda", 0)] for d in seen)


def test_launch_failure_propagates(card, monkeypatch):
    """A slot whose resolve launch fails raises out of the driver."""
    lib = build.kernels_lib()

    class Failing:
        def __getattr__(self, name):
            if name == "brotli_torch_resolve":
                return lambda *a: 1     # cudaErrorInvalidValue
            return getattr(lib, name)

    monkeypatch.setattr(build, "kernels_lib", lambda: Failing())
    streams = brotli_tpu_torch.encode_sharded(corpus(8 * 1024),
                                              chunk_size=1024)
    with pytest.raises(RuntimeError, match="resolve kernel launch failed"):
        TM.decode_batches_multichip(streams, TM.get_mesh(2, "cuda",
                                                         logical=True),
                                    group_size=4)
