"""The per-lane-table decode kernel on a CUDA card (brotli_tpu_torch/ops/
device_decode.py, csrc/device_decode.cu): the kernel against the plain
version on the same CUDA tensors, on well-formed, hand-broken and
bit-flipped lanes, and the drivers' bytes with their launches counted.

Needs a card: every test is marked `cuda` and skips where
torch.cuda.is_available() is False.  Imports nothing of JAX:
    python3 -m pytest --noconftest -m cuda tests/test_torch_device_decode_card.py
Tolerance: exact equality.
"""

import dataclasses

import numpy as np
import pytest
import torch

import brotli_tpu_torch
from brotli_tpu_torch import host_decode, host_encode
from brotli_tpu_torch.ops import device_decode as TD
from brotli_tpu_torch.ops.preflight2 import preflight_many
from brotli_tpu_torch.parallel import mesh as TM
from brotli_tpu_torch.utils.benchmarks import corpus

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")


def _streams(n: int = 64, size: int = 3000) -> list[bytes]:
    data = corpus(n * size)
    return [host_encode(data[i * size: (i + 1) * size - 37 * (i % 7)],
                        quality=1 + i % 4) for i in range(n)]


def _kernel_vs_plain(pre) -> tuple:
    db = TD.stage_batch(pre, "cuda")
    n0 = TD.KERNEL_LAUNCHES
    got = TD.device_decode(db)
    assert TD.KERNEL_LAUNCHES == n0 + 1
    ref = TD.device_decode_ref(db)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    return TD.fetch_outputs(*got)


def test_kernel_equals_plain_on_wellformed_and_broken_lanes(card):
    pre = preflight_many(_streams())
    broken = [dataclasses.replace(pre[0], max_backward=16),
              dataclasses.replace(pre[1], mlen=pre[1].mlen // 3),
              dataclasses.replace(pre[2], dist_offset=np.full_like(
                  pre[2].dist_offset, -5))]
    out, pos, err = _kernel_vs_plain(pre + broken)
    assert err[-3:].all()


def test_kernel_equals_plain_on_bitflipped_lanes(card):
    rng = np.random.default_rng(7)
    flipped = []
    for s in _streams(32):
        b = bytearray(s)
        for bit in rng.choice(8 * (len(b) - 2), 3, replace=False) + 16:
            b[bit >> 3] ^= 1 << (bit & 7)
        flipped.append(bytes(b))
    pre = [p for p in preflight_many(flipped) if p is not None]
    _kernel_vs_plain(pre)


def test_drivers_give_the_host_decoders_bytes(card):
    streams = _streams(48) + [host_encode(b"", quality=1)]
    want = [host_decode(s) for s in streams]
    n0 = TD.KERNEL_LAUNCHES
    assert brotli_tpu_torch.decode_batch_device(streams) == want
    assert TD.KERNEL_LAUNCHES == n0 + 1
    mesh = TM.get_mesh(3, "cuda", logical=True)
    assert brotli_tpu_torch.sharded_decode_batch(streams, mesh) == want
    assert TD.KERNEL_LAUNCHES == n0 + 4


def test_launch_refuses_a_short_output(card):
    pre = preflight_many(_streams(4))
    db = TD.stage_batch(pre, "cuda")
    with pytest.raises(ValueError):
        TD.device_decode(dataclasses.replace(db, out_size=1))
