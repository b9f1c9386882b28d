"""The per-lane-table decode kernels on a CUDA card (brotli_tpu_torch/ops/
device_decode.py, csrc/device_decode.cu): the shared-memory kernel
(`device_decode`) against the direct kernel (`device_decode_direct`) and
the plain version on the same CUDA tensors, on well-formed, hand-broken
and bit-flipped lanes and on rows longer than the kernel's window, and
the drivers' bytes with their launches counted.

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


def _same(a, b) -> None:
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def _kernel_vs_plain(pre, plain: bool = True) -> tuple:
    """The shared kernel == the direct kernel (== the plain version), one
    launch of each counted."""
    db = TD.stage_batch(pre, "cuda")
    n0, d0 = TD.KERNEL_LAUNCHES, TD.DIRECT_LAUNCHES
    got = TD.device_decode(db)
    direct = TD.device_decode_direct(db)
    assert TD.KERNEL_LAUNCHES == n0 + 1 and TD.DIRECT_LAUNCHES == d0 + 1
    _same(got, direct)
    if plain:
        _same(got, TD.device_decode_ref(db))
    return TD.fetch_outputs(*got)


def _flip(streams, seed: int, n_flips: int = 3) -> list[bytes]:
    rng = np.random.default_rng(seed)
    flipped = []
    for s in streams:
        b = bytearray(s)
        for bit in rng.choice(8 * (len(b) - 2), n_flips, replace=False) + 16:
            b[bit >> 3] ^= 1 << (bit & 7)
        flipped.append(bytes(b))
    return flipped


def test_kernel_equals_plain_on_wellformed_and_broken_lanes(card):
    pre = preflight_many(_streams())
    broken = [dataclasses.replace(pre[0], max_backward=16),
              dataclasses.replace(pre[1], mlen=pre[1].mlen // 3),
              dataclasses.replace(pre[2], dist_offset=np.full_like(
                  pre[2].dist_offset, -5))]
    # a padding entry the compact tables cannot hold: the row where it lies
    wide = pre[4].cmd_table.copy()
    wide[-1] = 0x7FFF0000
    broken.append(dataclasses.replace(pre[4], cmd_table=wide))
    out, pos, err = _kernel_vs_plain(pre + broken)
    assert err[-4:-1].all() and not err[-1] and pos[-1] == pre[4].mlen


def test_kernel_equals_plain_on_bitflipped_lanes(card):
    pre = [p for p in preflight_many(_flip(_streams(32), 7)) if p is not None]
    _kernel_vs_plain(pre)


def test_kernel_equals_plain_on_an_insert_past_the_row(card):
    """One lane cut inside an insert, alone, so its literals run past
    out_size and land on the row's last byte."""
    pre = preflight_many(_streams(4))[0]
    past = 0
    for m in range(40, 400, 37):
        out, pos, err = _kernel_vs_plain([dataclasses.replace(pre, mlen=m)])
        past += int(pos[0] > m)
    assert past


def test_kernels_agree_on_rows_longer_than_the_window(card):
    """8 x 64 KB at quality 1-3 (8x the shared kernel's window: it
    flushes as it wraps, refills its words ring and reads far copies
    from the row), whole and bit-flipped; no plain run (its steps take
    minutes at 64 KB)."""
    size = 65536
    data = corpus(8 * size)
    pieces = [data[i * size: (i + 1) * size] for i in range(8)]
    streams = [host_encode(p, quality=1 + i % 3) for i, p in enumerate(pieces)]
    out, pos, err = _kernel_vs_plain(preflight_many(streams), plain=False)
    assert not err.any()
    for k, p in enumerate(pieces):
        assert bytes(out[k, : pos[k]]) == p
    flipped = [p for p in preflight_many(_flip(streams, 11)) if p is not None]
    _kernel_vs_plain(flipped, plain=False)


def test_drivers_give_the_host_decoders_bytes(card):
    streams = _streams(48) + [host_encode(b"", quality=1)]
    want = [host_decode(s) for s in streams]
    n0, d0 = TD.KERNEL_LAUNCHES, TD.DIRECT_LAUNCHES
    assert brotli_tpu_torch.decode_batch_device(streams) == want
    assert TD.KERNEL_LAUNCHES == n0 + 1
    mesh = TM.get_mesh(3, "cuda", logical=True)
    assert brotli_tpu_torch.sharded_decode_batch(streams, mesh) == want
    assert TD.KERNEL_LAUNCHES == n0 + 4 and TD.DIRECT_LAUNCHES == d0


def test_launch_refuses_a_short_output(card):
    pre = preflight_many(_streams(4))
    db = TD.stage_batch(pre, "cuda")
    for fn in (TD.device_decode, TD.device_decode_direct):
        with pytest.raises(ValueError):
            fn(dataclasses.replace(db, out_size=1))


def test_launch_config(card):
    cfg = TD.launch_config()
    assert cfg["threads"] == 32 and cfg["ring_words"] == TD.RING_WORDS
    assert cfg["window_bytes"] == TD.WINDOW
    assert cfg["blocks_an_sm"] * (cfg["shared_bytes"] + 1024) <= 228 * 1024
