"""The port's device decode round trip (brotli_tpu_torch.decode_batch_device_e2e)
against the JAX package's (brotli_tpu.ops.pallas_decode2, interpret mode).

Tolerance: exact equality.  Decoded bytes must equal the input for both,
and neither may send a lane to the host decoder on these batches (a host
fallback would hide a device fault).  The corpus is built here from in-repo
files and numpy-seeded bytes.
"""

from functools import lru_cache
from pathlib import Path
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import brotli_tpu
import brotli_tpu_torch
from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu.ops import pallas_decode2 as P2
from brotli_tpu_torch.device import resolve_device
from brotli_tpu_torch.ops import decode2 as D
from brotli_tpu_torch.ops import resolve as R

ROOT = Path(__file__).resolve().parents[1]


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _port_decode(streams, **kw):
    before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu", **kw)
    return got, brotli_tpu_torch.fallback_stats()["lanes_fallback"] - before


@lru_cache(maxsize=None)
def _slice():
    """(data, streams, JAX decode_batch_device_e2e output, JAX fallback
    lanes): the reference's groups, min(MAX_GROUPS = 12, batch groups)."""
    data = _source_text(2048, skip=30000)
    streams = encode_sharded(data, chunk_size=256, max_distance=512 - 16)
    before = P2.fallback_stats()["lanes_fallback"]
    jax_out = P2.decode_batch_device_e2e(streams, H=512, interpret=True,
                                         token_row_cap=512)
    return data, streams, jax_out, P2.fallback_stats()["lanes_fallback"] - before


def test_slice_matches_jax():
    """encode_sharded -> both decode round trips: same bytes, no fallback."""
    data, streams, jax_out, jax_fell = _slice()
    port_out, port_fell = _port_decode(streams)
    assert jax_out == port_out
    assert b"".join(port_out) == data
    assert jax_fell == 0 and port_fell == 0


def test_reference_cap_matches_jax():
    """The port given the groups the reference's cap picks for the batch
    (min(MAX_GROUPS = 12, its groups)) explicitly == JAX."""
    _, streams, jax_out, _ = _slice()
    groups = min(P2.MAX_GROUPS, -(-len(streams) // P2.NSTREAM))
    port_out, port_fell = _port_decode(streams, groups=groups)
    assert port_out == jax_out and port_fell == 0


def test_far_distances_decode_without_fallback():
    """Copies beyond the reference ring's reach (H-16) decode on the port."""
    block = _source_text(1500, skip=50000)
    data = block + block
    streams = encode_sharded(data, chunk_size=3000)
    batch = P2.preflight_shared(streams)
    tok, count, _ = D.run_batch(batch, "cpu")
    col = tok[: int(count[0]), 0].numpy().view(np.uint32)
    far = col[(col >> 30) == 3] & 0x3FFFFF
    assert far.max() > 256 - 16   # the JAX tests' ring (H=256) flags these
    got, fell = _port_decode(streams)
    assert b"".join(got) == data and fell == 0


def test_rate_sorted_mixed_lanes_map_back():
    """Zeros, text and random chunks in one batch: rate_sort permutes the
    lane slots and the results come back in stream order."""
    rng = np.random.default_rng(11)
    data = (bytes(600) + _source_text(600)
            + rng.integers(0, 256, 600, np.uint8).tobytes())
    streams = encode_sharded(data, chunk_size=200)
    batch = P2.preflight_shared(streams, rate_sort=True)
    assert list(batch.perm[: len(streams)]) != list(range(len(streams)))
    got, fell = _port_decode(streams)
    assert b"".join(got) == data and fell == 0


def test_binned_batch_decodes_per_group():
    a_data, b_data = _source_text(700), bytes(500)
    a = encode_sharded(a_data, chunk_size=256)
    b = encode_sharded(b_data, chunk_size=256)
    got, fell = _port_decode(a + b)
    assert b"".join(got) == a_data + b_data and fell == 0


def test_two_groups():
    data = _source_text(1536, skip=70000)
    streams = encode_sharded(data, chunk_size=256)
    got, fell = _port_decode(streams, groups=2)
    assert b"".join(got) == data and fell == 0


def test_ineligible_batch_is_host_decoded_and_counted():
    # an empty stream has no metablock for the device to decode, so
    # neither preflight takes the batch
    data = [_source_text(900, skip=1000), b""]
    streams = [brotli_tpu.encode(d, quality=1) for d in data]
    assert P2.preflight_shared(streams) is None
    assert P2.preflight_binned(streams) is None
    got, fell = _port_decode(streams)
    assert got == data and fell == len(streams)


def test_truncated_lane_goes_to_host_decoder():
    """A cut stream reaches the host decoder, which raises BrotliError."""
    data = _source_text(2048, skip=4000)
    streams = list(encode_sharded(data, chunk_size=256, max_distance=496))
    streams[3] = streams[3][: len(streams[3]) // 2]
    with pytest.raises(brotli_tpu_torch.BrotliError):
        brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu")


def test_no_jax_import():
    """The package runs the slice with every jax import blocked."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import brotli_tpu_torch
        from brotli_tpu.encode.sharded import encode_sharded

        data = open("brotli_tpu/ops/pallas_decode2.py", "rb").read()[:2048]
        streams = encode_sharded(data, chunk_size=512, max_distance=496)
        got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu")
        assert b"".join(got) == data
        assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == 0
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    streams = encode_sharded(bytes(100), chunk_size=100)
    with pytest.raises(RuntimeError, match="cuda"):
        brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")


def test_resolve_device_names():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")


@pytest.mark.cuda
def test_round_trip_on_card():
    """The round trip through both kernels on a card (needs one)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    data = _source_text(65536)
    streams = encode_sharded(data, chunk_size=1024, max_distance=2032)
    e0, r0 = D.KERNEL_LAUNCHES, R.KERNEL_LAUNCHES
    before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")
    assert b"".join(got) == data
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == before
    assert D.KERNEL_LAUNCHES == e0 + 1
    assert R.KERNEL_LAUNCHES == r0 + 1
