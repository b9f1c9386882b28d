"""The port's device encoder end to end (brotli_tpu_torch
.encode_device_batch) against the JAX package's encode_device_batch in
interpret mode, and the port's encode -> decode round trip, on the CPU.

Tolerance: exact equality.  The streams must be byte-identical for every
knob set, every stream must decode with brotli_tpu.decode to its chunk,
and the round trip through the port's decoder must need no host fallback
on either side.  The corpus is built here from in-repo files and
numpy-seeded bytes.
"""

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
from brotli_tpu.ops import device_encode as JE
from brotli_tpu_torch.ops import device_encode as TE

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 1024


def _source_text(n: int, skip: int = 0) -> bytes:
    src = b"".join(p.read_bytes()
                   for p in sorted((ROOT / "brotli_tpu").rglob("*.py")))
    return src[skip: skip + n]


def _binary(n: int) -> bytes:
    """Sampled 16-bit signal: frequent high bytes, the SIGNED-context kind."""
    return (np.sin(np.arange(n // 2) / 5.0) * 2.5e4).astype("<i2").tobytes()


def _text() -> bytes:
    return _source_text(4 * CHUNK + 300, skip=12000)


def _mixed() -> bytes:
    rng = np.random.default_rng(3)
    return (_source_text(2 * CHUNK, skip=60000) + _binary(2 * CHUNK)
            + bytes(CHUNK) + rng.integers(0, 256, 700, np.uint8).tobytes())


def _far() -> bytes:
    """Repeats 1500 bytes apart inside 2 KB chunks: beyond max_distance."""
    block = _source_text(1500, skip=90000)
    return (block * 3)[: 2 * 2048]


KNOBS = {
    "default": (_text, dict()),
    "groups2_mixed": (_mixed, dict(table_groups=2)),
    "ctx4_groups2": (_mixed, dict(lit_ctx_trees=4, table_groups=2)),
    "blocks3_seg512": (_mixed, dict(lit_ctx_trees=4, block_types=3,
                                    block_seg=512)),
    "depth4_hash2": (_text, dict(chain_depth=4, hash2=True)),
    "stride2": (_text, dict(hash_stride=2)),
    "max_distance": (_far, dict(max_distance=1000, chunk_size=2048)),
    "lazy_gate": (_text, dict(lazy=(60, 120), min_gate=12)),
}


def _chunks(data: bytes, size: int) -> list[bytes]:
    return [data[i: i + size] for i in range(0, len(data), size)]


@pytest.mark.parametrize("name", list(KNOBS))
def test_streams_match_jax(name):
    make, kw = KNOBS[name]
    data = make()
    kw = {"chunk_size": CHUNK, **kw}
    jax_streams = JE.encode_device_batch(data, interpret=True, **kw)
    before = TE.encode_fallback_stats()["lanes_fallback"]
    port_streams = brotli_tpu_torch.encode_device_batch(data, device="cpu",
                                                        **kw)
    assert TE.encode_fallback_stats()["lanes_fallback"] == before
    assert port_streams == jax_streams
    assert ([brotli_tpu.decode(s) for s in port_streams]
            == _chunks(data, kw["chunk_size"]))


def test_empty_input_matches_jax():
    assert (brotli_tpu_torch.encode_device_batch(b"", device="cpu")
            == JE.encode_device_batch(b"", interpret=True))
    assert brotli_tpu.decode(
        brotli_tpu_torch.encode_device_batch(b"", device="cpu")[0]) == b""


@pytest.mark.parametrize("groups", [1, 2])
def test_round_trip_through_port_decoder(groups):
    """Port encode -> port decode: the data back, no fallback either side,
    and stream_sizes equal to the streams' lengths."""
    data = _mixed()
    state = TE._encode_start(data, torch.device("cpu"), CHUNK, 1, 256)
    TE._encode_mid(state, 22, table_groups=groups)
    sizes = TE.stream_sizes(state)
    enc0 = TE.encode_fallback_stats()["lanes_fallback"]
    streams = TE._encode_finish(state)
    assert TE.encode_fallback_stats()["lanes_fallback"] == enc0
    assert list(sizes) == [len(s) for s in streams]
    dec0 = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu")
    assert b"".join(got) == data
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == dec0


def test_overflowed_lane_is_host_encoded_and_counted(monkeypatch):
    """A lane the pack flags ovf is encoded on the host, and counted."""
    data = _text()
    orig = TE.pack_records

    def flag_lane_1(pb):
        words, status = orig(pb)
        status[5, 1] = 1
        return words, status

    monkeypatch.setattr(TE, "pack_records", flag_lane_1)
    before = TE.encode_fallback_stats()
    streams = brotli_tpu_torch.encode_device_batch(data, device="cpu",
                                                   chunk_size=CHUNK)
    after = TE.encode_fallback_stats()
    assert after["lanes_fallback"] == before["lanes_fallback"] + 1
    assert after["lanes_total"] == before["lanes_total"] + len(streams)
    assert [brotli_tpu.decode(s) for s in streams] == _chunks(data, CHUNK)


def test_bad_knobs_raise():
    with pytest.raises(ValueError, match="chunk_size"):
        brotli_tpu_torch.encode_device_batch(b"abc", device="cpu",
                                             chunk_size=1000)
    with pytest.raises(ValueError, match="block_types"):
        brotli_tpu_torch.encode_device_batch(b"abc" * 400, device="cpu",
                                             chunk_size=1024, block_types=2)


def test_no_jax_import():
    """Encode and decode back with every jax import blocked."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import brotli_tpu_torch

        data = open("brotli_tpu/ops/device_encode.py", "rb").read()[:3000]
        streams = brotli_tpu_torch.encode_device_batch(
            data, device="cpu", chunk_size=1024)
        got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cpu")
        assert b"".join(got) == data
        assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == 0
        assert brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] == 0
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
        brotli_tpu_torch.encode_device_batch(b"abc", device="cuda")


@pytest.mark.cuda
def test_round_trip_on_card():
    """Encode and decode on a card through the four kernels (needs one)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the GPU")
    from brotli_tpu_torch.ops import decode2 as D

    data = _source_text(64 * CHUNK)
    p0, d0, g0 = TE.KERNEL_LAUNCHES, D.KERNEL_LAUNCHES, TE.PARSE_LAUNCHES
    streams = brotli_tpu_torch.encode_device_batch(data, device="cuda",
                                                   chunk_size=CHUNK)
    assert streams == brotli_tpu_torch.encode_device_batch(
        data, device="cpu", chunk_size=CHUNK)
    before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    got = brotli_tpu_torch.decode_batch_device_e2e(streams, device="cuda")
    assert b"".join(got) == data
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == before
    assert TE.KERNEL_LAUNCHES == p0 + 1 and D.KERNEL_LAUNCHES == d0 + 1
    assert TE.PARSE_LAUNCHES == g0 + 1
