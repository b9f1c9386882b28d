"""The port's v3 drivers end to end on the CPU: brotli_tpu_torch
.decode_batch_v3 on the device encoder's context-mapped streams, and
.decode_batch_v3_full on streams of several metablocks, against the JAX
package's drivers (interpret mode) and the data.

Tolerance: exact equality of the decoded bytes, with no host fallback on
either side.  The corpus is built here from in-repo files.
"""

from functools import lru_cache
from pathlib import Path
import os
import subprocess
import sys
import textwrap

import pytest
import torch

import brotli_tpu
import brotli_tpu_torch
from brotli_tpu.encode import encode
from brotli_tpu.encode import metablock_full as MF
from brotli_tpu.encode.api import Encoder
from brotli_tpu.ops import pallas_decode2 as P2
from brotli_tpu.ops import pallas_decode3 as P3
from brotli_tpu.parallel.shard import parallel_encode
from brotli_tpu_torch.ops import decode3 as D3

from test_torch_decode3 import _source_text, round_robin_splitter

ROOT = Path(__file__).resolve().parents[1]
CHUNK = 1024
# the reference bench's full-format encode (bench.py:68-72, 336-344), at
# 1 KB chunks
SLICE_KW = dict(max_distance=1008, chain_depth=4, table_groups=1,
                lit_ctx_trees=8)


def streaming_stream(data: bytes, block_bits: int = 10) -> bytes:
    """The streaming Encoder(quality=5, lgwin=18) fed 1 KB updates, with
    its block size cut to 2**block_bits so that each update ends a
    compressed metablock whose copies reach into the ones before."""
    enc = Encoder(quality=5, lgwin=18)
    enc.params.lgblock = block_bits
    out = b""
    for off in range(0, len(data), 1024):
        out += enc.update(data[off: off + 1024])
    return out + enc.finish()


FULL = {
    "streaming": lambda d: streaming_stream(d, block_bits=11),
    "spliced": lambda d: parallel_encode(d, shard_size=1024, quality=5),
    "uncompressed": lambda d: encode(d, quality=0),
}


def _fallbacks() -> tuple[int, int]:
    return (brotli_tpu_torch.fallback_stats()["lanes_fallback"],
            P2.fallback_stats()["lanes_fallback"])


@lru_cache(maxsize=None)
def _slice():
    """(data, port-encoded streams at the bench setting, JAX
    decode_batch_v3 of them at the reference's max_groups=4)."""
    data = _source_text(8 * CHUNK, skip=100000)
    streams = brotli_tpu_torch.encode_device_batch(
        data, device="cpu", chunk_size=CHUNK, **SLICE_KW)
    return data, streams, P3.decode_batch_v3(streams, H=512, interpret=True,
                                             max_groups=4)


def test_slice_matches_jax_and_data():
    """Port encode (bench setting, 8 context-mapped literal trees) -> port
    decode_batch_v3 == JAX decode_batch_v3 == the data."""
    before = _fallbacks()
    data, streams, jax = _slice()
    batch = P3.preflight_v3(streams)
    assert batch.groups == 1 and batch.configs[0].NL == 8
    port = brotli_tpu_torch.decode_batch_v3(streams, device="cpu")
    assert _fallbacks() == before
    chunks = [data[i: i + CHUNK] for i in range(0, len(data), CHUNK)]
    assert port == jax == chunks


def test_reference_cap_matches_jax():
    """The port's decode_batch_v3 given the reference's max_groups=4
    explicitly == JAX's at the same cap."""
    before = _fallbacks()
    _, streams, jax = _slice()
    assert brotli_tpu_torch.decode_batch_v3(streams, device="cpu",
                                            max_groups=4) == jax
    assert _fallbacks() == before


@pytest.mark.parametrize("name", list(FULL))
def test_full_path_matches_jax_and_data(name, monkeypatch):
    """decode_batch_v3_full, one kernel run per round of metablocks."""
    data = _source_text(3 * CHUNK, skip=110000)
    stream = FULL[name](data)
    assert brotli_tpu.decode(stream) == data
    rounds = []
    run = D3.run_batch_v3
    monkeypatch.setattr(D3, "run_batch_v3",
                        lambda *a, **k: rounds.append(1) or run(*a, **k))
    before = _fallbacks()
    port = brotli_tpu_torch.decode_batch_v3_full([stream], device="cpu")
    jax = P3.decode_batch_v3_full([stream], H=1024, interpret=True)
    assert _fallbacks() == before
    assert port == jax == [data]
    assert len(rounds) == {"streaming": 2, "spliced": 3, "uncompressed": 0}[name]


def test_full_path_1k_metablocks():
    """The streaming stream cut into 1 KB metablocks: the port's full path
    equals the host decoder and the data, with no fallback.  (JAX v3 at
    H=1024, 2048 or 4096 returns 7 wrong bytes of these 3072, unflagged:
    three copies whose source starts in the previous metablock read zeros
    there.  The port does not copy that.)"""
    data = _source_text(3 * CHUNK, skip=110000)
    stream = streaming_stream(data, block_bits=10)
    assert brotli_tpu.decode(stream) == data
    before = _fallbacks()
    assert brotli_tpu_torch.decode_batch_v3_full([stream], device="cpu") == [
        data]
    assert _fallbacks() == before


def test_windowed_shim_in_full_path(monkeypatch):
    """decode_batch_v3_full on the stream of 1 KB metablocks with every
    round's batch also run through the windowed kernel's per-lane code
    (g++) at a 64-byte window: equal to the plain version bit for bit in
    every round, where lanes carry a history prefix and copies reach past
    the window into it and into flushed output; the bytes equal the data,
    with no fallback."""
    import shutil

    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host shim cannot be built")
    window = 64
    data = _source_text(3 * CHUNK, skip=110000)
    stream = streaming_stream(data, block_bits=10)
    rounds = []
    plain = D3.decode3

    def both(tb, use_dict=True):
        ref = plain(tb, use_dict)
        got = D3.decode3_host(tb, use_dict, window=window)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        rounds.append(tb.hrb)
        return ref

    monkeypatch.setattr(D3, "decode3", both)
    before = _fallbacks()
    assert brotli_tpu_torch.decode_batch_v3_full([stream], device="cpu") == [
        data]
    assert _fallbacks() == before
    assert len(rounds) >= 2 and max(rounds) > window


@pytest.mark.parametrize("k", [12, 16])
def test_more_than_8_block_types(k, monkeypatch):
    """A valid in-repo stream with k block types in all three categories
    (beyond the single-metablock caps, inside the full path's): the port's
    full path decodes it like the host decoder, on the device.  JAX v3 is
    run at 12 types only: its compile takes a minute or more at each."""
    from brotli_tpu.decode.bitreader import BitReader
    from brotli_tpu.decode.engine import (
        _MetablockState,
        _decode_window_bits,
        _read_metablock_length,
    )

    data = _source_text(4000, skip=70000)
    monkeypatch.setattr(MF, "split_block", round_robin_splitter(k))
    stream = encode(data, quality=9)
    monkeypatch.undo()
    br = BitReader(stream)
    _decode_window_bits(br, False)
    input_end = bool(br.read(1))
    assert input_end and br.read(1) == 0   # one last, non-empty metablock
    _read_metablock_length(br, input_end)
    st = _MetablockState(br, large_window=False)
    assert st.num_types == [k, k, k]
    assert P3.preflight_one_v3(stream) is None and P3._caps_full_ok(st)
    before = _fallbacks()
    got = brotli_tpu_torch.decode_batch_v3_full([stream], device="cpu")
    assert got == [brotli_tpu.decode(stream)] == [data]
    if k == 12:
        assert P3.decode_batch_v3_full([stream], H=512, interpret=True) == [
            data]
    assert _fallbacks() == before


def test_refused_batch_is_host_decoded_and_counted():
    """More table signatures than max_groups: the whole batch decodes on
    the host, and every lane counts as a fallback."""
    a = _source_text(600, skip=20000)
    streams = [encode(a, quality=5), encode(a, quality=11),
               brotli_tpu_torch.encode_device_batch(a, device="cpu",
                                                    chunk_size=1024)[0]]
    assert P3.preflight_v3(streams, max_groups=1) is None
    before = brotli_tpu_torch.fallback_stats()
    got = brotli_tpu_torch.decode_batch_v3(streams, device="cpu",
                                           max_groups=1)
    after = brotli_tpu_torch.fallback_stats()
    assert got == [a, a, a]
    assert after["lanes_fallback"] == before["lanes_fallback"] + 3


def test_no_jax_import():
    """Both v3 drivers with every jax import blocked."""
    code = textwrap.dedent("""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name == "jax" or name.startswith(("jax.", "jaxlib")):
                    raise ImportError("jax is blocked: " + name)
                return None

        sys.meta_path.insert(0, Block())
        import brotli_tpu_torch
        from brotli_tpu.encode.api import Encoder

        data = open("brotli_tpu/ops/device_encode.py", "rb").read()[:3000]
        streams = brotli_tpu_torch.encode_device_batch(
            data, device="cpu", chunk_size=1024, lit_ctx_trees=8)
        got = brotli_tpu_torch.decode_batch_v3(streams, device="cpu")
        assert b"".join(got) == data
        enc = Encoder(quality=5, lgwin=18)
        enc.params.lgblock = 10
        s = enc.update(data[:2048]) + enc.finish()
        assert brotli_tpu_torch.decode_batch_v3_full([s], device="cpu") == [
            data[:2048]]
        assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == 0
        assert not [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.cuda
def test_drivers_on_card():
    """Both drivers through the kernel on a card (needs one)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernel runs only on the GPU")
    data = _source_text(64 * CHUNK)
    streams = brotli_tpu_torch.encode_device_batch(
        data, device="cuda", chunk_size=CHUNK, **SLICE_KW)
    before = brotli_tpu_torch.fallback_stats()["lanes_fallback"]
    n0 = D3.KERNEL_LAUNCHES
    assert b"".join(brotli_tpu_torch.decode_batch_v3(streams,
                                                     device="cuda")) == data
    s = streaming_stream(data[:4096])
    assert brotli_tpu_torch.decode_batch_v3_full([s], device="cuda") == [
        data[:4096]]
    assert brotli_tpu_torch.fallback_stats()["lanes_fallback"] == before
    assert D3.KERNEL_LAUNCHES == n0 + 1 + 4
