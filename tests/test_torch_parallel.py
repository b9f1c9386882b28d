"""The port's scale-out layer (brotli_tpu_torch/parallel/mesh.py, the
dryrun in brotli_tpu_torch/entry.py) against the JAX package's
brotli_tpu/parallel/mesh.py on the 8-device CPU mesh (Pallas kernels in
interpret mode), on the CPU.

Tolerance: exact equality.  Each multi-device function must return what
the JAX function of the same name returns (decoded bytes; compressed
streams byte for byte), and both must equal the data.  The port may send
no lane to the host decoder where the test says 0 fallback lanes.  The
corpus is in-repo (utils/benchmarks.corpus: the reference package's
sources read as bytes).
"""

from functools import lru_cache
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import brotli_tpu
from brotli_tpu.encode.sharded import encode_sharded
from brotli_tpu.parallel import mesh as JM
import brotli_tpu_torch
from brotli_tpu_torch import native
from brotli_tpu_torch.entry import dryrun_multichip
from brotli_tpu_torch.ops import decode2 as D
from brotli_tpu_torch.ops import device_encode as TE
from brotli_tpu_torch.parallel import mesh as TM
from brotli_tpu_torch.utils.benchmarks import corpus

ROOT = Path(__file__).resolve().parents[1]


def _text(n: int, skip: int = 0) -> bytes:
    return corpus(skip + n)[skip:]


def _fallbacks() -> int:
    return brotli_tpu_torch.fallback_stats()["lanes_fallback"]


def test_get_mesh_cpu_slots_in_order():
    slots = TM.get_mesh(3, "cpu")
    assert [s.device for s in slots] == [torch.device("cpu")] * 3
    assert all(s.stream is None for s in slots)
    assert len(TM.get_mesh(device="cpu")) == 1
    assert JM.get_mesh(3).devices.size == len(slots)
    with pytest.raises(ValueError):
        TM.get_mesh(0, "cpu")


def test_get_mesh_cuda_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TM.get_mesh(2, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.get_mesh(2, "cuda", logical=True)


def test_get_mesh_more_gpus_than_visible_raises(monkeypatch):
    """Without logical=True, the mesh never quietly holds fewer slots."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 CUDA devices requested, 1"):
        TM.get_mesh(2, "cuda")


def test_broadcast_dictionary_matches_jax():
    port = TM.broadcast_dictionary(TM.get_mesh(4, "cpu"))
    assert list(port) == [torch.device("cpu")]   # one copy per device
    d = port[torch.device("cpu")]
    assert d.shape == (122784,) and d.dtype == torch.uint8
    assert bytes(d[:4].tolist()) == b"time"
    ref = np.asarray(JM.broadcast_dictionary(JM.get_mesh(4)))
    assert np.array_equal(d.numpy(), ref)


def test_broadcast_dictionary_chunks_matches_jax():
    port = TM.broadcast_dictionary_chunks(TM.get_mesh(2, "cpu"))
    d = port[torch.device("cpu")]
    ref = np.asarray(JM.broadcast_dictionary_chunks(JM.get_mesh(2)))
    # the JAX chunks replicate each 128-word row over 8 sublanes
    flat = ref.reshape(-1, 8, 128)[:, 0, :].reshape(-1).astype(np.int32)
    assert np.array_equal(d.numpy(), flat.view(np.uint8))


@lru_cache(maxsize=None)
def _v2_case():
    data = _text(16384, skip=40000)
    return data, encode_sharded(data, chunk_size=1024)


def _mixed():
    """Two streams with different tables (the binned path)."""
    return ([brotli_tpu.encode(_text(600, skip=5000), quality=1),
             brotli_tpu.encode(bytes(900), quality=1)],
            [_text(600, skip=5000), bytes(900)])


def _refused():
    """Context-modelled q11 streams, which neither preflight accepts."""
    texts = [_text(3000, skip=9000), _text(2500, skip=20000)]
    return [brotli_tpu.encode(t, quality=11) for t in texts], texts


def _shared():
    data, streams = _v2_case()
    return streams, [data[i: i + 1024] for i in range(0, len(data), 1024)]


PALLAS2_CASES = {"shared": _shared, "mixed": _mixed, "refused": _refused}


def test_decode_batches_multichip_matches_jax():
    data, streams = _v2_case()
    ref = JM.decode_batches_multichip(streams, JM.get_mesh(4), interpret=True,
                                      group_size=4)
    fb0 = _fallbacks()
    got = TM.decode_batches_multichip(streams, TM.get_mesh(4, "cpu"),
                                      group_size=4)
    assert got == ref
    assert b"".join(got) == data
    assert _fallbacks() == fb0


def test_decode_multichip_is_device_resident(monkeypatch):
    """The port's multi-device decode resolves with its own resolve kernel
    (its plain version here), never the host C++ resolver, and no lane
    falls back to the host decoder (tests/test_parallel.py's tripwire)."""
    def boom(*a, **k):
        raise AssertionError("host LZ resolver used on the flagship path")

    monkeypatch.setattr(native, "lz_resolve_batch_v2", boom)
    data = _text(16384, skip=70000)
    streams = encode_sharded(data, chunk_size=1024, max_distance=2048 - 16)
    fb0 = _fallbacks()
    got = TM.decode_batches_multichip(streams, TM.get_mesh(4, "cpu"),
                                      group_size=4)
    assert b"".join(got) == data
    assert _fallbacks() == fb0


def test_mixed_tables_take_the_binned_path(monkeypatch):
    """Two streams with different tables in one group: preflight_shared
    refuses the group, so it goes through decode_batch_pallas2, which bins
    it by table signature onto the kernels.  Bytes only are compared with
    JAX (the JAX driver does not count a binned batch's lanes alike)."""
    (a, b), want = _mixed()
    calls = []
    pallas2 = D.decode_batch_pallas2

    def seen(streams, **kw):
        calls.append(len(streams))
        return pallas2(streams, **kw)

    monkeypatch.setattr(D, "decode_batch_pallas2", seen)
    got = TM.decode_batches_multichip([a, b], TM.get_mesh(2, "cpu"),
                                      group_size=2)
    ref = JM.decode_batches_multichip([a, b], JM.get_mesh(2), interpret=True,
                                      group_size=2)
    assert got == ref == want
    assert calls == [2]
    assert D.preflight_shared([a, b], rate_sort=True) is None
    assert D.preflight_binned([a, b], max_groups=D.GROUP_CAP) is not None


def test_refused_group_is_host_decoded_and_counted():
    """A group neither preflight accepts (context-modelled q11 streams) is
    decoded on the host, and every one of its lanes is counted."""
    streams, texts = _refused()
    assert D.stage_v2(streams) is None
    fb0 = _fallbacks()
    got = TM.decode_batches_multichip(streams, TM.get_mesh(2, "cpu"),
                                      group_size=2)
    assert got == texts
    assert _fallbacks() - fb0 == 2
    ref = JM.decode_batches_multichip(streams, JM.get_mesh(2), interpret=True,
                                      group_size=2)
    assert got == ref


@pytest.mark.parametrize("name", list(PALLAS2_CASES))
def test_decode_batch_pallas2_matches_jax(name):
    """decode_batch_pallas2 on a shared-table batch, a binned one and one
    the host decodes whole: the reference's bytes (its C++ resolver
    against the port's resolve kernel), and the data."""
    from brotli_tpu.ops import pallas_decode2 as P2

    streams, want = PALLAS2_CASES[name]()
    got = D.decode_batch_pallas2(streams, device="cpu")
    assert got == P2.decode_batch_pallas2(streams, interpret=True) == want


ENC_CHUNK = 64    # a piece is 1024 x 64 B = 64 KB
ENC_KNOBS = {
    "default": {},
    # tests/test_parallel.py's bench-config knobs
    "bench": dict(max_distance=2048 - 16, chain_depth=3, table_groups=2,
                  lit_ctx_trees=2, hist_stride=16),
}


@pytest.mark.parametrize("name", list(ENC_KNOBS))
def test_encode_batches_multichip_matches_jax_and_pieces(name):
    """2.5 pieces over 2 slots: the port's streams == JAX's == the port's
    one-device encode_device_batch of each piece, and decode to the data."""
    knobs = ENC_KNOBS[name]
    step = TE.B_LANES * ENC_CHUNK
    data = _text(2 * step + step // 2, skip=1000)
    enc0 = brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"]
    got = TM.encode_batches_multichip(data, TM.get_mesh(2, "cpu"),
                                      chunk_size=ENC_CHUNK, **knobs)
    assert brotli_tpu_torch.encode_fallback_stats()["lanes_fallback"] == enc0
    single = []
    for off in range(0, len(data), step):
        single += brotli_tpu_torch.encode_device_batch(
            data[off: off + step], device="cpu", chunk_size=ENC_CHUNK, **knobs)
    assert len(got) == -(-len(data) // ENC_CHUNK)
    assert got == single
    ref = JM.encode_batches_multichip(data, JM.get_mesh(2), interpret=True,
                                      chunk_size=ENC_CHUNK, **knobs)
    assert got == ref
    assert b"".join(brotli_tpu.decode(s) for s in got) == data


def test_encode_batches_multichip_empty():
    assert TM.encode_batches_multichip(b"", TM.get_mesh(2, "cpu")) == \
        JM.encode_batches_multichip(b"", JM.get_mesh(2), interpret=True)


def test_decode_batch_v3_multichip_matches_jax():
    """The JAX dryrun's full-format shape (4 x 512 B, lit_ctx_trees=4,
    group_size=2) plus a q11 static-dictionary stream, against JAX at
    H=1024; the port reads the dictionary staged once."""
    data = _text(4 * 512, skip=100000)
    streams = brotli_tpu_torch.encode_device_batch(
        data, device="cpu", chunk_size=512, lit_ctx_trees=4, table_groups=1)
    text = b"the quick brown fox jumps over the lazy dog " * 3
    streams.append(brotli_tpu.encode(text, quality=11))
    jmesh = JM.get_mesh(4)
    ref = JM.decode_batch_v3_multichip(
        streams, jmesh, H=1024, interpret=True, group_size=2,
        dict_bcast=JM.broadcast_dictionary_chunks(jmesh))
    mesh = TM.get_mesh(4, "cpu")
    fb0 = _fallbacks()
    got = TM.decode_batch_v3_multichip(
        streams, mesh, group_size=2,
        dict_bcast=TM.broadcast_dictionary_chunks(mesh))
    want = [data[i: i + 512] for i in range(0, 2048, 512)] + [text]
    assert got == ref == want
    assert _fallbacks() == fb0


def test_slot_failure_propagates(monkeypatch):
    """A kernel wrapper that raises on one slot raises out of the driver."""
    from brotli_tpu_torch.ops import resolve as R

    def boom(*a, **k):
        raise RuntimeError("resolve kernel launch failed: cudaError 1")

    monkeypatch.setattr(R, "resolve_tokens", boom)
    _, streams = _v2_case()
    with pytest.raises(RuntimeError, match="resolve kernel launch failed"):
        TM.decode_batches_multichip(streams, TM.get_mesh(2, "cpu"),
                                    group_size=4)


def test_stream_overlap_of_a_trace(tmp_path):
    """The busy time and the time kernels of two streams overlap, from a
    Chrome trace in torch.profiler's form."""
    from brotli_tpu_torch.utils.profiling import (device_intervals,
                                                  stream_overlap)

    def ev(cat, stream, ts, dur):
        return {"ph": "X", "cat": cat, "name": "k", "ts": ts, "dur": dur,
                "tid": stream, "args": {"stream": stream}}

    trace = {"traceEvents": [
        ev("kernel", 7, 0, 10), ev("kernel", 9, 5, 7), ev("kernel", 7, 10, 3),
        ev("gpu_memcpy", 9, 20, 5), ev("cpu_op", 0, 0, 100),
        ev("kernel", 9, 30, 2), ev("kernel", 9, 31, 2)]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    got = stream_overlap(device_intervals(path))
    # busy: [0, 13] + [20, 25] + [30, 33]; two streams: [5, 12]
    assert got["busy_s"] == pytest.approx(21e-6)
    assert got["overlap_s"] == pytest.approx(7e-6)
    assert got["streams"] == [7, 9]


def test_dryrun_multichip_cpu():
    walls = dryrun_multichip(4, device="cpu", timeout_s=120)
    assert set(walls) == {"v2_s", "v3_s", "multihost_s"}


def test_parallel_imports_no_jax():
    code = ("import sys, brotli_tpu_torch.parallel, brotli_tpu_torch.entry\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'brotli_tpu'"
            " or m.startswith(('jax.', 'brotli_tpu.'))]\n"
            "print(bad)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
