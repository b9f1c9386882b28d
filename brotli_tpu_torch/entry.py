"""The port's entry points, the counterparts of __graft_entry__.py.

`entry()` returns the flagship device component, the v2 entropy kernel
(ops/decode2.py `entropy_decode`, csrc/decode2.cu), with a staged batch of
32 shared-table streams on the card: `fn(*args)` decodes them to tokens.

`dryrun_multichip(n)` drives the scale-out layer end to end over n device
slots (parallel/mesh.py; on one card, n CUDA streams): the dictionary
staged on every device, a device encode split into pieces on several
slots and decoded back through the v2 kernels, a context-mapped encode
decoded through the v3 kernel with the staged dictionary, and the
two-process round trip of tools/multihost_sim.py.  Any failure raises.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch


def example_shared_batch():
    """(data, streams, batch): 32 chunks of 512 B of repeated text as
    shared-table streams and their preflight (__graft_entry__'s batch)."""
    from .encode.sharded import encode_sharded
    from .ops.preflight2 import preflight_shared

    data = (b"the quick brown fox jumps over the lazy dog. " * 512)[:32 * 512]
    streams = encode_sharded(data, chunk_size=512)
    batch = preflight_shared(streams)
    if batch is None:
        raise RuntimeError("preflight_shared refused the example batch")
    return data, streams, batch


def entry(device: torch.device | str = "cuda"):
    """Returns (fn, args): the v2 entropy kernel and the example batch
    staged on `device` (the card unless the caller asks for the CPU, where
    fn is the kernel's plain version).  fn(*args) gives (tokens, counts,
    phases, words consumed) per lane."""
    from .ops.decode2 import batch_to_torch, entropy_decode

    _, _, batch = example_shared_batch()
    return entropy_decode, (batch_to_torch(batch, device),)


# dryrun_multichip's encode: two and a bit pieces of B_LANES (1024) chunks
# of DRY_CHUNK bytes, so that three slots encode
DRY_CHUNK = 256
DRY_BYTES = 2 * 1024 * DRY_CHUNK + 4096


def dryrun_multichip(n_devices: int, device: torch.device | str = "cuda",
                     timeout_s: float = 600.0) -> dict:
    """The multi-device round trip over `n_devices` slots on `device`
    (logical slots on CUDA, so one card runs them as streams); returns the
    host-clock seconds of each lane.  Raises on any mismatch, on a host
    fallback lane, and when the multi-process simulation fails or outlasts
    `timeout_s`."""
    from .ops.decode2 import fallback_stats
    from .ops.device_encode import encode_device_batch, encode_fallback_stats
    from .parallel.mesh import (broadcast_dictionary,
                                broadcast_dictionary_chunks,
                                decode_batch_v3_multichip,
                                decode_batches_multichip,
                                encode_batches_multichip, get_mesh)
    from .utils.benchmarks import corpus

    dev = torch.device(device)
    mesh = get_mesh(n_devices, dev, logical=dev.type == "cuda")
    walls = {}
    fb0 = fallback_stats()["lanes_fallback"]
    enc0 = encode_fallback_stats()["lanes_fallback"]

    t0 = time.perf_counter()
    for d, t in broadcast_dictionary(mesh).items():
        if tuple(t.shape) != (122784,) or bytes(t[:4].tolist()) != b"time":
            raise RuntimeError(f"dictionary broadcast on {d} is wrong")

    data = corpus(DRY_BYTES)
    streams = encode_batches_multichip(data, mesh, chunk_size=DRY_CHUNK)
    if len(streams) != -(-len(data) // DRY_CHUNK):
        raise RuntimeError(f"{len(streams)} streams from the encode")
    got = decode_batches_multichip(streams, mesh)
    if b"".join(got) != data:
        raise RuntimeError("multi-device round trip differs from the input")
    walls["v2_s"] = time.perf_counter() - t0

    # full-format lane: context-mapped literals, decoded by the v3 kernel
    # from the dictionary staged once per device
    t0 = time.perf_counter()
    ff_data = data[: 4 * 512]
    ff_streams = encode_device_batch(ff_data, device=dev, chunk_size=512,
                                     lit_ctx_trees=4, table_groups=1)
    ff_got = decode_batch_v3_multichip(
        ff_streams, mesh, group_size=2,
        dict_bcast=broadcast_dictionary_chunks(mesh))
    if b"".join(ff_got) != ff_data:
        raise RuntimeError("full-format round trip differs from the input")
    walls["v3_s"] = time.perf_counter() - t0
    fell = (fallback_stats()["lanes_fallback"] - fb0,
            encode_fallback_stats()["lanes_fallback"] - enc0)
    if any(fell):
        raise RuntimeError(f"host fallback lanes (decode, encode): {fell}")

    # multi-process lane: two processes of two slots each
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", "brotli_tpu_torch.tools.multihost_sim",
           "--device", dev.type, "--streams", "64", "--chunk", "512",
           "--piece-streams", "16", "--group-size", "16",
           "--timeout", str(timeout_s)]
    r = subprocess.run(cmd, capture_output=True, timeout=timeout_s + 120,
                       cwd=Path(__file__).resolve().parents[1])
    lines = r.stdout.decode().strip().splitlines()
    if r.returncode != 0:
        raise RuntimeError(f"multihost_sim failed (rc {r.returncode}): "
                           f"{lines[-1:]} {r.stderr.decode()[-2000:]}")
    walls["multihost_s"] = time.perf_counter() - t0
    print(f"dryrun_multichip: {len(data)} B in {len(streams)} streams "
          f"encoded and decoded over {n_devices} slots on {dev.type}; "
          f"full-format lane OK; multihost: {lines[-1]}")
    return walls
