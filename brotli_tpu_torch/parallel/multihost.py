"""Multi-process (multi-host) scale-out of the batch codec over
torch.distributed.  Counterpart of brotli_tpu/parallel/multihost.py.

Two levels, as in the reference:

  * within a process: the mesh.py drivers run the kernels on the
    process's own device slots (get_local_mesh);
  * across processes: each process owns the pieces (encode) or groups
    (decode) `rank::world_size`, runs its own host preflight and device
    dispatch on them, and the results come back in order on every process
    through a zero-padded sum (_allgather_bytes): each process contributes
    the rows it owns and zeros elsewhere, and ownership is disjoint, so the
    sum is an ordered gather.

The collectives run on the gloo backend over TCP: the gathered rows are
host bytes (in the reference too), and NCCL refuses two ranks on one GPU,
which is how one card simulates several hosts
(tools/multihost_sim.py).
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Slot, decode_batches_multichip, encode_pieces, get_mesh

# the local slots of this process, set by init_multihost
_LOCAL: dict = {"slots": 4, "device": "cuda"}


def init_multihost(coordinator: str, process_id: int, num_processes: int,
                   local_devices: int = 4, device: torch.device | str = "cuda",
                   timeout_s: float = 600.0) -> None:
    """Join the process group at `coordinator` ("host:port", rank 0
    listens there) as rank `process_id` of `num_processes`, on gloo, with
    every collective bounded by `timeout_s`.  `local_devices` slots on
    `device` make this process's mesh (get_local_mesh)."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            rank=process_id, world_size=num_processes,
                            timeout=timedelta(seconds=timeout_s))
    _LOCAL.update(slots=local_devices, device=device)


def get_local_mesh() -> list[Slot]:
    """This process's slots: `local_devices` logical slots on its device."""
    return get_mesh(_LOCAL["slots"], _LOCAL["device"], logical=True)


def _barrier() -> None:
    """Wait for every process (under the group's timeout) before a
    collective, so one process's longer compute is absorbed here and the
    collective starts aligned."""
    dist.barrier()


def _allgather_bytes(rows: list[bytes | None], n_total: int) -> list[bytes]:
    """Ordered cross-process gather of per-index byte strings.

    Each process passes a list of `n_total` entries holding bytes for the
    indices it owns and None elsewhere; every process gets the merged
    list.  The lengths are all-gathered, then a zero-padded (n_total,
    max_len) uint8 buffer is summed over the processes: ownership is
    disjoint, so each byte has one contributor.  An index nobody owns
    comes back as b""."""
    if n_total == 0:
        return []
    _barrier()
    lens = torch.zeros(n_total, dtype=torch.int64)
    for i, r in enumerate(rows):
        if r is not None:
            lens[i] = len(r)
    all_lens = [torch.empty_like(lens) for _ in range(dist.get_world_size())]
    dist.all_gather(all_lens, lens)
    all_lens = torch.stack(all_lens)
    merged_lens = all_lens.sum(dim=0).tolist()
    buf = np.zeros((n_total, max(1, int(all_lens.max()))), np.uint8)
    for i, r in enumerate(rows):
        if r:
            buf[i, : len(r)] = np.frombuffer(r, np.uint8)
    summed = torch.from_numpy(buf)
    dist.all_reduce(summed, op=dist.ReduceOp.SUM)
    merged = summed.numpy()
    return [merged[i, : merged_lens[i]].tobytes() for i in range(n_total)]


def encode_multihost(data: bytes, *, chunk_size: int = 1024,
                     piece_streams: int | None = None,
                     backend: str = "device", **knobs) -> list[bytes]:
    """Encode `data` across the processes: pieces of `piece_streams`
    chunks (B_LANES by default) are owned `rank::world_size`; each process
    encodes its pieces, over its local slots (backend "device",
    mesh.encode_pieces with `knobs`) or with the host encoder
    (backend "host", encode_sharded per piece), and the streams come back
    in order on every process."""
    from ..encode.sharded import encode_sharded
    from ..ops.device_encode import B_LANES

    if backend not in ("device", "host"):
        raise ValueError(f"backend must be 'device' or 'host', not {backend!r}")
    rank, world = dist.get_rank(), dist.get_world_size()
    step = (piece_streams or B_LANES) * chunk_size
    pieces = [data[off: off + step] for off in range(0, len(data), step)]
    bases = np.concatenate([[0], np.cumsum([-(-len(p) // chunk_size)
                                            for p in pieces])]).astype(int)
    owned = list(range(rank, len(pieces), world))
    if backend == "host":
        outs = [encode_sharded(pieces[bi], chunk_size=chunk_size)
                for bi in owned]
    else:
        outs = encode_pieces([pieces[bi] for bi in owned], get_local_mesh(),
                             chunk_size=chunk_size, **knobs)
    results: list[bytes | None] = [None] * int(bases[-1])
    for bi, streams in zip(owned, outs):
        results[bases[bi]: bases[bi] + len(streams)] = streams
    return _allgather_bytes(results, int(bases[-1]))


def decode_multihost(streams: list[bytes], *,
                     group_size: int | None = None) -> list[bytes]:
    """Decode `streams` across the processes: groups of `group_size`
    (1024 by default) are owned `rank::world_size`; each process decodes
    its groups in one decode_batches_multichip call over its local slots
    (its groups, concatenated, split into the same groups), and the
    outputs come back in order on every process."""
    rank, world = dist.get_rank(), dist.get_world_size()
    gs = group_size or 1024
    owned = list(range(0, len(streams), gs))[rank::world]
    mine = [s for off in owned for s in streams[off: off + gs]]
    outs = decode_batches_multichip(mine, get_local_mesh(), group_size=gs)
    results: list[bytes | None] = [None] * len(streams)
    k = 0
    for off in owned:
        n = len(streams[off: off + gs])
        results[off: off + n] = outs[k: k + n]
        k += n
    return _allgather_bytes(results, len(streams))
