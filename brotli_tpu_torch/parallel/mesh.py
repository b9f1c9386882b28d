"""Device slots and data-parallel batch encode and decode over them.
Counterpart of brotli_tpu/parallel/mesh.py.

The batch codec is data parallel over streams: groups of streams (decode)
or pieces of input (encode) go round-robin over an ordered list of device
slots, each slot runs the same kernels the one-device drivers run, and the
results come back in order by group index.  No collective is needed.

A slot is a device and, on CUDA, a stream of its own.  `get_mesh(n)` gives
one slot per visible GPU; `get_mesh(n, logical=True)` gives n slots
round-robin over the visible GPUs, each with its own stream, so one card
runs n slots as n streams.  Every kernel wrapper of the port launches on
the current stream of its tensors' device, so work queued inside a slot's
`with slot.active():` block runs on that slot's stream.  CPU slots have no
stream, and their work runs in turn.

Dispatch runs in phases, as in the reference: every slot's first kernels
are queued before the host waits on any of them, so the host's work for
one slot (preflight, tables, unpacking) overlaps the device's work for
the others.  A host read of a CUDA tensor waits for the slot's stream
only, since it runs inside that slot's block.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device


@dataclass(frozen=True)
class Slot:
    """One device slot: a device and, on CUDA, the stream its work runs on."""

    device: torch.device
    stream: torch.cuda.Stream | None = None

    @contextlib.contextmanager
    def active(self):
        """Queue the enclosed work on this slot's device and stream."""
        if self.stream is None:
            yield
            return
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            yield


def get_mesh(n_devices: int | None = None,
             device: torch.device | str = "cuda", *,
             logical: bool = False) -> list[Slot]:
    """An ordered list of device slots.

    On "cuda" the slots are the first `n_devices` visible GPUs (all of them
    by default), one slot and one stream each; asking for more GPUs than
    are visible raises.  With `logical`, the `n_devices` slots go
    round-robin over the visible GPUs ("cuda:i" keeps them on GPU i), each
    with a stream of its own.  On "cpu" the slots are `n_devices` (default
    1) CPU slots without streams.  Raises on "cuda" without a card."""
    dev = resolve_device(device)
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    if dev.type == "cpu":
        return [Slot(dev) for _ in range(n_devices or 1)]
    gpus = ([dev.index] if dev.index is not None
            else list(range(torch.cuda.device_count())))
    n = n_devices or len(gpus)
    if not logical and n > len(gpus):
        raise RuntimeError(f"{n} CUDA devices requested, {len(gpus)} visible; "
                           "pass logical=True to run several slots a GPU")
    slots = []
    for i in range(n):
        d = torch.device("cuda", gpus[i % len(gpus)])
        slots.append(Slot(d, torch.cuda.Stream(device=d)))
    return slots


@contextlib.contextmanager
def _dispatch(mesh: list[Slot]):
    """Order the slots' streams after the work their callers queued before
    (staged inputs, a staged dictionary), and the callers' streams after
    the slots' work on leaving, so tensors freed afterwards on the callers'
    streams are not reused while a slot still reads them."""
    for s in mesh:
        if s.stream is not None:
            s.stream.wait_stream(torch.cuda.current_stream(s.device))
    try:
        yield
    finally:
        for s in mesh:
            if s.stream is not None:
                torch.cuda.current_stream(s.device).wait_stream(s.stream)


def _per_device(mesh: list[Slot], stage) -> dict[torch.device, torch.Tensor]:
    """stage(device) once for each distinct device of the mesh."""
    out: dict[torch.device, torch.Tensor] = {}
    for s in mesh:
        if s.device not in out:
            out[s.device] = stage(s.device)
    return out


def broadcast_dictionary(mesh: list[Slot] | None = None
                         ) -> dict[torch.device, torch.Tensor]:
    """The 122,784-byte static dictionary as a uint8 tensor on each device
    of the mesh, staged once per device (slots of one card share it):
    the counterpart of the reference's replicated array's shards."""
    from ..decode.dictionary import get_dictionary

    if mesh is None:
        mesh = get_mesh()
    data = np.frombuffer(get_dictionary(), dtype=np.uint8)
    return _per_device(mesh, lambda d: torch.from_numpy(data.copy()).to(d))


def broadcast_dictionary_chunks(mesh: list[Slot] | None = None
                                ) -> dict[torch.device, torch.Tensor]:
    """The static dictionary in the v3 kernel's layout on each device of
    the mesh (ops/decode3.stage_dictionary, once per device): what
    decode_batch_v3_multichip passes to the v3 driver as `dict_dev`."""
    from ..ops.decode3 import stage_dictionary

    if mesh is None:
        mesh = get_mesh()
    return _per_device(mesh, stage_dictionary)


def decode_batches_multichip(streams: list[bytes],
                             mesh: list[Slot] | None = None, *,
                             group_size: int | None = None) -> list[bytes]:
    """Decode shared-table streams over the mesh's slots.

    Groups of min(group_size, 1024) streams go round-robin over the slots,
    each group staged in preflight_shared's layout (rate-sorted) by
    ops/preflight2_native.stage_v2_native as one batch of the entropy and
    resolve kernels.  Dispatch is in three phases: every group's staging
    and entropy kernel on its slot's stream; every resolve kernel behind it
    on the same stream (the token counts stay on the device, so no host
    read sits between the two); then the ordered fetch and unpack
    (collect_lanes_pinned), with lanes the kernels flag re-decoded on the
    host and counted in ops/decode2.fallback_stats().  A group of several
    table sets goes through decode_batch_pallas2 on the first slot, after
    the other groups are queued."""
    from ..ops import decode2 as D
    from ..ops import preflight2_native as N
    from ..ops.resolve import resolve_tokens

    if mesh is None:
        mesh = get_mesh()
    gs = min(group_size or D.NSTREAM, D.NSTREAM)
    groups = [streams[i: i + gs] for i in range(0, len(streams), gs)]
    results: list[bytes | None] = [None] * len(streams)
    pending, refused = [], []
    with _dispatch(mesh):
        # phase 1: host preflight, staging and the entropy kernel per group
        for gi, group in enumerate(groups):
            slot = mesh[len(pending) % len(mesh)]
            with slot.active():
                staged = N.stage_v2_native(group, slot.device, groups=1,
                                           binned=False)
                if staged is None:
                    refused.append(gi)
                    continue
                tok, count, phase, widx = D.entropy_decode(staged.tb)
            pending.append([gi, staged, slot, tok, count, phase, widx])
        # phase 2: the resolve kernels, each behind its group's entropy;
        # (resolved, err) take the place of (tok, count)
        for p in pending:
            _, staged, slot, tok, count = p[:5]
            with slot.active():
                p[3:5] = resolve_tokens(tok, count, staged.tb.mlen,
                                        staged.tb.max_mlen)
        for gi in refused:
            with mesh[0].active():
                results[gi * gs: gi * gs + len(groups[gi])] = \
                    D.decode_batch_pallas2(groups[gi], device=mesh[0].device)
        # phase 3: ordered fetch, unpack and per-lane host fallback
        for gi, staged, slot, resolved, err, phase, widx in pending:
            with slot.active():
                results[gi * gs: gi * gs + len(groups[gi])] = \
                    D.collect_lanes_pinned(staged, groups[gi], resolved, err,
                                           phase, widx)
    return results  # type: ignore[return-value]


def encode_pieces(pieces: list[bytes], mesh: list[Slot], *,
                  chunk_size: int = 32768, hash_stride: int = 1,
                  max_distance: int | None = None, chain_depth: int = 2,
                  table_groups: int = 1, lit_ctx_trees: int = 1,
                  hist_stride: int | None = None) -> list[list[bytes]]:
    """Encode each piece (at most B_LANES chunks) as one device batch, the
    pieces round-robin over the mesh's slots; each piece's streams, in
    order.  Three phases: stages 1-4 of every piece queued on its slot's
    stream; per piece, the host tables (which wait for that piece's sample
    only) and the pack kernel; then the ordered fetch and assembly."""
    from ..ops import device_encode as E

    if hist_stride is None:
        hist_stride = E._HIST_STRIDE_DEFAULT
    states = []
    with _dispatch(mesh):
        for bi, piece in enumerate(pieces):
            slot = mesh[bi % len(mesh)]
            with slot.active():
                states.append((slot, E._encode_start(
                    piece, slot.device, chunk_size, hash_stride, 256,
                    max_distance, chain_depth, lit_ctx=lit_ctx_trees > 1,
                    hist_stride=hist_stride)))
        for slot, state in states:
            with slot.active():
                E._encode_mid(state, 22, table_groups, lit_ctx_trees)
        out = []
        for slot, state in states:
            with slot.active():
                out.append(E._encode_finish(state))
    return out


def encode_batches_multichip(data: bytes, mesh: list[Slot] | None = None, *,
                             chunk_size: int = 32768, hash_stride: int = 1,
                             max_distance: int | None = None,
                             chain_depth: int = 2, table_groups: int = 1,
                             lit_ctx_trees: int = 1,
                             hist_stride: int | None = None) -> list[bytes]:
    """Encode `data` over the mesh's slots, one batch of B_LANES chunks a
    piece, pieces round-robin over the slots (encode_pieces).  The knobs
    are encode_device_batch's, passed through verbatim, so each piece's
    streams are byte-identical to encode_device_batch of that piece on
    one device."""
    from ..encode.api import _encode_empty
    from ..ops.device_encode import B_LANES

    if mesh is None:
        mesh = get_mesh()
    data = bytes(data)
    if not data:
        return [_encode_empty()]
    step = B_LANES * chunk_size
    pieces = [data[off: off + step] for off in range(0, len(data), step)]
    out = encode_pieces(pieces, mesh, chunk_size=chunk_size,
                        hash_stride=hash_stride, max_distance=max_distance,
                        chain_depth=chain_depth, table_groups=table_groups,
                        lit_ctx_trees=lit_ctx_trees, hist_stride=hist_stride)
    return [s for piece in out for s in piece]


def decode_batch_v3_multichip(streams: list[bytes],
                              mesh: list[Slot] | None = None, *,
                              group_size: int = 1024, custom_dictionary=None,
                              dict_bcast=None) -> list[bytes]:
    """Full-format decode over the mesh's slots: groups of `group_size`
    streams round-robin over the slots, each through
    ops/decode3.decode_batch_v3_full on its slot's stream, reading the
    static dictionary staged on its device (`dict_bcast`, from
    broadcast_dictionary_chunks; staged here once when None).  The v3
    driver reads its status rows on the host after every round and
    returns only when its group is decoded, so the groups run in turn:
    the slots spread the work over the devices but do not overlap it."""
    from ..ops.decode3 import decode_batch_v3_full

    if mesh is None:
        mesh = get_mesh()
    if dict_bcast is None:
        dict_bcast = broadcast_dictionary_chunks(mesh)
    results: list[bytes] = []
    with _dispatch(mesh):
        for gi, off in enumerate(range(0, len(streams), group_size)):
            slot = mesh[gi % len(mesh)]
            with slot.active():
                results.extend(decode_batch_v3_full(
                    streams[off: off + group_size], device=slot.device,
                    custom_dictionary=custom_dictionary,
                    dict_dev=dict_bcast[slot.device]))
    return results
