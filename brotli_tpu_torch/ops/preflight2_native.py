"""The v2 decode's host preflight and staging in C++, straight into the
port's layout.

native/preflight2.cpp does over threads what ops/decode2.stage_v2 and
batch_to_torch do in numpy: it parses each stream's header and tables
(every distinct header once), decides eligibility as `preflight` /
`preflight_many` do, bins the streams by their tables, lays the lanes out
as preflight_shared (one bin, rate-sorted) or preflight_binned (each bin
rate-sorted, first-seen order, at most GROUP_CAP groups), and writes the
batch into one buffer: each lane's words one lane after another, the
tables without the TPU's sublane replication (groups, k * 128), the
distance and length LUTs, each lane's start bit, decoded size and where
its words lie.  For a CUDA device the buffer is pinned and goes to the
card in one copy; there a gather spreads the lanes' words into the
kernel's word-major (Wpad, lanes) table, zero past each lane's words, and
the other tensors are views of the copy.  On the CPU the same happens in
place.  The streams are read where they lie (a pointer each), never
joined.

`stage_v2_native` returns None exactly where stage_v2 returns None, and
otherwise a batch equal to batch_to_torch(stage_v2(...)) field for field
(tests/test_torch_preflight2_native.py).  ops/preflight2.py stays as the
yardstick.  A library that fails to build or load raises: nothing falls
back to the Python preflight.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from ..constants import (
    BLOCK_LENGTH_N_BITS,
    BLOCK_LENGTH_OFFSET,
    CODE_LENGTH_CODE_LENGTHS,
    CODE_LENGTH_CODE_ORDER,
)
from ..device import resolve_device
from .decode2 import CONSTS_N, DX_N, GROUP_CAP, TorchBatch
from .preflight2 import NSTREAM, _build_consts

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_LIB: ctypes.CDLL | None = None

# threads of the plan and the fill: on the H100's 8-core host, 1-4 staged
# the v2 cell alike and 8 took 40% longer (tools/v2_host_profile.py)
N_THREADS = min(4, os.cpu_count() or 1)
TAB_N = 630 + 1080 + 920   # a bin's literal, command and distance tables
META_N = 10                # brotli_v2_plan's meta, in its order:
(M_GROUPS, M_BINS, M_WPAD, M_LIT_K, M_CMD_K, M_DIST_K, M_NPOSTFIX,
 M_NDIRECT, M_MAXBW, M_MAX_MLEN) = range(META_N)
ALIGN = 64                 # int32s: each field starts on 256 bytes

_CONSTS = np.ascontiguousarray(_build_consts()[0])
_FORMAT = [np.ascontiguousarray(np.asarray(x, np.int32))
           for x in (BLOCK_LENGTH_N_BITS, BLOCK_LENGTH_OFFSET,
                     CODE_LENGTH_CODE_ORDER, CODE_LENGTH_CODE_LENGTHS)]


def _lib() -> ctypes.CDLL:
    """native/preflight2.cpp, built into brotli_tpu_torch/build/ at first
    use (build._build, gated on a hash of it and of decoder.cpp, which it
    includes)."""
    global _LIB
    if _LIB is None:
        from ..build import _build

        path = _build(
            "brotli_tpu_torch_preflight2",
            ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread"],
            ["g++", "-shared", "-pthread"], [_NATIVE / "preflight2.cpp"],
            deps=[_NATIVE / "decoder.cpp"])
        lib = ctypes.CDLL(str(path))
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        plan = lib.brotli_v2_plan
        plan.restype = I64
        plan.argtypes = ([P, P, I64, I32, I32, I32] + [P] * 4
                         + [I32, I64] + [P] * 8)
        fill = lib.brotli_v2_fill
        fill.restype = None
        fill.argtypes = ([P] * 6 + [I64] + [P] * 2 + [I32] * 3
                         + [P] * 4 + [I32])
        _LIB = lib
    return _LIB


@dataclass
class StagedV2:
    """A v2 batch staged by stage_v2_native: the kernels' tensors, and
    what the unpack needs on the host (ops/decode2.collect_lanes_pinned),
    one entry a lane."""

    tb: TorchBatch
    perm: np.ndarray      # int64: the lane's stream, -1 for a pad lane
    n_words: np.ndarray   # int32: the lane's real words (lane_overran)
    mlens: np.ndarray     # int64: decoded size, 0 for a pad lane
    n_streams: int

    @property
    def groups(self) -> int:
        return self.tb.groups


@dataclass
class HostStaging:
    """The plan and the filled host buffer of one batch, before the copy
    to the device (`to_device`)."""

    buf: torch.Tensor     # int32, pinned for a CUDA device
    seg: list[int]        # each field's offset in buf (FIELDS' order)
    widths: list[int]     # and its length
    meta: np.ndarray      # brotli_v2_plan's meta
    perm: np.ndarray
    n_words: np.ndarray
    mlens: np.ndarray
    n_streams: int


# the fields of the host buffer, in brotli_v2_fill's order (its seg)
FIELDS = ("body", "lit", "cmd", "dist", "dx", "consts", "start_bit", "mlen",
          "lane_at", "lane_words")


def _p(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


def stage_host(streams: list[bytes], groups: int | None = None,
               binned: bool = True, pin: bool = False) -> HostStaging | None:
    """Plan and fill one batch on the host (brotli_v2_plan, then
    brotli_v2_fill into a buffer pinned when `pin`); None where stage_v2
    returns None.  `groups` is preflight_shared's (default: the streams'
    groups, at most GROUP_CAP); `binned=False` leaves preflight_binned
    out, so a batch of several table sets is None."""
    if not streams:
        return None
    n = len(streams)
    if groups is None:
        groups = min(GROUP_CAP, -(-n // NSTREAM))
    streams = [s if type(s) is bytes else bytes(s) for s in streams]
    data = (ctypes.c_char_p * n)(*streams)
    lens = np.fromiter(map(len, streams), np.int64, n)
    room = max(groups, GROUP_CAP if binned else 0, 1)
    meta = np.zeros(META_N, np.int64)
    perm, bit, mlens = (np.empty(room * NSTREAM, np.int64) for _ in range(3))
    n_words = np.empty(room * NSTREAM, np.int32)
    group_bin = np.empty(room, np.int32)
    bin_tab = np.empty((room, TAB_N), np.int32)
    dx = np.empty(DX_N, np.int32)
    lib = _lib()
    G = lib.brotli_v2_plan(
        data, _p(lens), n, groups, GROUP_CAP, int(binned),
        *map(_p, _FORMAT), N_THREADS, room, _p(meta), _p(perm), _p(bit),
        _p(mlens), _p(n_words), _p(group_bin), _p(bin_tab), _p(dx))
    if G == 0:
        return None
    if G < 0:
        raise RuntimeError("brotli_v2_plan: the batch outgrew its outputs")
    n_slots = G * NSTREAM
    perm, bit, mlens, n_words = (a[:n_slots]
                                 for a in (perm, bit, mlens, n_words))
    # each lane's words: from its command start word to its stream's end
    lane_at = np.zeros(n_slots + 1, np.int64)
    np.cumsum(np.maximum(n_words - 3, 0), out=lane_at[1:])
    if lane_at[-1] >= 1 << 31:
        raise ValueError("the batch's words outgrow int32 offsets")
    widths = [max(1, int(lane_at[-1])),
              *(G * int(meta[k]) * 128 for k in (M_LIT_K, M_CMD_K, M_DIST_K)),
              DX_N, CONSTS_N, n_slots, n_slots, n_slots, n_slots]
    seg, end = [], 0
    for w in widths:
        seg.append(end)
        end += -(-w // ALIGN) * ALIGN
    buf = torch.empty(end, dtype=torch.int32, pin_memory=pin)
    seg_a = np.asarray(seg, np.int64)
    lib.brotli_v2_fill(
        data, _p(lens), _p(perm), _p(bit), _p(mlens), _p(lane_at), n_slots,
        _p(group_bin), _p(bin_tab), int(meta[M_LIT_K]), int(meta[M_CMD_K]),
        int(meta[M_DIST_K]), _p(dx), _p(_CONSTS), buf.data_ptr(), _p(seg_a),
        N_THREADS)
    return HostStaging(buf=buf, seg=seg, widths=widths, meta=meta, perm=perm,
                       n_words=n_words, mlens=mlens, n_streams=n)


def to_device(hs: HostStaging, device: torch.device) -> StagedV2:
    """One copy of the host buffer to `device` (asynchronous from pinned
    memory, on the current stream); a gather spreads the lanes' words into
    the word-major (Wpad, lanes) table, zero past each lane's words; the
    other tensors are views of the copy."""
    m = hs.meta
    G, wpad = int(m[M_GROUPS]), int(m[M_WPAD])
    buf = hs.buf.to(device, non_blocking=True)
    f = {name: buf[o: o + w] for name, o, w in zip(FIELDS, hs.seg, hs.widths)}
    row = torch.arange(wpad, device=buf.device).unsqueeze(1)
    at = f["lane_at"].long().unsqueeze(0)
    src = (at + row).clamp_(max=f["body"].numel() - 1)
    wt = torch.where(row < f["lane_words"].unsqueeze(0), f["body"][src], 0)
    max_mlen = int(m[M_MAX_MLEN])
    tb = TorchBatch(
        wt=wt, lit=f["lit"].view(G, -1), cmd=f["cmd"].view(G, -1),
        dist=f["dist"].view(G, -1), dx=f["dx"], consts=f["consts"],
        start_bit=f["start_bit"], mlen=f["mlen"], groups=G,
        lit_k=int(m[M_LIT_K]), cmd_k=int(m[M_CMD_K]), dist_k=int(m[M_DIST_K]),
        npostfix=int(m[M_NPOSTFIX]), ndirect=int(m[M_NDIRECT]),
        maxbw=int(m[M_MAXBW]), max_mlen=max_mlen,
        # every token emits >= 1 byte and a tag-1/tag-2 pair >= 2, so an
        # honest lane never needs more than mlen slots (batch_to_torch)
        cap=max_mlen + 4)
    return StagedV2(tb=tb, perm=hs.perm, n_words=hs.n_words, mlens=hs.mlens,
                    n_streams=hs.n_streams)


def stage_v2_native(streams: list[bytes], device: torch.device | str,
                    groups: int | None = None,
                    binned: bool = True) -> StagedV2 | None:
    """stage_v2 + batch_to_torch in one native plan and fill, one copy and
    one gather: the batch on `device`, or None where stage_v2 returns None
    (`binned=False`: where preflight_shared does)."""
    dev = resolve_device(device)
    hs = stage_host(streams, groups, binned, pin=dev.type == "cuda")
    return None if hs is None else to_device(hs, dev)
