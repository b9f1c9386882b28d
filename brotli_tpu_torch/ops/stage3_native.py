"""The v3 decode's host staging in C++, straight into the port's layout.

native/preflight3.cpp's `brotli_v3_plan` parses and bins a batch's units
as `brotli_v3_preflight_batch` does (ops/preflight3_native.py): the same
unit statuses, tables and first-seen bins.  A thread remembers the table
sections it parsed last, and a unit whose section (the bits from its
tables' first bit to its first command) equals one of them takes that
parse; the bins then cost one lookup a unit.  The plan lays the lanes out
as assemble_v3 does (each bin stably sorted on mlen / (4 * padded words)),
in groups of `width` lanes: 1024 for the yardstick's layout, 128
(decode3.cu's DECODE3_BLOCK) by default, so that a batch of few streams a
table set takes few lanes.  `brotli_v3_fill` then writes the batch into
one buffer: each lane's words one lane after another, each group's tables
without the TPU's sublane replication at its config row's offsets, the
config rows, the per-lane scalars lane-major; the group-independent
tables (constants, context LUT, transforms, dictionary, compound
dictionary) are copied in here.  For a CUDA device the buffer is pinned
and goes to the card in one copy; there a gather spreads the words into
the kernel's word-major (Wpad, lanes) table, zero past each lane's words,
and the other tensors are views of the copy.  On the CPU the same happens
in place.  The streams are read where they lie (a pointer each), never
joined.

`stage_v3_native` at width 1024 returns None exactly where
preflight_v3_native does, and otherwise a batch equal to
batch_to_torch_v3(preflight_v3_native(...)) field for field
(tests/test_torch_stage3_native.py).  The multi-metablock driver stages
each round with `stage_units_v3_native`; each stream's output so far lives
on the device (`DeviceHistory`), and the round's history prefixes and the
last two bytes before each unit are gathered from it there.

A library that fails to build or load raises: nothing falls back to the
numpy staging.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from . import preflight3_native as N3
from .decode3 import (
    BSW_N,
    DX_N,
    GROUP_CAP_V3,
    NCFG,
    V3TorchBatch,
    _check_dict_dev,
    _shared_tables,
)
from .preflight3 import NSTREAM, SCAL_ROWS, _compound_flat

_LIB: ctypes.CDLL | None = None

# threads of the plan, the fill and the walk: on the H100's 8-core host,
# a thread's start costs more than most units' work, and 8 threads staged
# the v3 cell slower than 4 (tools/v3_host_profile.py)
N_THREADS = min(4, os.cpu_count() or 1)
_HASH_MASK = (1 << 64) - 1   # and-ed into each table key's hash
WIDTH = 128                  # lanes a group: decode3.cu's DECODE3_BLOCK
D = 64                       # Wpad = round_up(most words, D) + D
ALIGN = 64                   # int32s: each field starts on 256 bytes

META_N = 12                  # brotli_v3_plan's meta, in its order:
(M_STATUS, M_BINS, M_GROUPS, M_SLOTS, M_WPAD, M_BODY, M_LIT, M_CMD, M_DIST,
 M_CMAP, M_MAX_MLEN, M_PARSES) = range(META_N)
STAGED, NONE, OVER = range(3)
# the fields of the host buffer: brotli_v3_fill's (its seg), then the
# group-independent tables
FIELDS = ("body", "lit", "cmd", "dist", "bsw", "cmap", "dx", "cfg", "scal",
          "lane_at", "lane_words", "consts", "lut", "tfm", "tfs", "dict",
          "cdict")
_NATIVE_FIELDS = 11


def _lib() -> ctypes.CDLL:
    """native/preflight3.cpp's library (built by ops/preflight3_native.py)
    with the staging entries declared."""
    global _LIB
    if _LIB is None:
        lib = N3._lib()
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        plan = lib.brotli_v3_plan
        plan.restype = P
        plan.argtypes = ([P] * 6 + [I64, I32] + [P] * 5
                         + [I32, ctypes.c_uint64, I64, I64, I64, P, P])
        fill = lib.brotli_v3_fill
        fill.restype = None
        fill.argtypes = [P] * 11 + [I32]
        lib.brotli_v3_free.restype = None
        lib.brotli_v3_free.argtypes = [P]
        walk = lib.brotli_v3_walk_ptrs
        walk.restype = None
        walk.argtypes = [P] * 4 + [I64, I32] + [P] * 3
        _LIB = lib
    return _LIB


def _p(a: np.ndarray) -> ctypes.c_void_p:
    return a.ctypes.data_as(ctypes.c_void_p)


class StreamPtrs:
    """A batch's streams where they lie: a pointer and a length each."""

    def __init__(self, streams: list[bytes]):
        self.streams = [s if type(s) is bytes else bytes(s) for s in streams]
        n = len(self.streams)
        self.ptrs = (ctypes.c_char_p * n)(*self.streams)
        self.lens = np.fromiter(map(len, self.streams), np.int64, n)

    def __len__(self) -> int:
        return len(self.streams)


@dataclass
class HostStagingV3:
    """One batch planned and filled on the host, before the copy to the
    device (`to_device`)."""

    buf: torch.Tensor        # int32, pinned for a CUDA device
    seg: list[int]           # each field's offset in buf (FIELDS' order)
    widths: list[int]        # and its length
    meta: np.ndarray         # brotli_v3_plan's meta
    units: np.ndarray        # (n_units, 8) brotli_v3_preflight_batch's rows
    slot_unit: np.ndarray    # int64: the lane's unit, -1 for a pad lane
    n_words: np.ndarray      # int32: its words from its first command's
    mlens: np.ndarray        # int64
    w0: np.ndarray           # int64: its first command's word
    cfg: np.ndarray          # (G, NCFG) int32
    width: int
    cd_t: int


@dataclass
class StagedV3:
    """A v3 batch staged by this module: the kernel's tensors, and what
    the unpack needs on the host, one entry a lane."""

    tb: V3TorchBatch
    perm: np.ndarray         # int64: the lane's stream, -1 for a pad lane
    n_words: np.ndarray      # int32: the lane's words (the WIDX guard)
    mlens: np.ndarray        # int64: its decoded size, 0 for a pad lane
    w0: np.ndarray           # int64: its first command's word
    n_streams: int
    parses: int              # table sections the plan parsed

    @property
    def groups(self) -> int:
        return self.tb.groups


def _plan(src: StreamPtrs, us: np.ndarray, unit_bit, unit_maxbw, unit_mlen,
          full: bool, max_groups: int, width: int):
    """brotli_v3_plan: (the plan, or None; its meta; the units' rows).  A
    plan that is not None must go to brotli_v3_free."""
    n = us.shape[0]
    if n and (us.min() < 0 or us.max() >= len(src)):
        raise ValueError("a unit names no stream of the batch")
    zeros = np.zeros(n, np.int64)

    def col(a):
        return np.ascontiguousarray(zeros if a is None else a, np.int64)

    ub, um, ul = col(unit_bit), col(unit_maxbw), col(unit_mlen)
    if n and ub.min() < 0:
        raise ValueError("a unit starts at a negative bit")
    caps = N3._i32(N3.FULL_CAPS if full else N3.SINGLE_CAPS)
    F = N3._FORMAT
    meta = np.zeros(META_N, np.int64)
    units = np.zeros((n, N3.UNIT_COLS), np.int64)
    plan = _lib().brotli_v3_plan(
        src.ptrs, _p(src.lens), _p(us), _p(ub), _p(um), _p(ul), n, int(full),
        _p(caps), _p(F["blen_nbits"]), _p(F["blen_offset"]),
        _p(F["clc_order"]), _p(F["clc_lengths"]), N_THREADS, _HASH_MASK,
        width, max_groups * NSTREAM, D, _p(meta), _p(units))
    if not plan and meta[M_STATUS] == STAGED:
        raise RuntimeError("brotli_v3_plan failed")
    return plan, meta, units


def plan_and_fill(src: StreamPtrs, unit_stream, unit_bit=None,
                  unit_maxbw=None, unit_mlen=None, extras=None, *,
                  full: bool = False, max_groups: int = GROUP_CAP_V3,
                  width: int | None = None, pin: bool = False,
                  custom_dictionary=None,
                  with_dict: bool = True) -> HostStagingV3 | None:
    """One plan and one fill, in groups of `width` lanes (default WIDTH):
    None where the plan binned no unit, refused a whole-stream unit, or
    needs more lanes than `max_groups` groups of 1024 hold.
    `with_dict=False` leaves the static dictionary out (the caller has it
    on the device)."""
    width = WIDTH if width is None else width
    us = np.ascontiguousarray(unit_stream, np.int64)
    n = us.shape[0]
    plan, meta, units = _plan(src, us, unit_bit, unit_maxbw, unit_mlen, full,
                              max_groups, width)
    if not plan:
        return None
    lib = _lib()
    try:
        G, n_slots = int(meta[M_GROUPS]), int(meta[M_SLOTS])
        sh = _shared_tables()
        cd_raw = _compound_flat(custom_dictionary)
        cd_n = max(1, -(-len(cd_raw) // 512)) * 512
        widths = [max(1, int(meta[M_BODY])), int(meta[M_LIT]),
                  int(meta[M_CMD]), int(meta[M_DIST]), G * BSW_N,
                  int(meta[M_CMAP]), G * DX_N, G * NCFG, SCAL_ROWS * n_slots,
                  n_slots, n_slots, sh["consts"].size, sh["lut"].size,
                  sh["tfm"].size, sh["tfs"].size // 4,
                  sh["dict"].size // 4 if with_dict else 0, cd_n // 4]
        seg, end = [], 0
        for w in widths:
            seg.append(end)
            end += -(-w // ALIGN) * ALIGN
        buf = torch.empty(end, dtype=torch.int32, pin_memory=pin)
        seg_a = np.asarray(seg[:_NATIVE_FIELDS], np.int64)
        slot_unit = np.empty(n_slots, np.int64)
        n_words = np.empty(n_slots, np.int32)
        mlens = np.empty(n_slots, np.int64)
        w0 = np.empty(n_slots, np.int64)
        ex = None if extras is None else np.ascontiguousarray(extras, np.int64)
        if ex is not None and ex.shape != (7, n):
            raise ValueError(f"extras: want (7, {n}), got {ex.shape}")
        lib.brotli_v3_fill(plan, src.ptrs, _p(src.lens), _p(us),
                           None if ex is None else _p(ex), buf.data_ptr(),
                           _p(seg_a), _p(slot_unit), _p(n_words), _p(mlens),
                           _p(w0), N_THREADS)
    finally:
        lib.brotli_v3_free(plan)
    host = buf.numpy()
    for name, arr in (("consts", sh["consts"]), ("lut", sh["lut"]),
                      ("tfm", sh["tfm"]), ("tfs", sh["tfs"].view(np.int32)),
                      *((("dict", sh["dict"].view(np.int32)),)
                        if with_dict else ())):
        k = FIELDS.index(name)
        host[seg[k]: seg[k] + widths[k]] = arr
    k = FIELDS.index("cdict")
    cd = host[seg[k]: seg[k] + widths[k]].view(np.uint8)
    cd[:] = 0
    cd[: len(cd_raw)] = np.frombuffer(cd_raw, np.uint8)
    k = FIELDS.index("cfg")
    cfg = host[seg[k]: seg[k] + widths[k]].reshape(G, NCFG).copy()
    return HostStagingV3(buf=buf, seg=seg, widths=widths, meta=meta,
                         units=units, slot_unit=slot_unit, n_words=n_words,
                         mlens=mlens, w0=w0, cfg=cfg, width=width,
                         cd_t=len(cd_raw))


def stage_host(streams: list[bytes], *, max_groups: int = GROUP_CAP_V3,
               width: int | None = None, pin: bool = False,
               custom_dictionary=None,
               with_dict: bool = True) -> HostStagingV3 | None:
    """plan_and_fill of single-metablock streams, one unit a stream."""
    if not streams:
        return None
    src = StreamPtrs(streams)
    return plan_and_fill(src, np.arange(len(src), dtype=np.int64),
                         max_groups=max_groups, width=width, pin=pin,
                         custom_dictionary=custom_dictionary,
                         with_dict=with_dict)


def to_device(hs: HostStagingV3, device: torch.device, dict_dev=None,
              unit_stream=None) -> StagedV3:
    """One copy of the host buffer to `device` (asynchronous from pinned
    memory, on the current stream); a gather spreads the lanes' words into
    the word-major (Wpad, lanes) table, zero past each lane's words; the
    other tensors are views of the copy.  unit_stream: each unit's stream
    (default: unit u is stream u)."""
    m = hs.meta
    G, wpad, n = int(m[M_GROUPS]), int(m[M_WPAD]), int(m[M_SLOTS])
    buf = hs.buf.to(device, non_blocking=True)
    f = {name: buf[o: o + w] for name, o, w in zip(FIELDS, hs.seg, hs.widths)}
    row = torch.arange(wpad, device=buf.device).unsqueeze(1)
    at = f["lane_at"].long().unsqueeze(0)
    src = (at + row).clamp_(max=f["body"].numel() - 1)
    wt = torch.where(row < f["lane_words"].unsqueeze(0), f["body"][src], 0)
    max_mlen = int(m[M_MAX_MLEN])
    tb = V3TorchBatch(
        wt=wt, lit=f["lit"], cmd=f["cmd"], dist=f["dist"], bsw=f["bsw"],
        cmap=f["cmap"], dx=f["dx"], consts=f["consts"], lut=f["lut"],
        tfm=f["tfm"],
        dict=f["dict"].view(torch.uint8) if dict_dev is None else dict_dev,
        tfs=f["tfs"].view(torch.uint8), cdict=f["cdict"].view(torch.uint8),
        cfg=f["cfg"].view(G, NCFG), scal=f["scal"].view(SCAL_ROWS, n),
        hist=None, cfg_host=hs.cfg, groups=G,
        out_cap=max(16, -(-max_mlen // 16) * 16), max_mlen=max_mlen,
        cd_t=hs.cd_t, width=hs.width)
    live = hs.slot_unit >= 0
    units = hs.slot_unit if unit_stream is None else np.where(
        live, np.asarray(unit_stream, np.int64)[np.maximum(hs.slot_unit, 0)],
        -1)
    return StagedV3(tb=tb, perm=units, n_words=hs.n_words, mlens=hs.mlens,
                    w0=hs.w0, n_streams=int(live.sum()),
                    parses=int(m[M_PARSES]))


def stage_v3_native(streams: list[bytes], device: torch.device | str,
                    max_groups: int = GROUP_CAP_V3,
                    width: int | None = None, custom_dictionary=None,
                    dict_dev=None) -> StagedV3 | None:
    """preflight_v3_native + batch_to_torch_v3 in one native plan and
    fill, one copy and one gather: the batch on `device` in groups of
    `width` lanes, or None where the plan refuses it.  `dict_dev`: the
    static dictionary already on `device` (stage_dictionary), left out of
    the copy."""
    dev = resolve_device(device)
    if dict_dev is not None:
        _check_dict_dev(dict_dev, dev)
    hs = stage_host(streams, max_groups=max_groups, width=width,
                    pin=dev.type == "cuda",
                    custom_dictionary=custom_dictionary,
                    with_dict=dict_dev is None)
    return None if hs is None else to_device(hs, dev, dict_dev)


# ---------------------------------------------------------------------------
# the multi-metablock path
# ---------------------------------------------------------------------------

@dataclass
class WalkedPtrs:
    """One header walk (ops/preflight3_native.Walked's fields): units (n,
    6) int64, and the bytes of uncompressed metablocks copied on the way,
    unit u's at copied[copy_off[u]:]."""

    units: np.ndarray
    copied: np.ndarray        # uint8
    copy_off: np.ndarray


def walk_ptrs(src: StreamPtrs, unit_stream, unit_bit) -> WalkedPtrs:
    """walk_units over the streams where they lie: unit u walks stream
    unit_stream[u] from bit unit_bit[u] (0 = its first bit) to its next
    compressed metablock, in one call of native/preflight3.cpp over
    N_THREADS threads."""
    us = np.ascontiguousarray(unit_stream, np.int64)
    ub = np.ascontiguousarray(unit_bit, np.int64)
    n = us.shape[0]
    units = np.zeros((n, N3.WALK_COLS), np.int64)
    copy_off = np.zeros(n + 1, np.int64)
    np.cumsum(src.lens[us], out=copy_off[1:])
    # room for every unit's bytes; the pages no walk writes stay unmapped
    copied = np.empty(max(1, int(copy_off[-1])), np.uint8)
    _lib().brotli_v3_walk_ptrs(src.ptrs, _p(src.lens), _p(us), _p(ub), n,
                               N_THREADS, _p(units), _p(copied),
                               _p(copy_off))
    return WalkedPtrs(units, copied, copy_off)


class DeviceHistory:
    """Each stream's output so far, in one device buffer: stream i's bytes
    [0, lens[i]) at row i (`cap` bytes a row), after a front margin of
    zeros that a history prefix may reach into."""

    def __init__(self, n: int, device: torch.device):
        self.n, self.device = n, device
        self.lens = np.zeros(n, np.int64)
        self.cap = self.margin = 0
        self.buf = torch.zeros(1, dtype=torch.uint8, device=device)

    def _rows(self) -> torch.Tensor:
        return self.buf[self.margin:].view(self.n, self.cap)

    def reserve(self, need: int) -> None:
        """Room for `need` bytes in every row (a larger buffer, the rows
        copied over, when there is less)."""
        if need <= self.cap:
            return
        cap = max(need, 2 * self.cap, 4096)
        # a prefix is at most the longest output + 35 bytes long
        margin = cap + 64
        buf = torch.zeros(margin + self.n * cap, dtype=torch.uint8,
                          device=self.device)
        if self.cap:
            buf[margin:].view(self.n, cap)[:, : self.cap] = self._rows()
        self.buf, self.cap, self.margin = buf, cap, margin

    def append(self, idx: np.ndarray, rows: torch.Tensor,
               lengths: np.ndarray) -> None:
        """Stream idx[r] gains the first lengths[r] bytes of rows[r] (rows:
        (k, w) uint8 on the device; each row is written whole past the
        stream's end, and only lengths[r] bytes count)."""
        if not idx.size:
            return
        k, w = rows.shape
        self.reserve(int(self.lens[idx].max()) + w)
        start = self.margin + idx * self.cap + self.lens[idx]
        dst = (torch.from_numpy(start).to(self.device).unsqueeze(1)
               + torch.arange(w, device=self.device))
        self.buf.index_put_((dst.reshape(-1),), rows.reshape(-1))
        self.lens[idx] += lengths

    def append_copies(self, idx: np.ndarray, walked: WalkedPtrs,
                      which: np.ndarray) -> None:
        """The bytes the walk copied for its units `which` (uncompressed
        metablocks), gathered into one pinned buffer and uploaded once,
        appended to streams idx."""
        if not which.size:
            return
        lengths = walked.units[which, 5]
        at = np.zeros(which.size + 1, np.int64)
        np.cumsum(lengths, out=at[1:])
        w = int(lengths.max())
        host = torch.zeros(int(at[-1]) + w, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")
        h = host.numpy()
        for u, a, n in zip(which.tolist(), at.tolist(), lengths.tolist()):
            o = int(walked.copy_off[u])
            h[a: a + n] = walked.copied[o: o + n]
        flat = host.to(self.device, non_blocking=True)
        off = torch.from_numpy(at[:-1]).to(self.device)
        self.append(idx, flat.unfold(0, w, 1)[off], lengths)

    def prefix(self, idx: np.ndarray, hrb: int) -> torch.Tensor:
        """(len(idx), hrb) uint8: each stream's last hrb bytes,
        right-aligned, zeros before them (idx -1: all zeros)."""
        live = idx >= 0
        L = np.where(live, self.lens[np.maximum(idx, 0)], 0)
        start = np.where(live, self.margin + np.maximum(idx, 0) * self.cap
                         + L - hrb, 0)
        win = self.buf.unfold(0, hrb, 1)
        pre = win[torch.from_numpy(start).to(self.device)]
        keep = (torch.arange(hrb, device=self.device).unsqueeze(0)
                >= torch.from_numpy(hrb - L).to(self.device).unsqueeze(1))
        return pre.mul_(keep)

    def fetch(self, which: np.ndarray) -> dict[int, bytes]:
        """Streams `which`'s outputs, through one pinned copy."""
        if not which.size:
            return {}
        m = int(self.lens[which].max())
        if m == 0 or self.cap == 0:
            return {int(i): b"" for i in which}
        rows = self._rows()[torch.from_numpy(which).to(self.device), :m]
        if self.device.type == "cuda":
            host = torch.empty(rows.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(rows, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
        else:
            host = rows
        flat = memoryview(host.numpy().reshape(-1))
        return {int(i): bytes(flat[r * m: r * m + int(self.lens[i])])
                for r, i in enumerate(which.tolist())}


def stage_units_v3_native(src: StreamPtrs, stream, bit, mlen, maxbw,
                          rings, history: DeviceHistory, device: torch.device,
                          max_groups: int = GROUP_CAP_V3,
                          width: int | None = None, custom_dictionary=None,
                          dict_dev=None) -> StagedV3 | None:
    """One round of decode_batch_v3_full: unit u is the metablock of
    stream stream[u] whose tables start at bit bit[u], continuing the
    ring rings[:, u] (4, n) and the stream's output in `history`.  Parsed
    under the _FULL_* caps and binned by tables; the batch holds the units
    that parsed within the caps (its perm gives their streams), with each
    lane's history prefix and last two bytes gathered on the device from
    `history`; None when none did or they need more lanes than
    `max_groups` groups of 1024 hold."""
    stream = np.asarray(stream, np.int64)
    n = stream.shape[0]
    if n == 0:
        return None
    pos0 = history.lens[stream]
    extras = np.zeros((7, n), np.int64)
    extras[0] = pos0
    extras[3:] = rings
    hs = plan_and_fill(src, stream, bit, maxbw, mlen, extras, full=True,
                       max_groups=max_groups, width=width,
                       pin=device.type == "cuda",
                       custom_dictionary=custom_dictionary,
                       with_dict=dict_dev is None)
    if hs is None:
        return None
    staged = to_device(hs, device, dict_dev, unit_stream=stream)
    max_hist = int(pos0.max())
    if max_hist:
        # assemble_v3's prefix: whole words, whole rows of 8
        hrb = 4 * (((max_hist + 3) // 4 + 7) // 8 * 8)
        tb = staged.tb
        tb.hist = history.prefix(staged.perm, hrb)
        # p1, p2: the last two bytes before each lane's metablock
        tb.scal[6] = tb.hist[:, hrb - 1]
        tb.scal[7] = tb.hist[:, hrb - 2]
    return staged
