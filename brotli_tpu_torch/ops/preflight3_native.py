"""The v3 decode's host preflight in C++, and its staging in numpy.

native/preflight3.cpp parses every unit's metablock tables in one call,
over threads, and bins the units by their tables; this module stages the
bins as the `V3Batch` of ops/preflight3.py.  A unit is a whole stream
(`preflight_v3_native`, the counterpart of `preflight_v3`) or a metablock
whose tables start at a bit that the multi-metablock driver has reached
(`preflight_units_v3_native`, the counterpart of its per-round
`assemble_v3`).  Both return a V3Batch with preflight_v3's field meanings,
or None where it returns None.  That driver's header walk, from one
compressed metablock to the next, is native too (`walk_units`).

The one difference is the group key.  preflight_v3's (`_sig_of`) holds
each stream's initial block lengths; this one leaves them out, since they
are per-lane scalars already (`scal` rows 2-4).  Streams that differ only
there share a group here, so a batch can have fewer groups.  Where no two
streams differ only there, the batches are equal field for field
(tests/test_torch_preflight3_native.py).  ops/preflight3.py stays as the
yardstick.

A library that fails to build or load raises: nothing falls back to the
Python preflight.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ..constants import (
    BLOCK_LENGTH_N_BITS,
    BLOCK_LENGTH_OFFSET,
    CODE_LENGTH_CODE_LENGTHS,
    CODE_LENGTH_CODE_ORDER,
)
from .preflight3 import (
    BLCH,
    BTCH,
    CCH,
    DCH,
    LANES,
    LCH,
    NSTREAM,
    SCAL_ROWS,
    SUB,
    _FULL_NBT,
    _FULL_NC,
    _FULL_ND,
    _FULL_NL,
    GroupCfg,
    V3Batch,
    _dcmch,
    _lcmch,
)

_NATIVE = Path(__file__).resolve().parent.parent / "native"
_LIB: ctypes.CDLL | None = None

N_THREADS = min(8, os.cpu_count() or 1)
# and-ed into every key's hash; the tests set it to 0 (every key collides)
_HASH_MASK = (1 << 64) - 1
# most block types of a category, literal, command and distance trees:
# preflight_one_v3's caps, and the multi-metablock path's _caps_full_ok
SINGLE_CAPS = (8, 16, 8, 8)
FULL_CAPS = (_FULL_NBT, _FULL_NL, _FULL_NC, _FULL_ND)
NCFG = 10          # a bin's GroupCfg fields, in GroupCfg's order
UNIT_COLS = 8      # status, mlen, cmd_start_bit, maxbw, blen0..2, bin
WALK_COLS = 6      # status, mlen, table bit, maxbw, is_last, bytes copied
_BSW_CHUNKS = 3 * BTCH + 3 * BLCH
_DX_CHUNKS = 5


def _lib() -> ctypes.CDLL:
    """native/preflight3.cpp, built into brotli_tpu_torch/build/ at first
    use (build._build, gated on a hash of it and of decoder.cpp, which it
    includes)."""
    global _LIB
    if _LIB is None:
        from ..build import _build

        path = _build(
            "brotli_tpu_torch_preflight3",
            ["g++", "-O3", "-march=native", "-fPIC", "-std=c++17", "-pthread"],
            ["g++", "-shared", "-pthread"], [_NATIVE / "preflight3.cpp"],
            deps=[_NATIVE / "decoder.cpp"])
        lib = ctypes.CDLL(str(path))
        fn = lib.brotli_v3_preflight_batch
        fn.restype = ctypes.c_int64
        P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        fn.argtypes = ([P] * 6 + [I64, I32] + [P] * 5
                       + [I32, ctypes.c_uint64, P, I64, P, P, P, I64])
        walk = lib.brotli_v3_walk_batch
        walk.restype = None
        walk.argtypes = [P] * 5 + [I64, I32] + [P] * 3
        _LIB = lib
    return _LIB


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.int32))


_FORMAT = {
    "blen_nbits": _i32(BLOCK_LENGTH_N_BITS),
    "blen_offset": _i32(BLOCK_LENGTH_OFFSET),
    "clc_order": _i32(CODE_LENGTH_CODE_ORDER),
    "clc_lengths": _i32(CODE_LENGTH_CODE_LENGTHS),
}


@dataclass
class Streams:
    """A batch's streams in one buffer.  Stream s is lens[s] bytes at
    offsets[s], followed by preflight_one_v3's zero padding ((-len) % 4 +
    12 bytes), so its words are the n_words[s] u32 from word offsets[s] // 4."""

    buf: np.ndarray       # uint8
    offsets: np.ndarray   # int64 byte offsets, multiples of 4
    lens: np.ndarray      # int64
    n_words: np.ndarray   # int64

    @property
    def words(self) -> np.ndarray:
        return self.buf.view("<u4")


def stage_streams(streams: list[bytes]) -> Streams:
    lens = np.fromiter(map(len, streams), np.int64, len(streams))
    padded = lens + (-lens) % 4 + 12
    offsets = np.zeros(len(streams), np.int64)
    np.cumsum(padded[:-1], out=offsets[1:])
    buf = np.frombuffer(b"".join(
        bytes(s) + bytes(int(p - n)) for s, n, p in zip(streams, lens, padded)
    ), np.uint8)
    return Streams(buf=buf, offsets=offsets, lens=lens, n_words=padded // 4)


def _max_layout(caps) -> int:
    """Entries of the largest bin the caps allow."""
    nbt, nl, nc, nd = caps
    return 128 * (nl * LCH + nc * CCH + nd * DCH + _BSW_CHUNKS + _lcmch(nbt)
                  + _dcmch(nbt) + 1 + _DX_CHUNKS)


@dataclass
class Parsed:
    """One native call.  units (n, 8) int64: status (1 = binned; else the
    error code, -99 over the caps, -100 another stream shape), mlen,
    cmd_start_bit, maxbw, the initial block lengths, bin (-1 = none).  cfg
    (n_bins, 10) and the bins' tables (pool, at offsets) are None when
    there are more than max_bins bins."""

    units: np.ndarray
    n_bins: int
    cfg: np.ndarray | None
    pool: np.ndarray | None
    offsets: np.ndarray | None


def _unit_args(st: Streams, unit_stream, unit_bit, unit_maxbw=None):
    """The units' int64 arrays, checked: each names a stream of the batch
    and starts at a bit >= 0."""
    us = np.ascontiguousarray(unit_stream, np.int64)
    n = us.shape[0]
    ub = np.ascontiguousarray(np.zeros(n) if unit_bit is None else unit_bit,
                              np.int64)
    um = np.ascontiguousarray(
        np.zeros(n) if unit_maxbw is None else unit_maxbw, np.int64)
    if n and (us.min() < 0 or us.max() >= st.lens.shape[0]):
        raise ValueError("a unit names no stream of the batch")
    if n and ub.min() < 0:
        raise ValueError("a unit starts at a negative bit")
    return us, ub, um


def parse_units(st: Streams, unit_stream, unit_bit=None, unit_maxbw=None, *,
                full: bool = False, max_bins: int = 32) -> Parsed:
    """Parse and bin units in one call of native/preflight3.cpp, over
    N_THREADS threads.  full=False: unit u is stream unit_stream[u], parsed
    from its first bit under preflight_one_v3's caps.  full=True: its
    tables start at bit unit_bit[u], its window is unit_maxbw[u], under the
    _FULL_* caps."""
    lib = _lib()
    us, ub, um = _unit_args(st, unit_stream, unit_bit, unit_maxbw)
    n = us.shape[0]
    caps = _i32(FULL_CAPS if full else SINGLE_CAPS)
    units = np.zeros((n, UNIT_COLS), np.int64)
    max_bins = max(0, int(max_bins))
    cfg = np.zeros((max_bins, NCFG), np.int32)
    offsets = np.zeros(max_bins + 1, np.int64)
    pool_cap = max_bins * _max_layout(caps)
    pool = np.zeros(max(1, pool_cap), np.int32)
    p = ctypes.c_void_p
    F = _FORMAT
    n_bins = lib.brotli_v3_preflight_batch(
        st.buf.ctypes.data_as(p), st.offsets.ctypes.data_as(p),
        st.lens.ctypes.data_as(p), us.ctypes.data_as(p),
        ub.ctypes.data_as(p), um.ctypes.data_as(p), n, int(full),
        caps.ctypes.data_as(p), F["blen_nbits"].ctypes.data_as(p),
        F["blen_offset"].ctypes.data_as(p), F["clc_order"].ctypes.data_as(p),
        F["clc_lengths"].ctypes.data_as(p), N_THREADS, _HASH_MASK,
        units.ctypes.data_as(p), max_bins, cfg.ctypes.data_as(p),
        offsets.ctypes.data_as(p), pool.ctypes.data_as(p), pool_cap)
    if n_bins < 0:
        raise RuntimeError("brotli_v3_preflight_batch: the bins' tables "
                           "outgrew the pool")
    if n_bins > max_bins:
        return Parsed(units, n_bins, None, None, None)
    return Parsed(units, n_bins, cfg[:n_bins], pool, offsets[: n_bins + 1])


@dataclass
class Walked:
    """One header walk.  units (n, 6) int64: status (1 = a compressed
    metablock; 0 = the stream ended; else the error code), its MLEN, the
    bit at which its tables start, maxbw (when the walk began at bit 0),
    ISLAST, the bytes of uncompressed metablocks copied on the way, unit u's
    at copied[copy_off[u]:]."""

    units: np.ndarray
    copied: np.ndarray
    copy_off: np.ndarray

    def copy_of(self, u: int) -> bytes:
        o = int(self.copy_off[u])
        return self.copied[o: o + int(self.units[u, 5])].tobytes()


def walk_units(st: Streams, unit_stream, unit_bit) -> Walked:
    """The multi-metablock path's header walk in one call of
    native/preflight3.cpp, over N_THREADS threads: unit u walks stream
    unit_stream[u] from bit unit_bit[u] (0 = its first bit, the window bits
    first) to its next compressed metablock, past metadata, copying the
    bytes of uncompressed metablocks, as the host decoder's loop."""
    us, ub, _ = _unit_args(st, unit_stream, unit_bit)
    n = us.shape[0]
    units = np.zeros((n, WALK_COLS), np.int64)
    copy_off = np.zeros(n + 1, np.int64)
    np.cumsum(st.lens[us], out=copy_off[1:])
    copied = np.empty(max(1, int(copy_off[-1])), np.uint8)
    p = ctypes.c_void_p
    _lib().brotli_v3_walk_batch(
        st.buf.ctypes.data_as(p), st.offsets.ctypes.data_as(p),
        st.lens.ctypes.data_as(p), us.ctypes.data_as(p),
        ub.ctypes.data_as(p), n, N_THREADS, units.ctypes.data_as(p),
        copied.ctypes.data_as(p), copy_off.ctypes.data_as(p))
    return Walked(units, copied, copy_off)


def _replicated(parts: list[np.ndarray]) -> np.ndarray:
    """Flat tables of whole 128-entry chunks -> (k*8, 128), each chunk
    over the 8 sublanes (assemble_v3's `stack`)."""
    flat = np.concatenate(parts).reshape(-1, 1, LANES)
    return np.ascontiguousarray(
        np.broadcast_to(flat, (flat.shape[0], SUB, LANES))
    ).reshape(-1, LANES)


def _assemble(st: Streams, parsed: Parsed, unit_stream: np.ndarray,
              idx: np.ndarray, mlens: np.ndarray, max_groups: int, D: int,
              extras: np.ndarray | None = None,
              hists: list | None = None) -> V3Batch | None:
    """assemble_v3 over the binned units: groups in the order in which the
    bins first appear, each bin's units sorted stably on
    mlen / (4 * the stream's words) and cut into groups of 1024.  idx:
    each unit's caller index (perm); extras (7, n): pos0, p1, p2, r0..r3;
    hists: each unit's earlier output."""
    units = parsed.units
    ok = np.flatnonzero(units[:, 0] == 1)
    if ok.size == 0 or parsed.cfg is None:
        return None
    bins = units[ok, 7]
    counts = np.bincount(bins, minlength=parsed.n_bins)
    bin_groups = -(-counts // NSTREAM)
    G = int(bin_groups.sum())
    if G > max_groups:
        return None
    ratio = mlens[ok] / np.maximum(1, 4 * st.n_words[unit_stream[ok]])
    order = np.lexsort((ratio, bins))
    u = ok[order]
    b = bins[order]
    rank = np.arange(u.size) - (np.cumsum(counts) - counts)[b]
    group_base = np.cumsum(bin_groups) - bin_groups
    slot = (group_base[b] + rank // NSTREAM) * NSTREAM + rank % NSTREAM
    n_slots = G * NSTREAM

    # tables: each group holds its bin's
    group_bin = np.repeat(np.arange(parsed.n_bins), bin_groups)
    configs, parts = [], [[] for _ in range(6)]
    for g_bin in group_bin:
        c = [int(v) for v in parsed.cfg[g_bin]]
        configs.append(GroupCfg(
            NL=c[0], NC=c[1], ND=c[2], NBT0=c[3], NBT1=c[4], NBT2=c[5],
            npostfix=c[6], ndirect=c[7], maxbw=c[8], trivial_lit=bool(c[9])))
        sizes = np.array([c[0] * LCH, c[1] * CCH, c[2] * DCH, _BSW_CHUNKS,
                          _lcmch(c[3]) + _dcmch(c[5]) + 1, _DX_CHUNKS]) * 128
        ends = parsed.offsets[g_bin] + np.cumsum(sizes)
        for k in range(6):
            parts[k].append(parsed.pool[ends[k] - sizes[k]: ends[k]])
    lit_t, cmd_t, dist_t, bsw_t, cmap_t, dx_t = map(_replicated, parts)

    # per-slot scalars
    bitpos = units[u, 2]
    w0 = bitpos >> 5
    mlen_s = np.zeros(n_slots, np.int64)
    mlen_s[slot] = mlens[u]
    n_words = np.zeros(n_slots, np.int32)
    n_words[slot] = st.n_words[unit_stream[u]] - w0
    perm = np.full(n_slots, -1, np.int64)
    perm[slot] = idx[u]
    rows = np.zeros((SCAL_ROWS, n_slots), np.int32)
    rows[[8, 9, 10, 11]] = np.array([4, 11, 15, 16])[:, None]
    rows[0, slot] = bitpos & 31
    rows[1, slot] = mlens[u]
    rows[2:5, slot] = units[u, 4:7].T
    if extras is not None:
        ex = extras[:, u]
        ex[0] = np.minimum(ex[0], 1 << 30)
        rows[5:, slot] = ex
    scal = rows.reshape(SCAL_ROWS, G, NSTREAM).transpose(1, 0, 2).reshape(
        G * SCAL_ROWS * SUB, LANES)

    # words: slot s holds its stream's words from w0 on, word-major; only
    # the slots that hold a unit are gathered
    Wpad = -(-int(n_words.max()) // D) * D + D
    o = np.argsort(slot)
    occ = slot[o]
    src = (st.offsets[unit_stream[u]] // 4 + w0)[o]
    w = np.arange(Wpad, dtype=np.int64)[:, None]
    got = np.where(w < n_words[occ][None, :],
                   np.take(st.words, src[None, :] + w, mode="clip"),
                   0).astype(np.uint32, copy=False)
    if occ.size == n_slots:
        wt = got
    else:
        wt = np.zeros((Wpad, n_slots), np.uint32)
        wt[:, occ] = got
    wt = wt.reshape(Wpad, G * SUB, LANES)

    hist, HR = None, 0
    if hists is not None:
        max_hist = max(map(len, hists), default=0)
        if max_hist:
            HR = ((max_hist + 3) // 4 + 7) // 8 * 8
            hist_u = np.empty(len(hists), object)
            hist_u[:] = hists
            hist_s = np.full(n_slots, b"", object)
            hist_s[slot] = hist_u[u]
            hist = hist_s.tolist()

    return V3Batch(
        wt=wt, lit_t=lit_t, cmd_t=cmd_t, dist_t=dist_t, bsw_t=bsw_t,
        cmap_t=cmap_t, dx_t=dx_t, scal=scal, mlens=mlen_s,
        n_streams=int(ok.size), configs=tuple(configs), Wpad=Wpad, groups=G,
        perm=perm, n_words=n_words, HR=HR, hist=hist,
    )


def preflight_v3_native(streams: list[bytes], max_groups: int = 4,
                        D: int = 64) -> V3Batch | None:
    """preflight_v3 through native/preflight3.cpp: full-format
    single-metablock streams binned by their tables into kernel groups;
    None when ineligible (no streams, a device-ineligible stream shape, or
    more than `max_groups` groups)."""
    if not streams:
        return None
    st = stage_streams(streams)
    n = len(streams)
    ids = np.arange(n, dtype=np.int64)
    parsed = parse_units(st, ids, max_bins=max_groups)
    if (parsed.units[:, 0] != 1).any():
        return None
    return _assemble(st, parsed, ids, ids, parsed.units[:, 1], max_groups, D)


@dataclass
class V3Units:
    """One round of the multi-metablock path: unit u is the metablock of
    stream `stream[u]` (an index into `streams`) whose tables start at bit
    `bit[u]`, with what the kernel resumes from (ops/preflight3._EntryV3)."""

    streams: Streams
    stream: np.ndarray    # int64
    bit: np.ndarray       # int64
    mlen: np.ndarray      # int64
    maxbw: np.ndarray     # int64
    extras: np.ndarray    # (7, n) int64: pos0, p1, p2, r0..r3
    hist: list            # bytes of earlier output, one a unit


def preflight_units_v3_native(units: V3Units, max_groups: int = 4,
                              D: int = 64) -> V3Batch | None:
    """One round of decode_batch_v3_full: each unit's tables parsed at its
    bit under the _FULL_* caps, the units binned by their tables.  The
    batch holds the units that parsed within the caps (its perm gives their
    streams); None when none did or they need more than `max_groups`
    groups."""
    n = units.stream.shape[0]
    if n == 0:
        return None
    parsed = parse_units(units.streams, units.stream, units.bit, units.maxbw,
                         full=True, max_bins=max_groups)
    return _assemble(units.streams, parsed, units.stream, units.stream,
                     units.mlen, max_groups, D, units.extras, units.hist)
