"""Device encoder: match finding, parse, records, bit packing and assembly
on a torch device.  Counterpart of brotli_tpu/ops/device_encode.py.

The streams are byte-identical to the JAX package's `encode_device_batch`
for every knob: one single-metablock RFC 7932 stream per chunk, with the
Huffman tables shared by each table group of the batch, which is the layout
the port's decoder (ops/decode2.py) takes.

Stages, per batch of B_LANES chunks of up to CHUNK_N bytes:

1. `find_matches`: hash every 4-byte window, a stable row sort of
   (hash << pbits | pos) carrying the window words, the nearest
   `chain_depth` same-hash neighbours, byte runs and run extension by
   doubling, clamped to the chunk: the CUDA kernel csrc/matches.cu on CUDA
   tensors (`find_matches_ref`, whole-array ops, on CPU tensors);
2. `greedy_parse`: score gate and lazy look-ahead, then the sequential
   next-free and distance-ring walk (the JAX `lax.scan`): the CUDA kernel
   csrc/parse.cu on CUDA tensors, whose only serial step is the frontier
   walk (`greedy_parse_ref`, a Python loop over positions vectorised over
   lanes, on CPU tensors);
3. `build_records`: symbol records already in stream order: the CUDA
   kernel csrc/records.cu on CUDA tensors (`build_records_ref` on CPU
   tensors);
4. `segment_stats` (block_types > 1): k-means and Viterbi block typing;
5. `group_hist`: a strided record sample binned by one bincount;
6. host: lane clustering (the lanes' literal features counted on the
   device, `lane_features`; the numpy k-means), Huffman tables over
   threads and each distinct header built once (ops/encode_host.py, the
   port's copy of the reference's host steps, and its faster forms);
7. `pack_records`: records -> LSB-first words, the CUDA kernel
   csrc/pack.cu on CUDA tensors (`pack_records_ref` on CPU tensors);
8. assembly: each lane's byte count and word offset on the device
   (`_lane_counts`), every sound lane's header words, body words and bit
   tail end to end in one flat tensor (`_assemble_compact`), one pinned
   fetch and a `bytes` a lane.

The host half is laid out for the card (`stage_upload`,
`prepare_pack_pinned`, `_encode_finish`): one pinned copy of the input
laid out in lanes on the device, the pack kernel's small inputs in one
pinned buffer and one copy, fetches through pinned memory that wait on the
current stream only.  The yardstick it replaced stays callable for the
tests and the in-turns timings (tools/enc_host_profile.py): `stage_input`,
`_headers`, `prepare_pack`, `assemble_streams`, `_old_encode_finish`.

Every stage works on (B, N) int32 tensors, lane first, like the JAX code.
Where JAX relies on int32 wraparound (the hash multiplies), the arithmetic
is done in int64 and wrapped back.  Lanes whose pack buffer overflowed
(`ovf`) are encoded again on the host, as in JAX, and counted in
`encode_fallback_stats()`.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    COPY_LENGTH_OFFSET,
    DISTANCE_SHORT_CODE_DELTA,
    DISTANCE_SHORT_CODE_INDEX,
    INSERT_LENGTH_OFFSET,
)
from ..decode.engine import _CONTEXT_LUT
from ..device import resolve_device
from ..encode import encode as host_encode
from ..encode.api import _encode_empty
from .encode_host import (
    B_LANES,
    CELL,
    CHUNK_N,
    HASH_MUL,
    K_CMD,
    K_DIST,
    K_LIT,
    K_PAD,
    MATCH_CAP,
    MAX_LEN,
    PACK_BR,
    _HIST_STRIDE_DEFAULT,
    _cluster_lanes,
    _cluster_lanes_feats,
    _group_tables_from_hists,
    _group_tables_once,
    _header_bits,
    _header_words_native,
    _hg,
    _pack_consts,
    _pack_symbol_table,
    _plan_block_switches,
    _split_group_hist,
    _tab_chunks,
    cluster_groups_native,
)

# Launches of the CUDA pack kernels (the segmented one, whose passes count
# once a call, and the serial one) and of the parse kernel, counted by their
# wrappers where they launch.
KERNEL_LAUNCHES = 0
SERIAL_PACK_LAUNCHES = 0
PARSE_LAUNCHES = 0
# Launches of the match and record kernels, counted the same way, and of
# their first forms and the parse kernel's (the first designs, kept to be
# timed against; no main path launches them).
MATCH_LAUNCHES = 0
RECORD_LAUNCHES = 0
MATCH_DIRECT_LAUNCHES = 0
RECORD_DIRECT_LAUNCHES = 0
PARSE_DIRECT_LAUNCHES = 0

# csrc/parse.cuh: positions a tile of parse_kernel and a speculation
# segment, threads a block
PARSE_TILE = 1024
PARSE_SEG = 128
PARSE_THREADS = 128

_M32 = 0xFFFFFFFF
_I32 = torch.int32
_I64 = torch.int64


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its int32 two's-complement value (XLA's wrapping)."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(_I32)


def _shift_left(a: torch.Tensor, j: int) -> torch.Tensor:
    """a[:, j:] followed by j zero columns."""
    return torch.cat([a[:, j:], a.new_zeros((a.shape[0], j))], dim=1)


def _shift_right(a: torch.Tensor, j: int = 1, fill: int = 0) -> torch.Tensor:
    """j `fill` columns followed by a[:, :-j]."""
    return torch.cat([a.new_full((a.shape[0], j), fill), a[:, :-j]], dim=1)


# ---------------------------------------------------------------------------
# elementwise code helpers
# ---------------------------------------------------------------------------

def code_from_offsets(x: torch.Tensor, offsets) -> torch.Tensor:
    """code = max k with x >= offsets[k] (device_encode._code_from_offsets)."""
    code = torch.zeros_like(x, dtype=_I32)
    for k in range(1, len(offsets)):
        code = code + (x >= int(offsets[k])).to(_I32)
    return code


_CELL_LUT = {
    (0, 0): 2, (0, 1): 3, (1, 0): 4, (1, 1): 5,
    (0, 2): 6, (2, 0): 7, (1, 2): 8, (2, 1): 9, (2, 2): 10,
}


def combine_length_codes(ins_code: torch.Tensor, cp_code: torch.Tensor,
                         use_last: torch.Tensor) -> torch.Tensor:
    """Elementwise command prefix (device_encode._combine_length_codes)."""
    bits64 = ((ins_code & 7) << 3) | (cp_code & 7)
    ih, ch = ins_code >> 3, cp_code >> 3
    cell = torch.zeros_like(ins_code)
    for (i, c), v in _CELL_LUT.items():
        cell = torch.where((ih == i) & (ch == c), v, cell)
    normal = (cell << 6) | bits64
    implicit_ok = use_last & (ins_code < 8) & (cp_code < 16)
    implicit = torch.where(cp_code < 8, bits64, bits64 | 64)
    return torch.where(implicit_ok, implicit, normal)


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for 1 <= x < 2^22, from the float32 exponent."""
    return (x.to(torch.float32).view(_I32) >> 23) - 127


@functools.cache
def _table_on(device: torch.device, name: str) -> torch.Tensor:
    """A constant int32 table of the stages on `device`, staged once per
    process: a copy from host memory waits for the device's current
    stream, so staging it inside the stages would hold the host until the
    stream's earlier stages end, and serialise the slots of a multi-device
    encode (parallel/mesh.py)."""
    tables = {"insert": INSERT_LENGTH_OFFSET, "copy": COPY_LENGTH_OFFSET,
              **{f"ctx{m}": _CONTEXT_LUT[m * 512: m * 512 + 512]
                 for m in range(4)}}
    return torch.as_tensor(np.asarray(tables[name], np.int32), device=device)


def literal_context(d32: torch.Tensor, n: int, mode: int) -> torch.Tensor:
    """(B, n) literal context ids (0..63) for context `mode`: lut[p1] |
    lut[256 + p2].  The JAX code evaluates the same table as compare-select
    chains over its constant runs (`_ctx_runs`), because a gather is slow on
    the TPU; here it is one lookup per half."""
    lut = _table_on(d32.device, f"ctx{mode}")
    p1 = _shift_right(d32[:, : n], 1)
    p2 = _shift_right(d32[:, : n], 2)
    return lut[p1.long()] | lut[256 + p2.long()]


# ---------------------------------------------------------------------------
# stage 1: match finding
# ---------------------------------------------------------------------------

def _check_matches(data_u8, n_valid, hash_stride, max_distance,
                   chain_depth) -> None:
    """The shapes and knobs csrc/matches.cu takes; raises on any other."""
    if (data_u8.dim() != 2 or data_u8.dtype != torch.uint8
            or not 0 < data_u8.shape[1] - (MATCH_CAP + 4) <= CHUNK_N):
        raise ValueError(f"data_u8: want uint8 (B, N+{MATCH_CAP + 4}) with "
                         f"0 < N <= {CHUNK_N}, got {data_u8.dtype} "
                         f"{tuple(data_u8.shape)}")
    B, N = data_u8.shape[0], data_u8.shape[1] - (MATCH_CAP + 4)
    if tuple(n_valid.shape) != (B,) or n_valid.dtype != _I32:
        raise ValueError(f"n_valid: want int32 ({B},), got {n_valid.dtype} "
                         f"{tuple(n_valid.shape)}")
    for name, t in (("data_u8", data_u8), ("n_valid", n_valid)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if n_valid.device != data_u8.device:
        raise ValueError(f"n_valid is on {n_valid.device}, data_u8 on "
                         f"{data_u8.device}")
    if hash_stride not in (1, 2) or N % hash_stride:
        raise ValueError(f"hash_stride must be 1 or 2 and divide N={N}, got "
                         f"{hash_stride}")
    if chain_depth < 1:
        raise ValueError(f"chain_depth must be >= 1, got {chain_depth}")
    if max_distance is not None and not 0 <= max_distance < 1 << 31:
        raise ValueError(f"max_distance must be None or in [0, 2^31), got "
                         f"{max_distance}")


def _alloc_matches(data_u8):
    B, N = data_u8.shape[0], data_u8.shape[1] - (MATCH_CAP + 4)
    return (torch.empty((B, N), dtype=_I32, device=data_u8.device),
            torch.empty((B, N), dtype=_I32, device=data_u8.device))


def _matches_c_args(data_u8, n_valid, out, hash_stride, max_distance,
                    chain_depth, hash2) -> list:
    """The argument list of brotli_torch_matches (and its host shim)."""
    B, N = data_u8.shape[0], data_u8.shape[1] - (MATCH_CAP + 4)
    return ([t.data_ptr() for t in (data_u8, n_valid, *out)]
            + [B, N, hash_stride, -1 if max_distance is None
               else max_distance, chain_depth, int(bool(hash2))])


def find_matches(data_u8: torch.Tensor, n_valid: torch.Tensor,
                 hash_stride: int = 1, max_distance: int | None = None,
                 chain_depth: int = 2, hash2: bool = False):
    """data_u8 (B, N+MATCH_CAP+4) uint8; n_valid (B,) int32.

    Returns (mlen, mdist) int32 (B, N): the best match (len >= 4) at each
    position, 0 where there is none; see device_encode.find_matches.  N is
    at most CHUNK_N, hash_stride 1 or 2, chain_depth >= 1; anything else
    raises.  CPU tensors take find_matches_ref; CUDA tensors launch
    csrc/matches.cu `match_kernel`, one block per lane."""
    global MATCH_LAUNCHES
    args = (hash_stride, max_distance, chain_depth, hash2)
    if not _matches_on_card(data_u8, n_valid, *args):
        return find_matches_ref(data_u8, n_valid, *args)
    out = _launch_matches("brotli_torch_matches", data_u8, n_valid, args)
    MATCH_LAUNCHES += 1
    return out


def find_matches_direct(data_u8: torch.Tensor, n_valid: torch.Tensor,
                        hash_stride: int = 1,
                        max_distance: int | None = None,
                        chain_depth: int = 2, hash2: bool = False):
    """find_matches through the first kernel, `match_direct_kernel`, the
    yardstick the match kernel is timed against; no main path launches it.
    CPU tensors take find_matches_ref."""
    global MATCH_DIRECT_LAUNCHES
    args = (hash_stride, max_distance, chain_depth, hash2)
    if not _matches_on_card(data_u8, n_valid, *args):
        return find_matches_ref(data_u8, n_valid, *args)
    out = _launch_matches("brotli_torch_matches_direct", data_u8, n_valid,
                          args)
    MATCH_DIRECT_LAUNCHES += 1
    return out


def _matches_on_card(data_u8, n_valid, *args) -> bool:
    """False for CPU tensors; True for checked CUDA tensors; raises on
    another device or on a shape or knob the kernels do not take."""
    _check_matches(data_u8, n_valid, *args[:3])
    dev = data_u8.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _launch_matches(entry: str, data_u8, n_valid, args):
    """One launch of a match kernel's C entry on the current stream; raises
    when it reports an error."""
    from ..build import kernels_lib

    dev = data_u8.device
    out = _alloc_matches(data_u8)
    with torch.cuda.device(dev):
        rc = getattr(kernels_lib(), entry)(
            *_matches_c_args(data_u8, n_valid, out, *args),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out


def match_config(n: int, direct: bool = False) -> tuple[int, int]:
    """(threads, dynamic shared bytes) of a block of csrc/matches.cu's
    match_kernel (or, with `direct`, match_direct_kernel) at N = n: what a
    launch asks of an SM."""
    from ..build import kernels_lib

    out = (ctypes.c_int * 2)()
    entry = ("brotli_torch_matches_direct_config" if direct
             else "brotli_torch_matches_config")
    if getattr(kernels_lib(), entry)(n, ctypes.addressof(out)):
        raise ValueError(f"no match kernel launch at N={n}")
    return out[0], out[1]


def find_matches_host(data_u8: torch.Tensor, n_valid: torch.Tensor,
                      hash_stride: int = 1, max_distance: int | None = None,
                      chain_depth: int = 2, hash2: bool = False,
                      seg: int = 1):
    """csrc/matches.cuh's code built for the CPU (build.host_lib), with a
    serial stable sort where the kernel sorts in shared memory, and the
    byte runs and extension rounds split into segments of `seg` positions
    as match_kernel splits them: for the tests, which hold it against
    find_matches_ref and JAX."""
    from ..build import host_lib

    _check_matches(data_u8, n_valid, hash_stride, max_distance, chain_depth)
    if data_u8.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out = _alloc_matches(data_u8)
    if host_lib().brotli_torch_matches_host(*_matches_c_args(
            data_u8, n_valid, out, hash_stride, max_distance, chain_depth,
            hash2), seg):
        raise ValueError("host shim refused the batch")
    return out


def find_matches_ref(data_u8: torch.Tensor, n_valid: torch.Tensor,
                     hash_stride: int = 1, max_distance: int | None = None,
                     chain_depth: int = 2, hash2: bool = False):
    """Plain PyTorch version of find_matches, on the inputs' device.  The
    keys of the row sort carry the position, so they are unique per lane,
    and a stable sort plus a gather of the payload words gives what
    `lax.sort(num_keys=1)` gives.  The sort back to position order is the
    inverse permutation, a scatter by the sort's indices."""
    B, npad = data_u8.shape
    N = npad - (MATCH_CAP + 4)
    d64 = data_u8.to(_I64)

    def load32(off):
        return _wrap32(d64[:, off: off + N]
                       | (d64[:, off + 1: off + 1 + N] << 8)
                       | (d64[:, off + 2: off + 2 + N] << 16)
                       | (d64[:, off + 3: off + 3 + N] << 24))

    w = [load32(k * 4) for k in range(MATCH_CAP // 4)]
    st = hash_stride
    n2 = N // st
    pbits = (n2 - 1).bit_length()
    w2 = [x[:, ::st].contiguous() for x in w] if st > 1 else w
    pos2 = torch.arange(n2, dtype=_I32, device=data_u8.device).expand(B, n2)

    def hash_pass(h, depth):
        key = (h << pbits) | pos2
        skey, idx = torch.sort(key, dim=1, stable=True)
        sw = [torch.gather(x, 1, idx) for x in w2]
        spos = (skey & ((1 << pbits) - 1)) * st
        shash = skey >> pbits

        def neighbor(j):
            cpos = _shift_right(spos, j, fill=-1)
            same = torch.cat(
                [torch.zeros((B, j), dtype=torch.bool, device=skey.device),
                 shash[:, j:] == shash[:, :-j]], dim=1)
            mlen = torch.full((B, n2), MATCH_CAP, dtype=_I32,
                              device=skey.device)
            done = torch.zeros((B, n2), dtype=torch.bool, device=skey.device)
            for k in range(MATCH_CAP // 4):
                x = sw[k] ^ _shift_right(sw[k], j)
                has_diff = x != 0
                # trailing zero BYTES of x (little-endian byte order)
                tz = torch.where(
                    (x & 0xFF) != 0, 0,
                    torch.where((x & 0xFFFF) != 0, 1,
                                torch.where((x & 0xFFFFFF) != 0, 2, 3)))
                mlen = torch.where(~done & has_diff, k * 4 + tz, mlen)
                done = done | has_diff
            dist = spos - cpos
            ok = same & (cpos >= 0) & (mlen >= 4)
            if max_distance is not None:
                ok = ok & (dist <= max_distance)
            return torch.where(ok, mlen, 0), torch.where(ok, dist, 0)

        slen, sdist = neighbor(1)
        for j in range(2, depth + 1):
            lj, dj = neighbor(j)
            better = (lj > slen) | ((lj == slen) & (dj < sdist) & (lj > 0))
            slen = torch.where(better, lj, slen)
            sdist = torch.where(better, dj, sdist)
        packed = ((slen << 16) | sdist).to(_I32)
        back = torch.empty_like(packed).scatter_(1, idx, packed)
        return back >> 16, back & 0xFFFF

    w0 = w2[0].to(_I64)
    h4 = (_wrap32(w0 * HASH_MUL) >> 15) & ((1 << (31 - pbits)) - 1)
    mlen_e, mdist_e = hash_pass(h4, chain_depth)
    if hash2:
        mul2 = 0x9E3779B1 - (1 << 32)
        h7 = _wrap32(w0 * HASH_MUL) ^ _wrap32((w2[1].to(_I64) & 0xFFFFFF) * mul2)
        h7 = (h7 >> 15) & ((1 << (31 - pbits)) - 1)
        l7, d7 = hash_pass(h7, 2)
        better = (l7 > mlen_e) | ((l7 == mlen_e) & (d7 < mdist_e) & (l7 > 0))
        mlen_e = torch.where(better, l7, mlen_e)
        mdist_e = torch.where(better, d7, mdist_e)
    if st > 1:
        mlen = torch.zeros((B, n2, st), dtype=_I32, device=data_u8.device)
        mdist = torch.zeros_like(mlen)
        mlen[:, :, 0] = mlen_e
        mdist[:, :, 0] = mdist_e
        mlen, mdist = mlen.reshape(B, N), mdist.reshape(B, N)
    else:
        mlen, mdist = mlen_e, mdist_e

    # byte runs: dist-4 matches of unbounded length, by exact doubling
    d32 = data_u8.to(_I32)
    c = (d32[:, :N] == _shift_right(d32[:, :N], 4, fill=-1)).to(_I32)
    L = c
    stride = 1
    while stride < min(MAX_LEN, N):
        L = L + torch.where(L == stride, _shift_left(L, stride), 0)
        stride *= 2
    L = torch.clamp(L, max=MAX_LEN)
    run_better = (L >= 4) & (L > mlen)
    mlen = torch.where(run_better, L, mlen)
    mdist = torch.where(run_better, 4, mdist)

    # doubling-stride extension of capped matches with equal distance
    stride = MATCH_CAP
    while stride < min(MAX_LEN, N):
        nlen = _shift_left(mlen, stride)
        ndist = _shift_left(mdist, stride)
        can = (mlen == stride) & (ndist == mdist) & (nlen > 0)
        mlen = torch.where(can, torch.clamp(mlen + nlen, max=MAX_LEN), mlen)
        stride *= 2

    pos = torch.arange(N, dtype=_I32, device=data_u8.device)[None, :]
    nv = n_valid.to(_I32)[:, None]
    mlen = torch.minimum(mlen, torch.clamp(nv - pos, min=0))
    valid = (pos < nv) & (mlen >= 4) & (mdist >= 1) & (mdist <= pos)
    return (torch.where(valid, mlen, 0).to(_I32),
            torch.where(valid, mdist, 0).to(_I32))


# ---------------------------------------------------------------------------
# stage 2: greedy parse
# ---------------------------------------------------------------------------

def _check_parse(mlen, mdist, n_valid) -> None:
    if mlen.dim() != 2 or not mlen.shape[1]:
        raise ValueError(f"mlen: want int32 (B, N), got {tuple(mlen.shape)}")
    B = mlen.shape[0]
    for name, t, shape in (("mlen", mlen, tuple(mlen.shape)),
                           ("mdist", mdist, tuple(mlen.shape)),
                           ("n_valid", n_valid, (B,))):
        if tuple(t.shape) != shape or t.dtype != _I32:
            raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != mlen.device:
            raise ValueError(f"{name} is on {t.device}, mlen on {mlen.device}")


def _parse_c_args(mlen, mdist, n_valid, out, lazy, min_gate, sms) -> list:
    """The argument list of brotli_torch_parse (and its host shim)."""
    B, N = mlen.shape
    return ([t.data_ptr() for t in (mlen, mdist, n_valid, *out)]
            + [B, N, int(lazy[0]), int(lazy[1]), int(min_gate), sms])


def _alloc_parse(mlen):
    return (torch.empty(mlen.shape, dtype=torch.bool, device=mlen.device),
            torch.empty(mlen.shape, dtype=torch.bool, device=mlen.device),
            torch.empty(mlen.shape, dtype=_I32, device=mlen.device))


def greedy_parse(mlen: torch.Tensor, mdist: torch.Tensor,
                 n_valid: torch.Tensor, lazy=(105, 175), min_gate: int = 9):
    """Returns (is_cs, is_lit, dcode_short) (B, N) bool, bool, int32; see
    device_encode.greedy_parse.  mlen, mdist (B, N) and n_valid (B,) are
    int32.  CPU tensors take greedy_parse_ref; CUDA tensors launch
    csrc/parse.cu `parse_kernel`, a block a lane in tiles of PARSE_TILE
    positions."""
    global PARSE_LAUNCHES
    if not _parse_on_card(mlen, mdist, n_valid):
        return greedy_parse_ref(mlen, mdist, n_valid, lazy, min_gate)
    out = _launch_parse("brotli_torch_parse", mlen, mdist, n_valid, lazy,
                        min_gate)
    PARSE_LAUNCHES += 1
    return out


def greedy_parse_direct(mlen: torch.Tensor, mdist: torch.Tensor,
                        n_valid: torch.Tensor, lazy=(105, 175),
                        min_gate: int = 9):
    """greedy_parse through the first kernel, `parse_direct_kernel` (a warp
    a lane), the yardstick the parse kernel is timed against; no main path
    launches it.  CPU tensors take greedy_parse_ref."""
    global PARSE_DIRECT_LAUNCHES
    if not _parse_on_card(mlen, mdist, n_valid):
        return greedy_parse_ref(mlen, mdist, n_valid, lazy, min_gate)
    out = _launch_parse("brotli_torch_parse_direct", mlen, mdist, n_valid,
                        lazy, min_gate)
    PARSE_DIRECT_LAUNCHES += 1
    return out


def _parse_on_card(mlen, mdist, n_valid) -> bool:
    """False for CPU tensors, True for checked CUDA tensors; raises on
    another device or shape."""
    _check_parse(mlen, mdist, n_valid)
    if mlen.device.type == "cpu":
        return False
    if mlen.device.type != "cuda":
        raise ValueError(f"unsupported device {mlen.device}")
    return True


def _launch_parse(entry: str, mlen, mdist, n_valid, lazy, min_gate):
    """One launch of a parse kernel's C entry on the current stream, its
    grid sized from the card's SM count; raises when it reports an
    error."""
    from ..build import kernels_lib

    out = _alloc_parse(mlen)
    sms = torch.cuda.get_device_properties(mlen.device).multi_processor_count
    with torch.cuda.device(mlen.device):
        rc = getattr(kernels_lib(), entry)(
            *_parse_c_args(mlen, mdist, n_valid, out, lazy, min_gate, sms),
            torch.cuda.current_stream(mlen.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"parse kernel launch failed ({entry}): "
                           f"cudaError {rc}")
    return out


def parse_config() -> tuple[int, int, int, int, int]:
    """(threads, static shared bytes, blocks an SM, registers a thread,
    positions a tile) of csrc/parse.cu's parse_kernel on this card."""
    from ..build import kernels_lib

    out = (ctypes.c_int * 5)()
    if kernels_lib().brotli_torch_parse_config(ctypes.addressof(out)):
        raise RuntimeError("cannot read parse_kernel's launch shape")
    return tuple(out)


def greedy_parse_host(mlen: torch.Tensor, mdist: torch.Tensor,
                      n_valid: torch.Tensor, lazy=(105, 175),
                      min_gate: int = 9, tile: int = PARSE_TILE,
                      seg: int = PARSE_SEG, direct: bool = False):
    """csrc/parse.cuh built for the CPU (build.host_lib), for the tests,
    which hold it against greedy_parse_ref and JAX: parse_kernel's phases
    in tiles of `tile` positions (a multiple of 32 up to PARSE_TILE) and
    speculation segments of `seg` (a power of two from 32 up to the tile;
    the card's are PARSE_TILE and PARSE_SEG), the block's threads as loops;
    with `direct`, the first kernel's window walk."""
    from ..build import host_lib

    _check_parse(mlen, mdist, n_valid)
    if mlen.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out = _alloc_parse(mlen)
    args = _parse_c_args(mlen, mdist, n_valid, out, lazy, min_gate, 0)
    rc = (host_lib().brotli_torch_parse_direct_host(*args) if direct
          else host_lib().brotli_torch_parse_host(*args, int(tile),
                                                  int(seg)))
    if rc:
        raise ValueError("host shim refused the batch")
    return out


def parse_ring_host(dist: np.ndarray, collapsed: bool,
                    tile_copies: int = PARSE_TILE,
                    threads: int = PARSE_THREADS) -> np.ndarray:
    """The short codes of a lane's copies at distances `dist` (int32, in
    order), from csrc/parse.cuh built for the CPU: parse_copy's ring stepped
    copy by copy, or (`collapsed`) parse_kernel's prefix count of pushes,
    the copies in tiles of `tile_copies` with the ring carried between
    them, in chunks of `threads` copies."""
    from ..build import host_lib

    d = np.ascontiguousarray(dist, np.int32)
    out = np.empty_like(d)
    if host_lib().brotli_torch_parse_ring_host(
            d.ctypes.data, len(d), out.ctypes.data, int(collapsed),
            int(tile_copies), int(threads)):
        raise ValueError("host shim refused the copy list")
    return out


def greedy_parse_ref(mlen: torch.Tensor, mdist: torch.Tensor,
                     n_valid: torch.Tensor, lazy=(105, 175),
                     min_gate: int = 9):
    """Plain PyTorch version of greedy_parse, on the inputs' device.  The
    gate and the look-ahead are whole-array ops; the next-free and
    distance-ring walk is a loop over positions, each step a few ops on
    (B,) tensors."""
    B, N = mlen.shape
    dev = mlen.device
    pos = torch.arange(N, dtype=_I32, device=dev)[None, :]
    score = 135 * mlen - 30 * ilog2(torch.clamp(mdist, min=1))
    strong = (mlen >= 4) & (score >= 135 * 4 - 30 * min_gate)
    take = (strong & ~(_shift_left(score, 1) >= score + lazy[0])
            & ~(_shift_left(score, 2) >= score + lazy[1]))
    in_chunk = pos < n_valid.to(_I32)[:, None]
    take = take & in_chunk

    # position-major copies, so each step reads contiguous (B,) rows
    take_t = take.t().contiguous()
    lit_t = (~take & in_chunk).t().contiguous()
    end_t = (pos + mlen).t().contiguous()
    # distances as compared with the ring: the JAX test `(d == cand) &
    # (cand > 0)` equals `d' == cand` where d' is d, or an impossible
    # value when d <= 0
    dist_t = mdist.t().to(_I64).contiguous()
    dcmp_t = torch.where(dist_t > 0, dist_t, -(1 << 40))

    sidx = [int(x) for x in DISTANCE_SHORT_CODE_INDEX[:4]]
    sdel = [int(x) for x in DISTANCE_SHORT_CODE_DELTA[:4]]
    is_cs = torch.empty((N, B), dtype=torch.bool, device=dev)
    is_lit = torch.empty((N, B), dtype=torch.bool, device=dev)
    dcode = torch.empty((N, B), dtype=_I32, device=dev)
    next_free = torch.zeros(B, dtype=_I32, device=dev)
    ring = [torch.full((B,), v, dtype=_I64, device=dev)
            for v in (4, 11, 15, 16)]
    for p in range(N):
        free = next_free <= p
        csi = free & take_t[p]
        is_cs[p] = csi
        is_lit[p] = free & lit_t[p]
        next_free = torch.where(csi, end_t[p], next_free)
        d = dcmp_t[p]
        dc = torch.full((B,), -1, dtype=_I32, device=dev)
        for k in range(3, -1, -1):
            cand = ring[sidx[k]] + sdel[k]
            dc = torch.where(d == cand, k, dc)
        dc = torch.where(csi, dc, -1)
        dcode[p] = dc
        push = csi & (dc != 0)
        ring = [torch.where(push, dist_t[p], ring[0]),
                torch.where(push, ring[0], ring[1]),
                torch.where(push, ring[1], ring[2]),
                torch.where(push, ring[2], ring[3])]
    return is_cs.t(), is_lit.t(), dcode.t()


# ---------------------------------------------------------------------------
# stage 3: symbol records
# ---------------------------------------------------------------------------

@functools.cache
def _records_table(device: torch.device) -> torch.Tensor:
    """csrc/records.cuh's constant table on `device`, staged once per
    process from host memory (see _table_on): the insert offsets, the copy
    offsets and the literal context LUTs of modes 2 and 3."""
    return torch.as_tensor(np.concatenate(
        [INSERT_LENGTH_OFFSET, COPY_LENGTH_OFFSET,
         _CONTEXT_LUT[2 * 512: 4 * 512]]).astype(np.int32), device=device)


def _check_records(data_u8, mlen, mdist, is_cs, is_lit, dcode_short,
                   n_valid, contiguous: bool = True) -> None:
    """The shapes csrc/records.cu takes; raises on any other.  The plain
    version takes strided tensors too (greedy_parse_ref's outputs are
    transposed views): `contiguous=False` leaves that out."""
    if mlen.dim() != 2 or not mlen.shape[1]:
        raise ValueError(f"mlen: want int32 (B, N), got {tuple(mlen.shape)}")
    B, N = mlen.shape
    if (data_u8.dim() != 2 or data_u8.dtype != torch.uint8
            or data_u8.shape[0] != B or data_u8.shape[1] < N):
        raise ValueError(f"data_u8: want uint8 ({B}, >= {N}), got "
                         f"{data_u8.dtype} {tuple(data_u8.shape)}")
    for name, t, dtype, shape in (
            ("data_u8", data_u8, torch.uint8, tuple(data_u8.shape)),
            ("mlen", mlen, _I32, (B, N)), ("mdist", mdist, _I32, (B, N)),
            ("is_cs", is_cs, torch.bool, (B, N)),
            ("is_lit", is_lit, torch.bool, (B, N)),
            ("dcode_short", dcode_short, _I32, (B, N)),
            ("n_valid", n_valid, _I32, (B,))):
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if contiguous and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != mlen.device:
            raise ValueError(f"{name} is on {t.device}, mlen on {mlen.device}")


def _alloc_records(mlen):
    B, N = mlen.shape
    return (torch.empty((B, N + 1), dtype=_I32, device=mlen.device),
            torch.empty((B, N + 1), dtype=_I32, device=mlen.device),
            torch.empty((B,), dtype=_I32, device=mlen.device))


def _records_c_args(data_u8, mlen, mdist, is_cs, is_lit, dcode_short,
                    n_valid, out, lit_ctx) -> list:
    """The argument list of brotli_torch_records (and its host shim)."""
    B, N = mlen.shape
    tab = _records_table(mlen.device)
    return ([t.data_ptr() for t in (data_u8, mlen, mdist, is_cs, is_lit,
                                    dcode_short, n_valid, tab, *out)]
            + [B, N, data_u8.shape[1], int(bool(lit_ctx))])


def build_records(data_u8, mlen, mdist, is_cs, is_lit, dcode_short, n_valid,
                  lit_ctx: bool = False):
    """Returns (rec0, rec1, n_records): (B, N+1) int32 records in stream
    order and (B,) int32 counts; see device_encode.build_records for the
    format and the placement.  data_u8 (B, >= N) uint8; mlen, mdist,
    dcode_short (B, N) int32; is_cs, is_lit (B, N) bool; n_valid (B,)
    int32.  CPU tensors take build_records_ref; CUDA tensors launch
    csrc/records.cu `records_kernel`, one block per lane."""
    global RECORD_LAUNCHES
    ins = (data_u8, mlen, mdist, is_cs, is_lit, dcode_short, n_valid)
    if not _records_on_card(*ins):
        return build_records_ref(*ins, lit_ctx)
    out = _launch_records("brotli_torch_records", ins, lit_ctx)
    RECORD_LAUNCHES += 1
    return out


def build_records_direct(data_u8, mlen, mdist, is_cs, is_lit, dcode_short,
                         n_valid, lit_ctx: bool = False):
    """build_records through the first kernel, `records_direct_kernel` (a
    warp a lane), the yardstick the record kernel is timed against; no main
    path launches it.  CPU tensors take build_records_ref."""
    global RECORD_DIRECT_LAUNCHES
    ins = (data_u8, mlen, mdist, is_cs, is_lit, dcode_short, n_valid)
    if not _records_on_card(*ins):
        return build_records_ref(*ins, lit_ctx)
    out = _launch_records("brotli_torch_records_direct", ins, lit_ctx)
    RECORD_DIRECT_LAUNCHES += 1
    return out


def _records_on_card(*ins) -> bool:
    """False for CPU tensors (strided ones too); True for checked
    contiguous CUDA tensors; raises on another device or shape."""
    dev = ins[1].device
    _check_records(*ins, contiguous=dev.type != "cpu")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return True


def _launch_records(entry: str, ins, lit_ctx: bool):
    """One launch of a record kernel's C entry on the current stream, its
    grid sized from the card's SM count; raises when it reports an
    error."""
    from ..build import kernels_lib

    dev = ins[1].device
    out = _alloc_records(ins[1])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        rc = getattr(kernels_lib(), entry)(
            *_records_c_args(*ins, out, lit_ctx), sms,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return out


def records_config(n: int) -> tuple[int, int, int]:
    """(threads, dynamic shared bytes, blocks an SM) of csrc/records.cu's
    records_kernel at N = n on this card."""
    from ..build import kernels_lib

    out = (ctypes.c_int * 3)()
    if kernels_lib().brotli_torch_records_config(n, ctypes.addressof(out)):
        raise ValueError(f"no record kernel launch at N={n}")
    return out[0], out[1], out[2]


def build_records_host(data_u8, mlen, mdist, is_cs, is_lit, dcode_short,
                       n_valid, lit_ctx: bool = False, segments: int = 1):
    """csrc/records.cuh's run walks built for the CPU (build.host_lib), in
    the block kernel's order with `segments` runs a tile where the kernel
    has one a thread (REC_THREADS): for the tests, which hold it against
    build_records_ref and JAX."""
    from ..build import host_lib

    _check_records(data_u8, mlen, mdist, is_cs, is_lit, dcode_short, n_valid)
    if mlen.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out = _alloc_records(mlen)
    if host_lib().brotli_torch_records_host(*_records_c_args(
            data_u8, mlen, mdist, is_cs, is_lit, dcode_short, n_valid, out,
            lit_ctx), segments):
        raise ValueError("host shim refused the batch")
    return out


def build_records_ref(data_u8, mlen, mdist, is_cs, is_lit, dcode_short,
                      n_valid, lit_ctx: bool = False):
    """Plain PyTorch version of build_records, on the inputs' device:
    whole-array ops, the reversed scans by flips."""
    B, N = mlen.shape
    dev = mlen.device
    pos = torch.arange(N, dtype=_I32, device=dev)[None, :].expand(B, N)
    d32 = data_u8[:, :N].to(_I32)
    nv = n_valid.to(_I32)

    cend = torch.where(is_cs, pos + mlen, -1)
    cend_cum = torch.cummax(cend, dim=1).values
    prev_end = torch.clamp(_shift_right(cend_cum, 1), min=0)
    ins_len = torch.where(is_cs, pos - prev_end, 0)

    has_short = is_cs & (dcode_short >= 0)
    code0 = is_cs & (dcode_short == 0)

    ins_off = _table_on(dev, "insert")
    cp_off = _table_on(dev, "copy")
    ins_code = code_from_offsets(ins_len, INSERT_LENGTH_OFFSET)
    cp_code = code_from_offsets(mlen, COPY_LENGTH_OFFSET)
    ins_val = ins_len - ins_off[ins_code.long()]
    cp_val = mlen - cp_off[cp_code.long()]

    implicit = code0 & (ins_code < 8) & (cp_code < 16)
    cmd_prefix = combine_length_codes(ins_code, cp_code, code0)

    dd = mdist + 3
    bucket = ilog2(torch.clamp(dd, min=4)) - 1
    prefix = (dd >> bucket) & 1
    offset = (2 + prefix) << bucket
    dcode_long = 16 + 2 * (bucket - 1) + prefix
    dcode = torch.where(has_short, dcode_short, dcode_long)
    dval = torch.where(has_short, 0, dd - offset)

    is_dist_slot = _shift_right(is_cs & ~implicit)
    is_cmd_slot = _shift_right(is_cs, 2)

    big = 0x7FFFFFFF

    def rev_next(payload):
        packed = torch.where(is_cs, (pos << 16) | payload, big)
        return torch.flip(torch.cummin(torch.flip(packed, [1]), dim=1).values,
                          [1])

    nxt_prefix = rev_next(cmd_prefix)
    nxt_insval = rev_next(ins_val)
    nxt_cpval = rev_next(cp_val)

    n_lit_tail = (nv - torch.clamp(cend_cum[:, -1], min=0))[:, None]
    has_tail = n_lit_tail > 0
    t_ins_code = code_from_offsets(n_lit_tail, INSERT_LENGTH_OFFSET)
    t_prefix = combine_length_codes(t_ins_code, torch.zeros_like(t_ins_code),
                                    t_ins_code < 8)
    t_rec1 = n_lit_tail - ins_off[t_ins_code.long()]

    nxtp_here = _shift_right(nxt_prefix)
    nxti_here = _shift_right(nxt_insval)
    nxtc_here = _shift_right(nxt_cpval)
    next_exists = nxtp_here != big
    cmd_code = torch.where(next_exists, nxtp_here & 0xFFFF, t_prefix)
    cmd_rec1 = torch.where(
        next_exists, (nxti_here & 0xFFFF) | ((nxtc_here & 0xFFFF) << 16),
        t_rec1)
    emit_cmd = is_cmd_slot & (next_exists | has_tail)

    kind = torch.where(
        emit_cmd, K_CMD,
        torch.where(is_dist_slot, K_DIST, torch.where(is_lit, K_LIT, K_PAD)))
    lit_code = d32
    if lit_ctx:
        # both candidate context modes ride in the record; the table-group
        # clustering picks UTF8 (text) or SIGNED (binary) per group
        lit_code = (d32 | (literal_context(d32, N, 2) << 14)
                    | (literal_context(d32, N, 3) << 20))
    code = torch.where(
        emit_cmd, cmd_code,
        torch.where(is_dist_slot, _shift_right(dcode),
                    torch.where(is_lit, lit_code, 0)))
    rec1 = torch.where(emit_cmd, cmd_rec1,
                       torch.where(is_dist_slot, _shift_right(dval), 0))
    rec0 = torch.where(kind == K_PAD, 0, (kind << 28) | code)

    first_exists = nxt_prefix[:, 0:1] != big
    c0_rec0 = torch.where(
        first_exists | (nv[:, None] > 0),
        (K_CMD << 28) | torch.where(first_exists, nxt_prefix[:, 0:1] & 0xFFFF,
                                    t_prefix),
        0)
    c0_rec1 = torch.where(
        first_exists,
        (nxt_insval[:, 0:1] & 0xFFFF) | ((nxt_cpval[:, 0:1] & 0xFFFF) << 16),
        t_rec1)
    rec0_full = torch.cat([c0_rec0, rec0], dim=1).to(_I32)
    rec1_full = torch.cat([c0_rec1, rec1], dim=1).to(_I32)
    n_records = ((rec0_full >> 28) != K_PAD).sum(dim=1).to(_I32)
    return rec0_full, rec1_full, n_records


# ---------------------------------------------------------------------------
# stage 4: block typing (block_types > 1)
# ---------------------------------------------------------------------------

@contextmanager
def _no_tf32():
    """float32 matmuls in full float32 on the card, whatever the caller set:
    the k-means and Viterbi stages must type segments as JAX does."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def segment_stats(data_u8: torch.Tensor, is_lit: torch.Tensor, nbt: int,
                  pseg: int, feat_stride: int = 8):
    """Returns (seg_type (B, NSEG) int32, seg_litcnt (B, NSEG) int32, first
    literal flag (B, N) int32); see device_encode._segment_stats.  Float32
    throughout, as in JAX; argsort is stable and argmin takes the first
    minimum in both."""
    B, npad = data_u8.shape
    N = npad - (MATCH_CAP + 4)
    nseg = N // pseg
    dev = data_u8.device
    lit3 = is_lit.reshape(B, nseg, pseg)
    seg_litcnt = lit3.sum(dim=2).to(_I32)
    cum = torch.cumsum(lit3.to(_I32), dim=2)
    first = (lit3 & (cum == 1)).reshape(B, N).to(_I32)

    fs = feat_stride
    bins = (data_u8[:, :N:fs].to(_I64) >> 3).reshape(B, nseg, pseg // fs)
    mask = is_lit[:, ::fs].reshape(B, nseg, pseg // fs)
    onehot_bins = torch.nn.functional.one_hot(bins, 32) & mask[..., None]
    feats = onehot_bins.sum(dim=2).to(torch.float32)        # (B, NSEG, 32)

    with _no_tf32():
        M = B * nseg
        X = feats.reshape(M, 32)
        wgt = X.sum(dim=1)
        Xn = X / torch.clamp(wgt, min=1.0)[:, None]
        order = torch.argsort(-wgt, stable=True)
        seed_idx = order[:: max(1, M // nbt)][:nbt]
        C = Xn[seed_idx]
        types = torch.arange(nbt, device=dev)[None, :]
        assign = torch.zeros((M,), dtype=_I32, device=dev)
        for _ in range(4):
            d = ((Xn[:, None, :] - C[None, :, :]) ** 2).sum(dim=2)
            assign = torch.argmin(d, dim=1).to(_I32)
            onehot = (assign[:, None] == types).to(torch.float32)
            sums = onehot.t() @ (Xn * wgt[:, None])
            wsum = onehot.t() @ wgt[:, None]
            C = sums / torch.clamp(wsum, min=1e-6)

        sw_bits = 36.0 / feat_stride
        seg_type = None
        for _ in range(3):
            onehot = (assign[:, None] == types).to(torch.float32)
            H = onehot.t() @ X + 1.0 / 256.0
            logp = torch.log2(H / H.sum(dim=1, keepdim=True))
            cost = -(feats.reshape(M, 32) @ logp.t())
            cost_lane = cost.reshape(B, nseg, nbt)
            dps = [cost_lane[:, 0, :]]
            d_ = dps[0]
            for s in range(1, nseg):
                best_any = torch.min(d_, dim=1, keepdim=True).values
                d_ = cost_lane[:, s, :] + torch.minimum(d_, best_any + sw_bits)
                dps.append(d_)
            cur = torch.argmin(dps[-1], dim=1)
            picked = [cur]
            for s in range(nseg - 1, 0, -1):
                prev_dp = dps[s - 1]
                stay_cost = torch.gather(prev_dp, 1, cur[:, None])[:, 0]
                best_prev = torch.argmin(prev_dp, dim=1)
                best_cost = torch.gather(prev_dp, 1, best_prev[:, None])[:, 0]
                cur = torch.where(best_cost + sw_bits < stay_cost, best_prev,
                                  cur)
                picked.append(cur)
            seg_type = torch.stack(picked[::-1], dim=1).to(_I32)
            assign = seg_type.reshape(M)
    return seg_type, seg_litcnt, first


def device_stages(data_u8, n_valid, hash_stride: int = 1,
                  max_distance: int | None = None, chain_depth: int = 2,
                  lit_ctx: bool = False, nbt: int = 1, pseg: int = 2048,
                  hash2: bool = False, lazy=(105, 175), min_gate: int = 9,
                  mark=None):
    """Stages 1-4: records ready for packing (device_encode._device_stages).
    With nbt > 1 the first literal of each segment carries bit 26.
    `mark(name)`, when given, is called as each stage ends."""
    mark = mark or (lambda name: None)
    mlen, mdist = find_matches(data_u8, n_valid, hash_stride, max_distance,
                               chain_depth, hash2)
    mark("matches")
    is_cs, is_lit, dcode_short = greedy_parse(mlen, mdist, n_valid, lazy,
                                              min_gate)
    mark("parse")
    rec0, rec1, n_rec = build_records(data_u8, mlen, mdist, is_cs, is_lit,
                                      dcode_short, n_valid, lit_ctx=lit_ctx)
    if nbt <= 1:
        mark("records")
        return rec0, rec1, n_rec
    seg_type, seg_litcnt, first = segment_stats(data_u8, is_lit, nbt, pseg)
    # record row p+1 holds position p (row 0 is the first command)
    flag = torch.cat([first.new_zeros((first.shape[0], 1)), first], dim=1)
    rec0 = rec0 | (flag << 26)
    mark("records")
    return rec0, rec1, n_rec, seg_type, seg_litcnt


# ---------------------------------------------------------------------------
# stage 5: group histogram
# ---------------------------------------------------------------------------

def group_hist(rec0: torch.Tensor, grp: torch.Tensor,
               signed_mode: torch.Tensor, n_groups: int, stride: int,
               nbt: int = 1, btype: torch.Tensor | None = None):
    """Flat (n_groups*hg + 1,) counts of a strided record sample, keyed by
    lane group, context (signed or UTF8 per lane, block type when nbt > 1)
    and symbol; see device_encode._jitted_group_hist."""
    hg = _hg(nbt)
    lit_bins = nbt * 64 * 256
    sub = rec0[:, ::stride].to(_I64)
    kind = (sub >> 28) & 0xF
    code = sub & 0x3FFF
    ctx = torch.where(signed_mode.to(_I64)[:, None] > 0, (sub >> 20) & 0x3F,
                      (sub >> 14) & 0x3F)
    if nbt > 1:
        ctx = btype.to(_I64) * 64 + ctx
    base = grp.to(_I64)[:, None] * hg
    key = torch.where(
        kind == K_LIT, base + ctx * 256 + (code & 0xFF),
        torch.where(
            kind == K_CMD, base + lit_bins + torch.clamp(code, 0, 703),
            torch.where(kind == K_DIST,
                        base + lit_bins + 704 + torch.clamp(code, 0, 63),
                        n_groups * hg)))
    return torch.bincount(key.reshape(-1), minlength=n_groups * hg + 1)


# ---------------------------------------------------------------------------
# stage 7: bit packing (the kernel)
# ---------------------------------------------------------------------------

@dataclass
class PackBatch:
    """The pack kernel's inputs, all int32 and on one device.

    rec0, rec1 (rows, n_lanes) record-major, rows padded with zero (PAD)
    records to a multiple of PACK_BR as in JAX; tab (G, (2nt+6)*128)
    per-group code tables; cmap (G, NBC*128) context maps; consts (128,);
    grp, init0, initav (n_lanes,): table group (| SIGNED flag << 8 when
    nbt > 1), header tail bits and their count; sw, stype (nseg, n_lanes)
    switch words and segment types when nbt > 1."""

    rec0: torch.Tensor
    rec1: torch.Tensor
    tab: torch.Tensor
    cmap: torch.Tensor
    consts: torch.Tensor
    grp: torch.Tensor
    init0: torch.Tensor
    initav: torch.Tensor
    sw: torch.Tensor | None
    stype: torch.Tensor | None
    nt: int
    nbt: int
    pseg: int
    nseg: int

    @property
    def rows(self) -> int:
        return self.rec0.shape[0]

    @property
    def n_lanes(self) -> int:
        return self.rec0.shape[1]

    @property
    def device(self) -> torch.device:
        return self.rec0.device


def _check_pack(pb: PackBatch) -> None:
    n = pb.n_lanes
    G = pb.tab.shape[0] if pb.tab.dim() == 2 else -1
    shapes = {
        "rec0": (pb.rec0, (pb.rows, n)),
        "rec1": (pb.rec1, (pb.rows, n)),
        "tab": (pb.tab, (G, _tab_chunks(pb.nt) * 128)),
        "cmap": (pb.cmap, (G, pb.cmap.shape[-1])),
        "consts": (pb.consts, (128,)),
        "grp": (pb.grp, (n,)),
        "init0": (pb.init0, (n,)),
        "initav": (pb.initav, (n,)),
    }
    if pb.nbt > 1:
        shapes["sw"] = (pb.sw, (pb.nseg, n))
        shapes["stype"] = (pb.stype, (pb.nseg, n))
    for name, (t, shape) in shapes.items():
        if t is None or tuple(t.shape) != shape or t.dtype != _I32:
            got = None if t is None else (t.dtype, tuple(t.shape))
            raise ValueError(f"{name}: want int32 {shape}, got {got}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != pb.device:
            raise ValueError(f"{name} is on {t.device}, rec0 on {pb.device}")
    if G < 1 or pb.cmap.shape[-1] < 128 or pb.cmap.shape[-1] % 128:
        raise ValueError("tab needs >= 1 group and cmap whole 128-entry chunks")
    if pb.nt < 1 or pb.pseg < 1 or pb.nseg < 1:
        raise ValueError("nt, pseg and nseg must be >= 1")


PACK_SEG = 256   # record rows per segment of the segmented kernel (pack.cuh)


def _alloc_pack(pb: PackBatch):
    words = torch.zeros((pb.rows, pb.n_lanes), dtype=_I32, device=pb.device)
    status = torch.empty((6, pb.n_lanes), dtype=_I32, device=pb.device)
    return words, status


def _alloc_scratch(pb: PackBatch) -> torch.Tensor:
    """The segmented kernel's (3, segments, n_lanes) counts."""
    nsegr = -(-pb.rows // PACK_SEG)
    return torch.empty((3, nsegr, pb.n_lanes), dtype=_I32, device=pb.device)


def _pack_c_args(pb: PackBatch, words, status, scratch=None) -> list:
    """The argument list of brotli_torch_pack (with the scratch) and
    brotli_torch_pack_serial (without), and of their host shims."""
    def ptr(t):
        return t.data_ptr() if t is not None else None

    bufs = (words, status) if scratch is None else (words, status, scratch)
    return ([ptr(t) for t in (pb.rec0, pb.rec1, pb.tab, pb.cmap, pb.consts,
                              pb.grp, pb.init0, pb.initav, pb.sw, pb.stype,
                              *bufs)]
            + [pb.n_lanes, pb.rows, pb.tab.shape[0], pb.tab.shape[1],
               pb.cmap.shape[1], pb.nt, pb.nbt, pb.pseg, pb.nseg])


def _launch_pack(pb: PackBatch, serial: bool):
    from ..build import kernels_lib

    words, status = _alloc_pack(pb)
    lib = kernels_lib()
    # the scratch is freed after the launch: the caching allocator hands it
    # out again only to work queued behind the kernel on this stream
    scratch = None if serial else _alloc_scratch(pb)
    fn = lib.brotli_torch_pack_serial if serial else lib.brotli_torch_pack
    args = _pack_c_args(pb, words, status, scratch)
    with torch.cuda.device(pb.device):
        rc = fn(*args, torch.cuda.current_stream(pb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"pack kernel launch failed: cudaError {rc}")
    return words, status


def pack_records(pb: PackBatch):
    """Pack every lane's records into LSB-first words.

    Returns (words (rows, n_lanes) int32, status (6, n_lanes) int32) on the
    batch's device: lane l's body words are words[:widx[l], l], compact, and
    zero below; status rows are widx, avail (bits left in the buffer), the
    buffer's three low limbs and the overflow flag.  CPU tensors take
    pack_records_ref; CUDA tensors launch the segmented kernel of
    csrc/pack.cu (four passes, one count)."""
    global KERNEL_LAUNCHES
    _check_pack(pb)
    if pb.device.type == "cpu":
        return pack_records_ref(pb)
    if pb.device.type != "cuda":
        raise ValueError(f"unsupported device {pb.device}")
    out = _launch_pack(pb, serial=False)
    KERNEL_LAUNCHES += 1
    return out


def pack_records_serial(pb: PackBatch):
    """pack_records through the serial kernel of csrc/pack.cu (one thread a
    lane runs the row machine), on CUDA tensors only: the yardstick the
    segmented kernel is timed against."""
    global SERIAL_PACK_LAUNCHES
    _check_pack(pb)
    if pb.device.type != "cuda":
        raise ValueError(f"the serial pack kernel takes CUDA tensors, "
                         f"not {pb.device}")
    out = _launch_pack(pb, serial=True)
    SERIAL_PACK_LAUNCHES += 1
    return out


def pack_records_host(pb: PackBatch, serial: bool = False):
    """csrc/pack.cuh's code built for the CPU (build.host_lib): the
    segmented kernel's four passes, or with `serial` the row machine of the
    serial kernel; for the tests, which hold both against
    pack_records_ref."""
    from ..build import host_lib

    _check_pack(pb)
    if pb.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    words, status = _alloc_pack(pb)
    lib = host_lib()
    scratch = None if serial else _alloc_scratch(pb)
    fn = (lib.brotli_torch_pack_serial_host if serial
          else lib.brotli_torch_pack_host)
    rc = fn(*_pack_c_args(pb, words, status, scratch))
    if rc:
        raise ValueError(f"host shim refused the batch ({rc})")
    return words, status


def pack_records_ref(pb: PackBatch, rows_at_once: int = 512):
    """Plain PyTorch version of pack_records, on the batch's device.

    The per-lane machine of csrc/pack.cuh vectorised over lanes: one loop
    iteration is one record row for every lane (appends, then at most one
    word out).  What each row appends (its pieces, _pack_pieces) is looked
    up for `rows_at_once` rows at a time.  The bit buffer is a (4, lanes)
    int64 tensor of u32 limbs; bits past its fourth limb are dropped."""
    _check_pack(pb)
    dev = pb.device
    n, rows = pb.n_lanes, pb.rows
    lane = torch.arange(n, dtype=_I64, device=dev)
    limb_no = torch.arange(4, dtype=_I64, device=dev)[:, None]
    buf = torch.zeros((4, n), dtype=_I64, device=dev)
    buf[0] = pb.init0.to(_I64) & _M32
    avail = pb.initav.to(_I64) & _M32
    widx = torch.zeros(n, dtype=_I64, device=dev)
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    words = torch.zeros((rows + 1) * n, dtype=_I32, device=dev)
    dummy = rows * n + lane   # row `rows` absorbs the rows that emit nothing
    first = 0 if pb.nbt > 1 else 1   # one block type: no block-switch piece
    for lo in range(0, rows, rows_at_once):
        hi = min(rows, lo + rows_at_once)
        pieces = [(v.unbind(), nb.unbind())
                  for v, nb in _pack_pieces(pb, lo, hi)[first:]]
        for i in range(hi - lo):
            for vs, nbs in pieces:
                # the piece's bits (< 2^32) from bit `avail` on: its low
                # part into limb avail >> 5, its high part into the next
                t = vs[i] << (avail & 31)
                limb = avail >> 5
                buf |= (torch.where(limb_no == limb, t & _M32, 0)
                        | torch.where(limb_no == limb + 1, t >> 32, 0))
                avail = (avail + nbs[i]) & _M32
            emit = avail >= 32
            words[torch.where(emit, widx * n + lane, dummy)] = _wrap32(buf[0])
            buf = torch.where(emit, torch.nn.functional.pad(buf[1:],
                                                            (0, 0, 0, 1)),
                              buf)
            avail = avail - 32 * emit
            widx = widx + emit
            ovf |= avail > 80
    status = torch.stack([widx, avail, buf[0], buf[1], buf[2],
                          ovf.to(_I64)])
    return words[: rows * n].reshape(rows, n), _wrap32(status)


def _pack_pieces(pb: PackBatch, r_lo: int, r_hi: int):
    """What rows [r_lo, r_hi) of every lane append, as four (value, bit
    count) pairs of int64 (r_hi - r_lo, n_lanes) tensors, in order: the
    block-switch word, the symbol code, extra 1, extra 2.  The counts are
    pack_append's (nb & 63) and the values are masked to them."""
    dev = pb.device
    nt, nbt = pb.nt, pb.nbt
    G, tab_n = pb.tab.shape
    cmap_n = pb.cmap.shape[1]
    tab = pb.tab.reshape(-1).to(_I64)
    cmap = pb.cmap.reshape(-1).to(_I64)
    consts = pb.consts.to(_I64)
    grpv = pb.grp.to(_I64)[None, :]
    grp = grpv & 0xFF if nbt > 1 else grpv
    grp_ok = (grp >= 0) & (grp < G)
    cm_base = torch.where(grp_ok, grp, 0) * cmap_n
    r0 = pb.rec0[r_lo:r_hi].to(_I64)
    r1 = pb.rec1[r_lo:r_hi].to(_I64)
    kind = (r0 >> 28) & 0xF
    code = r0 & 0x3FFF
    is_cmd, is_dist, live = kind == K_CMD, kind == K_DIST, kind != K_PAD
    ctx_u, ctx_s = (r0 >> 14) & 0x3F, (r0 >> 20) & 0x3F
    r = torch.arange(r_lo, r_hi, device=dev)
    seg = ((r - 1).clamp(min=0) // pb.pseg).clamp(max=pb.nseg - 1)
    if nbt > 1:
        btype = pb.stype[seg].to(_I64)
        cidx = btype * 64 + torch.where(((grpv >> 8) & 1) > 0, ctx_s, ctx_u)
        ok = grp_ok & (cidx >= 0) & (cidx < cmap_n)
        tree = torch.where(ok, cmap[cm_base + cidx.clamp(0, cmap_n - 1)], 0)
    elif nt > 1:
        signed = grp_ok & (cmap[cm_base + 127] > 0)
        tree = torch.where(grp_ok, cmap[cm_base + (torch.where(
            signed, ctx_s, ctx_u) & 127)], 0)
    else:
        tree = torch.zeros_like(code)
    lit_idx = tree * 256 + (code & 0xFF)
    idx = torch.where(live, grp * tab_n + torch.where(
        is_cmd, nt * 256 + code,
        torch.where(is_dist, nt * 256 + 704 + code, lit_idx)), 0)
    in_tab = (idx >= 0) & (idx < G * tab_n)
    ent = torch.where(in_tab, tab[idx.clamp(0, G * tab_n - 1)], 0)
    cell = code >> 6
    s2 = 2 * torch.where(cell < 2, cell, cell - 2)
    ins_hi = torch.where(s2 < 32, 0x29850 >> s2.clamp(0, 31), 0) & 3
    cp_hi = torch.where(s2 < 32, 0x26244 >> s2.clamp(0, 31), 0) & 3
    zero = torch.zeros_like(code)
    pieces = [
        (zero, zero),
        (ent & 0xFFFF, torch.where(live, ent >> 16, 0)),
        (torch.where(is_cmd, r1 & 0xFFFF, torch.where(is_dist, r1 & _M32, 0)),
         torch.where(is_cmd, consts[(ins_hi * 8 + ((code >> 3) & 7)) & 127],
                     torch.where(is_dist & (code >= 16),
                                 ((code - 16) >> 1) + 1, 0))),
        (torch.where(is_cmd, (r1 >> 16) & 0xFFFF, 0),
         torch.where(is_cmd, consts[(cp_hi * 8 + (code & 7) + 64) & 127], 0)),
    ]
    if nbt > 1:
        sww = pb.sw[seg].to(_I64) & _M32
        pieces[0] = (sww & 0x07FFFFFF,
                     torch.where(((r0 >> 26) & 1) > 0, sww >> 27, 0))
    out = []
    for v, nb in pieces:
        nbu = nb & 63
        out.append((v & torch.where(nbu >= 32, _M32,
                                    (1 << nbu.clamp(max=31)) - 1), nbu))
    return out


def pack_records_scan(pb: PackBatch, chunk: int = 4096):
    """pack_records as a scan over rows, in plain PyTorch: a cross-check of
    the segmented kernel's formulation (csrc/pack.cuh) against the row
    machine pack_records_ref, which stays the yardstick.

    With S_r = initav + the bits of rows 0..r and F_r = S_r >> 5, a lane
    whose buffer never overflows has emitted W_r = r + min(1, min_{j<=r}
    (F_j - j)) words through row r, and those words are the bit stream's:
    init0, then every row's pieces from bit initav.  So widx = W_last, avail
    = S_last - 32 widx, the limbs are the stream's words from widx on, and
    ovf is set where some S_r - 32 W_r > 80.  Lanes with ovf drop bits as
    only the row machine does, so they are packed by pack_records_ref.
    Rows are taken `chunk` at a time."""
    _check_pack(pb)
    dev = pb.device
    n, rows = pb.n_lanes, pb.rows
    lane = torch.arange(n, dtype=_I64, device=dev)
    nbits = torch.zeros((rows, n), dtype=_I64, device=dev)
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        nbits[lo:hi] = sum(nb for _, nb in _pack_pieces(pb, lo, hi))
    initav = pb.initav.to(_I64) & _M32
    S = initav[None, :] + torch.cumsum(nbits, dim=0)
    r = torch.arange(rows, dtype=_I64, device=dev)[:, None]
    M = torch.cummin((S >> 5) - r, dim=0).values
    W = r + M.clamp(max=1)
    if rows:
        widx, s_last = W[-1], S[-1]
        ovf = ((S - 32 * W) > 80).any(dim=0)
    else:
        widx, s_last = torch.zeros_like(initav), initav
        ovf = torch.zeros(n, dtype=torch.bool, device=dev)

    # the stream's words, lane-major, wide enough for the rows' words, the
    # limbs after widx (<= rows) and each piece's second word; pieces' bits
    # are disjoint, so adding them ORs them
    n_words = max(rows, int(s_last.max().item()) // 32 if n else 0) + 3
    stream = torch.zeros(n * n_words, dtype=_I64, device=dev)
    base = lane * n_words
    for lo in range(0, rows, chunk):
        hi = min(rows, lo + chunk)
        off = S[lo:hi] - nbits[lo:hi]   # each row's first bit
        for v, nbu in _pack_pieces(pb, lo, hi):
            k, sh = off >> 5, off & 31
            stream.index_add_(0, (base + k).reshape(-1),
                              ((v << sh) & _M32).reshape(-1))
            stream.index_add_(0, (base + k + 1).reshape(-1), torch.where(
                sh > 0, v >> ((32 - sh) & 31), 0).reshape(-1))
            off = off + nbu
    stream = stream.reshape(n, n_words)
    stream[:, 0] |= pb.init0.to(_I64) & _M32
    col = torch.arange(rows, dtype=_I64, device=dev)[:, None]
    words = torch.where(col < widx[None, :], stream.t()[:rows], 0)
    limbs = torch.gather(stream, 1, widx[:, None] + torch.arange(
        3, device=dev)[None, :]).t()
    status = torch.stack([widx, s_last - 32 * widx, limbs[0], limbs[1],
                          limbs[2], ovf.to(_I64)])
    words, status = _wrap32(words), _wrap32(status)
    if bool(ovf.any()):
        sel = ovf.nonzero().reshape(-1)

        def cols(t):
            return None if t is None else t[:, sel].contiguous()

        sub = PackBatch(**{**pb.__dict__, "rec0": cols(pb.rec0),
                           "rec1": cols(pb.rec1), "sw": cols(pb.sw),
                           "stype": cols(pb.stype), "grp": pb.grp[sel],
                           "init0": pb.init0[sel], "initav": pb.initav[sel]})
        words[:, sel], status[:, sel] = pack_records_ref(sub)
    return words, status


# ---------------------------------------------------------------------------
# stage 8: assembly
# ---------------------------------------------------------------------------

def assemble_streams(words: torch.Tensor, status: torch.Tensor,
                     h: torch.Tensor, hidx: torch.Tensor,
                     hdr_stack: torch.Tensor) -> torch.Tensor:
    """Each lane's whole stream as (n_lanes, maxH + rows + 2) int32 words:
    its h header words (row hidx of the distinct-header stack), its widx
    body words, then the buffer limbs that still hold bits (b0 when avail
    > 0, b1 when avail > 32).  The words after a lane's stream are zero.
    The pack output is compact per lane, so this is a copy, where JAX needs
    a sort (device_encode._jitted_assemble)."""
    rows, n = words.shape
    max_h = hdr_stack.shape[1]
    width = max_h + rows + 2
    col = torch.arange(width, dtype=_I64, device=words.device)[None, :]
    h2 = h.to(_I64)[:, None]
    widx = status[0].to(_I64)[:, None]
    avail = status[1].to(_I64)[:, None]
    head = torch.nn.functional.pad(hdr_stack[hidx.long()], (0, width - max_h))
    body = torch.gather(words.t(), 1, (col - h2).clamp(0, rows - 1))
    t = col - h2 - widx
    return torch.where(
        col < h2, head,
        torch.where(t < 0, body,
                    torch.where((t == 0) & (avail > 0), status[2][:, None],
                                torch.where((t == 1) & (avail > 32),
                                            status[3][:, None], 0))))


# ---------------------------------------------------------------------------
# the encode entry points
# ---------------------------------------------------------------------------

# Lanes whose pack buffer overflowed are encoded again on the host: a
# performance cliff that has to be visible.
_FALLBACK_STATS = {"batches": 0, "lanes_total": 0, "lanes_fallback": 0}


def encode_fallback_stats() -> dict:
    """Counters of lanes that the host encoded in the device's place."""
    return dict(_FALLBACK_STATS)


def _note_fallbacks(n_lanes: int, n_fallback: int) -> None:
    _FALLBACK_STATS["batches"] += 1
    _FALLBACK_STATS["lanes_total"] += n_lanes
    _FALLBACK_STATS["lanes_fallback"] += n_fallback
    if n_fallback:
        logging.getLogger("brotli_tpu_torch").warning(
            "device encode: %d/%d lanes overflowed and were host-encoded",
            n_fallback, n_lanes,
        )


def stage_input(data: bytes, chunk_size: int, device: torch.device):
    """The batch on `device`: (data (B_LANES, chunk_size+12) uint8 tensor,
    n_valid (B_LANES,) int32 numpy, n_valid tensor)."""
    n_chunks = -(-len(data) // chunk_size)
    n_valid_np = np.zeros(B_LANES, dtype=np.int32)
    full = len(data) // chunk_size
    n_valid_np[:full] = chunk_size
    if full < n_chunks:
        n_valid_np[full] = len(data) - full * chunk_size
    # zero tail: windows never read across chunk ends (chunks are
    # independent streams; match lengths are clamped to n_valid anyway)
    body = np.zeros(B_LANES * chunk_size, dtype=np.uint8)
    body[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    arr = np.zeros((B_LANES, chunk_size + MATCH_CAP + 4), dtype=np.uint8)
    arr[:, :chunk_size] = body.reshape(B_LANES, chunk_size)
    return (torch.from_numpy(arr).to(device), n_valid_np,
            torch.from_numpy(n_valid_np).to(device))


def _pin_input(data: bytes, device: torch.device) -> torch.Tensor:
    """The input's bytes, copied once into a uint8 host tensor of len(data)
    bytes, pinned when `device` is a card; an input of 8 MB or more is
    copied in COPY_PIECES pieces at once (numpy's copy releases the GIL)."""
    host = torch.empty(len(data), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    dst = host.numpy()
    src = np.frombuffer(data, dtype=np.uint8)
    if len(data) < (8 << 20):
        dst[:] = src
        return host
    cuts = np.linspace(0, len(data), COPY_PIECES + 1).astype(np.int64)

    def piece(k):
        dst[cuts[k]: cuts[k + 1]] = src[cuts[k]: cuts[k + 1]]

    list(_pool().map(piece, range(COPY_PIECES)))
    return host


def _lay_out(host: torch.Tensor, chunk_size: int, device: torch.device):
    """The batch laid out on `device` from the host bytes: one asynchronous
    copy of the whole input, then a zeroed (B_LANES, chunk_size + MATCH_CAP
    + 4) uint8 tensor takes its n_chunks x chunk_size prefix, lane by lane,
    on the device (so every byte after a lane's n_valid is zero, as
    stage_input's); and n_valid (B_LANES,) int32, filled on the device."""
    flat = host.to(device, non_blocking=True)
    full, rem = divmod(host.numel(), chunk_size)
    data_t = torch.zeros((B_LANES, chunk_size + MATCH_CAP + 4),
                         dtype=torch.uint8, device=device)
    n_valid = torch.zeros(B_LANES, dtype=_I32, device=device)
    if full:
        data_t[:full, :chunk_size] = flat[: full * chunk_size].view(
            full, chunk_size)
        n_valid[:full] = chunk_size
    if rem:
        data_t[full, :rem] = flat[full * chunk_size:]
        n_valid[full] = rem
    return data_t, n_valid


def stage_upload(data: bytes, chunk_size: int, device: torch.device):
    """stage_input's batch from one pinned copy of the input: (data_t,
    n_valid numpy, n_valid tensor, the pinned host tensor, which must live
    until its copy has ended)."""
    n_chunks = -(-len(data) // chunk_size)
    full = len(data) // chunk_size
    n_valid_np = np.zeros(B_LANES, dtype=np.int32)
    n_valid_np[:full] = chunk_size
    if full < n_chunks:
        n_valid_np[full] = len(data) - full * chunk_size
    host = _pin_input(data, device)
    data_t, n_valid = _lay_out(host, chunk_size, device)
    return data_t, n_valid_np, n_valid, host


def _encode_start(data: bytes, device: torch.device, chunk_size: int,
                  hash_stride: int, sample_stride: int,
                  max_distance: int | None = None, chain_depth: int = 2,
                  lit_ctx: bool = False,
                  hist_stride: int = _HIST_STRIDE_DEFAULT,
                  block_types: int = 1, block_seg: int = 2048,
                  hash2: bool = False, lazy=(105, 175),
                  min_gate: int = 9, on_stage=None) -> dict:
    """Upload the batch and run stages 1-4 on `device`; returns the state
    the later steps take (device_encode._encode_start).  `on_stage(name,
    state)`, when given, is called as each stage ends."""
    if not (0 < chunk_size <= CHUNK_N and chunk_size % CELL == 0):
        raise ValueError(f"chunk_size must be a multiple of {CELL} in "
                         f"(0, {CHUNK_N}], got {chunk_size}")
    n_chunks = -(-len(data) // chunk_size)
    if n_chunks > B_LANES:
        raise ValueError(f"{n_chunks} chunks: at most {B_LANES} per batch")
    nbt = block_types
    if nbt > 1 and not (lit_ctx and chunk_size % block_seg == 0 and nbt <= 7):
        raise ValueError("block_types > 1 needs lit_ctx_trees > 1, "
                         "block_types <= 7 and chunk_size % block_seg == 0")

    data_t, n_valid_np, n_valid, host = stage_upload(data, chunk_size, device)
    # `pinned` keeps the host buffers of the encode's asynchronous copies
    state = dict(data=data, device=device, chunk_size=chunk_size,
                 n_chunks=n_chunks, n_valid_np=n_valid_np,
                 hist_stride=hist_stride, block_types=nbt,
                 block_seg=block_seg, pinned=[host])
    mark = None if on_stage is None else (lambda name: on_stage(name, state))
    if mark is not None:
        mark("upload")
    outs = device_stages(data_t, n_valid, hash_stride, max_distance,
                         chain_depth, lit_ctx, nbt, block_seg, hash2,
                         tuple(lazy), min_gate, mark)
    rec0, rec1 = outs[0], outs[1]
    seg_type, seg_litcnt = (outs[3], outs[4]) if nbt > 1 else (None, None)
    state.update(rec0=rec0, rec1=rec1, rec0_sample=rec0[:, ::sample_stride],
                 seg_type=seg_type, seg_litcnt=seg_litcnt)
    return state


def _headers(state: dict, lgwin: int, tables: list, group_of: np.ndarray,
             split: tuple | None):
    """Header words per lane: (init0, initav (B,) int32 header tail bits
    and count, h (B,) full header words, hidx (B,) index into the distinct
    headers, hdr_stack (n_distinct, maxH) uint32).  Headers are cached per
    (size, group[, first block length, first type])."""
    n_chunks = state["n_chunks"]
    n_valid_np = state["n_valid_np"]
    nbt = state["block_types"]
    cache: dict[tuple, tuple] = {}

    def header_for(s: int):
        key = (int(n_valid_np[s]), int(group_of[s]))
        if split is not None:
            first_blen, t0_np, group_splits = split
            key = key + (int(first_blen[s]), int(t0_np[s]))
        if key not in cache:
            sp = None
            if split is not None:
                sp = dict(nbt=nbt, first_blen=key[2], t0=key[3],
                          **group_splits[key[1]])
            w = _header_bits(key[0], lgwin, tables[key[1]], sp)
            total_bits = len(w.take_bytes()) * 8 + w.nbits
            # rebuilt to recover the bit-level tail (take_bytes drained it)
            raw = _header_bits(key[0], lgwin, tables[key[1]], sp).finish()
            words = np.frombuffer(raw + b"\x00" * ((-len(raw)) % 4), "<u4")
            rem = total_bits % 32
            partial = int(words[total_bits // 32]) & ((1 << rem) - 1) if rem else 0
            cache[key] = (words[: total_bits // 32], partial, rem)
        return key

    init0 = np.zeros(B_LANES, np.uint32)
    initav = np.zeros(B_LANES, np.int32)
    lane_key = [header_for(s) for s in range(n_chunks)]
    keys = sorted(cache)
    index = {k: j for j, k in enumerate(keys)}
    max_h = max([len(cache[k][0]) for k in keys] + [1])
    hdr_stack = np.zeros((max(1, len(keys)), max_h), np.uint32)
    for k, j in index.items():
        hdr_stack[j, : len(cache[k][0])] = cache[k][0]
    h = np.zeros(B_LANES, np.int32)
    hidx = np.zeros(B_LANES, np.int32)
    for s, k in enumerate(lane_key):
        words, partial, rem = cache[k]
        h[s] = len(words)
        hidx[s] = index[k]
        init0[s] = partial
        initav[s] = rem
    return init0.view(np.int32), initav, h, hidx, hdr_stack


def _table_arrays(tables: list, nt: int, nbt: int, table_groups: int):
    """The pack kernel's (tab, cmap) int32 arrays of the groups' tables:
    per-group flat code tables (the JAX stack without its sublane
    replication, the first group's again for unused groups) and context
    maps (| the SIGNED flag at entry 127 with one block type)."""
    tabk = _tab_chunks(nt)
    tab_np = np.concatenate([
        _pack_symbol_table(t, nt).reshape(tabk, 8, 128)[:, 0, :].reshape(1, -1)
        for t in tables
    ])
    n_used = len(tables)
    if n_used < table_groups:
        tab_np = np.concatenate([tab_np] + [tab_np[:1]] * (table_groups - n_used))
    nbc = -(-(nbt * 64) // 128) if nbt > 1 else 1
    cmap_np = np.zeros((table_groups, nbc * 128), np.int32)
    for j, t in enumerate(tables):
        if nbt > 1:
            cmap_np[j, : nbt * 64] = t["cmap"]
        else:
            cmap_np[j, :64] = t["cmap"]
            cmap_np[j, 127] = 1 if t.get("mode") == 3 else 0
    return tab_np, cmap_np


def prepare_pack(state: dict, lgwin: int, table_groups: int = 1,
                 lit_ctx_trees: int = 1):
    """Lane clustering, the group histogram, tables and headers: the pack
    kernel's inputs.  Returns (PackBatch, (h, hidx, hdr_stack) tensors for
    the assembly, h as numpy)."""
    dev = state["device"]
    chunk_size = state["chunk_size"]
    n_chunks = state["n_chunks"]
    rec0, rec1 = state["rec0"], state["rec1"]
    nt = lit_ctx_trees
    nbt = state["block_types"]
    pseg = state["block_seg"]
    nseg = chunk_size // pseg if nbt > 1 else 1

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    rec0_sample = state["rec0_sample"].cpu().numpy()
    group_of, group_modes = _cluster_lanes(rec0_sample, table_groups, n_chunks)
    n_used = len(group_modes)
    signed_mode = np.asarray([group_modes[g] == 3 for g in group_of], np.int32)
    btype = None
    split = None
    if nbt > 1:
        seg_type_np = state["seg_type"].cpu().numpy()
        seg_litcnt_np = state["seg_litcnt"].cpu().numpy()
        sw_words, first_blen, t0_np, group_splits = _plan_block_switches(
            seg_type_np, seg_litcnt_np, n_chunks, group_of, n_used, nbt)
        split = (first_blen, t0_np, group_splits)
        # record row j holds position j-1; row 0 is the first command
        cols = np.arange(0, rec0.shape[1], state["hist_stride"])
        btype = put(seg_type_np[:, np.clip((cols - 1) // pseg, 0, nseg - 1)])
    flat_hist = group_hist(rec0, put(group_of.astype(np.int32)),
                           put(signed_mode), n_used, state["hist_stride"],
                           nbt, btype).cpu().numpy()
    tables = [
        _group_tables_from_hists(*_split_group_hist(flat_hist, j, nbt), nt)
        for j in range(n_used)
    ]
    for j, t in enumerate(tables):
        t["mode"] = group_modes[j] if nt > 1 else 0
    tab_np, cmap_np = _table_arrays(tables, nt, nbt, table_groups)

    init0, initav, h_np, hidx, hdr_stack = _headers(state, lgwin, tables,
                                                    group_of, split)

    R = rec0.shape[1]
    rpad = -(-R // PACK_BR) * PACK_BR
    rec0_t = torch.zeros((rpad, B_LANES), dtype=_I32, device=dev)
    rec1_t = torch.zeros((rpad, B_LANES), dtype=_I32, device=dev)
    rec0_t[:R] = rec0.t()
    rec1_t[:R] = rec1.t()
    grp_enc = group_of.astype(np.int32)
    sw_t = stype_t = None
    if nbt > 1:
        grp_enc = grp_enc | (signed_mode << 8)
        sw_t = put(sw_words.T.view(np.int32))
        stype_t = put(seg_type_np.T.astype(np.int32))
    pb = PackBatch(
        rec0=rec0_t, rec1=rec1_t, tab=put(tab_np), cmap=put(cmap_np),
        consts=put(_pack_consts()[0]), grp=put(grp_enc), init0=put(init0),
        initav=put(initav), sw=sw_t, stype=stype_t,
        nt=nt, nbt=nbt, pseg=pseg, nseg=nseg,
    )
    return pb, (put(h_np), put(hidx), put(hdr_stack.view(np.int32))), h_np


# C++ threads of the table groups' native context-map clusterings, and
# pieces of the input's copy into pinned memory (memory-bound: a few
# threads take most of what more would give)
ENC_THREADS = min(8, os.cpu_count() or 1)
COPY_PIECES = 4
_POOL: ThreadPoolExecutor | None = None


def _pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(COPY_PIECES, thread_name_prefix="enc-copy")
    return _POOL


def _to_host(t: torch.Tensor) -> np.ndarray:
    """`t` as numpy: on a card, one copy into a pinned buffer and a wait on
    the current stream only (other slots' streams run on)."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    torch.cuda.current_stream(t.device).synchronize()
    return host.numpy()


def _to_device(fields: dict, device: torch.device, keep: list) -> dict:
    """int32 numpy arrays to `device` through one host buffer (pinned on a
    card; each array at a 64-word boundary) and one copy; returns a view
    of the device buffer per array.  The host buffer goes into `keep`,
    which must live until the copy has ended."""
    offs, end = {}, 0
    for k, a in fields.items():
        offs[k] = end
        end += -(-a.size // 64) * 64
    host = torch.empty(max(end, 1), dtype=_I32,
                       pin_memory=device.type == "cuda")
    hn = host.numpy()
    for k, a in fields.items():
        hn[offs[k]: offs[k] + a.size] = np.ascontiguousarray(a).reshape(-1) \
            .view(np.int32)
    buf = host.to(device, non_blocking=True)
    keep.append(host)
    return {k: buf[offs[k]: offs[k] + a.size].view(a.shape)
            for k, a in fields.items()}


def lane_features(rec0_sample: torch.Tensor, n_chunks: int) -> np.ndarray:
    """(n_chunks, 32) int64: each lane's literal count by (byte >> 3) over
    the record sample, as _cluster_lanes counts them (kind (r >> 28) & 0xF
    == K_LIT, bin (r & 0xFF) >> 3 on int32), counted where the sample lies
    by one masked scatter_add; only the counts are fetched."""
    s = rec0_sample[:n_chunks]
    dev = s.device
    lit = (((s >> 28) & 0xF) == K_LIT).to(_I32)
    key = (torch.arange(n_chunks, dtype=_I64, device=dev)[:, None] * 32
           + ((s & 0xFF) >> 3).to(_I64))
    counts = torch.zeros(n_chunks * 32, dtype=_I32, device=dev)
    counts.scatter_add_(0, key.reshape(-1), lit.reshape(-1))
    return _to_host(counts).reshape(n_chunks, 32).astype(np.int64)


def _group_hist_fetch(rec0, group_of: np.ndarray, signed_mode: np.ndarray,
                      n_used: int, stride: int, nbt: int, btype, keep: list):
    """group_hist of the lanes' groups and context modes (one copy of both
    to the device), fetched."""
    lanes = _to_device({"g": np.stack([group_of.astype(np.int32),
                                       signed_mode])}, rec0.device, keep)["g"]
    return _to_host(group_hist(rec0, lanes[0], lanes[1], n_used, stride,
                               nbt, btype))


def _group_tables_all(flat_hist: np.ndarray, n_used: int, nbt: int,
                      nt: int) -> list:
    """Every group's _group_tables_once, in group order: with context
    trees, the groups' native context-map clusterings first, in one call
    over ENC_THREADS C++ threads (cluster_groups_native), then each
    group's fold and codes."""
    hists = [_split_group_hist(flat_hist, j, nbt) for j in range(n_used)]
    clustered = [None] * n_used
    if nt > 1:
        clustered = cluster_groups_native(np.stack([h[0] for h in hists]),
                                          ENC_THREADS)
    return [_group_tables_once(*h, nt, c) for h, c in zip(hists, clustered)]


def _headers_once(state: dict, lgwin: int, tables: list,
                  group_of: np.ndarray, split: tuple | None):
    """_headers' result, each distinct header built once, in C++
    (_header_words_native, the same bits as _header_bits):
    (init0, initav, h, hidx, hdr_stack), the distinct headers sorted by
    key as _headers sorts them."""
    n = state["n_chunks"]
    # a lane's key (size, group[, first block length, first type]) as one
    # int64 ordered as the tuples are: sizes below 2^16, groups below 2^20,
    # first block lengths below 2^15 (at most 16,624) and types below 8
    key = (state["n_valid_np"][:n].astype(np.int64) << 20) \
        | group_of[:n].astype(np.int64)
    if split is not None:
        first_blen, t0_np, group_splits = split
        key = (key << 18) | (first_blen[:n].astype(np.int64) << 3) \
            | t0_np[:n].astype(np.int64)
    keys, inv = np.unique(key, return_inverse=True)
    inv = inv.reshape(-1)
    built = []
    for k in keys.tolist():
        sp = None
        if split is not None:
            k, first, t0 = k >> 18, (k >> 3) & 0x7FFF, k & 7
            sp = dict(nbt=state["block_types"], first_blen=first, t0=t0,
                      **group_splits[k & 0xFFFFF])
        built.append(_header_words_native(k >> 20, lgwin,
                                          tables[k & 0xFFFFF], sp))
    max_h = max([len(b[0]) for b in built] + [1])
    hdr_stack = np.zeros((max(1, len(built)), max_h), np.uint32)
    for j, b in enumerate(built):
        hdr_stack[j, : len(b[0])] = b[0]
    h = np.zeros(B_LANES, np.int32)
    hidx = np.zeros(B_LANES, np.int32)
    init0 = np.zeros(B_LANES, np.uint32)
    initav = np.zeros(B_LANES, np.int32)
    h[:n] = np.asarray([len(b[0]) for b in built], np.int32)[inv]
    hidx[:n] = inv
    init0[:n] = np.asarray([b[1] for b in built], np.uint32)[inv]
    initav[:n] = np.asarray([b[2] for b in built], np.int32)[inv]
    return init0.view(np.int32), initav, h, hidx, hdr_stack


def _transpose_records(rec0: torch.Tensor, rec1: torch.Tensor):
    """rec0, rec1 (B, R) -> (rpad, B) record-major on their device, rows
    padded with zero (PAD) records to a multiple of PACK_BR."""
    B, R = rec0.shape
    rpad = -(-R // PACK_BR) * PACK_BR
    out = []
    for r in (rec0, rec1):
        t = torch.empty((rpad, B), dtype=_I32, device=r.device)
        t[:R] = r.t()
        t[R:] = 0
        out.append(t)
    return out


def prepare_pack_pinned(state: dict, lgwin: int, table_groups: int = 1,
                        lit_ctx_trees: int = 1):
    """prepare_pack's result (PackBatch, (h, hidx, hdr_stack) tensors, h
    numpy), laid out for the card: the lanes' literal features counted on
    the device (lane_features), the group histogram fetched through a
    pinned buffer, the groups' context maps clustered over C++ threads
    (_group_tables_all), each distinct header built once (_headers_once),
    and the pack kernel's small inputs with h, hidx and the header stack
    in one pinned buffer and one copy (_to_device); the record transposes
    stay on the device."""
    dev = state["device"]
    chunk_size = state["chunk_size"]
    n_chunks = state["n_chunks"]
    rec0, rec1 = state["rec0"], state["rec1"]
    keep = state["pinned"]
    nt = lit_ctx_trees
    nbt = state["block_types"]
    pseg = state["block_seg"]
    nseg = chunk_size // pseg if nbt > 1 else 1

    feats = lane_features(state["rec0_sample"], n_chunks)
    group_of, group_modes = _cluster_lanes_feats(feats, table_groups,
                                                 n_chunks)
    n_used = len(group_modes)
    signed_mode = (np.asarray(group_modes)[group_of] == 3).astype(np.int32)
    btype = None
    split = None
    if nbt > 1:
        seg = _to_host(torch.stack([state["seg_type"],
                                    state["seg_litcnt"]]).to(_I32))
        sw_words, first_blen, t0_np, group_splits = _plan_block_switches(
            seg[0], seg[1], n_chunks, group_of, n_used, nbt)
        split = (first_blen, t0_np, group_splits)
        # record row j holds position j-1; row 0 is the first command
        cols = torch.arange(0, rec0.shape[1], state["hist_stride"],
                            device=dev)
        btype = state["seg_type"][:, ((cols - 1) // pseg).clamp(0, nseg - 1)]
    flat_hist = _group_hist_fetch(rec0, group_of, signed_mode, n_used,
                                  state["hist_stride"], nbt, btype, keep)
    tables = _group_tables_all(flat_hist, n_used, nbt, nt)
    for j, t in enumerate(tables):
        t["mode"] = group_modes[j] if nt > 1 else 0
    tab_np, cmap_np = _table_arrays(tables, nt, nbt, table_groups)

    init0, initav, h_np, hidx, hdr_stack = _headers_once(
        state, lgwin, tables, group_of, split)
    grp_enc = group_of.astype(np.int32)
    fields = dict(tab=tab_np, cmap=cmap_np, consts=_pack_consts()[0],
                  grp=grp_enc, init0=init0, initav=initav, h=h_np,
                  hidx=hidx, hdr_stack=hdr_stack.view(np.int32))
    if nbt > 1:
        fields["grp"] = grp_enc | (signed_mode << 8)
        fields["sw"] = sw_words.T.view(np.int32)
    t = _to_device(fields, dev, keep)
    rec0_t, rec1_t = _transpose_records(rec0, rec1)
    stype_t = state["seg_type"].t().contiguous() if nbt > 1 else None
    pb = PackBatch(
        rec0=rec0_t, rec1=rec1_t, tab=t["tab"], cmap=t["cmap"],
        consts=t["consts"], grp=t["grp"], init0=t["init0"],
        initav=t["initav"], sw=t.get("sw"), stype=stype_t,
        nt=nt, nbt=nbt, pseg=pseg, nseg=nseg,
    )
    return pb, (t["h"], t["hidx"], t["hdr_stack"]), h_np


def _encode_mid(state: dict, lgwin: int, table_groups: int = 1,
                lit_ctx_trees: int = 1, on_stage=None) -> None:
    """Host tables and headers (prepare_pack_pinned), then the pack kernel
    and each lane's word offset in the compact output, all queued (the
    status copy back into pinned memory starts here too)
    (device_encode._encode_mid).  The state keeps the pack kernel's input
    (`pb`) and output (`words`, `status`)."""
    on_stage = on_stage or (lambda name, st: None)
    pb, hdr, h_np = prepare_pack_pinned(state, lgwin, table_groups,
                                        lit_ctx_trees)
    state.update(pb=pb, h_np=h_np, lgwin=lgwin, hdr=hdr)
    on_stage("host tables", state)
    words, status = pack_records(pb)
    state.update(words=words, status=status)
    on_stage("pack", state)
    state.update(counts=_lane_counts(status, hdr[0], state["n_chunks"]))


def _lane_counts(status: torch.Tensor, h: torch.Tensor, n_chunks: int):
    """Each lane's byte count (h*32 + widx*32 + avail + 7) // 8 and its
    word offset in the compact output (a prefix sum of its h + widx +
    (avail + 31) // 32 words; 0 words for lanes past n_chunks and lanes
    whose buffer overflowed), computed on the status's device; the status
    and the counts start back to the host at once: (host (9, B) int64
    tensor, pinned on a card, and the copy's event (None on the CPU),
    word counts, word offsets) as device tensors."""
    st = status.to(_I64)
    h64 = h.to(_I64)
    widx, avail = st[0], st[1]
    lane = torch.arange(st.shape[1], device=st.device)
    sound = (lane < n_chunks) & (st[5] == 0)
    nw = torch.where(sound, h64 + widx + (avail + 31) // 32, 0)
    woff = torch.cumsum(nw, 0) - nw
    meta = torch.cat([st, ((h64 * 32 + widx * 32 + avail + 7) // 8)[None],
                      woff[None], nw[None]])
    if status.device.type != "cuda":
        return meta, None, nw, woff
    host = torch.empty(meta.shape, dtype=_I64, pin_memory=True)
    host.copy_(meta, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(status.device))
    return host, ev, nw, woff


def stream_sizes(state: dict) -> np.ndarray:
    """Compressed bytes per chunk, from the (6, n_lanes) status alone."""
    n_chunks = state["n_chunks"]
    status = state["status"][:2].cpu().numpy().astype(np.int64)
    total_bits = state["h_np"].astype(np.int64) * 32 + status[0] * 32 + status[1]
    return (total_bits[:n_chunks] + 7) // 8


def _old_encode_finish(state: dict) -> list[bytes]:
    """The yardstick's finish, on a state that holds assemble_streams'
    `swords`: fetch the assembled words and cut each lane's bytes; lanes whose
    buffer overflowed are encoded on the host and counted."""
    data = state["data"]
    chunk_size = state["chunk_size"]
    n_chunks = state["n_chunks"]
    h_np = state["h_np"].astype(np.int64)
    status = state["status"].cpu().numpy()
    widx = status[0].astype(np.int64)
    avail = status[1].astype(np.int64)
    ovf = status[5]
    nw = h_np + widx + (avail + 31) // 32
    maxw = int(nw[:n_chunks].max()) if n_chunks else 0
    words = state["swords"][:n_chunks, :maxw].cpu().numpy().view(np.uint32)
    out: list[bytes] = []
    n_fallback = 0
    for s in range(n_chunks):
        if ovf[s]:
            n_fallback += 1
            chunk = data[s * chunk_size: (s + 1) * chunk_size]
            out.append(host_encode(chunk, quality=2, lgwin=state["lgwin"]))
            continue
        nbytes = (int(h_np[s] + widx[s]) * 32 + int(avail[s]) + 7) // 8
        out.append(words[s, : int(nw[s])].tobytes()[:nbytes])
    _note_fallbacks(n_chunks, n_fallback)
    return out


def _assemble_compact(words: torch.Tensor, status: torch.Tensor,
                      h: torch.Tensor, hidx: torch.Tensor,
                      hdr_stack: torch.Tensor, nw: torch.Tensor,
                      woff: torch.Tensor, total: int) -> torch.Tensor:
    """Every lane's stream end to end in one flat int32 tensor of `total`
    words on the device: lane l's nw[l] words from word woff[l] (its h
    header words, row hidx of the distinct-header stack; its widx body
    words; the buffer limbs that hold bits, b0, then b1), so each lane
    starts on a word and holds (h + widx) * 4 + ceil(avail / 8) bytes of
    its stream.  assemble_streams' words, without its (lanes, maxH + rows
    + 2) table.  JAX's assembly is an XLA stage (device_encode.
    _jitted_assemble), so torch ops do it here."""
    dev = words.device
    rows, n = words.shape
    lane = torch.repeat_interleave(torch.arange(n, device=dev), nw,
                                   output_size=total)
    j = torch.arange(total, dtype=_I64, device=dev) - woff[lane]
    hl = h.to(_I64)[lane]
    t = j - hl
    widx = status[0].to(_I64)[lane]
    head = hdr_stack[hidx.long()[lane], j.clamp(0, hdr_stack.shape[1] - 1)]
    body = words.reshape(-1)[t.clamp(0, max(rows - 1, 0)) * n + lane]
    limb = torch.where(t == widx, status[2][lane],
                       torch.where(t == widx + 1, status[3][lane], 0))
    return torch.where(j < hl, head, torch.where(t < widx, body, limb))


def _fetch_compact(flat: torch.Tensor) -> np.ndarray:
    """The compact words as host bytes: one copy into pinned memory and
    one wait on the current stream (none on the CPU)."""
    return _to_host(flat).view(np.uint8)


def _cut_streams(buf: np.ndarray, meta: np.ndarray, n_chunks: int):
    """One `bytes` a sound lane, cut from the host buffer with one copy;
    None where the lane's buffer overflowed.  meta: _lane_counts' rows
    (status, byte counts, word offsets, word counts)."""
    ovf, nbytes, woff = meta[5], meta[6], meta[7]
    out: list[bytes | None] = []
    for s in range(n_chunks):
        if ovf[s]:
            out.append(None)
            continue
        a = 4 * int(woff[s])
        out.append(buf[a: a + int(nbytes[s])].tobytes())
    return out


def _encode_finish(state: dict) -> list[bytes]:
    """Wait for the status and the lanes' counts, write the sound lanes'
    streams end to end on the device (_assemble_compact), fetch them
    through pinned memory and cut a `bytes` a lane; lanes whose buffer
    overflowed are encoded on the host and counted."""
    data = state["data"]
    chunk_size = state["chunk_size"]
    n_chunks = state["n_chunks"]
    host, ev, nw, woff = state["counts"]
    if ev is not None:
        ev.synchronize()
    meta = host.numpy()
    total = int(meta[7][-1] + meta[8][-1])
    flat = _assemble_compact(state["words"], state["status"],
                             *state["hdr"], nw, woff, total)
    out = _cut_streams(_fetch_compact(flat), meta, n_chunks)
    n_fallback = 0
    for s, stream in enumerate(out):
        if stream is None:
            n_fallback += 1
            chunk = data[s * chunk_size: (s + 1) * chunk_size]
            out[s] = host_encode(chunk, quality=2, lgwin=state["lgwin"])
    _note_fallbacks(n_chunks, n_fallback)
    return out


def encode_device_batch(
    data: bytes,
    *,
    device: torch.device | str = "cuda",
    chunk_size: int = CHUNK_N,
    lgwin: int = 22,
    sample_stride: int = 256,
    hash_stride: int = 1,
    max_distance: int | None = None,
    chain_depth: int = 2,
    table_groups: int = 1,
    lit_ctx_trees: int = 1,
    hist_stride: int = _HIST_STRIDE_DEFAULT,
    block_types: int = 1,
    block_seg: int = 2048,
    hash2: bool = False,
    lazy=(105, 175),
    min_gate: int = 9,
    on_stage=None,
) -> list[bytes]:
    """Encode `data` on `device` as up to B_LANES chunk streams.

    The knobs and the streams are those of brotli_tpu's
    `encode_device_batch` (without `interpret`): table_groups > 1 clusters
    lanes into Huffman table groups (decode through preflight_binned);
    lit_ctx_trees > 1 codes literals with context-mapped trees and
    block_types > 1 adds literal block switching (both need the v3 decoder
    or the host decoder).  CPU tensors take the pack kernel's plain
    version; "cuda" launches the kernel, and raises without a card.
    `on_stage(name, state)`, when given, is called as each stage ends
    (upload, matches, parse, records, host tables, pack, assembly) with the
    encode's state; utils/profiling.profile_device_encode times them."""
    dev = resolve_device(device)
    data = bytes(data)
    if not data:
        return [_encode_empty()]
    state = _encode_start(data, dev, chunk_size, hash_stride, sample_stride,
                          max_distance, chain_depth,
                          lit_ctx=lit_ctx_trees > 1, hist_stride=hist_stride,
                          block_types=block_types, block_seg=block_seg,
                          hash2=hash2, lazy=lazy, min_gate=min_gate,
                          on_stage=on_stage)
    _encode_mid(state, lgwin, table_groups, lit_ctx_trees, on_stage)
    streams = _encode_finish(state)
    if on_stage is not None:
        on_stage("assembly", state)
    return streams
