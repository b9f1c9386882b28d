"""v2 entropy decode and the device decode round trip.  Counterpart of
brotli_tpu/ops/pallas_decode2.py.

The host half is the port's copy of the reference's (ops/preflight2.py):
`preflight_shared` / `preflight_binned` stage a batch of same-table streams
into a `SharedBatch` (numpy), exactly as for the JAX kernel.
`batch_to_torch` turns that staging into the port's tensors, and the device
half runs two kernels:

1. `entropy_decode` (csrc/decode2.cu `decode2_kernel`): bits -> v2
   tokens, one thread a stream and a few streams a warp, the group's tables
   in shared memory, each stream's words through a look-ahead queue
   (`entropy_decode_direct` launches the first form of the kernel, one
   stream a thread in blocks of 128, kept beside it for comparison);
2. `resolve_tokens` (ops/resolve.py, csrc/resolve.cu): tokens -> bytes.

`decode_batch_device_e2e` drives both and re-decodes on the host any lane
the kernels flag, counting it in `fallback_stats()`.

Layout: lane l = g*1024 + s is stream slot s of group g, the order of the
reference's (G*8, 128) rows flattened.  Words and tokens are int32 tensors
holding u32 bit patterns (PyTorch's uint32 has no shifts or gathers):
wt is (Wpad, n_lanes) word-major; tokens are (cap, n_lanes) token-major
with count[l] valid tokens per lane and no PAD tokens in between.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..decode import decode as host_decode
from ..device import resolve_device
from .preflight2 import (
    CMD,
    CMD_K,
    CP_EX,
    DIST,
    DIST2,
    DIST_EX,
    DIST_K,
    DONE,
    DX_K,
    ERR,
    INIT,
    INS_EX,
    LIT,
    LIT_K,
    NSTREAM,
    TAG_COPY,
    TAG_DIST,
    TAG_FUSED,
    SharedBatch,
    lane_overran,
    preflight_binned,
    preflight_shared,
)
from .resolve import resolve_tokens, unpack_resolved

# Launches of the CUDA kernels, counted by the wrappers where they launch:
# decode2_kernel (the main path's) and decode2_direct_kernel.
KERNEL_LAUNCHES = 0
DIRECT_LAUNCHES = 0

# The port's own cap on the groups of 1024 streams one batch stages, set
# from an H100 sweep of the kernels at 12, 16, 24 and 32 groups (PERF.md);
# MAX_GROUPS (ops/preflight2.py) is the reference's v5e figure.
GROUP_CAP = 32

# warps the lane map aims to put on each SM (ops/decode3.py shares it)
WARPS_PER_SM = 12

DX_N = DX_K * 128   # packed distance LUT, 544 entries used
CONSTS_N = 128      # length and short-distance LUT, SharedBatch.consts' row

_M32 = 0xFFFFFFFF


@dataclass
class TorchBatch:
    """A SharedBatch as the port's tensors, all on one device."""

    wt: torch.Tensor         # (Wpad, n_lanes) int32: u32 words, word-major
    lit: torch.Tensor        # (G, lit_k*128) int32 per-group tables
    cmd: torch.Tensor        # (G, cmd_k*128)
    dist: torch.Tensor       # (G, dist_k*128)
    dx: torch.Tensor         # (640,) int32 (extra<<26)|offset
    consts: torch.Tensor     # (128,) int32: ins/copy/short-distance LUT
    start_bit: torch.Tensor  # (n_lanes,) int32
    mlen: torch.Tensor       # (n_lanes,) int32, 0 for pad lanes
    groups: int
    lit_k: int
    cmd_k: int
    dist_k: int
    npostfix: int
    ndirect: int
    maxbw: int
    max_mlen: int
    cap: int                 # token slots per lane

    @property
    def n_lanes(self) -> int:
        return self.groups * NSTREAM

    @property
    def wpad(self) -> int:
        return self.wt.shape[0]

    @property
    def device(self) -> torch.device:
        return self.wt.device


def _unreplicate(table: np.ndarray, k: int, groups: int) -> np.ndarray:
    """(groups*k*8, 128) lane-gather layout -> (groups, k*128) flat tables
    (each 128-entry chunk is replicated over its 8 sublanes)."""
    t = np.asarray(table, np.int32).reshape(groups, k, 8, 128)[:, :, 0, :]
    return np.ascontiguousarray(t.reshape(groups, k * 128))


def batch_to_torch(batch: SharedBatch, device: torch.device | str) -> TorchBatch:
    """The JAX package's staged inputs (numpy) as the port's tensors.

    Tables lose the TPU's sublane replication; the word table keeps its
    word-major order, which is coalesced on the GPU; start bits and decoded
    sizes come out of the `scal` rows; the length and short-distance LUT
    is one row of `consts`."""
    dev = resolve_device(device)
    G = batch.groups
    n = G * NSTREAM
    scal = np.asarray(batch.scal, np.int32).reshape(G, 2, NSTREAM)
    max_mlen = int(batch.mlens.max()) if batch.mlens.size else 0
    dx = np.asarray(batch.dx_t, np.int32).reshape(-1, 8, 128)[:, 0, :].reshape(-1)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return TorchBatch(
        wt=put(np.asarray(batch.wt).reshape(batch.Wpad, n).view(np.int32)),
        lit=put(_unreplicate(batch.lit_t, batch.lit_k, G)),
        cmd=put(_unreplicate(batch.cmd_t, batch.cmd_k, G)),
        dist=put(_unreplicate(batch.dist_t, batch.dist_k, G)),
        dx=put(dx[:DX_N]),
        consts=put(np.asarray(batch.consts, np.int32)[0]),
        start_bit=put(scal[:, 0].reshape(n)),
        mlen=put(scal[:, 1].reshape(n)),
        groups=G, lit_k=batch.lit_k, cmd_k=batch.cmd_k, dist_k=batch.dist_k,
        npostfix=batch.npostfix, ndirect=batch.ndirect, maxbw=batch.maxbw,
        max_mlen=max_mlen,
        # every token emits >= 1 byte and a tag-1/tag-2 pair >= 2, so an
        # honest lane never needs more than mlen slots
        cap=max_mlen + 4,
    )


def _check_batch(tb: TorchBatch) -> None:
    n = tb.n_lanes
    shapes = {
        "wt": (tb.wt, (tb.wpad, n)),
        "lit": (tb.lit, (tb.groups, tb.lit_k * 128)),
        "cmd": (tb.cmd, (tb.groups, tb.cmd_k * 128)),
        "dist": (tb.dist, (tb.groups, tb.dist_k * 128)),
        "dx": (tb.dx, (DX_N,)),
        "consts": (tb.consts, (CONSTS_N,)),
        "start_bit": (tb.start_bit, (n,)),
        "mlen": (tb.mlen, (n,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape or t.dtype != torch.int32:
            raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tb.device:
            raise ValueError(f"{name} is on {t.device}, wt on {tb.device}")
    for name, k, top in (("lit_k", tb.lit_k, LIT_K), ("cmd_k", tb.cmd_k, CMD_K),
                         ("dist_k", tb.dist_k, DIST_K)):
        if not 2 <= k <= top:
            raise ValueError(f"{name}={k} outside [2, {top}]")
    if tb.cap < 1 or tb.wpad < 1:
        raise ValueError("cap and Wpad must be >= 1")


def _alloc_outputs(tb: TorchBatch):
    n, dev = tb.n_lanes, tb.device
    tok = torch.zeros((tb.cap, n), dtype=torch.int32, device=dev)
    count = torch.empty((n,), dtype=torch.int32, device=dev)
    phase = torch.empty((n,), dtype=torch.int32, device=dev)
    widx = torch.empty((n,), dtype=torch.int32, device=dev)
    return tok, count, phase, widx


def _c_args(tb: TorchBatch, outs) -> list:
    """The argument list of brotli_torch_decode2 (and its host shim)."""
    ins = (tb.wt, tb.lit, tb.cmd, tb.dist, tb.dx, tb.consts, tb.start_bit,
           tb.mlen)
    return ([t.data_ptr() for t in (*ins, *outs)]
            + [tb.n_lanes, tb.wpad, tb.cap, tb.npostfix, tb.ndirect,
               tb.maxbw, tb.lit_k, tb.cmd_k, tb.dist_k])


def lanes_per_warp(n_lanes: int, sms: int) -> int:
    """Lanes a warp of the queued / windowed kernels: the power of two (at
    most 32) that puts about WARPS_PER_SM warps of lanes on each of `sms`
    SMs, so a warp serializes the phases of few lanes while every SM holds
    enough warps to hide a row's latencies (the sweep in
    tools/decode_causes.py)."""
    want = max(1, -(-n_lanes // (sms * WARPS_PER_SM)))
    return min(32, 1 << (want - 1).bit_length())


def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _launch(tb: TorchBatch, entry: str, extra: list, what: str):
    """Launch `entry` of the CUDA library on the batch; the outputs."""
    from ..build import kernels_lib

    outs = _alloc_outputs(tb)
    with torch.cuda.device(tb.device):
        rc = getattr(kernels_lib(), entry)(
            *_c_args(tb, outs), *extra,
            torch.cuda.current_stream(tb.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    return outs


def _on_card(tb: TorchBatch) -> bool:
    """False for CPU tensors (which take the plain version); raises on a
    device that is neither."""
    _check_batch(tb)
    if tb.device.type == "cpu":
        return False
    if tb.device.type != "cuda":
        raise ValueError(f"unsupported device {tb.device}")
    return True


def entropy_decode(tb: TorchBatch):
    """Decode every lane's bits into v2 tokens.

    Returns (tok (cap, n_lanes) int32, count, phase, widx (n_lanes,) int32)
    on the batch's device.  CPU tensors take entropy_decode_ref; CUDA
    tensors launch csrc/decode2.cu `decode2_kernel` at lanes_per_warp
    lanes a warp for the batch and the card.
    """
    global KERNEL_LAUNCHES
    if not _on_card(tb):
        return entropy_decode_ref(tb)
    lanes = lanes_per_warp(tb.n_lanes, sm_count(tb.device))
    outs = _launch(tb, "brotli_torch_decode2", [lanes], "entropy kernel")
    KERNEL_LAUNCHES += 1
    return outs


def entropy_decode_direct(tb: TorchBatch):
    """entropy_decode through decode2_direct_kernel (one lane a thread,
    blocks of 128, each word loaded when the row rule asks for it); CPU
    tensors take entropy_decode_ref."""
    global DIRECT_LAUNCHES
    if not _on_card(tb):
        return entropy_decode_ref(tb)
    outs = _launch(tb, "brotli_torch_decode2_direct", [],
                   "direct entropy kernel")
    DIRECT_LAUNCHES += 1
    return outs


def entropy_decode_host(tb: TorchBatch, lanes: int = 4, direct: bool = False):
    """csrc/decode2.cuh's per-lane code built for the CPU (build.host_lib):
    the queued kernel's (`lanes` is checked as the kernel checks it), or
    with `direct` the direct kernel's.  For the tests, which hold it
    against entropy_decode_ref."""
    from ..build import host_lib

    _check_batch(tb)
    if tb.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    outs = _alloc_outputs(tb)
    lib = host_lib()
    rc = (lib.brotli_torch_decode2_direct_host(*_c_args(tb, outs)) if direct
          else lib.brotli_torch_decode2_host(*_c_args(tb, outs), lanes))
    if rc != 0:
        raise ValueError("host shim refused the batch")
    return outs


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> its int32 two's-complement value (XLA's wrapping)."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def entropy_decode_ref(tb: TorchBatch):
    """Plain PyTorch version of entropy_decode, on the batch's device.

    The per-lane machine of csrc/decode2.cuh vectorised over lanes: one loop
    iteration is one row (refill, then one phase step) for every live lane,
    with torch.where for the phase select and indexing into the flat
    tables.  Bit buffers are int64 tensors holding u32 values.
    """
    _check_batch(tb)
    dev = tb.device
    n = tb.n_lanes
    cap = tb.cap
    i64 = torch.int64

    def ten(x):
        return torch.as_tensor(x, dtype=i64, device=dev)

    lane = torch.arange(n, dtype=i64, device=dev)
    grp = lane // NSTREAM
    wt = tb.wt.reshape(-1).to(i64) & _M32
    lit, cmd, dist = (t.reshape(-1).to(i64) for t in (tb.lit, tb.cmd, tb.dist))
    lit_base = grp * (tb.lit_k * 128)
    cmd_base = grp * (tb.cmd_k * 128)
    dist_base = grp * (tb.dist_k * 128)
    dx = tb.dx.to(i64)
    consts = tb.consts.to(i64)
    start_bit = tb.start_bit.to(i64)
    mlen = tb.mlen.to(i64)
    budget = 8 * mlen + 4 * tb.wpad + 64
    zero = torch.zeros(n, dtype=i64, device=dev)

    def lookup(flat, base, k, idx):
        ok = (idx >= 0) & (idx < k * 128)
        return torch.where(ok, flat[base + idx.clamp(0, k * 128 - 1)], 0)

    def read_symbol(flat, base, k, v15):
        root = v15 & 0xFF
        e0 = flat[base + root]
        bits0 = e0 >> 16
        need_sub = bits0 > 8
        sub_mask = (1 << bits0.clamp(0, 15)) - 1
        idx2 = root + (e0 & 0xFFFF) + ((v15 & sub_mask) >> 8)
        e1 = lookup(flat, base, k, torch.where(need_sub, idx2, 0))
        sym = torch.where(need_sub, e1 & 0xFFFF, e0 & 0xFFFF)
        nb = torch.where(need_sub, (e1 >> 16) + 8, bits0)
        return sym, nb

    def low_mask(nbits):
        return (1 << (nbits & 31)) - 1

    phase = torch.where(mlen > 0, INIT, DONE).to(i64)
    widx, avail, count = zero.clone(), zero.clone(), zero.clone()
    b0, b1, b2 = zero.clone(), zero.clone(), zero.clone()
    mbl = mlen.clone()
    lit_rem, copy_len, ins_code, cp_code = (zero.clone() for _ in range(4))
    implicit, dcode, dist_save = zero.clone(), zero.clone(), zero.clone()
    r0, r1, r2, r3 = (torch.full((n,), v, dtype=i64, device=dev)
                      for v in (4, 11, 15, 16))
    tok = torch.zeros((cap + 1) * n, dtype=torch.int32, device=dev)
    dummy = cap * n + lane  # row `cap` absorbs the writes of silent lanes

    row = 0
    while True:
        live = (phase < DONE) & (row < budget)
        # ---- refill: one word when avail <= 64 ----
        need = live & (avail <= 64) & (widx < tb.wpad)
        acc = wt[widx.clamp(0, tb.wpad - 1) * n + lane]
        sh = avail & 31
        limb = avail >> 5
        lo = torch.where(need, (acc << sh) & _M32, 0)
        hi = torch.where(need & (sh > 0), acc >> ((32 - sh) & 31), 0)
        b0 = b0 | torch.where(limb == 0, lo, 0)
        b1 = b1 | torch.where(limb == 0, hi, torch.where(limb == 1, lo, 0))
        b2 = b2 | torch.where(limb == 1, hi, torch.where(limb == 2, lo, 0))
        avail = avail + torch.where(need, 32, 0)
        widx = widx + need.to(i64)
        run = live & ((avail >= 65) | ((phase == INIT) & (avail >= 32)))
        # a lane that neither refills nor runs never changes again
        if row % 16 == 0 and not bool((need | run).any()):
            break
        row += 1

        p0 = phase
        q = zero
        token = zero

        def pk(q):
            l0 = (q >> 5) == 0
            w0 = torch.where(l0, b0, b1)
            w1 = torch.where(l0, b1, b2)
            m = q & 31
            return ((w0 >> m) | torch.where(m == 0, 0, (w1 << (32 - m)) & _M32)) & _M32

        # ---- INIT: discard the sub-word start offset ----
        m = run & (p0 == INIT)
        q = q + torch.where(m, start_bit, 0)
        phase = torch.where(m, CMD, phase)

        # ---- CMD: command symbol + the extras that fit ----
        m = run & (p0 == CMD)
        sym, nb = read_symbol(cmd, cmd_base, tb.cmd_k, pk(q) & 0x7FFF)
        cell = sym >> 6
        ridx = torch.where(cell < 2, cell, cell - 2)
        sh2 = 2 * ridx
        ins_high = torch.where(sh2 < 32, 0x29850 >> sh2.clamp(0, 31), 0) & 3
        cp_high = torch.where(sh2 < 32, 0x26244 >> sh2.clamp(0, 31), 0) & 3
        ins_code = torch.where(m, ins_high * 8 + ((sym >> 3) & 7), ins_code)
        cp_code = torch.where(m, cp_high * 8 + (sym & 7), cp_code)
        implicit = torch.where(m, (cell < 2).to(i64), implicit)
        ins_pack = consts[ins_code & 127]
        cp_pack = consts[(cp_code + 64) & 127]
        nb_i, off_i = ins_pack >> 20, ins_pack & 0xFFFFF
        nb_c, off_c = cp_pack >> 20, cp_pack & 0xFFFFF
        q = q + torch.where(m, nb, 0)
        can_i = m & (q + nb_i <= 32)
        iv = pk(q) & 0xFFFFFF & low_mask(nb_i)
        lit_rem = torch.where(can_i, off_i + iv, lit_rem)
        q = q + torch.where(can_i, nb_i, 0)
        can_c = can_i & (q + nb_c <= 32)
        cv = pk(q) & 0xFFFFFF & low_mask(nb_c)
        copy_len = torch.where(can_c, off_c + cv, copy_len)
        q = q + torch.where(can_c, nb_c, 0)
        nxt = torch.where(~can_i, INS_EX, torch.where(
            ~can_c, CP_EX, torch.where(lit_rem > 0, LIT, DIST)))
        phase = torch.where(m, nxt, phase)

        # ---- INS_EX: spilled insert extra bits (+ copy if it fits) ----
        m = run & (p0 == INS_EX)
        iv = pk(q) & 0xFFFFFF & low_mask(nb_i)
        lit_rem = torch.where(m, off_i + iv, lit_rem)
        q = q + torch.where(m, nb_i, 0)
        can_c = m & (q + nb_c <= 32)
        cv = pk(q) & 0xFFFFFF & low_mask(nb_c)
        copy_len = torch.where(can_c, off_c + cv, copy_len)
        q = q + torch.where(can_c, nb_c, 0)
        nxt = torch.where(~can_c, CP_EX, torch.where(lit_rem > 0, LIT, DIST))
        phase = torch.where(m, nxt, phase)

        # ---- CP_EX: spilled copy extra bits ----
        m = run & (p0 == CP_EX)
        cv = pk(q) & 0xFFFFFF & low_mask(nb_c)
        copy_len = torch.where(m, off_c + cv, copy_len)
        q = q + torch.where(m, nb_c, 0)
        phase = torch.where(m, torch.where(lit_rem > 0, LIT, DIST), phase)

        # ---- LIT: one literal, two iff lit_rem >= 2 and mbl >= 2 ----
        m = run & (p0 == LIT)
        sym0, nb0 = read_symbol(lit, lit_base, tb.lit_k, pk(q) & 0x7FFF)
        q = q + torch.where(m, nb0, 0)
        have2 = m & (lit_rem >= 2) & (mbl >= 2)
        sym1, nb1 = read_symbol(lit, lit_base, tb.lit_k, pk(q) & 0x7FFF)
        q = q + torch.where(have2, nb1, 0)
        took = torch.where(m, 1 + have2.to(i64), 0)
        tok_lit = (sym0 | torch.where(have2, sym1 << 8, 0) | (took << 24)) & _M32
        token = torch.where(m, tok_lit, token)
        lit_rem = lit_rem - took
        mbl = mbl - took
        phase = torch.where(m & (mbl <= 0), DONE,
                            torch.where(m & (lit_rem <= 0), DIST, phase))

        # ---- DIST: distance symbol + extra bits when they fit ----
        m = run & (p0 == DIST)
        m2 = run & (p0 == DIST_EX)
        is_imp = implicit == 1
        m_read = m & ~is_imp
        sym, nb = read_symbol(dist, dist_base, tb.dist_k, pk(q) & 0x7FFF)
        q = q + torch.where(m_read, nb, 0)
        dcode = torch.where(m_read, sym, torch.where(m, -1, dcode))
        is_short = (dcode >= 0) & (dcode < 16)
        is_direct = (dcode >= 16) & (dcode < 16 + tb.ndirect)
        is_long = dcode >= 16 + tb.ndirect
        sp = consts[dcode.clamp(0, 15) + 96]
        k_idx = sp >> 4
        ring = torch.where(k_idx == 0, r0, torch.where(
            k_idx == 1, r1, torch.where(k_idx == 2, r2, r3)))
        short_dist = _wrap32(ring + (sp & 15) - 3)
        dxp = dx[dcode.clamp(0, DX_N - 1)]
        nbx, offx = dxp >> 26, dxp & 0x3FFFFFF
        can_x = m & is_long & (q + nbx <= 32)
        xv = pk(q) & 0xFFFFFF & low_mask(nbx)
        q = q + torch.where(can_x, nbx, 0)
        long_dist = _wrap32(offx + ((xv << tb.npostfix) & _M32))
        distance = torch.where(is_imp, r0, torch.where(
            is_short, short_dist, torch.where(is_direct, dcode - 15, long_dist)))
        spill = m & is_long & ~can_x
        m_fin = m & ~spill
        phase = torch.where(spill, DIST_EX, phase)

        # ---- DIST_EX: spilled distance extra bits (same dx entry) ----
        q = q + torch.where(m2, nbx, 0)
        distance = torch.where(m2, long_dist, distance)
        m_fin = m_fin | m2

        # ---- finalize a completed distance ----
        pos = mlen - mbl
        max_dist = torch.clamp(pos, max=tb.maxbw)
        bad = m_fin & ((distance < 1) | (distance > max_dist) | (copy_len > mbl))
        ok = m_fin & ~bad
        push = ok & ~is_imp & (dcode > 0)
        r3 = torch.where(push, r2, r3)
        r2 = torch.where(push, r1, r2)
        r1 = torch.where(push, r0, r1)
        r0 = torch.where(push, distance, r0)
        fusable = ok & (copy_len <= 255) & (distance <= 0x3FFFFF)
        tok_fused = (TAG_FUSED | (copy_len << 22) | distance) & _M32
        tok_copy = (TAG_COPY | copy_len) & _M32
        token = torch.where(fusable, tok_fused, torch.where(ok, tok_copy, token))
        dist_save = torch.where(ok & ~fusable, distance, dist_save)
        mbl = torch.where(fusable, mbl - copy_len, mbl)
        phase = torch.where(bad, ERR, torch.where(
            fusable, torch.where(mbl <= 0, DONE, CMD),
            torch.where(ok, DIST2, phase)))

        # ---- DIST2: long-form distance token ----
        m = run & (p0 == DIST2)
        token = torch.where(m, (TAG_DIST | dist_save) & _M32, token)
        mbl = torch.where(m, mbl - copy_len, mbl)
        phase = torch.where(m, torch.where(mbl <= 0, DONE, CMD), phase)

        # ---- consume q bits ----
        hi_l = (q >> 5) >= 1
        c0 = torch.where(hi_l, b1, b0)
        c1 = torch.where(hi_l, b2, b1)
        c2 = torch.where(hi_l, 0, b2)
        mq = q & 31
        nz = mq != 0
        b0 = ((c0 >> mq) | torch.where(nz, (c1 << (32 - mq)) & _M32, 0)) & _M32
        b1 = ((c1 >> mq) | torch.where(nz, (c2 << (32 - mq)) & _M32, 0)) & _M32
        b2 = c2 >> mq
        avail = avail - q

        # ---- token out (an honest lane never fills its cap) ----
        emit = token != 0
        full = emit & (count >= cap)
        phase = torch.where(full, ERR, phase)
        wrote = emit & ~full
        tok[torch.where(wrote, count * n + lane, dummy)] = \
            _wrap32(token).to(torch.int32)
        count = count + wrote.to(i64)

    tok = tok[: cap * n].reshape(cap, n)
    return (tok, count.to(torch.int32), phase.to(torch.int32),
            widx.to(torch.int32))


def tokens_from_jax(tokens: np.ndarray, used_rows: int | None = None,
                    cap: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX kernel's (R, G*8, 128) u32 token rows as the port's compact
    per-lane form: (tok (cap, n_lanes) int32, count (n_lanes,) int32), CPU.

    Which row a token sits on is a lockstep artifact of the TPU kernel, so
    the PAD zeros between a lane's tokens are dropped.  Rows from
    `used_rows` on (past the kernel's exit block) are ignored."""
    t = np.asarray(tokens, np.uint32)
    t = t[: t.shape[0] if used_rows is None else used_rows]
    t = t.reshape(t.shape[0], -1)
    nz = t != 0
    count = nz.sum(axis=0)
    order = np.argsort(~nz, axis=0, kind="stable")  # tokens first, in order
    compact = np.take_along_axis(t, order, axis=0)
    if cap is None:
        cap = max(1, int(count.max()) if count.size else 1)
    out = np.zeros((cap, t.shape[1]), np.uint32)
    rows = min(cap, compact.shape[0])
    out[:rows] = compact[:rows]
    return (torch.from_numpy(out.view(np.int32)),
            torch.from_numpy(count.astype(np.int32)))


def run_batch(batch: SharedBatch, device: torch.device | str,
              with_widx: bool = False):
    """Run the entropy kernel on `device` (counterpart of the reference's
    run_batch).  Returns (tokens (cap, n_lanes), counts, phases) as device
    tensors and, with `with_widx`, the per-lane words consumed too."""
    tb = batch_to_torch(batch, device)
    tok, count, phase, widx = entropy_decode(tb)
    if with_widx:
        return tok, count, phase, widx
    return tok, count, phase


def run_batch_e2e(batch: SharedBatch, device: torch.device | str):
    """Entropy kernel + LZ resolve on `device`, the tokens never leaving it.

    Returns (resolved (n_lanes, max_mlen) uint8 device tensor, err flags
    (n_lanes,) device tensor, phases (n_lanes,) host array).  Lanes that
    read past their own words (a truncated stream decoding zero padding)
    get phase 0xFFFF, so no caller takes their bytes."""
    tb = batch_to_torch(batch, device)
    tok, count, phase, widx = entropy_decode(tb)
    resolved, err = resolve_tokens(tok, count, tb.mlen, tb.max_mlen)
    return resolved, err, host_phases(batch, phase, widx)


def host_phases(batch: SharedBatch, phase: torch.Tensor,
                widx: torch.Tensor) -> np.ndarray:
    """The entropy kernel's end phase per lane, fetched to the host, with
    0xFFFF for lanes that read past their own words."""
    phases = phase.cpu().numpy()
    return np.where(lane_overran(batch, widx.cpu().numpy()), 0xFFFF, phases)


# Lanes that leave the kernels flagged are re-decoded on the host: a large
# performance cliff that has to be visible.
_FALLBACK_STATS = {"batches": 0, "lanes_total": 0, "lanes_fallback": 0}


def fallback_stats() -> dict:
    """Counters of lanes that degraded to host decode."""
    return dict(_FALLBACK_STATS)


def _note_fallbacks(n_lanes: int, n_fallback: int) -> None:
    _FALLBACK_STATS["batches"] += 1
    _FALLBACK_STATS["lanes_total"] += n_lanes
    _FALLBACK_STATS["lanes_fallback"] += n_fallback
    if n_fallback:
        logging.getLogger("brotli_tpu_torch").warning(
            "device decode: %d/%d lanes fell back to host decode",
            n_fallback, n_lanes,
        )


def stage_v2(streams: list[bytes], groups: int | None = None
             ) -> SharedBatch | None:
    """The batch of the v2 kernels for `streams`: preflight_shared
    (rate-sorted, `groups` groups of 1024, GROUP_CAP at most by default),
    else preflight_binned's bins (at most GROUP_CAP groups); None when
    neither accepts the streams."""
    if groups is None:
        groups = min(GROUP_CAP, -(-len(streams) // NSTREAM))
    batch = preflight_shared(streams, groups=groups, rate_sort=True)
    if batch is None:
        binned = preflight_binned(streams, max_groups=GROUP_CAP)
        if binned is not None:
            batch = binned[0]
    return batch


def collect_lanes(batch: SharedBatch, streams: list[bytes],
                  phases: np.ndarray, resolved: torch.Tensor,
                  err: torch.Tensor) -> list[bytes]:
    """Each stream's bytes from a finished batch, in stream order: a lane
    that ends in a phase other than DONE or carries resolve flags is
    re-decoded on the host.  Every such lane counts in fallback_stats()."""
    outs, errs = unpack_resolved(resolved, err, batch.mlens)
    results: list[bytes | None] = [None] * batch.n_streams
    n_fallback = 0
    for slot in range(NSTREAM * batch.groups):
        i = slot if batch.perm is None else int(batch.perm[slot])
        if i < 0 or i >= batch.n_streams:
            continue
        if phases[slot] != DONE or errs[slot] != 0:
            n_fallback += 1
            results[i] = host_decode(streams[i])
        else:
            results[i] = outs[slot]
    _note_fallbacks(batch.n_streams, n_fallback)
    return results  # type: ignore[return-value]


def decode_batch_device_e2e(streams: list[bytes], *,
                            device: torch.device | str = "cuda",
                            groups: int | None = None) -> list[bytes]:
    """Decode a batch of shared-table streams with both phases on `device`.

    Same-table streams (encode_sharded output) stage through
    preflight_shared (rate-sorted), per-group tables through
    preflight_binned (stage_v2).  Lanes that end in a phase other than
    DONE, read past their own words, or carry resolve flags are re-decoded
    by the host decoder; a batch neither preflight accepts (more streams
    than `groups` groups hold, GROUP_CAP groups by default; more than
    GROUP_CAP groups of bins) is host-decoded whole.  Every such lane
    counts in fallback_stats().
    """
    dev = resolve_device(device)
    batch = stage_v2(streams, groups)
    if batch is None:
        _note_fallbacks(len(streams), len(streams))
        return [host_decode(s) for s in streams]
    resolved, err, phases = run_batch_e2e(batch, dev)
    return collect_lanes(batch, streams, phases, resolved, err)


def decode_batch_pallas2(streams: list[bytes], *,
                         device: torch.device | str = "cuda",
                         groups: int | None = None) -> list[bytes]:
    """The counterpart of pallas_decode2.decode_batch_pallas2, the v2
    driver the reference's multi-device decode gives a group that
    preflight_shared refuses.  The reference resolves its tokens with the
    host C++ resolver; here both phases run on the device through the
    port's kernels, so this is decode_batch_device_e2e: preflight_shared,
    then preflight_binned, then the host decoder for the whole batch,
    every host-decoded lane counted in fallback_stats()."""
    return decode_batch_device_e2e(streams, device=device, groups=groups)
