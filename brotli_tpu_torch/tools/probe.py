"""Structure probes: what the v2 entropy row's operations, and the kernel
structure around a row, cost on the card, in ns per row.

Counterparts of the two TPU probes, which hunted a 14 us row on the TPU:

* `probe_v2` (tools/probe_v2.py): one (8, 128) tile over ROWS rows in
  BLOCKS blocks, five cumulative levels of the row (elementwise; four
  variable-shift peeks; the limb consume; a staging store; a lane gather);
* `probe_v2b` (tools/probe_v2b.py): a trivial row over 4 or 18 carries
  inside the kernel structure of v2: a fori or while outer loop,
  reductions over the tile, a 32-row refill into a 64-row window, a flush
  of the 32-row staging after each block.

Each wrapper launches csrc/probe.cu on CUDA tensors and takes its plain
PyTorch version (`probe_v2_ref`, `probe_v2b_ref`) on CPU tensors; the
`_host` forms run csrc/probe.cuh built by g++, for the tests.  The CUDA
kernel splits the tile's 1024 lanes over 8 blocks of 128 threads, one tile
row each, so probe_v2b's reductions span one tile row; the plain version
reduces per tile row too (the TPU kernel reduces over the whole tile; the
two differ only if a whole tile row of carry[0] is 0xFFFFFFFF).

`run_probe_v2(level, device)` and `run_probe_v2b(variant, device)` make the
inputs from seed 0, run the probe and, on the card, time it with CUDA
events.  Nothing runs when this module is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.benchmarks import time_device_fn

# Launches of each CUDA kernel, counted by its wrapper where it launches.
PROBE_V2_LAUNCHES = 0
PROBE_V2B_LAUNCHES = 0

SUB, LANES = 8, 128
TILE = (SUB, LANES)
V2_ROWS, V2_BLOCKS = 2048, 8        # tools/probe_v2.py
V2B_ROWS, V2B_BLOCKS = 2048, 64     # tools/probe_v2b.py
WT_ROWS = 1024                      # probe_v2b's word table rows
WIN, REFILL, FILL_CAP = 64, 32, 960

# the TPU scripts' labels, in their order
V2_LEVELS = (
    ("L1 elementwise only", 1),
    ("L2 + 4x variable-shift peeks", 2),
    ("L3 + limb consume", 3),
    ("L4 + dynamic staging store", 4),
    ("L5 + lane gather", 5),
)
V2B_VARIANTS = (
    ("fori outer, 4 carry", dict(ncarry=4)),
    ("fori outer, 18 carry", dict(ncarry=18)),
    ("while outer, 18 carry", dict(ncarry=18, while_outer=True)),
    ("while + reduces, 18 carry",
     dict(ncarry=18, while_outer=True, reduces=True)),
    ("while + reduces + dma_in",
     dict(ncarry=18, while_outer=True, reduces=True, dma_in=True)),
    ("while + reduces + dma_in + dma_out (full)",
     dict(ncarry=18, while_outer=True, reduces=True, dma_in=True,
          dma_out=True)),
)

_M32 = 0xFFFFFFFF


def probe_inputs(seed: int = 0):
    """The probes' inputs from `seed` (numpy, as the TPU scripts draw
    them): the (8, 128) int32 tile in [0, 2**30) and the (1024, 8, 128)
    word table, as int32 holding u32 bit patterns."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 30, TILE).astype(np.int32)
    wt = rng.integers(0, 1 << 30, (WT_ROWS, *TILE)).astype(np.int32)
    return a, wt


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding u32 -> int32 with the same bits."""
    return (((x & _M32) + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def _check(t: torch.Tensor, name: str, shape: tuple) -> None:
    if tuple(t.shape) != shape or t.dtype != torch.int32:
        raise ValueError(f"{name}: want int32 {shape}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_v2(a, level, rows) -> int:
    _check(a, "a", TILE)
    if level not in (1, 2, 3, 4, 5):
        raise ValueError(f"level {level} outside 1..5")
    if rows < V2_BLOCKS or rows % V2_BLOCKS:
        raise ValueError(f"rows={rows} must be a positive multiple of "
                         f"{V2_BLOCKS} blocks")
    return rows // V2_BLOCKS


def _v2_outputs(a: torch.Tensor, level: int, block_rows: int):
    carry = torch.empty((4, *TILE), dtype=torch.int32, device=a.device)
    # every row of staging is written at level >= 4, none below
    alloc = torch.empty if level >= 4 else torch.zeros
    staging = alloc((block_rows, *TILE), dtype=torch.int32, device=a.device)
    return carry, staging


def probe_v2(a: torch.Tensor, level: int, rows: int = V2_ROWS):
    """Run probe_v2 at `level` on the (8, 128) int32 tile `a`.

    Returns (carry (4, 8, 128) int32: b0, b1, b2 and q after the last row;
    staging (rows // V2_BLOCKS, 8, 128) int32: b0 of each row of the last
    block, written at level >= 4, zeros below).  CPU tensors take
    probe_v2_ref; CUDA tensors launch csrc/probe.cu."""
    global PROBE_V2_LAUNCHES
    block_rows = _check_v2(a, level, rows)
    if a.device.type == "cpu":
        return probe_v2_ref(a, level, rows)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    from ..build import kernels_lib

    carry, staging = _v2_outputs(a, level, block_rows)
    with torch.cuda.device(a.device):
        rc = kernels_lib().brotli_torch_probe_v2(
            a.data_ptr(), carry.data_ptr(), staging.data_ptr(), level,
            V2_BLOCKS, block_rows,
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_v2 launch failed: cudaError {rc}")
    PROBE_V2_LAUNCHES += 1
    return carry, staging


def probe_v2_host(a: torch.Tensor, level: int, rows: int = V2_ROWS):
    """csrc/probe.cuh's probe_v2 built for the CPU (build.host_lib), for
    the tests."""
    from ..build import host_lib

    block_rows = _check_v2(a, level, rows)
    if a.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    carry, staging = _v2_outputs(a, level, block_rows)
    if host_lib().brotli_torch_probe_v2_host(
            a.data_ptr(), carry.data_ptr(), staging.data_ptr(), level,
            V2_BLOCKS, block_rows) != 0:
        raise ValueError("host shim refused the probe")
    return carry, staging


def _funnel(lo, hi, m):
    """32 bits of (hi:lo) from bit m in [0, 31] (u32 values in int64)."""
    return torch.where(m == 0, lo, ((lo >> m) | (hi << (32 - m))) & _M32)


def probe_v2_ref(a: torch.Tensor, level: int, rows: int = V2_ROWS):
    """Plain PyTorch version of probe_v2 on `a`'s device: the TPU kernel's
    row as whole-tile tensor ops, u32 values held in int64."""
    block_rows = _check_v2(a, level, rows)
    i64 = torch.int64
    arow = a.to(i64) & _M32
    b0 = arow.clone()
    b1 = (arow + 1) & _M32
    b2 = (arow + 2) & _M32
    q = torch.zeros(TILE, dtype=i64, device=a.device)
    staging = torch.zeros((block_rows, *TILE), dtype=i64, device=a.device)
    for r in range(rows):
        b0 = b0 ^ ((b1 + 12345) & _M32)
        q = (q + 7) & 31
        if level >= 2:
            for _ in range(4):
                q = q + (_funnel(b0, b1, q & 31) & 7)
        if level >= 3:
            hi = (q >> 5) >= 1
            c0 = torch.where(hi, b1, b0)
            c1 = torch.where(hi, b2, b1)
            c2 = torch.where(hi, 0, b2)
            mq = q & 31
            b0 = _funnel(c0, c1, mq)
            b1 = _funnel(c1, c2, mq)
            b2 = c2 >> mq
        if level >= 4:
            staging[r % block_rows] = b0
        if level >= 5:
            b1 = (b1 + torch.gather(arow, 1, b0 & 127)) & _M32
    return _i32(torch.stack([b0, b1, b2, q])), _i32(staging)


def _check_v2b(a, wt, ncarry, rows) -> int:
    _check(a, "a", TILE)
    if wt.dim() != 3 or tuple(wt.shape[1:]) != TILE:
        raise ValueError(f"wt: want (W, 8, 128), got {tuple(wt.shape)}")
    _check(wt, "wt", tuple(wt.shape))
    if wt.shape[0] < FILL_CAP:
        raise ValueError(f"wt has {wt.shape[0]} rows; the refills read up "
                         f"to row {FILL_CAP}")
    if wt.device != a.device:
        raise ValueError(f"wt is on {wt.device}, a on {a.device}")
    if ncarry not in (4, 18):
        raise ValueError(f"ncarry {ncarry}: the probe has 4 or 18 carries")
    if rows % V2B_BLOCKS or rows // V2B_BLOCKS < 8:
        raise ValueError(f"rows={rows} must be a multiple of {V2B_BLOCKS} "
                         "blocks with at least 8 rows a block (the last copy "
                         "takes 8 staging rows)")
    return rows // V2B_BLOCKS


def _v2b_outputs(a: torch.Tensor, block_rows: int):
    out = torch.zeros((block_rows, *TILE), dtype=torch.int32, device=a.device)
    stat = torch.empty((SUB, 2), dtype=torch.int32, device=a.device)
    return out, stat


def _v2b_args(a, wt, out, stat, ncarry, while_outer, reduces, dma_in,
              dma_out, block_rows) -> list:
    return [a.data_ptr(), wt.data_ptr(), out.data_ptr(), stat.data_ptr(),
            ncarry, int(while_outer), int(reduces), int(dma_in),
            int(dma_out), V2B_BLOCKS, block_rows, wt.shape[0]]


def probe_v2b(a: torch.Tensor, wt: torch.Tensor, *, ncarry: int = 4,
              while_outer: bool = False, reduces: bool = False,
              dma_in: bool = False, dma_out: bool = False,
              rows: int = V2B_ROWS):
    """Run probe_v2b on the tile `a` and the word table `wt`.

    Returns (out (rows // V2B_BLOCKS, 8, 128) int32: rows 0-7 are the TPU
    kernel's last copy, carry[0] then staging rows 1-7, and with `dma_out`
    the other rows hold the last block's staging, zeros without it;
    stat (8, 2) int32: per tile row, the blocks run and the final fill
    level).  CPU tensors take probe_v2b_ref; CUDA tensors launch
    csrc/probe.cu, which is built for the six variants of V2B_VARIANTS."""
    global PROBE_V2B_LAUNCHES
    block_rows = _check_v2b(a, wt, ncarry, rows)
    flags = dict(while_outer=while_outer, reduces=reduces, dma_in=dma_in,
                 dma_out=dma_out)
    if a.device.type == "cpu":
        return probe_v2b_ref(a, wt, ncarry=ncarry, rows=rows, **flags)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    if dict(ncarry=ncarry, **{k: v for k, v in flags.items() if v}) not in [
            v for _, v in V2B_VARIANTS]:
        raise ValueError(f"no kernel built for {dict(ncarry=ncarry, **flags)}")
    from ..build import kernels_lib

    out, stat = _v2b_outputs(a, block_rows)
    with torch.cuda.device(a.device):
        rc = kernels_lib().brotli_torch_probe_v2b(
            *_v2b_args(a, wt, out, stat, ncarry, while_outer, reduces,
                       dma_in, dma_out, block_rows),
            torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"probe_v2b launch failed: cudaError {rc}")
    PROBE_V2B_LAUNCHES += 1
    return out, stat


def probe_v2b_host(a: torch.Tensor, wt: torch.Tensor, *, ncarry: int = 4,
                   while_outer: bool = False, reduces: bool = False,
                   dma_in: bool = False, dma_out: bool = False,
                   rows: int = V2B_ROWS):
    """csrc/probe.cuh's probe_v2b built for the CPU (build.host_lib), for
    the tests."""
    from ..build import host_lib

    block_rows = _check_v2b(a, wt, ncarry, rows)
    if a.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out, stat = _v2b_outputs(a, block_rows)
    if host_lib().brotli_torch_probe_v2b_host(
            *_v2b_args(a, wt, out, stat, ncarry, while_outer, reduces,
                       dma_in, dma_out, block_rows)) != 0:
        raise ValueError("host shim refused the probe")
    return out, stat


def probe_v2b_ref(a: torch.Tensor, wt: torch.Tensor, *, ncarry: int = 4,
                  while_outer: bool = False, reduces: bool = False,
                  dma_in: bool = False, dma_out: bool = False,
                  rows: int = V2B_ROWS):
    """Plain PyTorch version of probe_v2b on `a`'s device.  The carries
    are one (ncarry, 8, 128) tensor; the reductions run per tile row, as
    in the CUDA kernel.  The window's contents reach no output, so the
    refill keeps the fill level alone (`dma_in` changes nothing here)."""
    block_rows = _check_v2b(a, wt, ncarry, rows)
    dev = a.device
    i64 = torch.int64
    st0 = a.to(i64) & _M32
    k = torch.arange(ncarry, dtype=i64, device=dev)
    c = (st0[None] + k[:, None, None]) & _M32
    inc = torch.where(k >= 2, k, 0)[2:, None, None]
    filled = torch.full((SUB,), WIN, dtype=i64, device=dev)
    ran = torch.zeros(SUB, dtype=i64, device=dev)
    live = torch.ones(SUB, dtype=torch.bool, device=dev)
    staging = torch.zeros((block_rows, *TILE), dtype=i64, device=dev)
    out = torch.zeros((block_rows, *TILE), dtype=i64, device=dev)
    for _ in range(V2B_BLOCKS):
        if while_outer and reduces:
            live = live & (c[0] < _M32).any(dim=1)
        if reduces:
            key = torch.where(c[0] > 0, _i32(c[1]).to(i64), 1 << 30)
            minp = key.min(dim=1).values
            refill = (minp >= filled - REFILL) & (filled + REFILL <= FILL_CAP)
        else:
            refill = filled < FILL_CAP
        filled = torch.where(live & refill, filled + REFILL, filled)
        lv = live[:, None]
        for r in range(block_rows):
            c0 = c[0] ^ ((c[1] + 12345) & _M32)
            c1 = (c[1] + (c0 >> 3)) & _M32
            new = torch.cat([c0[None], c1[None], (c[2:] + inc) & _M32])
            c = torch.where(lv[None], new, c)
            staging[r] = torch.where(lv, c[0], staging[r])
        if dma_out:
            out = torch.where(lv[None], staging, out)
        ran = ran + live.to(i64)
    staging[0] = c[0]
    out[:8] = staging[:8]
    return _i32(out), torch.stack([ran, filled], dim=1).to(torch.int32)


def run_probe_v2(level: int, device: torch.device | str = "cuda",
                 rows: int = V2_ROWS):
    """probe_v2 at `level` on the inputs of seed 0: returns (outputs, ns
    per row).  On the card the time is the best of 3 windows of 20
    launches between CUDA events (time_device_fn); on the CPU nothing is
    timed and ns per row is None."""
    a = torch.from_numpy(probe_inputs()[0]).to(device)
    outs = probe_v2(a, level, rows)
    if a.device.type != "cuda":
        return outs, None
    s = time_device_fn(lambda: probe_v2(a, level, rows), rep=20)
    return outs, s / rows * 1e9


def run_probe_v2b(variant: dict, device: torch.device | str = "cuda",
                  rows: int = V2B_ROWS):
    """probe_v2b with the flags of `variant` (an entry of V2B_VARIANTS) on
    the inputs of seed 0: returns (outputs, ns per row), as run_probe_v2."""
    a, wt = (torch.from_numpy(x).to(device) for x in probe_inputs())
    outs = probe_v2b(a, wt, rows=rows, **variant)
    if a.device.type != "cuda":
        return outs, None
    s = time_device_fn(lambda: probe_v2b(a, wt, rows=rows, **variant),
                       rep=20)
    return outs, s / rows * 1e9
