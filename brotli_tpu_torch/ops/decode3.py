"""v3 full-format decode.  Counterpart of brotli_tpu/ops/pallas_decode3.py.

The host half: ops/stage3_native.py plans each batch in C++
(native/preflight3.cpp: each stream's or metablock's tables parsed, the
units binned by their tables into groups of `width` lanes, 128 by
default) and fills the port's tensors into one pinned buffer, which goes
to the card in one copy (`StagedV3`); `collect_lanes_v3_pinned` brings
the bytes and status rows back through pinned buffers.  The yardstick
stays: ops/preflight3_native.py (the same parse, staged in numpy in the
TPU's layout, `V3Batch`) with `batch_to_torch_v3` and `_lanes`, and the
port's copy of the reference's Python preflight (ops/preflight3.py:
`preflight_v3`, `assemble_v3`), whose key also holds each stream's
initial block lengths, so it can make more groups.  `decode3` runs one
kernel (csrc/decode3.cu `decode3_kernel`) that decodes every lane's
metablock, entropy and LZ together, through a window in shared memory
into the lane's own output slot (`launch_config` sizes its lane map,
window and table staging from the card).  `decode3_direct` launches the
first form of the kernel, kept beside it for comparison.

Drivers: `decode_batch_v3` (single-metablock streams) and
`decode_batch_v3_full` (any stream: the host walks the metablock headers and
decodes each compressed metablock on the device, carrying the earlier
output, kept on the device between rounds, the distance ring and the
last two bytes).  Lanes the kernel flags are re-decoded on the host and
counted in `fallback_stats()`.

Layout: lane l = g*width + s is stream slot s of group g.  Words are an
int32 (Wpad, n_lanes) tensor of u32 bit patterns, word-major; tables are
flat int32 tensors, each group's at the offsets of its config row; the
output is (n_lanes, hrb + out_cap) uint8, slot-major: hrb bytes of earlier
output, right-aligned, then this metablock.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..decode import decode as host_decode
from ..device import resolve_device
from .decode2 import _note_fallbacks, _wrap32, lanes_per_warp, sm_count
from .preflight3 import (
    BLCH,
    BSW2,
    BTCH,
    CCH,
    CMD,
    CP_EX,
    DCH,
    DIST,
    DIST_EX,
    DONE,
    ERR_FAR_DIST,
    ERR_STREAM,
    INIT,
    INS_EX,
    LCH,
    LIT,
    NSTREAM,
    SCAL_ROWS,
    TAIL,
    V3Batch,
    _build_consts,
    _compound_flat,
    _context_lut_chunks,
    _dcmch,
    _dict_chunks,
    _lcmch,
    _transform_tables,
)

# Launches of the CUDA kernels, counted by the wrappers where they launch:
# decode3_kernel (the main path's) and decode3_direct_kernel.
KERNEL_LAUNCHES = 0
DIRECT_LAUNCHES = 0

# The port's own default cap on the table groups of one v3 batch, set from
# an H100 sweep of the kernel at 12, 16, 24 and 32 groups (PERF.md); the
# reference's max_groups=4 is a VMEM figure of its TPU kernel.
GROUP_CAP_V3 = 32

QUEUE_R = 8                # csrc/queue.cuh: look-ahead slots a lane
TABLE_BUDGET = 12 * 1024   # table entries a block may stage (48 KB)
WINDOW_MIN, WINDOW_MAX = 64, 16384
WINDOW_PREF = 1024         # the window launch_config keeps before tables

# columns of a group's config row (csrc/decode3.cuh Cfg3)
(CFG_NL, CFG_NC, CFG_ND, CFG_NBT0, CFG_NBT1, CFG_NBT2, CFG_NPOSTFIX,
 CFG_NDIRECT, CFG_MAXBW, CFG_TRIVIAL, CFG_LCMCH, CFG_DCMCH, CFG_OFF_LIT,
 CFG_OFF_CMD, CFG_OFF_DIST, CFG_OFF_BSW, CFG_OFF_CMAP, CFG_OFF_DX,
 NCFG) = range(19)

BSW_N = (3 * BTCH + 3 * BLCH) * 128   # block-switch trees per group
DX_N = 5 * 128                        # distance LUT per group
STATUS_ROWS = TAIL                    # err, r_lane, phase, mbl, widx,
                                      # avail, r0..r3, zeros
WIDX_GUARD = 0x100                    # flag of a lane that read past its words

_M32 = 0xFFFFFFFF


@dataclass
class V3TorchBatch:
    """A V3Batch as the port's tensors, all on one device."""

    wt: torch.Tensor       # (Wpad, n_lanes) int32: u32 words, word-major
    lit: torch.Tensor      # flat int32 tables, per group at its cfg offsets
    cmd: torch.Tensor
    dist: torch.Tensor
    bsw: torch.Tensor      # (G*BSW_N,)
    cmap: torch.Tensor     # literal map, distance map, modes per group
    dx: torch.Tensor       # (G*DX_N,) (extra << 26) | offset
    consts: torch.Tensor   # (256,) length, short-code, dictionary LUTs
    lut: torch.Tensor      # (2048,) context LUT
    tfm: torch.Tensor      # (256,) transform meta
    dict: torch.Tensor     # uint8 static dictionary, 512-byte padded
    tfs: torch.Tensor      # uint8 transform strings, 512-byte padded
    cdict: torch.Tensor    # uint8 compound dictionary, 512-byte padded
    cfg: torch.Tensor      # (G, NCFG) int32
    scal: torch.Tensor     # (SCAL_ROWS, n_lanes) int32: start_bit, mlen,
                           # blen0..2, pos0, p1, p2, r0..r3
    hist: torch.Tensor | None  # (n_lanes, hrb) uint8 earlier output
    cfg_host: np.ndarray   # cfg, on the host for the checks
    groups: int
    out_cap: int           # output bytes per lane after the prefix
    max_mlen: int
    cd_t: int              # compound dictionary size
    width: int = NSTREAM   # lanes a group: lane l takes group l // width

    @property
    def n_lanes(self) -> int:
        return self.groups * self.width

    @property
    def wpad(self) -> int:
        return self.wt.shape[0]

    @property
    def hrb(self) -> int:
        return 0 if self.hist is None else self.hist.shape[1]

    @property
    def device(self) -> torch.device:
        return self.wt.device


def _flat(table: np.ndarray) -> np.ndarray:
    """(k*8, 128) lane-gather chunks (each replicated over 8 sublanes) ->
    (k*128,) flat entries."""
    t = np.asarray(table).reshape(-1, 8, 128)[:, 0, :]
    return np.ascontiguousarray(t.reshape(-1))


@functools.cache
def _shared_tables() -> dict:
    """The group-independent tables, un-replicated once per process."""
    tfm, tfs, _ = _transform_tables()
    return {
        "consts": _flat(_build_consts()).astype(np.int32),
        "lut": _flat(_context_lut_chunks()).astype(np.int32),
        "tfm": _flat(tfm).astype(np.int32),
        "tfs": _flat(tfs).astype(np.int32).view(np.uint8),
        "dict": _flat(_dict_chunks()[0]).astype(np.int32).view(np.uint8),
    }


def stage_dictionary(device: torch.device | str = "cuda") -> torch.Tensor:
    """The static dictionary in the v3 kernel's layout (the `dict` field of
    V3TorchBatch: uint8, padded to whole 512-byte chunks) on `device`.
    Stage it once and pass it to the decode calls as `dict_dev`: they then
    upload no dictionary.  The one-device counterpart of
    brotli_tpu/parallel/mesh.py broadcast_dictionary_chunks."""
    return torch.from_numpy(_shared_tables()["dict"].copy()).to(
        resolve_device(device))


def _check_dict_dev(dict_dev, dev: torch.device) -> None:
    """dict_dev must be what stage_dictionary(dev) makes."""
    want = _shared_tables()["dict"].shape
    if not isinstance(dict_dev, torch.Tensor):
        raise TypeError(f"dict_dev must be a tensor, got {type(dict_dev)}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dict_dev.device != dev:
        raise ValueError(f"dict_dev is on {dict_dev.device}, the batch on "
                         f"{dev}")
    if dict_dev.dtype != torch.uint8 or tuple(dict_dev.shape) != want:
        raise ValueError(f"dict_dev: want uint8 {want}, got {dict_dev.dtype} "
                         f"{tuple(dict_dev.shape)}")
    if not dict_dev.is_contiguous():
        raise ValueError("dict_dev must be contiguous")


def group_config(batch: V3Batch) -> np.ndarray:
    """(G, NCFG) int32: each group's GroupCfg and its table offsets."""
    cfg = np.zeros((batch.groups, NCFG), np.int32)
    o_lit = o_cmd = o_dist = o_cmap = 0
    for g, c in enumerate(batch.configs):
        lc, dc = _lcmch(c.NBT0), _dcmch(c.NBT2)
        cfg[g] = (c.NL, c.NC, c.ND, c.NBT0, c.NBT1, c.NBT2, c.npostfix,
                  c.ndirect, c.maxbw, int(c.trivial_lit), lc, dc, o_lit,
                  o_cmd, o_dist, g * BSW_N, o_cmap, g * DX_N)
        o_lit += c.NL * LCH * 128
        o_cmd += c.NC * CCH * 128
        o_dist += c.ND * DCH * 128
        o_cmap += (lc + dc + 1) * 128
    return cfg


def batch_to_torch_v3(batch: V3Batch, device: torch.device | str,
                      custom_dictionary=None, dict_dev=None) -> V3TorchBatch:
    """The JAX package's staged inputs (numpy) as the port's tensors.

    Tables lose the TPU's sublane replication, the per-group GroupCfg (baked
    into the JAX kernel at trace time) becomes a config row with the
    group's table offsets, the per-lane scalars come out of the `scal`
    rows, and the history prefix is each lane's earlier output,
    right-aligned in `hrb` bytes.  `dict_dev` (from stage_dictionary) is
    used as the static dictionary in place of an upload."""
    dev = resolve_device(device)
    if dict_dev is not None:
        _check_dict_dev(dict_dev, dev)
    G = batch.groups
    n = G * NSTREAM
    sh = _shared_tables()
    scal = np.asarray(batch.scal, np.int32).reshape(G, SCAL_ROWS, NSTREAM)
    scal = scal.transpose(1, 0, 2).reshape(SCAL_ROWS, n)
    cd_raw = _compound_flat(custom_dictionary)
    cd_n = max(1, -(-len(cd_raw) // 512)) * 512
    cdict = np.zeros(cd_n, np.uint8)
    cdict[: len(cd_raw)] = np.frombuffer(cd_raw, np.uint8)
    hist = None
    if batch.HR:
        hrb = 4 * batch.HR
        hist = np.zeros((n, hrb), np.uint8)
        for slot, hb in enumerate(batch.hist or ()):
            if hb:
                hist[slot, hrb - len(hb):] = np.frombuffer(bytes(hb), np.uint8)
    max_mlen = int(batch.mlens.max()) if batch.mlens.size else 0
    cfg = group_config(batch)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return V3TorchBatch(
        wt=put(np.asarray(batch.wt).reshape(batch.Wpad, n).view(np.int32)),
        lit=put(_flat(batch.lit_t)), cmd=put(_flat(batch.cmd_t)),
        dist=put(_flat(batch.dist_t)), bsw=put(_flat(batch.bsw_t)),
        cmap=put(_flat(batch.cmap_t)), dx=put(_flat(batch.dx_t)),
        consts=put(sh["consts"]), lut=put(sh["lut"]), tfm=put(sh["tfm"]),
        dict=put(sh["dict"]) if dict_dev is None else dict_dev,
        tfs=put(sh["tfs"]), cdict=put(cdict),
        cfg=put(cfg), scal=put(scal),
        hist=None if hist is None else put(hist),
        cfg_host=cfg, groups=G, out_cap=max(16, -(-max_mlen // 16) * 16),
        max_mlen=max_mlen, cd_t=len(cd_raw),
    )


def _check_batch(tb: V3TorchBatch) -> None:
    if tb.width < 1 or tb.width % 128:
        raise ValueError(f"width {tb.width}: want a multiple of 128 (the "
                         "kernels' blocks lie in one group)")
    n = tb.n_lanes
    i32, u8 = torch.int32, torch.uint8
    want = {
        "wt": (tb.wt, i32, (tb.wpad, n)),
        "cfg": (tb.cfg, i32, (tb.groups, NCFG)),
        "scal": (tb.scal, i32, (SCAL_ROWS, n)),
        "consts": (tb.consts, i32, (256,)),
        "lut": (tb.lut, i32, (2048,)),
        "tfm": (tb.tfm, i32, (256,)),
        "bsw": (tb.bsw, i32, (tb.groups * BSW_N,)),
        "dx": (tb.dx, i32, (tb.groups * DX_N,)),
    }
    for name in ("lit", "cmd", "dist", "cmap"):
        want[name] = (getattr(tb, name), i32, None)
    for name in ("dict", "tfs", "cdict"):
        want[name] = (getattr(tb, name), u8, None)
    if tb.hist is not None:
        want["hist"] = (tb.hist, u8, (n, tb.hrb))
    for name, (t, dtype, shape) in want.items():
        if t.dtype != dtype or (shape is not None and tuple(t.shape) != shape):
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if shape is None and (t.dim() != 1 or t.numel() < 1):
            raise ValueError(f"{name} must be a non-empty 1-D tensor")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != tb.device:
            raise ValueError(f"{name} is on {t.device}, wt on {tb.device}")
    if tb.groups < 1 or tb.wpad < 1:
        raise ValueError("groups and Wpad must be >= 1")
    if tb.out_cap < max(1, tb.max_mlen) or not 0 <= tb.cd_t <= tb.cdict.numel():
        raise ValueError("out_cap below the largest metablock, or cd_t "
                         "beyond the compound dictionary")
    c = np.asarray(tb.cfg_host)
    if c.shape != (tb.groups, NCFG):
        raise ValueError("cfg_host does not match the groups")
    ends = {
        "lit": c[:, CFG_OFF_LIT] + c[:, CFG_NL] * LCH * 128,
        "cmd": c[:, CFG_OFF_CMD] + c[:, CFG_NC] * CCH * 128,
        "dist": c[:, CFG_OFF_DIST] + c[:, CFG_ND] * DCH * 128,
        "cmap": c[:, CFG_OFF_CMAP]
        + (c[:, CFG_LCMCH] + c[:, CFG_DCMCH] + 1) * 128,
        "bsw": c[:, CFG_OFF_BSW] + BSW_N,
        "dx": c[:, CFG_OFF_DX] + DX_N,
    }
    for name, end in ends.items():
        if (end > getattr(tb, name).numel()).any() or (c[:, 12:] < 0).any():
            raise ValueError(f"a group's {name} table lies outside the tensor")


def _alloc_outputs(tb: V3TorchBatch):
    """The zeroed output slots with each lane's prefix in place, and the
    status rows."""
    out = torch.zeros((tb.n_lanes, tb.hrb + tb.out_cap), dtype=torch.uint8,
                      device=tb.device)
    if tb.hist is not None:
        out[:, : tb.hrb] = tb.hist
    status = torch.empty((STATUS_ROWS, tb.n_lanes), dtype=torch.int32,
                         device=tb.device)
    return out, status


def _c_args(tb: V3TorchBatch, out, status, use_dict: bool) -> list:
    """The argument list of brotli_torch_decode3 (and its host shim)."""
    ptrs = (tb.wt, tb.lit, tb.cmd, tb.dist, tb.bsw, tb.cmap, tb.dx,
            tb.consts, tb.lut, tb.tfm, tb.dict, tb.tfs, tb.cdict, tb.cfg,
            tb.scal, out, status)
    return ([t.data_ptr() for t in ptrs]
            + [tb.n_lanes, tb.wpad, tb.out_cap, tb.hrb, tb.dict.numel(),
               tb.tfs.numel(), tb.cdict.numel(), tb.cd_t, int(use_dict),
               tb.width])


def _table_sizes(cfg: np.ndarray) -> np.ndarray:
    """(G, 8) entries of each table decode3_kernel stages, in its order
    (csrc/decode3.cu): consts, the maps, the context LUT, the distance LUT,
    the command and distance trees, the block-switch trees where a
    category switches, the literal trees."""
    c = np.asarray(cfg, np.int64).reshape(-1, NCFG)
    switches = (c[:, [CFG_NBT0, CFG_NBT1, CFG_NBT2]] > 1).any(axis=1)
    ones = np.ones(len(c), np.int64)
    return np.stack([256 * ones,
                     (c[:, CFG_LCMCH] + c[:, CFG_DCMCH] + 1) * 128,
                     2048 * ones, DX_N * ones, c[:, CFG_NC] * CCH * 128,
                     c[:, CFG_ND] * DCH * 128, np.where(switches, BSW_N, 0),
                     c[:, CFG_NL] * LCH * 128], axis=1)


def table_ints(cfg: np.ndarray, cap: int | None = None) -> int:
    """The table entries decode3_kernel stages for the largest group of a
    config, each table whole while the running sum stays within `cap` (as
    the kernel stages them; no cap: all of them)."""
    sizes = _table_sizes(cfg)
    if cap is None:
        return int(sizes.sum(axis=1).max()) if len(sizes) else 0
    used = np.zeros(len(sizes), np.int64)
    for k in range(sizes.shape[1]):
        n = sizes[:, k]
        used += np.where(used + n <= cap, n, 0)
    return int(used.max()) if len(used) else 0


def launch_config(tb: V3TorchBatch, sms: int,
                  smem_sm: int) -> tuple[int, int, int]:
    """(lanes a warp, window bytes a lane, table entries a block) for
    decode3_kernel on a card of `sms` SMs with `smem_sm` bytes of shared
    memory each: lanes_per_warp lanes a warp, and the window and tables
    `_fit` gives them."""
    return _fit(tb, lanes_per_warp(tb.n_lanes, sms), sms, smem_sm)


def _fit(tb: V3TorchBatch, lpw: int, sms: int, smem_sm: int,
         window: int | None = None) -> tuple[int, int, int]:
    """launch_config at `lpw` lanes a warp (and a `window`-byte window, if
    one is given: the sweeps of tools/decode_causes.py and the card-only
    tests).  The blocks an SM must hold for one wave share its shared
    memory, less the 1 KB each block's runtime reserve takes.  The
    look-ahead queues take theirs.  Where the rest holds a window of
    WINDOW_PREF bytes a lane (or what a slot needs, if less), the window
    keeps that and the tables take what is left, up to TABLE_BUDGET; where
    it does not, the tables come first.  The window grows into the rest,
    as a power of two in [WINDOW_MIN, WINDOW_MAX] and no larger than a
    slot needs.  (H100 runs of the `[caps]` sweep, PERF.md section 6: at
    32 groups, where no 1 KB window fits, staging the tables beat a bare
    512 B window.)"""
    lpb = 4 * lpw
    per_sm = -(-(tb.n_lanes // lpb) // sms)
    room = min(smem_sm, smem_sm // per_sm) - 1024 - 4 * QUEUE_R * lpb
    slot = 1 << max(0, (tb.hrb + tb.out_cap - 1).bit_length())
    cap = TABLE_BUDGET
    keep = min(WINDOW_PREF, slot) * lpb
    if window is None and room >= keep:
        cap = min(cap, (room - keep) // 4)
    tab = table_ints(tb.cfg_host, cap)
    if window is None:
        per_lane = max(WINDOW_MIN, (room - 4 * tab) // lpb)
        window = min(WINDOW_MAX, slot, 1 << (per_lane.bit_length() - 1))
        window = max(WINDOW_MIN, window)
    return lpw, window, tab


def decode3(tb: V3TorchBatch, use_dict: bool = True):
    """Decode every lane's metablock.

    Returns (out (n_lanes, hrb + out_cap) uint8, status (16, n_lanes)
    int32) on the batch's device.  CPU tensors take decode3_ref; CUDA
    tensors launch csrc/decode3.cu `decode3_kernel` as launch_config sizes
    it."""
    global KERNEL_LAUNCHES
    if not _on_card(tb):
        return decode3_ref(tb, use_dict)
    props = torch.cuda.get_device_properties(tb.device)
    cfg = launch_config(tb, sm_count(tb.device),
                        props.shared_memory_per_multiprocessor)
    out = _launch(tb, use_dict, "brotli_torch_decode3", list(cfg),
                  "decode3 kernel")
    KERNEL_LAUNCHES += 1
    return out


def decode3_direct(tb: V3TorchBatch, use_dict: bool = True):
    """decode3 through decode3_direct_kernel (one lane a thread, blocks of
    128, bytes straight into the slot); CPU tensors take decode3_ref."""
    global DIRECT_LAUNCHES
    if not _on_card(tb):
        return decode3_ref(tb, use_dict)
    out = _launch(tb, use_dict, "brotli_torch_decode3_direct", [],
                  "direct decode3 kernel")
    DIRECT_LAUNCHES += 1
    return out


def _on_card(tb: V3TorchBatch) -> bool:
    _check_batch(tb)
    if tb.device.type == "cpu":
        return False
    if tb.device.type != "cuda":
        raise ValueError(f"unsupported device {tb.device}")
    return True


def _launch(tb: V3TorchBatch, use_dict: bool, entry: str, extra: list,
            what: str):
    from ..build import kernels_lib

    out, status = _alloc_outputs(tb)
    with torch.cuda.device(tb.device):
        rc = getattr(kernels_lib(), entry)(
            *_c_args(tb, out, status, use_dict), *extra,
            torch.cuda.current_stream(tb.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    return out, status


def decode3_host(tb: V3TorchBatch, use_dict: bool = True, lanes: int = 4,
                 window: int = 2048, direct: bool = False):
    """csrc/decode3.cuh's per-lane code built for the CPU (build.host_lib):
    the windowed kernel's with a `window`-byte window (`lanes` is checked
    as the kernel checks it), or with `direct` the direct kernel's.  For
    the tests, which hold it against decode3_ref."""
    from ..build import host_lib

    _check_batch(tb)
    if tb.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out, status = _alloc_outputs(tb)
    args = _c_args(tb, out, status, use_dict)
    lib = host_lib()
    rc = (lib.brotli_torch_decode3_direct_host(*args) if direct else
          lib.brotli_torch_decode3_host(*args, lanes, window,
                                        table_ints(tb.cfg_host,
                                                   TABLE_BUDGET)))
    if rc != 0:
        raise ValueError("host shim refused the batch")
    return out, status


def decode3_ref(tb: V3TorchBatch, use_dict: bool = True):
    """Plain PyTorch version of decode3, on the batch's device.

    The per-lane machine of csrc/decode3.cuh vectorised over lanes: one loop
    iteration is one row (refill, then one phase step with its bytes) for
    every live lane, with torch.where for the phase select and indexing
    into the flat tables.  Values are int64 tensors holding u32/i32 values.
    """
    _check_batch(tb)
    dev = tb.device
    n = tb.n_lanes
    i64 = torch.int64
    hrb, cap = tb.hrb, tb.out_cap
    stride = hrb + cap

    lane = torch.arange(n, dtype=i64, device=dev)
    cfg = tb.cfg.to(i64)[lane // tb.width]

    def col(c):
        return cfg[:, c]

    nl, nc, nd = col(CFG_NL), col(CFG_NC), col(CFG_ND)
    nbt = [col(CFG_NBT0), col(CFG_NBT1), col(CFG_NBT2)]
    npostfix, ndirect, maxbw = col(CFG_NPOSTFIX), col(CFG_NDIRECT), col(CFG_MAXBW)
    trivial = col(CFG_TRIVIAL) != 0
    lcmch, dcmch = col(CFG_LCMCH), col(CFG_DCMCH)
    o_lit, o_cmd, o_dist = col(CFG_OFF_LIT), col(CFG_OFF_CMD), col(CFG_OFF_DIST)
    o_bsw, o_cmap, o_dx = col(CFG_OFF_BSW), col(CFG_OFF_CMAP), col(CFG_OFF_DX)
    o_modes = o_cmap + (lcmch + dcmch) * 128

    lit, cmd, dist, bsw, cmap, dx = (t.to(i64) for t in (
        tb.lit, tb.cmd, tb.dist, tb.bsw, tb.cmap, tb.dx))
    consts, lut, tfm = tb.consts.to(i64), tb.lut.to(i64), tb.tfm.to(i64)
    dictb, tfs, cdict = tb.dict.to(i64), tb.tfs.to(i64), tb.cdict.to(i64)
    wt = tb.wt.reshape(-1).to(i64) & _M32
    scal = tb.scal.to(i64)
    start_bit, mlen, pos0 = scal[0], scal[1], scal[5]
    zero = torch.zeros(n, dtype=i64, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    out, _ = _alloc_outputs(tb)
    # one spare byte per lane takes the writes of masked lanes
    buf = torch.cat([out.reshape(-1), torch.zeros(n, dtype=torch.uint8,
                                                  device=dev)])
    base = lane * stride + hrb
    spare = n * stride + lane

    def write(mask, idx, vals):
        buf[torch.where(mask, idx, spare)] = (vals & 0xFF).to(torch.uint8)

    def read(idx):
        return buf[idx].to(i64)

    def get(tab, idx, ok):
        return torch.where(ok, tab[torch.where(ok, idx, 0)], 0)

    def read_symbol(tab, off, tc, ntrees, tree, v15):
        ok_t = (tree >= 0) & (tree < ntrees)
        tb_ = torch.where(ok_t, tree, 0) * tc
        root = v15 & 0xFF
        e0 = get(tab, off + tb_ * 128 + root, ok_t)
        bits0 = e0 >> 16
        need_sub = bits0 > 8
        sub_mask = (1 << bits0.clamp(0, 15)) - 1
        idx2 = root + (e0 & 0xFFFF) + ((v15 & sub_mask) >> 8)
        a = tb_ + (idx2 >> 7)
        ok2 = need_sub & (a < ntrees * tc) & (a % tc >= 2)
        e1 = get(tab, off + a * 128 + (idx2 & 127), ok2)
        sym = torch.where(need_sub, e1 & 0xFFFF, e0 & 0xFFFF)
        nb = torch.where(need_sub, (e1 >> 16) + 8, bits0)
        return sym, nb

    def map_get(off, n_chunks, idx):
        return get(cmap, off + idx, (idx >= 0) & ((idx >> 7) < n_chunks))

    def in_chunks(i, chunks):
        c = i >> 7
        hit = no
        for k in chunks:
            hit = hit | (c == k)
        return get(lut, i, hit)

    def lut2(clo, p1, p2):
        mode = clo >> 9
        ab = in_chunks(clo + p1, (8, 9, 12, 13)) | in_chunks(
            clo + 256 + p2, (10, 11, 14, 15))
        return torch.where(mode == 0, p1 & 63,
                           torch.where(mode == 1, p1 >> 2, ab))

    def low_mask(nbits):
        return (1 << (nbits & 31)) - 1

    s = {
        "phase": torch.where(mlen > 0, INIT, DONE).to(i64),
        "widx": zero.clone(), "avail": zero.clone(), "wpos": zero.clone(),
        "mbl": mlen.clone(), "b0": zero.clone(), "b1": zero.clone(),
        "b2": zero.clone(), "lit_rem": zero.clone(), "copy_len": zero.clone(),
        "ins_code": zero.clone(), "cp_code": zero.clone(),
        "implicit": zero.clone(), "dcode": zero.clone(),
        "blen0": scal[2].clone(), "blen1": scal[3].clone(),
        "blen2": scal[4].clone(),
        "bt0": zero.clone(), "bt1": zero.clone(), "bt2": zero.clone(),
        "btp0": zero + 1, "btp1": zero + 1, "btp2": zero + 1,
        "clo": cmap[o_modes], "p1": scal[6].clone(), "p2": scal[7].clone(),
        "r0": scal[8].clone(), "r1": scal[9].clone(), "r2": scal[10].clone(),
        "r3": scal[11].clone(), "bsw_cat": zero.clone(),
        "bsw_code": zero.clone(), "err": zero.clone(),
    }
    rows = zero.clone()
    budget = 8 * mlen + 4 * tb.wpad + 64

    def refill(need):
        acc = wt[s["widx"].clamp(0, tb.wpad - 1) * n + lane]
        sh = s["avail"] & 31
        limb = s["avail"] >> 5
        lo = torch.where(need, (acc << sh) & _M32, 0)
        hi = torch.where(need & (sh > 0), acc >> ((32 - sh) & 31), 0)
        s["b0"] = s["b0"] | torch.where(limb == 0, lo, 0)
        s["b1"] = s["b1"] | torch.where(limb == 0, hi,
                                        torch.where(limb == 1, lo, 0))
        s["b2"] = s["b2"] | torch.where(limb == 1, hi,
                                        torch.where(limb == 2, lo, 0))
        s["avail"] = s["avail"] + torch.where(need, 32, 0)
        s["widx"] = s["widx"] + need.to(i64)

    def pk(q):
        l0 = (q >> 5) == 0
        w0 = torch.where(l0, s["b0"], s["b1"])
        w1 = torch.where(l0, s["b1"], s["b2"])
        m = q & 31
        return ((w0 >> m) | torch.where(m == 0, 0, (w1 << (32 - m)) & _M32)) & _M32

    def set_where(mask, **kv):
        for k, v in kv.items():
            s[k] = torch.where(mask, v, s[k])

    def push_ring(mask, distance):
        set_where(mask, r3=s["r2"], r2=s["r1"], r1=s["r0"], r0=distance)

    def after_bytes(mask, w, k):
        """p1/p2 after k bytes written at slot offset w (mask lanes)."""
        last = read(torch.where(mask & (k >= 1), base + w + k - 1, spare))
        prev = read(torch.where(mask & (k >= 2), base + w + k - 2, spare))
        p1 = s["p1"]
        s["p2"] = torch.where(mask & (k >= 2), prev,
                              torch.where(mask & (k == 1), p1, s["p2"]))
        s["p1"] = torch.where(mask & (k >= 1), last, p1)
        s["wpos"] = s["wpos"] + torch.where(mask, k, 0)

    def block_switch(cat, m_all, q):
        m = m_all & (nbt[cat] >= 2) & (s[f"blen{cat}"] == 0)
        tsym, tnb = read_symbol(bsw, o_bsw + cat * BTCH * 128, BTCH, 1, zero,
                                pk(q) & 0x7FFF)
        q = q + torch.where(m, tnb, 0)
        lsym, lnb = read_symbol(bsw, o_bsw + (3 * BTCH + cat * BLCH) * 128,
                                BLCH, 1, zero, pk(q) & 0x7FFF)
        q = q + torch.where(m, lnb, 0)
        cur = s[f"bt{cat}"]
        bt = torch.where(tsym == 0, s[f"btp{cat}"],
                         torch.where(tsym == 1, cur + 1, tsym - 2))
        bt = torch.where(bt >= nbt[cat], bt - nbt[cat], bt)
        set_where(m, **{f"btp{cat}": cur, f"bt{cat}": bt})
        if cat == 0:
            set_where(m, clo=cmap[o_modes + (bt & 127)])
        pack = consts[128 + lsym.clamp(0, 25)]
        nbx, offx = pack >> 20, pack & 0xFFFFF
        can_x = m & (q + nbx <= 32)
        set_where(can_x, **{f"blen{cat}": offx + (pk(q) & 0xFFFFFF & low_mask(nbx))})
        q = q + torch.where(can_x, nbx, 0)
        set_where(m & ~can_x, bsw_cat=zero + cat, bsw_code=lsym,
                  phase=zero + BSW2)
        return q, m

    def lit_tree(p1, p2):
        cidx = (s["bt0"] << 6) + torch.where(trivial, 0, lut2(s["clo"], p1, p2))
        return map_get(o_cmap, lcmch, cidx)

    def dict_bytes(mask, total, pre, bodyn, woff, poff, soff, op, comp):
        """Every mask lane's word, byte by byte across the lanes."""
        w = s["wpos"]
        clpos, cllen, clxp, clxv, fdone = (zero.clone() for _ in range(5))
        for i in range(int(total[mask].max())):
            act = mask & (i < total)
            in_pre = i < pre
            bi = i - pre
            in_body = ~in_pre & (bi < bodyn)
            soff_i = torch.where(in_pre, poff + i, soff + bi - bodyn)
            s_b = tfs[soff_i.clamp(0, tfs.numel() - 1)]
            d_b = torch.where(
                comp, cdict[(woff + bi).clamp(0, cdict.numel() - 1)],
                dictb[(woff + bi).clamp(0, dictb.numel() - 1)])
            ferm = act & in_body & ~comp & (((op == 10) & (fdone == 0))
                                            | (op == 11))
            start = ferm & (clpos >= cllen)
            lo = (d_b >= 97) & (d_b <= 122)
            clpos = torch.where(start, 0, clpos)
            cllen = torch.where(start, torch.where(
                d_b < 0xC0, 1, torch.where(d_b < 0xE0, 2, 3)), cllen)
            clxp = torch.where(start, torch.where(
                d_b < 0xC0, 0, torch.where(d_b < 0xE0, 1, 2)), clxp)
            clxv = torch.where(start, torch.where(
                d_b < 0xC0, torch.where(lo, 32, 0),
                torch.where(d_b < 0xE0, 32, 5)), clxv)
            d_b = torch.where(ferm & (clpos == clxp), d_b ^ clxv, d_b)
            fdone = torch.where(ferm & (clpos + 1 >= cllen) & (op == 10), 1,
                                fdone)
            clpos = clpos + ferm.to(i64)
            write(act, base + w + i, torch.where(in_body, d_b, s_b))
        after_bytes(mask, w, torch.where(mask, total, 0))

    it = 0
    while True:
        live = (s["phase"] < DONE) & (s["err"] == 0)
        over = live & (rows >= budget)
        live = live & ~over
        rows = rows + live.to(i64)
        need = live & (s["avail"] <= 64) & (s["widx"] < tb.wpad)
        refill(need)
        run = live & ((s["avail"] >= 65)
                      | ((s["phase"] == INIT) & (s["avail"] >= 32)))
        stuck = over | (live & ~run & ~need)
        s["err"] = s["err"] | torch.where(stuck, ERR_STREAM, 0)
        if it % 16 == 0 and not bool((need | run).any()):
            break
        it += 1

        p0 = s["phase"].clone()
        q = zero

        # ---- INIT: discard the sub-word start offset ----
        m = run & (p0 == INIT)
        q = torch.where(m, start_bit, q)
        set_where(m, phase=zero + CMD)

        # ---- CMD (+ inline command block switch) ----
        m_all = run & (p0 == CMD)
        q, did = block_switch(1, m_all, q)
        m = m_all & ~did
        s["blen1"] = s["blen1"] - m.to(i64)
        sym, nb = read_symbol(cmd, o_cmd, CCH, nc, s["bt1"], pk(q) & 0x7FFF)
        cell = sym >> 6
        sh2 = 2 * torch.where(cell < 2, cell, cell - 2)
        ins_hi = torch.where(sh2 < 32, 0x29850 >> sh2.clamp(0, 31), 0) & 3
        cp_hi = torch.where(sh2 < 32, 0x26244 >> sh2.clamp(0, 31), 0) & 3
        set_where(m, ins_code=ins_hi * 8 + ((sym >> 3) & 7),
                  cp_code=cp_hi * 8 + (sym & 7), implicit=(cell < 2).to(i64))
        q = q + torch.where(m, nb, 0)

        def ins_cp():
            ip = consts[s["ins_code"] & 127]
            cpk = consts[(s["cp_code"] + 64) & 127]
            return ip >> 20, ip & 0xFFFFF, cpk >> 20, cpk & 0xFFFFF

        nb_i, off_i, nb_c, off_c = ins_cp()
        can_i = m & (q + nb_i <= 32)
        set_where(can_i, lit_rem=off_i + (pk(q) & 0xFFFFFF & low_mask(nb_i)))
        q = q + torch.where(can_i, nb_i, 0)
        can_c = can_i & (q + nb_c <= 32)
        set_where(can_c, copy_len=off_c + (pk(q) & 0xFFFFFF & low_mask(nb_c)))
        q = q + torch.where(can_c, nb_c, 0)
        set_where(m, phase=torch.where(~can_i, INS_EX, torch.where(
            ~can_c, CP_EX, torch.where(s["lit_rem"] > 0, LIT, DIST))))

        # ---- INS_EX: spilled insert extra bits (+ copy if it fits) ----
        m = run & (p0 == INS_EX)
        set_where(m, lit_rem=off_i + (pk(q) & 0xFFFFFF & low_mask(nb_i)))
        q = q + torch.where(m, nb_i, 0)
        can_c = m & (q + nb_c <= 32)
        set_where(can_c, copy_len=off_c + (pk(q) & 0xFFFFFF & low_mask(nb_c)))
        q = q + torch.where(can_c, nb_c, 0)
        set_where(m, phase=torch.where(~can_c, CP_EX, torch.where(
            s["lit_rem"] > 0, LIT, DIST)))

        # ---- CP_EX: spilled copy extra bits ----
        m = run & (p0 == CP_EX)
        set_where(m, copy_len=off_c + (pk(q) & 0xFFFFFF & low_mask(nb_c)))
        q = q + torch.where(m, nb_c, 0)
        set_where(m, phase=torch.where(s["lit_rem"] > 0, LIT, DIST))

        # ---- BSW2: spilled block-length extra bits ----
        m = run & (p0 == BSW2)
        pack = consts[128 + s["bsw_code"].clamp(0, 25)]
        nbx = pack >> 20
        v = (pack & 0xFFFFF) + (pk(q) & 0xFFFFFF & low_mask(nbx))
        q = q + torch.where(m, nbx, 0)
        for c in range(3):
            set_where(m & (s["bsw_cat"] == c), **{f"blen{c}": v})
        set_where(m, phase=torch.where(s["bsw_cat"] == 0, LIT, torch.where(
            s["bsw_cat"] == 1, CMD, DIST)))

        # ---- LIT (+ inline literal block switch), up to 2 per row ----
        m_all = run & (p0 == LIT)
        q, did = block_switch(0, m_all, q)
        m0 = m_all & ~did
        s["err"] = s["err"] | torch.where(m0 & (s["blen0"] <= 0), ERR_STREAM, 0)
        m = m0 & (s["blen0"] > 0)
        sym0, nb0 = read_symbol(lit, o_lit, LCH, nl,
                                lit_tree(s["p1"], s["p2"]), pk(q) & 0x7FFF)
        q = q + torch.where(m, nb0, 0)
        have2 = m & (s["lit_rem"] >= 2) & (s["mbl"] >= 2) & (s["blen0"] >= 2)
        sym1, nb1 = read_symbol(lit, o_lit, LCH, nl, lit_tree(sym0, s["p1"]),
                                pk(q) & 0x7FFF)
        q = q + torch.where(have2, nb1, 0)
        took = torch.where(m, 1 + have2.to(i64), 0)
        w = s["wpos"]
        write(m, base + w, sym0)
        write(have2, base + w + 1, sym1)
        set_where(have2, p2=sym0 & 0xFF, p1=sym1 & 0xFF)
        set_where(m & ~have2, p2=s["p1"], p1=sym0 & 0xFF)
        s["wpos"] = w + took
        for k in ("blen0", "lit_rem", "mbl"):
            s[k] = s[k] - took
        set_where(m, phase=torch.where(s["mbl"] <= 0, DONE, torch.where(
            s["lit_rem"] <= 0, DIST, s["phase"])))

        # ---- DIST (+ inline distance block switch) / DIST_EX ----
        m_all = run & (p0 == DIST)
        is_imp = s["implicit"] == 1
        q, did = block_switch(2, m_all & ~is_imp, q)
        m = m_all & ~did
        m_read = m & ~is_imp
        s["blen2"] = s["blen2"] - m_read.to(i64)
        didx = (s["bt2"] << 2) + s["copy_len"].clamp(max=5) - 2
        tree_d = map_get(o_cmap + lcmch * 128, dcmch, didx)
        sym, nb = read_symbol(dist, o_dist, DCH, nd, tree_d, pk(q) & 0x7FFF)
        q = q + torch.where(m_read, nb, 0)
        s["dcode"] = torch.where(m_read, sym, torch.where(m, -1, s["dcode"]))
        dcode = s["dcode"]
        is_short = (dcode >= 0) & (dcode < 16)
        is_direct = (dcode >= 16) & (dcode < 16 + ndirect)
        is_long = dcode >= 16 + ndirect
        sp = consts[96 + dcode.clamp(0, 15)]
        k_idx = sp >> 4
        ring = torch.where(k_idx == 0, s["r0"], torch.where(
            k_idx == 1, s["r1"], torch.where(k_idx == 2, s["r2"], s["r3"])))
        short_dist = _wrap32(ring + (sp & 15) - 3)
        m2 = run & (p0 == DIST_EX)
        dxp = dx[o_dx + dcode.clamp(0, DX_N - 1)]
        nbx, offx = dxp >> 26, dxp & 0x3FFFFFF
        can_x = m & is_long & (q + nbx <= 32)
        xv = pk(q) & 0xFFFFFF & low_mask(nbx)
        q = q + torch.where(can_x | m2, nbx, 0)
        long_dist = _wrap32(offx + ((xv << npostfix) & _M32))
        distance = torch.where(is_imp, s["r0"], torch.where(
            is_short, short_dist, torch.where(is_direct, dcode - 15, long_dist)))
        distance = torch.where(m2, long_dist, distance)
        spill = m & is_long & ~can_x
        set_where(spill, phase=zero + DIST_EX)
        fin = (m & ~spill) | m2

        # ---- finalize a completed distance: copy, or dictionary word ----
        pos = pos0 + (mlen - s["mbl"])
        max_dist = torch.minimum(pos, maxbw)
        is_dict = fin & (distance > max_dist)
        m_reg = fin & ~is_dict
        w = s["wpos"]
        bad_reg = m_reg & ((distance < 1) | (s["copy_len"] > s["mbl"])
                           | (hrb + w - distance < 0))
        ok = m_reg & ~bad_reg
        push_ring(ok & ~is_imp & (dcode > 0), distance)
        if bool(ok.any()):
            idx = ok.nonzero().squeeze(1)
            cl, d = s["copy_len"][idx], distance[idx]
            dst0 = base[idx] + w[idx]
            for c0 in range(0, int(cl.max()), 1024):
                j = torch.arange(c0, min(int(cl.max()), c0 + 1024),
                                 dtype=i64, device=dev)[None, :]
                valid = j < cl[:, None]
                src = dst0[:, None] - d[:, None] + j % d[:, None]
                buf[(dst0[:, None] + j)[valid]] = buf[src[valid]]
            after_bytes(ok, w, s["copy_len"])
        s["mbl"] = s["mbl"] - torch.where(ok, s["copy_len"], 0)
        set_where(ok, phase=torch.where(s["mbl"] <= 0, DONE, CMD))
        s["err"] = s["err"] | torch.where(bad_reg, ERR_STREAM, 0)

        tail = no
        if not use_dict:
            s["err"] = s["err"] | torch.where(is_dict, ERR_FAR_DIST, 0)
        elif bool(is_dict.any()):
            wlen = s["copy_len"]
            addr = distance - max_dist - 1
            too_big = is_dict & (distance > 0x7FFFFFFC)
            mcd = is_cd = no
            cd_addr = zero
            if tb.cd_t > 0:
                is_cd = is_dict & ~too_big & (addr < tb.cd_t)
                cd_addr = tb.cd_t - addr - 1
                bad_cd = is_cd & ((cd_addr + wlen > tb.cd_t) | (wlen > s["mbl"]))
                mcd = is_cd & ~bad_cd
                push_ring(mcd, distance)
                s["err"] = s["err"] | torch.where(bad_cd, ERR_STREAM, 0)
                addr = addr - tb.cd_t
            sref = is_dict & ~is_cd
            shift = consts[160 + wlen.clamp(0, 31)]
            bad_d = sref & (too_big | (wlen > 31) | (wlen < 4) | (shift == 0))
            md = sref & ~bad_d
            sh = shift.clamp(0, 30)
            word_idx = addr & ((1 << sh) - 1)
            tfi = (addr & _M32) >> sh
            bad_t = md & (tfi >= 121)
            md = md & ~bad_t
            meta1 = tfm[(2 * tfi).clamp(0, 255)]
            meta2 = tfm[(2 * tfi + 1).clamp(0, 255)]
            pre_len, op = (meta1 >> 5) & 15, meta1 & 31
            omit_first = torch.minimum(
                torch.where((op >= 12) & (op <= 20), op - 11, 0), wlen)
            omit_last = torch.where((op >= 1) & (op <= 9), op, 0)
            body = (wlen - omit_first - omit_last).clamp(min=0)
            woff = consts[192 + wlen.clamp(0, 31)] + wlen * word_idx + omit_first
            total = pre_len + body + (meta2 & 15)
            bad_len = md & (total > s["mbl"])
            md = md & ~bad_len
            s["err"] = s["err"] | torch.where(bad_d | bad_t | bad_len,
                                              ERR_STREAM, 0)
            words = md | mcd
            total = torch.where(mcd, wlen, total)
            s["mbl"] = s["mbl"] - torch.where(words, total, 0)
            if bool(words.any()):
                dict_bytes(words, total, torch.where(mcd, 0, pre_len),
                           torch.where(mcd, wlen, body),
                           torch.where(mcd, cd_addr, woff), meta1 >> 9,
                           meta2 >> 4, torch.where(mcd, 0, op), mcd)
            set_where(words, phase=torch.where(s["mbl"] <= 0, DONE, CMD))
            tail = words & (total > 0) & (s["mbl"] <= 0)

        # ---- consume q bits ----
        hi_l = (q >> 5) >= 1
        c0 = torch.where(hi_l, s["b1"], s["b0"])
        c1 = torch.where(hi_l, s["b2"], s["b1"])
        c2 = torch.where(hi_l, 0, s["b2"])
        mq = q & 31
        nz = mq != 0
        s["b0"] = ((c0 >> mq) | torch.where(nz, (c1 << (32 - mq)) & _M32, 0)) & _M32
        s["b1"] = ((c1 >> mq) | torch.where(nz, (c2 << (32 - mq)) & _M32, 0)) & _M32
        s["b2"] = c2 >> mq
        s["avail"] = s["avail"] - q
        # the reference's DICT rows of a word that ends the metablock
        refill(tail & (s["avail"] <= 64) & (s["widx"] < tb.wpad))

    status = torch.zeros((STATUS_ROWS, n), dtype=i64, device=dev)
    for r, k in enumerate(("err", None, "phase", "mbl", "widx", "avail",
                           "r0", "r1", "r2", "r3")):
        status[r] = (s["wpos"] + 3) >> 2 if k is None else s[k]
    out = buf[: n * stride].reshape(n, stride)
    return out, _wrap32(status).to(torch.int32)


# ---------------------------------------------------------------------------
# drivers
# ---------------------------------------------------------------------------

def run_staged_v3(staged, use_dict: bool = True):
    """Decode a batch that ops/stage3_native.py staged (a StagedV3), on its
    device.

    Returns (out (n_lanes, out_cap) uint8, status (16, n_lanes) int32) as
    device tensors: lane l's metablock is out[l, :mlen], its status rows
    err, r_lane, phase, mbl, widx, avail, r0..r3, then zeros."""
    tb = staged.tb
    out, status = decode3(tb, use_dict)
    return out[:, tb.hrb:], status


def run_batch_v3(batch: V3Batch, device: torch.device | str,
                 use_dict: bool = True, custom_dictionary=None,
                 dict_dev=None):
    """The yardstick's batch (counterpart of the reference's staged_v3 +
    run_batch_v3): batch_to_torch_v3 stages the V3Batch on `device`, then
    as run_staged_v3."""
    tb = batch_to_torch_v3(batch, device, custom_dictionary, dict_dev)
    out, status = decode3(tb, use_dict)
    return out[:, tb.hrb:], status


def _lanes(batch: V3Batch, out: torch.Tensor, status: torch.Tensor):
    """Host copies of a run: (status (16, n) int64 with WIDX_GUARD or-ed
    into the err row of lanes that read past their own words, bytes).
    The yardstick of collect_lanes_v3_pinned."""
    st = status.cpu().numpy().astype(np.int64)
    # truncated-stream guard: the word table is zero-padded, so a lane cut
    # short can decode padding to DONE; one that consumed words past its
    # stream (+ the lookahead's slack) is re-decoded on the host, which
    # raises the reference's error
    if batch.n_words is not None:
        over = st[4] > batch.n_words.astype(np.int64) + 4
        st[0] = np.where(over, st[0] | WIDX_GUARD, st[0])
    return st, out.cpu().numpy()


def _to_host(*tensors) -> list[np.ndarray]:
    """Device tensors into pinned buffers on the current stream, with one
    synchronise; CPU tensors as they lie."""
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            .copy_(t, non_blocking=True) for t in tensors]
    torch.cuda.current_stream(tensors[0].device).synchronize()
    return [t.numpy() for t in host]


def lane_flags(staged, status: np.ndarray) -> np.ndarray:
    """Each lane's err row with WIDX_GUARD or-ed in where it read past its
    own words (_lanes' rule), 0 for a pad lane."""
    err = status[0].astype(np.int64)
    over = status[4].astype(np.int64) > staged.n_words.astype(np.int64) + 4
    return np.where(staged.perm >= 0, np.where(over, err | WIDX_GUARD, err), 0)


def collect_lanes_v3_pinned(staged, streams: list[bytes], out: torch.Tensor,
                            status: torch.Tensor,
                            custom_dictionary=None) -> list[bytes]:
    """Each stream's bytes from a finished StagedV3, in stream order.

    On the card the bytes and the status rows go into pinned buffers on the
    current stream, with one synchronise; on the CPU they are read where
    they lie.  A lane that ends flagged, or that read past its own words
    (WIDX_GUARD), is re-decoded on the host, and counted in
    fallback_stats()."""
    raw, st = _to_host(out.contiguous(), status)
    flags = lane_flags(staged, st)
    perm = staged.perm
    live = perm >= 0
    results: list[bytes | None] = [None] * staged.n_streams
    flat = memoryview(raw.reshape(-1))
    stride = raw.shape[1]
    good = np.flatnonzero(live & (flags == 0))
    for slot, i, m in zip(good.tolist(), perm[good].tolist(),
                          staged.mlens[good].tolist()):
        results[i] = bytes(flat[slot * stride: slot * stride + m])
    fell = np.flatnonzero(live & (flags != 0))
    for i in perm[fell].tolist():
        results[i] = host_decode(streams[i],
                                 custom_dictionary=custom_dictionary)
    _note_fallbacks(staged.n_streams, int(fell.size))
    return results  # type: ignore[return-value]


def decode_batch_v3(streams: list[bytes], *,
                    device: torch.device | str = "cuda",
                    use_dict: bool = True, max_groups: int = GROUP_CAP_V3,
                    custom_dictionary=None, dict_dev=None) -> list[bytes]:
    """Full-format decode of single-metablock streams on `device`.

    Any stream of one compressed metablock is device-eligible whatever its
    entropy layout (context maps, block switching, tree groups, static and
    compound dictionary).  The batch is staged natively
    (ops/stage3_native.stage_v3_native: groups of 128 lanes, one pinned
    buffer, one copy) and unpacked through pinned buffers
    (collect_lanes_v3_pinned).  Flagged lanes re-decode on the host; a batch
    the staging refuses (another stream shape, more lanes than `max_groups`
    groups of 1024 hold) is host-decoded whole.  Both count in
    fallback_stats().  `dict_dev`: the static dictionary already on
    `device` (stage_dictionary), so that the call uploads none."""
    from . import stage3_native as S3

    staged = S3.stage_v3_native(streams, device, max_groups=max_groups,
                                custom_dictionary=custom_dictionary,
                                dict_dev=dict_dev)
    if staged is None:
        _note_fallbacks(len(streams), len(streams))
        return [host_decode(s, custom_dictionary=custom_dictionary)
                for s in streams]
    out, status = run_staged_v3(staged, use_dict)
    return collect_lanes_v3_pinned(staged, streams, out, status,
                                   custom_dictionary)


def decode_batch_v3_full(streams: list[bytes], *,
                         device: torch.device | str = "cuda",
                         use_dict: bool = True,
                         max_groups: int = GROUP_CAP_V3,
                         custom_dictionary=None,
                         dict_dev=None) -> list[bytes]:
    """Decode arbitrary (multi-metablock) Brotli streams on `device`.

    The host walks each stream's metablock headers: metadata blocks are
    skipped and uncompressed blocks copied, while each compressed metablock
    becomes a unit of device work carrying its continuation (all earlier
    output as the history prefix, the distance ring, the last two bytes).
    Units across streams are binned by their tables and decoded in rounds,
    one kernel launch a round; the walk and the staging are one C++ call
    each a round (ops/stage3_native.py: walk_ptrs, stage_units_v3_native).
    Each stream's output so far stays on the device (DeviceHistory): a
    round uploads only the bytes the walk copied, appends its lanes'
    bytes there, and gathers the next round's prefixes from it; the host
    fetches each stream's output once, at the end.  The status rows give
    the exact end bit (32*widx - avail) from which the host reads the next
    header.  Streams beyond the _FULL_* caps, or lanes that flag, are
    decoded on the host and counted in fallback_stats().  `dict_dev` as
    for decode_batch_v3: every round reads that one dictionary."""
    from . import stage3_native as S3

    dev = resolve_device(device)
    if dict_dev is not None:
        _check_dict_dev(dict_dev, dev)
    n = len(streams)
    src = S3.StreamPtrs(streams)
    history = S3.DeviceHistory(n, dev)
    bitpos = np.zeros(n, np.int64)   # 0: the stream's first bit
    rings = np.tile(np.array([[4], [11], [15], [16]], np.int64), (1, n))
    maxbw = np.zeros(n, np.int64)
    live = np.ones(n, bool)
    failed = np.zeros(n, bool)

    while True:
        # the header walk (native): each live stream to its next compressed
        # metablock, the bytes of uncompressed ones copied on the way
        todo = np.flatnonzero(live)
        if not todo.size:
            break
        walked = S3.walk_ptrs(src, todo, bitpos[todo])
        wu = walked.units
        first = bitpos[todo] == 0
        maxbw[todo[first]] = wu[first, 3]
        copies = np.flatnonzero(wu[:, 5])
        history.append_copies(todo[copies], walked, copies)
        failed[todo[wu[:, 0] < 0]] = True
        live[todo[wu[:, 0] != 1]] = False
        found = wu[:, 0] == 1
        if not found.any():
            break
        idx = todo[found]
        is_last = np.zeros(n, bool)
        is_last[idx] = wu[found, 4] != 0
        staged = S3.stage_units_v3_native(
            src, idx, wu[found, 2], wu[found, 1], maxbw[idx], rings[:, idx],
            history, dev, max_groups=max_groups,
            custom_dictionary=custom_dictionary, dict_dev=dict_dev)
        # units the parse refused (a malformed table, beyond the _FULL_*
        # caps), or all of them when over the group budget
        placed = np.zeros(n, bool)
        if staged is not None:
            placed[staged.perm[staged.perm >= 0]] = True
        refused = idx[~placed[idx]]
        failed[refused] = True
        live[refused] = False
        if staged is None:
            break
        out, status = run_staged_v3(staged, use_dict)
        st = _to_host(status)[0]
        flags = lane_flags(staged, st)
        slots = np.flatnonzero(staged.perm >= 0)
        bad, good = slots[flags[slots] != 0], slots[flags[slots] == 0]
        failed[staged.perm[bad]] = True
        live[staged.perm[bad]] = False
        i = staged.perm[good]
        history.append(i, out[torch.from_numpy(good).to(dev)],
                       staged.mlens[good])
        rings[:, i] = st[6:10, good]
        done = is_last[i]
        live[i[done]] = False
        # each lane's words start at the word of its first command
        go = good[~done]
        bitpos[staged.perm[go]] = (32 * staged.w0[go] + 32 * st[4, go]
                                   - st[5, go])

    outs = history.fetch(np.flatnonzero(~failed))
    results = [
        host_decode(streams[i], custom_dictionary=custom_dictionary)
        if failed[i] else outs[i]
        for i in range(n)
    ]
    _note_fallbacks(n, int(failed.sum()))
    return results
