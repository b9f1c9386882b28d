"""Quality-10 Zopfli DP on a torch device.  Counterpart of
brotli_tpu/ops/device_zopfli.py.

The contract is DECISION EQUALITY with the host
`create_zopfli_backward_references` (the port's copy,
encode/backward_refs_hq.py): the same node arrays, so the same commands
and last insert.  Matches are collected on the host, with the host's trim
rule and visit schedule; the node relaxation (the 8-entry start-position
queue, the distance-cache candidates with their byte compares, the
relaxation of every length of a candidate or a match, all in float64 in the
host's order) runs as the CUDA kernel csrc/zopfli.cu on CUDA tensors, one
warp a lane, its nodes near the current position in a window in shared
memory (zopfli_dp; the first kernel, every node in device memory, stays as
zopfli_dp_direct); the backtrack runs on the host.

Where the JAX DP departs from the host, the port follows the host:

* node `length` and `dcode_insert_length` are uint32 (int32 bit patterns in
  the tensors, read with logical shifts); JAX keeps int32, so a node with
  short code 16 reads back negative there (16 << 27 = 2^31);
* a position may have any number of matches (a compact list with
  per-position offsets), where JAX asserts at most MAXC = 64;
* the minimum copy length is not capped (JAX: 96 steps);
* the host's quick step (a position whose largest relaxed length reaches
  LONG_COPY_QUICK_STEP skips ahead by it) changes which positions the host
  visits, and so the matches the hasher finds after it.
  `zopfli_commands_device` runs the DP, finds the first position after
  which the host visits another position than the match schedule did (the
  quick step and the long-match skip are one skip, so a quick step the
  schedule already took agrees), collects the matches again with that skip
  and runs the DP again.  Each pass is exact up to that position, so the
  loop ends.

A lane is one stream.  CPU tensors take `zopfli_dp_ref`; `zopfli_dp_host`
runs either kernel's per-lane code built by g++ (csrc/host_shim.cpp), for
the tests.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..constants import (
    COPY_LENGTH_N_BITS,
    COPY_LENGTH_OFFSET,
    INSERT_LENGTH_N_BITS,
    combine_length_codes,
    get_insert_length_code,
)
from ..device import resolve_device
from ..encode.api import _NO_MASK, _padded
from ..encode.backward_refs_hq import (
    _DIST_CACHE_INDEX,
    _DIST_CACHE_OFFSET,
    LONG_COPY_QUICK_STEP,
    MAX_BACKWARD_LIMIT,
    StartPosQueue,
    ZopfliNode,
    _compute_shortest_path,
    _create_commands_from_path,
    _trim_long_matches,
    max_zopfli_len,
)
from ..encode.command import prefix_encode_copy_distance
from ..encode.cost_model import INFINITY_COST, ZopfliCostModel
from ..encode.hash_binary_tree import BinaryTreeHasher

# Launches of the CUDA DP kernels, counted where each launches: the window
# kernel (zopfli_dp) and the direct kernel (zopfli_dp_direct).
KERNEL_LAUNCHES = 0
DIRECT_LAUNCHES = 0

START_CACHE = (4, 11, 15, 16)
NUM_CMD = 704
DIST_ROW = 1024    # cost_dist padded with +inf past its 544 symbols
MAX_N = 1 << 25    # a node's copy-length field
_M32 = 0xFFFFFFFF
# the window kernel's shared memory (csrc/zopfli.cu): the cost tables, and
# 68 B a window slot (a node, 24 B; a literal cost, 8 B; the shortcut walk
# its last relaxation noted, 20 B; a distance-cache record, 16 B)
TABLE_BYTES = 8 * (NUM_CMD + DIST_ROW)
SLOT_BYTES = 68
WINDOW_MIN = 64
LANES_PER_SM = 8   # the most one-warp blocks launch_config puts on an SM
_F64 = torch.float64
_I32 = torch.int32


def collect_matches(data: bytes, quality: int = 10, quick=None):
    """The host's match collection for one stream: the ordered match sets
    the sequential q10 loop sees, trimmed as it trims them, at the
    positions it visits.  `quick` maps a position to the DP's largest
    relaxed length there, for each position where the host's quick step
    applies (see zopfli_commands_device).

    Returns numpy arrays moff (n + 1,) int32, mlen, mdist, mdelta (M,)
    int32 and active (n,) bool: the matches of position p are
    [moff[p], moff[p + 1])."""
    quick = quick or {}
    n = len(data)
    padded = _padded(bytes(data))
    hasher = BinaryTreeHasher(22, n)
    max_zlen = max_zopfli_len(quality)
    counts = np.zeros(n, np.int32)
    active = np.zeros(n, bool)
    found = []
    i = 0
    while i + 3 < n:
        active[i] = True
        matches = hasher.find_all_matches(padded, _NO_MASK, i, n - i,
                                          min(i, MAX_BACKWARD_LIMIT))
        matches = _trim_long_matches(matches, max_zlen)
        counts[i] = len(matches)
        found.extend(matches)
        if i in quick:
            i += quick[i] - 1
        elif len(matches) == 1 and matches[0].length > max_zlen:
            i += matches[0].length - 1
        i += 1
    moff = np.zeros(n + 1, np.int32)
    np.cumsum(counts, out=moff[1:])
    mlen, mdist, mdelta = (np.asarray([getattr(m, f) for m in found],
                                      np.int32).reshape(-1)
                           for f in ("length", "distance", "len_code_delta"))
    return moff, mlen, mdist, mdelta, active


@dataclass
class ZopfliBatch:
    """The DP's inputs for B lanes, on one device.  N is the longest lane.

    data (B, S) uint8, S >= N; lit_cost (B, N + 2), cost_cmd (B, 704),
    cost_dist (B, 1024) (+inf past 544) and min_cost_cmd (B,) float64;
    start_cache (B, 4), n_valid (B,) and moff (B, N + 1) int32; mlen,
    mdist, mdelta (M,) int32, the matches of every lane in lane order (moff
    absolute into them); active (B, N) bool; max_zlen, the host's
    max_zopfli_len."""
    data: torch.Tensor
    lit_cost: torch.Tensor
    cost_cmd: torch.Tensor
    cost_dist: torch.Tensor
    min_cost_cmd: torch.Tensor
    start_cache: torch.Tensor
    n_valid: torch.Tensor
    moff: torch.Tensor
    mlen: torch.Tensor
    mdist: torch.Tensor
    mdelta: torch.Tensor
    active: torch.Tensor
    max_zlen: int

    @property
    def n_lanes(self) -> int:
        return self.data.shape[0]

    @property
    def n_max(self) -> int:
        return self.lit_cost.shape[1] - 2

    @property
    def device(self) -> torch.device:
        return self.data.device


class ZopfliNodes(NamedTuple):
    """The DP's outputs: node arrays (B, N + 1) -- cost float64; nlen,
    ndist, ndci, nsc int32 (nlen and ndci are uint32 bit patterns) --
    result (B, N) int32, the largest length relaxed at each position (the
    host's quick step reads it), and tried (B,) int64, the lengths the
    lane's relaxations tried."""
    cost: torch.Tensor
    nlen: torch.Tensor
    ndist: torch.Tensor
    ndci: torch.Tensor
    nsc: torch.Tensor
    result: torch.Tensor
    tried: torch.Tensor


def stage_zopfli(chunks: list[bytes], quality: int = 10,
                 device: torch.device | str = "cuda",
                 quick=None) -> ZopfliBatch:
    """The host's cost model (ZopfliCostModel(n, 544) from the literal
    costs) and matches for each chunk, one lane each, as a ZopfliBatch on
    `device`.  `quick` gives collect_matches' quick-step skips, one dict a
    lane."""
    dev = resolve_device(device)
    if quality > 10:
        raise ValueError("the DP is the quality-10 one (one queue entry a "
                         f"position); got quality {quality}")
    if not chunks:
        raise ValueError("no chunks")
    B = len(chunks)
    n_max = max(max(len(c) for c in chunks), 1)
    if n_max >= MAX_N:
        raise ValueError(f"a chunk of {n_max} B: the DP takes under {MAX_N}")
    data = np.zeros((B, n_max), np.uint8)
    lit = np.zeros((B, n_max + 2), np.float64)
    cmd = np.zeros((B, NUM_CMD), np.float64)
    dist = np.full((B, DIST_ROW), np.inf, np.float64)
    min_cost = np.zeros(B, np.float64)
    n_valid = np.zeros(B, np.int32)
    moff = np.zeros((B, n_max + 1), np.int32)
    active = np.zeros((B, n_max), bool)
    found, base = [], 0
    for b, chunk in enumerate(chunks):
        n = len(chunk)
        model = ZopfliCostModel(n, 544)
        model.set_from_literal_costs(0, _padded(bytes(chunk)), _NO_MASK)
        data[b, :n] = np.frombuffer(bytes(chunk), np.uint8)
        lit[b, : n + 2] = model.literal_costs[: n + 2]
        cmd[b] = model.cost_cmd
        dist[b, :544] = model.cost_dist
        min_cost[b] = model.get_min_cost_cmd()
        n_valid[b] = n
        off, ml, md, mdl, act = collect_matches(
            chunk, quality, quick[b] if quick else None)
        moff[b, : n + 1] = off + base
        moff[b, n + 1:] = off[-1] + base
        active[b, :n] = act
        found.append((ml, md, mdl))
        base += len(ml)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return ZopfliBatch(
        put(data), put(lit), put(cmd), put(dist), put(min_cost),
        put(np.tile(np.asarray(START_CACHE, np.int32), (B, 1))),
        put(n_valid), put(moff),
        *(put(np.concatenate([f[k] for f in found]).astype(np.int32))
          for k in range(3)),
        put(active), max_zopfli_len(quality))


def _check_batch(zb: ZopfliBatch) -> None:
    """dtype, shape, device and contiguity of every tensor, and the bounds
    the kernel indexes by: moff's lanes in order over the match list, each
    match inside its lane (pos + length <= n), distances >= 1."""
    B, N = zb.n_lanes, zb.n_max
    if zb.data.dim() != 2 or zb.data.shape[1] < N or N < 1:
        raise ValueError(f"data: want uint8 (B, S >= N), got "
                         f"{tuple(zb.data.shape)} with N = {N}")
    M = zb.mlen.shape[0] if zb.mlen.dim() == 1 else -1
    want = {"data": (torch.uint8, tuple(zb.data.shape)),
            "lit_cost": (_F64, (B, N + 2)), "cost_cmd": (_F64, (B, NUM_CMD)),
            "cost_dist": (_F64, (B, DIST_ROW)), "min_cost_cmd": (_F64, (B,)),
            "start_cache": (_I32, (B, 4)), "n_valid": (_I32, (B,)),
            "moff": (_I32, (B, N + 1)), "mlen": (_I32, (M,)),
            "mdist": (_I32, (M,)), "mdelta": (_I32, (M,)),
            "active": (torch.bool, (B, N))}
    for name, (dtype, shape) in want.items():
        t = getattr(zb, name)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != zb.device:
            raise ValueError(f"{name} is on {t.device}, data on {zb.device}")
    nv = zb.n_valid.to(torch.int64)
    starts = torch.cat([zb.moff.new_zeros(1), zb.moff[:-1, -1]])
    bad = (bool((nv < 0).any()) or bool((nv > N).any())
           or bool((zb.moff[:, 0] != starts).any())
           or bool((zb.moff[:, 1:] < zb.moff[:, :-1]).any())
           or int(zb.moff[-1, -1]) != M)
    if not bad and M:
        counts = (zb.moff[:, 1:] - zb.moff[:, :-1]).reshape(-1).to(torch.int64)
        at = torch.arange(B * N, device=zb.device)
        pos = torch.repeat_interleave(at % N, counts)
        lane_n = torch.repeat_interleave(nv.repeat_interleave(N), counts)
        bad = (bool((zb.mdist < 1).any()) or bool((zb.mlen < 2).any())
               or bool((pos + zb.mlen > lane_n).any()))
    if bad:
        raise ValueError("matches out of bounds: moff must walk the match "
                         "list lane by lane, and every match must have "
                         "distance >= 1 and end inside its lane")


def _alloc_nodes(zb: ZopfliBatch) -> ZopfliNodes:
    """The outputs, uninitialised: the kernel and the shim set them."""
    B, N, dev = zb.n_lanes, zb.n_max, zb.device
    return ZopfliNodes(
        torch.empty((B, N + 1), dtype=_F64, device=dev),
        *(torch.empty((B, N + 1), dtype=_I32, device=dev) for _ in range(4)),
        torch.empty((B, N), dtype=_I32, device=dev),
        torch.empty(B, dtype=torch.int64, device=dev))


def _c_args(zb: ZopfliBatch, out: ZopfliNodes, grid: int) -> list:
    """The argument list of brotli_torch_zopfli_direct (and its host
    shim): the tensors' pointers, the sizes, and `grid`, the SM count the
    kernel sizes its grid by."""
    ins = (zb.data, zb.lit_cost, zb.cost_cmd, zb.cost_dist, zb.min_cost_cmd,
           zb.start_cache, zb.n_valid, zb.moff, zb.mlen, zb.mdist,
           zb.mdelta, zb.active)
    return ([t.data_ptr() for t in (*ins, *out)]
            + [zb.n_lanes, zb.n_max, zb.data.shape[1], zb.max_zlen, grid])


def _c_args_win(zb: ZopfliBatch, out: ZopfliNodes, blocks: int,
                window: int) -> tuple[list, torch.Tensor]:
    """The argument list of brotli_torch_zopfli (and its host shim): the
    direct kernel's with the records' scratch after the pointers, the
    block count for the grid and the window last; and the scratch, which
    must live until the kernel has run."""
    rec = torch.empty((zb.n_lanes, zb.n_max + 1, 4), dtype=_I32,
                      device=zb.device)
    args = _c_args(zb, out, blocks)
    return args[:19] + [rec.data_ptr()] + args[19:] + [window], rec


def launch_config(n_lanes: int, n_max: int, sms: int, smem_block: int,
                  smem_sm: int) -> tuple[int, int]:
    """(blocks, window slots) of zopfli_kernel for n_lanes lanes of up to
    n_max positions on a card of `sms` SMs, `smem_block` bytes of shared
    memory a block at most (its opt-in limit) and `smem_sm` an SM.  A block
    is one warp and one lane at a time; the blocks an SM holds (as many as
    the lanes need, at most LANES_PER_SM) share its shared memory, less the
    runtime's 1 KB a block and the tables.  The window is the
    largest power of two of slots that fits, no larger than a lane needs
    (n_max + 1 nodes) and at least WINDOW_MIN."""
    per_sm = max(1, min(-(-n_lanes // sms), LANES_PER_SM))
    room = (min(smem_block, smem_sm // per_sm - 1024)
            - TABLE_BYTES) // SLOT_BYTES
    fit = 1 << max(0, room.bit_length() - 1)
    need = 1 << n_max.bit_length()
    return min(n_lanes, sms * per_sm), max(WINDOW_MIN, min(fit, need))


def card_config(zb: ZopfliBatch) -> tuple[int, int]:
    """launch_config for `zb` on its card.  A block's opt-in limit is the
    SM's shared memory less the runtime's 1 KB where PyTorch does not
    report it."""
    props = torch.cuda.get_device_properties(zb.device)
    smem_sm = props.shared_memory_per_multiprocessor
    return launch_config(
        zb.n_lanes, zb.n_max, props.multi_processor_count,
        getattr(props, "shared_memory_per_block_optin", smem_sm - 1024),
        smem_sm)


def _on_card(zb: ZopfliBatch) -> bool:
    """False for CPU tensors, which take zopfli_dp_ref; True for a checked
    batch of CUDA tensors; raises on another device."""
    if zb.device.type == "cpu":
        return False
    if zb.device.type != "cuda":
        raise ValueError(f"unsupported device {zb.device}")
    _check_batch(zb)
    return True


def zopfli_dp(zb: ZopfliBatch) -> ZopfliNodes:
    """The q10 node relaxation of every lane (see ZopfliNodes).  CPU
    tensors take zopfli_dp_ref; CUDA tensors launch csrc/zopfli.cu
    `zopfli_kernel`, one warp a lane with its node window in shared memory,
    sized by launch_config.  A failed launch raises."""
    return _launch(zb) if _on_card(zb) else zopfli_dp_ref(zb)


def zopfli_dp_direct(zb: ZopfliBatch) -> ZopfliNodes:
    """zopfli_dp through the first kernel, `zopfli_direct_kernel` (every
    node in device memory), the yardstick the window kernel is timed
    against; no main path launches it.  CPU tensors take zopfli_dp_ref."""
    return _launch_direct(zb) if _on_card(zb) else zopfli_dp_ref(zb)


def _launch(zb: ZopfliBatch) -> ZopfliNodes:
    """The window kernel on a checked batch of CUDA tensors."""
    global KERNEL_LAUNCHES
    out = _alloc_nodes(zb)
    blocks, window = card_config(zb)
    args, rec = _c_args_win(zb, out, blocks, window)
    _run("brotli_torch_zopfli", args, zb,
         f"zopfli kernel ({blocks} blocks, window {window})")
    KERNEL_LAUNCHES += 1
    del rec  # back to the caching allocator, in this stream's order
    return out


def _launch_direct(zb: ZopfliBatch) -> ZopfliNodes:
    """The direct kernel on a checked batch of CUDA tensors."""
    global DIRECT_LAUNCHES
    out = _alloc_nodes(zb)
    sms = torch.cuda.get_device_properties(zb.device).multi_processor_count
    _run("brotli_torch_zopfli_direct", _c_args(zb, out, sms), zb,
         "zopfli direct kernel")
    DIRECT_LAUNCHES += 1
    return out


def _run(entry: str, args: list, zb: ZopfliBatch, what: str) -> None:
    """Launch a kernel's C entry on the batch's current stream; raises
    when it reports an error."""
    from ..build import kernels_lib

    with torch.cuda.device(zb.device):
        rc = getattr(kernels_lib(), entry)(
            *args, torch.cuda.current_stream(zb.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")


def zopfli_dp_host(zb: ZopfliBatch, window: int | None = None) -> ZopfliNodes:
    """csrc/zopfli.cuh's per-lane DP built for the CPU (build.host_lib),
    the warp's steps as loops: for the tests, which hold it against
    zopfli_dp_ref and the host.  window None runs the direct kernel's code
    (zopfli_step); a power of two >= WINDOW_MIN runs the window kernel's
    (zopfli_lane_win) at that many slots."""
    from ..build import host_lib

    _check_batch(zb)
    if zb.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out = _alloc_nodes(zb)
    if window is None:
        rc = host_lib().brotli_torch_zopfli_direct_host(*_c_args(zb, out, 0))
    else:
        args, _ = _c_args_win(zb, out, 1, window)
        rc = host_lib().brotli_torch_zopfli_host(*args)
    if rc:
        raise ValueError("host shim refused the batch")
    return out


@functools.cache
def _tables(device: torch.device):
    """(copy-length offsets int64, copy extra bits float64, the command
    code of (insert code, copy code, use_last) as a (24, 24, 2) int64
    table) on `device`."""
    cmd = [[[combine_length_codes(i, c, bool(u)) for u in (0, 1)]
            for c in range(24)] for i in range(24)]
    return (torch.tensor(COPY_LENGTH_OFFSET.tolist(), device=device),
            torch.tensor(COPY_LENGTH_N_BITS.tolist(), dtype=_F64,
                         device=device),
            torch.tensor(cmd, device=device))


def _bits32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return (((x + (1 << 31)) & _M32) - (1 << 31)).to(_I32)


def zopfli_dp_ref(zb: ZopfliBatch) -> ZopfliNodes:
    """Plain PyTorch version of zopfli_dp, on the inputs' device.  Lane by
    lane, it walks the positions in order as the host loop does, with the
    queue and the serial steps in Python over values read from the node
    tensors, and the lengths of one candidate or one match relaxed as one
    masked tensor update."""
    _check_batch(zb)
    B, N, dev = zb.n_lanes, zb.n_max, zb.device
    cost = torch.full((B, N + 1), INFINITY_COST, dtype=_F64, device=dev)
    cost[:, 0] = 0.0
    # a node's four int32 fields (nlen, ndist, ndci, nsc) side by side,
    # so that one copy reads a node
    fields = torch.zeros((B, N + 1, 4), dtype=_I32, device=dev)
    fields[:, 1:, 0] = 1
    result = torch.zeros((B, N), dtype=_I32, device=dev)
    tried = [_ref_lane(zb, b, cost[b], fields[b], result[b])
             for b in range(B)]
    return ZopfliNodes(cost, *(fields[..., k].contiguous() for k in range(4)),
                       result, torch.tensor(tried, device=dev))


def _min_copy_length(cost: torch.Tensor, n: int, pos: int,
                     min_cost: float) -> int:
    """_compute_minimum_copy_length over the node costs `cost` (n + 1 of
    them), without a step cap: the costs ahead are read 64 at a time."""
    ln, bucket, nxt = 2, 4, 10
    ahead: list[float] = []
    while pos + ln <= n:
        if ln - 2 == len(ahead):
            lo = pos + 2 + len(ahead)
            ahead += cost[lo: min(lo + 64, n + 1)].tolist()
        if not ahead[ln - 2] <= min_cost:
            break
        ln += 1
        if ln == nxt:
            min_cost += 1.0
            nxt += bucket
            bucket *= 2
    return ln


def _ref_lane(zb: ZopfliBatch, b: int, cost: torch.Tensor,
              fields: torch.Tensor, result_row: torch.Tensor) -> int:
    """Lane b of zopfli_dp_ref, into its rows of the outputs; returns the
    count of lengths tried."""
    dev = zb.device
    copy_off, copy_extra, cmd_lut = _tables(dev)
    n = int(zb.n_valid[b])
    data = zb.data[b, :n].tolist()
    lit = zb.lit_cost[b, : n + 2].tolist()
    cost_cmd = zb.cost_cmd[b]
    cost_dist = zb.cost_dist[b].tolist()
    min_cost_cmd = float(zb.min_cost_cmd[b])
    start_cache = zb.start_cache[b].tolist()
    moff = zb.moff[b, : n + 1].tolist()
    active = zb.active[b, :n].tolist()
    m_lo = moff[0] if n else 0
    mlen, mdist, mdelta = (t[m_lo: moff[-1]].tolist()
                           for t in (zb.mlen, zb.mdist, zb.mdelta))
    nlen, ndist, ndci, nsc = fields.unbind(1)
    queue = StartPosQueue()
    tried = 0

    def node(p):
        """(copy length, insert length, distance, short code, shortcut)"""
        ln, dist, dci, sc = fields[p].tolist()
        return (ln & 0x1FFFFFF, dci & 0x7FFFFFF, dist, (dci & _M32) >> 27,
                sc)

    def relax(pos, lo, hi, sel, cmds, dist, short_code, start,
              len_code=None):
        """Lengths lo..hi at once: sel[copy code] (the cost the command
        code cmds[copy code] starts from) plus the copy extra bits plus the
        command cost; a node takes the new cost only where it is strictly
        less.  Returns the largest length taken (0 for none)."""
        ls = torch.arange(lo, hi + 1, device=dev)
        codes = ls if len_code is None else torch.full_like(ls, len_code)
        cc = torch.bucketize(codes, copy_off, right=True) - 1
        c = (sel[cc] + copy_extra[cc]) + cost_cmd[cmds[cc]]
        seg = slice(pos + lo, pos + hi + 1)
        better = c < cost[seg]
        cost[seg] = torch.where(better, c, cost[seg])
        nlen[seg] = torch.where(
            better, _bits32(ls | ((ls + 9 - codes) << 25)), nlen[seg])
        ndist[seg] = torch.where(better, dist, ndist[seg])
        dci = (short_code << 27) | (pos - start)
        ndci[seg] = torch.where(better, dci - (dci >> 31 << 32), ndci[seg])
        return int((ls * better).max())

    for pos in range(max(n - 3, 0)):
        if not active[pos]:
            continue
        # _evaluate_node: the shortcut, then the push with its cache
        node_cost = float(cost[pos])
        clen, ilen, dist_here, short, _ = node(pos)
        dcode = dist_here + 15 if short == 0 else short - 1
        if pos == 0:
            sc = 0
        elif dist_here + clen <= pos and dist_here <= MAX_BACKWARD_LIMIT \
                and dcode > 0:
            sc = pos
        else:
            sc = node(pos - clen - ilen)[4]
        nsc[pos] = sc
        lc0 = lit[pos] - lit[0]
        if node_cost <= lc0:
            cache, p = [], sc
            while len(cache) < 4 and p > 0:
                cl, il, d, _, _ = node(p)
                cache.append(d)
                p = node(p - cl - il)[4]
            filled = len(cache)
            cache += [start_cache[k - filled] for k in range(filled, 4)]
            queue.push(pos, node_cost, node_cost - lc0, cache)
        head = queue.at(0)
        start, cache = head.pos, head.distance_cache
        min_len = _min_copy_length(
            cost, n, pos, (head.cost + min_cost_cmd) + (lit[pos] - lit[start]))
        if queue.size() == 0:
            continue

        max_distance = min(pos, MAX_BACKWARD_LIMIT)
        max_len = n - pos
        ins_code = get_insert_length_code(pos - start)
        base_cost = (head.costdiff + int(INSERT_LENGTH_N_BITS[ins_code])) + lc0
        result = 0
        best_len = min_len - 1
        for j in range(16):
            if best_len >= max_len:
                break
            backward = cache[_DIST_CACHE_INDEX[j]] + _DIST_CACHE_OFFSET[j]
            if backward <= 0 or backward > max_distance:
                continue
            prev = pos - backward
            if data[prev + best_len] != data[pos + best_len]:
                continue
            ln = 0
            while ln < max_len and data[prev + ln] == data[pos + ln]:
                ln += 1
            if ln < 4 or ln <= best_len:
                continue
            # the command codes below 128 use the last distance
            # implicitly and start from base_cost
            cmds = cmd_lut[ins_code, :, int(j == 0)]
            sel = torch.full((24,), base_cost + cost_dist[j], dtype=_F64,
                             device=dev)
            sel[cmds < 128] = base_cost
            result = max(result, relax(pos, best_len + 1, ln, sel, cmds,
                                       backward, j + 1, start))
            tried += ln - best_len
            best_len = ln

        match_len = min_len
        cmds = cmd_lut[ins_code, :, 0]
        for k in range(moff[pos] - m_lo, moff[pos + 1] - m_lo):
            dist, m_len = mdist[k], mlen[k]
            is_dict = dist > max_distance
            sym, _, nbits = prefix_encode_copy_distance(dist + 15, 0, 0)
            dist_cost = (base_cost + nbits) + cost_dist[sym & 0x3FF]
            if match_len < m_len and (is_dict or m_len > zb.max_zlen):
                match_len = m_len
            if match_len > m_len:
                continue
            sel = torch.full((24,), dist_cost, dtype=_F64, device=dev)
            result = max(result, relax(
                pos, match_len, m_len, sel, cmds, dist, 0, start,
                m_len + mdelta[k] if is_dict else None))
            tried += m_len - match_len + 1
            match_len = m_len + 1
        result_row[pos] = result
    return tried


def backtrack(nodes: ZopfliNodes, lane: int, n: int):
    """The host's backtrack over one lane's node arrays, as at
    brotli_tpu/ops/device_zopfli.py:460-474: ZopfliNodes of the host's
    class, _compute_shortest_path and _create_commands_from_path.  Returns
    (commands, last insert length)."""
    cost, nlen, ndist, ndci, nsc = (t[lane, : n + 1].cpu().tolist()
                                    for t in nodes[:5])
    path = []
    for i in range(n + 1):
        node = ZopfliNode()
        node.length = nlen[i] & _M32
        node.distance = ndist[i]
        node.dcode_insert_length = ndci[i] & _M32
        node.cost = cost[i]
        node.shortcut = nsc[i]
        path.append(node)
    _compute_shortest_path(n, path)
    commands, _, last_insert = _create_commands_from_path(
        n, 0, path, list(START_CACHE), 0, 0, 0)
    return commands, last_insert


def _quick_mismatch(result: np.ndarray, active: np.ndarray,
                    quick: dict) -> int | None:
    """The first visited position after which the host visits another
    position than the schedule did.  The host's quick step and its
    long-match skip are one `i += skip - 1`: after a position p whose
    result reaches LONG_COPY_QUICK_STEP it visits p + result[p] (or leaves
    the loop, at n - 3 or past it), whichever skip the schedule took to
    get there; elsewhere it takes the long-match skip, which the schedule
    takes unless `quick` gave p a skip of its own."""
    end = len(active) - 3
    vis = np.flatnonzero(active)
    nxt = np.append(vis[1:], end)
    hit = result[vis] >= LONG_COPY_QUICK_STEP
    if quick:
        hit |= np.isin(vis, list(quick))
    for k in np.flatnonzero(hit).tolist():
        p, skip = int(vis[k]), int(result[vis[k]])
        if skip < LONG_COPY_QUICK_STEP or min(p + skip, end) != nxt[k]:
            return p
    return None


def zopfli_commands_device(data: bytes, quality: int = 10,
                           device: torch.device | str = "cuda"):
    """q10 optimal parse of one stream with the DP on `device` (the card
    unless the caller asks for the CPU): the commands and last insert
    length of the host create_zopfli_backward_references(len(data), 0,
    data, ..., dist_cache=[4, 11, 15, 16], last_insert_len=0), decision for
    decision.  One lane holds the stream.  Where the host's quick step
    skips elsewhere than the match schedule did, the matches are collected
    again with that skip and the DP runs again (_quick_mismatch)."""
    n = len(data)
    quick: dict[int, int] = {}
    while True:
        zb = stage_zopfli([data], quality, device, [quick])
        nodes = zopfli_dp(zb)
        p = _quick_mismatch(nodes.result[0, :n].cpu().numpy(),
                            zb.active[0, :n].cpu().numpy(), quick)
        if p is None:
            return backtrack(nodes, 0, n)
        quick = {k: v for k, v in quick.items() if k < p}
        if int(nodes.result[0, p]) >= LONG_COPY_QUICK_STEP:
            quick[p] = int(nodes.result[0, p])
