"""Per-lane-table decode: a batch of streams that each carry their own
Huffman tables, decoded on the device.  Counterpart of
brotli_tpu/ops/device_decode.py (the round-1 lockstep decode).

The v2 and v3 decoders stage lanes that share tables (a group's tables
once); this path takes streams compressed independently, each with its own
literal, command and distance trees, as encodes of separate objects at low
quality give them.  A stream is device-eligible when it is one compressed
metablock (the last) with one block type and one tree in each category
(ops/preflight2.preflight); ineligible streams and lanes the kernel flags
(a static-dictionary reference, a distance or copy out of range) are
decoded on the host and counted in ops/decode2.fallback_stats().

The host half preflights with one native parse of the batch
(`preflight_native`: native.preflight_batch_native; a library that fails
to build or load raises) and stages the batch into one buffer, pinned for
a CUDA device, that goes to the card in one copy (`stage_batch`): each
lane's u32 words one lane after another, a row of scalars a lane (where
its words start, how many, its first bit, mlen, max_backward, npostfix),
a row of tables a lane (csrc/device_decode.cuh's layout: literal,
command, distance tables, then the distance codes' extra bits and
offsets, 3718 int32) and the length LUT.  `device_decode` launches
csrc/device_decode.cu `device_decode_kernel` (a warp a lane: its tables
compacted, its words and its output window in shared memory) on CUDA
tensors and takes `device_decode_ref`, the plain PyTorch version, on CPU
tensors; `device_decode_direct` launches the first design,
`device_decode_direct_kernel`, kept to be timed against.  The outputs, as
the JAX kernel's: out (B, out_size) uint8 with out_size the batch's
largest mlen, pos (B,) int32, err (B,) bool; `fetch_outputs` brings them
to the host through pinned buffers.

Words and tables are int32 tensors holding the u32 bit patterns.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..decode import decode as host_decode
from ..device import resolve_device
from .decode2 import _note_fallbacks
from .preflight2 import (
    CMD_TABLE_SIZE,
    DIST_TABLE_SIZE,
    LIT_TABLE_SIZE,
    MAX_DIST_ALPHABET,
    PreflightResult,
    _build_consts,
)

# Launches of device_decode_kernel and device_decode_direct_kernel, each
# counted by its wrapper where it launches.
KERNEL_LAUNCHES = 0
DIRECT_LAUNCHES = 0

# a lane's table row (device_decode.cuh DD_*_AT)
LIT_AT = 0
CMD_AT = LIT_AT + LIT_TABLE_SIZE
DIST_AT = CMD_AT + CMD_TABLE_SIZE
DXE_AT = DIST_AT + DIST_TABLE_SIZE
DXO_AT = DXE_AT + MAX_DIST_ALPHABET
TAB_N = DXO_AT + MAX_DIST_ALPHABET   # 3718 int32
# a lane's scalar row (device_decode.cuh DDScal)
SCAL_N = 8
S_AT, S_NWORDS, S_BIT, S_MLEN, S_MAXBW, S_NPOSTFIX = range(6)
CONSTS_N = 128
RING_WORDS = 1024          # device_decode.cu DD_RING: the card's words ring
WINDOW = 8192              # device_decode.cu DD_WIN: the card's window, bytes
ALIGN = 64                 # int32s: each field starts on 256 bytes

_CONSTS = np.ascontiguousarray(_build_consts()[0])
_M32 = 0xFFFFFFFF
_TAB_FILL = -(1 << 31)     # a table read past the table's end
_CMD, _LIT, _COPY = 0, 1, 2
# device_decode_ref's per-lane state
_STATE = ("bp", "mbl", "rb", "impl", "err", "pos", "rem", "ins", "cpl",
          "dist", "phase")
GRAPH_STEPS = 32   # steps of device_decode_ref in one CUDA graph


@dataclass
class DeviceBatch:
    """A batch staged for the kernel (stage_batch), on one device."""

    body: torch.Tensor    # int32 (n_body,): each lane's words, lane after lane
    scal: torch.Tensor    # int32 (B, SCAL_N)
    tabs: torch.Tensor    # int32 (B, TAB_N)
    consts: torch.Tensor  # int32 (CONSTS_N,)
    max_words: int        # a word index from here on reads 0xFFFFFFFF
    out_size: int         # bytes of a lane's output row
    mlens: np.ndarray     # int64 (B,): each lane's mlen, on the host

    @property
    def n_lanes(self) -> int:
        return self.scal.shape[0]


def stage_batch(batch: list[PreflightResult], device: torch.device | str,
                *, out_size: int | None = None,
                max_words: int | None = None) -> DeviceBatch:
    """`batch` in the kernel's layout on `device`: one host buffer (pinned
    for a CUDA device) and one copy.  `out_size` and `max_words` default
    to the batch's largest mlen and word count, as the JAX kernel's
    arrays; a shard of a larger batch passes the whole batch's."""
    dev = resolve_device(device)
    n = len(batch)
    if n == 0:
        raise ValueError("an empty batch")
    n_words = np.fromiter((p.words.shape[0] for p in batch), np.int64, n)
    mlens = np.fromiter((p.mlen for p in batch), np.int64, n)
    at = np.zeros(n, np.int64)
    np.cumsum(n_words[:-1], out=at[1:])
    n_body = int(n_words.sum())
    if n_body >= 1 << 31:
        raise ValueError("the batch's words outgrow int32 offsets")
    out_size = int(mlens.max()) if out_size is None else out_size
    max_words = int(n_words.max()) if max_words is None else max_words
    if out_size < int(mlens.max()) or max_words < int(n_words.max()):
        raise ValueError("out_size or max_words below the batch's own")
    widths = [max(1, n_body), n * SCAL_N, n * TAB_N, CONSTS_N]
    seg, end = [], 0
    for w in widths:
        seg.append(end)
        end += -(-w // ALIGN) * ALIGN
    buf = torch.empty(end, dtype=torch.int32,
                      pin_memory=dev.type == "cuda")
    a = buf.numpy()
    np.concatenate([p.words for p in batch],
                   out=a[seg[0]: seg[0] + n_body].view(np.uint32))
    scal = a[seg[1]: seg[1] + widths[1]].reshape(n, SCAL_N)
    scal[:] = 0
    scal[:, S_AT] = at
    scal[:, S_NWORDS] = n_words
    scal[:, S_BIT] = [p.cmd_start_bit for p in batch]
    scal[:, S_MLEN] = mlens
    scal[:, S_MAXBW] = [p.max_backward for p in batch]
    scal[:, S_NPOSTFIX] = [p.npostfix for p in batch]
    tabs = a[seg[2]: seg[2] + widths[2]].reshape(n, TAB_N)
    for lo, hi, name in ((LIT_AT, CMD_AT, "lit_table"),
                         (CMD_AT, DIST_AT, "cmd_table"),
                         (DIST_AT, DXE_AT, "dist_table"),
                         (DXE_AT, DXO_AT, "dist_extra"),
                         (DXO_AT, TAB_N, "dist_offset")):
        tabs[:, lo:hi] = np.stack([getattr(p, name) for p in batch])
    a[seg[3]: seg[3] + CONSTS_N] = _CONSTS
    buf = buf.to(dev, non_blocking=True)
    f = [buf[o: o + w] for o, w in zip(seg, widths)]
    return DeviceBatch(body=f[0], scal=f[1].view(n, SCAL_N),
                       tabs=f[2].view(n, TAB_N), consts=f[3],
                       max_words=max_words, out_size=out_size, mlens=mlens)


def _check(db: DeviceBatch) -> None:
    n = db.n_lanes
    for name, t, shape in (("body", db.body, None),
                           ("scal", db.scal, (n, SCAL_N)),
                           ("tabs", db.tabs, (n, TAB_N)),
                           ("consts", db.consts, (CONSTS_N,))):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, want {shape}")
        if t.device != db.body.device:
            raise ValueError(f"{name} is on {t.device}, body on "
                             f"{db.body.device}")
    if db.body.dim() != 1 or db.body.numel() == 0 or n == 0:
        raise ValueError("body must be a non-empty 1-D tensor, and the "
                         "batch must have lanes")
    if db.out_size < int(db.mlens.max()) or db.max_words < 0:
        raise ValueError("out_size below the batch's largest mlen")


def _alloc_outputs(db: DeviceBatch):
    dev = db.body.device
    out = torch.zeros((db.n_lanes, db.out_size), dtype=torch.uint8, device=dev)
    pos = torch.empty((db.n_lanes,), dtype=torch.int32, device=dev)
    err = torch.empty((db.n_lanes,), dtype=torch.bool, device=dev)
    return out, pos, err


def _c_args(db: DeviceBatch, outs) -> list:
    """The argument list of brotli_torch_device_decode (and its host shim)."""
    return [db.body.data_ptr(), db.scal.data_ptr(), db.tabs.data_ptr(),
            db.consts.data_ptr(), *(t.data_ptr() for t in outs), db.n_lanes,
            db.max_words, db.out_size]


def _launch(db: DeviceBatch, entry: str, lib=None):
    """`entry` of the kernel library (or of `lib`, a build of the same
    sources) on the batch: its outputs; no launch is counted here."""
    from ..build import kernels_lib

    dev = db.body.device
    outs = _alloc_outputs(db)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    with torch.cuda.device(dev):
        rc = getattr(lib or kernels_lib(), entry)(
            *_c_args(db, outs), sms, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: cudaError {rc}")
    return outs


def _device_of(db: DeviceBatch) -> torch.device:
    _check(db)
    dev = db.body.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_decode(db: DeviceBatch):
    """Decode every lane of a staged batch: (out (B, out_size) uint8, pos
    (B,) int32, err (B,) bool) on the batch's device.  CPU tensors take
    device_decode_ref; CUDA tensors launch csrc/device_decode.cu
    `device_decode_kernel` over a grid sized from the card's SM count."""
    global KERNEL_LAUNCHES
    if _device_of(db).type == "cpu":
        return device_decode_ref(db)
    outs = _launch(db, "brotli_torch_device_decode")
    KERNEL_LAUNCHES += 1
    return outs


def device_decode_direct(db: DeviceBatch):
    """device_decode through the first design, `device_decode_direct_kernel`
    (the table row in shared memory, words and bytes in device memory),
    kept to be timed against the main path's kernel."""
    global DIRECT_LAUNCHES
    if _device_of(db).type == "cpu":
        return device_decode_ref(db)
    outs = _launch(db, "brotli_torch_device_decode_direct")
    DIRECT_LAUNCHES += 1
    return outs


def launch_config() -> dict:
    """device_decode_kernel's launch shape, from the built library."""
    from ..build import kernels_lib

    cfg = np.zeros(5, np.int32)
    kernels_lib().brotli_torch_device_decode_config(cfg.ctypes.data)
    return dict(zip(("threads", "shared_bytes", "blocks_an_sm", "ring_words",
                     "window_bytes"), map(int, cfg)))


def device_decode_host(db: DeviceBatch, *, direct: bool = False,
                       ring_words: int = RING_WORDS, window: int = WINDOW):
    """csrc/device_decode.cuh's per-lane code built for the CPU
    (build.host_lib), a warp's 32 threads as loops: the shared form at a
    words ring of `ring_words` and a window of `window` bytes (powers of
    two, at least 16 and 64), or with `direct` the direct form.  For the
    tests, which hold it against device_decode_ref and the JAX kernel."""
    from ..build import host_lib

    _check(db)
    if db.body.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    outs = _alloc_outputs(db)
    lib = host_lib()
    if direct:
        rc = lib.brotli_torch_device_decode_direct_host(*_c_args(db, outs))
    else:
        rc = lib.brotli_torch_device_decode_host(*_c_args(db, outs),
                                                  ring_words, window)
    if rc != 0:
        raise ValueError("host shim refused the batch")
    return outs


def _shl(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(x, n)


def device_decode_ref(db: DeviceBatch):
    """Plain PyTorch version of device_decode, on the batch's device.

    Every lane steps through a state machine, in lockstep over the lanes:
    each step a lane at a command reads it (symbol, insert and copy extra
    bits), a lane inside its insert emits one literal, a lane at its
    insert's end reads its distance and checks it, and a lane inside its
    copy emits one byte, so the batch takes about as many steps as its
    longest lane has bytes.  Reads follow the JAX kernel: a word past the
    lane's own words is 0 below max_words and 0xFFFFFFFF from there, a
    table entry past the table's end is INT32_MIN, bit positions wrap at
    2^32, and bytes go to clip(pos, 0, out_size - 1)."""
    _check(db)
    dev = db.body.device
    n, size = db.n_lanes, db.out_size
    i64 = torch.int64
    scal = db.scal.to(i64)
    at, nw = scal[:, S_AT], scal[:, S_NWORDS]
    body = db.body.to(i64) & _M32
    tabs = db.tabs.reshape(-1).to(i64)
    lut = db.consts.to(i64)
    lane = torch.arange(n, device=dev, dtype=i64)
    row = lane * TAB_N
    stride = size + 1          # column `size` absorbs idle lanes' writes
    out = torch.zeros(n * stride, dtype=torch.uint8, device=dev)
    base = lane * stride
    dummy = base + size
    one = torch.ones(n, dtype=i64, device=dev)
    # each insert-and-copy cell's high code bits, 2 bits a cell
    ins_hi, cp_hi = one * 0x29850, one * 0x26244

    def word(w):
        got = body[(at + w).clamp(0, body.numel() - 1)]
        return torch.where(w < nw, got,
                           torch.where(w < db.max_words, 0, _M32))

    def peek(bp):
        w, sh = bp >> 5, bp & 31
        hi = _shl(word(w + 1), 32 - sh) & _M32
        return (word(w) >> sh) | torch.where(sh == 0, 0, hi)

    def bits(bp, nb):
        mask = torch.where(nb >= 32, _M32, _shl(one, nb.clamp(0, 31)) - 1)
        return peek(bp) & mask

    def read_symbol(at_tab, size_tab, bp):
        v = peek(bp)
        e0 = tabs[row + at_tab + (v & 0xFF)]
        bits0 = e0 >> 16
        leaf = bits0 <= 8
        mask = _shl(one, bits0.clamp(0, 15)) - 1
        idx2 = torch.where(leaf, 0, (v & 0xFF) + (e0 & 0xFFFF) + ((v & mask) >> 8))
        e1 = torch.where(idx2 < size_tab,
                         tabs[row + at_tab + idx2.clamp(0, size_tab - 1)],
                         _TAB_FILL)
        sym = torch.where(leaf, e0 & 0xFFFF, e1 & 0xFFFF)
        nb = torch.where(leaf, bits0, (e1 >> 16) + 8)
        return sym, (bp + nb) & _M32

    def wrap32(x):
        return ((x + (1 << 31)) & _M32) - (1 << 31)

    def zeros():
        return torch.zeros(n, dtype=i64, device=dev)

    st = dict(bp=scal[:, S_BIT] & _M32, mbl=scal[:, S_MLEN].clone(),
              rb=torch.full((n,), 3, dtype=i64, device=dev),
              impl=torch.zeros(n, dtype=torch.bool, device=dev),
              err=torch.zeros(n, dtype=torch.bool, device=dev),
              **{k: zeros() for k in ("pos", "rem", "ins", "cpl", "dist",
                                      "phase")})
    maxbw, npf = scal[:, S_MAXBW], scal[:, S_NPOSTFIX] & 31
    ring = torch.tensor([16, 15, 11, 4], dtype=i64, device=dev).repeat(n, 1)
    last = max(size - 1, 0)

    def step():
        """One step of every lane; the state goes back into `st` in place
        (so a CUDA graph can replay steps)."""
        bp, mbl, rb, impl, err, pos, rem, ins, cpl, dist, phase = (
            st[k] for k in _STATE)
        # ---- a command: symbol, insert and copy extra bits ----
        live = (phase == _CMD) & (mbl > 0) & ~err
        cmd, b = read_symbol(CMD_AT, CMD_TABLE_SIZE, bp)
        cell = cmd >> 6
        ri = torch.where(cell < 2, cell, cell - 2).clamp(0, 16)
        ins_code = ((ins_hi >> (2 * ri)) & 3) * 8 + ((cmd >> 3) & 7)
        cp_code = ((cp_hi >> (2 * ri)) & 3) * 8 + (cmd & 7)
        ip, cq = lut[ins_code & 127], lut[(cp_code + 64) & 127]
        il = (ip & 0xFFFFF) + bits(b, ip >> 20)
        b = (b + (ip >> 20)) & _M32
        cl = (cq & 0xFFFFF) + bits(b, cq >> 20)
        b = (b + (cq >> 20)) & _M32
        bp = torch.where(live, b, bp)
        rem = torch.where(live, il, rem)
        ins = torch.where(live, il, ins)
        cpl = torch.where(live, cl, cpl)
        impl = torch.where(live, cell < 2, impl)
        phase = torch.where(live, _LIT, phase)
        # ---- one literal ----
        lit = (phase == _LIT) & (rem > 0)
        sym, b = read_symbol(LIT_AT, LIT_TABLE_SIZE, bp)
        out[torch.where(lit, base + pos.clamp(0, last), dummy)] = \
            (sym & 0xFF).to(torch.uint8)
        bp = torch.where(lit, b, bp)
        pos = pos + lit.long()
        rem = rem - lit.long()
        # ---- the insert's end: distance, checks ----
        fin = (phase == _LIT) & (rem == 0)
        mbl = torch.where(fin, mbl - ins, mbl)
        act = fin & (mbl > 0)
        need = act & ~impl
        ds, b = read_symbol(DIST_AT, DIST_TABLE_SIZE, bp)
        bp = torch.where(need, b, bp)
        dcode = torch.where(need, ds, 0)
        sc = lut[96 + dcode.clamp(0, 15)]
        short = ring[lane, (rb - (sc >> 4)) & 3] + (sc & 15) - 3
        code = dcode.clamp(0, MAX_DIST_ALPHABET - 1)
        ebits = tabs[row + DXE_AT + code] & _M32
        long_read = need & (dcode >= 16)
        ev = torch.where(long_read, bits(bp, ebits), 0)
        bp = torch.where(long_read, (bp + ebits) & _M32, bp)
        long = wrap32(tabs[row + DXO_AT + code] + _shl(ev, npf))
        distance = torch.where(impl, ring[lane, rb & 3],
                               torch.where(dcode < 16, wrap32(short), long))
        max_distance = torch.minimum(pos, maxbw)
        err = err | (act & ((distance < 1) | (distance > max_distance)))
        push = act & ~impl & (dcode > 0) & (distance <= max_distance)
        rb = torch.where(push, (rb + 1) & 3, rb)
        ring[lane, rb] = torch.where(push, distance, ring[lane, rb])
        c_len = torch.where(act & ~err, cpl, 0)
        err = err | (fin & (c_len > mbl))
        c_len = torch.where(err, 0, c_len)
        rem = torch.where(fin, c_len, rem)
        cpl = torch.where(fin, c_len, cpl)
        dist = torch.where(fin, distance, dist)
        phase = torch.where(fin, _COPY, phase)
        # ---- one copied byte ----
        cp = (phase == _COPY) & (rem > 0)
        src = out[torch.where(cp, base + (pos - dist).clamp(0, last), dummy)]
        out[torch.where(cp, base + pos.clamp(0, last), dummy)] = src
        pos = pos + cp.long()
        rem = rem - cp.long()
        # ---- the copy's end ----
        done = (phase == _COPY) & (rem == 0)
        mbl = torch.where(done, mbl - cpl, mbl)
        phase = torch.where(done, _CMD, phase)
        for k, v in zip(_STATE, (bp, mbl, rb, impl, err, pos, rem, ins, cpl,
                                 dist, phase)):
            st[k].copy_(v)

    def busy() -> bool:
        return bool(((st["phase"] != _CMD)
                     | ((st["mbl"] > 0) & ~st["err"])).any())

    if dev.type == "cuda":
        _replay_steps(step, busy, dev)
    else:
        while busy():
            for _ in range(16):
                step()
    pos, err = st["pos"], st["err"]
    out = out.view(n, stride)[:, :size].contiguous()
    return out, pos.to(torch.int32), err


def _replay_steps(step, busy, dev: torch.device) -> None:
    """Run step() until busy() is False on a CUDA device: a few steps to
    warm up, then GRAPH_STEPS steps captured in one CUDA graph and
    replayed, so each step's ~200 small launches cost no host dispatch.
    Steps of finished lanes change nothing, so running past the end is
    harmless."""
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.device(dev), torch.cuda.stream(side):
        for _ in range(3):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(dev):
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_STEPS):
                step()
        while busy():
            graph.replay()


def fetch_outputs(out: torch.Tensor, pos: torch.Tensor, err: torch.Tensor
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's outputs as numpy arrays.  From the card through pinned
    buffers on the current stream, with one synchronise; on the CPU read
    where they lie."""
    if out.device.type == "cuda":
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in (out, pos, err)]
        torch.cuda.current_stream(out.device).synchronize()
    else:
        host = [out, pos, err]
    return tuple(t.numpy() for t in host)  # type: ignore[return-value]


def run_device_batch(batch: list[PreflightResult],
                     device: torch.device | str = "cuda"):
    """Stage a batch of preflighted streams on `device`, run the kernel
    (the plain version on the CPU) and return numpy (out, pos, err), as
    the JAX function of the same name."""
    return fetch_outputs(*device_decode(stage_batch(batch, device)))


def collect_results(results: list, streams: list[bytes], lanes: list[int],
                    out: np.ndarray, pos: np.ndarray, err: np.ndarray) -> int:
    """results[lanes[k]] = lane k's bytes, or the host decoder's where the
    kernel flagged lane k; returns the flagged lanes' count."""
    flat = memoryview(out.reshape(-1))
    stride = out.shape[1]
    flagged = 0
    for k, i in enumerate(lanes):
        if err[k]:
            flagged += 1
            results[i] = host_decode(streams[i])  # dictionary reference etc.
        else:
            results[i] = bytes(flat[k * stride: k * stride + int(pos[k])])
    return flagged


def preflight_native(streams: list[bytes]) -> list[PreflightResult | None]:
    """Each stream's PreflightResult, None for an ineligible one, from one
    native parse of the batch (native.preflight_batch_native).  A native
    library that fails to build or load raises: nothing falls back to the
    Python parser."""
    from ..native import preflight_batch_native

    scal, lit, cmd, dist, dxe, dxo = preflight_batch_native(streams)
    out: list[PreflightResult | None] = []
    for i, s in enumerate(streams):
        if scal[i, 0] != 1:
            out.append(None)
            continue
        pad = (-len(s)) % 4 + 12
        words = np.frombuffer(bytes(s) + b"\x00" * pad, dtype="<u4")
        out.append(PreflightResult(
            words=words, cmd_start_bit=int(scal[i, 2]), mlen=int(scal[i, 1]),
            max_backward=(1 << int(scal[i, 5])) - 16,
            lit_table=lit[i], cmd_table=cmd[i], dist_table=dist[i],
            dist_extra=dxe[i], dist_offset=dxo[i],
            npostfix=int(scal[i, 3]), ndirect=int(scal[i, 4])))
    return out


def preflight_split(streams: list[bytes]):
    """Preflight a batch: (the eligible streams' PreflightResults, their
    indices, and a result list holding the host decoder's bytes of the
    ineligible streams and None for the eligible ones)."""
    pre = preflight_native(list(streams))
    lanes = [i for i, p in enumerate(pre) if p is not None]
    results = [None if p is not None else host_decode(s)
               for p, s in zip(pre, streams)]
    return [pre[i] for i in lanes], lanes, results


def decode_batch_device(streams: list[bytes], *,
                        device: torch.device | str = "cuda") -> list[bytes]:
    """Decode a batch of independently compressed streams: the eligible
    ones through the kernel on `device` in one batch, the others and the
    flagged lanes by the host decoder, every such lane counted in
    fallback_stats()."""
    dev = resolve_device(device)
    batch, lanes, results = preflight_split(streams)
    n_fallback = len(streams) - len(lanes)
    if lanes:
        outs = run_device_batch(batch, dev)
        n_fallback += collect_results(results, streams, lanes, *outs)
    _note_fallbacks(len(streams), n_fallback)
    return results  # type: ignore[return-value]

