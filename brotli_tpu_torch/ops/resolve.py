"""LZ resolve: v2 tokens -> decoded bytes.  Counterpart of
brotli_tpu/ops/pallas_resolve.py.

The reference kernel keeps every lane's history in a shared VMEM ring of H
bytes, so it must flag copies further back than H-16 (ERR_FAR_DIST), and it
pulls tokens through a lockstep row cursor.  Here each lane resolves into
its own slot of a slot-major (n_lanes, max_mlen) u8 output in device memory
(csrc/resolve.cu): there is no distance cap, no far flag, and a lane the
reference flags far decodes, with the host decoder's bytes.

`resolve_tokens` launches `resolve_kernel`: one warp a lane, 32 tokens a
step, the lane's bytes in a window in shared memory that `launch_config`
sizes for the card (csrc/resolve.cuh resolve_lane_warp).
`resolve_tokens_direct` launches the first form, one thread a lane, kept
beside it for comparison.

Tokens come in the port's compact form: tok (cap, n_lanes) int32 holding
the u32 token bits, token-major, with count[lane] valid tokens per lane
(see ops/decode2.py).  The flags keep pallas_resolve.py's values.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

ERR_FAR_DIST = 1   # copy beyond the reference's ring; never set by the port
ERR_STARVED = 2    # tokens ended before mlen bytes
ERR_MALFORMED = 4  # tag-2 without a pending tag-1, distance outside [1, pos],
                   # or mlen beyond the output slot

# Launches of the CUDA kernels, counted by the wrappers where they launch:
# resolve_kernel (the main path's) and resolve_direct_kernel.
KERNEL_LAUNCHES = 0
DIRECT_LAUNCHES = 0

# resolve_kernel's shape, as csrc/resolve.cu and resolve.cuh define it
# (RESOLVE_WARPS, 4 * TOKQ, RESOLVE_WIN_MIN; tests/test_torch_resolve.py
# holds them equal): lanes a block, token-ring bytes a lane, the window's
# bounds (powers of two)
LANES_A_BLOCK = 8
TOKQ_BYTES = 4 * 128
WINDOW_MIN = 64
WINDOW_MAX = 16384

_M32 = 0xFFFFFFFF


def _check(tok: torch.Tensor, count: torch.Tensor, mlen: torch.Tensor,
           max_mlen: int) -> None:
    if tok.dim() != 2 or tok.dtype != torch.int32 or not tok.is_contiguous():
        raise ValueError("tok must be a contiguous (cap, n_lanes) int32 tensor")
    n = tok.shape[1]
    for name, t in (("count", count), ("mlen", mlen)):
        if t.shape != (n,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor")
        if t.device != tok.device:
            raise ValueError(f"{name} is on {t.device}, tok on {tok.device}")
    if max_mlen < 0:
        raise ValueError("max_mlen must be >= 0")


def resolve_tokens(tok: torch.Tensor, count: torch.Tensor, mlen: torch.Tensor,
                   max_mlen: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Resolve every lane's tokens to its mlen bytes.

    Returns (out (n_lanes, max_mlen) uint8, err (n_lanes,) int32 flags), on
    the tensors' device.  `max_mlen` is the output slot (the caller knows
    the largest mlen from the host batch, so no device read is needed); a
    lane whose mlen exceeds it is flagged, and a count above the token
    slots is cut to them.  CPU tensors take resolve_tokens_ref; CUDA tensors
    launch csrc/resolve.cu `resolve_kernel` with the window launch_config
    sizes for the batch and the card.
    """
    global KERNEL_LAUNCHES
    if not _on_card(tok, count, mlen, max_mlen):
        return resolve_tokens_ref(tok, count, mlen, max_mlen)
    props = torch.cuda.get_device_properties(tok.device)
    window = launch_config(tok.shape[1], max_mlen, props.multi_processor_count,
                           props.shared_memory_per_multiprocessor,
                           props.max_threads_per_multi_processor)
    outs = _launch(tok, count, mlen, max_mlen, "brotli_torch_resolve",
                   [window], "resolve kernel")
    KERNEL_LAUNCHES += 1
    return outs


def launch_config(n_lanes: int, max_mlen: int, sms: int, smem_sm: int,
                  threads_sm: int) -> int:
    """Window bytes a lane of resolve_kernel on a card of `sms` SMs with
    `smem_sm` bytes of shared memory and `threads_sm` threads each.  The
    blocks an SM holds at once (those of one wave, at most what its threads
    allow) share its shared memory, less the 1 KB each block's runtime
    reserve takes and the token rings; the window is the largest power of
    two in [WINDOW_MIN, WINDOW_MAX] that fits, and no larger than a slot
    at any 16-byte phase needs (then a lane never reads its slot back)."""
    blocks = -(-n_lanes // LANES_A_BLOCK)
    per_sm = max(1, min(-(-blocks // sms), threads_sm // (32 * LANES_A_BLOCK)))
    room = (smem_sm // per_sm - 1024
            - LANES_A_BLOCK * TOKQ_BYTES) // LANES_A_BLOCK
    need = max_mlen + (15 if max_mlen % 16 else 0)
    window = min(WINDOW_MAX, 1 << max(0, (need - 1).bit_length()),
                 1 << max(0, room.bit_length() - 1))
    return max(WINDOW_MIN, window)


def resolve_tokens_direct(tok: torch.Tensor, count: torch.Tensor,
                          mlen: torch.Tensor,
                          max_mlen: int) -> tuple[torch.Tensor, torch.Tensor]:
    """resolve_tokens through resolve_direct_kernel (one lane a thread,
    blocks of 128, each token and byte in device memory); CPU tensors take
    resolve_tokens_ref."""
    global DIRECT_LAUNCHES
    if not _on_card(tok, count, mlen, max_mlen):
        return resolve_tokens_ref(tok, count, mlen, max_mlen)
    outs = _launch(tok, count, mlen, max_mlen, "brotli_torch_resolve_direct",
                   [], "direct resolve kernel")
    DIRECT_LAUNCHES += 1
    return outs


def _on_card(tok, count, mlen, max_mlen: int) -> bool:
    """False for CPU tensors (which take the plain version); raises on a
    device that is neither."""
    _check(tok, count, mlen, max_mlen)
    if tok.device.type == "cpu":
        return False
    if tok.device.type != "cuda":
        raise ValueError(f"unsupported device {tok.device}")
    return True


def _launch(tok, count, mlen, max_mlen: int, entry: str, extra: list,
            what: str):
    """Launch `entry` of the CUDA library; the outputs."""
    from ..build import kernels_lib

    out, err = _alloc_outputs(tok, max_mlen)
    with torch.cuda.device(tok.device):
        rc = getattr(kernels_lib(), entry)(
            *_c_args(tok, count, mlen, out, err, max_mlen), *extra,
            torch.cuda.current_stream(tok.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {rc}")
    return out, err


def _alloc_outputs(tok: torch.Tensor, max_mlen: int):
    n = tok.shape[1]
    out = torch.zeros((n, max_mlen), dtype=torch.uint8, device=tok.device)
    err = torch.empty((n,), dtype=torch.int32, device=tok.device)
    return out, err


def _c_args(tok, count, mlen, out, err, max_mlen: int) -> list:
    """The argument list of brotli_torch_resolve (and its host shim)."""
    return [tok.data_ptr(), count.data_ptr(), mlen.data_ptr(), out.data_ptr(),
            err.data_ptr(), tok.shape[1], tok.shape[0], max_mlen]


def resolve_tokens_host(tok: torch.Tensor, count: torch.Tensor,
                        mlen: torch.Tensor, max_mlen: int,
                        window: int = 2048,
                        direct: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """csrc/resolve.cuh's per-lane code built for the CPU (build.host_lib):
    resolve_kernel's warp form with a `window`-byte window (each step's 32
    threads as loops), or with `direct` the direct kernel's.  For the tests,
    which hold it against resolve_tokens_ref."""
    from ..build import host_lib

    _check(tok, count, mlen, max_mlen)
    if tok.device.type != "cpu":
        raise ValueError("the host shim takes CPU tensors")
    out, err = _alloc_outputs(tok, max_mlen)
    args = _c_args(tok, count, mlen, out, err, max_mlen)
    lib = host_lib()
    rc = (lib.brotli_torch_resolve_direct_host(*args) if direct
          else lib.brotli_torch_resolve_host(*args, window))
    if rc != 0:
        raise ValueError("host shim refused the tokens")
    return out, err


def resolve_tokens_ref(tok: torch.Tensor, count: torch.Tensor,
                       mlen: torch.Tensor,
                       max_mlen: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of resolve_tokens, on the tensors' device.

    One step emits at most one byte for every lane (a literal byte, or a
    gather from the lane's own output at pos - dist), fetching a token for
    lanes that have nothing pending; so a copy needs no inner loop and the
    whole batch takes about max_mlen steps of a few vector ops.
    """
    _check(tok, count, mlen, max_mlen)
    dev = tok.device
    cap, n = tok.shape
    stride = max_mlen + 1  # column max_mlen absorbs the writes of idle lanes
    out = torch.zeros(n * stride, dtype=torch.uint8, device=dev)
    tokf = tok.reshape(-1).to(torch.int64) & _M32
    cnt = count.to(torch.int64).clamp(max=cap)
    ml = mlen.to(torch.int64)
    lane = torch.arange(n, device=dev, dtype=torch.int64)
    base = lane * stride
    dummy = base + max_mlen

    def zeros():
        return torch.zeros(n, dtype=torch.int64, device=dev)

    pos, cur, lw, lk, lcnt, crem, cdist = (zeros() for _ in range(7))
    err = torch.where(ml > max_mlen, ERR_MALFORMED, 0)
    pend = torch.full((n,), -1, dtype=torch.int64, device=dev)
    step = 0
    while True:
        active = (err == 0) & (pos < ml)
        if step % 16 == 0 and not bool(active.any()):
            break
        step += 1
        # ---- fetch one token for lanes with nothing pending ----
        idle = active & (lcnt == 0) & (crem == 0)
        starved = idle & (cur >= cnt)
        err = err | torch.where(starved, ERR_STARVED, 0)
        fetch = idle & ~starved
        t = tokf[cur.clamp(0, max(cap - 1, 0)) * n + lane] if cap else zeros()
        cur = cur + fetch.to(torch.int64)
        tag = t >> 30
        is_lit = fetch & (t != 0) & (tag == 0)
        is_len = fetch & (tag == 1)
        is_cp = fetch & (tag >= 2)
        is_fused = is_cp & (tag == 3)
        lcnt = torch.where(is_lit, (t >> 24) & 3, lcnt)
        lw = torch.where(is_lit, t, lw)
        lk = torch.where(is_lit, 0, lk)
        pend = torch.where(is_len, t & 0xFFFFFF, pend)
        bad = is_cp & ~is_fused & (pend < 0)
        clen = torch.where(is_fused, (t >> 22) & 0xFF, pend)
        dist = torch.where(is_fused, t & 0x3FFFFF, t & 0x3FFFFFFF)
        pend = torch.where(is_cp & ~is_fused & ~bad, -1, pend)
        bad = bad | (is_cp & ((dist < 1) | (dist > pos)))
        err = err | torch.where(bad, ERR_MALFORMED, 0)
        arm = is_cp & ~bad
        crem = torch.where(arm, clen, crem)
        cdist = torch.where(arm, dist, cdist)
        # ---- emit one byte ----
        active = (err == 0) & (pos < ml)
        from_lit = active & (lcnt > 0)
        from_cp = active & ~from_lit & (crem > 0)
        src = out[torch.where(from_cp, base + pos - cdist, dummy)]
        byte = torch.where(from_lit, ((lw >> (8 * lk)) & 0xFF).to(torch.uint8), src)
        wrote = from_lit | from_cp
        out[torch.where(wrote, base + pos, dummy)] = byte
        pos = pos + wrote.to(torch.int64)
        lk = lk + from_lit.to(torch.int64)
        lcnt = lcnt - from_lit.to(torch.int64)
        crem = crem - from_cp.to(torch.int64)
    out = out.reshape(n, stride)[:, :max_mlen].contiguous()
    return out, err.to(torch.int32)


def resolve_tokens_device(tokens: torch.Tensor, counts: torch.Tensor, mlens,
                          device: torch.device | str):
    """Resolve compact tokens on `device` (counterpart of the reference's
    resolve_tokens_device).  `mlens` is the host array of decoded sizes,
    one per lane (0 for pad lanes).  Returns (out (n_lanes, max_mlen) uint8,
    err (n_lanes,) int32), both on `device`."""
    dev = resolve_device(device)
    mlens = np.asarray(mlens, dtype=np.int64).reshape(-1)
    max_mlen = int(mlens.max()) if mlens.size else 0
    mlen_t = torch.from_numpy(mlens.astype(np.int32)).to(dev)
    return resolve_tokens(tokens.to(dev).contiguous(),
                          counts.to(dev).contiguous(), mlen_t, max_mlen)


def unpack_resolved(out: torch.Tensor, err: torch.Tensor,
                    mlens) -> tuple[list[bytes], np.ndarray]:
    """(n_lanes, max_mlen) u8 output + flags -> per-lane bytes + flags (host)."""
    raw = out.cpu().numpy()
    mlens = np.asarray(mlens).reshape(-1)
    return [bytes(raw[i, : mlens[i]]) for i in range(len(mlens))], \
        err.cpu().numpy()
