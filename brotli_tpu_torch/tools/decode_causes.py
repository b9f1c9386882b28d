"""What holds the direct entropy and v3 kernels back on the card (the
first CUDA forms, `entropy_decode_direct` and `decode3_direct`): each is
rebuilt in variants that keep its per-lane code and its outputs but change
the lane map or move one cost out of the lane's chain, and every variant
is timed on its cell; then the main path's kernels (`decode2_kernel`,
`decode3_kernel`) at their own launch config and at other lane maps,
windows and table budgets.

    python3 -m brotli_tpu_torch.tools.decode_causes [--redesign-only]

The variants are instances of one template kernel per decoder, built by
nvcc from this module's source (below) and a copy of csrc/decode3.cuh whose
refill reads words with a plain load instead of `__ldg` (a shared-memory
word cannot take the read-only path).  Parameters:

* lanes a warp and warps a block (the direct kernels: 32 and 4); the other
  threads of a warp exit at once;
* bytes in shared (v3): the lane's whole slot lives in shared memory, so
  copies read and bytes land there, and one 4-byte-wide copy-out writes the
  slot at the end;
* tokens to shared (v2): every token is stored to one shared word of the
  lane (so the tokens are lost and only count, phase and widx compare);
* words in shared: the block stages its lanes' whole word columns into
  shared memory first (coalesced), and refills read them there.

Last, both kinds of kernel at 4 lanes a warp on cells whose 4 lanes of a
warp decode one stream (what divergence costs).

Cells: v2, 4 x 1024 streams of 8,192 B (`encode_sharded(chunk_size=8192,
max_distance=2032)`); v3, 6 x 1024 streams of 4,096 B encoded on the card
at the reference bench's full-format setting.  Times: `time_device_fn`
(CUDA events, best of 3 windows of 5).  Every variant's outputs are held
against the direct kernel's on the same batch.  Needs a CUDA card and
nvcc; prints one line per variant and the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from .. import build
from ..utils.benchmarks import time_device_fn

V3_BENCH = dict(chunk_size=4096, max_distance=1008, chain_depth=4,
                table_groups=1, lit_ctx_trees=8)
REFILL_LDG = "return ldg(L.words + (i64)s.widx * L.wstride);"
REFILL_PLAIN = "return L.words[(i64)s.widx * L.wstride];"

# (lanes per warp, warps per block, bytes or tokens in shared, words in
# shared); lanes per block = the product of the first two
VARIANTS = [
    (32, 4, 0, 0), (32, 1, 0, 0), (32, 1, 1, 0), (32, 1, 0, 1),
    (32, 1, 1, 1), (16, 1, 0, 0), (16, 1, 1, 1), (8, 1, 1, 1),
    (8, 4, 0, 0), (4, 4, 0, 0), (2, 4, 0, 0), (1, 4, 0, 0),
    (4, 4, 1, 0), (4, 4, 0, 1), (4, 4, 1, 1),
]


def variant_name(lpw: int, wpb: int, outs: int, words: int, what: str) -> str:
    name = f"{lpw:2d} lanes a warp x {wpb} warps"
    extra = [x for x, on in ((what, outs), ("words in shared", words)) if on]
    return name + (", " + " + ".join(extra) if extra else "")


SOURCE = r"""
#include <cuda_runtime.h>
#include "decode2.cuh"
#include "decode3.cuh"
using namespace brotli_torch;

template <int LPW, int WPB, int OUTS, int WORDS>
__global__ void __launch_bounds__(32 * WPB)
k3(const u32* wt, const i32* lit, const i32* cmd, const i32* dist,
   const i32* bsw, const i32* cmap, const i32* dx, const i32* consts,
   const i32* lut, const i32* tfm, const u8* dict, const u8* tfs,
   const u8* cdict, const i32* cfg, const i32* scal, u8* out, i32* status,
   int n_lanes, int wpad, int out_cap, int hrb, Decode3Shared S) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int BLOCK = LPW * WPB;
  if ((int)threadIdx.x % 32 >= LPW) return;
  const int t = threadIdx.x / 32 * LPW + threadIdx.x % 32;
  const int lane = blockIdx.x * BLOCK + t;
  const i64 stride = (i64)hrb + out_cap;
  u8* s_out = smem;
  u32* s_w = (u32*)(smem + (OUTS ? BLOCK * stride : 0));
  u8* slot = out + (i64)lane * stride;
  if (WORDS)
    for (int w = 0; w < wpad; ++w) s_w[w * BLOCK + t] = wt[(i64)w * n_lanes + lane];
  if (OUTS)
    for (i64 i = 0; i < stride; i += 4)
      *(u32*)(s_out + t * stride + i) = *(const u32*)(slot + i);
  S.consts = consts; S.lut = lut; S.tfm = tfm; S.dict = dict; S.tfs = tfs;
  S.cdict = cdict;
  const Decode3Group G = make_group3(cfg + (lane / 1024) * NCFG3, lit, cmd,
                                     dist, bsw, cmap, dx);
  const Decode3Lane L{WORDS ? s_w + t : wt + lane, WORDS ? BLOCK : n_lanes,
                      wpad, scal + lane, n_lanes,
                      OUTS ? s_out + t * stride : slot, hrb, out_cap,
                      status + lane, n_lanes};
  decode3_lane(S, G, L);
  if (OUTS)
    for (i64 i = 0; i < stride; i += 4)
      *(u32*)(slot + i) = *(const u32*)(s_out + t * stride + i);
}

template <int LPW, int WPB, int TOKS, int WORDS>
__global__ void __launch_bounds__(32 * WPB)
k2(const u32* wt, const i32* lit, const i32* cmd, const i32* dist,
   const i32* dx, const i32* consts, const i32* start_bit, const i32* mlen,
   u32* tok, i32* count, i32* phase, i32* widx, int n_lanes, Decode2Params P,
   int lit_k, int cmd_k, int dist_k) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ i32 s_lit[LIT_K * 128], s_cmd[CMD_K * 128], s_dist[DIST_K * 128];
  __shared__ i32 s_dx[DX_N], s_consts[CONSTS_N];
  constexpr int BLOCK = LPW * WPB;
  __shared__ u32 s_tok[BLOCK];
  const int g = blockIdx.x * BLOCK / 1024;
  for (int i = threadIdx.x; i < lit_k * 128; i += 32 * WPB) s_lit[i] = lit[g * lit_k * 128 + i];
  for (int i = threadIdx.x; i < cmd_k * 128; i += 32 * WPB) s_cmd[i] = cmd[g * cmd_k * 128 + i];
  for (int i = threadIdx.x; i < dist_k * 128; i += 32 * WPB) s_dist[i] = dist[g * dist_k * 128 + i];
  for (int i = threadIdx.x; i < DX_N; i += 32 * WPB) s_dx[i] = dx[i];
  for (int i = threadIdx.x; i < CONSTS_N; i += 32 * WPB) s_consts[i] = consts[i];
  __syncthreads();
  if ((int)threadIdx.x % 32 >= LPW) return;
  const int t = threadIdx.x / 32 * LPW + threadIdx.x % 32;
  const int lane = blockIdx.x * BLOCK + t;
  u32* s_w = (u32*)smem;
  if (WORDS)
    for (int w = 0; w < P.wpad; ++w) s_w[w * BLOCK + t] = wt[(i64)w * n_lanes + lane];
  const Decode2Tables T{s_lit, s_cmd, s_dist, s_dx, s_consts, lit_k, cmd_k, dist_k};
  const Decode2Result r = decode2_lane(
      T, P, WORDS ? s_w + t : wt + lane, WORDS ? BLOCK : n_lanes,
      start_bit[lane], mlen[lane], TOKS ? s_tok + t : tok + lane,
      TOKS ? 0 : n_lanes);
  count[lane] = r.count;
  phase[lane] = r.phase;
  widx[lane] = r.widx;
}

template <class K>
static int allow(K kern, size_t smem) {
  if (smem > 0 &&
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return (int)cudaGetLastError();
  return 0;
}

#define V3(LP, WP, O, W) \
  if (lpw == LP && wpb == WP && outs == O && words == W) { \
    auto kern = k3<LP, WP, O, W>; \
    int rc = allow(kern, smem); if (rc) return rc; \
    kern<<<n_lanes / (LP * WP), 32 * WP, smem, st>>>((const u32*)wt, (const i32*)lit, \
        (const i32*)cmd, (const i32*)dist, (const i32*)bsw, (const i32*)cmap, \
        (const i32*)dx, (const i32*)consts, (const i32*)lut, (const i32*)tfm, \
        (const u8*)dict, (const u8*)tfs, (const u8*)cdict, (const i32*)cfg, \
        (const i32*)scal, (u8*)out, (i32*)status, n_lanes, wpad, out_cap, hrb, S); \
    return (int)cudaGetLastError(); }

#define V2(LP, WP, O, W) \
  if (lpw == LP && wpb == WP && toks == O && words == W) { \
    auto kern = k2<LP, WP, O, W>; \
    int rc = allow(kern, smem); if (rc) return rc; \
    kern<<<n_lanes / (LP * WP), 32 * WP, smem, st>>>((const u32*)wt, (const i32*)lit, \
        (const i32*)cmd, (const i32*)dist, (const i32*)dx, (const i32*)consts, \
        (const i32*)start_bit, (const i32*)mlen, (u32*)tok, (i32*)count, \
        (i32*)phase, (i32*)widx, n_lanes, P, lit_k, cmd_k, dist_k); \
    return (int)cudaGetLastError(); }

extern "C" int causes_decode3(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, int lpw, int wpb,
    int outs, int words, void* stream) {
  Decode3Shared S{};
  S.dict_n = dict_n; S.tfs_n = tfs_n; S.cd_n = cd_n; S.cd_t = cd_t;
  S.use_dict = use_dict != 0;
  const size_t block = (size_t)lpw * wpb;
  const size_t smem = (outs ? block * (hrb + out_cap) : 0) +
                      (words ? block * wpad * 4 : 0);
  cudaStream_t st = (cudaStream_t)stream;
  V3(32, 4, 0, 0) V3(32, 1, 0, 0) V3(32, 1, 1, 0) V3(32, 1, 0, 1)
  V3(32, 1, 1, 1) V3(16, 1, 0, 0) V3(16, 1, 1, 1) V3(8, 1, 1, 1)
  V3(8, 4, 0, 0) V3(4, 4, 0, 0) V3(2, 4, 0, 0) V3(1, 4, 0, 0)
  V3(4, 4, 1, 0) V3(4, 4, 0, 1) V3(4, 4, 1, 1)
  return (int)cudaErrorInvalidValue;
}

extern "C" int causes_decode2(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k, int lpw, int wpb, int toks,
    int words, void* stream) {
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  const size_t smem = words ? (size_t)lpw * wpb * wpad * 4 : 0;
  cudaStream_t st = (cudaStream_t)stream;
  V2(32, 4, 0, 0) V2(32, 1, 0, 0) V2(32, 1, 1, 0) V2(32, 1, 0, 1)
  V2(32, 1, 1, 1) V2(16, 1, 0, 0) V2(16, 1, 1, 1) V2(8, 1, 1, 1)
  V2(8, 4, 0, 0) V2(4, 4, 0, 0) V2(2, 4, 0, 0) V2(1, 4, 0, 0)
  V2(4, 4, 1, 0) V2(4, 4, 0, 1) V2(4, 4, 1, 1)
  return (int)cudaErrorInvalidValue;
}
"""


def _build(tmp: Path) -> ctypes.CDLL:
    for name in ("common.cuh", "queue.cuh", "decode2.cuh"):
        (tmp / name).write_bytes((build.CSRC / name).read_bytes())
    hdr = (build.CSRC / "decode3.cuh").read_text()
    if hdr.count(REFILL_LDG) != 1:
        raise RuntimeError("decode3.cuh's refill line moved: update the patch")
    (tmp / "decode3.cuh").write_text(hdr.replace(REFILL_LDG, REFILL_PLAIN))
    (tmp / "causes.cu").write_text(SOURCE)
    lib = tmp / "libcauses.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(tmp / "causes.cu")]
    t0 = time.perf_counter()
    p = subprocess.run(cmd, capture_output=True, text=True)
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
    print(f"[causes] variants built in {time.perf_counter() - t0:.3f} s")
    for line in (p.stdout + p.stderr).splitlines():
        if "registers" in line or "spill" in line:
            print(f"[causes] {line.strip()}")
    so = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    so.causes_decode3.argtypes = [P] * 17 + [I] * 13 + [P]
    so.causes_decode2.argtypes = [P] * 12 + [I] * 13 + [P]
    so.causes_decode3.restype = so.causes_decode2.restype = I
    return so


def _corpus(n_bytes: int) -> bytes:
    root = Path(__file__).resolve().parents[2]
    src = b"".join(p.read_bytes()
                   for p in sorted((root / "brotli_tpu").rglob("*.py")))
    base = src + (root / "brotli_tpu" / "data" / "dictionary.bin").read_bytes()
    return (base * (n_bytes // len(base) + 1))[:n_bytes]


def v2_cell(uniform: bool = False):
    """The v2 cell; with `uniform`, each of its 1024 streams 4 times in a
    row and not rate-sorted, so the lanes of a 4-lane warp are one
    stream's."""
    from .. import encode_sharded
    from ..ops import decode2 as D

    streams = encode_sharded(_corpus(1024 * 8192), chunk_size=8192,
                             max_distance=2032)
    if uniform:
        batch = D.preflight_shared([s for s in streams for _ in range(4)],
                                   groups=4, rate_sort=False)
    else:
        batch = D.preflight_shared(streams * 4, groups=4, rate_sort=True)
    return D.batch_to_torch(batch, "cuda")


def v3_cell(uniform: bool = False):
    """The v3 cell; with `uniform`, its first 1536 streams 4 times each in
    a row (the preflight's stable sort keeps the copies together), so the
    lanes of a 4-lane warp are one stream's."""
    from .. import encode_device_batch
    from ..ops import decode3 as D3
    from ..ops.preflight3 import preflight_v3

    piece = 1024 * V3_BENCH["chunk_size"]
    data = _corpus(6 * piece)
    streams = []
    for g in range(6):
        streams += encode_device_batch(data[g * piece:(g + 1) * piece],
                                       device="cuda", **V3_BENCH)
    if uniform:
        streams = [s for s in streams[:1536] for _ in range(4)]
    batch = preflight_v3(streams, max_groups=6)
    return D3.batch_to_torch_v3(batch, "cuda")


def main() -> int:
    variants = VARIANTS if "--redesign-only" not in sys.argv[1:] else []
    if not torch.cuda.is_available():
        print("decode_causes: no CUDA card", file=sys.stderr)
        return 1
    from ..ops import decode2 as D
    from ..ops import decode3 as D3

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(f"[causes] {card}")
    with tempfile.TemporaryDirectory() as d:
        so = _build(Path(d))
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        tb3 = v3_cell()
        ref3 = D3.decode3_direct(tb3, False)
        torch.cuda.synchronize()
        total3 = int(tb3.scal[1].sum().item())
        for lpw, wpb, outs, words in variants:
            res = {}
            name = variant_name(lpw, wpb, outs, words, "out in shared")

            def run3():
                out, status = D3._alloc_outputs(tb3)
                rc = so.causes_decode3(
                    *D3._c_args(tb3, out, status, False), lpw, wpb, outs,
                    words, stream())
                if rc:
                    raise RuntimeError(f"v3 {name}: cudaError {rc}")
                res["o"] = (out, status)

            try:
                ms = time_device_fn(run3) * 1e3
            except RuntimeError as e:
                print(f"[causes] v3 cell {name}: refused ({e})")
                continue
            same = all(torch.equal(a, b) for a, b in zip(res["o"], ref3))
            print(f"[causes] {card}: v3 cell {name:50s} {ms:9.4f} ms "
                  f"({total3 / ms / 1e3:9.2f} MB/s), outputs equal the direct "
                  f"kernel's: {same}")
        redesign_v3(tb3, ref3, total3, card)
        del tb3, ref3
        tb2 = v2_cell()
        ref2 = D.entropy_decode_direct(tb2)
        torch.cuda.synchronize()
        total2 = int(tb2.mlen.sum().item())
        for lpw, wpb, toks, words in variants:
            res = {}
            name = variant_name(lpw, wpb, toks, words, "tokens to shared")

            def run2():
                outs = D._alloc_outputs(tb2)
                rc = so.causes_decode2(*D._c_args(tb2, outs), lpw, wpb, toks,
                                       words, stream())
                if rc:
                    raise RuntimeError(f"v2 {name}: cudaError {rc}")
                res["o"] = outs

            try:
                ms = time_device_fn(run2) * 1e3
            except RuntimeError as e:
                print(f"[causes] v2 cell {name}: refused ({e})")
                continue
            k = 1 if toks else 0
            same = all(torch.equal(a, b) for a, b in zip(res["o"][k:], ref2[k:]))
            print(f"[causes] {card}: v2 cell {name:50s} {ms:9.4f} ms "
                  f"({total2 / ms / 1e3:9.2f} MB/s), "
                  f"{'count, phase, widx' if toks else 'outputs'} equal the "
                  f"direct kernel's: {same}")
        redesign_v2(tb2, ref2, total2, card)
        del tb2, ref2
        uniform_warps(so, card)
    return 0


def uniform_warps(so, card: str) -> None:
    """What divergence costs: both kernels at 4 lanes a warp on cells whose
    4 lanes of a warp decode the same stream, beside the same kernels on
    the cells themselves (timed above)."""
    from ..ops import decode2 as D
    from ..ops import decode3 as D3

    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    tb3 = v3_cell(uniform=True)
    total3 = int(tb3.scal[1].sum().item())

    def lanemap3():
        out, status = D3._alloc_outputs(tb3)
        rc = so.causes_decode3(*D3._c_args(tb3, out, status, False), 4, 4, 0,
                               0, stream())
        if rc:
            raise RuntimeError(f"cudaError {rc}")

    for name, fn in (("4 lanes a warp x 4 warps", lanemap3),
                     ("decode3_kernel", lambda: D3.decode3(tb3, False))):
        ms = time_device_fn(fn) * 1e3
        print(f"[causes] {card}: v3 uniform-warp cell {name:26s} {ms:9.4f} "
              f"ms ({total3 / ms / 1e3:9.2f} MB/s)")
    del tb3
    tb2 = v2_cell(uniform=True)
    total2 = int(tb2.mlen.sum().item())

    def lanemap2():
        outs = D._alloc_outputs(tb2)
        rc = so.causes_decode2(*D._c_args(tb2, outs), 4, 4, 0, 0, stream())
        if rc:
            raise RuntimeError(f"cudaError {rc}")

    for name, fn in (("4 lanes a warp x 4 warps", lanemap2),
                     ("decode2_kernel", lambda: run2(tb2, 4))):
        ms = time_device_fn(fn) * 1e3
        print(f"[causes] {card}: v2 uniform-warp cell {name:26s} {ms:9.4f} "
              f"ms ({total2 / ms / 1e3:9.2f} MB/s)")


def run3(tb, cfg: tuple):
    """decode3_kernel at launch config `cfg` (lanes a warp, window, table
    entries), use_dict=False; not counted as a main-path launch."""
    from ..ops import decode3 as D3

    return D3._launch(tb, False, "brotli_torch_decode3", list(cfg),
                      "decode3 kernel")


def run2(tb, lanes: int):
    """decode2_kernel at `lanes` lanes a warp; not counted."""
    from ..ops import decode2 as D

    return D._launch(tb, "brotli_torch_decode2", [lanes], "entropy kernel")


def redesign_v3(tb, ref, total: int, card: str) -> None:
    """decode3_kernel at its own launch config and at other lane maps,
    windows and table budgets, against the direct kernel's outputs."""
    from ..ops import decode3 as D3

    props = torch.cuda.get_device_properties(tb.device)
    sms, smem = (props.multi_processor_count,
                 props.shared_memory_per_multiprocessor)
    auto = D3.launch_config(tb, sms, smem)
    print(f"[causes] v3 cell: launch_config {auto} (lanes a warp, window, "
          f"table entries)")
    configs = {"launch_config": auto, "no tables": (*auto[:2], 0)}
    for window in (512, 256):
        configs[f"window {window}"] = D3._fit(tb, auto[0], sms, smem, window)
    for lanes in (2, 8, 16, 32):
        configs[f"lanes {lanes}"] = D3._fit(tb, lanes, sms, smem)
    for name, cfg in configs.items():
        res = {}
        ms = time_device_fn(lambda: res.__setitem__("o", run3(tb, cfg))) * 1e3
        same = all(torch.equal(a, b) for a, b in zip(res["o"], ref))
        print(f"[causes] {card}: v3 cell decode3_kernel {name:14s} {cfg} "
              f"{ms:9.4f} ms ({total / ms / 1e3:9.2f} MB/s), outputs equal "
              f"the direct kernel's: {same}")


def redesign_v2(tb, ref, total: int, card: str) -> None:
    """decode2_kernel at its own lane map and at others, against the
    direct kernel's outputs."""
    from ..ops import decode2 as D

    own = D.lanes_per_warp(tb.n_lanes, D.sm_count(tb.device))
    print(f"[causes] v2 cell: lanes_per_warp {own}")
    for lanes in (1, 2, 4, 8, 16, 32):
        res = {}
        ms = time_device_fn(
            lambda: res.__setitem__("o", run2(tb, lanes))) * 1e3
        same = all(torch.equal(a, b) for a, b in zip(res["o"], ref))
        print(f"[causes] {card}: v2 cell decode2_kernel lanes {lanes:2d}"
              f"{' (lanes_per_warp)' if lanes == own else ''} {ms:9.4f} ms "
              f"({total / ms / 1e3:9.2f} MB/s), outputs equal the direct "
              f"kernel's: {same}")


if __name__ == "__main__":
    sys.exit(main())
