// Host build of the kernels' per-lane logic (decode2.cuh, resolve.cuh),
// compiled with g++ so the CPU tests can hold the exact code the CUDA
// kernels run against the plain PyTorch versions.  Test-only: the decode
// path never calls it.  The argument layouts are those of the CUDA entry
// points in decode2.cu and resolve.cu, without the stream.
#include "decode2.cuh"
#include "resolve.cuh"

using namespace brotli_torch;

extern "C" int brotli_torch_decode2_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k) {
  if (n_lanes <= 0 || n_lanes % 1024 != 0 || lit_k < 2 || lit_k > LIT_K ||
      cmd_k < 2 || cmd_k > CMD_K || dist_k < 2 || dist_k > DIST_K)
    return 1;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  const i32* sb = (const i32*)start_bit;
  const i32* ml = (const i32*)mlen;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const int g = lane / 1024;
    const Decode2Tables T{(const i32*)lit + g * lit_k * 128,
                          (const i32*)cmd + g * cmd_k * 128,
                          (const i32*)dist + g * dist_k * 128,
                          (const i32*)dx, (const i32*)consts,
                          lit_k, cmd_k, dist_k};
    const Decode2Result r = decode2_lane(T, P, (const u32*)wt + lane, n_lanes,
                                         sb[lane], ml[lane],
                                         (u32*)tok + lane, n_lanes);
    ((i32*)count)[lane] = r.count;
    ((i32*)phase)[lane] = r.phase;
    ((i32*)widx)[lane] = r.widx;
  }
  return 0;
}

extern "C" int brotli_torch_resolve_host(const void* tok, const void* count,
                                         const void* mlen, void* out,
                                         void* err, int n_lanes, int cap,
                                         long long out_stride) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0) return 1;
  for (int lane = 0; lane < n_lanes; ++lane) {
    ((i32*)err)[lane] = resolve_lane(
        (const u32*)tok + lane, n_lanes, ((const i32*)count)[lane], cap,
        ((const i32*)mlen)[lane], (u8*)out + (i64)lane * out_stride,
        out_stride);
  }
  return 0;
}
