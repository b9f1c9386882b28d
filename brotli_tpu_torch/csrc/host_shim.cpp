// Host build of the kernels' per-lane logic (decode2.cuh, decode3.cuh,
// resolve.cuh, pack.cuh), compiled with g++ so the CPU tests can hold the exact code the
// CUDA kernels run against the plain PyTorch versions.  Test-only: the
// encode and decode paths never call it.  The argument layouts are those of the CUDA entry
// points in decode2.cu, decode3.cu, resolve.cu and pack.cu, without the
// stream.
#include "decode2.cuh"
#include "decode3.cuh"
#include "pack.cuh"
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

extern "C" int brotli_torch_decode3_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict) {
  if (n_lanes <= 0 || n_lanes % 1024 != 0 || wpad < 1 || out_cap < 1 ||
      hrb < 0 || dict_n < 1 || tfs_n < 1 || cd_n < 1 || cd_t < 0 ||
      cd_t > cd_n)
    return 1;
  Decode3Shared S{};
  S.consts = (const i32*)consts;
  S.lut = (const i32*)lut;
  S.tfm = (const i32*)tfm;
  S.dict = (const u8*)dict;
  S.tfs = (const u8*)tfs;
  S.cdict = (const u8*)cdict;
  S.dict_n = dict_n;
  S.tfs_n = tfs_n;
  S.cd_n = cd_n;
  S.cd_t = cd_t;
  S.use_dict = use_dict != 0;
  const i64 stride = (i64)hrb + out_cap;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const Decode3Group G = make_group3(
        (const i32*)cfg + (lane / 1024) * NCFG3, (const i32*)lit,
        (const i32*)cmd, (const i32*)dist, (const i32*)bsw, (const i32*)cmap,
        (const i32*)dx);
    const Decode3Lane L{(const u32*)wt + lane, n_lanes, wpad,
                        (const i32*)scal + lane, n_lanes,
                        (u8*)out + (i64)lane * stride, hrb, out_cap,
                        (i32*)status + lane, n_lanes};
    decode3_lane(S, G, L);
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

extern "C" int brotli_torch_pack_host(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, int n_lanes, int rows, int n_groups, int tab_n, int cmap_n,
    int nt, int nbt, int pseg, int nseg) {
  if (n_lanes <= 0 || rows < 0 || n_groups <= 0 || tab_n <= 0 ||
      cmap_n < 128 || nt < 1 || pseg <= 0 || nseg <= 0 ||
      (nbt > 1 && (sw == nullptr || stype == nullptr)))
    return 1;
  const PackTables T{(const i32*)tab, (const i32*)cmap, (const i32*)consts,
                     tab_n, cmap_n, n_groups};
  const PackParams P{nt, nbt, pseg, nseg, rows, n_lanes};
  const i64 n = n_lanes;
  i32* st = (i32*)status;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const PackResult r = pack_lane(
        T, P, (const i32*)rec0 + lane, (const i32*)rec1 + lane,
        ((const i32*)grp)[lane], ((const i32*)init0)[lane],
        ((const i32*)initav)[lane],
        nbt > 1 ? (const i32*)sw + lane : nullptr,
        nbt > 1 ? (const i32*)stype + lane : nullptr, (i32*)words + lane);
    st[0 * n + lane] = (i32)r.widx;
    st[1 * n + lane] = (i32)r.avail;
    st[2 * n + lane] = (i32)r.b0;
    st[3 * n + lane] = (i32)r.b1;
    st[4 * n + lane] = (i32)r.b2;
    st[5 * n + lane] = (i32)r.ovf;
  }
  return 0;
}
