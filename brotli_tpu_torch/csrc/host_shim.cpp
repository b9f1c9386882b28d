// Host build of the kernels' per-lane logic (decode2.cuh, decode3.cuh,
// resolve.cuh, pack.cuh, probe.cuh), compiled with g++ so the CPU tests can
// hold the exact code the CUDA kernels run against the plain PyTorch
// versions.  Test-only: the encode and decode paths never call it.  The
// argument layouts are those of the CUDA entry points in decode2.cu,
// decode3.cu, resolve.cu, pack.cu and probe.cu, without the stream.
#include <algorithm>
#include <vector>

#include "decode2.cuh"
#include "decode3.cuh"
#include "pack.cuh"
#include "probe.cuh"
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

template <int LEVEL>
static void probe_v2_host(const i32* a, i32* carry, u32* staging, int blocks,
                          int block_rows) {
  for (int e = 0; e < PROBE_TILE; ++e) {
    const i32* arow = a + (e / PROBE_LANES) * PROBE_LANES;
    const u32 st0 = (u32)a[e];
    ProbeV2 c{st0, st0 + 1u, st0 + 2u, 0};
    for (int blk = 0; blk < blocks; ++blk) {
      for (int r = 0; r < block_rows; ++r) {
        probe_v2_row<LEVEL>(c, arow);
        if (LEVEL >= 4) staging[(i64)r * PROBE_TILE + e] = c.b0;
      }
    }
    carry[e] = (i32)c.b0;
    carry[PROBE_TILE + e] = (i32)c.b1;
    carry[2 * PROBE_TILE + e] = (i32)c.b2;
    carry[3 * PROBE_TILE + e] = c.q;
  }
}

extern "C" int brotli_torch_probe_v2_host(const void* a, void* carry,
                                          void* staging, int level,
                                          int blocks, int block_rows) {
  if (blocks < 1 || block_rows < 1) return 1;
  const i32* A = (const i32*)a;
  switch (level) {
    case 1: probe_v2_host<1>(A, (i32*)carry, (u32*)staging, blocks, block_rows); break;
    case 2: probe_v2_host<2>(A, (i32*)carry, (u32*)staging, blocks, block_rows); break;
    case 3: probe_v2_host<3>(A, (i32*)carry, (u32*)staging, blocks, block_rows); break;
    case 4: probe_v2_host<4>(A, (i32*)carry, (u32*)staging, blocks, block_rows); break;
    case 5: probe_v2_host<5>(A, (i32*)carry, (u32*)staging, blocks, block_rows); break;
    default: return 1;
  }
  return 0;
}

// One tile row (a CUDA block's 128 lanes) at a time, the reductions over
// its lanes; the refill copy only moves window contents, which no output
// reads, so the host keeps the fill level alone.
template <int NCARRY>
static void probe_v2b_host(const i32* a, u32* out, i32* stat, int wo,
                           int reduces, int dma_out, int blocks,
                           int block_rows) {
  std::vector<u32> c((std::size_t)PROBE_LANES * NCARRY);
  std::vector<u32> staging((std::size_t)block_rows * PROBE_LANES);
  for (int sub = 0; sub < PROBE_SUB; ++sub) {
    std::fill(staging.begin(), staging.end(), 0u);
    for (int l = 0; l < PROBE_LANES; ++l)
      for (int i = 0; i < NCARRY; ++i)
        c[l * NCARRY + i] = (u32)a[sub * PROBE_LANES + l] + (u32)i;
    i32 filled = PROBE_WIN;
    int blk = 0;
    for (;; ++blk) {
      if (blk >= blocks) break;
      if (wo && reduces) {
        bool any = false;
        for (int l = 0; l < PROBE_LANES; ++l)
          any = any || c[l * NCARRY] < 0xFFFFFFFFu;
        if (!any) break;
      }
      i32 minp = 1 << 30;
      if (reduces)
        for (int l = 0; l < PROBE_LANES; ++l) {
          const i32 k = probe_v2b_minkey(c[l * NCARRY], c[l * NCARRY + 1]);
          minp = k < minp ? k : minp;
        }
      if (probe_v2b_refill(reduces != 0, minp, filled)) filled += PROBE_REFILL;
      for (int l = 0; l < PROBE_LANES; ++l) {
        u32 cl[NCARRY];
        for (int i = 0; i < NCARRY; ++i) cl[i] = c[l * NCARRY + i];
        for (int r = 0; r < block_rows; ++r) {
          probe_v2b_row<NCARRY>(cl);
          staging[r * PROBE_LANES + l] = cl[0];
        }
        for (int i = 0; i < NCARRY; ++i) c[l * NCARRY + i] = cl[i];
      }
      if (dma_out)
        for (int r = 0; r < block_rows; ++r)
          for (int l = 0; l < PROBE_LANES; ++l)
            out[(i64)r * PROBE_TILE + sub * PROBE_LANES + l] =
                staging[r * PROBE_LANES + l];
    }
    for (int l = 0; l < PROBE_LANES; ++l) {
      staging[l] = c[l * NCARRY];
      for (int r = 0; r < 8; ++r)
        out[(i64)r * PROBE_TILE + sub * PROBE_LANES + l] =
            staging[r * PROBE_LANES + l];
    }
    stat[2 * sub] = blk;
    stat[2 * sub + 1] = filled;
  }
}

extern "C" int brotli_torch_probe_v2b_host(const void* a, const void* wt,
                                           void* out, void* stat, int ncarry,
                                           int while_outer, int reduces,
                                           int dma_in, int dma_out,
                                           int blocks, int block_rows,
                                           int wrows) {
  (void)wt;
  (void)dma_in;
  if (blocks < 1 || block_rows < 8 || wrows < PROBE_FILL_CAP) return 1;
  if (ncarry == 4)
    probe_v2b_host<4>((const i32*)a, (u32*)out, (i32*)stat, while_outer,
                      reduces, dma_out, blocks, block_rows);
  else if (ncarry == 18)
    probe_v2b_host<18>((const i32*)a, (u32*)out, (i32*)stat, while_outer,
                       reduces, dma_out, blocks, block_rows);
  else
    return 1;
  return 0;
}
