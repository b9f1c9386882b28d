// Host build of the kernels' per-lane logic (decode2.cuh, decode3.cuh,
// queue.cuh, resolve.cuh, pack.cuh, parse.cuh, probe.cuh, zopfli.cuh,
// matches.cuh, records.cuh), compiled with
// g++ so the CPU tests can hold the exact code the CUDA kernels run against
// the plain PyTorch versions.  Test-only: the encode and decode paths never call it.
// The argument layouts are those of the CUDA entry points in decode2.cu,
// decode3.cu, resolve.cu, pack.cu, parse.cu, probe.cu, zopfli.cu, matches.cu
// and records.cu, without the stream.
#include <algorithm>
#include <cstdint>
#include <vector>

#include "decode2.cuh"
#include "decode3.cuh"
#include "matches.cuh"
#include "pack.cuh"
#include "parse.cuh"
#include "probe.cuh"
#include "records.cuh"
#include "resolve.cuh"
#include "zopfli.cuh"

using namespace brotli_torch;

static bool decode2_host_ok(int n_lanes, int lit_k, int cmd_k, int dist_k) {
  return n_lanes > 0 && n_lanes % 1024 == 0 && lit_k >= 2 && lit_k <= LIT_K &&
         cmd_k >= 2 && cmd_k <= CMD_K && dist_k >= 2 && dist_k <= DIST_K;
}

static Decode2Tables decode2_tables(const void* lit, const void* cmd,
                                    const void* dist, const void* dx,
                                    const void* consts, int g, int lit_k,
                                    int cmd_k, int dist_k) {
  return Decode2Tables{(const i32*)lit + g * lit_k * 128,
                       (const i32*)cmd + g * cmd_k * 128,
                       (const i32*)dist + g * dist_k * 128,
                       (const i32*)dx, (const i32*)consts,
                       lit_k, cmd_k, dist_k};
}

// The direct kernel of decode2.cu, lane by lane.
extern "C" int brotli_torch_decode2_direct_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k) {
  if (!decode2_host_ok(n_lanes, lit_k, cmd_k, dist_k)) return 1;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  const i32* sb = (const i32*)start_bit;
  const i32* ml = (const i32*)mlen;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const Decode2Tables T = decode2_tables(lit, cmd, dist, dx, consts,
                                           lane / 1024, lit_k, cmd_k, dist_k);
    const Decode2Result r = decode2_lane(T, P, (const u32*)wt + lane, n_lanes,
                                         sb[lane], ml[lane],
                                         (u32*)tok + lane, n_lanes);
    ((i32*)count)[lane] = r.count;
    ((i32*)phase)[lane] = r.phase;
    ((i32*)widx)[lane] = r.widx;
  }
  return 0;
}

// The queued kernel of decode2.cu, lane by lane, each lane's queue in a
// host array; `lpw` is checked as the kernel checks it.
extern "C" int brotli_torch_decode2_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* dx, const void* consts, const void* start_bit,
    const void* mlen, void* tok, void* count, void* phase, void* widx,
    int n_lanes, int wpad, int cap, int npostfix, int ndirect, int maxbw,
    int lit_k, int cmd_k, int dist_k, int lpw) {
  if (!decode2_host_ok(n_lanes, lit_k, cmd_k, dist_k) || lpw < 1 ||
      lpw > 32 || (lpw & (lpw - 1)) != 0)
    return 1;
  const Decode2Params P{npostfix, ndirect, maxbw, wpad, cap};
  const i32* sb = (const i32*)start_bit;
  const i32* ml = (const i32*)mlen;
  u32 q[QUEUE_R];
  for (int lane = 0; lane < n_lanes; ++lane) {
    const Decode2Tables T = decode2_tables(lit, cmd, dist, dx, consts,
                                           lane / 1024, lit_k, cmd_k, dist_k);
    Queued2 O{WordQueue{(const u32*)wt + lane, n_lanes, wpad, q, 1},
              (u32*)tok + lane, n_lanes};
    const Decode2Result r = decode2_lane_queued(T, P, sb[lane], ml[lane], O);
    ((i32*)count)[lane] = r.count;
    ((i32*)phase)[lane] = r.phase;
    ((i32*)widx)[lane] = r.widx;
  }
  return 0;
}

// decode3.cu's decode3_args_ok: whole groups of group_lanes lanes, each a
// whole number of 128-lane blocks
static bool decode3_host_ok(int n_lanes, int wpad, int out_cap, int hrb,
                            int dict_n, int tfs_n, int cd_n, int cd_t,
                            int group_lanes) {
  return group_lanes > 0 && group_lanes % 128 == 0 && n_lanes > 0 &&
         n_lanes % group_lanes == 0 && wpad >= 1 && out_cap >= 1 &&
         hrb >= 0 && dict_n >= 1 && tfs_n >= 1 && cd_n >= 1 && cd_t >= 0 &&
         cd_t <= cd_n;
}

static Decode3Shared decode3_host_shared(
    const void* consts, const void* lut, const void* tfm, const void* dict,
    const void* tfs, const void* cdict, int dict_n, int tfs_n, int cd_n,
    int cd_t, int use_dict) {
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
  return S;
}

// The direct kernel of decode3.cu, lane by lane.
extern "C" int brotli_torch_decode3_direct_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, int group_lanes) {
  if (!decode3_host_ok(n_lanes, wpad, out_cap, hrb, dict_n, tfs_n, cd_n, cd_t,
                       group_lanes))
    return 1;
  const Decode3Shared S = decode3_host_shared(
      consts, lut, tfm, dict, tfs, cdict, dict_n, tfs_n, cd_n, cd_t, use_dict);
  const i64 stride = (i64)hrb + out_cap;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const Decode3Group G = make_group3(
        (const i32*)cfg + (lane / group_lanes) * NCFG3, (const i32*)lit,
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

// The windowed kernel of decode3.cu, lane by lane: each lane's window of
// `win` bytes and its queue in host arrays.  `lpw` and `tab_ints` are
// checked as the kernel checks them; where the kernel keeps a table does
// not change what it reads.
extern "C" int brotli_torch_decode3_host(
    const void* wt, const void* lit, const void* cmd, const void* dist,
    const void* bsw, const void* cmap, const void* dx, const void* consts,
    const void* lut, const void* tfm, const void* dict, const void* tfs,
    const void* cdict, const void* cfg, const void* scal, void* out,
    void* status, int n_lanes, int wpad, int out_cap, int hrb, int dict_n,
    int tfs_n, int cd_n, int cd_t, int use_dict, int group_lanes, int lpw,
    int win, int tab_ints) {
  if (!decode3_host_ok(n_lanes, wpad, out_cap, hrb, dict_n, tfs_n, cd_n,
                       cd_t, group_lanes) ||
      lpw < 1 || lpw > 32 || (lpw & (lpw - 1)) != 0 ||
      group_lanes % (4 * lpw) != 0 || win < 64 ||
      (win & (win - 1)) != 0 || tab_ints < 0 || ((uintptr_t)out & 15) != 0)
    return 1;
  const Decode3Shared S = decode3_host_shared(
      consts, lut, tfm, dict, tfs, cdict, dict_n, tfs_n, cd_n, cd_t, use_dict);
  const i64 stride = (i64)hrb + out_cap;
  std::vector<u8> window((std::size_t)win);
  u32 q[QUEUE_R];
  for (int lane = 0; lane < n_lanes; ++lane) {
    const Decode3Group G = make_group3(
        (const i32*)cfg + (lane / group_lanes) * NCFG3, (const i32*)lit,
        (const i32*)cmd, (const i32*)dist, (const i32*)bsw, (const i32*)cmap,
        (const i32*)dx);
    u8* slot = (u8*)out + (i64)lane * stride;
    const Decode3Lane L{nullptr, n_lanes, wpad, (const i32*)scal + lane,
                        n_lanes, slot, hrb, out_cap, (i32*)status + lane,
                        n_lanes};
    // a window byte read before the lane wrote it would show as 0xA5 in
    // the lane's bytes, which the tests hold against the plain version
    std::fill(window.begin(), window.end(), (u8)0xA5);
    Ring3 O{L, WordQueue{(const u32*)wt + lane, n_lanes, wpad, q, 1},
            window.data(), win - 1, (i32)((uintptr_t)slot & 15), 0};
    decode3_lane_windowed(S, G, L, O);
  }
  return 0;
}

// The direct kernel of resolve.cu, lane by lane.
extern "C" int brotli_torch_resolve_direct_host(const void* tok,
                                                const void* count,
                                                const void* mlen, void* out,
                                                void* err, int n_lanes,
                                                int cap, long long out_stride) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0) return 1;
  for (int lane = 0; lane < n_lanes; ++lane) {
    ((i32*)err)[lane] = resolve_lane(
        (const u32*)tok + lane, n_lanes, ((const i32*)count)[lane], cap,
        ((const i32*)mlen)[lane], (u8*)out + (i64)lane * out_stride,
        out_stride);
  }
  return 0;
}

// The warp kernel of resolve.cu, lane by lane, the 32 threads of each step
// as loops: each lane's window of `win` bytes and its token ring in host
// arrays.  `win` and the alignment of `out` are checked as the launch
// checks them.
extern "C" int brotli_torch_resolve_host(const void* tok, const void* count,
                                         const void* mlen, void* out,
                                         void* err, int n_lanes, int cap,
                                         long long out_stride, int win) {
  if (n_lanes <= 0 || cap < 0 || out_stride < 0 || win < RESOLVE_WIN_MIN ||
      (win & (win - 1)) != 0 || ((uintptr_t)out & 15) != 0)
    return 1;
  std::vector<u8> window((std::size_t)win + 16);
  u8* w = window.data() + ((16 - ((uintptr_t)window.data() & 15)) & 15);
  u32 tq[TOKQ];
  for (int lane = 0; lane < n_lanes; ++lane) {
    // a window byte read before the lane wrote it would show as 0xA5 in
    // the lane's bytes, which the tests hold against the plain version
    std::fill(w, w + win, (u8)0xA5);
    const i32 cnt = ((const i32*)count)[lane];
    const ResolveWarpLane L{(const u32*)tok + lane, n_lanes,
                            cnt < cap ? cnt : cap, ((const i32*)mlen)[lane],
                            (u8*)out + (i64)lane * out_stride, out_stride,
                            w, win - 1, tq};
    ((i32*)err)[lane] = resolve_lane_warp(L);
  }
  return 0;
}

static void pack_host_lane(const PackTables& T, const PackParams& P,
                           const void* rec0, const void* rec1,
                           const void* grp, const void* init0,
                           const void* initav, const void* sw,
                           const void* stype, void* words, void* status,
                           int lane) {
  const i64 n = P.n_lanes;
  const PackResult r = pack_lane(
      T, P, (const i32*)rec0 + lane, (const i32*)rec1 + lane,
      ((const i32*)grp)[lane], ((const i32*)init0)[lane],
      ((const i32*)initav)[lane],
      P.nbt > 1 ? (const i32*)sw + lane : nullptr,
      P.nbt > 1 ? (const i32*)stype + lane : nullptr, (i32*)words + lane);
  i32* st = (i32*)status;
  st[0 * n + lane] = (i32)r.widx;
  st[1 * n + lane] = (i32)r.avail;
  st[2 * n + lane] = (i32)r.b0;
  st[3 * n + lane] = (i32)r.b1;
  st[4 * n + lane] = (i32)r.b2;
  st[5 * n + lane] = (i32)r.ovf;
}

// The serial kernel of pack.cu: the row machine, lane by lane.
extern "C" int brotli_torch_pack_serial_host(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, int n_lanes, int rows, int n_groups, int tab_n, int cmap_n,
    int nt, int nbt, int pseg, int nseg) {
  if (!pack_args_ok(sw, stype, n_lanes, rows, n_groups, tab_n, cmap_n,
                         nt, nbt, pseg, nseg))
    return 1;
  const PackTables T{(const i32*)tab, (const i32*)cmap, (const i32*)consts,
                     tab_n, cmap_n, n_groups};
  const PackParams P{nt, nbt, pseg, nseg, rows, n_lanes};
  for (int lane = 0; lane < n_lanes; ++lane)
    pack_host_lane(T, P, rec0, rec1, grp, init0, initav, sw, stype, words,
                   status, lane);
  return 0;
}

// The segmented kernel of pack.cu: its four passes in order, each over
// every (segment, lane) or lane.  A word that pass 3 stores without an OR
// must still be zero, or the segments overlap: the shim returns 2.
extern "C" int brotli_torch_pack_host(
    const void* rec0, const void* rec1, const void* tab, const void* cmap,
    const void* consts, const void* grp, const void* init0,
    const void* initav, const void* sw, const void* stype, void* words,
    void* status, void* scratch, int n_lanes, int rows, int n_groups,
    int tab_n, int cmap_n, int nt, int nbt, int pseg, int nseg) {
  if (!pack_args_ok(sw, stype, n_lanes, rows, n_groups, tab_n, cmap_n,
                         nt, nbt, pseg, nseg) ||
      scratch == nullptr)
    return 1;
  const PackTables T{(const i32*)tab, (const i32*)cmap, (const i32*)consts,
                     tab_n, cmap_n, n_groups};
  const PackParams P{nt, nbt, pseg, nseg, rows, n_lanes};
  const i64 n = n_lanes;
  const int nsegr = (rows + PACK_SEG - 1) / PACK_SEG;
  const i64 plane = (i64)nsegr * n;
  i32* cnt = (i32*)scratch;
  u32* body = (u32*)words;
  i32* st = (i32*)status;
  auto lane_sw = [&](int lane) {
    return nbt > 1 ? (const i32*)sw + lane : nullptr;
  };
  auto lane_stype = [&](int lane) {
    return nbt > 1 ? (const i32*)stype + lane : nullptr;
  };
  for (int g = 0; g < nsegr; ++g)
    for (int lane = 0; lane < n_lanes; ++lane) {
      const PackLaneCtx L = pack_lane_ctx(T, P, ((const i32*)grp)[lane]);
      const PackSegCount c = pack_seg_count(
          T, P, L, g * PACK_SEG, std::min(rows, (g + 1) * PACK_SEG),
          (const i32*)rec0 + lane, (const i32*)rec1 + lane, lane_sw(lane),
          lane_stype(lane));
      cnt[g * n + lane] = c.bits;
      cnt[plane + g * n + lane] = c.a;
      cnt[2 * plane + g * n + lane] = c.t;
    }
  for (int lane = 0; lane < n_lanes; ++lane)
    pack_scan_lane(cnt + lane, nsegr, n, rows, ((const i32*)init0)[lane],
                   ((const i32*)initav)[lane], st + lane, (i32*)words + lane);
  bool overlap = false;
  for (int g = 0; g < nsegr; ++g)
    for (int lane = 0; lane < n_lanes; ++lane) {
      const i32 widx = st[lane];
      const PackLaneCtx L = pack_lane_ctx(T, P, ((const i32*)grp)[lane]);
      const bool ovf = pack_seg_emit(
          T, P, L, g * PACK_SEG, std::min(rows, (g + 1) * PACK_SEG),
          (const i32*)rec0 + lane, (const i32*)rec1 + lane, lane_sw(lane),
          lane_stype(lane), cnt[g * n + lane], cnt[plane + g * n + lane],
          [&](i32 k, u32 v, bool shared) {
            if (k < widx) {
              u32& w = body[(i64)k * n + lane];
              overlap |= !shared && w != 0;
              w = shared ? w | v : v;
            } else if (k - widx < 3) {
              ((u32*)st)[(2 + k - widx) * n + lane] |= v;
            }
          });
      if (ovf) st[5 * n + lane] = 1;
    }
  for (int lane = 0; lane < n_lanes; ++lane) {
    if (st[5 * n + lane] == 0) continue;
    for (int r = 0; r < rows; ++r) ((i32*)words)[(i64)r * n + lane] = 0;
    pack_host_lane(T, P, rec0, rec1, grp, init0, initav, sw, stype, words,
                   status, lane);
  }
  return overlap ? 2 : 0;
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

// The warp of parse_direct_kernel is a loop here: the gate for each
// position of a window into bit masks, then the same window walk.
extern "C" int brotli_torch_parse_direct_host(
    const void* mlen, const void* mdist, const void* n_valid, void* is_cs,
    void* is_lit, void* dcode, int n_lanes, int n, int lazy0, int lazy1,
    int min_gate, int sms) {
  (void)sms;
  if (n_lanes <= 0 || n <= 0) return 1;
  const ParseKnobs K{lazy0, lazy1, min_gate};
  std::vector<i32> sc(n + 2);
  for (int lane = 0; lane < n_lanes; ++lane) {
    const i64 row = (i64)lane * n;
    const i32* ml = (const i32*)mlen + row;
    const i32* md = (const i32*)mdist + row;
    u8* cs = (u8*)is_cs + row;
    u8* lit = (u8*)is_lit + row;
    i32* dc = (i32*)dcode + row;
    const i32 nv = ((const i32*)n_valid)[lane];
    for (int p = 0; p < n; ++p) sc[p] = parse_score(ml[p], md[p]);
    sc[n] = sc[n + 1] = 0;
    ParseLane s = parse_lane_init();
    for (int base = 0; base < n; base += PARSE_W) {
      const int w_n = std::min(PARSE_W, n - base);
      u32 take = 0, in_chunk = 0;
      for (int i = 0; i < w_n; ++i) {
        const int p = base + i;
        take |= (u32)parse_take(K, ml[p], sc[p], sc[p + 1], sc[p + 2], p, nv)
                << i;
        in_chunk |= (u32)(p < nv) << i;
        dc[p] = -1;
      }
      const ParseWindow w = parse_window(
          s, base, take, in_chunk,
          [&](int i, i32& len, i32& d) {
            len = ml[base + i];
            d = md[base + i];
          },
          [&](int i, i32 code) { dc[base + i] = code; });
      for (int i = 0; i < w_n; ++i) {
        cs[base + i] = (u8)((w.cs >> i) & 1u);
        lit[base + i] = (u8)((w.lit >> i) & 1u);
      }
    }
  }
  return 0;
}

// The short codes of `cnt` copies at distances dist[0..cnt), the ring
// carried in and out: parse_kernel's phase 4 in chunks of nt copies, a
// copy a thread, the ballot prefix count a loop.  pushed has 4 + cnt
// slots.
static void parse_codes_host(const i32* dist, i32 cnt, i32* ring, i32* pushed,
                             i32* codes, int nt) {
  for (int r = 0; r < 4; ++r) pushed[3 - r] = ring[r];
  std::vector<i32> pj(nt);
  i32 total = 0;
  for (i32 c0 = 0; c0 < cnt; c0 += nt) {
    const i32 hi = std::min(cnt, c0 + nt);
    for (i32 j = c0; j < hi; ++j) {  // the flags and their prefix count
      pj[j - c0] = total;
      if (parse_pushes(dist[j], j ? dist[j - 1] : ring[0])) ++total;
    }
    for (i32 j = c0; j < hi; ++j)
      if (parse_pushes(dist[j], j ? dist[j - 1] : ring[0]))
        pushed[4 + pj[j - c0]] = dist[j];
    for (i32 j = c0; j < hi; ++j)
      codes[j] = parse_code(pushed + 3 + pj[j - c0], dist[j]);
  }
  if (cnt)
    for (int r = 0; r < 4; ++r) ring[r] = pushed[3 + total - r];
}

// parse_kernel's block on the host, a lane at a time: tiles of `tile`
// positions (a multiple of 32 up to PARSE_TILE) and speculation segments of
// `seg` (a power of two from 32 up to the tile; the card's are PARSE_TILE
// and PARSE_SEG), in the kernel's order and buffers: tile 0 through phases
// 0-2, then for each tile k phases 3-4 of tile k, 0-2 of tile k + 1 and
// 5-6 of tile k; the threads of warp 0, of the gate warps and of the block
// as loops.
extern "C" int brotli_torch_parse_host(const void* mlen, const void* mdist,
                                       const void* n_valid, void* is_cs,
                                       void* is_lit, void* dcode, int n_lanes,
                                       int n, int lazy0, int lazy1,
                                       int min_gate, int sms, int tile,
                                       int seg) {
  (void)sms;
  if (n_lanes <= 0 || n <= 0 || tile < 32 || tile > PARSE_TILE || tile % 32 ||
      seg < 32 || seg > tile || (seg & (seg - 1)))
    return 1;
  const int seg_log = __builtin_ctz((unsigned)seg);
  const ParseKnobs K{lazy0, lazy1, min_gate};
  std::vector<ParseTile> mem(1);
  ParseTile& m = mem[0];
  std::vector<i32> dist(tile), codes(tile);
  for (int lane = 0; lane < n_lanes; ++lane) {
    const i64 row = (i64)lane * n;
    const i32* ml_g = (const i32*)mlen + row;
    const i32* md_g = (const i32*)mdist + row;
    const i32 nv = ((const i32*)n_valid)[lane];
    const int n_tiles = (n + tile - 1) / tile;
    auto ctx = [&](int k) {
      return parse_tile_ctx(K, n, nv, tile, seg_log, k);
    };
    // 0-2: stage, gate (four positions a thread) and succ
    auto gate = [&](const ParseTileCtx& c) {
      const int len = std::min(tile + PARSE_HALO, n - c.base);
      std::copy(ml_g + c.base, ml_g + c.base + len, m.ml[c.buf]);
      std::copy(md_g + c.base, md_g + c.base + len, m.md[c.buf]);
      m.nz[c.buf] = 0;
      for (int w = 0; w < c.nw; ++w) {
        u32 word = 0;
        for (int q = 0; q < 8; ++q)
          word |= parse_tile_take4(m, c, (w << 5) + 4 * q) << (4 * q);
        m.take[c.buf][w] = word;
        m.nz[c.buf] |= (u32)(word != 0) << w;
      }
      for (int t = 0; t < PARSE_GATE_THREADS; ++t)
        parse_tile_succ<PARSE_GATE_THREADS>(m, c, t);
    };
    i64 front = 0;
    i32 ring[4] = {4, 11, 15, 16};
    gate(ctx(0));
    for (int k = 0; k < n_tiles; ++k) {
      const ParseTileCtx c = ctx(k);
      // 3-4: the speculative walks, the resolution, the list, the words
      for (int g = 0; g << seg_log < c.tn; ++g) parse_tile_spec(m, c, g);
      front = parse_tile_resolve(m, c, front);
      i32 before = 0, last = -1;
      for (int w = 0; w < c.nw; ++w) {
        const u32 cs = parse_word_starts(m, c, w);
        parse_word_list(m, c, w, cs, before, last);
        before += __builtin_popcount(cs);
        if (cs) last = (w << 5) + parse_top(cs);
      }
      m.cnt = before;
      for (int w = 0; w < c.nw; ++w) parse_tile_words(m, c, w, 32);
      if (k + 1 < n_tiles) gate(ctx(k + 1));
      // 5: the codes, the pushed distances over the tile's staged mlen
      for (i32 j = 0; j < m.cnt; ++j) dist[j] = m.md[c.buf][m.list[j]];
      parse_codes_host(dist.data(), m.cnt, ring, m.ml[c.buf], codes.data(),
                       PARSE_THREADS);
      for (i32 j = 0; j < m.cnt; ++j) m.code[m.list[j]] = (i8)codes[j];
      // 6: the rows
      for (int t = 0; t < PARSE_THREADS; ++t)
        parse_tile_store(m, c, (u8*)is_cs + row, (u8*)is_lit + row,
                         (i32*)dcode + row, true, t, PARSE_THREADS);
    }
  }
  return 0;
}

// The short codes of a lane's copies, at distances dist[0..n_copies), two
// ways: `collapsed` 0 steps parse_copy's ring copy by copy (the direct
// kernel's); 1 takes parse_kernel's collapsed ring, the copies cut into
// tiles of `tile_copies` with the ring carried between them, each in
// chunks of `threads` copies.
extern "C" int brotli_torch_parse_ring_host(const void* dist, int n_copies,
                                            void* codes, int collapsed,
                                            int tile_copies, int threads) {
  if (n_copies < 0 || tile_copies < 1 || threads < 1) return 1;
  const i32* d = (const i32*)dist;
  i32* out = (i32*)codes;
  if (!collapsed) {
    ParseLane s = parse_lane_init();
    for (int j = 0; j < n_copies; ++j) out[j] = parse_copy(s, j, 1, d[j]);
    return 0;
  }
  i32 ring[4] = {4, 11, 15, 16};
  std::vector<i32> pushed(4 + tile_copies);
  for (int j = 0; j < n_copies; j += tile_copies)
    parse_codes_host(d + j, std::min(tile_copies, n_copies - j), ring,
                     pushed.data(), out + j, threads);
  return 0;
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

// The warp of csrc/zopfli.cu is a loop here: a byte at a time for a match
// length, a length at a time for a relaxation, the same steps in order.
struct HostSteps {
  bool leader() const { return true; }
  void sync() const {}
  void mark(int) const {}
  i32 match_length(const u8* a, const u8* b, i32 limit) const {
    i32 k = 0;
    while (k < limit && a[k] == b[k]) ++k;
    return k;
  }
  template <class F>
  void lengths(i32 lo, i32 hi, F f) const {
    for (i32 l = lo; l <= hi; ++l) f(l);
  }
  template <class F>
  void spread(i32 lo, i32 hi, F f) const {
    for (i32 l = lo; l <= hi; ++l) f(l);
  }
  template <class F>
  void each_thread(F f) const {
    for (int t = 0; t < 32; ++t) f(t);
  }
  template <class F>
  void each(i32 lo, i32 hi, F f) const {
    for (i32 i = lo; i < hi; ++i) f(i);
  }
  template <class F>
  u32 ballot(F f) const {
    u32 mask = 0;
    for (int j = 0; j < 32; ++j) mask |= (u32)f(j) << j;
    return mask;
  }

  template <class F>
  i32 first_false(i32 lo, F f) const {
    while (f(lo)) ++lo;
    return lo;
  }
  i32 reduce_max(i32 x) const { return x; }
};

static ZopfliLane zopfli_host_lane(const void* data, const void* lit, const void* cmd,
                                   const void* dist, const void* min_cost_cmd,
                                   const void* start_cache, const void* n_valid,
                                   const void* moff, const void* mlen, const void* mdist,
                                   const void* mdelta, const void* active, int lane,
                                   int n_max, int stride, int max_zlen) {
  return ZopfliLane{(const u8*)data + (i64)lane * stride,
                    (const double*)lit + (i64)lane * (n_max + 2),
                    (const double*)cmd + (i64)lane * ZOPFLI_NUM_CMD,
                    (const double*)dist + (i64)lane * ZOPFLI_DIST_ROW,
                    ((const double*)min_cost_cmd)[lane],
                    (const i32*)start_cache + 4 * lane,
                    (const i32*)moff + (i64)lane * (n_max + 1),
                    (const i32*)mlen,
                    (const i32*)mdist,
                    (const i32*)mdelta,
                    (const u8*)active + (i64)lane * n_max,
                    ((const i32*)n_valid)[lane],
                    max_zlen};
}

static ZopfliNodes zopfli_host_nodes(void* cost, void* len, void* ndist, void* dci, void* sc,
                                     int lane, int n_max) {
  const i64 nrow = (i64)lane * (n_max + 1);
  return ZopfliNodes{(double*)cost + nrow, (u32*)len + nrow, (i32*)ndist + nrow,
                     (u32*)dci + nrow, (i32*)sc + nrow};
}

// The window kernel's lanes (zopfli_lane_win), at a window of `window`
// slots; `blocks` is the card's launch shape and unused here.
extern "C" int brotli_torch_zopfli_host(
    const void* data, const void* lit, const void* cmd, const void* dist,
    const void* min_cost_cmd, const void* start_cache, const void* n_valid,
    const void* moff, const void* mlen, const void* mdist, const void* mdelta,
    const void* active, void* cost, void* len, void* ndist, void* dci,
    void* sc, void* result, void* tried, void* rec, int n_lanes, int n_max,
    int stride, int max_zlen, int blocks, int window) {
  (void)blocks;
  if (n_lanes <= 0 || n_max <= 0 || stride < n_max || window < 64 ||
      (window & (window - 1)) != 0)
    return 1;
  const HostSteps w;
  std::vector<double> tables(ZOPFLI_NUM_CMD + ZOPFLI_DIST_ROW), wcost(window), wlit(window);
  // len, dist, dci, sc, nx; records; walks
  std::vector<u32> fields(13 * (size_t)window);
  u32* f = fields.data();
  const ZopfliWindow V{ZopfliNodes{wcost.data(), f, (i32*)f + window, f + 2 * window,
                                   (i32*)f + 3 * window},
                       wlit.data(), (i32*)f + 4 * window, (i32*)f + 9 * window,
                       (i32*)f + 5 * window, tables.data(), tables.data() + ZOPFLI_NUM_CMD,
                       window, 0, 0.0};
  for (int lane = 0; lane < n_lanes; ++lane) {
    ((i64*)tried)[lane] = zopfli_lane_win(
        w,
        zopfli_host_lane(data, lit, cmd, dist, min_cost_cmd, start_cache, n_valid, moff, mlen,
                         mdist, mdelta, active, lane, n_max, stride, max_zlen),
        zopfli_host_nodes(cost, len, ndist, dci, sc, lane, n_max), V,
        (i32*)rec + (i64)lane * (n_max + 1) * 4, (i32*)result + (i64)lane * n_max, n_max);
  }
  return 0;
}

// The direct kernel's lanes (zopfli_step over device-memory nodes).
extern "C" int brotli_torch_zopfli_direct_host(
    const void* data, const void* lit, const void* cmd, const void* dist,
    const void* min_cost_cmd, const void* start_cache, const void* n_valid,
    const void* moff, const void* mlen, const void* mdist, const void* mdelta,
    const void* active, void* cost, void* len, void* ndist, void* dci,
    void* sc, void* result, void* tried, int n_lanes, int n_max, int stride,
    int max_zlen, int sms) {
  (void)sms;
  if (n_lanes <= 0 || n_max <= 0 || stride < n_max) return 1;
  const HostSteps w;
  for (int lane = 0; lane < n_lanes; ++lane) {
    const ZopfliNodes N = zopfli_host_nodes(cost, len, ndist, dci, sc, lane, n_max);
    const ZopfliLane L =
        zopfli_host_lane(data, lit, cmd, dist, min_cost_cmd, start_cache, n_valid, moff, mlen,
                         mdist, mdelta, active, lane, n_max, stride, max_zlen);
    i32* res = (i32*)result + (i64)lane * n_max;
    for (i32 i = 0; i <= n_max; ++i) zopfli_nodes_init(N, i);
    std::fill(res, res + n_max, 0);
    ZopfliQueue q;
    zopfli_queue_init(q);
    i64 n_tried = 0;
    for (i32 pos = 0; pos + 3 < L.n; ++pos) {
      if (!L.active[pos]) continue;
      const ZopfliStep s = zopfli_step(w, L, N, q, pos);
      res[pos] = s.result;
      n_tried += s.tried;
    }
    ((i64*)tried)[lane] = n_tried;
  }
  return 0;
}

// zopfli_min_copy_len alone, for the tests: the minimum copy length at pos
// over the node costs cost[0 .. n].
extern "C" int brotli_torch_zopfli_min_len_host(const void* cost, int n,
                                                int pos, double min_cost) {
  return zopfli_min_copy_len((const double*)cost, n, pos, min_cost);
}

// The match finder lane by lane: a serial stable sort of each pass's
// hashed positions by key (the kernel's radix sort in shared memory gives
// the same order), the same candidates, then the byte runs and the
// extension rounds split as match_kernel splits them with `seg` positions
// a segment: each run ends at the first stop in its segment or the suffix
// minimum of the segments' first stops after it (the kernel: windows of
// 32, a ballot each); each round goes tile by tile of `seg` positions from
// the front, a tile's reads before its writes (the kernel: tiles of
// EXT_ITEMS positions a thread).  seg = 1 is the serial walk.
extern "C" int brotli_torch_matches_host(const void* data, const void* n_valid,
                                         void* mlen, void* mdist, int n_lanes,
                                         int n, int st, int max_dist,
                                         int depth, int hash2, int seg) {
  if (!match_args_ok(n_lanes, n, st, max_dist, depth) || seg <= 0) return 1;
  const MatchKnobs K{st, match_pbits(n / st), max_dist, depth, hash2 != 0};
  const int n2 = n / st;
  const int nseg = (n + seg - 1) / seg;
  std::vector<u32> key(n2);
  std::vector<i32> order(n2), d1(n), d7(n), len(n), grown(seg), after(nseg + 1);
  for (int lane = 0; lane < n_lanes; ++lane) {
    const u8* row = (const u8*)data + (i64)lane * (n + MATCH_TAIL);
    auto win = [&](i32 q) {
      return (u32)row[q] | (u32)row[q + 1] << 8 | (u32)row[q + 2] << 16 |
             (u32)row[q + 3] << 24;
    };
    auto len_at = [&](i32 p, i32 d) {
      return d ? match_len(win(p), win(p + 4), win(p - d), win(p - d + 4)) : 0;
    };
    auto pass = [&](bool h7, int dep, std::vector<i32>& out) {
      for (int e = 0; e < n2; ++e) {
        key[e] = match_key(win(e * st), win(e * st + 4), h7, K.pbits);
        order[e] = e;
      }
      std::stable_sort(order.begin(), order.end(),
                       [&](i32 x, i32 y) { return key[x] < key[y]; });
      std::fill(out.begin(), out.end(), 0);
      for (int k = 0; k < n2; ++k) {
        const i32 p = order[k] * st;
        i32 sl = 0, sd = 0;
        for (int j = 1; j <= dep && k - j >= 0; ++j) {
          if (key[order[k - j]] != key[order[k]]) break;
          const i32 c = order[k - j] * st;
          i32 l, d;
          match_candidate(K, match_len(win(p), win(p + 4), win(c), win(c + 4)),
                          p - c, l, d);
          match_take(sl, sd, l, d);
        }
        out[p] = sd;
      }
    };
    pass(false, depth, d1);
    if (K.hash2) {
      pass(true, 2, d7);
      for (int p = 0; p < n; ++p) {
        i32 sd = d1[p], sl = len_at(p, sd);
        match_take(sl, sd, len_at(p, d7[p]), d7[p]);
        d1[p] = sd;
      }
    }
    std::vector<i32>& dist = d1;
    auto stops = [&](i32 q) { return q >= n || q < 4 || row[q] != row[q - 4]; };
    after[nseg] = n;  // the first stop at or after segment v, v = nseg: n
    for (int v = nseg - 1; v >= 0; --v) {
      i32 f = n;
      for (i32 q = v * seg; q < n && q < (v + 1) * seg; ++q)
        if (stops(q)) {
          f = q;
          break;
        }
      after[v] = std::min(f, after[v + 1]);
    }
    for (int p = 0; p < n; ++p) {
      const int v = p / seg;
      i32 stop = after[v + 1];
      for (i32 q = p; q < n && q < (v + 1) * seg; ++q)
        if (stops(q)) {
          stop = q;
          break;
        }
      len[p] = len_at(p, dist[p]);
      match_run(stop - p, len[p], dist[p]);
    }
    for (i32 s = MATCH_CAP_BYTES; s < match_ext_limit(n); s *= 2)
      for (int t0 = 0; t0 < n; t0 += seg) {
        const int t1 = std::min(n, t0 + seg);
        for (int p = t0; p < t1; ++p) {
          const bool in = p + s < n;
          grown[p - t0] = match_extend(s, len[p], dist[p], in ? len[p + s] : 0,
                                       in ? dist[p + s] : 0);
        }
        for (int p = t0; p < t1; ++p) len[p] = grown[p - t0];
      }
    const i32 nv = ((const i32*)n_valid)[lane];
    i32* ml = (i32*)mlen + (i64)lane * n;
    i32* md = (i32*)mdist + (i64)lane * n;
    for (int p = 0; p < n; ++p) {
      i32 l = len[p], d = dist[p];
      match_final(p, nv, l, d);
      ml[p] = l;
      md[p] = d;
    }
  }
  return 0;
}

// The record builder in the block kernel's order (csrc/records.cu
// records_kernel), with `segments` runs of REC_ITEMS positions a tile
// where the kernel has one a thread: the tiles' maxima of copy ends, then
// tile by tile from the top the runs' maxima, their exclusive running
// maximum from the tiles' below, the runs' aggregates of the suffix
// minima, their exclusive suffix minimum from the tile above, and each
// run's rows.  segments = 1 is the serial walk over runs.
namespace {
struct RecHostIn {
  const u8 *cs_, *lit_, *d_;
  const i32 *ml_, *md_, *ds_;
  bool cs(i32 p) const { return p >= 0 && cs_[p]; }
  bool lit(i32 p) const { return lit_[p]; }
  i32 byte(i32 p) const { return p >= 0 ? d_[p] : 0; }
  i32 mlen(i32 p) const { return ml_[p]; }
  i32 mdist(i32 p) const { return md_[p]; }
  i32 dshort(i32 p) const { return ds_[p]; }
};
struct RecHostKeep {
  std::vector<RecCopy>& copy;
  void put(i32 q, const RecCopy& rc) { copy[q] = rc; }
  RecCopy get(i32 q) const { return copy[q]; }
};
struct RecHostOut {
  i32 *r0, *r1;
  void row(i32 r, i32 a, i32 b) {
    r0[r] = a;
    r1[r] = b;
  }
};
}  // namespace

extern "C" int brotli_torch_records_host(
    const void* data, const void* mlen, const void* mdist, const void* is_cs,
    const void* is_lit, const void* dshort, const void* n_valid,
    const void* tab, void* rec0, void* rec1, void* n_rec, int n_lanes, int n,
    int dstride, int lit_ctx, int segments) {
  if (n_lanes <= 0 || n <= 0 || dstride < n || segments <= 0) return 1;
  const i32* T = (const i32*)tab;
  const i32 tile = segments * REC_ITEMS;
  const int n_tiles = (n + tile - 1) / tile;
  std::vector<i32> below(n_tiles), prev(segments);
  std::vector<u32> starts(segments);
  std::vector<RecNext> agg(segments), next(segments);
  std::vector<RecCopy> copy(n);
  RecHostKeep keep{copy};
  for (int lane = 0; lane < n_lanes; ++lane) {
    const i64 row = (i64)lane * n, orow = (i64)lane * (n + 1);
    const RecHostIn in{(const u8*)is_cs + row, (const u8*)is_lit + row,
                       (const u8*)data + (i64)lane * dstride,
                       (const i32*)mlen + row, (const i32*)mdist + row,
                       (const i32*)dshort + row};
    RecHostOut out{(i32*)rec0 + orow, (i32*)rec1 + orow};
    const i32 nv = ((const i32*)n_valid)[lane];
    i32 carry = -1;  // the tiles' maxima, each tile's from those below
    for (int k = 0; k < n_tiles; ++k) {
      below[k] = carry;
      for (i32 p = k * tile; p < n && p < (k + 1) * tile; ++p)
        if (in.cs(p)) carry = rec_max(carry, p + in.mlen(p));
    }
    const RecTail tail = rec_tail(T, nv, carry);
    RecNext above{REC_BIG, REC_BIG, REC_BIG};
    i32 count = 0;
    for (int k = n_tiles - 1; k >= 0; --k) {
      const i32 base = k * tile;
      i32 m = below[k];
      for (int t = 0; t < segments; ++t) {
        const i32 lo = base + t * REC_ITEMS;
        starts[t] = rec_run_starts(in, lo, n);
        prev[t] = m;
        m = rec_max(m, rec_run_max(in, lo, starts[t], -1));
      }
      for (int t = 0; t < segments; ++t)
        agg[t] = rec_run_copies(T, in, base + t * REC_ITEMS, starts[t],
                                prev[t], keep);
      RecNext s = above;
      for (int t = segments - 1; t >= 0; --t) {
        next[t] = s;
        s = rec_next_min(agg[t], s);
      }
      above = s;
      for (int t = 0; t < segments; ++t)
        count += rec_run_rows(T, in, base + t * REC_ITEMS, n, starts[t],
                              next[t], tail, lit_ctx != 0, nv, keep, out);
    }
    ((i32*)n_rec)[lane] = count;
  }
  return 0;
}
