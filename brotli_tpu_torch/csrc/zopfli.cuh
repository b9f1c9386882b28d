// Per-lane q10 Zopfli DP: the node relaxation of the host
// create_zopfli_backward_references (encode/backward_refs_hq.py), over
// precollected matches.  Replaces the `lax.scan` of
// brotli_tpu/ops/device_zopfli.py (_build_dp), which has no `pallas_call`.
//
// The contract is the host's decisions, bit for bit: float64 costs summed in
// the host's order (no product appears; csrc/zopfli.cu is built with
// -fmad=false so that no later edit can contract one), `<` and `<=` as the
// host compares, INFINITY_COST = 1.7e38, the 8-entry start-position queue
// with its ring and bubble, and the node fields `length` and
// `dcode_insert_length` as uint32 read with logical shifts.  The JAX DP
// keeps the latter in int32, so short code 16 (16 << 27 = 2^31) reads back
// negative there; the minimum copy length has no step cap here.
//
// One step is one position of the host loop.  Its serial part (shortcut,
// distance cache, queue, minimum length) is warp-uniform: every thread of
// a warp computes it from the same loads, and the leader alone writes.  The
// byte compares and the relaxation of a candidate's or a match's lengths go
// through the `Steps` policy: on the card (csrc/zopfli.cu) 32 bytes and 32
// lengths a step, on the host (csrc/host_shim.cpp) plain loops.  The lengths
// of one candidate or match have distinct targets pos + l, so the
// strict-less rule holds in any order among them.
//
// Two forms of the lane share these pieces.  `zopfli_step` (the
// direct kernel) reads and writes every node in device memory and walks
// the distance cache hop by hop.  `zopfli_lane_win` (the default kernel)
// keeps a window of nodes in shared memory, memoises the distance cache,
// finds the minimum copy length 32 costs at a time and stages the lane's
// cost tables; see the notes above it.
//
// Steps::mark(k) ends phase k of a step: a no-op, but for the phase-clock
// build of tools/zopfli_phases.py, which sums clock64() deltas by phase.
#pragma once

#include "common.cuh"

namespace brotli_torch {

constexpr double ZOPFLI_INF = 1.7e38;               // cost_model.INFINITY_COST
constexpr i32 ZOPFLI_MAX_BACKWARD = (1 << 22) - 16;  // MAX_BACKWARD_LIMIT
constexpr int ZOPFLI_NUM_CMD = 704;
constexpr int ZOPFLI_DIST_ROW = 1024;  // cost_dist padded with +inf past 544

// One lane's inputs.  moff holds n + 1 offsets into mlen, mdist and mdelta:
// the matches of position p are [moff[p], moff[p + 1]), in the host's order.
struct ZopfliLane {
  const u8* data;         // n bytes
  const double* lit;      // literal_costs[0 .. n + 1]
  const double* cmd;      // cost_cmd[704]
  const double* dist;     // cost_dist[1024]
  double min_cost_cmd;
  const i32* start_cache;  // 4
  const i32* moff;
  const i32* mlen;
  const i32* mdist;
  const i32* mdelta;
  const u8* active;  // positions the host loop visits
  i32 n;
  i32 max_zlen;
};

// One lane's node arrays, n + 1 entries each.
struct ZopfliNodes {
  double* cost;
  u32* len;   // copy length | (length code delta + 9) << 25
  i32* dist;
  u32* dci;   // short code << 27 | insert length
  i32* sc;    // shortcut
};

struct ZopfliQueue {  // StartPosQueue
  double cd[8];
  double cost[8];
  i32 pos[8];
  i32 cache[8][4];
  i32 idx;
};

BROTLI_HD i32 zopfli_log2(u32 x) {  // floor(log2(x)), x > 0
#if defined(__CUDA_ARCH__)
  return 31 - __clz((int)x);
#else
  return 31 - __builtin_clz(x);
#endif
}

// constants.get_insert_length_code / get_copy_length_code
BROTLI_HD i32 zopfli_ins_code(i32 ins) {
  if (ins < 6) return ins;
  if (ins < 130) {
    const i32 nbits = zopfli_log2((u32)(ins - 2)) - 1;
    return (nbits << 1) + ((ins - 2) >> nbits) + 2;
  }
  if (ins < 2114) return zopfli_log2((u32)(ins - 66)) + 10;
  if (ins < 6210) return 21;
  if (ins < 22594) return 22;
  return 23;
}

BROTLI_HD i32 zopfli_copy_code(i32 len) {
  if (len < 10) return len - 2;
  if (len < 134) {
    const i32 nbits = zopfli_log2((u32)(len - 6)) - 1;
    return (nbits << 1) + ((len - 6) >> nbits) + 4;
  }
  if (len < 2118) return zopfli_log2((u32)(len - 70)) + 12;
  return 23;
}

// zopfli_copy_code and zopfli_copy_extra as selects: the same values, with
// no branch for the lengths of a warp's relaxation to diverge on (the window
// form's; zopfli_step keeps the branches, the direct kernel as it was)
BROTLI_HD i32 zopfli_copy_code_sel(i32 len) {
  const i32 a = len - 6 > 4 ? len - 6 : 4, b = len - 70 > 1 ? len - 70 : 1;
  const i32 nbits = zopfli_log2((u32)a) - 1;
  const i32 mid = (nbits << 1) + (a >> nbits) + 4, high = zopfli_log2((u32)b) + 12;
  return len < 10 ? len - 2 : len < 134 ? mid : len < 2118 ? high : 23;
}

BROTLI_HD double zopfli_copy_extra_sel(i32 code) {
  return (double)(code < 8 ? 0 : code < 18 ? (code - 6) >> 1 : code < 23 ? code - 12 : 24);
}

// INSERT_LENGTH_N_BITS and COPY_LENGTH_N_BITS as closed forms
BROTLI_HD double zopfli_ins_extra(i32 code) {
  if (code < 6) return 0.0;
  if (code < 16) return (double)((code - 4) >> 1);
  if (code < 21) return (double)(code - 10);
  return code == 21 ? 12.0 : (code == 22 ? 14.0 : 24.0);
}

BROTLI_HD double zopfli_copy_extra(i32 code) {
  if (code < 8) return 0.0;
  if (code < 18) return (double)((code - 6) >> 1);
  if (code < 23) return (double)(code - 12);
  return 24.0;
}

// constants.combine_length_codes
BROTLI_HD i32 zopfli_combine(i32 ins, i32 copy, bool use_last) {
  const i32 bits64 = ((ins & 7) << 3) | (copy & 7);
  if (use_last && ins < 8 && copy < 16) return copy < 8 ? bits64 : (bits64 | 64);
  // cell of (ins >> 3, copy >> 3), a nibble each, row-major over 3 x 3
  const i32 cell = (i32)((0xA97854632ull >> (4 * ((ins >> 3) * 3 + (copy >> 3)))) & 0xF);
  return (cell << 6) | bits64;
}

// command.prefix_encode_copy_distance(dist + 15, 0, 0): symbol and nbits
BROTLI_HD void zopfli_dist_symbol(i32 dist, i32& sym, i32& nbits) {
  const i32 dcode = dist + 15;
  if (dcode < 16) {
    sym = dcode;
    nbits = 0;
    return;
  }
  const i32 d = dcode - 12;  // 4 + (dcode - 16)
  const i32 bucket = zopfli_log2((u32)d) - 1;
  nbits = bucket;
  sym = 16 + 2 * (nbits - 1) + ((d >> bucket) & 1);
}

// zopfli_dist_symbol as selects
BROTLI_HD void zopfli_dist_symbol_sel(i32 dist, i32& sym, i32& nbits) {
  const i32 dcode = dist + 15, d = dcode - 12 > 4 ? dcode - 12 : 4;
  const i32 bucket = zopfli_log2((u32)d) - 1;
  nbits = dcode < 16 ? 0 : bucket;
  sym = dcode < 16 ? dcode : 16 + 2 * (bucket - 1) + ((d >> bucket) & 1);
}

// _DIST_CACHE_INDEX / _DIST_CACHE_OFFSET
BROTLI_HD i32 zopfli_cache_index(int j) { return j < 4 ? j : (j < 10 ? 0 : 1); }
BROTLI_HD i32 zopfli_cache_offset(int j) {
  if (j < 4) return 0;
  const int k = j - (j < 10 ? 4 : 10);
  return (k & 1) ? (k >> 1) + 1 : -((k >> 1) + 1);
}
BROTLI_HD i32 zopfli_cache_offset_sel(int j) {
  const int k = j - (j < 10 ? 4 : 10), off = (k & 1) ? (k >> 1) + 1 : -((k >> 1) + 1);
  return j < 4 ? 0 : off;
}

BROTLI_HD void zopfli_nodes_init(const ZopfliNodes& N, i32 i) {
  N.cost[i] = i == 0 ? 0.0 : ZOPFLI_INF;
  N.len[i] = i == 0 ? 0u : 1u;
  N.dist[i] = 0;
  N.dci[i] = 0u;
  N.sc[i] = 0;
}

BROTLI_HD void zopfli_queue_init(ZopfliQueue& q) {
  for (int k = 0; k < 8; ++k) {
    q.cd[k] = q.cost[k] = ZOPFLI_INF;
    q.pos[k] = 0;
    for (int s = 0; s < 4; ++s) q.cache[k][s] = 0;
  }
  q.idx = 0;
}

// StartPosQueue.at(k)'s slot
BROTLI_HD int zopfli_queue_slot(const ZopfliQueue& q, int k) { return (k - q.idx) & 7; }

// StartPosQueue.push: the ring slot, then one bubble pass by costdiff
BROTLI_HD void zopfli_queue_push(ZopfliQueue& q, i32 pos, double cost, double cd,
                                 const i32 cache[4]) {
  const int offset = (~q.idx) & 7;
  ++q.idx;
  q.pos[offset] = pos;
  q.cost[offset] = cost;
  q.cd[offset] = cd;
  for (int s = 0; s < 4; ++s) q.cache[offset][s] = cache[s];
  const int size = q.idx < 8 ? q.idx : 8;
  for (int i = 1; i < size; ++i) {
    const int a = (offset + i - 1) & 7, b = (offset + i) & 7;
    if (q.cd[a] > q.cd[b]) {
      const double cd_a = q.cd[a], cost_a = q.cost[a];
      const i32 pos_a = q.pos[a];
      q.cd[a] = q.cd[b];
      q.cost[a] = q.cost[b];
      q.pos[a] = q.pos[b];
      q.cd[b] = cd_a;
      q.cost[b] = cost_a;
      q.pos[b] = pos_a;
      for (int s = 0; s < 4; ++s) {
        const i32 c = q.cache[a][s];
        q.cache[a][s] = q.cache[b][s];
        q.cache[b][s] = c;
      }
    }
  }
}

BROTLI_HD i32 zopfli_clen(const ZopfliNodes& N, i32 p) { return (i32)(N.len[p] & 0x1FFFFFFu); }
BROTLI_HD i32 zopfli_ilen(const ZopfliNodes& N, i32 p) { return (i32)(N.dci[p] & 0x7FFFFFFu); }

// _compute_distance_shortcut (block_start 0)
BROTLI_HD i32 zopfli_shortcut(const ZopfliNodes& N, i32 pos) {
  if (pos == 0) return 0;
  const i32 clen = zopfli_clen(N, pos), ilen = zopfli_ilen(N, pos);
  const i32 dist = N.dist[pos];
  const u32 short_code = N.dci[pos] >> 27;
  const i64 dcode = short_code == 0 ? (i64)dist + 15 : (i64)short_code - 1;
  if ((i64)dist + clen <= pos && dist <= ZOPFLI_MAX_BACKWARD && dcode > 0) return pos;
  return N.sc[pos - clen - ilen];
}

// _compute_distance_cache from the shortcut sc of the position: at most four
// hops, then the starting cache in order (fixed hops, so that the found
// distances stay in registers on the card).
BROTLI_HD void zopfli_cache(const ZopfliNodes& N, i32 sc, const i32* start, i32 out[4]) {
  i32 found[4] = {0, 0, 0, 0};
  int filled = 0;
  i32 p = sc;
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int h = 0; h < 4; ++h) {
    if (p > 0) {
      found[h] = N.dist[p];
      ++filled;
      p = N.sc[p - zopfli_clen(N, p) - zopfli_ilen(N, p)];
    }
  }
#if defined(__CUDA_ARCH__)
#pragma unroll
#endif
  for (int k = 0; k < 4; ++k) out[k] = k < filled ? found[k] : start[k - filled];
}

// _compute_minimum_copy_length, without a step cap
BROTLI_HD i32 zopfli_min_copy_len(const double* cost, i32 n, i32 pos, double min_cost) {
  i32 ln = 2, bucket = 4, next = 10;
  while (pos + ln <= n && cost[pos + ln] <= min_cost) {
    ++ln;
    if (ln == next) {
      min_cost += 1.0;
      next += bucket;
      bucket *= 2;
    }
  }
  return ln;
}

// _update_zopfli_node
BROTLI_HD void zopfli_update(const ZopfliNodes& N, i32 pos, i32 start, i32 l, i32 len_code,
                             i32 dist, i32 short_code, double cost) {
  const i32 t = pos + l;
  N.len[t] = (u32)l | ((u32)(l + 9 - len_code) << 25);
  N.dist[t] = dist;
  N.dci[t] = ((u32)short_code << 27) | (u32)(pos - start);
  N.cost[t] = cost;
}

struct ZopfliStep {
  i32 result;  // largest length this thread relaxed (the quick step's skip)
  i64 tried;   // lengths tried, the same on every thread
};

// One position of the host loop: _update_nodes at quality 10 (one queue
// entry, k = 0).  The caller skips positions the host does not visit.
// Steps gives leader(), sync(), mark(k), match_length(a, b, limit) and
// lengths(lo, hi, f), which calls f(l) for l in [lo, hi] and syncs.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Steps>
BROTLI_HD ZopfliStep zopfli_step(const Steps& w, const ZopfliLane& L, const ZopfliNodes& N,
                                 ZopfliQueue& q, i32 pos) {
  ZopfliStep out{0, 0};
  // _evaluate_node
  const double node_cost = N.cost[pos];
  const i32 sc = zopfli_shortcut(N, pos);
  const double lc0 = L.lit[pos] - L.lit[0];
  const bool push = node_cost <= lc0;
  w.mark(0);
  i32 cache[4];
  if (push) zopfli_cache(N, sc, L.start_cache, cache);
  w.mark(1);
  if (w.leader()) {
    N.sc[pos] = sc;
    if (push) zopfli_queue_push(q, pos, node_cost, node_cost - lc0, cache);
  }
  w.sync();
  w.mark(2);

  const int s0 = zopfli_queue_slot(q, 0);
  const i32 start = q.pos[s0];
  const double min_cost = (q.cost[s0] + L.min_cost_cmd) + (L.lit[pos] - L.lit[start]);
  const i32 min_len = zopfli_min_copy_len(N.cost, L.n, pos, min_cost);
  w.mark(3);
  if (q.idx == 0) return out;  // an empty queue: no candidate

  const i32 max_distance = pos < ZOPFLI_MAX_BACKWARD ? pos : ZOPFLI_MAX_BACKWARD;
  const i32 max_len = L.n - pos;
  const i32 ins_code = zopfli_ins_code(pos - start);
  const double base_cost = (q.cd[s0] + zopfli_ins_extra(ins_code)) + (L.lit[pos] - L.lit[0]);
  const i32 c0 = q.cache[s0][0], c1 = q.cache[s0][1], c2 = q.cache[s0][2],
            c3 = q.cache[s0][3];
  const u8* cur = L.data + pos;

  // distance-cache candidates
  i32 best_len = min_len - 1;
  for (int j = 0; j < 16; ++j) {
    if (best_len >= max_len) break;
    const i32 ci = zopfli_cache_index(j);
    const i32 backward =
        (ci == 0 ? c0 : ci == 1 ? c1 : ci == 2 ? c2 : c3) + zopfli_cache_offset(j);
    if (backward <= 0 || backward > max_distance) continue;
    const u8* prev = cur - backward;
    if (ldg(prev + best_len) != ldg(cur + best_len)) continue;
    const i32 ln = w.match_length(prev, cur, max_len);
    if (ln < 4 || ln <= best_len) continue;
    const double dist_cost = base_cost + ldg(L.dist + j);
    w.lengths(best_len + 1, ln, [&](i32 l) {
      const i32 copy_code = zopfli_copy_code(l);
      const i32 cmd = zopfli_combine(ins_code, copy_code, j == 0);
      const double cost =
          ((cmd < 128 ? base_cost : dist_cost) + zopfli_copy_extra(copy_code)) + ldg(L.cmd + cmd);
      if (cost < N.cost[pos + l]) {
        zopfli_update(N, pos, start, l, l, backward, j + 1, cost);
        if (l > out.result) out.result = l;
      }
    });
    out.tried += ln - best_len;
    best_len = ln;
  }
  w.mark(4);

  // hasher matches, match_len carried from one to the next
  i32 match_len = min_len;
  const i32 m_end = ldg(L.moff + pos + 1);
  for (i32 k = ldg(L.moff + pos); k < m_end; ++k) {
    const i32 dist = ldg(L.mdist + k), mlen = ldg(L.mlen + k);
    const bool is_dict = dist > max_distance;
    i32 sym, nbits;
    zopfli_dist_symbol(dist, sym, nbits);
    const double dist_cost = (base_cost + (double)nbits) + ldg(L.dist + (sym & 0x3FF));
    if (match_len < mlen && (is_dict || mlen > L.max_zlen)) match_len = mlen;
    if (match_len > mlen) continue;
    const i32 dict_code = mlen + ldg(L.mdelta + k);
    w.lengths(match_len, mlen, [&](i32 l) {
      const i32 len_code = is_dict ? dict_code : l;
      const i32 copy_code = zopfli_copy_code(len_code);
      const i32 cmd = zopfli_combine(ins_code, copy_code, false);
      const double cost = (dist_cost + zopfli_copy_extra(copy_code)) + ldg(L.cmd + cmd);
      if (cost < N.cost[pos + l]) {
        zopfli_update(N, pos, start, l, len_code, dist, 0, cost);
        if (l > out.result) out.result = l;
      }
    });
    out.tried += mlen - match_len + 1;
    match_len = mlen + 1;
  }
  w.mark(6);
  return out;
}

// ---------------------------------------------------------------------------
// The window form: the same decisions as zopfli_step, in another order of
// memory traffic.
//
// * A node window.  Nodes [base, base + size) (size a power of two, node p
//   in slot p & (size - 1)) live in shared memory, so the node read at pos,
//   the minimum-length scan and most relaxations stay there.  The window
//   slides by half its size once pos reaches its second half: the nodes
//   that leave are written back to device memory, the nodes that enter are
//   read from there (a relaxation past the window may have written them).
//   A target past the window is relaxed in device memory; a read behind
//   base (the shortcut's node) reads device memory, where the node was
//   written back when it left.  At the end the window is written back, so
//   the node arrays in device memory equal zopfli_step's.
// * A memoised distance cache.  The walk of zopfli_cache from a shortcut
//   target p > 0 reads dist[p], then walks on from next(p) = sc[p -
//   clen(p) - ilen(p)]: walk(p) = [dist[p], walk(next(p))[0..2]], and
//   walk(0) = the start cache.  Every nonzero shortcut is a position that
//   was visited with its own distance (sc[p] = p there, or a copy of an
//   earlier shortcut; unvisited positions keep 0), and the nodes and
//   shortcuts walk(p) reads are final from step p on: a step at pos writes
//   only nodes past pos.  So step p records rec[p] = walk(p) where sc[p] =
//   p, reading one earlier record, and a push reads one record where the
//   walk took up to four hops of two dependent loads.  The records ride in
//   the window beside the nodes (16 B a slot) and go to device memory when
//   their slot leaves it; a record is read only where it was written.
// * The queue in registers (ZopfliQueueRegs): every thread of the warp
//   keeps the same copy, in the ring's logical order, so no index is
//   dynamic; an entry keeps its position's literal cost, and the window
//   the literal costs of its positions.
// * The minimum copy length 32 lengths a step: length ln passes where pos +
//   ln <= n and cost[pos + ln] <= its threshold, the first failure ends the
//   scan.  A threshold is the serial loop's own sequence of `+ 1.0` adds
//   (the first three made once for the warp), so the float64 value is the
//   same.
// * Relaxations without a sync between them: the lengths of one candidate
//   or match are distinct targets, each candidate's run past the last, and
//   the matches' ranges disjoint (each starts past the longest match before
//   it); one sync orders the candidates' writes before the matches'.
// * The 16 cache candidates: one round tests each candidate's byte at the
//   starting best length and its first 4 bytes (a candidate that fails
//   either matches at most that best length or fewer than 4 bytes, so
//   zopfli_step skips it too; the 4 bytes are loaded before the minimum
//   length, so that their latency overlaps it), then the survivors run in
//   order as in zopfli_step.
// * next(p) noted by the relaxation.  A step at s relaxes node p = s + l
//   with copy length l and insert length s - start, start the queue head's
//   position, so next(p) = sc[start] and walk(next(p)) are the head's own
//   shortcut and cache, which the queue entry keeps.  A relaxation in the
//   window notes both in p's slot; step p reads them there instead of the
//   chain node -> sc[back] -> rec.  A slot whose node entered the window
//   from device memory, or was never relaxed, holds -1 and takes the
//   chain.
// * The lane's cost tables (cmd 704, dist 1024 float64) staged in shared
//   memory.
// * Latency off the chain: the position's match offsets are loaded at the
//   start of the step, its first match after the minimum length, each
//   match's successor while it relaxes; the positions to visit read 32
//   flags a ballot.
//
// Steps adds to zopfli_step's: spread(lo, hi, f), lengths without the
// sync; each(lo, hi, f), f(i) for i in [lo, hi) and a sync;
// each_thread(f), f(t) for each thread t, no sync; ballot(f), the mask of
// t < 32 with f(t); first_false(lo, f), the least i >= lo with !f(i), f
// called on i, i + 1, ... until then (and on up to 31 lengths past it on
// the card); reduce_max(x).

#if defined(__CUDA_ARCH__)
#define ZOPFLI_UNROLL _Pragma("unroll")
#else
#define ZOPFLI_UNROLL
#endif

// A value of each of the warp's 32 threads: the calling thread's on the
// card, all 32 on the host (where Steps::each_thread loops over them).
#if defined(__CUDA_ARCH__)
template <class T>
struct ZopfliLanes {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
};
#else
template <class T>
struct ZopfliLanes {
  T v[32];
  T& operator[](int t) { return v[t]; }
};
#endif

// StartPosQueue with entry k = at(k).  A push moves every entry up one (the
// last falls off, where the ring overwrites it), puts the new one at 0 and
// runs the ring's bubble pass over the first min(pushes, 8) entries.
struct ZopfliQueueRegs {
  double cd[8];
  double cost[8];
  double lit[8];  // literal_costs[pos]
  i32 pos[8];
  i32 sc[8];      // the shortcut of pos, whose walk `cache` is
  i32 cache[8][4];
  i32 count;
};

BROTLI_HD void zopfli_queue_regs_init(ZopfliQueueRegs& q) {
  ZOPFLI_UNROLL
  for (int k = 0; k < 8; ++k) {
    q.cd[k] = q.cost[k] = ZOPFLI_INF;
    q.lit[k] = 0.0;
    q.pos[k] = 0;
    q.sc[k] = 0;
    ZOPFLI_UNROLL
    for (int s = 0; s < 4; ++s) q.cache[k][s] = 0;
  }
  q.count = 0;
}

BROTLI_HD void zopfli_queue_regs_push(ZopfliQueueRegs& q, i32 pos, double cost, double cd,
                                      double lit, i32 sc, const i32 cache[4]) {
  ZOPFLI_UNROLL
  for (int k = 7; k > 0; --k) {
    q.cd[k] = q.cd[k - 1];
    q.cost[k] = q.cost[k - 1];
    q.lit[k] = q.lit[k - 1];
    q.pos[k] = q.pos[k - 1];
    q.sc[k] = q.sc[k - 1];
    ZOPFLI_UNROLL
    for (int s = 0; s < 4; ++s) q.cache[k][s] = q.cache[k - 1][s];
  }
  q.cd[0] = cd;
  q.cost[0] = cost;
  q.lit[0] = lit;
  q.pos[0] = pos;
  q.sc[0] = sc;
  ZOPFLI_UNROLL
  for (int s = 0; s < 4; ++s) q.cache[0][s] = cache[s];
  ++q.count;
  ZOPFLI_UNROLL
  for (int i = 1; i < 8; ++i) {
    if (i < q.count && q.cd[i - 1] > q.cd[i]) {
      const double cd_a = q.cd[i - 1], cost_a = q.cost[i - 1], lit_a = q.lit[i - 1];
      const i32 pos_a = q.pos[i - 1], sc_a = q.sc[i - 1];
      q.sc[i - 1] = q.sc[i];
      q.sc[i] = sc_a;
      q.cd[i - 1] = q.cd[i];
      q.cost[i - 1] = q.cost[i];
      q.lit[i - 1] = q.lit[i];
      q.pos[i - 1] = q.pos[i];
      q.cd[i] = cd_a;
      q.cost[i] = cost_a;
      q.lit[i] = lit_a;
      q.pos[i] = pos_a;
      ZOPFLI_UNROLL
      for (int s = 0; s < 4; ++s) {
        const i32 c = q.cache[i - 1][s];
        q.cache[i - 1][s] = q.cache[i][s];
        q.cache[i][s] = c;
      }
    }
  }
}

// One lane's window: the five node fields, the literal costs and the
// records of `size` slots, and the staged tables.
struct ZopfliWindow {
  ZopfliNodes slots;
  double* lit;   // literal_costs[p]
  i32* nx;       // next(p) as the node's last relaxation in the window saw it, or -1
  i32* walk;     // walk(nx), 4 a slot
  i32* rec;      // 4 a slot
  double* cmd;   // cost_cmd[704]
  double* dist;  // cost_dist[1024]
  i32 size;      // a power of two
  i32 base;
  double lit0;   // literal_costs[0]
};

BROTLI_HD bool zopfli_in(const ZopfliWindow& V, i32 p) { return (u32)(p - V.base) < (u32)V.size; }

// Node p's cost, shortcut and relaxation, in its window slot or in device
// memory.  Each takes one branch, not a pointer into either, so that the
// card addresses the window as shared memory.
BROTLI_HD double zopfli_cost_at(const ZopfliWindow& V, const ZopfliNodes& N, i32 p) {
  return zopfli_in(V, p) ? V.slots.cost[p & (V.size - 1)] : N.cost[p];
}

BROTLI_HD i32 zopfli_sc_at(const ZopfliWindow& V, const ZopfliNodes& N, i32 p) {
  return zopfli_in(V, p) ? V.slots.sc[p & (V.size - 1)] : N.sc[p];
}

// The 4 words of a record (16-byte aligned) in one load on the card.
BROTLI_HD void zopfli_rec_load(const i32* p, i32 r[4]) {
#if defined(__CUDA_ARCH__)
  const int4 v = *(const int4*)p;
  r[0] = v.x, r[1] = v.y, r[2] = v.z, r[3] = v.w;
#else
  for (int k = 0; k < 4; ++k) r[k] = p[k];
#endif
}

BROTLI_HD void zopfli_rec_store(i32* p, const i32 r[4]) {
#if defined(__CUDA_ARCH__)
  *(int4*)p = make_int4(r[0], r[1], r[2], r[3]);
#else
  for (int k = 0; k < 4; ++k) p[k] = r[k];
#endif
}

// _update_zopfli_node where `cost` is strictly less than node p's; returns
// whether it was.  In the window it also notes next(p) and its walk, which
// the relaxing step knows (see zopfli_step_win).
BROTLI_HD bool zopfli_relax(const ZopfliWindow& V, const ZopfliNodes& N, i32 p, double cost,
                            u32 len, i32 dist, u32 dci, i32 nx, const i32 walk[4]) {
  if (zopfli_in(V, p)) {
    const i32 s = p & (V.size - 1);
    if (!(cost < V.slots.cost[s])) return false;
    V.slots.len[s] = len;
    V.slots.dist[s] = dist;
    V.slots.dci[s] = dci;
    V.slots.cost[s] = cost;
    V.nx[s] = nx;
    zopfli_rec_store(V.walk + 4 * s, walk);
  } else {
    if (!(cost < N.cost[p])) return false;
    N.len[p] = len;
    N.dist[p] = dist;
    N.dci[p] = dci;
    N.cost[p] = cost;
  }
  return true;
}


BROTLI_HD void zopfli_node_copy(const ZopfliNodes& to, i32 i, const ZopfliNodes& from, i32 j) {
  to.cost[i] = from.cost[j];
  to.len[i] = from.len[j];
  to.dist[i] = from.dist[j];
  to.dci[i] = from.dci[j];
  to.sc[i] = from.sc[j];
}

// Slide the window to start at new_base (> base, a multiple of half its
// size away): each slot whose position leaves writes its node and record
// back and takes the node of the position that enters it (no record: no
// step has reached that position yet).  Nodes past n_max exist in neither
// array; their slots hold the initial node.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Steps>
BROTLI_HD void zopfli_slide(const Steps& w, const ZopfliLane& L, const ZopfliNodes& N, i32* rec,
                            ZopfliWindow& V, i32 new_base, i32 n_max) {
  const i32 mask = V.size - 1, base = V.base;
  const i32 gone = new_base - base < V.size ? new_base - base : V.size;
  w.each(0, gone, [&](i32 i) {
    const i32 out = base + i, slot = out & mask;
    const i32 in = new_base + ((out - new_base) & mask);
    if (out <= n_max) {
      zopfli_node_copy(N, out, V.slots, slot);
      i32 r[4];
      zopfli_rec_load(V.rec + 4 * slot, r);
      zopfli_rec_store(rec + 4 * (i64)out, r);
    }
    if (in <= n_max) {
      zopfli_node_copy(V.slots, slot, N, in);
      V.lit[slot] = L.lit[in];
    } else {
      zopfli_nodes_init(V.slots, slot);
      V.slots.cost[slot] = ZOPFLI_INF;
    }
    V.nx[slot] = -1;
  });
  V.base = new_base;
}

// zopfli_step through the window; pos lies in [V.base, V.base + size / 2).
// rec: 4 int32 a position in device memory, the records behind the window.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Steps>
BROTLI_HD ZopfliStep zopfli_step_win(const Steps& w, const ZopfliLane& L, const ZopfliNodes& N,
                                     const ZopfliWindow& V, i32* rec, ZopfliQueueRegs& q,
                                     i32 pos) {
  ZopfliStep out{0, 0};
  // the matches' offsets, off the chain
  const i32 m_begin = ldg(L.moff + pos), m_end = ldg(L.moff + pos + 1);
  // _evaluate_node: the shortcut, then the push with its cache
  const i32 at = pos & (V.size - 1);
  const double node_cost = V.slots.cost[at];
  const i32 clen = (i32)(V.slots.len[at] & 0x1FFFFFFu);
  const i32 ilen = (i32)(V.slots.dci[at] & 0x7FFFFFFu);
  const i32 dist_here = V.slots.dist[at];
  const u32 short_code = V.slots.dci[at] >> 27;
  const i64 dcode = short_code == 0 ? (i64)dist_here + 15 : (i64)short_code - 1;
  const bool own = pos > 0 && (i64)dist_here + clen <= pos &&
                   dist_here <= ZOPFLI_MAX_BACKWARD && dcode > 0;
  // next(pos) and walk(next): noted by the node's last relaxation in the
  // window, or read behind pos
  const i32 noted = V.nx[at];
  i32 r[4];
  zopfli_rec_load(V.walk + 4 * at, r);
  const i32 next = noted >= 0 ? noted : pos == 0 ? 0 : zopfli_sc_at(V, N, pos - clen - ilen);
  const i32 sc = own ? pos : next;
  const double lit_pos = V.lit[at];
  const double lc0 = lit_pos - V.lit0;
  const bool push = node_cost <= lc0;
  w.mark(0);
  i32 cache[4];
  if (own || push) {
    if (noted < 0) {
      if (next > 0 && zopfli_in(V, next)) {
        zopfli_rec_load(V.rec + 4 * (next & (V.size - 1)), r);
      } else if (next > 0) {
        zopfli_rec_load(rec + 4 * (i64)next, r);
      } else {
        for (int k = 0; k < 4; ++k) r[k] = L.start_cache[k];
      }
    }
    cache[0] = own ? dist_here : r[0];
    cache[1] = own ? r[0] : r[1];
    cache[2] = own ? r[1] : r[2];
    cache[3] = own ? r[2] : r[3];
  }
  // every thread stores the same values: no branch to the leader
  V.slots.sc[at] = sc;
  if (own) zopfli_rec_store(V.rec + 4 * at, cache);
  w.mark(1);
  if (push) zopfli_queue_regs_push(q, pos, node_cost, node_cost - lc0, lit_pos, sc, cache);
  w.mark(2);

  if (q.count == 0) return out;  // an empty queue: no candidate
  const i32 max_distance = pos < ZOPFLI_MAX_BACKWARD ? pos : ZOPFLI_MAX_BACKWARD;
  const i32 c0 = q.cache[0][0], c1 = q.cache[0][1], c2 = q.cache[0][2], c3 = q.cache[0][3];
  const u8* cur = L.data + pos;
  auto backward_of = [&](int j) {
    const i32 ci = zopfli_cache_index(j);
    return (ci == 0 ? c0 : ci == 1 ? c1 : ci == 2 ? c2 : c3) + zopfli_cache_offset_sel(j);
  };
  // each candidate's first 4 bytes, 2 a thread (thread 2j + h: bytes 2h
  // and 2h + 1 of candidate j), loaded now and compared after the minimum
  // length; max_len >= 4 here
  ZopfliLanes<bool> valid;
  ZopfliLanes<const u8*> prevs;
  ZopfliLanes<u32> got, want;
  w.each_thread([&](int t) {
    const i32 backward = backward_of(t >> 1);
    valid[t] = backward > 0 && backward <= max_distance;
    const u8* prev = valid[t] ? cur - backward : cur;
    const int h = 2 * (t & 1);
    prevs[t] = prev;
    got[t] = (u32)ldg(prev + h) | (u32)ldg(prev + h + 1) << 8;
    want[t] = (u32)ldg(cur + h) | (u32)ldg(cur + h + 1) << 8;
  });
  w.mark(11);
  const i32 start = q.pos[0];
  const double min_cost = (q.cost[0] + L.min_cost_cmd) + (lit_pos - q.lit[0]);
  // the serial loop's bound at lengths 2-9, 10-13, 14-21 and 22-37
  const double bound1 = min_cost + 1.0, bound2 = bound1 + 1.0, bound3 = bound2 + 1.0;
  const i32 min_len = w.first_false(2, [&](i32 ln) {
    if (pos + ln > L.n) return false;
    double bound = ln < 10 ? min_cost : ln < 14 ? bound1 : ln < 22 ? bound2 : bound3;
    for (i32 next_ln = 38, bucket = 32; next_ln <= ln; next_ln += bucket, bucket *= 2)
      bound += 1.0;
    return zopfli_cost_at(V, N, pos + ln) <= bound;
  });
  w.mark(3);
  i32 next_dist = 0, next_len = 0, next_delta = 0;  // the first match
  if (m_begin < m_end) {
    next_dist = ldg(L.mdist + m_begin);
    next_len = ldg(L.mlen + m_begin);
    next_delta = ldg(L.mdelta + m_begin);
  }

  const i32 max_len = L.n - pos;
  const i32 ins_code = zopfli_ins_code(pos - start);
  const double base_cost = (q.cd[0] + zopfli_ins_extra(ins_code)) + lc0;

  // distance-cache candidates: those that can pass best_len and reach 4
  // bytes (thread 2j also tests candidate j's byte at best_len), then in
  // order
  i32 best_len = min_len - 1;
  u32 maybe = 0;
  if (best_len < max_len) {
    const i32 first = best_len;
    const u32 pass = w.ballot([&](int t) {
      return valid[t] && got[t] == want[t] &&
             ((t & 1) != 0 || ldg(prevs[t] + first) == ldg(cur + first));
    });
    maybe = pass & (pass >> 1) & 0x55555555u;  // bit 2j: candidate j
  }
  w.mark(4);
  while (maybe != 0 && best_len < max_len) {
    const int j = zopfli_log2(maybe & (0u - maybe)) >> 1;
    maybe &= maybe - 1;
    const i32 backward = backward_of(j);
    const u8* prev = cur - backward;
    if (ldg(prev + best_len) != ldg(cur + best_len)) continue;
    const i32 ln = w.match_length(prev, cur, max_len);
    if (ln < 4 || ln <= best_len) continue;
    const double dist_cost = base_cost + V.dist[j];
    w.mark(5);
    w.spread(best_len + 1, ln, [&](i32 l) {
      const i32 copy_code = zopfli_copy_code_sel(l);
      const i32 cmd = zopfli_combine(ins_code, copy_code, j == 0);
      const double cost =
          ((cmd < 128 ? base_cost : dist_cost) + zopfli_copy_extra_sel(copy_code)) + V.cmd[cmd];
      if (zopfli_relax(V, N, pos + l, cost, (u32)l | (9u << 25), backward,
                       ((u32)(j + 1) << 27) | (u32)(pos - start), q.sc[0], q.cache[0]) &&
          l > out.result)
        out.result = l;
    });
    w.mark(9);
    out.tried += ln - best_len;
    best_len = ln;
  }
  w.mark(5);

  // hasher matches, match_len carried from one to the next; their ranges
  // are disjoint, but may hold a candidate's targets
  w.sync();
  i32 match_len = min_len;
  for (i32 k = m_begin; k < m_end; ++k) {
    const i32 dist = next_dist, mlen = next_len, delta = next_delta;
    const i32 k_next = k + 1 < m_end ? k + 1 : k;  // loaded again at the last
    next_dist = ldg(L.mdist + k_next);
    next_len = ldg(L.mlen + k_next);
    next_delta = ldg(L.mdelta + k_next);
    const bool is_dict = dist > max_distance;
    if (match_len < mlen && (is_dict || mlen > L.max_zlen)) match_len = mlen;
    if (match_len > mlen) continue;
    i32 sym, nbits;
    zopfli_dist_symbol_sel(dist, sym, nbits);
    const double dist_cost = (base_cost + (double)nbits) + V.dist[sym & 0x3FF];
    const i32 dict_code = mlen + delta;
    w.mark(6);
    w.spread(match_len, mlen, [&](i32 l) {
      const i32 len_code = is_dict ? dict_code : l;
      const i32 copy_code = zopfli_copy_code_sel(len_code);
      const i32 cmd = zopfli_combine(ins_code, copy_code, false);
      const double cost = (dist_cost + zopfli_copy_extra_sel(copy_code)) + V.cmd[cmd];
      if (zopfli_relax(V, N, pos + l, cost, (u32)l | ((u32)(l + 9 - len_code) << 25), dist,
                       (u32)(pos - start), q.sc[0], q.cache[0]) &&
          l > out.result)
        out.result = l;
    });
    w.mark(10);
    out.tried += mlen - match_len + 1;
    match_len = mlen + 1;
  }
  w.mark(6);
  return out;
}

// One lane of the window form: stages the tables, sets up the nodes (the
// window's in shared memory, the rest in device memory), walks the
// positions the host visits, writes the window's nodes back.  result:
// n_max entries; rec: n_max + 1 records of scratch.  Returns the lengths
// tried.
#if defined(__CUDACC__)
#pragma nv_exec_check_disable
#endif
template <class Steps>
BROTLI_HD i64 zopfli_lane_win(const Steps& w, const ZopfliLane& L, const ZopfliNodes& N,
                              ZopfliWindow V, i32* rec, i32* result, i32 n_max) {
  w.each(0, ZOPFLI_NUM_CMD, [&](i32 i) { V.cmd[i] = ldg(L.cmd + i); });
  w.each(0, ZOPFLI_DIST_ROW, [&](i32 i) { V.dist[i] = ldg(L.dist + i); });
  V.base = 0;
  V.lit0 = L.lit[0];
  w.each(0, V.size, [&](i32 i) {
    zopfli_nodes_init(V.slots, i);
    V.lit[i] = i <= n_max ? L.lit[i] : 0.0;
    V.nx[i] = -1;
  });
  w.each(V.size, n_max + 1, [&](i32 i) { zopfli_nodes_init(N, i); });
  w.each(0, n_max, [&](i32 i) { result[i] = 0; });
  ZopfliQueueRegs q;
  zopfli_queue_regs_init(q);
  const i32 half = V.size >> 1;
  i64 tried = 0;
  const i32 end = L.n - 3;  // the host loop runs while pos + 3 < n
  for (i32 base = 0; base < end; base += 32) {
    u32 visit = w.ballot([&](int t) { return base + t < end && ldg(L.active + base + t); });
    while (visit != 0) {
      const i32 pos = base + zopfli_log2(visit & (0u - visit));
      visit &= visit - 1;
      w.mark(7);
      if (pos - V.base >= half)
        zopfli_slide(w, L, N, rec, V, pos - (pos - V.base) % half, n_max);
      w.mark(8);
      const ZopfliStep s = zopfli_step_win(w, L, N, V, rec, q, pos);
      result[pos] = w.reduce_max(s.result);  // the same value from each thread
      tried += s.tried;
      w.sync();
    }
  }
  const i32 mask = V.size - 1, base = V.base;
  w.each(0, V.size, [&](i32 slot) {
    const i32 p = base + ((slot - base) & mask);
    if (p <= n_max) zopfli_node_copy(N, p, V.slots, slot);
  });
  return tried;
}

}  // namespace brotli_torch
