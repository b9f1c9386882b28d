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

// _DIST_CACHE_INDEX / _DIST_CACHE_OFFSET
BROTLI_HD i32 zopfli_cache_index(int j) { return j < 4 ? j : (j < 10 ? 0 : 1); }
BROTLI_HD i32 zopfli_cache_offset(int j) {
  if (j < 4) return 0;
  const int k = j - (j < 10 ? 4 : 10);
  return (k & 1) ? (k >> 1) + 1 : -((k >> 1) + 1);
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
// Steps gives leader(), sync(), match_length(a, b, limit) and
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
  i32 cache[4];
  if (push) zopfli_cache(N, sc, L.start_cache, cache);
  if (w.leader()) {
    N.sc[pos] = sc;
    if (push) zopfli_queue_push(q, pos, node_cost, node_cost - lc0, cache);
  }
  w.sync();

  const int s0 = zopfli_queue_slot(q, 0);
  const i32 start = q.pos[s0];
  const double min_cost = (q.cost[s0] + L.min_cost_cmd) + (L.lit[pos] - L.lit[start]);
  const i32 min_len = zopfli_min_copy_len(N.cost, L.n, pos, min_cost);
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
  return out;
}

}  // namespace brotli_torch
