// LZ resolution of device token streams (host fallback for phase 2 of TPU
// decode; the primary path resolves on device, ops/pallas_resolve.py).
//
// The Pallas entropy kernel (ops/pallas_decode2.py) emits per-lane token
// streams in row-major (n_rows, n_lanes) layout.  This resolver walks each
// lane's column, materializing literals and back-reference copies — pure
// memory-bandwidth work, multithreaded across lanes.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---- v2 token format (ops/pallas_decode2.py) ----
// PAD = 0; tag = t >> 30:
//   0: literals, count=(t>>24)&3 in 1..3, bytes at bits 0-7, 8-15, 16-23
//   1: copy_len = t & 0xFFFFFF (awaits a tag-2 distance)
//   2: distance = t & 0x3FFFFFFF (completes the tag-1 copy)
//   3: fused copy: copy_len=(t>>22)&0xFF, distance = t & 0x3FFFFF
int64_t resolve_lane_v2(const uint32_t* tokens, int64_t n_rows, int64_t stride,
                        uint8_t* out, int64_t out_cap, int64_t expected) {
  int64_t pos = 0;
  int64_t copy_len = -1;
  for (int64_t r = 0; r < n_rows && pos < expected; ++r) {
    uint32_t t = tokens[r * stride];
    if (t == 0) continue;
    uint32_t tag = t >> 30;
    if (tag == 0) {
      int64_t cnt = (t >> 24) & 3;
      if (pos + cnt > out_cap) return -1;
      out[pos++] = static_cast<uint8_t>(t & 0xFF);
      if (cnt >= 2) out[pos++] = static_cast<uint8_t>((t >> 8) & 0xFF);
      if (cnt == 3) out[pos++] = static_cast<uint8_t>((t >> 16) & 0xFF);
    } else if (tag == 1) {
      copy_len = static_cast<int64_t>(t & 0xFFFFFFu);
    } else {
      int64_t dist;
      int64_t len;
      if (tag == 3) {
        len = (t >> 22) & 0xFF;
        dist = t & 0x3FFFFFu;
      } else {
        len = copy_len;
        dist = t & 0x3FFFFFFFu;
        copy_len = -1;
      }
      if (len < 0 || dist < 1 || dist > pos || pos + len > out_cap) return -1;
      const uint8_t* src = out + pos - dist;
      uint8_t* dst = out + pos;
      if (dist >= len) {
        std::memcpy(dst, src, static_cast<size_t>(len));
      } else {
        int64_t written = dist;
        std::memcpy(dst, src, static_cast<size_t>(dist));
        while (written < len) {
          int64_t n = written < len - written ? written : len - written;
          std::memcpy(dst + written, dst, static_cast<size_t>(n));
          written += n;
        }
      }
      pos += len;
    }
  }
  return pos;
}

}  // namespace

extern "C" {

// tokens: (n_rows, n_lanes) u32 row-major.
// out: (n_lanes, out_stride) u8; out_lens[lane]: IN expected size, OUT bytes
// produced (-1 on malformed stream).  Returns the number of failed lanes.
int lz_resolve_batch_v2(const uint32_t* tokens, int64_t n_rows,
                        int64_t n_lanes, uint8_t* out, int64_t out_stride,
                        int64_t* out_lens, int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> failures(static_cast<size_t>(n_threads), 0);
  auto work = [&](int tid) {
    for (int64_t lane = tid; lane < n_lanes; lane += n_threads) {
      int64_t n = resolve_lane_v2(tokens + lane, n_rows, n_lanes,
                                  out + lane * out_stride, out_stride,
                                  out_lens[lane]);
      if (n < 0 || n != out_lens[lane]) {
        failures[static_cast<size_t>(tid)]++;
        out_lens[lane] = -1;
      } else {
        out_lens[lane] = n;
      }
    }
  };
  if (n_threads == 1) {
    work(0);
  } else {
    std::vector<std::thread> threads;
    threads.reserve(static_cast<size_t>(n_threads));
    for (int t = 0; t < n_threads; ++t) threads.emplace_back(work, t);
    for (auto& th : threads) th.join();
  }
  int total = 0;
  for (int f : failures) total += f;
  return total;
}

}  // extern "C"
