// Shared helpers for the port's kernels.  Every header here compiles under
// both nvcc (device kernels, csrc/*.cu) and g++ (csrc/host_shim.cpp, which
// runs the same per-lane logic on the CPU for the tests).
#pragma once

#include <cstdint>

#if defined(__CUDACC__)
#define BROTLI_HD __host__ __device__ __forceinline__
#else
#define BROTLI_HD inline
#endif

namespace brotli_torch {

using i8 = int8_t;
using u8 = uint8_t;
using u16 = uint16_t;
using u32 = uint32_t;
using i32 = int32_t;
using i64 = int64_t;
using u64 = uint64_t;

// Right funnel shift: 32 bits of the 64-bit value (hi:lo) starting at bit m,
// m in [0, 31].  A plain `hi << (32 - m)` is undefined for m == 0, so that
// case is selected apart, as the JAX kernel does with its `(32 - m) & 31`
// shift under an `m == 0` select (pallas_decode2.py peek / consume).
BROTLI_HD u32 funnel_r(u32 lo, u32 hi, u32 m) {
  return m == 0 ? lo : (lo >> m) | (hi << (32u - m));
}

// (1 << n) - 1 for n in [0, 31]; callers mask n with & 31 first, matching
// the JAX kernel's `(1 << (n & 31)) - 1`.
BROTLI_HD u32 low_mask(u32 n) { return (1u << (n & 31u)) - 1u; }

// Logical right shift of a non-negative int32 that yields 0 for shifts of
// 32 or more (XLA's semantics; C++ leaves them undefined).
BROTLI_HD i32 shr_sat(i32 x, i32 s) {
  return (s < 0 || s >= 32) ? 0 : (i32)((u32)x >> (u32)s);
}

// Two's-complement int32 arithmetic as XLA does it: wraps, never undefined.
BROTLI_HD i32 add_wrap(i32 a, i32 b) { return (i32)((u32)a + (u32)b); }
BROTLI_HD i32 shl_wrap(i32 a, i32 s) { return (i32)((u32)a << ((u32)s & 31u)); }

BROTLI_HD i32 clip(i32 x, i32 lo, i32 hi) { return x < lo ? lo : (x > hi ? hi : x); }

// 32 bits of the 96-bit buffer (b2:b1:b0) from bit q, q in [0, 63] (JAX `peek`)
BROTLI_HD u32 peek32(u32 b0, u32 b1, u32 b2, i32 q) {
  const bool l0 = (q >> 5) == 0;
  return funnel_r(l0 ? b0 : b1, l0 ? b1 : b2, (u32)(q & 31));
}

// A read through the read-only data cache on the card; a plain load on the
// host.
template <typename T>
BROTLI_HD T ldg(const T* p) {
#if defined(__CUDA_ARCH__)
  return __ldg(p);
#else
  return *p;
#endif
}

}  // namespace brotli_torch
