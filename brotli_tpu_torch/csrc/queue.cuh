// A lane's look-ahead queue of input words, for the row machines of
// decode2.cuh and decode3.cuh.
//
// The row rule refills one word when avail <= 64, and the very next step
// needs it, so a load issued at the refill puts a whole device-memory
// latency on the lane's chain about every other row.  The queue issues
// each word's load QUEUE_R - 1 words ahead of its use, into a ring of
// QUEUE_R slots in shared memory, with cp.async: the copy holds no
// register, so nothing waits for it until the row rule takes the word.
// The words a lane consumes (widx) are still the row rule's; the queue
// only loads ahead, and never past wpad.
//
// Word w lands in slot w % QUEUE_R.  When the lane takes word w, the load
// it issues (word w + QUEUE_R - 1) goes to the slot of word w - 1, whose
// value the lane has already used, so no copy overwrites a word before it
// is read.  One commit group per word (empty past wpad) keeps
// `wait_prior(QUEUE_R - 2)` exact: every group but the QUEUE_R - 2 newest,
// so word w's, is complete.
//
// On the host (csrc/host_shim.cpp) the copy is a plain load made at issue,
// and the waits are empty.
#pragma once

#include "common.cuh"

#if defined(__CUDA_ARCH__)
#include <cuda_pipeline.h>
#endif

namespace brotli_torch {

constexpr i32 QUEUE_R = 8;  // slots a lane; QUEUE_R - 1 loads in flight

struct WordQueue {
  const u32* words;  // the lane's word w at words[w * wstride]
  i64 wstride;
  i32 wpad;
  u32* q;            // slot k at q[k * qstride]
  i32 qstride;

  BROTLI_HD void issue(i32 w) {
    if (w < wpad) {
      u32* dst = q + (w & (QUEUE_R - 1)) * qstride;
      const u32* src = words + (i64)w * wstride;
#if defined(__CUDA_ARCH__)
      __pipeline_memcpy_async(dst, src, sizeof(u32));
#else
      *dst = *src;
#endif
    }
#if defined(__CUDA_ARCH__)
    __pipeline_commit();
#endif
  }

  // the first QUEUE_R - 1 loads
  BROTLI_HD void start() {
    for (i32 w = 0; w < QUEUE_R - 1; ++w) issue(w);
  }

  // Word w, which the row rule takes in order w = 0, 1, ...
  BROTLI_HD u32 pop(i32 w) {
#if defined(__CUDA_ARCH__)
    __pipeline_wait_prior(QUEUE_R - 2);
#endif
    const u32 v = q[(w & (QUEUE_R - 1)) * qstride];
    issue(w + QUEUE_R - 1);
    return v;
  }

  // no copy is left in flight when the lane ends
  BROTLI_HD void drain() {
#if defined(__CUDA_ARCH__)
    __pipeline_wait_prior(0);
#endif
  }
};

}  // namespace brotli_torch
