// greedy_keep_walk, the one-warp walk over a bitmask in shared memory that
// the one-block designs of kernels A and C ran, kept for the alternative
// designs that tests/torch_kernel_breakdown.py times. The port's kernels
// walk with csrc/nms_walk.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Called by the 32 threads of warp 0. `mask` (K x W words, K <= 1024) and
// `valid` (K flags) are in shared memory; `keep` is the image's K output
// flags. Lane w < W holds word w of the removed set; each lane also tracks
// `cur`, the word being walked, so the decision chain needs no shuffle per
// candidate; both mask loads are independent of the decision.
__device__ __forceinline__ void greedy_keep_walk(const uint32_t* mask, const uint8_t* valid, uint8_t* keep,
                                                 int K, int W) {
  const int lane = threadIdx.x & 31;
  uint32_t removed = 0;
  for (int w = 0; w < W; ++w) {
    uint32_t cur = __shfl_sync(0xffffffffu, removed, w);
    uint32_t kept_bits = 0;
    const int i0 = w << 5;
    const int iend = min(i0 + 32, K);
    for (int i = i0; i < iend; ++i) {
      const uint32_t row_cur = mask[i * W + w];
      const uint32_t row_own = lane < W ? mask[i * W + lane] : 0u;
      const uint32_t bit = 1u << (i - i0);
      if (valid[i] && !(cur & bit)) {
        kept_bits |= bit;
        cur |= row_cur;
        removed |= row_own;
      }
    }
    if (i0 + lane < K) keep[i0 + lane] = (kept_bits >> lane) & 1u;
  }
}
