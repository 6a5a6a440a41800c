// The greedy walk shared by the keep-mask kernels (nms_fused.cu, kernel A;
// rotated_nms_fused.cu, kernel C).
//
// Each kernel first writes, in shared memory, the strictly upper-triangular
// suppression bitmask of one image: K rows of W = ceil(K/32) 32-bit words,
// bit j of row i set when i < j and candidate i overlaps candidate j past the
// threshold. Then one warp walks the score-sorted candidates i = 0..K-1:
// candidate i is kept when it is valid and no kept candidate removed it, and
// a kept candidate's row is ORed into the removed set. That is sequential
// greedy NMS, the limit of the JAX package's fixpoint sweeps, so the keep mask
// equals the fixpoint's bit for bit.
#pragma once

#include <stdint.h>

constexpr int kNmsMaxK = 1024;  // the removed set is one 32-bit word per lane

// Called by the 32 threads of warp 0. `mask` (K x W words) and `valid` (K
// flags) are in shared memory; `keep` is the image's K output flags.
__device__ __forceinline__ void greedy_keep_walk(const uint32_t* mask, const uint8_t* valid, uint8_t* keep,
                                                 int K, int W) {
  // Lane w < W holds word w of the removed set. Each lane also tracks `cur`,
  // the word being walked, so the decision chain needs no shuffle per
  // candidate; both mask loads are independent of the decision.
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
