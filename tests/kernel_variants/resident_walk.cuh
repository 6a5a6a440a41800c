// The resident walk that csrc/nms_walk.cuh ran for K <= 1024 until the
// strip-staged walk measured faster at A's K = 384 and C's K = 1024, for
// tests/torch_kernel_breakdown.py: the block stages the image's whole mask
// (rows below E, words below ceil(E/32); 128 KB at K = 1024) into shared
// memory with 4-byte cp.async, then warp 0 walks it without a further sync,
// each strip's 32 decisions in registers and the kept rows ORed into a
// removed set of one word per lane, every row under a mask rather than a
// branch. Included after csrc/nms_walk.cuh (through a kernel's source), with
// -I yolo_infer_tpu_torch/csrc.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_walk.cuh"

constexpr int kNmsMaxK = 1024;  // the resident walk: the whole mask in shared memory

namespace nms_walk {
namespace {

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Start copying rows i0..i0+nrows-1 of the image's bitmask, words w..wend-1,
// into `dst` (row stride W words): warp `warp` of `nwarps` takes every
// nwarps-th row, its lanes consecutive words.
__device__ __forceinline__ void stage_strip(const uint32_t* __restrict__ src, uint32_t* dst, int i0, int nrows,
                                            int w, int wend, int W, int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  for (int rr = warp; rr < nrows; rr += nwarps) {
    const uint32_t* row = src + static_cast<size_t>(i0 + rr) * W;
    for (int c = w + lane; c < wend; c += 32) cp_async4(dst + rr * W + c, row + c);
  }
}

// The resident walk's step over word w: decide candidates 32w .. 32w+31 from
// `strip` (their rows, row stride W, staged from word w on), write their keep
// flags and OR the kept rows into `removed`. We = ceil(E/32) words are live,
// wpl = ceil(We/32) of them per lane.
template <int kWords>
__device__ __forceinline__ void walk_strip(const uint32_t* strip, const uint8_t* svalid, uint8_t* kb,
                                           uint32_t (&removed)[kWords], int w, int We, int wpl, int E, int K,
                                           int W) {
  const int lane = threadIdx.x & 31;
  const int i0 = w << 5;
  // the word under the walk, from the lane that holds it
  uint32_t mine = 0u;
#pragma unroll
  for (int g = 0; g < kWords; ++g)
    if (g == (w >> 5)) mine = removed[g];
  uint32_t cur = __shfl_sync(0xffffffffu, mine, w & 31);
  // the strip's 32 decisions depend only on `cur` and each row's word w:
  // every lane holds those 32 words in registers, so the chain is ALU only;
  // rows past E (never staged) are never valid
  const int n = min(32, E - i0);
  const uint32_t vbits = __ballot_sync(0xffffffffu, lane < n && svalid[i0 + lane]);
  uint32_t diag[32];
#pragma unroll
  for (int t = 0; t < 32; ++t) diag[t] = strip[t * W + w];
  uint32_t kept_bits = 0u;
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const uint32_t take = 0u - ((vbits & ~cur) >> t & 1u);  // all ones when candidate i0+t is kept
    kept_bits |= take & (1u << t);
    cur |= diag[t] & take;
  }
  // then the kept rows' words from w on join the removed set: all 32 rows
  // under their masks, so the loads wait on no branch (rows past n are
  // never kept)
#pragma unroll
  for (int t = 0; t < 32; ++t) {
    const uint32_t take = 0u - (kept_bits >> t & 1u);
    const uint32_t* row = strip + t * W;
#pragma unroll
    for (int g = 0; g < kWords; ++g) {
      const int c = g * 32 + lane;
      // words before w were not staged and are never read again
      if (g < wpl && c >= w && c < We) removed[g] |= row[c] & take;
    }
  }
  if (i0 + lane < K) kb[i0 + lane] = (kept_bits >> lane) & 1u;
}

__global__ void __launch_bounds__(kWalkThreads)
resident_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                     uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = ((K + 31) >> 5) << 5;  // the last strip's rows past K are read (never kept)
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);             // rows x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + rows * W);  // K flags

  const int img = blockIdx.x;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  const int E = stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);
  const int We = (E + 31) >> 5;
  if (We == 0) return;
  stage_strip(bits + static_cast<size_t>(img) * K * W, mask, 0, E, 0, We, W, threadIdx.x >> 5, kWalkThreads / 32);
  cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) {
    uint32_t removed[1] = {0u};  // We <= 32: one word per lane
    for (int w = 0; w < We; ++w) walk_strip<1>(mask + (w << 5) * W, svalid, kb, removed, w, We, 1, E, K, W);
  }
}

// The resident walk for K <= kNmsMaxK (the whole mask and the K flags in
// dynamic shared memory), the port's strip-staged walk above.
inline cudaError_t launch_resident_walk(const uint32_t* bits, const uint8_t* valid, uint8_t* keep, int B, int K,
                                        cudaStream_t stream) {
  if (K > kNmsMaxK) return launch_greedy_walk(bits, valid, keep, B, K, stream);
  const int W = bits_stride(K);
  const size_t smem = static_cast<size_t>((K + 31) / 32 * 32) * W * sizeof(uint32_t) + K;
  cudaError_t err = cudaFuncSetAttribute(resident_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  resident_walk_kernel<<<B, kWalkThreads, smem, stream>>>(bits, valid, keep, K, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nms_walk
