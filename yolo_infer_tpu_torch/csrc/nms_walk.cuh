// The greedy walks shared by the keep-mask kernels: A (nms_fused.cu), C
// (rotated_nms_fused.cu) and G (greedy_nms.cu).
//
// Each kernel first forms the strictly upper-triangular suppression bitmask
// of one image: K rows of W = ceil(K/32) 32-bit words, bit j of row i set
// when i < j and candidate i overlaps candidate j past the threshold. Then
// one warp walks the score-sorted candidates i = 0..K-1: candidate i is kept
// when it is valid and no kept candidate removed it, and a kept candidate's
// row is ORed into the removed set. That is sequential greedy NMS, the limit
// of the JAX package's fixpoint sweeps, so the keep mask equals the
// fixpoint's bit for bit.
//
// Only the words a walk can consult must be written: for row i, words
// i/32 .. ceil(E/32)-1 of a valid row, where E is one past the last valid
// candidate. An invalid row is never ORed in, and no candidate at or past E
// is ever kept.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kNmsMaxK = 1024;  // greedy_keep_walk: the removed set is one 32-bit word per lane

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

// ---------------------------------------------------------------------------
// The walks over a bitmask in device memory (kernels C and G), for K up to
// kWalkMaxK. One block per image; warp 0 walks the candidates in rank order,
// a strip of 32 at a time. Within a strip the 32 keep decisions need only the
// word under the walk and each row's word there, held in registers, so the
// serial chain is a few ALU operations per candidate; the kept rows are then
// ORed into the removed set, every row under a mask rather than a branch per
// kept row (measured faster for C and G, PERF.md). The removed set is
// ceil(E/32) words, at most kWalkMaxWordsPerLane per lane: lane l holds words
// l, l+32, l+64, ... . The walk stops at E, one past the last valid
// candidate: every candidate from there on is invalid, so not kept.
//   Resident (K <= kNmsMaxK): the block stages the whole mask (rows below E,
//   words below ceil(E/32); 128 KB at K = 1024) into shared memory with
//   cp.async, then warp 0 walks it with no further synchronisation.
//   Strip-staged (larger K): the other warps stage the next 32-row strip
//   (words from the strip's own on) into the second of two shared-memory
//   buffers while warp 0 walks the current one, a __syncthreads per strip.
// launch_greedy_walk picks by K.

namespace nms_walk {
namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkMaxWordsPerLane = 8;
constexpr int kWalkMaxK = 32 * 32 * kWalkMaxWordsPerLane;  // 8192

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
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

// The image's K flags into `svalid` (block-wide); returns E, one past the
// last valid candidate, and zeroes the keep flags from ceil(E/32)*32 on.
__device__ __forceinline__ int stage_valid(const uint8_t* __restrict__ vb, uint8_t* svalid, uint8_t* kb, int K) {
  __shared__ int s_end;
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int last = 0;  // one past this thread's last valid candidate
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    const uint8_t v = vb[i];
    svalid[i] = v;
    if (v) last = i + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_end, last);
  __syncthreads();
  const int E = s_end;
  for (int i = (((E + 31) >> 5) << 5) + threadIdx.x; i < K; i += blockDim.x) kb[i] = 0;
  return E;
}

// Warp 0's step over word w: decide candidates 32w .. 32w+31 from `strip`
// (their rows, row stride W, staged from word w on), write their keep flags
// and OR the kept rows into `removed`. We = ceil(E/32) words are live, wpl =
// ceil(We/32) of them per lane.
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
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);                // 32W rows x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + 32 * W * W);  // K flags

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

__global__ void __launch_bounds__(kWalkThreads)
greedy_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* strips = reinterpret_cast<uint32_t*>(smem);          // 2 x 32 rows x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(strips + 64 * W);  // K flags

  const int img = blockIdx.x;
  const uint32_t* mb = bits + static_cast<size_t>(img) * K * W;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  const int E = stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);
  const int We = (E + 31) >> 5;  // the walk's strips, and the words it reads
  if (We == 0) return;
  stage_strip(mb, strips, 0, min(32, E), 0, We, W, threadIdx.x >> 5, kWalkThreads / 32);
  cp_async_wait_all();
  __syncthreads();

  const int wpl = (We + 31) >> 5;  // words of the removed set per lane
  uint32_t removed[kWalkMaxWordsPerLane];
#pragma unroll
  for (int g = 0; g < kWalkMaxWordsPerLane; ++g) removed[g] = 0u;
  for (int w = 0; w < We; ++w) {
    const int i0 = w << 5;
    if (threadIdx.x < 32) {
      walk_strip<kWalkMaxWordsPerLane>(strips + (w & 1) * 32 * W, svalid, kb, removed, w, We, wpl, E, K, W);
    } else if (w + 1 < We) {
      stage_strip(mb, strips + ((w + 1) & 1) * 32 * W, i0 + 32, min(32, E - i0 - 32), w + 1, We, W,
                  (threadIdx.x >> 5) - 1, kWalkThreads / 32 - 1);
      cp_async_wait_all();
    }
    __syncthreads();
  }
}

// Launch the walk over `bits` (B, K, ceil(K/32)) on `stream`, one block per
// image: resident for K <= kNmsMaxK (the whole mask, its rows padded to a
// multiple of 32, and the K flags in dynamic shared memory), strip-staged
// above (two 32-row strips and the flags).
inline cudaError_t launch_greedy_walk(const uint32_t* bits, const uint8_t* valid, uint8_t* keep, int B, int K,
                                      cudaStream_t stream) {
  const int W = (K + 31) / 32;
  const bool resident = K <= kNmsMaxK;
  const auto kernel = resident ? resident_walk_kernel : greedy_walk_kernel;
  const size_t smem = static_cast<size_t>(resident ? 32 * W : 64) * W * sizeof(uint32_t) + K;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, kWalkThreads, smem, stream>>>(bits, valid, keep, K, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nms_walk
