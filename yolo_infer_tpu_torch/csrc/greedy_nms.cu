// Exact greedy-NMS keep mask over a precomputed IoU matrix (kernel G).
//
// Replaces: greedy_nms_pallas (yolo_infer_tpu/ops/pallas/nms_kernel.py),
// which holds one image's whole (K, K) IoU block in VMEM and scans the
// score-sorted candidates in order. On the H100 the val pool's 4096^2 f32
// block (64 MB) cannot sit in a block's 227 KB of shared memory, so the work
// is two kernels:
//
//   Bits: a grid over (row tile, image), one warp per candidate row. The
//   warp reads the row's strict upper triangle once, 32 consecutive columns
//   per step (one coalesced 128-byte read), and __ballot_sync packs
//   `iou > thr` into one 32-bit word: bit j%32 of word j/32 of row i, for
//   i < j < K. Words below the diagonal, and every word of an invalid
//   candidate's row (never kept, so never ORed by the walk), are written as
//   0 without reading the IoU. The (B, K, ceil(K/32)) uint32 buffer is 2 MB
//   per image at K = 4096, 32 MB at the val batch of 16: it stays in L2.
//   Walk: one block per image. Warp 0 walks the candidates in rank order,
//   as nms_walk.cuh does for kernels A and C, while the other warps stage
//   the next 32-row strip of the bitmask (words from the strip's own on; 16
//   KB at K = 4096) into the second of two shared-memory buffers. The
//   removed set is ceil(K/32) words, kMaxWordsPerLane per lane at most (K <=
//   8192): lane l holds words l, l+32, l+64, ... . Candidate i is kept when
//   it is valid and no kept candidate removed it; its row is then ORed into
//   the removed set.
//
// What bounds it on the H100: bytes, the upper triangle of the valid rows
// (~0.54 GB at B = 16, K = 4096, all valid). The walk's K dependent
// decisions per image run on B SMs in parallel, after the bits.
//
// Compares only: a pair suppresses when `iou > thr` in f32 (NaN never does),
// exactly the plain version's test (ops/nms.py _nms_fixpoint), and sequential
// greedy is the fixpoint's limit, so the keep masks are equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBitsThreads = 256;
constexpr int kBitsRowsPerBlock = kBitsThreads / 32;  // one warp per row
constexpr int kBitsUnroll = 4;                        // words in flight per lane
constexpr int kWalkThreads = 256;
constexpr int kMaxWordsPerLane = 8;
constexpr int kMaxK = 32 * 32 * kMaxWordsPerLane;  // 8192

__global__ void __launch_bounds__(kBitsThreads)
suppression_bits_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid,
                        uint32_t* __restrict__ bits, int K, int W, float thr) {
  const int img = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBitsRowsPerBlock + (threadIdx.x >> 5);
  if (i >= K) return;  // a whole warp leaves together
  const size_t r = static_cast<size_t>(img) * K + i;
  uint32_t* out = bits + r * W;
  if (!valid[r]) {
    for (int w = lane; w < W; w += 32) out[w] = 0u;
    return;
  }
  const int wfirst = (i + 1) >> 5;  // the first word that can hold a j > i
  for (int w = lane; w < wfirst; w += 32) out[w] = 0u;
  const float* row = iou + r * K;
  for (int w0 = wfirst; w0 < W; w0 += kBitsUnroll) {
    float x[kBitsUnroll];
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      x[u] = (j > i && j < K) ? row[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, j > i && j < K && x[u] > thr);
      if (lane == 0 && w0 + u < W) out[w0 + u] = word;
    }
  }
}

// Copy rows i0..i0+nrows-1 of the image's bitmask, words w..W-1, into `dst`
// (row stride W words), with `nthreads` threads numbered from `t`.
__device__ __forceinline__ void stage_strip(const uint32_t* __restrict__ src, uint32_t* dst, int i0, int nrows,
                                            int w, int W, int t, int nthreads) {
  const int n = W - w;
  for (int idx = t; idx < nrows * n; idx += nthreads) {
    const int rr = idx / n;
    const int c = w + (idx - rr * n);
    dst[rr * W + c] = src[static_cast<size_t>(i0 + rr) * W + c];
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
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += kWalkThreads) svalid[i] = vb[i];
  stage_strip(mb, strips, 0, min(32, K), 0, W, threadIdx.x, kWalkThreads);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int wpl = (W + 31) >> 5;  // words of the removed set per lane
  uint32_t removed[kMaxWordsPerLane];
#pragma unroll
  for (int g = 0; g < kMaxWordsPerLane; ++g) removed[g] = 0u;

  for (int w = 0; w < W; ++w) {
    const uint32_t* strip = strips + (w & 1) * 32 * W;
    const int i0 = w << 5;
    if (threadIdx.x < 32) {
      // the word under the walk, from the lane that holds it
      uint32_t mine = 0u;
#pragma unroll
      for (int g = 0; g < kMaxWordsPerLane; ++g)
        if (g == (w >> 5)) mine = removed[g];
      uint32_t cur = __shfl_sync(0xffffffffu, mine, w & 31);
      uint32_t kept_bits = 0u;
      const int iend = min(i0 + 32, K);
      for (int i = i0; i < iend; ++i) {
        const uint32_t* row = strip + (i - i0) * W;
        const uint32_t row_cur = row[w];
        uint32_t own[kMaxWordsPerLane];
#pragma unroll
        for (int g = 0; g < kMaxWordsPerLane; ++g) {
          const int c = g * 32 + lane;
          // words before w were not staged and are never read again
          own[g] = (g < wpl && c >= w && c < W) ? row[c] : 0u;
        }
        const uint32_t bit = 1u << (i - i0);
        if (svalid[i] && !(cur & bit)) {
          kept_bits |= bit;
          cur |= row_cur;
#pragma unroll
          for (int g = 0; g < kMaxWordsPerLane; ++g) removed[g] |= own[g];
        }
      }
      if (i0 + lane < K) kb[i0 + lane] = (kept_bits >> lane) & 1u;
    } else if (w + 1 < W) {
      stage_strip(mb, strips + ((w + 1) & 1) * 32 * W, i0 + 32, min(32, K - i0 - 32), w + 1, W,
                  threadIdx.x - 32, kWalkThreads - 32);
    }
    __syncthreads();
  }
}

}  // namespace

// iou (B, K, K) f32, valid (B, K) bool, keep (B, K) bool, bits (B, K,
// ceil(K/32)) uint32 scratch; all contiguous on the current device. Returns
// the cudaError_t of the launches.
extern "C" int greedy_nms_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                 float thr, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + kBitsRowsPerBlock - 1) / kBitsRowsPerBlock, B);
  suppression_bits_kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float*>(iou),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint32_t*>(bits), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(64) * W * sizeof(uint32_t) + K;
  err = cudaFuncSetAttribute(greedy_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_walk_kernel<<<B, kWalkThreads, smem, s>>>(static_cast<const uint32_t*>(bits),
                                                   static_cast<const uint8_t*>(valid),
                                                   static_cast<uint8_t*>(keep), K, W);
  return static_cast<int>(cudaGetLastError());
}
