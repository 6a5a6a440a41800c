// Exact greedy-NMS keep mask over a precomputed IoU matrix (kernel G).
//
// Replaces: greedy_nms_pallas (yolo_infer_tpu/ops/pallas/nms_kernel.py),
// which holds one image's whole (K, K) IoU block in VMEM and scans the
// score-sorted candidates in order. On the H100 the val pool's 4096^2 f32
// block (64 MB) cannot sit in a block's 227 KB of shared memory.
//
// Design: two kernels.
//   Bits: a grid over (row tile, image), one warp per candidate row. The
//   warp reads the row's strict upper triangle once, 32 consecutive columns
//   per step (one coalesced 128-byte read), and __ballot_sync packs
//   `iou > thr` into one 32-bit word: bit j%32 of word j/32 of row i, for
//   i < j < K. Words below the diagonal, and every word of an invalid
//   candidate's row (never kept, so never ORed by the walk), are written as
//   0 without reading the IoU. The (B, K, ceil(K/32)) uint32 buffer is 2 MB
//   per image at K = 4096, 32 MB at the val batch of 16: it stays in L2.
//   Walk: the strip-staged walk of nms_walk.cuh, shared with kernel C: one
//   block per image; warp 0 walks the candidates in rank order while the
//   other warps stage the next 32-row strip of the bitmask (words from the
//   strip's own on; 16 KB at K = 4096) with cp.async. The removed set is up
//   to 8 words per lane (K <= 8192), and the walk stops one past the last
//   valid candidate.
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

#include "nms_walk.cuh"

namespace {

constexpr int kBitsThreads = 256;
constexpr int kBitsRowsPerBlock = kBitsThreads / 32;  // one warp per row
constexpr int kBitsUnroll = 4;                        // words in flight per lane

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

}  // namespace

// iou (B, K, K) f32, valid (B, K) bool, keep (B, K) bool, bits (B, K,
// ceil(K/32)) uint32 scratch; all contiguous on the current device. Returns
// the cudaError_t of the launches.
extern "C" int greedy_nms_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                 float thr, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((K + kBitsRowsPerBlock - 1) / kBitsRowsPerBlock, B);
  suppression_bits_kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float*>(iou),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint32_t*>(bits), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_walk::launch_greedy_walk(static_cast<const uint32_t*>(bits),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint8_t*>(keep), B, K, s));
}
