// Exact greedy-NMS keep mask over a precomputed IoU matrix (kernel G).
//
// Replaces: greedy_nms_pallas (yolo_infer_tpu/ops/pallas/nms_kernel.py),
// which holds one image's whole (K, K) IoU block in VMEM and scans the
// score-sorted candidates in order. On the H100 the validation pool's 4096^2
// f32 block (64 MB) cannot sit in a block's 227 KB of shared memory.
//
// What bounds it on the H100: bytes. The walk needs the upper triangle of
// the valid rows below E (E is one past the image's last valid candidate):
// ~0.54 GB at the validation batch (B = 16, K = 4096, all valid), ~0.16 ms at
// 3.35 TB/s. The IoU is 1 GB there, read once, so L2 cannot help. Then the
// walk's K/32 dependent strips per image (nms_walk.cuh), on B SMs.
//
// Design: two launches.
//   Bits: a grid over (image, row pairs), one warp per pair of rows p and
//   E-1-p, so every warp reads E-1 columns and the blocks finish together
//   over the triangle (each block finds E from the flags, 16 a load). A row
//   is read with 16-byte streaming loads (__ldcs, evict-first: the matrix is
//   read once): lane l takes the float4 of columns 4l..4l+3 of a 128-column
//   step, kBitsUnroll steps in flight per lane; three xor-shuffles gather 8
//   lanes' nibbles of `iou > thr` into one 32-bit word (bit j%32 of word j/32
//   of row i, for i < j < E), and one lane in 8 stores it. Only columns from
//   the row's own 16 bytes to E are read, and only what the walk stages is
//   written: words i/32 .. ceil(E/32)-1 of valid rows below E (no bit at or
//   below i). Invalid rows and the words below the diagonal stay unwritten. A
//   K that is not a multiple of 4 (rows not 16-byte aligned) takes 4-byte
//   loads and a ballot per word. The (B, K, bits_stride(K)) uint32 scratch
//   is 32 MB at the validation batch.
//   Walk: nms_walk.cuh's, shared with kernels A and C: resident in shared
//   memory for K <= 1024; above, one warp walks on the two words per row it
//   needs, staged 16 strips ahead, while six helper warps OR the kept rows
//   into the removed set behind it.
//
// Compares only: a pair suppresses when `iou > thr` in f32 (NaN never does),
// exactly the plain version's test (ops/nms.py _nms_fixpoint), and sequential
// greedy is the fixpoint's limit, so the keep masks are equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_walk.cuh"

namespace {

constexpr int kBitsWarps = 8;
constexpr int kBitsThreads = kBitsWarps * 32;
constexpr int kBitsUnroll = 4;  // 128-column steps in flight per lane

// One valid row r < E: words r/32 .. ceil(E/32)-1 of `out`, from 16-byte loads.
__device__ __forceinline__ void row_bits_vec(const float* __restrict__ row, uint32_t* __restrict__ out, int r,
                                             int E, float thr) {
  const int lane = threadIdx.x & 31;
  const int We = (E + 31) >> 5;
  const int wfirst = r >> 5;
  const float4* row4 = reinterpret_cast<const float4*>(row);
  for (int c0 = (r >> 7) << 7; c0 < E; c0 += 128 * kBitsUnroll) {
    float4 x[kBitsUnroll];
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = c0 + 128 * u + 4 * lane;
      x[u] = (j + 3 > r && j < E) ? __ldcs(row4 + (j >> 2)) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = c0 + 128 * u + 4 * lane;
      const float v[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
      uint32_t nib = 0u;
#pragma unroll
      for (int q = 0; q < 4; ++q) nib |= static_cast<uint32_t>(j + q > r && j + q < E && v[q] > thr) << q;
      uint32_t word = nib << ((lane & 7) * 4);
      word |= __shfl_xor_sync(0xffffffffu, word, 1);
      word |= __shfl_xor_sync(0xffffffffu, word, 2);
      word |= __shfl_xor_sync(0xffffffffu, word, 4);
      const int w = ((c0 + 128 * u) >> 5) + (lane >> 3);
      if ((lane & 7) == 0 && w >= wfirst && w < We) out[w] = word;
    }
  }
}

// The same from 4-byte loads: lane l takes column 32w + l, a ballot packs the word.
__device__ __forceinline__ void row_bits_scalar(const float* __restrict__ row, uint32_t* __restrict__ out, int r,
                                                int E, float thr) {
  const int lane = threadIdx.x & 31;
  const int We = (E + 31) >> 5;
  for (int w0 = r >> 5; w0 < We; w0 += kBitsUnroll) {
    float x[kBitsUnroll];
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      x[u] = (j > r && j < E) ? __ldcs(row + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBitsUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, j > r && j < E && x[u] > thr);
      if (lane == 0 && w0 + u < We) out[w0 + u] = word;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kBitsThreads)
suppression_bits_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid,
                        uint32_t* __restrict__ bits, int K, int W, const float* __restrict__ thr_ptr) {
  const float thr = __ldg(thr_ptr);  // in device memory, so a captured graph reads the current value
  const int img = blockIdx.x;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  const int E = nms_walk::valid_end(vb, K);
  const int pairs = (E + 1) >> 1;
  const int p = blockIdx.y * kBitsWarps + (threadIdx.x >> 5);
  if (p >= pairs) return;  // a whole warp leaves together; no block-wide sync follows
  const int rows[2] = {p, E - 1 - p != p ? E - 1 - p : -1};
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = rows[s];
    if (r < 0 || !vb[r]) continue;  // the same for the whole warp
    const size_t at = static_cast<size_t>(img) * K + r;
    if (kVec) {
      row_bits_vec(iou + at * K, bits + at * W, r, E, thr);
    } else {
      row_bits_scalar(iou + at * K, bits + at * W, r, E, thr);
    }
  }
}

}  // namespace

// iou (B, K, K) f32, valid (B, K) bool, keep (B, K) bool, bits (B, K,
// bits_stride(K)) uint32 scratch, thr one f32 (the IoU threshold, as the TPU
// kernel's thr_ref, read by the bits pass at run time so that a captured CUDA
// graph takes the value current at each replay); all on the current device,
// contiguous. Returns the cudaError_t of the launches.
extern "C" int greedy_nms_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                 const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = nms_walk::bits_stride(K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(iou) % 16 == 0;
  const auto kernel = vec ? suppression_bits_kernel<true> : suppression_bits_kernel<false>;
  kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float*>(iou), static_cast<const uint8_t*>(valid),
                                       static_cast<uint32_t*>(bits), K, W, static_cast<const float*>(thr));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_walk::launch_greedy_walk(static_cast<const uint32_t*>(bits),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint8_t*>(keep), B, K, s));
}
