// Greedy-NMS keep mask over score-sorted, class-offset candidates (kernel A).
//
// Replaces: nms_keep_pallas (yolo_infer_tpu/ops/pallas/nms_fused.py), the TPU
// kernel that builds each image's (K, K) IoU in VMEM and sweeps the greedy
// fixpoint to stability.
//
// What bounds it on the H100: not bytes (16 B of box and 1 B of flag in, 1 B
// out per candidate) and hardly arithmetic (K^2/2 IoUs, ~74 k per image at
// the serving pool of K = 384), but the greedy walk, serial in the candidate
// rank, and the latency of each launch. The earlier design, one block per image
// that built every IoU with a division and then walked the shared-memory mask
// one candidate at a time, ran on 32 of 132 SMs at the detect batch.
//
// Design: two launches, kernel C's shape (rotated_nms_fused.cu), any K <= 8192.
//   Bits: a grid over (image, row pairs), one warp per pair of candidate rows
//   p and E-1-p, so every warp takes E-1 columns and the blocks finish
//   together over the triangle (E is one past the image's last valid
//   candidate, found by each block from the flags). The lanes take 32
//   consecutive columns j, compute IoU(i, j) in place (never stored), and
//   __ballot_sync packs `> thr` into bit j%32 of word j/32 of row i. Column
//   boxes, areas and flags are staged in shared memory in chunks of 512
//   columns. Pairs with j <= i, j >= E or an invalid j are 0 without the IoU,
//   and so is every pair of a box with a NaN coordinate (its IoU is NaN); an
//   invalid row is not written (the walk never keeps it, so never reads it).
//   The (B, K, bits_stride(K)) uint32 scratch is 0.6 MB at K = 384, B = 32.
//   Walk: nms_walk.cuh's, the one C and G launch: for K <= 1024 the whole
//   mask resident in shared memory and walked without a sync (the serving
//   pool of 384), above that strip-staged with helper warps.
// Sequential greedy is the fixpoint's limit, so the mask is bit-identical to
// the plain version (ops/nms.py _nms_fixpoint over ops/iou.py
// box_iou_matrix) as long as every IoU rounds the same way: the IoU is
// written with explicitly rounded operations in box_iou_matrix's order,
// inter / (area_i + area_j - inter + eps), clamp(min=0) passes NaN through as
// PyTorch's does (fmaxf would drop it), a NaN coordinate (which makes
// torch.maximum / torch.minimum NaN) clears every pair of its box, and the
// file is built with --fmad=false so nothing is contracted into an FMA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_walk.cuh"

namespace {

constexpr int kBitsWarps = 4;
constexpr int kBitsThreads = kBitsWarps * 32;
constexpr int kChunk = 512;  // columns staged at a time (a multiple of 32)
constexpr float kEps = 1e-7f;

// torch.clamp keeps a NaN (inf - inf makes one) where fmaxf would drop it
__device__ __forceinline__ float clamp_min0(float v) { return isnan(v) ? v : fmaxf(v, 0.f); }

// torch.maximum / torch.minimum return NaN when either side is NaN, so a box
// with a NaN coordinate has a NaN IoU with every box, and never suppresses
// nor is suppressed: such boxes are flagged once, and between two boxes
// without NaN fminf / fmaxf are torch.minimum / torch.maximum (up to the sign
// of a zero, which no compare below can see)
__device__ __forceinline__ bool has_nan(const float4 b) {
  return isnan(b.x) || isnan(b.y) || isnan(b.z) || isnan(b.w);
}

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(clamp_min0(__fsub_rn(b.z, b.x)), clamp_min0(__fsub_rn(b.w, b.y)));
}

// `iou(a, c) > thr` in ops/iou.py box_iou_matrix's order, a the row's box;
// neither box has a NaN coordinate
__device__ __forceinline__ bool iou_above(const float4 a, float area_a, const float4 c, float area_c, float thr) {
  const float iw = clamp_min0(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)));
  const float ih = clamp_min0(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)));
  const float inter = __fmul_rn(iw, ih);
  const float areas = __fadd_rn(area_a, area_c);
  // an empty intersection gives 0 / (areas + eps): +0 when the areas are
  // finite or +inf, NaN when they are NaN; the division only where boxes meet
  if (inter == 0.f) return !isnan(areas) && 0.f > thr;
  return __fdiv_rn(inter, __fadd_rn(__fsub_rn(areas, inter), kEps)) > thr;
}

__global__ void __launch_bounds__(kBitsThreads)
iou_bits_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint32_t* __restrict__ bits, int K, int W, const float* __restrict__ thr_ptr) {
  __shared__ float4 sbox[kChunk];
  __shared__ float sarea[kChunk];
  __shared__ uint8_t sval[kChunk];  // valid, and no NaN coordinate

  const float thr = __ldg(thr_ptr);  // in device memory, so a captured graph reads the current value
  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float4* bx = boxes + static_cast<size_t>(img) * K;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  uint32_t* out = bits + static_cast<size_t>(img) * K * W;

  const int E = nms_walk::valid_end(vb, K);
  const int pairs = (E + 1) >> 1;
  const int p0 = blockIdx.y * kBitsWarps;
  if (p0 >= pairs) return;  // the whole block: E is the same for all its threads
  const int We = (E + 31) >> 5;

  // this warp's rows: p and E-1-p (one row where they meet, none past the
  // pairs); an invalid row is skipped, a row with a NaN is all zeros
  const int p = p0 + (threadIdx.x >> 5);
  int rows[2] = {p < pairs ? p : -1, (p < pairs && E - 1 - p != p) ? E - 1 - p : -1};
  float4 rbox[2];
  float rarea[2];
  bool rnan[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if (rows[s] >= 0 && !vb[rows[s]]) rows[s] = -1;
    rbox[s] = bx[rows[s] < 0 ? 0 : rows[s]];
    rarea[s] = box_area(rbox[s]);
    rnan[s] = has_nan(rbox[s]);
  }

  // columns from the block's first row's word on, in chunks
  for (int cs = (p0 >> 5) << 5; cs < E; cs += kChunk) {
    const int ce = min(cs + kChunk, E);
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < ce - cs; t += kBitsThreads) {
      const float4 b = bx[cs + t];
      sbox[t] = b;
      sarea[t] = box_area(b);
      sval[t] = vb[cs + t] && !has_nan(b);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = rows[s];
      if (r < 0) continue;  // the same for the whole warp
      const int wend = min(We, (ce + 31) >> 5);
      for (int w = max(r >> 5, cs >> 5); w < wend; ++w) {
        const int j = (w << 5) + lane;
        const int t = j - cs;
        const bool hit =
            j > r && j < E && !rnan[s] && sval[t] && iou_above(rbox[s], rarea[s], sbox[t], sarea[t], thr);
        const uint32_t word = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) out[static_cast<size_t>(r) * W + w] = word;
      }
    }
  }
}

}  // namespace

// boxes (B, K, 4) f32 (16-byte aligned), valid (B, K) bool, keep (B, K) bool,
// bits (B, K, bits_stride(K)) uint32 scratch, thr one f32 (the IoU
// threshold, as the TPU kernel's thr_ref, read by the bits pass at run time so
// that a captured CUDA graph takes the value current at each replay); all on
// the current device, contiguous. Returns the cudaError_t of the launches.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, void* keep, void* bits, int B, int K,
                               const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = nms_walk::bits_stride(K);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps);
  iou_bits_kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
                                                static_cast<uint32_t*>(bits), K, W,
                                                static_cast<const float*>(thr));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_walk::launch_greedy_walk(static_cast<const uint32_t*>(bits),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint8_t*>(keep), B, K, s));
}
