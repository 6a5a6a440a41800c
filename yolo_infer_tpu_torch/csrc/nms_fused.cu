// Greedy-NMS keep mask over score-sorted, class-offset candidates.
//
// Replaces: nms_keep_pallas (yolo_infer_tpu/ops/pallas/nms_fused.py), the TPU
// kernel that builds each image's (K, K) IoU in VMEM and sweeps the greedy
// fixpoint to stability.
//
// What bounds it on the H100: not bytes (16 B of box and 1 B of flag in, 1 B
// out per candidate) and not arithmetic (K^2/2 IoUs, ~74 k at K = 384), but
// the greedy walk, which is serial in the candidate rank.
//
// Design: one block per image, any K <= 1024.
//   Phase 1: all threads build the strictly upper-triangular suppression
//   bitmask in shared memory, K rows of ceil(K/32) 32-bit words (bit j of row
//   i: i < j and iou(i, j) > thr). 18 KB at K = 384, 128 KB at K = 1024, so
//   the launch asks for dynamic shared memory above 48 KB.
//   Phase 2: one warp walks i = 0..K-1 (nms_walk.cuh, shared with kernel C).
//   Lane w holds word w of the removed set (K <= 1024 means at most 32
//   words); candidate i is kept when it is valid and not removed, and then
//   its row is ORed into the removed set. Every lane carries a copy of the
//   word under the walk, so a decision costs a bit test and two ORs, not a
//   shuffle.
// Sequential greedy is the fixpoint's limit, so the mask is bit-identical to
// the plain version (ops/nms.py _nms_fixpoint over ops/iou.py
// box_iou_matrix) as long as every IoU rounds the same way: the IoU is
// written with explicitly rounded operations in box_iou_matrix's order,
// inter / (area_i + area_j - inter + eps), and the file is built with
// --fmad=false so nothing is contracted into an FMA.

#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_walk.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float box_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(kThreads)
nms_keep_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  float4* sbox = reinterpret_cast<float4*>(smem);             // K boxes
  float* sarea = reinterpret_cast<float*>(sbox + K);          // K areas
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + K);    // K x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + K * W); // K flags

  const int img = blockIdx.x;
  const float4* bx = boxes + static_cast<size_t>(img) * K;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float4 b = bx[i];
    sbox[i] = b;
    sarea[i] = box_area(b);
    svalid[i] = vb[i];
  }
  __syncthreads();

  // an empty intersection gives iou = 0 / (area_i + area_j + eps) = +0 exactly
  // (areas are >= 0), so the division is needed only where boxes meet
  const bool zero_suppresses = 0.f > thr;
  // consecutive threads take consecutive rows i of one word column w, so a
  // warp reads the same box j at each step (a broadcast, not a bank conflict)
  for (int idx = threadIdx.x; idx < K * W; idx += kThreads) {
    const int w = idx / K;
    const int i = idx - w * K;
    const int j0 = w << 5;
    uint32_t bits = 0;
    if (j0 + 31 > i) {  // the word holds some j > i
      const float4 a = sbox[i];
      const float area_a = sarea[i];
      const int jend = min(j0 + 32, K);
      for (int j = max(j0, i + 1); j < jend; ++j) {
        const float4 c = sbox[j];
        const float iw = fmaxf(__fsub_rn(fminf(a.z, c.z), fmaxf(a.x, c.x)), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(a.w, c.w), fmaxf(a.y, c.y)), 0.f);
        const float inter = __fmul_rn(iw, ih);
        bool sup = zero_suppresses;
        if (inter != 0.f) {
          const float uni = __fsub_rn(__fadd_rn(area_a, sarea[j]), inter);
          sup = __fdiv_rn(inter, __fadd_rn(uni, 1e-7f)) > thr;
        }
        if (sup) bits |= 1u << (j - j0);
      }
    }
    mask[i * W + w] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) greedy_keep_walk(mask, svalid, keep + static_cast<size_t>(img) * K, K, W);
}

}  // namespace

// boxes (B, K, 4) f32, valid (B, K) bool, keep (B, K) bool; all contiguous on
// the current device. Returns the cudaError_t of the launch.
extern "C" int nms_keep_launch(const void* boxes, const void* valid, void* keep, int B, int K,
                               float thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * (sizeof(float4) + sizeof(float)) +
                      static_cast<size_t>(K) * W * sizeof(uint32_t) + K;
  cudaError_t err = cudaFuncSetAttribute(nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}
