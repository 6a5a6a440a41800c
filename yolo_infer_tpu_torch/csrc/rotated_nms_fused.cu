// Greedy probIoU-NMS keep mask over score-sorted, class-offset oriented boxes.
//
// Replaces: rotated_nms_keep_pallas (yolo_infer_tpu/ops/pallas/nms_fused.py),
// the TPU kernel that evaluates each image's (K, K) probIoU matrix in VMEM
// from the candidates' Gaussian terms and sweeps the greedy fixpoint.
//
// What bounds it on the H100: operations, and how few SMs hold them. Each
// pair costs ~38 f32 operations of which a log, an exp, two square roots and
// two divisions run as multi-instruction sequences; at K = 1024 an image has
// 523,776 pairs. Bytes are negligible (20 B of terms and 1 B of flag in, 1 B
// out per candidate). One block per image means only B of the 132 SMs work
// (16 at OBB serving batch 16); the walk is serial in the candidate rank.
//
// Design: one block per image, any K <= 1024, as kernel A (nms_fused.cu).
//   Phase 0: the Gaussian terms (x, y, a, b, c) go to shared memory as five
//   arrays, with each candidate's clamped determinant max(ab - c^2, eps).
//   Phase 1: the strictly upper-triangular suppression bitmask, K rows of
//   ceil(K/32) words (128 KB at K = 1024, plus 24 KB of terms: the launch
//   asks for dynamic shared memory above 48 KB). Consecutive threads take
//   consecutive rows of one word column, so a warp reads the same j at each
//   step (a broadcast).
//   Phase 2: one warp walks the candidates (nms_walk.cuh).
// The mask must equal the plain version's (ops/nms.py _nms_fixpoint over
// ops/rotated.py probiou_gauss_matrix on the card) bit for bit, so the
// probIoU is written in _probiou_from_terms's order with every operation
// explicitly rounded (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: what
// PyTorch's elementwise kernels compute one operation at a time), the log and
// exp are the CUDA math library's logf and expf that torch.log and torch.exp
// call (never __logf / __expf), the clamps pass NaN through as torch.clamp
// does, and the file is built with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_walk.cuh"

namespace {

constexpr int kThreads = 512;
constexpr float kEps = 1e-7f;

// torch.clamp keeps a NaN where fmaxf / fminf would drop it
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }

// 1 - Hellinger distance of two Gaussians given by their terms and clamped
// determinants, in ops/rotated.py _probiou_from_terms's order
__device__ __forceinline__ float probiou(float x1, float y1, float a1, float b1, float c1, float det1,
                                         float x2, float y2, float a2, float b2, float c2, float det2) {
  const float dx = __fsub_rn(x1, x2);
  const float dy = __fsub_rn(y1, y2);
  const float sa = __fadd_rn(a1, a2);
  const float sb = __fadd_rn(b1, b2);
  const float sc = __fadd_rn(c1, c2);
  const float denom = __fadd_rn(__fsub_rn(__fmul_rn(sa, sb), __fmul_rn(sc, sc)), kEps);
  const float num = __fsub_rn(__fadd_rn(__fmul_rn(sb, __fmul_rn(dx, dx)), __fmul_rn(sa, __fmul_rn(dy, dy))),
                              __fmul_rn(__fmul_rn(__fmul_rn(2.f, sc), dx), dy));
  const float t1 = __fmul_rn(__fdiv_rn(num, denom), 0.25f);
  const float root = __fadd_rn(__fmul_rn(4.f, __fsqrt_rn(__fmul_rn(det1, det2))), kEps);
  const float t3 = __fmul_rn(logf(__fadd_rn(__fdiv_rn(denom, root), kEps)), 0.5f);
  const float bd = clamp_max(clamp_min(__fadd_rn(t1, t3), kEps), 100.f);
  const float hd = __fsqrt_rn(clamp_min(__fsub_rn(1.f, expf(-bd)), kEps));
  return __fsub_rn(1.f, hd);
}

__global__ void __launch_bounds__(kThreads)
rotated_nms_keep_kernel(const float* __restrict__ gauss, const uint8_t* __restrict__ valid,
                        uint8_t* __restrict__ keep, int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  float* sx = reinterpret_cast<float*>(smem);                 // 6 x K terms
  float* sy = sx + K;
  float* sa = sy + K;
  float* sb = sa + K;
  float* sc = sb + K;
  float* sdet = sc + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(sdet + K);     // K x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + K * W); // K flags

  const int img = blockIdx.x;
  const float* g = gauss + static_cast<size_t>(img) * K * 5;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float a = g[i * 5 + 2], b = g[i * 5 + 3], c = g[i * 5 + 4];
    sx[i] = g[i * 5];
    sy[i] = g[i * 5 + 1];
    sa[i] = a;
    sb[i] = b;
    sc[i] = c;
    sdet[i] = clamp_min(__fsub_rn(__fmul_rn(a, b), __fmul_rn(c, c)), kEps);
    svalid[i] = vb[i];
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < K * W; idx += kThreads) {
    const int w = idx / K;
    const int i = idx - w * K;
    const int j0 = w << 5;
    uint32_t bits = 0;
    if (j0 + 31 > i) {  // the word holds some j > i
      const float x1 = sx[i], y1 = sy[i], a1 = sa[i], b1 = sb[i], c1 = sc[i], d1 = sdet[i];
      const int jend = min(j0 + 32, K);
      for (int j = max(j0, i + 1); j < jend; ++j) {
        if (probiou(x1, y1, a1, b1, c1, d1, sx[j], sy[j], sa[j], sb[j], sc[j], sdet[j]) > thr) {
          bits |= 1u << (j - j0);
        }
      }
    }
    mask[i * W + w] = bits;
  }
  __syncthreads();

  if (threadIdx.x < 32) greedy_keep_walk(mask, svalid, keep + static_cast<size_t>(img) * K, K, W);
}

}  // namespace

// gauss (B, K, 5) f32 [x, y, a, b, c], valid (B, K) bool, keep (B, K) bool;
// all contiguous on the current device. Returns the cudaError_t of the launch.
extern "C" int rotated_nms_keep_launch(const void* gauss, const void* valid, void* keep, int B, int K,
                                       float thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * 6 * sizeof(float) +
                      static_cast<size_t>(K) * W * sizeof(uint32_t) + K;
  cudaError_t err = cudaFuncSetAttribute(rotated_nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rotated_nms_keep_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gauss), static_cast<const uint8_t*>(valid),
      static_cast<uint8_t*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}
