// Greedy probIoU-NMS keep mask over score-sorted, class-offset oriented boxes
// (kernel C).
//
// Replaces: rotated_nms_keep_pallas (yolo_infer_tpu/ops/pallas/nms_fused.py),
// the TPU kernel that evaluates each image's (K, K) probIoU matrix in VMEM
// from the candidates' Gaussian terms and sweeps the greedy fixpoint.
//
// What bounds it on the H100: operations. Each pair costs ~38 f32 operations
// of which a log, an exp, two square roots and two divisions run as
// multi-instruction sequences: ~10^9 instructions at K = 1024, B = 16, all
// valid (523,776 pairs per image). Bytes are negligible (20 B of terms and
// 1 B of flag in, 1 B out per candidate). Then the walk, serial in the
// candidate rank: about K dependent steps per image, B images at once.
//
// Design: two launches, kernel G's shape (greedy_nms.cu), for any K <= 8192.
//   Bits: a grid over (image, row pairs), one warp per pair of candidate rows
//   p and E-1-p, so every warp takes E-1 columns and the blocks finish
//   together over the triangle (E is one past the image's last valid
//   candidate, found by each block from the flags). The lanes take 32
//   consecutive columns j, compute probIoU(i, j) in place (never stored), and
//   __ballot_sync packs `> thr` into bit j%32 of word j/32 of row i. The
//   column terms (x, y, a, b, c and the clamped determinant) and flags are
//   staged in shared memory in chunks of 512 columns (12.5 KB: several blocks
//   fit on an SM). A pair with j <= i, j >= E or an invalid j is written 0
//   without the probIoU, and an invalid row is all 0: it is never kept, so
//   never ORed in, and its own bit is never consulted, so the keep mask is
//   exact. With the valid candidates a prefix of V (serving: scores sorted,
//   valid = score > 0) the work is V^2/2 pairs, on every SM. The (B, K,
//   ceil(K/32)) uint32 mask is 2 MB at B = 16, K = 1024; 128 MB at K = 8192.
//   Walk: nms_walk.cuh's, the one kernel G launches: for K <= 1024 the
//   whole mask resident in shared memory and walked without a sync (the
//   OBB serving pool), above that staged in 32-row strips.
// The mask must equal the plain version's (ops/nms.py _nms_fixpoint over
// ops/rotated.py probiou_gauss_matrix on the card) bit for bit, so the
// probIoU is written in _probiou_from_terms's order with every operation
// explicitly rounded (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: what
// PyTorch's elementwise kernels compute one operation at a time), row i is
// argument 1, the log and exp are the CUDA math library's logf and expf that
// torch.log and torch.exp call (never __logf / __expf), the clamps pass NaN
// through as torch.clamp does, and the file is built with --fmad=false.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "nms_walk.cuh"

namespace {

constexpr int kBitsWarps = 4;
constexpr int kBitsThreads = kBitsWarps * 32;
constexpr int kChunk = 512;  // columns staged at a time (a multiple of 32)
constexpr float kEps = 1e-7f;

// torch.clamp keeps a NaN where fmaxf / fminf would drop it
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }

__device__ __forceinline__ float clamped_det(float a, float b, float c) {
  return clamp_min(__fsub_rn(__fmul_rn(a, b), __fmul_rn(c, c)), kEps);
}

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

__global__ void __launch_bounds__(kBitsThreads)
probiou_bits_kernel(const float* __restrict__ gauss, const uint8_t* __restrict__ valid,
                    uint32_t* __restrict__ bits, int K, int W, float thr) {
  __shared__ float sx[kChunk], sy[kChunk], sa[kChunk], sb[kChunk], sc[kChunk], sdet[kChunk];
  __shared__ uint8_t sval[kChunk];
  __shared__ int s_end;

  const int img = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const float* g = gauss + static_cast<size_t>(img) * K * 5;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  uint32_t* out = bits + static_cast<size_t>(img) * K * W;

  // E: one past the image's last valid candidate
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < K; i += kBitsThreads)
    if (vb[i]) last = i + 1;
  last = __reduce_max_sync(0xffffffffu, last);
  if (lane == 0) atomicMax(&s_end, last);
  __syncthreads();
  const int E = s_end;
  const int pairs = (E + 1) >> 1;
  const int p0 = blockIdx.y * kBitsWarps;
  if (p0 >= pairs) return;  // the whole block: E is the same for all its threads
  const int We = (E + 31) >> 5;

  // this warp's rows: p and E-1-p (one row where they meet, none past the pairs)
  const int p = p0 + (threadIdx.x >> 5);
  int rows[2] = {p < pairs ? p : -1, (p < pairs && E - 1 - p != p) ? E - 1 - p : -1};
  float rx[2], ry[2], ra[2], rb[2], rc[2], rdet[2];
  bool rvalid[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int r = rows[s] < 0 ? 0 : rows[s];
    rx[s] = g[r * 5];
    ry[s] = g[r * 5 + 1];
    ra[s] = g[r * 5 + 2];
    rb[s] = g[r * 5 + 3];
    rc[s] = g[r * 5 + 4];
    rdet[s] = clamped_det(ra[s], rb[s], rc[s]);
    rvalid[s] = rows[s] >= 0 && vb[r];
  }

  // columns from the block's first row's word on, in chunks
  for (int cs = (p0 >> 5) << 5; cs < E; cs += kChunk) {
    const int ce = min(cs + kChunk, E);
    __syncthreads();  // the previous chunk is no longer read
    for (int t = threadIdx.x; t < ce - cs; t += kBitsThreads) {
      const float* gj = g + static_cast<size_t>(cs + t) * 5;
      const float a = gj[2], b = gj[3], c = gj[4];
      sx[t] = gj[0];
      sy[t] = gj[1];
      sa[t] = a;
      sb[t] = b;
      sc[t] = c;
      sdet[t] = clamped_det(a, b, c);
      sval[t] = vb[cs + t];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int r = rows[s];
      if (r < 0) continue;  // the same for the whole warp
      const int wend = min(We, (ce + 31) >> 5);
      for (int w = max(r >> 5, cs >> 5); w < wend; ++w) {
        const int j = (w << 5) + lane;
        bool hit = false;
        if (rvalid[s] && j > r && j < E && sval[j - cs]) {
          const int t = j - cs;
          hit = probiou(rx[s], ry[s], ra[s], rb[s], rc[s], rdet[s], sx[t], sy[t], sa[t], sb[t], sc[t], sdet[t]) > thr;
        }
        const uint32_t word = __ballot_sync(0xffffffffu, hit);
        if (lane == 0) out[static_cast<size_t>(r) * W + w] = word;
      }
    }
  }
}

}  // namespace

// gauss (B, K, 5) f32 [x, y, a, b, c], valid (B, K) bool, keep (B, K) bool,
// bits (B, K, ceil(K/32)) uint32 scratch; all contiguous on the current
// device. Returns the cudaError_t of the launches.
extern "C" int rotated_nms_keep_launch(const void* gauss, const void* valid, void* keep, void* bits, int B, int K,
                                       float thr, void* stream) {
  if (B < 1 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps);
  probiou_bits_kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float*>(gauss),
                                                    static_cast<const uint8_t*>(valid),
                                                    static_cast<uint32_t*>(bits), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_walk::launch_greedy_walk(static_cast<const uint32_t*>(bits),
                                                        static_cast<const uint8_t*>(valid),
                                                        static_cast<uint8_t*>(keep), B, K, s));
}
