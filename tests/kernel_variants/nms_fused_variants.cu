// Kernel A's one-block design, for tests/torch_kernel_breakdown.py: it
// computes the same keep mask as csrc/nms_fused.cu (held to the plain version
// in the breakdown) and takes the same arguments as nms_keep_launch. Built
// with kernel A's flags and -I yolo_infer_tpu_torch/csrc. K <= 1024 only.
//
//   nms_keep_one_block_launch  one block per image: 256 threads form the
//       image's whole IoU bitmask in shared memory (a thread per (row, word),
//       a division where boxes meet), then warp 0 runs greedy_keep_walk; the
//       bits scratch is not used
//   nms_keep_resident_walk_launch  this kernel A's bits pass, then the
//       resident walk of resident_walk.cuh (the port's walk up to K = 1024
//       before the strip-staged walk took every K)

#include "nms_fused.cu"
#include "keep_walk.cuh"
#include "resident_walk.cuh"

namespace {

constexpr int kOneBlockThreads = 256;

__device__ __forceinline__ float one_block_area(const float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(kOneBlockThreads)
one_block_kernel(const float4* __restrict__ boxes, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int K, const float* __restrict__ thr_ptr) {
  const float thr = __ldg(thr_ptr);
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  float4* sbox = reinterpret_cast<float4*>(smem);              // K boxes
  float* sarea = reinterpret_cast<float*>(sbox + K);           // K areas
  uint32_t* mask = reinterpret_cast<uint32_t*>(sarea + K);     // K x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + K * W);  // K flags

  const int img = blockIdx.x;
  const float4* bx = boxes + static_cast<size_t>(img) * K;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += kOneBlockThreads) {
    const float4 b = bx[i];
    sbox[i] = b;
    sarea[i] = one_block_area(b);
    svalid[i] = vb[i];
  }
  __syncthreads();

  // an empty intersection gives iou = 0 / (area_i + area_j + eps) = +0 for
  // finite boxes, so the division is needed only where boxes meet
  const bool zero_suppresses = 0.f > thr;
  // consecutive threads take consecutive rows i of one word column w
  for (int idx = threadIdx.x; idx < K * W; idx += kOneBlockThreads) {
    const int w = idx / K;
    const int i = idx - w * K;
    const int j0 = w << 5;
    uint32_t word = 0;
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
        if (sup) word |= 1u << (j - j0);
      }
    }
    mask[i * W + w] = word;
  }
  __syncthreads();

  if (threadIdx.x < 32) greedy_keep_walk(mask, svalid, keep + static_cast<size_t>(img) * K, K, W);
}

}  // namespace

extern "C" int nms_keep_one_block_launch(const void* boxes, const void* valid, void* keep, void*, int B, int K,
                                         const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * (sizeof(float4) + sizeof(float)) +
                      static_cast<size_t>(K) * W * sizeof(uint32_t) + K;
  cudaError_t err =
      cudaFuncSetAttribute(one_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  one_block_kernel<<<B, kOneBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K, static_cast<const float*>(thr));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int nms_keep_resident_walk_launch(const void* boxes, const void* valid, void* keep, void* bits, int B,
                                             int K, const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  iou_bits_kernel<<<dim3(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps), kBitsThreads, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(bits), K,
      nms_walk::bits_stride(K), static_cast<const float*>(thr));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(nms_walk::launch_resident_walk(static_cast<const uint32_t*>(bits),
                                                          static_cast<const uint8_t*>(valid),
                                                          static_cast<uint8_t*>(keep), B, K, s));
}
