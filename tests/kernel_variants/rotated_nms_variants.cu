// Alternative designs of kernel C for tests/torch_kernel_breakdown.py: each
// computes the same keep mask as csrc/rotated_nms_fused.cu (held to the plain
// version in the breakdown) and takes the same arguments as
// rotated_nms_keep_launch. Built with kernel C's flags and
// -I yolo_infer_tpu_torch/csrc. Both take K <= 1024 only.
//
//   rotated_nms_one_block_launch  the one-block-per-image kernel C replaced:
//       512 threads form the image's whole probIoU bitmask in shared memory
//       (a thread per (row, word)), then warp 0 runs greedy_keep_walk; the
//       bits scratch is not used
//   rotated_nms_keep_walk_launch  this kernel C's bits pass, then one block
//       per image stages the mask into shared memory as the resident walk
//       does and warp 0 runs greedy_keep_walk over it (a shared-memory load
//       chain per candidate, in place of the register chain of walk_strip)

#include "rotated_nms_fused.cu"

namespace {

constexpr int kOneBlockThreads = 512;

__global__ void __launch_bounds__(kOneBlockThreads)
one_block_kernel(const float* __restrict__ gauss, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int K, float thr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = (K + 31) >> 5;
  float* sx = reinterpret_cast<float*>(smem);  // 6 x K terms
  float* sy = sx + K;
  float* sa = sy + K;
  float* sb = sa + K;
  float* sc = sb + K;
  float* sdet = sc + K;
  uint32_t* mask = reinterpret_cast<uint32_t*>(sdet + K);      // K x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + K * W);  // K flags

  const int img = blockIdx.x;
  const float* g = gauss + static_cast<size_t>(img) * K * 5;
  const uint8_t* vb = valid + static_cast<size_t>(img) * K;
  for (int i = threadIdx.x; i < K; i += kOneBlockThreads) {
    const float a = g[i * 5 + 2], b = g[i * 5 + 3], c = g[i * 5 + 4];
    sx[i] = g[i * 5];
    sy[i] = g[i * 5 + 1];
    sa[i] = a;
    sb[i] = b;
    sc[i] = c;
    sdet[i] = clamped_det(a, b, c);
    svalid[i] = vb[i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < K * W; idx += kOneBlockThreads) {
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

__global__ void __launch_bounds__(nms_walk::kWalkThreads)
keep_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                 int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem);
  uint8_t* svalid = reinterpret_cast<uint8_t*>(mask + 32 * W * W);

  const int img = blockIdx.x;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  const int E = nms_walk::stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);
  const int We = (E + 31) >> 5;
  for (int i = E + threadIdx.x; i < K; i += blockDim.x) kb[i] = 0;  // greedy_keep_walk writes below E only
  if (We == 0) return;
  nms_walk::stage_strip(bits + static_cast<size_t>(img) * K * W, mask, 0, E, 0, We, W, threadIdx.x >> 5,
                        nms_walk::kWalkThreads / 32);
  nms_walk::cp_async_wait_all();
  __syncthreads();
  if (threadIdx.x < 32) greedy_keep_walk(mask, svalid, kb, E, W);
}

}  // namespace

extern "C" int rotated_nms_one_block_launch(const void* gauss, const void* valid, void* keep, void*, int B, int K,
                                            float thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  const size_t smem = static_cast<size_t>(K) * 6 * sizeof(float) + static_cast<size_t>(K) * W * sizeof(uint32_t) + K;
  cudaError_t err =
      cudaFuncSetAttribute(one_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  one_block_kernel<<<B, kOneBlockThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gauss), static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep), K, thr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rotated_nms_keep_walk_launch(const void* gauss, const void* valid, void* keep, void* bits, int B,
                                            int K, float thr, void* stream) {
  if (B < 1 || K < 1 || K > kNmsMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int W = (K + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  probiou_bits_kernel<<<dim3(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps), kBitsThreads, 0, s>>>(
      static_cast<const float*>(gauss), static_cast<const uint8_t*>(valid), static_cast<uint32_t*>(bits), K, W, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(32) * W * W * sizeof(uint32_t) + K;
  err = cudaFuncSetAttribute(keep_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  keep_walk_kernel<<<B, nms_walk::kWalkThreads, smem, s>>>(static_cast<const uint32_t*>(bits),
                                                          static_cast<const uint8_t*>(valid),
                                                          static_cast<uint8_t*>(keep), K, W);
  return static_cast<int>(cudaGetLastError());
}
