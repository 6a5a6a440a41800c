// Kernel G's earlier designs, for tests/torch_kernel_breakdown.py: each entry
// computes the same keep mask as csrc/greedy_nms.cu (held to the plain
// version in the breakdown) and takes the same arguments as
// greedy_nms_launch. Built with kernel G's flags and
// -I yolo_infer_tpu_torch/csrc.
//
//   greedy_nms_two_buffer_walk_launch  this G's bits pass, then the earlier
//       strip-staged walk for K > 1024 (resident_walk.cuh's below): warp 0 walks strip w
//       while the other warps stage strip w+1 (words from its own on) into
//       the second of two shared-memory buffers with 4-byte cp.async, a
//       cp.async.wait_all and a __syncthreads per strip; warp 0 ORs every
//       kept row's words into a removed set of up to 8 words per lane
//   greedy_nms_scalar_bits_launch  the earlier bits pass (one warp per row,
//       4-byte loads, 4 words in flight per lane, every word of every row
//       written, zeros below the diagonal and for invalid rows), then the
//       two-buffer walk
//   greedy_nms_ring_bulk_launch, greedy_nms_ring_bulk_single_or_launch,
//   greedy_nms_ring_cp_async_launch  this G's bits pass, then for K > 1024
//       the ring-staged walk of ring_walk.cuh (resident_walk.cuh's below): whole strips staged by one
//       cp.async.bulk per row, the kept rows ORed by the helper warps out of
//       the staged strip; the same with warp 0 ORing every word itself; the
//       same staged by 16-byte cp.async

#include "greedy_nms.cu"
#include "resident_walk.cuh"
#include "ring_walk.cuh"

namespace {

constexpr int kScalarUnroll = 4;

__global__ void __launch_bounds__(256)
scalar_bits_kernel(const float* __restrict__ iou, const uint8_t* __restrict__ valid, uint32_t* __restrict__ bits,
                int K, int W, const float* __restrict__ thr_ptr) {
  const float thr = __ldg(thr_ptr);
  const int img = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * 8 + (threadIdx.x >> 5);
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
  for (int w0 = wfirst; w0 < W; w0 += kScalarUnroll) {
    float x[kScalarUnroll];
#pragma unroll
    for (int u = 0; u < kScalarUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      x[u] = (j > i && j < K) ? row[j] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kScalarUnroll; ++u) {
      const int j = (w0 + u) * 32 + lane;
      const uint32_t word = __ballot_sync(0xffffffffu, j > i && j < K && x[u] > thr);
      if (lane == 0 && w0 + u < W) out[w0 + u] = word;
    }
  }
}

__global__ void __launch_bounds__(nms_walk::kWalkThreads)
two_buffer_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
                int K, int W) {
  using namespace nms_walk;
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* strips = reinterpret_cast<uint32_t*>(smem);           // 2 x 32 rows x W words
  uint8_t* svalid = reinterpret_cast<uint8_t*>(strips + 64 * W);  // K flags

  const int img = blockIdx.x;
  const uint32_t* mb = bits + static_cast<size_t>(img) * K * W;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  const int E = stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);
  const int We = (E + 31) >> 5;
  if (We == 0) return;
  stage_strip(mb, strips, 0, min(32, E), 0, We, W, threadIdx.x >> 5, kWalkThreads / 32);
  cp_async_wait_all();
  __syncthreads();

  const int wpl = (We + 31) >> 5;
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

int two_buffer_walk(const void* bits, const void* valid, void* keep, int B, int K, cudaStream_t s) {
  const int W = nms_walk::bits_stride(K);
  if (K <= kNmsMaxK)
    return static_cast<int>(nms_walk::launch_resident_walk(static_cast<const uint32_t*>(bits),
                                                          static_cast<const uint8_t*>(valid),
                                                          static_cast<uint8_t*>(keep), B, K, s));
  const size_t smem = static_cast<size_t>(64) * W * sizeof(uint32_t) + K;
  cudaError_t err =
      cudaFuncSetAttribute(two_buffer_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  two_buffer_walk_kernel<<<B, nms_walk::kWalkThreads, smem, s>>>(static_cast<const uint32_t*>(bits),
                                                          static_cast<const uint8_t*>(valid),
                                                          static_cast<uint8_t*>(keep), K, W);
  return static_cast<int>(cudaGetLastError());
}

// this G's bits pass, as greedy_nms_launch runs it
cudaError_t g_bits(const void* iou, const void* valid, void* bits, int B, int K, const void* thr, cudaStream_t s) {
  const dim3 grid(B, ((K + 1) / 2 + kBitsWarps - 1) / kBitsWarps);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(iou) % 16 == 0;
  const auto kernel = vec ? suppression_bits_kernel<true> : suppression_bits_kernel<false>;
  kernel<<<grid, kBitsThreads, 0, s>>>(static_cast<const float*>(iou), static_cast<const uint8_t*>(valid),
                                       static_cast<uint32_t*>(bits), K, nms_walk::bits_stride(K), static_cast<const float*>(thr));
  return cudaGetLastError();
}

template <bool kSplit, bool kBulkStage>
int ring_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K, const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = g_bits(iou, valid, bits, B, K, thr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto b = static_cast<const uint32_t*>(bits);
  const auto v = static_cast<const uint8_t*>(valid);
  const auto k = static_cast<uint8_t*>(keep);
  if (K <= kNmsMaxK) return static_cast<int>(nms_walk::launch_resident_walk(b, v, k, B, K, s));
  return static_cast<int>(ring_walk::launch_ring_walk<kSplit, kBulkStage>(b, v, k, B, K, s));
}

}  // namespace

extern "C" int greedy_nms_two_buffer_walk_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                          const void* thr, void* stream) {
  if (B < 1 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = g_bits(iou, valid, bits, B, K, thr, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return two_buffer_walk(bits, valid, keep, B, K, s);
}

extern "C" int greedy_nms_ring_bulk_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                           const void* thr, void* stream) {
  return ring_launch<true, true>(iou, valid, keep, bits, B, K, thr, stream);
}

extern "C" int greedy_nms_ring_bulk_single_or_launch(const void* iou, const void* valid, void* keep, void* bits, int B,
                                                     int K, const void* thr, void* stream) {
  return ring_launch<false, true>(iou, valid, keep, bits, B, K, thr, stream);
}

extern "C" int greedy_nms_ring_cp_async_launch(const void* iou, const void* valid, void* keep, void* bits, int B,
                                               int K, const void* thr, void* stream) {
  return ring_launch<true, false>(iou, valid, keep, bits, B, K, thr, stream);
}

extern "C" int greedy_nms_scalar_bits_launch(const void* iou, const void* valid, void* keep, void* bits, int B, int K,
                                     const void* thr, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || K > nms_walk::kWalkMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  scalar_bits_kernel<<<dim3((K + 7) / 8, B), 256, 0, s>>>(static_cast<const float*>(iou),
                                                      static_cast<const uint8_t*>(valid),
                                                      static_cast<uint32_t*>(bits), K, nms_walk::bits_stride(K), static_cast<const float*>(thr));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return two_buffer_walk(bits, valid, keep, B, K, s);
}
