// Other designs of kernel F, for tests/torch_kernel_breakdown.py: each
// computes what csrc/dfl_decode.cu computes (held to the plain version in the
// breakdown) and takes the same arguments as dfl_decode_launch. Built with
// kernel F's flags and -I yolo_infer_tpu_torch/csrc.
//
//   dfl_decode_rows2_launch, dfl_decode_rows4_launch  the port's kernel with
//       2 or 4 rows a thread (kRowsPerSlot rows apart, so a warp's loads of
//       one slot cover consecutive rows), every row's loads issued before any
//       arithmetic: more bytes in flight per thread, fewer threads
//   dfl_decode_lanes16_launch  kernel F as it was first ported: 16 lanes per
//       anchor row, 4 logits a lane read as four scalar loads, the image found
//       by a 64-bit row / A in every thread, a full-precision expf per logit,
//       two __shfl_xor_sync steps per reduction, and one 4-byte store per side

#include "dfl_decode.cu"

namespace multirow {

constexpr int kRowsPerSlot = kThreads / kLanesPerRow;

template <typename T, int kVec, int kRows>
__device__ __forceinline__ void decode_rows(const T* __restrict__ x, float4* __restrict__ out, int A,
                                            long long stride_b, long long stride_a) {
  constexpr int kWords = kLogitsPerLane * static_cast<int>(sizeof(T)) / 4;
  const int q = threadIdx.x % kLanesPerRow;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kRowsPerSlot * kRows + threadIdx.x / kLanesPerRow;
  uint32_t w[kRows][kWords] = {};
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int a = a0 + r * kRowsPerSlot;
    if (a < A)
      load_words<kVec>(reinterpret_cast<const unsigned char*>(x + b * stride_b + a * stride_a) +
                           q * kLogitsPerLane * sizeof(T),
                       w[r]);
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const float side = side_expectation<T>(w[r], q);
    const float s1 = __shfl_sync(0xffffffffu, side, 2, kLanesPerRow);
    const float s2 = __shfl_sync(0xffffffffu, side, 4, kLanesPerRow);
    const float s3 = __shfl_sync(0xffffffffu, side, 6, kLanesPerRow);
    const int a = a0 + r * kRowsPerSlot;
    if (q == 0 && a < A) out[static_cast<long long>(b) * A + a] = make_float4(side, s1, s2, s3);
  }
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
rows2_dfl_decode_kernel(const T* __restrict__ x, float4* __restrict__ out, int A, long long stride_b,
                        long long stride_a) {
  decode_rows<T, kVec, 2>(x, out, A, stride_b, stride_a);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
rows4_dfl_decode_kernel(const T* __restrict__ x, float4* __restrict__ out, int A, long long stride_b,
                        long long stride_a) {
  decode_rows<T, kVec, 4>(x, out, A, stride_b, stride_a);
}

template <typename T, int kRows, int kVec>
void launch_vec(dim3 grid, cudaStream_t s, const T* x, float4* out, int A, long long stride_b, long long stride_a) {
  if constexpr (kRows == 2)
    rows2_dfl_decode_kernel<T, kVec><<<grid, kThreads, 0, s>>>(x, out, A, stride_b, stride_a);
  else
    rows4_dfl_decode_kernel<T, kVec><<<grid, kThreads, 0, s>>>(x, out, A, stride_b, stride_a);
}

template <typename T, int kRows>
cudaError_t launch(const void* x, void* out, int B, int A, long long stride_b, long long stride_a,
                   cudaStream_t s) {
  const int rows_per_block = kRowsPerSlot * kRows;
  const dim3 grid((A + rows_per_block - 1) / rows_per_block, B);
  const T* xt = static_cast<const T*>(x);
  float4* o = static_cast<float4*>(out);
  switch (vector_bytes(x, sizeof(T), stride_b, stride_a)) {
    case 16:
      launch_vec<T, kRows, 16>(grid, s, xt, o, A, stride_b, stride_a);
      break;
    case 8:
      launch_vec<T, kRows, 8>(grid, s, xt, o, A, stride_b, stride_a);
      break;
    case 4:
      launch_vec<T, kRows, 4>(grid, s, xt, o, A, stride_b, stride_a);
      break;
    default:
      if constexpr (sizeof(T) == 2) {
        launch_vec<T, kRows, 2>(grid, s, xt, o, A, stride_b, stride_a);
        break;
      } else {
        return cudaErrorMisalignedAddress;
      }
  }
  return cudaGetLastError();
}

template <int kRows>
int launch_rows(const void* x, void* out, int dtype, long long B, long long A, long long stride_b,
                long long stride_a, void* stream) {
  if (B < 1 || A < 1 || (dtype != 0 && dtype != 1) || B > kMaxGridY || A > 0x7fffffffLL - kThreads ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float, kRows>(x, out, static_cast<int>(B), static_cast<int>(A), stride_b, stride_a, s)
                 : launch<__nv_bfloat16, kRows>(x, out, static_cast<int>(B), static_cast<int>(A), stride_b,
                                                stride_a, s);
  return static_cast<int>(err);
}

}  // namespace multirow

extern "C" int dfl_decode_rows2_launch(const void* x, void* out, int dtype, long long B, long long A,
                                       long long stride_b, long long stride_a, void* stream) {
  return multirow::launch_rows<2>(x, out, dtype, B, A, stride_b, stride_a, stream);
}

extern "C" int dfl_decode_rows4_launch(const void* x, void* out, int dtype, long long B, long long A,
                                       long long stride_b, long long stride_a, void* stream) {
  return multirow::launch_rows<4>(x, out, dtype, B, A, stride_b, stride_a, stream);
}

namespace lanes16 {

constexpr int kThreads = 256;
constexpr int kLanesPerRow = 16;  // 4 sides x 4 lanes, 4 logits per lane
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
lanes16_dfl_decode_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows, long long A,
                          long long stride_b, long long stride_a) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int q = threadIdx.x % kLanesPerRow;
  const bool live = row < rows;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const long long b = row / A;
    const T* src = x + b * stride_b + (row - b * A) * stride_a + q * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = to_f32(src[k]);
  }
  float m = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  const float bin0 = static_cast<float>((q & 3) * 4);
  float se = 0.f, sb = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float e = expf(v[k] - m);
    se += e;
    sb += e * (bin0 + static_cast<float>(k));
  }
  se += __shfl_xor_sync(0xffffffffu, se, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  se += __shfl_xor_sync(0xffffffffu, se, 2);
  sb += __shfl_xor_sync(0xffffffffu, sb, 2);
  if (live && (q & 3) == 0) out[row * 4 + q / 4] = sb / se;
}

}  // namespace lanes16

extern "C" int dfl_decode_lanes16_launch(const void* x, void* out, int dtype, long long B, long long A,
                                         long long stride_b, long long stride_a, void* stream) {
  if (B < 1 || A < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = B * A;
  const long long blocks = (rows + lanes16::kRowsPerBlock - 1) / lanes16::kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    lanes16::lanes16_dfl_decode_kernel<float><<<static_cast<unsigned>(blocks), lanes16::kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, A, stride_b, stride_a);
  } else {
    lanes16::lanes16_dfl_decode_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), lanes16::kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), rows, A, stride_b, stride_a);
  }
  return static_cast<int>(cudaGetLastError());
}
