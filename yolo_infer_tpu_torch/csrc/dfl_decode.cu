// DFL softmax expectation over the full anchor grid (kernel F).
//
// Replaces: dfl_decode_pallas (yolo_infer_tpu/ops/pallas/dfl_kernel.py), the
// TPU kernel that maps (B, A, 4 * reg_max) distribution logits to the f32
// expectation of each side, with the softmax and the bin dot fused in VMEM.
//
// What bounds it on the H100: bytes. Each logit is read once (64 per anchor
// row, 2 bytes in bf16 or 4 in f32) and 16 bytes are written per row; the
// ~10 operations per logit (max, subtraction, exp, product, two sums) are far
// below the card's rate. At the val batch, (16, 8400, 64) bf16, that is
// 17.2 MB in and 2.15 MB out: ~6 us at 3.35 TB/s.
//
// Design: 16 lanes per anchor row, two rows per warp. Lane q of a row reads
// the 4 consecutive logits 4q..4q+3 (bins 4(q%4).. of side q/4) and converts
// them to f32; two __shfl_xor_sync steps inside each aligned 4-lane group
// give the side's max, then its sums of e = exp(x - max) and of e * bin; the
// group's first lane divides once and writes. Neighbouring lanes read
// neighbouring logits, so a row is one coalesced read. Rows are addressed
// through (batch, row) strides, so the (B, A, 64) slice of the decode's
// (B, A, 64 + nc) head slab is read in place, with no contiguous copy. The
// formula is the TPU kernel's, sum(e * bin) / sum(e); the plain version
// (ops/kernels/dfl_decode.py dfl_decode_reference) sums in another order,
// which moves the result by ~1e-6 of a bin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegMax = 16;
constexpr int kLanesPerRow = 16;  // 4 sides x 4 lanes, 4 logits per lane
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
static_assert(kLanesPerRow * 4 == 4 * kRegMax, "one lane per 4 logits of a row");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
dfl_decode_kernel(const T* __restrict__ x, float* __restrict__ out, long long rows, long long A,
                  long long stride_b, long long stride_a) {
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  const int q = threadIdx.x % kLanesPerRow;
  // every lane takes part in the shuffles; a lane past the last row reads nothing
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

}  // namespace

// x: (B, A, 64) logits, f32 (dtype 0) or bf16 (dtype 1), last dim contiguous,
// element strides stride_b and stride_a; out: (B, A, 4) f32, contiguous. All
// on the current device. Returns the cudaError_t of the launch.
extern "C" int dfl_decode_launch(const void* x, void* out, int dtype, long long B, long long A,
                                 long long stride_b, long long stride_a, void* stream) {
  if (B < 1 || A < 1 || (dtype != 0 && dtype != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = B * A;
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dfl_decode_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), rows, A, stride_b, stride_a);
  } else {
    dfl_decode_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), rows, A, stride_b, stride_a);
  }
  return static_cast<int>(cudaGetLastError());
}
