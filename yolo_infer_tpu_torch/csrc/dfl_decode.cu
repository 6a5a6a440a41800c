// DFL softmax expectation over the full anchor grid (kernel F).
//
// Replaces: dfl_decode_pallas (yolo_infer_tpu/ops/pallas/dfl_kernel.py), the
// TPU kernel that maps (B, A, 4 * reg_max) distribution logits to the f32
// expectation of each side, with the softmax and the bin dot fused in VMEM.
//
// What bounds it on the H100: bytes, as long as the instructions per logit
// stay few. Each logit is read once (64 per anchor row, 2 bytes in bf16 or 4
// in f32) and 16 bytes are written per row: at the val batch, (16, 8400, 64)
// bf16, 17.2 MB in and 2.15 MB out, ~5.8 us at 3.35 TB/s. The ~10 operations
// per logit are far below the card's rate, but a 64-bit division per thread,
// scalar loads, a full-precision expf and a shuffle per lane and step cost
// ~90 SASS instructions per logit and made the kernel issue-bound; this
// design issues ~14 and is bound by bytes when its input comes from HBM.
//
// Design: 8 lanes per anchor row, 8 consecutive logits a lane (half a side),
// so a side's max and sums need one __shfl_xor_sync each.
//   - The image is blockIdx.y (a block strides over images past the grid's
//     y limit) and the row within it a 32-bit index: no division. Rows are
//     addressed through (batch, row) strides, so the (B, A, 64) slice of the
//     decode's (B, A, 64 + nc) head slab is read in place, with no
//     contiguous copy.
//   - Loads as wide as the rows allow: the launcher takes the widest of 16,
//     8, 4 and 2 bytes that divides the base address and both strides, one
//     template instance per width (detect's 144-channel bf16 slab is 16-byte
//     aligned; OBB's 79 and pose's 65 channels, or a slice that starts one
//     channel in, are not). A lane's 16 (bf16) or 32 (f32) bytes are one to
//     sixteen loads; neighbouring lanes read neighbouring bytes. The loads
//     are evict-first (__ldcs): with L2 full of dirty lines, as an earlier
//     kernel's writes leave it, F then evicts its own lines first and writes
//     back fewer of the others.
//   - One row a thread: two and four rows a thread, their loads issued
//     before any arithmetic (tests/kernel_variants/dfl_decode_variants.cu),
//     measured slower cold at the validation path's input.
//   - exp(x - max) as ex2.approx of x * log2(e) - max * log2(e), one FFMA and
//     one MUFU.EX2 a logit: the rounding of max * log2(e) is the same for
//     every logit of a side and cancels in the quotient, and ex2.approx's
//     relative error (~2^-22) keeps the result within 1e-5 of the plain
//     version (phase 12 of chip_smoke.py checks logits spread to N(0, 8) and
//     sides that span 80).
//   - The quotient is the approximate reciprocal's and one FMA correction
//     (a side's sum of e lies in [1, 16]), not the division routine.
//   - Lane 0 of a row gathers the other sides from lanes 2, 4 and 6 and
//     writes the row's four floats as one 16-byte store.
// The formula is the TPU kernel's, sum(e * bin) / sum(e); the plain version
// (ops/kernels/dfl_decode.py dfl_decode_reference) sums in another order,
// which moves the result by ~1e-6 of a bin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegMax = 16;
constexpr int kLanesPerRow = 8;  // 4 sides x 2 lanes, 8 logits per lane
constexpr int kLogitsPerLane = 4 * kRegMax / kLanesPerRow;
constexpr int kRowsPerBlock = kThreads / kLanesPerRow;
constexpr int kMaxGridY = 65535;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kLogitsPerLane == 8, "a lane holds half a side");

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a / b for b in [1, 16] (a side's sum of e, whose largest term is 1): the
// approximate reciprocal's quotient and one FMA correction, within an ulp of
// the rounded quotient, in place of the division routine
__device__ __forceinline__ float quotient(float a, float b) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(b));
  const float q = a * r;
  return fmaf(fmaf(-q, b, a), r, q);
}

// A lane's kWords 32-bit words at p, read kVec bytes at a time (p is kVec-aligned),
// evict-first (ld.global.cs): each logit is read once, so a line F brings into
// L2 is the first its set gives up, before the lines earlier kernels left
// there dirty, which would cost a write-back to HBM each.
template <int kVec, int kWords>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[kWords]) {
  if constexpr (kVec == 16) {
#pragma unroll
    for (int i = 0; i < kWords / 4; ++i) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + i);
      w[4 * i] = v.x;
      w[4 * i + 1] = v.y;
      w[4 * i + 2] = v.z;
      w[4 * i + 3] = v.w;
    }
  } else if constexpr (kVec == 8) {
#pragma unroll
    for (int i = 0; i < kWords / 2; ++i) {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p) + i);
      w[2 * i] = v.x;
      w[2 * i + 1] = v.y;
    }
  } else if constexpr (kVec == 4) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = __ldcs(reinterpret_cast<const unsigned int*>(p) + i);
  } else {
    static_assert(kVec == 2, "loads of 16, 8, 4 or 2 bytes");
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t lo = __ldcs(reinterpret_cast<const unsigned short*>(p) + 2 * i);
      const uint32_t hi = __ldcs(reinterpret_cast<const unsigned short*>(p) + 2 * i + 1);
      w[i] = lo | (hi << 16);
    }
  }
}

// Logit k of a lane's words, as f32.
template <typename T>
__device__ __forceinline__ float logit(const uint32_t* w, int k);
template <>
__device__ __forceinline__ float logit<float>(const uint32_t* w, int k) {
  return __uint_as_float(w[k]);
}
template <>
__device__ __forceinline__ float logit<__nv_bfloat16>(const uint32_t* w, int k) {
  return __uint_as_float((k & 1) ? w[k >> 1] & 0xffff0000u : w[k >> 1] << 16);
}

// One anchor row's side (half of it in each of two lanes) from the lane's
// words: the side's expectation in bins, held by both of its lanes.
template <typename T, int kWords>
__device__ __forceinline__ float side_expectation(const uint32_t (&w)[kWords], int q) {
  float v[kLogitsPerLane];
#pragma unroll
  for (int k = 0; k < kLogitsPerLane; ++k) v[k] = logit<T>(w, k);
  float m = fmaxf(fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3])), fmaxf(fmaxf(v[4], v[5]), fmaxf(v[6], v[7])));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  const float mb = m * kLog2e;
  float e[kLogitsPerLane];
#pragma unroll
  for (int k = 0; k < kLogitsPerLane; ++k) e[k] = exp2_approx(fmaf(v[k], kLog2e, -mb));
  float se = e[0], sk = e[1];  // sum(e) and sum(e * k) over k = 0..7
#pragma unroll
  for (int k = 1; k < kLogitsPerLane; ++k) se += e[k];
#pragma unroll
  for (int k = 2; k < kLogitsPerLane; ++k) sk = fmaf(e[k], static_cast<float>(k), sk);
  const float bin0 = static_cast<float>((q & 1) * kLogitsPerLane);
  float sb = fmaf(bin0, se, sk);  // sum(e * bin) over this lane's bins
  se += __shfl_xor_sync(0xffffffffu, se, 1);
  sb += __shfl_xor_sync(0xffffffffu, sb, 1);
  return quotient(sb, se);
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads)
dfl_decode_kernel(const T* __restrict__ x, float4* __restrict__ out, int B, int A, long long stride_b,
                  long long stride_a) {
  constexpr int kWords = kLogitsPerLane * static_cast<int>(sizeof(T)) / 4;
  const int q = threadIdx.x % kLanesPerRow;
  const int a = blockIdx.x * kRowsPerBlock + threadIdx.x / kLanesPerRow;
  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    // a row past A reads nothing (its lanes still take part in the shuffles)
    uint32_t w[kWords] = {};
    if (a < A)
      load_words<kVec>(reinterpret_cast<const unsigned char*>(x + b * stride_b + a * stride_a) +
                           q * kLogitsPerLane * sizeof(T),
                       w);
    const float side = side_expectation<T>(w, q);
    // lane 0 of the row gathers the other sides from lanes 2, 4 and 6
    const float s1 = __shfl_sync(0xffffffffu, side, 2, kLanesPerRow);
    const float s2 = __shfl_sync(0xffffffffu, side, 4, kLanesPerRow);
    const float s3 = __shfl_sync(0xffffffffu, side, 6, kLanesPerRow);
    if (q == 0 && a < A) out[static_cast<long long>(b) * A + a] = make_float4(side, s1, s2, s3);
  }
}

// The widest load, in bytes, that divides the base address and both strides.
int vector_bytes(const void* x, int elem, long long stride_b, long long stride_a) {
  const unsigned long long bits = static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(x)) |
                                  static_cast<unsigned long long>(stride_b * elem) |
                                  static_cast<unsigned long long>(stride_a * elem);
  for (int v = 16; v > 2; v >>= 1)
    if (bits % v == 0) return v;
  return 2;
}

template <typename T>
cudaError_t launch(const void* x, void* out, int B, int A, long long stride_b, long long stride_a,
                   cudaStream_t s) {
  const dim3 grid((A + kRowsPerBlock - 1) / kRowsPerBlock, B < kMaxGridY ? B : kMaxGridY);
  const T* xt = static_cast<const T*>(x);
  float4* o = static_cast<float4*>(out);
  switch (vector_bytes(x, sizeof(T), stride_b, stride_a)) {
    case 16:
      dfl_decode_kernel<T, 16><<<grid, kThreads, 0, s>>>(xt, o, B, A, stride_b, stride_a);
      break;
    case 8:
      dfl_decode_kernel<T, 8><<<grid, kThreads, 0, s>>>(xt, o, B, A, stride_b, stride_a);
      break;
    case 4:
      dfl_decode_kernel<T, 4><<<grid, kThreads, 0, s>>>(xt, o, B, A, stride_b, stride_a);
      break;
    default:
      if constexpr (sizeof(T) == 2) {
        dfl_decode_kernel<T, 2><<<grid, kThreads, 0, s>>>(xt, o, B, A, stride_b, stride_a);
        break;
      } else {
        return cudaErrorMisalignedAddress;  // f32 logits off their 4-byte alignment
      }
  }
  return cudaGetLastError();
}

}  // namespace

// x: (B, A, 64) logits, f32 (dtype 0) or bf16 (dtype 1), last dim contiguous,
// element strides stride_b and stride_a; out: (B, A, 4) f32, contiguous and
// 16-byte aligned. All on the current device. Returns the cudaError_t of the
// launch.
extern "C" int dfl_decode_launch(const void* x, void* out, int dtype, long long B, long long A,
                                 long long stride_b, long long stride_a, void* stream) {
  if (B < 1 || A < 1 || (dtype != 0 && dtype != 1) || B > 0x7fffffffLL || A > 0x7fffffffLL - kRowsPerBlock ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == 0 ? launch<float>(x, out, static_cast<int>(B), static_cast<int>(A), stride_b, stride_a, s)
                 : launch<__nv_bfloat16>(x, out, static_cast<int>(B), static_cast<int>(A), stride_b, stride_a, s);
  return static_cast<int>(err);
}

// The load width, in bytes, that dfl_decode_launch takes for these logits.
extern "C" int dfl_decode_vector_bytes(const void* x, int dtype, long long stride_b, long long stride_a) {
  return vector_bytes(x, dtype == 0 ? 4 : 2, stride_b, stride_a);
}
