// Fused 4x bilinear upsample + 0.5 threshold + MSB-first bit-pack of the
// segment serving masks.
//
// Replaces: upsample4x_threshold_pack (yolo_infer_tpu/ops/pallas/mask_pack.py),
// the TPU kernel that runs the whole serving mask tail in VMEM per tile of
// instances, on soft masks pre-split into even and odd columns.
//
// What bounds it on the H100: bytes. It reads the (n, Hm, Wm) f32 soft masks
// and writes the (n, 4Hm, Wm/2) packed bytes (983 MB in and 491 MB out at
// n = 9600, Hm = Wm = 160), and does ~5 operations per output bit. The
// (n, 4Hm, 4Wm) upsampled image never exists.
//
// Design: the whole batch in one launch; one thread per (instance, source row
// i, 4-byte chunk c of the packed row). Output byte B of a row covers source
// columns 2B and 2B+1, so chunk c needs columns 8c-1 .. 8c+8 (clamped at the
// edges, which crosses column parity: the reason the TPU kernel needed mixed
// even/odd shifts; unsplit, it is a plain clamp). The thread reads rows i-1,
// i, i+1 (clamped) as two float4 and two scalars each, computes the four
// H-phases kh (output rows 4i+kh) of the ten columns, then the eight
// W-phases of each output byte, and stores each output row's four bytes as
// one uint32. Consecutive threads take consecutive chunks, so loads and
// stores coalesce. Rounding follows the plain version (ops/masks.py
// _upsample_threshold_pack): the H tap wa*a + wb*b with each product
// rounded, then the W tap on those values the same way, then > 0.5; built
// with --fmad=false, so the bytes are equal bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// phase weights for ratio 4: off_k = (k + 0.5) / 4 - 0.5; phases 0, 1 tap
// (q-1, q), phases 2, 3 tap (q, q+1)
__device__ __constant__ float kWa[4] = {0.375f, 0.125f, 0.875f, 0.625f};
__device__ __constant__ float kWb[4] = {0.625f, 0.875f, 0.125f, 0.375f};

__device__ __forceinline__ float tap(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

// the ten columns 8c-1 .. 8c+8 of one source row, clamped at the row's edges
__device__ __forceinline__ void load_cols(const float* row, int c, int W, float v[10]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 8 * c);
  const float4 hi = *reinterpret_cast<const float4*>(row + 8 * c + 4);
  v[0] = row[max(8 * c - 1, 0)];
  v[1] = lo.x; v[2] = lo.y; v[3] = lo.z; v[4] = lo.w;
  v[5] = hi.x; v[6] = hi.y; v[7] = hi.z; v[8] = hi.w;
  v[9] = row[min(8 * c + 8, W - 1)];
}

__global__ void __launch_bounds__(kThreads)
mask_pack_kernel(const float* __restrict__ soft, uint32_t* __restrict__ out, int H, int W, long long total) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= total) return;
  const int C = W >> 3;  // 4-byte chunks per packed row
  const int c = static_cast<int>(t % C);
  const long long rest = t / C;
  const int i = static_cast<int>(rest % H);
  const long long inst = rest / H;

  const float* base = soft + inst * H * W;
  float up[10], mid[10], dn[10];
  load_cols(base + static_cast<long long>(max(i - 1, 0)) * W, c, W, up);
  load_cols(base + static_cast<long long>(i) * W, c, W, mid);
  load_cols(base + static_cast<long long>(min(i + 1, H - 1)) * W, c, W, dn);

  // packed row 4i+kh, as words of W/8 per row (W/2 bytes)
  uint32_t* orow = out + (inst * 4 * H + 4LL * i) * C + c;
#pragma unroll
  for (int kh = 0; kh < 4; ++kh) {
    float v[10];
#pragma unroll
    for (int q = 0; q < 10; ++q) {
      v[q] = kh < 2 ? tap(kWa[kh], up[q], kWb[kh], mid[q]) : tap(kWa[kh], mid[q], kWb[kh], dn[q]);
    }
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {  // byte 4c+b: source columns 8c+2b, 8c+2b+1 = v[2b+1], v[2b+2]
      uint32_t byte = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = 2 * b + 1 + (j >> 2);  // v index of the source column of bit j
        const int kw = j & 3;
        const float x = kw < 2 ? tap(kWa[kw], v[q - 1], kWb[kw], v[q]) : tap(kWa[kw], v[q], kWb[kw], v[q + 1]);
        byte |= static_cast<uint32_t>(x > 0.5f) << (7 - j);
      }
      word |= byte << (8 * b);  // little-endian: byte 4c+b at the b-th lowest address
    }
    orow[static_cast<long long>(kh) * C] = word;
  }
}

}  // namespace

// soft (n, H, W) f32 contiguous and 16-byte aligned, W % 8 == 0; out
// (n, 4H, W/2) uint8 contiguous and 4-byte aligned; both on the current
// device. Returns the cudaError_t of the launch.
extern "C" int mask_pack_launch(const void* soft, void* out, long long n, int H, int W, void* stream) {
  if (n < 1 || H < 1 || W < 8 || W % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = n * H * (W / 8);
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  mask_pack_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soft), static_cast<uint32_t*>(out), H, W, total);
  return static_cast<int>(cudaGetLastError());
}
