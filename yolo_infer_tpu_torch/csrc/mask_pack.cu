// Fused 4x bilinear upsample + 0.5 threshold + MSB-first bit-pack of the
// segment serving masks (kernel D).
//
// Replaces: upsample4x_threshold_pack (yolo_infer_tpu/ops/pallas/mask_pack.py),
// the TPU kernel that runs the whole serving mask tail in VMEM per tile of
// instances, on soft masks pre-split into even and odd columns.
//
// What bounds it on the H100: bytes in principle, operations in practice. It
// reads the (n, Hm, Wm) f32 soft masks and writes the (n, 4Hm, Wm/2) packed
// bytes: 983 MB in and 491 MB out at n = 9600, Hm = Wm = 160, 0.44 ms at the
// card's memory rate. Every product and sum must round apart
// (--fmad=false), so each output bit costs a product, a sum, a compare and
// the bit's insertion, one instruction each: ~4 x 3.9e9 on a dense input,
// above the bytes. The (n, 4Hm, 4Wm) upsampled image never exists.
//
// Design: a 2-D grid of (256 (instance, word c) pairs, band of 16 source
// rows); a thread walks the band's rows for one instance and one 32-bit
// output word c of the packed row (4 output bytes, source columns 8c .. 8c+7,
// plus 8c-1 and 8c+8 clamped at the edges). It reads each source row once,
// two float4 and two halo floats (the neighbours' columns, from L1), and
// holds rows i-1, i, i+1 in registers with row i+2 already in flight; so
// every source float comes from device memory once, apart from one halo row
// above and below each band. Output rows 4i+kh take rows (i-1, i) for phases
// 0, 1 and (i, i+1) for 2, 3; the weights (3/8, 5/8), (1/8, 7/8), (7/8,
// 1/8), (5/8, 3/8) mean each product of a source value serves two taps, along
// H (row i's 5/8 and 7/8 products feed two output rows each) and along W
// (each H tap's 3/8, 5/8, 1/8, 7/8 products feed two output pixels each), so
// an output bit costs one product, one sum, one compare and one predicated
// OR. Consecutive threads store consecutive words of a packed row (4 per
// source row).
// Zero skip: when no value of rows i-1..i+1 in the thread's ten columns is
// above 0.5 (NaN is not), the four words are 0 and no tap is computed. That
// is exact: rounding is monotone and each weight pair sums to 1, so taps of
// values <= 0.5 are <= rn(wa/2 + wb/2) = 0.5 along H and again along W, -inf
// stays below, and a NaN tap compares false. On the segment path most masks
// are empty slots or cropped to zero outside their box, so most rows skip.
// Rounding follows the plain version (ops/masks.py _upsample_threshold_pack):
// the H tap wa*a + wb*b with each product rounded, then the W tap on those
// values the same way, then > 0.5; the bytes are equal bit for bit.
// Measured slower on the card and kept out (tests/kernel_variants/
// mask_pack_variants.cu, timed by tests/torch_kernel_breakdown.py): bands
// staged in shared memory by 16-byte cp.async with a tile stored 16 bytes at
// a time (a thread reloads three staged rows per step, where this one keeps
// them in registers), and H taps computed once per output row and packed by
// __ballot_sync (a shared-memory round trip per output bit).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;  // source rows a thread walks

// the ten columns 8c-1 .. 8c+8 of source row r (clamped to the image)
__device__ __forceinline__ void load_row(const float* __restrict__ base, int r, int H, int W, int c, float v[10]) {
  const float* row = base + static_cast<size_t>(min(max(r, 0), H - 1)) * W;
  const float4 lo = __ldg(reinterpret_cast<const float4*>(row + 8 * c));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(row + 8 * c + 4));
  v[0] = __ldg(row + max(8 * c - 1, 0));
  v[1] = lo.x; v[2] = lo.y; v[3] = lo.z; v[4] = lo.w;
  v[5] = hi.x; v[6] = hi.y; v[7] = hi.z; v[8] = hi.w;
  v[9] = __ldg(row + min(8 * c + 8, W - 1));
}

// any value above 0.5 (fmaxf drops NaN, which never sets a bit)
__device__ __forceinline__ bool above_half(const float v[10]) {
  float m = v[0];
#pragma unroll
  for (int k = 1; k < 10; ++k) m = fmaxf(m, v[k]);
  return m > 0.5f;
}

// the 32 W phases of an output row from its H taps h[0..9] (columns 8c-1 ..
// 8c+8): output column m = 4(q-1) + kw of source column q = 1..8 is bit
// 8(m/8) + 7 - m%8 of the little-endian word (MSB-first bytes)
__device__ __forceinline__ uint32_t pack_row(const float h[10]) {
  float a375[10], a125[10], a625[10], a875[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    a375[k] = __fmul_rn(0.375f, h[k]);
    a125[k] = __fmul_rn(0.125f, h[k]);
    if (k >= 1 && k <= 8) {
      a625[k] = __fmul_rn(0.625f, h[k]);
      a875[k] = __fmul_rn(0.875f, h[k]);
    }
  }
  uint32_t word = 0;
#pragma unroll
  for (int q = 1; q <= 8; ++q) {
    const float x[4] = {__fadd_rn(a375[q - 1], a625[q]), __fadd_rn(a125[q - 1], a875[q]),
                        __fadd_rn(a875[q], a125[q + 1]), __fadd_rn(a625[q], a375[q + 1])};
#pragma unroll
    for (int kw = 0; kw < 4; ++kw) {
      const int m = 4 * (q - 1) + kw;
      if (x[kw] > 0.5f) word |= 1u << (8 * (m >> 3) + 7 - (m & 7));  // a compare and a predicated OR
    }
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
mask_pack_kernel(const float* __restrict__ soft, uint32_t* __restrict__ out, unsigned tasks, int H, int W) {
  const int C = W >> 3;  // 32-bit words per packed row
  const unsigned task = blockIdx.x * kThreads + threadIdx.x;
  if (task >= tasks) return;
  const unsigned inst = task / C;
  const int c = static_cast<int>(task - inst * C);
  const int i0 = blockIdx.y * kBand;
  const int i1 = min(i0 + kBand, H);

  const float* base = soft + static_cast<size_t>(inst) * H * W;
  uint32_t* orow = out + (static_cast<size_t>(inst) * 4 * H + 4 * i0) * C + c;
  float prv[10], cur[10], nxt[10], ahead[10];
  load_row(base, i0 - 1, H, W, c, prv);
  load_row(base, i0, H, W, c, cur);
  load_row(base, i0 + 1, H, W, c, ahead);
  bool fprv = above_half(prv), fcur = above_half(cur);
#pragma unroll 4
  for (int i = i0; i < i1; ++i) {
#pragma unroll
    for (int k = 0; k < 10; ++k) nxt[k] = ahead[k];
    load_row(base, i + 2, H, W, c, ahead);  // in flight while row i is computed
    const bool fnxt = above_half(nxt);
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
    if (fprv || fcur || fnxt) {
      float c625[10], c875[10], h[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) {
        c625[k] = __fmul_rn(0.625f, cur[k]);
        c875[k] = __fmul_rn(0.875f, cur[k]);
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) h[k] = __fadd_rn(__fmul_rn(0.375f, prv[k]), c625[k]);
      w0 = pack_row(h);
#pragma unroll
      for (int k = 0; k < 10; ++k) h[k] = __fadd_rn(__fmul_rn(0.125f, prv[k]), c875[k]);
      w1 = pack_row(h);
#pragma unroll
      for (int k = 0; k < 10; ++k) h[k] = __fadd_rn(c875[k], __fmul_rn(0.125f, nxt[k]));
      w2 = pack_row(h);
#pragma unroll
      for (int k = 0; k < 10; ++k) h[k] = __fadd_rn(c625[k], __fmul_rn(0.375f, nxt[k]));
      w3 = pack_row(h);
    }
    orow[0] = w0;
    orow[C] = w1;
    orow[2 * C] = w2;
    orow[3 * C] = w3;
    orow += 4 * C;
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      prv[k] = cur[k];
      cur[k] = nxt[k];
    }
    fprv = fcur;
    fcur = fnxt;
  }
}

}  // namespace

// soft (n, H, W) f32 contiguous and 16-byte aligned, W % 8 == 0; out (n, 4H,
// W/2) uint8 contiguous and 4-byte aligned; both on the current device. n *
// W/8 < 2^32 holds for any input that fits in device memory (32 H bytes of
// soft mask per task). Returns the cudaError_t of the launch.
extern "C" int mask_pack_launch(const void* soft, void* out, long long n, int H, int W, void* stream) {
  const long long tasks = n * (W / 8);
  if (n < 1 || H < 1 || W < 8 || W % 8 || tasks > 0xffffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((tasks + kThreads - 1) / kThreads), (H + kBand - 1) / kBand);
  mask_pack_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soft), static_cast<uint32_t*>(out), static_cast<unsigned>(tasks), H, W);
  return static_cast<int>(cudaGetLastError());
}
