// Static8 int8 convolution with the requantizing epilogue fused (kernel E).
//
// Replaces: int8_conv3x3_fused (yolo_infer_tpu/ops/pallas/int8_conv.py), the
// TPU kernel that keeps an image's int8 tile in VMEM, sums nine shifted
// (TH*W, Ci) x (Ci, Co) int8 dots in int32 and requantizes in registers, so
// only int8 crosses HBM. Here one launch is one whole static8 conv of the
// serving path, k = 1 or 3 and stride 1 or 2 (the JAX package hands the
// shapes other than 3x3/stride 1 to XLA's s8 convolution), groups 1.
//
// Input x (B, H, W, Ci) int8 NHWC with a pixel pitch P >= Ci: element (b, y,
// x, c) lies at x[((b*H + y)*W + x)*P + c], so a channel chunk of a wider
// NHWC tensor is read in place (not padded: k/2 zero padding, exact since
// the zero point is 0); weights (Co, k, k, Ci) int8; scale (Co,) f32 = sx *
// w_scale; bias (Co,) f32 or null; output (B, Ho, Wo, Co) int8. Per output:
// exact int32 sum, then
//   f32 epilogue:  y = acc*scale + bias, SiLU, q = rint(y * syinv)
//   bf16 epilogue: y = bf16(acc*scale), bf16(y + bf16(bias)), bf16(SiLU(y)),
//                  bf16(y * bf16(syinv)), q = rint(y)
// with SiLU = y * sigmoid(y), sigmoid = 1 / (1 + exp(-y)) (the JAX
// package's form; in bf16 the exp, the sum, the reciprocal and the product
// each round to bf16, as XLA evaluates a bf16 sigmoid on the CPU), and q
// clipped to ±127.
// Built with --fmad=false and written with __fmul_rn-style intrinsics, so
// every operation rounds as PyTorch's elementwise kernels do and the plain
// version on the card gives the same codes.
//
// The float epilogue (epilogues 2 and 3) serves the dynamic and legacy
// static int8 modes, whose JAX conv (yolo_infer_tpu/nn/quantize.py
// quantized_conv2d and nn/layers.py conv_block's fp-in/fp-out branch) is
// XLA's s8 convolution outside any Pallas kernel: the same exact int32 sum,
// then per output y = cast(acc*scale) to the activation dtype, + cast(bias),
// SiLU, written as that float (f32 or bf16, NHWC) with no requantize. That
// is the JAX order of rounding; the outputs go straight from the registers
// to global memory (a pair of channels per store where Co is even).
//
// What bounds it on the H100: at yolo11s, batch 32, 640 px the 48 static8
// convs do 236 GMAC over 1.47 GB of int8 traffic, 0.44 ms by bytes and 0.24
// ms at the int8 tensor-core peak, so the products must run on the tensor
// cores and the loads must overlap them. Past that, neither the bytes nor
// the mma rate sets its time: the requantizing epilogue does (a chain of
// bf16 roundings, an exp and a reciprocal for every output), then the
// operand traffic through shared memory and each block's fixed costs. So
// the epilogue runs two outputs at a time in packed bf16x2 form.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels by N = Co channels by
// K = k*k*Ci, on the int8 tensor cores (mma.sync m16n8k32 s8 -> s32). NHWC
// input rows are A row-major (Ci contiguous) and the (Co, k, k, Ci) weight
// rows are B "col" (K contiguous): the layouts the instruction takes, no
// transpose. A block of 8 warps owns 128 pixels by 128 channels (64 when Co
// <= 64); a K-step is one tap by 64 input channels. Steps flow through a
// 4-stage shared-memory ring filled with 16-byte cp.async.cg, whose
// zero-fill form (src-size 0) gives the padding outside the image, the rows
// past the last pixel and the channels past Ci with no branch in the copy;
// cp.async.wait_group and __syncthreads separate the stages, so the loads of
// step s+3 run under the products of step s. Rows of 64 bytes are
// XOR-swizzled (16-byte chunk c of row r at c ^ ((r >> 1) & 3)), so ldmatrix
// reads 8 rows without bank conflicts. The epilogue requantizes in
// registers, stages the int8 tile in shared memory and stores 16 contiguous
// bytes per thread (byte stores where Co % 16 != 0, as at Co = 70). Ci that
// is not a multiple of 16 (the 3-channel stem, or Ci = 130, only when
// eligibility is lowered) fills the same ring with byte loads and the same
// zero fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kBM = 128;       // output pixels per block
constexpr int kBK = 64;        // reduction bytes per K-step: one tap x 64 input channels
constexpr int kStages = 4;     // shared-memory ring depth
constexpr int kLoadRows = kThreads / (kBK / 16);  // rows one pass of 16-byte chunks covers: 64

struct Geometry {
  int B, H, W, Ci, P, Ho, Wo, Co, k, stride;
};

__device__ __forceinline__ int8_t to_code(float y) {
  return static_cast<int8_t>(static_cast<int>(fminf(fmaxf(rintf(y), -127.0f), 127.0f)));
}

// the f32 epilogue of one output, up to the requantize
__device__ __forceinline__ float epi_f32(int acc, float scale, float bias, int act) {
  float y = __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
  if (act) y = __fmul_rn(y, __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))));
  return y;
}

__device__ __forceinline__ int8_t requant_f32(int acc, float scale, float bias, int act, float syinv) {
  return to_code(__fmul_rn(epi_f32(acc, scale, bias, act), syinv));
}

// the bf16 epilogue of two outputs of one pixel (channels co, co + 1):
//   y = bf16(acc*scale), bf16(y + bias), y * bf16(1 / bf16(1 + bf16(exp(-y)))),
//   bf16(y * syinv), each product and sum rounded to bf16.
// A sum or product of two bf16 values runs as one packed bf16x2 instruction,
// rounding the exact result once; that equals rounding the f32 result to
// bf16, since f32 carries 24 >= 2*8 + 2 significand bits. exp and the
// reciprocal run in f32 and round to bf16, as PyTorch's bf16 ops do.
__device__ __forceinline__ __nv_bfloat162 epi2_bf16(int a0, int a1, float s0, float s1, __nv_bfloat162 bias2,
                                                   bool has_bias, int act) {
  __nv_bfloat162 y = __floats2bfloat162_rn(__fmul_rn(__int2float_rn(a0), s0), __fmul_rn(__int2float_rn(a1), s1));
  if (has_bias) y = __hadd2(y, bias2);
  if (act) {
    const float2 yf = __bfloat1622float2(y);
    const __nv_bfloat162 d = __hadd2(__floats2bfloat162_rn(expf(-yf.x), expf(-yf.y)), __float2bfloat162_rn(1.0f));
    const float2 df = __bfloat1622float2(d);
    y = __hmul2(y, __floats2bfloat162_rn(__fdiv_rn(1.0f, df.x), __fdiv_rn(1.0f, df.y)));
  }
  return y;
}

__device__ __forceinline__ char2 requant2_bf16(int a0, int a1, float s0, float s1, __nv_bfloat162 bias2, bool has_bias,
                                               int act, __nv_bfloat162 syinv2) {
  const __nv_bfloat162 y = epi2_bf16(a0, a1, s0, s1, bias2, has_bias, act);
  const float2 q = __bfloat1622float2(__hmul2(y, syinv2));
  char2 c;
  c.x = to_code(q.x);
  c.y = to_code(q.y);
  return c;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk c (0..3) of row r in a tile of 64-byte rows
__device__ __forceinline__ int swz(int r, int c) { return r * kBK + ((c ^ ((r >> 1) & 3)) << 4); }

// 16 bytes at src into shared memory at dst: cp.async with zero fill when
// !valid; or (!kVec) byte by byte, bytes at or past `left` zero
template <bool kVec>
__device__ __forceinline__ void stage16(unsigned char* dst, const int8_t* src, bool valid, int left) {
  if (kVec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
                 "r"(valid ? 16 : 0));
  } else {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    unsigned char* vb = reinterpret_cast<unsigned char*>(&v);
    if (valid) {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        if (e < left) vb[e] = static_cast<unsigned char>(src[e]);
      }
    }
    *reinterpret_cast<uint4*>(dst) = v;
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x32 s8, row) * b (32x8 s8, col), exact s32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kEpi: 0 f32 and 1 bf16 requantizing (int8 out), 2 f32 and 3 bf16 float out
template <int kBN, bool kVec, int kEpi>
__global__ void __launch_bounds__(kThreads, 2)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, void* __restrict__ out, Geometry g, float syinv, int act) {
  constexpr int kWarpsM = kBN == 128 ? 2 : 4;
  constexpr int kWarpsN = 8 / kWarpsM;
  constexpr int kWM = kBM / kWarpsM;  // pixels per warp: 64 or 32
  constexpr int kWN = kBN / kWarpsN;  // channels per warp: 32
  constexpr int kMI = kWM / 16;       // m16 tiles per warp
  constexpr int kNI = kWN / 8;        // n8 tiles per warp
  constexpr int kStageBytes = (kBM + kBN) * kBK;
  constexpr int kARows = kBM / kLoadRows;
  constexpr int kBRows = kBN / kLoadRows;
  constexpr int kOS = kBN + 16;  // output staging row (bytes)
  static_assert(kNI % 2 == 0 && kBM * kOS <= kStages * kStageBytes, "tile shapes");

  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int c0 = blockIdx.y * kBN;
  const int pad = g.k / 2;
  const int nci = (g.Ci + kBK - 1) / kBK;  // 64-channel slices per tap
  const int steps = g.k * g.k * nci;
  const long long wrow = static_cast<long long>(g.k) * g.k * g.Ci;  // weight bytes per output channel

  // the pixels whose 16-byte chunk this thread stages: image start b*H*W (-1
  // past the last pixel) and the window's top-left input row and column
  const int chunk = tid & 3;
  int a_img[kARows], a_y[kARows], a_x[kARows];
#pragma unroll
  for (int i = 0; i < kARows; ++i) {
    const long long m = m0 + (tid >> 2) + i * kLoadRows;
    a_img[i] = -1;
    a_y[i] = a_x[i] = 0;
    if (m < M) {
      const int ox = static_cast<int>(m % g.Wo);
      const long long r = m / g.Wo;
      const int oy = static_cast<int>(r % g.Ho);
      a_img[i] = static_cast<int>(r / g.Ho) * g.H * g.W;
      a_y[i] = oy * g.stride - pad;
      a_x[i] = ox * g.stride - pad;
    }
  }

  auto load_step = [&](int s, int slot) {
    const int tap = s / nci;
    const int ci = (s - tap * nci) * kBK + 16 * chunk;
    const int kh = tap / g.k, kw = tap - kh * g.k;
    unsigned char* As = smem + slot * kStageBytes;
    unsigned char* Bs = As + kBM * kBK;
#pragma unroll
    for (int i = 0; i < kARows; ++i) {
      const int row = (tid >> 2) + i * kLoadRows;
      const int iy = a_y[i] + kh, ix = a_x[i] + kw;
      const bool valid = a_img[i] >= 0 && ci < g.Ci && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W;
      const int8_t* src = x + (valid ? static_cast<long long>(a_img[i] + iy * g.W + ix) * g.P + ci : 0);
      stage16<kVec>(As + swz(row, chunk), src, valid, g.Ci - ci);
    }
#pragma unroll
    for (int i = 0; i < kBRows; ++i) {
      const int row = (tid >> 2) + i * kLoadRows;
      const int co = c0 + row;
      const bool valid = co < g.Co && ci < g.Ci;
      const int8_t* src = w + (valid ? co * wrow + static_cast<long long>(tap) * g.Ci + ci : 0);
      stage16<kVec>(Bs + swz(row, chunk), src, valid, g.Ci - ci);
    }
  };

  int acc[kMI][kNI][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  // prologue: steps 0 .. kStages-2 in flight; one commit group per step,
  // empty past the last, so wait_group counts steps
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_step(s, s);
    asm volatile("cp.async.commit_group;\n" ::);
  }

  for (int s = 0; s < steps; ++s) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2));
    __syncthreads();  // step s has landed for every thread; slot (s-1) % kStages is free
    if (s + kStages - 1 < steps) load_step(s + kStages - 1, (s + kStages - 1) % kStages);
    asm volatile("cp.async.commit_group;\n" ::);

    const unsigned char* As = smem + (s % kStages) * kStageBytes;
    const unsigned char* Bs = As + kBM * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {  // k32 sub-steps
      unsigned af[kMI][4], bf[kNI][2];
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
        // lanes 0-15: rows 0-15 at k 0-15 (a0, a1); lanes 16-31: k 16-31 (a2, a3)
        ldmatrix_x4(af[i], As + swz(wm * kWM + 16 * i + (lane & 15), 2 * kk + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < kNI; j += 2) {
        // matrices: channels 0-7 at k 0-15, k 16-31 (b0, b1 of tile j), channels 8-15 (tile j+1)
        unsigned r[4];
        ldmatrix_x4(r, Bs + swz(wn * kWN + 8 * j + (lane & 7) + ((lane >> 4) << 3), 2 * kk + ((lane >> 3) & 1)));
        bf[j][0] = r[0];
        bf[j][1] = r[1];
        bf[j + 1][0] = r[2];
        bf[j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < kMI; ++i)
#pragma unroll
        for (int j = 0; j < kNI; ++j) mma_s8(acc[i][j], af[i], bf[j][0], bf[j][1]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();  // the ring is free: it becomes the output tile

  const int g8 = lane >> 2, t4 = lane & 3;
  if constexpr (kEpi >= 2) {
    // float epilogue: each thread's channel pairs go straight to global memory
    const bool pairs = (g.Co & 1) == 0;
#pragma unroll
    for (int j = 0; j < kNI; ++j) {
      const int co = c0 + wn * kWN + 8 * j + 2 * t4;
      if (co >= g.Co) continue;
      const bool two = co + 1 < g.Co;
      const float s0 = scale[co], s1 = two ? scale[co + 1] : 0.f;
      const float b0 = bias != nullptr ? bias[co] : 0.f;
      const float b1 = bias != nullptr && two ? bias[co + 1] : 0.f;
      const __nv_bfloat162 bias2 = __floats2bfloat162_rn(b0, b1);
#pragma unroll
      for (int i = 0; i < kMI; ++i) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const long long m = m0 + wm * kWM + 16 * i + g8 + 8 * r;
          if (m >= M) continue;
          const int a0 = acc[i][j][2 * r], a1 = acc[i][j][2 * r + 1];
          const long long o = m * g.Co + co;
          if constexpr (kEpi == 2) {
            float* dst = static_cast<float*>(out) + o;
            const float y0 = epi_f32(a0, s0, b0, act), y1 = epi_f32(a1, s1, b1, act);
            if (pairs) {
              *reinterpret_cast<float2*>(dst) = make_float2(y0, y1);
            } else {
              dst[0] = y0;
              if (two) dst[1] = y1;
            }
          } else {
            __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(out) + o;
            const __nv_bfloat162 y = epi2_bf16(a0, a1, s0, s1, bias2, bias != nullptr, act);
            if (pairs) {
              *reinterpret_cast<__nv_bfloat162*>(dst) = y;
            } else {
              dst[0] = __low2bfloat16(y);
              if (two) dst[1] = __high2bfloat16(y);
            }
          }
        }
      }
    }
    return;
  }

  // epilogue: requantize in registers, stage the int8 tile, store 16 bytes per thread
  // (channels past Co compute with scale and bias 0 and are not stored)
  unsigned char* Os = smem;
  const __nv_bfloat162 syinv2 = __float2bfloat162_rn(syinv);
#pragma unroll
  for (int j = 0; j < kNI; ++j) {
    const int col = wn * kWN + 8 * j + 2 * t4;
    const int co = c0 + col;
    const float s0 = co < g.Co ? scale[co] : 0.f, s1 = co + 1 < g.Co ? scale[co + 1] : 0.f;
    const float b0 = bias != nullptr && co < g.Co ? bias[co] : 0.f;
    const float b1 = bias != nullptr && co + 1 < g.Co ? bias[co + 1] : 0.f;
    const __nv_bfloat162 bias2 = __floats2bfloat162_rn(b0, b1);
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = wm * kWM + 16 * i + g8 + 8 * r;
        const int a0 = acc[i][j][2 * r], a1 = acc[i][j][2 * r + 1];
        char2 q;
        if (kEpi == 0) {
          q.x = requant_f32(a0, s0, b0, act, syinv);
          q.y = requant_f32(a1, s1, b1, act, syinv);
        } else {
          q = requant2_bf16(a0, a1, s0, s1, bias2, bias != nullptr, act, syinv2);
        }
        *reinterpret_cast<char2*>(Os + row * kOS + col) = q;
      }
    }
  }
  __syncthreads();
  constexpr int kChunks = kBN / 16;
  for (int idx = tid; idx < kBM * kChunks; idx += kThreads) {
    const int r = idx / kChunks, cc = idx % kChunks;
    const long long m = m0 + r;
    const int co = c0 + 16 * cc;
    if (m >= M || co >= g.Co) continue;
    int8_t* dst = static_cast<int8_t*>(out) + m * g.Co + co;
    const unsigned char* src = Os + r * kOS + 16 * cc;
    if ((g.Co & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 16 && co + e < g.Co; ++e) dst[e] = static_cast<int8_t>(src[e]);
    }
  }
}

template <int kBN, bool kVec, int kEpi>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias, void* out,
                   const Geometry& g, float syinv, int act, cudaStream_t stream) {
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long blocks = (M + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = kStages * (kBM + kBN) * kBK;
  auto kernel = int8_conv_kernel<kBN, kVec, kEpi>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(blocks), (g.Co + kBN - 1) / kBN);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, scale, bias, out, g, syinv, act);
  return cudaGetLastError();
}

template <int kBN, bool kVec>
cudaError_t launch_epi(int epilogue, const int8_t* x, const int8_t* w, const float* scale, const float* bias,
                       void* out, const Geometry& g, float syinv, int act, cudaStream_t stream) {
  switch (epilogue) {
    case 0: return launch<kBN, kVec, 0>(x, w, scale, bias, out, g, syinv, act, stream);
    case 1: return launch<kBN, kVec, 1>(x, w, scale, bias, out, g, syinv, act, stream);
    case 2: return launch<kBN, kVec, 2>(x, w, scale, bias, out, g, syinv, act, stream);
    default: return launch<kBN, kVec, 3>(x, w, scale, bias, out, g, syinv, act, stream);
  }
}

}  // namespace

// x (B, H, W, Ci) with pixel pitch P (bytes between neighbouring pixels, P >=
// Ci), w (Co, k, k, Ci) contiguous, out (B, Ho, Wo, Co) contiguous int8, and
// scale, bias (Co,) f32 (bias may be null), on the current device. Ci % 16
// == 0 takes the cp.async path and needs P, x and w 16-byte aligned; other
// Ci the byte path. epilogue 0 = float32, 1 = bfloat16 (out int8); 2 =
// float32, 3 = bfloat16 float epilogue (out (B, Ho, Wo, Co) of that type,
// syinv unused). Returns the cudaError_t of the launch.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                int B, int H, int W, int Ci, int P, int Ho, int Wo, int Co, int k, int stride,
                                float syinv, int act, int epilogue, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ci < 1 || P < Ci || Co < 1 || (k != 1 && k != 3) || (stride != 1 && stride != 2) ||
      Co > 65535 * 64 || epilogue < 0 || epilogue > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = Ci % 16 == 0;
  if (vec && (P % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{B, H, W, Ci, P, Ho, Wo, Co, k, stride};
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bs = static_cast<const float*>(bias);
  void* os = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (Co > 64) {
    err = vec ? launch_epi<128, true>(epilogue, xs, ws, sc, bs, os, g, syinv, act, s)
              : launch_epi<128, false>(epilogue, xs, ws, sc, bs, os, g, syinv, act, s);
  } else {
    err = vec ? launch_epi<64, true>(epilogue, xs, ws, sc, bs, os, g, syinv, act, s)
              : launch_epi<64, false>(epilogue, xs, ws, sc, bs, os, g, syinv, act, s);
  }
  return static_cast<int>(err);
}
