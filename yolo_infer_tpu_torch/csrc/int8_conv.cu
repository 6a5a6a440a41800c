// Static8 int8 convolution with the requantizing epilogue fused (kernel E).
//
// Replaces: int8_conv3x3_fused (yolo_infer_tpu/ops/pallas/int8_conv.py), the
// TPU kernel that keeps an image's int8 tile in VMEM, sums nine shifted
// (TH*W, Ci) x (Ci, Co) int8 dots in int32 and requantizes in registers, so
// only int8 crosses HBM. Here one launch is one whole static8 conv of the
// serving path, k = 1 or 3 and stride 1 or 2 (the JAX package hands the
// shapes other than 3x3/stride 1 to XLA's s8 convolution), groups 1.
//
// Input x (B, H, W, Ci) int8 NHWC, not padded (k/2 zero padding: zero is
// exact, the zero point is 0); weights (Co, k, k, Ci) int8; scale (Co,) f32
// = sx * w_scale; bias (Co,) f32 or null; output (B, Ho, Wo, Co) int8. Per
// output: exact int32 sum, then
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
// What bounds it on the H100: at yolo11s, batch 32, 640 px the 48 static8
// convs do 236 GMAC over 1.47 GB of int8 traffic, 0.44 ms by bytes and 0.24
// ms at the int8 tensor-core peak. This first version does not use the
// tensor cores: its products are __dp4a on the CUDA cores (4 MACs per
// instruction), so instructions, not bytes, set its time; wgmma int8 with
// TMA-fed tiles is later work.
//
// Design: an implicit GEMM, M = B*Ho*Wo output pixels by N = Co channels by
// K = k*k*Ci. A block of 256 threads owns a 64-pixel by 64-channel tile;
// each thread keeps 4 pixels x 4 channels of int32 sums in registers. The
// reduction walks the k*k taps and, per tap, 64-channel slices of Ci: the
// block stages the slice of its 64 pixels' inputs (zero outside the image)
// and of its 64 channels' weights in shared memory as 4-byte words, K-major,
// then each thread reads its 4 pixels' and 4 channels' words with one 16-byte
// load each and issues 16 __dp4a per word. Ci that is not a multiple of 4
// (the 3-channel stem, when eligibility is lowered that far) is staged byte
// by byte with the same zero fill.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTP = 64;        // output pixels per block
constexpr int kTC = 64;        // output channels per block
constexpr int kKW = 16;        // 4-byte words of the reduction staged at once (64 input channels)
constexpr int kRow = kTP + 4;  // shared row in words: 16-byte aligned rows

struct Geometry {
  int B, H, W, Ci, Ho, Wo, Co, k, stride;
};

__device__ __forceinline__ float bf16r(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

__device__ __forceinline__ float sigmoid(float y) { return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y))); }
__device__ __forceinline__ float sigmoid_bf16(float y) {
  return bf16r(__fdiv_rn(1.0f, bf16r(__fadd_rn(1.0f, bf16r(expf(-y))))));
}

template <int kEpi>
__device__ __forceinline__ int8_t requant(int acc, float scale, const float* bias, int co, int act, float syinv) {
  float y = __fmul_rn(__int2float_rn(acc), scale);
  if (kEpi == 0) {
    if (bias != nullptr) y = __fadd_rn(y, bias[co]);
    if (act) y = __fmul_rn(y, sigmoid(y));
    y = __fmul_rn(y, syinv);
  } else {
    y = bf16r(y);
    if (bias != nullptr) y = bf16r(__fadd_rn(y, bf16r(bias[co])));
    if (act) y = bf16r(__fmul_rn(y, sigmoid_bf16(y)));
    y = bf16r(__fmul_rn(y, bf16r(syinv)));
  }
  y = fminf(fmaxf(rintf(y), -127.0f), 127.0f);
  return static_cast<int8_t>(static_cast<int>(y));
}

// four bytes at src as one word; bytes at or past `valid` are zero
template <bool kVec>
__device__ __forceinline__ int load_word(const int8_t* src, int valid) {
  if (kVec) return *reinterpret_cast<const int*>(src);
  unsigned v = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < valid) v |= static_cast<unsigned>(static_cast<uint8_t>(src[e])) << (8 * e);
  }
  return static_cast<int>(v);
}

template <bool kVec, int kEpi>
__global__ void __launch_bounds__(kThreads)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w, const float* __restrict__ scale,
                 const float* __restrict__ bias, int8_t* __restrict__ out, Geometry g, float syinv, int act) {
  __shared__ __align__(16) int As[kKW][kRow];  // [word][pixel]
  __shared__ __align__(16) int Ws[kKW][kRow];  // [word][channel]
  __shared__ long long pix_base[kTP];          // b*H*W, or -1 past the last pixel
  __shared__ int pix_y[kTP], pix_x[kTP];       // top-left input row and column of the window

  const int tid = threadIdx.x;
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long m0 = static_cast<long long>(blockIdx.x) * kTP;
  const int c0 = blockIdx.y * kTC;
  const int pad = g.k / 2;
  if (tid < kTP) {
    const long long m = m0 + tid;
    if (m < M) {
      const int ox = static_cast<int>(m % g.Wo);
      const long long r = m / g.Wo;
      const int oy = static_cast<int>(r % g.Ho);
      const long long b = r / g.Ho;
      pix_base[tid] = b * g.H * g.W;
      pix_y[tid] = oy * g.stride - pad;
      pix_x[tid] = ox * g.stride - pad;
    } else {
      pix_base[tid] = -1;
      pix_y[tid] = pix_x[tid] = 0;
    }
  }
  const int tx = tid % 16;  // channels c0 + 4*tx .. +3
  const int ty = tid / 16;  // pixels m0 + 4*ty .. +3
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;
  const long long wrow = static_cast<long long>(g.k) * g.k * g.Ci;  // weight bytes per output channel
  __syncthreads();

  for (int t = 0; t < g.k * g.k; ++t) {
    const int kh = t / g.k, kw = t - kh * g.k;
    for (int ci0 = 0; ci0 < g.Ci; ci0 += 4 * kKW) {
      for (int idx = tid; idx < kTP * kKW; idx += kThreads) {
        const int p = idx / kKW, wd = idx - p * kKW;
        const int ci = ci0 + 4 * wd;
        const int iy = pix_y[p] + kh, ix = pix_x[p] + kw;
        int v = 0;
        if (pix_base[p] >= 0 && ci < g.Ci && iy >= 0 && iy < g.H && ix >= 0 && ix < g.W) {
          v = load_word<kVec>(x + (pix_base[p] + static_cast<long long>(iy) * g.W + ix) * g.Ci + ci, g.Ci - ci);
        }
        As[wd][p] = v;
      }
      for (int idx = tid; idx < kTC * kKW; idx += kThreads) {
        const int c = idx / kKW, wd = idx - c * kKW;
        const int co = c0 + c, ci = ci0 + 4 * wd;
        int v = 0;
        if (co < g.Co && ci < g.Ci) {
          v = load_word<kVec>(w + co * wrow + static_cast<long long>(t) * g.Ci + ci, g.Ci - ci);
        }
        Ws[wd][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int wd = 0; wd < kKW; ++wd) {
        const int4 a = *reinterpret_cast<const int4*>(&As[wd][4 * ty]);
        const int4 b = *reinterpret_cast<const int4*>(&Ws[wd][4 * tx]);
        const int av[4] = {a.x, a.y, a.z, a.w};
        const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  const int cb = c0 + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + 4 * ty + i;
    if (m >= M) continue;
    int8_t* orow = out + m * g.Co;
    if (cb + 3 < g.Co && (g.Co & 3) == 0) {
      char4 q;
      q.x = requant<kEpi>(acc[i][0], scale[cb], bias, cb, act, syinv);
      q.y = requant<kEpi>(acc[i][1], scale[cb + 1], bias, cb + 1, act, syinv);
      q.z = requant<kEpi>(acc[i][2], scale[cb + 2], bias, cb + 2, act, syinv);
      q.w = requant<kEpi>(acc[i][3], scale[cb + 3], bias, cb + 3, act, syinv);
      *reinterpret_cast<char4*>(orow + cb) = q;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (cb + j < g.Co) orow[cb + j] = requant<kEpi>(acc[i][j], scale[cb + j], bias, cb + j, act, syinv);
      }
    }
  }
}

template <bool kVec, int kEpi>
cudaError_t launch(const int8_t* x, const int8_t* w, const float* scale, const float* bias, int8_t* out,
                   const Geometry& g, float syinv, int act, cudaStream_t stream) {
  const long long M = static_cast<long long>(g.B) * g.Ho * g.Wo;
  const long long blocks = (M + kTP - 1) / kTP;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(blocks), (g.Co + kTC - 1) / kTC);
  int8_conv_kernel<kVec, kEpi><<<grid, kThreads, 0, stream>>>(x, w, scale, bias, out, g, syinv, act);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, Ci), w (Co, k, k, Ci), out (B, Ho, Wo, Co) int8 and scale,
// bias (Co,) f32 (bias may be null), contiguous on the current device;
// epilogue 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* scale, const void* bias, void* out,
                                int B, int H, int W, int Ci, int Ho, int Wo, int Co, int k, int stride,
                                float syinv, int act, int epilogue, void* stream) {
  if (B < 1 || H < 1 || W < 1 || Ci < 1 || Co < 1 || (k != 1 && k != 3) || (stride != 1 && stride != 2) ||
      Co > 65535 * kTC || (epilogue != 0 && epilogue != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g{B, H, W, Ci, Ho, Wo, Co, k, stride};
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bs = static_cast<const float*>(bias);
  auto* os = static_cast<int8_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = (Ci % 4) == 0 && (reinterpret_cast<uintptr_t>(x) % 4) == 0 && (reinterpret_cast<uintptr_t>(w) % 4) == 0;
  cudaError_t err;
  if (vec) {
    err = epilogue == 0 ? launch<true, 0>(xs, ws, sc, bs, os, g, syinv, act, s)
                        : launch<true, 1>(xs, ws, sc, bs, os, g, syinv, act, s);
  } else {
    err = epilogue == 0 ? launch<false, 0>(xs, ws, sc, bs, os, g, syinv, act, s)
                        : launch<false, 1>(xs, ws, sc, bs, os, g, syinv, act, s);
  }
  return static_cast<int>(err);
}
