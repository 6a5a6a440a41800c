// C2PSA attention on the raw qkv slab: softmax(q k^T * kd^-0.5) v per batch
// row and head.
//
// Replaces: attention_qkv_fused_pallas (yolo_infer_tpu/ops/pallas/
// attention_fused.py), the TPU kernel that keeps each batch row's score
// matrix in VMEM and reads the qkv conv's output slab in place (kernel B,
// attn_qkv_launch); and attention_fused_pallas in the same file, the older
// per-(batch*head) kernel on a slab packed head-major beforehand, (G, N,
// 2kd+hd) with G = batch*heads (kernel H, attn_packed_launch). A packed slab
// is a qkv slab of one head, so H launches B's body with heads = 1 and G
// grid rows: the same arithmetic, the same bound (bytes), the same design.
//
// Input (B, N, heads*(2kd+hd)), channels [h: q | k | v]; output (B, N,
// heads*hd), head-major. Products accumulate in f32, the softmax is f32 and
// exact (row max, then the sum of exp, then p = e / sum), and p is rounded
// to the input dtype before the PV product, as the JAX kernel does; the
// output is rounded to the input dtype. The normalisation is not deferred
// flash-style, which would move the rounding of p.
//
// What bounds it on the H100: bytes. At yolo11n, 640 px, batch 32 (N = 400,
// heads = 2, kd = 32, hd = 64) it moves ~9.8 MB for ~2 GFLOP, far below the
// card's bf16 ridge. This first version computes the products on the f32
// CUDA cores, not the tensor cores, and recomputes q.k in three passes, so
// arithmetic, not bytes, sets its time; wgmma and TMA are later work.
//
// Design: a block per (64-row query tile, head, batch row), 256 threads, four
// threads per query row. The head's K and V are staged in shared memory once
// when they fit (400 x (32 + 64) bf16 = 77 KB at N = 400, dynamic shared
// memory); otherwise 64-key tiles are streamed on every pass, so N = 1600
// (1280 px) works too. Pass 1 takes each row's max score, pass 2 the sum of
// exp(s - max), pass 3 forms p, rounds it, and accumulates p v. Each thread
// keeps its query row in registers and walks keys with a stride of 4, with
// the score's products chained through __fmaf_rn in a fixed order so every
// pass sees the same bits. Shared memory is read 16 bytes at a time (K rows,
// V rows, four p values), so the loads stay well below the arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;                      // query rows per block
constexpr int kTK = 64;                      // keys per tile
constexpr int kRowThreads = kThreads / kQT;  // threads sharing one query row
constexpr int kPS = kTK + 4;                 // p tile row (floats): 16-byte rows, no bank conflicts

// 8 consecutive elements as floats: one 16-byte load of bf16, two of f32
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);  // bf16 -> f32 is exact: the high half of the word
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// 8 floats rounded to T and stored with 16-byte stores
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* f) {
  uint4 u;
  unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);  // .x = low half
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}

// copy 8 elements (16 or 32 bytes)
__device__ __forceinline__ void copy8(__nv_bfloat16* d, const __nv_bfloat16* s) {
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
}
__device__ __forceinline__ void copy8(float* d, const float* s) {
  reinterpret_cast<float4*>(d)[0] = reinterpret_cast<const float4*>(s)[0];
  reinterpret_cast<float4*>(d)[1] = reinterpret_cast<const float4*>(s)[1];
}

__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float round_to(float v, const float*) { return v; }

// K rows in shared memory are padded by 16 bytes: rows stay 16-byte aligned
// and the four keys a warp reads at once start in different banks.
template <typename T, int KD> struct KRow { static constexpr int kStride = KD + 16 / static_cast<int>(sizeof(T)); };

template <typename T, int KD, int HD>
__global__ void __launch_bounds__(kThreads)
attn_qkv_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int heads, float scale, int resident) {
  static_assert(KD % 8 == 0 && HD % (8 * kRowThreads) == 0, "vector widths");
  constexpr int kStep = 2 * KD + HD;
  constexpr int kKS = KRow<T, KD>::kStride;
  constexpr int kOut = HD / kRowThreads;  // contiguous output columns per thread
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);                   // kQT x kPS
  T* Ks = reinterpret_cast<T*>(Ps + kQT * kPS);                 // rows x kKS
  const int kv_rows = resident ? N : kTK;
  T* Vs = Ks + static_cast<size_t>(kv_rows) * kKS;              // rows x HD

  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c3 = heads * kStep;
  const T* base = qkv + static_cast<size_t>(b) * N * c3 + h * kStep;

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;
  const int sub = tid % kRowThreads;
  const int qn = q0 + r;
  const bool qvalid = qn < N;

  float q[KD];
#pragma unroll
  for (int c = 0; c < KD; c += 8) {
    if (qvalid) {
      load8(base + static_cast<size_t>(qn) * c3 + c, q + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[c + e] = 0.f;
    }
  }

  // copy keys [j0, j0 + rows) of this head into Ks (and Vs) from row 0
  auto load_kv = [&](int j0, int rows, bool with_v) {
    for (int idx = tid; idx < rows * (KD / 8); idx += kThreads) {
      const int jr = idx / (KD / 8), c = (idx - jr * (KD / 8)) * 8;
      copy8(Ks + jr * kKS + c, base + static_cast<size_t>(j0 + jr) * c3 + KD + c);
    }
    if (with_v) {
      for (int idx = tid; idx < rows * (HD / 8); idx += kThreads) {
        const int jr = idx / (HD / 8), c = (idx - jr * (HD / 8)) * 8;
        copy8(Vs + jr * HD + c, base + static_cast<size_t>(j0 + jr) * c3 + 2 * KD + c);
      }
    }
  };
  // q . k in a fixed order, so every pass sees the same bits
  auto score = [&](const T* krow) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < KD; c += 8) {
      float kf[8];
      load8(krow + c, kf);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc = __fmaf_rn(q[c + e], kf[e], acc);
    }
    return __fmul_rn(acc, scale);
  };

  if (resident) {
    load_kv(0, N, true);
    __syncthreads();
  }

  // pass 1: row max
  float m = -INFINITY;
  for (int j0 = 0; j0 < N; j0 += kTK) {
    const int rows = min(kTK, N - j0);
    const T* Kt = Ks + (resident ? j0 * kKS : 0);
    if (!resident) {
      __syncthreads();
      load_kv(j0, rows, false);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) m = fmaxf(m, score(Kt + jr * kKS));
  }
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  // pass 2: sum of exp(s - max)
  float l = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTK) {
    const int rows = min(kTK, N - j0);
    const T* Kt = Ks + (resident ? j0 * kKS : 0);
    if (!resident) {
      __syncthreads();
      load_kv(j0, rows, false);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) l = __fadd_rn(l, expf(__fsub_rn(score(Kt + jr * kKS), m)));
  }
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));

  // pass 3: p = e / l rounded to T, o += p v over this thread's kOut columns
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float* prow = Ps + r * kPS;
  for (int j0 = 0; j0 < N; j0 += kTK) {
    const int rows = min(kTK, N - j0);
    const T* Kt = Ks + (resident ? j0 * kKS : 0);
    const T* Vt = Vs + (resident ? j0 * HD : 0) + sub * kOut;
    __syncthreads();  // the previous tile's p (and K/V) are no longer read
    if (!resident) {
      load_kv(j0, rows, true);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) {
      prow[jr] = round_to(__fdiv_rn(expf(__fsub_rn(score(Kt + jr * kKS), m)), l), Kt);
    }
    __syncthreads();
    int jr = 0;
    for (; jr + 4 <= rows; jr += 4) {
      const float4 p4 = *reinterpret_cast<const float4*>(prow + jr);
      const float pj[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < kOut; c += 8) {
          float vf[8];
          load8(Vt + (jr + t) * HD + c, vf);
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[c + e] = __fmaf_rn(pj[t], vf[e], acc[c + e]);
        }
      }
    }
    for (; jr < rows; ++jr) {
      const float p = prow[jr];
#pragma unroll
      for (int c = 0; c < kOut; c += 8) {
        float vf[8];
        load8(Vt + jr * HD + c, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c + e] = __fmaf_rn(p, vf[e], acc[c + e]);
      }
    }
  }

  if (qvalid) {
    T* orow = out + (static_cast<size_t>(b) * N + qn) * (heads * HD) + h * HD + sub * kOut;
#pragma unroll
    for (int c = 0; c < kOut; c += 8) store8(orow + c, acc + c);
  }
}

template <typename T, int KD, int HD>
cudaError_t launch(const void* qkv, void* out, int B, int N, int heads, float scale, cudaStream_t stream) {
  constexpr int kKS = KRow<T, KD>::kStride;
  auto kv_bytes = [](int rows) { return static_cast<size_t>(rows) * (kKS + HD) * sizeof(T); };
  const size_t p_bytes = static_cast<size_t>(kQT) * kPS * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int resident = p_bytes + kv_bytes(N) <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = p_bytes + kv_bytes(resident ? N : kTK);
  auto kernel = attn_qkv_kernel<T, KD, HD>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kQT - 1) / kQT, heads, B);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(qkv), static_cast<T*>(out), N, heads,
                                           scale, resident);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, N, heads*(2kd+hd)) and out (B, N, heads*hd), contiguous, on the
// current device; dtype 0 = float32, 1 = bfloat16. Returns the cudaError_t
// of the launch.
extern "C" int attn_qkv_launch(const void* qkv, void* out, int B, int N, int heads, int kd, int hd,
                               float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || heads < 1 || B > 65535 || heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  // every YOLO11 size has head_dim 64 and key_dim 32
  if (kd != 32 || hd != 64) return static_cast<int>(err);
  if (dtype == 0) err = launch<float, 32, 64>(qkv, out, B, N, heads, scale, s);
  else if (dtype == 1) err = launch<__nv_bfloat16, 32, 64>(qkv, out, B, N, heads, scale, s);
  return static_cast<int>(err);
}

// qg (G, N, 2kd+hd) and out (G, N, hd), contiguous, on the current device;
// dtype as above. Returns the cudaError_t of the launch.
extern "C" int attn_packed_launch(const void* qg, void* out, int G, int N, int kd, int hd, float scale, int dtype,
                                  void* stream) {
  return attn_qkv_launch(qg, out, G, N, 1, kd, hd, scale, dtype, stream);
}
