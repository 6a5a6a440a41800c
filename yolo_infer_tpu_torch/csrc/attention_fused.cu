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
// exact (p = exp(s - m) / l with the row's final max m and sum l), and p is
// rounded to the input dtype before the PV product, as the JAX kernel does;
// the output is rounded to the input dtype. The normalisation is not
// deferred flash-style, which would move the rounding of p.
//
// What bounds it on the H100: bytes. At yolo11n, 640 px, batch 32 (N = 400,
// heads = 2, kd = 32, hd = 64) it moves ~9.8 MB for ~2.6 GFLOP (q.k twice,
// p.v once), far below the card's bf16 ridge, so the products have to run
// on the tensor cores for the arithmetic to stay near the bytes.
//
// bf16 design (attn_qkv_mma_kernel): a block per (128-query tile, head,
// batch row), 8 warps of 16 query rows, two blocks to an SM where the K/V
// fit. A warp keeps its 16x32 Q fragment in registers for the whole kernel.
// The head's K and V rows are staged in shared memory with 16-byte cp.async,
// rows padded by 16 bytes so ldmatrix reads 8 rows without bank conflicts;
// they stay resident when N x 224 B fits (N = 400: 100 KB; N = 1024: 224
// KB), otherwise 64-key tiles stream through a double-buffered ring (N =
// 1600). Both products are mma.sync m16n8k16 bf16 -> f32 with operands from
// ldmatrix (V through ldmatrix.trans), on 16x32 score sub-tiles. Pass 1
// computes the scores and the row's max and sum (quad shuffles over the 4
// threads of a row; the sum is rescaled online in f32 when the max grows).
// Pass 2 recomputes the scores and forms p = exp(s - m) / l in f32, the
// quotient correctly rounded from the row's reciprocal and one FMA
// correction step (cheaper than a division per element); it rounds p to
// bf16 with round-to-nearest-even and feeds it from the score accumulators
// straight into the PV product: the m16n8k16 accumulator layout is the next
// product's A-operand layout, so no p tile goes through shared memory. Keys
// past N are -inf before the max and 0 after (their K and V rows are
// zero-filled); query rows past N are not stored, and a warp whose 16 rows
// all lie past N skips the products.
//
// f32 design (attn_qkv_f32_kernel, the fp32 correctness paths only): on the
// tensor cores f32 means TF32, which misses the 1e-5 tolerance, so f32 slabs
// keep the CUDA-core body: four threads per query row, q.k chained through
// __fmaf_rn in a fixed order in three passes (max, sum, p and p v), p staged
// in a shared f32 tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kKD = 32;  // every YOLO11 size has key_dim 32 and head_dim 64
constexpr int kHD = 64;
constexpr int kStep = 2 * kKD + kHD;  // channels per head in the slab

// ------------------------------------------------------------------ bf16, tensor cores

constexpr int kMmaWarps = 8;               // 16 query rows each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaQT = 16 * kMmaWarps;     // query rows per block
constexpr int kTile = 64;                  // keys per tile (resident K/V are whole tiles)
constexpr int kSub = 32;                   // keys per score sub-tile in registers
constexpr int kKS = kKD + 8;      // K row in shared memory, bf16 (80 B)
constexpr int kVS = kHD + 8;      // V row in shared memory, bf16 (144 B)
constexpr size_t kTileBytes = static_cast<size_t>(kTile) * (kKS + kVS) * sizeof(__nv_bfloat16);

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled when !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a / b rounded to nearest from rb = RN(1/b): q = RN(a * rb) is within an ulp
// of a / b, the FMA residual a - q*b is exact, and one correction step gives
// RN(a / b) (Markstein's theorem; a, b and the quotient in the normal range)
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const float q = __fmul_rn(a, rb);
  return __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo, round to nearest even
  return *reinterpret_cast<const unsigned*>(&h);
}

__global__ void __launch_bounds__(kMmaThreads, 2)
attn_qkv_mma_kernel(const __nv_bfloat16* __restrict__ qkv, __nv_bfloat16* __restrict__ out, int N, int heads,
                    float scale, int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = (N + kTile - 1) / kTile;
  const int slots = resident ? tiles : 2;
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);  // slots*kTile rows x kKS
  __nv_bfloat16* Vs = Ks + static_cast<size_t>(slots) * kTile * kKS;  // slots*kTile rows x kVS

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c3 = heads * kStep;
  const __nv_bfloat16* base = qkv + static_cast<size_t>(b) * N * c3 + h * kStep;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;  // fragment row group and thread in the quad
  const int q0 = blockIdx.x * kMmaQT + warp * 16;
  const bool active = q0 < N;  // warp-uniform

  // Q's 16x32 A fragments (two k16 steps), straight from global memory
  unsigned qa[2][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = q0 + g + (e & 1) * 8, col = 16 * s + 2 * t + (e >> 1) * 8;
      qa[s][e] = row < N ? *reinterpret_cast<const unsigned*>(base + static_cast<size_t>(row) * c3 + col) : 0u;
    }
  }

  // keys [tile*kTile, +kTile) of this head into ring slot `slot`; rows past N zero-filled
  auto load_k = [&](int tile, int slot) {
    for (int idx = tid; idx < kTile * (kKD / 8); idx += kMmaThreads) {
      const int r = idx / (kKD / 8), c = idx % (kKD / 8), key = tile * kTile + r;
      cp_async16(Ks + (static_cast<size_t>(slot) * kTile + r) * kKS + 8 * c,
                 base + static_cast<size_t>(key < N ? key : 0) * c3 + kKD + 8 * c, key < N);
    }
  };
  auto load_v = [&](int tile, int slot) {
    for (int idx = tid; idx < kTile * (kHD / 8); idx += kMmaThreads) {
      const int r = idx / (kHD / 8), c = idx % (kHD / 8), key = tile * kTile + r;
      cp_async16(Vs + (static_cast<size_t>(slot) * kTile + r) * kVS + 8 * c,
                 base + static_cast<size_t>(key < N ? key : 0) * c3 + 2 * kKD + 8 * c, key < N);
    }
  };
  // the warp's 16x32 scores s = q.k * scale for keys [j0, j0 + kSub), staged
  // at ring row jr; keys past N at -inf. s[j] is the m16n8 accumulator of
  // keys 8j..8j+7: [0], [1] row g, keys 2t, 2t+1; [2], [3] row g + 8
  auto scores = [&](int j0, int jr, float (&s)[kSub / 8][4]) {
#pragma unroll
    for (int j = 0; j < kSub / 8; ++j) {
      unsigned kb[4];  // k16 step 0: kb[0], kb[1]; step 1: kb[2], kb[3]
      ldmatrix_x4(kb, Ks + static_cast<size_t>(jr + 8 * j + (lane & 7)) * kKS + 8 * (lane >> 3));
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      mma_bf16(s[j], qa[0], kb[0], kb[1]);
      mma_bf16(s[j], qa[1], kb[2], kb[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = j0 + 8 * j + 2 * t + (e & 1);
        s[j][e] = key < N ? __fmul_rn(s[j][e], scale) : -INFINITY;
      }
    }
  };

  if (resident) {  // K first (pass 1 needs only K), then V, which lands during pass 1
    for (int tile = 0; tile < tiles; ++tile) load_k(tile, tile);
    cp_async_commit();
    for (int tile = 0; tile < tiles; ++tile) load_v(tile, tile);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
  } else {
    load_k(0, 0);
    cp_async_commit();
  }

  // pass 1: the row's max m and sum l of exp(s - m) (rows g and g + 8)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    int slot = tile;
    if (!resident) {
      slot = tile & 1;
      if (tile + 1 < tiles) load_k(tile + 1, slot ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    for (int h2 = 0; active && h2 < kTile / kSub; ++h2) {
      float s[kSub / 8][4];
      scores(tile * kTile + h2 * kSub, slot * kTile + h2 * kSub, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mt = -INFINITY;
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) mt = fmaxf(mt, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float mn = fmaxf(m[r], mt);  // finite: key 0 lies in the first sub-tile
        float lt = __fmul_rn(l[r], expf(__fsub_rn(m[r], mn)));
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          lt = __fadd_rn(lt, expf(__fsub_rn(s[j][2 * r], mn)));
          lt = __fadd_rn(lt, expf(__fsub_rn(s[j][2 * r + 1], mn)));
        }
        m[r] = mn;
        l[r] = lt;
      }
    }
    if (!resident) __syncthreads();  // this slot is refilled two tiles on
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }

  // pass 2: p = exp(s - m) / l rounded to bf16, o += p v
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  if (resident) {
    cp_async_wait<0>();
    __syncthreads();
  } else {
    load_k(0, 0);
    load_v(0, 0);
    cp_async_commit();
  }
  for (int tile = 0; tile < tiles; ++tile) {
    int slot = tile;
    if (!resident) {
      slot = tile & 1;
      if (tile + 1 < tiles) {
        load_k(tile + 1, slot ^ 1);
        load_v(tile + 1, slot ^ 1);
      }
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
    }
    for (int h2 = 0; active && h2 < kTile / kSub; ++h2) {
      float s[kSub / 8][4];
      const int jr = slot * kTile + h2 * kSub;
      scores(tile * kTile + h2 * kSub, jr, s);
#pragma unroll
      for (int kk = 0; kk < kSub / 16; ++kk) {  // k16 steps over the sub-tile's keys
        float p[2][4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[0][e] = div_rn(expf(__fsub_rn(s[2 * kk][e], m[e >> 1])), l[e >> 1], rl[e >> 1]);
          p[1][e] = div_rn(expf(__fsub_rn(s[2 * kk + 1][e], m[e >> 1])), l[e >> 1], rl[e >> 1]);
        }
        // the two score accumulators of keys 16kk..16kk+15 are the A fragment of P
        const unsigned pa[4] = {pack_bf16(p[0][0], p[0][1]), pack_bf16(p[0][2], p[0][3]),
                                pack_bf16(p[1][0], p[1][1]), pack_bf16(p[1][2], p[1][3])};
#pragma unroll
        for (int c = 0; c < 4; ++c) {  // hd columns 16c..16c+15: two n8 blocks
          unsigned vb[4];
          ldmatrix_x4_trans(vb, Vs + static_cast<size_t>(jr + 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1)) * kVS +
                                    16 * c + 8 * (lane >> 4));
          mma_bf16(o[2 * c], pa, vb[0], vb[1]);
          mma_bf16(o[2 * c + 1], pa, vb[2], vb[3]);
        }
      }
    }
    if (!resident) __syncthreads();
  }

  if (active) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + g + 8 * r;
      if (row >= N) continue;
      __nv_bfloat16* orow = out + (static_cast<size_t>(b) * N + row) * (heads * kHD) + h * kHD + 2 * t;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        *reinterpret_cast<unsigned*>(orow + 8 * n) = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
      }
    }
  }
}

cudaError_t launch_mma(const void* qkv, void* out, int B, int N, int heads, float scale, cudaStream_t stream) {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int tiles = (N + kTile - 1) / kTile;
  const int resident = static_cast<size_t>(tiles) * kTileBytes <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = (resident ? tiles : 2) * kTileBytes;
  err = cudaFuncSetAttribute(attn_qkv_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kMmaQT - 1) / kMmaQT, heads, B);
  attn_qkv_mma_kernel<<<grid, kMmaThreads, smem, stream>>>(static_cast<const __nv_bfloat16*>(qkv),
                                                           static_cast<__nv_bfloat16*>(out), N, heads, scale,
                                                           resident);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ f32, CUDA cores

constexpr int kThreads = 256;
constexpr int kQT = 64;                      // query rows per block
constexpr int kTK = 64;                      // keys per tile
constexpr int kRowThreads = kThreads / kQT;  // threads sharing one query row
constexpr int kPS = kTK + 4;                 // p tile row (floats): 16-byte rows, no bank conflicts
constexpr int kF32KS = kKD + 4;              // K row in shared memory (floats), padded by 16 bytes
constexpr int kOut = kHD / kRowThreads;      // contiguous output columns per thread

__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
__device__ __forceinline__ void store8(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(f[4], f[5], f[6], f[7]);
}
__device__ __forceinline__ void copy8(float* d, const float* s) {
  reinterpret_cast<float4*>(d)[0] = reinterpret_cast<const float4*>(s)[0];
  reinterpret_cast<float4*>(d)[1] = reinterpret_cast<const float4*>(s)[1];
}

__global__ void __launch_bounds__(kThreads)
attn_qkv_f32_kernel(const float* __restrict__ qkv, float* __restrict__ out, int N, int heads, float scale,
                    int resident) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);                   // kQT x kPS
  float* Ks = Ps + kQT * kPS;                                   // rows x kF32KS
  const int kv_rows = resident ? N : kTK;
  float* Vs = Ks + static_cast<size_t>(kv_rows) * kF32KS;       // rows x kHD

  const int q0 = blockIdx.x * kQT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int c3 = heads * kStep;
  const float* base = qkv + static_cast<size_t>(b) * N * c3 + h * kStep;

  const int tid = threadIdx.x;
  const int r = tid / kRowThreads;
  const int sub = tid % kRowThreads;
  const int qn = q0 + r;
  const bool qvalid = qn < N;

  float q[kKD];
#pragma unroll
  for (int c = 0; c < kKD; c += 8) {
    if (qvalid) {
      load8(base + static_cast<size_t>(qn) * c3 + c, q + c);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) q[c + e] = 0.f;
    }
  }

  // copy keys [j0, j0 + rows) of this head into Ks (and Vs) from row 0
  auto load_kv = [&](int j0, int rows, bool with_v) {
    for (int idx = tid; idx < rows * (kKD / 8); idx += kThreads) {
      const int jr = idx / (kKD / 8), c = (idx - jr * (kKD / 8)) * 8;
      copy8(Ks + jr * kF32KS + c, base + static_cast<size_t>(j0 + jr) * c3 + kKD + c);
    }
    if (with_v) {
      for (int idx = tid; idx < rows * (kHD / 8); idx += kThreads) {
        const int jr = idx / (kHD / 8), c = (idx - jr * (kHD / 8)) * 8;
        copy8(Vs + jr * kHD + c, base + static_cast<size_t>(j0 + jr) * c3 + 2 * kKD + c);
      }
    }
  };
  // q . k in a fixed order, so every pass sees the same bits
  auto score = [&](const float* krow) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < kKD; c += 8) {
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
    const float* Kt = Ks + (resident ? j0 * kF32KS : 0);
    if (!resident) {
      __syncthreads();
      load_kv(j0, rows, false);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) m = fmaxf(m, score(Kt + jr * kF32KS));
  }
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  // pass 2: sum of exp(s - max)
  float l = 0.f;
  for (int j0 = 0; j0 < N; j0 += kTK) {
    const int rows = min(kTK, N - j0);
    const float* Kt = Ks + (resident ? j0 * kF32KS : 0);
    if (!resident) {
      __syncthreads();
      load_kv(j0, rows, false);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) l = __fadd_rn(l, expf(__fsub_rn(score(Kt + jr * kF32KS), m)));
  }
#pragma unroll
  for (int o = 1; o < kRowThreads; o <<= 1) l = __fadd_rn(l, __shfl_xor_sync(0xffffffffu, l, o));

  // pass 3: p = e / l, o += p v over this thread's kOut columns
  float acc[kOut];
#pragma unroll
  for (int i = 0; i < kOut; ++i) acc[i] = 0.f;
  float* prow = Ps + r * kPS;
  for (int j0 = 0; j0 < N; j0 += kTK) {
    const int rows = min(kTK, N - j0);
    const float* Kt = Ks + (resident ? j0 * kF32KS : 0);
    const float* Vt = Vs + (resident ? j0 * kHD : 0) + sub * kOut;
    __syncthreads();  // the previous tile's p (and K/V) are no longer read
    if (!resident) {
      load_kv(j0, rows, true);
      __syncthreads();
    }
    for (int jr = sub; jr < rows; jr += kRowThreads) {
      prow[jr] = __fdiv_rn(expf(__fsub_rn(score(Kt + jr * kF32KS), m)), l);
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
          load8(Vt + (jr + t) * kHD + c, vf);
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
        load8(Vt + jr * kHD + c, vf);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c + e] = __fmaf_rn(p, vf[e], acc[c + e]);
      }
    }
  }

  if (qvalid) {
    float* orow = out + (static_cast<size_t>(b) * N + qn) * (heads * kHD) + h * kHD + sub * kOut;
#pragma unroll
    for (int c = 0; c < kOut; c += 8) store8(orow + c, acc + c);
  }
}

cudaError_t launch_f32(const void* qkv, void* out, int B, int N, int heads, float scale, cudaStream_t stream) {
  auto kv_bytes = [](int rows) { return static_cast<size_t>(rows) * (kF32KS + kHD) * sizeof(float); };
  const size_t p_bytes = static_cast<size_t>(kQT) * kPS * sizeof(float);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int resident = p_bytes + kv_bytes(N) <= static_cast<size_t>(optin) ? 1 : 0;
  const size_t smem = p_bytes + kv_bytes(resident ? N : kTK);
  err = cudaFuncSetAttribute(attn_qkv_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kQT - 1) / kQT, heads, B);
  attn_qkv_f32_kernel<<<grid, kThreads, smem, stream>>>(static_cast<const float*>(qkv), static_cast<float*>(out), N,
                                                        heads, scale, resident);
  return cudaGetLastError();
}

}  // namespace

// qkv (B, N, heads*(2kd+hd)) and out (B, N, heads*hd), contiguous and
// 16-byte aligned, on the current device; dtype 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch.
extern "C" int attn_qkv_launch(const void* qkv, void* out, int B, int N, int heads, int kd, int hd,
                               float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || heads < 1 || B > 65535 || heads > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (kd != kKD || hd != kHD) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0) err = launch_f32(qkv, out, B, N, heads, scale, s);
  else if (dtype == 1) err = launch_mma(qkv, out, B, N, heads, scale, s);
  return static_cast<int>(err);
}

// qg (G, N, 2kd+hd) and out (G, N, hd), contiguous, on the current device;
// dtype as above. Returns the cudaError_t of the launch.
extern "C" int attn_packed_launch(const void* qg, void* out, int G, int N, int kd, int hd, float scale, int dtype,
                                  void* stream) {
  return attn_qkv_launch(qg, out, G, N, 1, kd, hd, scale, dtype, stream);
}
