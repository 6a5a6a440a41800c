// Alternative designs of kernel D for tests/torch_kernel_breakdown.py: each
// computes the same bytes as csrc/mask_pack.cu (held to the plain version in
// the breakdown) and takes the same arguments as mask_pack_launch. Built with
// kernel D's flags and -I yolo_infer_tpu_torch/csrc.
//
//   mask_pack_staged_launch  a grid of resident blocks looping over
//       (instance, band of up to 16 source rows) tiles, three bands in
//       flight: each band and its halo row above and below staged into shared
//       memory by 16-byte cp.async, so every source float comes from device
//       memory once; a thread takes one (source row, packed word) step,
//       reading rows i-1, i, i+1 at columns 8c-1 .. 8c+8 from the band, with
//       csrc/mask_pack.cu's tap arithmetic, into a staged output tile that
//       the block stores 16 bytes at a time; a band with nothing above 0.5
//       stores zeros without a tap, and so does a step
//   mask_pack_staged_stores4_launch  the same, each thread storing its four
//       words straight to device memory (4-byte stores)
//   mask_pack_staged_stages1_launch  the same with one band in flight
//   mask_pack_ballot_launch  the staged bands, but each output row's H taps
//       computed once into a per-warp row in shared memory, then lane L
//       computes pixel 8(L/8) + 7 - L%8 of each 32-pixel word and
//       __ballot_sync packs the word; a row whose H taps are all <= 0.5 is
//       zero

#include <math.h>

#include "mask_pack.cu"

namespace {

constexpr int kBandMax = 16;  // source rows per band
constexpr int kMaxThreads = 512;
constexpr int kSmemBudget = 64 * 1024;  // per block, for the band height

__host__ __device__ constexpr int staged_smem_bytes(int stages, int R, int W) {
  // `stages` staged bands of R + 2 rows, the output tile of 4R rows x W/8 words
  return W * (stages * 4 * (R + 2) + 2 * R);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// a tile's instance and band, stepped by the grid
struct Tile {
  long long inst;
  int band;
  __device__ __forceinline__ void advance(long long dq, int dr, int bands) {
    inst += dq;
    band += dr;
    if (band >= bands) {
      band -= bands;
      ++inst;
    }
  }
};

// Issue the copies of tile t's band: rows i0-1 .. i0+rows, clamped to the
// image, into `buf` (row stride W).
__device__ __forceinline__ void stage_band(const float* __restrict__ soft, float* buf, const Tile& t, int H, int W,
                                           int R) {
  const int i0 = t.band * R;
  const int Q = W >> 2;  // float4 per row
  const int n = (min(R, H - i0) + 2) * Q;
  const float* base = soft + static_cast<size_t>(t.inst) * H * W;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const int r = k / Q, q = k - r * Q;
    const int src = min(max(i0 - 1 + r, 0), H - 1);
    cp_async16(buf + r * W + 4 * q, base + static_cast<size_t>(src) * W + 4 * q);
  }
}

// the ten columns 8c-1 .. 8c+8 of a staged row (clamped to the image)
__device__ __forceinline__ void load_staged_row(const float* row, int c, int W, float v[10]) {
  const float4 lo = *reinterpret_cast<const float4*>(row + 8 * c);
  const float4 hi = *reinterpret_cast<const float4*>(row + 8 * c + 4);
  v[0] = row[max(8 * c - 1, 0)];
  v[1] = lo.x; v[2] = lo.y; v[3] = lo.z; v[4] = lo.w;
  v[5] = hi.x; v[6] = hi.y; v[7] = hi.z; v[8] = hi.w;
  v[9] = row[min(8 * c + 8, W - 1)];
}

// Step (source row ii of the band, word c): the four words of output rows
// 4ii .. 4ii+3 at `dst` (row stride C words).
__device__ __forceinline__ void pack_step(const float* band, uint32_t* dst, int ii, int c, int W, int C) {
  float prv[10], cur[10], nxt[10];
  load_staged_row(band + ii * W, c, W, prv);
  load_staged_row(band + (ii + 1) * W, c, W, cur);
  load_staged_row(band + (ii + 2) * W, c, W, nxt);
  uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;
  if (above_half(prv) || above_half(cur) || above_half(nxt)) {
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
  uint32_t* tw = dst + 4 * ii * C + c;
  tw[0] = w0;
  tw[C] = w1;
  tw[2 * C] = w2;
  tw[3 * C] = w3;
}

// The non-skipped band, ballot design: warp w takes output rows w, w +
// nwarps, ...; `hbuf` holds W + 2 floats per warp (the row's H taps with its
// edge columns repeated on each side).
__device__ __forceinline__ void pack_band_ballot(const float* band, uint32_t* tile, float* hbuf, int rows, int W,
                                                 int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  float* hrow = hbuf + warp * (W + 2) + 1;
  // this lane's pixel of a word, its W phase, and its neighbour's side
  const int p = 8 * (lane >> 3) + 7 - (lane & 7);
  const int kw = p & 3, qoff = p >> 2;
  const float wself = (kw == 0 || kw == 3) ? 0.625f : 0.875f;
  const float wnb = (kw == 0 || kw == 3) ? 0.375f : 0.125f;
  const int dn = kw < 2 ? -1 : 1;
  for (int r = warp; r < 4 * rows; r += nwarps) {
    const int ii = r >> 2, kh = r & 3;
    const float* a = band + (ii + (kh < 2 ? 0 : 1)) * W;  // rows (i-1, i) or (i, i+1)
    const float* b = a + W;
    const float wa = kh == 0 ? 0.375f : kh == 1 ? 0.125f : kh == 2 ? 0.875f : 0.625f;
    const float wb = kh == 0 ? 0.625f : kh == 1 ? 0.875f : kh == 2 ? 0.125f : 0.375f;
    bool any = false;
    for (int j = lane; j < W; j += 32) {
      const float h = __fadd_rn(__fmul_rn(wa, a[j]), __fmul_rn(wb, b[j]));
      hrow[j] = h;
      any |= h > 0.5f;
    }
    const bool live = __any_sync(0xffffffffu, any);
    __syncwarp();
    if (lane == 0) {
      hrow[-1] = hrow[0];
      hrow[W] = hrow[W - 1];
    }
    __syncwarp();
    uint32_t* trow = tile + r * C;
    for (int c = 0; c < C; ++c) {
      uint32_t word = 0u;
      if (live) {
        const int q = 8 * c + qoff;
        const float x = __fadd_rn(__fmul_rn(wnb, hrow[q + dn]), __fmul_rn(wself, hrow[q]));
        word = __ballot_sync(0xffffffffu, x > 0.5f);
      }
      if (lane == 0) trow[c] = word;
    }
    __syncwarp();  // the row buffer is reused by the next row
  }
}

enum class Pack { kSteps, kStepsStores4, kBallot };

template <int kStages, Pack kPack>
__global__ void __launch_bounds__(kMaxThreads)
mask_pack_staged_kernel(const float* __restrict__ soft, uint32_t* __restrict__ out, long long n, int H, int W, int R,
                        int bands) {
  extern __shared__ __align__(16) float smem[];
  const int C = W >> 3;  // 32-bit words per packed row
  const int band_floats = (R + 2) * W;
  uint32_t* tile = reinterpret_cast<uint32_t*>(smem + kStages * band_floats);
  float* hbuf = reinterpret_cast<float*>(tile + 4 * R * C);  // the ballot design's H-tap rows

  // this block's tiles: blockIdx.x, then every gridDim.x-th
  const long long dq = gridDim.x / bands;
  const int dr = static_cast<int>(gridDim.x % bands);
  Tile cur{blockIdx.x / bands, static_cast<int>(blockIdx.x % bands)};
  Tile next = cur;  // the next tile to stage
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (next.inst < n) stage_band(soft, smem + s * band_floats, next, H, W, R);
    cp_async_commit();
    next.advance(dq, dr, bands);
  }
  for (int k = 0; cur.inst < n; ++k, cur.advance(dq, dr, bands)) {
    if (next.inst < n) stage_band(soft, smem + ((k + kStages - 1) % kStages) * band_floats, next, H, W, R);
    cp_async_commit();
    next.advance(dq, dr, bands);
    cp_async_wait<kStages - 1>();  // this thread's copies of tile k have landed
    __syncthreads();               // and everyone's

    const float* band = smem + (k % kStages) * band_floats;
    const int i0 = cur.band * R;
    const int rows = min(R, H - i0);
    const int nsteps = rows * C;  // also the tile's uint4 count (4 rows x C words per source row)
    uint4* dst = reinterpret_cast<uint4*>(out + (static_cast<size_t>(cur.inst) * 4 * H + 4 * i0) * C);
    float m = -INFINITY;
    for (int t = threadIdx.x; t < (rows + 2) * (W >> 2); t += blockDim.x) {
      const float4 v = reinterpret_cast<const float4*>(band)[t];
      m = fmaxf(m, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
    }
    if (!__syncthreads_or(m > 0.5f)) {
      for (int t = threadIdx.x; t < nsteps; t += blockDim.x) dst[t] = make_uint4(0u, 0u, 0u, 0u);
    } else if (kPack == Pack::kStepsStores4) {
      for (int t = threadIdx.x; t < nsteps; t += blockDim.x) {
        const int ii = t / C;
        pack_step(band, reinterpret_cast<uint32_t*>(dst), ii, t - ii * C, W, C);
      }
    } else {
      if (kPack == Pack::kBallot) {
        pack_band_ballot(band, tile, hbuf, rows, W, C);
      } else {
        for (int t = threadIdx.x; t < nsteps; t += blockDim.x) {
          const int ii = t / C;
          pack_step(band, tile, ii, t - ii * C, W, C);
        }
      }
      __syncthreads();
      for (int t = threadIdx.x; t < nsteps; t += blockDim.x) dst[t] = reinterpret_cast<const uint4*>(tile)[t];
    }
    __syncthreads();  // band k % kStages and the output tile are free again
  }
}

template <int kStages, Pack kPack>
int launch_staged(const void* soft, void* out, long long n, int H, int W, void* stream) {
  if (n < 1 || H < 1 || W < 8 || W % 8) return static_cast<int>(cudaErrorInvalidValue);
  int R = kBandMax;
  while (R > 1 && staged_smem_bytes(kStages, R, W) > kSmemBudget) --R;
  const int threads = min(kMaxThreads, (R * (W / 8) + 31) / 32 * 32);
  const int smem = staged_smem_bytes(kStages, R, W) + (kPack == Pack::kBallot ? (threads / 32) * (W + 2) * 4 : 0);
  const auto kernel = mask_pack_staged_kernel<kStages, kPack>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) != cudaSuccess)
    return static_cast<int>(err);
  const int bands = (H + R - 1) / R;
  const long long tiles = n * bands;
  const long long cap = static_cast<long long>(max(per_sm, 1)) * sms;  // every block resident at once
  kernel<<<static_cast<unsigned>(tiles < cap ? tiles : cap), threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(soft), static_cast<uint32_t*>(out), n, H, W, R, bands);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mask_pack_staged_launch(const void* soft, void* out, long long n, int H, int W, void* stream) {
  return launch_staged<3, Pack::kSteps>(soft, out, n, H, W, stream);
}

extern "C" int mask_pack_staged_stores4_launch(const void* soft, void* out, long long n, int H, int W,
                                               void* stream) {
  return launch_staged<3, Pack::kStepsStores4>(soft, out, n, H, W, stream);
}

extern "C" int mask_pack_staged_stages1_launch(const void* soft, void* out, long long n, int H, int W,
                                               void* stream) {
  return launch_staged<1, Pack::kSteps>(soft, out, n, H, W, stream);
}

extern "C" int mask_pack_ballot_launch(const void* soft, void* out, long long n, int H, int W, void* stream) {
  return launch_staged<3, Pack::kBallot>(soft, out, n, H, W, stream);
}
