// The ring-staged design of the strip-staged walk, for
// tests/torch_kernel_breakdown.py (included by greedy_nms_variants.cu after
// csrc/greedy_nms.cu, whose nms_walk.cuh it builds on): whole strips staged
// in a shared-memory ring. Warp 1 copies each valid row's run of words from
// the strip's own to ceil(E/32) into a ring of up to 8 stages (a stage is 32
// rows of 64, 128 or 256 words, the depth sized by K), by one 1-D
// cp.async.bulk per row completing on the stage's mbarrier (kBulkStage) or by
// 16-byte cp.async; warp 0 walks; with kSplit, warps 2..7 OR the kept rows'
// words from s+2 on out of the staged strip into a shared removed set (thread
// h owns words h and h+192), without it warp 0 ORs every word itself. The
// walk's bit tests and carry are those of csrc/nms_walk.cuh.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ring_walk {
namespace {

using namespace nms_walk;

constexpr int kRingMaxStages = 8;
constexpr int kHelperThreads = kHelperWarps * 32;
constexpr int kSmemPerBlock = 232448;  // the H100's 227 KB a block can ask for

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// The ring-staged walk. kS is the stage's row stride in
// words, a compile-time constant >= W so that every load of a staged row is
// an immediate offset from the stage's base. Dynamic shared memory: the ring
// (stages x 32 rows x kS words), the removed set and the kept bits
// (ceil(K/32) words each) and the K flags.
template <bool kSplit, bool kBulkStage, int kS>
__global__ void __launch_bounds__(kWalkThreads)
ring_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int K, int W, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full_bar[kRingMaxStages], empty_bar[kRingMaxStages], kept_bar[kHandoff],
      ored_bar[kHandoff];
  const int nwords = (K + 31) >> 5;
  uint32_t* ring = reinterpret_cast<uint32_t*>(smem);
  uint32_t* sremoved = ring + stages * 32 * kS;
  uint32_t* skept = sremoved + nwords;
  uint8_t* svalid = reinterpret_cast<uint8_t*>(skept + nwords);

  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t* mb = bits + static_cast<size_t>(img) * K * W;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full_bar[s], kBulkStage ? 1 : 32);
      mbar_init(&empty_bar[s], kSplit ? 1 + kHelperWarps : 1);
    }
    for (int s = 0; s < kHandoff; ++s) {
      mbar_init(&kept_bar[s], 1);
      mbar_init(&ored_bar[s], kHelperWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int E = stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);  // syncs the block
  const int We = (E + 31) >> 5;  // the walk's strips, and the words it reads
  if (We == 0) return;
  for (int c = threadIdx.x; c < We; c += kWalkThreads) sremoved[c] = 0u;
  __syncthreads();

  // each role walks the strips in order: stage st of the ring, its fill's parity
  int st = 0;
  uint32_t phase = 0u;
  const auto advance = [&]() {
    if (++st == stages) {
      st = 0;
      phase ^= 1u;
    }
  };

  if (warp == 1) {
    // producer: strip s into stage s % stages, once strip s - stages has left it
    const int We4 = (We + 3) & ~3;
    for (int s = 0; s < We; ++s, advance()) {
      if (s >= stages) mbar_wait(&empty_bar[st], phase ^ 1u);
      const int row = (s << 5) + lane;
      const int c0 = s & ~3;  // from the strip's own word, rounded down to 16 bytes
      const bool take = row < E && svalid[row];
      uint32_t* dst = ring + st * 32 * kS + c0;
      const uint32_t* src = mb + static_cast<size_t>(s << 5) * W + c0;
      if (kBulkStage) {  // lane t: row t's run, one bulk copy
        const uint32_t bytes = take ? static_cast<uint32_t>(We4 - c0) * 4u : 0u;
        const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
        if (lane == 0) mbar_arrive_expect_tx(&full_bar[st], total);
        __syncwarp();
        if (take) bulk_copy(dst + lane * kS, src + static_cast<size_t>(lane) * W, bytes, &full_bar[st]);
      } else {  // row by row, the lanes on consecutive 16-byte chunks
        const int chunks = (We4 - c0) >> 2;
        for (uint32_t rows = __ballot_sync(0xffffffffu, take); rows; rows &= rows - 1) {
          const int t = __ffs(rows) - 1;
          for (int q = lane; q < chunks; q += 32) cp_async16(dst + t * kS + 4 * q, src + static_cast<size_t>(t) * W + 4 * q);
        }
        mbar_arrive_on_copies(&full_bar[st]);
      }
    }
  } else if (warp == 0) {
    const int wpl = (We + 31) >> 5;  // removed-set words per lane (kSplit false)
    uint32_t removed[kWalkMaxWordsPerLane];
#pragma unroll
    for (int g = 0; g < kWalkMaxWordsPerLane; ++g) removed[g] = 0u;
    // carry[d]: the kept rows of strips w-kWalkCarry .. w-1, their word w+d (kSplit)
    uint32_t carry[kWalkCarry];
#pragma unroll
    for (int d = 0; d < kWalkCarry; ++d) carry[d] = 0u;
    for (int w = 0; w < We; ++w, advance()) {
      const uint32_t* strip = ring + st * 32 * kS;
      const int i0 = w << 5;
      const int n = min(32, E - i0);
      // invalid candidates and rows past E (never staged) count as removed
      const uint32_t invalid = ~__ballot_sync(0xffffffffu, lane < n && svalid[i0 + lane]);
      mbar_wait(&full_bar[st], phase);
      // the strip's words go out before the wait on the helpers, so their
      // latency hides behind it
      uint32_t diag[32], next[kWalkCarry][32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        diag[t] = strip[t * kS + w];
#pragma unroll
        for (int d = 0; d < kWalkCarry; ++d) next[d][t] = kSplit && w + 1 + d < We ? strip[t * kS + w + 1 + d] : 0u;
      }
      uint32_t cur;
      if (kSplit) {
        const int helped = w - kWalkCarry - 1;  // the helpers' strip that word w waits for
        if (helped >= 0) mbar_wait(&ored_bar[helped % kHandoff], (helped / kHandoff) & 1);
        cur = sremoved[w] | carry[0] | invalid;
      } else {
        uint32_t mine = 0u;
#pragma unroll
        for (int g = 0; g < kWalkMaxWordsPerLane; ++g)
          if (g == (w >> 5)) mine = removed[g];
        cur = __shfl_sync(0xffffffffu, mine, w & 31) | invalid;
      }
      // the chain: candidate i0+t is kept when bit t is clear, and then its
      // row's word joins; the carry rides on the same predicate
      uint32_t add[kWalkCarry];
#pragma unroll
      for (int d = 0; d < kWalkCarry; ++d) add[d] = 0u;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        if (!(cur & (1u << t))) {
          cur |= diag[t];
#pragma unroll
          for (int d = 0; d < kWalkCarry; ++d) add[d] |= next[d][t];
        }
      }
      const uint32_t kept = ~cur;  // no row holds a bit at or below its own rank
      if (i0 + lane < K) kb[i0 + lane] = (kept >> lane) & 1u;
      if (kSplit) {
#pragma unroll
        for (int d = 0; d < kWalkCarry; ++d) carry[d] = (d + 1 < kWalkCarry ? carry[d + 1] : 0u) | add[d];
        if (lane == 0) skept[w] = kept;
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&kept_bar[w % kHandoff]);
          mbar_arrive(&empty_bar[st]);
        }
      } else {
        // every kept row's words from w+1 on, under masks
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const uint32_t take = 0u - (kept >> t & 1u);
          const uint32_t* row = strip + t * kS;
#pragma unroll
          for (int g = 0; g < kWalkMaxWordsPerLane; ++g) {
            const int c = g * 32 + lane;
            if (g < wpl && c > w && c < We) removed[g] |= row[c] & take;
          }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty_bar[st]);
      }
    }
  } else if (kSplit) {
    // helpers: strip s's kept rows into words s+kWalkCarry+1 .. We-1, which
    // the walk reads from strip s+kWalkCarry+1 on; thread h owns words h and
    // h + kHelperThreads
    const int h = threadIdx.x - 64;
    uint32_t owned[2] = {0u, 0u};
    for (int s = 0; s + kWalkCarry + 1 < We; ++s, advance()) {
      mbar_wait(&kept_bar[s % kHandoff], (s / kHandoff) & 1);
      mbar_wait(&full_bar[st], phase);  // complete already: orders the copy's writes before these reads
      const uint32_t kept = skept[s];
      const uint32_t* strip = ring + st * 32 * kS;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int c = h + g * kHelperThreads;
        if (c >= s + kWalkCarry + 1 && c < We) {
          // all 32 rows under their masks: the loads wait on no branch and
          // go out together (a warp reads 32 consecutive words of a row)
          uint32_t acc = 0u;
#pragma unroll
          for (int t = 0; t < 32; ++t) acc |= strip[t * kS + c] & (0u - (kept >> t & 1u));
          owned[g] |= acc;
          sremoved[c] = owned[g];
        }
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&ored_bar[s % kHandoff]);
        mbar_arrive(&empty_bar[st]);
      }
    }
  }
}

// One stride class of the ring-staged walk: the ring sized by K.
template <bool kSplit, bool kBulkStage, int kS>
cudaError_t launch_ring_stride(const uint32_t* bits, const uint8_t* valid, uint8_t* keep, int B, int K, int W,
                              cudaStream_t stream) {
  const size_t extras = 2 * static_cast<size_t>((K + 31) / 32) * sizeof(uint32_t) + K;
  const size_t stage_bytes = 32 * static_cast<size_t>(kS) * sizeof(uint32_t);
  const size_t budget = kSmemPerBlock - 1024;  // the kernel's static shared memory
  const size_t fit = (budget - extras) / stage_bytes;
  const int stages = fit < kRingMaxStages ? static_cast<int>(fit) : kRingMaxStages;
  if (stages < 2) return cudaErrorInvalidValue;
  const size_t smem = stages * stage_bytes + extras;
  const auto kernel = ring_walk_kernel<kSplit, kBulkStage, kS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<B, kWalkThreads, smem, stream>>>(bits, valid, keep, K, W, stages);
  return cudaGetLastError();
}

template <bool kSplit, bool kBulkStage>
cudaError_t launch_ring_walk(const uint32_t* bits, const uint8_t* valid, uint8_t* keep, int B, int K,
                             cudaStream_t stream) {
  const int W = bits_stride(K);
  if (W <= 64) return launch_ring_stride<kSplit, kBulkStage, 64>(bits, valid, keep, B, K, W, stream);
  if (W <= 128) return launch_ring_stride<kSplit, kBulkStage, 128>(bits, valid, keep, B, K, W, stream);
  return launch_ring_stride<kSplit, kBulkStage, 256>(bits, valid, keep, B, K, W, stream);
}

}  // namespace
}  // namespace ring_walk
