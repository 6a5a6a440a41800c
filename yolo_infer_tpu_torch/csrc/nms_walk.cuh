// The greedy walk shared by the keep-mask kernels A (nms_fused.cu), C
// (rotated_nms_fused.cu) and G (greedy_nms.cu).
//
// Replaces: the sequential half of the TPU kernels nms_keep_pallas,
// rotated_nms_keep_pallas (yolo_infer_tpu/ops/pallas/nms_fused.py) and
// greedy_nms_pallas (yolo_infer_tpu/ops/pallas/nms_kernel.py), which sweep the
// greedy fixpoint over a (K, K) block held in VMEM.
//
// Each kernel first forms the strictly upper-triangular suppression bitmask
// of one image: K rows of bits_stride(K) 32-bit words (ceil(K/32) padded to a
// multiple of 4, so every row starts on 16 bytes), bit j%32 of word j/32 of
// row i set when i < j and candidate i overlaps candidate j past the
// threshold. Then one warp walks the score-sorted candidates in rank order:
// candidate i is kept when it is valid and no kept candidate removed it, and
// a kept candidate's row joins the removed set. That is sequential greedy
// NMS, the limit of the JAX package's fixpoint sweeps, so the keep mask equals
// the fixpoint's bit for bit.
//
// What the walk reads: for a valid row i < E (E is one past the image's last
// valid candidate), words i/32 .. ceil(E/32)-1, and in word i/32 no bit at or
// below i. Nothing else of the mask need be written: an invalid row is never
// kept, so never ORed in, and no candidate at or past E is ever kept.
//
// What bounds it on the H100: the serial chain. A strip of 32 candidates
// needs the removed set's word under it and each row's word there; each
// decision tests one bit of that word and ORs one row word into it. K/32
// strips per image, one block per image on B SMs: the latency of each strip's
// wait, loads and 32 dependent decisions, not bytes or operations.
//
// Design: one warp-specialised block per image, at every K up to kWalkMaxK
// (A's serving pool of 384, C's of 1024, G's validation pool of 4096), with
// no __syncthreads after set-up. The walk needs only two words of each row
// of a strip (its own and the next); the rest of a kept row matters only to
// later strips.
//   - Warp 1 stages those words for kWalkStages strips ahead: lane t copies
//     row t's 16-byte chunks from the strip's own word (rounded down to 16
//     bytes) on, by cp.async, and arrives on the stage's mbarrier when they
//     land (cp.async.mbarrier.arrive); a stage is refilled once the walk has
//     arrived on its second mbarrier. 1 KB a strip.
//   - Warp 0 waits only on the barriers of the strip it is about to walk. The
//     removed set's word w is the helpers' word (kept rows of strips up to
//     w-kWalkCarry-1) ORed with a carry the walk itself took from the
//     kWalkCarry strips before (their kept rows' words up to kWalkCarry
//     past their own). The 32 decisions are one bit test and one
//     predicated OR each; the carry is ORed under the same predicate, off
//     the chain. The strip's kept bits are published to shared memory.
//   - Warps 2..7 take the strips in turn, each a strip at a time: the
//     helper reads the strip's rows' words from s+kWalkCarry+1 on straight
//     from global memory (the bitmask was just written: mostly L2), all 32
//     rows at once, the first loads before the strip's kept bits are out;
//     then ORs the kept rows' words into the shared removed set with
//     atomicOr and arrives on the strip's barrier. Six strips are in
//     flight among the helpers.
//   Every decision of a strip takes all 32 bits of its word at once: with no
//   row bit at or below its own rank, the kept set is the complement of the
//   removed word after the strip.
//   (Staging whole strips in a shared-memory ring, by 1-D bulk copies or by
//   16-byte cp.async, measured slower: one warp's copies of ~8 KB a strip
//   set the pace. tests/kernel_variants/ring_walk.cuh keeps that design. So
//   did staging the whole mask in shared memory for K <= 1024 and walking it
//   with one warp, at A's K = 384 and C's K = 1024 alike:
//   tests/kernel_variants/resident_walk.cuh keeps that design.)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace nms_walk {
namespace {

constexpr int kWalkThreads = 256;
constexpr int kWalkMaxWordsPerLane = 8;
constexpr int kWalkMaxK = 32 * 32 * kWalkMaxWordsPerLane;  // 8192
constexpr int kWalkStages = 16;  // strips of the walk's words staged ahead of it
constexpr int kStageWords = 8;   // words per row and stage: the strip's own word rounded down to 16 bytes, on
constexpr int kWalkCarry = 1;    // words past its own that warp 0 ORs itself (at most kStageWords - 4)
constexpr int kHandoff = 8;      // the kept / ORed barrier ring between warp 0 and the helpers (> kWalkCarry)
constexpr int kHelperWarps = kWalkThreads / 32 - 2;
constexpr int kHelperWords = 4;  // words per lane a helper reads at once: a strip's 128 words at K = 4096

// The row stride of a bits buffer, in words: ceil(K/32) padded to a multiple
// of 4, so every row of every image starts on 16 bytes.
__host__ __device__ constexpr int bits_stride(int K) { return ((K + 31) / 32 + 3) & ~3; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (the barrier's count includes this arrival).
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One past the last valid of the K flags at `vb` (block-wide; 16 flags a
// load where they are 16-byte aligned).
__device__ __forceinline__ int valid_end(const uint8_t* __restrict__ vb, int K) {
  __shared__ int s_end;
  if (threadIdx.x == 0) s_end = 0;
  __syncthreads();
  int last = 0;  // one past this thread's last valid candidate
  if ((K & 15) == 0 && (reinterpret_cast<uintptr_t>(vb) & 15) == 0) {
    const uint4* v4 = reinterpret_cast<const uint4*>(vb);
    for (int q = threadIdx.x; q < K / 16; q += blockDim.x) {
      const uint4 v = v4[q];
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)  // flags are 0 or 1: the highest set bit names the last valid byte
        if (words[u]) last = q * 16 + u * 4 + (31 - __clz(words[u])) / 8 + 1;
    }
  } else {
    for (int i = threadIdx.x; i < K; i += blockDim.x)
      if (vb[i]) last = i + 1;
  }
  last = __reduce_max_sync(0xffffffffu, last);
  if ((threadIdx.x & 31) == 0) atomicMax(&s_end, last);
  __syncthreads();
  return s_end;
}

// The image's K flags into `svalid` (block-wide); returns E, one past the
// last valid candidate, and zeroes the keep flags from ceil(E/32)*32 on.
__device__ __forceinline__ int stage_valid(const uint8_t* __restrict__ vb, uint8_t* svalid, uint8_t* kb, int K) {
  for (int i = threadIdx.x; i < K; i += blockDim.x) svalid[i] = vb[i];
  const int E = valid_end(vb, K);
  for (int i = (((E + 31) >> 5) << 5) + threadIdx.x; i < K; i += blockDim.x) kb[i] = 0;
  return E;
}

// The strip-staged walk (see the header). Dynamic shared memory: the removed
// set and the kept bits (ceil(K/32) words each) and the K flags; the ring of
// the walk's words is static.
__global__ void __launch_bounds__(kWalkThreads)
greedy_walk_kernel(const uint32_t* __restrict__ bits, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, int K, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint32_t ring[kWalkStages][32][kStageWords];
  __shared__ __align__(8) uint64_t full_bar[kWalkStages], empty_bar[kWalkStages], kept_bar[kHandoff],
      ored_bar[kHandoff];
  const int nwords = (K + 31) >> 5;
  uint32_t* sremoved = reinterpret_cast<uint32_t*>(smem);
  uint32_t* skept = sremoved + nwords;
  uint8_t* svalid = reinterpret_cast<uint8_t*>(skept + nwords);

  const int img = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t* mb = bits + static_cast<size_t>(img) * K * W;
  uint8_t* kb = keep + static_cast<size_t>(img) * K;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kWalkStages; ++s) {
      mbar_init(&full_bar[s], 32);  // every producer lane, once its copies land
      mbar_init(&empty_bar[s], 1);
    }
    for (int s = 0; s < kHandoff; ++s) {
      mbar_init(&kept_bar[s], 1);
      mbar_init(&ored_bar[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int E = stage_valid(valid + static_cast<size_t>(img) * K, svalid, kb, K);  // syncs the block
  const int We = (E + 31) >> 5;  // the walk's strips, and the words it reads
  if (We == 0) return;
  for (int c = threadIdx.x; c < We; c += kWalkThreads) sremoved[c] = 0u;
  __syncthreads();

  if (warp == 1) {
    // producer: lane t stages row t of strip s, words s&~3 .. (s&~3)+7 (two
    // 16-byte chunks; the second only inside the row), into stage s %
    // kWalkStages once strip s - kWalkStages has left it
    int st = 0;
    uint32_t phase = 0u;
    for (int s = 0; s < We; ++s) {
      if (s >= kWalkStages) mbar_wait(&empty_bar[st], phase ^ 1u);
      const int row = (s << 5) + lane;
      if (row < E && svalid[row]) {
        const int c0 = s & ~3;
        const uint32_t* src = mb + static_cast<size_t>(row) * W + c0;
        cp_async16(&ring[st][lane][0], src);
        if (c0 + 4 < W) cp_async16(&ring[st][lane][4], src + 4);
      }
      mbar_arrive_on_copies(&full_bar[st]);
      if (++st == kWalkStages) {
        st = 0;
        phase ^= 1u;
      }
    }
  } else if (warp == 0) {
    // carry[d]: the kept rows of strips w-kWalkCarry .. w-1, their word w+d
    uint32_t carry[kWalkCarry];
#pragma unroll
    for (int d = 0; d < kWalkCarry; ++d) carry[d] = 0u;
    int st = 0;
    uint32_t phase = 0u;
    for (int w = 0; w < We; ++w) {
      const int i0 = w << 5;
      const int n = min(32, E - i0);
      // invalid candidates and rows past E (never staged) count as removed
      const uint32_t invalid = ~__ballot_sync(0xffffffffu, lane < n && svalid[i0 + lane]);
      mbar_wait(&full_bar[st], phase);
      // the strip's words go out before the wait on the helpers, so their
      // latency hides behind it: row t's word w + d at ring[st][t][(w & 3) + d]
      const uint32_t* words = &ring[st][0][w & 3];
      uint32_t diag[32], next[kWalkCarry][32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        diag[t] = words[t * kStageWords];
#pragma unroll
        for (int d = 0; d < kWalkCarry; ++d) next[d][t] = w + 1 + d < We ? words[t * kStageWords + 1 + d] : 0u;
      }
      const int helped = w - kWalkCarry - 1;  // the helpers' strip that word w waits for
      if (helped >= 0) mbar_wait(&ored_bar[helped % kHandoff], (helped / kHandoff) & 1);
      uint32_t cur = sremoved[w] | carry[0] | invalid;
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
#pragma unroll
      for (int d = 0; d < kWalkCarry; ++d) carry[d] = (d + 1 < kWalkCarry ? carry[d + 1] : 0u) | add[d];
      if (lane == 0) skept[w] = kept;
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&kept_bar[w % kHandoff]);
        mbar_arrive(&empty_bar[st]);
      }
      if (++st == kWalkStages) {
        st = 0;
        phase ^= 1u;
      }
    }
  } else {
    // helpers: warp 2 + g takes strips g, g + kHelperWarps, ...: the kept
    // rows of strip s, read from global memory (lanes on consecutive words),
    // ORed into words s+kWalkCarry+1 .. We-1 of the removed set. A lane reads
    // kHelperWords words of all 32 rows at once, whether kept or not (rows
    // past E read row 0 again), so the loads go out together and wait on no
    // branch; the first go out before the wait for the strip's kept bits.
    for (int s = warp - 2; s + kWalkCarry + 1 < We; s += kHelperWarps) {
      const int n = min(32, E - (s << 5));  // the strip's rows below E
      const uint32_t* rows = mb + static_cast<size_t>(s << 5) * W;
      uint32_t v[kHelperWords][32];
      const auto load = [&](int c) {
#pragma unroll
        for (int t = 0; t < 32; ++t) {
          const uint32_t* row = rows + static_cast<size_t>(t < n ? t : 0) * W;
#pragma unroll
          for (int g = 0; g < kHelperWords; ++g) v[g][t] = c + 32 * g < We ? __ldcg(row + c + 32 * g) : 0u;
        }
      };
      int c = s + kWalkCarry + 1 + lane;
      load(c);
      mbar_wait(&kept_bar[s % kHandoff], (s / kHandoff) & 1);
      const uint32_t kept = skept[s];
      while (c < We) {
#pragma unroll
        for (int g = 0; g < kHelperWords; ++g) {
          uint32_t acc = 0u;
#pragma unroll
          for (int t = 0; t < 32; ++t) acc |= v[g][t] & (0u - (kept >> t & 1u));
          if (acc) atomicOr(&sremoved[c + 32 * g], acc);
        }
        c += 32 * kHelperWords;
        if (c < We) load(c);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&ored_bar[s % kHandoff]);
    }
  }
}

// Launch the walk over `bits` (B, K, bits_stride(K)) on `stream`, one block
// per image (the removed set, the kept bits and the K flags in dynamic
// shared memory).
inline cudaError_t launch_greedy_walk(const uint32_t* bits, const uint8_t* valid, uint8_t* keep, int B, int K,
                                      cudaStream_t stream) {
  const int W = bits_stride(K);
  const size_t smem = 2 * static_cast<size_t>((K + 31) / 32) * sizeof(uint32_t) + K;
  cudaError_t err = cudaFuncSetAttribute(greedy_walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  greedy_walk_kernel<<<B, kWalkThreads, smem, stream>>>(bits, valid, keep, K, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace nms_walk
