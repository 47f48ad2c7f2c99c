// Out-of-core per-chunk signature fold (Algorithm 1 lines 13-15) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_chunk_kernel` of
// src/repro/kernels/sig_fold.py (reached through `chunk_sig_fold`).  It
// computes the same function, not the same structure.  One chunk of the
// (src, eLabel, pId)-sorted edge stream arrives as lanes with a dense
// ascending local source id `seg`; lane i is kept when it is valid and,
// with dedup, when its (seg, eLabel, pId) triple differs from lane i-1's
// (lane 0 takes the host's cross-chunk bit `keep0`).  A kept lane hashes
// (u32 eLabel, u32 pId) into two u32 lanes and wrap-adds them into row
// seg when 0 <= seg < num_segments; other lanes fall out, as the
// reference's boundary search drops them.
//
// What bounds it: bytes.  Each lane reads 13 B (three int32 columns and a
// bool) and each segment writes 8 B; the hash is ~20 integer operations a
// lane.  The TPU kernel's u32 cumsum plus two binary searches per segment
// is not copied: a grid-wide scan would need a decoupled look-back, while
// u32 atomicAdd wraps mod 2^32 and commutes, so atomics give the same bits
// in any order.  A grid-stride loop spreads the chunk over every SM and
// consecutive threads read consecutive lanes, so every load is coalesced.
// Runs of equal seg (hub sources) make atomics hit one row; a warp-level
// segmented pre-reduction would cut those and is left for later work.
//
// The hash is the one of sig_fold.cu's `add_edge`: ctypes loads each .cu
// as its own library, and a header shared by both would escape the build
// digest, so the ten lines are repeated here.
//
// Plain-C entry point, loaded with ctypes; it returns cudaGetLastError() so
// a refused launch reaches the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x9E3779B1u;
constexpr uint32_t kC2 = 0x85EBCA77u;
constexpr uint32_t kC3 = 0xC2B2AE3Du;
constexpr uint32_t kC4 = 0x27D4EB2Fu;
constexpr uint32_t kC5 = 0x165667B1u;
constexpr uint32_t kSeedLo = 0x2545F491u;
constexpr uint32_t kSeedHi = 0x9E3779B9u;

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ void add_edge(uint32_t a, uint32_t b,
                                         uint32_t* hi_row, uint32_t* lo_row) {
  const uint32_t lo = fmix32(a * kC1 + b * kC2 + kSeedLo);
  const uint32_t h = fmix32(a * kC3 + b * kC4 + kSeedHi);
  atomicAdd(hi_row, fmix32(h + lo * kC5));
  atomicAdd(lo_row, lo);
}

__global__ void chunk_fold(const int32_t* __restrict__ elabel,
                           const int32_t* __restrict__ pid,
                           const int32_t* __restrict__ seg,
                           const uint8_t* __restrict__ valid,
                           uint32_t* __restrict__ out_hi,
                           uint32_t* __restrict__ out_lo, int64_t n,
                           int32_t num_segments, int dedup, int keep0) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    if (!valid[i]) continue;
    const int32_t s = seg[i];
    if (s < 0 || s >= num_segments) continue;
    const uint32_t a = (uint32_t)elabel[i];
    const uint32_t b = (uint32_t)pid[i];
    if (dedup) {
      const bool keep =
          i == 0 ? keep0 != 0
                 : (seg[i - 1] != s || (uint32_t)elabel[i - 1] != a ||
                    (uint32_t)pid[i - 1] != b);
      if (!keep) continue;
    }
    add_edge(a, b, out_hi + s, out_lo + s);
  }
}

}  // namespace

extern "C" int chunk_sig_fold(const void* elabel, const void* pid,
                              const void* seg, const void* valid,
                              void* out_hi, void* out_lo, long long n,
                              int num_segments, int dedup, int keep0,
                              void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  chunk_fold<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)elabel, (const int32_t*)pid, (const int32_t*)seg,
      (const uint8_t*)valid, (uint32_t*)out_hi, (uint32_t*)out_lo, n,
      num_segments, dedup, keep0);
  return (int)cudaGetLastError();
}
