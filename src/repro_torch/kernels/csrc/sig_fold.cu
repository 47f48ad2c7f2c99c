// Signature fold (Algorithm 1 lines 14-15) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` of src/repro/kernels/sig_fold.py
// (reached through `sig_fold` and `frontier_sig_fold`), including its
// in-kernel bitonic dedup `_bitonic_sort3`.  It computes the same function,
// not the same block structure: lane i belongs to block i / eb; it hashes
// (u32 eLabel, u32 pId) into two u32 lanes, keeps the lane if it is valid
// (and, with dedup, if its (src, eLabel, pId) triple differs from the
// previous lane's in the block), and wrap-adds the lanes into row
// block * nb + src when 0 <= src < nb.
//
// What bounds it: bytes.  Each lane reads 13 B (three int32 columns and a
// bool) and each output row writes 8 B; the hash is ~20 integer operations
// a lane, far below the card's integer rate.  The TPU kernel's
// [nb, eb] broadcast-compare reduction is not copied: u32 atomicAdd wraps
// mod 2^32 and is commutative, so atomics give the same bits in any order
// with O(eb) work instead of O(nb * eb).  A grid-stride loop over 64-bit
// lane indices spreads any block, up to the build's single block of all
// edges, over every SM; consecutive threads read consecutive lanes, so
// every load is coalesced.  Hub sources make many atomics hit one row;
// a warp-level segmented pre-reduction would cut those and is left for
// later work.
//
// The unsorted dedup route sorts each block in shared memory (12 B a lane,
// a bitonic network with one __syncthreads() per substage) before the same
// adjacent-compare fold.  One CTA per block; the wrapper bounds eb by the
// 227 KB a block may use.
//
// Plain-C entry points, loaded with ctypes: every launcher returns
// cudaGetLastError() so a refused launch reaches the caller.

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

__device__ __forceinline__ bool lex_lt(int32_t s1, uint32_t a1, uint32_t b1,
                                       int32_t s2, uint32_t a2, uint32_t b2) {
  return s1 < s2 || (s1 == s2 && (a1 < a2 || (a1 == a2 && b1 < b2)));
}

// Lanes in [0, n), blocks of eb lanes, nb output rows a block.  With dedup
// the lanes of each block arrive in (src, eLabel, pId) order; invalid lanes
// compare as src = nb, as in the reference.
__global__ void fold_flat(const int32_t* __restrict__ elabel,
                          const int32_t* __restrict__ pid,
                          const int32_t* __restrict__ lsrc,
                          const uint8_t* __restrict__ valid,
                          uint32_t* __restrict__ out_hi,
                          uint32_t* __restrict__ out_lo,
                          int64_t n, int64_t eb, int32_t nb, int dedup) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t blk = eb == n ? 0 : i / eb;
    const bool v = valid[i] != 0;
    const uint32_t a = (uint32_t)elabel[i];
    const uint32_t b = (uint32_t)pid[i];
    int32_t s = lsrc[i];
    bool keep = v;
    if (dedup) {
      s = v ? s : nb;
      if (i != blk * eb) {
        const int32_t sp = valid[i - 1] ? lsrc[i - 1] : nb;
        keep = keep && !(sp == s && (uint32_t)elabel[i - 1] == a &&
                         (uint32_t)pid[i - 1] == b);
      }
    }
    if (keep && s >= 0 && s < nb) {
      const int64_t row = blk * nb + s;
      add_edge(a, b, out_hi + row, out_lo + row);
    }
  }
}

// One CTA per block of eb (a power of two) lanes: bitonic sort of the
// (src, eLabel, pId) triples in shared memory, then the adjacent-compare
// fold.  Padding takes src = nb and sinks to the tail.
__global__ void fold_bitonic(const int32_t* __restrict__ elabel,
                             const int32_t* __restrict__ pid,
                             const int32_t* __restrict__ lsrc,
                             const uint8_t* __restrict__ valid,
                             uint32_t* __restrict__ out_hi,
                             uint32_t* __restrict__ out_lo,
                             int32_t eb, int32_t nb) {
  extern __shared__ uint32_t smem[];
  int32_t* ss = reinterpret_cast<int32_t*>(smem);
  uint32_t* sa = smem + eb;
  uint32_t* sb = smem + 2 * eb;
  const int64_t base = (int64_t)blockIdx.x * eb;
  for (int32_t j = threadIdx.x; j < eb; j += blockDim.x) {
    ss[j] = valid[base + j] ? lsrc[base + j] : nb;
    sa[j] = (uint32_t)elabel[base + j];
    sb[j] = (uint32_t)pid[base + j];
  }
  __syncthreads();
  for (int32_t span = 2; span <= eb; span <<= 1) {
    for (int32_t half = span >> 1; half >= 1; half >>= 1) {
      for (int32_t j = threadIdx.x; j < eb; j += blockDim.x) {
        const int32_t p = j ^ half;
        if (p <= j) continue;
        const bool ascending = (j & span) == 0;
        const bool swap =
            ascending ? lex_lt(ss[p], sa[p], sb[p], ss[j], sa[j], sb[j])
                      : lex_lt(ss[j], sa[j], sb[j], ss[p], sa[p], sb[p]);
        if (swap) {
          const int32_t ts = ss[j];
          const uint32_t ta = sa[j], tb = sb[j];
          ss[j] = ss[p]; sa[j] = sa[p]; sb[j] = sb[p];
          ss[p] = ts; sa[p] = ta; sb[p] = tb;
        }
      }
      __syncthreads();
    }
  }
  const int64_t row0 = (int64_t)blockIdx.x * nb;
  for (int32_t j = threadIdx.x; j < eb; j += blockDim.x) {
    const int32_t s = ss[j];
    if (s < 0 || s >= nb) continue;
    if (j > 0 && ss[j - 1] == s && sa[j - 1] == sa[j] && sb[j - 1] == sb[j])
      continue;
    add_edge(sa[j], sb[j], out_hi + row0 + s, out_lo + row0 + s);
  }
}

}  // namespace

extern "C" int sig_fold_flat(const void* elabel, const void* pid,
                             const void* lsrc, const void* valid,
                             void* out_hi, void* out_lo, long long n,
                             long long eb, int nb, int dedup, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  const long long cap = (long long)(sms > 0 ? sms : 132) * 16;
  if (blocks > cap) blocks = cap;
  fold_flat<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)elabel, (const int32_t*)pid, (const int32_t*)lsrc,
      (const uint8_t*)valid, (uint32_t*)out_hi, (uint32_t*)out_lo, n, eb, nb,
      dedup);
  return (int)cudaGetLastError();
}

extern "C" int sig_fold_bitonic(const void* elabel, const void* pid,
                                const void* lsrc, const void* valid,
                                void* out_hi, void* out_lo,
                                long long num_blocks, long long eb, int nb,
                                void* stream) {
  if (num_blocks <= 0) return 0;
  const size_t smem = (size_t)eb * 12;
  cudaError_t err = cudaFuncSetAttribute(
      fold_bitonic, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = eb < 1024 ? (int)((eb + 31) / 32 * 32) : 1024;
  fold_bitonic<<<(unsigned)num_blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)elabel, (const int32_t*)pid, (const int32_t*)lsrc,
      (const uint8_t*)valid, (uint32_t*)out_hi, (uint32_t*)out_lo,
      (int32_t)eb, nb);
  return (int)cudaGetLastError();
}
