// Signature folds (Algorithm 1 lines 13-15) for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of src/repro/kernels/sig_fold.py:
// - `_kernel` (reached through `sig_fold` and `frontier_sig_fold`), with its
//   in-kernel bitonic dedup `_bitonic_sort3`: `fold_flat`, `fold_bitonic`;
// - `_chunk_kernel` (reached through `chunk_sig_fold`), the out-of-core
//   per-chunk fold: `chunk_fold`.
// Each computes the same function as its TPU kernel, not the same block
// structure.  Lane i of a flat fold belongs to block i / eb; it hashes
// (u32 eLabel, u32 pId) into two u32 lanes, is kept if it is valid (and,
// with dedup, if its (src, eLabel, pId) triple differs from the previous
// lane's in the block; a block's first lane is always kept), and wrap-adds
// (mod 2^32) into row block * nb + src when 0 <= src < nb.  A chunk fold is
// one block of dense ascending segment ids: its dedup compares raw seg ids
// and its first lane takes the host's cross-chunk bit keep0.
//
// What bounds it: bytes.  Each lane reads 13 B (three int32 columns and a
// bool) and each output row writes 8 B; the hash is ~20 integer operations
// a lane.  What the design does about it:
// - One device pass a fold.  The output is the int64 [2, rows] tensor the
//   wrapper returns: the C entry zeroes it with cudaMemsetAsync on the
//   caller's stream, and the atomics add into the low 32-bit word of each
//   int64.  The card is little-endian and nothing touches the high word, so
//   each value is exactly the u32 wrap-sum; no widening pass follows.
// - Wide loads.  A warp takes 32 * V consecutive lanes a step.  With V = 4
//   each thread loads one int4 from each int32 column and the four bools as
//   one u32; the wrapper's launch plan picks V = 1 where a column is not
//   aligned for that (a row of a [3, n] tensor with n % 4 != 0).
// - Warp-level segmented pre-reduction.  The TPU kernel's [nb, eb]
//   broadcast compare (and the chunk kernel's cumsum plus two binary
//   searches a segment) is not copied: u32 wrap-add commutes, so atomics
//   give the same bits in any order.  Lanes of a warp that share an output
//   row first combine their values, inside the thread and then by
//   __shfl_up_sync across it (a segmented Hillis-Steele scan over the
//   threads' last runs), and only the last lane of each run issues the pair
//   of atomics.  Sorted input (the build's `sorted`, `dedup_hash` and
//   src-ordered `multiset` lanes) has runs of a source's out-degree; an
//   unsorted one only finds shorter runs, so no order is assumed.  Runs
//   never join two blocks: the key is the output row block * nb + src.  A
//   lane that is not kept keeps its row and adds 0, so dropped duplicates
//   and invalid lanes do not split a run; a lane whose src is out of range
//   takes row -1, which matches nothing and adds nothing.
// - The grid-stride loop walks warp tiles, so its trip count is uniform
//   across a warp and all 32 lanes reach every shuffle; lanes past n carry
//   row -1.  Dedup needs lane i-1's triple: inside a thread from its own
//   registers, across threads by shuffle, and for a warp's first lane from
//   memory.
//
// The unsorted dedup route (`fold_bitonic`) sorts each block in shared
// memory (12 B a lane, a bitonic network with one __syncthreads() per
// substage) before the same adjacent-compare fold, one CTA per block; the
// wrapper bounds eb by the 227 KB a block may use.  The port's builds never
// take it (they pass presorted lanes).
//
// Plain-C entry points, loaded with ctypes: each makes the tensors' card
// current for its calls (and the caller's again after) and returns the
// first CUDA error of its memset and launch, so a refused launch reaches
// the caller.

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
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kThreads = 256;  // kernels/sig_fold.py's THREADS

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// The two u32 lanes of one edge: core/signatures.py::hash_pair.
__device__ __forceinline__ void edge_hash(uint32_t a, uint32_t b,
                                          uint32_t& hi, uint32_t& lo) {
  lo = fmix32(a * kC1 + b * kC2 + kSeedLo);
  hi = fmix32(fmix32(a * kC3 + b * kC4 + kSeedHi) + lo * kC5);
}

// Wrap-add (hi, lo) into row `row` of the int64 [2, rows] output, viewed
// as u32 words: row r's low words are out[2r] and out[2(rows + r)].  Row -1
// matches nothing; adding 0 changes nothing and is skipped.
__device__ __forceinline__ void add_row(uint32_t* out, int64_t rows,
                                        int64_t row, uint32_t hi,
                                        uint32_t lo) {
  if (row < 0) return;
  if (hi) atomicAdd(out + 2 * row, hi);
  if (lo) atomicAdd(out + 2 * (rows + row), lo);
}

struct Fold {
  const int32_t* elabel;
  const int32_t* pid;
  const int32_t* seg;     // local src of a flat fold, segment of a chunk
  const uint8_t* valid;
  uint32_t* out;          // int64 [2, rows], zeroed
  int64_t rows;
  int64_t n;              // lanes
  int64_t eb;             // lanes a block (n for a chunk)
  int32_t nb;             // rows a block (num_segments for a chunk)
  int dedup;
  int keep_first;         // keep a block's first lane: 1, or the chunk's keep0
  int mask_prev;          // dedup compares an invalid lane's src as nb
};

// One warp tile: this thread's V consecutive lanes from i0.
template <int V>
__device__ __forceinline__ void fold_tile(const Fold& f, int64_t i0,
                                          int lane) {
  int32_t s[V];
  uint32_t a[V], b[V];
  bool v[V];
  bool loaded = false;
  if constexpr (V == 4) {
    if (i0 + 4 <= f.n) {
      const int4 e = *reinterpret_cast<const int4*>(f.elabel + i0);
      const int4 p = *reinterpret_cast<const int4*>(f.pid + i0);
      const int4 q = *reinterpret_cast<const int4*>(f.seg + i0);
      const uint32_t m = *reinterpret_cast<const uint32_t*>(f.valid + i0);
      a[0] = e.x; a[1] = e.y; a[2] = e.z; a[3] = e.w;
      b[0] = p.x; b[1] = p.y; b[2] = p.z; b[3] = p.w;
      s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = ((m >> (8 * k)) & 0xFFu) != 0;
      loaded = true;
    }
  }
  if (!loaded) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool in = i0 + k < f.n;
      a[k] = in ? (uint32_t)f.elabel[i0 + k] : 0u;
      b[k] = in ? (uint32_t)f.pid[i0 + k] : 0u;
      s[k] = in ? f.seg[i0 + k] : -1;
      v[k] = in && f.valid[i0 + k] != 0;
    }
  }
  // the src that dedup compares
  int32_t se[V];
#pragma unroll
  for (int k = 0; k < V; ++k) se[k] = f.mask_prev && !v[k] ? f.nb : s[k];
  // lane i0 - 1's triple: the previous thread's last lane, or memory for
  // the warp's first lane (a warp-uniform branch: every lane shuffles)
  int32_t ps = 0;
  uint32_t pa = 0, pb = 0;
  if (f.dedup) {
    ps = __shfl_up_sync(kFull, se[V - 1], 1);
    pa = __shfl_up_sync(kFull, a[V - 1], 1);
    pb = __shfl_up_sync(kFull, b[V - 1], 1);
    if (lane == 0 && i0 > 0 && i0 < f.n) {
      const int64_t j = i0 - 1;
      ps = f.mask_prev && !f.valid[j] ? f.nb : f.seg[j];
      pa = (uint32_t)f.elabel[j];
      pb = (uint32_t)f.pid[j];
    }
  }
  int64_t blk = 0, off = i0;
  if (f.eb != f.n) {
    blk = i0 / f.eb;
    off = i0 - blk * f.eb;
  }
  int64_t row[V];
  uint32_t hi[V], lo[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    bool keep = v[k];
    if (f.dedup && keep) {
      if (off == 0) {
        keep = f.keep_first != 0;
      } else {
        const int32_t qs = k ? se[k - 1] : ps;
        const uint32_t qa = k ? a[k - 1] : pa, qb = k ? b[k - 1] : pb;
        keep = !(qs == se[k] && qa == a[k] && qb == b[k]);
      }
    }
    row[k] = s[k] >= 0 && s[k] < f.nb ? blk * f.nb + s[k] : -1;
    hi[k] = lo[k] = 0u;
    if (keep && row[k] >= 0) edge_hash(a[k], b[k], hi[k], lo[k]);
    if (++off == f.eb) {
      off = 0;
      ++blk;
    }
  }
  // runs inside the thread: the first may continue the previous thread's
  // last run, the middle ones are whole (added at once), the last may run
  // on into the next thread
  int64_t key = row[0];
  uint32_t sh = hi[0], sl = lo[0];
  uint32_t fh = 0u, fl = 0u;  // the first run's sum, once it has closed
  bool closed = false;
#pragma unroll
  for (int k = 1; k < V; ++k) {
    if (row[k] == key) {
      sh += hi[k];
      sl += lo[k];
      continue;
    }
    if (closed) {
      add_row(f.out, f.rows, key, sh, sl);
    } else {
      fh = sh;
      fl = sl;
      closed = true;
    }
    key = row[k];
    sh = hi[k];
    sl = lo[k];
  }
  // across the warp: thread t's first run continues t-1's last run when
  // their rows match; a thread whose lanes are one such run extends the
  // run, every other thread's last run starts one (a head)
  const int64_t prev_key = __shfl_up_sync(kFull, key, 1);
  const bool link = lane > 0 && row[0] >= 0 && row[0] == prev_key;
  const unsigned heads = __ballot_sync(kFull, closed || !link);
  const int start = 31 - __clz(heads & (kFull >> (31 - lane)));
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t th = __shfl_up_sync(kFull, sh, d);
    const uint32_t tl = __shfl_up_sync(kFull, sl, d);
    if (lane - d >= start) {
      sh += th;
      sl += tl;
    }
  }
  // (sh, sl) now sums the run ending at this thread's last lane
  const uint32_t ch = __shfl_up_sync(kFull, sh, 1);
  const uint32_t cl = __shfl_up_sync(kFull, sl, 1);
  const int64_t next_first = __shfl_down_sync(kFull, row[0], 1);
  if (closed)
    add_row(f.out, f.rows, row[0], fh + (link ? ch : 0u),
            fl + (link ? cl : 0u));
  if (!(lane < 31 && key >= 0 && next_first == key))
    add_row(f.out, f.rows, key, sh, sl);
}

template <int V>
__device__ __forceinline__ void fold_grid(const Fold& f) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t tiles = (f.n + 32 * V - 1) / (32 * V);
  for (int64_t t = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
       t < tiles; t += warps)
    fold_tile<V>(f, t * 32 * V + (int64_t)lane * V, lane);
}

template <int V>
__global__ void __launch_bounds__(kThreads) fold_flat(Fold f) {
  fold_grid<V>(f);
}

template <int V>
__global__ void __launch_bounds__(kThreads) chunk_fold(Fold f) {
  fold_grid<V>(f);
}

__device__ __forceinline__ bool lex_lt(int32_t s1, uint32_t a1, uint32_t b1,
                                       int32_t s2, uint32_t a2, uint32_t b2) {
  return s1 < s2 || (s1 == s2 && (a1 < a2 || (a1 == a2 && b1 < b2)));
}

// One CTA per block of eb (a power of two) lanes: bitonic sort of the
// (src, eLabel, pId) triples in shared memory, then the adjacent-compare
// fold.  Padding takes src = nb and sinks to the tail.
__global__ void fold_bitonic(const int32_t* __restrict__ elabel,
                             const int32_t* __restrict__ pid,
                             const int32_t* __restrict__ lsrc,
                             const uint8_t* __restrict__ valid,
                             uint32_t* __restrict__ out, int64_t rows,
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
    uint32_t hi, lo;
    edge_hash(sa[j], sb[j], hi, lo);
    add_row(out, rows, row0 + s, hi, lo);
  }
}

// Zero the int64 [2, rows] output, then fold f.n lanes (if any) with `vec`
// lanes a thread over `blocks` CTAs.
cudaError_t launch_fold(void (*k4)(Fold), void (*k1)(Fold), const Fold& f,
                        int vec, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(f.out, 0, (size_t)f.rows * 16, stream);
  if (err != cudaSuccess || f.n <= 0 || f.rows <= 0) return err;
  if (vec != 4 && vec != 1) return cudaErrorInvalidValue;
  (vec == 4 ? k4 : k1)<<<(unsigned)blocks, kThreads, 0, stream>>>(f);
  return cudaGetLastError();
}

// Runs a launcher with `device` current (the tensors' card), restoring
// the caller's current device after, so the host needs no device switch.
template <typename Launch>
int on_device(int device, Launch launch) {
  int prev = device;
  cudaError_t err = cudaGetDevice(&prev);
  if (err == cudaSuccess && prev != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  if (prev != device) cudaSetDevice(prev);
  return (int)err;
}

}  // namespace

// Lanes in [0, n), blocks of eb lanes, nb output rows a block; out is the
// int64 [2, (n / eb) * nb] result.  With dedup the lanes of each block
// arrive in (src, eLabel, pId) order; invalid lanes compare as src = nb, as
// in the reference.
extern "C" int sig_fold_flat(const void* elabel, const void* pid,
                             const void* lsrc, const void* valid, void* out,
                             long long n, long long eb, int nb, int dedup,
                             int vec, int blocks, int device, void* stream) {
  if (eb <= 0) return (int)cudaErrorInvalidValue;
  const Fold f{(const int32_t*)elabel, (const int32_t*)pid,
               (const int32_t*)lsrc, (const uint8_t*)valid, (uint32_t*)out,
               n / eb * nb, n, eb, nb, dedup, 1, 1};
  return on_device(device, [&] {
    return launch_fold(fold_flat<4>, fold_flat<1>, f, vec, blocks,
                       (cudaStream_t)stream);
  });
}

// One chunk of n lanes with dense segment ids into the int64
// [2, num_segments] result; lane 0 is kept (under dedup) iff keep0.
extern "C" int chunk_sig_fold(const void* elabel, const void* pid,
                              const void* seg, const void* valid, void* out,
                              long long n, int num_segments, int dedup,
                              int keep0, int vec, int blocks, int device,
                              void* stream) {
  const Fold f{(const int32_t*)elabel, (const int32_t*)pid,
               (const int32_t*)seg, (const uint8_t*)valid, (uint32_t*)out,
               num_segments, n, n, num_segments, dedup, keep0, 0};
  return on_device(device, [&] {
    return launch_fold(chunk_fold<4>, chunk_fold<1>, f, vec, blocks,
                       (cudaStream_t)stream);
  });
}

extern "C" int sig_fold_bitonic(const void* elabel, const void* pid,
                                const void* lsrc, const void* valid,
                                void* out, long long num_blocks,
                                long long eb, int nb, int device,
                                void* stream) {
  return on_device(device, [&] {
    const cudaStream_t st = (cudaStream_t)stream;
    const int64_t rows = num_blocks * nb;
    cudaError_t err = cudaMemsetAsync(out, 0, (size_t)rows * 16, st);
    if (err != cudaSuccess || num_blocks <= 0) return err;
    const size_t smem = (size_t)eb * 12;
    err = cudaFuncSetAttribute(
        fold_bitonic, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int threads = eb < 1024 ? (int)((eb + 31) / 32 * 32) : 1024;
    fold_bitonic<<<(unsigned)num_blocks, threads, smem, st>>>(
        (const int32_t*)elabel, (const int32_t*)pid, (const int32_t*)lsrc,
        (const uint8_t*)valid, (uint32_t*)out, rows, (int32_t)eb, nb);
    return cudaGetLastError();
  });
}
