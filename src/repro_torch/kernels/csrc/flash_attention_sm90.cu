// Flash attention forward in bf16 for Hopper (sm_90a): the tensor cores
// through wgmma, tiles through TMA, one producer warpgroup and two consumer
// warpgroups.
//
// Replaces, for bf16 inputs, the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`);
// f32 inputs keep the CUDA-core kernel of flash_attention.cu.  Same function
// and forward order as the reference: s = (q.k) * scale from bf16 q and k
// with f32 accumulation; s = softcap * tanh(s / softcap) when a softcap is
// set; then the mask (right-aligned queries, qpos = row + Skv - Sq; causal
// qpos >= kpos; window qpos - kpos < window; keys past Skv); masked logits
// take a finite NEG and their p is 0; the running (m, l, acc) update in f32
// over the kv tiles; l == 0 -> 1 at the end, so a row with no key writes 0.
// The one extra rounding: p is rounded to bf16 as the A operand of P.V (l is
// summed from the f32 p).  The logits are kept in log2 units (times log2 e,
// after the softcap and before the mask) so that p = exp2(s - m); NEG is set
// in those units, so no masked logit becomes -inf.  GQA: q head h reads kv
// head h / (Hq / Hkv).  Query row i sits at position i + q_offset (the serve
// passes Skv - Sq: right-aligned).  For training the consumers' epilogue
// also writes, when its pointer is not null, each row's log-sum-exp from
// their m and l: (m + log2 l) * ln 2, m being in log2 units (f32 [B, Hq,
// Sq]; +BIG for a row with no key), which flash_attention_bwd.cu reads.
//
// What bounds it: operations.  At gemma2's head_dim 256 a (query, key) pair
// costs 4 * D flops against 8 * D bytes per key row shared by 128 query rows
// and the GQA group, far above the card's ~295 flops a byte.  So both
// products run on the tensor cores (wgmma, bf16 in, f32 accumulate) and the
// loads stay off the consumers' instruction stream (TMA):
//
// - One block per 128 query rows of one (batch, q head); blockIdx.x walks
//   the query tiles, heaviest first under causal.
// - Warpgroup 2 is the producer: one thread loads the Q tile once, then K and
//   V tiles of 64 keys into a ring of 2 stages; each load completes on an
//   mbarrier ("full"), and the consumers free a stage on another ("empty").
// - Warpgroups 0 and 1 are consumers, 64 query rows each.  A kv tile:
//   S = Q.K^T (wgmma m64n64k16, A and B from shared memory, both K-major,
//   D/16 k-steps); scale, softcap, mask and online softmax on the f32
//   accumulator in registers (row max by two quad shuffles; the row sum is
//   kept per thread and summed across the quad once, at the end); P to bf16
//   in registers, where the accumulator layout of S is already the A
//   fragment layout of P.V; O += P.V (wgmma m64n{D}k16, A from registers, V
//   from shared memory read MN-major through the transpose bit, no copy).
// - Tiles that the causal or window mask empties for a warpgroup are
//   skipped; the mask is built only on tiles that cross the diagonal, the
//   window's edge or Skv.
// - Tiles sit in shared memory as TMA writes them (`Cols`): rows of at
//   most 64 bf16 (128, 64 or 32 bytes) with the matching 128/64/32-byte
//   swizzle, so a D = 256 tile is four column chunks and a k-step's
//   descriptor steps across them.  Rows past Sq or Skv are zero-filled by
//   TMA.  A block takes 65.0 KB of shared memory at (D, DV) = (96, 64),
//   21.0 KB at (24, 16), 129.0 KB at (192, 128), 97.0 KB at (112, 112)
//   (as at (128, 128)).
// - Registers: setmaxnreg gives the consumers 240 and the producer 24
//   (2 * 128 * 240 + 128 * 24 = 64,512 of the SM's 65,536); a consumer at
//   D = 256 holds O (128 f32), S (32 f32) and P (16 bf16 pairs), 199
//   registers and no spills.  ptxas keeps to the entry's 168 (and spills,
//   and serialises the wgmma) unless the role branch is provably
//   warp-uniform and no trap lies on the consumers' path.
// - The softcap's tanh is 1 - 2 / (2^(2x log2 e) + 1): two MUFU operations
//   in place of tanhf's long sequence, absolute error ~1e-7 (so ~1e-5 in a
//   logit capped at 50).
//
// - q and k have head_dim D, v (and so o) head_dim DV (MLA: 96 / 64): S
//   runs over D's k-steps, P.V is m64n{DV}k16.  A head_dim that is not a
//   multiple of 16 is padded to one in shared memory (24 -> 32): its TMA
//   box is wider than the tensor, TMA fills the columns past D with
//   zeros, which add nothing to Q.K^T.  At D = 96 a row is three 32-wide
//   chunks in the 64-byte swizzle (`Cols`).  Zamba2's D = 112 is padded
//   to 128 the same way (two 64-wide chunks in the 128-byte swizzle
//   rather than seven 16-wide ones): S takes one k-step of zeros, P.V is
//   m64n128k16 with 16 columns of zeros, and the epilogue stores 112.
//
// Plain-C entry point, loaded with ctypes; the tensor maps are encoded on
// the host through cuTensorMapEncodeTiled, looked up at run time with
// cudaGetDriverEntryPoint (nothing links -lcuda).  It returns
// cudaGetLastError() so a refused launch reaches the caller, -1 for a
// (D, DV) pair it was not built for and -2 when a tensor map is refused.

#include <float.h>

#include "sm90_common.cuh"

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_sm90_mla.cu includes this file with
// its own pairs, so each set compiles in a translation unit of its own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_fwd_sm90
#endif

namespace {

constexpr int kTileQ = 128;      // query rows a block
constexpr int kRowsWG = 64;      // query rows a consumer warpgroup
constexpr int kTileK = 64;       // keys a kv tile
constexpr int kStages = 2;       // K/V ring depth
constexpr int kConsumers = 2;    // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr float kNeg = -0.7f * FLT_MAX;  // masked logit, in log2 units

struct Params {
  int batch, hq, hkv, sq, skv, q_tiles;
  int64_t os[3];  // element strides of o: batch, head, seq
  int causal, has_window, has_softcap;
  int window;        // clamped to the range of qpos - kpos: the same mask
  int off;           // position of query row 0
  float* lse;        // [batch, hq, sq] or null
  float scale_log2;  // scale * log2 e (no softcap)
  float cap_in;      // scale / softcap
  float cap_out;     // softcap * log2 e
};

// Shared-memory plan of one block, in bytes from a 1024-aligned base: Q
// and K in the columns of D (`Cols<D>`), V in those of DV.
template <int D, int DV>
struct Plan {
  using QK = Cols<D>;
  using V = Cols<DV>;
  static constexpr uint32_t kQChunk = kTileQ * QK::kRow;
  static constexpr uint32_t kKChunk = kTileK * QK::kRow;
  static constexpr uint32_t kVChunk = kTileK * V::kRow;
  static constexpr uint32_t kQBytes = kQChunk * QK::kChunks;
  static constexpr uint32_t kKBytes = kKChunk * QK::kChunks;
  static constexpr uint32_t kVBytes = kVChunk * V::kChunks;
  static constexpr uint32_t kK = kQBytes;                   // + stage * kKBytes
  static constexpr uint32_t kV = kK + kStages * kKBytes;    // + stage * kVBytes
  static constexpr uint32_t kBar = kV + kStages * kVBytes;
  // q, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// The accumulator layout of m64nN: register 4j + 2h + c of thread (warp w,
// lane) holds row 16w + lane/4 + 8h, column 8j + 2 (lane%4) + c.  So s[i]
// is in row half (i >> 1) & 1 and column 8 (i >> 2) + 2 (lane%4) + (i & 1).
//
// One tile's softmax on the S accumulator, in place: s becomes p.  m and l
// are the running max (log2 units) and this thread's share of the row sum;
// alpha the factor that rescales the output rows.
template <bool kMask, bool kCap>
__device__ __forceinline__ void softmax(float (&s)[32], float (&m)[2],
                                        float (&l)[2], float (&alpha)[2],
                                        const Params& p, int qpos0,
                                        int kpos0) {
  uint32_t keep = 0xFFFFFFFFu;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x =
        kCap ? tanh_exp2(s[i] * p.cap_in) * p.cap_out : s[i] * p.scale_log2;
    if (kMask) {
      const int qpos = qpos0 + 8 * ((i >> 1) & 1);
      const int kpos = kpos0 + 8 * (i >> 2) + (i & 1);
      bool ok = kpos < p.skv;
      if (p.causal) ok = ok && qpos >= kpos;
      if (p.has_window) ok = ok && qpos - kpos < p.window;
      if (!ok) {
        x = kNeg;
        keep &= ~(1u << i);
      }
    }
    s[i] = x;
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < 32; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xFFFFFFFFu, mx[h], 2));
    alpha[h] = exp2f(m[h] - mx[h]);
    m[h] = mx[h];
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float e = exp2f(s[i] - mx[(i >> 1) & 1]);
    if (kMask && !((keep >> i) & 1u)) e = 0.f;
    s[i] = e;
    sum[(i >> 1) & 1] += e;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = alpha[h] * l[h] + sum[h];
}

template <int D, int DV>
__device__ __forceinline__ void consume(uint32_t base, const Params& p,
                                        __nv_bfloat16* __restrict__ o, int wg,
                                        int b, int h, int q0, int k_begin,
                                        int n_tiles) {
  using L = Plan<D, DV>;
  using QK = typename L::QK;
  using V = typename L::V;
  constexpr int kAcc = V::kPad / 2;  // O: m64n{DV} accumulator registers
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int off = p.off;
  const int r_lo = q0 + kRowsWG * wg;
  const int r_hi = min(r_lo + kRowsWG, p.sq);  // past this warpgroup's rows
  const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const uint32_t bar_q = base + L::kBar;
  const uint32_t q_smem = base + wg * kRowsWG * QK::kRow;

  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t % kStages;
    const int k0 = k_begin + t * kTileK;
    // what this warpgroup's rows see of the tile (warpgroup-uniform)
    const int qmin = r_lo + off, qmax = r_hi - 1 + off;
    bool skip = r_lo >= r_hi;
    bool mask = k0 + kTileK > p.skv;
    if (p.causal) {
      skip = skip || k0 > qmax;
      mask = mask || k0 + kTileK - 1 > qmin;
    }
    if (p.has_window) {
      skip = skip || qmin - (k0 + kTileK - 1) >= p.window;
      mask = mask || qmax - k0 >= p.window;
    }
    const uint32_t full = base + L::kBar + 8 * (1 + stage);
    const uint32_t empty = base + L::kBar + 8 * (1 + kStages + stage);
    mbar_wait(full, (t / kStages) & 1);
    __syncwarp();
    if (!skip) {
      const uint32_t k_smem = base + L::kK + stage * L::kKBytes;
      const uint32_t v_smem = base + L::kV + stage * L::kVBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      const uint64_t dq = fresh(smem_desc(q_smem, 1, QK::kSbo, QK::kLayout));
      const uint64_t dk = fresh(smem_desc(k_smem, 1, QK::kSbo, QK::kLayout));
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < QK::kPad / 16; ++kk) {
        // k-step kk: columns 16 kk of chunk (16 kk) / W, 32 bytes a step;
        // descriptor addresses count 16-byte units
        const uint32_t c = (16 * kk) / QK::W, in = (16 * kk) % QK::W * 2;
        wgmma_qk(s, dq + ((c * L::kQChunk + in) >> 4),
                 dk + ((c * L::kKChunk + in) >> 4), kk > 0);
      }
      wg_commit();
      wg_wait_all();
      pin(s);

      float alpha[2];
      const int kpos0 = k0 + col0;
      if (mask) {
        if (p.has_softcap)
          softmax<true, true>(s, m, l, alpha, p, row0 + off, kpos0);
        else
          softmax<true, false>(s, m, l, alpha, p, row0 + off, kpos0);
      } else {
        if (p.has_softcap)
          softmax<false, true>(s, m, l, alpha, p, row0 + off, kpos0);
        else
          softmax<false, false>(s, m, l, alpha, p, row0 + off, kpos0);
      }
#pragma unroll
      for (int i = 0; i < kAcc; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // P as the A fragments of four k-steps of 16 keys
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          a[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

      // V rows 16 kk.. (keys) in every chunk; chunks lie kVChunk apart
      const uint64_t dv =
          fresh(smem_desc(v_smem, L::kVChunk / 16, V::kSbo, V::kLayout));
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<V::kPad>(acc, a[kk], dv + ((16 * kk * V::kRow) >> 4));
      wg_commit();
      wg_wait_all();
      pin(acc);
    }
    mbar_arrive(empty);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float sum = l[hh];
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 1);
    sum += __shfl_xor_sync(0xFFFFFFFFu, sum, 2);
    const float inv = 1.f / (sum == 0.f ? 1.f : sum);
    const int row = row0 + 8 * hh;
    if (row >= p.sq) continue;
    if (p.lse != nullptr && lane % 4 == 0)
      p.lse[((int64_t)b * p.hq + h) * p.sq + row] =
          sum > 0.f ? (m[hh] + log2f(sum)) * kLn2 : -kNeg;
    __nv_bfloat16* orow = o + b * p.os[0] + h * p.os[1] + row * p.os[2];
#pragma unroll
    for (int j = 0; j < DV / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh] * inv,
                                acc[4 * j + 2 * hh + 1] * inv);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, const Params p) {
  using L = Plan<D, DV>;
  using QK = typename L::QK;
  using V = typename L::V;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + L::kBar;

  const int bh = blockIdx.y;
  const int b = bh / p.hq, h = bh % p.hq;
  const int hk = h / (p.hq / p.hkv);
  const int qt = p.causal ? p.q_tiles - 1 - (int)blockIdx.x : (int)blockIdx.x;
  const int q0 = qt * kTileQ;
  const int off = p.off;
  const int rows = min(kTileQ, p.sq - q0);
  // the kv tiles that any row of the block sees
  int k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min(p.skv, q0 + rows + off);
  if (p.has_window) k_begin = max(0, q0 + off - p.window + 1);
  k_begin = k_begin / kTileK * kTileK;
  const int n_tiles =
      k_end > k_begin ? (k_end - k_begin + kTileK - 1) / kTileK : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_q + 8 * (1 + s), 1);
      mbar_init(bar_q + 8 * (1 + kStages + s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, through a shuffle so that ptxas sees it warp-uniform:
  // setmaxnreg's register counts then hold for each role's whole branch
  const int wg = __shfl_sync(0xFFFFFFFFu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    // producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar_q, L::kQBytes);
      for (int c = 0; c < QK::kChunks; ++c)
        tma_load(base + c * L::kQChunk, &tq, bar_q, c * QK::W, q0, h, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int stage = t % kStages;
        const uint32_t full = bar_q + 8 * (1 + stage);
        // the consumers freed this stage (passes at once on the first lap)
        mbar_wait(bar_q + 8 * (1 + kStages + stage), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, L::kKBytes + L::kVBytes);
        const int k0 = k_begin + t * kTileK;
        const uint32_t k_smem = base + L::kK + stage * L::kKBytes;
        const uint32_t v_smem = base + L::kV + stage * L::kVBytes;
        for (int c = 0; c < QK::kChunks; ++c)
          tma_load(k_smem + c * L::kKChunk, &tk, full, c * QK::W, k0, hk, b);
        for (int c = 0; c < V::kChunks; ++c)
          tma_load(v_smem + c * L::kVChunk, &tv, full, c * V::W, k0, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, DV>(base, p, o, wg, b, h, q0, k_begin, n_tiles);
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* dims, const Params& p, cudaStream_t stream) {
  using L = Plan<D, DV>;
  using QK = typename L::QK;
  using V = typename L::V;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, D, p.sq, p.hq, p.batch, dims + 6, QK::W, kTileQ) ||
      !encode(&tk, k, D, p.skv, p.hkv, p.batch, dims + 9, QK::W, kTileK) ||
      !encode(&tv, v, DV, p.skv, p.hkv, p.batch, dims + 12, V::W, kTileK))
    return -2;
  cudaFuncSetAttribute(flash_fwd_sm90<D, DV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)L::kBytes);
  const dim3 grid((unsigned)p.q_tiles, (unsigned)(p.batch * p.hq));
  flash_fwd_sm90<D, DV><<<grid, kThreads, L::kBytes, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim (of q and k), then the (batch,
// head, seq) element strides of q, k, v and o, then v's head_dim.  q, k, v:
// bf16, 16-byte aligned, strides multiples of 8 elements (TMA's 16 bytes),
// head_dim contiguous.  lse: f32 [batch, hq, sq], contiguous, or null.
extern "C" int FA_ENTRY(const void* q, const void* k,
                                        const void* v, void* o,
                                        const long long* dims, int causal,
                                        int has_window, long long window,
                                        int has_softcap, float softcap,
                                        float scale, long long q_offset,
                                        void* lse, void* stream) {
  Params p;
  p.batch = (int)dims[0];
  p.hq = (int)dims[1];
  p.hkv = (int)dims[2];
  p.sq = (int)dims[3];
  p.skv = (int)dims[4];
  const int head_dim = (int)dims[5], v_dim = (int)dims[18];
  for (int i = 0; i < 3; ++i) p.os[i] = dims[15 + i];
  p.q_tiles = (p.sq + kTileQ - 1) / kTileQ;
  p.causal = causal;
  p.has_window = has_window;
  // qpos - kpos lies in [q_offset - Skv + 1, q_offset + Sq - 1]: a window
  // outside [q_offset - Skv, q_offset + Sq] masks as that bound does
  const long long lo = q_offset - dims[4], hi = q_offset + dims[3];
  const long long w = window < lo ? lo : window > hi ? hi : window;
  p.window = (int)w;
  p.off = (int)q_offset;
  p.lse = (float*)lse;
  p.has_softcap = has_softcap;
  p.scale_log2 = scale * kLog2e;
  p.cap_in = has_softcap ? scale / softcap : 0.f;
  p.cap_out = has_softcap ? softcap * kLog2e : 0.f;
  if (p.sq <= 0 || p.batch * p.hq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(D, DV) \
  if (head_dim == D && v_dim == DV) return launch<D, DV>(q, k, v, o, dims, p, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}
