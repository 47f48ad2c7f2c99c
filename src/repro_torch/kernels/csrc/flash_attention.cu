// Flash attention forward (block-wise online softmax) in f32 for Hopper
// (sm_90a), its two products on the tensor cores in 3xTF32.
//
// Replaces, for f32 inputs, the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`);
// bf16 inputs take flash_attention_sm90.cu (wgmma, TMA).  It computes the
// same function in the same forward order: s = (q.k) * scale; s = softcap
// * tanh(s / softcap) when a softcap is set; then the mask (query row i at
// position i + q_offset; causal qpos >= kpos; window qpos - kpos < window;
// keys past Skv); masked logits take the finite NEG = -0.7 * FLT_MAX and
// their p is zeroed; the running (m, l, acc) update of each kv tile; and at
// the end l == 0 -> 1, so a row with no key left writes 0.  GQA: q head h
// reads kv head h / (Hq / Hkv).  For training it also writes, when its
// pointer is not null, each row's log-sum-exp m + log(l) (f32 [B, Hq, Sq];
// +BIG = -NEG for a row with no key, as repro.models.flash_xla._fwd_impl
// has it), which the backward (flash_attention_bwd.cu) reads.
//
// Structure: one block per (query tile, batch * q head), causal blocks
// heaviest first (every head's last query tile before any head's second
// last); a loop inside the block over the kv tiles takes the place of the
// TPU's sequential kv grid axis, the next kv tile loading while this one
// is multiplied (`Tiles`: into registers, or by cp.async into a second
// buffer; 16-byte loads where q, k and v allow them, else 4-byte ones).
// S = Q K^T and O += P V are mma.sync m16n8k8 products in 3xTF32
// (tf32x3.cuh); S and P stay in registers: P's C fragment is the A
// fragment of P V, its keys in paired slots, so V is read at rows 2t and
// 2t + 1.  Softmax, masks and lse stay in f32 on the CUDA cores.  A warp
// skips a kv tile that its causal or window mask empties (it would leave
// (m, l, acc) as they are), tests no pair of a tile the mask keeps whole,
// and computes nothing when its rows all lie past Sq.  Rows past Sq and
// keys past Skv are zero-filled and masked, so any Sq and Skv are taken.
//
// What bounds it: operations.  The tile work is 2 (D + Dv) flops a
// visible (query, key) pair against 4 (D + Dv) bytes a key row read once a
// query tile.  In 3xTF32 each product is three TF32 products, so the
// tensor cores' 495 TFLOP/s give 165 TFLOP/s of f32-accurate work, where
// the CUDA cores give 67.  The kernel stays at the f32 tolerance (2e-5
// against the plain version): a 3xTF32 product is within 2^-22 of the f32
// one, where one TF32 product alone (~2^-11) would miss the bar 75 times
// over.  The splits and the softmax are CUDA-core instructions, and they,
// not the tensor cores, set the pace: so a block's 8 warps read K and V
// split once by the block where D + Dv <= 256, products with few output
// tiles run over independent accumulator chains, and a decode step
// (Sq <= 16), which would leave all but one warp idle, shares the keys of
// each kv tile out among the warps and combines their softmax states.
//
// q and k have head_dim D, v (and so o) head_dim DV: the logits run over
// D, the output over DV (MLA's 96 / 64).  D and DV are multiples of 8.
//
// Plain-C entry point, loaded with ctypes; it returns cudaGetLastError()
// so a refused launch reaches the caller, or -1 for a (D, DV) pair it was
// not built for.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "tf32x3.cuh"

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_mla.cu includes this file with its
// own pairs, so each set compiles in a translation unit of its own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_fwd
#endif

namespace {

constexpr float kNeg = -0.7f * FLT_MAX;

struct Params {
  int64_t batch, hq, hkv, sq, skv;
  // element strides of (batch, head, seq) for q, k, v, o; head_dim is
  // contiguous
  int64_t qs[3], ks[3], vs[3], os[3];
  int causal, has_window, has_softcap;
  int64_t window;
  float softcap, scale;
  int64_t off;  // position of query row 0
  float* lse;   // [batch, hq, sq] or null
  int vec;      // q, k, v take 16-byte copies
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

// The tiles of a (D, DV) pair.  A block has W warps; each R of them share
// 16 query rows (an m-tile), each taking 8 KT / R of the keys of every kv
// tile, so a block has 16 W / R rows, and where R > 1 the R warps'
// softmax states (m, l, acc) of a row are combined at the end.  Keys: KT
// a kv tile, the largest of 64, 32 and 16 that fits the block's shared
// memory (a block an SM: at 256 threads the registers allow no more).
// - D + DV <= 256: W = 8, R = 1 (128 rows).  The K and V tiles are held
//   pre-split, as (big, small) pairs ([KT][pad4(D)] and [KT][pad2(DV)]),
//   written by the block from registers it loaded during the previous
//   tile, so that each value is split once where each of the 8 warps
//   would split it again.  KT = 64 up to D + DV = 160, 32 up to 224, else
//   16: the loads' registers (more spill).
// - wider heads, (192, 128) and (256, 256): W = 8, R = 1 (128 rows), K
//   and V f32, double-buffered by cp.async ([2][KT][pad4]); each warp
//   splits its fragments (pre-split measured slower there).
// - kSplit (Sq <= 16, a decode step): 16 rows, W = R = KT / 8 warps of 8
//   keys each (no value is read by two warps), f32 tiles as the wide
//   heads'.
// Q stays f32 [rows][pad4(D)], split by the warp that owns its rows (held
// pre-split too, it measured slower).
constexpr size_t kSmem = 227 * 1024;  // a block's shared memory

template <int D, int DV, bool kSplit>
struct Tiles {
  static constexpr int kSum = D + DV;
  static constexpr bool kPre = !kSplit && kSum <= 256;
  static constexpr int LQ = pad4(D), LK = pad4(D);
  static constexpr int LV = kPre ? pad2(DV) : pad4(DV);
  static constexpr int kWarps = 8;  // W, but for kSplit
  static constexpr int kRows = kSplit ? 16 : 16 * kWarps;
  static constexpr size_t bytes(int kt) {
    return sizeof(float) * size_t(kRows) * LQ +
           (kPre ? sizeof(uint2) * size_t(kt) * (LK + LV)
                 : sizeof(float) * size_t(2) * kt * (LK + LV));
  }
  // the largest of 64, 32 and 16 keys (at most `most`) that fits
  static constexpr int pick(int most) {
    return most >= 64 && bytes(64) <= kSmem   ? 64
           : most >= 32 && bytes(32) <= kSmem ? 32
                                              : 16;
  }
  static constexpr int KT =
      pick(!kPre || kSum <= 160 ? 64 : kSum <= 224 ? 32 : 16);
  static constexpr int W = kSplit ? KT / 8 : kWarps;
  static constexpr int R = W * 16 / kRows;  // warps sharing an m-tile
  static constexpr int NS = KT / 8 / R;     // n-tiles of a warp's S
  static constexpr int kThreads = 32 * W;
  static constexpr size_t kBytes = bytes(KT);
  // kPre: a kv tile's K and V rows as chunks of 4 floats, and the chunks a
  // thread carries
  static constexpr int kChunks = KT * (D + DV) / 4;
  static constexpr int kPer = (kChunks + kThreads - 1) / kThreads;
  // the R > 1 combine: each warp's 16 rows of (acc, m, l) in the kv tiles
  static constexpr int LC = DV + 2;
  static_assert(R == 1 || size_t(W) * 16 * LC * sizeof(float) <=
                              kBytes - sizeof(float) * kRows * LQ,
                "the warps' partial states must fit the kv tiles");
};

template <int D, int DV, bool kSplit>
__global__ void __launch_bounds__(Tiles<D, DV, kSplit>::kThreads, 1)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Params p) {
  using T = Tiles<D, DV, kSplit>;
  constexpr int KT = T::KT, W = T::W, R = T::R, NS = T::NS;
  constexpr int kRows = T::kRows, kThreads = T::kThreads;
  constexpr int LQ = T::LQ, LK = T::LK, LV = T::LV;
  constexpr int NO = DV / 8;  // n-tiles of O
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [kRows][LQ]
  float* ks = qs + kRows * LQ;        // [2][KT][LK] f32, or
  float* vs = ks + 2 * KT * LK;       // [2][KT][LV] f32
  uint2* kp = reinterpret_cast<uint2*>(ks);  // [KT][LK] pairs
  uint2* vp = kp + KT * LK;                   // [KT][LV] pairs

  const int warp = threadIdx.x / 32;
  const int g = lane_g(), t = lane_t();
  // causal: the heaviest blocks first, every head's last query tile (it
  // sees the most keys) before any head's second last, and so on; the
  // grid keeps batch * q head on its second axis.  (32-bit arithmetic: a
  // 64-bit division is a call, and made the (256, 256) kernel spill.)
  const uint32_t q_tiles = gridDim.x, heads = gridDim.y;
  uint32_t qt = blockIdx.x, bhu = blockIdx.y;
  if (p.causal && uint64_t(q_tiles) * heads <= 0xffffffffull) {
    const uint32_t linear = blockIdx.y * q_tiles + blockIdx.x;
    qt = q_tiles - 1 - linear / heads;
    bhu = linear % heads;
  }
  const int64_t bh = bhu, q0 = int64_t(qt) * kRows;
  const uint32_t hq = uint32_t(p.hq), h = bhu % hq;
  const int64_t b = bhu / hq, hk = h / (hq / uint32_t(p.hkv));
  const int64_t off = p.off;
  const float* qb = q + b * p.qs[0] + h * p.qs[1];
  const float* kb = k + b * p.ks[0] + hk * p.ks[1];
  const float* vb = v + b * p.vs[0] + hk * p.vs[1];
  float* ob = o + b * p.os[0] + h * p.os[1];
  const int64_t rows = min64(kRows, p.sq - q0);
  const bool vec = p.vec != 0;
  const float scale = p.scale;

  // kv range that any row of this tile can see, in whole tiles
  int64_t k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min64(p.skv, q0 + rows + off);
  if (p.has_window) k_begin = max64(0, q0 + off - p.window + 1);
  k_begin = k_begin / KT * KT;
  const int64_t tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;
  // the warp's rows [r0, r0 + 16) and the keys they can see; its keys of
  // a kv tile start at n-tile n0
  const int r0 = 16 * (warp / R);
  const int n0 = NS * (warp % R);
  const bool active = r0 < rows;
  const int64_t first_q = q0 + r0 + off;
  const int64_t last_q = q0 + min64(r0 + 16, rows) - 1 + off;
  int64_t wk_begin = k_begin, wk_end = k_end;
  if (p.causal) wk_end = min64(p.skv, last_q + 1);
  if (p.has_window) wk_begin = max64(0, first_q - p.window + 1);

  stage_rows<D, kThreads>(qs, LQ, qb + q0 * p.qs[2], p.qs[2], kRows, rows,
                          vec);
  cp_async_commit();
  // f32 tiles: cp.async into a stage
  auto stage_kv = [&](int64_t k0, int st) {
    stage_rows<D, kThreads>(ks + st * KT * LK, LK, kb + k0 * p.ks[2],
                            p.ks[2], KT, p.skv - k0, vec);
    stage_rows<DV, kThreads>(vs + st * KT * LV, LV, vb + k0 * p.vs[2],
                             p.vs[2], KT, p.skv - k0, vec);
  };
  // pre-split tiles: a thread's chunks into registers, then split into
  // the pair tiles (keys past Skv as zeros)
  float4 buf[T::kPer];
  auto fetch = [&](int64_t k0) {
#pragma unroll
    for (int i = 0; i < T::kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      const bool is_k = c < KT * D / 4;
      const int cc = is_k ? c : c - KT * D / 4;
      const int w4 = (is_k ? D : DV) / 4;
      const int r = cc / w4, col = 4 * (cc % w4);
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (c < T::kChunks && k0 + r < p.skv) {
        const float* src = is_k ? kb + (k0 + r) * p.ks[2] + col
                                : vb + (k0 + r) * p.vs[2] + col;
        if (vec) {
          x = *reinterpret_cast<const float4*>(src);
        } else {
          x = make_float4(src[0], src[1], src[2], src[3]);
        }
      }
      buf[i] = x;
    }
  };
  auto put = [&]() {
#pragma unroll
    for (int i = 0; i < T::kPer; ++i) {
      const int c = threadIdx.x + i * kThreads;
      if (c >= T::kChunks) continue;
      const bool is_k = c < KT * D / 4;
      const int cc = is_k ? c : c - KT * D / 4;
      const int w4 = (is_k ? D : DV) / 4;
      const int r = cc / w4, col = 4 * (cc % w4);
      store4(is_k ? kp + r * LK + col : vp + r * LV + col, buf[i]);
    }
  };
  if (tiles > 0) {
    if constexpr (T::kPre) {
      fetch(k_begin);
      put();
    } else {
      stage_kv(k_begin, 0);
    }
  }
  cp_async_commit();

  // rows g and g + 8 of the warp: running max, this lane's share of the
  // sum, and O's C fragments
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f}, acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  // one kv tile's work for the warp: S, the softmax update, O += P V
  auto tile = [&](const auto* kt, const auto* vt, int64_t k0) {
    const int64_t kw0 = k0 + 8 * n0;  // the warp's first key of the tile
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    mma_nt<D, NS, chains(NS), true>(s, qs, LQ, r0, kt, LK, n0, n0 + NS);
    // s = (q.k) * scale, capped; then the mask, unless it keeps every
    // pair of the warp's rows and keys: each uniform test once a tile
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    if (p.has_softcap) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[n][e] = p.softcap * tanhf(s[n][e] / p.softcap);
    }
    const bool full = kw0 + 8 * NS <= p.skv &&
                      (!p.causal || kw0 + 8 * NS - 1 <= first_q) &&
                      (!p.has_window || last_q - kw0 < p.window);
    uint32_t keep[2] = {~0u, ~0u};  // bit 2n + e: (row, key 8n + 2t + e)
    if (!full) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int64_t qpos = first_q + g + 8 * hh;
        uint32_t bits = 0;
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t kpos = kw0 + 8 * n + 2 * t + e;
            bool ok = kpos < p.skv;
            if (p.causal) ok = ok && qpos >= kpos;
            if (p.has_window) ok = ok && (qpos - kpos) < p.window;
            bits |= (uint32_t)ok << (2 * n + e);
            if (!ok) s[n][2 * hh + e] = kNeg;
          }
        keep[hh] = bits;
      }
    }

#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[n][2 * hh + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m[hh], mx);
      const float alpha = expf(m[hh] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float pr = expf(s[n][2 * hh + e] - m_cur);
          if (!full && !((keep[hh] >> (2 * n + e)) & 1u)) pr = 0.f;
          s[n][2 * hh + e] = pr;
          sum += pr;
        }
      l[hh] = alpha * l[hh] + sum;
      m[hh] = m_cur;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        acc[j][2 * hh] *= alpha;
        acc[j][2 * hh + 1] *= alpha;
      }
    }

    // O += P V: each n-tile of S is a k-step of 8 keys
    mma_rn<NS, NO, chains(NO)>(acc, s, vt, LV, n0);
  };

  for (int64_t i = 0; i < tiles; ++i) {
    const int64_t k0 = k_begin + i * KT;
    const int64_t kw0 = k0 + 8 * n0;
    const bool work = active && kw0 < wk_end && kw0 + 8 * NS > wk_begin;
    if constexpr (T::kPre) {
      if (i + 1 < tiles) fetch(k0 + KT);  // in flight during this tile
      cp_async_wait<0>();                 // Q landed
      __syncthreads();                    // the pair tiles are written
      if (work) tile(kp, vp, k0);
      if (i + 1 < tiles) {
        __syncthreads();  // every warp is done with this tile
        put();
      }
    } else {
      const int st = (int)(i & 1);
      if (i + 1 < tiles) stage_kv(k0 + KT, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // tile i (and Q) landed
      __syncthreads();
      if (work) tile(ks + st * KT * LK, vs + st * KT * LV, k0);
      __syncthreads();  // this stage's readers are done before it refills
    }
  }
  cp_async_wait<0>();

  // each row's sum over its quad
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }

  if (R > 1) {
    // the R warps' partial states of each row (each over its own keys)
    // into the kv tiles, combined: M = max m_w, L = sum l_w e^(m_w - M),
    // O = sum acc_w e^(m_w - M) / L
    constexpr int LC = T::LC;  // a row: acc, then m, l
    float* part = ks;          // [W][16][LC]
    __syncthreads();
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float* row = part + (warp * 16 + g + 8 * hh) * LC;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        row[8 * j + 2 * t] = acc[j][2 * hh];
        row[8 * j + 2 * t + 1] = acc[j][2 * hh + 1];
      }
      if (t == 0) {
        row[DV] = m[hh];
        row[DV + 1] = l[hh];
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < rows * (DV + 1); e += kThreads) {
      const int r = e / (DV + 1), c = e % (DV + 1);
      // row r's warps: R (r / 16) .. R (r / 16) + R - 1, at row r % 16
      const float* rw = part + ((r / 16) * R * 16 + r % 16) * LC;
      float mx = kNeg;
      for (int w = 0; w < R; ++w) mx = fmaxf(mx, rw[w * 16 * LC + DV]);
      float sum = 0.f, val = 0.f;
      for (int w = 0; w < R; ++w) {
        const float* row = rw + w * 16 * LC;
        const float f = expf(row[DV] - mx);
        sum += row[DV + 1] * f;
        if (c < DV) val += row[c] * f;
      }
      if (c < DV) {
        ob[(q0 + r) * p.os[2] + c] = val / (sum == 0.f ? 1.f : sum);
      } else if (p.lse != nullptr) {
        p.lse[bh * p.sq + q0 + r] = sum > 0.f ? mx + logf(sum) : -kNeg;
      }
    }
    return;
  }
  if (!active) return;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = r0 + g + 8 * hh;
    if (r >= rows) continue;
    const float inv = l[hh] == 0.f ? 1.f : l[hh];
    if (p.lse != nullptr && t == 0)
      p.lse[bh * p.sq + q0 + r] = l[hh] > 0.f ? m[hh] + logf(l[hh]) : -kNeg;
    float* orow = ob + (q0 + r) * p.os[2];
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      orow[8 * j + 2 * t] = acc[j][2 * hh] / inv;
      orow[8 * j + 2 * t + 1] = acc[j][2 * hh + 1] / inv;
    }
  }
}

template <int D, int DV, bool kSplit>
int launch_tiles(const void* q, const void* k, const void* v, void* o,
                 const Params& p, cudaStream_t stream) {
  using T = Tiles<D, DV, kSplit>;
  cudaFuncSetAttribute(flash_fwd<D, DV, kSplit>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)T::kBytes);
  const dim3 grid((unsigned)((p.sq + T::kRows - 1) / T::kRows),
                  (unsigned)(p.batch * p.hq));
  flash_fwd<D, DV, kSplit><<<grid, T::kThreads, T::kBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  return p.sq <= 16 ? launch_tiles<D, DV, true>(q, k, v, o, p, stream)
                    : launch_tiles<D, DV, false>(q, k, v, o, p, stream);
}

// whether a tensor's rows take 16-byte copies: its base and (batch, head,
// seq) strides are multiples of 4 floats
bool aligned16(const void* t, const int64_t* strides) {
  if (reinterpret_cast<uintptr_t>(t) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 4) return false;
  return true;
}

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim (of q and k), then the (batch,
// head, seq) element strides of q, k, v and o, all f32, then v's head_dim;
// lse: f32 [batch, hq, sq], contiguous, or null.
extern "C" int FA_ENTRY(const void* q, const void* k, const void* v,
                        void* o, const long long* dims, int causal,
                        int has_window, long long window, int has_softcap,
                        float softcap, float scale, long long q_offset,
                        void* lse, void* stream) {
  Params p;
  p.batch = dims[0];
  p.hq = dims[1];
  p.hkv = dims[2];
  p.sq = dims[3];
  p.skv = dims[4];
  const int head_dim = (int)dims[5], v_dim = (int)dims[18];
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = dims[6 + i];
    p.ks[i] = dims[9 + i];
    p.vs[i] = dims[12 + i];
    p.os[i] = dims[15 + i];
  }
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  p.off = q_offset;
  p.lse = (float*)lse;
  p.vec = aligned16(q, p.qs) && aligned16(k, p.ks) && aligned16(v, p.vs);
  if (p.sq <= 0 || p.batch * p.hq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(D, DV) \
  if (head_dim == D && v_dim == DV) return launch<D, DV>(q, k, v, o, p, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}
