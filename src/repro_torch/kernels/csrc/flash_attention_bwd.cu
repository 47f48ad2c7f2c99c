// Flash attention backward for Hopper (sm_90a) in f32: dq, dk and dv from
// (q, k, v, o, lse, dO), every product on the tensor cores in 3xTF32.
// bf16 inputs take flash_attention_bwd_sm90.cu (wgmma, TMA); this kernel
// is the f32 route.
//
// No Pallas kernel stands behind it: the JAX package differentiates its
// XLA attention (src/repro/models/flash_xla.py, `_bwd_rule`, the custom VJP
// of `flash_attention_xla`), and this kernel computes that rule.  For each
// (query, key) pair the query may see: s = (q.k) * scale; under a softcap
// t = tanh(s / softcap), s = softcap * t; p = exp(s - lse), with the
// forward's lse (+BIG in a row with no key, so p = 0 there); then dv += p dO,
// dp = dO.v, ds = p (dp - delta) with delta = rowsum(dO * o), times (1 - t^2)
// under a softcap, times the scale; dq += ds k and dk += ds q.  Masked pairs
// have p = ds = 0.  The mask is the forward's: query row i at position
// i + q_offset; causal qpos >= kpos; window qpos - kpos < window.  GQA: q
// head h reads kv head h / (Hq / Hkv), and dk and dv sum over the q heads of
// a kv head.
//
// Three passes a call, one stream, no atomics, so two calls give the same
// bits:
// - delta: one warp a query row, rowsum(dO * o) in f32 on the CUDA cores;
// - dk/dv: one block of 8 warps per (kv tile of KT keys, batch * kv head),
//   looping over the q heads of its group and over the query tiles of 32
//   rows that its keys can see (causal and window bounds); the Q, dO, lse
//   and delta tiles are double-buffered by cp.async.  Each query tile
//   takes two steps: S^T = K Q^T and dP^T = V dO^T, each warp 16 keys by
//   a share of the queries, then P^T and dS^T into shared memory; then
//   dV += P^T dO and dK += dS^T Q, each warp 16 keys by a share of the
//   columns, its dk and dv in registers for the whole loop;
// - dq: one block of 8 warps per (query tile of QT rows, batch * q head),
//   looping over the kv tiles of 32 keys its rows can see (K and V
//   double-buffered): S = Q K^T and dP = dO V^T, dS into shared memory,
//   dQ += dS K.
// So s and dp are computed twice (7 products where 5 would do): the price
// of writing dq without atomics or a second buffer.  Every product is an
// mma.sync m16n8k8 in 3xTF32 (tf32x3.cuh): within 2^-22 of the f32
// product, so the f32 tolerance (1e-4 of each gradient's max |x|) holds,
// where one TF32 product (~2^-11) would not.  Only P, dS and the f32 row
// statistics pass through shared memory; p, ds, the masks and the softcap's
// derivative stay in f32 on the CUDA cores.
//
// What bounds it: operations.  A visible pair costs 14 * D flops here (10
// * D in the five products of the rule) against bytes read once a tile;
// on the tensor cores in 3xTF32 the f32-accurate peak is 495 / 3 = 165
// TFLOP/s.  Tiles: KT = 64 keys (dk/dv) and QT = 64 rows (dq) where D + Dv
// <= 160, else 32, so that the narrow heads fit two blocks an SM and D =
// 256 fits one (210 KB of shared memory for dk/dv, 205 KB for dq).  Row
// strides are padded (pad4 / pad8) so that every fragment load is free of
// bank conflicts.  A warp's share of a product is a few 8-wide tiles (one
// to eight), so its mma.sync would wait on each other through their
// accumulators: where it has fewer than eight, the products run over two
// or four independent accumulator chains, added at the end (`chains`).
// The k-loops are unrolled.
//
// q and k have head_dim D, v, o and dO head_dim DV (MLA's 96 / 64): s and
// dq, dk run over D, dp, delta and dv over DV.  D and DV are multiples of 8.
//
// Plain-C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() that is not 0, or -1 for a (D, DV) pair it was not
// built for.

#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

#include "tf32x3.cuh"

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_bwd_mla.cu includes this file with
// its own pairs, so each set compiles in a translation unit of its own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_bwd
#endif

namespace {

constexpr int kDeltaThreads = 256;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr float kNeg = -0.7f * FLT_MAX;

struct Params {
  int64_t batch, hq, hkv, sq, skv, off;
  // element strides of (batch, head, seq); head_dim is contiguous
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int causal, has_window, has_softcap;
  int64_t window;
  float softcap, scale;
  int vec;  // q, k, v and dO take 16-byte copies
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ bool visible(const Params& p, int64_t qpos,
                                        int64_t kpos) {
  bool ok = true;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.has_window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// whether the mask keeps every pair of the rows [i0, i0 + rows) and the
// keys [k0, k0 + keys): then no pair of the tile needs its test
__device__ __forceinline__ bool tile_full(const Params& p, int64_t i0,
                                          int rows, int64_t k0, int keys) {
  const int64_t first_q = i0 + p.off, last_q = first_q + rows - 1;
  return k0 + keys <= p.skv && i0 + rows <= p.sq &&
         (!p.causal || k0 + keys - 1 <= first_q) &&
         (!p.has_window || last_q - k0 < p.window);
}

// p and ds of one pair from its logit and dp, the row's lse and delta
__device__ __forceinline__ void p_ds(const Params& p, bool keep, float s,
                                     float dp, float lse, float delta,
                                     float& pr, float& ds) {
  float x = s * p.scale, t = 0.f;
  if (p.has_softcap) {
    t = tanhf(x / p.softcap);
    x = p.softcap * t;
  }
  pr = keep ? expf(x - lse) : 0.f;
  ds = pr * (dp - delta);
  if (p.has_softcap) ds *= 1.f - t * t;
  ds *= p.scale;
}

// the tiles of a (D, DV) pair; widths of the shared-memory rows
template <int D, int DV>
struct Tiles {
  static constexpr bool kNarrow = D + DV <= 160;
  static constexpr int KT = kNarrow ? 64 : 32;  // dk/dv: keys a block
  static constexpr int QT = 32;                 // dk/dv: queries a tile
  static constexpr int DQ_QT = kNarrow ? 64 : 32;  // dq: rows a block
  static constexpr int DQ_KT = 32;                 // dq: keys a tile
  static constexpr int LD = pad4(D), LV = pad4(DV);
  // dk/dv: K [KT][LD], V [KT][LV], 2 x (Q [QT][LD], dO [QT][LV], lse,
  // delta [QT]), P^T and dS^T [KT][pad8(QT)]
  static constexpr size_t kDkdvBytes =
      sizeof(float) * (size_t(KT) * (LD + LV) +
                       size_t(2) * QT * (LD + LV + 2) +
                       size_t(2) * KT * pad8(QT));
  // dq: Q [DQ_QT][LD], dO [DQ_QT][LV], lse, delta [DQ_QT], 2 x (K
  // [DQ_KT][LD], V [DQ_KT][LV]), dS [DQ_QT][pad8(DQ_KT)]
  static constexpr size_t kDqBytes =
      sizeof(float) * (size_t(DQ_QT) * (LD + LV + 2) +
                       size_t(2) * DQ_KT * (LD + LV) +
                       size_t(DQ_QT) * pad8(DQ_KT));
};

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d], a warp a row (D
// here is v's head_dim).
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
    bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, Params p) {
  const int64_t row =
      (int64_t)blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.batch * p.hq * p.sq) return;
  const int64_t i = row % p.sq, bh = row / p.sq;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const float* orow = o + b * p.os[0] + h * p.os[1] + i * p.os[2];
  const float* drow = dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += drow[d] * orow[d];
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (lane == 0) delta[row] = sum;
}

// A C fragment's four values (rows g, g + 8; columns 2t, 2t + 1 of n-tile
// n) into a [rows][ld] tile at row m0, as two 8-byte stores
__device__ __forceinline__ void store_c(float* s, int ld, int m0, int n,
                                        const float* c) {
  float* r = s + (m0 + lane_g()) * ld + 8 * n + 2 * lane_t();
  *reinterpret_cast<float2*>(r) = make_float2(c[0], c[1]);
  *reinterpret_cast<float2*>(r + 8 * ld) = make_float2(c[2], c[3]);
}

// acc's C fragments (n-tiles first + j < count) into rows [r0, r0 + 16)
// of out (row stride rs) below `valid` rows
template <int J>
__device__ __forceinline__ void write_rows(float* out, int64_t rs, int r0,
                                           int64_t valid,
                                           const float (*acc)[4], int first,
                                           int count) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int n = first + j;
    if (n >= count) continue;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = r0 + g + 8 * hh;
      if (r >= valid) continue;
      float* row = out + r * rs + 8 * n + 2 * t;
      row[0] = acc[j][2 * hh];
      row[1] = acc[j][2 * hh + 1];
    }
  }
}

template <int J>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// A warp's share of n n-tiles split over G warps: J = ceil(n / G) tiles
// from first = g J; kAll when every warp's J tiles are all below n
template <int N, int G>
struct Share {
  static constexpr int J = (N + G - 1) / G;
  static constexpr bool kAll = J * G == N;
};

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, Params p) {
  using T = Tiles<D, DV>;
  constexpr int KT = T::KT, QT = T::QT, LD = T::LD, LV = T::LV;
  constexpr int LP = pad8(QT);
  constexpr int MT = KT / 16, NG = kWarps / MT;  // key m-tiles, col groups
  using S1 = Share<QT / 8, NG>;                  // query n-tiles a warp
  using SK = Share<D / 8, NG>;                   // dk, dv n-tiles a warp
  using SV = Share<DV / 8, NG>;
  constexpr int J1 = S1::J, JK = SK::J, JV = SV::J;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                   // [KT][LD]
  float* vs = ks + KT * LD;           // [KT][LV]
  float* qs = vs + KT * LV;           // [2][QT][LD]
  float* dos = qs + 2 * QT * LD;      // [2][QT][LV]
  float* pt = dos + 2 * QT * LV;      // [KT][LP]
  float* dst = pt + KT * LP;          // [KT][LP]
  float* lse_s = dst + KT * LP;       // [2][QT]
  float* del_s = lse_s + 2 * QT;      // [2][QT]

  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int m0 = 16 * (warp % MT), ng = warp / MT;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hkv, hk = bh % p.hkv;
  const int64_t gq = p.hq / p.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * KT;
  const int64_t keys = min64(KT, p.skv - k0);
  const bool vec = p.vec != 0;
  stage_rows<D, kThreads>(ks, LD, k + b * p.ks[0] + hk * p.ks[1] +
                          k0 * p.ks[2], p.ks[2], KT, keys, vec);
  stage_rows<DV, kThreads>(vs, LV, v + b * p.vs[0] + hk * p.vs[1] +
                           k0 * p.vs[2], p.vs[2], KT, keys, vec);
  cp_async_commit();

  // the query rows that any of these keys can see
  int64_t i_begin = 0, i_end = p.sq;
  if (p.causal) i_begin = max64(0, k0 - p.off);
  if (p.has_window) i_end = min64(p.sq, k0 + keys - 1 + p.window - p.off);
  const int64_t q_tiles =
      i_end > i_begin ? (i_end - i_begin + QT - 1) / QT : 0;
  const int64_t steps = gq * q_tiles;
  auto stage_q = [&](int64_t it, int st) {
    const int64_t h = hk * gq + it / q_tiles;
    const int64_t i0 = i_begin + (it % q_tiles) * QT;
    const int64_t at = (b * p.hq + h) * p.sq + i0;
    stage_rows<D, kThreads>(qs + st * QT * LD, LD,
                            q + b * p.qs[0] + h * p.qs[1] + i0 * p.qs[2],
                            p.qs[2], QT, p.sq - i0, vec);
    stage_rows<DV, kThreads>(dos + st * QT * LV, LV,
                             dout + b * p.dos[0] + h * p.dos[1] +
                                 i0 * p.dos[2],
                             p.dos[2], QT, p.sq - i0, vec);
    stage_vec<kThreads>(lse_s + st * QT, lse + at, QT, p.sq - i0);
    stage_vec<kThreads>(del_s + st * QT, delta + at, QT, p.sq - i0);
  };
  if (steps > 0) stage_q(0, 0);
  cp_async_commit();

  float dk_acc[JK][4], dv_acc[JV][4];
  zero<JK>(dk_acc);
  zero<JV>(dv_acc);

  for (int64_t it = 0; it < steps; ++it) {
    const int st = (int)(it & 1);
    const int64_t i0 = i_begin + (it % q_tiles) * QT;
    if (it + 1 < steps) stage_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt = qs + st * QT * LD;
    const float* dot = dos + st * QT * LV;
    const float* ls = lse_s + st * QT;
    const float* ds_ = del_s + st * QT;

    // S^T and dP^T: keys [m0, m0 + 16) by the warp's query n-tiles
    float s[J1][4], dp[J1][4];
    zero<J1>(s);
    zero<J1>(dp);
    mma_nt<D, J1, chains(J1), S1::kAll>(s, ks, LD, m0, qt, LD, ng * J1,
                                        QT / 8);
    mma_nt<DV, J1, chains(J1), S1::kAll>(dp, vs, LV, m0, dot, LV, ng * J1,
                                         QT / 8);
    const bool full = tile_full(p, i0, QT, k0, KT);
#pragma unroll
    for (int j = 0; j < J1; ++j) {
      const int n = ng * J1 + j;
      if (!S1::kAll && n >= QT / 8) continue;
      float pr[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = m0 + g + 8 * (e / 2), qc = 8 * n + 2 * t + (e % 2);
        const int64_t kpos = k0 + kr, qi = i0 + qc;
        const bool keep = full || (kpos < p.skv && qi < p.sq &&
                                   visible(p, qi + p.off, kpos));
        p_ds(p, keep, s[j][e], dp[j][e], ls[qc], ds_[qc], pr[e], ds[e]);
      }
      store_c(pt, LP, m0, n, pr);
      store_c(dst, LP, m0, n, ds);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: keys [m0, m0 + 16) by the warp's
    // column n-tiles
    mma_nn<QT, JV, chains(JV), SV::kAll>(dv_acc, pt, LP, m0, dot, LV,
                                         ng * JV, DV / 8);
    mma_nn<QT, JK, chains(JK), SK::kAll>(dk_acc, dst, LP, m0, qt, LD,
                                         ng * JK, D / 8);
    __syncthreads();  // the stage and P^T, dS^T are free again
  }
  cp_async_wait<0>();
  write_rows<JK>(dk + b * p.dks[0] + hk * p.dks[1] + k0 * p.dks[2], p.dks[2],
                 m0, keys, dk_acc, ng * JK, D / 8);
  write_rows<JV>(dv + b * p.dvs[0] + hk * p.dvs[1] + k0 * p.dvs[2], p.dvs[2],
                 m0, keys, dv_acc, ng * JV, DV / 8);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, Params p) {
  using T = Tiles<D, DV>;
  constexpr int QT = T::DQ_QT, KT = T::DQ_KT, LD = T::LD, LV = T::LV;
  constexpr int LS = pad8(KT);
  constexpr int MT = QT / 16, NG = kWarps / MT;  // row m-tiles, col groups
  using S1 = Share<KT / 8, NG>;                  // key n-tiles a warp
  using SQ = Share<D / 8, NG>;                   // dq n-tiles a warp
  constexpr int J1 = S1::J, JQ = SQ::J;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                   // [QT][LD]
  float* dos = qs + QT * LD;          // [QT][LV]
  float* ks = dos + QT * LV;          // [2][KT][LD]
  float* vs = ks + 2 * KT * LD;       // [2][KT][LV]
  float* dss = vs + 2 * KT * LV;      // [QT][LS]
  float* lse_s = dss + QT * LS;       // [QT]
  float* del_s = lse_s + QT;          // [QT]

  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int m0 = 16 * (warp % MT), ng = warp / MT;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const int64_t hk = h / (p.hq / p.hkv);
  const int64_t i0 = (int64_t)blockIdx.x * QT;
  const int64_t rows = min64(QT, p.sq - i0);
  const bool vec = p.vec != 0;
  stage_rows<D, kThreads>(qs, LD, q + b * p.qs[0] + h * p.qs[1] +
                          i0 * p.qs[2], p.qs[2], QT, rows, vec);
  stage_rows<DV, kThreads>(dos, LV, dout + b * p.dos[0] + h * p.dos[1] +
                           i0 * p.dos[2], p.dos[2], QT, rows, vec);
  const int64_t at = bh * p.sq + i0;
  stage_vec<kThreads>(lse_s, lse + at, QT, rows);
  stage_vec<kThreads>(del_s, delta + at, QT, rows);
  cp_async_commit();

  // the keys that any of these rows can see
  int64_t k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min64(p.skv, i0 + rows + p.off);
  if (p.has_window) k_begin = max64(0, i0 + p.off - p.window + 1);
  const int64_t tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;
  const float* kb = k + b * p.ks[0] + hk * p.ks[1];
  const float* vb = v + b * p.vs[0] + hk * p.vs[1];
  auto stage_kv = [&](int64_t k0, int st) {
    stage_rows<D, kThreads>(ks + st * KT * LD, LD, kb + k0 * p.ks[2],
                            p.ks[2], KT, p.skv - k0, vec);
    stage_rows<DV, kThreads>(vs + st * KT * LV, LV, vb + k0 * p.vs[2],
                             p.vs[2], KT, p.skv - k0, vec);
  };
  if (tiles > 0) stage_kv(k_begin, 0);
  cp_async_commit();

  float dq_acc[JQ][4];
  zero<JQ>(dq_acc);
  for (int64_t it = 0; it < tiles; ++it) {
    const int64_t k0 = k_begin + it * KT;
    const int st = (int)(it & 1);
    if (it + 1 < tiles) stage_kv(k0 + KT, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kt = ks + st * KT * LD;
    const float* vt = vs + st * KT * LV;

    // S and dP: rows [m0, m0 + 16) by the warp's key n-tiles
    float s[J1][4], dp[J1][4];
    zero<J1>(s);
    zero<J1>(dp);
    mma_nt<D, J1, chains(J1), S1::kAll>(s, qs, LD, m0, kt, LD, ng * J1,
                                        KT / 8);
    mma_nt<DV, J1, chains(J1), S1::kAll>(dp, dos, LV, m0, vt, LV, ng * J1,
                                         KT / 8);
    const bool full = tile_full(p, i0, QT, k0, KT);
#pragma unroll
    for (int j = 0; j < J1; ++j) {
      const int n = ng * J1 + j;
      if (!S1::kAll && n >= KT / 8) continue;
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + g + 8 * (e / 2), c = 8 * n + 2 * t + (e % 2);
        const int64_t kpos = k0 + c, qi = i0 + r;
        const bool keep = full || (kpos < p.skv && qi < p.sq &&
                                   visible(p, qi + p.off, kpos));
        float pr;
        p_ds(p, keep, s[j][e], dp[j][e], lse_s[r], del_s[r], pr, ds[e]);
      }
      store_c(dss, LS, m0, n, ds);
    }
    __syncthreads();

    // dQ += dS K: rows [m0, m0 + 16) by the warp's column n-tiles
    mma_nn<KT, JQ, chains(JQ), SQ::kAll>(dq_acc, dss, LS, m0, kt, LD,
                                         ng * JQ, D / 8);
    __syncthreads();  // the stage and dS are free again
  }
  cp_async_wait<0>();
  write_rows<JQ>(dq + b * p.dqs[0] + h * p.dqs[1] + i0 * p.dqs[2], p.dqs[2],
                 m0, rows, dq_acc, ng * JQ, D / 8);
}

template <int D, int DV>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* dq, float* dk,
           float* dv, float* delta, const Params& p, cudaStream_t stream) {
  using T = Tiles<D, DV>;
  // a pass with nothing to do is not launched (a grid of 0 is refused)
  const int64_t rows = p.batch * p.hq * p.sq;
  if (rows > 0) {
    constexpr int kRows = kDeltaThreads / 32;
    bwd_delta<DV><<<(unsigned)((rows + kRows - 1) / kRows), kDeltaThreads,
                    0, stream>>>(o, dout, delta, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (p.skv > 0) {
    cudaFuncSetAttribute(bwd_dkdv<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)T::kDkdvBytes);
    const dim3 grid((unsigned)((p.skv + T::KT - 1) / T::KT),
                    (unsigned)(p.batch * p.hkv));
    bwd_dkdv<D, DV><<<grid, kThreads, T::kDkdvBytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (rows > 0) {
    cudaFuncSetAttribute(bwd_dq<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)T::kDqBytes);
    const dim3 grid((unsigned)((p.sq + T::DQ_QT - 1) / T::DQ_QT),
                    (unsigned)(p.batch * p.hq));
    bwd_dq<D, DV><<<grid, kThreads, T::kDqBytes, stream>>>(
        q, k, v, dout, lse, delta, dq, p);
    return (int)cudaGetLastError();
  }
  return 0;
}

int dispatch(int head_dim, int v_dim, const float* q, const float* k,
             const float* v, const float* o, const float* lse,
             const float* dout, float* dq, float* dk, float* dv, float* delta,
             const Params& p, cudaStream_t s) {
#define FA_CASE(D, DV)                   \
  if (head_dim == D && v_dim == DV)      \
    return launch<D, DV>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
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
// head, seq) element strides of q, k, v, o, do, dq, dk and dv, then v's
// head_dim; every tensor f32 (lse and delta [batch, hq, sq], contiguous;
// delta is scratch).
extern "C" int FA_ENTRY(const float* q, const float* k, const float* v,
                        const float* o, const float* lse, const float* dout,
                        float* dq, float* dk, float* dv, float* delta,
                        const long long* dims, int causal, int has_window,
                        long long window, int has_softcap, float softcap,
                        float scale, long long q_offset, void* stream) {
  Params p;
  p.batch = dims[0];
  p.hq = dims[1];
  p.hkv = dims[2];
  p.sq = dims[3];
  p.skv = dims[4];
  const int head_dim = (int)dims[5], v_dim = (int)dims[30];
  int64_t* strides[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[6 + 3 * t + i];
  p.off = q_offset;
  p.causal = causal;
  p.has_window = has_window;
  p.window = window;
  p.has_softcap = has_softcap;
  p.softcap = softcap;
  p.scale = scale;
  p.vec = aligned16(q, p.qs) && aligned16(k, p.ks) && aligned16(v, p.vs) &&
          aligned16(dout, p.dos);
  if (p.batch * p.hq <= 0) return 0;
  return dispatch(head_dim, v_dim, q, k, v, o, lse, dout, dq, dk, dv, delta,
                  p, (cudaStream_t)stream);
}
