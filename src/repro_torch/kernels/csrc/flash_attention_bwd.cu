// Flash attention backward for Hopper (sm_90a) in f32: dq, dk and dv from
// (q, k, v, o, lse, dO) on the CUDA cores.  bf16 inputs take
// flash_attention_bwd_sm90.cu (wgmma, TMA); this kernel is the f32 route
// (the f32 tolerance of 1e-4 rules out a bf16 P and dS).
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
// Three passes a call, one stream, no atomics:
// - delta: one warp a query row, rowsum(dO * o) in f32;
// - dk/dv: one block per (kv tile of 32 keys, batch * kv head).  The block
//   keeps its keys' dk and dv rows in registers and loops over the q heads
//   of its group and over the query tiles of 32 rows that its keys can see
//   (causal and window bounds), recomputing s and p for each;
// - dq: one block per (query tile of 32 rows, batch * q head), looping over
//   the kv tiles its rows can see and recomputing p and ds.
// So s and dp are computed twice (7 products where 5 would do): the price of
// writing dq without atomics or a second buffer.
//
// What bounds it: operations.  A visible pair costs 14 * D flops here (10 *
// D in the five products of the rule) against bytes read once a tile; this
// simple version keeps them on the CUDA cores in f32 (tiles in shared
// memory, each thread 4 outputs of a 32 x 32 product at a time): the f32
// peak, not the tensor cores', bounds it.
//
// Shared memory, in f32: K and V transposed
// ([D][33]: consecutive keys in consecutive banks), Q and dO by rows with a
// stride of D + 1, P and dS [32][33]: 142,080 bytes at D = 256, so the
// launch opts in to dynamic shared memory.
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

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_bwd_mla.cu includes this file with
// its own pairs, so each set compiles in a translation unit of its own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_bwd
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // query rows and keys a tile
constexpr int kPadT = kTile + 1;   // row stride of K^T, V^T, P and dS
constexpr float kNeg = -0.7f * FLT_MAX;

struct Params {
  int64_t batch, hq, hkv, sq, skv, off;
  // element strides of (batch, head, seq); head_dim is contiguous
  int64_t qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int causal, has_window, has_softcap;
  int64_t window;
  float softcap, scale;
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <int D, int DV>
constexpr size_t dkdv_smem() {
  // K^T [D][kPadT], V^T [DV][kPadT]; Q [kTile][D + 1], dO [kTile][DV + 1];
  // P, dS [kTile][kPadT]; lse, delta [kTile]
  return sizeof(float) * (size_t(D + DV) * kPadT + size_t(kTile) * (D + DV + 2) +
                          size_t(2) * kTile * kPadT + 2 * kTile);
}

template <int D, int DV>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t(D + DV) * kPadT + size_t(kTile) * (D + DV + 2) +
                          size_t(kTile) * kPadT + 2 * kTile);
}

__device__ __forceinline__ bool visible(const Params& p, int64_t qpos,
                                        int64_t kpos) {
  bool ok = true;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.has_window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d], a warp a row (D
// here is v's head_dim).
template <int D>
__global__ void __launch_bounds__(kThreads)
    bwd_delta(const float* __restrict__ o, const float* __restrict__ dout,
              float* __restrict__ delta, Params p) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
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

// One query tile's rows into shared memory (Q and dO by rows, strides D + 1
// and DV + 1; rows past Sq are zero, their lse +BIG and delta 0).
template <int D, int DV>
__device__ __forceinline__ void load_rows(
    const float* __restrict__ q, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Params& p, int64_t b, int64_t h, int64_t i0, float* qs_, float* dos_,
    float* lse_, float* delta_) {
  const float* qb = q + b * p.qs[0] + h * p.qs[1];
  const float* db = dout + b * p.dos[0] + h * p.dos[1];
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qs_[r * (D + 1) + d] = i0 + r < p.sq ? qb[(i0 + r) * p.qs[2] + d] : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * DV; e += kThreads) {
    const int r = e / DV, d = e % DV;
    dos_[r * (DV + 1) + d] = i0 + r < p.sq ? db[(i0 + r) * p.dos[2] + d] : 0.f;
  }
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const bool in = i0 + r < p.sq;
    const int64_t at = (b * p.hq + h) * p.sq + i0 + r;
    lse_[r] = in ? lse[at] : -kNeg;
    delta_[r] = in ? delta[at] : 0.f;
  }
}

// One kv tile's keys into shared memory, transposed (K [D][kPadT], V
// [DV][kPadT]; keys past Skv are zero).
template <int D, int DV>
__device__ __forceinline__ void load_keys(const float* __restrict__ k,
                                          const float* __restrict__ v,
                                          const Params& p, int64_t b,
                                          int64_t hk, int64_t k0, float* kt,
                                          float* vt) {
  const float* kb = k + b * p.ks[0] + hk * p.ks[1];
  const float* vb = v + b * p.vs[0] + hk * p.vs[1];
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int c = e / D, d = e % D;
    kt[d * kPadT + c] = k0 + c < p.skv ? kb[(k0 + c) * p.ks[2] + d] : 0.f;
  }
  for (int e = threadIdx.x; e < kTile * DV; e += kThreads) {
    const int c = e / DV, d = e % DV;
    vt[d * kPadT + c] = k0 + c < p.skv ? vb[(k0 + c) * p.vs[2] + d] : 0.f;
  }
}

// p and ds of a 32 x 32 tile: thread (r = tid / 8, c = tid % 8) computes
// row r, columns c + 8 j (j < 4), and writes them to P (if not null) and dS.
template <int D, int DV>
__device__ __forceinline__ void tile_p_ds(const Params& p, int64_t i0,
                                          int64_t k0, const float* qs_,
                                          const float* dos_, const float* kt,
                                          const float* vt, const float* lse_,
                                          const float* delta_, float* pp,
                                          float* dss) {
  const int r = threadIdx.x / 8, c = threadIdx.x % 8;
  float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
  for (int d = 0; d < D; ++d) {
    const float qa = qs_[r * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] = fmaf(qa, kt[d * kPadT + c + 8 * j], s[j]);
  }
  for (int d = 0; d < DV; ++d) {
    const float da = dos_[r * (DV + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dp[j] = fmaf(da, vt[d * kPadT + c + 8 * j], dp[j]);
  }
  const int64_t qpos = i0 + r + p.off;
  const bool row_in = i0 + r < p.sq;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = c + 8 * j;
    const int64_t kpos = k0 + col;
    const bool keep = row_in && kpos < p.skv && visible(p, qpos, kpos);
    float x = s[j] * p.scale, t = 0.f;
    if (p.has_softcap) {
      t = tanhf(x / p.softcap);
      x = p.softcap * t;
    }
    const float pr = keep ? expf(x - lse_[r]) : 0.f;
    float ds = pr * (dp[j] - delta_[r]);
    if (p.has_softcap) ds *= 1.f - t * t;
    ds *= p.scale;
    if (pp != nullptr) pp[r * kPadT + col] = pr;
    dss[r * kPadT + col] = ds;
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             float* __restrict__ dk, float* __restrict__ dv, Params p) {
  constexpr int kCols = D / 8, kVCols = DV / 8;  // dk, dv columns a thread
  extern __shared__ float smem[];
  float* kt = smem;                      // [D][kPadT]
  float* vt = kt + D * kPadT;            // [DV][kPadT]
  float* qs_ = vt + DV * kPadT;          // [kTile][D + 1]
  float* dos_ = qs_ + kTile * (D + 1);   // [kTile][DV + 1]
  float* pp = dos_ + kTile * (DV + 1);   // [kTile][kPadT]
  float* dss = pp + kTile * kPadT;       // [kTile][kPadT]
  float* lse_ = dss + kTile * kPadT;     // [kTile]
  float* delta_ = lse_ + kTile;          // [kTile]

  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hkv, hk = bh % p.hkv;
  const int64_t g = p.hq / p.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int64_t keys = min64(kTile, p.skv - k0);
  load_keys<D, DV>(k, v, p, b, hk, k0, kt, vt);

  // the query rows that any of these keys can see
  int64_t i_begin = 0, i_end = p.sq;
  if (p.causal) i_begin = max64(0, k0 - p.off);
  if (p.has_window) i_end = min64(p.sq, k0 + keys - 1 + p.window - p.off);

  const int jr = threadIdx.x / 8, tx = threadIdx.x % 8;
  float dk_acc[kCols], dv_acc[kVCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dk_acc[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kVCols; ++c) dv_acc[c] = 0.f;

  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t h = hk * g + gi;
    for (int64_t i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<D, DV>(q, dout, lse, delta, p, b, h, i0, qs_, dos_, lse_,
                       delta_);
      __syncthreads();
      tile_p_ds<D, DV>(p, i0, k0, qs_, dos_, kt, vt, lse_, delta_, pp, dss);
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float pr = pp[r * kPadT + jr];
        const float ds = dss[r * kPadT + jr];
#pragma unroll
        for (int c = 0; c < kVCols; ++c)
          dv_acc[c] = fmaf(pr, dos_[r * (DV + 1) + tx + 8 * c], dv_acc[c]);
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          dk_acc[c] = fmaf(ds, qs_[r * (D + 1) + tx + 8 * c], dk_acc[c]);
      }
    }
  }
  if (jr < keys) {
    float* dkr = dk + b * p.dks[0] + hk * p.dks[1] + (k0 + jr) * p.dks[2];
    float* dvr = dv + b * p.dvs[0] + hk * p.dvs[1] + (k0 + jr) * p.dvs[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c) dkr[tx + 8 * c] = dk_acc[c];
#pragma unroll
    for (int c = 0; c < kVCols; ++c) dvr[tx + 8 * c] = dv_acc[c];
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           float* __restrict__ dq, Params p) {
  constexpr int kCols = D / 8;
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + D * kPadT;
  float* qs_ = vt + DV * kPadT;
  float* dos_ = qs_ + kTile * (D + 1);
  float* dss = dos_ + kTile * (DV + 1);
  float* lse_ = dss + kTile * kPadT;
  float* delta_ = lse_ + kTile;

  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const int64_t hk = h / (p.hq / p.hkv);
  const int64_t i0 = (int64_t)blockIdx.x * kTile;
  const int64_t rows = min64(kTile, p.sq - i0);
  load_rows<D, DV>(q, dout, lse, delta, p, b, h, i0, qs_, dos_, lse_,
                   delta_);

  // the keys that any of these rows can see
  int64_t k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min64(p.skv, i0 + rows + p.off);
  if (p.has_window) k_begin = max64(0, i0 + p.off - p.window + 1);

  const int ir = threadIdx.x / 8, tx = threadIdx.x % 8;
  float dq_acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dq_acc[c] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_keys<D, DV>(k, v, p, b, hk, k0, kt, vt);
    __syncthreads();
    tile_p_ds<D, DV>(p, i0, k0, qs_, dos_, kt, vt, lse_, delta_, nullptr,
                     dss);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[ir * kPadT + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dq_acc[c] = fmaf(ds, kt[(tx + 8 * c) * kPadT + j], dq_acc[c]);
    }
  }
  if (ir < rows) {
    float* dqr = dq + b * p.dqs[0] + h * p.dqs[1] + (i0 + ir) * p.dqs[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c) dqr[tx + 8 * c] = dq_acc[c];
  }
}

template <int D, int DV>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* lse, const float* dout, float* dq, float* dk,
           float* dv, float* delta, const Params& p, cudaStream_t stream) {
  // a pass with nothing to do is not launched (a grid of 0 is refused)
  const int64_t rows = p.batch * p.hq * p.sq;
  if (rows > 0) {
    bwd_delta<DV><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                   kThreads, 0, stream>>>(o, dout, delta, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (p.skv > 0) {
    constexpr size_t bytes = dkdv_smem<D, DV>();
    cudaFuncSetAttribute(bwd_dkdv<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    const dim3 grid((unsigned)((p.skv + kTile - 1) / kTile),
                    (unsigned)(p.batch * p.hkv));
    bwd_dkdv<D, DV><<<grid, kThreads, bytes, stream>>>(
        q, k, v, dout, lse, delta, dk, dv, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (rows > 0) {
    constexpr size_t bytes = dq_smem<D, DV>();
    cudaFuncSetAttribute(bwd_dq<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    const dim3 grid((unsigned)((p.sq + kTile - 1) / kTile),
                    (unsigned)(p.batch * p.hq));
    bwd_dq<D, DV><<<grid, kThreads, bytes, stream>>>(q, k, v, dout, lse,
                                                     delta, dq, p);
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

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim (of q and k), then the (batch,
// head, seq) element strides of q, k, v, o, do, dq, dk and dv, then v's
// head_dim; every tensor f32 (lse and delta [batch, hq, sq], contiguous;
// delta is scratch).
extern "C" int FA_ENTRY(const float* q, const float* k,
                                   const float* v, const float* o,
                                   const float* lse, const float* dout,
                                   float* dq, float* dk, float* dv,
                                   float* delta, const long long* dims,
                                   int causal, int has_window,
                                   long long window, int has_softcap,
                                   float softcap, float scale,
                                   long long q_offset, void* stream) {
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
  if (p.batch * p.hq <= 0) return 0;
  return dispatch(head_dim, v_dim, q, k, v, o, lse, dout, dq, dk, dv, delta,
                  p, (cudaStream_t)stream);
}
