// Flash attention backward for Hopper (sm_90a): dq, dk and dv from
// (q, k, v, o, lse, dO), in f32 or bf16 with f32 accumulation.
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
// memory, each thread 4 outputs of a 32 x 32 product at a time), far below
// the tensor cores' rate.  wgmma and TMA are a later redesign's.
//
// Shared memory, in f32 whatever the input type: K and V transposed
// ([D][33]: consecutive keys in consecutive banks), Q and dO by rows with a
// stride of D + 1, P and dS [32][33]: 142,080 bytes at D = 256, so the
// launch opts in to dynamic shared memory.
//
// Plain-C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() that is not 0, or -1 for a head_dim or type it was not
// built for.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

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

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <int D>
constexpr size_t dkdv_smem() {
  // K^T, V^T [D][kPadT]; Q, dO [kTile][D + 1]; P, dS [kTile][kPadT];
  // lse, delta [kTile]
  return sizeof(float) * (size_t(2) * D * kPadT + size_t(2) * kTile * (D + 1) +
                          size_t(2) * kTile * kPadT + 2 * kTile);
}

template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (size_t(2) * D * kPadT + size_t(2) * kTile * (D + 1) +
                          size_t(kTile) * kPadT + 2 * kTile);
}

__device__ __forceinline__ bool visible(const Params& p, int64_t qpos,
                                        int64_t kpos) {
  bool ok = true;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.has_window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// delta[b, h, i] = sum_d dO[b, h, i, d] * o[b, h, i, d], a warp a row.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dout,
              float* __restrict__ delta, Params p) {
  const int64_t row = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= p.batch * p.hq * p.sq) return;
  const int64_t i = row % p.sq, bh = row / p.sq;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const T* orow = o + b * p.os[0] + h * p.os[1] + i * p.os[2];
  const T* drow = dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += ld(drow + d) * ld(orow + d);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  if (lane == 0) delta[row] = sum;
}

// One query tile's rows into shared memory (Q and dO by rows, stride D + 1;
// rows past Sq are zero, their lse +BIG and delta 0).
template <typename T, int D>
__device__ __forceinline__ void load_rows(
    const T* __restrict__ q, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const Params& p, int64_t b, int64_t h, int64_t i0, float* qs_, float* dos_,
    float* lse_, float* delta_) {
  const T* qb = q + b * p.qs[0] + h * p.qs[1];
  const T* db = dout + b * p.dos[0] + h * p.dos[1];
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, d = e % D;
    const bool in = i0 + r < p.sq;
    qs_[r * (D + 1) + d] = in ? ld(qb + (i0 + r) * p.qs[2] + d) : 0.f;
    dos_[r * (D + 1) + d] = in ? ld(db + (i0 + r) * p.dos[2] + d) : 0.f;
  }
  if (threadIdx.x < kTile) {
    const int r = threadIdx.x;
    const bool in = i0 + r < p.sq;
    const int64_t at = (b * p.hq + h) * p.sq + i0 + r;
    lse_[r] = in ? lse[at] : -kNeg;
    delta_[r] = in ? delta[at] : 0.f;
  }
}

// One kv tile's keys into shared memory, transposed ([D][kPadT]; keys past
// Skv are zero).
template <typename T, int D>
__device__ __forceinline__ void load_keys(const T* __restrict__ k,
                                          const T* __restrict__ v,
                                          const Params& p, int64_t b,
                                          int64_t hk, int64_t k0, float* kt,
                                          float* vt) {
  const T* kb = k + b * p.ks[0] + hk * p.ks[1];
  const T* vb = v + b * p.vs[0] + hk * p.vs[1];
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int c = e / D, d = e % D;
    const bool in = k0 + c < p.skv;
    kt[d * kPadT + c] = in ? ld(kb + (k0 + c) * p.ks[2] + d) : 0.f;
    vt[d * kPadT + c] = in ? ld(vb + (k0 + c) * p.vs[2] + d) : 0.f;
  }
}

// p and ds of a 32 x 32 tile: thread (r = tid / 8, c = tid % 8) computes
// row r, columns c + 8 j (j < 4), and writes them to P (if not null) and dS.
template <int D>
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
    const float da = dos_[r * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = fmaf(qa, kt[d * kPadT + c + 8 * j], s[j]);
      dp[j] = fmaf(da, vt[d * kPadT + c + 8 * j], dp[j]);
    }
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, Params p) {
  constexpr int kCols = D / 8;  // dk and dv columns a thread
  extern __shared__ float smem[];
  float* kt = smem;                      // [D][kPadT]
  float* vt = kt + D * kPadT;            // [D][kPadT]
  float* qs_ = vt + D * kPadT;           // [kTile][D + 1]
  float* dos_ = qs_ + kTile * (D + 1);   // [kTile][D + 1]
  float* pp = dos_ + kTile * (D + 1);    // [kTile][kPadT]
  float* dss = pp + kTile * kPadT;       // [kTile][kPadT]
  float* lse_ = dss + kTile * kPadT;     // [kTile]
  float* delta_ = lse_ + kTile;          // [kTile]

  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hkv, hk = bh % p.hkv;
  const int64_t g = p.hq / p.hkv;
  const int64_t k0 = (int64_t)blockIdx.x * kTile;
  const int64_t keys = min64(kTile, p.skv - k0);
  load_keys<T, D>(k, v, p, b, hk, k0, kt, vt);

  // the query rows that any of these keys can see
  int64_t i_begin = 0, i_end = p.sq;
  if (p.causal) i_begin = max64(0, k0 - p.off);
  if (p.has_window) i_end = min64(p.sq, k0 + keys - 1 + p.window - p.off);

  const int jr = threadIdx.x / 8, tx = threadIdx.x % 8;
  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t h = hk * g + gi;
    for (int64_t i0 = i_begin; i0 < i_end; i0 += kTile) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D>(q, dout, lse, delta, p, b, h, i0, qs_, dos_, lse_,
                      delta_);
      __syncthreads();
      tile_p_ds<D>(p, i0, k0, qs_, dos_, kt, vt, lse_, delta_, pp, dss);
      __syncthreads();
      for (int r = 0; r < kTile; ++r) {
        const float pr = pp[r * kPadT + jr];
        const float ds = dss[r * kPadT + jr];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[c] = fmaf(pr, dos_[r * (D + 1) + tx + 8 * c], dv_acc[c]);
          dk_acc[c] = fmaf(ds, qs_[r * (D + 1) + tx + 8 * c], dk_acc[c]);
        }
      }
    }
  }
  if (jr < keys) {
    T* dkr = dk + b * p.dks[0] + hk * p.dks[1] + (k0 + jr) * p.dks[2];
    T* dvr = dv + b * p.dvs[0] + hk * p.dvs[1] + (k0 + jr) * p.dvs[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      st(dkr + tx + 8 * c, dk_acc[c]);
      st(dvr + tx + 8 * c, dv_acc[c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, Params p) {
  constexpr int kCols = D / 8;
  extern __shared__ float smem[];
  float* kt = smem;
  float* vt = kt + D * kPadT;
  float* qs_ = vt + D * kPadT;
  float* dos_ = qs_ + kTile * (D + 1);
  float* dss = dos_ + kTile * (D + 1);
  float* lse_ = dss + kTile * kPadT;
  float* delta_ = lse_ + kTile;

  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const int64_t hk = h / (p.hq / p.hkv);
  const int64_t i0 = (int64_t)blockIdx.x * kTile;
  const int64_t rows = min64(kTile, p.sq - i0);
  load_rows<T, D>(q, dout, lse, delta, p, b, h, i0, qs_, dos_, lse_, delta_);

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
    load_keys<T, D>(k, v, p, b, hk, k0, kt, vt);
    __syncthreads();
    tile_p_ds<D>(p, i0, k0, qs_, dos_, kt, vt, lse_, delta_, nullptr, dss);
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
      const float ds = dss[ir * kPadT + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        dq_acc[c] = fmaf(ds, kt[(tx + 8 * c) * kPadT + j], dq_acc[c]);
    }
  }
  if (ir < rows) {
    T* dqr = dq + b * p.dqs[0] + h * p.dqs[1] + (i0 + ir) * p.dqs[2];
#pragma unroll
    for (int c = 0; c < kCols; ++c) st(dqr + tx + 8 * c, dq_acc[c]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const float* lse, const void* dout, void* dq, void* dk, void* dv,
           float* delta, const Params& p, cudaStream_t stream) {
  // a pass with nothing to do is not launched (a grid of 0 is refused)
  const int64_t rows = p.batch * p.hq * p.sq;
  if (rows > 0) {
    bwd_delta<T, D><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                      kThreads, 0, stream>>>((const T*)o, (const T*)dout,
                                             delta, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (p.skv > 0) {
    constexpr size_t bytes = dkdv_smem<D>();
    cudaFuncSetAttribute(bwd_dkdv<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    const dim3 grid((unsigned)((p.skv + kTile - 1) / kTile),
                    (unsigned)(p.batch * p.hkv));
    bwd_dkdv<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dk, (T*)dv, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  if (rows > 0) {
    constexpr size_t bytes = dq_smem<D>();
    cudaFuncSetAttribute(bwd_dq<T, D>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    const dim3 grid((unsigned)((p.sq + kTile - 1) / kTile),
                    (unsigned)(p.batch * p.hq));
    bwd_dq<T, D><<<grid, kThreads, bytes, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta,
        (T*)dq, p);
    return (int)cudaGetLastError();
  }
  return 0;
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const void* o, const float* lse, const void* dout, void* dq,
             void* dk, void* dv, float* delta, const Params& p,
             cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<T, 16>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
    case 32: return launch<T, 32>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
    case 64: return launch<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
    case 128: return launch<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
    case 256: return launch<T, 256>(q, k, v, o, lse, dout, dq, dk, dv, delta, p, s);
    default: return -1;
  }
}

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim, then the (batch, head, seq)
// element strides of q, k, v, o, do, dq, dk and dv.  dtype: 0 f32, 1 bf16
// (every tensor but lse and delta, which are f32 [batch, hq, sq],
// contiguous; delta is scratch).
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* lse, const void* dout,
                                   void* dq, void* dk, void* dv, void* delta,
                                   const long long* dims, int dtype,
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
  const int head_dim = (int)dims[5];
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
  cudaStream_t s = (cudaStream_t)stream;
  const float* l = (const float*)lse;
  float* dl = (float*)delta;
  if (dtype == 0)
    return dispatch<float>(head_dim, q, k, v, o, l, dout, dq, dk, dv, dl, p, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(head_dim, q, k, v, o, l, dout, dq, dk, dv,
                                   dl, p, s);
  return -1;
}
