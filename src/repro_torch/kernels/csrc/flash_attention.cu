// Flash attention forward (block-wise online softmax) in f32 for Hopper
// (sm_90a).
//
// Replaces, for f32 inputs, the Pallas TPU kernel `_kernel` of
// src/repro/kernels/flash_attention.py (reached through `flash_attention`);
// bf16 inputs take flash_attention_sm90.cu (wgmma, TMA).  It computes the
// same function in the same forward order: s = (q.k) * scale; s = softcap * tanh(s / softcap) when a softcap
// is set; then the mask (right-aligned queries, qpos = row + Skv - Sq;
// causal qpos >= kpos; window qpos - kpos < window; keys past Skv); masked
// logits take the finite NEG = -0.7 * FLT_MAX and their p is zeroed; the
// running (m, l, acc) update of each kv tile; and at the end l == 0 -> 1, so
// a row with no key left writes 0.  GQA: q head h reads kv head h /
// (Hq / Hkv).  Query row i sits at position i + q_offset (the serve passes
// Skv - Sq: right-aligned).  For training it also writes, when its pointer
// is not null, each row's log-sum-exp m + log(l) (f32 [B, Hq, Sq]; +BIG =
// -NEG for a row with no key, as repro.models.flash_xla._fwd_impl has it),
// which the backward (flash_attention_bwd.cu) reads.
//
// Structure: one block of 256 threads per (query tile, batch * q head); a
// loop inside the block over the kv tiles takes the place of the TPU's
// sequential kv grid axis.  Tiles that the causal or window mask empties
// entirely are skipped: such a tile leaves (m, l, acc) as they were in the
// reference too.  Rows past Sq and keys past Skv are masked here, so any
// Sq <= Skv is taken (the Pallas wrapper asserts Sq % bq == 0).  Thread
// (ty, tx), ty < 32 and tx < 8, owns query rows 2ty and 2ty + 1, logit
// columns tx + 8j and output columns tx + 8j; the 8 threads of a row sit in
// one warp, so the row max and sum are three shuffles.
//
// What bounds it: operations.  At gemma2's head_dim 256 the tile work is
// 4 * D flops a (query, key) pair against 8 * D bytes a key row.  This
// kernel does them on the CUDA cores in full f32 (the f32 tolerance of 2e-5
// rules out TF32 and a bf16 P).  Tiles sit in shared memory: q and k
// transposed with a row stride of 65 floats (conflict-free transposing
// stores and reads), v row-major; at D = 256 that is 215,296 B, above the 48 KB of
// static shared memory, so the launch opts in to dynamic shared memory.
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

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_mla.cu includes this file with its
// own pairs, so each set compiles in a translation unit of its own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_fwd
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileQ = 64;   // query rows a block (2 a thread row)
constexpr int kTileK = 64;   // keys a kv tile (8 a thread)
constexpr int kPad = kTileQ + 1;  // row stride of the transposed tiles
constexpr float kNeg = -0.7f * FLT_MAX;

struct Params {
  int64_t batch, hq, hkv, sq, skv;
  // element strides of (batch, head, seq) for q, k, v, o; head_dim is
  // contiguous
  int64_t qs[3], ks[3], vs[3], os[3];
  int causal, has_window, has_softcap;
  int64_t window;
  float softcap, scale;
  int bq, bk;  // tile sizes in use, bq <= kTileQ and bk <= kTileK
  int64_t off;  // position of query row 0
  float* lse;   // [batch, hq, sq] or null
};

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

template <int D, int DV>
constexpr size_t smem_bytes() {
  // q^T [D][kPad], k^T [D][kPad], v [kTileK][DV], p [kTileQ][kPad]
  return sizeof(float) *
         (size_t(2) * D * kPad + size_t(kTileK) * DV + size_t(kTileQ) * kPad);
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads)
    flash_fwd(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, Params p) {
  constexpr int kCols = DV / 8;  // output columns a thread
  extern __shared__ float smem[];
  float* qt = smem;                // [D][kPad]
  float* kt = qt + D * kPad;       // [D][kPad]
  float* vv = kt + D * kPad;       // [kTileK][DV]
  float* pp = vv + kTileK * DV;    // [kTileQ][kPad]

  const int tid = threadIdx.x;
  const int tx = tid & 7, ty = tid >> 3;
  const int64_t bh = blockIdx.y;
  const int64_t b = bh / p.hq, h = bh % p.hq;
  const int64_t hk = h / (p.hq / p.hkv);
  const int64_t q0 = (int64_t)blockIdx.x * p.bq;
  const int64_t off = p.off;
  const float* qb = q + b * p.qs[0] + h * p.qs[1];
  const float* kb = k + b * p.ks[0] + hk * p.ks[1];
  const float* vb = v + b * p.vs[0] + hk * p.vs[1];
  float* ob = o + b * p.os[0] + h * p.os[1];
  const int64_t rows = min64(p.bq, p.sq - q0);

  // the query tile, transposed; rows past the tile or Sq are zero
  for (int e = tid; e < kTileQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qt[d * kPad + r] = r < rows ? qb[(q0 + r) * p.qs[2] + d] : 0.f;
  }

  // kv range that any row of this tile can see
  int64_t k_begin = 0, k_end = p.skv;
  if (p.causal) k_end = min64(p.skv, q0 + rows + off);
  if (p.has_window) k_begin = max64(0, q0 + off - p.window + 1);
  k_begin = k_begin / p.bk * p.bk;

  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
  float acc[2][kCols];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  for (int64_t k0 = k_begin; k0 < k_end; k0 += p.bk) {
    const int64_t keys = min64(p.bk, p.skv - k0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < kTileK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      kt[d * kPad + c] = c < keys ? kb[(k0 + c) * p.ks[2] + d] : 0.f;
    }
    for (int e = tid; e < kTileK * DV; e += kThreads) {
      const int c = e / DV, d = e % DV;
      vv[c * DV + d] = c < keys ? vb[(k0 + c) * p.vs[2] + d] : 0.f;
    }
    __syncthreads();

    float s[2][8];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qa = qt[d * kPad + 2 * ty];
      const float qc = qt[d * kPad + 2 * ty + 1];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float kv = kt[d * kPad + tx + 8 * j];
        s[0][j] = fmaf(qa, kv, s[0][j]);
        s[1][j] = fmaf(qc, kv, s[1][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 2 * ty + i;
      const int64_t qpos = q0 + r + off;
      bool ok[8];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 8 * j;
        const int64_t kpos = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.has_softcap) x = p.softcap * tanhf(x / p.softcap);
        bool keep = c < keys;
        if (p.causal) keep = keep && qpos >= kpos;
        if (p.has_window) keep = keep && (qpos - kpos) < p.window;
        ok[j] = keep;
        s[i][j] = keep ? x : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_cur = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_cur);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float e = ok[j] ? expf(s[i][j] - m_cur) : 0.f;
        pp[r * kPad + tx + 8 * j] = e;
        sum += e;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = alpha * l[i] + sum;
      m[i] = m_cur;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();  // a row's p is written and read by one warp

    for (int c = 0; c < keys; ++c) {
      const float pa = pp[(2 * ty) * kPad + c];
      const float pc = pp[(2 * ty + 1) * kPad + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float x = vv[c * DV + tx + 8 * j];
        acc[0][j] = fmaf(pa, x, acc[0][j]);
        acc[1][j] = fmaf(pc, x, acc[1][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 2 * ty + i;
    if (r >= rows) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];
    if (p.lse != nullptr && tx == 0)
      p.lse[bh * p.sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : -kNeg;
    float* orow = ob + (q0 + r) * p.os[2];
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 8 * j] = acc[i][j] / inv;
  }
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o,
           const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D, DV>();
  cudaFuncSetAttribute(flash_fwd<D, DV>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  const dim3 grid((unsigned)((p.sq + p.bq - 1) / p.bq),
                  (unsigned)(p.batch * p.hq));
  flash_fwd<D, DV><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, p);
  return (int)cudaGetLastError();
}

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim (of q and k), then the (batch,
// head, seq) element strides of q, k, v and o, all f32, then v's head_dim;
// lse: f32 [batch, hq, sq], contiguous, or null.
extern "C" int FA_ENTRY(const void* q, const void* k,
                                   const void* v, void* o,
                                   const long long* dims, int causal,
                                   int has_window, long long window,
                                   int has_softcap, float softcap,
                                   float scale, int block_q, int block_k,
                                   long long q_offset, void* lse,
                                   void* stream) {
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
  p.bq = block_q < kTileQ ? block_q : kTileQ;
  p.bk = block_k < kTileK ? block_k : kTileK;
  p.off = q_offset;
  p.lse = (float*)lse;
  if (p.sq <= 0 || p.batch * p.hq <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(D, DV) \
  if (head_dim == D && v_dim == DV) return launch<D, DV>(q, k, v, o, p, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}
