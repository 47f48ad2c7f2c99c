// Flash attention backward in bf16 for Hopper (sm_90a): dq, dk and dv from
// (q, k, v, o, lse, dO) on the tensor cores through wgmma, tiles through
// TMA, one producer warpgroup and two consumer warpgroups a block.
//
// No Pallas kernel stands behind it: the JAX package differentiates its
// XLA attention (src/repro/models/flash_xla.py, `_bwd_rule`, the custom VJP
// of `flash_attention_xla`), and this kernel computes that rule, as
// flash_attention_bwd.cu does for f32 inputs.  For each (query, key) pair
// the query may see: s = (q.k) * scale; under a softcap t = tanh(s /
// softcap), s = softcap * t; p = exp(s - lse); dv += p dO; dp = dO.v; ds =
// p (dp - delta) (1 - t^2) scale with delta = rowsum(dO * o); dq += ds k and
// dk += ds q.  The mask is the forward's: query row i at position i +
// q_offset, causal qpos >= kpos, window qpos - kpos < window, keys past
// Skv.  GQA: q head h reads kv head h / (Hq / Hkv), and dk and dv sum over
// the q heads of a kv head.  Every sum is in f32; p and ds are rounded to
// bf16 as wgmma operands, and the outputs to bf16.
//
// What bounds it: operations.  A visible pair costs 10 * D flops in the
// rule's five products against bytes read once a tile, far above the
// card's ~295 flops a byte, so every product runs on the tensor cores.
// Three launches a call, one stream, no atomics (so two calls on the same
// inputs give the same bits):
//
// - delta: one warp a query row: delta = rowsum(dO * o), and lse in log2
//   units, into a scratch of [2][B * Hq][Sq_pad] f32 (Sq_pad = Sq rounded
//   up to 128).  Rows with no key (lse = +BIG) and rows past Sq get lse2 =
//   +inf, so that their p = exp2(x - inf) = 0 exactly: the kernel does not
//   rely on BIG * log2 e overflowing.
// - dk/dv: one block per (64 keys, batch * kv head).  The producer loads
//   the K and V tiles once, then Q and dO tiles of 64 query rows with
//   their rows of the scratch into a ring of 2 stages, for each q head of
//   the group and each query tile the keys see.  Each consumer warpgroup
//   takes 32 of a tile's 64 queries: S^T = K.Q^T and dP^T = V.dO^T (wgmma
//   m64n32k16, A and B K-major in shared memory), P^T and dS^T in f32
//   registers, rounded to bf16 into shared memory as [64 keys][64 queries]
//   (128-byte swizzle, double-buffered so one named barrier a tile
//   suffices).  Then warpgroup 0 owns dV += P^T.dO and warpgroup 1 owns
//   dK += dS^T.Q, each m64n{D}k16 with A from shared memory and B read
//   MN-major through the transpose bit: the same registers as splitting
//   D in halves, and no n-range that starts inside a swizzle atom.  dK
//   and dV sit in registers across the group's q heads and are stored
//   once.
// - dq: one block per (128 query rows, batch * q head), the forward with
//   two more products.  Q and dO stay resident; K and V arrive in a ring
//   of 2 stages of 32 keys.  Each consumer warpgroup takes 64 rows: S =
//   Q.K^T and dP = dO.V^T (m64n32k16), dS in registers, whose accumulator
//   layout is already the A-fragment layout of dQ += dS.K (m64n{D}k16, A
//   from registers, K read MN-major through the transpose bit).
// So s and dp are computed twice (7 products where 5 would do): the price
// of a dq without atomics.
//
// Each block reads what it does from the Python plan's block table
// (`bwd_launch_plan`, `BwdPlan.blocks`): one int4 (head, start, first,
// tiles) a block, the dk/dv kernel's blocks and then the dq kernel's.  A
// dk/dv block takes the 64 keys at ``start`` of kv head ``head`` (b * Hkv
// + h) and visits ``tiles`` query tiles of 64 rows from row ``first``; a
// dq block takes the 128 rows at ``start`` of q head ``head`` and visits
// ``tiles`` kv tiles of 32 keys from key ``first``.  The table orders the
// blocks heaviest first.
//
// Tiles sit in shared memory as TMA writes them (`Cols`: rows of at most 64
// bf16 with the matching swizzle; a D = 256 tile is four column chunks, a
// D = 96 one three 32-wide chunks, and D = 24 is padded to 32 columns that
// TMA zero-fills), rows past Sq or Skv zero-filled; the mask is built only
// on edge tiles.
//
// q, k (and so dq, dk) have head_dim D; v, o, dO (and dv) head_dim DV (MLA:
// 96 / 64).  S^T, S and dq, dk run over D; dP^T, dP, delta and dv over DV.
// In the dk/dv pass the two warpgroups' products then differ in width
// (dV m64n{DV}, dK m64n{D}), so each warpgroup runs a consumer of its own
// width.  Shared memory a block (dk/dv pass, dq pass): 226.0 and 193.0 KB
// at (256, 256), 154.0 and 121.0 KB at (192, 128), 94.0 and 61.0 KB at
// (96, 64), 52.0 and 19.0 KB at (24, 16), 130.0 and 97.0 KB at (112, 112),
// with the same tiles and ring depth at every pair.  At D = 192 a row is
// three 64-wide chunks of the 128-byte swizzle, and dK and dQ are
// m64n192k16.  Zamba2's D = 112 is padded to 128 columns that TMA
// zero-fills (`Cols`: two 64-wide chunks, not seven 16-wide ones), so its
// products are those of D = 128 and the epilogues store 112 columns.
// Registers: setmaxnreg gives the consumers 240 and the producer 24; no
// trap lies on the consumers' path (a trap made ptxas ignore setmaxnreg in
// the forward).
//
// Plain-C entry point, loaded with ctypes; it returns the first
// cudaGetLastError() that is not 0, -1 for a (D, DV) pair it was not built
// for and -2 when a tensor map is refused.

#include <float.h>

#include "sm90_common.cuh"

// The (q/k head_dim, v head_dim) pairs this library is built for and its
// entry point's name.  flash_attention_bwd_sm90_mla.cu includes this file
// with its own pairs, so each set compiles in a translation unit of its
// own.
#ifndef FA_PAIRS
#define FA_PAIRS(X) \
  X(16, 16) X(32, 32) X(64, 64) X(112, 112) X(128, 128) X(256, 256)
#define FA_ENTRY flash_attention_bwd_sm90
#endif

namespace {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;
constexpr int kRowTile = 64;   // query rows a TMA box (dk/dv tile; dq: 2)
constexpr int kPadRows = 128;  // the scratch's rows are padded to this

struct Params {
  int batch, hq, hkv, sq, skv, group, sq_pad;
  int64_t os[3], dos[3], dqs[3], dks[3], dvs[3];  // (batch, head, seq)
  int causal, has_window, has_softcap;
  int window, off;
  // the launch plan: blocks[dkdv_blocks + dq_blocks]
  const int4* blocks;
  int dkdv_blocks, dq_blocks;
  float scale, scale_log2, cap_in, cap_out;
  const float* lse;
  float* lse2;   // [B * Hq][sq_pad]
  float* delta;  // [B * Hq][sq_pad]
};

// Tile geometry of one TMA box of ``Rows`` rows by D columns.
template <int D, int Rows>
struct Tile : Cols<D> {
  static constexpr uint32_t kChunk = Rows * Cols<D>::kRow;
  static constexpr uint32_t kBytes = kChunk * Cols<D>::kChunks;
};

__device__ __forceinline__ bool visible(const Params& p, int qpos,
                                        int kpos) {
  bool ok = kpos < p.skv;
  if (p.causal) ok = ok && qpos >= kpos;
  if (p.has_window) ok = ok && qpos - kpos < p.window;
  return ok;
}

// delta and lse2 of one row a warp, padded rows included.
__global__ void __launch_bounds__(256)
    bwd_delta(const __nv_bfloat16* __restrict__ o,
              const __nv_bfloat16* __restrict__ dout, Params p, int d) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (int64_t)p.batch * p.hq * p.sq_pad) return;
  const int i = (int)(row % p.sq_pad);
  const int64_t bh = row / p.sq_pad;
  float sum = 0.f;
  if (i < p.sq) {
    const int64_t b = bh / p.hq, h = bh % p.hq;
    const __nv_bfloat16* orow = o + b * p.os[0] + h * p.os[1] + i * p.os[2];
    const __nv_bfloat16* drow =
        dout + b * p.dos[0] + h * p.dos[1] + i * p.dos[2];
    for (int c = lane; c < d; c += 32)
      sum += __bfloat162float(drow[c]) * __bfloat162float(orow[c]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
  }
  if (lane == 0) {
    const float lse = i < p.sq ? p.lse[bh * p.sq + i] : FLT_MAX;
    p.delta[row] = sum;
    p.lse2[row] = lse >= 0.5f * FLT_MAX ? __int_as_float(0x7f800000)
                                        : lse * kLog2e;
  }
}

// x in log2 units and 1 - t^2 (1 without a softcap) from a raw logit.
template <bool kCap>
__device__ __forceinline__ float logit(float s, const Params& p, float& dt) {
  if (kCap) {
    const float t = tanh_exp2(s * p.cap_in);
    dt = (1.f - t * t) * p.scale;
    return t * p.cap_out;
  }
  dt = p.scale;
  return s * p.scale_log2;
}

// ---------------------------------------------------------------- dk / dv

namespace dkdv {

constexpr int kKeys = 64;     // keys a block
constexpr int kHalf = 32;     // queries a consumer warpgroup takes of a tile
constexpr uint32_t kPBytes = kKeys * kRowTile * 2;  // one of P^T, dS^T

template <int D, int DV>
struct Plan {
  using TK = Tile<D, kRowTile>;   // K and Q tiles: 64 rows
  using TV = Tile<DV, kRowTile>;  // V and dO tiles
  static constexpr uint32_t kK = 0;
  static constexpr uint32_t kV = TK::kBytes;
  static constexpr uint32_t kQ = kV + TV::kBytes;  // + stage * TK::kBytes
  static constexpr uint32_t kDO = kQ + kStages * TK::kBytes;  // + stage * TV
  static constexpr uint32_t kP = kDO + kStages * TV::kBytes;  // + buf * 2P
  static constexpr uint32_t kRows = kP + 4 * kPBytes;  // + stage * 512
  static constexpr uint32_t kBar = kRows + kStages * 2 * kRowTile * 4;
  // kv, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr));
  return v;
}

// P^T / dS^T element (key r, query c) of a [64][64] bf16 tile with
// 128-byte rows and TMA's 128-byte swizzle (16-byte unit c/8 ^ r%8).
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
}

template <bool kCap>
__device__ __forceinline__ void p_ds(float (&s)[16], float (&dp)[16],
                                     const Params& p, uint32_t rows,
                                     uint32_t p_buf, int wg, bool mask,
                                     int kpos0, int qpos0) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int key = 16 * warp + lane / 4;        // and key + 8
  const int q = kHalf * wg + 2 * (lane % 4);   // + 8 j + c
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 l2 = lds_f2(rows + 4 * (q + 8 * j));
    const float2 dl = lds_f2(rows + 4 * kRowTile + 4 * (q + 8 * j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float pr[2], ds[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int i = 4 * j + 2 * h + c;
        float dt;
        const float x = logit<kCap>(s[i], p, dt);
        pr[c] = exp2f(x - (c ? l2.y : l2.x));
        if (mask && !visible(p, qpos0 + 8 * j + c, kpos0 + 8 * h))
          pr[c] = 0.f;
        ds[c] = pr[c] * (dp[i] - (c ? dl.y : dl.x)) * dt;
      }
      const uint32_t at = swz128(key + 8 * h, q + 8 * j);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p_buf + at),
                   "r"(pack_bf16(pr[0], pr[1])));
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(p_buf + kPBytes + at),
                   "r"(pack_bf16(ds[0], ds[1])));
    }
  }
}

// A consumer warpgroup whose product is COLS wide: dV (warpgroup 0, COLS =
// DV, B = dO) or dK (warpgroup 1, COLS = D, B = Q).
template <int D, int DV, int COLS>
__device__ __forceinline__ void consume(uint32_t base, const Params& p,
                                        __nv_bfloat16* __restrict__ dk,
                                        __nv_bfloat16* __restrict__ dv,
                                        int wg, int b, int hk, int k0,
                                        int i_start, int n_q) {
  using L = Plan<D, DV>;
  using TK = typename L::TK;
  using TV = typename L::TV;
  using TB = Tile<COLS, kRowTile>;  // B of this warpgroup's product
  constexpr int kAcc = TB::kPad / 2;
  constexpr int kSteps = (TK::kPad > TV::kPad ? TK::kPad : TV::kPad) / 16;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int col0 = 2 * (lane % 4);
  float acc[kAcc];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  mbar_wait(base + L::kBar, 0);
  __syncwarp();
  int t = 0;
  for (int gi = 0; gi < p.group; ++gi) {
    for (int it = 0; it < n_q; ++it, ++t) {
      const int stage = t % kStages;
      const int i0 = i_start + it * kRowTile;
      const uint32_t full = base + L::kBar + 8 * (1 + stage);
      const uint32_t empty = base + L::kBar + 8 * (1 + kStages + stage);
      const uint32_t q_smem = base + L::kQ + stage * TK::kBytes;
      const uint32_t do_smem = base + L::kDO + stage * TV::kBytes;
      const uint32_t p_buf = base + L::kP + (t & 1) * 2 * kPBytes;
      // what this warpgroup's 32 queries see of the 64 keys
      const int qmin = i0 + kHalf * wg + p.off, qmax = qmin + kHalf - 1;
      bool mask = k0 + kKeys > p.skv;
      if (p.causal) mask = mask || qmin < k0 + kKeys - 1;
      if (p.has_window) mask = mask || qmax - k0 >= p.window;
      mbar_wait(full, (t / kStages) & 1);
      __syncwarp();

      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      const uint64_t dk_ = fresh(smem_desc(base + L::kK, 1, TK::kSbo,
                                           TK::kLayout));
      const uint64_t dv_ = fresh(smem_desc(base + L::kV, 1, TV::kSbo,
                                           TV::kLayout));
      const uint64_t dq_ = fresh(smem_desc(q_smem + kHalf * wg * TK::kRow, 1,
                                           TK::kSbo, TK::kLayout));
      const uint64_t ddo = fresh(smem_desc(do_smem + kHalf * wg * TV::kRow,
                                           1, TV::kSbo, TV::kLayout));
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        // k-step kk: columns 16 kk of chunk (16 kk) / W, 32 bytes a step;
        // S^T over D's k-steps, dP^T over DV's
        if (kk < TK::kPad / 16) {
          const uint32_t c = (16 * kk) / TK::W, in = (16 * kk) % TK::W * 2;
          const uint32_t at = (c * TK::kChunk + in) >> 4;
          wgmma_ss32(s, dk_ + at, dq_ + at, kk > 0);
        }
        if (kk < TV::kPad / 16) {
          const uint32_t c = (16 * kk) / TV::W, in = (16 * kk) % TV::W * 2;
          const uint32_t at = (c * TV::kChunk + in) >> 4;
          wgmma_ss32(dp, dv_ + at, ddo + at, kk > 0);
        }
      }
      wg_commit();
      wg_wait_all();
      pin(s);
      pin(dp);

      const uint32_t rows = base + L::kRows + stage * 2 * kRowTile * 4;
      const int kpos0 = k0 + 16 * warp + lane / 4;
      const int qpos0 = qmin + col0;
      if (p.has_softcap)
        p_ds<true>(s, dp, p, rows, p_buf, wg, mask, kpos0, qpos0);
      else
        p_ds<false>(s, dp, p, rows, p_buf, wg, mask, kpos0, qpos0);
      fence_async_smem();
      named_sync<1, 128 * kConsumers>();

      // warpgroup 0: dV += P^T.dO; warpgroup 1: dK += dS^T.Q; 16 queries
      // a k-step, B's chunks kChunk apart
      const uint64_t da = fresh(smem_desc(p_buf + wg * kPBytes, 1, 64, 1));
      const uint64_t db = fresh(smem_desc(wg ? q_smem : do_smem,
                                          TB::kChunk / 16, TB::kSbo,
                                          TB::kLayout));
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kRowTile / 16; ++kk)
        wgmma_ss_tb<TB::kPad>(acc, da + 2 * kk,
                              db + ((16 * kk * TB::kRow) >> 4));
      wg_commit();
      wg_wait_all();
      pin(acc);
      mbar_arrive(empty);
    }
  }

  // (strides picked by value: a pointer into the parameters would move
  // them to local memory)
  __nv_bfloat16* out = wg ? dk : dv;
  const int64_t sb = wg ? p.dks[0] : p.dvs[0];
  const int64_t sh = wg ? p.dks[1] : p.dvs[1];
  const int64_t ss = wg ? p.dks[2] : p.dvs[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int key = k0 + 16 * warp + lane / 4 + 8 * hh;
    if (key >= p.skv) continue;
    __nv_bfloat16* row = out + b * sb + hk * sh + key * ss;
#pragma unroll
    for (int j = 0; j < COLS / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tdo,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
             const Params p) {
  using L = Plan<D, DV>;
  using TK = typename L::TK;
  using TV = typename L::TV;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;

  const int4 plan = p.blocks[blockIdx.x];
  const int b = plan.x / p.hkv, hk = plan.x % p.hkv;
  const int k0 = plan.y;
  const int2 qt = make_int2(plan.z, plan.w);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (1 + kStages + s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xFFFFFFFFu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar, TK::kBytes + TV::kBytes);
      for (int c = 0; c < TK::kChunks; ++c)
        tma_load(base + L::kK + c * TK::kChunk, &tk, bar, c * TK::W, k0, hk,
                 b);
      for (int c = 0; c < TV::kChunks; ++c)
        tma_load(base + L::kV + c * TV::kChunk, &tv, bar, c * TV::W, k0, hk,
                 b);
      int t = 0;
      for (int gi = 0; gi < p.group; ++gi) {
        const int h = hk * p.group + gi;
        const int64_t row0 = ((int64_t)b * p.hq + h) * p.sq_pad;
        for (int it = 0; it < qt.y; ++it, ++t) {
          const int stage = t % kStages;
          const int i0 = qt.x + it * kRowTile;
          const uint32_t full = bar + 8 * (1 + stage);
          mbar_wait(bar + 8 * (1 + kStages + stage), ((t / kStages) & 1) ^ 1);
          mbar_expect_tx(full, TK::kBytes + TV::kBytes + 2 * kRowTile * 4);
          const uint32_t q_smem = base + L::kQ + stage * TK::kBytes;
          const uint32_t do_smem = base + L::kDO + stage * TV::kBytes;
          for (int c = 0; c < TK::kChunks; ++c)
            tma_load(q_smem + c * TK::kChunk, &tq, full, c * TK::W, i0, h, b);
          for (int c = 0; c < TV::kChunks; ++c)
            tma_load(do_smem + c * TV::kChunk, &tdo, full, c * TV::W, i0, h,
                     b);
          const uint32_t rows = base + L::kRows + stage * 2 * kRowTile * 4;
          bulk_load(rows, p.lse2 + row0 + i0, kRowTile * 4, full);
          bulk_load(rows + kRowTile * 4, p.delta + row0 + i0, kRowTile * 4,
                    full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    if constexpr (D == DV)
      consume<D, DV, D>(base, p, dk, dv, wg, b, hk, k0, qt.x, qt.y);
    else if (wg)
      consume<D, DV, D>(base, p, dk, dv, wg, b, hk, k0, qt.x, qt.y);
    else
      consume<D, DV, DV>(base, p, dk, dv, wg, b, hk, k0, qt.x, qt.y);
  }
}

}  // namespace dkdv

// --------------------------------------------------------------------- dq

namespace dq {

constexpr int kRows = 128;   // query rows a block
constexpr int kRowsWG = 64;  // query rows a consumer warpgroup
constexpr int kKeys = 32;    // keys a kv tile

template <int D, int DV>
struct Plan {
  using Q = Tile<D, kRows>;   // Q: two TMA boxes of 64 rows a chunk
  using O = Tile<DV, kRows>;  // dO, the same
  using K = Tile<D, kKeys>;
  using V = Tile<DV, kKeys>;
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kDO = Q::kBytes;
  static constexpr uint32_t kK = kDO + O::kBytes;  // + stage * K::kBytes
  static constexpr uint32_t kV = kK + kStages * K::kBytes;  // + stage * V
  static constexpr uint32_t kBar = kV + kStages * V::kBytes;
  // q, full[kStages], empty[kStages]; + 1024 to align the base
  static constexpr uint32_t kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

template <bool kMask, bool kCap>
__device__ __forceinline__ void ds_frags(const float (&s)[16],
                                         const float (&dp)[16],
                                         uint32_t (&a)[2][4], const Params& p,
                                         const float (&l2)[2],
                                         const float (&dl)[2], int qpos0,
                                         int kpos0) {
  float ds[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int h = (i >> 1) & 1;
    float dt;
    const float x = logit<kCap>(s[i], p, dt);
    float pr = exp2f(x - l2[h]);
    if (kMask && !visible(p, qpos0 + 8 * h, kpos0 + 8 * (i >> 2) + (i & 1)))
      pr = 0.f;
    ds[i] = pr * (dp[i] - dl[h]) * dt;
  }
  // dS as the A fragments of two k-steps of 16 keys
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(ds[8 * kk + 2 * r], ds[8 * kk + 2 * r + 1]);
}

template <int D, int DV>
__device__ __forceinline__ void consume(uint32_t base, const Params& p,
                                        __nv_bfloat16* __restrict__ dq,
                                        int wg, int b, int h, int q0,
                                        int k_start, int n_k) {
  using L = Plan<D, DV>;
  using Q = typename L::Q;
  using O = typename L::O;
  using K = typename L::K;
  using V = typename L::V;
  constexpr int kAcc = K::kPad / 2;  // dQ: m64n{D} accumulator registers
  constexpr int kSteps = (Q::kPad > O::kPad ? Q::kPad : O::kPad) / 16;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int r_lo = q0 + kRowsWG * wg;
  const int r_hi = min(r_lo + kRowsWG, p.sq);
  const int row0 = r_lo + 16 * warp + lane / 4;  // and row0 + 8
  const int col0 = 2 * (lane % 4);
  const int64_t bh = (int64_t)b * p.hq + h;
  float l2[2], dl[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l2[hh] = p.lse2[bh * p.sq_pad + row0 + 8 * hh];
    dl[hh] = p.delta[bh * p.sq_pad + row0 + 8 * hh];
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  mbar_wait(base + L::kBar, 0);
  __syncwarp();
  for (int t = 0; t < n_k; ++t) {
    const int stage = t % kStages;
    const int k0 = k_start + t * kKeys;
    const int qmin = r_lo + p.off, qmax = r_hi - 1 + p.off;
    bool skip = r_lo >= r_hi;
    bool mask = k0 + kKeys > p.skv;
    if (p.causal) {
      skip = skip || k0 > qmax;
      mask = mask || k0 + kKeys - 1 > qmin;
    }
    if (p.has_window) {
      skip = skip || qmin - (k0 + kKeys - 1) >= p.window;
      mask = mask || qmax - k0 >= p.window;
    }
    const uint32_t full = base + L::kBar + 8 * (1 + stage);
    const uint32_t empty = base + L::kBar + 8 * (1 + kStages + stage);
    mbar_wait(full, (t / kStages) & 1);
    __syncwarp();
    if (!skip) {
      const uint32_t k_smem = base + L::kK + stage * K::kBytes;
      const uint32_t v_smem = base + L::kV + stage * V::kBytes;
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      const uint64_t dq_ = fresh(smem_desc(
          base + L::kQ + wg * kRowsWG * Q::kRow, 1, Q::kSbo, Q::kLayout));
      const uint64_t ddo = fresh(smem_desc(
          base + L::kDO + wg * kRowsWG * O::kRow, 1, O::kSbo, O::kLayout));
      const uint64_t dk_ = fresh(smem_desc(k_smem, 1, K::kSbo, K::kLayout));
      const uint64_t dv_ = fresh(smem_desc(v_smem, 1, V::kSbo, V::kLayout));
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        // S over D's k-steps, dP over DV's
        if (kk < Q::kPad / 16) {
          const uint32_t c = (16 * kk) / Q::W, in = (16 * kk) % Q::W * 2;
          wgmma_ss32(s, dq_ + ((c * Q::kChunk + in) >> 4),
                     dk_ + ((c * K::kChunk + in) >> 4), kk > 0);
        }
        if (kk < O::kPad / 16) {
          const uint32_t c = (16 * kk) / O::W, in = (16 * kk) % O::W * 2;
          wgmma_ss32(dp, ddo + ((c * O::kChunk + in) >> 4),
                     dv_ + ((c * V::kChunk + in) >> 4), kk > 0);
        }
      }
      wg_commit();
      wg_wait_all();
      pin(s);
      pin(dp);

      uint32_t a[2][4];
      const int qpos0 = row0 + p.off, kpos0 = k0 + col0;
      if (mask) {
        if (p.has_softcap)
          ds_frags<true, true>(s, dp, a, p, l2, dl, qpos0, kpos0);
        else
          ds_frags<true, false>(s, dp, a, p, l2, dl, qpos0, kpos0);
      } else {
        if (p.has_softcap)
          ds_frags<false, true>(s, dp, a, p, l2, dl, qpos0, kpos0);
        else
          ds_frags<false, false>(s, dp, a, p, l2, dl, qpos0, kpos0);
      }
      // dQ += dS.K: K rows 16 kk.. (keys) in every chunk, chunks kChunk
      // apart
      const uint64_t dkt =
          fresh(smem_desc(k_smem, K::kChunk / 16, K::kSbo, K::kLayout));
      pin(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        wgmma_pv<K::kPad>(acc, a[kk], dkt + ((16 * kk * K::kRow) >> 4));
      wg_commit();
      wg_wait_all();
      pin(acc);
    }
    mbar_arrive(empty);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row >= p.sq) continue;
    __nv_bfloat16* out = dq + b * p.dqs[0] + h * p.dqs[1] + row * p.dqs[2];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * hh], acc[4 * j + 2 * hh + 1]);
  }
}

template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           __nv_bfloat16* __restrict__ dq, const Params p) {
  using L = Plan<D, DV>;
  using Q = typename L::Q;
  using O = typename L::O;
  using K = typename L::K;
  using V = typename L::V;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar = base + L::kBar;

  const int4 plan = p.blocks[p.dkdv_blocks + blockIdx.x];
  const int b = plan.x / p.hq, h = plan.x % p.hq;
  const int hk = h / p.group;
  const int q0 = plan.y;
  const int2 kt = make_int2(plan.z, plan.w);

  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar + 8 * (1 + s), 1);
      mbar_init(bar + 8 * (1 + kStages + s), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xFFFFFFFFu, (int)threadIdx.x / 128, 0);
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 128 * kConsumers) {
      mbar_expect_tx(bar, Q::kBytes + O::kBytes);
      for (int half = 0; half < kRows / kRowTile; ++half) {
        const int i0 = q0 + half * kRowTile;
        for (int c = 0; c < Q::kChunks; ++c)
          tma_load(base + L::kQ + c * Q::kChunk + half * kRowTile * Q::kRow,
                   &tq, bar, c * Q::W, i0, h, b);
        for (int c = 0; c < O::kChunks; ++c)
          tma_load(base + L::kDO + c * O::kChunk + half * kRowTile * O::kRow,
                   &tdo, bar, c * O::W, i0, h, b);
      }
      for (int t = 0; t < kt.y; ++t) {
        const int stage = t % kStages;
        const uint32_t full = bar + 8 * (1 + stage);
        mbar_wait(bar + 8 * (1 + kStages + stage), ((t / kStages) & 1) ^ 1);
        mbar_expect_tx(full, K::kBytes + V::kBytes);
        const int k0 = kt.x + t * kKeys;
        const uint32_t k_smem = base + L::kK + stage * K::kBytes;
        const uint32_t v_smem = base + L::kV + stage * V::kBytes;
        for (int c = 0; c < K::kChunks; ++c)
          tma_load(k_smem + c * K::kChunk, &tk, full, c * K::W, k0, hk, b);
        for (int c = 0; c < V::kChunks; ++c)
          tma_load(v_smem + c * V::kChunk, &tv, full, c * V::W, k0, hk, b);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    consume<D, DV>(base, p, dq, wg, b, h, q0, kt.x, kt.y);
  }
}

}  // namespace dq

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq_, void* dk, void* dv,
           const long long* dims, const Params& p, cudaStream_t stream) {
  constexpr int kW = Cols<D>::W, kWV = Cols<DV>::W;  // box widths
  // q and dO in boxes of 64 rows (the dq pass loads two a chunk); with no
  // query row nothing reads them, and k's and v's maps stand in (a map of
  // an empty tensor is refused)
  const bool rows = p.sq > 0;
  CUtensorMap tq, tdo, tk64, tv64, tk32, tv32;
  if (!encode(&tq, rows ? q : k, D, rows ? p.sq : p.skv,
              rows ? p.hq : p.hkv, p.batch, dims + (rows ? 6 : 9), kW,
              kRowTile) ||
      !encode(&tdo, rows ? dout : v, DV, rows ? p.sq : p.skv,
              rows ? p.hq : p.hkv, p.batch, dims + (rows ? 18 : 12), kWV,
              kRowTile) ||
      !encode(&tk64, k, D, p.skv, p.hkv, p.batch, dims + 9, kW,
              dkdv::kKeys) ||
      !encode(&tv64, v, DV, p.skv, p.hkv, p.batch, dims + 12, kWV,
              dkdv::kKeys) ||
      !encode(&tk32, k, D, p.skv, p.hkv, p.batch, dims + 9, kW,
              dq::kKeys) ||
      !encode(&tv32, v, DV, p.skv, p.hkv, p.batch, dims + 12, kWV,
              dq::kKeys))
    return -2;
  const int64_t padded = (int64_t)p.batch * p.hq * p.sq_pad;
  if (padded > 0) {
    bwd_delta<<<(unsigned)((padded + 7) / 8), 256, 0, stream>>>(
        (const __nv_bfloat16*)o, (const __nv_bfloat16*)dout, p, DV);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int64_t kv_blocks = p.dkdv_blocks;
  if (kv_blocks > 0) {
    constexpr uint32_t bytes = dkdv::Plan<D, DV>::kBytes;
    cudaFuncSetAttribute(dkdv::bwd_dkdv<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    dkdv::bwd_dkdv<D, DV><<<(unsigned)kv_blocks, kThreads, bytes, stream>>>(
        tq, tdo, tk64, tv64, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv, p);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  const int64_t q_blocks = p.dq_blocks;
  if (q_blocks > 0) {
    constexpr uint32_t bytes = dq::Plan<D, DV>::kBytes;
    cudaFuncSetAttribute(dq::bwd_dq<D, DV>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)bytes);
    dq::bwd_dq<D, DV><<<(unsigned)q_blocks, kThreads, bytes, stream>>>(
        tq, tdo, tk32, tv32, (__nv_bfloat16*)dq_, p);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace

// dims: batch, hq, hkv, sq, skv, head_dim (of q and k), then the (batch,
// head, seq) element strides of q, k, v, o, do, dq, dk and dv, then v's
// head_dim.  q, k, v, do: bf16,
// 16-byte aligned, strides multiples of 8 elements (TMA's 16 bytes),
// head_dim contiguous; o, dq, dk, dv: bf16, head_dim contiguous.  lse: f32
// [batch, hq, sq], contiguous.  scratch: f32 [2][batch * hq][sq_pad].
// blocks: the plan's block table, int32 [dkdv_blocks + dq_blocks][4] on
// the card.  plan (`bwd_launch_plan`): dkdv_blocks, dq_blocks, sq_pad,
// window (clamped), q_offset.
extern "C" int FA_ENTRY(
    const void* q, const void* k, const void* v, const void* o,
    const void* lse, const void* dout, void* dq, void* dk, void* dv,
    void* scratch, const void* blocks, const long long* dims,
    const long long* plan, int causal,
    int has_window, int has_softcap, float softcap, float scale,
    void* stream) {
  Params p;
  p.batch = (int)dims[0];
  p.hq = (int)dims[1];
  p.hkv = (int)dims[2];
  p.sq = (int)dims[3];
  p.skv = (int)dims[4];
  const int head_dim = (int)dims[5], v_dim = (int)dims[30];
  if (p.batch * p.hq <= 0) return 0;
  p.group = p.hq / p.hkv;
  int64_t* strides[5] = {p.os, p.dos, p.dqs, p.dks, p.dvs};
  const int at[5] = {15, 18, 21, 24, 27};  // o, do, dq, dk, dv
  for (int t = 0; t < 5; ++t)
    for (int i = 0; i < 3; ++i) strides[t][i] = dims[at[t] + i];
  p.blocks = (const int4*)blocks;
  p.dkdv_blocks = (int)plan[0];
  p.dq_blocks = (int)plan[1];
  p.sq_pad = (int)plan[2];
  p.window = (int)plan[3];
  p.off = (int)plan[4];
  p.causal = causal;
  p.has_window = has_window;
  p.has_softcap = has_softcap;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  p.cap_in = has_softcap ? scale / softcap : 0.f;
  p.cap_out = has_softcap ? softcap * kLog2e : 0.f;
  p.lse = (const float*)lse;
  p.lse2 = (float*)scratch;
  p.delta = p.lse2 + (int64_t)p.batch * p.hq * p.sq_pad;
  if (p.sq_pad % kPadRows) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define FA_CASE(D, DV)              \
  if (head_dim == D && v_dim == DV) \
    return launch<D, DV>(q, k, v, o, dout, dq, dk, dv, dims, p, s);
  FA_PAIRS(FA_CASE)
#undef FA_CASE
  return -1;
}
