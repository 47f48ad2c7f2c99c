// Building blocks of the f32 attention kernels, flash_attention.cu (the
// forward) and flash_attention_bwd.cu (the backward): f32 products on the
// tensor cores by 3xTF32 on mma.sync, fragments from f32 tiles or from
// tiles held pre-split, and cp.async staging of row tiles into shared
// memory.  Everything is in an anonymous namespace and inlined, so each
// library gets its own copy.
//
// 3xTF32.  A TF32 value keeps f32's exponent and 10 of its 23 mantissa
// bits.  Each f32 operand x is split in registers into big = tf32(x) and
// small = tf32(x - big) (x - big is exact in f32), both rounded to nearest
// with ties away from zero, as cvt.rna.tf32.f32 rounds, but on the bits:
// add half a TF32 ulp (0x1000), then drop the 13 low bits.  big needs the
// mask, since x - big takes its exact value; small needs only the add,
// since mma.sync reads the top 19 bits of a .tf32 register.  That is four
// instructions an operand (ptxas lowers cvt.rna.tf32.f32 to four, with an
// infinity test, so its split took seven); the operands here are finite.
// Then
//   a b ~ a_small b_big + a_big b_small + a_big b_big,
// three TF32 products (each exact in the f32 accumulator), the small
// terms first, or in an accumulator of their own (`mma3_chains`), so that
// they are not lost against the big one.  What is
// dropped, a_small b_small, is below 2^-22 of |a b|: the product is as
// near f32's as one f32 rounding, where one TF32 product alone is ~2^-11
// off.
//
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32: a warp multiplies a
// 16 x 8 A by an 8 x 8 B into a 16 x 8 f32 C.  Lane (g, t) = (lane / 4,
// lane % 4) holds A at rows g and g + 8 and the reduction columns of
// "slot" t and t + 4, B at column g and the same two slots, and C at rows
// g and g + 8, columns 2t and 2t + 1.  Which reduction index a slot takes
// is free, as long as A and B agree, since the sum does not depend on its
// order:
// - plain: slots t, t + 4 are indices t, t + 4 (two 4-byte loads of a row);
// - paired: slots t, t + 4 are indices 2t, 2t + 1.  A C fragment is then
//   the A fragment of the next product over its columns, with no shuffle:
//   (c0, c2, c1, c3) are A's (row g slot t, row g + 8 slot t, row g slot
//   t + 4, row g + 8 slot t + 4).
// Shared-memory tiles are row-major f32.  Every 4-byte load below is free
// of bank conflicts when the tile's row stride is 4 mod 32 floats
// (`pad4`), every 8-byte (paired A) load and store when it is 8 mod 32
// (`pad8`).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the smallest row stride >= x that is 4 (8) mod 32 floats
__host__ __device__ constexpr int pad4(int x) { return x + (36 - x % 32) % 32; }
__host__ __device__ constexpr int pad8(int x) { return x + (40 - x % 32) % 32; }

struct FragA {
  uint32_t big[4], small[4];
};
struct FragB {
  uint32_t big[2], small[2];
};

__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float* c, const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// One k-step of a 3xTF32 product over C independent accumulator chains:
// the three products of a k-step depend on each other only through their
// accumulator, so where a warp has few output tiles, splitting them over
// chains keeps mma.sync's latency off the critical path.  C = 1: all into
// c; C = 2: the small terms into part[0], the big one into c; C = 4: the
// big term into c or part[0] and the small terms into part[1] or part[2]
// by the parity of the k-step kk.  The caller adds the parts into c at the
// end (`Parts::fold`).
template <int C>
__device__ __forceinline__ void mma3_chains(float* c, float (*part)[4],
                                            int kk, const FragA& a,
                                            const FragB& b) {
  if (C == 1) {
    mma3(c, a, b);
  } else if (C == 2) {
    mma_tf32(part[0], a.small, b.big);
    mma_tf32(part[0], a.big, b.small);
    mma_tf32(c, a.big, b.big);
  } else {
    float* big = kk & 1 ? part[0] : c;
    float* small = part[1 + (kk & 1)];
    mma_tf32(small, a.small, b.big);
    mma_tf32(small, a.big, b.small);
    mma_tf32(big, a.big, b.big);
  }
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A at rows m0.., reduction columns k0.. of a [m][k] tile (stride ld),
// plain slots
__device__ __forceinline__ void load_a_plain(FragA& a, const float* s,
                                             int ld, int m0, int k0) {
  const float* r = s + (m0 + lane_g()) * ld + k0 + lane_t();
  split(r[0], a.big[0], a.small[0]);
  split(r[8 * ld], a.big[1], a.small[1]);
  split(r[4], a.big[2], a.small[2]);
  split(r[8 * ld + 4], a.big[3], a.small[3]);
}

// A at rows m0.., reduction columns k0.. of a [m][k] tile, paired slots
// (8-byte loads: stride 8 mod 32)
__device__ __forceinline__ void load_a_paired(FragA& a, const float* s,
                                              int ld, int m0, int k0) {
  const float* r = s + (m0 + lane_g()) * ld + k0 + 2 * lane_t();
  const float2 x = *reinterpret_cast<const float2*>(r);
  const float2 y = *reinterpret_cast<const float2*>(r + 8 * ld);
  split(x.x, a.big[0], a.small[0]);
  split(y.x, a.big[1], a.small[1]);
  split(x.y, a.big[2], a.small[2]);
  split(y.y, a.big[3], a.small[3]);
}

// A from a C fragment in registers (paired slots over C's columns)
__device__ __forceinline__ void load_a_regs(FragA& a, const float* c) {
  split(c[0], a.big[0], a.small[0]);
  split(c[2], a.big[1], a.small[1]);
  split(c[1], a.big[2], a.small[2]);
  split(c[3], a.big[3], a.small[3]);
}

// B at output columns n0.., reduction k0.. of a tile stored [n][k] (B^T
// by rows: keys by head_dim), plain slots
__device__ __forceinline__ void load_b_nk(FragB& b, const float* s, int ld,
                                          int n0, int k0) {
  const float* r = s + (n0 + lane_g()) * ld + k0 + lane_t();
  split(r[0], b.big[0], b.small[0]);
  split(r[4], b.big[1], b.small[1]);
}

// B at reduction rows k0.., output columns n0.. of a tile stored [k][n],
// paired slots
__device__ __forceinline__ void load_b_kn(FragB& b, const float* s, int ld,
                                          int k0, int n0) {
  const float* r = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  split(r[0], b.big[0], b.small[0]);
  split(r[ld], b.big[1], b.small[1]);
}

// A pre-split tile holds each value as its (big, small) pair, a uint2:
// the values a block's warps all read are split once, by the block, where
// each warp would split them again.  The two B patterns on it: [n][k]
// (plain slots, row stride 4 mod 16 pairs, `pad4`) and [k][n] (paired
// slots, row stride 2 mod 8 pairs, `pad2`), conflict-free 8-byte loads.
__host__ __device__ constexpr int pad2(int x) { return x + (10 - x % 8) % 8; }

// four consecutive values into a pair tile, split (16-byte aligned)
__device__ __forceinline__ void store4(uint2* dst, float4 x) {
  uint4 a, b;
  split(x.x, a.x, a.y);
  split(x.y, a.z, a.w);
  split(x.z, b.x, b.y);
  split(x.w, b.z, b.w);
  reinterpret_cast<uint4*>(dst)[0] = a;
  reinterpret_cast<uint4*>(dst)[1] = b;
}

__device__ __forceinline__ void load_b_nk(FragB& b, const uint2* s, int ld,
                                          int n0, int k0) {
  const uint2* r = s + (n0 + lane_g()) * ld + k0 + lane_t();
  const uint2 x = r[0], y = r[4];
  b.big[0] = x.x;
  b.small[0] = x.y;
  b.big[1] = y.x;
  b.small[1] = y.y;
}

__device__ __forceinline__ void load_b_kn(FragB& b, const uint2* s, int ld,
                                          int k0, int n0) {
  const uint2* r = s + (k0 + 2 * lane_t()) * ld + n0 + lane_g();
  const uint2 x = r[0], y = r[ld];
  b.big[0] = x.x;
  b.small[0] = x.y;
  b.big[1] = y.x;
  b.small[1] = y.y;
}

// The C - 1 extra chains of each of J C fragments: zeroed, then added
// into the fragments
template <int C, int J>
struct Parts {
  static constexpr int kN = C > 1 ? C - 1 : 1;
  float v[J][kN][4];
  __device__ __forceinline__ Parts() {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < kN; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[j][i][e] = 0.f;
  }
  __device__ __forceinline__ void fold(float (*acc)[4]) {
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int i = 0; i < C - 1; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += v[j][i][e];
  }
};

// acc[j] += A[m0, m0 + 16) B^T over K for the n-tiles n = first + j <
// first + J (those < count unless kAll), A [m][K] and B [n][K] tiles:
// logits (q k^T) and dP (dO v^T) and their transposes, over C accumulator
// chains (B: f32, or pre-split pairs)
template <int K, int J, int C, bool kAll, class TB>
__device__ __forceinline__ void mma_nt(float (*acc)[4], const float* a_s,
                                       int lda, int m0, const TB* b_s,
                                       int ldb, int first, int count) {
  Parts<C, J> parts;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    FragA a;
    load_a_plain(a, a_s, lda, m0, 8 * kk);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (kAll || first + j < count) {
        FragB b;
        load_b_nk(b, b_s, ldb, 8 * (first + j), 8 * kk);
        mma3_chains<C>(acc[j], parts.v[j], kk, a, b);
      }
    }
  }
  if (C > 1) parts.fold(acc);
}

// acc[j] += A[m0, m0 + 16) B over K for the n-tiles n = first + j <
// first + J (those < count unless kAll), A [m][K] (stride 8 mod 32) and B
// [K][n] tiles: the gradient products over P and dS, over C chains
template <int K, int J, int C, bool kAll>
__device__ __forceinline__ void mma_nn(float (*acc)[4], const float* a_s,
                                       int lda, int m0, const float* b_s,
                                       int ldb, int first, int count) {
  Parts<C, J> parts;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    FragA a;
    load_a_paired(a, a_s, lda, m0, 8 * kk);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      if (kAll || first + j < count) {
        FragB b;
        load_b_kn(b, b_s, ldb, 8 * kk, 8 * (first + j));
        mma3_chains<C>(acc[j], parts.v[j], kk, a, b);
      }
    }
  }
  if (C > 1) parts.fold(acc);
}

// acc[j] += P B over the NK k-steps of P's C fragments in registers
// ([NK][4], paired slots) and the rows [8 k0, 8 (k0 + NK)) of a [K][n]
// tile B (f32, or pre-split pairs), for the output n-tiles j < J: O += P
// V, over C chains
template <int NK, int J, int C, class TB>
__device__ __forceinline__ void mma_rn(float (*acc)[4], float (*p)[4],
                                       const TB* b_s, int ldb, int k0) {
  Parts<C, J> parts;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    FragA a;
    load_a_regs(a, p[kk]);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      FragB b;
      load_b_kn(b, b_s, ldb, 8 * (k0 + kk), 8 * j);
      mma3_chains<C>(acc[j], parts.v[j], kk, a, b);
    }
  }
  if (C > 1) parts.fold(acc);
}

// chains for a warp's J independent output tiles: about four or
// more products in flight (four chains each cost four registers a tile,
// and spilled in dq at (64, 64))
__host__ __device__ constexpr int chains(int tiles) {
  return tiles >= 8 ? 1 : tiles >= 2 ? 2 : 4;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// rows [0, n) of a tile of W floats a row into shared memory (row stride
// ld), from row 0 at src with a row stride of rs floats; rows at or past
// `valid` are zero-filled and not read.  vec: 16-byte copies (src and rs
// multiples of 4 floats), else 4-byte ones.  Threads of the block stride
// over the elements; the caller commits the group.
template <int W, int kThreads>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* src, int64_t rs,
                                           int n, int64_t valid, bool vec) {
  if (vec) {
    constexpr int C = W / 4;
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      const int r = e / C, c = 4 * (e % C);
      const bool ok = r < valid;
      cp_async16(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < n * W; e += kThreads) {
      const int r = e / W, c = e % W;
      const bool ok = r < valid;
      cp_async4(dst + r * ld + c, ok ? src + r * rs + c : src, ok);
    }
  }
}

// n contiguous floats from src into shared memory, 4 bytes each; those at
// or past `valid` zero-filled
template <int kThreads>
__device__ __forceinline__ void stage_vec(float* dst, const float* src,
                                          int n, int64_t valid) {
  for (int e = threadIdx.x; e < n; e += kThreads)
    cp_async4(dst + e, e < valid ? src + e : src, e < valid);
}

}  // namespace
