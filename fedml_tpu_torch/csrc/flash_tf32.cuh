// The f32 tile products of K1, K2 and K3 (flash_fwd.cu, flash_bwd_dq.cu,
// flash_bwd_dkv.cu) on Hopper's tensor cores: warp-level mma.sync m16n8k8 in TF32 with the
// 3xTF32 split, which keeps f32 accuracy.  Each f32 value x is split as
// x ≈ hi + lo, hi = tf32(x), lo = tf32(x − hi) (the rounding of
// cvt.rna.tf32.f32: to nearest, ties away from zero), and a·b is taken as
// lo_a·hi_b + hi_a·lo_b + hi_a·hi_b, three mma a k-step, small terms first
// (the scheme of CUTLASS's OpMultiplyAddFastF32).  The lo·lo term and the
// TF32 rounding of lo are below f32's own rounding: one TF32 pass alone
// misses KERNEL_TOL[f32] by ~40× at the text shape, 3xTF32 keeps ~25×
// margin (tests/test_torch_tf32_split.py pins both on the CPU).  This is
// not the library's TF32 mode (device.py keeps that off): the products stay
// f32-accurate, and the card holds them to KERNEL_TOL[f32].
//
// mma_tile is a warp's 16 x 16 output tile, kept in registers by its
// caller: K2 and K3 hold S, dP and their dQ, dK, dV accumulators there.
// mm_tf32x3 is a block-level product C (+)= A·B from shared memory, built
// on it (fa_tile_mm_f32_test checks every layout of it).  mma_strip is a
// warp's whole 16-row strip of one k-step with A already in registers:
// K1 keeps Q's fragments there, and its P is S's C fragment (c_frag_as_a;
// fa_pv_f32_test checks that product alone).
//
// Fragments (PTX ISA, m16n8k8 .tf32; CUTLASS SM80_16x8x8_F32TF32TF32F32_TN),
// g = lane / 4, t = lane % 4: A a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); B b0 (k t, n g), b1 (k t+4, n g); C c0/c1 (g, 2t / 2t+1),
// c2/c3 (g+8, 2t / 2t+1).  They are loaded from shared memory with plain
// loads, so a transposed operand costs index arithmetic only.  The order of
// k inside a k-step of 8 is free as long as A and B agree on it: with B
// stored [N][K] (B_T) slot s holds k0 + s; with B stored [K][N] slot t holds
// k0 + 2t and slot t+4 holds k0 + 2t + 1 ("paired"), so that an operand
// whose rows are picked by t reads rows 2t and 2t+1.  Then every load is
// free of bank conflicts when row strides (floats) are:
//   - an odd multiple of 4 (PAD4 past a multiple of 16): every B operand;
//     A stored [M][K] when B_T; A stored [K][M] when not B_T;
//   - an odd multiple of 8 (PAD8 past a multiple of 16): A stored [M][K]
//     when not B_T (rows g, g+8, read as float2 at 2t), and C, read and
//     written as float2 at (g, 2t).
// (A stored [K][M] with B_T would want an odd multiple of 8; no kernel
// uses it.)
#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace fa {

// Row padding, in floats, of the f32 tiles of K1, K2 and K3: D and the
// tile sizes are multiples of 16,
// so a row of n + PAD4 floats is an odd multiple of 4 and one of n + PAD8
// an odd multiple of 8.
constexpr int PAD4 = 4, PAD8 = 8;

// x ≈ hi + lo for the tensor cores, both TF32.  hi is tf32(x) exactly as
// cvt.rna.tf32.f32 gives it for a finite x: round the magnitude to nearest,
// ties away from zero, by adding half of the 13 dropped bits, then clear
// them (cvt.rna compiles to four instructions with an inf check; these
// are two).  lo is x − hi (exact) with the same half added: mma .tf32
// reads only the top 19 bits of its operand registers, so it is tf32(lo)
// as the tensor cores see it (ptxas makes the same saving for cvt.rna).
// An inf stays inf; a NaN whose payload lies only in the dropped bits
// becomes inf — neither occurs in attention's finite inputs.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a·b in 3xTF32.  The tensor cores add into their accumulator with
// truncation, not round-to-nearest: over a long sum (dQ over 2048 keys)
// that bias grows with K and breaks KERNEL_TOL[f32].  So each k-step's
// three passes go into a fresh accumulator, which holds only that step's
// sum, and it is added to c in f32 with round-to-nearest.
__device__ __forceinline__ void mma_tf32x3(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(s, al, bh);
  mma_tf32(s, ah, bl);
  mma_tf32(s, ah, bh);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += s[e];
}

// c += A·B on this warp's 16 x 16 output tile at (m0, n0), as two m16n8
// accumulators (c[j]: columns n0 + 8j ..; c[j][e] at row m0 + g + 8·(e/2),
// column n0 + 8j + 2t + e%2), over k = 0..K-1 (K a multiple of 8).  A_T: A
// stored as [K][M] (lda); B_T: B stored as [N][K] (ldb).  Only this warp's
// lanes take part; the sums run in a fixed order.
template <bool A_T, bool B_T, int K>
__device__ __forceinline__ void mma_tile(const float* A, int lda,
                                         const float* B, int ldb, int m0,
                                         int n0, float (&c)[2][4]) {
  static_assert(K % 8 == 0, "k-steps of 8");
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  // k of fragment slots t and t+4 (see the note at the top)
  const int k_lo = B_T ? t : 2 * t, k_hi = B_T ? t + 4 : 2 * t + 1;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 8) {
    float a[4];   // a0..a3: rows g, g+8 at slot t, then at slot t+4
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + g + 8 * h;
      if (A_T) {
        a[h] = A[(k0 + k_lo) * lda + m];
        a[h + 2] = A[(k0 + k_hi) * lda + m];
      } else if (B_T) {
        a[h] = A[m * lda + k0 + k_lo];
        a[h + 2] = A[m * lda + k0 + k_hi];
      } else {   // paired: k0 + 2t and k0 + 2t + 1 side by side
        const float2 v =
            *reinterpret_cast<const float2*>(A + m * lda + k0 + 2 * t);
        a[h] = v.x;
        a[h + 2] = v.y;
      }
    }
    uint32_t ah[4], al[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + 8 * j + g;
      const float b0 =
          B_T ? B[n * ldb + k0 + k_lo] : B[(k0 + k_lo) * ldb + n];
      const float b1 =
          B_T ? B[n * ldb + k0 + k_hi] : B[(k0 + k_hi) * ldb + n];
      uint32_t bh[2], bl[2];
      split_tf32(b0, bh[0], bl[0]);
      split_tf32(b1, bh[1], bl[1]);
      mma_tf32x3(c[j], ah, al, bh, bl);
    }
  }
}

// C[M x N] (f32, row-major, ldc) =
// (acc ? C : 0) + A[M x K] · B[K x N], with A_T: A stored as [K][M]
// (lda) and B_T: B stored as [N][K] (ldb).  M and N multiples of 16, K of
// 8; every thread of the block calls it, the caller synchronises.  The
// four warps take 16 x 16 output tiles in turn (mma_tile), keep them in
// registers over the whole K loop, and read C (when acc) and write it
// once.
template <bool A_T, bool B_T>
__device__ void mm_tf32x3(const float* A, int lda, const float* B, int ldb,
                          float* C, int ldc, int M, int N, int K, bool acc) {
  if ((M | N) % 16 || K % 8) __trap();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = N / 16;
  for (int w = warp; w < (M / 16) * tiles_n; w += NWARPS) {
    const int m0 = w / tiles_n * 16, n0 = w % tiles_n * 16;
    float c[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v =
            acc ? *reinterpret_cast<const float2*>(
                      C + (m0 + g + 8 * h) * ldc + n0 + 8 * j + 2 * t)
                : make_float2(0.f, 0.f);
        c[j][2 * h] = v.x;
        c[j][2 * h + 1] = v.y;
      }
    for (int k0 = 0; k0 < K; k0 += 8)   // k-steps at A's and B's k0
      mma_tile<A_T, B_T, 8>(A + (A_T ? k0 * lda : k0), lda,
                            B + (B_T ? k0 : k0 * ldb), ldb, m0, n0, c);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(C + (m0 + g + 8 * h) * ldc + n0 + 8 * j +
                                   2 * t) =
            make_float2(c[j][2 * h], c[j][2 * h + 1]);
  }
}

// ---- A in registers: a warp's 16-row strip --------------------------------
// The A fragment of k-step k0 of A stored [M][K] (lda) at rows m0 + g and
// m0 + g + 8, in the k order of a B stored [N][K] (slot s = k0 + s), split
// into hi and lo.
__device__ __forceinline__ void a_frag_bt(const float* A, int lda, int m0,
                                          int k0, uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = A + (m0 + g + 8 * h) * lda + k0;
    split_tf32(row[t], ah[h], al[h]);
    split_tf32(row[t + 4], ah[h + 2], al[h + 2]);
  }
}

// The A fragment, split, of the k-step over columns 8i .. 8i+7 of a 16-row
// strip held as the C fragment c of those columns (c0/c1 at row g, columns
// 2t/2t+1; c2/c3 at row g+8), in the paired k order of a B stored [K][N]
// (slot t = 2t, slot t+4 = 2t+1): a0 = c0, a1 = c2, a2 = c1, a3 = c3.  So
// one product's output is the next one's A operand without leaving
// registers, with no shuffle.
__device__ __forceinline__ void c_frag_as_a(const float (&c)[4],
                                            uint32_t (&ah)[4],
                                            uint32_t (&al)[4]) {
  split_tf32(c[0], ah[0], al[0]);
  split_tf32(c[2], ah[1], al[1]);
  split_tf32(c[1], ah[2], al[2]);
  split_tf32(c[3], ah[3], al[3]);
}

// c[j] += A·B over one k-step at k0 for the NT column tiles j (columns
// 8j .. 8j+7, from 0) of a warp's 16-row strip, A given split (ah, al) in
// B's k order.  B_T: B stored [N][K] (ldb); else B stored [K][N] (ldb),
// paired.  Row strides an odd multiple of 4 floats keep B's loads free of
// bank conflicts in both layouts.
template <bool B_T, int NT>
__device__ __forceinline__ void mma_strip(const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const float* B, int ldb, int k0,
                                          float (&c)[NT][4]) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int k_lo = B_T ? t : 2 * t, k_hi = B_T ? t + 4 : 2 * t + 1;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = 8 * j + g;
    const float b0 = B_T ? B[n * ldb + k0 + k_lo] : B[(k0 + k_lo) * ldb + n];
    const float b1 = B_T ? B[n * ldb + k0 + k_hi] : B[(k0 + k_hi) * ldb + n];
    uint32_t bh[2], bl[2];
    split_tf32(b0, bh[0], bl[0]);
    split_tf32(b1, bh[1], bl[1]);
    mma_tf32x3(c[j], ah, al, bh, bl);
  }
}

}  // namespace fa
