// Register-tile pieces of the bf16 kernels K1 (flash_fwd.cu), K2
// (flash_bwd_dq.cu) and K3 (flash_bwd_dkv.cu): the 128-byte-swizzled
// shared-memory tile that wgmma reads, 16-byte cp.async tile loads into it
// (ragged rows zero-filled), wgmma descriptors and wrappers, and the
// register-fragment helpers of the softmax.
//
// Per warp, a wgmma accumulator and a register A operand use the layouts
// of mma.m16n8k16 (PTX ISA; g = lane / 4, t = lane % 4), warp w of a
// warpgroup holding rows 16w..16w+15 of the 64:
//   A 16x16 (4 regs of 2 bf16): rows g, g+8 × cols 2t, 2t+1 and 2t+8, 2t+9;
//   C 16x8 per 8 columns (4 f32): rows g (c0, c1) and g+8 (c2, c3) × cols
//   2t, 2t+1.
// Two neighbouring C tiles of a row block are, once rounded to bf16, the A
// fragment of the next product over the same 16 columns: S becomes P·V's A
// operand without leaving registers.
#pragma once

#include <stdint.h>

#include "flash_common.cuh"

namespace fa {

// The bf16 kernels hold a head dim D (a multiple of 16 up to 128) in tiles
// of padded_dim(D) columns, zero past D: the 128-byte swizzle takes blocks
// of 64 bf16 columns.
__host__ __device__ constexpr int padded_dim(int d) { return d <= 64 ? 64 : 128; }

// X(d) for every head dim the bf16 kernels are built for
#define FA_BF16_HEAD_DIMS(X) X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128)

namespace sm90 {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A [ROWS][DP] bf16 tile (DP 64 or 128) is stored as DP/64 column
// blocks of ROWS × 128 bytes.  The 16-byte chunk c (8 bf16) of row r lies
// in block c / 8 at r·128 + ((c % 8) ^ (r % 8))·16: wgmma's canonical
// 128-byte swizzle, which puts chunk c of eight consecutive rows on eight
// different bank groups.  Tiles start on 1024-byte boundaries.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Starts copying rows row0 .. row0+ROWS-1 of src ([nrows][D] bf16) into the
// swizzled [ROWS][DP] tile at shared address dst, all NT threads taking
// part.  Rows at or past nrows, and columns D .. DP-1, are zero-filled: a
// ragged end and a head dim padded up to the tile's DP columns feed zeros
// to the sums.
template <int ROWS, int DP, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int nrows) {
  constexpr int CPR = DP / 8;
  static_assert(ROWS * CPR % NT == 0, "tile chunks must split over threads");
#pragma unroll
  for (int it = 0; it < ROWS * CPR / NT; ++it) {
    const int idx = it * NT + threadIdx.x;
    const int r = idx / CPR, c = idx % CPR;
    const bool in = row0 + r < nrows && c < D / 8;
    cp16(dst + swz<ROWS>(r, c), in ? src + (size_t)(row0 + r) * D + c * 8 : src,
         in);
  }
}

// Starts copying src[row0 .. row0+n-1] (f32) to shared address dst,
// zero-filled at or past nrows.
template <int NT>
__device__ __forceinline__ void load_row(uint32_t dst, const float* src,
                                         int row0, int nrows, int n) {
  for (int i = threadIdx.x; i < n; i += NT) {
    const bool in = row0 + i < nrows;
    cp4(dst + 4 * i, in ? src + row0 + i : src, in);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 16 × 16·N product from N·2 C tiles (rounded to bf16).
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[N][4],
                                       const float (&c)[2 * N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    a[i][0] = pack_bf16(c[2 * i][0], c[2 * i][1]);
    a[i][1] = pack_bf16(c[2 * i][2], c[2 * i][3]);
    a[i][2] = pack_bf16(c[2 * i + 1][0], c[2 * i + 1][1]);
    a[i][3] = pack_bf16(c[2 * i + 1][2], c[2 * i + 1][3]);
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// max / sum over the four lanes of a quad (the threads that hold one row)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---- wgmma: warpgroup products (sm_90a) -----------------------------------
// Four warps (a warpgroup) issue one asynchronous m64nNk16 product; warp w
// of the warpgroup holds rows 16w..16w+15 of the 64-row f32 accumulator in
// the C layout above (d[j] covers columns 8j..8j+7), and an A operand in
// registers has the A layout above.  A shared-memory operand is described
// by a 64-bit descriptor (PTX ISA, "Matrix Descriptor Format"): start
// address, leading and stride byte offsets, all in 16-byte units, and the
// swizzle mode in bits 62-63 (1: the 128-byte swizzle of swz()).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major operand (the product's k runs along the 128-byte rows): rows
// row0.. of a swizzled [ROWS][DP] tile, k slice kk (columns 16kk..16kk+15).
// Eight-row groups are 1024 bytes apart; a slice inside a 64-column block
// starts 32 bytes further along the row, which the swizzle resolves.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int row0, int kk) {
  return sw128_desc(tile + (kk >> 2) * (ROWS * 128) + row0 * 128 + (kk & 3) * 32,
                    16, 1024);
}
// MN-major B operand (the product's n runs along the rows): k rows
// 16kk..16kk+15 of a swizzled [ROWS][DP] tile, n over all DP columns; the
// 64-column blocks are ROWS·128 bytes apart (leading offset), eight-row k
// groups 1024 (stride offset).
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return sw128_desc(tile + kk * 16 * 128, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the compiler's uses of accumulator registers after a wgmma_wait.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M][4]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}
// Makes this thread's completed cp.async (generic-proxy) writes visible to
// wgmma's (async-proxy) reads; a block barrier follows.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A·B, m64nNk16, bf16 in, f32 sums: wgmma_ss reads A (K-major) and
// B (K-major) from shared memory; wgmma_rs reads A from registers and B
// (MN-major) from shared memory.  scale_d 0 overwrites d.  Built for the N
// the kernels use: 64 for wgmma_ss (S tiles of 64 columns), 64 and 128 for
// wgmma_rs (the padded head dims).
template <int N>
__device__ void wgmma_ss(float (&d)[N / 8][4], uint64_t a, uint64_t b,
                         int scale_d);
template <int N>
__device__ void wgmma_rs(float (&d)[N / 8][4], const uint32_t (&a)[4],
                         uint64_t b, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[8][4], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[8][4],
                                                const uint32_t (&a)[4], uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[16][4],
                                                const uint32_t (&a)[4], uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(scale_d));
}

}  // namespace sm90
}  // namespace fa
