// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile sizes, shared-memory carving,
// row loads with ragged-edge zeroing, warp reductions and the block-level
// tile product C (+)= A·B with f32 accumulation.
//
// Products: bf16 tiles go through the tensor cores with nvcuda::wmma
// (16x16x16, f32 accumulator); f32 tiles (the small parity shapes) use
// plain FMA loops.  Both keep every partial sum in f32, as the TPU kernels'
// preferred_element_type=f32 dots do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stddef.h>

#include <type_traits>

namespace fa {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;   // mask value of the reference, not -inf
constexpr int NTHREADS = 128;       // four warps per block
constexpr int NWARPS = NTHREADS / 32;

// (BQ, BK) query/key tile rows per element type.  bf16 tiles are multiples
// of the 16-row wmma shape; f32 tiles are smaller so that the f32 dK/dV
// block still fits in shared memory at head_dim 128.  Every shared-memory
// row is padded by 16 bytes (PAD elements of T, 4 of f32): rows of 128 or
// 256 bytes would put the rows of a 16x16 fragment on the same banks.
template <typename T> struct Tiles;
template <> struct Tiles<bf16> {
  static constexpr int BQ = 64, BK = 64, PAD = 8;
};
template <> struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32, PAD = 4;
};
constexpr int FPAD = 4;   // padding of f32 rows

__host__ __device__ constexpr size_t region(size_t bytes) {
  return (bytes + 127) & ~size_t(127);
}

struct Carver {
  unsigned char* p;
  template <typename T> __device__ T* take(size_t n) {
    T* r = reinterpret_cast<T*>(p);
    p += region(n * sizeof(T));
    return r;
  }
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Starts dst[r·ld + c] = src[row0 + r][c] for r < rows as 16-byte cp.async
// copies, zero-filled where row0 + r >= nrows (out-of-range K/V/Q rows are
// zeroed before any product, so ragged sequence ends never feed undefined
// values into a sum).  Needs D·sizeof(T) and ld·sizeof(T) multiples of 16
// and a 16-byte aligned src (the wrapper guarantees it); every chunk of a
// call is in flight at once.  Complete with cp_wait() before the block
// synchronises.
template <typename T>
__device__ void load_rows(T* dst, int ld, const T* __restrict__ src, int row0,
                          int nrows, int rows, int D) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = D / V;
  for (int idx = threadIdx.x; idx < rows * cpr; idx += NTHREADS) {
    const int r = idx / cpr, c = (idx - r * cpr) * V;
    const bool in = row0 + r < nrows;
    __pipeline_memcpy_async(dst + r * ld + c,
                            in ? src + (size_t)(row0 + r) * D + c : src, 16,
                            in ? 0 : 16);
  }
  __pipeline_commit();
}

__device__ __forceinline__ void cp_wait() { __pipeline_wait_prior(0); }

// C[M x N] (f32, row-major, ldc) = (acc ? C : 0) + A[M x K] · B[K x N].
// A_T: A is stored transposed, as [K][M] with leading dimension lda;
// B_T: B is stored transposed, as [N][K] with leading dimension ldb.
// Every thread of the block must call it; the caller synchronises.
template <bool A_T, bool B_T>
__device__ void mm(const float* A, int lda, const float* B, int ldb,
                   float* C, int ldc, int M, int N, int K, bool acc) {
  for (int idx = threadIdx.x; idx < M * N; idx += NTHREADS) {
    const int m = idx / N, n = idx - m * N;
    float s = acc ? C[m * ldc + n] : 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float a = A_T ? A[kk * lda + m] : A[m * lda + kk];
      const float b = B_T ? B[n * ldb + kk] : B[kk * ldb + n];
      s = fmaf(a, b, s);
    }
    C[m * ldc + n] = s;
  }
}

template <bool A_T, bool B_T>
__device__ void mm(const bf16* A, int lda, const bf16* B, int ldb, float* C,
                   int ldc, int M, int N, int K, bool acc) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_T, wmma::col_major,
                                       wmma::row_major>::type;
  using LB = typename std::conditional<B_T, wmma::col_major,
                                       wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  const int tn = N / 16, tiles = (M / 16) * tn;
  for (int t = warp; t < tiles; t += NWARPS) {
    const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (acc)
      wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
      wmma::load_matrix_sync(a, A_T ? A + k0 * lda + m0 : A + m0 * lda + k0,
                             lda);
      wmma::load_matrix_sync(b, B_T ? B + n0 * ldb + k0 : B + k0 * ldb + n0,
                             ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
  }
}

}  // namespace fa

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
