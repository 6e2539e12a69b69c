// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the f32 builds' block size and K2's
// and K3's f32 tile rows, shared-memory regions, row loads with ragged-edge
// zeroing and warp reductions; also the three kernels' bf16 type, mask
// value and CUDA error string.  The f32 products run on the tensor cores in
// 3xTF32 (flash_tf32.cuh), the bf16 ones as wgmma (flash_sm90.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace fa {

typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -1e30f;   // mask value of the reference, not -inf
constexpr int NTHREADS = 128;       // four warps per block
constexpr int NWARPS = NTHREADS / 32;

// (BQ, BK) query/key tile rows of the f32 K2 and K3, small enough that the
// f32 dK/dV block fits in shared memory at head_dim 128.
template <typename T> struct Tiles;
template <> struct Tiles<float> {
  static constexpr int BQ = 32, BK = 32;
};

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

}  // namespace fa

extern "C" const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
