// K2 — flash-attention backward, dQ pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel fedml_tpu/ops/attention.py::_flash_bwd_dq_kernel
// (launched in flash_attention_bwd_pallas, pallas_call at :483).  Also
// folds in the Δ = rowsum(dO∘O) preprocess that the reference leaves to
// XLA (:469): each block computes Δ for its q rows, uses it, and writes it
// out for the dK/dV kernel (K3), which runs after this one on the stream.
//
// Per KV tile: P = exp(Q·Kᵀ·scale − lse) under the masks, dP = dO·Vᵀ,
// dS = P∘(dP − Δ)·scale, dQ += dS·K — all sums in f32, dS rounded to K's
// type before its product, as the reference does.
//
// Bound on the H100: 6·Sq·Sk·D flops (half of it for causal) over reads of
// Q, K, V, O, dO and lse and writes of dQ and Δ — at the training shape
// 26 GFLOP (26 µs) against 101 MB (30 µs), so bytes set the least time by
// a small margin.  Design: one
// block of four warps per (b·h, 64-row q tile), looping over KV tiles with
// Q, dO, the current K/V tile, S, dP and the f32 dQ accumulator in shared
// memory and the three products on the tensor cores (wmma, f32
// accumulation).  KV tiles above the causal diagonal are skipped.
#include "flash_common.cuh"

namespace fa {

template <typename T>
size_t dq_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK, P = Tiles<T>::PAD;
  return 2 * region(BQ * (D + P) * sizeof(T)) +
         2 * region(BK * (D + P) * sizeof(T)) +
         2 * region(BQ * (BK + FPAD) * sizeof(float)) +
         region(BQ * (BK + P) * sizeof(T)) +
         region(BQ * (D + FPAD) * sizeof(float)) +
         2 * region(BQ * sizeof(float));
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    T* __restrict__ dq, float* __restrict__ delta, int H,
                    int Hkv, int Sq, int Sk, int D, float scale, int causal) {
  constexpr int lds = BK + FPAD, ldp = BK + Tiles<T>::PAD;
  const int ldt = D + Tiles<T>::PAD, ldf = D + FPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* sQ = cv.take<T>(BQ * ldt);
  T* sdO = cv.take<T>(BQ * ldt);
  T* sK = cv.take<T>(BK * ldt);
  T* sV = cv.take<T>(BK * ldt);
  float* sS = cv.take<float>(BQ * lds);
  float* sdP = cv.take<float>(BQ * lds);
  T* sdS = cv.take<T>(BQ * ldp);
  float* sAcc = cv.take<float>(BQ * ldf);
  float* sLse = cv.take<float>(BQ);
  float* sDelta = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const size_t qoff = (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvr * Sk * D;
  const T* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(sQ, ldt, q + qoff, q0, Sq, BQ, D);
  load_rows(sdO, ldt, dout + qoff, q0, Sq, BQ, D);
  for (int i = threadIdx.x; i < BQ * ldf; i += NTHREADS) sAcc[i] = 0.f;
  // Δ = rowsum(dO∘O) in f32, one warp per row
  for (int r = warp; r < BQ; r += NWARPS) {
    const int qpos = q0 + r;
    float d = 0.f;
    if (qpos < Sq) {
      const T* orow = o + qoff + (size_t)qpos * D;
      const T* drow = dout + qoff + (size_t)qpos * D;
      for (int c = lane; c < D; c += 32) d += to_f(drow[c]) * to_f(orow[c]);
    }
    d = warp_sum(d);
    if (lane == 0) {
      sDelta[r] = d;
      sLse[r] = qpos < Sq ? lse[(size_t)bh * Sq + qpos] : 0.f;
      if (qpos < Sq) delta[(size_t)bh * Sq + qpos] = d;
    }
  }
  cp_wait();
  __syncthreads();

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    if (causal && k0 > q0 + BQ - 1) break;
    load_rows(sK, ldt, kb, k0, Sk, BK, D);
    load_rows(sV, ldt, vb, k0, Sk, BK, D);
    cp_wait();
    __syncthreads();
    mm<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);    // Q·Kᵀ
    mm<false, true>(sdO, ldt, sV, ldt, sdP, lds, BQ, BK, D, false);  // dO·Vᵀ
    __syncthreads();
    for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
      const int r = idx / BK, j = idx - r * BK;
      const int qpos = q0 + r, kpos = k0 + j;
      const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
      const float p = ok ? expf(sS[r * lds + j] * scale - sLse[r]) : 0.f;
      sdS[r * ldp + j] =
          from_f<T>(p * (sdP[r * lds + j] - sDelta[r]) * scale);
    }
    __syncthreads();
    mm<false, false>(sdS, ldp, sK, ldt, sAcc, ldf, BQ, D, BK, true);  // dS·K
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx - r * D;
    if (q0 + r < Sq)
      dq[qoff + (size_t)q0 * D + idx] = from_f<T>(sAcc[r * ldf + c]);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* lse, const void* dout, void* dq, void* delta, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = dq_smem<T>(D);
  auto kern = flash_bwd_dq_kernel<T, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const float*>(lse), static_cast<const T*>(dout),
      static_cast<T*>(dq), static_cast<float*>(delta), H, Hkv, Sq, Sk, D,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* delta, int B, int H, int Hkv,
                            int Sq, int Sk, int D, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fa::launch<fa::bf16>(q, k, v, o, lse, dout, dq, delta, B, H, Hkv,
                                Sq, Sk, D, scale, causal, s);
  return fa::launch<float>(q, k, v, o, lse, dout, dq, delta, B, H, Hkv, Sq,
                           Sk, D, scale, causal, s);
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_bwd_dq_smem_bytes(int D, int dtype) {
  return dtype == 1 ? (int)fa::dq_smem<fa::bf16>(D)
                    : (int)fa::dq_smem<float>(D);
}
