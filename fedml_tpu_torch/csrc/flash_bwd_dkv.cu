// K3 — flash-attention backward, dK/dV pass, for Hopper (sm_90a).
//
// Replaces the TPU kernel fedml_tpu/ops/attention.py::_flash_bwd_dkv_kernel
// (launched in flash_attention_bwd_pallas, pallas_call at :500), including
// the group sum over the q heads of a KV head that the reference does
// outside its kernel (:521-524).
//
// Per q tile: P = exp(Q·Kᵀ·scale − lse) under the masks (padded q rows
// masked too), dV += Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − Δ)·scale,
// dK += dSᵀ·Q — sums in f32, P and dS rounded to the operand type before
// their products as in the reference.  Δ comes from K2.
//
// Bound on the H100: 8·Sq·Sk·D flops (half of it for causal) over reads of
// Q, K, V, dO, lse and Δ — at the training shape 34 GFLOP (35 µs) against
// 101 MB (30 µs): operation-bound.  Design:
// one block of four warps per (b·h_kv, 64-row k tile).  It keeps its K/V
// tile and the f32 dK/dV accumulators in shared memory and loops over the
// H/H_kv q heads of its group and over their q tiles, so the group sum
// happens inside the block: no atomics and no per-q-head dK/dV buffer.
// All four products run on the tensor cores (wmma, f32 accumulation); q
// tiles wholly above the causal diagonal are skipped.
#include "flash_common.cuh"

namespace fa {

template <typename T>
size_t dkv_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK, P = Tiles<T>::PAD;
  return 2 * region(BK * (D + P) * sizeof(T)) +
         2 * region(BQ * (D + P) * sizeof(T)) +
         2 * region(BQ * (BK + FPAD) * sizeof(float)) +
         2 * region(BQ * (BK + P) * sizeof(T)) +
         2 * region(BK * (D + FPAD) * sizeof(float)) +
         2 * region(BQ * sizeof(float));
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const T* __restrict__ dout, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Sq, int Sk, int D,
                     float scale, int causal) {
  constexpr int lds = BK + FPAD, ldp = BK + Tiles<T>::PAD;
  const int ldt = D + Tiles<T>::PAD, ldf = D + FPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* sK = cv.take<T>(BK * ldt);
  T* sV = cv.take<T>(BK * ldt);
  T* sQ = cv.take<T>(BQ * ldt);
  T* sdO = cv.take<T>(BQ * ldt);
  float* sS = cv.take<float>(BQ * lds);
  float* sdP = cv.take<float>(BQ * lds);
  T* sP = cv.take<T>(BQ * ldp);
  T* sdS = cv.take<T>(BQ * ldp);
  float* sdK = cv.take<float>(BK * ldf);
  float* sdV = cv.take<float>(BK * ldf);
  float* sLse = cv.take<float>(BQ);
  float* sDelta = cv.take<float>(BQ);

  const int kvr = blockIdx.y, k0 = blockIdx.x * BK;
  const int b = kvr / Hkv, hk = kvr % Hkv, rep = H / Hkv;
  const size_t koff = (size_t)kvr * Sk * D;

  load_rows(sK, ldt, k + koff, k0, Sk, BK, D);
  load_rows(sV, ldt, v + koff, k0, Sk, BK, D);
  for (int i = threadIdx.x; i < BK * ldf; i += NTHREADS) {
    sdK[i] = 0.f;
    sdV[i] = 0.f;
  }

  const int nq = (Sq + BQ - 1) / BQ;
  for (int g = 0; g < rep; ++g) {
    const int bh = b * H + hk * rep + g;
    const size_t qoff = (size_t)bh * Sq * D;
    for (int qi = 0; qi < nq; ++qi) {
      const int q0 = qi * BQ;
      if (causal && q0 + BQ - 1 < k0) continue;  // tile sees none of this K
      __syncthreads();  // previous tile's products are done with sQ/sdO/sP
      load_rows(sQ, ldt, q + qoff, q0, Sq, BQ, D);
      load_rows(sdO, ldt, dout + qoff, q0, Sq, BQ, D);
      for (int r = threadIdx.x; r < BQ; r += NTHREADS) {
        const bool in = q0 + r < Sq;
        sLse[r] = in ? lse[(size_t)bh * Sq + q0 + r] : 0.f;
        sDelta[r] = in ? delta[(size_t)bh * Sq + q0 + r] : 0.f;
      }
      cp_wait();
      __syncthreads();
      mm<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);  // Q·Kᵀ
      mm<false, true>(sdO, ldt, sV, ldt, sdP, lds, BQ, BK, D, false);
      __syncthreads();
      for (int idx = threadIdx.x; idx < BQ * BK; idx += NTHREADS) {
        const int r = idx / BK, j = idx - r * BK;
        const int qpos = q0 + r, kpos = k0 + j;
        const bool ok = kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
        const float p = ok ? expf(sS[r * lds + j] * scale - sLse[r]) : 0.f;
        sP[r * ldp + j] = from_f<T>(p);
        sdS[r * ldp + j] =
            from_f<T>(p * (sdP[r * lds + j] - sDelta[r]) * scale);
      }
      __syncthreads();
      mm<true, false>(sP, ldp, sdO, ldt, sdV, ldf, BK, D, BQ, true);  // Pᵀ·dO
      mm<true, false>(sdS, ldp, sQ, ldt, sdK, ldf, BK, D, BQ, true);  // dSᵀ·Q
    }
  }
  cp_wait();   // no q tile may have been live: the K/V loads end here
  __syncthreads();

  for (int idx = threadIdx.x; idx < BK * D; idx += NTHREADS) {
    const int r = idx / D, c = idx - r * D;
    if (k0 + r < Sk) {
      dk[koff + (size_t)k0 * D + idx] = from_f<T>(sdK[r * ldf + c]);
      dv[koff + (size_t)k0 * D + idx] = from_f<T>(sdV[r * ldf + c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lse,
           const void* delta, const void* dout, void* dk, void* dv, int B,
           int H, int Hkv, int Sq, int Sk, int D, float scale, int causal,
           cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = dkv_smem<T>(D);
  auto kern = flash_bwd_dkv_kernel<T, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + BK - 1) / BK, B * Hkv);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const T*>(dout),
      static_cast<T*>(dk), static_cast<T*>(dv), H, Hkv, Sq, Sk, D, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* lse, const void* delta,
                             const void* dout, void* dk, void* dv, int B,
                             int H, int Hkv, int Sq, int Sk, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fa::launch<fa::bf16>(q, k, v, lse, delta, dout, dk, dv, B, H, Hkv,
                                Sq, Sk, D, scale, causal, s);
  return fa::launch<float>(q, k, v, lse, delta, dout, dk, dv, B, H, Hkv, Sq,
                           Sk, D, scale, causal, s);
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_bwd_dkv_smem_bytes(int D, int dtype) {
  return dtype == 1 ? (int)fa::dkv_smem<fa::bf16>(D)
                    : (int)fa::dkv_smem<float>(D);
}
