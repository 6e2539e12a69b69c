// K1 — flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel fedml_tpu/ops/attention.py::_flash_fwd_kernel
// (launched by flash_attention_fwd_pallas, pallas_call at :297).
// Computes O = softmax(Q·Kᵀ·scale) · V with an online softmax and emits the
// per-row logsumexp m + log(max(l, 1e-30)) for the backward kernels.
//
// Layout: q (B·H, Sq, D), k/v (B·H_kv, Sk, D), o like q, lse (B·H, Sq) f32.
// Grouped-query attention reads kv row (bh / H)·H_kv + (bh % H) / (H / H_kv)
// directly: K/V are never repeated.
//
// Bound on the H100: at the training shape (B 2, H 32, S 1024, D 128,
// causal, bf16) the call must move 67 MB (20 µs at 3.35 TB/s) for 17 GFLOP
// (17 µs at 989 TFLOP/s): ~256 flop/byte, just under the card's ~295
// ridge, so both bounds matter and the least time is set by bytes.
// Design: one block of four warps per (b·h, 64-row q tile); it walks the
// KV tiles in order (the TPU's sequential k grid becomes this loop), keeps
// Q, the current K/V tile, the score tile and the f32 accumulator in
// shared memory (rows padded against bank conflicts, tiles copied in with
// 16-byte cp.async), and runs both products on the tensor cores through
// wmma with f32 accumulation.  KV tiles wholly above the causal diagonal
// are skipped.  Not yet done (later work): wgmma, TMA loads,
// double-buffered KV tiles and register-resident accumulators.
#include "flash_common.cuh"

namespace fa {

template <typename T>
size_t fwd_smem(int D) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK, P = Tiles<T>::PAD;
  return region(BQ * (D + P) * sizeof(T)) +
         2 * region(BK * (D + P) * sizeof(T)) +
         region(BQ * (BK + FPAD) * sizeof(float)) +
         region(BQ * (BK + P) * sizeof(T)) +
         region(BQ * (D + FPAD) * sizeof(float)) +
         2 * region(BQ * sizeof(float));
}

template <typename T, int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                 int D, float scale, int causal) {
  constexpr int lds = BK + FPAD, ldp = BK + Tiles<T>::PAD;
  const int ldt = D + Tiles<T>::PAD, ldf = D + FPAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carver cv{smem};
  T* sQ = cv.take<T>(BQ * ldt);
  T* sK = cv.take<T>(BK * ldt);
  T* sV = cv.take<T>(BK * ldt);
  float* sS = cv.take<float>(BQ * lds);
  T* sP = cv.take<T>(BQ * ldp);
  float* sAcc = cv.take<float>(BQ * ldf);
  float* sM = cv.take<float>(BQ);
  float* sL = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const T* qb = q + (size_t)bh * Sq * D;
  const T* kb = k + (size_t)kvr * Sk * D;
  const T* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(sQ, ldt, qb, q0, Sq, BQ, D);
  for (int i = threadIdx.x; i < BQ * ldf; i += NTHREADS) sAcc[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    sM[i] = NEG_INF;
    sL[i] = 0.f;
  }
  cp_wait();
  __syncthreads();

  const int nk = (Sk + BK - 1) / BK;
  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK;
    if (causal && k0 > q0 + BQ - 1) break;  // this and later tiles are masked
    load_rows(sK, ldt, kb, k0, Sk, BK, D);
    load_rows(sV, ldt, vb, k0, Sk, BK, D);
    cp_wait();
    __syncthreads();
    mm<false, true>(sQ, ldt, sK, ldt, sS, lds, BQ, BK, D, false);  // Q·Kᵀ
    __syncthreads();
    // online softmax, one warp per row
    for (int r = warp; r < BQ; r += NWARPS) {
      const int qpos = q0 + r;
      float mx = NEG_INF;
      for (int j = lane; j < BK; j += 32) {
        const int kpos = k0 + j;
        const bool ok = kpos < Sk && (!causal || kpos <= qpos);
        const float s = ok ? sS[r * lds + j] * scale : NEG_INF;
        sS[r * lds + j] = s;
        mx = fmaxf(mx, s);
      }
      mx = warp_max(mx);
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = lane; j < BK; j += 32) {
        const float p = expf(sS[r * lds + j] - m_new);
        sum += p;
        sP[r * ldp + j] = from_f<T>(p);   // P enters P·V in V's type
      }
      sum = warp_sum(sum);
      for (int c = lane; c < D; c += 32) sAcc[r * ldf + c] *= alpha;
      if (lane == 0) {
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
      }
    }
    __syncthreads();
    mm<false, false>(sP, ldp, sV, ldt, sAcc, ldf, BQ, D, BK, true);  // += P·V
    __syncthreads();
  }

  for (int r = warp; r < BQ; r += NWARPS) {
    const int qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float l_safe = fmaxf(sL[r], 1e-30f);
    T* orow = o + ((size_t)bh * Sq + qpos) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = from_f<T>(sAcc[r * ldf + c] / l_safe);
    if (lane == 0) lse[(size_t)bh * Sq + qpos] = sM[r] + logf(l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
           int causal, cudaStream_t stream) {
  constexpr int BQ = Tiles<T>::BQ, BK = Tiles<T>::BK;
  const size_t smem = fwd_smem<T>(D);
  auto kern = flash_fwd_kernel<T, BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      H, Hkv, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Hkv, int Sq, int Sk,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return fa::launch<fa::bf16>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, scale,
                                causal, s);
  return fa::launch<float>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, scale,
                           causal, s);
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_fwd_smem_bytes(int D, int dtype) {
  return dtype == 1 ? (int)fa::fwd_smem<fa::bf16>(D)
                    : (int)fa::fwd_smem<float>(D);
}
