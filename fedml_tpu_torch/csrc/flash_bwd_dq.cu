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
// (B 2, H 32, S 1024, D 128, causal, bf16) 26 GFLOP (26 µs) against 101 MB
// (30 µs), so bytes set the least time by a small margin.
//
// bf16 design (D any multiple of 16 up to 128, held in tiles of DP = 64 or
// 128 columns whose columns past D are zero), K1's shape with one more
// product: one warpgroup per (b·h, 64-row q tile), q tiles with the most KV
// tiles first.  It owns the 64 q rows (each warp 16), so q is the row
// dimension of every product and dQ, S and dP stay in registers.  Q and dO
// are loaded once into 128-byte-swizzled shared memory; Δ is summed in f32
// from 16-byte loads of O and dO by the four threads that hold each row,
// and each thread keeps its rows' Δ and lse in registers.  Per KV tile,
// S = Q·Kᵀ and dP = dO·Vᵀ are one group of wgmma m64n64k16 (all operands
// K-major from shared memory); P = ex2(S·scale·log2 e − lse·log2 e) and dS
// are formed in registers, dS is rounded to bf16 as the register A operand
// of dQ += dS·K, which reads K as stored, [k][d] (an MN-major B), all sums
// in f32 (flash_sm90.cuh).  64-row K/V tiles go through a two-stage ring
// filled by 16-byte cp.async: tile j+1 is in flight while tile j's products
// run.  Only tiles that cross the causal diagonal or the ragged end
// evaluate the mask (a zero-filled K row past Sk gives P = exp(−lse), not
// 0, so the mask must zero it there); tiles wholly above the diagonal are
// never visited.  dQ is rounded to bf16 once and staged through the Q tile
// for whole-row stores.  Shared memory is 32 KB (D ≤ 64) or 96 KB, so two
// blocks share an SM.  This design replaced the first one (wmma 16×16×16
// with S, dP, dS and the dQ accumulator in shared memory, one block an SM,
// no overlap of loads and products): PERF.md has both times.
//
// f32 (the small parity shapes only) keeps the first design: tiles and the
// f32 accumulator in shared memory, FMA products (flash_common.cuh).
#include "flash_sm90.cuh"

namespace fa {

constexpr int DQ_BQ = 64, DQ_BK = 64;

// Q, dO, then two stages of (K, V)
template <int DP>
__host__ __device__ constexpr size_t dq_bf16_smem() {
  return 2 * size_t(DQ_BQ) * DP * 2 + 2 * 2 * size_t(DQ_BK) * DP * 2;
}

// Σ a∘b over 8 bf16 pairs, in f32
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(DQ_BQ * 2)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ o,
                         const float* __restrict__ lse,
                         const bf16* __restrict__ dout,
                         bf16* __restrict__ dq, float* __restrict__ delta,
                         int H, int Hkv, int Sq, int Sk, float scale,
                         float scale_log2, int causal) {
  using namespace sm90;
  constexpr int BQ = DQ_BQ, BK = DQ_BK, NT = BQ * 2, DP = padded_dim(D);
  constexpr int QBYTES = BQ * DP * 2, KBYTES = BK * DP * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem), sdO = sQ + QBYTES;
  auto stage = [&](int j) { return sQ + 2 * QBYTES + (j & 1) * 2 * KBYTES; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const size_t qoff = (size_t)bh * Sq * D;
  const bf16* kb = k + (size_t)kvr * Sk * D;
  const bf16* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int nk_all = (Sk + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_tile<BQ, DP, D, NT>(sQ, q + qoff, q0, Sq);
  load_tile<BQ, DP, D, NT>(sdO, dout + qoff, q0, Sq);
  load_tile<BK, DP, D, NT>(stage(0), kb, 0, Sk);
  load_tile<BK, DP, D, NT>(stage(0) + KBYTES, vb, 0, Sk);
  cp_commit();

  // Δ and lse of this thread's rows g and g+8 (its quad sums each row's Δ
  // over 16-byte chunks while the copies above are in flight)
  float dl[2], l2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + r0 + g + 8 * i;
    const bool in = qpos < Sq;
    float sum = 0.f;
#pragma unroll
    for (int it = 0; it < (D / 8 + 3) / 4; ++it) {
      const int c = t + 4 * it;
      if (in && c < D / 8) {
        const size_t off = qoff + (size_t)qpos * D + c * 8;
        sum = dot8(*reinterpret_cast<const uint4*>(o + off),
                   *reinterpret_cast<const uint4*>(dout + off), sum);
      }
    }
    dl[i] = quad_sum(sum);
    l2[i] = in ? lse[(size_t)bh * Sq + qpos] * LOG2E : 0.f;
    if (in && t == 0) delta[(size_t)bh * Sq + qpos] = dl[i];
  }

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int j = 0; j < nk; ++j) {
    if (j + 1 < nk) {   // next tile's copies overlap this tile's products
      load_tile<BK, DP, D, NT>(stage(j + 1), kb, (j + 1) * BK, Sk);
      load_tile<BK, DP, D, NT>(stage(j + 1) + KBYTES, vb, (j + 1) * BK, Sk);
    }
    cp_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = stage(j), sV = sK + KBYTES;

    // S = Q·Kᵀ and dP = dO·Vᵀ: rows q, columns k
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
    wgmma_fence();   // this warpgroup's 64 q rows; all operands in smem
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {   // past D the columns are zero
      wgmma_ss<BK>(s, desc_k<BQ>(sQ, 0, kk), desc_k<BK>(sK, 0, kk), 1);
      wgmma_ss<BK>(dp, desc_k<BQ>(sdO, 0, kk), desc_k<BK>(sV, 0, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P, then dS (in dp), per row: lse and Δ of rows g, g+8
    const int k0 = j * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(s[nt][e] * scale_log2 - l2[e >> 1]);
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = q0 + r0 + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) p = 0.f;
        }
        dp[nt][e] = p * (dp[nt][e] - dl[e >> 1]) * scale;
      }
    }
    uint32_t dsa[BK / 16][4];   // dS in K's type, as the A operand of dS·K
    c_to_a<BK / 16>(dsa, dp);

    wgmma_fence();   // K read as stored, [k][d]: an MN-major B
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, dsa[kk], desc_mn<BK>(sK, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // the stage is refilled by the next iteration
  }

  // dQ in bf16, staged through this warp's own rows of the Q tile (every
  // read of it is done: the loop ends on a barrier after the last
  // products) so that the global stores are whole rows
  unsigned char* sQp = smem;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      *reinterpret_cast<uint32_t*>(sQp + swz<BQ>(r, nt) + 4 * t) =
          pack_bf16(acc[nt][2 * i], acc[nt][2 * i + 1]);
    }
  }
  __syncwarp();
  bf16* dqb = dq + qoff + (size_t)q0 * D;
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = r0 + idx / (D / 8), c = idx % (D / 8);
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(dqb + (size_t)r * D + c * 8) =
          *reinterpret_cast<const uint4*>(sQp + swz<BQ>(r, c));
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* delta,
                int B, int H, int Hkv, int Sq, int Sk, float scale,
                int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_bf16_smem<padded_dim(D)>();
  auto kern = flash_bwd_dq_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + DQ_BQ - 1) / DQ_BQ);
  kern<<<grid, DQ_BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(o),
      static_cast<const float*>(lse), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<float*>(delta), H, Hkv, Sq, Sk,
      scale, scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---- f32: the first design ------------------------------------------------
size_t dq_f32_smem(int D) {
  constexpr int BQ = Tiles<float>::BQ, BK = Tiles<float>::BK;
  constexpr int P = Tiles<float>::PAD;
  return 2 * region(BQ * (D + P) * sizeof(float)) +
         2 * region(BK * (D + P) * sizeof(float)) +
         3 * region(BQ * (BK + FPAD) * sizeof(float)) +
         region(BQ * (D + FPAD) * sizeof(float)) +
         2 * region(BQ * sizeof(float));
}

template <int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int H, int Hkv, int Sq, int Sk, int D, float scale,
                        int causal) {
  constexpr int lds = BK + FPAD;
  const int ldt = D + Tiles<float>::PAD, ldf = D + FPAD;
  extern __shared__ __align__(1024) unsigned char smem[];
  Carver cv{smem};
  float* sQ = cv.take<float>(BQ * ldt);
  float* sdO = cv.take<float>(BQ * ldt);
  float* sK = cv.take<float>(BK * ldt);
  float* sV = cv.take<float>(BK * ldt);
  float* sS = cv.take<float>(BQ * lds);
  float* sdP = cv.take<float>(BQ * lds);
  float* sdS = cv.take<float>(BQ * lds);
  float* sAcc = cv.take<float>(BQ * ldf);
  float* sLse = cv.take<float>(BQ);
  float* sDelta = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const size_t qoff = (size_t)bh * Sq * D;
  const float* kb = k + (size_t)kvr * Sk * D;
  const float* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(sQ, ldt, q + qoff, q0, Sq, BQ, D);
  load_rows(sdO, ldt, dout + qoff, q0, Sq, BQ, D);
  for (int i = threadIdx.x; i < BQ * ldf; i += NTHREADS) sAcc[i] = 0.f;
  // Δ = rowsum(dO∘O) in f32, one warp per row
  for (int r = warp; r < BQ; r += NWARPS) {
    const int qpos = q0 + r;
    float d = 0.f;
    if (qpos < Sq) {
      const float* orow = o + qoff + (size_t)qpos * D;
      const float* drow = dout + qoff + (size_t)qpos * D;
      for (int c = lane; c < D; c += 32) d += drow[c] * orow[c];
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
      sdS[r * lds + j] = p * (sdP[r * lds + j] - sDelta[r]) * scale;
    }
    __syncthreads();
    mm<false, false>(sdS, lds, sK, ldt, sAcc, ldf, BQ, D, BK, true);  // dS·K
    __syncthreads();
  }

  for (int idx = threadIdx.x; idx < BQ * D; idx += NTHREADS) {
    const int r = idx / D, c = idx - r * D;
    if (q0 + r < Sq) dq[qoff + (size_t)q0 * D + idx] = sAcc[r * ldf + c];
  }
}

int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* delta,
               int B, int H, int Hkv, int Sq, int Sk, int D, float scale,
               int causal, cudaStream_t stream) {
  constexpr int BQ = Tiles<float>::BQ, BK = Tiles<float>::BK;
  const size_t smem = dq_f32_smem(D);
  auto kern = flash_bwd_dq_f32_kernel<BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(delta), H, Hkv, Sq, Sk,
      D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16;
// D a multiple of 16 up to 128.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* delta, int B, int H, int Hkv,
                            int Sq, int Sk, int D, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa::launch_f32(q, k, v, o, lse, dout, dq, delta, B, H, Hkv, Sq,
                          Sk, D, scale, causal, s);
  switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_bf16<d>(q, k, v, o, lse, dout, dq, delta, B, H, Hkv,  \
                              Sq, Sk, scale, causal, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_bwd_dq_smem_bytes(int D, int dtype) {
  if (dtype == 0) return (int)fa::dq_f32_smem(D);
  return fa::padded_dim(D) == 64 ? (int)fa::dq_bf16_smem<64>()
                                 : (int)fa::dq_bf16_smem<128>();
}
