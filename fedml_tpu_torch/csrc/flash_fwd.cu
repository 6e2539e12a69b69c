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
//
// bf16 design (D any multiple of 16 up to 128, held in tiles of DP = 64 or
// 128 columns whose columns past D are zero): one warpgroup per (b·h,
// 64-row q tile), q tiles with the most KV tiles first.  It owns the 64 q
// rows (each warp 16) and keeps the S tile, the running max and sum and
// the f32 O accumulator in registers; rows are reduced with quad shuffles,
// and P, rounded to bf16, is P·V's A operand in registers
// (flash_sm90.cuh).  Both products are warpgroup wgmma m64nNk16 with f32
// sums: S = Q·Kᵀ reads Q and K from shared memory (K-major), O += P·V reads
// V as stored, [k][d] (an MN-major B).  64-row K/V tiles go through a
// two-stage ring of 128-byte-swizzled shared memory filled by 16-byte
// cp.async: tile j+1 is in flight while tile j's products run.  Only tiles
// that cross the causal diagonal or the ragged end evaluate the mask; tiles
// wholly above the diagonal are never visited.  Softmax exponentials are
// ex2 of s·scale·log2 e; lse is written in natural-log units.  The tiles,
// 64 × 64, won a measured sweep of 64/128 × 64/128 at the training shape
// (PERF.md).
//
// f32 (the text transformer's build) keeps the first design: Q, the K/V
// tile, S and the accumulator in shared memory, products as FMA loops
// (flash_common.cuh::mm), bound by shared-memory bandwidth at ~4 TFLOP/s.
// K2 and K3 have moved their f32 products to the tensor cores
// (flash_tf32.cuh::mm_tf32x3); this kernel's two mm calls are next.
#include "flash_sm90.cuh"

namespace fa {

constexpr int FWD_BQ = 64, FWD_BK = 64;

template <int DP>
__host__ __device__ constexpr size_t fwd_bf16_smem() {
  return size_t(FWD_BQ) * DP * 2 + 2 * 2 * size_t(FWD_BK) * DP * 2;
}

template <int D>
__global__ void __launch_bounds__(FWD_BQ * 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                      float scale_log2, int causal) {
  using namespace sm90;
  constexpr int BQ = FWD_BQ, BK = FWD_BK, NT = BQ * 2, DP = padded_dim(D);
  constexpr int QBYTES = BQ * DP * 2, KBYTES = BK * DP * 2;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sQ = smem_u32(smem);
  auto stage = [&](int j) { return sQ + QBYTES + (j & 1) * 2 * KBYTES; };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const bf16* kb = k + (size_t)kvr * Sk * D;
  const bf16* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int nk_all = (Sk + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_tile<BQ, DP, D, NT>(sQ, q + (size_t)bh * Sq * D, q0, Sq);
  load_tile<BK, DP, D, NT>(stage(0), kb, 0, Sk);
  load_tile<BK, DP, D, NT>(stage(0) + KBYTES, vb, 0, Sk);
  cp_commit();

  float acc[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

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

    float s[BK / 8][4];   // S = Q·Kᵀ
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
    wgmma_fence();   // this warpgroup's 64 q rows; Q and K in smem
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)   // past D the columns are zero
      wgmma_ss<BK>(s, desc_k<BQ>(sQ, r0 & ~63, kk), desc_k<BK>(sK, 0, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // online softmax in log2 units; the mask only where the tile needs it
    const int k0 = j * BK;
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > q0);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
          const int qpos = q0 + r0 + g + 8 * (e >> 1);
          if (kpos >= Sk || (causal && kpos > qpos)) x = NEG_INF;
        }
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = ex2(m[i] - mx[i]);
      m[i] = mx[i];
    }
#pragma unroll
    for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[nt][e] - m[e >> 1]);
        s[nt][e] = p;
        sum[e >> 1] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
#pragma unroll
    for (int nt = 0; nt < DP / 8; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }

    uint32_t pa[BK / 16][4];   // P in V's type, as the A operand of P·V
    c_to_a<BK / 16>(pa, s);
    wgmma_fence();   // V read as stored, [k][d]: an MN-major B
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<DP>(acc, pa[kk], desc_mn<BK>(sV, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // the stage is refilled by the next iteration
  }

  // O = acc / l in bf16, staged through this warp's own rows of the Q tile
  // (every read of it is done) so that the global stores are whole rows
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(quad_sum(l[i]), 1e-30f);
  unsigned char* sQp = smem;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      *reinterpret_cast<uint32_t*>(sQp + swz<BQ>(r, nt) + 4 * t) =
          pack_bf16(acc[nt][2 * i] / l[i], acc[nt][2 * i + 1] / l[i]);
    }
  }
  __syncwarp();
  bf16* ob = o + ((size_t)bh * Sq + q0) * D;
#pragma unroll
  for (int it = 0; it < 16 * (D / 8) / 32; ++it) {
    const int idx = it * 32 + lane;
    const int r = r0 + idx / (D / 8), c = idx % (D / 8);
    if (q0 + r < Sq)
      *reinterpret_cast<uint4*>(ob + (size_t)r * D + c * 8) =
          *reinterpret_cast<const uint4*>(sQp + swz<BQ>(r, c));
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + g + 8 * i;
      if (qpos < Sq) lse[(size_t)bh * Sq + qpos] = m[i] * LN2 + logf(l[i]);
    }
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
                int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem<padded_dim(D)>();
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + FWD_BQ - 1) / FWD_BQ);
  kern<<<grid, FWD_BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---- f32: the first design ------------------------------------------------
size_t fwd_f32_smem(int D) {
  constexpr int BQ = Tiles<float>::BQ, BK = Tiles<float>::BK;
  constexpr int P = Tiles<float>::PAD;
  return region(BQ * (D + P) * sizeof(float)) +
         2 * region(BK * (D + P) * sizeof(float)) +
         region(BQ * (BK + FPAD) * sizeof(float)) +
         region(BQ * (BK + P) * sizeof(float)) +
         region(BQ * (D + FPAD) * sizeof(float)) +
         2 * region(BQ * sizeof(float));
}

template <int BQ, int BK>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     int D, float scale, int causal) {
  constexpr int lds = BK + FPAD, ldp = BK + Tiles<float>::PAD;
  const int ldt = D + Tiles<float>::PAD, ldf = D + FPAD;
  extern __shared__ __align__(1024) unsigned char smem[];
  Carver cv{smem};
  float* sQ = cv.take<float>(BQ * ldt);
  float* sK = cv.take<float>(BK * ldt);
  float* sV = cv.take<float>(BK * ldt);
  float* sS = cv.take<float>(BQ * lds);
  float* sP = cv.take<float>(BQ * ldp);
  float* sAcc = cv.take<float>(BQ * ldf);
  float* sM = cv.take<float>(BQ);
  float* sL = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const float* qb = q + (size_t)bh * Sq * D;
  const float* kb = k + (size_t)kvr * Sk * D;
  const float* vb = v + (size_t)kvr * Sk * D;
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
        sP[r * ldp + j] = p;
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
    float* orow = o + ((size_t)bh * Sq + qpos) * D;
    for (int c = lane; c < D; c += 32) orow[c] = sAcc[r * ldf + c] / l_safe;
    if (lane == 0) lse[(size_t)bh * Sq + qpos] = sM[r] + logf(l_safe);
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int D,
               float scale, int causal, cudaStream_t stream) {
  constexpr int BQ = Tiles<float>::BQ, BK = Tiles<float>::BK;
  const size_t smem = fwd_f32_smem(D);
  auto kern = flash_fwd_f32_kernel<BQ, BK>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16;
// D a multiple of 16 up to 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Hkv, int Sq, int Sk,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fa::launch_f32(q, k, v, o, lse, B, H, Hkv, Sq, Sk, D, scale,
                          causal, s);
  switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_bf16<d>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale,    \
                              causal, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 0) return (int)fa::fwd_f32_smem(D);
  return fa::padded_dim(D) == 64 ? (int)fa::fwd_bf16_smem<64>()
                                 : (int)fa::fwd_bf16_smem<128>();
}
