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
// 101 MB (30 µs): operation-bound.
//
// bf16 design (D any multiple of 16 up to 128, held in tiles of DP = 64 or
// 128 columns whose columns past D are zero), in the transposed form: one
// warpgroup per (b·h_kv, 64-row k tile), heaviest k tiles (the first,
// under a causal mask) first.  It owns the 64 k rows (each warp 16), so k
// is the row dimension of every product and every sum stays in registers:
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ (K and V resident in shared memory for the
// whole block, Q and dO K-major B operands), Pᵀ = exp(Sᵀ·scale − lse[col])
// and dSᵀ = Pᵀ∘(dPᵀ − Δ[col])·scale in registers, then dV += Pᵀ·dO and
// dK += dSᵀ·Q with Pᵀ and dSᵀ, rounded to bf16, as register A operands and
// dO and Q read as stored ([q][d], MN-major B operands); all four products
// are warpgroup wgmma m64nNk16 with f32 sums (flash_sm90.cuh).  The block
// loops over the H/H_kv q heads of its KV head and their q tiles, so the
// group sum happens in f32 inside the block: no atomics, no per-head
// buffer.  64-row Q, dO, lse and Δ tiles go through a two-stage ring of
// 128-byte-swizzled shared memory filled by cp.async, the next q tile's
// copies in flight during the current one's products.  Only tiles that
// cross the causal diagonal or a ragged end evaluate the mask; q tiles
// wholly above the diagonal are skipped.  Registers are the limit: dK and
// dV take 128 a thread at D 128, Sᵀ and dPᵀ 64 (248 in all, no spills).
// The tiles, 64 × 64, won a measured sweep of 64/128 k rows × 32/64 q rows
// at the training shape (PERF.md).
//
// f32 design (the text transformer's build; built per head dim, D any
// multiple of 16 up to 128): one block of four warps per (b·h_kv, 32-row k
// tile), K and V resident in shared memory.  The block loops over the
// H/H_kv q heads of its KV head and their 32-row q tiles (the group sum in
// f32 in the block, no atomics); Q, dO, lse and Δ of step it + 1 are in
// flight (cp.async, two stages) during step it.  Per step each warp forms
// its 16 x 16 tile of S = Q·Kᵀ and dP = dO·Vᵀ in registers, P and dS there
// too, and writes P and dS to shared memory; then dV += Pᵀ·dO and dK +=
// dSᵀ·Q into register accumulators that live over all steps (dK and dV
// are written once).  Pᵀ and dSᵀ are read from P and dS as stored, by
// index.  Two block barriers a step.  The products run on the tensor cores
// as warp-level mma.sync m16n8k8 in 3xTF32 (f32-accurate; flash_tf32.cuh);
// every fragment load is free of bank conflicts at the row strides chosen
// (all an odd multiple of 4 floats; P's and dS's float2 stores conflict
// 2-way, once a step).  Bound at the text shape (B 80, H 8, S 128, D 32,
// full): 2.7 GFLOP at 165 TFLOP/s (495 TF32 over three passes) is 16 µs,
// under the 64 MB it must move (19 µs), so bytes set the least time.  What
// holds it back is instruction issue, as in K2: the split into hi and lo,
// fragment loads and addresses at 32-row tiles, and latency with ~4 blocks
// an SM (125 registers a thread at D 32).
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace fa {

constexpr int DKV_BK = 64, DKV_BQ = 64;

// K and V, then two stages of (Q, dO, lse, Δ), each stage 1024-aligned
template <int DP>
__host__ __device__ constexpr size_t dkv_stage_bytes() {
  return (2 * size_t(DKV_BQ) * DP * 2 + 2 * DKV_BQ * 4 + 1023) & ~size_t(1023);
}
template <int DP>
__host__ __device__ constexpr size_t dkv_bf16_smem() {
  return 2 * size_t(DKV_BK) * DP * 2 + 2 * dkv_stage_bytes<DP>();
}

template <int D>
__global__ void __launch_bounds__(DKV_BK * 2)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const bf16* __restrict__ dout, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, float* __restrict__ dk32,
                          float* __restrict__ dv32, int H, int Hkv, int Sq,
                          int Sk, float scale, float scale_log2, int causal) {
  using namespace sm90;
  constexpr int BK = DKV_BK, BQ = DKV_BQ, NT = BK * 2, DP = padded_dim(D);
  constexpr int KBYTES = BK * DP * 2, QBYTES = BQ * DP * 2;
  constexpr int STAGE = (int)dkv_stage_bytes<DP>();
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sK = smem_u32(smem), sV = sK + KBYTES;
  // stage j: Q, dO, lse, Δ
  auto stage = [&](int j) { return sK + 2 * KBYTES + (j & 1) * STAGE; };

  const int kvr = blockIdx.x, k0 = blockIdx.y * BK;
  const int b = kvr / Hkv, hk = kvr % Hkv, rep = H / Hkv;
  const size_t koff = (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qi0 = causal ? min(k0 / BQ, nq) : 0;   // first q tile seeing k0
  const int per_head = nq - qi0, ntiles = rep * per_head;

  // (head g_, q tile qi) of the it-th step: g_ = it / per_head
  auto load_step = [&](int it) {
    const int bh = b * H + hk * rep + it / per_head;
    const int q0 = (qi0 + it % per_head) * BQ;
    const size_t qoff = (size_t)bh * Sq * D;
    const uint32_t st = stage(it);
    load_tile<BQ, DP, D, NT>(st, q + qoff, q0, Sq);
    load_tile<BQ, DP, D, NT>(st + QBYTES, dout + qoff, q0, Sq);
    load_row<NT>(st + 2 * QBYTES, lse + (size_t)bh * Sq, q0, Sq, BQ);
    load_row<NT>(st + 2 * QBYTES + 4 * BQ, delta + (size_t)bh * Sq, q0, Sq,
                 BQ);
  };
  load_tile<BK, DP, D, NT>(sK, k + koff, k0, Sk);
  load_tile<BK, DP, D, NT>(sV, v + koff, k0, Sk);
  if (ntiles > 0) load_step(0);
  cp_commit();

  float dka[DP / 8][4], dva[DP / 8][4];
#pragma unroll
  for (int i = 0; i < DP / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[i][e] = dva[i][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    if (it + 1 < ntiles) load_step(it + 1);   // in flight during this step
    cp_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int q0 = (qi0 + it % per_head) * BQ;
    const uint32_t sQ = stage(it), sdO = sQ + QBYTES;
    const float* sL = reinterpret_cast<const float*>(
        smem + (sQ - sK) + 2 * QBYTES);
    const float* sD = sL + BQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: rows k, columns q
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int i = 0; i < BQ / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[i][e] = dpt[i][e] = 0.f;
    wgmma_fence();   // this warpgroup's 64 k rows; all operands in smem
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {   // past D the columns are zero
      wgmma_ss<BQ>(st, desc_k<BK>(sK, r0 & ~63, kk), desc_k<BQ>(sQ, 0, kk),
                   1);
      wgmma_ss<BQ>(dpt, desc_k<BK>(sV, r0 & ~63, kk), desc_k<BQ>(sdO, 0, kk),
                   1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // Pᵀ (in st) and dSᵀ (in dpt), per column q: lse[q], Δ[q]
    const bool edge = q0 + BQ > Sq || k0 + BK > Sk ||
                      (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int nt = 0; nt < BQ / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = nt * 8 + 2 * t + c;
        const float l2 = sL[col] * LOG2E, dl = sD[col];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int e = 2 * h + c;
          float p = ex2(st[nt][e] * scale_log2 - l2);
          if (edge) {
            const int kpos = k0 + r0 + g + 8 * h, qpos = q0 + col;
            if (kpos >= Sk || qpos >= Sq || (causal && kpos > qpos)) p = 0.f;
          }
          st[nt][e] = p;
          dpt[nt][e] = p * (dpt[nt][e] - dl) * scale;
        }
      }
    }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    c_to_a<BQ / 16>(pa, st);
    c_to_a<BQ / 16>(dsa, dpt);

    // dV += Pᵀ·dO, dK += dSᵀ·Q: dO and Q read as stored, [q][d], as
    // MN-major B operands
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<DP>(dva, pa[kk], desc_mn<BQ>(sdO, kk), 1);
      wgmma_rs<DP>(dka, dsa[kk], desc_mn<BQ>(sQ, kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dva);
    fence_regs(dka);
    __syncthreads();   // the stage is refilled by the next step
  }
  cp_async_wait<0>();   // with no q tile at all, K/V copies may still be pending
  __syncthreads();

  if (dk32 != nullptr) {
    // dK, dV in f32 (ring attention's partial gradients), each thread its
    // fragment's pairs of columns
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + g + 8 * h;
        if (k0 + r < Sk) {
          const size_t off = koff + (size_t)(k0 + r) * D + 8 * nt + 2 * t;
          *reinterpret_cast<float2*>(dk32 + off) =
              make_float2(dka[nt][2 * h], dka[nt][2 * h + 1]);
          *reinterpret_cast<float2*>(dv32 + off) =
              make_float2(dva[nt][2 * h], dva[nt][2 * h + 1]);
        }
      }
    }
    return;
  }
  // dK, dV in bf16, staged through this warp's own rows of the K and V
  // tiles (every read of them is done) so that the global stores are whole
  // rows
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + g + 8 * h;
      *reinterpret_cast<uint32_t*>(smem + swz<BK>(r, nt) + 4 * t) =
          pack_bf16(dka[nt][2 * h], dka[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(smem + KBYTES + swz<BK>(r, nt) + 4 * t) =
          pack_bf16(dva[nt][2 * h], dva[nt][2 * h + 1]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < 16 * (D / 8) / 32; ++i) {
    const int idx = i * 32 + lane;
    const int r = r0 + idx / (D / 8), c = idx % (D / 8);
    if (k0 + r < Sk) {
      const size_t off = koff + (size_t)(k0 + r) * D + c * 8;
      *reinterpret_cast<uint4*>(dk + off) =
          *reinterpret_cast<const uint4*>(smem + swz<BK>(r, c));
      *reinterpret_cast<uint4*>(dv + off) =
          *reinterpret_cast<const uint4*>(smem + KBYTES + swz<BK>(r, c));
    }
  }
}

// out_f32: dK and dV written in f32 (float buffers), not bf16
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* lse,
                const void* delta, const void* dout, void* dk, void* dv, int B,
                int H, int Hkv, int Sq, int Sk, float scale, int causal,
                bool out_f32, cudaStream_t stream) {
  constexpr size_t smem = dkv_bf16_smem<padded_dim(D)>();
  auto kern = flash_bwd_dkv_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * Hkv, (Sk + DKV_BK - 1) / DKV_BK);
  kern<<<grid, DKV_BK * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      out_f32 ? static_cast<float*>(dk) : nullptr,
      out_f32 ? static_cast<float*>(dv) : nullptr, H, Hkv, Sq, Sk, scale,
      scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 products on 32-row tiles --------------------------------
constexpr int F32_BQ = Tiles<float>::BQ, F32_BK = Tiles<float>::BK;

// K, V (rows D + PAD4), two stages of (Q, dO (D + PAD4), lse, Δ), then P
// and dS (BK + PAD4)
template <int D>
__host__ __device__ constexpr size_t dkv_f32_stage() {
  return 2 * region(F32_BQ * (D + PAD4) * sizeof(float)) +
         2 * region(F32_BQ * sizeof(float));
}
template <int D>
__host__ __device__ constexpr size_t dkv_f32_smem() {
  return 2 * region(F32_BK * (D + PAD4) * sizeof(float)) +
         2 * dkv_f32_stage<D>() +
         2 * region(F32_BQ * (F32_BK + PAD4) * sizeof(float));
}

// Starts dst[i] = src[row0 + i] for i < rows as 4-byte cp.async copies,
// zero-filled where row0 + i >= nrows, and commits them.
__device__ __forceinline__ void load_floats(float* dst,
                                            const float* __restrict__ src,
                                            int row0, int nrows, int rows) {
  for (int i = threadIdx.x; i < rows; i += NTHREADS) {
    const bool in = row0 + i < nrows;
    __pipeline_memcpy_async(dst + i, in ? src + row0 + i : src, 4,
                            in ? 0 : 4);
  }
  __pipeline_commit();
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Hkv, int Sq, int Sk, float scale,
                         int causal) {
  constexpr int BQ = F32_BQ, BK = F32_BK;
  constexpr int ldt = D + PAD4, ldp = BK + PAD4;
  constexpr int TN = D / 16, NT = (BK / 16) * TN;   // dK's, dV's 16 x 16
  constexpr int WT = (NT + NWARPS - 1) / NWARPS;     // tiles; a warp's
  static_assert((BQ / 16) * (BK / 16) == NWARPS,
                "one 16 x 16 tile of S and dP a warp");
  constexpr size_t KB = region(BK * ldt * 4), QB = region(BQ * ldt * 4);
  constexpr size_t STAGE = dkv_f32_stage<D>();
  extern __shared__ __align__(1024) unsigned char smem[];
  float* const sK = reinterpret_cast<float*>(smem);
  float* const sV = reinterpret_cast<float*>(smem + KB);
  // stage st: Q, dO, lse, Δ
  auto sQ = [&](int st) {
    return reinterpret_cast<float*>(smem + 2 * KB + st * STAGE);
  };
  auto sdO = [&](int st) {
    return reinterpret_cast<float*>(smem + 2 * KB + st * STAGE + QB);
  };
  auto sLse = [&](int st) {
    return reinterpret_cast<float*>(smem + 2 * KB + st * STAGE + 2 * QB);
  };
  float* const sP = reinterpret_cast<float*>(smem + 2 * KB + 2 * STAGE);
  float* const sdS = sP + region(BQ * ldp * 4) / 4;

  const int kvr = blockIdx.y, k0 = blockIdx.x * BK;
  const int b = kvr / Hkv, hk = kvr % Hkv, rep = H / Hkv;
  const size_t koff = (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tile of S and dP: rows (q) sm0.., columns (k) sn0..
  const int sm0 = warp / (BK / 16) * 16, sn0 = warp % (BK / 16) * 16;
  const int nq = (Sq + BQ - 1) / BQ;
  const int qi0 = causal ? min(k0 / BQ, nq) : 0;   // first q tile seeing k0
  const int per_head = nq - qi0, nsteps = rep * per_head;

  // step it: q head b·H + hk·rep + it / per_head, q tile qi0 + it % per_head
  auto load_step = [&](int it) {
    const int bh = b * H + hk * rep + it / per_head;
    const int q0 = (qi0 + it % per_head) * BQ, st = it & 1;
    const size_t qoff = (size_t)bh * Sq * D;
    load_rows(sQ(st), ldt, q + qoff, q0, Sq, BQ, D);
    load_rows(sdO(st), ldt, dout + qoff, q0, Sq, BQ, D);
    load_floats(sLse(st), lse + (size_t)bh * Sq, q0, Sq, BQ);
    load_floats(sLse(st) + BQ, delta + (size_t)bh * Sq, q0, Sq, BQ);
  };
  load_rows(sK, ldt, k + koff, k0, Sk, BK, D);
  load_rows(sV, ldt, v + koff, k0, Sk, BK, D);
  if (nsteps > 0) load_step(0);

  float dka[WT][2][4], dva[WT][2][4];   // this warp's dK, dV tiles
#pragma unroll
  for (int i = 0; i < WT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dka[i][e / 4][e % 4] = dva[i][e / 4][e % 4] = 0.f;

  for (int it = 0; it < nsteps; ++it) {
    const int st = it & 1, q0 = (qi0 + it % per_head) * BQ;
    cp_wait();
    // every warp is done with the last step: its stage, P and dS are free
    __syncthreads();
    if (it + 1 < nsteps) load_step(it + 1);   // in flight during this step
    // S = Q·Kᵀ and dP = dO·Vᵀ on this warp's tile (rows q, columns k), in
    // registers; P and dS there too, then to shared memory, where dV and
    // dK read them transposed
    float s[2][4] = {}, dp[2][4] = {};
    mma_tile<false, true, D>(sQ(st), ldt, sK, ldt, sm0, sn0, s);
    mma_tile<false, true, D>(sdO(st), ldt, sV, ldt, sm0, sn0, dp);
    const float* sL = sLse(st);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm0 + g + 8 * h, qpos = q0 + r;
      const float l = sL[r], dl = sL[BQ + r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + sn0 + 8 * j + 2 * t + e;
          const bool ok =
              kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
          p[e] = ok ? expf(s[j][2 * h + e] * scale - l) : 0.f;
          ds[e] = p[e] * (dp[j][2 * h + e] - dl) * scale;
        }
        const int off = r * ldp + sn0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(sP + off) = make_float2(p[0], p[1]);
        *reinterpret_cast<float2*>(sdS + off) = make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WT; ++i) {   // dV += Pᵀ·dO, dK += dSᵀ·Q
      const int w = warp + NWARPS * i;
      if (w < NT) {
        const int m0 = w / TN * 16, n0 = w % TN * 16;
        mma_tile<true, false, BQ>(sP, ldp, sdO(st), ldt, m0, n0, dva[i]);
        mma_tile<true, false, BQ>(sdS, ldp, sQ(st), ldt, m0, n0, dka[i]);
      }
    }
  }
  cp_wait();   // with no step at all, the K/V copies may still be pending

#pragma unroll
  for (int i = 0; i < WT; ++i) {
    const int w = warp + NWARPS * i;
    if (w >= NT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w / TN * 16 + g + 8 * h;
      if (k0 + r >= Sk) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const size_t off =
            koff + (size_t)(k0 + r) * D + w % TN * 16 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(dk + off) =
            make_float2(dka[i][j][2 * h], dka[i][j][2 * h + 1]);
        *reinterpret_cast<float2*>(dv + off) =
            make_float2(dva[i][j][2 * h], dva[i][j][2 * h + 1]);
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* lse,
               const void* delta, const void* dout, void* dk, void* dv, int B,
               int H, int Hkv, int Sq, int Sk, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_f32_smem<D>();
  auto kern = flash_bwd_dkv_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sk + F32_BK - 1) / F32_BK, B * Hkv);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(dout),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Hkv, Sq, Sk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16,
// 2 = bf16 inputs with dK and dV written in f32; D a multiple of 16 up to
// 128.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* lse, const void* delta,
                             const void* dout, void* dk, void* dv, int B,
                             int H, int Hkv, int Sq, int Sk, int D,
                             float scale, int causal, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_f32<d>(q, k, v, lse, delta, dout, dk, dv, B, H, Hkv,  \
                             Sq, Sk, scale, causal, s);
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_bf16<d>(q, k, v, lse, delta, dout, dk, dv, B, H, Hkv, \
                              Sq, Sk, scale, causal, dtype == 2, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_bwd_dkv_smem_bytes(int D, int dtype) {
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d) \
  case d:          \
    return (int)fa::dkv_f32_smem<d>();
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return 0;
  }
  return fa::padded_dim(D) == 64 ? (int)fa::dkv_bf16_smem<64>()
                                 : (int)fa::dkv_bf16_smem<128>();
}
