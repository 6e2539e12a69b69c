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
// f32 design (the text transformer's build; built per head dim, D any
// multiple of 16 up to 128): one block of four warps per (b·h, 32-row q
// tile).  Q and dO stay in shared memory; 32-row K/V tiles go through two
// stages filled by cp.async, tile j+1 in flight during tile j's work.  Per
// KV tile each warp forms its 16 x 16 tile of S = Q·Kᵀ and dP = dO·Vᵀ in
// registers, P and dS there too (Δ summed in f32 up front, as in bf16),
// and writes dS to shared memory; then dQ += dS·K into register
// accumulators that live over the whole key loop (dQ is written once).
// Two block barriers a tile.  The products run on the tensor cores as
// warp-level mma.sync m16n8k8 in 3xTF32 (f32-accurate; flash_tf32.cuh)
// from row strides that leave every fragment load free of bank conflicts
// (dS's rows an odd multiple of 8 floats, Q's, dO's, K's and V's of 4).
// Bound at the text shape (B 80, H 8, S 128, D 32, full): 2.0 GFLOP at 165
// TFLOP/s (495 TF32 over three passes) is 12 µs, under the 64 MB it must
// move (19 µs), so bytes set the least time.  What holds it back is
// instruction issue, not the tensor cores: per mma the split into hi and
// lo, the fragment loads and their addresses, at 32-row tiles (4 warps, a
// 16 x 16 tile each) that reuse each fragment little, and latency with
// ~4 blocks an SM (125 registers a thread at D 32).
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

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
                         bf16* __restrict__ dq, float* __restrict__ dq32,
                         float* __restrict__ delta, int H, int Hkv, int Sq,
                         int Sk, float scale, float scale_log2, int causal) {
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

  if (dq32 != nullptr) {
    // dQ in f32 (ring attention's partial gradients), each thread its
    // fragment's pairs of columns
    float* dqb = dq32 + qoff + (size_t)q0 * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i;
        if (q0 + r < Sq)
          *reinterpret_cast<float2*>(dqb + (size_t)r * D + 8 * nt + 2 * t) =
              make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
      }
    }
    return;
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

// out_f32: dQ written in f32 (``dq`` a float buffer), not bf16
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* lse, const void* dout, void* dq, void* delta,
                int B, int H, int Hkv, int Sq, int Sk, float scale,
                int causal, bool out_f32, cudaStream_t stream) {
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
      static_cast<bf16*>(dq), out_f32 ? static_cast<float*>(dq) : nullptr,
      static_cast<float*>(delta), H, Hkv, Sq, Sk, scale,
      scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 products on 32-row tiles --------------------------------
constexpr int F32_BQ = Tiles<float>::BQ, F32_BK = Tiles<float>::BK;

// Q, dO (rows D + PAD4), two stages of (K, V) (D + PAD4), dS (BK + PAD8),
// lse and Δ
template <int D>
__host__ __device__ constexpr size_t dq_f32_smem() {
  return 2 * region(F32_BQ * (D + PAD4) * sizeof(float)) +
         4 * region(F32_BK * (D + PAD4) * sizeof(float)) +
         region(F32_BQ * (F32_BK + PAD8) * sizeof(float)) +
         2 * region(F32_BQ * sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ o,
                        const float* __restrict__ lse,
                        const float* __restrict__ dout,
                        float* __restrict__ dq, float* __restrict__ delta,
                        int H, int Hkv, int Sq, int Sk, float scale,
                        int causal) {
  constexpr int BQ = F32_BQ, BK = F32_BK, RPW = BQ / NWARPS;
  constexpr int ldt = D + PAD4, lds = BK + PAD8;
  constexpr int TN = D / 16, NT = (BQ / 16) * TN;   // dQ's 16 x 16 tiles
  constexpr int WT = (NT + NWARPS - 1) / NWARPS;     // ... a warp's
  static_assert((BQ / 16) * (BK / 16) == NWARPS,
                "one 16 x 16 tile of S and dP a warp");
  constexpr size_t QB = region(BQ * ldt * 4), KB = region(BK * ldt * 4);
  extern __shared__ __align__(1024) unsigned char smem[];
  float* const sQ = reinterpret_cast<float*>(smem);
  float* const sdO = reinterpret_cast<float*>(smem + QB);
  auto sK = [&](int st) {
    return reinterpret_cast<float*>(smem + 2 * QB + st * 2 * KB);
  };
  auto sV = [&](int st) {
    return reinterpret_cast<float*>(smem + 2 * QB + st * 2 * KB + KB);
  };
  float* const sdS = reinterpret_cast<float*>(smem + 2 * QB + 4 * KB);
  float* const sLse = reinterpret_cast<float*>(
      smem + 2 * QB + 4 * KB + region(BQ * lds * 4));
  float* const sDelta = sLse + BQ;

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const size_t qoff = (size_t)bh * Sq * D;
  const float* kb = k + (size_t)kvr * Sk * D;
  const float* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  // this warp's tile of S and dP: rows sm0.., columns sn0..
  const int sm0 = warp / (BK / 16) * 16, sn0 = warp % (BK / 16) * 16;
  const int nk_all = (Sk + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_rows(sQ, ldt, q + qoff, q0, Sq, BQ, D);
  load_rows(sdO, ldt, dout + qoff, q0, Sq, BQ, D);
  load_rows(sK(0), ldt, kb, 0, Sk, BK, D);
  load_rows(sV(0), ldt, vb, 0, Sk, BK, D);
  // Δ = rowsum(dO∘O) in f32, one warp per row: rows warp + 4i, every
  // row's loads in flight before the first reduction
  float dsum[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int qpos = q0 + warp + NWARPS * i;
    dsum[i] = 0.f;
    if (qpos < Sq) {
      const float* orow = o + qoff + (size_t)qpos * D;
      const float* drow = dout + qoff + (size_t)qpos * D;
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += 32)
        if (c0 + lane < D) dsum[i] += drow[c0 + lane] * orow[c0 + lane];
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = warp + NWARPS * i, qpos = q0 + r;
    const float d = warp_sum(dsum[i]);
    if (lane == 0) {
      sDelta[r] = d;
      sLse[r] = qpos < Sq ? lse[(size_t)bh * Sq + qpos] : 0.f;
      if (qpos < Sq) delta[(size_t)bh * Sq + qpos] = d;
    }
  }

  float acc[WT][2][4];   // this warp's dQ tiles, over the whole key loop
#pragma unroll
  for (int i = 0; i < WT; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e / 4][e % 4] = 0.f;

  for (int kj = 0; kj < nk; ++kj) {
    const int k0 = kj * BK, st = kj & 1;
    cp_wait();
    // every warp is done with the last tile: its stage takes the next
    // tile's copies, in flight during this tile's work
    __syncthreads();
    if (kj + 1 < nk) {
      load_rows(sK(st ^ 1), ldt, kb, k0 + BK, Sk, BK, D);
      load_rows(sV(st ^ 1), ldt, vb, k0 + BK, Sk, BK, D);
    }
    // S = Q·Kᵀ and dP = dO·Vᵀ on this warp's tile, in registers; P and dS
    // there too; dS to shared memory for dS·K
    float s[2][4] = {}, dp[2][4] = {};
    mma_tile<false, true, D>(sQ, ldt, sK(st), ldt, sm0, sn0, s);
    mma_tile<false, true, D>(sdO, ldt, sV(st), ldt, sm0, sn0, dp);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sm0 + g + 8 * h, qpos = q0 + r;
      const float l = sLse[r], dl = sDelta[r];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + sn0 + 8 * j + 2 * t + e;
          const bool ok =
              kpos < Sk && qpos < Sq && (!causal || kpos <= qpos);
          const float p = ok ? expf(s[j][2 * h + e] * scale - l) : 0.f;
          ds[e] = p * (dp[j][2 * h + e] - dl) * scale;
        }
        *reinterpret_cast<float2*>(sdS + r * lds + sn0 + 8 * j + 2 * t) =
            make_float2(ds[0], ds[1]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WT; ++i) {   // dQ += dS·K
      const int w = warp + NWARPS * i;
      if (w < NT)
        mma_tile<false, false, BK>(sdS, lds, sK(st), ldt, w / TN * 16,
                                   w % TN * 16, acc[i]);
    }
  }

#pragma unroll
  for (int i = 0; i < WT; ++i) {
    const int w = warp + NWARPS * i;
    if (w >= NT) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w / TN * 16 + g + 8 * h;
      if (q0 + r >= Sq) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<float2*>(dq + qoff + (size_t)(q0 + r) * D +
                                   w % TN * 16 + 8 * j + 2 * t) =
            make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dout, void* dq, void* delta,
               int B, int H, int Hkv, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_f32_smem<D>();
  auto kern = flash_bwd_dq_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + F32_BQ - 1) / F32_BQ, B * H);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(lse), static_cast<const float*>(dout),
      static_cast<float*>(dq), static_cast<float*>(delta), H, Hkv, Sq, Sk,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16,
// 2 = bf16 inputs with dQ written in f32; D a multiple of 16 up to 128.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dout,
                            void* dq, void* delta, int B, int H, int Hkv,
                            int Sq, int Sk, int D, float scale, int causal,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_f32<d>(q, k, v, o, lse, dout, dq, delta, B, H, Hkv,   \
                             Sq, Sk, scale, causal, s);
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_bf16<d>(q, k, v, o, lse, dout, dq, delta, B, H, Hkv,  \
                              Sq, Sk, scale, causal, dtype == 2, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_bwd_dq_smem_bytes(int D, int dtype) {
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d) \
  case d:          \
    return (int)fa::dq_f32_smem<d>();
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return 0;
  }
  return fa::padded_dim(D) == 64 ? (int)fa::dq_bf16_smem<64>()
                                 : (int)fa::dq_bf16_smem<128>();
}

// ---- a check of mm_tf32x3's fragment layouts ------------------------------
namespace fa {

// One block: A, B and C (dense, row-major as stored) copied into shared
// memory at the row strides the kernels use for each layout, C (+)= A·B by
// mm_tf32x3, C copied back.
template <bool A_T, bool B_T>
__global__ void __launch_bounds__(NTHREADS)
tile_mm_f32_test_kernel(const float* __restrict__ A,
                        const float* __restrict__ B, float* __restrict__ C,
                        int M, int N, int K, int acc) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int ar = A_T ? K : M, ac = A_T ? M : K;
  const int br = B_T ? N : K, bc = B_T ? K : N;
  const int lda = ac + (A_T == B_T ? PAD8 : PAD4), ldb = bc + PAD4;
  const int ldc = N + PAD8;
  Carver cv{smem};
  float* sA = cv.take<float>(ar * lda);
  float* sB = cv.take<float>(br * ldb);
  float* sC = cv.take<float>(M * ldc);
  for (int i = threadIdx.x; i < ar * ac; i += NTHREADS)
    sA[i / ac * lda + i % ac] = A[i];
  for (int i = threadIdx.x; i < br * bc; i += NTHREADS)
    sB[i / bc * ldb + i % bc] = B[i];
  for (int i = threadIdx.x; i < M * N; i += NTHREADS)
    sC[i / N * ldc + i % N] = acc ? C[i] : __int_as_float(0x7fc00000);
  __syncthreads();
  mm_tf32x3<A_T, B_T>(sA, lda, sB, ldb, sC, ldc, M, N, K, acc != 0);
  __syncthreads();
  for (int i = threadIdx.x; i < M * N; i += NTHREADS)
    C[i] = sC[i / N * ldc + i % N];
}

template <bool A_T, bool B_T>
int launch_tile_mm_test(const void* A, const void* B, void* C, int M, int N,
                        int K, int acc, cudaStream_t stream) {
  const int ar = A_T ? K : M, ac = A_T ? M : K;
  const int br = B_T ? N : K, bc = B_T ? K : N;
  const size_t smem =
      region(ar * (ac + (A_T == B_T ? PAD8 : PAD4)) * sizeof(float)) +
      region(br * (bc + PAD4) * sizeof(float)) +
      region(M * (N + PAD8) * sizeof(float));
  auto kern = tile_mm_f32_test_kernel<A_T, B_T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, NTHREADS, smem, stream>>>(static_cast<const float*>(A),
                                      static_cast<const float*>(B),
                                      static_cast<float*>(C), M, N, K, acc);
  return (int)cudaGetLastError();
}

}  // namespace fa

// C[M x N] (+)= A·B through mm_tf32x3 in one block (a test of its fragment
// layouts): A is [M][K] row-major, or [K][M] if a_t; B is [K][N], or [N][K]
// if b_t; C is [M][N], read first if acc.  M and N multiples of 16, K of 8,
// all three tiles within one block's shared memory.  Returns a cudaError_t
// code.
extern "C" int fa_tile_mm_f32_test(const void* A, const void* B, void* C,
                                   int M, int N, int K, int a_t, int b_t,
                                   int acc, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || M % 16 || N % 16 || K % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_t)
    return b_t ? fa::launch_tile_mm_test<true, true>(A, B, C, M, N, K, acc, s)
               : fa::launch_tile_mm_test<true, false>(A, B, C, M, N, K, acc,
                                                      s);
  return b_t ? fa::launch_tile_mm_test<false, true>(A, B, C, M, N, K, acc, s)
             : fa::launch_tile_mm_test<false, false>(A, B, C, M, N, K, acc,
                                                     s);
}
