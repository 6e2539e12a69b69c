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
// f32 design (the text transformer's build; built per head dim, D any
// multiple of 16 up to 128), the bf16 design's shape on warp-level tensor
// cores: one block of four warps per (b·h, 64-row q tile), each warp owning
// 16 q rows across the whole K/V tile and all of D, so the running max and
// sum are quad shuffles, with no shared memory and no barrier.  S (16 × BK)
// and the O accumulator (16 × D) stay in registers over the key loop, and O
// is written once.  Both products are mma.sync m16n8k8 in 3xTF32
// (f32-accurate, each k-step summed in a fresh accumulator; flash_tf32.cuh):
// S = Q·Kᵀ reads K as stored ([key][d], a B stored [N][K]); O += P·V reads
// V as stored ([key][d], a B stored [K][N], paired k order), and P never
// leaves registers: S's C fragment is P·V's A fragment (c_frag_as_a).  Q's
// split fragments stay in registers across the key loop for D ≤ 64 (D
// registers a thread) and are read from shared memory each tile above.
// Rows of Q, K and V are padded by PAD4, so every fragment load is free of
// bank conflicts.  K/V tiles (64 rows for D ≤ 64, 32 above, to keep two
// blocks an SM at D 128) go through two cp.async stages, tile j+1 in flight
// during tile j, one block barrier a tile.  Masking and the tiles visited
// are as in bf16; exponentials are ex2 of s·scale·log2 e, lse is written as
// m·ln 2 + log l.  Bound at the text shape (B 80, H 8, S 128, D 32, full):
// 1.3 GFLOP at 165 TFLOP/s (495 TF32 over three passes) is 8 µs, under the
// 42 MB it must move (13 µs), so bytes set the least time.
#include "flash_sm90.cuh"
#include "flash_tf32.cuh"

namespace fa {

constexpr int FWD_BQ = 64, FWD_BK = 64;

template <int DP>
__host__ __device__ constexpr size_t fwd_bf16_smem() {
  return size_t(FWD_BQ) * DP * 2 + 2 * 2 * size_t(FWD_BK) * DP * 2;
}

// Online softmax of one S tile (this warp's rows q_row and q_row + 8, BK
// columns from key k0, in the C layout) in log2 units, shared by K1's bf16
// and f32 builds: S·scale·log2 e, masked to NEG_INF where a key is past Sk
// or (causal) after the row's query (evaluated only where edge says the
// tile needs it); the row max m and sum l move on, S becomes P, and alpha
// is the factor by which O must be scaled.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&s)[BK / 8][4],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               float scale_log2, bool edge,
                                               int k0, int q_row, int Sk,
                                               int causal) {
  const int t = threadIdx.x % 4;
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[nt][e] * scale_log2;
      if (edge) {
        const int kpos = k0 + nt * 8 + 2 * t + (e & 1);
        const int qpos = q_row + 8 * (e >> 1);
        if (kpos >= Sk || (causal && kpos > qpos)) x = NEG_INF;
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = sm90::quad_max(mx[i]);
    alpha[i] = sm90::ex2(m[i] - mx[i]);
    m[i] = mx[i];
  }
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = sm90::ex2(s[nt][e] - m[e >> 1]);
      s[nt][e] = p;
      sum[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
}

// O's rows g (c0, c1) and g+8 (c2, c3) times alpha
template <int N>
__device__ __forceinline__ void scale_rows(float (&acc)[N][4],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int nt = 0; nt < N; ++nt) {
    acc[nt][0] *= alpha[0];
    acc[nt][1] *= alpha[0];
    acc[nt][2] *= alpha[1];
    acc[nt][3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(FWD_BQ * 2)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o,
                      float* __restrict__ o32, float* __restrict__ lse,
                      int H, int Hkv, int Sq, int Sk, float scale_log2,
                      int causal) {
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

    const int k0 = j * BK;
    float alpha[2];
    online_softmax<BK>(s, m, l, alpha, scale_log2,
                       k0 + BK > Sk || (causal && k0 + BK - 1 > q0), k0,
                       q0 + r0 + g, Sk, causal);
    scale_rows(acc, alpha);

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

#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = fmaxf(quad_sum(l[i]), 1e-30f);
  if (o32 != nullptr) {
    // O = acc / l in f32 (ring attention's partial outputs), each thread
    // its fragment's pairs of columns
    float* ob = o32 + ((size_t)bh * Sq + q0) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + g + 8 * i;
        if (q0 + r < Sq)
          *reinterpret_cast<float2*>(ob + (size_t)r * D + 8 * nt + 2 * t) =
              make_float2(acc[nt][2 * i] / l[i], acc[nt][2 * i + 1] / l[i]);
      }
    }
  } else {
    // O = acc / l in bf16, staged through this warp's own rows of the Q
    // tile (every read of it is done) so that the global stores are whole
    // rows
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
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = q0 + r0 + g + 8 * i;
      if (qpos < Sq) lse[(size_t)bh * Sq + qpos] = m[i] * LN2 + logf(l[i]);
    }
  }
}

// out_f32: O written in f32 (``o`` a float buffer), not bf16
template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
                int causal, bool out_f32, cudaStream_t stream) {
  constexpr size_t smem = fwd_bf16_smem<padded_dim(D)>();
  auto kern = flash_fwd_bf16_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + FWD_BQ - 1) / FWD_BQ);
  kern<<<grid, FWD_BQ * 2, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      out_f32 ? static_cast<float*>(o) : nullptr, static_cast<float*>(lse),
      H, Hkv, Sq, Sk, scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

// ---- f32: 3xTF32 products, S, P and O in registers -----------------------
constexpr int F32_FWD_BQ = 64;
template <int D>
__host__ __device__ constexpr int fwd_f32_bk() { return D <= 64 ? 64 : 32; }

// Q (rows D + PAD4) and two stages of (K, V)
template <int D>
__host__ __device__ constexpr size_t fwd_f32_smem() {
  return region(F32_FWD_BQ * (D + PAD4) * sizeof(float)) +
         4 * region(fwd_f32_bk<D>() * (D + PAD4) * sizeof(float));
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int Hkv, int Sq, int Sk,
                     float scale_log2, int causal) {
  constexpr int BQ = F32_FWD_BQ, BK = fwd_f32_bk<D>(), ld = D + PAD4;
  constexpr bool QREG = D <= 64;   // Q's split fragments held in registers
  static_assert(BQ == 16 * NWARPS, "a warp owns 16 q rows");
  constexpr size_t QB = region(BQ * ld * 4), KB = region(BK * ld * 4);
  extern __shared__ __align__(1024) unsigned char smem[];
  float* const sQ = reinterpret_cast<float*>(smem);
  auto sK = [&](int st) {
    return reinterpret_cast<float*>(smem + QB + st * 2 * KB);
  };
  auto sV = [&](int st) {
    return reinterpret_cast<float*>(smem + QB + st * 2 * KB + KB);
  };

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // heaviest tiles first
  const int kvr = (bh / H) * Hkv + (bh % H) / (H / Hkv);
  const float* kb = k + (size_t)kvr * Sk * D;
  const float* vb = v + (size_t)kvr * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, r0 = warp * 16;
  const int nk_all = (Sk + BK - 1) / BK;
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  load_rows(sQ, ld, q + (size_t)bh * Sq * D, q0, Sq, BQ, D);
  load_rows(sK(0), ld, kb, 0, Sk, BK, D);
  load_rows(sV(0), ld, vb, 0, Sk, BK, D);
  cp_wait();
  __syncthreads();
  uint32_t qh[QREG ? D / 8 : 1][4], ql[QREG ? D / 8 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      a_frag_bt(sQ, ld, r0, 8 * kk, qh[kk], ql[kk]);
  }

  float acc[D / 8][4];   // O, unnormalised
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows g, g+8

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BK, st = j & 1;
    if (j) {
      cp_wait();
      // every warp is done with tile j-1: its stage takes tile j+1
      __syncthreads();
    }
    if (j + 1 < nk) {   // in flight during this tile's work
      load_rows(sK(st ^ 1), ld, kb, k0 + BK, Sk, BK, D);
      load_rows(sV(st ^ 1), ld, vb, k0 + BK, Sk, BK, D);
    }

    float s[BK / 8][4];   // S = Q·Kᵀ on this warp's 16 rows
#pragma unroll
    for (int i = 0; i < BK / 8; ++i)
      s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      if constexpr (QREG) {
        mma_strip<true, BK / 8>(qh[kk], ql[kk], sK(st), ld, 8 * kk, s);
      } else {
        uint32_t ah[4], al[4];
        a_frag_bt(sQ, ld, r0, 8 * kk, ah, al);
        mma_strip<true, BK / 8>(ah, al, sK(st), ld, 8 * kk, s);
      }
    }

    float alpha[2];
    online_softmax<BK>(s, m, l, alpha, scale_log2,
                       k0 + BK > Sk || (causal && k0 + BK - 1 > q0), k0,
                       q0 + r0 + g, Sk, causal);
    scale_rows(acc, alpha);

    // O += P·V, P from S's registers
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      uint32_t ah[4], al[4];
      c_frag_as_a(s[kk], ah, al);
      mma_strip<false, D / 8>(ah, al, sV(st), ld, 8 * kk, acc);
    }
  }

  // O = acc / l, each quad writing 8 consecutive floats of a row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = fmaxf(sm90::quad_sum(l[i]), 1e-30f);
    const int qpos = q0 + r0 + g + 8 * i;
    if (qpos >= Sq) continue;
    float* orow = o + ((size_t)bh * Sq + qpos) * D;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<float2*>(orow + 8 * nt + 2 * t) =
          make_float2(acc[nt][2 * i] / l[i], acc[nt][2 * i + 1] / l[i]);
    if (t == 0)
      lse[(size_t)bh * Sq + qpos] = m[i] * sm90::LN2 + logf(l[i]);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = fwd_f32_smem<D>();
  auto kern = flash_fwd_f32_kernel<D>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (Sq + F32_FWD_BQ - 1) / F32_FWD_BQ);
  kern<<<grid, NTHREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), H, Hkv, Sq, Sk, scale * sm90::LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace fa

// Returns a cudaError_t code (0 = cudaSuccess).  dtype: 0 = f32, 1 = bf16,
// 2 = bf16 inputs with O written in f32;
// D a multiple of 16 up to 128.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int Hkv, int Sq, int Sk,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_f32<d>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale,     \
                             causal, s);
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (D) {
#define FA_CASE(d)                                                          \
  case d:                                                                   \
    return fa::launch_bf16<d>(q, k, v, o, lse, B, H, Hkv, Sq, Sk, scale,    \
                              causal, dtype == 2, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory one block of the kernel takes at head_dim D.
extern "C" int flash_fwd_smem_bytes(int D, int dtype) {
  if (dtype == 0) {
    switch (D) {
#define FA_CASE(d) \
  case d:          \
    return (int)fa::fwd_f32_smem<d>();
      FA_BF16_HEAD_DIMS(FA_CASE)   // the f32 builds: the same head dims
#undef FA_CASE
    }
    return 0;
  }
  return fa::padded_dim(D) == 64 ? (int)fa::fwd_bf16_smem<64>()
                                 : (int)fa::fwd_bf16_smem<128>();
}

// ---- a check of K1's register-A product -----------------------------------
namespace fa {

// One block: O[64 x D] = P[64 x BK]·V[BK x D] (dense, row-major) as K1's
// f32 build forms it, each warp holding its 16 rows of P as the C
// fragments of S, V in shared memory at K1's row stride.
template <int D, int BK>
__global__ void __launch_bounds__(NTHREADS)
pv_f32_test_kernel(const float* __restrict__ P, const float* __restrict__ V,
                   float* __restrict__ O) {
  constexpr int ld = D + PAD4;
  extern __shared__ __align__(1024) unsigned char smem[];
  float* sV = reinterpret_cast<float*>(smem);
  for (int i = threadIdx.x; i < BK * D; i += NTHREADS)
    sV[i / D * ld + i % D] = V[i];
  __syncthreads();
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = threadIdx.x / 32 * 16;
  float p[BK / 8][4], acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[nt][e] = P[(r0 + g + 8 * (e >> 1)) * BK + 8 * nt + 2 * t + (e & 1)];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ah[4], al[4];
    c_frag_as_a(p[kk], ah, al);
    mma_strip<false, D / 8>(ah, al, sV, ld, 8 * kk, acc);
  }
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      O[(r0 + g + 8 * (e >> 1)) * D + 8 * nt + 2 * t + (e & 1)] = acc[nt][e];
}

template <int D>
int launch_pv_test(const void* P, const void* V, void* O, int bk,
                   cudaStream_t stream) {
  const size_t smem = region(size_t(bk) * (D + PAD4) * sizeof(float));
  auto kern = bk == 64 ? pv_f32_test_kernel<D, 64> : pv_f32_test_kernel<D, 32>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, NTHREADS, smem, stream>>>(static_cast<const float*>(P),
                                      static_cast<const float*>(V),
                                      static_cast<float*>(O));
  return (int)cudaGetLastError();
}

}  // namespace fa

// O[64 x D] = P[64 x bk]·V[bk x D], all row-major, through K1's f32
// register-A product (c_frag_as_a, mma_strip) in one block: a test of its
// fragment mapping.  bk 32 or 64 (K1's K/V tile rows), D a multiple of 16
// up to 128.  Returns a cudaError_t code.
extern "C" int fa_pv_f32_test(const void* P, const void* V, void* O, int D,
                              int bk, void* stream) {
  if (bk != 32 && bk != 64) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
#define FA_CASE(d) \
  case d:          \
    return fa::launch_pv_test<d>(P, V, O, bk, s);
    FA_BF16_HEAD_DIMS(FA_CASE)
#undef FA_CASE
  }
  return (int)cudaErrorInvalidValue;
}
