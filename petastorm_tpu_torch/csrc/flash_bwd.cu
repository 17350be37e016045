// Flash-attention backward (K2: dq, K3: dk/dv) for Hopper, CUDA C++.
//
// Replaces: petastorm_tpu/ops/attention.py `_flash_bwd_dq_kernel`
// (:658-703) and `_flash_bwd_dkdv_kernel` (:706-754), with their shared
// `_bwd_recompute_p_ds` (:619-655), launched by
// `_flash_backward_from_prepared` (:828, :861).
//
// What they compute: p = exp(s - lse), gated to 0 where the mask fails or
// lse <= -5e29 (a fully masked forward row); ds = p * (do v^T - delta) *
// scale with delta = rowsum(do * o) computed outside (as :757-764 does);
// K2: dq = ds k; K3: dv = p^T do, dk = ds^T q. K2 runs one block per
// (q-block, batch-head row) and loops over kv blocks; K3 runs one block per
// (kv-block, q-head row) and loops over q blocks, replacing the reference's
// sequential q grid axis (:722-754). Each block owns its output tile, so no
// atomics. With grouped-query attention K3 runs once per q head (reading the
// shared kv row through the head map) and writes float32 partials that the
// caller sums per group (the reference's :856-881 contract); for plain
// multi-head attention it writes dk/dv in the storage dtype.
//
// What bounds them on the H100: at the slice's shape (8, 8, 2048, 64) bf16
// causal, K2 does three products per live (q, k) pair (s, dp, dq) and K3
// four (s, dp, dv, dk): 3*B*H*L^2*D and 4*B*H*L^2*D FLOP, 52 and 69 GFLOP,
// against 85 MB and 102 MB of compulsory traffic. Both sit far above the
// bf16 ridge, so they are bound by operations. The kernels here compute on
// the FP32 CUDA cores from padded float32 shared-memory tiles with 4 x 4
// register micro-tiles; they recompute p rather than storing it, which is
// what keeps their traffic at the compulsory bytes. Both run here in
// float32 only (the tensor cores would multiply float32 as TF32); their bf16
// launches go to the wgmma / TMA kernels of flash_bwd_dq_sm90.cu (K2) and
// flash_bwd_sm90.cu (K3).
//
// Blocks: kB q rows and kB kv rows, 64 (flash_common.cuh's kBlockQ) below
// head dim 256, 32 at 256 (bwd_block): four kB x (D + 1) float32 tiles of
// 64 rows take 263 KB there, past the 227 KB a block may have; at 32 rows
// K2 takes ~133 KB and K3 ~137 KB. The 16 x 16 thread grid then owns kB /
// 16 rows and score columns a thread (kS) instead of 4.
//
// Past D = 256 (dq_wide_kernel, dkdv_wide_kernel): 64-row blocks that own
// one slice of the output's columns (256 of dq, 128 of dk and dv;
// blockIdx.z) and accumulate s and dp over 64-column chunks of q, do, k and
// v; the output step reads the slice of k (K2) or of q and do (K3). ~145 KB
// and ~162 KB of shared memory at any D.
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {

// Rows of the backward kernels' q and kv blocks at head dim D (above).
template <int D>
constexpr int bwd_block() {
  return D > 128 ? 32 : kBlockQ;
}

// s = q k^T and dp = do v^T for one kB x kB tile, the thread's kS x kS part
// (kS = kB / 16).
template <int D, int kS>
__device__ __forceinline__ void score_tiles(const float* sQ, const float* sDO,
                                            const float* sK, const float* sV,
                                            const Lane& ln,
                                            float (&s)[kS][kS],
                                            float (&dp)[kS][kS]) {
  constexpr int SD = D + 1;
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < kS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kS], g[kS], b[kS], w[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      a[i] = sQ[(ln.ty + 16 * i) * SD + d];
      g[i] = sDO[(ln.ty + 16 * i) * SD + d];
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      b[j] = sK[(ln.tx + 16 * j) * SD + d];
      w[j] = sV[(ln.tx + 16 * j) * SD + d];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// p and ds of the reference's `_bwd_recompute_p_ds` for the thread's part.
template <int kS>
__device__ __forceinline__ void recompute_p_ds(
    const Mask& mask, const int (&qpos)[kS], const int (&sq)[kS],
    const float (&lse)[kS], const float (&delta)[kS], const int (&kpos)[kS],
    const int (&sk)[kS], float scale, float (&s)[kS][kS],
    float (&dp)[kS][kS]) {
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      const bool live =
          mask(qpos[i], kpos[j], sq[i], sk[j]) && lse[i] > kNegInf * 0.5f;
      const float p = live ? expf(s[i][j] * scale - lse[i]) : 0.f;
      s[i][j] = p;                                   // s now holds p
      dp[i][j] = p * (dp[i][j] - delta[i]) * scale;  // dp now holds ds
    }
}

template <typename T, int D, int kB>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse_g,
              const float* __restrict__ delta_g, const int* __restrict__ segq,
              const int* __restrict__ segk, T* __restrict__ dq, int H, int Hkv,
              int Lq, int Lk, int causal, int window, float scale, int bh0) {
  constexpr int SD = D + 1, SP = kB + 1, NJ = D / 16, kS = kB / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // kB x SD
  float* sDO = sQ + kB * SD;         // kB x SD
  float* sK = sDO + kB * SD;         // kB x SD
  float* sV = sK + kB * SD;          // kB x SD
  float* sDS = sV + kB * SD;         // kB x SP

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = bh0 + (int)blockIdx.y;
  const int kvh = kv_row(bh, H, Hkv);
  const int q0 = qb * kB;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;
  load_tile<D, kB>(sQ, SD, q + (size_t)bh * Lq * D, q0, Lq);
  load_tile<D, kB>(sDO, SD, dout + (size_t)bh * Lq * D, q0, Lq);

  int qpos[kS], sq[kS];
  float lse[kS], delta[kS], acc[kS][NJ];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    qpos[i] = q0 + ln.ty + 16 * i;
    const bool in = qpos[i] < Lq;
    const size_t r = (size_t)bh * Lq + qpos[i];
    sq[i] = (segq != nullptr && in) ? segq[r] : 0;
    lse[i] = in ? lse_g[r] : kNegInf;
    delta[i] = in ? delta_g[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nkb = (Lk + kB - 1) / kB;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {
    kb_hi = min(nkb, (q0 + kB - 1) / kB + 1);
    if (window > 0) {
      const int lo = q0 - window + 1;
      kb_lo = lo >= kB ? lo / kB : 0;
    }
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kB;
    __syncthreads();
    load_tile<D, kB>(sK, SD, kp, k0, Lk);
    load_tile<D, kB>(sV, SD, vp, k0, Lk);
    __syncthreads();

    float s[kS][kS], dp[kS][kS];
    score_tiles<D>(sQ, sDO, sK, sV, ln, s, dp);
    int kpos[kS], sk[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      kpos[j] = k0 + ln.tx + 16 * j;
      sk[j] = (segk != nullptr && kpos[j] < Lk)
                  ? segk[(size_t)kvh * Lk + kpos[j]]
                  : 0;
    }
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j)
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float a[kS], b[NJ];
#pragma unroll
      for (int i = 0; i < kS; ++i) a[i] = sDS[(ln.ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = sK[kk * SD + ln.tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kS; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kS; ++i) {
    if (qpos[i] >= Lq) continue;
    T* row = dq + ((size_t)bh * Lq + qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[ln.tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, typename TO, int D, int kB>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_g,
                const float* __restrict__ delta_g,
                const int* __restrict__ segq, const int* __restrict__ segk,
                TO* __restrict__ dk, TO* __restrict__ dv, int H, int Hkv,
                int Lq, int Lk, int causal, int window, float scale, int bh0) {
  constexpr int SD = D + 1, SP = kB + 1, NJ = D / 16, kS = kB / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // kB x SD
  float* sV = sK + kB * SD;          // kB x SD
  float* sQ = sV + kB * SD;          // kB x SD
  float* sDO = sQ + kB * SD;         // kB x SD
  float* sP = sDO + kB * SD;         // kB x SP
  float* sDS = sP + kB * SP;         // kB x SP

  const int kb = blockIdx.x;
  const int bh = bh0 + (int)blockIdx.y;  // q-head row: its own partial
  const int kvh = kv_row(bh, H, Hkv);
  const int k0 = kb * kB;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  load_tile<D, kB>(sK, SD, k + (size_t)kvh * Lk * D, k0, Lk);
  load_tile<D, kB>(sV, SD, v + (size_t)kvh * Lk * D, k0, Lk);
  const T* qp = q + (size_t)bh * Lq * D;
  const T* dop = dout + (size_t)bh * Lq * D;

  int kpos[kS], sk[kS];
  float dk_acc[kS][NJ], dv_acc[kS][NJ];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    kpos[j] = k0 + ln.tx + 16 * j;
    sk[j] = (segk != nullptr && kpos[j] < Lk)
                ? segk[(size_t)kvh * Lk + kpos[j]]
                : 0;
  }
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqb = (Lq + kB - 1) / kB;
  int qb_lo = 0, qb_hi = nqb;
  if (causal) {
    qb_lo = k0 / kB;             // first q block reaching this kv block
    if (window > 0)                   // last q block the window lets see it
      qb_hi = min(nqb, (k0 + kB - 2 + window) / kB + 1);
  }

  for (int qb = qb_lo; qb < qb_hi; ++qb) {
    const int q0 = qb * kB;
    __syncthreads();
    load_tile<D, kB>(sQ, SD, qp, q0, Lq);
    load_tile<D, kB>(sDO, SD, dop, q0, Lq);
    __syncthreads();

    int qpos[kS], sq[kS];
    float lse[kS], delta[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      qpos[i] = q0 + ln.ty + 16 * i;
      const bool in = qpos[i] < Lq;
      const size_t r = (size_t)bh * Lq + qpos[i];
      sq[i] = (segq != nullptr && in) ? segq[r] : 0;
      lse[i] = in ? lse_g[r] : kNegInf;
      delta[i] = in ? delta_g[r] : 0.f;
    }
    float s[kS][kS], dp[kS][kS];
    score_tiles<D>(sQ, sDO, sK, sV, ln, s, dp);
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        sP[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = s[i][j];
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // this thread now owns kv rows ty + 16 i and columns tx + 16 j
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float p[kS], ds[kS], g[NJ], a[NJ];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        p[i] = sP[qq * SP + ln.ty + 16 * i];
        ds[i] = sDS[qq * SP + ln.ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = sDO[qq * SD + ln.tx + 16 * j];
        a[j] = sQ[qq * SD + ln.tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(p[i], g[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], a[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int kr = k0 + ln.ty + 16 * i;
    if (kr >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[off + ln.tx + 16 * j] = from_f32<TO>(dk_acc[i][j]);
      dv[off + ln.tx + 16 * j] = from_f32<TO>(dv_acc[i][j]);
    }
  }
}

// Head dims past 256: s = q k^T and dp = do v^T over one 64-column chunk of
// each (row stride SC = kWideChunk + 1), added to the thread's kS x kS part.
template <int kS>
__device__ __forceinline__ void score_chunk(const float* sQ, const float* sDO,
                                            const float* sK, const float* sV,
                                            const Lane& ln,
                                            float (&s)[kS][kS],
                                            float (&dp)[kS][kS]) {
  constexpr int SC = kWideChunk + 1;
#pragma unroll 4
  for (int d = 0; d < kWideChunk; ++d) {
    float a[kS], g[kS], b[kS], w[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      a[i] = sQ[(ln.ty + 16 * i) * SC + d];
      g[i] = sDO[(ln.ty + 16 * i) * SC + d];
    }
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      b[j] = sK[(ln.tx + 16 * j) * SC + d];
      w[j] = sV[(ln.tx + 16 * j) * SC + d];
    }
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// K2 past head dim 256: a block owns 64 q rows and kWideFwdCols of dq's
// columns (blockIdx.z); s and dp stream over D in chunks of q, do, k and v,
// and the ds k step reads the slice of k's columns.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dq_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse_g,
                   const float* __restrict__ delta_g,
                   const int* __restrict__ segq, const int* __restrict__ segk,
                   T* __restrict__ dq, int H, int Hkv, int Lq, int Lk, int D,
                   int causal, int window, float scale, int bh0) {
  constexpr int kB = kBlockQ, kC = kWideChunk, SC = kC + 1, SP = kB + 1;
  constexpr int kW = kWideFwdCols, NJ = kW / 16, kS = kB / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // kB x SC: chunks of q, do, k, v
  float* sDO = sQ + kB * SC;
  float* sK = sDO + kB * SC;
  float* sV = sK + kB * SC;
  float* sDS = sV + kB * SC;         // kB x SP
  float* sKs = sDS + kB * SP;        // kB x kW: the slice of k

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = bh0 + (int)blockIdx.y;
  const int col0 = kW * blockIdx.z;
  const int kvh = kv_row(bh, H, Hkv);
  const int q0 = qb * kB;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  const T* qp = q + (size_t)bh * Lq * D;
  const T* dop = dout + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;

  int qpos[kS], sq[kS];
  float lse[kS], delta[kS], acc[kS][NJ];
#pragma unroll
  for (int i = 0; i < kS; ++i) {
    qpos[i] = q0 + ln.ty + 16 * i;
    const bool in = qpos[i] < Lq;
    const size_t r = (size_t)bh * Lq + qpos[i];
    sq[i] = (segq != nullptr && in) ? segq[r] : 0;
    lse[i] = in ? lse_g[r] : kNegInf;
    delta[i] = in ? delta_g[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nkb = (Lk + kB - 1) / kB;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {
    kb_hi = min(nkb, (q0 + kB - 1) / kB + 1);
    if (window > 0) {
      const int lo = q0 - window + 1;
      kb_lo = lo >= kB ? lo / kB : 0;
    }
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kB;
    float s[kS][kS], dp[kS][kS];
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kC) {
      __syncthreads();
      load_cols<kC, kB>(sQ, SC, qp, q0, Lq, D, c0);
      load_cols<kC, kB>(sDO, SC, dop, q0, Lq, D, c0);
      load_cols<kC, kB>(sK, SC, kp, k0, Lk, D, c0);
      load_cols<kC, kB>(sV, SC, vp, k0, Lk, D, c0);
      __syncthreads();
      score_chunk(sQ, sDO, sK, sV, ln, s, dp);
    }
    load_cols<kW, kB>(sKs, kW, kp, k0, Lk, D, col0);
    int kpos[kS], sk[kS];
#pragma unroll
    for (int j = 0; j < kS; ++j) {
      kpos[j] = k0 + ln.tx + 16 * j;
      sk[j] = (segk != nullptr && kpos[j] < Lk)
                  ? segk[(size_t)kvh * Lk + kpos[j]]
                  : 0;
    }
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j)
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kB; ++kk) {
      float a[kS], b[NJ];
#pragma unroll
      for (int i = 0; i < kS; ++i) a[i] = sDS[(ln.ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = sKs[kk * kW + ln.tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kS; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kS; ++i) {
    if (qpos[i] >= Lq) continue;
    T* row = dq + ((size_t)bh * Lq + qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = col0 + ln.tx + 16 * j;
      if (col < D) row[col] = from_f32<T>(acc[i][j]);
    }
  }
}

// K3 past head dim 256: a block owns 64 kv rows and kWideKvCols of dk's and
// dv's columns (blockIdx.z); s and dp stream over D in chunks, and the dv
// and dk steps read the slices of do's and q's columns.
template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    dkdv_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse_g,
                     const float* __restrict__ delta_g,
                     const int* __restrict__ segq,
                     const int* __restrict__ segk, TO* __restrict__ dk,
                     TO* __restrict__ dv, int H, int Hkv, int Lq, int Lk,
                     int D, int causal, int window, float scale, int bh0) {
  constexpr int kB = kBlockQ, kC = kWideChunk, SC = kC + 1, SP = kB + 1;
  constexpr int kW = kWideKvCols, NJ = kW / 16, kS = kB / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // kB x SC: chunks of q, do, k, v
  float* sDO = sQ + kB * SC;
  float* sK = sDO + kB * SC;
  float* sV = sK + kB * SC;
  float* sP = sV + kB * SC;          // kB x SP
  float* sDS = sP + kB * SP;         // kB x SP
  float* sQs = sDS + kB * SP;        // kB x kW: the slices of q and do
  float* sDOs = sQs + kB * kW;

  const int kb = blockIdx.x;
  const int bh = bh0 + (int)blockIdx.y;  // q-head row: its own partial
  const int col0 = kW * blockIdx.z;
  const int kvh = kv_row(bh, H, Hkv);
  const int k0 = kb * kB;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;
  const T* qp = q + (size_t)bh * Lq * D;
  const T* dop = dout + (size_t)bh * Lq * D;

  int kpos[kS], sk[kS];
  float dk_acc[kS][NJ], dv_acc[kS][NJ];
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    kpos[j] = k0 + ln.tx + 16 * j;
    sk[j] = (segk != nullptr && kpos[j] < Lk)
                ? segk[(size_t)kvh * Lk + kpos[j]]
                : 0;
  }
#pragma unroll
  for (int i = 0; i < kS; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqb = (Lq + kB - 1) / kB;
  int qb_lo = 0, qb_hi = nqb;
  if (causal) {
    qb_lo = k0 / kB;             // first q block reaching this kv block
    if (window > 0)                   // last q block the window lets see it
      qb_hi = min(nqb, (k0 + kB - 2 + window) / kB + 1);
  }

  for (int qb = qb_lo; qb < qb_hi; ++qb) {
    const int q0 = qb * kB;
    int qpos[kS], sq[kS];
    float lse[kS], delta[kS];
#pragma unroll
    for (int i = 0; i < kS; ++i) {
      qpos[i] = q0 + ln.ty + 16 * i;
      const bool in = qpos[i] < Lq;
      const size_t r = (size_t)bh * Lq + qpos[i];
      sq[i] = (segq != nullptr && in) ? segq[r] : 0;
      lse[i] = in ? lse_g[r] : kNegInf;
      delta[i] = in ? delta_g[r] : 0.f;
    }
    float s[kS][kS], dp[kS][kS];
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += kC) {
      __syncthreads();
      load_cols<kC, kB>(sQ, SC, qp, q0, Lq, D, c0);
      load_cols<kC, kB>(sDO, SC, dop, q0, Lq, D, c0);
      load_cols<kC, kB>(sK, SC, kp, k0, Lk, D, c0);
      load_cols<kC, kB>(sV, SC, vp, k0, Lk, D, c0);
      __syncthreads();
      score_chunk(sQ, sDO, sK, sV, ln, s, dp);
    }
    load_cols<kW, kB>(sQs, kW, qp, q0, Lq, D, col0);
    load_cols<kW, kB>(sDOs, kW, dop, q0, Lq, D, col0);
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kS; ++i)
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        sP[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = s[i][j];
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // this thread now owns kv rows ty + 16 i and columns tx + 16 j
#pragma unroll 4
    for (int qq = 0; qq < kB; ++qq) {
      float p[kS], ds[kS], g[NJ], a[NJ];
#pragma unroll
      for (int i = 0; i < kS; ++i) {
        p[i] = sP[qq * SP + ln.ty + 16 * i];
        ds[i] = sDS[qq * SP + ln.ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = sDOs[qq * kW + ln.tx + 16 * j];
        a[j] = sQs[qq * kW + ln.tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kS; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(p[i], g[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], a[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kS; ++i) {
    const int kr = k0 + ln.ty + 16 * i;
    if (kr >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kr) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = col0 + ln.tx + 16 * j;
      if (col < D) {
        dk[off + col] = from_f32<TO>(dk_acc[i][j]);
        dv[off + col] = from_f32<TO>(dv_acc[i][j]);
      }
    }
  }
}

template <typename T>
int launch_dq_wide(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* segq, const int* segk, void* dq, int BH, int H,
                   int Hkv, int Lq, int Lk, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  constexpr int kB = kBlockQ;
  const size_t smem = sizeof(float) * (4 * kB * (kWideChunk + 1) +
                                       kB * (kB + 1) + kB * kWideFwdCols);
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks(BH, [&](int bh0, int nbh) {
    dim3 grid((Lq + kB - 1) / kB, nbh, (D + kWideFwdCols - 1) / kWideFwdCols);
    dq_wide_kernel<T><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
        segk, (T*)dq, H, Hkv, Lq, Lk, D, causal, window, scale, bh0);
    return (int)cudaGetLastError();
  });
}

template <typename T, typename TO>
int launch_dkdv_wide(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* segq, const int* segk, void* dk, void* dv,
                     int BH, int H, int Hkv, int Lq, int Lk, int D,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  constexpr int kB = kBlockQ;
  const size_t smem =
      sizeof(float) * (4 * kB * (kWideChunk + 1) + 2 * kB * (kB + 1) +
                       2 * kB * kWideKvCols);
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_wide_kernel<T, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks(BH, [&](int bh0, int nbh) {
    dim3 grid((Lk + kB - 1) / kB, nbh, (D + kWideKvCols - 1) / kWideKvCols);
    dkdv_wide_kernel<T, TO><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
        segk, (TO*)dk, (TO*)dv, H, Hkv, Lq, Lk, D, causal, window, scale, bh0);
    return (int)cudaGetLastError();
  });
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* segq,
              const int* segk, void* dq, int BH, int H, int Hkv, int Lq,
              int Lk, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int SD = D + 1, kB = bwd_block<D>();
  const size_t smem = sizeof(float) * (4 * kB * SD + kB * (kB + 1));
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks(BH, [&](int bh0, int nbh) {
    dim3 grid((Lq + kB - 1) / kB, nbh);
    dq_kernel<T, D, kB><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
        segk, (T*)dq, H, Hkv, Lq, Lk, causal, window, scale, bh0);
    return (int)cudaGetLastError();
  });
}

template <typename T, typename TO, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* segq,
                const int* segk, void* dk, void* dv, int BH, int H, int Hkv,
                int Lq, int Lk, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr int SD = D + 1, kB = bwd_block<D>();
  const size_t smem = sizeof(float) * (4 * kB * SD + 2 * kB * (kB + 1));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, TO, D, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks(BH, [&](int bh0, int nbh) {
    dim3 grid((Lk + kB - 1) / kB, nbh);
    dkdv_kernel<T, TO, D, kB><<<grid, kThreads, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
        segk, (TO*)dk, (TO*)dv, H, Hkv, Lq, Lk, causal, window, scale, bh0);
    return (int)cudaGetLastError();
  });
}

}  // namespace flash

// dtype: 0 = float32 (D 16, 32, 64, 128 or 256, or any multiple of 64 past
// 256 on the wide kernel), 1 = bfloat16 (of q, k, v, do and dq; on wgmma,
// flash_bwd_dq_sm90.cu; D 32, 64, 128 or 256, or any multiple of 64 past
// 256). Returns a cudaError_t (0 = launched).
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, const int* segq,
                            const int* segk, void* dq, int BH, int H, int Hkv,
                            int Lq, int Lk, int D, int causal, int window,
                            float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return flash::launch_dq_sm90(q, k, v, dout, lse, delta, segq, segk, dq,
                                 BH, H, Hkv, Lq, Lk, D, causal, window, scale,
                                 s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
#define FLASH_DQ_CASE(HD)                                                   \
  case HD:                                                                  \
    return flash::launch_dq<float, HD>(q, k, v, dout, lse, delta, segq,     \
                                       segk, dq, BH, H, Hkv, Lq, Lk, causal, \
                                       window, scale, s);
    FLASH_FOR_HEAD_DIMS_F32(FLASH_DQ_CASE)
#undef FLASH_DQ_CASE
  }
  if (D > 256 && D % flash::kWideChunk == 0)
    return flash::launch_dq_wide<float>(q, k, v, dout, lse, delta, segq, segk,
                                        dq, BH, H, Hkv, Lq, Lk, D, causal,
                                        window, scale, s);
  return (int)cudaErrorInvalidValue;
}

// dtype as above (bfloat16 on wgmma, flash_bwd_sm90.cu); out_f32 = 1 writes
// float32 dk/dv (grouped-query partials), 0 writes them in the input dtype.
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, const int* segq,
                              const int* segk, void* dk, void* dv, int BH,
                              int H, int Hkv, int Lq, int Lk, int D,
                              int causal, int window, float scale, int dtype,
                              int out_f32, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return flash::launch_dkdv_sm90(q, k, v, dout, lse, delta, segq, segk, dk,
                                   dv, out_f32, BH, H, Hkv, Lq, Lk, D, causal,
                                   window, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
#define FLASH_DKDV_CASE(HD)                                                 \
  case HD:                                                                  \
    return flash::launch_dkdv<float, float, HD>(                            \
        q, k, v, dout, lse, delta, segq, segk, dk, dv, BH, H, Hkv, Lq, Lk,  \
        causal, window, scale, s);
    FLASH_FOR_HEAD_DIMS_F32(FLASH_DKDV_CASE)
#undef FLASH_DKDV_CASE
  }
  if (D > 256 && D % flash::kWideChunk == 0)
    return flash::launch_dkdv_wide<float, float>(
        q, k, v, dout, lse, delta, segq, segk, dk, dv, BH, H, Hkv, Lq, Lk, D,
        causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}
