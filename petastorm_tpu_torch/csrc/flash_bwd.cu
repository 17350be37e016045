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
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {

// s = q k^T and dp = do v^T for one 64 x 64 tile, the thread's 4 x 4 part.
template <int D>
__device__ __forceinline__ void score_tiles(const float* sQ, const float* sDO,
                                            const float* sK, const float* sV,
                                            const Lane& ln,
                                            float (&s)[kSub][kSub],
                                            float (&dp)[kSub][kSub]) {
  constexpr int SD = D + 1;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[kSub], g[kSub], b[kSub], w[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      a[i] = sQ[(ln.ty + 16 * i) * SD + d];
      g[i] = sDO[(ln.ty + 16 * i) * SD + d];
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      b[j] = sK[(ln.tx + 16 * j) * SD + d];
      w[j] = sV[(ln.tx + 16 * j) * SD + d];
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
      }
  }
}

// p and ds of the reference's `_bwd_recompute_p_ds` for the thread's part.
__device__ __forceinline__ void recompute_p_ds(
    const Mask& mask, const int (&qpos)[kSub], const int (&sq)[kSub],
    const float (&lse)[kSub], const float (&delta)[kSub],
    const int (&kpos)[kSub], const int (&sk)[kSub], float scale,
    float (&s)[kSub][kSub], float (&dp)[kSub][kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool live =
          mask(qpos[i], kpos[j], sq[i], sk[j]) && lse[i] > kNegInf * 0.5f;
      const float p = live ? expf(s[i][j] * scale - lse[i]) : 0.f;
      s[i][j] = p;                                   // s now holds p
      dp[i][j] = p * (dp[i][j] - delta[i]) * scale;  // dp now holds ds
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse_g,
              const float* __restrict__ delta_g, const int* __restrict__ segq,
              const int* __restrict__ segk, T* __restrict__ dq, int H, int Hkv,
              int Lq, int Lk, int causal, int window, float scale) {
  constexpr int SD = D + 1, SP = kBlockK + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                  // kBlockQ x SD
  float* sDO = sQ + kBlockQ * SD;    // kBlockQ x SD
  float* sK = sDO + kBlockQ * SD;    // kBlockK x SD
  float* sV = sK + kBlockK * SD;     // kBlockK x SD
  float* sDS = sV + kBlockK * SD;    // kBlockQ x SP

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = kv_row(bh, H, Hkv);
  const int q0 = qb * kBlockQ;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;
  load_tile<D, kBlockQ>(sQ, SD, q + (size_t)bh * Lq * D, q0, Lq);
  load_tile<D, kBlockQ>(sDO, SD, dout + (size_t)bh * Lq * D, q0, Lq);

  int qpos[kSub], sq[kSub];
  float lse[kSub], delta[kSub], acc[kSub][NJ];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    qpos[i] = q0 + ln.ty + 16 * i;
    const bool in = qpos[i] < Lq;
    const size_t r = (size_t)bh * Lq + qpos[i];
    sq[i] = (segq != nullptr && in) ? segq[r] : 0;
    lse[i] = in ? lse_g[r] : kNegInf;
    delta[i] = in ? delta_g[r] : 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  const int nkb = (Lk + kBlockK - 1) / kBlockK;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {
    kb_hi = min(nkb, (q0 + kBlockQ - 1) / kBlockK + 1);
    if (window > 0) {
      const int lo = q0 - window + 1;
      kb_lo = lo >= kBlockK ? lo / kBlockK : 0;
    }
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();
    load_tile<D, kBlockK>(sK, SD, kp, k0, Lk);
    load_tile<D, kBlockK>(sV, SD, vp, k0, Lk);
    __syncthreads();

    float s[kSub][kSub], dp[kSub][kSub];
    score_tiles<D>(sQ, sDO, sK, sV, ln, s, dp);
    int kpos[kSub], sk[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      kpos[j] = k0 + ln.tx + 16 * j;
      sk[j] = (segk != nullptr && kpos[j] < Lk)
                  ? segk[(size_t)kvh * Lk + kpos[j]]
                  : 0;
    }
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j)
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float a[kSub], b[NJ];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = sDS[(ln.ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = sK[kk * SD + ln.tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    if (qpos[i] >= Lq) continue;
    T* row = dq + ((size_t)bh * Lq + qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) row[ln.tx + 16 * j] = from_f32<T>(acc[i][j]);
  }
}

template <typename T, typename TO, int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse_g,
                const float* __restrict__ delta_g,
                const int* __restrict__ segq, const int* __restrict__ segk,
                TO* __restrict__ dk, TO* __restrict__ dv, int H, int Hkv,
                int Lq, int Lk, int causal, int window, float scale) {
  constexpr int SD = D + 1, SP = kBlockK + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;                  // kBlockK x SD
  float* sV = sK + kBlockK * SD;     // kBlockK x SD
  float* sQ = sV + kBlockK * SD;     // kBlockQ x SD
  float* sDO = sQ + kBlockQ * SD;    // kBlockQ x SD
  float* sP = sDO + kBlockQ * SD;    // kBlockQ x SP
  float* sDS = sP + kBlockQ * SP;    // kBlockQ x SP

  const int kb = blockIdx.x;
  const int bh = blockIdx.y;         // q-head row; writes its own partial
  const int kvh = kv_row(bh, H, Hkv);
  const int k0 = kb * kBlockK;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  load_tile<D, kBlockK>(sK, SD, k + (size_t)kvh * Lk * D, k0, Lk);
  load_tile<D, kBlockK>(sV, SD, v + (size_t)kvh * Lk * D, k0, Lk);
  const T* qp = q + (size_t)bh * Lq * D;
  const T* dop = dout + (size_t)bh * Lq * D;

  int kpos[kSub], sk[kSub];
  float dk_acc[kSub][NJ], dv_acc[kSub][NJ];
#pragma unroll
  for (int j = 0; j < kSub; ++j) {
    kpos[j] = k0 + ln.tx + 16 * j;
    sk[j] = (segk != nullptr && kpos[j] < Lk)
                ? segk[(size_t)kvh * Lk + kpos[j]]
                : 0;
  }
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const int nqb = (Lq + kBlockQ - 1) / kBlockQ;
  int qb_lo = 0, qb_hi = nqb;
  if (causal) {
    qb_lo = k0 / kBlockQ;             // first q block reaching this kv block
    if (window > 0)                   // last q block the window lets see it
      qb_hi = min(nqb, (k0 + kBlockK - 2 + window) / kBlockQ + 1);
  }

  for (int qb = qb_lo; qb < qb_hi; ++qb) {
    const int q0 = qb * kBlockQ;
    __syncthreads();
    load_tile<D, kBlockQ>(sQ, SD, qp, q0, Lq);
    load_tile<D, kBlockQ>(sDO, SD, dop, q0, Lq);
    __syncthreads();

    int qpos[kSub], sq[kSub];
    float lse[kSub], delta[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      qpos[i] = q0 + ln.ty + 16 * i;
      const bool in = qpos[i] < Lq;
      const size_t r = (size_t)bh * Lq + qpos[i];
      sq[i] = (segq != nullptr && in) ? segq[r] : 0;
      lse[i] = in ? lse_g[r] : kNegInf;
      delta[i] = in ? delta_g[r] : 0.f;
    }
    float s[kSub][kSub], dp[kSub][kSub];
    score_tiles<D>(sQ, sDO, sK, sV, ln, s, dp);
    recompute_p_ds(mask, qpos, sq, lse, delta, kpos, sk, scale, s, dp);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        sP[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = s[i][j];
        sDS[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = dp[i][j];
      }
    __syncthreads();

    // this thread now owns kv rows ty + 16 i and columns tx + 16 j
#pragma unroll 4
    for (int qq = 0; qq < kBlockQ; ++qq) {
      float p[kSub], ds[kSub], g[NJ], a[NJ];
#pragma unroll
      for (int i = 0; i < kSub; ++i) {
        p[i] = sP[qq * SP + ln.ty + 16 * i];
        ds[i] = sDS[qq * SP + ln.ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        g[j] = sDO[qq * SD + ln.tx + 16 * j];
        a[j] = sQ[qq * SD + ln.tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          dv_acc[i][j] = fmaf(p[i], g[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], a[j], dk_acc[i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
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

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* segq,
              const int* segk, void* dq, int BH, int H, int Hkv, int Lq,
              int Lk, int causal, int window, float scale,
              cudaStream_t stream) {
  constexpr int SD = D + 1;
  const size_t smem = sizeof(float) * (2 * kBlockQ * SD + 2 * kBlockK * SD +
                                       kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
      segk, (T*)dq, H, Hkv, Lq, Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename TO, int D>
int launch_dkdv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, const int* segq,
                const int* segk, void* dk, void* dv, int BH, int H, int Hkv,
                int Lq, int Lk, int causal, int window, float scale,
                cudaStream_t stream) {
  constexpr int SD = D + 1;
  const size_t smem = sizeof(float) * (2 * kBlockK * SD + 2 * kBlockQ * SD +
                                       2 * kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_kernel<T, TO, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lk + kBlockK - 1) / kBlockK, BH);
  dkdv_kernel<T, TO, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, delta, segq,
      segk, (TO*)dk, (TO*)dv, H, Hkv, Lq, Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32 (D 16, 32, 64 or 128), 1 = bfloat16 (of q, k, v, do
// and dq; on wgmma, flash_bwd_dq_sm90.cu; D 32, 64 or 128). Returns a
// cudaError_t (0 = launched).
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
  return (int)cudaErrorInvalidValue;
}
