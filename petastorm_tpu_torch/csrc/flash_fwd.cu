// Flash-attention forward (K1), float32, for Hopper's FP32 CUDA cores; and
// the C entry point `flash_fwd`, which sends bf16 (dtype 1) to the
// tensor-core kernel of flash_fwd_sm90.cu.
//
// Replaces: petastorm_tpu/ops/attention.py `_flash_kernel` (:260-348),
// launched by `_pallas_flash` (:494-561).
//
// What it computes: online-softmax attention o = softmax(q k^T * scale) v
// with the reference's mask (kv/q tail, causal, sliding window, segment
// equality), plus lse = m + log(l) per row as float32 (BH, Lq). A fully
// masked row gives o = 0 and lse = -1e30, as the reference does.
//
// Grid: one block per (q-block of 64 rows, flat batch-head row). The
// reference's sequential "arbitrary" kv grid axis and its VMEM scratch
// (:287-294, :547-554) become a loop over kv blocks inside the block, with
// m and l in registers and the output accumulator in registers. Whole kv
// blocks above the diagonal or behind the window are skipped with the rule
// of :296-303. q blocks are launched last-first so the longest causal rows
// start first. No lane-replicated lse, no sublane-replicated segment block,
// no zero-padding copies: lse is written as (BH, Lq), segment ids are read
// as (rows, L) int32, and the ragged edge is masked in the loads.
//
// Why float32 stays here: the tensor cores would multiply float32 as TF32
// (about three decimal digits), and the float32 path is held to
// atol = rtol = 1e-4. This kernel multiplies on the FP32 CUDA cores
// (67 TFLOP/s peak): float32 tiles in padded shared memory (row stride
// D+1, conflict-free column reads), a 4 x 4 register micro-tile of the
// score block and a 4 x D/16 tile of the output per thread. No path of the
// port runs float32 attention on the card; the bf16 path is the LM's.
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ segq,
               const int* __restrict__ segk, T* __restrict__ o,
               float* __restrict__ lse, int H, int Hkv, int Lq, int Lk,
               int causal, int window, float scale) {
  constexpr int SD = D + 1, SP = kBlockK + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;                    // kBlockQ x SD
  float* sK = sQ + kBlockQ * SD;       // kBlockK x SD
  float* sV = sK + kBlockK * SD;       // kBlockK x D
  float* sP = sV + kBlockK * D;        // kBlockQ x SP

  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int kvh = kv_row(bh, H, Hkv);
  const int q0 = qb * kBlockQ;
  const Lane ln = lane_layout();
  const Mask mask{Lq, Lk, causal, window};

  const T* qp = q + (size_t)bh * Lq * D;
  const T* kp = k + (size_t)kvh * Lk * D;
  const T* vp = v + (size_t)kvh * Lk * D;
  load_tile<D, kBlockQ>(sQ, SD, qp, q0, Lq);

  float m[kSub], l[kSub], acc[kSub][NJ];
  int qpos[kSub], sq[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
    qpos[i] = q0 + ln.ty + 16 * i;
    sq[i] = (segq != nullptr && qpos[i] < Lq) ? segq[(size_t)bh * Lq + qpos[i]]
                                              : 0;
  }

  const int nkb = (Lk + kBlockK - 1) / kBlockK;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {
    kb_hi = min(nkb, (q0 + kBlockQ - 1) / kBlockK + 1);
    if (window > 0) {
      const int lo = q0 - window + 1;   // first position any row can see
      kb_lo = lo >= kBlockK ? lo / kBlockK : 0;
    }
  }

  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();                    // previous tile fully consumed
    load_tile<D, kBlockK>(sK, SD, kp, k0, Lk);
    load_tile<D, kBlockK>(sV, D, vp, k0, Lk);
    __syncthreads();

    float s[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[kSub], b[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = sQ[(ln.ty + 16 * i) * SD + d];
#pragma unroll
      for (int j = 0; j < kSub; ++j) b[j] = sK[(ln.tx + 16 * j) * SD + d];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    int kpos[kSub], sk[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      kpos[j] = k0 + ln.tx + 16 * j;
      sk[j] = (segk != nullptr && kpos[j] < Lk)
                  ? segk[(size_t)kvh * Lk + kpos[j]]
                  : 0;
    }
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      bool ok[kSub];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        ok[j] = mask(qpos[i], kpos[j], sq[i], sk[j]);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        sP[(ln.ty + 16 * i) * SP + ln.tx + 16 * j] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBlockK; ++kk) {
      float p[kSub], b[NJ];
#pragma unroll
      for (int i = 0; i < kSub; ++i) p[i] = sP[(ln.ty + 16 * i) * SP + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) b[j] = sV[kk * D + ln.tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], b[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    if (qpos[i] >= Lq) continue;
    const float safe_l = l[i] == 0.f ? 1.f : l[i];
    T* orow = o + ((size_t)bh * Lq + qpos[i]) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      orow[ln.tx + 16 * j] = from_f32<T>(acc[i][j] / safe_l);
    if (lse != nullptr && ln.tx == 0)
      lse[(size_t)bh * Lq + qpos[i]] =
          l[i] == 0.f ? kNegInf : m[i] + logf(safe_l);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const int* segq,
               const int* segk, void* o, float* lse, int BH, int H, int Hkv,
               int Lq, int Lk, int causal, int window, float scale,
               cudaStream_t stream) {
  constexpr int SD = D + 1;
  const size_t smem =
      sizeof(float) * ((kBlockQ + kBlockK) * SD + kBlockK * D +
                       kBlockQ * (kBlockK + 1));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Lq + kBlockQ - 1) / kBlockQ, BH);
  fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, segq, segk, (T*)o, lse, H, Hkv,
      Lq, Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash

// dtype: 0 = float32 (FP32 cores, above; D 16, 32, 64 or 128), 1 =
// bfloat16 (wgmma, flash_fwd_sm90.cu; D 32, 64 or 128). Returns a
// cudaError_t (0 = launched).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         const int* segq, const int* segk, void* o, float* lse,
                         int BH, int H, int Hkv, int Lq, int Lk, int D,
                         int causal, int window, float scale, int dtype,
                         void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return flash::launch_fwd_sm90(q, k, v, segq, segk, o, lse, BH, H, Hkv, Lq,
                                  Lk, D, causal, window, scale, s);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  switch (D) {
#define FLASH_FWD_CASE(HD)                                                  \
  case HD:                                                                  \
    return flash::launch_fwd<float, HD>(q, k, v, segq, segk, o, lse, BH, H, \
                                        Hkv, Lq, Lk, causal, window, scale, \
                                        s);
    FLASH_FOR_HEAD_DIMS_F32(FLASH_FWD_CASE)
#undef FLASH_FWD_CASE
  }
  return (int)cudaErrorInvalidValue;
}
