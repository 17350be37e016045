// Flash-attention backward dk/dv (K3), bf16, for Hopper's tensor cores
// (sm_90a).
//
// Replaces: petastorm_tpu/ops/attention.py `_flash_bwd_dkdv_kernel`
// (:706-754) with `_bwd_recompute_p_ds` (:619-655), launched by
// `_flash_backward_from_prepared` (:861). The float32 instantiation stays on
// the FP32-core kernel of flash_bwd.cu; the C entry point `flash_bwd_dkdv`
// sends dtype 1 here.
//
// What bounds it: at (8, 8, 2048, 64) bf16 causal K3 does four products per
// live (q, k) pair, 69 GFLOP against 102 MB of compulsory traffic, ~680
// FLOP/byte (the forward's ~510 and more): bound by operations, so all
// four products run on wgmma, fed by TMA.
//
// Block: 288 threads, one 128-row kv tile of one q-head row (GQA: the kv
// row through the head map; each q head writes its own float32 partial).
// Warps 0-7 are two consumer warpgroups of 64 kv rows each, warp 8 the
// producer. TMA loads K and V (128 x 64 each) once; they stay resident.
// 64 x 64 Q and dO tiles stream through a 2-stage ring, and the producer's
// lanes write the tile's lse (pre-multiplied by log2(e); +inf where lse <=
// -5e29, a fully masked forward row, so p = 0 there), delta and q segment
// ids beside them (shared memory: K, V 32 KB + 2 x (Q 8 KB + dO 8 KB) +
// 2 x 768 B ~ 66 KB, tiles 128-byte swizzled). Per q tile a consumer
// warpgroup runs S^T = K Q^T and dP^T = V dO^T (4 + 4 x m64n64k16, A and B
// K-major from shared memory), p^T = exp2(S^T scale log2e - lse log2e) and
// dS^T = p^T (dP^T - delta) scale on the accumulator fragments, then
// dV += P^T dO and dK += dS^T Q (4 + 4 x m64n64k16, A from registers, B =
// dO and Q MN-major: the transpose bit). dK and dV stay in float32
// registers for the whole loop. ptxas gives it 168 registers and spills 16
// bytes rather than use more under this launch bound.
//
// Precision: P^T and dS^T are rounded to nearest bf16 before the second
// products (the A operand of a bf16 wgmma is bf16), as aten's flash
// backward does; dk and dv are rounded once to bf16 at the end (float32
// partials under GQA).
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kRowsK = 128;                 // kv rows per block
constexpr int kRowsQ = 64;                  // q rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;
constexpr int kThreadsBwd = kConsumers + 32;
constexpr int kTileK = kRowsK * kRowBytes;  // 16 KB
constexpr int kTileQ = kRowsQ * kRowBytes;  // 8 KB
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + kTileK;
constexpr int kOffQ = kOffV + kTileK;
constexpr int kOffDO = kOffQ + kStages * kTileQ;
constexpr int kOffSide = kOffDO + kStages * kTileQ;
constexpr int kSide = 3 * kRowsQ;           // lse2, delta, seg per stage
constexpr int kOffBar = kOffSide + kStages * kSide * 4;
constexpr int kSmemBwd = kOffBar + 64 + 1024;

template <typename TO>
__device__ __forceinline__ void store2(TO* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p,
                                                      float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename TO>
__global__ void __launch_bounds__(kThreadsBwd, 1)
    dkdv_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                     const __grid_constant__ CUtensorMap tmK,
                     const __grid_constant__ CUtensorMap tmV,
                     const __grid_constant__ CUtensorMap tmDO,
                     const float* __restrict__ lse_g,
                     const float* __restrict__ delta_g,
                     const int* __restrict__ segq,
                     const int* __restrict__ segk, TO* __restrict__ dk,
                     TO* __restrict__ dv, int H, int Hkv, int Lq, int Lk,
                     int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + kOffSide);
  const uint32_t kvbar = base + kOffBar;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;                 // q-head row
  const int kb = blockIdx.y;                 // longest (first) kv tiles first
  const int kvh = kv_row(bh, H, Hkv);
  const int k0 = kb * kRowsK;

  const int nqb = (Lq + kRowsQ - 1) / kRowsQ;
  int qb_lo = 0, qb_hi = nqb;
  if (causal) {
    qb_lo = k0 / kRowsQ;                     // first q tile reaching k0
    if (window > 0)                          // last q tile the window allows
      qb_hi = min(nqb, (k0 + kRowsK - 2 + window) / kRowsQ + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * kTileK);
      tma_load_3d(base + kOffK, &tmK, kvbar, 0, k0, kvh);
      tma_load_3d(base + kOffV, &tmV, kvbar, 0, k0, kvh);
    }
    for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
      const int s = i % kStages;
      const int q0 = qb * kRowsQ;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * kTileQ);
        tma_load_3d(base + kOffQ + s * kTileQ, &tmQ, full, 0, q0, bh);
        tma_load_3d(base + kOffDO + s * kTileQ, &tmDO, full, 0, q0, bh);
      }
      float* st = side + s * kSide;
      for (int j = lane; j < kRowsQ; j += 32) {
        const int qp = q0 + j;
        const bool in = qp < Lq;
        const size_t r = (size_t)bh * Lq + qp;
        const float ls = in ? lse_g[r] : kNegInf;
        st[j] = ls > kNegInf * 0.5f ? ls * kLog2e
                                    : __int_as_float(0x7f800000);  // +inf
        st[kRowsQ + j] = in ? delta_g[r] : 0.f;
        reinterpret_cast<int*>(st)[2 * kRowsQ + j] =
            (segq != nullptr && in) ? segq[r] : 0;
      }
      mbar_arrive(full);
    }
    return;
  }

  // consumer warpgroup wg owns kv rows kr0 .. kr0 + 63
  const int wg = threadIdx.x >> 7;
  const int kr0 = k0 + 64 * wg;
  const float scale2 = scale * kLog2e;
  const Mask mask{Lq, Lk, causal, window};
  int kpos[2], sk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kpos[h] = kr0 + frag_row(2 * h);
    sk[h] = (segk != nullptr && kpos[h] < Lk)
                ? segk[(size_t)kvh * Lk + kpos[h]]
                : 0;
  }
  float dk_acc[32], dv_acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) dk_acc[r] = dv_acc[r] = 0.f;
  const uint64_t dkk = desc_kmajor(base + kOffK + wg * 64 * kRowBytes);
  const uint64_t dvk = desc_kmajor(base + kOffV + wg * 64 * kRowBytes);
  mbar_wait(kvbar, 0);

  for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
    const int s = i % kStages;
    const int q0 = qb * kRowsQ;
    const uint32_t qaddr = base + kOffQ + s * kTileQ;
    const uint32_t doaddr = base + kOffDO + s * kTileQ;
    const float* st = side + s * kSide;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[32], dp[32];
    const uint64_t dq = desc_kmajor(qaddr), ddo = desc_kmajor(doaddr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(sc, dkk + 2 * kk, dq + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(dp, dvk + 2 * kk, ddo + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && kr0 + 63 > q0;  // reaches above it
    const bool need_mask =
        diag || segq != nullptr || q0 + kRowsQ > Lq || kr0 + 64 > Lk ||
        (causal && window > 0 && q0 + kRowsQ - 1 - kr0 >= window);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int c = frag_col(r);
      float p = exp2f(sc[r] * scale2 - st[c]);
      if (need_mask &&
          !mask(q0 + c, kpos[(r >> 1) & 1],
                reinterpret_cast<const int*>(st)[2 * kRowsQ + c],
                sk[(r >> 1) & 1]))
        p = 0.f;
      sc[r] = p;
      dp[r] = p * (dp[r] - st[kRowsQ + c]) * scale;
    }

    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      to_a_frag(sc, kk, pa[kk]);
      to_a_frag(dp, kk, dsa[kk]);
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)        // 16 q rows of dO = 2048 bytes
      wgmma_rs_n64<1>(dv_acc, pa[kk],
                      desc_mnmajor(doaddr + kk * 16 * kRowBytes));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_n64<1>(dk_acc, dsa[kk],
                      desc_mnmajor(qaddr + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(empty0 + 8 * s);
  }

  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kpos[h]) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * h;
      store2<TO>(dk + off + 8 * j + 2 * cq, dk_acc[r], dk_acc[r + 1]);
      store2<TO>(dv + off + 8 * j + 2 * cq, dv_acc[r], dv_acc[r + 1]);
    }
  }
}

template <typename TO>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const CUtensorMap& mdo, const float* lse,
           const float* delta, const int* segq, const int* segk, void* dk,
           void* dv, int BH, int H, int Hkv, int Lq, int Lk, int causal,
           int window, float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBwd);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lk + kRowsK - 1) / kRowsK);
  dkdv_sm90_kernel<TO><<<grid, kThreadsBwd, kSmemBwd, stream>>>(
      mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
      Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_dkdv_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* segq, const int* segk, void* dk, void* dv,
                     int out_f32, int BH, int H, int Hkv, int Lq, int Lk,
                     int causal, int window, float scale,
                     cudaStream_t stream) {
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !sm90::make_map(&mdo, dout, BH, Lq, kRowsQ) ||
      !sm90::make_map(&mk, k, BHkv, Lk, kRowsK) ||
      !sm90::make_map(&mv, v, BHkv, Lk, kRowsK))
    return (int)cudaErrorInvalidValue;
  if (out_f32)
    return launch<float>(mq, mk, mv, mdo, lse, delta, segq, segk, dk, dv, BH,
                         H, Hkv, Lq, Lk, causal, window, scale, stream);
  return launch<__nv_bfloat16>(mq, mk, mv, mdo, lse, delta, segq, segk, dk,
                               dv, BH, H, Hkv, Lq, Lk, causal, window, scale,
                               stream);
}

}  // namespace flash
