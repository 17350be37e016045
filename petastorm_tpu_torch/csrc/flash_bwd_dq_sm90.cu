// Flash-attention backward dq (K2), bf16, for Hopper's tensor cores
// (sm_90a).
//
// Replaces: petastorm_tpu/ops/attention.py `_flash_bwd_dq_kernel`
// (:658-703) with `_bwd_recompute_p_ds` (:619-655), launched by
// `_flash_backward_from_prepared` (:828). The float32 instantiation stays on
// the FP32-core kernel of flash_bwd.cu (a float32 product on the tensor
// cores would be TF32); the C entry point `flash_bwd_dq` sends dtype 1 here.
//
// What bounds it: at (8, 8, 2048, 64) bf16 causal K2 does three products per
// live (q, k) pair (s, dp, dq: 6 D FLOP), 51.6 GFLOP against 84.9 MB of
// compulsory traffic (q, k, v, do read and dq written once, lse and delta
// read once), ~610 FLOP/byte, above the bf16 ridge (~295): bound by
// operations. So all three products run on wgmma, fed by TMA.
//
// Block: 288 threads, one 128-row q tile of one q-head row (GQA: the kv row
// through the head map; dq is per q head, so there are no partials). Warps
// 0-7 are two consumer warpgroups of 64 q rows each, warp 8 the producer.
// TMA loads Q and dO (128 x 64 each) once; they stay resident. 64 x 64 K and
// V tiles stream through a 4-stage ring, and the producer's lanes write the
// tile's kv segment ids beside them (shared memory: Q, dO 32 KB + 4 x (K 8
// KB + V 8 KB) + 4 x 256 B ~ 98 KB, tiles 128-byte swizzled). Each consumer
// thread reads, once, the lse (times log2(e); +inf where lse <= -5e29, a
// fully masked forward row, so p = 0 there), delta and q segment id of its
// two fragment rows into registers. Per kv tile a consumer warpgroup runs
// S = Q K^T and dP = dO V^T (4 + 4 x m64n64k16, A and B K-major from shared
// memory: K3's pair with the roles swapped), p = exp2(S scale log2e - lse
// log2e) and dS = p (dP - delta) scale on the accumulator fragments, then
// dQ += dS K (4 x m64n64k16, A = dS from registers, B = K MN-major: the
// transpose bit). dQ stays in float32 registers for the whole kv loop.
//
// Why 64-row kv tiles: registers. With 128-row tiles S and dP would take 64
// floats each a thread, beside dQ's 32 and the dS fragments' 32: well over
// the 168 registers ptxas gives K1 and K3 under this launch bound. At 64
// rows the count is 32 + 32 + 32 + 16.
//
// Precision: dS is rounded to nearest bf16 before dS K (the A operand of a
// bf16 wgmma is bf16), as aten's flash backward does; dq is rounded once to
// bf16 at the end.
//
// Masks: per element from its (row, col) on the fragment (kv tail, q tail,
// causal, window, segment equality), only on tiles that need it: the
// diagonal, the window edge, the ragged tails, or any tile with segment
// ids. Whole kv tiles above the diagonal or behind the window are skipped,
// and q blocks are launched longest causal row first. Rows past Lq read as
// TMA zeros and are not written.
//
// Shared-memory order: Q, dO, the K stages, then the V stages, so that a
// wgmma reading a K tile with the wrong layout stays inside the block's
// shared memory.
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kRowsQ = 128;                 // q rows per block
constexpr int kRowsK = 64;                  // kv rows per tile
constexpr int kStages = 4;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreadsDq = kConsumers + 32;   // + one producer warp
constexpr int kTileQ = kRowsQ * kRowBytes;  // 16 KB
constexpr int kTileK = kRowsK * kRowBytes;  // 8 KB
constexpr int kOffQ = 0;
constexpr int kOffDO = kOffQ + kTileQ;
constexpr int kOffK = kOffDO + kTileQ;
constexpr int kOffV = kOffK + kStages * kTileK;
constexpr int kOffSeg = kOffV + kStages * kTileK;
constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
constexpr int kSmemDq =                     // barriers: q, full, empty
    kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + slack to align to 1024

__global__ void __launch_bounds__(kThreadsDq, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmDO,
                   const float* __restrict__ lse_g,
                   const float* __restrict__ delta_g,
                   const int* __restrict__ segq,
                   const int* __restrict__ segk,
                   __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Lq,
                   int Lk, int causal, int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* seg_tile = reinterpret_cast<int*>(smem_raw + pad + kOffSeg);
  const uint32_t qbar = base + kOffBar;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  const int qb = gridDim.y - 1 - blockIdx.y;   // longest causal rows first
  const int kvh = kv_row(bh, H, Hkv);
  const int q0 = qb * kRowsQ;

  const int nkb = (Lk + kRowsK - 1) / kRowsK;
  int kb_lo = 0, kb_hi = nkb;
  if (causal) {
    kb_hi = min(nkb, (q0 + kRowsQ - 1) / kRowsK + 1);
    if (window > 0) {
      const int lo = q0 - window + 1;   // first position any row can see
      kb_lo = lo >= kRowsK ? lo / kRowsK : 0;
    }
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {            // producer warp
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * kTileQ);
      tma_load_3d(base + kOffQ, &tmQ, qbar, 0, q0, bh);
      tma_load_3d(base + kOffDO, &tmDO, qbar, 0, q0, bh);
    }
    for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
      const int s = i % kStages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * kTileK);
        tma_load_3d(base + kOffK + s * kTileK, &tmK, full, 0, kb * kRowsK,
                    kvh);
        tma_load_3d(base + kOffV + s * kTileK, &tmV, full, 0, kb * kRowsK,
                    kvh);
      }
      if (segk != nullptr)
        for (int j = lane; j < kRowsK; j += 32) {
          const int kp = kb * kRowsK + j;
          seg_tile[s * kRowsK + j] =
              kp < Lk ? segk[(size_t)kvh * Lk + kp] : 0;
        }
      mbar_arrive(full);
    }
    return;
  }

  // consumer warpgroup wg owns q rows r0 .. r0 + 63
  const int wg = threadIdx.x >> 7;
  const int r0 = q0 + 64 * wg;
  const float scale2 = scale * kLog2e;
  const Mask mask{Lq, Lk, causal, window};
  int qpos[2], sq[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = r0 + frag_row(2 * h);
    const bool in = qpos[h] < Lq;
    const size_t r = (size_t)bh * Lq + qpos[h];
    const float ls = in ? lse_g[r] : kNegInf;
    lse2[h] = ls > kNegInf * 0.5f ? ls * kLog2e
                                  : __int_as_float(0x7f800000);  // +inf
    dlt[h] = in ? delta_g[r] : 0.f;
    sq[h] = (segq != nullptr && in) ? segq[r] : 0;
  }
  float dq_acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) dq_acc[r] = 0.f;
  const uint64_t dqd = desc_kmajor(base + kOffQ + wg * 64 * kRowBytes);
  const uint64_t dod = desc_kmajor(base + kOffDO + wg * 64 * kRowBytes);
  mbar_wait(qbar, 0);

  for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
    const int s = i % kStages;
    const int k0 = kb * kRowsK;
    const uint32_t kaddr = base + kOffK + s * kTileK;
    const uint32_t vaddr = base + kOffV + s * kTileK;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[32], dp[32];
    const uint64_t dkd = desc_kmajor(kaddr), dvd = desc_kmajor(vaddr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)        // +32 bytes = 16 columns of D
      wgmma_ss_n64(sc, dqd + 2 * kk, dkd + 2 * kk, kk > 0);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss_n64(dp, dod + 2 * kk, dvd + 2 * kk, kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const int h = (r >> 1) & 1, c = frag_col(r);
      float p = exp2f(sc[r] * scale2 - lse2[h]);
      if (need_mask &&
          !mask(qpos[h], k0 + c, sq[h],
                segk != nullptr ? seg_tile[s * kRowsK + c] : 0))
        p = 0.f;
      dp[r] = p * (dp[r] - dlt[h]) * scale;   // dp now holds ds
    }

    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) to_a_frag(dp, kk, dsa[kk]);
    fence_regs(dq_acc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)        // 16 kv rows of K = 2048 bytes
      wgmma_rs_n64<1>(dq_acc, dsa[kk],
                      desc_mnmajor(kaddr + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    mbar_arrive(empty0 + 8 * s);
  }

  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qpos[h] >= Lq) continue;
    __nv_bfloat16* row = dq + ((size_t)bh * Lq + qpos[h]) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * cq) =
          __floats2bfloat162_rn(dq_acc[r], dq_acc[r + 1]);
    }
  }
}

}  // namespace

int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* segq, const int* segk, void* dq, int BH, int H,
                   int Hkv, int Lq, int Lk, int causal, int window,
                   float scale, cudaStream_t stream) {
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!sm90::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !sm90::make_map(&mdo, dout, BH, Lq, kRowsQ) ||
      !sm90::make_map(&mk, k, BHkv, Lk, kRowsK) ||
      !sm90::make_map(&mv, v, BHkv, Lk, kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemDq);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lq + kRowsQ - 1) / kRowsQ);
  dq_sm90_kernel<<<grid, kThreadsDq, kSmemDq, stream>>>(
      mq, mk, mv, mdo, lse, delta, segq, segk, (__nv_bfloat16*)dq, H, Hkv,
      Lq, Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash
