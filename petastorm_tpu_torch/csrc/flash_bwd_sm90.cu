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
// Head dims: instantiated at D = 32, 64 and 128, like K1 (sm90.cuh's
// Tile<D>); the wrapper pads any other D <= 128 to the next of them.
//
// Block: 288 threads (384 at D = 128, below), one 128-row kv tile of one
// q-head row (GQA: the kv row through the head map; each q head writes its
// own float32 partial). Warps 0-7 are two consumer warpgroups of 64 kv rows
// each, warp 8 the producer. TMA loads K and V (128 x D each) once; they
// stay resident. 64 x D Q and dO tiles stream through a 2-stage ring, and
// the producer's lanes write the tile's lse (pre-multiplied by log2(e); +inf
// where lse <= -5e29, a fully masked forward row, so p = 0 there), delta and
// q segment ids beside them (shared memory at D = 64: K, V 32 KB + 2 x (Q 8
// KB + dO 8 KB) + 2 x 768 B ~ 66 KB; half the tile bytes at D = 32, ~131 KB
// at D = 128). Per q tile a consumer warpgroup runs S^T = K Q^T and dP^T = V
// dO^T (2 x D/16 x m64n64k16, A and B K-major from shared memory), p^T =
// exp2(S^T scale log2e - lse log2e) and dS^T = p^T (dP^T - delta) scale on
// the accumulator fragments, then dV += P^T dO and dK += dS^T Q (2 x 4 x
// m64nDk16, at D = 128 two m64n64k16 a step; A from registers, B = dO and Q
// MN-major: the transpose bit). dK and dV stay in float32 registers for the
// whole loop. At D = 64 ptxas gives it 168 registers and spills 16 bytes
// rather than use more under this launch bound.
//
// Registers at D = 128: dK and dV over a warpgroup's 64 kv rows take 64
// floats each a thread, S^T and dP^T over a 64-row q tile 32 more each, 192
// in all against the 168 ptxas allots under a 288-thread launch bound (even
// at 32-row q tiles it spilled 564 bytes there). So at D = 128 the block has
// 384 threads: the producer warp sits in a warpgroup of its own, whose
// setmaxnreg.dec hands its registers to the two consumer warpgroups
// (setmaxnreg.inc to 232; sm90.cuh).
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
constexpr int kStages = 2;
constexpr int kConsumers = 256;

template <int D>
struct Bwd {
  // At D = 128 the producer is a whole warpgroup (one warp of it loads),
  // so that setmaxnreg can move its registers to the consumers.
  static constexpr bool kRealloc = D == 128;
  static constexpr int kThreads = kConsumers + (kRealloc ? 128 : 32);
  static constexpr int kRowsQ = 64;                  // q rows per tile
  static constexpr int kTileK = Tile<D>::bytes(kRowsK);
  static constexpr int kTileQ = Tile<D>::bytes(kRowsQ);
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + kTileK;
  static constexpr int kOffQ = kOffV + kTileK;
  static constexpr int kOffDO = kOffQ + kStages * kTileQ;
  static constexpr int kOffSide = kOffDO + kStages * kTileQ;
  static constexpr int kSide = 3 * kRowsQ;  // lse2, delta, seg per stage
  static constexpr int kOffBar = kOffSide + kStages * kSide * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;
};

template <int D, typename TO>
__global__ void __launch_bounds__(Bwd<D>::kThreads, 1)
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
  using C = Bwd<D>;
  constexpr int kRowsQ = C::kRowsQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + C::kOffSide);
  const uint32_t kvbar = base + C::kOffBar;
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
    if constexpr (C::kRealloc) {
      producer_regs();
      if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    }
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * C::kTileK);
      Tile<D>::load(base + C::kOffK, &tmK, kvbar, k0, kvh, kRowsK);
      Tile<D>::load(base + C::kOffV, &tmV, kvbar, k0, kvh, kRowsK);
    }
    for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
      const int s = i % kStages;
      const int q0 = qb * kRowsQ;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * C::kTileQ);
        Tile<D>::load(base + C::kOffQ + s * C::kTileQ, &tmQ, full, q0, bh,
                      kRowsQ);
        Tile<D>::load(base + C::kOffDO + s * C::kTileQ, &tmDO, full, q0, bh,
                      kRowsQ);
      }
      float* st = side + s * C::kSide;
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
  if constexpr (C::kRealloc) consumer_regs();
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
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;
  mbar_wait(kvbar, 0);

  for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
    const int s = i % kStages;
    const int q0 = qb * kRowsQ;
    const uint32_t qaddr = base + C::kOffQ + s * C::kTileQ;
    const uint32_t doaddr = base + C::kOffDO + s * C::kTileQ;
    const float* st = side + s * C::kSide;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[kRowsQ / 2], dp[kRowsQ / 2];
    wgmma_fence();
    wgmma_ss_tile<D>(sc, base + C::kOffK, kRowsK, 64 * wg, qaddr);
    wgmma_ss_tile<D>(dp, base + C::kOffV, kRowsK, 64 * wg, doaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && kr0 + 63 > q0;  // reaches above it
    const bool need_mask =
        diag || segq != nullptr || q0 + kRowsQ > Lq || kr0 + 64 > Lk ||
        (causal && window > 0 && q0 + kRowsQ - 1 - kr0 >= window);
#pragma unroll
    for (int r = 0; r < kRowsQ / 2; ++r) {
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

    uint32_t pa[kRowsQ / 16][4], dsa[kRowsQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk) {
      to_a_frag(sc, kk, pa[kk]);
      to_a_frag(dp, kk, dsa[kk]);
    }
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)   // 16 q rows of dO a step
      wgmma_rs_tile<D, 1>(dv_acc, pa[kk], doaddr, kRowsQ, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      wgmma_rs_tile<D, 1>(dk_acc, dsa[kk], qaddr, kRowsQ, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kpos[h]) * D;
    store_row<D>(dk + off, dk_acc, h, 1.f);
    store_row<D>(dv + off, dv_acc, h, 1.f);
  }
}

template <int D, typename TO>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* segq,
           const int* segk, void* dk, void* dv, int BH, int H, int Hkv,
           int Lq, int Lk, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Bwd<D>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!Tile<D>::make_map(&mq, q, BH, Lq, C::kRowsQ) ||
      !Tile<D>::make_map(&mdo, dout, BH, Lq, C::kRowsQ) ||
      !Tile<D>::make_map(&mk, k, BHkv, Lk, kRowsK) ||
      !Tile<D>::make_map(&mv, v, BHkv, Lk, kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90_kernel<D, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lk + kRowsK - 1) / kRowsK);
  dkdv_sm90_kernel<D, TO><<<grid, C::kThreads, C::kSmem, stream>>>(
      mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
      Lk, causal, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, const void* dout,
             const float* lse, const float* delta, const int* segq,
             const int* segk, void* dk, void* dv, int out_f32, int BH, int H,
             int Hkv, int Lq, int Lk, int causal, int window, float scale,
             cudaStream_t stream) {
  if (out_f32)
    return launch<D, float>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                            BH, H, Hkv, Lq, Lk, causal, window, scale,
                            stream);
  return launch<D, __nv_bfloat16>(q, k, v, dout, lse, delta, segq, segk, dk,
                                  dv, BH, H, Hkv, Lq, Lk, causal, window,
                                  scale, stream);
}

}  // namespace

int launch_dkdv_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* segq, const int* segk, void* dk, void* dv,
                     int out_f32, int BH, int H, int Hkv, int Lq, int Lk,
                     int D, int causal, int window, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_d<32>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                          out_f32, BH, H, Hkv, Lq, Lk, causal, window, scale,
                          stream);
    case 64:
      return launch_d<64>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                          out_f32, BH, H, Hkv, Lq, Lk, causal, window, scale,
                          stream);
    case 128:
      return launch_d<128>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                           out_f32, BH, H, Hkv, Lq, Lk, causal, window, scale,
                           stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
