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
// Head dims: D = 32 runs its own kernel (dkdv_sm90_d32_kernel, below), D =
// 64 and 128 the one described next, D = 256 the split kernel
// (dkdv_sm90_split_kernel); the wrapper pads any other D <= 256 to the next
// of them (bf16 D 16 and 24 to 32), and any D past 256 to the next multiple
// of 64, which runs the wide kernel (dkdv_wide_sm90_kernel).
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
// D = 256: at 64 kv rows, dK and dV in one warpgroup would take 128 floats
// each a thread. So the split kernel's block holds 64 kv rows and its two
// consumer warpgroups split D: warpgroup w accumulates columns 128 w .. 128
// w + 127 of dK and dV (64 + 64 floats a thread, as at D = 128). S^T and
// dP^T contract over all of D and are computed once: warpgroup w takes q
// columns 32 w .. 32 w + 31 of the 64-row q tile (2 x 16 x m64n32k16),
// turns them into P^T and dS^T, rounds them to bf16 as the A fragments of
// its two k16 steps, and the two warpgroups swap those fragments through
// shared memory (16 KB, a named barrier on each side), so each then runs
// its dV and dK products over the whole q tile (2 x 4 x 2 m64n64k16).
// Shared memory: K, V 32 KB each; Q and dO 32 KB a stage each, 2 stages;
// the swap 16 KB; ~211 KB. 384 threads, setmaxnreg as at D = 128.
//
// D = 32 (dkdv_sm90_d32_kernel): the block, tiles and schedule of D = 64,
// but at this width a (q, k) pair costs as much in elementwise work (one
// exponential on the special-function unit, 16 a clock an SM, and some
// eight more instructions) as in products. So the exponential is
// ex2.approx (its result rounded to bf16 next), and the mask selects
// instead of branching (Mask::live), in a loop of its own for the tiles
// that need it: with a branch an element the compiler could not interleave
// the elements' exponentials, and each waited out the last. Q and dO
// stream through 4 stages; the producer loads a tile's lse, delta and
// segment ids one tile ahead (load_side), off the ring's path. 384 threads
// with setmaxnreg; shared memory ~53 KB.
//
// Precision: P^T and dS^T are rounded to nearest bf16 before the second
// products (the A operand of a bf16 wgmma is bf16), as aten's flash
// backward does; dk and dv are rounded once to bf16 at the end (float32
// partials under GQA).
//
// Past D = 256 (dkdv_wide_sm90_kernel): K and V (128 x D each) no longer fit
// beside the Q and dO stages, nor dK and dV over all of D in registers. A
// block owns 128 kv rows (64 a consumer warpgroup) and one 128-column slice
// of dK and dV (blockIdx.z), 64 + 64 floats a thread as at D = 128, 384
// threads with setmaxnreg. Per 64-row q tile the producer streams D/64
// chunks (K, V 128 x 64 and Q, dO 64 x 64, 48 KB) through a 3-stage ring,
// then Q's and dO's slices (64 x 128 each) with the tile's lse, delta and
// segment ids through a 2-stage ring; the consumers add each chunk to S^T
// and dP^T (2 x 4 x m64n64k16), each chunk's products issued before the
// last chunk's are retired (wgmma_wait<1>, then that chunk's stage
// freed), then run dV += P^T dO_slice and dK += dS^T Q_slice as at D =
// 128, the elementwise work in the D = 32 kernel's form (ex2.approx, one
// FFMA for the scale and the lse, the mask a select in a loop of its own
// for the tiles that need it). Each slice recomputes S^T and dP^T over all
// of D (D/128 times the score products), and K and V are read again for
// every q tile. ~211 KB. Splitting D across a thread block cluster instead
// (each block's K and V columns resident, the blocks' partial S^T and dP^T
// summed through distributed shared memory) ran 1.7-2.5x slower at D 512
// and 576 on an H100: the partials' traffic between the SMs bound it
// (PERF.md, PR 28).
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kStages = 2;
constexpr int kConsumers = 256;

template <int D>
struct Bwd {
  // At D = 128 the producer is a whole warpgroup (one warp of it loads),
  // so that setmaxnreg can move its registers to the consumers.
  static constexpr bool kRealloc = D == 128;
  static constexpr int kThreads = kConsumers + (kRealloc ? 128 : 32);
  static constexpr int kRowsK = 128;                 // kv rows per block
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

// The producer warp of both kernels (C: the block's layout, Bwd or Split):
// K and V of the block's kv rows once, on `kvbar`; then the Q and dO tiles
// of q tiles qb_lo .. qb_hi - 1 through the ring, and beside each the
// tile's lse (times log2(e); +inf where lse <= -5e29, a fully masked
// forward row, so p = 0 there), delta and q segment ids.
template <int D, class C>
__device__ __forceinline__ void produce(
    uint32_t base, float* side, const CUtensorMap* tmQ,
    const CUtensorMap* tmK, const CUtensorMap* tmV, const CUtensorMap* tmDO,
    uint32_t kvbar, uint32_t full0, uint32_t empty0,
    const float* __restrict__ lse_g, const float* __restrict__ delta_g,
    const int* __restrict__ segq, int bh, int kvh, int k0, int qb_lo,
    int qb_hi, int Lq) {
  constexpr int kRowsQ = C::kRowsQ;
  const int lane = threadIdx.x & 31;
  if (lane == 0) {
    mbar_arrive_tx(kvbar, 2 * C::kTileK);
    Tile<D>::load(base + C::kOffK, tmK, kvbar, k0, kvh, C::kRowsK);
    Tile<D>::load(base + C::kOffV, tmV, kvbar, k0, kvh, C::kRowsK);
  }
  for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
    const int s = i % kStages;
    const int q0 = qb * kRowsQ;
    const uint32_t full = full0 + 8 * s;
    mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
    if (lane == 0) {
      mbar_arrive_tx(full, 2 * C::kTileQ);
      Tile<D>::load(base + C::kOffQ + s * C::kTileQ, tmQ, full, q0, bh,
                    kRowsQ);
      Tile<D>::load(base + C::kOffDO + s * C::kTileQ, tmDO, full, q0, bh,
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
}

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
                     int causal, int window, float scale, int y0) {
  using C = Bwd<D>;
  constexpr int kRowsK = C::kRowsK, kRowsQ = C::kRowsQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + C::kOffSide);
  const uint32_t kvbar = base + C::kOffBar;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;                 // q-head row
  const int kb = y0 + (int)blockIdx.y;      // longest (first) kv tiles first
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
    produce<D, C>(base, side, &tmQ, &tmK, &tmV, &tmDO, kvbar, full0,
                  empty0, lse_g, delta_g, segq, bh, kvh, k0, qb_lo, qb_hi,
                  Lq);
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

// Head dim 32 (see the top of this file): D = 64's schedule, the
// exponential on ex2.approx, the mask a select, a deeper ring.
struct BwdD32 {
  static constexpr int D = 32;
  static constexpr int kThreads = kConsumers + 128;  // producer warpgroup
  static constexpr int kStages = 4;
  static constexpr int kRowsK = 128;                 // kv rows per block
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
  static constexpr int kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

// A tile's lse, delta and q segment ids as the producer's lanes load them
// (rows lane and lane + 32), written to shared memory a tile later.
struct SideRows {
  float lse[2], delta[2];
  int seg[2];
};

__device__ __forceinline__ SideRows load_side(
    const float* __restrict__ lse_g, const float* __restrict__ delta_g,
    const int* __restrict__ segq, int bh, int q0, int Lq, int lane) {
  SideRows t;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int qp = q0 + lane + 32 * j;
    const bool in = qp < Lq;
    const size_t r = (size_t)bh * Lq + qp;
    t.lse[j] = in ? lse_g[r] : kNegInf;
    t.delta[j] = in ? delta_g[r] : 0.f;
    t.seg[j] = (segq != nullptr && in) ? segq[r] : 0;
  }
  return t;
}

template <typename TO>
__global__ void __launch_bounds__(BwdD32::kThreads, 1)
    dkdv_sm90_d32_kernel(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const __grid_constant__ CUtensorMap tmDO,
                         const float* __restrict__ lse_g,
                         const float* __restrict__ delta_g,
                         const int* __restrict__ segq,
                         const int* __restrict__ segk, TO* __restrict__ dk,
                         TO* __restrict__ dv, int H, int Hkv, int Lq, int Lk,
                         int causal, int window, float scale, int y0) {
  using C = BwdD32;
  constexpr int D = C::D, kRowsK = C::kRowsK, kRowsQ = C::kRowsQ;
  constexpr int kS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + C::kOffSide);
  const uint32_t kvbar = base + C::kOffBar;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * kS;

  const int bh = blockIdx.x;                 // q-head row
  const int kb = y0 + (int)blockIdx.y;       // longest (first) kv tiles first
  const int kvh = kv_row(bh, H, Hkv);
  const int k0 = kb * kRowsK;

  const int nqb = (Lq + kRowsQ - 1) / kRowsQ;
  int qb_lo = 0, qb_hi = nqb;
  if (causal) {
    qb_lo = k0 / kRowsQ;                     // first q tile reaching k0
    if (window > 0)                          // last q tile the window allows
      qb_hi = min(nqb, (k0 + kRowsK - 2 + window) / kRowsQ + 1);
  }
  const int n = max(qb_hi - qb_lo, 0);       // q tiles of this block

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // producer warpgroup
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(kvbar, 2 * C::kTileK);
      Tile<D>::load(base + C::kOffK, &tmK, kvbar, k0, kvh, kRowsK);
      Tile<D>::load(base + C::kOffV, &tmV, kvbar, k0, kvh, kRowsK);
    }
    // the side rows of tile i + 1 are loaded while tile i's wait for its
    // stage, so their latency is off the ring's path
    SideRows next = load_side(lse_g, delta_g, segq, bh, qb_lo * kRowsQ, Lq,
                              lane);
    for (int i = 0; i < n; ++i) {
      const int s = i % kS;
      const int q0 = (qb_lo + i) * kRowsQ;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kS) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * C::kTileQ);
        Tile<D>::load(base + C::kOffQ + s * C::kTileQ, &tmQ, full, q0, bh,
                      kRowsQ);
        Tile<D>::load(base + C::kOffDO + s * C::kTileQ, &tmDO, full, q0, bh,
                      kRowsQ);
      }
      float* st = side + s * C::kSide;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = lane + 32 * j;
        st[row] = next.lse[j] > kNegInf * 0.5f
                      ? next.lse[j] * kLog2e
                      : __int_as_float(0x7f800000);  // +inf: p = 0
        st[kRowsQ + row] = next.delta[j];
        reinterpret_cast<int*>(st)[2 * kRowsQ + row] = next.seg[j];
      }
      if (i + 1 < n)
        next = load_side(lse_g, delta_g, segq, bh, q0 + kRowsQ, Lq, lane);
      mbar_arrive(full);
    }
    return;
  }

  // consumer warpgroup wg owns kv rows kr0 .. kr0 + 63
  consumer_regs();
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

  for (int i = 0; i < n; ++i) {
    const int s = i % kS;
    const int q0 = (qb_lo + i) * kRowsQ;
    const uint32_t qaddr = base + C::kOffQ + s * C::kTileQ;
    const uint32_t doaddr = base + C::kOffDO + s * C::kTileQ;
    const float* st = side + s * C::kSide;
    mbar_wait(full0 + 8 * s, (i / kS) & 1);

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
    // sc becomes p^T and dp dS^T; the mask, where a tile needs it, selects
    if (need_mask) {
      const int* seg = reinterpret_cast<const int*>(st) + 2 * kRowsQ;
#pragma unroll
      for (int r = 0; r < kRowsQ / 2; ++r) {
        const int c = frag_col(r), h = (r >> 1) & 1;
        const float p = ex2(sc[r] * scale2 - st[c]);
        sc[r] = mask.live(q0 + c, kpos[h], seg[c], sk[h]) ? p : 0.f;
        dp[r] = sc[r] * (dp[r] - st[kRowsQ + c]) * scale;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsQ / 2; ++r) {
        const int c = frag_col(r);
        sc[r] = ex2(sc[r] * scale2 - st[c]);
        dp[r] = sc[r] * (dp[r] - st[kRowsQ + c]) * scale;
      }
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

// Head dim 256 (see the top of this file): 64 kv rows a block, D split
// between the two consumer warpgroups, P^T and dS^T swapped through shared
// memory.
template <int D>
struct Split {
  static_assert(D == 256, "the split kernel is the head dim 256 one");
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kRowsK = 64;                  // kv rows per block
  static constexpr int kRowsQ = 64;                  // q rows per tile
  static constexpr int kTileK = Tile<D>::bytes(kRowsK);
  static constexpr int kTileQ = Tile<D>::bytes(kRowsQ);
  static constexpr int kOffK = 0;
  static constexpr int kOffV = kOffK + kTileK;
  static constexpr int kOffQ = kOffV + kTileK;
  static constexpr int kOffDO = kOffQ + kStages * kTileQ;
  // 16 words a consumer thread: its P^T then dS^T fragments (2 k16 steps)
  static constexpr int kOffSwap = kOffDO + kStages * kTileQ;
  static constexpr int kOffSide = kOffSwap + kConsumers * 16 * 4;
  static constexpr int kSide = 3 * kRowsQ;  // lse2, delta, seg per stage
  static constexpr int kOffBar = kOffSide + kStages * kSide * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;
};

template <int D, typename TO>
__global__ void __launch_bounds__(Split<D>::kThreads, 1)
    dkdv_sm90_split_kernel(const __grid_constant__ CUtensorMap tmQ,
                           const __grid_constant__ CUtensorMap tmK,
                           const __grid_constant__ CUtensorMap tmV,
                           const __grid_constant__ CUtensorMap tmDO,
                           const float* __restrict__ lse_g,
                           const float* __restrict__ delta_g,
                           const int* __restrict__ segq,
                           const int* __restrict__ segk,
                           TO* __restrict__ dk, TO* __restrict__ dv, int H,
                           int Hkv, int Lq, int Lk, int causal, int window,
                           float scale, int y0) {
  using C = Split<D>;
  constexpr int kRowsK = C::kRowsK, kRowsQ = C::kRowsQ;
  constexpr int kHalf = D / 2;               // dK, dV columns a warpgroup
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + C::kOffSide);
  uint32_t* swap = reinterpret_cast<uint32_t*>(smem_raw + pad + C::kOffSwap);
  const uint32_t kvbar = base + C::kOffBar;
  const uint32_t full0 = kvbar + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;                 // q-head row
  const int kb = y0 + (int)blockIdx.y;
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

  if (threadIdx.x >= kConsumers) {           // producer warpgroup
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    produce<D, C>(base, side, &tmQ, &tmK, &tmV, &tmDO, kvbar, full0,
                  empty0, lse_g, delta_g, segq, bh, kvh, k0, qb_lo, qb_hi,
                  Lq);
    return;
  }

  // consumer warpgroup wg: dK, dV columns kHalf wg .., S^T's q columns
  // 32 wg .. 32 wg + 31; both over all 64 kv rows of the block
  consumer_regs();
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const float scale2 = scale * kLog2e;
  const Mask mask{Lq, Lk, causal, window};
  int kpos[2], sk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    kpos[h] = k0 + frag_row(2 * h);
    sk[h] = (segk != nullptr && kpos[h] < Lk)
                ? segk[(size_t)kvh * Lk + kpos[h]]
                : 0;
  }
  // this warpgroup's half of each tile: blocks 2 wg, 2 wg + 1 of the four,
  // laid out as a (rows, kHalf) tile (sm90.cuh)
  const uint32_t half_k = 2 * wg * kRowsQ * Tile<D>::kRowBytes;
  uint32_t* mine = swap + wg * 16 * 128 + t;
  const uint32_t* theirs = swap + (1 - wg) * 16 * 128 + t;
  float dk_acc[kHalf / 2], dv_acc[kHalf / 2];
#pragma unroll
  for (int r = 0; r < kHalf / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;
  mbar_wait(kvbar, 0);

  for (int qb = qb_lo, i = 0; qb < qb_hi; ++qb, ++i) {
    const int s = i % kStages;
    const int q0 = qb * kRowsQ;
    const uint32_t qaddr = base + C::kOffQ + s * C::kTileQ;
    const uint32_t doaddr = base + C::kOffDO + s * C::kTileQ;
    const float* st = side + s * C::kSide;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[16], dp[16];                    // 64 kv rows x 32 q columns
    wgmma_fence();
    wgmma_ss_tile<D>(sc, base + C::kOffK, kRowsK, 0, qaddr, kRowsQ, 32 * wg);
    wgmma_ss_tile<D>(dp, base + C::kOffV, kRowsK, 0, doaddr, kRowsQ,
                     32 * wg);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && k0 + kRowsK - 1 > q0;  // reaches above it
    const bool need_mask =
        diag || segq != nullptr || q0 + kRowsQ > Lq || k0 + kRowsK > Lk ||
        (causal && window > 0 && q0 + kRowsQ - 1 - k0 >= window);
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int c = 32 * wg + frag_col(r);   // q row within the tile
      float p = exp2f(sc[r] * scale2 - st[c]);
      if (need_mask &&
          !mask(q0 + c, kpos[(r >> 1) & 1],
                reinterpret_cast<const int*>(st)[2 * kRowsQ + c],
                sk[(r >> 1) & 1]))
        p = 0.f;
      sc[r] = p;
      dp[r] = p * (dp[r] - st[kRowsQ + c]) * scale;
    }

    // [0], [1]: this warpgroup's k16 steps (q rows 32 wg ..); [2], [3]: the
    // other's, through shared memory
    uint32_t pa[4][4], dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      to_a_frag(sc, kk, pa[kk]);
      to_a_frag(dp, kk, dsa[kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mine[(4 * kk + j) * 128] = pa[kk][j];
        mine[(8 + 4 * kk + j) * 128] = dsa[kk][j];
      }
    }
    consumer_sync();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        pa[2 + kk][j] = theirs[(4 * kk + j) * 128];
        dsa[2 + kk][j] = theirs[(8 + 4 * kk + j) * 128];
      }
    consumer_sync();                         // the swap may be written again

    fence_regs(dk_acc);
    fence_regs(dv_acc);
    fence_regs(pa);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {         // 16 q rows of dO a step
      const int qr = 16 * (kk < 2 ? 2 * wg + kk : 2 * (1 - wg) + kk - 2);
      wgmma_rs_tile<kHalf, 1>(dv_acc, pa[kk], doaddr + half_k, kRowsQ, qr);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int qr = 16 * (kk < 2 ? 2 * wg + kk : 2 * (1 - wg) + kk - 2);
      wgmma_rs_tile<kHalf, 1>(dk_acc, dsa[kk], qaddr + half_k, kRowsQ, qr);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kpos[h]) * D + kHalf * wg;
    store_row<kHalf>(dk + off, dk_acc, h, 1.f);
    store_row<kHalf>(dv + off, dv_acc, h, 1.f);
  }
}

// Head dims past 256 (see the top of this file): one 128-column slice of
// dK and dV a block, S^T and dP^T streamed over D in 64-column chunks.
struct BwdWide {
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kW = 128;                 // dK, dV columns a block
  static constexpr int kRowsK = 128;             // kv rows per block
  static constexpr int kRowsQ = 64;              // q rows per tile
  static constexpr int kChunkStages = 3;
  static constexpr int kSliceStages = 2;
  static constexpr int kChunkK = kRowsK * kChunkRowBytes;   // K, V: 16 KB
  static constexpr int kChunkQ = kRowsQ * kChunkRowBytes;   // Q, dO: 8 KB
  static constexpr int kOffV = kChunkK;
  static constexpr int kOffQ = 2 * kChunkK;
  static constexpr int kOffDO = kOffQ + kChunkQ;
  static constexpr int kChunk = kOffDO + kChunkQ;            // 48 KB
  static constexpr int kSliceQ = Tile<kW>::bytes(kRowsQ);    // Q, dO: 16 KB
  static constexpr int kSlice = 2 * kSliceQ;
  static constexpr int kOffSlice = kChunkStages * kChunk;
  static constexpr int kOffSide = kOffSlice + kSliceStages * kSlice;
  static constexpr int kSide = 3 * kRowsQ;  // lse2, delta, seg per stage
  static constexpr int kOffBar = kOffSide + kSliceStages * kSide * 4;
  static constexpr int kSmem =
      kOffBar + 8 * 2 * (kChunkStages + kSliceStages) + 1024;
};

template <typename TO>
__global__ void __launch_bounds__(BwdWide::kThreads, 1)
    dkdv_wide_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                          const __grid_constant__ CUtensorMap tmK,
                          const __grid_constant__ CUtensorMap tmV,
                          const __grid_constant__ CUtensorMap tmDO,
                          const float* __restrict__ lse_g,
                          const float* __restrict__ delta_g,
                          const int* __restrict__ segq,
                          const int* __restrict__ segk, TO* __restrict__ dk,
                          TO* __restrict__ dv, int H, int Hkv, int Lq, int Lk,
                          int Dp, int causal, int window, float scale, int y0) {
  using C = BwdWide;
  constexpr int kRowsK = C::kRowsK, kRowsQ = C::kRowsQ;
  constexpr int kCS = C::kChunkStages, kSS = C::kSliceStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  float* side = reinterpret_cast<float*>(smem_raw + pad + C::kOffSide);
  const uint32_t cfull0 = base + C::kOffBar, cempty0 = cfull0 + 8 * kCS;
  const uint32_t sfull0 = cempty0 + 8 * kCS, sempty0 = sfull0 + 8 * kSS;

  const int bh = blockIdx.x;                 // q-head row
  const int kb = y0 + (int)blockIdx.y;
  const int col0 = C::kW * blockIdx.z;       // this block's dK, dV columns
  const int ncols = min(C::kW, Dp - col0);
  const int nch = Dp / kChunkCols;
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
    for (int s = 0; s < kCS; ++s) {
      mbar_init(cfull0 + 8 * s, 1);
      mbar_init(cempty0 + 8 * s, kConsumers);
    }
    for (int s = 0; s < kSS; ++s) {
      mbar_init(sfull0 + 8 * s, 1 + 32);
      mbar_init(sempty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {           // producer warpgroup
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    const int lane = threadIdx.x & 31;
    for (int qb = qb_lo, i = 0, ic = 0; qb < qb_hi; ++qb, ++i) {
      const int q0 = qb * kRowsQ;
      for (int c = 0; c < nch; ++c, ++ic) {  // K, V, Q and dO chunk c
        const int s = ic % kCS;
        const uint32_t full = cfull0 + 8 * s;
        const uint32_t dst = base + s * C::kChunk;
        const int col = kChunkCols * c;
        mbar_wait(cempty0 + 8 * s, ((ic / kCS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full, C::kChunk);
          tma_load_3d(dst, &tmK, full, col, k0, kvh);
          tma_load_3d(dst + C::kOffV, &tmV, full, col, k0, kvh);
          tma_load_3d(dst + C::kOffQ, &tmQ, full, col, q0, bh);
          tma_load_3d(dst + C::kOffDO, &tmDO, full, col, q0, bh);
        }
      }
      const int s = i % kSS;                 // Q's and dO's slices, the side
      const uint32_t full = sfull0 + 8 * s;
      const uint32_t dst = base + C::kOffSlice + s * C::kSlice;
      const int nblk = ncols / kChunkCols;
      mbar_wait(sempty0 + 8 * s, ((i / kSS) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * nblk * kRowsQ * kChunkRowBytes);
        load_blocks(dst, &tmQ, full, col0, nblk, q0, bh, kRowsQ);
        load_blocks(dst + C::kSliceQ, &tmDO, full, col0, nblk, q0, bh,
                    kRowsQ);
      }
      float* st = side + s * C::kSide;
      for (int j = lane; j < kRowsQ; j += 32) {
        const int qp = q0 + j;
        const bool in = qp < Lq;
        const size_t r = (size_t)bh * Lq + qp;
        const float ls = in ? lse_g[r] : kNegInf;
        st[j] = ls > kNegInf * 0.5f ? -ls * kLog2e
                                    : __int_as_float(0xff800000);  // -inf
        st[kRowsQ + j] = in ? delta_g[r] : 0.f;
        reinterpret_cast<int*>(st)[2 * kRowsQ + j] =
            (segq != nullptr && in) ? segq[r] : 0;
      }
      mbar_arrive(full);
    }
    return;
  }

  // consumer warpgroup wg owns kv rows kr0 .. kr0 + 63
  consumer_regs();
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
  float dk_acc[C::kW / 2], dv_acc[C::kW / 2];
#pragma unroll
  for (int r = 0; r < C::kW / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;

  for (int qb = qb_lo, i = 0, ic = 0; qb < qb_hi; ++qb, ++i) {
    const int q0 = qb * kRowsQ;
    float sc[kRowsQ / 2], dp[kRowsQ / 2];
    for (int c = 0; c < nch; ++c, ++ic) {    // S^T, dP^T over D, by chunks
      const int s = ic % kCS;
      const uint32_t chunk = base + s * C::kChunk;
      mbar_wait(cfull0 + 8 * s, (ic / kCS) & 1);
      wgmma_fence();
      wgmma_ss_chunk(sc, chunk, kRowsK, 64 * wg, chunk + C::kOffQ, kRowsQ, 0,
                     c > 0);
      wgmma_ss_chunk(dp, chunk + C::kOffV, kRowsK, 64 * wg,
                     chunk + C::kOffDO, kRowsQ, 0, c > 0);
      wgmma_commit();
      wgmma_wait<1>();     // chunk c - 1's products: its stage is free
      if (c > 0) mbar_arrive(cempty0 + 8 * ((ic - 1) % kCS));
    }
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    mbar_arrive(cempty0 + 8 * ((ic - 1) % kCS));
    const int s = i % kSS;
    const uint32_t qaddr = base + C::kOffSlice + s * C::kSlice;
    const uint32_t doaddr = qaddr + C::kSliceQ;
    const float* st = side + s * C::kSide;
    mbar_wait(sfull0 + 8 * s, (i / kSS) & 1);

    const bool diag = causal && kr0 + 63 > q0;  // reaches above it
    const bool need_mask =
        diag || segq != nullptr || q0 + kRowsQ > Lq || kr0 + 64 > Lk ||
        (causal && window > 0 && q0 + kRowsQ - 1 - kr0 >= window);
    // sc becomes p^T and dp dS^T; the mask, where a tile needs it, selects
    if (need_mask) {
      const int* seg = reinterpret_cast<const int*>(st) + 2 * kRowsQ;
#pragma unroll
      for (int r = 0; r < kRowsQ / 2; ++r) {
        const int c = frag_col(r), h = (r >> 1) & 1;
        const float p = ex2(fmaf(sc[r], scale2, st[c]));
        sc[r] = mask.live(q0 + c, kpos[h], seg[c], sk[h]) ? p : 0.f;
        dp[r] = sc[r] * (dp[r] - st[kRowsQ + c]) * scale;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsQ / 2; ++r) {
        const int c = frag_col(r);
        sc[r] = ex2(fmaf(sc[r], scale2, st[c]));
        dp[r] = sc[r] * (dp[r] - st[kRowsQ + c]) * scale;
      }
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
      wgmma_rs_tile<C::kW, 1>(dv_acc, pa[kk], doaddr, kRowsQ, 16 * kk);
#pragma unroll
    for (int kk = 0; kk < kRowsQ / 16; ++kk)
      wgmma_rs_tile<C::kW, 1>(dk_acc, dsa[kk], qaddr, kRowsQ, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dk_acc);
    fence_regs(dv_acc);
    mbar_arrive(sempty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Lk) continue;
    const size_t off = ((size_t)bh * Lk + kpos[h]) * Dp + col0;
    store_row_n<C::kW>(dk + off, dk_acc, h, 1.f, ncols);
    store_row_n<C::kW>(dv + off, dv_acc, h, 1.f, ncols);
  }
}

template <typename TO>
int launch_wide(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const int* segq, const int* segk, void* dk, void* dv, int BH,
                int H, int Hkv, int Lq, int Lk, int Dp, int causal,
                int window, float scale, cudaStream_t stream) {
  using C = BwdWide;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_wide_map(&mq, q, Dp, BH, Lq, C::kRowsQ) ||
      !make_wide_map(&mdo, dout, Dp, BH, Lq, C::kRowsQ) ||
      !make_wide_map(&mk, k, Dp, BHkv, Lk, C::kRowsK) ||
      !make_wide_map(&mv, v, Dp, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_wide_sm90_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Lk + C::kRowsK - 1) / C::kRowsK;
  return launch_in_chunks(nkb, [&](int y0, int ny) {
    dim3 grid(BH, ny, (Dp + C::kW - 1) / C::kW);
    dkdv_wide_sm90_kernel<TO><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
        Lk, Dp, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
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
      !Tile<D>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<D>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90_kernel<D, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Lk + C::kRowsK - 1) / C::kRowsK;
  return launch_in_chunks(nkb, [&](int y0, int ny) {
    dim3 grid(BH, ny);
    dkdv_sm90_kernel<D, TO><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
        Lk, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
}

template <typename TO>
int launch_d32(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, const int* segq,
               const int* segk, void* dk, void* dv, int BH, int H, int Hkv,
               int Lq, int Lk, int causal, int window, float scale,
               cudaStream_t stream) {
  using C = BwdD32;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!Tile<32>::make_map(&mq, q, BH, Lq, C::kRowsQ) ||
      !Tile<32>::make_map(&mdo, dout, BH, Lq, C::kRowsQ) ||
      !Tile<32>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<32>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90_d32_kernel<TO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Lk + C::kRowsK - 1) / C::kRowsK;
  return launch_in_chunks(nkb, [&](int y0, int ny) {
    dim3 grid(BH, ny);
    dkdv_sm90_d32_kernel<TO><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
        Lk, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
}

template <typename TO>
int launch_split(const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 const int* segq, const int* segk, void* dk, void* dv, int BH,
                 int H, int Hkv, int Lq, int Lk, int causal, int window,
                 float scale, cudaStream_t stream) {
  using C = Split<256>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!Tile<256>::make_map(&mq, q, BH, Lq, C::kRowsQ) ||
      !Tile<256>::make_map(&mdo, dout, BH, Lq, C::kRowsQ) ||
      !Tile<256>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<256>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dkdv_sm90_split_kernel<256, TO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int nkb = (Lk + C::kRowsK - 1) / C::kRowsK;
  return launch_in_chunks(nkb, [&](int y0, int ny) {
    dim3 grid(BH, ny);
    dkdv_sm90_split_kernel<256, TO><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (TO*)dk, (TO*)dv, H, Hkv, Lq,
        Lk, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
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
      if (out_f32)
        return launch_d32<float>(q, k, v, dout, lse, delta, segq, segk, dk,
                                 dv, BH, H, Hkv, Lq, Lk, causal, window,
                                 scale, stream);
      return launch_d32<__nv_bfloat16>(q, k, v, dout, lse, delta, segq, segk,
                                       dk, dv, BH, H, Hkv, Lq, Lk, causal,
                                       window, scale, stream);
    case 64:
      return launch_d<64>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                          out_f32, BH, H, Hkv, Lq, Lk, causal, window, scale,
                          stream);
    case 128:
      return launch_d<128>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                           out_f32, BH, H, Hkv, Lq, Lk, causal, window, scale,
                           stream);
    case 256:
      if (out_f32)
        return launch_split<float>(q, k, v, dout, lse, delta, segq, segk, dk,
                                   dv, BH, H, Hkv, Lq, Lk, causal, window,
                                   scale, stream);
      return launch_split<__nv_bfloat16>(q, k, v, dout, lse, delta, segq,
                                         segk, dk, dv, BH, H, Hkv, Lq, Lk,
                                         causal, window, scale, stream);
  }
  if (D > 256 && D % sm90::kChunkCols == 0) {
    if (out_f32)
      return launch_wide<float>(q, k, v, dout, lse, delta, segq, segk, dk, dv,
                                BH, H, Hkv, Lq, Lk, D, causal, window, scale,
                                stream);
    return launch_wide<__nv_bfloat16>(q, k, v, dout, lse, delta, segq, segk,
                                      dk, dv, BH, H, Hkv, Lq, Lk, D, causal,
                                      window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
