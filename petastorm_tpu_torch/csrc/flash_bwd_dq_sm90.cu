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
// Head dims: instantiated at D = 32, 64, 128 and 256 (sm90.cuh's Tile<D>).
// The wrapper pads any other D <= 256 to the next of them (bf16 D 16 and
// 24 to 32), and any D past 256 to the next multiple of 64
// (dq_wide_cluster_sm90_kernel up to 512, dq_wide_sm90_kernel past it,
// below).
//
// Block: 288 threads, one 128-row q tile of one q-head row (GQA: the kv row
// through the head map; dq is per q head, so there are no partials). Warps
// 0-7 are two consumer warpgroups of 64 q rows each, warp 8 the producer.
// TMA loads Q and dO (128 x D each) once; they stay resident. 64 x D K and V
// tiles stream through a 4-stage ring, and the producer's lanes write the
// tile's kv segment ids beside them (shared memory at D = 64: Q, dO 32 KB +
// 4 x (K 8 KB + V 8 KB) + 4 x 256 B ~ 98 KB; half the tile bytes at D = 32,
// twice at D = 128, ~195 KB). Each consumer thread reads, once, the lse
// (times log2(e); +inf where lse <= -5e29, a fully masked forward row, so p
// = 0 there), delta and q segment id of its two fragment rows into
// registers. Per kv tile a consumer warpgroup runs S = Q K^T and dP = dO V^T
// (2 x D/16 x m64n64k16, A and B K-major from shared memory: K3's pair with
// the roles swapped), p = exp2(S scale log2e - lse log2e) and dS = p (dP -
// delta) scale on the accumulator fragments, then dQ += dS K (4 x m64nDk16,
// at D = 128 two m64n64k16 a step; A = dS from registers, B = K MN-major:
// the transpose bit). dQ stays in float32 registers for the whole kv loop.
//
// Why 64-row kv tiles: registers. With 128-row tiles S and dP would take 64
// floats each a thread, beside dQ's 32 and the dS fragments' 32: well over
// the 168 registers ptxas gives a thread under a 288-thread launch bound.
// At 64 rows the count is 32 + 32 + 32 + 16 at D = 64, and dQ's 64 at D =
// 128.
//
// D = 256: Q and dO take 64 KB each, and four stages of 64-row K and V
// tiles would take 256 KB more, past the 227 KB a block may have. So kv
// tiles are 32 rows (S and dP on m64n32k16) through 2 stages: 128 + 2 x (16
// + 16) KB ~ 193 KB. dQ over 64 q rows is 128 floats a thread, so the block
// has 384 threads, the producer warp in a warpgroup of its own whose
// setmaxnreg.dec hands its registers to the consumers (to 232; sm90.cuh).
//
// D = 32: at this width a (q, k) pair costs as much in elementwise work
// (one exponential on the special-function unit, 16 a clock an SM, and
// some eight more instructions) as in products. So there the exponential
// is ex2.approx (its result rounded to bf16 next), and the mask selects
// instead of branching (Mask::live), in a loop of its own for the tiles
// that need it: with a branch an element the compiler could not
// interleave the elements' exponentials, and each waited out the last.
// K3 does the same at D = 32 in a kernel of its own (flash_bwd_sm90.cu).
// Two ways to overlap the exponentials with the products, the consumer
// warpgroups taking turns at the tensor cores and one tile's second
// products issued with the next tile's scores, measured within the spread
// of this schedule in both kernels (PERF.md), so neither is kept.
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
//
// Past D = 256 (dq_wide_cluster_sm90_kernel<NB>, up to D = 512): the D/64
// chunks of 64 columns are split over the n = 2 blocks of one 128-row q
// tile, NB = ceil(D / 128) (3 or 4) chunks a block (the second may have
// fewer), and the two blocks are one thread block cluster along z. Block
// z keeps its own chunks of Q and dO (128 x 64 NB each) resident in shared
// memory for the whole kv loop, and streams only its chunks of K and V (32
// x 64 NB each a 32-row kv tile) through a 2-stage ring (3 at NB = 3).
// Per kv tile each consumer warpgroup computes its block's partial S and
// dP over those columns (NB x 2 x m64n32k16 with 4 k steps each, in one
// commit group issued while the last tile's dQ products run), and the
// cluster sums the partials through distributed shared memory (sm90.cuh's
// cluster_sum: each block reads both blocks' partials and adds them from
// block 0 up, so both hold the same bits of S and dP; each warpgroup's
// exchange has its own two mbarriers). Then p, dS and dQ_z += dS K_z (NB x
// 2 x m64n64k16) as at D = 256, on the K chunks already in the ring. S and
// dP are computed once a (q tile, kv tile) pair, 6 D FLOP a live pair in
// all, and each byte of Q, dO, K and V crosses from L2 to an SM once a
// block that needs it. A block's partial dP sums at most 4 chunks (16 k
// steps) in one accumulator and the blocks' partials are added in float32:
// a row that sees one key (causal row 0) has dP = delta, so ds = 0 there,
// and with one wgmma accumulator carried through all 64 k steps at D =
// 1024 its dq fell outside the gate's allowance for the sums' order on the
// card (tests/test_torch_head_dims.py, MQA). The elementwise work is K1's
// Hopper form: one FFMA for the scale and the lse, ex2.approx, the mask a
// select (Mask::live) in a loop of its own for the tiles that need it.
// Shared memory: Q, dO 128 KB, the ring 64 KB and the exchange 32 KB at NB
// = 4 (~225 KB); ~200 KB at NB = 3.
//
// Past D = 512 (more than two blocks to a cluster) D runs
// dq_wide_sm90_kernel, the streaming design: a block owns 128 q rows and
// one 256-column slice of dQ, and per 32-row kv tile the producer streams
// all D/64 chunks of Q, dO (128 x 64 each) and K, V (32 x 64 each), 40 KB,
// through a 4-stage ring, then K's slice (32 x 256) through a 2-stage
// ring; each slice recomputes S and dP over all of D, and Q and dO are
// read again for every kv tile; dP is summed a chunk at a time on the
// tensor cores and the chunks in float32 adds. On an H100 the cluster
// kernel beat it by 6% at D 512 and lost by 11% at 576 (3 blocks): the
// partials' traffic between the SMs (~9 GB/s an SM, (n - 1) x 32 KB a
// block a kv tile) grows with the cluster (PERF.md, PR 28).
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kRowsQ = 128;                 // q rows per block
constexpr int kConsumers = 256;             // two warpgroups

template <int D>
struct Dq {
  // At D = 256 the producer is a whole warpgroup (one warp of it loads),
  // so that setmaxnreg can move its registers to the consumers.
  static constexpr bool kRealloc = D == 256;
  static constexpr int kThreads = kConsumers + (kRealloc ? 128 : 32);
  static constexpr int kRowsK = D == 256 ? 32 : 64;  // kv rows per tile
  static constexpr int kStages = D == 256 ? 2 : 4;
  static constexpr int kTileQ = Tile<D>::bytes(kRowsQ);
  static constexpr int kTileK = Tile<D>::bytes(kRowsK);
  static constexpr int kOffQ = 0;
  static constexpr int kOffDO = kOffQ + kTileQ;
  static constexpr int kOffK = kOffDO + kTileQ;
  static constexpr int kOffV = kOffK + kStages * kTileK;
  static constexpr int kOffSeg = kOffV + kStages * kTileK;
  static constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
  static constexpr int kSmem =                // barriers: q, full, empty
      kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + slack to align to 1024
};

template <int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1)
    dq_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmDO,
                   const float* __restrict__ lse_g,
                   const float* __restrict__ delta_g,
                   const int* __restrict__ segq,
                   const int* __restrict__ segk,
                   __nv_bfloat16* __restrict__ dq, int H, int Hkv, int Lq,
                   int Lk, int causal, int window, float scale, int y0) {
  using C = Dq<D>;
  constexpr int kRowsK = C::kRowsK, kStages = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* seg_tile = reinterpret_cast<int*>(smem_raw + pad + C::kOffSeg);
  const uint32_t qbar = base + C::kOffBar;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kStages;

  const int bh = blockIdx.x;
  // longest causal rows first: the last q tile in the first block
  const int qb = (Lq - 1) / kRowsQ - (y0 + (int)blockIdx.y);
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
    if constexpr (C::kRealloc) {
      producer_regs();
      if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    }
    const int lane = threadIdx.x & 31;
    if (lane == 0) {
      mbar_arrive_tx(qbar, 2 * C::kTileQ);
      Tile<D>::load(base + C::kOffQ, &tmQ, qbar, q0, bh, kRowsQ);
      Tile<D>::load(base + C::kOffDO, &tmDO, qbar, q0, bh, kRowsQ);
    }
    for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
      const int s = i % kStages;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, 2 * C::kTileK);
        Tile<D>::load(base + C::kOffK + s * C::kTileK, &tmK, full,
                      kb * kRowsK, kvh, kRowsK);
        Tile<D>::load(base + C::kOffV + s * C::kTileK, &tmV, full,
                      kb * kRowsK, kvh, kRowsK);
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
  if constexpr (C::kRealloc) consumer_regs();
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
  float dq_acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) dq_acc[r] = 0.f;
  mbar_wait(qbar, 0);

  for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
    const int s = i % kStages;
    const int k0 = kb * kRowsK;
    const uint32_t kaddr = base + C::kOffK + s * C::kTileK;
    const uint32_t vaddr = base + C::kOffV + s * C::kTileK;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[kRowsK / 2], dp[kRowsK / 2];
    wgmma_fence();
    wgmma_ss_tile<D>(sc, base + C::kOffQ, kRowsQ, 64 * wg, kaddr);
    wgmma_ss_tile<D>(dp, base + C::kOffDO, kRowsQ, 64 * wg, vaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
    if constexpr (D == 32) {    // see the top of this file
      // dp becomes ds; the mask, where a tile needs it, selects
      if (need_mask) {
        const int* seg = seg_tile + s * kRowsK;
#pragma unroll
        for (int r = 0; r < kRowsK / 2; ++r) {
          const int h = (r >> 1) & 1, c = frag_col(r);
          const float p = ex2(sc[r] * scale2 - lse2[h]);
          const bool live = mask.live(qpos[h], k0 + c, sq[h],
                                      segk != nullptr ? seg[c] : 0);
          dp[r] = (live ? p : 0.f) * (dp[r] - dlt[h]) * scale;
        }
      } else {
#pragma unroll
        for (int r = 0; r < kRowsK / 2; ++r) {
          const int h = (r >> 1) & 1;
          dp[r] = ex2(sc[r] * scale2 - lse2[h]) * (dp[r] - dlt[h]) * scale;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        const int h = (r >> 1) & 1, c = frag_col(r);
        float p = exp2f(sc[r] * scale2 - lse2[h]);
        if (need_mask &&
            !mask(qpos[h], k0 + c, sq[h],
                  segk != nullptr ? seg_tile[s * kRowsK + c] : 0))
          p = 0.f;
        dp[r] = p * (dp[r] - dlt[h]) * scale;   // dp now holds ds
      }
    }

    uint32_t dsa[kRowsK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) to_a_frag(dp, kk, dsa[kk]);
    fence_regs(dq_acc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of K a step
      wgmma_rs_tile<D, 1>(dq_acc, dsa[kk], kaddr, kRowsK, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (qpos[h] < Lq)
      store_row<D>(dq + ((size_t)bh * Lq + qpos[h]) * D, dq_acc, h, 1.f);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, const int* segq,
           const int* segk, void* dq, int BH, int H, int Hkv, int Lq, int Lk,
           int causal, int window, float scale, cudaStream_t stream) {
  using C = Dq<D>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!Tile<D>::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !Tile<D>::make_map(&mdo, dout, BH, Lq, kRowsQ) ||
      !Tile<D>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<D>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    dim3 grid(BH, ny);
    dq_sm90_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (__nv_bfloat16*)dq, H, Hkv,
        Lq, Lk, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
}

// Head dims past 512 (see the top of this file): one 256-column slice of dQ
// a block, S and dP streamed over D in 64-column chunks.
struct DqWide {
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kW = 256;                 // dQ columns a block
  static constexpr int kRowsK = 32;              // kv rows per tile
  static constexpr int kChunkStages = 4;
  static constexpr int kSliceStages = 2;
  static constexpr int kChunkQ = kRowsQ * kChunkRowBytes;   // Q, dO: 16 KB
  static constexpr int kChunkK = kRowsK * kChunkRowBytes;   // K, V: 4 KB
  static constexpr int kOffDO = kChunkQ;
  static constexpr int kOffK = 2 * kChunkQ;
  static constexpr int kOffV = kOffK + kChunkK;
  static constexpr int kChunk = kOffV + kChunkK;            // 40 KB
  static constexpr int kSlice = Tile<kW>::bytes(kRowsK);    // K: 16 KB
  static constexpr int kOffSlice = kChunkStages * kChunk;
  static constexpr int kOffSeg = kOffSlice + kSliceStages * kSlice;
  static constexpr int kOffBar = kOffSeg + kSliceStages * kRowsK * 4;
  static constexpr int kSmem =
      kOffBar + 8 * 2 * (kChunkStages + kSliceStages) + 1024;
};

__global__ void __launch_bounds__(DqWide::kThreads, 1)
    dq_wide_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                        const __grid_constant__ CUtensorMap tmK,
                        const __grid_constant__ CUtensorMap tmV,
                        const __grid_constant__ CUtensorMap tmDO,
                        const float* __restrict__ lse_g,
                        const float* __restrict__ delta_g,
                        const int* __restrict__ segq,
                        const int* __restrict__ segk,
                        __nv_bfloat16* __restrict__ dq, int H, int Hkv,
                        int Lq, int Lk, int Dp, int causal, int window,
                        float scale, int y0) {
  using C = DqWide;
  constexpr int kRowsK = C::kRowsK;
  constexpr int kCS = C::kChunkStages, kSS = C::kSliceStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* seg_tile = reinterpret_cast<int*>(smem_raw + pad + C::kOffSeg);
  const uint32_t cfull0 = base + C::kOffBar, cempty0 = cfull0 + 8 * kCS;
  const uint32_t sfull0 = cempty0 + 8 * kCS, sempty0 = sfull0 + 8 * kSS;

  const int bh = blockIdx.x;
  // longest causal rows first: the last q tile in the first block
  const int qb = (Lq - 1) / kRowsQ - (y0 + (int)blockIdx.y);
  const int col0 = C::kW * blockIdx.z;         // this block's dQ columns
  const int ncols = min(C::kW, Dp - col0);
  const int nch = Dp / kChunkCols;
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

  if (threadIdx.x >= kConsumers) {            // producer warpgroup
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    const int lane = threadIdx.x & 31;
    for (int kb = kb_lo, i = 0, ic = 0; kb < kb_hi; ++kb, ++i) {
      for (int c = 0; c < nch; ++c, ++ic) {   // Q, dO, K and V chunk c
        const int s = ic % kCS;
        const uint32_t full = cfull0 + 8 * s;
        const uint32_t dst = base + s * C::kChunk;
        const int col = kChunkCols * c;
        mbar_wait(cempty0 + 8 * s, ((ic / kCS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full, C::kChunk);
          tma_load_3d(dst, &tmQ, full, col, q0, bh);
          tma_load_3d(dst + C::kOffDO, &tmDO, full, col, q0, bh);
          tma_load_3d(dst + C::kOffK, &tmK, full, col, kb * kRowsK, kvh);
          tma_load_3d(dst + C::kOffV, &tmV, full, col, kb * kRowsK, kvh);
        }
      }
      const int s = i % kSS;                  // K's slice, the segment ids
      const uint32_t full = sfull0 + 8 * s;
      mbar_wait(sempty0 + 8 * s, ((i / kSS) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, ncols / kChunkCols * kRowsK * kChunkRowBytes);
        load_blocks(base + C::kOffSlice + s * C::kSlice, &tmK, full, col0,
                    ncols / kChunkCols, kb * kRowsK, kvh, kRowsK);
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
  consumer_regs();
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
  float dq_acc[C::kW / 2];
#pragma unroll
  for (int r = 0; r < C::kW / 2; ++r) dq_acc[r] = 0.f;

  for (int kb = kb_lo, i = 0, ic = 0; kb < kb_hi; ++kb, ++i) {
    const int k0 = kb * kRowsK;
    float sc[kRowsK / 2], dp[kRowsK / 2];
#pragma unroll
    for (int r = 0; r < kRowsK / 2; ++r) dp[r] = 0.f;
    for (int c = 0; c < nch; ++c, ++ic) {     // S, dP over D, chunk by chunk
      const int s = ic % kCS;
      const uint32_t chunk = base + s * C::kChunk;
      float dpc[kRowsK / 2];                  // this chunk's dO V^T
      mbar_wait(cfull0 + 8 * s, (ic / kCS) & 1);
      wgmma_fence();
      wgmma_ss_chunk(sc, chunk, kRowsQ, 64 * wg, chunk + C::kOffK, kRowsK, 0,
                     c > 0);
      wgmma_ss_chunk(dpc, chunk + C::kOffDO, kRowsQ, 64 * wg,
                     chunk + C::kOffV, kRowsK, 0, 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dpc);
      mbar_arrive(cempty0 + 8 * s);
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) dp[r] += dpc[r];  // in float32
    }
    const int s = i % kSS;
    const uint32_t kaddr = base + C::kOffSlice + s * C::kSlice;
    mbar_wait(sfull0 + 8 * s, (i / kSS) & 1);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
#pragma unroll
    for (int r = 0; r < kRowsK / 2; ++r) {
      const int h = (r >> 1) & 1, c = frag_col(r);
      float p = exp2f(sc[r] * scale2 - lse2[h]);
      if (need_mask &&
          !mask(qpos[h], k0 + c, sq[h],
                segk != nullptr ? seg_tile[s * kRowsK + c] : 0))
        p = 0.f;
      dp[r] = p * (dp[r] - dlt[h]) * scale;   // dp now holds ds
    }

    uint32_t dsa[kRowsK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) to_a_frag(dp, kk, dsa[kk]);
    fence_regs(dq_acc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of K a step
      wgmma_rs_tile<C::kW, 1>(dq_acc, dsa[kk], kaddr, kRowsK, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq_acc);
    mbar_arrive(sempty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (qpos[h] < Lq)
      store_row_n<C::kW>(dq + ((size_t)bh * Lq + qpos[h]) * Dp + col0,
                         dq_acc, h, 1.f, ncols);
}

int launch_wide(const void* q, const void* k, const void* v,
                const void* dout, const float* lse, const float* delta,
                const int* segq, const int* segk, void* dq, int BH, int H,
                int Hkv, int Lq, int Lk, int Dp, int causal, int window,
                float scale, cudaStream_t stream) {
  using C = DqWide;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_wide_map(&mq, q, Dp, BH, Lq, kRowsQ) ||
      !make_wide_map(&mdo, dout, Dp, BH, Lq, kRowsQ) ||
      !make_wide_map(&mk, k, Dp, BHkv, Lk, C::kRowsK) ||
      !make_wide_map(&mv, v, Dp, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    dim3 grid(BH, ny, (Dp + C::kW - 1) / C::kW);
    dq_wide_sm90_kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, mdo, lse, delta, segq, segk, (__nv_bfloat16*)dq, H, Hkv,
        Lq, Lk, Dp, causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
}

// Head dims past 256 up to 4 kDqClusterBlocks chunks (see the top of this
// file): the n = gridDim.z blocks of a q tile are one cluster, block z
// owning chunks NB z .. of Q, dO, K, V and dQ.
// The widest cluster the dispatch takes (at most kClusterMax blocks): past
// it D runs the streaming kernel, which was faster at three blocks.
constexpr int kDqClusterBlocks = 2;

template <int NB>
struct DqCluster {
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kW = NB * kChunkCols;      // dQ columns a block
  static constexpr int kRowsK = 32;               // kv rows per tile
  static constexpr int kStages = NB == 4 ? 2 : 3;
  static constexpr int kChunkQ = kRowsQ * kChunkRowBytes;   // 16 KB
  static constexpr int kChunkK = kRowsK * kChunkRowBytes;   // 4 KB
  static constexpr int kOffDO = NB * kChunkQ;
  static constexpr int kOffK = 2 * NB * kChunkQ;
  static constexpr int kTileK = NB * kChunkK;               // K's, V's slice
  static constexpr int kOffV = kOffK + kStages * kTileK;
  static constexpr int kOffPart = kOffV + kStages * kTileK;
  static constexpr int kPart = kConsumers * kRowsK * 4;     // S, dP: 32 KB
  static constexpr int kOffSeg = kOffPart + kPart;
  static constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
  // barriers: q, full and empty a stage, full and empty a warpgroup
  static constexpr int kSmem = kOffBar + 8 * (1 + 2 * kStages + 4) + 1024;
};

template <int NB>
__global__ void __launch_bounds__(DqCluster<NB>::kThreads, 1)
    dq_wide_cluster_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                                const __grid_constant__ CUtensorMap tmK,
                                const __grid_constant__ CUtensorMap tmV,
                                const __grid_constant__ CUtensorMap tmDO,
                                const float* __restrict__ lse_g,
                                const float* __restrict__ delta_g,
                                const int* __restrict__ segq,
                                const int* __restrict__ segk,
                                __nv_bfloat16* __restrict__ dq, int H,
                                int Hkv, int Lq, int Lk, int Dp, int causal,
                                int window, float scale, int y0) {
  using C = DqCluster<NB>;
  constexpr int kRowsK = C::kRowsK, kS = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* seg_tile = reinterpret_cast<int*>(smem_raw + pad + C::kOffSeg);
  const uint32_t qbar = base + C::kOffBar;
  const uint32_t full0 = qbar + 8, empty0 = full0 + 8 * kS;
  const uint32_t xbar0 = empty0 + 8 * kS;   // full, empty a warpgroup

  const int bh = blockIdx.x;
  // longest causal rows first: the last q tile in the first block
  const int qb = (Lq - 1) / kRowsQ - (y0 + (int)blockIdx.y);
  const int n = (int)gridDim.z;                // the cluster's blocks
  const int col0 = C::kW * blockIdx.z;         // this block's columns
  const int nb = min(NB, Dp / kChunkCols - NB * (int)blockIdx.z);
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
    for (int s = 0; s < kS; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    for (int b = 0; b < 4; ++b) mbar_init(xbar0 + 8 * b, 4 * n);
    mbar_fence_init();
  }
  cluster_sync();   // every block's barriers, before any block arrives

  if (threadIdx.x >= kConsumers) {            // producer warpgroup
    producer_regs();
    if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    const int lane = threadIdx.x & 31;
    if (lane == 0) {                          // this block's Q, dO columns
      mbar_arrive_tx(qbar, 2 * nb * C::kChunkQ);
      load_blocks(base, &tmQ, qbar, col0, nb, q0, bh, kRowsQ);
      load_blocks(base + C::kOffDO, &tmDO, qbar, col0, nb, q0, bh, kRowsQ);
    }
    for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
      const int s = i % kS;
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, ((i / kS) & 1) ^ 1);
      if (lane == 0) {                        // its K, V columns of a tile
        mbar_arrive_tx(full, 2 * nb * C::kChunkK);
        load_blocks(base + C::kOffK + s * C::kTileK, &tmK, full, col0, nb,
                    kb * kRowsK, kvh, kRowsK);
        load_blocks(base + C::kOffV + s * C::kTileK, &tmV, full, col0, nb,
                    kb * kRowsK, kvh, kRowsK);
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
  consumer_regs();
  const int wg = threadIdx.x >> 7;
  const int r0 = q0 + 64 * wg;
  const float scale2 = scale * kLog2e;
  const Mask mask{Lq, Lk, causal, window};
  int qpos[2], sq[2];
  float nlse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = r0 + frag_row(2 * h);
    const bool in = qpos[h] < Lq;
    const size_t r = (size_t)bh * Lq + qpos[h];
    const float ls = in ? lse_g[r] : kNegInf;
    nlse2[h] = ls > kNegInf * 0.5f ? -ls * kLog2e
                                   : __int_as_float(0xff800000);  // -inf
    dlt[h] = in ? delta_g[r] : 0.f;
    sq[h] = (segq != nullptr && in) ? segq[r] : 0;
  }
  const uint32_t slot = base + C::kOffPart + 16 * threadIdx.x;
  const uint32_t xfull = xbar0 + 16 * wg, xempty = xfull + 8;
  float dq_acc[C::kW / 2];
#pragma unroll
  for (int r = 0; r < C::kW / 2; ++r) dq_acc[r] = 0.f;
  // dS as the A operand of dQ's products, live until they retire
  uint32_t dsa[kRowsK / 16][4];
  mbar_wait(qbar, 0);

  for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
    const int s = i % kS;
    const int k0 = kb * kRowsK;
    const uint32_t kaddr = base + C::kOffK + s * C::kTileK;
    const uint32_t vaddr = base + C::kOffV + s * C::kTileK;
    mbar_wait(full0 + 8 * s, (i / kS) & 1);

    // this block's partial S and dP over its nb chunks (4 nb k steps in
    // one accumulator each), issued while the last tile's dQ products run
    float sc[kRowsK / 2], dp[kRowsK / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NB; ++c)
      if (c < nb) {
        wgmma_ss_chunk(sc, base + c * C::kChunkQ, kRowsQ, 64 * wg,
                       kaddr + c * C::kChunkK, kRowsK, 0, c > 0);
        wgmma_ss_chunk(dp, base + C::kOffDO + c * C::kChunkQ, kRowsQ,
                       64 * wg, vaddr + c * C::kChunkK, kRowsK, 0, c > 0);
      }
    wgmma_commit();
    wgmma_wait<1>();              // the last tile's dQ: its stage is free
    if (i > 0) mbar_arrive(empty0 + 8 * ((i - 1) % kS));
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
    // S and dP over all of D: the cluster's partials, summed
    cluster_sum(sc, dp, slot, 16 * kConsumers, xfull, xempty, n, i);
    // dp becomes ds; the mask, where a tile needs it, selects
    if (need_mask) {
      const int* seg = seg_tile + s * kRowsK;
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        const int h = (r >> 1) & 1, c = frag_col(r);
        const float p = ex2(fmaf(sc[r], scale2, nlse2[h]));
        const bool live = mask.live(qpos[h], k0 + c, sq[h],
                                    segk != nullptr ? seg[c] : 0);
        dp[r] = (live ? p : 0.f) * (dp[r] - dlt[h]) * scale;
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        const int h = (r >> 1) & 1;
        dp[r] = ex2(fmaf(sc[r], scale2, nlse2[h])) * (dp[r] - dlt[h]) *
                scale;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) to_a_frag(dp, kk, dsa[kk]);

    fence_regs(dq_acc);
    fence_regs(dsa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of K a step
      wgmma_rs_blocks<NB, 1>(dq_acc, dsa[kk], kaddr, kRowsK, 16 * kk);
    wgmma_commit();   // retired under the next tile's first products
  }
  wgmma_wait_all();
  fence_regs(dq_acc);
  cluster_sum_done(xempty, kb_hi - kb_lo);

#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (qpos[h] < Lq)
      store_row_n<C::kW>(dq + ((size_t)bh * Lq + qpos[h]) * Dp + col0,
                         dq_acc, h, 1.f, nb * kChunkCols);
}

template <int NB>
int launch_cluster(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* segq, const int* segk, void* dq, int BH, int H,
                   int Hkv, int Lq, int Lk, int Dp, int n, int causal,
                   int window, float scale, cudaStream_t stream) {
  using C = DqCluster<NB>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv, mdo;
  if (!make_wide_map(&mq, q, Dp, BH, Lq, kRowsQ) ||
      !make_wide_map(&mdo, dout, Dp, BH, Lq, kRowsQ) ||
      !make_wide_map(&mk, k, Dp, BHkv, Lk, C::kRowsK) ||
      !make_wide_map(&mv, v, Dp, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      dq_wide_cluster_sm90_kernel<NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = n;
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(BH, ny, n);
    cfg.blockDim = dim3(C::kThreads);
    cfg.dynamicSmemBytes = C::kSmem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(&cfg, dq_wide_cluster_sm90_kernel<NB>, mq,
                                   mk, mv, mdo, lse, delta, segq, segk,
                                   (__nv_bfloat16*)dq, H, Hkv, Lq, Lk, Dp,
                                   causal, window, scale, y0);
  });
}

}  // namespace

int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* segq, const int* segk, void* dq, int BH, int H,
                   int Hkv, int Lq, int Lk, int D, int causal, int window,
                   float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<32>(q, k, v, dout, lse, delta, segq, segk, dq, BH, H,
                        Hkv, Lq, Lk, causal, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, dout, lse, delta, segq, segk, dq, BH, H,
                        Hkv, Lq, Lk, causal, window, scale, stream);
    case 128:
      return launch<128>(q, k, v, dout, lse, delta, segq, segk, dq, BH, H,
                         Hkv, Lq, Lk, causal, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, dout, lse, delta, segq, segk, dq, BH, H,
                         Hkv, Lq, Lk, causal, window, scale, stream);
  }
  if (D <= 256 || D % sm90::kChunkCols != 0) return (int)cudaErrorInvalidValue;
  // a cluster of n blocks of up to 4 chunks each, as even as NB allows,
  // where it spans D in at most kDqClusterBlocks blocks
  const int nch = D / sm90::kChunkCols;
  const int n = (nch + 3) / 4;
  if (n <= kDqClusterBlocks) {
    if ((nch + n - 1) / n == 4)
      return launch_cluster<4>(q, k, v, dout, lse, delta, segq, segk, dq, BH,
                               H, Hkv, Lq, Lk, D, n, causal, window, scale,
                               stream);
    return launch_cluster<3>(q, k, v, dout, lse, delta, segq, segk, dq, BH, H,
                             Hkv, Lq, Lk, D, n, causal, window, scale,
                             stream);
  }
  return launch_wide(q, k, v, dout, lse, delta, segq, segk, dq, BH, H, Hkv,
                     Lq, Lk, D, causal, window, scale, stream);
}

}  // namespace flash
