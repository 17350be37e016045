// Flash-attention forward (K1), bf16, for Hopper's tensor cores (sm_90a).
//
// Replaces: petastorm_tpu/ops/attention.py `_flash_kernel` (:260-348),
// launched by `_pallas_flash` (:494-561). The float32 instantiation stays on
// the FP32-core kernel of flash_fwd.cu (a float32 product on the tensor
// cores would be TF32); the C entry point `flash_fwd` sends dtype 1 here.
//
// What bounds it: at (8, 8, 2048, 64) bf16 causal the forward does 34.4
// GFLOP against 67.6 MB of compulsory traffic, ~510 FLOP/byte, above the
// bf16 ridge (~295): bound by operations. So both products run on wgmma
// (989 TFLOP/s bf16), fed by TMA. At D = 32 the exponentials bound it
// instead: one 2^x a live (q, k) pair on the special-function unit (16 a
// clock an SM) takes 1.8 times the products' time (below).
//
// Head dims: instantiated at D = 32, 64, 128 and 256 (sm90.cuh's Tile<D>:
// 64-byte swizzled rows at 32, one 128-byte block at 64, two at 128, four at
// 256); the wrapper pads any other D <= 256 with zero columns to the next of
// them, and any D past 256 to the next multiple of 64 (fwd_wide_sm90_kernel,
// below).
//
// Block (D = 64 and 256; 32 and 128 below): 288 threads (384 at D = 256,
// below). Warps 0-7 are two consumer warpgroups, each owning 64 of the
// block's 128 q rows of one (batch, head) row; warp 8 is the producer. TMA
// loads the 128 x D Q tile once; kRowsK x D K and V tiles (128 rows; 64 at
// D = 256) stream through a 2-stage ring (shared memory at D = 64: Q 16 KB
// + 2 x (V 16 KB + K 16 KB) + segment ids 2 x 512 B ~ 82 KB; at D = 256 Q
// 64 KB + 2 x (V 32 KB + K 32 KB) ~ 194 KB).
// Each stage has a `full` mbarrier (the TMA bytes plus one arrival per
// producer lane, after the lanes wrote the tile's kv segment ids) and an
// `empty` one (one arrival per consumer thread once its wgmmas are done).
// Per kv tile a consumer warpgroup runs S = Q K^T (D/16 x m64n{kRowsK}k16,
// A and B K-major from shared memory), the online softmax on the
// accumulator fragment (row max and sum over the 4 lanes of a quad, scale
// and log2(e) folded so the kernel uses exp2f), then O += P V (kRowsK/16 x
// m64nDk16, at D = 128 two m64n64k16 a step, one a column block; A = P from
// registers, B = V MN-major: the transpose bit).
//
// D = 256: O over 64 q rows is 128 floats a thread, beside S's 32 and P's
// 16 at 64-row kv tiles: more than the 168 registers a 288-thread launch
// bound allots. So the block has 384 threads, the producer warp in a
// warpgroup of its own whose setmaxnreg.dec hands its registers to the two
// consumer warpgroups (setmaxnreg.inc to 232; sm90.cuh), as K3 does at D =
// 128.
//
// D = 32 and 128, the Hopper schedule (fwd_persistent_sm90_kernel, below):
// at D = 64 and 256 a warpgroup issues S, waits for it, runs the softmax,
// issues P V and waits again, so the tensor cores idle through the
// softmax and the special-function unit through the products, and a
// block's start (its Q and first K, V tiles from memory, its first S) and
// end idle the SM, once for each of B H ceil(L / 128) blocks. Here:
// - A persistent grid: one block an SM, each walking the q tiles (items)
//   of the launch, last q tile first, a row of items a block at a time,
//   every other row in reverse (item_of: a block with a long item then
//   takes a short one). The
//   producer's ring of kv tiles and its Q tile run on from one item to
//   the next (Q is loaded again once the consumers' last S of the item is
//   done: a Q-empty mbarrier), so the next item's loads go out under this
//   item's last products and its stores.
// - The softmax under the products: a warpgroup issues tile j's S and
//   tile j - 1's P V together, waits for S alone (wgmma.wait_group 1) and
//   runs tile j's softmax under tile j - 1's P V (FA3's intra-warpgroup
//   overlap). Two S fragments in flight at D = 32 (tile j + 1's S issued
//   before tile j's softmax) measured slower, and ptxas serialized their
//   wgmmas (C7515); the two warpgroups taking turns at issuing their
//   products (FA3's ping-pong) measured within the spread at D = 128 and
//   slower at D = 32 (PERF.md).
// - 128-row kv tiles in 384 threads with setmaxnreg (232 registers a
//   consumer thread hold O, S's 64 floats and P's 32 bf16 pairs: at D =
//   128 FA3's configuration), half the per-tile wait, max, correction and
//   rescale of O of 64-row tiles. 3 stages at D = 128 (Q 32 KB + 3 x (V
//   32 KB + K 32 KB) ~ 227 KB), so a tile's loads have a tile's time to
//   land though its stage is freed only once its P V is done; 4 at D = 32
//   (~74 KB).
// - Every element's work: one FMNMX on the raw score (the scale is
//   positive, so the max of the scaled scores is the scaled max), one FFMA
//   (scale and max in one: s scale log2e - m), one ex2.approx (sm90::ex2)
//   and one FADD. The mask is a select to -inf in a loop of its own on
//   the tiles that need it: the causal test alone on a causal band's
//   diagonal tile, Mask::live on the others (a branch an element keeps
//   the compiler from interleaving the elements' exponentials).
// At D = 32 the exponentials are the floor of this work (one a live pair,
// 16 a clock an SM: 1.8 times the products' time at (8, 16, 2048, 32)).
//
// Precision: P is rounded to nearest bf16 before P V (the A operand of a
// bf16 wgmma is bf16), as scaled_dot_product_attention does and as the
// TPU's matrix unit did for the reference's default-precision dot. The row
// sum l is taken from the unrounded float32 p. o = acc / l is rounded to
// bf16 once; lse stays float32.
//
// Masks: per element from its (row, col) on the fragment (kv tail, q tail,
// causal, window, segment equality), only on tiles that need it: the
// diagonal, the window edge, the ragged tails, or any tile with segment
// ids. Whole kv tiles above the diagonal or behind the window are skipped,
// and q blocks are launched longest causal row first. A fully masked row
// gives o = 0 and lse = -1e30. Rows past Lq read as TMA zeros and are not
// written.
//
// Past D = 256 (fwd_wide_sm90_kernel): neither Q (128 x D) beside the K
// and V stages nor O over all of D (D/2 floats a thread) fits. A block
// owns 128 q rows and one 256-column slice of O (blockIdx.z; the last
// slice may be narrower), 384 threads with setmaxnreg as at D = 256. Per
// 64-row kv tile the producer streams D/64 chunks (Q 128 x 64 and K 64 x 64,
// one TMA box each, 24 KB) through a 4-stage ring, then V's slice (64 x
// 256, 32 KB) through a 2-stage ring with the tile's segment ids; the
// consumers add each chunk to S (4 x m64n64k16), then run the softmax and O
// += P V_slice as at D = 256. Each slice recomputes S over all of D: D/256
// times the score products, and Q is read again for every kv tile (from
// L2). lse is written by the first slice. Shared memory ~162 KB.
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kRowsQ = 128;                 // q rows per block
constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups

template <int D>
struct Fwd {
  // At D = 256 the producer is a whole warpgroup (one warp of it loads),
  // so that setmaxnreg can move its registers to the consumers.
  static constexpr bool kRealloc = D == 256;
  static constexpr int kThreads = kConsumers + (kRealloc ? 128 : 32);
  static constexpr int kRowsK = D >= 128 ? 64 : 128;  // kv rows per tile
  static constexpr int kTileQ = Tile<D>::bytes(kRowsQ);
  static constexpr int kTileK = Tile<D>::bytes(kRowsK);
  static constexpr int kOffQ = 0;
  static constexpr int kOffV = kOffQ + kTileQ;
  static constexpr int kOffK = kOffV + kStages * kTileK;
  static constexpr int kOffSeg = kOffK + kStages * kTileK;
  static constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
  static constexpr int kSmem = kOffBar + 64 + 1024;  // + slack to align
};

template <int D>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const int* __restrict__ segq,
                    const int* __restrict__ segk,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int Hkv, int Lq, int Lk, int causal, int window,
                    float scale, int y0) {
  using C = Fwd<D>;
  constexpr int kRowsK = C::kRowsK;
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
      mbar_arrive_tx(qbar, C::kTileQ);
      Tile<D>::load(base + C::kOffQ, &tmQ, qbar, q0, bh, kRowsQ);
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
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = r0 + frag_row(2 * h);
    sq[h] = (segq != nullptr && qpos[h] < Lq)
                ? segq[(size_t)bh * Lq + qpos[h]]
                : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[D / 2];
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
  mbar_wait(qbar, 0);

  for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
    const int s = i % kStages;
    const int k0 = kb * kRowsK;
    const uint32_t kaddr = base + C::kOffK + s * C::kTileK;
    const uint32_t vaddr = base + C::kOffV + s * C::kTileK;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[kRowsK / 2];
    wgmma_fence();
    wgmma_ss_tile<D>(sc, base + C::kOffQ, kRowsQ, 64 * wg, kaddr);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
    if (need_mask) {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        const int h = (r >> 1) & 1, c = frag_col(r);
        const int sk = segk != nullptr ? seg_tile[s * kRowsK + c] : 0;
        sc[r] = mask(qpos[h], k0 + c, sq[h], sk) ? sc[r] * scale2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        sc[r] *= scale2;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
      }
    }
    float m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with nothing live yet: masked scores (-1e30) give p = 0
      m_use[h] = m_new == kNegInf ? 0.f : m_new;
      corr[h] = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
    }
#pragma unroll
    for (int r = 0; r < kRowsK / 2; ++r) {
      sc[r] = exp2f(sc[r] - m_use[(r >> 1) & 1]);
      psum[(r >> 1) & 1] += sc[r];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] *= corr[(r >> 1) & 1];

    uint32_t a[kRowsK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) to_a_frag(sc, kk, a[kk]);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of V a step
      wgmma_rs_tile<D, 1>(acc, a[kk], vaddr, kRowsK, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (qpos[h] >= Lq) continue;
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
    store_row<D>(o + ((size_t)bh * Lq + qpos[h]) * D, acc, h, inv);
    if ((threadIdx.x & 3) == 0)
      lse[(size_t)bh * Lq + qpos[h]] =
          l[h] == 0.f ? kNegInf : m[h] / kLog2e + logf(l[h]);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* segq,
           const int* segk, void* o, float* lse, int BH, int H, int Hkv,
           int Lq, int Lk, int causal, int window, float scale,
           cudaStream_t stream) {
  using C = Fwd<D>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv;
  if (!Tile<D>::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !Tile<D>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<D>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_sm90_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    dim3 grid(BH, ny);
    fwd_sm90_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, segq, segk, (__nv_bfloat16*)o, lse, H, Hkv, Lq, Lk, causal,
        window, scale, y0);
    return (int)cudaGetLastError();
  });
}


// ---------------------------------------------------------------------------
// D = 32 and 128: the Hopper schedule (see the top of this file)
// ---------------------------------------------------------------------------

constexpr int kRowsKH = 128;                // kv rows per tile

template <int D>
struct FwdP {
  // a producer warpgroup (one warp of it loads) whose setmaxnreg.dec
  // hands its registers to the two consumer warpgroups
  static constexpr bool kRealloc = true;
  static constexpr int kThreads = kConsumers + (kRealloc ? 128 : 32);
  static constexpr int kRowsK = kRowsKH;              // kv rows per tile
  static constexpr int kStages = D == 32 ? 4 : 3;
  static constexpr int kTileQ = Tile<D>::bytes(kRowsQ);
  static constexpr int kTileK = Tile<D>::bytes(kRowsK);
  static constexpr int kOffQ = 0;
  static constexpr int kOffV = kOffQ + kTileQ;
  static constexpr int kOffK = kOffV + kStages * kTileK;
  static constexpr int kOffSeg = kOffK + kStages * kTileK;
  static constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
  static constexpr int kSmem =       // barriers: Q full, Q empty, the ring's
      kOffBar + 8 * (2 + 2 * kStages) + 1024;  // + slack to align to 1024
};

// A masked score: 2^-inf = 0, and a row whose scores are all -inf keeps
// m = -inf.
__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Work item k of block b of G: items go out row by row of G, every other
// row in reverse (b, 2 G - 1 - b, 2 G + b, ...), so that a block that took
// one of the longest items of a row takes one of the shortest of the next
// (items run longest first); -1 past the last of `items`.
__device__ __forceinline__ long long item_of(int k, int b, int G,
                                             long long items) {
  const long long w = (long long)k * G + ((k & 1) ? G - 1 - b : b);
  return w < items ? w : -1;
}

// The q tile of work item w of a launch (the launch's q-tile rows y0 ..,
// each of BH items, the last q tile first): its first q row and its
// (batch, head) row; and the kv tiles [lo, hi) it sees.
struct Item {
  int bh, q0, lo, hi;
  __device__ __forceinline__ Item(long long w, int BH, int y0, int Lq,
                                  int Lk, int causal, int window) {
    bh = (int)(w % BH);
    q0 = ((Lq - 1) / kRowsQ - (y0 + (int)(w / BH))) * kRowsQ;
    constexpr int kRowsK = kRowsKH;
    lo = 0;
    hi = (Lk + kRowsK - 1) / kRowsK;
    if (causal) {
      hi = min(hi, (q0 + kRowsQ - 1) / kRowsK + 1);
      if (window > 0) {
        const int first = q0 - window + 1;  // first position any row sees
        lo = first >= kRowsK ? first / kRowsK : 0;
      }
    }
  }
};

// The mask on the raw scores of kv tile k0 of the rows from r0, where the
// tile needs it: Mask::live's select on the window edge, the ragged tails
// and any tile with segment ids (`seg`, the tile's kv segment ids, or
// null); on the diagonal tile of a causal band alone, the causal test
// alone. Each element the mask drops becomes -inf.
template <int kRowsK, int R>
__device__ __forceinline__ void mask_tile(float (&sc)[R], const Mask& mask,
                                          const int (&qpos)[2],
                                          const int (&sq)[2], int r0, int k0,
                                          const int* seg) {
  const bool diagonal = mask.causal && k0 + kRowsK - 1 > r0;
  if (seg != nullptr || k0 + kRowsK > mask.Lk || r0 + 64 > mask.Lq ||
      (mask.causal && mask.window > 0 && r0 + 63 - k0 >= mask.window)) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int h = (r >> 1) & 1, c = frag_col(r);
      sc[r] = mask.live(qpos[h], k0 + c, sq[h], seg != nullptr ? seg[c] : 0)
                  ? sc[r] : neg_inf();
    }
  } else if (diagonal) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int h = (r >> 1) & 1, c = frag_col(r);
      sc[r] = k0 + c <= qpos[h] ? sc[r] : neg_inf();
    }
  }
}

// The online softmax of one kv tile: sc holds the raw scores, masked ones
// -inf; on return p = 2^(s scale2 - m) (one FFMA and one ex2.approx an
// element), m (in log2 units) and l are updated, and corr holds
// 2^(m_old - m_new) of each fragment row.
template <int R>
__device__ __forceinline__ void online_softmax(float (&sc)[R], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2],
                                               float scale2) {
  float mx[2][2] = {{neg_inf(), neg_inf()}, {neg_inf(), neg_inf()}};
#pragma unroll
  for (int r = 0; r < R; ++r) {             // two chains a row
    float& x = mx[(r >> 1) & 1][(r >> 2) & 1];
    x = fmaxf(x, sc[r]);
  }
  float neg_m[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = fmaxf(mx[h][0], mx[h][1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[h], x * scale2);
    // a row with nothing live yet: every score -inf, so p = 0
    const float m_use = m_new == neg_inf() ? 0.f : m_new;
    corr[h] = ex2(m[h] - m_use);
    m[h] = m_new;
    neg_m[h] = -m_use;
  }
  float ps[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = (r >> 1) & 1;
    sc[r] = ex2(fmaf(sc[r], scale2, neg_m[h]));
    ps[h][(r >> 2) & 1] += sc[r];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + (ps[h][0] + ps[h][1]);
}

// O rescaled by each row's correction, and p as the A operand of P V.
template <int D, int R>
__device__ __forceinline__ void rescale_pack(float (&acc)[D / 2],
                                             uint32_t (&pa)[R / 8][4],
                                             const float (&sc)[R],
                                             const float (&corr)[2]) {
#pragma unroll
  for (int r = 0; r < D / 2; ++r) acc[r] *= corr[(r >> 1) & 1];
#pragma unroll
  for (int kk = 0; kk < R / 8; ++kk) to_a_frag(sc, kk, pa[kk]);
}

template <int D>
__global__ void __launch_bounds__(FwdP<D>::kThreads, 1)
    fwd_persistent_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                               const __grid_constant__ CUtensorMap tmK,
                               const __grid_constant__ CUtensorMap tmV,
                               const int* __restrict__ segq,
                               const int* __restrict__ segk,
                               __nv_bfloat16* __restrict__ o,
                               float* __restrict__ lse, int BH, int H,
                               int Hkv, int Lq, int Lk, int causal,
                               int window, float scale, int y0, int ny) {
  using C = FwdP<D>;
  constexpr int kRowsK = C::kRowsK, kStages = C::kStages;
  constexpr int R = kRowsK / 2;               // S fragment registers
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t pad = (1024 - (raw & 1023)) & 1023;
  const uint32_t base = raw + pad;
  int* seg_tile = reinterpret_cast<int*>(smem_raw + pad + C::kOffSeg);
  const uint32_t q_tile = base + C::kOffQ;
  const uint32_t qfull = base + C::kOffBar, qempty = qfull + 8;
  const uint32_t full0 = qempty + 8, empty0 = full0 + 8 * kStages;
  const long long items = (long long)BH * ny;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qempty, kConsumers);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1 + 32);
      mbar_init(empty0 + 8 * s, kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Each block takes items blockIdx.x, + gridDim.x, ...; the ring's kv
  // tiles (g counts them) and the Q tile (it counts items) run on from
  // one item to the next, so the next item's loads go out under this
  // one's last products.
  if (threadIdx.x >= kConsumers) {            // producer warpgroup
    if constexpr (C::kRealloc) {
      producer_regs();
      if (threadIdx.x >= kConsumers + 32) return;  // the idle three warps
    }
    const int lane = threadIdx.x & 31;
    int g = 0;
    for (int it = 0;; ++it) {
      const long long w = item_of(it, blockIdx.x, gridDim.x, items);
      if (w < 0) break;
      const Item item(w, BH, y0, Lq, Lk, causal, window);
      const int kvh = kv_row(item.bh, H, Hkv);
      mbar_wait(qempty, (it & 1) ^ 1);        // the last item's S are done
      if (lane == 0) {
        mbar_arrive_tx(qfull, C::kTileQ);
        Tile<D>::load(q_tile, &tmQ, qfull, item.q0, item.bh, kRowsQ);
      }
      for (int kb = item.lo; kb < item.hi; ++kb, ++g) {
        const int s = g % kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((g / kStages) & 1) ^ 1);
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
    }
    return;
  }

  // consumer warpgroup wg owns q rows r0 .. r0 + 63 of each item's tile
  if constexpr (C::kRealloc) consumer_regs();
  const int wg = threadIdx.x >> 7;
  const float scale2 = scale * kLog2e;
  const Mask mask{Lq, Lk, causal, window};
  int g = 0;
  for (int it = 0;; ++it) {
    const long long w = item_of(it, blockIdx.x, gridDim.x, items);
    if (w < 0) break;
    const Item item(w, BH, y0, Lq, Lk, causal, window);
    const int bh = item.bh, r0 = item.q0 + 64 * wg;
    const int n = item.hi - item.lo;          // tile t: kv tile lo + t
    int qpos[2], sq[2];
    float m[2], l[2], corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qpos[h] = r0 + frag_row(2 * h);
      sq[h] = (segq != nullptr && qpos[h] < Lq)
                  ? segq[(size_t)bh * Lq + qpos[h]]
                  : 0;
      m[h] = neg_inf();
      l[h] = 0.f;
    }
    float acc[D / 2], sc[R];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;
    uint32_t pa[kRowsK / 16][4];              // P, the A operand of P V
    // tile t's stage, its K and V tiles and its segment ids (or null)
    auto stage = [&](int t) { return (g + t) % kStages; };
    auto k_tile = [&](int t) {
      return base + C::kOffK + stage(t) * C::kTileK;
    };
    auto v_tile = [&](int t) {
      return base + C::kOffV + stage(t) * C::kTileK;
    };
    auto wait_full = [&](int t) {
      mbar_wait(full0 + 8 * stage(t), ((g + t) / kStages) & 1);
    };
    auto mask_of = [&](int t) {
      mask_tile<kRowsK>(sc, mask, qpos, sq, r0, (item.lo + t) * kRowsK,
                        segk != nullptr ? seg_tile + stage(t) * kRowsK
                                        : nullptr);
    };
    auto issue_pv = [&](int t) {
#pragma unroll
      for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of V a step
        wgmma_rs_tile<D, 1>(acc, pa[kk], v_tile(t), kRowsK, 16 * kk);
      wgmma_commit();
    };
    mbar_wait(qfull, it & 1);
    if (n == 0) mbar_arrive(qempty);
    if (n > 0) {                              // tile 0: S alone
      wait_full(0);
      wgmma_fence();
      wgmma_ss_tile<D>(sc, q_tile, kRowsQ, 64 * wg, k_tile(0));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      if (n == 1) mbar_arrive(qempty);
      mask_of(0);
      online_softmax(sc, m, l, corr, scale2);
      rescale_pack<D>(acc, pa, sc, corr);
    }
    // tile t: issue t's S and t - 1's P V together; wait for S alone; t's
    // softmax under t - 1's P V; then t - 1's stage freed
#pragma unroll 1
    for (int t = 1; t < n; ++t) {
      wait_full(t);
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      wgmma_ss_tile<D>(sc, q_tile, kRowsQ, 64 * wg, k_tile(t));
      wgmma_commit();
      issue_pv(t - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      if (t == n - 1) mbar_arrive(qempty);    // the item's last S
      mask_of(t);
      online_softmax(sc, m, l, corr, scale2);
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * stage(t - 1));
      rescale_pack<D>(acc, pa, sc, corr);
    }
    if (n > 0) {                              // the last tile's P V
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(n - 1);
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty0 + 8 * stage(n - 1));
    }
    g += n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (qpos[h] >= Lq) continue;
      const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
      store_row<D>(o + ((size_t)bh * Lq + qpos[h]) * D, acc, h, inv);
      if ((threadIdx.x & 3) == 0)
        lse[(size_t)bh * Lq + qpos[h]] =
            l[h] == 0.f ? kNegInf : m[h] / kLog2e + logf(l[h]);
    }
  }
}

template <int D>
int launch_persistent(const void* q, const void* k, const void* v,
                      const int* segq, const int* segk, void* o, float* lse,
                      int BH, int H, int Hkv, int Lq, int Lk, int causal,
                      int window, float scale, cudaStream_t stream) {
  using C = FwdP<D>;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv;
  if (!Tile<D>::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !Tile<D>::make_map(&mk, k, BHkv, Lk, C::kRowsK) ||
      !Tile<D>::make_map(&mv, v, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_persistent_sm90_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // one block an SM (at most one an item), each walking its items
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    const long long items = (long long)BH * ny;
    const int grid = (int)(items < sms ? items : sms);
    fwd_persistent_sm90_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, segq, segk, (__nv_bfloat16*)o, lse, BH, H, Hkv, Lq, Lk,
        causal, window, scale, y0, ny);
    return (int)cudaGetLastError();
  });
}

// Head dims past 256 (see the top of this file): one 256-column slice of O
// a block, S streamed over D in 64-column chunks.
struct FwdWide {
  static constexpr int kThreads = kConsumers + 128;
  static constexpr int kW = 256;                 // O columns a block
  static constexpr int kRowsK = 64;              // kv rows per tile
  static constexpr int kChunkStages = 4;
  static constexpr int kSliceStages = 2;
  static constexpr int kChunkQ = kRowsQ * kChunkRowBytes;   // 16 KB
  static constexpr int kChunk = kChunkQ + kRowsK * kChunkRowBytes;
  static constexpr int kSlice = Tile<kW>::bytes(kRowsK);    // V: 32 KB
  static constexpr int kOffSlice = kChunkStages * kChunk;
  static constexpr int kOffSeg = kOffSlice + kSliceStages * kSlice;
  static constexpr int kOffBar = kOffSeg + kSliceStages * kRowsK * 4;
  static constexpr int kSmem =
      kOffBar + 8 * 2 * (kChunkStages + kSliceStages) + 1024;
};

__global__ void __launch_bounds__(FwdWide::kThreads, 1)
    fwd_wide_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                         const __grid_constant__ CUtensorMap tmK,
                         const __grid_constant__ CUtensorMap tmV,
                         const int* __restrict__ segq,
                         const int* __restrict__ segk,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int Hkv, int Lq,
                         int Lk, int Dp, int causal, int window,
                         float scale, int y0) {
  using C = FwdWide;
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
  const int col0 = C::kW * blockIdx.z;         // this block's O columns
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
      for (int c = 0; c < nch; ++c, ++ic) {   // Q and K chunk c
        const int s = ic % kCS;
        const uint32_t full = cfull0 + 8 * s;
        const uint32_t dst = base + s * C::kChunk;
        mbar_wait(cempty0 + 8 * s, ((ic / kCS) & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_tx(full, C::kChunk);
          tma_load_3d(dst, &tmQ, full, kChunkCols * c, q0, bh);
          tma_load_3d(dst + C::kChunkQ, &tmK, full, kChunkCols * c,
                      kb * kRowsK, kvh);
        }
      }
      const int s = i % kSS;                  // V's slice, the segment ids
      const uint32_t full = sfull0 + 8 * s;
      mbar_wait(sempty0 + 8 * s, ((i / kSS) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_tx(full, ncols / kChunkCols * kRowsK * kChunkRowBytes);
        load_blocks(base + C::kOffSlice + s * C::kSlice, &tmV, full, col0,
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
  float m[2], l[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = r0 + frag_row(2 * h);
    sq[h] = (segq != nullptr && qpos[h] < Lq)
                ? segq[(size_t)bh * Lq + qpos[h]]
                : 0;
    m[h] = kNegInf;
    l[h] = 0.f;
  }
  float acc[C::kW / 2];
#pragma unroll
  for (int r = 0; r < C::kW / 2; ++r) acc[r] = 0.f;

  for (int kb = kb_lo, i = 0, ic = 0; kb < kb_hi; ++kb, ++i) {
    const int k0 = kb * kRowsK;
    float sc[kRowsK / 2];
    for (int c = 0; c < nch; ++c, ++ic) {     // S over D, a chunk at a time
      const int s = ic % kCS;
      const uint32_t chunk = base + s * C::kChunk;
      mbar_wait(cfull0 + 8 * s, (ic / kCS) & 1);
      wgmma_fence();
      wgmma_ss_chunk(sc, chunk, kRowsQ, 64 * wg, chunk + C::kChunkQ, kRowsK,
                     0, c > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(cempty0 + 8 * s);
    }
    const int s = i % kSS;
    const uint32_t vaddr = base + C::kOffSlice + s * C::kSlice;
    mbar_wait(sfull0 + 8 * s, (i / kSS) & 1);

    const bool diag = causal && k0 + kRowsK - 1 > r0;  // reaches above it
    const bool need_mask =
        diag || segk != nullptr || k0 + kRowsK > Lk || r0 + 64 > Lq ||
        (causal && window > 0 && r0 + 63 - k0 >= window);
    float mx[2] = {kNegInf, kNegInf};
    if (need_mask) {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        const int h = (r >> 1) & 1, c = frag_col(r);
        const int sk = segk != nullptr ? seg_tile[s * kRowsK + c] : 0;
        sc[r] = mask(qpos[h], k0 + c, sq[h], sk) ? sc[r] * scale2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < kRowsK / 2; ++r) {
        sc[r] *= scale2;
        mx[(r >> 1) & 1] = fmaxf(mx[(r >> 1) & 1], sc[r]);
      }
    }
    float m_use[2], corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      // a row with nothing live yet: masked scores (-1e30) give p = 0
      m_use[h] = m_new == kNegInf ? 0.f : m_new;
      corr[h] = exp2f(m[h] - m_use[h]);
      m[h] = m_new;
    }
#pragma unroll
    for (int r = 0; r < kRowsK / 2; ++r) {
      sc[r] = exp2f(sc[r] - m_use[(r >> 1) & 1]);
      psum[(r >> 1) & 1] += sc[r];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
    for (int r = 0; r < C::kW / 2; ++r) acc[r] *= corr[(r >> 1) & 1];

    uint32_t a[kRowsK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk) to_a_frag(sc, kk, a[kk]);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kRowsK / 16; ++kk)   // 16 kv rows of V a step
      wgmma_rs_tile<C::kW, 1>(acc, a[kk], vaddr, kRowsK, 16 * kk);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(sempty0 + 8 * s);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (qpos[h] >= Lq) continue;
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
    store_row_n<C::kW>(o + ((size_t)bh * Lq + qpos[h]) * Dp + col0, acc, h,
                       inv, ncols);
    if (blockIdx.z == 0 && (threadIdx.x & 3) == 0)
      lse[(size_t)bh * Lq + qpos[h]] =
          l[h] == 0.f ? kNegInf : m[h] / kLog2e + logf(l[h]);
  }
}

int launch_wide(const void* q, const void* k, const void* v, const int* segq,
                const int* segk, void* o, float* lse, int BH, int H, int Hkv,
                int Lq, int Lk, int Dp, int causal, int window, float scale,
                cudaStream_t stream) {
  using C = FwdWide;
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv;
  if (!make_wide_map(&mq, q, Dp, BH, Lq, kRowsQ) ||
      !make_wide_map(&mk, k, Dp, BHkv, Lk, C::kRowsK) ||
      !make_wide_map(&mv, v, Dp, BHkv, Lk, C::kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_wide_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (err != cudaSuccess) return (int)err;
  return launch_in_chunks((Lq + kRowsQ - 1) / kRowsQ, [&](int y0, int ny) {
    dim3 grid(BH, ny, (Dp + C::kW - 1) / C::kW);
    fwd_wide_sm90_kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
        mq, mk, mv, segq, segk, (__nv_bfloat16*)o, lse, H, Hkv, Lq, Lk, Dp,
        causal, window, scale, y0);
    return (int)cudaGetLastError();
  });
}

}  // namespace

int launch_fwd_sm90(const void* q, const void* k, const void* v,
                    const int* segq, const int* segk, void* o, float* lse,
                    int BH, int H, int Hkv, int Lq, int Lk, int D, int causal,
                    int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_persistent<32>(q, k, v, segq, segk, o, lse, BH, H, Hkv,
                                   Lq, Lk, causal, window, scale, stream);
    case 64:
      return launch<64>(q, k, v, segq, segk, o, lse, BH, H, Hkv, Lq, Lk,
                        causal, window, scale, stream);
    case 128:
      return launch_persistent<128>(q, k, v, segq, segk, o, lse, BH, H, Hkv,
                                    Lq, Lk, causal, window, scale, stream);
    case 256:
      return launch<256>(q, k, v, segq, segk, o, lse, BH, H, Hkv, Lq, Lk,
                         causal, window, scale, stream);
  }
  if (D > 256 && D % sm90::kChunkCols == 0)
    return launch_wide(q, k, v, segq, segk, o, lse, BH, H, Hkv, Lq, Lk, D,
                       causal, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash
