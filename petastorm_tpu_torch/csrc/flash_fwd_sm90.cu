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
// (989 TFLOP/s bf16), fed by TMA.
//
// Block: 288 threads. Warps 0-7 are two consumer warpgroups, each owning 64
// of the block's 128 q rows of one (batch, head) row; warp 8 is the
// producer. TMA loads the 128 x 64 Q tile once; 128 x 64 K and V tiles
// stream through a 2-stage ring (shared memory: Q 16 KB + 2 x (V 16 KB + K
// 16 KB) + segment ids 2 x 512 B ~ 82 KB, all tiles 128-byte swizzled).
// Each stage has a `full` mbarrier (the TMA bytes plus one arrival per
// producer lane, after the lanes wrote the tile's kv segment ids) and an
// `empty` one (one arrival per consumer thread once its wgmmas are done).
// Per kv tile a consumer warpgroup runs S = Q K^T (4 x m64n128k16, A and B
// K-major from shared memory), the online softmax on the accumulator
// fragment (row max and sum over the 4 lanes of a quad, scale and log2(e)
// folded so the kernel uses exp2f), then O += P V (8 x m64n64k16, A = P from
// registers, B = V MN-major: the transpose bit). ptxas gives it 168
// registers and no spills.
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
#include "flash_common.cuh"
#include "sm90.cuh"

namespace flash {
namespace {

using namespace sm90;

constexpr int kRowsQ = 128;                 // q rows per block
constexpr int kRowsK = 128;                 // kv rows per tile
constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreadsFwd = kConsumers + 32;  // + one producer warp
constexpr int kTileQ = kRowsQ * kRowBytes;  // 16 KB
constexpr int kTileK = kRowsK * kRowBytes;  // 16 KB
constexpr int kOffQ = 0;
constexpr int kOffV = kOffQ + kTileQ;
constexpr int kOffK = kOffV + kStages * kTileK;
constexpr int kOffSeg = kOffK + kStages * kTileK;
constexpr int kOffBar = kOffSeg + kStages * kRowsK * 4;
constexpr int kSmemFwd = kOffBar + 64 + 1024;  // + slack to align to 1024

__global__ void __launch_bounds__(kThreadsFwd, 1)
    fwd_sm90_kernel(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const int* __restrict__ segq,
                    const int* __restrict__ segk,
                    __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                    int H, int Hkv, int Lq, int Lk, int causal, int window,
                    float scale) {
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
      mbar_arrive_tx(qbar, kTileQ);
      tma_load_3d(base + kOffQ, &tmQ, qbar, 0, q0, bh);
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
  float acc[32];
#pragma unroll
  for (int r = 0; r < 32; ++r) acc[r] = 0.f;
  const uint64_t dq = desc_kmajor(base + kOffQ + wg * 64 * kRowBytes);
  mbar_wait(qbar, 0);

  for (int kb = kb_lo, i = 0; kb < kb_hi; ++kb, ++i) {
    const int s = i % kStages;
    const int k0 = kb * kRowsK;
    const uint32_t kaddr = base + kOffK + s * kTileK;
    const uint32_t vaddr = base + kOffV + s * kTileK;
    mbar_wait(full0 + 8 * s, (i / kStages) & 1);

    float sc[64];
    const uint64_t dk = desc_kmajor(kaddr);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)        // +32 bytes = 16 columns of D
      wgmma_ss_n128(sc, dq + 2 * kk, dk + 2 * kk, kk > 0);
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
      for (int r = 0; r < 64; ++r) {
        const int h = (r >> 1) & 1, c = frag_col(r);
        const int sk = segk != nullptr ? seg_tile[s * kRowsK + c] : 0;
        sc[r] = mask(qpos[h], k0 + c, sq[h], sk) ? sc[r] * scale2 : kNegInf;
        mx[h] = fmaxf(mx[h], sc[r]);
      }
    } else {
#pragma unroll
      for (int r = 0; r < 64; ++r) {
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
    for (int r = 0; r < 64; ++r) {
      sc[r] = exp2f(sc[r] - m_use[(r >> 1) & 1]);
      psum[(r >> 1) & 1] += sc[r];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + psum[h];
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[r] *= corr[(r >> 1) & 1];

    uint32_t a[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) to_a_frag(sc, kk, a[kk]);
    fence_regs(acc);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)        // 16 kv rows of V = 2048 bytes
      wgmma_rs_n64<1>(acc, a[kk], desc_mnmajor(vaddr + kk * 16 * kRowBytes));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    if (qpos[h] >= Lq) continue;
    const float inv = l[h] == 0.f ? 0.f : 1.f / l[h];
    __nv_bfloat16* orow = o + ((size_t)bh * Lq + qpos[h]) * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = 4 * j + 2 * h;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * cq) =
          __floats2bfloat162_rn(acc[r] * inv, acc[r + 1] * inv);
    }
    if (cq == 0)
      lse[(size_t)bh * Lq + qpos[h]] =
          l[h] == 0.f ? kNegInf : m[h] / kLog2e + logf(l[h]);
  }
}

}  // namespace

int launch_fwd_sm90(const void* q, const void* k, const void* v,
                    const int* segq, const int* segk, void* o, float* lse,
                    int BH, int H, int Hkv, int Lq, int Lk, int causal,
                    int window, float scale, cudaStream_t stream) {
  const int BHkv = BH / H * Hkv;
  CUtensorMap mq, mk, mv;
  if (!sm90::make_map(&mq, q, BH, Lq, kRowsQ) ||
      !sm90::make_map(&mk, k, BHkv, Lk, kRowsK) ||
      !sm90::make_map(&mv, v, BHkv, Lk, kRowsK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemFwd);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(BH, (Lq + kRowsQ - 1) / kRowsQ);
  fwd_sm90_kernel<<<grid, kThreadsFwd, kSmemFwd, stream>>>(
      mq, mk, mv, segq, segk, (__nv_bfloat16*)o, lse, H, Hkv, Lq, Lk, causal,
      window, scale);
  return (int)cudaGetLastError();
}

}  // namespace flash
