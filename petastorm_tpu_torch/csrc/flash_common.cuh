// Shared pieces of the hand-written flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): element conversions, the tile loader, the thread layout and
// the attention mask. Plain C interface, no PyTorch headers: the library is
// built with one nvcc call and loaded with ctypes (ops/kernels.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

// Masked-score sentinel of the reference (-1e30, not -inf): a fully masked
// row ends with l == 0, o == 0 and lse == kNegInf; the backward gates p to 0
// where lse <= kNegInf / 2.
constexpr float kNegInf = -1e30f;

// Tile sizes and block shape shared by the three kernels. 256 threads form a
// 16 x 16 grid: thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
// (i, j < 4) of every 64 x 64 score tile, so a row's 16 owners are one
// half-warp and row reductions are four xor-shuffles.
constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr int kSub = 4;            // rows (and score columns) per thread

// The head dims the kernels are instantiated for (float32: the FP32-core
// kernels' template; bf16: the wgmma kernels' Tile<D>); the C entry points
// return cudaErrorInvalidValue for any other, and the wrapper pads a head dim
// up to the next of these (ops/kernels.py).
#define FLASH_FOR_HEAD_DIMS_F32(X) X(16) X(32) X(64) X(128)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Lane {
  int tx, ty;
};

__device__ __forceinline__ Lane lane_layout() {
  const int tid = (int)threadIdx.x;
  const int lane = tid & 31;
  return Lane{lane & 15, (tid >> 5) * 2 + (lane >> 4)};
}

// Sum / max over the 16 threads that own one row (one half-warp).
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// Copy rows [r0, r0 + kRows) of a row-major (L, D) matrix into shared memory
// as float32 with row stride `stride`; rows at or past L read as zero (the
// ragged edge is masked here instead of padded in device memory).
template <int D, int kRows, typename T>
__device__ __forceinline__ void load_tile(float* dst, int stride,
                                          const T* __restrict__ src, int r0,
                                          int L) {
  for (int idx = threadIdx.x; idx < kRows * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int g = r0 + r;
    dst[r * stride + c] = g < L ? to_f32(src[(size_t)g * D + c]) : 0.f;
  }
}

// The reference's mask (attention.py `_flash_kernel` :312-325): kv tail,
// q tail, causal q >= k, window q - k < W, and segment equality.
struct Mask {
  int Lq, Lk, causal, window;
  __device__ __forceinline__ bool operator()(int qp, int kp, int sq,
                                             int sk) const {
    bool ok = kp < Lk && qp < Lq && sq == sk;
    if (causal) {
      ok = ok && qp >= kp;
      if (window > 0) ok = ok && (qp - kp < window);
    }
    return ok;
  }
};

// Grouped-query head map (attention.py `_FlashDims.kv_program_index`):
// flat q row b reads kv row (b / H) * Hkv + (b % H) / (H / Hkv).
__device__ __forceinline__ int kv_row(int bh, int H, int Hkv) {
  return (bh / H) * Hkv + (bh % H) / (H / Hkv);
}

}  // namespace flash
