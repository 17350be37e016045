// Image normalisation (K4) for Hopper, CUDA C++.
//
// Replaces: petastorm_tpu/ops/normalize.py `_normalize_kernel` (:21-23),
// launched by `normalize_images` (:26-56).
//
// What it computes: out = ((x * (1/255)) - mean[c]) * inv_std[c], cast to
// bfloat16 (round to nearest even) or float32, over a uint8 (N, H, W, C)
// image batch, c = i % C of the flat element index i, for any C. mean and
// inv_std come as one float32 (2, C) table in device memory; each block
// stages it in shared memory (up to kStagedChannels channels; a wider table
// is read where it lies, through the read-only cache). The TPU kernel tiled
// mean and inv_std to full (H*W*C,) rows to match its block layout
// (:45-46); here the channel is the flat index modulo C, and nothing but the
// image and the 2 C table is read.
//
// Rounding: each of the three operations rounds on its own (__fmul_rn,
// __fsub_rn, __fmul_rn), as the plain PyTorch twin and the JAX reference's
// formula do. nvcc would otherwise contract the multiply and the subtract into
// one FMA, which rounds once and changes the last bit of float32 results
// near the mean.
//
// What bounds it on the H100: one read of 1 byte and one write of 2 (bf16)
// or 4 (float32) bytes per element and three flops: bound by bytes. At the
// image line's shape (64, 224, 224, 3) -> bf16 that is 28.9 MB, 8.6 us at
// 3.35 TB/s. Each thread takes 16 consecutive bytes with one 16-byte load and
// writes its 16 outputs with 16-byte stores (two for bf16, four for float32),
// so a warp moves 512 contiguous bytes in and 1 or 2 KB out per access. A
// pointer that is not 16-byte aligned, or the last group of a tensor whose
// size is not a multiple of 16, takes the scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace normalize {

constexpr int kGroup = 16;     // elements per thread: one 16-byte load
constexpr int kThreads = 256;

constexpr int kStagedChannels = 1024;   // 8 KB of shared memory a block

__device__ __forceinline__ float apply(uint32_t x, int c, const float* mean,
                                       const float* inv_std) {
  const float kScale = (float)(1.0 / 255.0);
  float s = __fmul_rn((float)x, kScale);
  return __fmul_rn(__fsub_rn(s, mean[c]), inv_std[c]);
}

__device__ __forceinline__ void store_one(float* out, float v) { *out = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* out, float v) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void store_group(float* out, const float (&r)[kGroup]) {
  float4* o = reinterpret_cast<float4*>(out);
#pragma unroll
  for (int j = 0; j < kGroup / 4; ++j)
    o[j] = make_float4(r[4 * j], r[4 * j + 1], r[4 * j + 2], r[4 * j + 3]);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* out,
                                            const float (&r)[kGroup]) {
  uint4 packed[2];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(packed);
#pragma unroll
  for (int j = 0; j < kGroup / 2; ++j)
    h[j] = __floats2bfloat162_rn(r[2 * j], r[2 * j + 1]);
  uint4* o = reinterpret_cast<uint4*>(out);
  o[0] = packed[0];
  o[1] = packed[1];
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
    normalize_kernel(const uint8_t* __restrict__ x, OutT* __restrict__ out,
                     long long n, int C, const float* __restrict__ table,
                     int vector) {
  __shared__ float staged[2 * kStagedChannels];
  const float* ch = table;                   // mean[C], then inv_std[C]
  if (C <= kStagedChannels) {
    for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) staged[i] = table[i];
    __syncthreads();
    ch = staged;
  }
  const float* mean = ch;
  const float* inv_std = ch + C;
  long long base =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) * kGroup;
  if (base >= n) return;
  int c = (int)(base % C);
  if (vector && base + kGroup <= n) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + base);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    float r[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      r[j] = apply((w[j / 4] >> (8 * (j % 4))) & 0xffu, c, mean, inv_std);
      c = (c + 1 == C) ? 0 : c + 1;
    }
    store_group(out + base, r);
    return;
  }
  long long end = base + kGroup < n ? base + kGroup : n;
  for (long long i = base; i < end; ++i) {
    store_one(out + i, apply(x[i], c, mean, inv_std));
    c = (c + 1 == C) ? 0 : c + 1;
  }
}

template <typename OutT>
int launch(const uint8_t* x, void* out, long long n, int C,
           const float* table, cudaStream_t stream) {
  OutT* o = static_cast<OutT*>(out);
  int vector = ((uintptr_t)x % 16 == 0) && ((uintptr_t)o % 16 == 0);
  long long groups = (n + kGroup - 1) / kGroup;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
  normalize_kernel<OutT><<<(unsigned)blocks, kThreads, 0, stream>>>(
      x, o, n, C, table, vector);
  return (int)cudaGetLastError();
}

}  // namespace normalize

// table: float32 (2, C) on the device, mean then inv_std. out_dtype: 0
// float32, 1 bfloat16 (as ops/kernels.py _DTYPES).
extern "C" int normalize_u8(const void* x, void* out, long long n, int C,
                            const float* table, int out_dtype, void* stream) {
  if (C < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const uint8_t* in = static_cast<const uint8_t*>(x);
  cudaStream_t s = (cudaStream_t)stream;
  if (out_dtype == 0) return normalize::launch<float>(in, out, n, C, table, s);
  if (out_dtype == 1)
    return normalize::launch<__nv_bfloat16>(in, out, n, C, table, s);
  return (int)cudaErrorInvalidValue;
}
