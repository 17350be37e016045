// Hopper (sm_90a) building blocks of the bf16 flash kernels
// (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu, flash_bwd_sm90.cu), in inline
// PTX: mbarriers, TMA tile loads, wgmma shared-memory descriptors and the
// wgmma shapes the kernels issue. No CUTLASS: the nvcc calls stay in
// seconds.
//
// Tiles of a head dim D (Tile<D>, D = 32, 64, 128 or 256) are stored by TMA
// as column blocks of kCols = min(D, 64) bf16 columns, each kRowBytes = 2
// kCols wide and swizzled at that width: the 128-byte swizzle for 64 columns
// (row r's 16-byte chunk c at chunk c ^ (r % 8)), the 64-byte swizzle for 32
// (chunk c ^ ((r / 2) % 4)). D = 128 is two 64-column blocks and D = 256
// four, each after the previous one's rows (a TMA box's inner dim is at most
// the swizzle width, so it takes a box a block); D = 32 is one block of
// 64-byte rows, not padded to 64 columns. A block of R rows takes R
// kRowBytes, so with R a multiple of 8 every block starts on a swizzle atom
// of 8 rows, and a wgmma descriptor can address any 8-row group and any
// 16-column k step of it. Blocks 2 and 3 of a D = 256 tile of R rows are laid
// out as a D = 128 tile of R rows 2 R kRowBytes past its start.
//
// Head dims past 256 (the wide kernels; the bottom of this file): a bf16 row
// of Dp columns (Dp a multiple of 64, any width) is read through one map
// with 64-column boxes (make_wide_map). A chunk of 64 columns of R rows is
// one box, laid out as a Tile<64> of R rows: the contractions over D (S = Q
// K^T, dP = dO V^T) stream chunk by chunk, one 4-k-step wgmma a chunk. A
// slice of up to kW output columns (256, or 128 for dK and dV) is its
// column blocks loaded as a Tile<kW> of R rows, the blocks past Dp left
// unloaded: their products land in accumulator registers that are never
// stored.
#pragma once

#include <cuda.h>              // CUtensorMap and its enums (header only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Load the box at (column c0, row c1, matrix c2) of a 3-D (BH, L, D) map
// into shared memory at `dst`; completion is counted on `bar`. Rows at or
// past L arrive as zeros.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, not in the runtime library:
// fetch its address at run time so the library needs no -lcuda.
static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                              cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// Shared-memory matrix descriptor of wgmma: start address, leading and
// stride byte offsets, and the swizzle (layout type 1: 128-byte, 2: 64-byte).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// The descriptor of the address `bytes` (a multiple of 16) past desc's:
// the start address field holds address / 16 in its low 14 bits, and a
// shared-memory address stays below 2^18, so the add never carries out.
__device__ __forceinline__ uint64_t desc_add(uint64_t desc, uint32_t bytes) {
  return desc + (bytes >> 4);
}

// The layout of a bf16 (rows, D) tile in shared memory (see the top of this
// file), its TMA map and its wgmma descriptors.
template <int D>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "head dim 32, 64, 128 or 256");
  static constexpr int kCols = D < 64 ? D : 64;     // columns of one block
  static constexpr int kRowBytes = 2 * kCols;       // 64 or 128
  static constexpr int kBlocks = D / kCols;         // 1, 2 or 4
  static constexpr int kAtomBytes = 8 * kRowBytes;  // one 8-row swizzle atom
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;

  static constexpr int bytes(int rows) { return rows * D * 2; }

  // A 3-D (rows of matrices, L, D) map with boxes of `box_rows` x kCols.
  // 3-D and not (rows * L, D): a box that runs past L must read zeros, not
  // the next matrix's first rows. Returns false on failure (the pointer
  // must be 16-byte aligned).
  static bool make_map(CUtensorMap* map, const void* base, int mats, int L,
                       int box_rows) {
    EncodeTiledFn fn = encode_tiled();
    if (fn == nullptr) return false;
    const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)L,
                                (cuuint64_t)mats};
    const cuuint64_t strides[2] = {(cuuint64_t)D * 2,
                                   (cuuint64_t)L * D * 2};
    const cuuint32_t box[3] = {(cuuint32_t)kCols, (cuuint32_t)box_rows, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
              const_cast<void*>(base), dims, strides, box, elem,
              CU_TENSOR_MAP_INTERLEAVE_NONE,
              kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                               : CU_TENSOR_MAP_SWIZZLE_64B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
  }

  // Load rows row0 .. row0 + rows - 1 of matrix `mat` into the tile at
  // `dst` (rows x D, one box per column block); counted on `bar`.
  __device__ static void load(uint32_t dst, const CUtensorMap* map,
                              uint32_t bar, int row0, int mat, int rows) {
#pragma unroll
    for (int b = 0; b < kBlocks; ++b)
      tma_load_3d(dst + b * rows * kRowBytes, map, bar, b * kCols, row0,
                  mat);
  }

  // K-major operand (the product contracts over D): rows r0 .. r0 + 63 (A)
  // or the tile's rows (B, r0 = 0) of a tile of `rows` rows at `base`, k
  // step kk (columns 16 kk .. 16 kk + 15): +32 bytes within a block's row,
  // the next block after kCols columns. SBO = one 8-row atom; LBO unused.
  // The step's offset is added to the descriptor of the rows' start, so
  // with constant `rows` and kk only that one descriptor is computed.
  __device__ static uint64_t kmajor(uint32_t base, int rows, int r0, int kk) {
    const int col = 16 * kk;
    return desc_add(make_desc(base + r0 * kRowBytes, 16, kAtomBytes, kLayout),
                    (col / kCols) * rows * kRowBytes + (col % kCols) * 2);
  }

  // MN-major operand (the product contracts over the tile's rows; N = the
  // kCols columns of block `blk`): rows k0 .. k0 + 15 of a tile of `rows`
  // rows at `base`. One swizzle atom spans the block's N, so both offsets
  // are the stride between 8-row groups of K.
  __device__ static uint64_t mnmajor(uint32_t base, int rows, int k0,
                                     int blk) {
    return desc_add(make_desc(base, kAtomBytes, kAtomBytes, kLayout),
                    blk * rows * kRowBytes + k0 * kRowBytes);
  }
};

// ---------------------------------------------------------------------------
// register reallocation
// ---------------------------------------------------------------------------

// A block of 384 threads (two consumer warpgroups, then a producer
// warpgroup of which one warp loads) starts with the 168 registers a
// thread its launch bound allows. setmaxnreg moves them: the producer
// warpgroup drops to 40 a thread, which lifts the consumers to 232
// (40 + 2 x 232 = 3 x 168). Each warpgroup runs its own one before it
// branches no more.
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
__device__ __forceinline__ void producer_regs() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
}
__device__ __forceinline__ void consumer_regs() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
}

// A barrier of the two consumer warpgroups alone (named barrier 1; the
// producer warp never waits on it). Orders their shared-memory writes
// before it against their reads after it.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// 2^x on the special-function unit (ex2.approx, flushing results below
// 2^-126 to zero; 2^-inf = 0), about 2^-22 relative error: far inside the
// bf16 rounding of p and ds that follows. exp2f's full-range path costs
// several more instructions an element.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N of the warpgroup's committed wgmma groups are still
// pending (the most recent N): wgmma_wait<1> lets the last group run on.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  static_assert(N > 0, "wgmma_wait_all waits for every group");
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties each register of a wgmma operand to this point in the program, so
// the compiler moves no write of it past a following wgmma_fence and no
// read of it above a preceding wgmma_wait_all (to the compiler a wgmma asm
// statement is finished as soon as it is issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Accumulator fragment of m64nN: thread t of the warpgroup holds N/2 floats;
// register r sits at row 16 (t / 32) + (t % 32) / 4 + 8 ((r / 2) % 2) and
// column 8 (r / 4) + 2 (t % 4) + r % 2. So a row is owned by the 4 lanes
// t % 4 = 0..3 of one quad (reductions: shfl.xor 1 and 2), the registers
// 8 kk .. 8 kk + 7 (columns 16 kk .. 16 kk + 15) are, pairwise packed,
// exactly the A-from-registers fragment of a k16 step, and the fragment of
// m64n128 is those of two m64n64 side by side (registers 0-31, 32-63).
__device__ __forceinline__ int frag_row(int r) {
  return 16 * ((threadIdx.x & 127) >> 5) + ((threadIdx.x & 31) >> 2) +
         8 * ((r >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int r) {
  return 8 * (r >> 2) + 2 * (threadIdx.x & 3) + (r & 1);
}

// Two floats rounded to nearest bf16 and packed (lo in the low half), the
// A-operand element pair of a wgmma.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Columns 16 kk .. 16 kk + 15 of an accumulator fragment as the A operand.
template <int kRegs>
__device__ __forceinline__ void to_a_frag(const float (&acc)[kRegs], int kk,
                                          uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// D (64 x N, f32, N = 2 R = 32, 64 or 128) (+)= A (64 x 16, smem)
// B (N x 16, smem)^T, both K-major.
template <int R>
__device__ __forceinline__ void wgmma_ss(float (&d)[R], uint64_t da,
                                         uint64_t db, int accumulate) {
  static_assert(R == 16 || R == 32 || R == 64, "m64n32, m64n64 or m64n128");
  if constexpr (R == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  if constexpr (R == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
          "%28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  if constexpr (R == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
          "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
          "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
          "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
}

// D[kOff .. kOff + kN/2) (64 x kN, f32, kN = 32 or 64) += A (64 x 16 bf16,
// registers) B (16 x kN, smem); B is MN-major (N contiguous) when
// kTransB = 1, K-major when 0.
template <int kN, int kOff, int kTransB, int R>
__device__ __forceinline__ void wgmma_rs(float (&d)[R],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  static_assert((kN == 32 || kN == 64) && kOff + kN / 2 <= R, "m64n32/n64");
  if constexpr (kN == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(kTransB));
  }
  if constexpr (kN == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
          "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
          "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
          "%28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[kOff + 0]), "+f"(d[kOff + 1]), "+f"(d[kOff + 2]),
          "+f"(d[kOff + 3]), "+f"(d[kOff + 4]), "+f"(d[kOff + 5]),
          "+f"(d[kOff + 6]), "+f"(d[kOff + 7]), "+f"(d[kOff + 8]),
          "+f"(d[kOff + 9]), "+f"(d[kOff + 10]), "+f"(d[kOff + 11]),
          "+f"(d[kOff + 12]), "+f"(d[kOff + 13]), "+f"(d[kOff + 14]),
          "+f"(d[kOff + 15]), "+f"(d[kOff + 16]), "+f"(d[kOff + 17]),
          "+f"(d[kOff + 18]), "+f"(d[kOff + 19]), "+f"(d[kOff + 20]),
          "+f"(d[kOff + 21]), "+f"(d[kOff + 22]), "+f"(d[kOff + 23]),
          "+f"(d[kOff + 24]), "+f"(d[kOff + 25]), "+f"(d[kOff + 26]),
          "+f"(d[kOff + 27]), "+f"(d[kOff + 28]), "+f"(d[kOff + 29]),
          "+f"(d[kOff + 30]), "+f"(d[kOff + 31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1),
          "n"(kTransB));
  }
}

// O (64 x D, f32 fragment of D/2 registers) += A (64 x 16, registers)
// B (16 x D), B rows k0 .. k0 + 15 of the (rows, D) tile at `base`: one
// m64n{kCols} wgmma per column block (its own part of the fragment).
template <int D, int kTransB>
__device__ __forceinline__ void wgmma_rs_tile(float (&o)[D / 2],
                                              const uint32_t (&a)[4],
                                              uint32_t base, int rows,
                                              int k0) {
  using T = Tile<D>;
  constexpr int kPart = T::kCols / 2;   // fragment registers of one block
  wgmma_rs<T::kCols, 0, kTransB>(o, a, T::mnmajor(base, rows, k0, 0));
  if constexpr (T::kBlocks > 1)
    wgmma_rs<T::kCols, kPart, kTransB>(o, a, T::mnmajor(base, rows, k0, 1));
  if constexpr (T::kBlocks > 2) {
    wgmma_rs<T::kCols, 2 * kPart, kTransB>(o, a,
                                           T::mnmajor(base, rows, k0, 2));
    wgmma_rs<T::kCols, 3 * kPart, kTransB>(o, a,
                                           T::mnmajor(base, rows, k0, 3));
  }
}

// S (64 x N) = A B^T over the D columns of two tiles, both K-major: rows
// a_r0 .. a_r0 + 63 of the (a_rows, D) tile at `a` and rows b_r0 .. b_r0 +
// N - 1 of the (b_rows, D) tile at `b`; D / 16 k steps.
template <int D, int R>
__device__ __forceinline__ void wgmma_ss_tile(float (&s)[R], uint32_t a,
                                              int a_rows, int a_r0,
                                              uint32_t b, int b_rows,
                                              int b_r0) {
  using T = Tile<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, T::kmajor(a, a_rows, a_r0, kk),
             T::kmajor(b, b_rows, b_r0, kk), kk > 0);
}

// The same with B the whole (N, D) tile at `b`.
template <int D, int R>
__device__ __forceinline__ void wgmma_ss_tile(float (&s)[R], uint32_t a,
                                              int a_rows, int a_r0,
                                              uint32_t b) {
  wgmma_ss_tile<D>(s, a, a_rows, a_r0, b, 2 * R, 0);
}

// Two values stored side by side, rounded to nearest when TO is bf16.
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

// Fragment row h (0 or 1) of a 64 x D accumulator, times `mul`, to `out`
// (that row's D elements): registers 4 j + 2 h and + 1 hold columns
// 8 j + 2 (t % 4) and + 1.
template <int D, typename TO>
__device__ __forceinline__ void store_row(TO* out, const float (&acc)[D / 2],
                                          int h, float mul) {
  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int r = 4 * j + 2 * h;
    store2<TO>(out + 8 * j + 2 * cq, acc[r] * mul, acc[r + 1] * mul);
  }
}

// ---------------------------------------------------------------------------
// head dims past 256: chunks and slices of wide rows (see the top)
// ---------------------------------------------------------------------------

constexpr int kChunkCols = 64;     // contraction columns a chunk: one box
constexpr int kChunkRowBytes = 128;

// A 3-D (mats, L, Dp) map of a bf16 tensor with rows of Dp columns (a
// multiple of 64) and boxes of box_rows x 64 columns in the 128-byte
// swizzle. Returns false on failure (the pointer must be 16-byte aligned).
static inline bool make_wide_map(CUtensorMap* map, const void* base, int Dp,
                                 int mats, int L, int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)Dp, (cuuint64_t)L,
                              (cuuint64_t)mats};
  const cuuint64_t strides[2] = {(cuuint64_t)Dp * 2,
                                 (cuuint64_t)L * Dp * 2};
  const cuuint32_t box[3] = {(cuuint32_t)kChunkCols, (cuuint32_t)box_rows,
                             1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Columns col0 .. col0 + 64 nblk - 1 of rows row0 .. row0 + rows - 1 of
// matrix `mat` of a wide map into `dst`, laid out as the first nblk column
// blocks of a (rows, 64 nblk) tile (one box a block); counted on `bar`.
__device__ __forceinline__ void load_blocks(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int col0, int nblk,
                                            int row0, int mat, int rows) {
  for (int b = 0; b < nblk; ++b)
    tma_load_3d(dst + b * rows * kChunkRowBytes, map, bar,
                col0 + kChunkCols * b, row0, mat);
}

// S (64 x N, N = 2 R) (+)= A B^T over one 64-column chunk, both K-major:
// rows a_r0 .. a_r0 + 63 of the (a_rows, 64) chunk at `a` and rows b_r0 ..
// b_r0 + N - 1 of the (b_rows, 64) chunk at `b`; 4 k steps, the first
// adding to S only when `acc` (0 for a contraction's first chunk).
template <int R>
__device__ __forceinline__ void wgmma_ss_chunk(float (&s)[R], uint32_t a,
                                               int a_rows, int a_r0,
                                               uint32_t b, int b_rows,
                                               int b_r0, int acc) {
  using T = Tile<kChunkCols>;
#pragma unroll
  for (int kk = 0; kk < kChunkCols / 16; ++kk)
    wgmma_ss(s, T::kmajor(a, a_rows, a_r0, kk),
             T::kmajor(b, b_rows, b_r0, kk), acc || kk > 0);
}

// Fragment row h of a 64 x W accumulator, times `mul`, to `out`: that
// row's first ncols (a multiple of 8, at most W) elements.
template <int W, typename TO>
__device__ __forceinline__ void store_row_n(TO* out, const float (&acc)[W / 2],
                                            int h, float mul, int ncols) {
  const int cq = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < W / 8; ++j) {
    const int r = 4 * j + 2 * h;
    if (8 * j < ncols)
      store2<TO>(out + 8 * j + 2 * cq, acc[r] * mul, acc[r + 1] * mul);
  }
}

// O (64 x 64 NB, f32 fragment of 32 NB registers) += A (64 x 16, registers)
// B (16 x 64 NB): rows k0 .. k0 + 15 of the first NB column blocks of a
// (rows, 64 NB) slice at `base` (load_blocks' layout), one m64n64 a block.
template <int NB, int kTransB>
__device__ __forceinline__ void wgmma_rs_blocks(float (&o)[32 * NB],
                                                const uint32_t (&a)[4],
                                                uint32_t base, int rows,
                                                int k0) {
  static_assert(NB >= 1 && NB <= 4, "one to four column blocks");
  using T = Tile<kChunkCols>;
  wgmma_rs<64, 0, kTransB>(o, a, T::mnmajor(base, rows, k0, 0));
  if constexpr (NB > 1)
    wgmma_rs<64, 32, kTransB>(o, a, T::mnmajor(base, rows, k0, 1));
  if constexpr (NB > 2)
    wgmma_rs<64, 64, kTransB>(o, a, T::mnmajor(base, rows, k0, 2));
  if constexpr (NB > 3)
    wgmma_rs<64, 96, kTransB>(o, a, T::mnmajor(base, rows, k0, 3));
}

// ---------------------------------------------------------------------------
// thread block clusters: K2's wide kernel up to D 512 splits D across the
// blocks of a cluster and sums their partial scores through distributed
// shared memory (cluster_sum)
// ---------------------------------------------------------------------------

// Every cluster has at most this many blocks (the portable limit).
constexpr int kClusterMax = 8;

// Every thread of every block of the cluster arrives, then waits for all:
// what a block wrote to its shared memory before is seen by the others
// after (release, acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in block `rank` of the cluster of this block's shared-memory
// address `addr`.
__device__ __forceinline__ uint32_t cluster_map(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// One arrival on an mbarrier of any block of the cluster (an address from
// cluster_map), releasing this thread's earlier memory accesses to the
// cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// mbar_wait that acquires what the arrivals of other blocks released.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t addr, float a, float b,
                                           float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(a), "f"(b), "f"(c), "f"(d)
               : "memory");
}

__device__ __forceinline__ float4 ld_cluster4(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The cluster's sum of two float32 fragments of R registers (a block's
// partial S and dP over its columns of D), for the i-th tile of the loop;
// on return a and b hold the sums, the same bits in every block. Each
// consumer thread keeps its own 2 R floats at `slot` (R / 2 float4s,
// `stride` bytes apart: the thread's index x 16 past the block's exchange
// area, stride = 16 x the consumer threads, so a warp's stores and loads
// are coalesced). Per warpgroup two mbarriers of 4 n arrivals (one a warp
// of each of the n blocks): `full` counts the partials written, `empty`
// the partials read. A warp waits until every block has read its last
// partials (empty, tile i - 1), writes its own, arrives on `full` in
// every block, waits for its own `full`, then reads the n partials from
// block 0 up and adds them in that order, and arrives on `empty` in every
// block. Before a block exits, its consumers wait on `empty` for the last
// tile (cluster_sum_done), so no block reads the shared memory of one that
// has exited.
template <int R>
__device__ __forceinline__ void cluster_sum(float (&a)[R], float (&b)[R],
                                            uint32_t slot, uint32_t stride,
                                            uint32_t full, uint32_t empty,
                                            int n, int i) {
  static_assert(R % 4 == 0, "whole float4s");
  constexpr int kV = R / 4;
  const bool lead = (threadIdx.x & 31) == 0;
  if (i > 0) mbar_wait_cluster(empty, (i - 1) & 1);
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    st_shared4(slot + j * stride, a[4 * j], a[4 * j + 1], a[4 * j + 2],
               a[4 * j + 3]);
    st_shared4(slot + (kV + j) * stride, b[4 * j], b[4 * j + 1],
               b[4 * j + 2], b[4 * j + 3]);
  }
  __syncwarp();
  if (lead)
    for (int r = 0; r < n; ++r) mbar_arrive_cluster(cluster_map(full, r));
  mbar_wait_cluster(full, i & 1);
  // float4 j of every block in flight at once, then added from block 0 up
#pragma unroll
  for (int j = 0; j < 2 * kV; ++j) {
    float4 x[kClusterMax];
#pragma unroll
    for (int r = 0; r < kClusterMax; ++r)
      if (r < n) x[r] = ld_cluster4(cluster_map(slot + j * stride, r));
    float4 v = x[0];
#pragma unroll
    for (int r = 1; r < kClusterMax; ++r)
      if (r < n) {
        v.x += x[r].x; v.y += x[r].y; v.z += x[r].z; v.w += x[r].w;
      }
    float* out = j < kV ? a + 4 * j : b + 4 * (j - kV);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  }
  __syncwarp();
  if (lead)
    for (int r = 0; r < n; ++r) mbar_arrive_cluster(cluster_map(empty, r));
}

// After a block's last cluster_sum (of `tiles` in all): wait until every
// block has read this one's partials.
__device__ __forceinline__ void cluster_sum_done(uint32_t empty, int tiles) {
  if (tiles > 0) mbar_wait_cluster(empty, (tiles - 1) & 1);
}

}  // namespace sm90

// Launchers of the bf16 kernels (flash_fwd_sm90.cu, flash_bwd_dq_sm90.cu,
// flash_bwd_sm90.cu) at head dim D (32, 64, 128 or 256; or any multiple of
// 64 past 256, on the wide kernels), called by the C entry points for dtype
// 1. Return a cudaError_t.
int launch_fwd_sm90(const void* q, const void* k, const void* v,
                    const int* segq, const int* segk, void* o, float* lse,
                    int BH, int H, int Hkv, int Lq, int Lk, int D, int causal,
                    int window, float scale, cudaStream_t stream);
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   const int* segq, const int* segk, void* dq, int BH, int H,
                   int Hkv, int Lq, int Lk, int D, int causal, int window,
                   float scale, cudaStream_t stream);
int launch_dkdv_sm90(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const int* segq, const int* segk, void* dk, void* dv,
                     int out_f32, int BH, int H, int Hkv, int Lq, int Lk,
                     int D, int causal, int window, float scale,
                     cudaStream_t stream);

}  // namespace flash
