// int8 serving GEMM and its row quantize for Hopper (sm_90a).
//
// int8_matmul replaces the Pallas TPU kernel one_peace_tpu/ops/quant_pallas.py
// `int8_matmul` / `_kernel`:
//
//   y[m, n] = (float(sum_k x_q[m, k] * w_q[n, k]) * sx[m]) * sw[n]  (+ b[n])
//
// with the int32 sum exact, the epilogue in fp32 in that order (each step
// rounded, no fused multiply-add), and one rounding to the output dtype (bf16,
// fp16 or fp32).  That is the JAX package's arithmetic: `quantized_linear`
// (ops/quant.py) takes the kernel's fp32 output, adds the bias in fp32 and
// casts once to x's dtype.  x_q is (M, K) int8 row-major, w_q is (N, K) int8
// row-major (K contiguous: the transpose of the JAX package's (K, N)), sx is
// (M,) fp32, sw and b are (N,) fp32.
//
// int8_quantize_rows is the XLA fusion in front of it (ops/quant.py:46-49),
// which has no Pallas kernel: per row of x (M, K), bf16, fp16 or fp32,
//
//   sx[m]     = max(max_k |float(x[m, k])| / 127, 1e-8)
//   x_q[m, k] = clamp(rint(float(x[m, k]) / sx[m]), -127, 127)
//
// with IEEE division and round-half-to-even, so the int8 values are the bits
// that the plain version and the JAX package give.  This file is built
// without --use_fast_math and states the rounding of every step.
//
// What bounds them on an H100 (4B geometry, images at B=256: M = 65,792 rows
// of L=257 tokens; per FFN projection K/N = 1536/6144 or 6144/1536):
//   int8_matmul: 2*M*K*N = 1.24 TOP per projection, 0.63 ms at the 1,979
//     TOPS dense int8 peak; the bytes are x_q (101 MB or 404 MB), w_q (9.4 MB,
//     resident in the 50 MB L2) and y (808 MB in bf16 at N=6144, 202 MB at
//     N=1536), 0.3 ms at 3.35 TB/s.  So the product is bound by the tensor
//     cores, and the bf16 store of y is the largest memory term: an epilogue
//     that runs while the tensor cores wait adds to the time.
//   int8_quantize_rows: reads x once to reduce and once to quantize (the
//     second read mostly from L1/L2) and writes x_q and sx: 303 MB for a
//     (65,792 x 1536) bf16 activation, about 0.1 ms at 3.35 TB/s; nothing
//     to compute.  Bound by memory bandwidth.
//
// What this design does about it:
//   int8_matmul: 128 x 256 output tiles.  A block of three warpgroups: the
//     producer (warpgroup 0, 40 registers a thread after setmaxnreg) whose
//     one thread issues every TMA copy, and two consumers (232 registers),
//     each owning 64 x 256 int32 sums in registers for the whole K loop.
//     TMA brings 128-byte K slabs of x_q (a 128-row box) and w_q (a 256-row
//     box) into a 4-stage ring (48 KB a stage) in the 128-byte swizzle, each
//     stage behind a full mbarrier (armed with the stage's bytes: TMA counts
//     the whole box, zero-filled rows and columns beyond M, N and K too) and
//     an empty one (every consumer thread arrives once the products that
//     read the stage have retired).  The products are wgmma
//     m64n256k32.s32.s8.s8 with both operands read from shared memory through
//     the descriptors of csrc/wgmma_tiles.cuh (`sw128_desc`: a k32 step of
//     int8 advances 32 bytes, as a k16 step of bf16 does); one wgmma group a
//     stage, the previous group retired before its stage is released.
//     Persistent: at most one block per SM, walking tiles t = blockIdx.x +
//     i * gridDim.x in raster groups of `group` M-tiles, M fastest inside a
//     group, so the blocks in flight share a few x_q slabs and w_q stays in
//     L2; the producer runs ahead into the next tile's stages while the
//     consumers write the current one.  The epilogue: where out's rows are
//     a multiple of 16 bytes, each consumer scales its sums ((acc * sx) *
//     sw (+ b), sx read once per row, sw and b as 8-byte pairs once per
//     column pair) into 64-row x 128-byte boxes of shared memory in the
//     128-byte swizzle (conflict-free from the accumulator layout), and one
//     thread hands each box to a TMA store, so the consumers go back to the
//     products while the stores drain; two boxes alternate.  Elsewhere
//     (ragged N) the int32 sums go through shared memory 32 columns at a
//     time (rows of 40 int32: conflict-free int2 writes in the accumulator
//     layout and int4 reads along rows) and each thread stores 4 outputs
//     along a row, masked at ragged M and N.  The plan (tile, stages,
//     shared memory, grid, raster group) comes from
//     ops/int8_matmul.py:gemm_plan and is refused here if it is not this
//     kernel's.  K must be a multiple of 16 (the TMA row stride; the
//     wrapper pads when it is not).
//   int8_quantize_rows: one warp per row, 8 rows per block, 16-byte loads
//     where the row allows it; the row's absmax is a warp shuffle reduction,
//     then the warp reads the row again and stores 4 or 8 int8 per lane.
// Measured against (PERF.md, PR 10): one block per tile; each consumer
// owning a whole 64 x 256 tile, the two taking turns (ping-pong); a 2-block
// cluster sharing the w_q box by multicast.  Not done yet: the quantize
// fused into the producer of x.

#include <cuda.h>  // CUtensorMap and its enums; the driver entry point is fetched at run time
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kBM = 128;                       // output rows per tile: two consumers of 64
constexpr int kBN = 256;                       // output columns per tile: wgmma n256
constexpr int kBK = 128;                       // bytes (int8 values) of K per stage
constexpr int kStages = 4;                     // TMA ring depth
constexpr int kABytes = kBM * kBK;             // x_q box: 16 KB
constexpr int kStageBytes = kABytes + kBN * kBK;  // + w_q box: 48 KB
constexpr int kOutBytes = 16384;               // a consumer's staging of its outputs
constexpr int kBoxBytes = 64 * 128;            // one TMA store box: 64 rows x 128 bytes
constexpr int kEpiCols = 32;                   // thread stores: columns staged at a time
constexpr int kEpiStride = kEpiCols + 8;       // int32 per staged row, conflict-free
static_assert(64 * kEpiStride * 4 <= kOutBytes, "thread-store staging beyond its buffer");
constexpr int kThreads = 384;                  // producer + two consumer warpgroups
constexpr int kAlign = 1024;                   // the 128-byte swizzle's 8-row period
constexpr int kSmem = kStages * kStageBytes + 2 * kOutBytes + 2 * kStages * 8 + kAlign;
static_assert(kSmem <= 232448, "shared memory beyond the opt-in limit");

// Errors of this file's own, beside cudaError_t's (which are positive).
constexpr int kErrPlan = -1;    // a plan this kernel does not take
constexpr int kErrDriver = -2;  // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = -3;  // cuTensorMapEncodeTiled refused the operand

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  return done != 0;
}
// Returns once the barrier's phase of the given parity has completed.  A
// wait of more than ~2^34 cycles (seconds) traps: a fault, never a hang.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 34)) __trap();
}

// A 2-D box of the tensor map at (c0 bytes of K, c1 rows) into shared
// memory; its bytes count towards bar's transaction.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

// A 2-D box of shared memory to the tensor map at (c0 columns, c1 rows);
// the parts beyond the tensor's edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// All but the last N committed store groups have read their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
// Every committed store group is done.
__device__ __forceinline__ void bulk_wait_done() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of d across a wgmma's start or wait.
__device__ __forceinline__ void fence_acc_s32(int d[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d (+)= A . B^T: wgmma m64n256k32 s8 x s8 -> s32, A (64 rows) and B (256
// rows) K-major from shared memory.  The integer form takes no scale or
// transpose immediates.  d[4j + c] is row 16w + g + 8 (c >> 1), column
// 8j + 2t + (c & 1) (warp w of the warpgroup, g = lane / 4, t = lane % 4).
#define S8_ACC8(i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),           \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
__device__ __forceinline__ void wgmma_s8_64x256x32(int d[128], uint64_t desc_a, uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, %128, %129, p;\n}\n"
      : S8_ACC8(0), S8_ACC8(8), S8_ACC8(16), S8_ACC8(24), S8_ACC8(32), S8_ACC8(40),
        S8_ACC8(48), S8_ACC8(56), S8_ACC8(64), S8_ACC8(72), S8_ACC8(80), S8_ACC8(88),
        S8_ACC8(96), S8_ACC8(104), S8_ACC8(112), S8_ACC8(120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}
#undef S8_ACC8

__device__ __forceinline__ void bar_sync_wg(int id) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(id) : "memory");
}

// The origin of tile t of the walk: raster groups of `group` M-tiles (the
// last group may hold fewer), M fastest inside a group.  Mirrored by
// ops/int8_matmul.py:tile_coords.
struct Origin {
  int m0, n0;
};
__device__ __forceinline__ Origin tile_origin(int t, int tiles_m, int tiles_n, int group) {
  const int per_group = group * tiles_n;
  const int first = (t / per_group) * group;
  const int rows = min(group, tiles_m - first);
  const int r = t % per_group;
  return {(first + r % rows) * kBM, (r / rows) * kBN};
}

// (acc * sx) * sw (+ b), each product and the sum rounded on its own.
__device__ __forceinline__ float epilogue(int acc, float sx, float sw, float b, bool has_bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return has_bias ? __fadd_rn(y, b) : y;
}

// Four fp32 values of v from column n on (zeros past N).
__device__ __forceinline__ void load4(float f[4], const float* __restrict__ v, int n, int N,
                                      bool vec) {
  if (vec && n + 3 < N) {
    const float4 x = *reinterpret_cast<const float4*>(v + n);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) f[i] = n + i < N ? v[n + i] : 0.f;
  }
}

// Four outputs from p on, `left` of them inside the row; vec: p is aligned
// for one 8-byte (bf16, fp16) or 16-byte (fp32) store.
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float y[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) p[i] = __float2bfloat16_rn(y[i]);
  }
}
__device__ __forceinline__ void store4(__half* p, const float y[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_f16(y[0], y[1]), pack_f16(y[2], y[3]));
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) p[i] = __float2half_rn(y[i]);
  }
}
__device__ __forceinline__ void store4(float* p, const float y[4], int left, bool vec) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (i < left) p[i] = y[i];
  }
}

// One consumer warpgroup's part of a tile, rows [m0, m0 + 64): its sums
// through the staging rows `stage` 32 columns at a time, then out.  tid is
// the thread's index in the warpgroup, bar its named barrier.
template <typename T>
__device__ __forceinline__ void write_tile(const int acc[128], int* __restrict__ stage, int tid,
                                           int bar, int m0, int n0, const float* __restrict__ sx,
                                           const float* __restrict__ sw,
                                           const float* __restrict__ bias, T* __restrict__ out,
                                           int M, int N, bool vec) {
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  const int col = (tid & 7) * 4;  // the read side: 4 columns of rows 16p + tid / 8
  float s_x[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + 16 * p + (tid >> 3);
    s_x[p] = m < M ? sx[m] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < kBN / kEpiCols; ++q) {
    bar_sync_wg(bar);  // the previous chunk's rows have been read
#pragma unroll
    for (int jj = 0; jj < kEpiCols / 8; ++jj) {
      const int j = q * (kEpiCols / 8) + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        *reinterpret_cast<int2*>(stage + r * kEpiStride + jj * 8 + 2 * t) =
            make_int2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    bar_sync_wg(bar);
    const int n = n0 + q * kEpiCols + col;
    if (n < N) {
      float w4[4], b4[4] = {0.f, 0.f, 0.f, 0.f};
      load4(w4, sw, n, N, vec);
      if (bias) load4(b4, bias, n, N, vec);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int r = 16 * p + (tid >> 3), m = m0 + r;
        if (m < M) {
          const int4 v = *reinterpret_cast<const int4*>(stage + r * kEpiStride + col);
          const float y[4] = {epilogue(v.x, s_x[p], w4[0], b4[0], bias != nullptr),
                              epilogue(v.y, s_x[p], w4[1], b4[1], bias != nullptr),
                              epilogue(v.z, s_x[p], w4[2], b4[2], bias != nullptr),
                              epilogue(v.w, s_x[p], w4[3], b4[3], bias != nullptr)};
          store4(out + static_cast<size_t>(m) * N + n, y, N - n, vec);
        }
      }
    }
  }
}

// One consumer warpgroup's part of a tile, rows [m0, m0 + 64), by TMA
// stores (out's rows a multiple of 16 bytes): per pass one box of 64 rows x
// 128 bytes of columns, scaled from the accumulator layout into its
// 128-byte-swizzled place (conflict-free), then one thread stores it and
// the warpgroup goes on.  The two boxes of `boxes` alternate; a box is
// written again once the store of two passes ago has read it.  tid is the
// thread's index in the warpgroup, bar its named barrier.
template <typename T>
__device__ __forceinline__ void write_tile_tma(const int acc[128], uint8_t* boxes, int tid,
                                               int bar, int m0, int n0,
                                               const float* __restrict__ sx,
                                               const float* __restrict__ sw,
                                               const float* __restrict__ bias,
                                               const CUtensorMap* map_out, int M, int N) {
  constexpr int kBoxCols = 128 / sizeof(T);  // 64 bf16 or fp16, or 32 fp32
  static_assert((kBN / kBoxCols) % 2 == 0, "the boxes alternate across tiles too");
  const int warp = tid >> 5, g = (tid & 31) >> 2, t = tid & 3;
  float s_x[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 16 * warp + g + 8 * h;
    s_x[h] = m < M ? sx[m] : 0.f;
  }
#pragma unroll
  for (int pass = 0; pass < kBN / kBoxCols; ++pass) {
    uint8_t* box = boxes + (pass & 1) * kBoxBytes;
    if (tid == 0) bulk_wait_read<1>();
    bar_sync_wg(bar);  // this box is free
#pragma unroll
    for (int jj = 0; jj < kBoxCols / 8; ++jj) {
      const int j = pass * (kBoxCols / 8) + jj;
      // columns n, n + 1: both inside N or both beyond it (N is even here)
      const int n = n0 + 8 * j + 2 * t;
      float2 w = make_float2(0.f, 0.f), b = make_float2(0.f, 0.f);
      if (n < N) {
        w = *reinterpret_cast<const float2*>(sw + n);
        if (bias) b = *reinterpret_cast<const float2*>(bias + n);
      }
      const float w0 = w.x, w1 = w.y, b0 = b.x, b1 = b.y;
      // byte of column 8 jj + 2t in the box's 128-byte row; its 16-byte chunk
      const int byte = (8 * jj + 2 * t) * static_cast<int>(sizeof(T));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = 16 * warp + g + 8 * h;
        const float y0 = epilogue(acc[4 * j + 2 * h], s_x[h], w0, b0, bias != nullptr);
        const float y1 = epilogue(acc[4 * j + 2 * h + 1], s_x[h], w1, b1, bias != nullptr);
        uint8_t* at = box + r * 128 + (((byte >> 4) ^ (r & 7)) << 4) + (byte & 15);
        if constexpr (sizeof(T) == 2) {
          *reinterpret_cast<uint32_t*>(at) = pack2<T>(y0, y1);
        } else {
          *reinterpret_cast<float2*>(at) = make_float2(y0, y1);
        }
      }
    }
    fence_async_shared();  // the box's writes become visible to the TMA unit
    bar_sync_wg(bar);
    if (tid == 0) {
      const int c0 = n0 + pass * kBoxCols;
      if (m0 < M && c0 < N) tma_store_2d(map_out, box, c0, m0);
      bulk_commit();
    }
  }
}

// One wgmma group: the stage's four k32 steps into acc (accumulate == 0:
// the first step of a tile overwrites it).
__device__ __forceinline__ void mma_stage(int acc[128], const uint8_t* a, const uint8_t* b,
                                          bool first) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  fence_acc_s32(acc);
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 32; ++ks)  // 32 bytes of K: 2 in the descriptor's 16-byte units
    wgmma_s8_64x256x32(acc, da + 2 * ks, db + 2 * ks, first && ks == 0 ? 0 : 1);
  wgmma_commit();
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const __grid_constant__ CUtensorMap map_out, const float* __restrict__ sx,
                   const float* __restrict__ sw, const float* __restrict__ bias,
                   T* __restrict__ out, int M, int N, int K, int group, int vec, int tma_out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));
  uint8_t* staging = smem + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kOutBytes);
  uint64_t* empty = full + kStages;
  const int tiles_m = (M + kBM - 1) / kBM, tiles_n = (N + kBN - 1) / kBN;
  const int tiles = tiles_m * tiles_n, kblocks = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // producer: one thread keeps the ring full, tile after tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const Origin o = tile_origin(t, tiles_m, tiles_n, group);
        for (int kb = 0; kb < kblocks; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass finds every stage free
          mbar_expect_tx(&full[stage], kStageBytes);
          uint8_t* a = smem + stage * kStageBytes;
          tma_load_2d(a, &map_x, &full[stage], kb * kBK, o.m0);
          tma_load_2d(a + kABytes, &map_w, &full[stage], kb * kBK, o.n0);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers: warpgroup c = 0, 1 owns rows [64c, 64c + 64) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = threadIdx.x / 128 - 1, tid = threadIdx.x & 127;
    uint8_t* mine = staging + c * kOutBytes;
    int stage = 0;
    uint32_t phase = 0;
    int acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0;  // each tile's first product overwrites it
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Origin o = tile_origin(t, tiles_m, tiles_n, group);
      mbar_wait(&full[stage], phase);
      mma_stage(acc, smem + stage * kStageBytes + c * 64 * kBK,
                smem + stage * kStageBytes + kABytes, true);
      int done = stage;  // the stage of the group still in flight
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
      for (int kb = 1; kb < kblocks; ++kb) {
        mbar_wait(&full[stage], phase);
        mma_stage(acc, smem + stage * kStageBytes + c * 64 * kBK,
                  smem + stage * kStageBytes + kABytes, false);
        wgmma_wait<1>();  // the previous stage's group has retired
        fence_acc_s32(acc);
        mbar_arrive(&empty[done]);
        done = stage;
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      fence_acc_s32(acc);
      mbar_arrive(&empty[done]);
      if (tma_out) {
        write_tile_tma<T>(acc, mine, tid, 1 + c, o.m0 + 64 * c, o.n0, sx, sw, bias, &map_out, M,
                          N);
      } else {
        write_tile<T>(acc, reinterpret_cast<int*>(mine), tid, 1 + c, o.m0 + 64 * c, o.n0, sx, sw,
                      bias, out, M, N, vec != 0);
      }
    }
    if (tid == 0) bulk_wait_done();  // the last stores are done before the block ends
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int8_t quantize(float v, float s) {
  const float q = rintf(__fdiv_rn(v, s));
  return static_cast<int8_t>(fminf(fmaxf(q, -127.f), 127.f));
}

__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) { return __bfloat1622float2(v); }
__device__ __forceinline__ float2 to_float2(__half2 v) { return __half22float2(v); }

// 16 bytes of x as floats: 8 bf16 or fp16, or 4 fp32 values.
template <typename T> struct Vec {
  static_assert(sizeof(T) == 2, "the 2-byte types: bf16 and fp16");
  using T2 = std::conditional_t<std::is_same_v<T, __half>, __half2, __nv_bfloat162>;
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(float f[8], const T* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const T2* h = reinterpret_cast<const T2*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = to_float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static void store(int8_t* q, const float f[8], float s) {
    uint2 u;
    int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 8; ++i) b[i] = quantize(f[i], s);
    *reinterpret_cast<uint2*>(q) = u;
  }
};
template <> struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void load(float f[4], const float* p) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ __forceinline__ static void store(int8_t* q, const float f[4], float s) {
    uint32_t u;
    int8_t* b = reinterpret_cast<int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) b[i] = quantize(f[i], s);
    *reinterpret_cast<uint32_t*>(q) = u;
  }
};

__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

// One warp per row; kVec: 16-byte loads (K a multiple of Vec<T>::kN and
// x, x_q 16-byte aligned), else one value per lane per step.
template <typename T, bool kVec>
__global__ void __launch_bounds__(256)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ xq,
                     float* __restrict__ sx, int M, int K) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const T* xr = x + static_cast<size_t>(row) * K;
  int8_t* qr = xq + static_cast<size_t>(row) * K;
  constexpr int E = Vec<T>::kN;
  float amax = 0.f;
  if (kVec) {
    for (int i = lane * E; i < K; i += 32 * E) {
      float f[E];
      Vec<T>::load(f, xr + i);
#pragma unroll
      for (int j = 0; j < E; ++j) amax = fmaxf(amax, fabsf(f[j]));
    }
  } else {
    for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(to_float(xr[i])));
  }
  amax = warp_max(amax);
  const float s = fmaxf(__fdiv_rn(amax, 127.f), 1e-8f);
  if (lane == 0) sx[row] = s;
  if (kVec) {
    for (int i = lane * E; i < K; i += 32 * E) {
      float f[E];
      Vec<T>::load(f, xr + i);
      Vec<T>::store(qr + i, f, s);
    }
  } else {
    for (int i = lane; i < K; i += 32) qr[i] = quantize(to_float(xr[i]), s);
  }
}

template <typename T>
cudaError_t launch_quantize(const void* x, void* xq, void* sx, int M, int K, bool vec,
                            cudaStream_t s) {
  const dim3 grid((M + 7) / 8);
  if (vec) {
    quantize_rows_kernel<T, true><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  } else {
    quantize_rows_kernel<T, false><<<grid, 256, 0, s>>>(
        static_cast<const T*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K);
  }
  return cudaGetLastError();
}


using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, K) int8 operand as boxes of box_rows rows x 128 bytes of K in
// the 128-byte swizzle; reads beyond the edges fill zeros.
int encode_operand(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrDriver;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

// The (M, N) output as boxes of 64 rows x 128 bytes in the 128-byte swizzle.
template <typename T>
int encode_output(CUtensorMap* map, void* base, int M, int N) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kErrDriver;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(N), static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(N) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / sizeof(T)), 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map,
                        std::is_same_v<T, __half>          ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                        : std::is_same_v<T, __nv_bfloat16> ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        2, base, dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int launch_matmul(const void* xq, const void* wq, const void* sx, const void* sw,
                  const void* bias, void* out, int M, int N, int K, int tile_m, int tile_n,
                  int stages, int smem_bytes, int grid, int group, cudaStream_t s) {
  const long tiles = static_cast<long>((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  if (tile_m != kBM || tile_n != kBN || stages != kStages || smem_bytes != kSmem ||
      grid < 1 || grid > tiles || group < 1 || K % 16 != 0 || K < 16)
    return kErrPlan;
  CUtensorMap map_x, map_w, map_out;
  int err = encode_operand(&map_x, xq, M, K, kBM);
  if (err == 0) err = encode_operand(&map_w, wq, N, K, kBN);
  // TMA stores where out's rows are a multiple of 16 bytes (and sw and b
  // take 8-byte loads at even columns), else thread stores
  const bool tma_out = (static_cast<long>(N) * sizeof(T)) % 16 == 0 && aligned16(out) &&
                       aligned16(sw) && (bias == nullptr || aligned16(bias));
  if (err == 0 && tma_out) err = encode_output<T>(&map_out, out, M, N);
  if (err != 0) return err;
  cudaError_t cerr = cudaFuncSetAttribute(int8_matmul_kernel<T>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const bool vec = N % 4 == 0 && aligned16(out) && aligned16(sw) &&
                   (bias == nullptr || aligned16(bias));
  int8_matmul_kernel<T><<<grid, kThreads, kSmem, s>>>(
      map_x, map_w, tma_out ? map_out : map_x, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias), static_cast<T*>(out), M, N,
      K, group, vec ? 1 : 0, tma_out ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) of the dtype `dtype` names (0 fp32, 1 bf16, 2 fp16) -> x_q (M, K)
// int8 and sx (M,) fp32.  vec: x and x_q 16-byte aligned and K a multiple of
// 8 (bf16, fp16) or 4 (fp32).
extern "C" int one_peace_int8_quantize_rows(const void* x, void* xq, void* sx, int M, int K,
                                            int dtype, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_quantize<float>(x, xq, sx, M, K, vec != 0, s); break;
    case 1: err = launch_quantize<__nv_bfloat16>(x, xq, sx, M, K, vec != 0, s); break;
    case 2: err = launch_quantize<__half>(x, xq, sx, M, K, vec != 0, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// x_q (M, K) int8 @ w_q (N, K)^T int8 -> out (M, N) of the dtype `out_dtype`
// names (0 fp32, 1 bf16, 2 fp16), scaled by sx (M,) and sw (N,), plus bias
// (N,) fp32 when not null.  K a multiple of 16; x_q and w_q 16-byte aligned.  The plan (tile_m x tile_n
// tiles, stages, shared memory bytes, grid, raster group) is
// ops/int8_matmul.py:gemm_plan's; another one is refused.
extern "C" int one_peace_int8_matmul(const void* xq, const void* wq, const void* sx,
                                     const void* sw, const void* bias, void* out, int M, int N,
                                     int K, int out_dtype, int tile_m, int tile_n, int stages,
                                     int smem_bytes, int grid, int group, int device,
                                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0:
      return launch_matmul<float>(xq, wq, sx, sw, bias, out, M, N, K, tile_m, tile_n, stages,
                                  smem_bytes, grid, group, s);
    case 1:
      return launch_matmul<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, tile_m, tile_n,
                                          stages, smem_bytes, grid, group, s);
    case 2:
      return launch_matmul<__half>(xq, wq, sx, sw, bias, out, M, N, K, tile_m, tile_n, stages,
                                   smem_bytes, grid, group, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* one_peace_int8_error_string(int err) {
  switch (err) {
    case kErrPlan:
      return "a GEMM plan this kernel does not take";
    case kErrDriver:
      return "cuTensorMapEncodeTiled not found in the driver";
    case kErrEncode:
      return "cuTensorMapEncodeTiled refused an operand";
    default:
      return cudaGetErrorString(static_cast<cudaError_t>(err));
  }
}
