// Pieces shared by the retrieval attention kernels (flash_attention_fwd.cu,
// flash_attention_bwd.cu) on top of wgmma_tiles.cuh: the tile plan of a
// sequence (ops/flash_attention.py:tile_plan), the bias staged into a shared
// region of fp32 rows, and the warpgroup's products on a ragged last tile,
// compiled for its width.
//
// Layout conventions.  A block is one warpgroup (4 warps, 128 threads) that
// owns 64 rows; warp w holds rows 16w + g and 16w + g + 8 (g = lane / 4) of a
// 64-column accumulator, columns 8j + 2t + (c & 1) (t = lane % 4), as
// wgmma_tiles.cuh writes them.  Q/K/V/G tiles are 64 rows x 64 head dims of
// the element type T (bf16 or fp16: the kernels are templated on it, the
// layouts are the same) in the 128-byte swizzle; rows past the sequence are
// zeros.

#pragma once

#include <type_traits>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                        // rows of a q tile, keys of a key tile
constexpr int kTileBytes = kTile * kHeadDim * 2;  // a swizzled bf16 or fp16 tile
constexpr int kAlign = 1024;                     // the 128-byte swizzle's atom
constexpr int kStageStride = kTile + 8;          // floats per staged bias row (two walks)
constexpr float kNegInf = -1e30f;                // as ops/flash_attention.py NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

// ops/flash_attention.py:tile_plan for one sequence length.
struct TilePlan {
  int n_tiles;   // ceil(L / 64)
  int tail;      // the last tile's width: its keys rounded up to 16
  int resident;  // one walk, the row block's scores (or p32) kept in the region
  int stride;    // floats per region row (0: two walks, which stage kStageStride)
  int smem;      // dynamic shared memory: four tiles, the region, the alignment slack
};

// The plan that ops/flash_attention.py:tile_plan gives for L, with the
// caller's branch: one walk with the row block's region (64 rows of the
// padded width + 8 floats), or two walks, the bias staged a tile ahead in
// two buffers of 64 rows of kStageStride floats.  The launchers refuse a
// launch whose plan differs.
inline bool plan_matches(const TilePlan& p, int L) {
  const int n = (L + kTile - 1) / kTile;
  const int tail = (L - kTile * (n - 1) + 15) / 16 * 16;
  const int width = kTile * (n - 1) + tail;
  const int stride = p.resident ? width + 8 : 0;
  const int region = p.resident ? kTile * stride * 4 : 2 * kTile * kStageStride * 4;
  return p.n_tiles == n && p.tail == tail && p.stride == stride &&
         p.smem == 4 * kTileBytes + region + kAlign;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The dynamic shared memory, its start aligned up to the swizzle's atom.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* p) {
  return p + ((kAlign - static_cast<uint32_t>(__cvta_generic_to_shared(p))) & (kAlign - 1));
}

// wgmma A fragments of rows [16w, 16w + 16) of a swizzled tile (warp w).
__device__ __forceinline__ void read_a_frags(uint32_t a[4][4], const unsigned char* tile) {
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const unsigned char* p0 = tile + r * 128 + 4 * t;
  const unsigned char* p1 = p0 + 8 * 128;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // head dims 16kk + 2t (+ 8); r & 7 == (r + 8) & 7
    const int c0 = ((2 * kk) ^ (r & 7)) << 4, c1 = ((2 * kk + 1) ^ (r & 7)) << 4;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p0 + c0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p1 + c0);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + c1);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + c1);
  }
}

// Calls f(std::integral_constant<int, kN8>{}) for a tile 8 * kN8 = width
// wide (16, 32, 48 or 64), so that a tile's products, their wait and its
// elementwise work are compiled for its width: with one body for every width
// ptxas had to merge the accumulators of the narrower products and inserted
// warpgroup waits (C7517) between them.
template <typename F>
__device__ __forceinline__ void with_width(int width, F&& f) {
  switch (width) {
    case 16: f(std::integral_constant<int, 2>{}); break;
    case 32: f(std::integral_constant<int, 4>{}); break;
    case 48: f(std::integral_constant<int, 6>{}); break;
    default: f(std::integral_constant<int, 8>{});
  }
}

// x rounded to T as A fragments of a 16 * kK16 deep product: the
// accumulator layout of two adjacent 8-column groups is the A layout of one
// 16-deep step.
template <int kK16, typename T>
__device__ __forceinline__ void pack_a(uint32_t xa[4][4], const float x[8][4]) {
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk) {
    xa[kk][0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    xa[kk][1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    xa[kk][2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[kk][3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero_a(uint32_t xa[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) xa[kk][0] = xa[kk][1] = xa[kk][2] = xa[kk][3] = 0u;
}

// Issue acc = A B^T over the 64 head dims: A the warpgroup's 64 rows in
// registers, B the first 8 * kN8 rows of a swizzled tile (keys, or queries in
// the dk/dv kernel); acc[kN8 ..] is left alone.  Committed, not waited for.
template <int kN8, typename T>
__device__ __forceinline__ void issue_nt(float acc[8][4], const uint32_t a[4][4],
                                         const unsigned char* b) {
  const uint64_t desc = sw128_desc(b);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_64xnx16<kN8, 0, T>(acc, a[kk], desc + 2 * kk, kk);
  wgmma_commit();
}

// Issue o += X B: X (64 rows x 16 * kK16, the sum index) as A fragments, B
// the first 16 * kK16 rows of a swizzled tile read transposed (MN-major).
// Committed, not waited for.
template <int kK16, typename T>
__device__ __forceinline__ void issue_nn(float o[8][4], const uint32_t xa[4][4],
                                         const unsigned char* b) {
  const uint64_t desc = sw128_desc(b);
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kK16; ++kk) wgmma_64x64x16<1, T>(o, xa[kk], desc + 128 * kk, 1);
  wgmma_commit();
}

// Rows [0, rows) x columns [0, cols) of a bias tile into rows of a region
// `stride` floats apart, by 4-byte cp.async (bias rows are L floats, so rows
// are not 16-byte aligned in general); src points at the tile's first
// element, rows L floats apart.
__device__ __forceinline__ void stage_bias(float* dst, int stride, const float* src, int rows,
                                           int cols, int L) {
  const int c = threadIdx.x & (kTile - 1);
  if (c < cols)
    for (int r = threadIdx.x >> 6; r < rows; r += 2)
      cp_async_4(dst + r * stride + c, src + static_cast<size_t>(r) * L + c, true);
}

// Rows rows[0..1] of a 16 x 64 accumulator, rounded to T (bf16 or fp16),
// into a (L, H*64) tensor; rows >= L are skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float acc[8][4], const int rows[2],
                                           int L, int row_stride) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    T* p = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) = pack2<T>(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

}  // namespace
