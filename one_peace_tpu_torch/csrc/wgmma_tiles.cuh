// Hopper (sm_90a) building blocks shared by the attention kernels
// (flash_attention_{fwd,bwd}.cu, det_attention_{fwd,bwd}.cu): cp.async copies
// into 128-byte-swizzled bf16 tiles of 64 rows x 64 head dims, their wgmma
// descriptors, wgmma m64n64k16 with A from registers or from shared memory,
// and wgmma m64nNk16 (N = 16, 32, 48 or 64) with A from registers for a
// ragged last tile.  Each product takes its element type T, bf16 (the
// default) or fp16 (__half): the tiles, fragments and swizzle are the same
// for both 2-byte types, only the wgmma's type and the rounding of packed
// values differ.  ops/build.py hashes every header here into each
// library's name.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// lo, hi rounded to nearest even in T (bf16 or fp16), packed as one A
// fragment register or one 4-byte store.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  static_assert(std::is_same_v<T, __nv_bfloat16> || std::is_same_v<T, __half>,
                "the 2-byte element types are bf16 and fp16");
  if constexpr (std::is_same_v<T, __half>) return pack_f16(lo, hi);
  else return pack_bf16(lo, hi);
}

// wgmma (sm_90a): one warpgroup (the block's 4 warps) multiplies a 64 x 16
// bf16 A, from registers in mma.sync's m16n8k16 A layout per warp or from a
// tile in shared memory, by a 16 x 64 bf16 B in shared memory, into 64 x 64
// fp32 accumulators in mma.sync's m16n8 accumulator layout per warp: d[j][c]
// is row 16w + g + 8 (c >> 1), column 8j + 2t + (c & 1).
//
// A tile's descriptor: 128-byte rows stored with the 128-byte swizzle
// (16-byte chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4), the tile
// 1024-byte aligned), 8-row groups 1024 B apart.  K (key rows of 64 head
// dims) is B = K^T K-major: a 16-deep step advances 32 bytes along the row;
// Q as A is K-major the same way.  V (key rows of 64 head dims) is B = V
// MN-major (transposed): a 16-deep step advances 16 rows, 2048 bytes.
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Shared memory written by threads (cp.async) becomes visible to wgmma.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accesses of d across a wgmma's start or wait.
__device__ __forceinline__ void fence_acc(float d[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) asm volatile("" : "+f"(d[j][c])::"memory");
}

#define DET_ACC4(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
// The asm of one product, TY its element type's PTX name ("bf16" or "f16").
#define WGMMA_RS_64(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"                                       \
      : DET_ACC4(0), DET_ACC4(1), DET_ACC4(2), DET_ACC4(3), DET_ACC4(4), DET_ACC4(5),       \
        DET_ACC4(6), DET_ACC4(7)                                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB))
#define WGMMA_SS_64(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "%32, %33, p, 1, 1, 0, %35;\n}\n"                                                      \
      : DET_ACC4(0), DET_ACC4(1), DET_ACC4(2), DET_ACC4(3), DET_ACC4(4), DET_ACC4(5),       \
        DET_ACC4(6), DET_ACC4(7)                                                             \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB))
#define WGMMA_RS_16(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"        \
      : DET_ACC4(0), DET_ACC4(1)                                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB))
#define WGMMA_RS_32(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "            \
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"                                         \
      : DET_ACC4(0), DET_ACC4(1), DET_ACC4(2), DET_ACC4(3)                                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB))
#define WGMMA_RS_48(TY)                                                                      \
  asm volatile(                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"                                           \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "             \
      "%16, %17, %18, %19, %20, %21, %22, %23}, "                                            \
      "{%24, %25, %26, %27}, %28, p, 1, 1, %30;\n}\n"                                         \
      : DET_ACC4(0), DET_ACC4(1), DET_ACC4(2), DET_ACC4(3), DET_ACC4(4), DET_ACC4(5)         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate), "n"(kTransB))

// d (+)= a . B: wgmma m64n64k16, A from registers; kTransB: B is MN-major.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_64x64x16(float d[8][4], const uint32_t a[4], uint64_t desc,
                                               int accumulate) {
  if constexpr (std::is_same_v<T, __half>) WGMMA_RS_64("f16");
  else WGMMA_RS_64("bf16");
}
// d (+)= A . B: wgmma m64n64k16, A K-major from shared memory (desc_a); B as above.
template <int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_64x64x16_ss(float d[8][4], uint64_t desc_a, uint64_t desc_b,
                                                  int accumulate) {
  if constexpr (std::is_same_v<T, __half>) WGMMA_SS_64("f16");
  else WGMMA_SS_64("bf16");
}

// d[0 .. kN8) (+)= a . B: wgmma m64nNk16 with N = 8 kN8 (16, 32 or 48; 64 is
// wgmma_64x64x16), A from registers, B K-major (kTransB 0) or MN-major (1)
// N rows / columns of a swizzled tile; d[kN8 ..] is left alone.
template <int kN8, int kTransB, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_64xnx16(float d[8][4], const uint32_t a[4], uint64_t desc,
                                              int accumulate) {
  static_assert(kN8 == 2 || kN8 == 4 || kN8 == 6 || kN8 == 8, "N is 16, 32, 48 or 64");
  constexpr bool kF16 = std::is_same_v<T, __half>;
  if constexpr (kN8 == 8) {
    wgmma_64x64x16<kTransB, T>(d, a, desc, accumulate);
  } else if constexpr (kN8 == 2) {
    if constexpr (kF16) WGMMA_RS_16("f16");
    else WGMMA_RS_16("bf16");
  } else if constexpr (kN8 == 4) {
    if constexpr (kF16) WGMMA_RS_32("f16");
    else WGMMA_RS_32("bf16");
  } else {
    if constexpr (kF16) WGMMA_RS_48("f16");
    else WGMMA_RS_48("bf16");
  }
}
#undef WGMMA_RS_64
#undef WGMMA_SS_64
#undef WGMMA_RS_16
#undef WGMMA_RS_32
#undef WGMMA_RS_48
#undef DET_ACC4

// 16- and 4-byte async copies global -> shared; zero-fill when !valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// Rows [row0, row0 + 64) of one head (64 head dims a row of a 2-byte type,
// bf16 or fp16) into a 128-byte-swizzled tile, asynchronously; rows >= L
// are zero.
template <typename T>
__device__ __forceinline__ void load_tile_async(unsigned char* dst, const T* src, int row0,
                                                int L, int row_stride) {
  static_assert(sizeof(T) == 2, "a tile row is 64 two-byte head dims");
  for (int i = threadIdx.x; i < 64 * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < L;
    cp_async_16(dst + r * 128 + ((c ^ (r & 7)) << 4),
                src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride + c * 8, valid);
  }
}

}  // namespace
