// Detection-trunk attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels one_peace_tpu/ops/det_attention.py
// `_det_flash_bwd`: pass 1 (`_make_bwd_dq_kernel`, :618) and pass 2
// (`_make_bwd_dkv_kernel`, :642).  Over an (hg, wg) grid of L = hg * wg
// tokens, per (batch b, head h), with q = (qy, qx), k = (ky, kx) and
//
//   s  = q k^T * scaling + toep[h, qy - ky + hg - 1, qx, kx] + bh[b, h, ky, q]
//        + bw[b, h, q, kx]                                    (fp32)
//   p  = exp(s - lse)            from the forward's row log-sum-exp
//   dp = g v^T,  ds = p * (dp - delta),  delta = rowsum(g * out)  (fp32)
//
// it computes, on the (B, L, H*64) layout of the projections:
//   dv = round(p)^T g;  dq = round(ds) k * scaling;  dk = round(ds)^T q * scaling
//   dbh[b, h, ky, q] = sum_kx ds;  dbw[b, h, q, kx] = sum_ky ds
//   dtoep[h, dy, qx, kx] = sum over b and over the (qy, ky) with
//                          qy - ky + hg - 1 = dy of ds
// where round() is to the inputs' dtype (fp32, bf16 or fp16), exactly where
// the TPU kernels and det_attention_bwd_plain round; dq/dk/dv have the inputs' dtype,
// the bias cotangents are fp32.  Neither (B, H, L, L) p nor ds exists.
//
// What bounds it on an H100 (1.5B trunk, H=24, Dh=64, B=2 at 1024 px):
//   global layer, L = 4096: s and dp recomputed, dv, dq, dk: 10 * B*H*L^2*64
//     = 5.2e11 operations (0.52 ms at 989 TFLOP/s); the bytes (q, k, v, g,
//     out, dq, dk, dv in bf16, toep/dtoep, bh/dbh, bw/dbw fp32) are ~0.3 GB
//     (0.09 ms).  So the tensor cores set the bound.  But every one of the
//     B*H*L^2 = 8.1e8 scores also needs three bias values, an exp, and (pass
//     1) adds into three bias sums, in each of three kernels: the first port
//     read the bias per score from device memory (8 cache lines per
//     warp-wide load) and summed dbh and dbw through shared memory behind two
//     barriers a tile, and spent 15 of its 17.4 ms outside the products.
//   windowed layer, B' = 32 windows of L = 256: 3.2e10 operations (0.03 ms)
//     against ~0.2 GB (0.06 ms): bytes.
//
// What this design does about it, and where each reduction happens:
//   - Three kernels on one stream, each block one warpgroup (4 warps).  bf16
//     and fp16 run one set of kernels, templated on the element type; their
//     products run on wgmma m64n64k16 (wgmma_tiles.cuh): q.k^T, g.v^T, k.q^T
//     and v.g^T with both operands from 128-byte-swizzled tiles written by
//     cp.async; ds.K, p^T.G and ds^T.Q with A = round(ds) or round(p) from
//     registers (the accumulator layout is wgmma's A layout) and B the tile
//     read transposed.  The dtoep pass's 16- and 32-wide items use mma.sync
//     on the same tiles.  fp32 (the test path) runs the same tile code on
//     CUDA-core FMA in the same accumulator layout, so the bias reads, masks
//     and reductions are shared.
//   - The bias comes from on-chip memory where wg is 8, 16, 32 or 64 (the
//     64 x 64 grid and its 16 x 16 windows; ops/det_attention.py:bwd_plan):
//     a 64-key tile is 64 / wg whole grid rows with one column pattern, so
//     * toep: a (q tile at q0, key tile at ky_lo) pair reads toep's flat rows
//       q + (hg - 1 - ky) * wg, the 64 + (64 / wg - 1) * wg rows from
//       q0 + (hg - 64 / wg - ky_lo) * wg on, copied by cp.async into rows
//       padded to a stride = 8 mod 16 floats (pass 1's float2 reads of an
//       mma fragment hit 32 banks) or = 4 mod 16 (pass 2's scalar reads,
//       keys as rows, do);
//     * bw: a pass 1 thread holds the wg / 2 values of bw[q, kx] it needs
//       (its two rows, its columns mod wg) in registers for the whole key
//       walk; pass 2 stages the q tile's bw rows; the dtoep pass stages each
//       item's bw rows with its Q and G rows (any grid);
//     * bh: pass 1 stages the tile's grid rows of bh (at wg = 64 one value a
//       row, folded into the row's lse); pass 2 stages the q tile's bh rows
//       with its lse and delta and subtracts bh from lse once per column;
//     and the bias is read while the tile's q.k^T (and g.v^T) run.  Other
//     grids read the bias per score from device memory through a per-tile
//     (ky, kx) offset table, in the same kernels (the forward found staging
//     there lost at one block per SM).
//   - det_bwd_dq (pass 1): one block per (batch, 64-row q tile, head) walks
//     the 64-key tiles (K, V and the tile's bias double-buffered with
//     cp.async); dq sums in the wgmma accumulators.  Staged, every key tile
//     holds whole grid rows with fixed columns, so dbw[q, kx] sums in the
//     registers of the thread that owns (q, kx) for the whole walk, and
//     dbh[ky, q], the sum of one grid row's keys, is a row sum in registers
//     and two quad shuffles, written once: no staging, no barrier; both run
//     while ds.K is on the tensor cores.  Gathered, ds goes to shared memory
//     after each tile, dbw[q, kx] is summed there by its owner thread, and
//     dbh[ky, q] is added to in device memory in tile order.  No atomics:
//     deterministic.
//   - det_bwd_dkv (pass 2): one block per (batch, 64-key tile, head) walks
//     the q tiles from the saved LSE, as csrc/flash_attention_bwd.cu does.
//     Staged, the q tile's toep slab and bw rows are single-buffered (two
//     blocks per SM) and refilled as soon as the tile's p is computed.
//   - det_bwd_dtoep (the rest of pass 1's work): the TPU kernel keeps a
//     per-(b, h, q tile) dtoep slab in VMEM and folds the partials in XLA.
//     Here a 64-row q tile at wg = 64 is one grid row, so each (q tile, k
//     tile) pair is a whole wg x wg slab of one dy: per-q-tile partials would
//     be the whole of ds in fp32, 3.2 GB at B=2.  Instead one block per
//     (dy, head) owns its output slab and recomputes s and dp for the tile
//     pairs of that dy only (one grid row of queries against one of keys, for
//     every b and every qy), summing ds in registers in a fixed order: no
//     scratch at all, at the price of recomputing s and dp once more
//     (2/5 of the operations above) and of reading each item's Q, G, K, V
//     and bw rows (48 KB at wg = 64) for two 64 x 64 x 64 products.  Grid
//     rows narrower than 64 are packed 2 or 4 to a 64-row tile (16 x 16 or
//     32 x 32 products per warp), and the warps holding the same slab
//     columns add their sums in shared memory in a fixed order.
//   - Rows and keys >= L (a ragged last tile) are zero-filled on load and
//     get p = 0, or a finite p against zero rows of G and V, so they add
//     nothing; their results are not stored.
// Not done yet: TMA; s and dp shared between pass 1 and the dtoep pass; a
// dtoep block that owns a band of displacements, so that it reads each
// item's Q, G and bw rows once for several of them.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;              // rows of a q tile, keys of a key tile
constexpr int kThreads = 128;          // 4 warps, 16 rows each
constexpr int kDsStride = kTile + 1;   // fp32 staging rows: no bank conflicts

// How the 2-byte kernels read the bias (ops/det_attention.py: BWD_GATHER,
// BWD_SLAB).
constexpr int kGather = 0;  // per score from device memory, any grid
constexpr int kSlab = 1;    // staged in shared memory (and registers); wg in {8, 16, 32, 64}

// Floats per staged row of wg floats, padded to = mod (mod 16): 8 for pass 1's
// float2 reads, 4 for pass 2's scalar reads (both conflict-free).
__host__ __device__ constexpr int padded_stride(int wg, int mod) {
  return wg + (mod - wg % 16 + 16) % 16;
}
template <int kLw>
constexpr int kQStride = padded_stride(1 << kLw, 8);
template <int kLw>
constexpr int kKStride = padded_stride(1 << kLw, 4);

// The 2-byte kernels' plan for one grid (ops/det_attention.py:bwd_plan): the
// caller's mode, and the staging geometry that follows from wg.
struct Plan {
  int mode;       // kGather or kSlab
  int tile_rows;  // kSlab: grid rows of a 64-key tile, 64 / wg
  int slab_rows;  // kSlab: toep rows staged per tile pair, 64 + (tile_rows - 1) * wg
  int q_stride;   // kSlab: floats per staged row in pass 1 (kQStride)
  int k_stride;   // kSlab: floats per staged row in pass 2 (kKStride)
};

Plan make_plan(int mode, int wg) {
  if (mode != kSlab) return Plan{mode, 0, 0, 0, 0};
  const int tile_rows = kTile / wg;
  return Plan{mode, tile_rows, kTile + (tile_rows - 1) * wg, padded_stride(wg, 8),
              padded_stride(wg, 4)};
}

using bf16 = __nv_bfloat16;

// The 2-byte element types, bf16 and fp16 (__half): one set of kernels serves
// both, their tiles, swizzle, fragments and plans being those of any 2-byte
// type; only the products' type (.bf16 or .f16) and the rounding of packed
// values differ.
template <typename T>
constexpr bool kTwoByte = std::is_same<T, bf16>::value || std::is_same<T, __half>::value;

// A Q/K/V/G tile of 64 rows: bf16 or fp16 in the 128-byte swizzle that wgmma reads
// (wgmma_tiles.cuh; 128 bytes a row, the tile 1024-byte aligned), fp32 in
// rows padded to kF32Stride floats.
constexpr int kF32Stride = kHeadDim + 4;
constexpr int kAlign = 1024;
template <typename T>
constexpr int kRowBytes = kTwoByte<T> ? 128 : kF32Stride * 4;
template <typename T>
constexpr int kTileBytes = kTile * kRowBytes<T>;

// Row r of the tile at `tile` (bytes), as T*.
template <typename T>
__device__ __forceinline__ T* tile_row(unsigned char* tile, int r) {
  return reinterpret_cast<T*>(tile + r * kRowBytes<T>);
}

// D = A (16x16, row) * B (16x8, col) + D, T (bf16 or fp16) in, fp32 accumulate.
#define DET_MMA_16816(TY)                                                            \
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32." TY "." TY ".f32 "            \
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"             \
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])                      \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
template <typename T>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  static_assert(kTwoByte<T>, "mma.sync takes a 2-byte type here");
  if constexpr (std::is_same<T, __half>::value) DET_MMA_16816("f16");
  else DET_MMA_16816("bf16");
}
#undef DET_MMA_16816

// 64 rows of one head into a tile, asynchronously: row r is row rows[r] of
// the (rows, H*64) tensor `src` (already offset to the head), or zeros when
// rows[r] < 0.
template <typename T>
__device__ __forceinline__ void load_rows(unsigned char* dst, const T* src, const int* rows,
                                          int row_stride) {
  constexpr int kChunks = kHeadDim * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, row = rows[r];
    const int at = kTwoByte<T> ? r * 128 + ((c ^ (r & 7)) << 4) : r * kRowBytes<T> + 16 * c;
    cp_async_16(dst + at,
                src + static_cast<size_t>(row < 0 ? 0 : row) * row_stride + c * 16 / sizeof(T),
                row >= 0);
  }
}

// Rows [row0, row0 + 64) of one head into a tile; rows >= L are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(unsigned char* dst, const T* src, int row0, int L,
                                          int row_stride) {
  if constexpr (kTwoByte<T>) {
    load_tile_async(dst, src, row0, L, row_stride);
  } else {
    for (int i = threadIdx.x; i < kTile * 16; i += kThreads) {
      const int r = i >> 4, c = i & 15;
      const bool valid = row0 + r < L;
      cp_async_16(dst + r * kRowBytes<T> + 16 * c,
                  src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride + 4 * c, valid);
    }
  }
}

// Rows r0 .. r0 + rows - 1 of a (total, 2^kLw) fp32 matrix into rows `stride`
// floats apart, asynchronously; rows outside [0, total) are zeros.
template <int kLw>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, int r0, int rows,
                                               int stride, int total) {
  constexpr int kLp = kLw - 2;  // log2 of a row's 16-byte pieces
  for (int i = threadIdx.x; i < rows << kLp; i += kThreads) {
    const int r = i >> kLp, c = i & ((1 << kLp) - 1), fr = r0 + r;
    const bool valid = fr >= 0 && fr < total;
    cp_async_16(dst + r * stride + 4 * c,
                valid ? src + (static_cast<size_t>(fr) << kLw) + 4 * c : src, valid);
  }
}

// bh rows ky_lo .. ky_lo + kRows - 1 (of hg), queries q0 .. q0 + 63 (of L, a
// multiple of 4 here), 64 floats a row; zeros outside the grid.
template <int kRows>
__device__ __forceinline__ void stage_bh(float* dst, const float* bh, int ky_lo, int q0, int hg,
                                         int L) {
  for (int i = threadIdx.x; i < kRows * 16; i += kThreads) {
    const int r = i >> 4, c = i & 15;
    const bool valid = ky_lo + r < hg && q0 + 4 * c < L;
    cp_async_16(dst + r * kTile + 4 * c,
                valid ? bh + static_cast<size_t>(ky_lo + r) * L + q0 + 4 * c : bh, valid);
  }
}

// ---------------------------------------------------------------------------
// Tile products in the m16n8k16 accumulator layout: a warp's acc[j][c] is
// row g + 8 * (c >> 1) of its 16 rows and column 8j + 2t + (c & 1), with
// g = lane / 4 and t = lane % 4.
// ---------------------------------------------------------------------------

// acc (16 x 8*kN8) = A (16 rows x 64) * B (8*kN8 rows x 64)^T on mma.sync;
// a and b point at the first row of each, rows a multiple of 8 into a
// swizzled tile of the 2-byte type T (so row g's chunk c sits at
// g * 128 + ((c ^ g) << 4)).
template <int kN8, typename T>
__device__ __forceinline__ void tile_nt(float acc[][4], const T* a, const T* b) {
  static_assert(kTwoByte<T>, "the fp32 tiles take the FMA overload below");
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  auto at = [&](const T* tile, int r, int e) {  // elements e, e + 1 of row r (r & 7 == g)
    return *reinterpret_cast<const uint32_t*>(reinterpret_cast<const unsigned char*>(tile) +
                                              r * 128 + (((e >> 3) ^ g) << 4) + (e & 7) * 2);
  };
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    af[kk][0] = at(a, g, kk * 16 + 2 * t);
    af[kk][1] = at(a, g + 8, kk * 16 + 2 * t);
    af[kk][2] = at(a, g, kk * 16 + 8 + 2 * t);
    af[kk][3] = at(a, g + 8, kk * 16 + 8 + 2 * t);
  }
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816<T>(acc[j], af[kk], at(b, j * 8 + g, kk * 16 + 2 * t),
                at(b, j * 8 + g, kk * 16 + 8 + 2 * t));
  }
}

// The same on FMA for fp32: a and b point at the first row of each in a
// padded fp32 tile.
template <int kN8>
__device__ __forceinline__ void tile_nt(float acc[][4], const float* a, const float* b) {
  constexpr int S = kF32Stride;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kN8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
  const float* a0 = a + g * S;
  const float* a1 = a0 + 8 * S;
  for (int d = 0; d < kHeadDim; ++d) {
    const float x0 = a0[d], x1 = a1[d];
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float y = b[(8 * j + 2 * t + c) * S + d];
        acc[j][c] = fmaf(x0, y, acc[j][c]);
        acc[j][2 + c] = fmaf(x1, y, acc[j][2 + c]);
      }
  }
}

// The thread's elements of x into the warp's 16 rows of an fp32 staging tile.
__device__ __forceinline__ void stage_rows(float* xs, const float x[8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      xs[(g + 8 * (c >> 1)) * kDsStride + 8 * j + 2 * t + (c & 1)] = x[j][c];
}

// fp32: o (16 x 64) += x (16 x 64, the sum index) * tile (64 sum rows x 64),
// x read from xs, the warp's rows staged by the caller.
__device__ __forceinline__ void tile_nn(float o[8][4], const float* xs, const float* tile) {
  constexpr int S = kF32Stride;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < kTile; ++k) {
    const float x0 = xs[g * kDsStride + k], x1 = xs[(g + 8) * kDsStride + k];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float y = tile[k * S + 8 * n + 2 * t + c];
        o[n][c] = fmaf(x0, y, o[n][c]);
        o[n][2 + c] = fmaf(x1, y, o[n][2 + c]);
      }
  }
}

// Products of one warpgroup on wgmma m64n64k16 in the 2-byte type T, from
// 128-byte-swizzled tiles; each is issued and committed, and its accumulator
// may be read only after product_wait.
// acc = A B^T over the 64 head dims: A and B 64 rows each (acc holds the
// warp's 16 rows of A).
template <typename T>
__device__ __forceinline__ void product_nt(float acc[8][4], const unsigned char* a,
                                           const unsigned char* b) {
  const uint64_t da = sw128_desc(a), db = sw128_desc(b);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16_ss<0, T>(acc, da + 2 * kk, db + 2 * kk, kk);
  wgmma_commit();
}
// o += x B: x (64 rows x 64, the sum index) in registers as wgmma A
// fragments (pack_a), B the tile's 64 rows (the sum index) transposed.
template <typename T>
__device__ __forceinline__ void product_nn(float o[8][4], const uint32_t xa[4][4],
                                           const unsigned char* b) {
  const uint64_t db = sw128_desc(b);
  fence_acc(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1, T>(o, xa[kk], db + 128 * kk, 1);
  wgmma_commit();
}
__device__ __forceinline__ void product_wait(float a[8][4]) {
  wgmma_wait_all();
  fence_acc(a);
}
// round(x) to T, x in the accumulator layout, as A fragments: the
// accumulator layout of two adjacent 8-column tiles is the A layout of one
// 16-deep step.
template <typename T>
__device__ __forceinline__ void pack_a(uint32_t xa[4][4], const float x[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    xa[kk][0] = pack2<T>(x[2 * kk][0], x[2 * kk][1]);
    xa[kk][1] = pack2<T>(x[2 * kk][2], x[2 * kk][3]);
    xa[kk][2] = pack2<T>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    xa[kk][3] = pack2<T>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// Rows rows[0..1] of a 16 x 64 accumulator, times scale and rounded to the
// 2-byte type T, into a (L, H*64) tensor; rows >= L are skipped.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float acc[8][4], const int rows[2],
                                           int L, int row_stride, float scale) {
  static_assert(kTwoByte<T>, "fp32 rows take the overload below");
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    T* p = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack2<T>(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

__device__ __forceinline__ void store_rows(float* dst, const float acc[8][4], const int rows[2],
                                           int L, int row_stride, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    float* p = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(p + n * 8) =
          make_float2(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// ---------------------------------------------------------------------------
// kGather: the bias of one (query, key) pair, toep[qpos.t + kpos.t] +
// bh[kpos.h + qpos.h] + bw[qpos.w + kpos.w], from per-query and per-key
// offsets that are computed once per tile (no thread divides by wg in a
// score loop).
// ---------------------------------------------------------------------------

struct Bias {
  const float* toep;  // the head's (2hg-1, wg, wg), or null
  const float* bh;    // the (batch, head)'s (hg, L), or null
  const float* bw;    // the (batch, head)'s (L, wg), or null
  int hg, wg, L;
};

struct Pos {
  int t, h, w;
};

// A query's offsets: ((qy + hg - 1) * wg + qx) * wg, q, q * wg.
__device__ __forceinline__ Pos query_pos(int q, const Bias& bias) {
  q = min(q, bias.L - 1);
  const int qy = q / bias.wg, qx = q - qy * bias.wg;
  return Pos{((qy + bias.hg - 1) * bias.wg + qx) * bias.wg, q, q * bias.wg};
}

// A key's offsets: kx - ky * wg * wg, ky * L, kx; and its ky.
__device__ __forceinline__ Pos key_pos(int k, const Bias& bias, int* ky_out) {
  k = min(k, bias.L - 1);
  const int ky = k / bias.wg, kx = k - ky * bias.wg;
  *ky_out = ky;
  return Pos{kx - ky * bias.wg * bias.wg, ky * bias.L, kx};
}

__device__ __forceinline__ float bias_at(const Bias& bias, const Pos& a, int bt, int bh, int bw) {
  float x = 0.f;
  if (bias.toep != nullptr) x += __ldg(bias.toep + a.t + bt);
  if (bias.bh != nullptr) {
    x += __ldg(bias.bh + a.h + bh);
    x += __ldg(bias.bw + a.w + bw);
  }
  return x;
}

// A table of 64 positions in shared memory: t, h, w and (keys) ky.
struct PosTable {
  int t[kTile], h[kTile], w[kTile], y[kTile];
};

// The dynamic shared memory, its start aligned up to the swizzle's 1024-byte
// atom where wgmma reads the tiles (the layouts reserve kAlign bytes for it).
template <bool kWgmma>
__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
  if constexpr (kWgmma)
    return p + ((kAlign - static_cast<uint32_t>(__cvta_generic_to_shared(p))) & (kAlign - 1));
  else
    return p;
}

// s = A B^T and dp = C D^T over the 64 head dims (the warp's 16 rows of A and
// C), done on return: bf16 or fp16 on wgmma, fp32 on FMA.
template <typename T>
__device__ __forceinline__ void two_products(float s[8][4], float dp[8][4], unsigned char* a,
                                             unsigned char* b, unsigned char* c,
                                             unsigned char* d) {
  if constexpr (kTwoByte<T>) {
    product_nt<T>(s, a, b);
    product_nt<T>(dp, c, d);
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);
  } else {
    const int w = threadIdx.x >> 5;
    tile_nt<8>(s, tile_row<float>(a, 16 * w), tile_row<float>(b, 0));
    tile_nt<8>(dp, tile_row<float>(c, 16 * w), tile_row<float>(d, 0));
  }
}

// ---------------------------------------------------------------------------
// Pass 1: dq, dbh, dbw.  Block (b, 64-row q tile, h); warp w owns query rows
// [16w, 16w + 16) of the tile.
// ---------------------------------------------------------------------------

// Byte offsets into pass 1's dynamic shared memory.
struct DqSmem {
  int qs, gs, ks, vs, slab, bhs, dss, dbw, cols, total;
};

template <typename T>
__host__ __device__ inline DqSmem dq_layout(int mode, bool toep, bool decomp, int wg,
                                            const Plan& p) {
  DqSmem s;
  int off = 0;
  s.qs = off;
  off += kTileBytes<T>;
  s.gs = off;
  off += kTileBytes<T>;
  s.ks = off;  // [2] tiles
  off += 2 * kTileBytes<T>;
  s.vs = off;  // [2] tiles
  off += 2 * kTileBytes<T>;
  s.slab = off;  // kSlab: [2][slab_rows * q_stride] floats
  if (mode == kSlab && toep) off += 2 * p.slab_rows * p.q_stride * 4;
  s.bhs = off;  // kSlab: [2][tile_rows * 64] floats
  if (mode == kSlab && decomp) off += 2 * p.tile_rows * kTile * 4;
  s.dss = off;  // kGather: ds, 64 x kDsStride floats
  if (mode == kGather) off += kTile * kDsStride * 4;
  s.dbw = off;  // kGather: dbw sums, [kx][row]
  if (mode == kGather && decomp) off += kTile * wg * 4;
  s.cols = off;  // kGather: [2] PosTable
  if (mode == kGather) off += 2 * static_cast<int>(sizeof(PosTable));
  s.total = off + (kTwoByte<T> ? kAlign : 0);
  return s;
}

template <typename T, int kMode, int kLw>
__global__ void __launch_bounds__(kThreads, 2)
det_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ toep,
           const float* __restrict__ bh, const float* __restrict__ bw, T* __restrict__ dq,
           float* __restrict__ dbh, float* __restrict__ dbw, int L, int H, int hg, int wg,
           float scaling, Plan plan) {
  constexpr int KT = kTileBytes<T>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = align_smem<kTwoByte<T>>(dyn_smem);
  const bool decomp = bh != nullptr;
  const DqSmem lay = dq_layout<T>(kMode, toep != nullptr, decomp, wg, plan);
  unsigned char* qs = smem + lay.qs;
  unsigned char* gs = smem + lay.gs;
  unsigned char* ks = smem + lay.ks;  // [2] tiles
  unsigned char* vs = smem + lay.vs;  // [2] tiles

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bhead = static_cast<size_t>(b) * H + h;
  const Bias bias{toep != nullptr ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg
                                  : nullptr,
                  decomp ? bh + bhead * hg * L : nullptr,
                  decomp ? bw + bhead * L * wg : nullptr, hg, wg, L};
  float* dbh_b = decomp ? dbh + bhead * hg * L : nullptr;
  float* dbw_b = decomp ? dbw + bhead * L * wg : nullptr;

  load_tile(qs, q + base, q0, L, row_stride);
  load_tile(gs, g + base, q0, L, row_stride);
  cp_async_commit();

  const int rl[2] = {warp * 16 + gr, warp * 16 + gr + 8};  // the rows within the tile
  const int rows[2] = {q0 + rl[0], q0 + rl[1]};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row >= L gets p = 0
    const bool ok = rows[r] < L;
    lse_r[r] = ok ? lse[bhead * L + rows[r]] : INFINITY;
    delta_r[r] = ok ? delta[bhead * L + rows[r]] : 0.f;
  }

  float o[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  const int n_tiles = (L + kTile - 1) / kTile;

  if constexpr (kMode == kSlab) {
    constexpr int kWg = 1 << kLw, kNr = kTile >> kLw, kNj = kWg / 8, kQs = kQStride<kLw>;
    float* slab = reinterpret_cast<float*>(smem + lay.slab);  // [2][slab_rows * kQs]
    float* bhs = reinterpret_cast<float*>(smem + lay.bhs);    // [2][kNr * 64]
    const int slab_size = plan.slab_rows * kQs, total = (2 * hg - 1) << kLw;
    // bw of this thread's rows and columns, the same in every key tile; and
    // the dbw sums of those (q, kx), owned by this thread for the whole walk
    float bwr[kNj][4], dbw_acc[kNj][4];
#pragma unroll
    for (int jj = 0; jj < kNj; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        bwr[jj][c] = decomp ? __ldg(bias.bw + min(rows[c >> 1], L - 1) * kWg + 8 * jj + 2 * t +
                                    (c & 1))
                            : 0.f;
        dbw_acc[jj][c] = 0.f;
      }
    const int toff[2] = {rl[0] * kQs + 2 * t, rl[1] * kQs + 2 * t};
    auto stage = [&](int it) {
      const int buf = it & 1, k0 = it * kTile, ky_lo = k0 >> kLw;
      load_tile(ks + buf * KT, k + base, k0, L, row_stride);
      load_tile(vs + buf * KT, v + base, k0, L, row_stride);
      if (bias.toep != nullptr)
        stage_rows_f32<kLw>(slab + buf * slab_size, bias.toep, q0 + (hg - kNr - ky_lo) * kWg,
                            plan.slab_rows, kQs, total);
      if (decomp) stage_bh<kNr>(bhs + buf * kNr * kTile, bias.bh, ky_lo, q0, hg, L);
    };
    stage(0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kTile, cur = it & 1, ky_lo = k0 >> kLw;
      if (it + 1 < n_tiles) stage(it + 1);
      cp_async_commit();
      cp_async_wait_prev();
      fence_async_shared();
      __syncthreads();
      product_nt<T>(s, qs, ks + cur * KT);  // s = q k^T and dp = g v^T, while the bias is read
      product_nt<T>(dp, gs, vs + cur * KT);
      const float* sl = slab + cur * slab_size;
      const float* bc = bhs + cur * kNr * kTile;
      // at wg = 64 the tile is one grid row: its bh goes into the row's lse
      float lrow[2], bv[8][4];
#pragma unroll
      for (int r = 0; r < 2; ++r) lrow[r] = lse_r[r] - (decomp && kNr == 1 ? bc[rl[r]] : 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kyl = (8 * j) >> kLw;  // the column group's grid row in the tile
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2 x = make_float2(0.f, 0.f);
          if (bias.toep != nullptr)
            x = *reinterpret_cast<const float2*>(
                sl + toff[r] + ((kNr - 1 - kyl) << kLw) * kQs + ((8 * j) & (kWg - 1)));
          if (decomp) {
            const float y = kNr > 1 ? bc[kyl * kTile + rl[r]] : 0.f;
            x.x += bwr[j & (kNj - 1)][2 * r] + y;
            x.y += bwr[j & (kNj - 1)][2 * r + 1] + y;
          }
          bv[j][2 * r] = x.x;
          bv[j][2 * r + 1] = x.y;
        }
      }
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
      const bool ragged = k0 + kTile > L;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = __expf(fmaf(s[j][e], scaling, bv[j][e]) - lrow[e >> 1]);
          if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= L) p = 0.f;
          s[j][e] = p * (dp[j][e] - delta_r[e >> 1]);  // ds
        }
      uint32_t dsa[4][4];  // read by the wgmma until product_wait
      pack_a<T>(dsa, s);
      product_nn<T>(o, dsa, ks + cur * KT);  // dq += round(ds) k, while the bias sums run
      if (decomp) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) dbw_acc[j & (kNj - 1)][c] += s[j][c];
        // dbh[ky, q]: the row's sum over each grid row's keys, in the thread
        // (column order), then over the quad
        float hs[kNr][2];
#pragma unroll
        for (int y = 0; y < kNr; ++y) hs[y][0] = hs[y][1] = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            hs[(8 * j) >> kLw][r] += s[j][2 * r];
            hs[(8 * j) >> kLw][r] += s[j][2 * r + 1];
          }
#pragma unroll
        for (int y = 0; y < kNr; ++y)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            hs[y][r] += __shfl_xor_sync(0xffffffffu, hs[y][r], 1);
            hs[y][r] += __shfl_xor_sync(0xffffffffu, hs[y][r], 2);
          }
        // thread t of the quad writes the tile's grid rows y = t mod 4, once
#pragma unroll
        for (int y = 0; y < kNr; ++y)
          if ((y & 3) == t && ky_lo + y < hg)
#pragma unroll
            for (int r = 0; r < 2; ++r)
              if (rows[r] < L) dbh_b[static_cast<size_t>(ky_lo + y) * L + rows[r]] = hs[y][r];
      }
      product_wait(o);
      __syncthreads();  // tile it is consumed before its buffers are refilled
    }
    if (decomp) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (rows[r] >= L) continue;
#pragma unroll
        for (int jj = 0; jj < kNj; ++jj)
          *reinterpret_cast<float2*>(dbw_b + static_cast<size_t>(rows[r]) * kWg + 8 * jj + 2 * t) =
              make_float2(dbw_acc[jj][2 * r], dbw_acc[jj][2 * r + 1]);
      }
    }
  } else {
    float* dss = reinterpret_cast<float*>(smem + lay.dss);    // ds, 64 x kDsStride
    float* dbw_acc = reinterpret_cast<float*>(smem + lay.dbw);  // [kx][row], with decomp
    PosTable* cols = reinterpret_cast<PosTable*>(smem + lay.cols);
    if (decomp) {  // this block alone owns dbh[:, q0:q0+64] and dbw[q0:q0+64, :]
      for (int i = threadIdx.x; i < hg * kTile; i += kThreads) {
        const int ky = i >> 6, r = i & 63;
        if (q0 + r < L) dbh_b[static_cast<size_t>(ky) * L + q0 + r] = 0.f;
      }
      for (int i = threadIdx.x; i < wg * kTile; i += kThreads) dbw_acc[i] = 0.f;
    }
    const Pos rp[2] = {query_pos(rows[0], bias), query_pos(rows[1], bias)};
    auto fill_cols = [&](PosTable& tab, int k0) {
      if (threadIdx.x < kTile) {
        int ky;
        const Pos p = key_pos(k0 + threadIdx.x, bias, &ky);
        tab.t[threadIdx.x] = p.t;
        tab.h[threadIdx.x] = p.h;
        tab.w[threadIdx.x] = p.w;
        tab.y[threadIdx.x] = ky;
      }
    };
    float bv[8][4];
    load_tile(ks, k + base, 0, L, row_stride);
    load_tile(vs, v + base, 0, L, row_stride);
    cp_async_commit();
    fill_cols(cols[0], 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int k0 = it * kTile, cur = it & 1;
      if (it + 1 < n_tiles) {
        load_tile(ks + (cur ^ 1) * KT, k + base, k0 + kTile, L, row_stride);
        load_tile(vs + (cur ^ 1) * KT, v + base, k0 + kTile, L, row_stride);
        fill_cols(cols[cur ^ 1], k0 + kTile);
      }
      cp_async_commit();
      cp_async_wait_prev();
      fence_async_shared();
      __syncthreads();
      const PosTable& tab = cols[cur];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          bv[j][c] = bias_at(bias, rp[c >> 1], tab.t[col], tab.h[col], tab.w[col]);
        }
      two_products<T>(s, dp, qs, ks + cur * KT, gs, vs + cur * KT);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c >> 1;
          const bool ok = k0 + 8 * j + 2 * t + (c & 1) < L;
          const float p = ok ? __expf(s[j][c] * scaling + bv[j][c] - lse_r[r]) : 0.f;
          s[j][c] = p * (dp[j][c] - delta_r[r]);  // ds
        }
      float* my_ds = dss + warp * 16 * kDsStride;
      if (!kTwoByte<T> || decomp) {
        stage_rows(my_ds, s);
        __syncwarp();
      }
      if constexpr (kTwoByte<T>) {  // dq += round(ds) k
        uint32_t dsa[4][4];
        pack_a<T>(dsa, s);
        product_nn<T>(o, dsa, ks + cur * KT);
        product_wait(o);
      } else {
        tile_nn(o, my_ds, tile_row<T>(ks + cur * KT, 0));
      }
      if (decomp) {
        __syncthreads();  // the whole ds tile is staged
        const int n_valid = min(kTile, L - k0);
        const int ky0 = tab.y[0], kx0 = tab.w[0], ky_end = tab.y[n_valid - 1] + 1;
        // dbh[ky, q] += sum of the tile's keys in grid row ky
        for (int i = threadIdx.x; i < (ky_end - ky0) * kTile; i += kThreads) {
          const int r = i & 63, ky = ky0 + (i >> 6);
          const int c_end = min(n_valid, (ky + 1) * wg - k0);
          float sum = 0.f;
          for (int c = max(0, ky * wg - k0); c < c_end; ++c) sum += dss[r * kDsStride + c];
          if (q0 + r < L) dbh_b[static_cast<size_t>(ky) * L + q0 + r] += sum;
        }
        // dbw[q, kx] += sum of the tile's keys in grid column kx (same owner
        // thread for the whole walk)
        for (int i = threadIdx.x; i < wg * kTile; i += kThreads) {
          const int r = i & 63, kx = i >> 6;
          int c = kx - kx0;
          if (c < 0) c += wg;
          float sum = 0.f;
          for (; c < n_valid; c += wg) sum += dss[r * kDsStride + c];
          dbw_acc[i] += sum;
        }
      }
      __syncthreads();  // tile it is consumed before its buffers are refilled
    }
    if (decomp) {
      for (int i = threadIdx.x; i < wg * kTile; i += kThreads) {
        const int r = i & 63, kx = i >> 6;
        if (q0 + r < L) dbw_b[static_cast<size_t>(q0 + r) * wg + kx] = dbw_acc[i];
      }
    }
  }
  store_rows(dq + base, o, rows, L, row_stride, scaling);
}

// ---------------------------------------------------------------------------
// Pass 2: dk, dv.  Block (b, 64-key tile, h); warp w owns keys [16w, 16w+16)
// of the tile and walks the q tiles.  Scores are transposed: rows are keys,
// columns queries.
// ---------------------------------------------------------------------------

struct QueryTable {
  int t[kTile], h[kTile], w[kTile];
  float lse[kTile], delta[kTile];
};

// Byte offsets into pass 2's dynamic shared memory.
struct DkvSmem {
  int ks, vs, qs, gs, slab, bws, tabs, stage, total;
};

template <typename T>
__host__ __device__ inline DkvSmem dkv_layout(int mode, bool toep, bool decomp, const Plan& p) {
  DkvSmem s;
  int off = 0;
  s.ks = off;
  off += kTileBytes<T>;
  s.vs = off;
  off += kTileBytes<T>;
  s.qs = off;  // [2] tiles
  off += 2 * kTileBytes<T>;
  s.gs = off;  // [2] tiles
  off += 2 * kTileBytes<T>;
  s.slab = off;  // kSlab: slab_rows * k_stride floats
  if (mode == kSlab && toep) off += p.slab_rows * p.k_stride * 4;
  s.bws = off;  // kSlab: 64 * k_stride floats
  if (mode == kSlab && decomp) off += kTile * p.k_stride * 4;
  s.tabs = off;  // kSlab: [2][(tile_rows + 2) * 64] floats; kGather: [2] QueryTable
  off += mode == kSlab ? 2 * (p.tile_rows + 2) * kTile * 4
                       : 2 * static_cast<int>(sizeof(QueryTable));
  s.stage = off;  // kGather: fp32 staging, 64 x kDsStride floats
  if (mode == kGather) off += kTile * kDsStride * 4;
  s.total = off + (kTwoByte<T> ? kAlign : 0);
  return s;
}

template <typename T, int kMode, int kLw>
__global__ void __launch_bounds__(kThreads, 2)
det_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, const float* __restrict__ toep,
            const float* __restrict__ bh, const float* __restrict__ bw, T* __restrict__ dk,
            T* __restrict__ dv, int L, int H, int hg, int wg, float scaling, Plan plan) {
  constexpr int KT = kTileBytes<T>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = align_smem<kTwoByte<T>>(dyn_smem);
  const bool decomp = bh != nullptr;
  const DkvSmem lay = dkv_layout<T>(kMode, toep != nullptr, decomp, plan);
  unsigned char* ks = smem + lay.ks;
  unsigned char* vs = smem + lay.vs;
  unsigned char* qs = smem + lay.qs;  // [2] tiles
  unsigned char* gs = smem + lay.gs;  // [2] tiles

  const int b = blockIdx.x, k0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bhead = static_cast<size_t>(b) * H + h;
  const Bias bias{toep != nullptr ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg
                                  : nullptr,
                  decomp ? bh + bhead * hg * L : nullptr,
                  decomp ? bw + bhead * L * wg : nullptr, hg, wg, L};

  load_tile(ks, k + base, k0, L, row_stride);
  load_tile(vs, v + base, k0, L, row_stride);
  load_tile(qs, q + base, 0, L, row_stride);
  load_tile(gs, g + base, 0, L, row_stride);

  const int kr[2] = {warp * 16 + gr, warp * 16 + gr + 8};  // the keys within the tile
  const int keys[2] = {k0 + kr[0], k0 + kr[1]};
  float dk_acc[8][4], dv_acc[8][4], s[8][4], dp[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;
  const int n_tiles = (L + kTile - 1) / kTile;

  if constexpr (kMode == kSlab) {
    constexpr int kWg = 1 << kLw, kNr = kTile >> kLw, kKs = kKStride<kLw>;
    constexpr int kTab = (kNr + 2) * kTile;
    float* slab = reinterpret_cast<float*>(smem + lay.slab);  // slab_rows x kKs
    float* bws = reinterpret_cast<float*>(smem + lay.bws);    // 64 x kKs
    // [2][kNr + 2][64]: the q tile's lse, delta, and bh[ky_lo + y] per grid
    // row y of the key tile, copied by cp.async (zeros for queries >= L: their
    // Q and G rows are zeros, so p is finite and adds nothing)
    float* tabs = reinterpret_cast<float*>(smem + lay.tabs);
    const int ky_lo = k0 >> kLw, total = (2 * hg - 1) << kLw;
    // this thread's key rows: their kx and grid row y in the tile are fixed,
    // so a query column's toep, bw and table offsets are constants
    int toff[2], woff[2], loff[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int y = kr[r] >> kLw, kx = kr[r] & (kWg - 1);
      toff[r] = (((kNr - 1 - y) << kLw) + 2 * t) * kKs + kx;
      woff[r] = 2 * t * kKs + kx;
      loff[r] = (y + 2) * kTile + 2 * t;
    }
    auto stage_bias = [&](int q0) {
      if (bias.toep != nullptr)
        stage_rows_f32<kLw>(slab, bias.toep, q0 + (hg - kNr - ky_lo) * kWg, plan.slab_rows, kKs,
                            total);
      if (decomp) stage_rows_f32<kLw>(bws, bias.bw, q0, kTile, kKs, L);
    };
    auto fill_table = [&](float* tab, int q0) {  // 16-byte pieces (L is a multiple of 8)
      for (int i = threadIdx.x; i < (decomp ? kNr + 2 : 2) * 16; i += kThreads) {
        const int y = i >> 4, qi = q0 + 4 * (i & 15);
        const float* src = y == 0   ? lse + bhead * L
                           : y == 1 ? delta + bhead * L
                                    : bias.bh + static_cast<size_t>(ky_lo + y - 2) * L;
        const bool valid = qi < L && ky_lo + y - 2 < hg;
        cp_async_16(tab + 4 * i, valid ? src + qi : lse, valid);
      }
    };
    fill_table(tabs, 0);
    stage_bias(0);
    cp_async_commit();
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * kTile, cur = it & 1;
      unsigned char* qc = qs + cur * KT;
      unsigned char* gc = gs + cur * KT;
      if (it + 1 < n_tiles) {
        load_tile(qs + (cur ^ 1) * KT, q + base, q0 + kTile, L, row_stride);
        load_tile(gs + (cur ^ 1) * KT, g + base, q0 + kTile, L, row_stride);
        fill_table(tabs + (cur ^ 1) * kTab, q0 + kTile);
      }
      cp_async_commit();
      cp_async_wait_prev();
      fence_async_shared();
      __syncthreads();
      const float* tab = tabs + cur * kTab;
      product_nt<T>(s, ks, qc);  // s^T, while the bias is read
      float bv[8][4];  // toep + bw, less the query's lse less bh
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 l = *reinterpret_cast<const float2*>(tab + 2 * t + 8 * j);
          const float2 y = decomp ? *reinterpret_cast<const float2*>(tab + loff[r] + 8 * j)
                                  : make_float2(0.f, 0.f);
          const float lc[2] = {l.x - y.x, l.y - y.y};  // lse less bh
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float x = 0.f;
            if (bias.toep != nullptr) x = slab[toff[r] + (8 * j + c) * kKs];
            if (decomp) x += bws[woff[r] + (8 * j + c) * kKs];
            bv[j][2 * r + c] = x - lc[c];
          }
        }
      product_wait(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = __expf(fmaf(s[j][e], scaling, bv[j][e]));
          s[j][e] = keys[e >> 1] < L ? p : 0.f;
        }
      uint32_t pa[4][4];  // read by the wgmma until product_wait
      pack_a<T>(pa, s);
      product_nn<T>(dv_acc, pa, gc);  // dv += round(p)^T g
      product_nt<T>(dp, vs, gc);      // dp^T = v g^T
      if (it + 1 < n_tiles) {  // the bias buffers are read: refill them for the next q tile
        __syncthreads();
        stage_bias(q0 + kTile);
        cp_async_commit();
      }
      wgmma_wait_all();
      fence_acc(dv_acc);
      fence_acc(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d = *reinterpret_cast<const float2*>(tab + kTile + 2 * t + 8 * j);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          dp[j][2 * r] = s[j][2 * r] * (dp[j][2 * r] - d.x);  // ds^T
          dp[j][2 * r + 1] = s[j][2 * r + 1] * (dp[j][2 * r + 1] - d.y);
        }
      }
      uint32_t dsa[4][4];
      pack_a<T>(dsa, dp);
      product_nn<T>(dk_acc, dsa, qc);  // dk += round(ds)^T q
      product_wait(dk_acc);
      __syncthreads();  // tile it is consumed before its buffers are refilled
    }
  } else {
    float* stage = reinterpret_cast<float*>(smem + lay.stage);  // fp32 only
    QueryTable* tabs = reinterpret_cast<QueryTable*>(smem + lay.tabs);
    cp_async_commit();
    int ky_unused;
    const Pos kp[2] = {key_pos(keys[0], bias, &ky_unused), key_pos(keys[1], bias, &ky_unused)};
    auto fill_queries = [&](QueryTable& tab, int q0) {
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        const Pos p = query_pos(qi, bias);
        tab.t[threadIdx.x] = p.t;
        tab.h[threadIdx.x] = p.h;
        tab.w[threadIdx.x] = p.w;
        const bool ok = qi < L;  // a query >= L gets p = 0
        tab.lse[threadIdx.x] = ok ? lse[bhead * L + qi] : INFINITY;
        tab.delta[threadIdx.x] = ok ? delta[bhead * L + qi] : 0.f;
      }
    };
    fill_queries(tabs[0], 0);
    float bv[8][4];
    float* my_stage = stage + warp * 16 * kDsStride;
    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * kTile, cur = it & 1;
      unsigned char* qc = qs + cur * KT;
      unsigned char* gc = gs + cur * KT;
      if (it + 1 < n_tiles) {
        load_tile(qs + (cur ^ 1) * KT, q + base, q0 + kTile, L, row_stride);
        load_tile(gs + (cur ^ 1) * KT, g + base, q0 + kTile, L, row_stride);
        fill_queries(tabs[cur ^ 1], q0 + kTile);
      }
      cp_async_commit();
      cp_async_wait_prev();
      fence_async_shared();
      __syncthreads();
      const QueryTable& tab = tabs[cur];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          bv[j][c] = bias_at(bias, kp[c >> 1], tab.t[col], tab.h[col], tab.w[col]);
        }
      if constexpr (kTwoByte<T>) {
        product_nt<T>(s, ks, qc);  // s^T
        product_wait(s);
      } else {
        tile_nt<8>(s, tile_row<T>(ks, warp * 16), tile_row<T>(qc, 0));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          s[j][c] = keys[c >> 1] < L ? __expf(s[j][c] * scaling + bv[j][c] - tab.lse[col]) : 0.f;
        }
      if constexpr (kTwoByte<T>) {
        uint32_t pa[4][4];
        pack_a<T>(pa, s);
        product_nn<T>(dv_acc, pa, gc);  // dv += round(p)^T g
        product_nt<T>(dp, vs, gc);      // dp^T = v g^T
        wgmma_wait_all();
        fence_acc(dv_acc);
        fence_acc(dp);
      } else {
        stage_rows(my_stage, s);
        __syncwarp();
        tile_nn(dv_acc, my_stage, tile_row<T>(gc, 0));
        tile_nt<8>(dp, tile_row<T>(vs, warp * 16), tile_row<T>(gc, 0));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = 8 * j + 2 * t + (c & 1);
          dp[j][c] = s[j][c] * (dp[j][c] - tab.delta[col]);  // ds^T
        }
      if constexpr (kTwoByte<T>) {  // dk += round(ds)^T q
        uint32_t dsa[4][4];
        pack_a<T>(dsa, dp);
        product_nn<T>(dk_acc, dsa, qc);
        product_wait(dk_acc);
      } else {
        __syncwarp();  // p is consumed
        stage_rows(my_stage, dp);
        __syncwarp();
        tile_nn(dk_acc, my_stage, tile_row<T>(qc, 0));
      }
      __syncthreads();  // tile it is consumed before its buffers are refilled
    }
  }
  store_rows(dk + base, dk_acc, keys, L, row_stride, scaling);
  store_rows(dv + base, dv_acc, keys, L, row_stride, 1.f);
}

// ---------------------------------------------------------------------------
// dtoep.  Block (dy, h, slab tile); the block's output is the slab
// dtoep[h, dy, qx0 : qx0 + 64, kx0 : kx0 + 64].  An item is one (b, qy):
// its queries are grid row qy (columns qx0 + [0, kCols)), its keys grid row
// ky = qy - (dy - hg + 1) (columns kx0 + [0, kCols)).  A 64-row tile holds
// 64 / kCols items; the warps of one item hold kCols / 16 chunks of 16 query
// columns each.  With the decomposed bias, each item's bw rows (its queries'
// kx0 + [0, kCols)) are staged with its Q and G rows.  2-byte 64-wide items
// run on wgmma, narrower ones on mma.sync.
// ---------------------------------------------------------------------------

struct ItemTable {
  int qrow[kTile], krow[kTile], bw_row[kTile];
  float lse[kTile], delta[kTile], bh[kTile];
};

// The dtoep pass runs 64-wide 2-byte items on wgmma, narrower ones on mma.sync.
template <typename T, int kCols>
constexpr bool kDtoepWgmma = kTwoByte<T> && kCols == 64;
// Floats per staged bw row: = 8 mod 16 for conflict-free float2 reads; 16 at
// kCols = 16 (2-way conflicts on 4 reads an item) so that the 16 x 16
// windows' pass fits three blocks per SM.
template <int kCols>
constexpr int kBwStride = kCols == 16 ? 16 : kCols + 8;

// Byte offsets into the dtoep pass's dynamic shared memory.
struct DtoepSmem {
  int tiles, tabs, bws, total;
};

template <typename T, int kCols>
__host__ __device__ inline DtoepSmem dtoep_layout(bool decomp) {
  DtoepSmem s;
  s.tiles = 0;  // [2 buffers][q, g, k, v]
  s.tabs = 8 * kTileBytes<T>;
  s.bws = s.tabs + 2 * static_cast<int>(sizeof(ItemTable));  // [2][64][kBwStride] floats
  s.total = s.bws + (decomp ? 2 * kTile * kBwStride<kCols> * 4 : 0) +
            (kDtoepWgmma<T, kCols> ? kAlign : 0);
  return s;
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
det_bwd_dtoep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ toep,
              const float* __restrict__ bh, const float* __restrict__ bw,
              float* __restrict__ dtoep, int B, int L, int H, int hg, int wg, float scaling) {
  constexpr int KT = kTileBytes<T>;
  constexpr int kN8 = kCols / 8;
  constexpr int kChunks = kCols / 16;  // warps per item
  constexpr int kItems = 4 / kChunks;  // items per 64-row tile
  constexpr int kBs = kBwStride<kCols>;
  constexpr bool kWgmma = kDtoepWgmma<T, kCols>;
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = align_smem<kWgmma>(dyn_smem);
  const DtoepSmem lay = dtoep_layout<T, kCols>(bh != nullptr);
  unsigned char* tiles = smem + lay.tiles;
  ItemTable* tabs = reinterpret_cast<ItemTable*>(smem + lay.tabs);
  float* bws = reinterpret_cast<float*>(smem + lay.bws);

  const int dy = blockIdx.x, h = blockIdx.y;
  const int n_xt = (wg + kTile - 1) / kTile;
  const int qx0 = (blockIdx.z / n_xt) * kTile, kx0 = (blockIdx.z % n_xt) * kTile;
  const int dyr = dy - (hg - 1);  // qy - ky
  const int qy_lo = max(0, dyr), n_qy = min(hg, hg + dyr) - qy_lo;
  const int n_items = B * n_qy, n_iter = (n_items + kItems - 1) / kItems;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int slot = warp / kChunks, chunk = warp % kChunks;
  const int row_stride = H * kHeadDim;
  const size_t head = static_cast<size_t>(h) * kHeadDim;
  const float* slab = toep + (static_cast<size_t>(h) * (2 * hg - 1) + dy) * wg * wg;

  // per element of the thread's accumulator: its slab position is fixed
  float tv[kN8][4], acc[kN8][4], s[kN8][4], dp[kN8][4];
  int kx_of[kN8][2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) row_ok[r] = qx0 + chunk * 16 + gr + 8 * r < wg;
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
#pragma unroll
    for (int c = 0; c < 2; ++c) kx_of[j][c] = kx0 + 8 * j + 2 * t + c;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int qx = qx0 + chunk * 16 + gr + 8 * (c >> 1), kx = kx_of[j][c & 1];
      tv[j][c] = qx < wg && kx < wg ? __ldg(slab + qx * wg + kx) : 0.f;
      acc[j][c] = 0.f;
    }
  }

  // The item table of iteration `iter`: row indices by arithmetic, the
  // queries' lse, delta and bh by cp.async with the item's rows (zeros for a
  // row past the items or the grid: its Q and G rows are zeros too, so its p
  // is finite and its ds 0).
  auto fill_items = [&](ItemTable& tab, int iter) {
    const int side = threadIdx.x >> 6, r = threadIdx.x & 63;  // 0: queries, 1: keys
    const int item = iter * kItems + r / kCols, x = (side ? kx0 : qx0) + r % kCols;
    const bool valid = item < n_items && x < wg;
    int row = -1, bw_row = 0;
    size_t at = 0, bh_at = 0;
    if (valid) {
      const int bb = item / n_qy, qy = qy_lo + item - bb * n_qy, ky = qy - dyr;
      const size_t bhead = static_cast<size_t>(bb) * H + h;
      const int tok = (side ? ky : qy) * wg + x;
      row = bb * L + tok;
      at = bhead * L + tok;
      bh_at = (bhead * hg + ky) * L + tok;
      bw_row = static_cast<int>(at * wg);
    }
    if (side) {
      tab.krow[r] = row;
    } else {
      tab.qrow[r] = row;
      tab.bw_row[r] = bw_row;
      cp_async_4(tab.lse + r, lse + at, valid);
      cp_async_4(tab.delta + r, delta + at, valid);
      if (bh != nullptr) cp_async_4(tab.bh + r, bh + bh_at, valid);
    }
  };
  auto load_items = [&](int buf) {
    unsigned char* base = tiles + buf * 4 * KT;
    const ItemTable& tab = tabs[buf];
    load_rows(base, q + head, tab.qrow, row_stride);
    load_rows(base + KT, g + head, tab.qrow, row_stride);
    load_rows(base + 2 * KT, k + head, tab.krow, row_stride);
    load_rows(base + 3 * KT, v + head, tab.krow, row_stride);
    if (bh == nullptr) return;
    float* dst = bws + buf * kTile * kBs;  // row r: bw[query r, kx0 + [0, kCols)], zeros beyond wg
    if ((wg & 3) == 0) {
      for (int i = threadIdx.x; i < kTile * kCols / 4; i += kThreads) {
        const int r = i / (kCols / 4), c = i % (kCols / 4), x = kx0 + 4 * c;
        const bool valid = tab.qrow[r] >= 0 && x < wg;
        cp_async_16(dst + r * kBs + 4 * c, valid ? bw + tab.bw_row[r] + x : bw, valid);
      }
    } else {
      for (int i = threadIdx.x; i < kTile * kCols; i += kThreads) {
        const int r = i / kCols, c = i % kCols, x = kx0 + c;
        const bool valid = tab.qrow[r] >= 0 && x < wg;
        cp_async_4(dst + r * kBs + c, valid ? bw + tab.bw_row[r] + x : bw, valid);
      }
    }
  };

  fill_items(tabs[0], 0);
  __syncthreads();
  load_items(0);
  cp_async_commit();
  for (int it = 0; it < n_iter; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_iter) {
      fill_items(tabs[cur ^ 1], it + 1);
      __syncthreads();  // the table is written before the copies read it
      load_items(cur ^ 1);
    }
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    unsigned char* base = tiles + cur * 4 * KT;
    const ItemTable& tab = tabs[cur];
    const float* bwc = bws + cur * kTile * kBs;
    if constexpr (kWgmma) {  // s = q k^T and dp = g v^T, while the bias is read
      product_nt<T>(s, base, base + 2 * KT);
      product_nt<T>(dp, base + KT, base + 3 * KT);
    }
    float xb[kN8][4], drow[2];  // each score's bias less its row's lse; each row's delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + gr + 8 * r;
      const float l = tab.lse[row];
      drow[r] = tab.delta[row];
      const float y = bh != nullptr ? tab.bh[row] : 0.f;
#pragma unroll
      for (int j = 0; j < kN8; ++j) {
        const float2 w = bh != nullptr
                             ? *reinterpret_cast<const float2*>(bwc + row * kBs + 8 * j + 2 * t)
                             : make_float2(0.f, 0.f);
        xb[j][2 * r] = tv[j][2 * r] + (y + w.x) - l;
        xb[j][2 * r + 1] = tv[j][2 * r + 1] + (y + w.y) - l;
      }
    }
    if constexpr (kWgmma) {
      wgmma_wait_all();
      fence_acc(s);
      fence_acc(dp);
    } else {
      tile_nt<kN8>(s, tile_row<T>(base, warp * 16), tile_row<T>(base + 2 * KT, slot * kCols));
      tile_nt<kN8>(dp, tile_row<T>(base + KT, warp * 16), tile_row<T>(base + 3 * KT, slot * kCols));
    }
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = row_ok[r] && kx_of[j][e & 1] < wg
                            ? __expf(fmaf(s[j][e], scaling, xb[j][e]))
                            : 0.f;
        acc[j][e] += p * (dp[j][e] - drow[r]);
      }
    __syncthreads();  // buffer cur is consumed before it is refilled
  }

  // the warps of one chunk add their sums in slot order
  float* red = reinterpret_cast<float*>(smem);  // [warp][16][kCols + 1]
  constexpr int kRed = 16 * (kCols + 1);
  if (kItems > 1) {
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        red[warp * kRed + (gr + 8 * (c >> 1)) * (kCols + 1) + 8 * j + 2 * t + (c & 1)] = acc[j][c];
    __syncthreads();
    if (slot == 0) {
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int off = (gr + 8 * (c >> 1)) * (kCols + 1) + 8 * j + 2 * t + (c & 1);
          float sum = red[chunk * kRed + off];
          for (int sl = 1; sl < kItems; ++sl) sum += red[(sl * kChunks + chunk) * kRed + off];
          acc[j][c] = sum;
        }
    }
  }
  if (slot == 0) {
    float* out = dtoep + (static_cast<size_t>(h) * (2 * hg - 1) + dy) * wg * wg;
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int qx = qx0 + chunk * 16 + gr + 8 * (c >> 1), kx = kx_of[j][c & 1];
        if (qx < wg && kx < wg) out[qx * wg + kx] = acc[j][c];
      }
  }
}

// Launches a kernel with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, int smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

// The operands of one call.
struct Operands {
  const void *q, *k, *v, *g;
  const float *lse, *delta, *toep, *bh, *bw;
  void *dq, *dk, *dv;
  float *dtoep, *dbh, *dbw;
  int batch, L, heads, hg, wg;
  float scaling;
  int passes;
};

// The caller's shared memory per launch (2-byte types only): it must equal this
// file's layouts, or the plan and the kernels disagree.
struct SmemCheck {
  int dq, dkv, dtoep;
};

template <typename T, int kCols>
cudaError_t launch_dtoep(const Operands& a, const SmemCheck& want, cudaStream_t s) {
  const int n_xt = (a.wg + kTile - 1) / kTile;
  const int smem = dtoep_layout<T, kCols>(a.bh != nullptr).total;
  if (kTwoByte<T> && smem != want.dtoep) return cudaErrorInvalidValue;
  return launch(det_bwd_dtoep<T, kCols>, dim3(2 * a.hg - 1, a.heads, n_xt * n_xt), smem, s,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.g), a.lse, a.delta, a.toep,
                a.bh, a.bw, a.dtoep, a.batch, a.L, a.heads, a.hg, a.wg, a.scaling);
}

// The passes in `a.passes` with the kernels of one plan branch.
template <typename T, int kMode, int kLw>
cudaError_t run(const Operands& a, const Plan& plan, const SmemCheck& want, cudaStream_t s) {
  const T* qt = static_cast<const T*>(a.q);
  const T* kt = static_cast<const T*>(a.k);
  const T* vt = static_cast<const T*>(a.v);
  const T* gt = static_cast<const T*>(a.g);
  const bool toep = a.toep != nullptr, decomp = a.bh != nullptr;
  const dim3 grid(a.batch, (a.L + kTile - 1) / kTile, a.heads);
  cudaError_t err = cudaSuccess;
  if (a.passes & 1) {
    const int smem = dq_layout<T>(kMode, toep, decomp, a.wg, plan).total;
    if (kTwoByte<T> && smem != want.dq) return cudaErrorInvalidValue;
    err = launch(det_bwd_dq<T, kMode, kLw>, grid, smem, s, qt, kt, vt, gt, a.lse, a.delta, a.toep,
                 a.bh, a.bw, static_cast<T*>(a.dq), a.dbh, a.dbw, a.L, a.heads, a.hg, a.wg,
                 a.scaling, plan);
    if (err != cudaSuccess) return err;
  }
  if (a.dtoep != nullptr && (a.passes & 2)) {
    err = a.wg <= 16   ? launch_dtoep<T, 16>(a, want, s)
          : a.wg <= 32 ? launch_dtoep<T, 32>(a, want, s)
                       : launch_dtoep<T, 64>(a, want, s);
    if (err != cudaSuccess) return err;
  }
  if (a.passes & 4) {
    const int smem = dkv_layout<T>(kMode, toep, decomp, plan).total;
    if (kTwoByte<T> && smem != want.dkv) return cudaErrorInvalidValue;
    err = launch(det_bwd_dkv<T, kMode, kLw>, grid, smem, s, qt, kt, vt, gt, a.lse, a.delta,
                 a.toep, a.bh, a.bw, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.L, a.heads,
                 a.hg, a.wg, a.scaling, plan);
  }
  return err;
}

// The 2-byte kernels of the plan's branch: the gather, or the staged bias at
// wg = 8, 16, 32 or 64.
template <typename T>
cudaError_t run_2byte(const Operands& a, int mode, const SmemCheck& want, cudaStream_t s) {
  if (mode == kGather) return run<T, kGather, 0>(a, make_plan(kGather, a.wg), want, s);
  if (mode != kSlab) return cudaErrorInvalidValue;
  const Plan plan = make_plan(kSlab, a.wg);
  switch (a.wg) {
    case 8: return run<T, kSlab, 3>(a, plan, want, s);
    case 16: return run<T, kSlab, 4>(a, plan, want, s);
    case 32: return run<T, kSlab, 5>(a, plan, want, s);
    case 64: return run<T, kSlab, 6>(a, plan, want, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError() (0 on
// success).  q, k, v, g (the output's cotangent), dq, dk, dv: (batch, L,
// heads * 64) of the dtype `dtype` names (0 fp32, 1 bf16, 2 fp16;
// ops/build.py: DTYPE_CODES), L = hg * wg.  lse and delta
// (rowsum(g * out)): fp32 (batch, heads, L).  toep and dtoep: fp32
// (heads, 2hg-1, wg, wg), or toep null (then dtoep is not written), or dtoep
// null (not wanted).  bh, dbh: fp32 (batch, heads, hg, L); bw, dbw: fp32
// (batch, heads, L, wg); all four or none.  passes: a bit mask of the kernels
// to launch, 1 pass 1 (dq, dbh, dbw), 2 dtoep, 4 pass 2 (dk, dv); 7 is the
// whole backward (the others time one pass alone).  mode and dq_smem ..
// dtoep_smem: the 2-byte kernels' plan for this grid and these biases
// (ops/det_attention.py:bwd_plan: kGather or kSlab, and each launch's
// shared memory, checked against this file's layouts); the fp32 kernels
// gather and ignore it.
extern "C" int one_peace_det_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* lse,
    const void* delta, const void* toep, const void* bh, const void* bw, void* dq, void* dk,
    void* dv, void* dtoep, void* dbh, void* dbw, int batch, int seq_len, int heads, int hg,
    int wg, float scaling, int dtype, int passes, int mode, int dq_smem, int dkv_smem,
    int dtoep_smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(toep);
  const Operands a{q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                   tp, static_cast<const float*>(bh), static_cast<const float*>(bw), dq, dk, dv,
                   tp != nullptr ? static_cast<float*>(dtoep) : nullptr, static_cast<float*>(dbh),
                   static_cast<float*>(dbw), batch, seq_len, heads, hg, wg, scaling, passes};
  const SmemCheck want{dq_smem, dkv_smem, dtoep_smem};
  switch (dtype) {
    case 0: err = run<float, kGather, 0>(a, make_plan(kGather, wg), want, s); break;
    case 1: err = run_2byte<bf16>(a, mode, want, s); break;
    case 2: err = run_2byte<__half>(a, mode, want, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" const char* one_peace_det_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
