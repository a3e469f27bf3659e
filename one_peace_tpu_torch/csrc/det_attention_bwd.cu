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
// where round() is to the inputs' dtype (bf16 or fp32), exactly where the TPU
// kernels and det_attention_bwd_plain round; dq/dk/dv have the inputs' dtype,
// the bias cotangents are fp32.  Neither (B, H, L, L) p nor ds exists.
//
// What bounds it on an H100 (1.5B trunk, H=24, Dh=64, B=2 at 1024 px):
//   global layer, L = 4096: s and dp recomputed, dv, dq, dk: 10 * B*H*L^2*64
//     = 5.2e11 operations (0.52 ms at 989 TFLOP/s); the bytes (q, k, v, g,
//     out, dq, dk, dv in bf16, toep/dtoep, bh/dbh, bw/dbw fp32) are ~0.3 GB
//     (0.09 ms).  So the tensor cores set the bound, and every score also
//     gathers three bias values and takes an exp, as in the forward.
//   windowed layer, B' = 32 windows of L = 256: 3.2e10 operations (0.03 ms)
//     against ~0.2 GB (0.06 ms): bytes.
//
// What this design does about it, and where each reduction happens:
//   - Three kernels on one stream, each block 4 warps, mma.sync m16n8k16 with
//     fp32 accumulation for bf16, and the same tile code on CUDA-core FMA for
//     fp32 (the accumulator layout is kept, so the bias gathers, masks and
//     reductions are shared).
//   - det_bwd_dq (pass 1): one block per (batch, 64-row q tile, head) walks
//     the 64-key tiles (K, V and a table of the keys' bias offsets
//     double-buffered with cp.async, as the forward); dq sums in registers.
//     With the decomposed bias, ds goes to shared memory after each tile;
//     dbw[q, kx] is summed there by the thread that owns (q, kx) for the
//     whole walk, and dbh[ky, q], owned by this block alone, is added to in
//     device memory in tile order.  No atomics: deterministic.
//   - det_bwd_dkv (pass 2): one block per (batch, 64-key tile, head) walks
//     the q tiles from the saved LSE, as csrc/flash_attention_bwd.cu does.
//   - det_bwd_dtoep (the rest of pass 1's work): the TPU kernel keeps a
//     per-(b, h, q tile) dtoep slab in VMEM and folds the partials in XLA.
//     Here a 64-row q tile at wg = 64 is one grid row, so each (q tile, k
//     tile) pair is a whole wg x wg slab of one dy: per-q-tile partials would
//     be the whole of ds in fp32, 3.2 GB at B=2.  Instead one block per
//     (dy, head) owns its output slab and recomputes s and dp for the tile
//     pairs of that dy only (one grid row of queries against one of keys, for
//     every b and every qy), summing ds in registers in a fixed order: no
//     scratch at all, at the price of recomputing s and dp once more
//     (2/5 of the operations above).  Grid rows narrower than 64 are packed
//     2 or 4 to a 64-row tile (16 x 16 or 32 x 32 products per warp), and
//     the warps holding the same slab columns add their sums in shared
//     memory in a fixed order.
//   - Rows and keys >= L (a ragged last tile) are zero-filled on load and
//     get p = 0, so they add nothing; their results are not stored.
// Not done yet: wgmma, TMA, s and dp shared between pass 1 and the dtoep pass.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;              // rows of a q tile, keys of a key tile
constexpr int kThreads = 128;          // 4 warps, 16 rows each
constexpr int kDsStride = kTile + 1;   // fp32 staging rows: no bank conflicts

using bf16 = __nv_bfloat16;

template <typename T> struct Elem;
template <> struct Elem<bf16> {
  static constexpr int kStride = kHeadDim + 8;  // smem row stride in elements
  static constexpr int kPerChunk = 8;           // elements per 16-byte copy
};
template <> struct Elem<float> {
  static constexpr int kStride = kHeadDim + 4;
  static constexpr int kPerChunk = 4;
};
template <typename T>
constexpr int kTileBytes = kTile * Elem<T>::kStride * static_cast<int>(sizeof(T));

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// 64 rows of one head into shared memory, asynchronously: row r is row
// rows[r] of the (rows, H*64) tensor `src` (already offset to the head), or
// zeros when rows[r] < 0.
template <typename T>
__device__ __forceinline__ void load_rows_async(T* dst, const T* src, const int* rows,
                                                int row_stride) {
  constexpr int kChunks = kHeadDim / Elem<T>::kPerChunk;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = rows[r];
    cp_async_16(dst + r * Elem<T>::kStride + c * Elem<T>::kPerChunk,
                src + static_cast<size_t>(row < 0 ? 0 : row) * row_stride + c * Elem<T>::kPerChunk,
                row >= 0);
  }
}

// Rows [row0, row0 + 64) of one head; rows >= L are zeros.
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int row0, int L,
                                                int row_stride) {
  constexpr int kChunks = kHeadDim / Elem<T>::kPerChunk;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const bool valid = row0 + r < L;
    cp_async_16(dst + r * Elem<T>::kStride + c * Elem<T>::kPerChunk,
                src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride +
                    c * Elem<T>::kPerChunk,
                valid);
  }
}

// ---------------------------------------------------------------------------
// Tile products in the m16n8k16 accumulator layout: a warp's acc[j][c] is
// row g + 8 * (c >> 1) of its 16 rows and column 8j + 2t + (c & 1), with
// g = lane / 4 and t = lane % 4.
// ---------------------------------------------------------------------------

// acc (16 x 8*kN8) = A (16 rows x 64) * B (8*kN8 rows x 64)^T; a and b point
// at the first row of each in shared memory.
template <int kN8>
__device__ __forceinline__ void tile_nt(float acc[][4], const bf16* a, const bf16* b) {
  constexpr int S = Elem<bf16>::kStride;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t af[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p0 = a + g * S + kk * 16 + 2 * t;
    const bf16* p1 = p0 + 8 * S;
    af[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    af[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    af[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    af[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
#pragma unroll
  for (int j = 0; j < kN8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    const bf16* bp = b + (j * 8 + g) * S + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(acc[j], af[kk], *reinterpret_cast<const uint32_t*>(bp + kk * 16),
                *reinterpret_cast<const uint32_t*>(bp + kk * 16 + 8));
  }
}

template <int kN8>
__device__ __forceinline__ void tile_nt(float acc[][4], const float* a, const float* b) {
  constexpr int S = Elem<float>::kStride;
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

// o (16 x 64) += round(x) (16 x 64, the sum index) * tile (64 sum rows x 64):
// bf16 from x in registers (two 8-column accumulator tiles are the A operand
// of one 16-deep step); fp32 from xs, the warp's rows of x staged in shared
// memory by the caller.
__device__ __forceinline__ void tile_nn(float o[8][4], const float x[8][4], const float*,
                                        const bf16* tile) {
  constexpr int S = Elem<bf16>::kStride;
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const bf16* row = tile + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * S;
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + (n + (mi >> 1)) * 8);
      mma_16816(o[n], xa, b[0], b[1]);
      mma_16816(o[n + 1], xa, b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void tile_nn(float o[8][4], const float (*)[4], const float* xs,
                                        const float* tile) {
  constexpr int S = Elem<float>::kStride;
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

// Rows rows[0..1] of a 16 x 64 accumulator, times scale, into a (L, H*64)
// tensor; rows >= L are skipped.
__device__ __forceinline__ void store_rows(bf16* dst, const float acc[8][4], const int rows[2],
                                           int L, int row_stride, float scale) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    bf16* p = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack_bf16(acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
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
// The bias of one (query, key) pair: toep[qpos.t + kpos.t] + bh[kpos.h +
// qpos.h] + bw[qpos.w + kpos.w], from per-query and per-key offsets that are
// computed once per tile (no thread divides by wg in a score loop).
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

// ---------------------------------------------------------------------------
// Pass 1: dq, dbh, dbw.  Block (b, 64-row q tile, h); warp w owns query rows
// [16w, 16w + 16) of the tile.
// ---------------------------------------------------------------------------

template <typename T>
size_t dq_smem_bytes(int wg, bool decomp) {
  return 6 * kTileBytes<T> + sizeof(float) * kTile * kDsStride +
         (decomp ? sizeof(float) * kTile * wg : 0) + 2 * sizeof(PosTable);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
det_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
           const T* __restrict__ g, const float* __restrict__ lse,
           const float* __restrict__ delta, const float* __restrict__ toep,
           const float* __restrict__ bh, const float* __restrict__ bw, T* __restrict__ dq,
           float* __restrict__ dbh, float* __restrict__ dbw, int L, int H, int hg, int wg,
           float scaling) {
  constexpr int S = Elem<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* gs = qs + kTile * S;
  T* ks = gs + kTile * S;  // [2] tiles
  T* vs = ks + 2 * kTile * S;
  float* dss = reinterpret_cast<float*>(vs + 2 * kTile * S);  // ds, 64 x kDsStride
  float* dbw_acc = dss + kTile * kDsStride;                   // [kx][row], with decomp
  PosTable* cols = reinterpret_cast<PosTable*>(dbw_acc + (bh != nullptr ? kTile * wg : 0));

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bhead = static_cast<size_t>(b) * H + h;
  const bool decomp = bh != nullptr;
  const Bias bias{toep != nullptr ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg
                                  : nullptr,
                  decomp ? bh + bhead * hg * L : nullptr,
                  decomp ? bw + bhead * L * wg : nullptr, hg, wg, L};
  float* dbh_b = decomp ? dbh + bhead * hg * L : nullptr;

  load_tile_async(qs, q + base, q0, L, row_stride);
  load_tile_async(gs, g + base, q0, L, row_stride);
  cp_async_commit();
  if (decomp) {  // this block alone owns dbh[:, q0:q0+64] and dbw[q0:q0+64, :]
    for (int i = threadIdx.x; i < hg * kTile; i += kThreads) {
      const int ky = i >> 6, r = i & 63;
      if (q0 + r < L) dbh_b[static_cast<size_t>(ky) * L + q0 + r] = 0.f;
    }
    for (int i = threadIdx.x; i < wg * kTile; i += kThreads) dbw_acc[i] = 0.f;
  }

  const int rows[2] = {q0 + warp * 16 + gr, q0 + warp * 16 + gr + 8};
  const Pos rp[2] = {query_pos(rows[0], bias), query_pos(rows[1], bias)};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // a row >= L gets p = 0
    const bool ok = rows[r] < L;
    lse_r[r] = ok ? lse[bhead * L + rows[r]] : INFINITY;
    delta_r[r] = ok ? delta[bhead * L + rows[r]] : 0.f;
  }

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

  float o[8][4], s[8][4], dp[8][4], bv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

  const int n_tiles = (L + kTile - 1) / kTile;
  load_tile_async(ks, k + base, 0, L, row_stride);
  load_tile_async(vs, v + base, 0, L, row_stride);
  cp_async_commit();
  fill_cols(cols[0], 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async(ks + (cur ^ 1) * kTile * S, k + base, k0 + kTile, L, row_stride);
      load_tile_async(vs + (cur ^ 1) * kTile * S, v + base, k0 + kTile, L, row_stride);
      fill_cols(cols[cur ^ 1], k0 + kTile);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const PosTable& tab = cols[cur];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        bv[j][c] = bias_at(bias, rp[c >> 1], tab.t[col], tab.h[col], tab.w[col]);
      }
    tile_nt<8>(s, qs + warp * 16 * S, ks + cur * kTile * S);
    tile_nt<8>(dp, gs + warp * 16 * S, vs + cur * kTile * S);
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
    if (std::is_same<T, float>::value || decomp) {
      stage_rows(my_ds, s);
      __syncwarp();
    }
    tile_nn(o, s, my_ds, ks + cur * kTile * S);  // dq += round(ds) k
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
  store_rows(dq + base, o, rows, L, row_stride, scaling);
  if (decomp) {
    float* dbw_b = dbw + bhead * L * wg;
    for (int i = threadIdx.x; i < wg * kTile; i += kThreads) {
      const int r = i & 63, kx = i >> 6;
      if (q0 + r < L) dbw_b[static_cast<size_t>(q0 + r) * wg + kx] = dbw_acc[i];
    }
  }
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

template <typename T>
size_t dkv_smem_bytes() {
  return 6 * kTileBytes<T> + sizeof(float) * kTile * kDsStride + 2 * sizeof(QueryTable);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
det_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, const float* __restrict__ toep,
            const float* __restrict__ bh, const float* __restrict__ bw, T* __restrict__ dk,
            T* __restrict__ dv, int L, int H, int hg, int wg, float scaling) {
  constexpr int S = Elem<T>::kStride;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = ks + kTile * S;
  T* qs = vs + kTile * S;  // [2] tiles
  T* gs = qs + 2 * kTile * S;
  float* stage = reinterpret_cast<float*>(gs + 2 * kTile * S);  // fp32 only
  QueryTable* tabs = reinterpret_cast<QueryTable*>(stage + kTile * kDsStride);

  const int b = blockIdx.x, k0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gr = lane >> 2, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bhead = static_cast<size_t>(b) * H + h;
  const bool decomp = bh != nullptr;
  const Bias bias{toep != nullptr ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg
                                  : nullptr,
                  decomp ? bh + bhead * hg * L : nullptr,
                  decomp ? bw + bhead * L * wg : nullptr, hg, wg, L};

  load_tile_async(ks, k + base, k0, L, row_stride);
  load_tile_async(vs, v + base, k0, L, row_stride);
  load_tile_async(qs, q + base, 0, L, row_stride);
  load_tile_async(gs, g + base, 0, L, row_stride);
  cp_async_commit();

  const int keys[2] = {k0 + warp * 16 + gr, k0 + warp * 16 + gr + 8};
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

  float dk_acc[8][4], dv_acc[8][4], s[8][4], dp[8][4], bv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;
  float* my_stage = stage + warp * 16 * kDsStride;

  const int n_tiles = (L + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * kTile, cur = it & 1;
    T* qc = qs + cur * kTile * S;
    T* gc = gs + cur * kTile * S;
    if (it + 1 < n_tiles) {
      load_tile_async(qs + (cur ^ 1) * kTile * S, q + base, q0 + kTile, L, row_stride);
      load_tile_async(gs + (cur ^ 1) * kTile * S, g + base, q0 + kTile, L, row_stride);
      fill_queries(tabs[cur ^ 1], q0 + kTile);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const QueryTable& tab = tabs[cur];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        bv[j][c] = bias_at(bias, kp[c >> 1], tab.t[col], tab.h[col], tab.w[col]);
      }
    tile_nt<8>(s, ks + warp * 16 * S, qc);  // s^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        s[j][c] = keys[c >> 1] < L ? __expf(s[j][c] * scaling + bv[j][c] - tab.lse[col]) : 0.f;
      }
    if (std::is_same<T, float>::value) {
      stage_rows(my_stage, s);
      __syncwarp();
    }
    tile_nn(dv_acc, s, my_stage, gc);  // dv += round(p)^T g
    tile_nt<8>(dp, vs + warp * 16 * S, gc);  // dp^T = v g^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 8 * j + 2 * t + (c & 1);
        dp[j][c] = s[j][c] * (dp[j][c] - tab.delta[col]);  // ds^T
      }
    if (std::is_same<T, float>::value) {
      __syncwarp();  // p is consumed
      stage_rows(my_stage, dp);
      __syncwarp();
    }
    tile_nn(dk_acc, dp, my_stage, qc);  // dk += round(ds)^T q
    __syncthreads();  // tile it is consumed before its buffers are refilled
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
// columns each.
// ---------------------------------------------------------------------------

struct ItemTable {
  int qrow[kTile], krow[kTile], bw_row[kTile];
  float lse[kTile], delta[kTile], bh[kTile];
};

template <typename T>
size_t dtoep_smem_bytes() {
  return 8 * kTileBytes<T> + 2 * sizeof(ItemTable);
}

template <typename T, int kCols>
__global__ void __launch_bounds__(kThreads)
det_bwd_dtoep(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ g, const float* __restrict__ lse,
              const float* __restrict__ delta, const float* __restrict__ toep,
              const float* __restrict__ bh, const float* __restrict__ bw,
              float* __restrict__ dtoep, int B, int L, int H, int hg, int wg, float scaling) {
  constexpr int S = Elem<T>::kStride;
  constexpr int kN8 = kCols / 8;
  constexpr int kChunks = kCols / 16;  // warps per item
  constexpr int kItems = 4 / kChunks;  // items per 64-row tile
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);  // [2 buffers][q, g, k, v]
  ItemTable* tabs = reinterpret_cast<ItemTable*>(tiles + 8 * kTile * S);

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

  auto fill_items = [&](ItemTable& tab, int iter) {
    const int side = threadIdx.x >> 6, r = threadIdx.x & 63;  // 0: queries, 1: keys
    const int item = iter * kItems + r / kCols, x = (side ? kx0 : qx0) + r % kCols;
    int row = -1, bw_row = 0;
    float l = INFINITY, d = 0.f, bhv = 0.f;
    if (item < n_items && x < wg) {
      const int bb = item / n_qy, qy = qy_lo + item - bb * n_qy, ky = qy - dyr;
      const size_t bhead = static_cast<size_t>(bb) * H + h;
      const int tok = (side ? ky : qy) * wg + x;
      row = bb * L + tok;
      if (!side) {
        l = lse[bhead * L + tok];
        d = delta[bhead * L + tok];
        if (bh != nullptr) {
          bhv = bh[(bhead * hg + ky) * L + tok];
          bw_row = static_cast<int>((bhead * L + tok) * wg);
        }
      }
    }
    if (side) {
      tab.krow[r] = row;
    } else {
      tab.qrow[r] = row;
      tab.lse[r] = l;
      tab.delta[r] = d;
      tab.bh[r] = bhv;
      tab.bw_row[r] = bw_row;
    }
  };
  auto load_items = [&](int buf) {
    T* base = tiles + buf * 4 * kTile * S;
    const ItemTable& tab = tabs[buf];
    load_rows_async(base, q + head, tab.qrow, row_stride);
    load_rows_async(base + kTile * S, g + head, tab.qrow, row_stride);
    load_rows_async(base + 2 * kTile * S, k + head, tab.krow, row_stride);
    load_rows_async(base + 3 * kTile * S, v + head, tab.krow, row_stride);
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
    __syncthreads();
    const T* base = tiles + cur * 4 * kTile * S;
    const ItemTable& tab = tabs[cur];
    tile_nt<kN8>(s, base + warp * 16 * S, base + 2 * kTile * S + slot * kCols * S);
    tile_nt<kN8>(dp, base + kTile * S + warp * 16 * S, base + 3 * kTile * S + slot * kCols * S);
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = warp * 16 + gr + 8 * (c >> 1);
        const int kx = min(kx_of[j][c & 1], wg - 1);
        float x = s[j][c] * scaling + tv[j][c];
        if (bh != nullptr) x += tab.bh[row] + __ldg(bw + tab.bw_row[row] + kx);
        const float p = row_ok[c >> 1] && kx_of[j][c & 1] < wg ? __expf(x - tab.lse[row]) : 0.f;
        acc[j][c] += p * (dp[j][c] - tab.delta[row]);
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
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* q, const void* k, const void* v, const void* g, const float* lse,
                const float* delta, const float* toep, const float* bh, const float* bw,
                void* dq, void* dk, void* dv, float* dtoep, float* dbh, float* dbw, int batch,
                int L, int heads, int hg, int wg, float scaling, int passes, cudaStream_t s) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(g);
  const dim3 grid(batch, (L + kTile - 1) / kTile, heads);
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = launch(det_bwd_dq<T>, grid, dq_smem_bytes<T>(wg, bh != nullptr), s, qt, kt, vt, gt,
                 lse, delta, toep, bh, bw, static_cast<T*>(dq), dbh, dbw, L, heads, hg, wg,
                 scaling);
    if (err != cudaSuccess) return err;
  }
  if (dtoep != nullptr && (passes & 2)) {
    const int n_xt = (wg + kTile - 1) / kTile;
    const dim3 tgrid(2 * hg - 1, heads, n_xt * n_xt);
    const size_t smem = dtoep_smem_bytes<T>();
    if (wg <= 16)
      err = launch(det_bwd_dtoep<T, 16>, tgrid, smem, s, qt, kt, vt, gt, lse, delta, toep, bh,
                   bw, dtoep, batch, L, heads, hg, wg, scaling);
    else if (wg <= 32)
      err = launch(det_bwd_dtoep<T, 32>, tgrid, smem, s, qt, kt, vt, gt, lse, delta, toep, bh,
                   bw, dtoep, batch, L, heads, hg, wg, scaling);
    else
      err = launch(det_bwd_dtoep<T, 64>, tgrid, smem, s, qt, kt, vt, gt, lse, delta, toep, bh,
                   bw, dtoep, batch, L, heads, hg, wg, scaling);
    if (err != cudaSuccess) return err;
  }
  if (passes & 4)
    err = launch(det_bwd_dkv<T>, grid, dkv_smem_bytes<T>(), s, qt, kt, vt, gt, lse, delta, toep,
                 bh, bw, static_cast<T*>(dk), static_cast<T*>(dv), L, heads, hg, wg, scaling);
  return err;
}

}  // namespace

// Launches the three kernels on `stream` and returns cudaGetLastError() (0 on
// success).  q, k, v, g (the output's cotangent), dq, dk, dv: (batch, L,
// heads * 64), bf16 when is_bf16 else fp32, L = hg * wg.  lse and delta
// (rowsum(g * out)): fp32 (batch, heads, L).  toep and dtoep: fp32
// (heads, 2hg-1, wg, wg), or toep null (then dtoep is not written), or dtoep
// null (not wanted).  bh, dbh: fp32 (batch, heads, hg, L); bw, dbw: fp32
// (batch, heads, L, wg); all four or none.  passes: a bit mask of the kernels
// to launch, 1 pass 1 (dq, dbh, dbw), 2 dtoep, 4 pass 2 (dk, dv); 7 is the
// whole backward (the others time one pass alone).
extern "C" int one_peace_det_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* lse,
    const void* delta, const void* toep, const void* bh, const void* bw, void* dq, void* dk,
    void* dv, void* dtoep, void* dbh, void* dbw, int batch, int seq_len, int heads, int hg,
    int wg, float scaling, int is_bf16, int passes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(toep);
  float* dtp = tp != nullptr ? static_cast<float*>(dtoep) : nullptr;
  auto args = [&](auto tag) {
    using T = decltype(tag);
    return run<T>(q, k, v, g, static_cast<const float*>(lse), static_cast<const float*>(delta),
                  tp, static_cast<const float*>(bh), static_cast<const float*>(bw), dq, dk, dv,
                  dtp, static_cast<float*>(dbh), static_cast<float*>(dbw), batch, seq_len, heads,
                  hg, wg, scaling, passes, s);
  };
  err = is_bf16 ? args(bf16()) : args(0.f);
  return static_cast<int>(err);
}

extern "C" const char* one_peace_det_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
