// Detection-trunk attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel one_peace_tpu/ops/det_attention.py
// `_det_flash_fwd` / `_make_kernel`.  Over an (hg, wg) grid of L = hg * wg
// tokens, per (batch b, head h), with q = (qy, qx) and k = (ky, kx) the grid
// coordinates of a query and a key, it computes
//
//   out = softmax(q k^T * scaling + toep[h, qy - ky + hg - 1, qx, kx]
//                 + bh[b, h, ky, q] + bw[b, h, q, kx]) v
//
// on the (B, L, H*64) layout of the q/k/v projections, with the scores and
// the softmax in fp32, and optionally the row log-sum-exp (B, H, L) fp32 (the
// residual a backward recomputes the probabilities from).  toep is the
// block-Toeplitz factor of the shared rel-pos bucket bias, fp32
// (H, 2hg-1, wg, wg), or absent; bh (B, H, hg, L) and bw (B, H, L, wg) are the
// decomposed rel-pos factors (detectron2's add_decomposed_rel_pos), fp32, both
// or neither.  Neither the (B, H, L, L) scores nor the (H, L, L) bias exist.
// out has q's dtype: fp32, bf16 or fp16.
//
// What bounds it on an H100 (1.5B trunk, H=24, Dh=64, per image):
//   global layer at 1024 px, L = 4096: q.k^T + p.v = 4*H*L^2*Dh = 103 GFLOP
//     (0.104 ms at the 989 TFLOP/s bf16 peak); the unique bytes are q/k/v/out
//     (50 MB in bf16), toep (50 MB) and bh + bw (25 MB): 0.037 ms at 3.35 TB/s.
//     So the tensor cores set the bound.  But every one of the H*L^2 = 4.0e8
//     scores has its own fp32 toep value: a block of 64 query rows reads
//     64 x L x 4 B = 1 MB of toep per pass from L2, twice its K and V, and
//     the first port, which gathered it per score (8 cache lines per
//     warp-wide load: the 8 row groups of an mma fragment sit wg floats
//     apart), spent two thirds of its 5.3 ms there.  Two passes of
//     exponentials and the bias adds are the rest of the non-MMA work.
//   windowed layer, 16 windows of L = 256: 6.4 GFLOP (6.5 us) against 12.6 MB
//     of q/k/v/out, bh and bw (3.8 us); toep is 0.7 MB, shared by all windows.
//
// What this design does about it:
//   - one block, one warpgroup, per (batch, 64-row q tile, head), batch in
//     blockIdx.x, so the blocks in flight read the same toep rows from L2;
//   - the (L, L) scores never leave registers: the block walks 64-key tiles of
//     K (and V), double-buffered in shared memory by cp.async;
//   - q.k^T and p.v run on wgmma m64n64k16: A from registers (Q, then P in the
//     accumulator layout, which is the A layout), B from 128-byte-swizzled
//     shared memory (K, then V transposed); the bias is read while q.k^T runs;
//     __launch_bounds__(128, 3) holds it to 168 registers, 3 blocks per SM;
//   - the bias comes from on-chip memory where wg is even and divides 64 (the
//     64 x 64 grid and its 16 x 16 windows; ops/det_attention.py:fwd_plan):
//     * toep: a (q tile at q0, key tile) pair whose keys span grid rows
//       ky_lo..ky_hi reads toep's flat rows (qy - ky + hg - 1) * wg + qx =
//       q + (hg - 1 - ky) * wg: the 64 + (ky_hi - ky_lo) * wg contiguous rows
//       from q0 + (hg - 1 - ky_hi) * wg on (one 16 KB slab at wg = 64).  They
//       are copied beside K and V into rows padded to a stride = 8 mod 16
//       floats, so the float2 reads of an mma fragment (4 rows x 4 column
//       pairs per half-warp) hit 32 banks;
//     * bw: every key tile has the same column pattern, so each thread keeps
//       its 32 bw values in registers for the whole key walk;
//     * bh: the tile's few ky rows x 64 queries are staged with K;
//     * on a full key tile of the 64- or 16-wide grid every offset but the
//       row's is a constant;
//     on other grids the same kernel gathers the bias per score through a
//     per-tile (ky, kx) offset table (staging there, with bw's rows in shared
//     memory, needed one block per SM and lost to the gather);
//   - two passes over the key tiles: the first finds each row's max m and sum
//     l (and the log-sum-exp), the second computes P = exp2(s log2e -
//     (m log2e + log2 l)) and rounds it to v's dtype (bf16 or fp16) before
//     P.V, exactly where the plain version casts its fp32 probabilities to
//     v's dtype (the TPU kernel rounds the unnormalised P; in the retrieval
//     kernel that one-pass order drifted from the plain path almost to the
//     0.999 cosine bound at depth 40);
//   - bf16 and fp16 run one kernel, templated on the element type: the
//     tiles, swizzle, fragments and plans are those of any 2-byte type, only
//     the wgmma's type (.bf16 or .f16) and the rounding of P and of the
//     output differ;
//   - fp32 inputs (the test path) use CUDA-core FMA, a one-pass online
//     softmax and the per-score gather.
// Not done yet: TMA for K, V and the slab; sharing one slab between the two
// images of a batch (a 2-block cluster with a multicast copy: half the L2
// traffic of toep, which now bounds the bias); 128-row q tiles (half that of
// K and V).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma_tiles.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;              // query rows per block
constexpr int kBlockN = 64;              // keys per K/V tile
constexpr int kTileBytes = kBlockN * kHeadDim * 2;  // a 2-byte K/V tile: 64 rows of 128 B
constexpr int kAlign = 1024;             // the 128-byte swizzle's atom: 8 rows of 128 B
constexpr int kF32Stride = kHeadDim + 1; // fp32 smem row stride: no bank conflicts
constexpr float kNegInf = -1e30f;

// How the 2-byte (bf16 or fp16) kernel reads the bias (ops/det_attention.py:
// FWD_GATHER, FWD_SLAB).
constexpr int kGather = 0;  // per score from device memory
constexpr int kSlab = 1;    // toep and bh staged per tile pair, bw in registers
constexpr float kLog2e = 1.4426950408889634f;

// The forward's plan for one grid (ops/det_attention.py:fwd_plan).
struct Plan {
  int mode;        // kGather or kSlab (the grid has wg even and 64 % wg == 0)
  int tile_rows;   // the most grid rows one 64-token tile spans
  int slab_rows;   // toep rows (wg floats each) staged per tile pair
  int stride;      // floats per staged toep row
  int smem_bytes;  // dynamic shared memory of the launch
};

// Byte offsets into the 2-byte kernel's dynamic shared memory.
struct Smem {
  int ks, vs, slab, bh, cols, total;
};

__host__ __device__ inline Smem smem_layout(bool toep, bool decomp, int mode, const Plan& p) {
  Smem s;
  int off = 0;
  s.ks = off;
  off += 2 * kTileBytes;
  s.vs = off;  // Q is read into registers from here before V is first loaded
  off += 2 * kTileBytes;
  s.slab = off;
  if (toep && mode == kSlab) off += 2 * p.slab_rows * p.stride * 4;
  s.bh = off;
  if (decomp && mode == kSlab) off += 2 * p.tile_rows * kBlockM * 4;
  s.cols = off;
  if ((toep || decomp) && mode == kGather) off += 2 * 3 * kBlockN * 4;
  s.total = off + kAlign;  // room to align the start to the swizzle atom
  return s;
}

// The bias operands of one (batch, head), the grid shape and the plan.
struct Bias {
  const float* toep;  // toep + h * (2hg-1) * wg * wg, or null
  const float* bh;    // bh + (b*H + h) * hg * L, or null
  const float* bw;    // bw + (b*H + h) * L * wg, or null
  int hg, wg, L;
  int q0, stride, lw;  // the block's first row; the slab's row stride; log2(wg) (kSlab)
};

// Offsets of one query row into the bias operands (kGather).
struct Row {
  int toep;  // ((qy + hg - 1) * wg + qx) * wg
  int q;     // the row itself: bh's column
  int bw;    // q * wg
};

__device__ __forceinline__ Row make_row(int q, const Bias& bias) {
  q = min(q, bias.L - 1);  // rows >= L compute clamped garbage, never stored
  const int qy = q / bias.wg, qx = q - qy * bias.wg;
  return Row{((qy + bias.hg - 1) * bias.wg + qx) * bias.wg, q, q * bias.wg};
}

// Offsets of the 64 key columns of the tile at k0, one column per thread of
// the first 64: toep's (-ky * wg * wg + kx), bh's ky * L and bw's kx.  Keys
// >= L are clamped to L - 1 (their scores are masked).
__device__ __forceinline__ void column_table(int* cols, int k0, const Bias& bias) {
  if (threadIdx.x < kBlockN) {
    const int key = min(k0 + static_cast<int>(threadIdx.x), bias.L - 1);
    const int ky = key / bias.wg, kx = key - ky * bias.wg;
    cols[threadIdx.x] = kx - ky * bias.wg * bias.wg;
    cols[kBlockN + threadIdx.x] = ky * bias.L;
    cols[2 * kBlockN + threadIdx.x] = kx;
  }
}

template <bool kToep, bool kDecomp>
__device__ __forceinline__ float bias_at(const Bias& bias, const Row& row, const int* cols, int c) {
  float x = 0.f;
  if (kToep) x += __ldg(bias.toep + row.toep + cols[c]);
  if (kDecomp) {
    x += __ldg(bias.bh + cols[kBlockN + c] + row.q);
    x += __ldg(bias.bw + row.bw + cols[2 * kBlockN + c]);
  }
  return x;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int L, int row_stride) {
  for (int i = threadIdx.x; i < kBlockM * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kF32Stride + c] =
        row0 + r < L ? src[static_cast<size_t>(row0 + r) * row_stride + c] : 0.f;
  }
}

// Stage the bias of the key tile at k0 (kSlab; see the header).  wg is a
// power of two that divides 64, so the tile holds grid rows ky_lo ..
// ky_lo + span whole, and every row and piece index is a shift and a mask.
template <bool kToep, bool kDecomp>
__device__ __forceinline__ void stage_slab(float* slab, float* bhs, int k0, const Bias& bias) {
  const int lw = bias.lw, wg = bias.wg;
  const int ky_lo = k0 >> lw, span = (min(kBlockN, bias.L - k0) - 1) >> lw;
  if (kToep) {  // toep rows r0 .. r0 + rows - 1, `stride` apart
    const int r0 = bias.q0 + (bias.hg - 1 - ky_lo - span) * wg;
    const int rows = min(kBlockM + span * wg, (2 * bias.hg - 1) * wg - r0);
    const float* src = bias.toep + static_cast<size_t>(r0) * wg;
    if (wg >= 4) {  // 16-byte pieces, wg / 4 a row
      const int lp = lw - 2;
      for (int i = threadIdx.x; i < rows << lp; i += blockDim.x) {
        const int r = i >> lp, c = i & ((1 << lp) - 1);
        cp_async_16(slab + r * bias.stride + 4 * c, src + (r << lw) + 4 * c, true);
      }
    } else {
      for (int i = threadIdx.x; i < rows << lw; i += blockDim.x) {
        const int r = i >> lw, c = i & (wg - 1);
        cp_async_4(slab + r * bias.stride + c, src + (r << lw) + c, true);
      }
    }
  }
  if (kDecomp) {  // bh rows ky_lo .. ky_lo + span, queries q0 .. q0 + 63 (zero beyond L)
    const float* src = bias.bh + static_cast<size_t>(ky_lo) * bias.L + bias.q0;
    if ((bias.L & 3) == 0) {
      for (int i = threadIdx.x; i < (span + 1) << 4; i += blockDim.x) {
        const int r = i >> 4, c = i & 15;
        const bool valid = bias.q0 + 4 * c < bias.L;
        cp_async_16(bhs + r * kBlockM + 4 * c, valid ? src + r * bias.L + 4 * c : src, valid);
      }
    } else {
      for (int i = threadIdx.x; i < (span + 1) << 6; i += blockDim.x) {
        const int r = i >> 6, c = i & 63;
        const bool valid = bias.q0 + c < bias.L;
        cp_async_4(bhs + r * kBlockM + c, valid ? src + r * bias.L + c : src, valid);
      }
    }
  }
}

// slab_bias's case of a full key tile on a grid 2^kLw >= 8 wide: the key
// rows and columns of each 8-key group are constants.  At kLw = 6 the tile
// is one grid row of keys, so bh is one value per row: it goes to ys, for
// the softmax to add to the row's max and exponent instead of to each score.
template <bool kToep, bool kDecomp, int kLw>
__device__ __forceinline__ void slab_bias_full(float bv[8][4], float ys[2], const float* slab,
                                               const float* bhs, const int rq[2],
                                               const float bwr[8][4], int stride) {
  constexpr int kWg = 1 << kLw, kSpan = (kBlockN >> kLw) - 1;
  const int t = threadIdx.x & 3;
  const int row_step = kWg * stride;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* p = slab + rq[r] * stride + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int kyl = (j * 8) >> kLw;
      float2 x = make_float2(0.f, 0.f);
      if (kToep)
        x = *reinterpret_cast<const float2*>(p + (kSpan - kyl) * row_step + ((j * 8) & (kWg - 1)));
      if (kDecomp && kLw == 6) {
        x.x += bwr[j][2 * r];
        x.y += bwr[j][2 * r + 1];
      } else if (kDecomp) {
        const float y = bhs[kyl * kBlockM + rq[r]];
        x.x = x.x + y + bwr[j][2 * r];
        x.y = x.y + y + bwr[j][2 * r + 1];
      }
      bv[j][2 * r] = x.x;
      bv[j][2 * r + 1] = x.y;
    }
    if (kDecomp && kLw == 6) ys[r] = bhs[rq[r]];
  }
}

// The bias of one warp's 16 x 64 tile in the mma accumulator layout:
// bv[j][c] is row (g + 8 (c >> 1)), key k0 + 8j + 2t + (c & 1).
// kSlab: wg divides 64 and is even, so the column pair (2t, 2t + 1) of each
// 8-key group shares its ky and one float2 read gives both toep values;
// bwr holds this thread's bw.  Rows r (and clamped keys) stay in the slab.
template <bool kToep, bool kDecomp, int kMode>
__device__ __forceinline__ void bias_tile(float bv[8][4], float ys[2], const float* slab,
                                          const float* bhs, const int* cols, const int rq[2],
                                          const Row rows[2], const float bwr[8][4], int k0,
                                          const Bias& bias) {
  const int t = threadIdx.x & 3;
  ys[0] = ys[1] = 0.f;
  if constexpr (kMode == kSlab) {
    const int ncols = min(kBlockN, bias.L - k0);  // even, as L is
    if (ncols == kBlockN && bias.lw == 6) {
      slab_bias_full<kToep, kDecomp, 6>(bv, ys, slab, bhs, rq, bwr, bias.stride);
      return;
    }
    if (ncols == kBlockN && bias.lw == 4) {
      slab_bias_full<kToep, kDecomp, 4>(bv, ys, slab, bhs, rq, bwr, bias.stride);
      return;
    }
    const int span = (ncols - 1) >> bias.lw;      // ky_hi - ky_lo
    float y[2] = {0.f, 0.f};
    if (kDecomp && span == 0) {  // one grid row of keys (wg = 64): one bh value a row
      y[0] = bhs[rq[0]];
      y[1] = bhs[rq[1]];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = min(j * 8 + 2 * t, ncols - 2);
      const int kyl = col >> bias.lw;
      const int toff = (span - kyl) * bias.wg * bias.stride + (col & (bias.wg - 1));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 x = make_float2(0.f, 0.f);
        if (kToep) x = *reinterpret_cast<const float2*>(slab + rq[r] * bias.stride + toff);
        if (kDecomp) {
          const float yr = span == 0 ? y[r] : bhs[kyl * kBlockM + rq[r]];
          x.x = x.x + yr + bwr[j][2 * r];
          x.y = x.y + yr + bwr[j][2 * r + 1];
        }
        bv[j][2 * r] = x.x;
        bv[j][2 * r + 1] = x.y;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        bv[j][c] = bias_at<kToep, kDecomp>(bias, rows[c >> 1], cols, j * 8 + 2 * t + (c & 1));
  }
}

// One warp's 16 x 64 tile of scaled, biased and masked scores against the
// K tile in shared memory, in the mma accumulator layout: s[j][c] + ys[c >> 1]
// is row rows[c >> 1], key k0 + 8j + 2t + (c & 1).  The bias is read while
// q.k^T runs; only the last tile masks.
template <typename T, bool kToep, bool kDecomp, int kMode>
__device__ __forceinline__ void score_tile(float s[8][4], float ys[2], const uint32_t qa[4][4],
                                           const unsigned char* ks, const float* slab,
                                           const float* bhs, const int* cols, const int rq[2],
                                           const Row rows[2], const float bwr[8][4], int k0,
                                           float scaling, const Bias& bias) {
  const int t = threadIdx.x & 3;
  const uint64_t desc = sw128_desc(ks);
  fence_acc(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<0, T>(s, qa[kk], desc + 2 * kk, kk);
  wgmma_commit();
  float bv[8][4];
  bias_tile<kToep, kDecomp, kMode>(bv, ys, slab, bhs, cols, rq, rows, bwr, k0, bias);
  wgmma_wait_all();
  fence_acc(s);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = s[j][c] * scaling + bv[j][c];
  if (k0 + kBlockN > bias.L) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + j * 8 + 2 * t + (c & 1) >= bias.L) s[j][c] = kNegInf;
  }
}

// 4 warps; warp w owns query rows [16w, 16w + 16) of the block's tile.
// T is the 2-byte element type, bf16 or fp16 (__half).
template <typename T, bool kToep, bool kDecomp, int kMode>
__global__ void __launch_bounds__(128, 3)
det_attn_fwd_wgmma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ toep, const float* __restrict__ bh,
                   const float* __restrict__ bw, T* __restrict__ out, float* __restrict__ lse,
                   int L, int H, int hg, int wg, float scaling, Plan plan) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  const Smem lay = smem_layout(kToep, kDecomp, kMode, plan);
  unsigned char* smem =
      dyn_smem + ((kAlign - static_cast<uint32_t>(__cvta_generic_to_shared(dyn_smem))) & (kAlign - 1));
  unsigned char* ks = smem + lay.ks;  // [2][kTileBytes], 128-byte swizzled
  unsigned char* vs = smem + lay.vs;  // [2][kTileBytes], 128-byte swizzled
  float* slab = reinterpret_cast<float*>(smem + lay.slab);  // [2][slab_rows * stride]
  float* bhs = reinterpret_cast<float*>(smem + lay.bh);     // [2][tile_rows * 64]
  int* cols = reinterpret_cast<int*>(smem + lay.cols);      // [2][3 * 64]
  const int slab_size = plan.slab_rows * plan.stride, bh_size = plan.tile_rows * kBlockM;

  const int b = blockIdx.x, q0 = blockIdx.y * kBlockM, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bh_head = static_cast<size_t>(b) * H + h;
  const Bias bias{kToep ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg : nullptr,
                  kDecomp ? bh + bh_head * hg * L : nullptr,
                  kDecomp ? bw + bh_head * L * wg : nullptr, hg, wg, L, q0, plan.stride,
                  __ffs(wg) - 1};

  const unsigned char* qs = vs;
  load_tile_async(vs, q + base, q0, L, row_stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // row qr (and qr + 8), head dims 16kk + 2t (+ 8)
    const unsigned char* p0 = qs + qr * 128 + 4 * t;
    const unsigned char* p1 = p0 + 8 * 128;
    const int c0 = ((2 * kk) ^ (qr & 7)) << 4, c1 = ((2 * kk + 1) ^ (qr & 7)) << 4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0 + c0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1 + c0);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + c1);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + c1);
  }
  const int row_ids[2] = {q0 + qr, q0 + qr + 8};
  const int rq[2] = {min(row_ids[0], L - 1) - q0, min(row_ids[1], L - 1) - q0};
  const Row rows[2] = {make_row(row_ids[0], bias), make_row(row_ids[1], bias)};
  // kSlab: bw of this thread's rows and columns, the same in every key tile
  float bwr[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      bwr[j][c] = kDecomp && kMode == kSlab
                      ? __ldg(bias.bw + (q0 + rq[c >> 1]) * wg +
                              ((j * 8 + 2 * t + (c & 1)) & (wg - 1)))
                      : 0.f;
  float s[8][4], ys[2];
  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  auto stage = [&](int it, bool with_v) {
    const int buf = it & 1, k0 = it * kBlockN;
    load_tile_async(ks + buf * kTileBytes, k + base, k0, L, row_stride);
    if (with_v) load_tile_async(vs + buf * kTileBytes, v + base, k0, L, row_stride);
    if constexpr (kMode == kSlab)
      stage_slab<kToep, kDecomp>(slab + buf * slab_size, bhs + buf * bh_size, k0, bias);
    else if constexpr (kToep || kDecomp)
      column_table(cols + buf * 3 * kBlockN, k0, bias);
  };
  auto scores = [&](int it) {
    const int buf = it & 1;
    score_tile<T, kToep, kDecomp, kMode>(s, ys, qa, ks + buf * kTileBytes, slab + buf * slab_size,
                                      bhs + buf * bh_size, cols + buf * 3 * kBlockN, rq, rows,
                                      bwr, it * kBlockN, scaling, bias);
  };

  // pass 1: running max m and sum l of exp(s - m) per row (exp through exp2)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  stage(0, false);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, false);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    scores(it);
    float mx[2] = {-INFINITY, -INFINITY}, rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      mx[r] = fmaxf(m[r], mx[r] + ys[r]);
    }
    // exp(s + ys - mx) = exp2(s log2e + (ys log2e - mx log2e))
    const float off[2] = {fmaf(ys[0], kLog2e, -mx[0] * kLog2e),
                          fmaf(ys[1], kLog2e, -mx[1] * kLog2e)};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) rs[c >> 1] += ex2(fmaf(s[j][c], kLog2e, off[c >> 1]));
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * ex2((m[r] - mx[r]) * kLog2e) + rs[r];  // exactly l when m holds
      m[r] = mx[r];
    }
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }
  // exp(s - m) / l = exp2(s log2e - (m log2e + log2 l))
  const float ml[2] = {fmaf(m[0], kLog2e, log2f(l[0])), fmaf(m[1], kLog2e, log2f(l[1]))};
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (row_ids[r] < L) lse[bh_head * L + row_ids[r]] = m[r] + logf(l[r]);
  }

  // pass 2: P = exp(s - m) / l, rounded to T, times V
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  stage(0, true);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_tiles) stage(it + 1, true);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    scores(it);
    const float off[2] = {fmaf(ys[0], kLog2e, -ml[0]), fmaf(ys[1], kLog2e, -ml[1])};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = ex2(fmaf(s[j][c], kLog2e, off[c >> 1]));
    // The accumulator layout of two adjacent 8-key score tiles is the A
    // operand layout of one 16-key step of P.V.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      pa[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
    const uint64_t desc = sw128_desc(vs + buf * kTileBytes);
    fence_acc(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_64x64x16<1, T>(o, pa[kk], desc + 128 * kk, 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(o);
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row_ids[r] >= L) continue;
    T* dst = out + base + static_cast<size_t>(row_ids[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack2<T>(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 and, of each
// 64-wide tile, columns tx, tx+16, tx+32, tx+48.
constexpr size_t kF32Smem = 4 * kBlockM * kF32Stride * sizeof(float);

template <bool kToep, bool kDecomp>
__global__ void __launch_bounds__(256)
det_attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ toep,
                 const float* __restrict__ bh, const float* __restrict__ bw,
                 float* __restrict__ out, float* __restrict__ lse,
                 int L, int H, int hg, int wg, float scaling) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * kF32Stride;
  float* vs = ks + kBlockN * kF32Stride;
  float* ps = vs + kBlockN * kF32Stride;
  __shared__ int cols[3 * kBlockN];

  const int b = blockIdx.x, q0 = blockIdx.y * kBlockM, h = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bh_head = static_cast<size_t>(b) * H + h;
  const Bias bias{kToep ? toep + static_cast<size_t>(h) * (2 * hg - 1) * wg * wg : nullptr,
                  kDecomp ? bh + bh_head * hg * L : nullptr,
                  kDecomp ? bw + bh_head * L * wg : nullptr, hg, wg, L, q0, 0, 0};

  load_tile_f32(qs, q + base, q0, L, row_stride);
  Row rows[4];
  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rows[i] = make_row(q0 + ty * 4 + i, bias);
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_tile_f32(ks, k + base, k0, L, row_stride);
    load_tile_f32(vs, v + base, k0, L, row_stride);
    column_table(cols, k0, bias);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < kHeadDim; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * kF32Stride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * kF32Stride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        s[i][j] = k0 + c < L ? s[i][j] * scaling + bias_at<kToep, kDecomp>(bias, rows[i], cols, c)
                             : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float alpha = __expf(m[i] - mx);
      m[i] = mx;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = __expf(s[i][j] - mx);
        ps[(ty * 4 + i) * kF32Stride + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    __syncthreads();  // P is complete

    for (int c = 0; c < kBlockN; ++c) {
      float pv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kF32Stride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vv[j] = vs[c * kF32Stride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], vv[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[base + static_cast<size_t>(row) * row_stride + tx + 16 * j] = o[i][j] * inv;
    if (lse != nullptr && tx == 0) lse[bh_head * L + row] = m[i] + logf(l[i]);
  }
}

template <typename T, bool kToep, bool kDecomp, int kMode>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* toep,
                         const float* bh, const float* bw, void* out, float* lse, dim3 grid,
                         int L, int heads, int hg, int wg, float scaling, const Plan& plan,
                         cudaStream_t s) {
  const Smem lay = smem_layout(kToep, kDecomp, kMode, plan);
  if (lay.total != plan.smem_bytes) return cudaErrorInvalidValue;  // the plan is inconsistent
  cudaError_t err = cudaFuncSetAttribute(det_attn_fwd_wgmma<T, kToep, kDecomp, kMode>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, lay.total);
  if (err != cudaSuccess) return err;
  det_attn_fwd_wgmma<T, kToep, kDecomp, kMode><<<grid, 128, lay.total, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), toep, bh, bw,
      static_cast<T*>(out), lse, L, heads, hg, wg, scaling, plan);
  return cudaGetLastError();
}

// The 2-byte kernel of the plan's branch.
template <typename T, bool kToep, bool kDecomp>
cudaError_t launch_2byte(const void* q, const void* k, const void* v, const float* toep,
                         const float* bh, const float* bw, void* out, float* lse, dim3 grid,
                         int L, int heads, int hg, int wg, float scaling, const Plan& plan,
                         cudaStream_t s) {
  if constexpr (!kToep && !kDecomp)  // no bias to read: one kernel serves every plan
    return launch_wgmma<T, kToep, kDecomp, kGather>(q, k, v, toep, bh, bw, out, lse, grid, L,
                                                    heads, hg, wg, scaling, plan, s);
  else switch (plan.mode) {
    case kGather:
      return launch_wgmma<T, kToep, kDecomp, kGather>(q, k, v, toep, bh, bw, out, lse, grid, L,
                                                      heads, hg, wg, scaling, plan, s);
    case kSlab:
      if (wg % 2 != 0 || kBlockN % wg != 0) return cudaErrorInvalidValue;
      return launch_wgmma<T, kToep, kDecomp, kSlab>(q, k, v, toep, bh, bw, out, lse, grid, L,
                                                    heads, hg, wg, scaling, plan, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 fp32, 1 bf16, 2 fp16 (ops/build.py: DTYPE_CODES).
template <bool kToep, bool kDecomp>
cudaError_t launch(const void* q, const void* k, const void* v, const float* toep,
                   const float* bh, const float* bw, void* out, float* lse, int batch, int L,
                   int heads, int hg, int wg, float scaling, int dtype, const Plan& plan,
                   cudaStream_t s) {
  const dim3 grid(batch, (L + kBlockM - 1) / kBlockM, heads);
  if (dtype == 1)
    return launch_2byte<__nv_bfloat16, kToep, kDecomp>(q, k, v, toep, bh, bw, out, lse, grid, L,
                                                       heads, hg, wg, scaling, plan, s);
  if (dtype == 2)
    return launch_2byte<__half, kToep, kDecomp>(q, k, v, toep, bh, bw, out, lse, grid, L, heads,
                                                hg, wg, scaling, plan, s);
  if (dtype != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(det_attn_fwd_f32<kToep, kDecomp>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kF32Smem));
  if (err != cudaSuccess) return err;
  det_attn_fwd_f32<kToep, kDecomp><<<grid, 256, kF32Smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), toep, bh, bw, static_cast<float*>(out), lse,
      L, heads, hg, wg, scaling);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, out: (batch, L, heads * 64) of the dtype `dtype` names (0 fp32, 1 bf16,
// 2 fp16; ops/build.py: DTYPE_CODES), L = hg * wg.
// toep: fp32 (heads, 2hg-1, wg, wg) or null.  bh: fp32 (batch, heads, hg, L)
// and bw: fp32 (batch, heads, L, wg), both or neither.  lse: fp32
// (batch, heads, L) or null.  mode, tile_rows, slab_rows, stride and
// smem_bytes: the 2-byte kernel's plan for this grid and these biases
// (ops/det_attention.py:fwd_plan); the fp32 kernel ignores them.
extern "C" int one_peace_det_attention_fwd(
    const void* q, const void* k, const void* v, const void* toep, const void* bh,
    const void* bw, void* out, void* lse, int batch, int seq_len, int heads, int hg, int wg,
    float scaling, int dtype, int mode, int tile_rows, int slab_rows, int stride,
    int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* tp = static_cast<const float*>(toep);
  const float* h = static_cast<const float*>(bh);
  const float* w = static_cast<const float*>(bw);
  float* ls = static_cast<float*>(lse);
  const Plan plan{mode, tile_rows, slab_rows, stride, smem_bytes};
  if (tp != nullptr && h != nullptr)
    err = launch<true, true>(q, k, v, tp, h, w, out, ls, batch, seq_len, heads, hg, wg, scaling,
                             dtype, plan, s);
  else if (tp != nullptr)
    err = launch<true, false>(q, k, v, tp, h, w, out, ls, batch, seq_len, heads, hg, wg, scaling,
                              dtype, plan, s);
  else if (h != nullptr)
    err = launch<false, true>(q, k, v, tp, h, w, out, ls, batch, seq_len, heads, hg, wg, scaling,
                              dtype, plan, s);
  else
    err = launch<false, false>(q, k, v, tp, h, w, out, ls, batch, seq_len, heads, hg, wg, scaling,
                               dtype, plan, s);
  return static_cast<int>(err);
}

extern "C" const char* one_peace_det_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
