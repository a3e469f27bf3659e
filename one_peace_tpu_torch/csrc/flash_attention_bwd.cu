// Fused bias-aware attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel one_peace_tpu/ops/flash_attention.py:409
// `_flash_bwd` / `_make_bwd_kernel`.  Per (batch b, head h), with
// s = q k^T * scaling + rel_bias + key_bias in fp32, it computes
//
//   p32 = softmax(s);  p = p32 rounded to q's dtype
//   dv  = p^T g;       dp = g v^T                     (fp32 sums)
//   ds  = p32 * (dp - rowsum(dp * p32))
//   dsc = ds * scaling rounded to q's dtype
//   dq  = dsc k;  dk = dsc^T q;  d(rel_bias) = ds     (d(rel_bias) in fp32)
//
// on the (B, L, H*64) layout, with d(rel_bias) summed over B when the bias is
// shared, (H, L, L).  The row statistics are recomputed here, so the forward
// kernel stays as it is.  The rounding points of p and dsc are the TPU
// kernel's (:311, :323) and those of flash_attention_bwd_plain.
//
// What bounds it on an H100 (4B geometry, H=24, Dh=64, per layer, B=32):
//   images, L=257: the recompute of s, dp twice and the four gradient
//     products are ~9 x 2*B*H*L^2*Dh = 58 GFLOP (0.06 ms at the 989 TFLOP/s
//     bf16 peak); q, k, v, g, dq, dk, dv are 152 MB of HBM traffic (0.05 ms);
//     the shared bias is read three times per batch row (1.6 GB of reads
//     over a 6.3 MB table, served from L2) and d(bias) is read and written
//     once per batch row by its owning block (0.8 GB of L2 traffic).
//   text, L=71 with pads: small; the launch and the tail of 2 key tiles
//     (of which the second holds 7 keys) dominate.
// So, as in the forward, bytes through L2 and the latency of the many small
// products bound it, not the tensor cores.
//
// What this design does about it, and where each reduction happens:
//   - Two kernels on one stream, and a third for a shared bias's chunks.
//     attn_bwd_dq: one block per (batch, 64-row q tile, head), batch in
//     blockIdx.x so that neighbouring blocks read the same bias rows from L2.
//     Pass 1 over the 64-key tiles finds each row's max m, sum l and
//     rowsum(dp * p32) online (rescaled when m grows); pass 2 recomputes s
//     and dp and accumulates dq over the key tiles in registers.
//     It stores m, 1/l and rowsum(dp * p32) per row (3 * B*H*L floats).
//   - attn_bwd_dkv: one block per (64-key tile, head, chunk of batch rows;
//     a chunk is one row unless the bias is shared).  It keeps its keys' k
//     and v in registers and walks the q tiles (q, g and the row statistics
//     double-buffered with cp.async), recomputing s^T and dp^T from the
//     statistics; dk and dv are summed over the q tiles in registers.  With
//     a shared bias the block loops over its chunk of the batch inside, and
//     adds each row's ds into the d(bias) columns it alone owns for that
//     chunk; attn_bwd_sum_chunks then adds the chunks' partial sums in
//     chunk order.  The sum over B is a loop in the block and a second pass,
//     in a fixed order, with no atomics, so it is deterministic.  The chunks
//     are sized so that about four blocks per SM are in flight (a loop over
//     the whole batch in 120 blocks left the card 1 block per SM and made
//     this kernel 4/5 of the backward's time).  A batched bias gets its ds
//     stored once.
//   - bf16 uses the tensor cores through mma.sync m16n8k16 with fp32
//     accumulation; the accumulator layout of two 8-column score tiles is
//     the A operand of a 16-deep product, so p and dsc are rounded to bf16
//     exactly where they enter dv, dq and dk, and never touch memory.  fp32
//     uses CUDA-core FMA on shared-memory tiles.
//   - Query rows and keys >= L are zero-filled on load and their scores set
//     to -1e30 (probability 0), so nothing non-finite meets a zero weight;
//     padded keys arrive as a -1e30 key bias and get p = ds = 0.
// Not done yet: wgmma, TMA, saving the forward's row statistics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kHeadDim = 64;
constexpr int kTile = 64;                // rows of a q tile, keys of a key tile
constexpr int kStride = kHeadDim + 8;    // bf16 smem row stride: no bank conflicts
constexpr int kF32Stride = kHeadDim + 1; // fp32 smem row stride: no bank conflicts
constexpr float kNegInf = -1e30f;        // as ops/flash_attention.py NEG_INF

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A (16x16, row) * B (16x8, col) + D, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
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

// Rows [row0, row0 + 64) of one head into shared memory, asynchronously;
// rows >= L are zero.
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int L, int row_stride) {
  for (int i = threadIdx.x; i < kTile * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < L;
    cp_async_16(dst + r * kStride + c * 8,
                src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride + c * 8, valid);
  }
}

// A fragments (m16n8k16, row-major) of rows [row0, row0 + 16) x 64 of a tile.
__device__ __forceinline__ void load_a_frags(uint32_t a[4][4], const __nv_bfloat16* tile,
                                             int row0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p0 = tile + (row0 + g) * kStride + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    a[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    a[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    a[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    a[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
}

// acc (16 x 64) = A (16 x 64 dims) * tile^T, tile rows = the 64 output
// columns: acc[j][c] is row g + 8 (c >> 1), column 8j + 2t + (c & 1).
__device__ __forceinline__ void mma_nt(float acc[8][4], const uint32_t a[4][4],
                                       const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    const __nv_bfloat16* bp = tile + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(acc[j], a[kk], *reinterpret_cast<const uint32_t*>(bp + kk * 16),
                *reinterpret_cast<const uint32_t*>(bp + kk * 16 + 8));
  }
}

// o (16 x 64) += round_bf16(x) (16 x 64, accumulator layout) * tile, tile
// rows = the 64-deep sum index.  The accumulator layout of two adjacent
// 8-column tiles is the A operand layout of one 16-deep step.
__device__ __forceinline__ void mma_nn(float o[8][4], const float x[8][4],
                                       const __nv_bfloat16* tile) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
    const __nv_bfloat16* row = tile + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kStride;
#pragma unroll
    for (int n = 0; n < 8; n += 2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, row + (n + (mi >> 1)) * 8);
      mma_16816(o[n], xa, b[0], b[1]);
      mma_16816(o[n + 1], xa, b[2], b[3]);
    }
  }
}

// Rows [row0, row0 + 16) of a 16 x 64 fp32 accumulator, rounded to bf16,
// into rows of a (L, H*64) tensor; rows >= L are skipped.
__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, const float acc[8][4],
                                                const int rows[2], int L, int row_stride) {
  const int t = (threadIdx.x & 31) & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    __nv_bfloat16* p = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// --------------------------------------------------------------------------
// bf16: 4 warps; warp w owns rows [16w, 16w + 16) of the block's tile.
// --------------------------------------------------------------------------

// Scores of query rows `rows` against keys [k0, k0 + 64): s = acc * scaling
// + bias + key_bias, -1e30 at keys >= L.  Bias loads are issued first, at
// clamped addresses, so they overlap the products.
__device__ __forceinline__ void scores_qk(float s[8][4], const uint32_t qa[4][4],
                                          const __nv_bfloat16* ks, const int rows[2], int k0,
                                          int L, float scaling, const float* bias_bh,
                                          const float* kb) {
  const int t = (threadIdx.x & 31) & 3;
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = min(rows[c >> 1], L - 1), col = min(k0 + j * 8 + 2 * t + (c & 1), L - 1);
      bv[j][c] = (bias_bh != nullptr ? __ldg(bias_bh + static_cast<size_t>(row) * L + col) : 0.f) +
                 (kb != nullptr ? __ldg(kb + col) : 0.f);
    }
  mma_nt(s, qa, ks);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[j][c] = k0 + j * 8 + 2 * t + (c & 1) < L ? s[j][c] * scaling + bv[j][c] : kNegInf;
}

// Transposed scores: keys `keys` (rows) against queries [q0, q0 + 64)
// (columns); -1e30 where the key or the query is >= L.
__device__ __forceinline__ void scores_kq(float s[8][4], const uint32_t ka[4][4],
                                          const __nv_bfloat16* qs, const int keys[2], int q0,
                                          int L, float scaling, const float* bias_bh,
                                          const float* kb) {
  const int t = (threadIdx.x & 31) & 3;
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = min(keys[c >> 1], L - 1), query = min(q0 + j * 8 + 2 * t + (c & 1), L - 1);
      bv[j][c] = (bias_bh != nullptr ? __ldg(bias_bh + static_cast<size_t>(query) * L + key) : 0.f) +
                 (kb != nullptr ? __ldg(kb + key) : 0.f);
    }
  mma_nt(s, ka, qs);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[j][c] = keys[c >> 1] < L && q0 + j * 8 + 2 * t + (c & 1) < L
                    ? s[j][c] * scaling + bv[j][c] : kNegInf;
}

__global__ void __launch_bounds__(128)
attn_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                 const float* __restrict__ bias, int bias_batched,
                 const float* __restrict__ key_bias, __nv_bfloat16* __restrict__ dq,
                 float* __restrict__ stats, int B, int L, int H, float scaling) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kTile * kStride];

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const float* bias_bh = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? b * H : 0) + h) * L * L;
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;

  // q and g fragments, staged through the K buffers
  load_tile_async(ks[0], q + base, q0, L, row_stride);
  load_tile_async(ks[1], g + base, q0, L, row_stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[4][4], ga[4][4];
  load_a_frags(qa, ks[0], warp * 16);
  load_a_frags(ga, ks[1], warp * 16);
  __syncthreads();
  const int rows[2] = {q0 + warp * 16 + (lane >> 2), q0 + warp * 16 + (lane >> 2) + 8};
  const int n_tiles = (L + kTile - 1) / kTile;
  float s[8][4], dp[8][4];

  // pass 1: row max m, sum l of exp(s - m) and sum a of exp(s - m) * dp
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, a[2] = {0.f, 0.f};
  load_tile_async(ks[0], k + base, 0, L, row_stride);
  load_tile_async(vs[0], v + base, 0, L, row_stride);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async(ks[cur ^ 1], k + base, k0 + kTile, L, row_stride);
      load_tile_async(vs[cur ^ 1], v + base, k0 + kTile, L, row_stride);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    scores_qk(s, qa, ks[cur], rows, k0, L, scaling, bias_bh, kb);
    mma_nt(dp, ga, vs[cur]);
    float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f}, ra[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float e = __expf(s[j][c] - mx[c >> 1]);
        rs[c >> 1] += e;
        ra[c >> 1] += e * dp[j][c];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      ra[r] += __shfl_xor_sync(0xffffffffu, ra[r], 1);
      ra[r] += __shfl_xor_sync(0xffffffffu, ra[r], 2);
      const float alpha = __expf(m[r] - mx[r]);
      l[r] = l[r] * alpha + rs[r];
      a[r] = a[r] * alpha + ra[r];
      m[r] = mx[r];
    }
    __syncthreads();  // tile it is consumed before its buffer is refilled
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  const float dsum[2] = {a[0] * inv[0], a[1] * inv[1]};
  if (t == 0) {
    const size_t plane = static_cast<size_t>(B) * H * L;
    const size_t off = (static_cast<size_t>(b) * H + h) * L;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < L) {
        stats[off + rows[r]] = m[r];
        stats[plane + off + rows[r]] = inv[r];
        stats[2 * plane + off + rows[r]] = dsum[r];
      }
  }

  // pass 2: ds = p32 (dp - dsum), dq += round(ds * scaling) k
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  load_tile_async(ks[0], k + base, 0, L, row_stride);
  load_tile_async(vs[0], v + base, 0, L, row_stride);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kTile, cur = it & 1;
    if (it + 1 < n_tiles) {
      load_tile_async(ks[cur ^ 1], k + base, k0 + kTile, L, row_stride);
      load_tile_async(vs[cur ^ 1], v + base, k0 + kTile, L, row_stride);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    scores_qk(s, qa, ks[cur], rows, k0, L, scaling, bias_bh, kb);
    mma_nt(dp, ga, vs[cur]);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        const float p32 = __expf(s[j][c] - m[r]) * inv[r];
        s[j][c] = p32 * (dp[j][c] - dsum[r]) * scaling;
      }
    mma_nn(o, s, ks[cur]);
    __syncthreads();  // tile it is consumed before its buffer is refilled
  }
  store_rows_bf16(dq + base, o, rows, L, row_stride);
}

__global__ void __launch_bounds__(128)
attn_bwd_dkv_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ g,
                  const float* __restrict__ bias, int bias_batched,
                  const float* __restrict__ key_bias, const float* __restrict__ stats,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                  float* __restrict__ dbias, int B, int L, int H, float scaling, int b_chunk) {
  __shared__ __align__(16) __nv_bfloat16 qs[2][kTile * kStride];
  __shared__ __align__(16) __nv_bfloat16 gs[2][kTile * kStride];
  __shared__ float st[2][3][kTile];  // m, 1/l, dsum of the q tile's rows

  const int k0 = blockIdx.x * kTile, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const bool shared_bias = bias != nullptr && !bias_batched;
  const int b_first = blockIdx.z * b_chunk, b_end = min(B, b_first + b_chunk);
  const int keys[2] = {k0 + warp * 16 + (lane >> 2), k0 + warp * 16 + (lane >> 2) + 8};
  const int n_tiles = (L + kTile - 1) / kTile;
  const size_t plane = static_cast<size_t>(B) * H * L;

  for (int b = b_first; b < b_end; ++b) {
    const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
    const size_t bh = static_cast<size_t>(bias_batched ? b * H : 0) + h;
    const float* bias_bh = bias == nullptr ? nullptr : bias + bh * L * L;
    // a shared bias's chunk z adds into plane z of the partial sums
    const size_t dbh = bias_batched ? bh : static_cast<size_t>(blockIdx.z) * H + h;
    float* dbias_bh = dbias == nullptr ? nullptr : dbias + dbh * L * L;
    const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;
    const float* stats_bh = stats + (static_cast<size_t>(b) * H + h) * L;
    auto load_stats = [&](float (*dst)[kTile], int q0) {
      for (int i = threadIdx.x; i < 3 * kTile; i += blockDim.x) {
        const int which = i / kTile, r = i % kTile;
        dst[which][r] = q0 + r < L ? stats_bh[which * plane + q0 + r] : 0.f;
      }
    };

    __syncthreads();  // the previous batch row's buffers are consumed
    // this block's k and v rows, staged through the second buffers
    load_tile_async(qs[1], k + base, k0, L, row_stride);
    load_tile_async(gs[1], v + base, k0, L, row_stride);
    load_tile_async(qs[0], q + base, 0, L, row_stride);
    load_tile_async(gs[0], g + base, 0, L, row_stride);
    cp_async_commit();
    load_stats(st[0], 0);
    cp_async_wait_all();
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    load_a_frags(ka, qs[1], warp * 16);
    load_a_frags(va, gs[1], warp * 16);
    __syncthreads();  // staging buffers free before tile 1 is prefetched

    float dk_acc[8][4], dv_acc[8][4], s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * kTile, cur = it & 1;
      if (it + 1 < n_tiles) {
        load_tile_async(qs[cur ^ 1], q + base, q0 + kTile, L, row_stride);
        load_tile_async(gs[cur ^ 1], g + base, q0 + kTile, L, row_stride);
      }
      cp_async_commit();
      if (it + 1 < n_tiles) load_stats(st[cur ^ 1], q0 + kTile);
      cp_async_wait_prev();
      __syncthreads();
      scores_kq(s, ka, qs[cur], keys, q0, L, scaling, bias_bh, kb);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = j * 8 + 2 * t + (c & 1);
          s[j][c] = __expf(s[j][c] - st[cur][0][qi]) * st[cur][1][qi];  // p32^T
        }
      mma_nn(dv_acc, s, gs[cur]);  // dv += round(p)^T g
      mma_nt(dp, va, gs[cur]);     // dp^T = v g^T
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int qi = j * 8 + 2 * t + (c & 1);
          dp[j][c] = s[j][c] * (dp[j][c] - st[cur][2][qi]);  // ds^T
        }
      if (dbias_bh != nullptr) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = keys[c >> 1], query = q0 + j * 8 + 2 * t + (c & 1);
            if (key < L && query < L) {
              float* d = dbias_bh + static_cast<size_t>(query) * L + key;
              *d = shared_bias && b > b_first ? *d + dp[j][c] : dp[j][c];
            }
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dp[j][c] *= scaling;
      mma_nn(dk_acc, dp, qs[cur]);  // dk += round(ds * scaling)^T q
      __syncthreads();  // tile it is consumed before its buffer is refilled
    }
    store_rows_bf16(dk + base, dk_acc, keys, L, row_stride);
    store_rows_bf16(dv + base, dv_acc, keys, L, row_stride);
  }
}

// --------------------------------------------------------------------------
// fp32: 256 threads as 16 x 16; thread (ty, tx) owns rows 4ty..4ty+3 and,
// of each 64-wide tile, columns tx, tx+16, tx+32, tx+48.
// --------------------------------------------------------------------------

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int L, int row_stride) {
  for (int i = threadIdx.x; i < kTile * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kF32Stride + c] =
        row0 + r < L ? src[static_cast<size_t>(row0 + r) * row_stride + c] : 0.f;
  }
}

// acc[i][j] = sum_d a[4ty + i][d] * b[tx + 16j][d]
__device__ __forceinline__ void fma_nt(float acc[4][4], const float* a, const float* b) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < kHeadDim; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * kF32Stride + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * kF32Stride + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// Score of (row, col) after scaling, bias and masking (the forward's).
__device__ __forceinline__ float biased_score(float acc, int row, int col, int L,
                                              float scaling, const float* bias_bh,
                                              const float* kb) {
  if (row >= L || col >= L) return kNegInf;
  float x = acc * scaling;
  if (bias_bh != nullptr) x += __ldg(bias_bh + static_cast<size_t>(row) * L + col);
  if (kb != nullptr) x += __ldg(kb + col);
  return x;
}

constexpr size_t kF32TileBytes = kTile * kF32Stride * sizeof(float);
constexpr size_t kDqF32Smem = 5 * kF32TileBytes;
constexpr size_t kDkvF32Smem = 6 * kF32TileBytes + 3 * kTile * sizeof(float);

__global__ void __launch_bounds__(256)
attn_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ g,
                const float* __restrict__ bias, int bias_batched,
                const float* __restrict__ key_bias, float* __restrict__ dq,
                float* __restrict__ stats, int B, int L, int H, float scaling) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* gs = qs + kTile * kF32Stride;
  float* ks = gs + kTile * kF32Stride;
  float* vs = ks + kTile * kF32Stride;
  float* ps = vs + kTile * kF32Stride;

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const float* bias_bh = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? b * H : 0) + h) * L * L;
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;

  load_tile_f32(qs, q + base, q0, L, row_stride);
  load_tile_f32(gs, g + base, q0, L, row_stride);
  float s[4][4], dp[4][4], m[4], l[4], a[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = a[i] = 0.f;
  }

  // pass 1: row max, sum and sum of exp(s - m) * dp, online
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and q, g are loaded)
    load_tile_f32(ks, k + base, k0, L, row_stride);
    load_tile_f32(vs, v + base, k0, L, row_stride);
    __syncthreads();
    fma_nt(s, qs, ks);
    fma_nt(dp, gs, vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // rows >= L are never stored: score them as row L-1 would be
        s[i][j] = biased_score(s[i][j], min(row, L - 1), k0 + tx + 16 * j, L, scaling,
                               bias_bh, kb);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float rs = 0.f, ra = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = __expf(s[i][j] - mx);
        rs += e;
        ra += e * dp[i][j];
      }
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
        ra += __shfl_xor_sync(0xffffffffu, ra, off);
      }
      const float alpha = __expf(m[i] - mx);
      l[i] = l[i] * alpha + rs;
      a[i] = a[i] * alpha + ra;
      m[i] = mx;
    }
  }
  float inv[4], dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    inv[i] = 1.f / l[i];
    dsum[i] = a[i] * inv[i];
    const int row = q0 + ty * 4 + i;
    if (tx == 0 && row < L) {
      const size_t plane = static_cast<size_t>(B) * H * L;
      const size_t off = (static_cast<size_t>(b) * H + h) * L + row;
      stats[off] = m[i];
      stats[plane + off] = inv[i];
      stats[2 * plane + off] = dsum[i];
    }
  }

  // pass 2: dq += (ds * scaling) k
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  for (int k0 = 0; k0 < L; k0 += kTile) {
    __syncthreads();  // the previous tile and its ds are consumed
    load_tile_f32(ks, k + base, k0, L, row_stride);
    load_tile_f32(vs, v + base, k0, L, row_stride);
    __syncthreads();
    fma_nt(s, qs, ks);
    fma_nt(dp, gs, vs);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = biased_score(s[i][j], min(row, L - 1), k0 + tx + 16 * j, L, scaling,
                                     bias_bh, kb);
        const float p32 = __expf(x - m[i]) * inv[i];
        ps[(ty * 4 + i) * kF32Stride + tx + 16 * j] = p32 * (dp[i][j] - dsum[i]) * scaling;
      }
    }
    __syncthreads();  // ds is complete
    for (int c = 0; c < kTile; ++c) {
      float pv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty * 4 + i) * kF32Stride + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[c * kF32Stride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pv[i], kv[j], o[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= L) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dq[base + static_cast<size_t>(row) * row_stride + tx + 16 * j] = o[i][j];
  }
}

// The score tile is (query 4ty+i, key tx+16j), so bias reads and d(bias)
// writes are contiguous along tx; dk and dv are (key 4ty+i, dim tx+16j).
__global__ void __launch_bounds__(256)
attn_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ g,
                 const float* __restrict__ bias, int bias_batched,
                 const float* __restrict__ key_bias, const float* __restrict__ stats,
                 float* __restrict__ dk, float* __restrict__ dv, float* __restrict__ dbias,
                 int B, int L, int H, float scaling, int b_chunk) {
  extern __shared__ float smem[];
  float* ks = smem;
  float* vs = ks + kTile * kF32Stride;
  float* qs = vs + kTile * kF32Stride;
  float* gs = qs + kTile * kF32Stride;
  float* ps = gs + kTile * kF32Stride;   // p32 [query][key]
  float* dss = ps + kTile * kF32Stride;  // ds * scaling [query][key]
  float* st = dss + kTile * kF32Stride;  // m, 1/l, dsum of the q tile's rows

  const int k0 = blockIdx.x * kTile, h = blockIdx.y;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row_stride = H * kHeadDim;
  const bool shared_bias = bias != nullptr && !bias_batched;
  const int b_first = blockIdx.z * b_chunk, b_end = min(B, b_first + b_chunk);
  const size_t plane = static_cast<size_t>(B) * H * L;

  for (int b = b_first; b < b_end; ++b) {
    const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
    const size_t bh = static_cast<size_t>(bias_batched ? b * H : 0) + h;
    const float* bias_bh = bias == nullptr ? nullptr : bias + bh * L * L;
    const size_t dbh = bias_batched ? bh : static_cast<size_t>(blockIdx.z) * H + h;
    float* dbias_bh = dbias == nullptr ? nullptr : dbias + dbh * L * L;
    const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;
    const float* stats_bh = stats + (static_cast<size_t>(b) * H + h) * L;

    __syncthreads();  // the previous batch row's tiles are consumed
    load_tile_f32(ks, k + base, k0, L, row_stride);
    load_tile_f32(vs, v + base, k0, L, row_stride);
    float dk_acc[4][4], dv_acc[4][4], s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    for (int q0 = 0; q0 < L; q0 += kTile) {
      __syncthreads();  // the previous q tile, p and ds are consumed
      load_tile_f32(qs, q + base, q0, L, row_stride);
      load_tile_f32(gs, g + base, q0, L, row_stride);
      for (int i = threadIdx.x; i < 3 * kTile; i += blockDim.x) {
        const int which = i / kTile, r = i % kTile;
        st[i] = q0 + r < L ? stats_bh[which * plane + q0 + r] : 0.f;
      }
      __syncthreads();
      fma_nt(s, qs, ks);  // (query, key)
      fma_nt(dp, gs, vs);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = ty * 4 + i, query = q0 + qi;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kj = tx + 16 * j, key = k0 + kj;
          const float x = biased_score(s[i][j], query, key, L, scaling, bias_bh, kb);
          const float p32 = query < L ? __expf(x - st[qi]) * st[kTile + qi] : 0.f;
          const float ds = p32 * (dp[i][j] - st[2 * kTile + qi]);
          ps[qi * kF32Stride + kj] = p32;
          dss[qi * kF32Stride + kj] = ds * scaling;
          if (dbias_bh != nullptr && query < L && key < L) {
            float* d = dbias_bh + static_cast<size_t>(query) * L + key;
            *d = shared_bias && b > b_first ? *d + ds : ds;
          }
        }
      }
      __syncthreads();  // p and ds are complete
      for (int c = 0; c < kTile; ++c) {
        float pv[4], dsv[4], gv[4], qv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[c * kF32Stride + ty * 4 + i];
          dsv[i] = dss[c * kF32Stride + ty * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gv[j] = gs[c * kF32Stride + tx + 16 * j];
          qv[j] = qs[c * kF32Stride + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            dv_acc[i][j] = fmaf(pv[i], gv[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty * 4 + i;
      if (key >= L) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const size_t off = base + static_cast<size_t>(key) * row_stride + tx + 16 * j;
        dk[off] = dk_acc[i][j];
        dv[off] = dv_acc[i][j];
      }
    }
  }
}

// d(bias)[i] = sum over the chunks z, in order, of partial[z][i].
__global__ void __launch_bounds__(256)
attn_bwd_sum_chunks(const float* __restrict__ partial, float* __restrict__ dbias, size_t n,
                    int chunks) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = partial[i];
    for (int z = 1; z < chunks; ++z) acc += partial[z * n + i];
    dbias[i] = acc;
  }
}

}  // namespace

// Launches the kernels on `stream` and returns cudaGetLastError() (0 on
// success).  q, k, v, g, dq, dk, dv: (batch, seq_len, heads * 64), bf16 when
// is_bf16 else fp32.  bias and dbias: fp32 (heads, L, L), or (batch, heads,
// L, L) when bias_batched, or both null.  key_bias: fp32 (batch, L) or null.
// stats: fp32 scratch of 3 * batch * heads * L.  b_chunk: batch rows per
// dk/dv block with a shared bias (1 otherwise); with more than one chunk,
// partial is fp32 scratch of ceil(batch / b_chunk) * heads * L * L.
extern "C" int one_peace_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* bias,
    int bias_batched, const void* key_bias, void* dq, void* dk, void* dv, void* dbias,
    void* partial, void* stats, int batch, int seq_len, int heads, float scaling,
    int is_bf16, int b_chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (seq_len + kTile - 1) / kTile;
  const bool shared_bias = bias != nullptr && !bias_batched;
  if (!shared_bias) b_chunk = 1;
  const int chunks = (batch + b_chunk - 1) / b_chunk;
  // with several chunks, the dk/dv kernel writes partial sums of d(bias)
  float* dbias_out = shared_bias && chunks > 1 ? static_cast<float*>(partial)
                                               : static_cast<float*>(dbias);
  const dim3 grid_dq(batch, n_tiles, heads);
  const dim3 grid_dkv(n_tiles, heads, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    using bf = __nv_bfloat16;
    attn_bwd_dq_bf16<<<grid_dq, 128, 0, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(g), static_cast<const float*>(bias), bias_batched,
        static_cast<const float*>(key_bias), static_cast<bf*>(dq), static_cast<float*>(stats),
        batch, seq_len, heads, scaling);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkv_bf16<<<grid_dkv, 128, 0, s>>>(
        static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
        static_cast<const bf*>(g), static_cast<const float*>(bias), bias_batched,
        static_cast<const float*>(key_bias), static_cast<const float*>(stats),
        static_cast<bf*>(dk), static_cast<bf*>(dv), dbias_out,
        batch, seq_len, heads, scaling, b_chunk);
  } else {
    err = cudaFuncSetAttribute(attn_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDqF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(attn_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dq_f32<<<grid_dq, 256, kDqF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<const float*>(bias), bias_batched, static_cast<const float*>(key_bias),
        static_cast<float*>(dq), static_cast<float*>(stats), batch, seq_len, heads, scaling);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_bwd_dkv_f32<<<grid_dkv, 256, kDkvF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(g),
        static_cast<const float*>(bias), bias_batched, static_cast<const float*>(key_bias),
        static_cast<const float*>(stats), static_cast<float*>(dk), static_cast<float*>(dv),
        dbias_out, batch, seq_len, heads, scaling, b_chunk);
  }
  if (dbias_out != dbias) {
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const size_t n = static_cast<size_t>(heads) * seq_len * seq_len;
    const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    attn_bwd_sum_chunks<<<blocks, 256, 0, s>>>(dbias_out, static_cast<float*>(dbias), n, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* one_peace_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
