// Fused bias-aware attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel one_peace_tpu/ops/flash_attention.py:409
// `_flash_bwd` / `_make_bwd_kernel`.  Per (batch b, head h), with
// s = q k^T * scaling + rel_bias + key_bias in fp32, it computes
//
//   p32 = softmax(s) = exp(s - m) / l     (m, 1/l: the forward's statistics)
//   p   = p32 rounded to q's dtype
//   dv  = p^T g;       dp = g v^T                     (fp32 sums)
//   ds  = p32 * (dp - rowsum(dp * p32))               (the rowsum in fp32)
//   dsc = ds * scaling rounded to q's dtype
//   dq  = dsc k;  dk = dsc^T q;  d(rel_bias) = ds     (d(rel_bias) in fp32)
//
// on the (B, L, H*64) layout in bf16, fp16 or fp32, with d(rel_bias) summed
// over B when the bias is shared, (H, L, L).  The rounding points of p and dsc are the TPU kernel's
// (:311, :323) and those of flash_attention_bwd_plain.
//
// What bounds it on an H100 (4B geometry, H=24, Dh=64, per layer, B=32):
//   images, L=257: s, dp (twice) and the four gradient products are ~8 x
//     2*B*H*L^2*Dh = 52 GFLOP (0.05 ms at the 989 TFLOP/s bf16 peak); q, k,
//     v, g, dq, dk, dv are 152 MB of HBM traffic (0.05 ms); the bias is read
//     per score (0.2 GB from L2 for each reading kernel, a 6.3 MB table).
//   text, L=71 with pads: two key tiles, the second holding 7 keys.
// So bytes through L2 and the latency of short products bound it, not the
// tensor cores.  The first port found m and l again online in its dq
// kernel, read the bias three times per batch row, added every ds of a
// shared bias into d(bias) in device memory once per batch row (0.6 GB of
// L2 read-modify-write at L=257, B=32: the dk/dv kernel took 0.97 of its
// 1.37 ms on an H100 80GB HBM3 at 700 W), computed 64-wide tiles whether or
// not their rows exist, and ran on mma.sync.
//
// What this design does (ops/flash_attention.py:tile_plan, bwd_plan):
//   - the forward writes each row's m and 1/l when a gradient will be taken;
//     nothing here finds them again or rescales;
//   - attn_bwd_dq: one block, one warpgroup, per (batch, 64-row q tile,
//     head), batch in blockIdx.x so that neighbouring blocks read the same
//     bias rows from L2.  Walk 1 over the key tiles: s = q.k^T and dp = g.v^T
//     on wgmma (Q and G from registers, K and V from 128-byte-swizzled tiles
//     double-buffered by cp.async), the bias read from shared memory while
//     they run (each tile's bias rows copied by cp.async a tile ahead into
//     the block's region where two blocks fit on an SM, L <= 304, else into
//     one of two 64 x 72 float buffers), p32 from m and 1/l, rowsum(dp *
//     p32) in fp32.  Where the row block is resident p32 stays in the region in
//     place of the bias, and walk 2 recomputes only dp = g.v^T: ds, and dq
//     += round(ds * scaling) k on wgmma (A from registers).  Keeping p32
//     saves a second q.k^T, bias read and exp per score: at L=257, B=32 the
//     dq kernel took 0.267 ms so and 0.392 ms in two walks (H100 80GB HBM3,
//     700 W; PERF.md).
//     Longer sequences recompute s and stage the bias again in walk 2.
//     It stores rowsum(dp * p32) per row for the second kernel;
//   - attn_bwd_dkv: one block per (64-key tile, head, chunk of batch rows; a
//     chunk is one row unless the bias is shared or grid z would pass
//     65535).  K and V stay in registers; the block walks the q tiles (Q, G
//     and the rows' statistics double-buffered by cp.async) with s^T = k.q^T
//     on wgmma and the bias read by __ldg while it runs, then dp^T = v.g^T while the exps run, dv
//     += round(p)^T g and dk += round(dsc)^T q (A from registers).  A shared bias's d(bias)
//     columns of the block's keys are summed over its chunk in a shared slab
//     (64 keys x the padded width + 8 floats; each element has one owner
//     thread for the whole chunk) and written once per chunk; the chunks'
//     partial sums are added by attn_bwd_sum_chunks in chunk order.  Where
//     the slab does not fit beside the tiles and the block's static
//     statistics (st, 1,536 bytes; L > 752) the block reads, adds and
//     writes d(bias) in device memory per batch row, as the first port did.  A
//     batched bias gets its ds stored once.  No atomics: bit-reproducible;
//   - ragged tails at their own width: the last key tile (dq kernel) and
//     the last q tile (dk/dv kernel) are as wide as their rows rounded up to
//     16 (wgmma m64nNk16 and products 16 * ceil(rows / 16) deep), and warps
//     whose 16 rows all lie past L take part only in the warpgroup's wgmma;
//   - fp16 (the fp16 training path) runs the bf16 kernels unchanged,
//     templated on the element type: wgmma's .f16 form, p and dsc rounded
//     to fp16 where the plain version rounds them;
//   - fp32 (the test path) uses CUDA-core FMA on shared-memory tiles and
//     finds the statistics itself, as before.
// Not done yet: TMA; the dk/dv block's bias kept resident across its batch
// chunk (the slab and the bias together do not fit beside its tiles at two
// blocks per SM); p32 and dp shared between the two kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "flash_tiles.cuh"

namespace {

constexpr int kF32Stride = kHeadDim + 1; // fp32 smem row stride: no bank conflicts

// ---------------------------------------------------------------------------
// bf16 / fp16 (T) dq kernel: rows [16w, 16w + 16) of the block's q tile in
// warp w.
// ---------------------------------------------------------------------------

template <typename T, bool kResident>
__global__ void __launch_bounds__(128, 2)
attn_bwd_dq_wgmma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const T* __restrict__ g, const float* __restrict__ bias, int bias_batched,
                  const float* __restrict__ key_bias, const float* __restrict__ stats,
                  T* __restrict__ dq, float* __restrict__ dsum, int L, int H, float scaling,
                  TilePlan plan) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = aligned_smem(dyn_smem);
  unsigned char* ks = smem;                   // [2] swizzled K tiles (Q, G first)
  unsigned char* vs = smem + 2 * kTileBytes;  // [2] swizzled V tiles
  // the row block's p32 (kResident), or two staged bias tiles of kStageStride
  float* region = reinterpret_cast<float*>(smem + 4 * kTileBytes);

  const int b = blockIdx.x, q0 = blockIdx.y * kTile, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* bias_q = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? bh : h) * L + q0) * L;
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;
  const int nrows = min(kTile, L - q0), n_tiles = plan.n_tiles, stride = plan.stride;
  const bool live = warp * 16 < nrows;
  const int lr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int rows[2] = {q0 + lr[0], q0 + lr[1]};
  const int cr[2] = {min(lr[0], nrows - 1), min(lr[1], nrows - 1)};

  load_tile_async(ks, q + base, q0, L, row_stride);
  load_tile_async(ks + kTileBytes, g + base, q0, L, row_stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[4][4], ga[4][4];
  read_a_frags(qa, ks);
  read_a_frags(ga, ks + kTileBytes);
  __syncthreads();
  // exp(s - m) / l = exp2(s log2e - m log2e) * (1 / l)
  const size_t plane = static_cast<size_t>(gridDim.x) * H * L;
  float mo[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool ok = rows[r] < L;
    mo[r] = ok ? -stats[bh * L + rows[r]] * kLog2e : 0.f;
    inv[r] = ok ? stats[plane + bh * L + rows[r]] : 0.f;
  }

  auto width = [&](int it) { return it + 1 < n_tiles ? kTile : plan.tail; };
  // key tile it's bias rows: its columns of the region, or a staging buffer
  auto bias_tile = [&](int it) {
    return kResident ? region + it * kTile : region + (it & 1) * kTile * kStageStride;
  };
  const int bias_stride = kResident ? stride : kStageStride;
  auto stage = [&](int it, bool with_bias) {
    const int buf = it & 1, k0 = it * kTile;
    load_tile_async(ks + buf * kTileBytes, k + base, k0, L, row_stride);
    load_tile_async(vs + buf * kTileBytes, v + base, k0, L, row_stride);
    if (with_bias && bias_q != nullptr)
      stage_bias(bias_tile(it), bias_stride, bias_q + k0, nrows, min(kTile, L - k0), L);
  };
  // p32 of key tile it (8 kN8 keys wide; 0 at keys >= L) into s, and dp =
  // g v^T: the staged bias is read while both products run.  No branch lies between the products'
  // issue and their wait, and no register a product wrote is touched while
  // another runs: either made ptxas serialise the wgmmas (C7517).
  auto p32_dp = [&](auto n8c, float s[8][4], float dp[8][4], int it) {
    constexpr int kN8 = decltype(n8c)::value;
    const int k0 = it * kTile, buf = it & 1;
    issue_nt<kN8, T>(s, qa, ks + buf * kTileBytes);
    issue_nt<kN8, T>(dp, ga, vs + buf * kTileBytes);
    float bv[kN8][4];
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      const int col = k0 + 8 * j + 2 * t;
      float2 kbv = make_float2(0.f, 0.f);
      if (kb != nullptr)
        kbv = make_float2(__ldg(kb + min(col, L - 1)), __ldg(kb + min(col + 1, L - 1)));
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 x = make_float2(0.f, 0.f);
        if (bias_q != nullptr)
          x = *reinterpret_cast<const float2*>(bias_tile(it) + cr[r] * bias_stride + 8 * j + 2 * t);
        bv[j][2 * r] = x.x + kbv.x;
        bv[j][2 * r + 1] = x.y + kbv.y;
      }
    }
    wgmma_wait_all();
    fence_acc(s);
    fence_acc(dp);
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = c >> 1;
        s[j][c] = k0 + 8 * j + 2 * t + (c & 1) < L
                      ? ex2(fmaf(s[j][c] * scaling + bv[j][c], kLog2e, mo[r])) * inv[r]
                      : 0.f;
      }
  };

  // walk 1: rowsum(dp * p32); p32 kept in the region where it fits
  float dsr[2] = {0.f, 0.f};
  stage(0, true);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, true);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    with_width(width(it), [&](auto n8c) {
      constexpr int kN8 = decltype(n8c)::value;
      // every warp goes on (rows past L are not stored): an early return here
      // made ptxas serialise the wgmmas (C7517)
      float s[8][4], dp[8][4];
      p32_dp(n8c, s, dp, it);
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) dsr[c >> 1] += s[j][c] * dp[j][c];
      if constexpr (kResident) {
        float* rt = region + it * kTile + 2 * t;
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(rt + lr[r] * stride + 8 * j) =
                make_float2(s[j][2 * r], s[j][2 * r + 1]);
      }
    });
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    dsr[r] += __shfl_xor_sync(0xffffffffu, dsr[r], 1);
    dsr[r] += __shfl_xor_sync(0xffffffffu, dsr[r], 2);
  }
  if (live && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < L) dsum[bh * L + rows[r]] = dsr[r];
  }

  // walk 2: ds = p32 (dp - rowsum), dq += round(ds * scaling) k
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  stage(0, !kResident);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, !kResident);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    with_width(width(it), [&](auto n8c) {
      constexpr int kN8 = decltype(n8c)::value;
      const int buf = it & 1;
      float s[8][4], dp[8][4];
      if constexpr (kResident) {
        issue_nt<kN8, T>(dp, ga, vs + buf * kTileBytes);
        const float* rt = region + it * kTile + 2 * t;
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float2 x = *reinterpret_cast<const float2*>(rt + cr[r] * stride + 8 * j);
            s[j][2 * r] = x.x;
            s[j][2 * r + 1] = x.y;
          }
        wgmma_wait_all();
        fence_acc(dp);
      } else {
        p32_dp(n8c, s, dp, it);
      }
      uint32_t dsa[4][4];
      if (live) {
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[j][c] = s[j][c] * (dp[j][c] - dsr[c >> 1]) * scaling;
        pack_a<kN8 / 2, T>(dsa, s);
      } else {
        zero_a(dsa);
      }
      issue_nn<kN8 / 2, T>(o, dsa, ks + buf * kTileBytes);
      wgmma_wait_all();
      fence_acc(o);
    });
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }
  store_rows<T>(dq + base, o, rows, L, row_stride);
}

// ---------------------------------------------------------------------------
// bf16 / fp16 (T) dk/dv kernel: keys [16w, 16w + 16) of the block's key tile in warp w;
// scores are transposed (rows keys, columns queries).
// kDbias: 0 no bias or a batched one (ds stored once), 1 a shared bias summed
// in the shared slab, 2 a shared bias summed in device memory per row.
// ---------------------------------------------------------------------------

template <typename T, int kDbias>
__global__ void __launch_bounds__(128, 2)
attn_bwd_dkv_wgmma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const T* __restrict__ g, const float* __restrict__ bias, int bias_batched,
                   const float* __restrict__ key_bias, const float* __restrict__ stats,
                   const float* __restrict__ dsum, T* __restrict__ dk, T* __restrict__ dv,
                   float* __restrict__ dbias, int B, int L, int H, float scaling, int b_chunk,
                   int n_tiles, int tail, int slab_stride) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = aligned_smem(dyn_smem);
  unsigned char* qs = smem;                   // [2] swizzled Q tiles (K first)
  unsigned char* gs = smem + 2 * kTileBytes;  // [2] swizzled G tiles (V first)
  float* slab = reinterpret_cast<float*>(smem + 4 * kTileBytes);  // kDbias 1: [64][slab_stride]
  // m, 1/l, rowsum(dp * p32) of the q tile's rows.  bwd_plan counts these
  // bytes as DKV_STATIC_SMEM (ops/flash_attention.py), which the wrapper
  // holds equal to one_peace_bwd_dkv_static_smem() when it loads the library.
  __shared__ float st[2][3][kTile];

  const int k0 = blockIdx.x * kTile, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const int b_first = blockIdx.z * b_chunk, b_end = min(B, b_first + b_chunk);
  const int nkeys = min(kTile, L - k0);
  const bool live = warp * 16 < nkeys;
  const int kr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int keys[2] = {k0 + kr[0], k0 + kr[1]};
  const int ck[2] = {min(keys[0], L - 1), min(keys[1], L - 1)};
  const size_t plane = static_cast<size_t>(B) * H * L;
  // a shared bias's chunk z writes plane z of the partial sums
  float* dbias_z = kDbias == 0 ? nullptr
      : dbias + (static_cast<size_t>(blockIdx.z) * H + h) * L * L;
  auto width = [&](int it) { return it + 1 < n_tiles ? kTile : tail; };

  if constexpr (kDbias == 1) {
    for (int i = threadIdx.x; i < kTile * slab_stride; i += 128) slab[i] = 0.f;
  }
  for (int b = b_first; b < b_end; ++b) {
    const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
    const size_t bh = static_cast<size_t>(b) * H + h;
    const float* bias_bh = bias == nullptr ? nullptr
        : bias + static_cast<size_t>(bias_batched ? bh : h) * L * L;
    const float kbr[2] = {key_bias == nullptr ? 0.f : key_bias[static_cast<size_t>(b) * L + ck[0]],
                          key_bias == nullptr ? 0.f : key_bias[static_cast<size_t>(b) * L + ck[1]]};
    auto load_stats = [&](int buf, int q0) {
      for (int i = threadIdx.x; i < 3 * kTile; i += 128) {
        const int which = i >> 6, r = i & (kTile - 1);
        const bool valid = q0 + r < L;
        const float* src = which < 2 ? stats + which * plane + bh * L : dsum + bh * L;
        cp_async_4(&st[buf][which][r], src + (valid ? q0 + r : 0), valid);
      }
    };

    __syncthreads();  // the previous batch row's buffers are consumed (and the slab zeroed)
    load_tile_async(qs + kTileBytes, k + base, k0, L, row_stride);
    load_tile_async(gs + kTileBytes, v + base, k0, L, row_stride);
    load_tile_async(qs, q + base, 0, L, row_stride);
    load_tile_async(gs, g + base, 0, L, row_stride);
    load_stats(0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
    uint32_t ka[4][4], va[4][4];
    read_a_frags(ka, qs + kTileBytes);
    read_a_frags(va, gs + kTileBytes);
    __syncthreads();  // staging buffers free before tile 1 is prefetched

    float dk_acc[8][4], dv_acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const int q0 = it * kTile, cur = it & 1;
      unsigned char* qc = qs + cur * kTileBytes;
      unsigned char* gc = gs + cur * kTileBytes;
      if (it + 1 < n_tiles) {
        load_tile_async(qs + (cur ^ 1) * kTileBytes, q + base, q0 + kTile, L, row_stride);
        load_tile_async(gs + (cur ^ 1) * kTileBytes, g + base, q0 + kTile, L, row_stride);
        load_stats(cur ^ 1, q0 + kTile);
      }
      cp_async_commit();
      cp_async_wait_prev();
      fence_async_shared();
      __syncthreads();
      with_width(width(it), [&](auto n8c) {
        constexpr int kN8 = decltype(n8c)::value;
        float s[8][4], dp[8][4];
        issue_nt<kN8, T>(s, ka, qc);  // s^T = k q^T, while the bias is read
        // no branch between a product's issue and its wait (ptxas serialised
        // the wgmmas behind one); one accumulator pair at a time in flight
        // beside dk and dv, or the kernel spilled
        float bv[kN8][4];  // bias^T + key bias
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int query = min(q0 + 8 * j + 2 * t + (c & 1), L - 1);
            bv[j][c] = (bias_bh != nullptr
                            ? __ldg(bias_bh + static_cast<size_t>(query) * L + ck[c >> 1])
                            : 0.f) + kbr[c >> 1];
          }
        wgmma_wait_all();
        fence_acc(s);
        uint32_t pa[4][4];
        if (live) {
#pragma unroll
          for (int j = 0; j < kN8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int qi = 8 * j + 2 * t + (c & 1);
              s[j][c] = keys[c >> 1] < L && q0 + qi < L
                            ? ex2(fmaf(s[j][c] * scaling + bv[j][c], kLog2e,
                                       -st[cur][0][qi] * kLog2e)) * st[cur][1][qi]
                            : 0.f;  // p32^T
            }
          pack_a<kN8 / 2, T>(pa, s);
        } else {
          zero_a(pa);
        }
        issue_nn<kN8 / 2, T>(dv_acc, pa, gc);  // dv += round(p)^T g
        issue_nt<kN8, T>(dp, va, gc);          // dp^T = v g^T
        wgmma_wait_all();
        fence_acc(dv_acc);
        fence_acc(dp);
        uint32_t dsa[4][4];
        if (live) {
#pragma unroll
          for (int j = 0; j < kN8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dp[j][c] = s[j][c] * (dp[j][c] - st[cur][2][8 * j + 2 * t + (c & 1)]);  // ds^T
          if constexpr (kDbias == 0) {
            if (dbias != nullptr) {  // a batched bias: this (b, h)'s ds, stored once
              float* d = dbias + bh * L * L;
#pragma unroll
              for (int j = 0; j < kN8; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                  const int query = q0 + 8 * j + 2 * t + (c & 1);
                  if (keys[c >> 1] < L && query < L)
                    d[static_cast<size_t>(query) * L + keys[c >> 1]] = dp[j][c];
                }
            }
          } else if constexpr (kDbias == 1) {  // one owner thread per slab element
#pragma unroll
            for (int j = 0; j < kN8; ++j)
#pragma unroll
              for (int r = 0; r < 2; ++r) {
                float2* p = reinterpret_cast<float2*>(slab + kr[r] * slab_stride + q0 + 8 * j +
                                                      2 * t);
                float2 x = *p;
                x.x += dp[j][2 * r];
                x.y += dp[j][2 * r + 1];
                *p = x;
              }
          } else {
#pragma unroll
            for (int j = 0; j < kN8; ++j)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int query = q0 + 8 * j + 2 * t + (c & 1);
                if (keys[c >> 1] < L && query < L) {
                  float* d = dbias_z + static_cast<size_t>(query) * L + keys[c >> 1];
                  *d = b > b_first ? *d + dp[j][c] : dp[j][c];
                }
              }
          }
#pragma unroll
          for (int j = 0; j < kN8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) dp[j][c] *= scaling;
          pack_a<kN8 / 2, T>(dsa, dp);
        } else {
          zero_a(dsa);
        }
        issue_nn<kN8 / 2, T>(dk_acc, dsa, qc);  // dk += round(ds * scaling)^T q
        wgmma_wait_all();
        fence_acc(dk_acc);
      });
      __syncthreads();  // tile it is consumed before its buffers are refilled
    }
    store_rows<T>(dk + base, dk_acc, keys, L, row_stride);
    store_rows<T>(dv + base, dv_acc, keys, L, row_stride);
  }
  if constexpr (kDbias == 1) {  // the chunk's sum, once: rows are queries, 64 keys a row
    __syncthreads();
    const int c = threadIdx.x & (kTile - 1);
    if (c < nkeys)
      for (int qi = threadIdx.x >> 6; qi < L; qi += 2)
        dbias_z[static_cast<size_t>(qi) * L + k0 + c] = slab[c * slab_stride + qi];
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
                float* __restrict__ stats, float* __restrict__ dsum_out, int B, int L, int H,
                float scaling) {
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
      dsum_out[off] = dsum[i];
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
                 const float* __restrict__ dsum, float* __restrict__ dk, float* __restrict__ dv,
                 float* __restrict__ dbias,
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
    const size_t bh_off = (static_cast<size_t>(b) * H + h) * L;

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
        st[i] = q0 + r >= L ? 0.f
                : which < 2 ? stats[which * plane + bh_off + q0 + r] : dsum[bh_off + q0 + r];
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


template <typename T, bool kResident>
cudaError_t launch_dq(const void* q, const void* k, const void* v, const void* g,
                      const float* bias, int bias_batched, const float* key_bias,
                      const float* stats, void* dq, float* dsum, dim3 grid, int L, int heads,
                      float scaling, const TilePlan& plan, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dq_wgmma<T, kResident>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dq_wgmma<T, kResident><<<grid, 128, plan.smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), bias, bias_batched, key_bias, stats, static_cast<T*>(dq), dsum,
      L, heads, scaling, plan);
  return cudaGetLastError();
}

template <typename T, int kDbias>
cudaError_t launch_dkv(const void* q, const void* k, const void* v, const void* g,
                       const float* bias, int bias_batched, const float* key_bias,
                       const float* stats, const float* dsum, void* dk, void* dv, float* dbias,
                       dim3 grid, int batch, int L, int heads, float scaling, int b_chunk,
                       const TilePlan& plan, int slab_stride, int smem, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attn_bwd_dkv_wgmma<T, kDbias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  attn_bwd_dkv_wgmma<T, kDbias><<<grid, 128, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), bias, bias_batched, key_bias, stats, dsum, static_cast<T*>(dk),
      static_cast<T*>(dv), dbias, batch, L, heads, scaling, b_chunk, plan.n_tiles, plan.tail,
      slab_stride);
  return cudaGetLastError();
}

// The bf16 or fp16 (T) kernels of one backward: the dq kernel (passes & 1)
// and the dk/dv kernel (passes & 2) on their plans.
template <typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* g,
                         const float* bias, int bias_batched, const float* key_bias,
                         const float* stats, float* dsum, void* dq, void* dk, void* dv,
                         float* dbias_out, dim3 grid_dq, dim3 grid_dkv, int batch, int L,
                         int heads, float scaling, int passes, const TilePlan& plan,
                         bool shared_bias, int dkv_slab, int dkv_smem, int b_chunk,
                         cudaStream_t s) {
  cudaError_t err = cudaSuccess;
  if (passes & 1) {
    err = plan.resident ? launch_dq<T, true>(q, k, v, g, bias, bias_batched, key_bias, stats,
                                             dq, dsum, grid_dq, L, heads, scaling, plan, s)
                        : launch_dq<T, false>(q, k, v, g, bias, bias_batched, key_bias, stats,
                                              dq, dsum, grid_dq, L, heads, scaling, plan, s);
    if (err != cudaSuccess) return err;
  }
  if (passes & 2) {
    const int width = kTile * (plan.n_tiles - 1) + plan.tail;
    if (dkv_slab)
      err = launch_dkv<T, 1>(q, k, v, g, bias, bias_batched, key_bias, stats, dsum, dk, dv,
                             dbias_out, grid_dkv, batch, L, heads, scaling, b_chunk, plan,
                             width + 8, dkv_smem, s);
    else if (shared_bias)
      err = launch_dkv<T, 2>(q, k, v, g, bias, bias_batched, key_bias, stats, dsum, dk, dv,
                             dbias_out, grid_dkv, batch, L, heads, scaling, b_chunk, plan, 0,
                             dkv_smem, s);
    else
      err = launch_dkv<T, 0>(q, k, v, g, bias, bias_batched, key_bias, stats, dsum, dk, dv,
                             dbias_out, grid_dkv, batch, L, heads, scaling, b_chunk, plan, 0,
                             dkv_smem, s);
  }
  return err;
}

}  // namespace

// Launches the kernels on `stream` and returns cudaGetLastError() (0 on
// success).  q, k, v, g, dq, dk, dv: (batch, seq_len, heads * 64), of the
// dtype `dtype` names: 0 fp32, 1 bf16, 2 fp16.  bias and dbias: fp32 (heads,
// L, L), or (batch, heads, L, L) when bias_batched, or both null.  key_bias:
// fp32 (batch, L) or null.  stats: fp32 (2, batch, heads, L), each row's max
// and 1 / sum: the forward's, read by the bf16 and fp16 kernels; scratch that
// the fp32 kernels write.  dsum: fp32 scratch of batch * heads * L.  passes:
// a bit mask, 1 the dq kernel, 2 the dk/dv kernel (and the chunk sum).
// n_tiles, tail, resident, stride and dq_smem: the bf16 / fp16 dq kernel's
// plan (ops/flash_attention.py:tile_plan); dkv_slab, dkv_smem and b_chunk: the dk/dv kernel's
// (bwd_plan); a launch whose plan differs from the one for seq_len is
// refused with cudaErrorInvalidValue.  b_chunk: batch rows per dk/dv block
// (a shared bias's chunk; otherwise 1, or more where ceil(batch / b_chunk)
// chunks would pass grid z's 65535, which is refused); with a shared bias
// and more than one chunk, partial is fp32 scratch of ceil(batch / b_chunk)
// * heads * L * L.
extern "C" int one_peace_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* g, const void* bias,
    int bias_batched, const void* key_bias, void* dq, void* dk, void* dv, void* dbias,
    void* partial, void* stats, void* dsum, int batch, int seq_len, int heads, float scaling,
    int dtype, int passes, int n_tiles, int tail, int resident, int stride, int dq_smem,
    int dkv_slab, int dkv_smem, int b_chunk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool shared_bias = bias != nullptr && !bias_batched;
  if (b_chunk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (batch + b_chunk - 1) / b_chunk;
  if (chunks > 65535) return static_cast<int>(cudaErrorInvalidValue);  // grid z's limit
  // with several chunks, the dk/dv kernel writes partial sums of d(bias)
  float* dbias_out = shared_bias && chunks > 1 ? static_cast<float*>(partial)
                                               : static_cast<float*>(dbias);
  const int q_tiles = (seq_len + kTile - 1) / kTile;
  const dim3 grid_dq(batch, q_tiles, heads);
  const dim3 grid_dkv(q_tiles, heads, chunks);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const float* kbp = static_cast<const float*>(key_bias);
  float* st = static_cast<float*>(stats);
  float* ds = static_cast<float*>(dsum);
  if (dtype != 0 && dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0) {
    const TilePlan plan{n_tiles, tail, resident, stride, dq_smem};
    const int width = kTile * (n_tiles - 1) + tail;
    if (!plan_matches(plan, seq_len) || (dkv_slab && !shared_bias) ||
        dkv_smem != 4 * kTileBytes + (dkv_slab ? kTile * (width + 8) * 4 : 0) + kAlign)
      return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 1
              ? launch_wgmma<__nv_bfloat16>(q, k, v, g, bp, bias_batched, kbp, st, ds, dq, dk,
                                            dv, dbias_out, grid_dq, grid_dkv, batch, seq_len,
                                            heads, scaling, passes, plan, shared_bias, dkv_slab,
                                            dkv_smem, b_chunk, s)
              : launch_wgmma<__half>(q, k, v, g, bp, bias_batched, kbp, st, ds, dq, dk, dv,
                                     dbias_out, grid_dq, grid_dkv, batch, seq_len, heads,
                                     scaling, passes, plan, shared_bias, dkv_slab, dkv_smem,
                                     b_chunk, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    err = cudaFuncSetAttribute(attn_bwd_dq_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDqF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(attn_bwd_dkv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kDkvF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (passes & 1) {
      attn_bwd_dq_f32<<<grid_dq, 256, kDqF32Smem, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(g), bp, bias_batched, kbp,
          static_cast<float*>(dq), st, ds, batch, seq_len, heads, scaling);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (passes & 2) {
      attn_bwd_dkv_f32<<<grid_dkv, 256, kDkvF32Smem, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<const float*>(g), bp, bias_batched, kbp, st,
          ds, static_cast<float*>(dk), static_cast<float*>(dv), dbias_out, batch, seq_len, heads,
          scaling, b_chunk);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  if (dbias_out != dbias && (passes & 2)) {
    const size_t n = static_cast<size_t>(heads) * seq_len * seq_len;
    const int blocks = static_cast<int>(std::min<size_t>((n + 255) / 256, 4096));
    attn_bwd_sum_chunks<<<blocks, 256, 0, s>>>(dbias_out, static_cast<float*>(dbias), n, chunks);
  }
  return static_cast<int>(cudaGetLastError());
}

// The dk/dv kernel's static shared memory in bytes, the largest of its
// instantiations', or -1 if the attributes cannot be read.
extern "C" int one_peace_bwd_dkv_static_smem() {
  const void* kernels[] = {
      reinterpret_cast<const void*>(attn_bwd_dkv_wgmma<__nv_bfloat16, 0>),
      reinterpret_cast<const void*>(attn_bwd_dkv_wgmma<__nv_bfloat16, 1>),
      reinterpret_cast<const void*>(attn_bwd_dkv_wgmma<__half, 0>),
      reinterpret_cast<const void*>(attn_bwd_dkv_wgmma<__half, 1>)};
  size_t most = 0;
  for (const void* kernel : kernels) {
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
    most = std::max(most, attr.sharedSizeBytes);
  }
  return static_cast<int>(most);
}

extern "C" const char* one_peace_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
