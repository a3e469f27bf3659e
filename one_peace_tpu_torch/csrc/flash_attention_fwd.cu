// Fused bias-aware attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel one_peace_tpu/ops/flash_attention.py:239
// `_flash_fwd` / `_make_fwd_kernel`.  Per (batch b, head h) it computes
//
//   out = softmax(q k^T * scaling + rel_bias + key_bias) v
//
// on the (B, L, H*64) layout that the q/k/v projections produce, with the
// scores and the softmax in fp32 and the probabilities rounded to v's dtype
// before p.v, where the plain version casts them.  q, k, v and out are bf16,
// fp16 or fp32.  rel_bias is fp32
// (H, L, L) shared over the batch, fp32 (B, H, L, L), or absent; key_bias is
// fp32 (B, L) (-1e30 at padded keys) or absent.  out has q's dtype.  When a
// gradient will be taken it also writes each row's max m and 1 / sum
// (2, B, H, L) fp32: the backward starts from them.
//
// What bounds it on an H100 (4B geometry, H=24, Dh=64, per layer):
//   images, L=257, B=256: q.k^T + p.v = 4*B*H*L^2*Dh = 104 GFLOP (0.105 ms at
//     the 989 TFLOP/s bf16 peak); q, k, v and out are 808 MB of HBM traffic
//     (0.24 ms at 3.35 TB/s); every block also reads its 64 x L slice of the
//     bias, B*H*L^2*4 = 1.6 GB in all from L2 (the shared table is 6.3 MB).
//   audio, L=500, B=32: 49 GFLOP, 197 MB of q/k/v/out, 768 MB of bias reads.
// So the kernel is bound by bytes (q/k/v/out in HBM, the bias through L2)
// and by the latency of short per-score work, not by the tensor cores.  The
// first port walked the key tiles twice, computing q.k^T, reading the
// bias and taking exp twice per score, on 64-wide tiles whether or not their
// keys exist (25 tile pairs for 16.1 of work at L=257), on mma.sync.
//
// What this design does (ops/flash_attention.py:tile_plan):
//   - one block, one warpgroup, per (batch, 64-row q tile, head), batch in
//     blockIdx.x, so the blocks in flight read the same bias rows from L2;
//   - one walk over the key tiles where two row blocks fit on an SM (L <=
//     304: 64 rows of the padded width + 8 floats, 72 KB at L=257, beside
//     four K/V tiles): each tile's bias rows are copied by cp.async into the
//     block's region of shared memory a tile ahead, q.k^T runs on wgmma (Q
//     from registers, K from a 128-byte-swizzled tile), the bias is read from
//     the region while it runs, and the biased scores go back into the region
//     in place of the bias.  Then, in registers and shared memory only, m,
//     one exp per score and l; then p = exp(s - m) / l rounded to bf16
//     exactly where the plain version rounds it, and p.v on wgmma over V
//     tiles streamed by cp.async.  One q.k^T, one bias read, one exp per
//     score (on an H100 80GB HBM3 at 700 W, 0.040 against 0.049 ms in two
//     walks at L=71, B=32; a tie at L=257, B=256, 1.764 against 1.762;
//     PERF.md);
//   - longer sequences walk twice (online m and l first, then p.v), each
//     tile's bias staged a tile ahead in one of two 64 x 72 float buffers and
//     read while q.k^T runs: the same function with the same rounding points;
//     only the order of l's fp32 sum differs between the branches.  With the
//     row block resident at L=500 the kernel ran one block per SM and lost to
//     the first port, and reading the bias per score from device memory in
//     the two walks cost a third more than staging it (PERF.md);
//   - ragged tails at their own width: the last key tile is as wide as its
//     keys rounded up to 16 (wgmma m64nNk16, N = 16, 32, 48 or 64, and p.v
//     only 16 * ceil(keys / 16) deep; each width compiled apart), and in the
//     last q tile the warps whose 16 rows all lie past L take part only in
//     the warpgroup's wgmma: no bias, no exp, no stores;
//   - fp16 inputs (the fp16 training and serving path) run the bf16 design
//     unchanged, templated on the element type: the same 2-byte tiles,
//     swizzle and fragments, wgmma's .f16 form, p rounded to fp16 before
//     p.v as the plain version rounds it (fp16 keeps 3 more mantissa bits
//     than bf16, so p.v is closer to fp32);
//   - fp32 inputs (the test path) use CUDA-core FMA and a one-pass online
//     softmax (nothing is rounded, so the order does not matter).
// Not done yet: TMA for K, V; 128-row q tiles (half the K/V traffic); a row
// block for the last q tile narrower than 64 (its idle warps still issue the
// warpgroup's products); overlapping one tile's p.v with the next q.k^T.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

namespace {

constexpr int kBlockM = kTile;           // query rows per block
constexpr int kBlockN = kTile;           // keys per K/V tile
constexpr int kF32Stride = kHeadDim + 1; // fp32 smem row stride: no bank conflicts

__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int row0, int L, int row_stride) {
  for (int i = threadIdx.x; i < kBlockM * kHeadDim; i += blockDim.x) {
    const int r = i / kHeadDim, c = i % kHeadDim;
    dst[r * kF32Stride + c] =
        row0 + r < L ? src[static_cast<size_t>(row0 + r) * row_stride + c] : 0.f;
  }
}

// Score of (row, col) after scaling, bias and masking.
__device__ __forceinline__ float biased_score(float acc, int row, int col, int L,
                                              float scaling, const float* bias_bh,
                                              const float* kb) {
  if (col >= L) return kNegInf;
  float x = acc * scaling;
  if (bias_bh != nullptr && row < L) x += __ldg(bias_bh + static_cast<size_t>(row) * L + col);
  if (kb != nullptr) x += __ldg(kb + col);
  return x;
}

// 4 warps; warp w owns query rows [16w, 16w + 16) of the block's tile.
// T: bf16 or fp16.  kResident: one walk, the scores kept in the region (see
// the header).
template <typename T, bool kResident>
__global__ void __launch_bounds__(128, 2)
attn_fwd_wgmma(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const float* __restrict__ bias, int bias_batched,
               const float* __restrict__ key_bias, T* __restrict__ out,
               float* __restrict__ stats, int L, int H, float scaling, TilePlan plan) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  unsigned char* smem = aligned_smem(dyn_smem);
  unsigned char* ks = smem;                   // [2] swizzled K tiles
  unsigned char* vs = smem + 2 * kTileBytes;  // [2] swizzled V tiles (Q first)
  // the row block's scores (kResident), or two staged bias tiles of kStageStride
  float* region = reinterpret_cast<float*>(smem + 4 * kTileBytes);

  const int b = blockIdx.x, q0 = blockIdx.y * kBlockM, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, t = lane & 3;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const size_t bh = static_cast<size_t>(b) * H + h;
  const float* bias_q = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? bh : h) * L + q0) * L;  // the block's rows
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;
  const int nrows = min(kBlockM, L - q0), n_tiles = plan.n_tiles, stride = plan.stride;
  const bool live = warp * 16 < nrows;  // a warp with no row < L only joins the wgmmas
  const int lr[2] = {warp * 16 + (lane >> 2), warp * 16 + (lane >> 2) + 8};
  const int rows[2] = {q0 + lr[0], q0 + lr[1]};
  const int cr[2] = {min(lr[0], nrows - 1), min(lr[1], nrows - 1)};  // rows >= L read row L-1

  load_tile_async(vs, q + base, q0, L, row_stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  uint32_t qa[4][4];
  read_a_frags(qa, vs);
  __syncthreads();

  auto width = [&](int it) { return it + 1 < n_tiles ? kBlockN : plan.tail; };
  // key tile it's bias rows: its columns of the region, or a staging buffer
  auto bias_tile = [&](int it) {
    return kResident ? region + it * kBlockN : region + (it & 1) * kBlockM * kStageStride;
  };
  const int bias_stride = kResident ? stride : kStageStride;
  // K and V tiles of key tile it, and its bias
  auto stage = [&](int it, bool with_k, bool with_v, bool with_bias) {
    const int buf = it & 1, k0 = it * kBlockN;
    if (with_k) load_tile_async(ks + buf * kTileBytes, k + base, k0, L, row_stride);
    if (with_v) load_tile_async(vs + buf * kTileBytes, v + base, k0, L, row_stride);
    if (with_bias && bias_q != nullptr)
      stage_bias(bias_tile(it), bias_stride, bias_q + k0, nrows, min(kBlockN, L - k0), L);
  };
  // s = q k^T * scaling + bias + key_bias for key tile it, 8 kN8 keys wide
  // (-1e30 at keys >= L); the staged bias is read while q.k^T runs
  auto scores = [&](auto n8c, float s[8][4], int it) {
    constexpr int kN8 = decltype(n8c)::value;
    const int k0 = it * kBlockN;
    issue_nt<kN8, T>(s, qa, ks + (it & 1) * kTileBytes);
    // no branch between a product's issue and its wait (ptxas serialised the
    // wgmmas behind one): every warp reads the bias, at rows clamped below L
    float bv[kN8][4];
#pragma unroll
    for (int j = 0; j < kN8; ++j) {
      const int col = k0 + 8 * j + 2 * t;
      float2 kbv = make_float2(0.f, 0.f);
      if (kb != nullptr)  // key_bias is 0 or -1e30: adding it first rounds alike
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
#pragma unroll
    for (int j = 0; j < kN8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[j][c] = k0 + 8 * j + 2 * t + (c & 1) < L ? s[j][c] * scaling + bv[j][c] : kNegInf;
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // walk 1: the scores, kept in the region, and each row's max; or, in two
  // walks, the running max and sum
  stage(0, true, false, true);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, true, false, true);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    with_width(width(it), [&](auto n8c) {
      constexpr int kN8 = decltype(n8c)::value;
      float s[8][4];
      scores(n8c, s, it);
      if (!live) return;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kN8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      if constexpr (kResident) {
        float* rt = region + it * kBlockN + 2 * t;
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float2*>(rt + lr[r] * stride + 8 * j) =
                make_float2(s[j][2 * r], s[j][2 * r + 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) m[r] = fmaxf(m[r], mx[r]);
      } else {
        float rs[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(m[r], fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2)));
        }
        const float off[2] = {-mx[0] * kLog2e, -mx[1] * kLog2e};
#pragma unroll
        for (int j = 0; j < kN8; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) rs[c >> 1] += ex2(fmaf(s[j][c], kLog2e, off[c >> 1]));
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
          rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
          l[r] = l[r] * ex2((m[r] - mx[r]) * kLog2e) + rs[r];  // exactly l when m holds
          m[r] = mx[r];
        }
      }
    });
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }

  if constexpr (kResident) {
    stage(0, false, true, false);  // V tile 0 loads while the exps run
    cp_async_commit();
    // walk 2, over the region: e = exp(s - m) in place, l = sum of e
    if (live) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      }
      const float off[2] = {-m[0] * kLog2e, -m[1] * kLog2e};
      const int n8 = (kBlockN * (n_tiles - 1) + plan.tail) >> 3;
      for (int j = 0; j < n8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float2* p = reinterpret_cast<float2*>(region + lr[r] * stride + 8 * j + 2 * t);
          float2 x = *p;
          x.x = ex2(fmaf(x.x, kLog2e, off[r]));
          x.y = ex2(fmaf(x.y, kLog2e, off[r]));
          *p = x;
          l[r] += x.x + x.y;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      }
    }
  } else {
    stage(0, true, true, true);
    cp_async_commit();
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  if (stats != nullptr && live && t == 0) {
    const size_t plane = static_cast<size_t>(gridDim.x) * H * L;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (rows[r] < L) {
        stats[bh * L + rows[r]] = m[r];
        stats[plane + bh * L + rows[r]] = inv[r];
      }
  }

  // walk 3: P = exp(s - m) / l, rounded to T, times V
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  const float off[2] = {-m[0] * kLog2e, -m[1] * kLog2e};
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage(it + 1, !kResident, true, !kResident);
    cp_async_commit();
    cp_async_wait_prev();
    fence_async_shared();
    __syncthreads();
    with_width(width(it), [&](auto n8c) {
      constexpr int kN8 = decltype(n8c)::value;
      float p[8][4];
      if constexpr (kResident) {
        if (live) {
          const float* rt = region + it * kBlockN + 2 * t;
#pragma unroll
          for (int j = 0; j < kN8; ++j)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const float2 x = *reinterpret_cast<const float2*>(rt + lr[r] * stride + 8 * j);
              p[j][2 * r] = x.x * inv[r];
              p[j][2 * r + 1] = x.y * inv[r];
            }
        }
      } else {
        scores(n8c, p, it);
        if (live) {
#pragma unroll
          for (int j = 0; j < kN8; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              p[j][c] = ex2(fmaf(p[j][c], kLog2e, off[c >> 1])) * inv[c >> 1];
        }
      }
      uint32_t pa[4][4];
      if (live)
        pack_a<kN8 / 2, T>(pa, p);
      else
        zero_a(pa);
      issue_nn<kN8 / 2, T>(o, pa, vs + (it & 1) * kTileBytes);
      wgmma_wait_all();
      fence_acc(o);
    });
    __syncthreads();  // tile it is consumed before its buffers are refilled
  }
  store_rows<T>(out + base, o, rows, L, row_stride);
}

// 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 and, of each
// 64-wide tile, columns tx, tx+16, tx+32, tx+48.
constexpr size_t kF32Smem = 4 * kBlockM * kF32Stride * sizeof(float);

__global__ void __launch_bounds__(256)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             int bias_batched, const float* __restrict__ key_bias,
             float* __restrict__ out, float* __restrict__ stats, int L, int H,
             float scaling) {
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockM * kF32Stride;
  float* vs = ks + kBlockN * kF32Stride;
  float* ps = vs + kBlockN * kF32Stride;

  const int b = blockIdx.x, q0 = blockIdx.y * kBlockM, h = blockIdx.z;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const float* bias_bh = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? b * H : 0) + h) * L * L;
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;

  load_tile_f32(qs, q + base, q0, L, row_stride);

  float o[4][4], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < L; k0 += kBlockN) {
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    load_tile_f32(ks, k + base, k0, L, row_stride);
    load_tile_f32(vs, v + base, k0, L, row_stride);
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
      const int row = q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = biased_score(s[i][j], row, k0 + tx + 16 * j, L, scaling, bias_bh, kb);
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
    if (stats != nullptr && tx == 0) {
      const size_t off = (static_cast<size_t>(b) * H + h) * L + row;
      stats[off] = m[i];
      stats[static_cast<size_t>(gridDim.x) * H * L + off] = inv;
    }
  }
}


template <typename T, bool kResident>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const float* bias,
                         int bias_batched, const float* key_bias, void* out, float* stats,
                         dim3 grid, int L, int heads, float scaling, const TilePlan& plan,
                         cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wgmma<T, kResident>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, plan.smem);
  if (err != cudaSuccess) return err;
  attn_fwd_wgmma<T, kResident><<<grid, 128, plan.smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      bias_batched, key_bias, static_cast<T*>(out), stats, L, heads, scaling, plan);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wgmma(bool resident, const void* q, const void* k, const void* v,
                         const float* bias, int bias_batched, const float* key_bias, void* out,
                         float* stats, dim3 grid, int L, int heads, float scaling,
                         const TilePlan& plan, cudaStream_t s) {
  return resident ? launch_wgmma<T, true>(q, k, v, bias, bias_batched, key_bias, out, stats,
                                          grid, L, heads, scaling, plan, s)
                  : launch_wgmma<T, false>(q, k, v, bias, bias_batched, key_bias, out, stats,
                                           grid, L, heads, scaling, plan, s);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, out: (batch, seq_len, heads * 64), of the dtype `dtype` names:
// 0 fp32, 1 bf16, 2 fp16 (ops/build.py:DTYPE_CODES).
// bias: fp32 (heads, L, L), or (batch, heads, L, L) when bias_batched, or null.
// key_bias: fp32 (batch, L) or null.  stats: fp32 (2, batch, heads, L) for each
// row's max and 1 / sum, or null.  n_tiles, tail, resident, stride and
// smem_bytes: the bf16 and fp16 kernel's plan (ops/flash_attention.py:tile_plan); a
// launch whose plan differs from the one for seq_len is refused with
// cudaErrorInvalidValue.  The fp32 kernel ignores them.
extern "C" int one_peace_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, int bias_batched,
    const void* key_bias, void* out, void* stats, int batch, int seq_len, int heads,
    float scaling, int dtype, int n_tiles, int tail, int resident, int stride,
    int smem_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (seq_len + kBlockM - 1) / kBlockM, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bp = static_cast<const float*>(bias);
  const float* kbp = static_cast<const float*>(key_bias);
  float* st = static_cast<float*>(stats);
  if (dtype != 0 && dtype != 1 && dtype != 2) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0) {
    const TilePlan plan{n_tiles, tail, resident, stride, smem_bytes};
    if (!plan_matches(plan, seq_len)) return static_cast<int>(cudaErrorInvalidValue);
    err = dtype == 1
              ? launch_wgmma<__nv_bfloat16>(resident, q, k, v, bp, bias_batched, kbp, out, st,
                                            grid, seq_len, heads, scaling, plan, s)
              : launch_wgmma<__half>(resident, q, k, v, bp, bias_batched, kbp, out, st, grid,
                                     seq_len, heads, scaling, plan, s);
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kF32Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attn_fwd_f32<<<grid, 256, kF32Smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      bp, bias_batched, kbp, static_cast<float*>(out), st, seq_len, heads, scaling);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* one_peace_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
