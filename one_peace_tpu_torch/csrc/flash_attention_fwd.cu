// Fused bias-aware attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel one_peace_tpu/ops/flash_attention.py
// `_flash_fwd` / `_make_fwd_kernel`.  Per (batch b, head h) it computes
//
//   out = softmax(q k^T * scaling + rel_bias + key_bias) v
//
// on the (B, L, H*64) layout that the q/k/v projections produce, with the
// scores and the softmax in fp32.  rel_bias is fp32 (H, L, L) shared over the
// batch, fp32 (B, H, L, L), or absent; key_bias is fp32 (B, L) (-1e30 at
// padded keys) or absent.  out has q's dtype.
//
// What bounds it on an H100 (4B geometry, H=24, Dh=64, per layer):
//   images, L=257, B=256: q.k^T + p.v = 4*B*H*L^2*Dh = 104 GFLOP (0.105 ms at
//     the 989 TFLOP/s bf16 peak); q, k, v and out are 808 MB of HBM traffic
//     (0.24 ms at 3.35 TB/s); every block also reads its 64 x L slice of the
//     bias, B*H*L^2*4 = 1.6 GB in all, of which only the 6.3 MB shared table
//     has to come from HBM.
//   audio, L=500, B=32: 49 GFLOP (0.05 ms at peak), 197 MB of q/k/v/out
//     (0.06 ms), 768 MB of bias reads over a 24 MB shared table.
// So at these short sequences the kernel is bound by bytes, not FLOPs: the
// q/k/v/out traffic in HBM and the bias reads that must hit L2.
//
// What this design does about it:
//   - one block per (batch, 64-row q tile, head), batch in blockIdx.x: the
//     blocks that run together read the same (head, q tile) rows of a shared
//     bias, so those rows are served from L2 (the Hopper analogue of the TPU
//     kernel's batch-innermost grid);
//   - q is read once per block in 16-byte loads and the (L, L) scores never
//     leave registers: the block walks 64-key tiles of K (and V) staged in
//     shared memory, double-buffered with cp.async so the next tile loads
//     while this one computes, with the softmax statistics (row max and sum)
//     in fp32;
//   - the bias is read straight from global memory in the mma accumulator
//     layout (4 lanes cover 32 contiguous bytes of a row), all 32 loads of a
//     tile issued before its MMAs, at clamped addresses and without
//     branches; key columns >= L are masked in the kernel.  Issued one by
//     one behind their branches, the bias loads had made the kernel 1.7x
//     slower (PERF.md);
//   - bf16 inputs use the tensor cores through mma.sync m16n8k16 with fp32
//     accumulation, in two passes over the key tiles: the first finds each
//     row's max and sum, the second rounds the normalised P to bf16 before
//     P.V, exactly where the plain version casts its fp32 probabilities to
//     v's dtype.  A one-pass online softmax rounds the unnormalised P
//     instead, and its bf16 embeddings of the 40-layer model drifted from
//     the plain path's almost to the 0.999 cosine bound (PERF.md).  The
//     second pass reads K and the bias again;
//   - fp32 inputs use CUDA-core FMA and a one-pass online softmax (nothing
//     is rounded, so the order does not matter).
// Not done yet: wgmma, TMA, warp specialisation, and a single pass that keeps
// a row block's scores in shared memory where they fit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kBlockM = 64;              // query rows per block
constexpr int kBlockN = 64;              // keys per K/V tile
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
  for (int i = threadIdx.x; i < kBlockM * 8; i += blockDim.x) {
    const int r = i >> 3, c = i & 7;
    const bool valid = row0 + r < L;
    cp_async_16(dst + r * kStride + c * 8,
                src + static_cast<size_t>(valid ? row0 + r : 0) * row_stride + c * 8, valid);
  }
}

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

// One warp's 16 x 64 tile of scaled, biased and masked scores against the
// K tile in shared memory, in the mma accumulator layout: s[j][c] is row
// rows[c >> 1], key k0 + 8j + 2t + (c & 1).  The bias loads are issued
// first, branch-free at clamped addresses, so they overlap the MMAs.
__device__ __forceinline__ void score_tile(float s[8][4], const uint32_t qa[4][4],
                                           const __nv_bfloat16* ks, const int rows[2],
                                           int k0, int L, float scaling,
                                           const float* bias_bh, const float* kb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float bv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = min(rows[c >> 1], L - 1), col = min(k0 + j * 8 + 2 * t + (c & 1), L - 1);
      // key_bias is 0 or -1e30, so adding it to the bias first rounds alike
      bv[j][c] = (bias_bh != nullptr ? __ldg(bias_bh + static_cast<size_t>(row) * L + col) : 0.f) +
                 (kb != nullptr ? __ldg(kb + col) : 0.f);
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    const __nv_bfloat16* kp = ks + (j * 8 + g) * kStride + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp + kk * 16),
                *reinterpret_cast<const uint32_t*>(kp + kk * 16 + 8));
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[j][c] = k0 + j * 8 + 2 * t + (c & 1) < L ? s[j][c] * scaling + bv[j][c] : kNegInf;
  }
}

// 4 warps; warp w owns query rows [16w, 16w + 16) of the block's tile.
__global__ void __launch_bounds__(128)
attn_fwd_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
              int bias_batched, const float* __restrict__ key_bias,
              __nv_bfloat16* __restrict__ out, int L, int H, float scaling) {
  __shared__ __align__(16) __nv_bfloat16 qs[kBlockM * kStride];
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBlockN * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBlockN * kStride];

  const int b = blockIdx.x, q0 = blockIdx.y * kBlockM, h = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row group / column pair
  const int row_stride = H * kHeadDim;
  const size_t base = static_cast<size_t>(b) * L * row_stride + static_cast<size_t>(h) * kHeadDim;
  const float* bias_bh = bias == nullptr ? nullptr
      : bias + (static_cast<size_t>(bias_batched ? b * H : 0) + h) * L * L;
  const float* kb = key_bias == nullptr ? nullptr : key_bias + static_cast<size_t>(b) * L;

  load_tile_async(qs, q + base, q0, L, row_stride);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  const int qr = warp * 16 + g;
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p0 = qs + qr * kStride + kk * 16 + 2 * t;
    const __nv_bfloat16* p1 = p0 + 8 * kStride;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
  }
  const int rows[2] = {q0 + qr, q0 + qr + 8};
  float s[8][4];

  // pass 1: running max m and sum l of exp(s - m) per row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_tiles = (L + kBlockN - 1) / kBlockN;
  load_tile_async(ks[0], k + base, 0, L, row_stride);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    if (it + 1 < n_tiles) load_tile_async(ks[(it + 1) & 1], k + base, k0 + kBlockN, L, row_stride);
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    score_tile(s, qa, ks[it & 1], rows, k0, L, scaling, bias_bh, kb);
    float mx[2] = {m[0], m[1]}, rs[2] = {0.f, 0.f};
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
      for (int c = 0; c < 4; ++c) rs[c >> 1] += __expf(s[j][c] - mx[c >> 1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = l[r] * __expf(m[r] - mx[r]) + rs[r];
      m[r] = mx[r];
    }
    __syncthreads();  // tile it is consumed before its buffer is refilled
  }
  const float inv[2] = {1.f / l[0], 1.f / l[1]};

  // pass 2: P = exp(s - m) / l, rounded to bf16, times V
  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  load_tile_async(ks[0], k + base, 0, L, row_stride);
  load_tile_async(vs[0], v + base, 0, L, row_stride);
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBlockN;
    if (it + 1 < n_tiles) {
      load_tile_async(ks[(it + 1) & 1], k + base, k0 + kBlockN, L, row_stride);
      load_tile_async(vs[(it + 1) & 1], v + base, k0 + kBlockN, L, row_stride);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    score_tile(s, qa, ks[it & 1], rows, k0, L, scaling, bias_bh, kb);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = __expf(s[j][c] - m[c >> 1]) * inv[c >> 1];
    // The accumulator layout of two adjacent 8-key score tiles is the A
    // operand layout of one 16-key step of P.V.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const int mi = lane >> 3;
      const __nv_bfloat16* vrow = vs[it & 1] + (kk * 16 + (mi & 1) * 8 + (lane & 7)) * kStride;
#pragma unroll
      for (int n = 0; n < 8; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + (n + (mi >> 1)) * 8);
        mma_16816(o[n], pa, vb[0], vb[1]);
        mma_16816(o[n + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // tile it is consumed before its buffer is refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= L) continue;
    __nv_bfloat16* dst = out + base + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) = pack_bf16(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// 256 threads as 16 x 16: thread (ty, tx) owns rows 4ty..4ty+3 and, of each
// 64-wide tile, columns tx, tx+16, tx+32, tx+48.
constexpr size_t kF32Smem = 4 * kBlockM * kF32Stride * sizeof(float);

__global__ void __launch_bounds__(256)
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const float* __restrict__ bias,
             int bias_batched, const float* __restrict__ key_bias,
             float* __restrict__ out, int L, int H, float scaling) {
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
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// q, k, v, out: (batch, seq_len, heads * 64), bf16 when is_bf16 else fp32.
// bias: fp32 (heads, L, L), or (batch, heads, L, L) when bias_batched, or null.
// key_bias: fp32 (batch, L) or null.
extern "C" int one_peace_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* bias, int bias_batched,
    const void* key_bias, void* out, int batch, int seq_len, int heads,
    float scaling, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, (seq_len + kBlockM - 1) / kBlockM, heads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    attn_fwd_bf16<<<grid, 128, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), bias_batched,
        static_cast<const float*>(key_bias), static_cast<__nv_bfloat16*>(out),
        seq_len, heads, scaling);
  } else {
    err = cudaFuncSetAttribute(attn_fwd_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kF32Smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attn_fwd_f32<<<grid, 256, kF32Smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(bias), bias_batched,
        static_cast<const float*>(key_bias), static_cast<float*>(out),
        seq_len, heads, scaling);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* one_peace_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
