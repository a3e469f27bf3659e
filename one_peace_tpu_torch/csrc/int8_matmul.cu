// int8 serving GEMM and its row quantize for Hopper (sm_90a).
//
// int8_matmul replaces the Pallas TPU kernel one_peace_tpu/ops/quant_pallas.py
// `int8_matmul` / `_kernel`:
//
//   y[m, n] = (float(sum_k x_q[m, k] * w_q[n, k]) * sx[m]) * sw[n]  (+ b[n])
//
// with the int32 sum exact, the epilogue in fp32 in that order (each step
// rounded, no fused multiply-add), and one rounding to the output dtype (bf16
// or fp32).  That is the JAX package's arithmetic: `quantized_linear`
// (ops/quant.py) takes the kernel's fp32 output, adds the bias in fp32 and
// casts once to x's dtype.  x_q is (M, K) int8 row-major, w_q is (N, K) int8
// row-major (K contiguous: the transpose of the JAX package's (K, N)), sx is
// (M,) fp32, sw and b are (N,) fp32.
//
// int8_quantize_rows is the XLA fusion in front of it (ops/quant.py:46-49),
// which has no Pallas kernel: per row of x (M, K), bf16 or fp32,
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
//     cores, and the bf16 store of y is the largest memory term.
//   int8_quantize_rows: reads x once to reduce and once to quantize (the
//     second read mostly from L1/L2) and writes x_q and sx: 303 MB for a
//     (65,792 x 1536) bf16 activation, about 0.1 ms at 3.35 TB/s; nothing
//     to compute.  Bound by memory bandwidth.
//
// What this design does about it:
//   int8_matmul: one block of 256 threads (8 warps) per 128 x 128 output
//     tile; the K loop walks 128-byte slabs of x_q and w_q staged in shared
//     memory by cp.async in a 3-stage ring (110.6 KB, two blocks per SM), so
//     two slabs load while one computes; 128-byte slabs ran the FFN shapes
//     ~10% faster than 64-byte ones (PERF.md).  Rows are padded to 144
//     bytes, which puts the 8 rows a ldmatrix phase reads on distinct banks.
//     Each warp owns a 64 x 32 sub-tile: 4 x 4 mma.sync m16n8k32 s8.s8.s32
//     per 32 bytes of K, the int32 sums in registers for the whole K loop
//     (64 per thread).  Blocks
//     walk N fastest, so the blocks in flight share their x_q rows and all of
//     w_q in L2.  The scales and the bias are applied in the epilogue from
//     registers, and the ragged M and N edges are masked there; rows beyond
//     M or N, and 16-byte chunks beyond K, are zero-filled by cp.async.  K
//     must be a multiple of 16 (the wrapper pads when it is not).
//   int8_quantize_rows: one warp per row, 8 rows per block, 16-byte loads
//     where the row allows it; the row's absmax is a warp shuffle reduction,
//     then the warp reads the row again and stores 4 or 8 int8 per lane.
// Not done yet: wgmma, TMA, a persistent schedule, the quantize fused into
// the producer of x, and a coalesced store of y through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWN = 32;                  // output columns per warp
constexpr int kNI = kWN / 8;             // n8 mma tiles per warp
constexpr int kBM = 128;                 // output rows per block
constexpr int kBN = 4 * kWN;             // output columns per block
constexpr int kBK = 128;                 // bytes (int8 values) of K per stage
constexpr int kStages = 3;               // cp.async ring depth
constexpr int kChunks = kBK / 16;        // 16-byte cp.async chunks per row and stage
constexpr int kRow = kBK + 16;           // smem row stride in bytes: 144, conflict-free
constexpr int kThreads = 256;            // 8 warps: 2 (M) x 4 (N), 64 x 32 each
constexpr int kStageBytes = (kBM + kBN) * kRow;
constexpr int kSmem = kStages * kStageBytes;  // 110,592 bytes

// 16-byte async copy global -> shared; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, bool valid) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(addr), "l"(gmem), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Four 8 x 16-byte matrices from shared memory; lane i receives the 4 bytes
// (i % 4) * 4 .. + 3 of row i / 4 of each.  For int8 that is the mma
// fragment layout of m16n8k32: a 16-byte row segment is 16 k values.
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// D (16x8 s32) += A (16x32 s8, row) * B (32x8 s8, col).
__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: rows [m0, m0 + 128) of x_q and [n0, n0 + 128) of w_q, bytes
// [k0, k0 + 128) of each, as 16-byte chunks (4 + 4 per thread).
__device__ __forceinline__ void load_stage(int8_t* smem, const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ wq, int m0, int n0,
                                           int k0, int M, int N, int K) {
  int8_t* sa = smem;
  int8_t* sb = smem + kBM * kRow;
#pragma unroll
  for (int i = threadIdx.x; i < kBM * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const bool valid = m0 + r < M && k0 + c < K;
    cp_async_16(sa + r * kRow + c,
                xq + (valid ? static_cast<size_t>(m0 + r) * K + k0 + c : 0), valid);
  }
#pragma unroll
  for (int i = threadIdx.x; i < kBN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 16;
    const bool valid = n0 + r < N && k0 + c < K;
    cp_async_16(sb + r * kRow + c,
                wq + (valid ? static_cast<size_t>(n0 + r) * K + k0 + c : 0), valid);
  }
}

// (acc * sx) * sw (+ b), each product and the sum rounded on its own.
__device__ __forceinline__ float epilogue(int acc, float sx, float sw, const float* b, int n) {
  float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw);
  return b ? __fadd_rn(y, b[n]) : y;
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, size_t i, float y0, float y1,
                                       bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<__nv_bfloat162*>(out + i) = __floats2bfloat162_rn(y0, y1);
  } else {
    out[i] = __float2bfloat16_rn(y0);
    if (two) out[i + 1] = __float2bfloat16_rn(y1);
  }
}
__device__ __forceinline__ void store2(float* out, size_t i, float y0, float y1,
                                       bool two, bool pair) {
  if (two && pair) {
    *reinterpret_cast<float2*>(out + i) = make_float2(y0, y1);
  } else {
    out[i] = y0;
    if (two) out[i + 1] = y1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                   const float* __restrict__ sx, const float* __restrict__ sw,
                   const float* __restrict__ bias, T* __restrict__ out,
                   int M, int N, int K) {
  extern __shared__ __align__(16) int8_t smem[];
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * kWN;

  int acc[4][kNI][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int ktiles = (K + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load_stage(smem + s * kStageBytes, xq, wq, m0, n0, s * kBK, M, N, K);
    cp_async_commit();
  }

  // ldmatrix lane addresses inside a stage.  A: lanes 0-15 rows 0-15 at
  // byte 0, lanes 16-31 rows 0-15 at byte 16 -> a0..a3 of m16n8k32.  B:
  // lanes 0-7 n 0-7 at byte 0 (b0 of the first n8 tile), 8-15 n 0-7 at
  // byte 16 (its b1), 16-23 n 8-15 at byte 0, 24-31 n 8-15 at byte 16.
  const int a_off = (wm + (lane & 15)) * kRow + (lane >> 4) * 16;
  const int b_off = kBM * kRow + (wn + ((lane >> 4) << 3) + (lane & 7)) * kRow
                    + ((lane >> 3) & 1) * 16;

  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    const int next = kt + kStages - 1;
    if (next < ktiles)
      load_stage(smem + (next % kStages) * kStageBytes, xq, wq, m0, n0, next * kBK, M, N, K);
    cp_async_commit();

    const int8_t* stage = smem + (kt % kStages) * kStageBytes;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4], b[kNI][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) ldmatrix_x4(a[mi], stage + a_off + mi * 16 * kRow + ks);
#pragma unroll
      for (int nj = 0; nj < kNI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4(r, stage + b_off + nj * 16 * kRow + ks);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < kNI; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  // accumulator layout of m16n8: c0, c1 at row g, columns 2t, 2t + 1; c2,
  // c3 at row g + 8 (g = lane / 4, t = lane % 4)
  const int g = lane >> 2, t = lane & 3;
  const bool pair = (N & 1) == 0;  // 2-element stores stay aligned
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = m0 + wm + mi * 16 + g + half * 8;
      if (m >= M) continue;
      const float s_x = sx[m];
#pragma unroll
      for (int ni = 0; ni < kNI; ++ni) {
        const int n = n0 + wn + ni * 8 + 2 * t;
        if (n >= N) continue;
        const bool two = n + 1 < N;
        const float y0 = epilogue(acc[mi][ni][2 * half], s_x, sw[n], bias, n);
        const float y1 = two ? epilogue(acc[mi][ni][2 * half + 1], s_x, sw[n + 1], bias, n + 1)
                             : 0.f;
        store2(out, static_cast<size_t>(m) * N + n, y0, y1, two, pair);
      }
    }
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

// 16 bytes of x as floats: 8 bf16 or 4 fp32 values.
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void load(float f[8], const __nv_bfloat16* p) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
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

template <typename T>
cudaError_t launch_matmul(const void* xq, const void* wq, const void* sx, const void* sw,
                          const void* bias, void* out, int M, int N, int K, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, kSmem, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sx), static_cast<const float*>(sw),
      static_cast<const float*>(bias), static_cast<T*>(out), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16 (is_bf16) or fp32 -> x_q (M, K) int8 and sx (M,) fp32.
// vec: x and x_q 16-byte aligned and K a multiple of 8 (bf16) or 4 (fp32).
extern "C" int one_peace_int8_quantize_rows(const void* x, void* xq, void* sx, int M, int K,
                                            int is_bf16, int vec, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = is_bf16 ? launch_quantize<__nv_bfloat16>(x, xq, sx, M, K, vec != 0, s)
                : launch_quantize<float>(x, xq, sx, M, K, vec != 0, s);
  return static_cast<int>(err);
}

// x_q (M, K) int8 @ w_q (N, K)^T int8 -> out (M, N) bf16 (out_bf16) or fp32,
// scaled by sx (M,) and sw (N,), plus bias (N,) fp32 when not null.  K a
// multiple of 16; x_q and w_q 16-byte aligned.
extern "C" int one_peace_int8_matmul(const void* xq, const void* wq, const void* sx,
                                     const void* sw, const void* bias, void* out, int M, int N,
                                     int K, int out_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = out_bf16 ? launch_matmul<__nv_bfloat16>(xq, wq, sx, sw, bias, out, M, N, K, s)
                 : launch_matmul<float>(xq, wq, sx, sw, bias, out, M, N, K, s);
  return static_cast<int>(err);
}

extern "C" const char* one_peace_int8_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
