// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel stores its operands in fp32 (shared memory or registers) and
// accumulates in fp32. For bf16 inputs, `rnd<T>` rounds an fp32 value to the
// input's precision at exactly the places where the JAX kernels cast to the
// compute dtype, so the bf16 results follow the reference's rounding points.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace mop {

constexpr int kThreads = 256;  // 16 x 16 threads; each owns a 4 x 4 output tile
constexpr int kTile = 64;      // rows (and columns) of one block tile

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's astype
}

// Round an fp32 value to T's precision (identity for fp32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// A stride that is odd keeps the column walks of the 4 x 4 tiles free of
// shared-memory bank conflicts.
__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reductions over the 16 lanes of a half warp (one row of the thread grid).
__device__ __forceinline__ float half_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float half_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One thread's 4 x 4 block of a product tile: rows 4*ty + i and columns
// c0 + tx + 16*j of the 64 x 64 tile owned by the 16 x 16 threads.
struct Tile {
  float v[4][4];
};

// acc = X Y over K for rows 4ty+i and columns c0 + tx + 16j; out-of-range
// rows and columns read the last valid one and are never written.
__device__ __forceinline__ void mm_nn(const float* X, int ldx, const float* Y, int ldy,
                                      int K, int rows, int cols, int c0, Tile& t) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int ri[4], ci[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ri[i] = min(4 * ty + i, rows - 1) * ldx;
#pragma unroll
  for (int j = 0; j < 4; ++j) ci[j] = min(c0 + tx + 16 * j, cols - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t.v[i][j] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = X[ri[i] + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Y[kk * ldy + ci[j]];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t.v[i][j] = fmaf(a[i], b[j], t.v[i][j]);
  }
}

// acc = X Y^T over K (both row-major with K columns and `rows` rows).
__device__ __forceinline__ void mm_nt(const float* X, const float* Y, int ld, int K, int rows,
                                      Tile& t) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  int ri[4], ci[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) ri[i] = min(4 * ty + i, rows - 1) * ld;
#pragma unroll
  for (int j = 0; j < 4; ++j) ci[j] = min(tx + 16 * j, rows - 1) * ld;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t.v[i][j] = 0.f;
  for (int kk = 0; kk < K; ++kk) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = X[ri[i] + kk];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Y[ci[j] + kk];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) t.v[i][j] = fmaf(a[i], b[j], t.v[i][j]);
  }
}

// Store a tile (optionally rounded to T) into a row-major buffer.
template <typename T>
__device__ __forceinline__ void store(float* D, int ld, int rows, int cols, int c0,
                                      const Tile& t, bool round) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < rows && c < cols) D[r * ld + c] = round ? rnd<T>(t.v[i][j]) : t.v[i][j];
    }
  }
}

// dst = an input (rows x cols, row stride rs, feature stride 1) times `mul`,
// or its transpose. With mul != 1 the product is rounded to T, as the JAX
// kernels scale q in the compute dtype.
template <typename T>
__device__ void stage_in(float* dst, int ldst, const T* src, long long rs, int rows, int cols,
                         bool trans, float mul) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    float x = to_f<T>(src[r * rs + c]);
    if (mul != 1.f) x = rnd<T>(x * mul);
    if (trans)
      dst[c * ldst + r] = x;
    else
      dst[r * ldst + c] = x;
  }
}

// Row softmax of an N x N map (N <= 64, row stride ld) into dst, which may be
// M itself, rounded to T; one warp a row, each lane reading its two values
// before any is written.
template <typename T>
__device__ void softmax_rows(const float* M, float* dst, int ld, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kThreads / 32) {
    const float* row = M + r * ld;
    const float x0 = lane < N ? row[lane] : -INFINITY;
    const float x1 = lane + 32 < N ? row[lane + 32] : -INFINITY;
    const float mx = warp_max(fmaxf(x0, x1));
    const float e0 = lane < N ? expf(x0 - mx) : 0.f;
    const float e1 = lane + 32 < N ? expf(x1 - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (lane < N) dst[r * ld + lane] = rnd<T>(e0 / sum);
    if (lane + 32 < N) dst[r * ld + lane + 32] = rnd<T>(e1 / sum);
  }
}

}  // namespace mop
