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

}  // namespace mop
