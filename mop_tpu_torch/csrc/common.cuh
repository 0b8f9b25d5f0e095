// Shared helpers for the port's hand-written Hopper kernels.
//
// The CUDA-core kernels store their operands in fp32 (shared memory or
// registers) and accumulate in fp32; for bf16 inputs, `rnd<T>` rounds an
// fp32 value to the input's precision at exactly the places where the JAX
// kernels cast to the compute dtype, so the bf16 results follow the
// reference's rounding points. The tensor-core paths (K1's, K2's and K2b's
// bf16) keep bf16 operands in shared memory and use the `cp.async`,
// `ldmatrix` and `mma.sync` helpers below.
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

// ------------------- fp32 register tiles on CUDA cores -------------------

// Floats rounded up to a multiple of four (16-byte alignment).
__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Row stride, in floats, of an fp32 operand read with float4 loads: 16-byte
// rows, and eight consecutive rows in distinct 16-byte bank groups.
__host__ __device__ inline int ld4(int x) { return ((x + 7) & ~7) + 4; }

// Barrier of one group of half the block's threads (ids 1 and 2; 0 is
// __syncthreads).
__device__ __forceinline__ void named_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kThreads / 2) : "memory");
}


// A thread's 4 x 4 tile of a product in its group: rows 4ty + i, columns
// c0 + 4tx + j (gt = 16 ty + tx). t = X Y over K, X rows x K (row stride
// ldx) read as float4 along k, Y K x cols (row stride ldy) as float4 along
// the columns; the k sum runs in order. Rows past `rows` read the last row
// and columns past `cols` column 0: their sums are never stored.
__device__ __forceinline__ void mm4(const float* X, int ldx, const float* Y, int ldy, int K,
                                    int rows, int cols, int c0, int gt, float (&t)[4][4]) {
  const int ty = gt >> 4, tx = gt & 15;
  const float* xr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) xr[i] = X + min(4 * ty + i, rows - 1) * ldx;
  const int cc = c0 + 4 * tx < cols ? c0 + 4 * tx : 0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = 0.f;
  int kk = 0;
  for (; kk + 4 <= K; kk += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(xr[i] + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) b[q] = *reinterpret_cast<const float4*>(Y + (kk + q) * ldy + cc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float av[4] = {a[i].x, a[i].y, a[i].z, a[i].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        t[i][0] = fmaf(av[q], b[q].x, t[i][0]);
        t[i][1] = fmaf(av[q], b[q].y, t[i][1]);
        t[i][2] = fmaf(av[q], b[q].z, t[i][2]);
        t[i][3] = fmaf(av[q], b[q].w, t[i][3]);
      }
    }
  }
  for (; kk < K; ++kk) {
    const float4 b = *reinterpret_cast<const float4*>(Y + kk * ldy + cc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = xr[i][kk];
      t[i][0] = fmaf(a, b.x, t[i][0]);
      t[i][1] = fmaf(a, b.y, t[i][1]);
      t[i][2] = fmaf(a, b.z, t[i][2]);
      t[i][3] = fmaf(a, b.w, t[i][3]);
    }
  }
}


// D[r][c] = t for the tile's rows < rows and columns c0 + 4tx + j < cols.
__device__ __forceinline__ void put4(float* D, int ld, int rows, int cols, int c0, int gt,
                                     const float (&t)[4][4]) {
  const int ty = gt >> 4, tx = gt & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + 4 * tx + j;
      if (r < rows && c < cols) D[r * ld + c] = t[i][j];
    }
  }
}

// ------------------- asynchronous copies and tensor cores -------------------
//
// The bf16 products of K1 and K2b run on the tensor cores with
// `mma.sync.m16n8k16` (bf16 operands, fp32 accumulation). Their operands sit
// in shared memory in bf16, row-major with a row stride of a multiple of 8
// elements plus 8 (16-byte aligned rows, and the eight rows one `ldmatrix`
// phase reads fall in distinct banks); `ldmatrix` with or without `.trans`
// reads either layout of either operand, so nothing is transposed on the way
// in. Device memory reaches shared memory by `cp.async`, whose width the
// caller picks from the alignment of the source (16, 8 or 4 bytes; a plain
// load below 4).

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_u32(dst)), "l"(src),
                 "n"(kBytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `kPending` of this thread's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename T, int kBytes>
__device__ __forceinline__ void copy_rows_vec(T* dst, int ld, const T* src, long long rs,
                                              int valid, int cols, int tid, int nthr) {
  constexpr int kE = kBytes / (int)sizeof(T);  // elements per copy
  const int per_row = cols / kE;
  for (int idx = tid; idx < valid * per_row; idx += nthr) {
    const int r = idx / per_row, c = (idx - r * per_row) * kE;
    if constexpr (kBytes >= 4)
      cp_async<kBytes>(dst + r * ld + c, src + r * rs + c);
    else
      dst[r * ld + c] = src[r * rs + c];
  }
}

// Copy rows [0, valid) of a rows x cols block of T (row stride rs elements,
// feature stride 1) into shared memory (row stride ld) with `vec`-byte
// copies, and write zeros to columns [0, cols) of rows [valid, rows). The
// caller commits and waits. `vec` divides cols * sizeof(T), the source
// address and rs * sizeof(T).
template <typename T>
__device__ void copy_rows_async(T* dst, int ld, const T* src, long long rs, int rows, int valid,
                                int cols, int vec, int tid, int nthr) {
  switch (vec) {
    case 16: copy_rows_vec<T, 16>(dst, ld, src, rs, valid, cols, tid, nthr); break;
    case 8: copy_rows_vec<T, 8>(dst, ld, src, rs, valid, cols, tid, nthr); break;
    case 4: copy_rows_vec<T, 4>(dst, ld, src, rs, valid, cols, tid, nthr); break;
    default: copy_rows_vec<T, (int)sizeof(T)>(dst, ld, src, rs, valid, cols, tid, nthr);
  }
  for (int idx = tid; idx < (rows - valid) * cols; idx += nthr) {
    const int r = valid + idx / cols, c = idx % cols;
    dst[r * ld + c] = from_f<T>(0.f);
  }
}

// Row stride, in elements, of a bf16 shared-memory operand with `cols`
// columns: 16-byte rows, columns padded to a multiple of 16 (one k-step),
// plus 8 so that the rows of one ldmatrix phase hit distinct banks.
__host__ __device__ __forceinline__ int mma_ld(int cols) { return ((cols + 15) & ~15) + 8; }

// Four 8x8 bf16 matrices; lane l gives the row address for matrix l / 8.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 step: bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two fp32 values as one bf16x2 register, x in the low half.
__device__ __forceinline__ unsigned pack_bf16(float x, float y) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<unsigned*>(&h);
}

// The A fragment (16 x 16, rows m0.., k k0..) of an operand X held in shared
// memory as X itself ([m][k], trans false) or as its transpose ([k][m]).
__device__ __forceinline__ void load_a(unsigned (&a)[4], const __nv_bfloat16* X, int ld,
                                       bool trans, int m0, int k0) {
  const int lane = threadIdx.x & 31;
  if (!trans) {
    ldsm_x4(a, X + (m0 + (lane & 15)) * ld + k0 + 8 * (lane >> 4));
  } else {
    ldsm_x4_t(a, X + (k0 + (lane & 7) + 8 * (lane >> 4)) * ld + m0 + 8 * ((lane >> 3) & 1));
  }
}

// The B fragments of two n-tiles (k k0.., n n0.. and n0 + 8..) of an operand
// Y (K x N) held as Y itself ([k][n], trans false) or as its transpose
// ([n][k]): b[0], b[1] for n-tile n0, b[2], b[3] for n0 + 8.
__device__ __forceinline__ void load_b2(unsigned (&b)[4], const __nv_bfloat16* Y, int ld,
                                        bool trans, int k0, int n0) {
  const int lane = threadIdx.x & 31;
  if (!trans) {
    ldsm_x4_t(b, Y + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ld + n0 + 8 * (lane >> 4));
  } else {
    ldsm_x4(b, Y + (n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1));
  }
}

// ------------------- warp tiles of tensor-core products -------------------
//
// The bf16 products of K2 and K2b: eight warps tile a 64 x 64 output as 4 x 2
// warp tiles of 16 x 32 (`MTile`), from bf16 operands in shared memory with
// `mma_ld` rows zero-padded to a multiple of 16 in both dimensions.

using bf16 = __nv_bfloat16;

// The widest copy (16, 8, 4 or 2 bytes) of a 16-byte-aligned bf16 row of `cols`.
__device__ __forceinline__ int row_vec(int cols) {
  return (cols % 8 == 0) ? 16 : (cols % 4 == 0) ? 8 : (cols % 2 == 0) ? 4 : 2;
}

struct Op {
  const bf16* p;
  bool t;  // the buffer holds the operand's transpose
};

// A warp's 16 x 32 piece of a 64 x 64 product tile: four n-tiles of 8.
struct MTile {
  float v[4][4];
};

// t (+)= X Y over K for output rows < rows and columns [c0, c0 + 64) < cols;
// X and Y are operands in buffers of row strides ldx and ldy.
__device__ __forceinline__ void mma_mm(MTile& t, Op X, int ldx, Op Y, int ldy, int K, int rows,
                                       int cols, int c0, bool acc) {
  const int warp = threadIdx.x >> 5;
  const int m0 = 16 * (warp & 3), n0 = c0 + 32 * (warp >> 2);
  if (!acc) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) t.v[j][e] = 0.f;
  }
  if (m0 >= rows) return;
  for (int k0 = 0; k0 < K; k0 += 16) {
    unsigned a[4];
    load_a(a, X.p, ldx, X.t, m0, k0);
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      if (n0 + 16 * np < cols) {
        unsigned b[4];
        load_b2(b, Y.p, ldy, Y.t, k0, n0 + 16 * np);
        mma_bf16(t.v[2 * np], a, b[0], b[1]);
        mma_bf16(t.v[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
}

// The same with both operands in buffers of row stride ld.
__device__ __forceinline__ void mma_mm(MTile& t, Op X, Op Y, int ld, int K, int rows, int cols,
                                       int c0, bool acc) {
  mma_mm(t, X, ld, Y, ld, K, rows, cols, c0, acc);
}

// f(row, col, value) for every element of t inside rows x cols.
template <class F>
__device__ __forceinline__ void for_tile(const MTile& t, int rows, int cols, int c0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3) + (lane >> 2), cb = c0 + 32 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = cb + 8 * j + (e & 1);
      if (r < rows && c < cols) f(r, c, t.v[j][e]);
    }
}

// f(r, c, x0, x1) for each pair of neighbouring columns c (even), c + 1 of t
// whose first column lies inside rows x cols: a quad of lanes holds 8
// neighbouring columns of a row, so paired stores fill whole sectors.
template <class F>
__device__ __forceinline__ void for_pairs(const MTile& t, int rows, int cols, int c0, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3) + (lane >> 2), cb = c0 + 32 * (warp >> 2) + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = cb + 8 * j;
      if (r < rows && c < cols) f(r, c, t.v[j][2 * h], t.v[j][2 * h + 1]);
    }
}

// Store x0 at p[0] and, if column c + 1 < cols, x1 at p[1]; as one vector
// store when `vec` (p aligned to the pair).
__device__ __forceinline__ void st2(float* p, int c, int cols, float x0, float x1, bool vec) {
  if (vec && c + 1 < cols) {
    *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
  } else {
    p[0] = x0;
    if (c + 1 < cols) p[1] = x1;
  }
}

__device__ __forceinline__ void st2(bf16* p, int c, int cols, float x0, float x1, bool vec) {
  if (vec && c + 1 < cols) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
  } else {
    p[0] = __float2bfloat16(x0);
    if (c + 1 < cols) p[1] = __float2bfloat16(x1);
  }
}

// Zero the padding of a rows x cols operand: columns [cols, c16) of rows
// [0, r16) and rows [rows, r16) of columns [0, cols).
__device__ void zero_pad(bf16* buf, int ld, int rows, int cols) {
  const int r16 = (rows + 15) & ~15, c16 = (cols + 15) & ~15;
  const bf16 z = __float2bfloat16(0.f);
  const int pc = c16 - cols;
  for (int idx = threadIdx.x; idx < r16 * pc; idx += kThreads)
    buf[(idx / pc) * ld + cols + idx % pc] = z;
  for (int idx = threadIdx.x; idx < (r16 - rows) * cols; idx += kThreads)
    buf[(rows + idx / cols) * ld + idx % cols] = z;
}

// A bf16 rows x cols block from device memory by cp.async (the caller
// commits and waits), its padding zeroed.
__device__ __forceinline__ void stage_async(bf16* buf, int ld, const bf16* src, long long rs,
                                            int rows, int cols, int vec) {
  copy_rows_async(buf, ld, src, rs, rows, rows, cols, vec, threadIdx.x, kThreads);
  zero_pad(buf, ld, rows, cols);
}

// buf = c(buf * mul), as the JAX math scales q in the compute dtype.
__device__ void scale_rows(bf16* buf, int ld, int rows, int cols, float mul) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    buf[r * ld + c] = __float2bfloat16(__bfloat162float(buf[r * ld + c]) * mul);
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
