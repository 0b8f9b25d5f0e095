// K5: fused Quartet causal attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_quartet_kernel` / `_quartet_pallas` in
// mop_tpu/ops/fused.py. For each (batch*head):
//   S1 = (q * scale) k^T and S2 = (q2 * scale) k2^T (q * scale rounded to
//   the compute dtype, scores in fp32); each standardized per row over EVERY
//   column, before the causal mask, with the unbiased variance and eps after
//   the sqrt: Sn = (S - mu) / (sqrt(M2 / max(1, N - 1)) + eps);
//   scores = (1 - m) S1n + m (S1n * S2n) qscale, causal mask, softmax, times V.
//
// Bound on this card: at (BH, N, dk) = (512, 256, 80) the function needs the
// full score maps for the statistics (2 x 2 N^2 dk flops) and the causal half
// of P V, about 13.4 Gflop against 252 MB of inputs and output in fp32, so
// it is bound by the fp32 FMA rate. Products run on CUDA cores in true fp32.
//
// The TPU kernel holds whole N x N rows per program. A Hopper block has
// 227 KB, so two designs:
// - The kept-rows kernels, where a block's raw rows fit (`rows_fit`: at
//   dk = 80, N <= 256 in fp32 and N <= 768 in bf16): one CTA takes one
//   (batch*head, block of query rows). Pass 1 runs over every key block
//   (the masked ones enter mu and sigma), each S1 and S2 tile computed once
//   and kept in shared memory in fp32; the statistics then come from the
//   kept rows as the JAX kernel takes them (the mean, then the sum of
//   squared deviations), the rows are standardised, mixed, masked and
//   softmaxed in place (max, sum, normalised probabilities rounded to the
//   compute dtype, where the TPU kernel rounds them: no extra sweep in
//   bf16), and pass 2 runs P V over the causal key blocks. Every score tile
//   is computed once, where the streaming kernel computes the causal ones
//   twice (26 tile pairs of 64 x 64 for 16 needed at N = 256). Key and value
//   blocks come in by `cp.async` (the copy width from the views'
//   alignment). The grid is one-dimensional, a (batch*head)'s query blocks
//   adjacent and its heaviest causal block first.
//   fp32 (`quartet_rows_f32_kernel`): true fp32 on CUDA cores, 64 query
//   rows, 8 x 4 thread tiles whose operands are read as float4 (128 FMAs
//   per 12 shared-memory loads); the two score maps in two thread groups
//   with their own barriers, so that one group's products run while the
//   other waits for its next key block. bf16 (`quartet_rows_tc_kernel`):
//   32 query rows, both score products and P V on the tensor cores
//   (`mma.sync` from `ldmatrix`), key blocks double-buffered, two CTAs an
//   SM at the LM's shape.
// - `quartet_stream_kernel` above that: one CTA takes a block of 64 query
//   rows through two passes over the keys, 64 at a time: every key block for
//   each row's tile mean and M2, merged by Chan et al.'s pairwise update,
//   then the key blocks up to the diagonal again, standardized, mixed and
//   masked in registers, an online softmax and P V (in bf16 a first sweep
//   for each row's final max and sum, so that the normalised probabilities
//   are rounded), on CUDA cores, bf16 converted to fp32 as it is staged.
// In both dtypes the result is the TPU kernel's up to fp32 rounding.
#include <type_traits>

#include "common.cuh"

namespace mop {

constexpr int kMaxDk = 128;
constexpr int kOutCols = kMaxDk / 16;  // output columns owned by one thread (streaming)
constexpr int kQBf = 64;               // query rows of a kept-rows CTA: fp32
constexpr int kQBh = 32;               // bf16
constexpr int kKT = 32;                // keys of the bf16 kept-rows kernel's staged block
constexpr int kMaxSmem = 232448;       // shared memory one block may take on the H100

// (b, h, row) element strides of q, k, v, q2, k2 and out.
struct Strides {
  long long s[18];
};

// Row stride, in floats, of a kept score row: every block of 64 keys,
// float4 aligned, and four rows eight banks apart.
__host__ __device__ inline int ldr(int N) { return ((N + kTile - 1) / kTile) * kTile + 8; }

// Query rows of a kept-rows CTA: 64 in fp32, 32 in bf16.
__host__ __device__ inline int rows_qb(int dtype) { return dtype == 1 ? kQBh : kQBf; }

// Bytes of the kept-rows kernels' shared memory: q and q2, then fp32 one
// block of 64 keys of k and of k2 (v in pass 2, two blocks), fp32 rows read
// as float4; bf16 two stages of 32 keys of both, bf16 rows for `ldmatrix`;
// then the kept S1 and S2 rows in fp32.
__host__ __device__ inline long long rows_bytes(int dtype, int N, int dk) {
  const int qb = rows_qb(dtype);
  const long long ops = dtype == 1 ? (2LL * qb + 4LL * kKT) * 2 * mma_ld(dk)
                                   : (2LL * qb + 2LL * kTile) * 4 * ld4(dk);
  return ops + 4LL * 2 * qb * ldr(N);
}

inline bool rows_fit(int dtype, int N, int dk) { return rows_bytes(dtype, N, dk) <= kMaxSmem; }

// The sum over the eight lanes of an aligned lane group, in a fixed order:
// ((p0 + p4) + (p2 + p6)) + ((p1 + p5) + (p3 + p7)) on every lane.
__device__ __forceinline__ float oct_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float oct_max(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Kept row r (query row `row`) of R1, R2 (row stride lr, every column of
// the keys) into its probabilities over the causal key blocks [0, kend), by
// the eight lanes g = 0..7 of a lane group: mu and the sum of squared
// deviations of both maps over all N columns, each lane summing columns g,
// g + 8, ... in order and the lanes by `oct_sum`; then the standardised mix,
// the causal mask, the row max, the sum of exponentials (the same order)
// and p = exp(x - max) / sum, rounded to T, written by `put(r, col, p)`
// (zeros past the diagonal, and in a row past N, which is computed over row
// N - 1's range).
template <typename T, class Put>
__device__ __forceinline__ void row_softmax(float* R1, const float* R2, int lr, int r, int row,
                                            int N, int kend, float m, float qscale, float eps,
                                            int g, Put put) {
  float* x1 = R1 + r * lr;
  const float* x2 = R2 + r * lr;
  const int lim = min(row, N - 1);
  float a = 0.f, c = 0.f;
#pragma unroll 4
  for (int col = g; col < N; col += 8) {
    a += x1[col];
    c += x2[col];
  }
  const float mu1 = oct_sum(a) / (float)N, mu2 = oct_sum(c) / (float)N;
  a = c = 0.f;
#pragma unroll 4
  for (int col = g; col < N; col += 8) {
    const float d1 = x1[col] - mu1, d2 = x2[col] - mu2;
    a += d1 * d1;
    c += d2 * d2;
  }
  const float dof = (float)max(1, N - 1);
  const float den1 = sqrtf(oct_sum(a) / dof) + eps, den2 = sqrtf(oct_sum(c) / dof) + eps;
  float mx = -INFINITY;
#pragma unroll 4
  for (int col = g; col <= lim; col += 8) {
    const float s1n = (x1[col] - mu1) / den1, s2n = (x2[col] - mu2) / den2;
    const float x = (1.f - m) * s1n + m * (s1n * s2n) * qscale;
    x1[col] = x;
    mx = fmaxf(mx, x);
  }
  mx = oct_max(mx);
  float sum = 0.f;
#pragma unroll 4
  for (int col = g; col <= lim; col += 8) {
    const float e = expf(x1[col] - mx);
    x1[col] = e;
    sum += e;
  }
  sum = oct_sum(sum);
#pragma unroll 4
  for (int col = g; col < kend; col += 8)
    put(r, col, row < N && col <= row ? rnd<T>(x1[col] / sum) : 0.f);
}

// The kQB kept rows of a block into probabilities, eight lanes a row: warp
// w takes rows 4w..4w+3, then every 32nd row on. Ends without a barrier.
template <typename T, int kQB, class Put>
__device__ __forceinline__ void rows_softmax(float* R1, const float* R2, int lr, int q0, int N,
                                             int kend, float m, float qscale, float eps,
                                             Put put) {
  const int lane = threadIdx.x & 31;
  for (int r = 4 * (threadIdx.x >> 5) + (lane >> 3); r < kQB; r += kThreads / 8)
    row_softmax<T>(R1, R2, lr, r, q0 + r, N, kend, m, qscale, eps, lane & 7, put);
}

// A CTA's (batch*head, block of qb query rows). The grid is one-dimensional,
// the query blocks of one (batch*head) adjacent, the heaviest causal block,
// the last, first; `last` is the last causal block of kt keys.
struct RowsBlock {
  int bh, q0, last, kend;
  __device__ RowsBlock(int N, int qb, int kt) {
    const int nqb = (N + qb - 1) / qb;
    bh = blockIdx.x / nqb;
    q0 = (nqb - 1 - (int)(blockIdx.x - bh * nqb)) * qb;
    last = min((N + kt - 1) / kt - 1, (q0 + qb - 1) / kt);
    kend = (last + 1) * kt;
  }
};

// fp32: CUDA cores, 64 query rows, 256 threads. Each map has its own
// thread group: warps 0-3 compute S1, warps 4-7 S2, each group staging its
// own q rows and key blocks of 64 keys (one block at a time) and meeting at
// its own named barrier, so that one group's products run while the other
// waits for its next block. A thread owns rows rg + 8i, keys kg + 16j of its
// map's 64 x 64 tile (8 x 4), reading q rows and k rows as float4 along dk:
// a warp's loads touch 8 q rows or 4 k rows, one shared-memory wavefront
// each, 128 FMAs per 12 loads. P V: a thread owns 8 rows x 4 columns of the
// 64 x dk output, reading P along the keys and V along dk as float4, 128
// FMAs per 12 loads; v blocks are double-buffered in the two key buffers.
__global__ void __launch_bounds__(kThreads, 1) quartet_rows_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ q2, const float* __restrict__ k2, float* __restrict__ o,
    const float* __restrict__ mix, int H, int N, int dk, Strides strides, float eps,
    float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const int ld = ld4(dk), lr = ldr(N);
  const int tsz = kTile * ld;  // floats of one staged key block
  float* Q1 = smem;
  float* Q2 = Q1 + kQBf * ld;
  float* K1 = Q2 + kQBf * ld;  // k's block (v's in pass 2)
  float* K2 = K1 + tsz;        // k2's block (v's in pass 2)
  float* R1 = K2 + tsz;        // the kept S1 rows, then the probabilities
  float* R2 = R1 + kQBf * lr;  // the kept S2 rows

  const RowsBlock blk(N, kQBf, kTile);
  const int bh = blk.bh, b = bh / H, h = bh % H;
  const int q0 = blk.q0, last = blk.last;
  const float* vp = v + b * st[6] + h * st[7];
  float* op = o + b * st[15] + h * st[16];
  const int tid = threadIdx.x;
  const float m = mix[0], qscale = mix[1];
  const int nkb = (N + kTile - 1) / kTile;
  auto stage = [&](float* dst, const float* src, long long rs, int r0, int rows, int t, int nt) {
    copy_rows_async(dst, ld, src + (long long)r0 * rs, rs, rows, max(0, min(rows, N - r0)), dk,
                    vec, t, nt);
  };

  // The float4 tail of every staged row past dk reads zeros.
  const int d4 = (dk + 3) & ~3, pad = d4 - dk;
  if (pad) {
    for (int idx = tid; idx < (2 * kQBf + 2 * kTile) * pad; idx += kThreads)
      Q1[(idx / pad) * ld + dk + idx % pad] = 0.f;
  }
  __syncthreads();

  // ---- pass 1: every key block's S1 and S2 tiles into the kept rows ----
  const int mp = tid >> 7, gt = tid & 127, rg = gt & 7, kg = gt >> 3;
  float* Qm = mp ? Q2 : Q1;
  float* Km = mp ? K2 : K1;
  float* Rm = mp ? R2 : R1;
  const float* qm = mp ? q2 + b * st[9] + h * st[10] : q + b * st[0] + h * st[1];
  const float* km = mp ? k2 + b * st[12] + h * st[13] : k + b * st[3] + h * st[4];
  const long long qrs = mp ? st[11] : st[2], krs = mp ? st[14] : st[5];
  stage(Qm, qm, qrs, q0, kQBf, gt, kThreads / 2);
  stage(Km, km, krs, 0, kTile, gt, kThreads / 2);
  cp_async_commit();
  for (int kb = 0; kb < nkb; ++kb) {
    cp_async_wait<0>();
    named_sync(mp);
    if (kb == 0) {  // q * scale
      for (int idx = gt; idx < kQBf * dk; idx += kThreads / 2) {
        const int r = idx / dk, c = idx - r * dk;
        Qm[r * ld + c] *= scale;
      }
      named_sync(mp);
    }
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < d4; d += 4) {
      float4 a[8], bk[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qm + (rg + 8 * i) * ld + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bk[j] = *reinterpret_cast<const float4*>(Km + (kg + 16 * j) * ld + d);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, bk[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, bk[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, bk[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, bk[j].w, s[i][j]);
        }
    }
    named_sync(mp);  // the group is done with this block
    if (kb + 1 < nkb) {
      stage(Km, km, krs, (kb + 1) * kTile, kTile, gt, kThreads / 2);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) Rm[(rg + 8 * i) * lr + kb * kTile + kg + 16 * j] = s[i][j];
  }
  __syncthreads();
  // v's first block comes in while the statistics are taken.
  stage(K1, vp, st[8], 0, kTile, tid, kThreads);
  cp_async_commit();
  rows_softmax<float, kQBf>(R1, R2, lr, q0, N, blk.kend, m, qscale, eps,
                      [&](int r, int col, float p) { R1[r * lr + col] = p; });

  // ---- pass 2: P V over the causal key blocks ----
  // Thread (pg, cg) owns rows 8pg.. and columns 4cg.. of the output.
  const int ncg = (dk + 3) / 4;
  const int pg = tid / ncg, cg = tid - pg * ncg;
  const bool live = pg < kQBf / 8;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int kb = 0; kb <= last; ++kb) {
    if (kb + 1 <= last) {
      stage((kb & 1) ? K1 : K2, vp, st[8], (kb + 1) * kTile, kTile, tid, kThreads);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Vb = (kb & 1) ? K2 : K1;
    if (live) {
      const float* pr = R1 + 8 * pg * lr + kb * kTile;
      for (int kk = 0; kk < kTile; kk += 4) {
        float4 p[8], vv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) p[i] = *reinterpret_cast<const float4*>(pr + i * lr + kk);
#pragma unroll
        for (int u = 0; u < 4; ++u)
          vv[u] = *reinterpret_cast<const float4*>(Vb + (kk + u) * ld + 4 * cg);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float pv[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[i][0] = fmaf(pv[u], vv[u].x, acc[i][0]);
            acc[i][1] = fmaf(pv[u], vv[u].y, acc[i][1]);
            acc[i][2] = fmaf(pv[u], vv[u].z, acc[i][2]);
            acc[i][3] = fmaf(pv[u], vv[u].w, acc[i][3]);
          }
        }
      }
    }
    __syncthreads();  // every thread is done with this block
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = q0 + 8 * pg + i;
      if (row >= N) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 4 * cg + j;
        if (col < dk) op[(long long)row * st[17] + col] = acc[i][j];
      }
    }
  }
}

// bf16: tensor cores (`mma.sync.m16n8k16`, operands by `ldmatrix` from bf16
// rows of stride mma_ld(dk), zero-padded to a multiple of 16 columns, every
// block by `cp.async`), 32 query rows, 256 threads, two CTAs an SM at the
// LM's shape. Warps 0-3 take S1, warps 4-7 S2; in a map's 32 x 32 tile a
// warp owns a 16 x 16 piece. The scores leave their fragments for the fp32
// kept rows; the probabilities, rounded to bf16, go to the S2 rows' storage
// as a bf16 matrix (row stride 2 lr), the A operand of P V; in P V a warp
// owns 16 rows and the 16-column groups w/2, w/2 + 4.
__global__ void __launch_bounds__(kThreads, 2) quartet_rows_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ q2, const bf16* __restrict__ k2, bf16* __restrict__ o,
    const float* __restrict__ mix, int H, int N, int dk, Strides strides, float eps,
    float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long* st = strides.s;
  const int ld = mma_ld(dk), lr = ldr(N);
  const int tsz = kKT * ld;  // elements of one staged key block
  bf16* Q1 = reinterpret_cast<bf16*>(smem_raw);
  bf16* Q2 = Q1 + kQBh * ld;
  bf16* KB = Q2 + kQBh * ld;  // stage s: k at KB + 2s tsz, k2 after it (v in pass 2)
  float* R1 = reinterpret_cast<float*>(KB + 4 * tsz);  // the kept S1 rows
  float* R2 = R1 + kQBh * lr;                          // the kept S2 rows, then bf16 P
  bf16* Pb = reinterpret_cast<bf16*>(R2);
  const int ldp = 2 * lr;

  const RowsBlock blk(N, kQBh, kKT);
  const int bh = blk.bh, b = bh / H, h = bh % H;
  const int q0 = blk.q0, last = blk.last;
  const bf16* qp = q + b * st[0] + h * st[1];
  const bf16* kp = k + b * st[3] + h * st[4];
  const bf16* vp = v + b * st[6] + h * st[7];
  const bf16* q2p = q2 + b * st[9] + h * st[10];
  const bf16* k2p = k2 + b * st[12] + h * st[13];
  bf16* op = o + b * st[15] + h * st[16];
  const int tid = threadIdx.x;
  const float m = mix[0], qscale = mix[1];
  const int nkb = (N + kKT - 1) / kKT;
  auto stage = [&](bf16* dst, const bf16* src, long long rs, int r0, int rows) {
    copy_rows_async(dst, ld, src + (long long)r0 * rs, rs, rows, max(0, min(rows, N - r0)), dk,
                    vec, tid, kThreads);
  };

  // Columns [dk, dk rounded up to 16) of every staged row read zeros.
  const int d16 = (dk + 15) & ~15, pad = d16 - dk;
  if (pad) {
    const bf16 z = __float2bfloat16(0.f);
    for (int idx = tid; idx < (2 * kQBh + 4 * kKT) * pad; idx += kThreads)
      Q1[(idx / pad) * ld + dk + idx % pad] = z;
  }
  stage(Q1, qp, st[2], q0, kQBh);
  stage(Q2, q2p, st[11], q0, kQBh);
  stage(KB, kp, st[5], 0, kKT);
  stage(KB + tsz, k2p, st[14], 0, kKT);
  cp_async_commit();

  // ---- pass 1: every key block's S1 and S2 tiles into the kept rows ----
  const int w = tid >> 5, lane = tid & 31, mp = w >> 2;
  const int m0 = 16 * (w & 1), n0 = 16 * ((w >> 1) & 1);
  const bf16* Qm = mp ? Q2 : Q1;
  float* Rm = mp ? R2 : R1;
  for (int kb = 0; kb < nkb; ++kb) {
    if (kb + 1 < nkb) {
      bf16* nxt = KB + 2 * ((kb + 1) & 1) * tsz;
      stage(nxt, kp, st[5], (kb + 1) * kKT, kKT);
      stage(nxt + tsz, k2p, st[14], (kb + 1) * kKT, kKT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kb == 0) {  // q * scale, rounded to bf16
      const float sc = rnd<bf16>(scale);
      scale_rows(Q1, ld, kQBh, dk, sc);
      scale_rows(Q2, ld, kQBh, dk, sc);
      __syncthreads();
    }
    const bf16* Km = KB + (2 * (kb & 1) + mp) * tsz;
    float acc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int k0 = 0; k0 < d16; k0 += 16) {
      unsigned a[4], bb[4];
      load_a(a, Qm, ld, false, m0, k0);
      load_b2(bb, Km, ld, true, k0, n0);
      mma_bf16(acc[0], a, bb[0], bb[1]);
      mma_bf16(acc[1], a, bb[2], bb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = m0 + (lane >> 2) + 8 * hh, c = kb * kKT + n0 + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(Rm + r * lr + c) =
            make_float2(acc[j][2 * hh], acc[j][2 * hh + 1]);
      }
    __syncthreads();  // every thread is done with this stage
  }
  // v's first block comes in while the statistics are taken.
  stage(KB, vp, st[8], 0, kKT);
  cp_async_commit();
  rows_softmax<bf16, kQBh>(R1, R2, lr, q0, N, blk.kend, m, qscale, eps,
                     [&](int r, int col, float p) { Pb[r * ldp + col] = __float2bfloat16(p); });

  // ---- pass 2: P V over the causal key blocks ----
  const int ng = (dk + 15) / 16;  // 16-column groups of the output
  float acc[2][2][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = 0.f;
  const int gw = w >> 1;  // this warp's groups: gw, gw + 4
  for (int kb = 0; kb <= last; ++kb) {
    if (kb + 1 <= last) {
      stage(KB + 2 * ((kb + 1) & 1) * tsz, vp, st[8], (kb + 1) * kKT, kKT);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Vb = KB + 2 * (kb & 1) * tsz;
#pragma unroll
    for (int k0 = 0; k0 < kKT; k0 += 16) {
      unsigned a[4];
      load_a(a, Pb, ldp, false, m0, kb * kKT + k0);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int gi = gw + 4 * u;
        if (gi < ng) {
          unsigned bb[4];
          load_b2(bb, Vb, ld, false, k0, 16 * gi);
          mma_bf16(acc[u][0], a, bb[0], bb[1]);
          mma_bf16(acc[u][1], a, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();  // every thread is done with this stage
  }
  const bool vecD = dk % 2 == 0;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int gi = gw + 4 * u;
    if (gi >= ng) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + m0 + (lane >> 2) + 8 * hh, c = 16 * gi + 8 * j + 2 * (lane & 3);
        if (row < N && c < dk)
          st2(op + (long long)row * st[17] + c, c, dk, acc[u][j][2 * hh], acc[u][j][2 * hh + 1],
              vecD);
      }
  }
}

// ---------------------------- the streaming kernel ----------------------------

// Rows k0.. of an input (row stride rs) as fp32 into a 64-row tile; rows at
// or beyond N are zero.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src, long long rs,
                                          int k0, int N, int dk, float mul) {
  for (int idx = threadIdx.x; idx < kTile * dk; idx += kThreads) {
    const int r = idx / dk, c = idx - r * dk;
    float x = 0.f;
    if (k0 + r < N) {
      x = to_f<T>(src[(long long)(k0 + r) * rs + c]);
      if (mul != 1.f) x = rnd<T>(x * mul);
    }
    dst[r * ld + c] = x;
  }
}

// The two 64 x 64 score tiles s1 = Q1 K1^T and s2 = Q2 K2^T for rows 4ty+i
// and columns tx+16j.
__device__ __forceinline__ void scores(const float* Q1, const float* K1, const float* Q2,
                                       const float* K2, int ld, int dk, float s1[4][4],
                                       float s2[4][4]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s1[i][j] = s2[i][j] = 0.f;
  for (int d = 0; d < dk; ++d) {
    float a[4], b[4], a2[4], b2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = Q1[(4 * ty + i) * ld + d];
      a2[i] = Q2[(4 * ty + i) * ld + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = K1[(tx + 16 * j) * ld + d];
      b2[j] = K2[(tx + 16 * j) * ld + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s1[i][j] = fmaf(a[i], b[j], s1[i][j]);
        s2[i][j] = fmaf(a2[i], b2[j], s2[i][j]);
      }
  }
}

// Merge one tile's (mean, M2) over nb columns of a row into the running
// (mu, m2) over na columns.
__device__ __forceinline__ void chan_merge(float& mu, float& m2, float na, float tmu, float tm2,
                                           float nb) {
  if (na == 0.f) {
    mu = tmu;
    m2 = tm2;
    return;
  }
  const float n = na + nb, delta = tmu - mu;
  mu = mu + delta * (nb / n);
  m2 = m2 + tm2 + delta * delta * (na * nb / n);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) quartet_stream_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ q2, const T* __restrict__ k2, T* __restrict__ o,
    const float* __restrict__ mix, int H, int N, int dk, Strides strides, float eps,
    float scale) {
  extern __shared__ float smem[];
  const long long* st = strides.s;
  const int ld = odd_stride(dk);
  const int ldp = kTile + 1;
  float* Q1s = smem;
  float* Q2s = Q1s + kTile * ld;
  float* K1s = Q2s + kTile * ld;  // k's key block; in pass 2 then v's
  float* K2s = K1s + kTile * ld;
  float* Ps = K2s + kTile * ld;

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const T* qp = q + b * st[0] + h * st[1];
  const T* kp = k + b * st[3] + h * st[4];
  const T* vp = v + b * st[6] + h * st[7];
  const T* q2p = q2 + b * st[9] + h * st[10];
  const T* k2p = k2 + b * st[12] + h * st[13];
  T* op = o + b * st[15] + h * st[16];
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float sc = rnd<T>(scale);
  const float m = mix[0], qscale = mix[1];

  load_rows<T>(Q1s, ld, qp + (long long)q0 * st[2], st[2], 0, N - q0, dk, sc);
  load_rows<T>(Q2s, ld, q2p + (long long)q0 * st[11], st[11], 0, N - q0, dk, sc);

  const int nkb = (N + kTile - 1) / kTile;
  float s1[4][4], s2[4][4];

  // Pass 1: each row's mean and M2 of both maps over all N columns.
  float mu1[4] = {}, m21[4] = {}, mu2[4] = {}, m22[4] = {};
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * kTile;
    const int nb = min(kTile, N - k0);
    __syncthreads();  // Q is staged; the previous block is done with K
    load_rows<T>(K1s, ld, kp, st[5], k0, N, dk, 1.f);
    load_rows<T>(K2s, ld, k2p, st[14], k0, N, dk, 1.f);
    __syncthreads();
    scores(Q1s, K1s, Q2s, K2s, ld, dk, s1, s2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < nb) {
          a += s1[i][j];
          c += s2[i][j];
        }
      const float ta = half_sum(a) / (float)nb, tc = half_sum(c) / (float)nb;
      float da = 0.f, dc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (tx + 16 * j < nb) {
          da += (s1[i][j] - ta) * (s1[i][j] - ta);
          dc += (s2[i][j] - tc) * (s2[i][j] - tc);
        }
      da = half_sum(da);
      dc = half_sum(dc);
      chan_merge(mu1[i], m21[i], (float)k0, ta, da, (float)nb);
      chan_merge(mu2[i], m22[i], (float)k0, tc, dc, (float)nb);
    }
  }
  float den1[4], den2[4];
  const float dof = (float)max(1, N - 1);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    den1[i] = sqrtf(m21[i] / dof) + eps;
    den2[i] = sqrtf(m22[i] / dof) + eps;
  }

  // Pass 2: the key blocks up to the diagonal, online softmax and P V. In
  // bf16 a first sweep gets each row's final max and sum, so that the second
  // rounds the normalised probabilities, where the TPU kernel rounds them.
  constexpr bool kNormFirst = !std::is_same<T, float>::value;
  float mrun[4], l[4], acc[4][kOutCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    mrun[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }
  const int last = min(nkb - 1, (int)blockIdx.y);
  for (int sweep = kNormFirst ? 0 : 1; sweep < 2; ++sweep)
  for (int kb = 0; kb <= last; ++kb) {
    const bool stats_only = sweep == 0, normalised = kNormFirst && sweep == 1;
    const int k0 = kb * kTile;
    __syncthreads();  // the previous block is done with V and P
    load_rows<T>(K1s, ld, kp, st[5], k0, N, dk, 1.f);
    load_rows<T>(K2s, ld, k2p, st[14], k0, N, dk, 1.f);
    __syncthreads();
    scores(Q1s, K1s, Q2s, K2s, ld, dk, s1, s2);
    if (!stats_only) {
      __syncthreads();  // every thread is done with k's block
      load_rows<T>(K1s, ld, vp, st[8], k0, N, dk, 1.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float a = (s1[i][j] - mu1[i]) / den1[i];
        const float c = (s2[i][j] - mu2[i]) / den2[i];
        float x = (1.f - m) * a + m * (a * c) * qscale;
        if (col >= N || col > row) x = -INFINITY;
        s1[i][j] = x;
        mx = fmaxf(mx, x);
      }
      if (normalised) {  // mrun and l are the row's final max and sum
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Ps[(4 * ty + i) * ldp + tx + 16 * j] = rnd<T>(expf(s1[i][j] - mrun[i]) / l[i]);
        continue;
      }
      mx = half_max(mx);
      const float m_new = fmaxf(mrun[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(mrun[i]) ? expf(mrun[i] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s1[i][j] - m_safe);
        rs += pr;
        if (!stats_only) Ps[(4 * ty + i) * ldp + tx + 16 * j] = rnd<T>(pr);
      }
      l[i] = l[i] * alpha + half_sum(rs);
      mrun[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    if (stats_only) continue;
    __syncthreads();
    for (int mm = 0; mm < kTile; ++mm) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(4 * ty + i) * ldp + mm];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int col = tx + 16 * c;
        if (col < dk) {
          const float vv = K1s[mm * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pr[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    const float denom = kNormFirst ? 1.f : fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dk) op[(long long)row * st[17] + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

size_t stream_smem_bytes(int dk) {
  return sizeof(float) * (4 * (size_t)kTile * odd_stride(dk) + (size_t)kTile * (kTile + 1));
}

// Shared-memory bytes of the kernel that takes (N, dk) in `dtype`: the
// kept-rows kernel's where its rows fit, else the streaming kernel's.
size_t smem_bytes(int dtype, int N, int dk) {
  return rows_fit(dtype, N, dk) ? (size_t)rows_bytes(dtype, N, dk) : stream_smem_bytes(dk);
}

// The kept-rows kernel of each dtype.
inline auto rows_kernel(float*) { return quartet_rows_f32_kernel; }
inline auto rows_kernel(bf16*) { return quartet_rows_tc_kernel; }

template <typename T>
int launch(const void* const* in, void* out, const float* mix, int B, int H, int N, int dk,
           const long long* st, float eps, float scale, int vec, cudaStream_t stream) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  Strides strides;
  for (int i = 0; i < 18; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(dtype, N, dk);
  const T *x0 = (const T*)in[0], *x1 = (const T*)in[1], *x2 = (const T*)in[2],
          *x3 = (const T*)in[3], *x4 = (const T*)in[4];
  cudaError_t e;
  if (rows_fit(dtype, N, dk)) {
    auto kernel = rows_kernel((T*)nullptr);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int qb = rows_qb(dtype);
    const int grid = B * H * ((N + qb - 1) / qb);
    kernel<<<grid, kThreads, smem, stream>>>(
        x0, x1, x2, x3, x4, (T*)out, mix, H, N, dk, strides, eps, scale, vec);
  } else {
    e = cudaFuncSetAttribute(quartet_stream_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    dim3 grid(B * H, (N + kTile - 1) / kTile);
    quartet_stream_kernel<T><<<grid, kThreads, smem, stream>>>(
        x0, x1, x2, x3, x4, (T*)out, mix, H, N, dk, strides, eps, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes of one CTA at (N, dk) (`dtype` 0 fp32, 1 bf16), of the
// kept-rows kernel where its rows fit and of the streaming kernel above.
extern "C" long long mop_quartet_smem_bytes(int dtype, int N, int dk) {
  return (long long)mop::smem_bytes(dtype, N, dk);
}

// Whether K5 keeps the raw score rows at (N, dk): 1 kept rows, 0 streaming.
extern "C" int mop_quartet_keeps_rows(int dtype, int N, int dk) {
  return mop::rows_fit(dtype, N, dk) ? 1 : 0;
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 18 element strides: (b, h, row) of
// q, k, v, q2, k2 and out, in that order; feature strides are 1. `mix` is an
// fp32 device array (m, qscale): the sigmoid'd mixture and the quartet scale.
// `vec` is the width in bytes (16, 8 or 4) of the fp32 kept-rows kernel's
// asynchronous row copies, which must divide the inputs' addresses, strides
// and rows. Returns a cudaError_t code.
extern "C" int mop_quartet_fwd(int dtype, const void* q, const void* k, const void* v,
                               const void* q2, const void* k2, void* out, const void* mix, int B,
                               int H, int N, int dk, const long long* strides, float eps,
                               float scale, int vec, void* stream) {
  if (N < 1 || N > 65535 * mop::kTile || (long long)B * H * N > (1LL << 31) || dk < 1 ||
      dk > mop::kMaxDk || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[5] = {q, k, v, q2, k2};
  const float* mx = (const float*)mix;
  if (dtype == 0)
    return mop::launch<float>(in, out, mx, B, H, N, dk, strides, eps, scale, vec, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(in, out, mx, B, H, N, dk, strides, eps, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}
