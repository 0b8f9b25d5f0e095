// K2: fused E-mode (edgewise, lowrank gate head) attention forward for Hopper.
//
// Replaces the Pallas forward `_edgewise_generic_fwd_kernel` over
// `_edgewise_math` + `_edgewise_output` in mop_tpu/ops/fused.py. One CTA runs
// one (batch*head) program through the whole pipeline:
//   1. per view i: S_i = (q_i * scale) k_i^T, its row and column means, and
//      A_i = softmax(S_i) (fp32 statistics, stored rounded to the compute
//      dtype, which is the only form the pipeline reads A_i in);
//   2. c_fwd = A_0 A_1 ... A_{V-1}, c_bwd = A_{V-1} ... A_0 (each partial
//      product rounded before the next dot), then log(c + 1e-6) and its means;
//   3. the rank-r factors a = row_feat wrow + brow, b = col_feat wcol + bcol
//      over the channel order [S_1..S_V, S_1^T..S_V^T, logC_fwd, logC_bwd];
//   4. the gated logit mix with gates sigmoid(a_c b_c^T), the final softmax,
//      and y = att v_0 + w A_0 (A_1 (... (A_{V-1} v_{V-1}))).
// No map goes to device memory. Each S_i comes out of its product in the
// same register layout for every view, so S_0, the other views' sum and the
// running log-sum-exp over views (max and sum of exponentials) stay in those
// registers, as does log c_fwd, and the mix reads them there. Shared memory
// holds the V probability maps (both chains and the transport read them
// all), the operands of the product at hand, the pooled features and the
// rank factors. Row and column sums of a register tile go through shuffles
// and then a fixed-order sum of the warps' partials.
//
// Bound on this card: about 9.4 Mflop per program at the main shape (the
// 2(V-1) N^3 chain products are almost half) against 3 V N dk inputs read
// once. Two kernels:
// - bf16 (E's train step, `edgewise_lowrank_tc_kernel`): every product on the
//   tensor cores (`mma.sync` from `ldmatrix`, q, k and v brought in by
//   `cp.async`, the next view's while this one's product runs); the A_i kept
//   in bf16; 99 KB of shared memory at the main shape, so two programs share
//   an SM.
// - fp32 (E's eval forward, `edgewise_lowrank_fwd_kernel`): true fp32 on CUDA
//   cores (the JAX kernel uses HIGHEST precision). The fp32 A_i keep a
//   program to one SM (171 KB), so the program takes 512 threads, two groups
//   of 256 that run independent products side by side: the views two at a
//   time, the forward chain beside the backward chain, the transport beside
//   the mix. Each thread owns a 4 x 4 tile whose operands it reads as
//   float4s (the left operand along k, the right one along its columns).
#include <algorithm>

#include "common.cuh"

namespace mop {

constexpr int kMaxN = kTile;
constexpr int kMaxDk = 2 * kTile;
constexpr int kF32Threads = 512;   // the fp32 kernel: two groups of kThreads
constexpr int kRed = 10 * kTile;   // the bf16 kernel's cross-warp row and column sums

// (b, h, view, row) element strides of qs, ks and vs, then (b, h, row) of out.
struct Strides {
  long long s[15];
};

// =========================== fp32: CUDA cores ===========================

// Row stride, in floats, of an fp32 map read with float4 loads: 16-byte
// rows, and two rows four apart fall in other banks.
__host__ __device__ inline int ld4(int x) { return ((x + 7) & ~7) + 4; }

// Barrier of one group of kThreads threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kThreads) : "memory");
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

// The row and column means of an N x N register tile (x[i][j] at row
// 4ty + i, column 4tx + j) into rowf[r * C + ch] and colf[c * C + ch] (and,
// with ch_t >= 0, the transposed channel: colf[r * C + ch_t] and
// rowf[c * C + ch_t]). A half warp holds a whole row; a column's partials
// go through colp (the group's 8 warps' sums), added in warp order.
__device__ void tile_means(const float (&x)[4][4], int N, int grp, int gt, float* colp,
                           float* rowf, float* colf, int C, int ch, int ch_t) {
  const int ty = gt >> 4, tx = gt & 15, gw = gt >> 5, lane = gt & 31;
  const float inv_n = 1.f / (float)N;
  float cs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool in = 4 * tx + j < N;
      s += in ? x[i][j] : 0.f;
      if (r < N && in) cs[j] += x[i][j];
    }
    s = half_sum(s) * inv_n;
    if (tx == 0 && r < N) {
      rowf[r * C + ch] = s;
      if (ch_t >= 0) colf[r * C + ch_t] = s;
    }
  }
  float* part = colp + grp * (kThreads / 32) * N;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    cs[j] += __shfl_xor_sync(0xffffffffu, cs[j], 16);
    if (lane < 16 && 4 * tx + j < N) part[gw * N + 4 * tx + j] = cs[j];
  }
  group_sync(grp);
  for (int c = gt; c < N; c += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += part[w * N + c];
    s *= inv_n;
    colf[c * C + ch] = s;
    if (ch_t >= 0) rowf[c * C + ch_t] = s;
  }
  group_sync(grp);
}

// Row softmax of an N x N register tile into D (row stride ld).
__device__ __forceinline__ void tile_softmax(const float (&x)[4][4], int N, int gt, float* D,
                                             int ld) {
  const int ty = gt >> 4, tx = gt & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * tx + j < N) m = fmaxf(m, x[i][j]);
    m = half_max(m);
    float e[4], s = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      e[j] = 4 * tx + j < N ? expf(x[i][j] - m) : 0.f;
      s += e[j];
    }
    s = half_sum(s);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (r < N && 4 * tx + j < N) D[r * ld + 4 * tx + j] = e[j] / s;
  }
}

// The elements idx, idx + step, idx + 2 step, ... of a block with `cols`
// columns, as (row, column): one division to start, none to advance.
struct RowCol {
  int r, c, dr, dc, cols;
  __device__ __forceinline__ RowCol(int idx, int step, int cols_) : cols(cols_) {
    r = idx / cols;
    c = idx - r * cols;
    dr = step / cols;
    dc = step - dr * cols;
  }
  __device__ __forceinline__ void next() {
    c += dc;
    r += dr;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
};

// dst[r][c] = src[r][c] * mul (rows x cols, row stride rs), or dst[c][r], by
// one group; a thread issues eight loads before it stores any.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src, long long rs,
                                          int rows, int cols, bool trans, float mul, int gt) {
  constexpr int kU = 8;
  const int n = rows * cols;
  for (int base = gt; base < n; base += kU * kThreads) {
    float x[kU];
    RowCol rc(base, kThreads, cols);
#pragma unroll
    for (int u = 0; u < kU; ++u, rc.next())
      x[u] = base + u * kThreads < n ? src[rc.r * rs + rc.c] * mul : 0.f;
    RowCol wc(base, kThreads, cols);
#pragma unroll
    for (int u = 0; u < kU; ++u, wc.next()) {
      if (base + u * kThreads < n) {
        if (trans)
          dst[wc.c * ld + wc.r] = x[u];
        else
          dst[wc.r * ld + wc.c] = x[u];
      }
    }
  }
}

__global__ void __launch_bounds__(kF32Threads, 1) edgewise_lowrank_fwd_kernel(
    const float* __restrict__ qs, const float* __restrict__ ks, const float* __restrict__ vs,
    float* __restrict__ out, const float* __restrict__ wrow, const float* __restrict__ brow,
    const float* __restrict__ wcol, const float* __restrict__ bcol,
    const float* __restrict__ chain_w, int H, int V, int N, int dk, int r, Strides strides,
    float beta_not, float scale) {
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const int ldn = ld4(N), ldd = ld4(dk);
  const int C = 2 * V + 2, R4 = 4 * r;
  const int tid = threadIdx.x, grp = tid >> 8, gt = tid & (kThreads - 1);
  const int ty = gt >> 4, tx = gt & 15;
  const int msz = N * ldn;
  const int area = max(N * ldd + dk * ldn, msz + N * ldd);
  float* A = smem;                                    // the V maps A_i
  float* G = A + V * msz;                             // the groups' areas, or the merge maps
  float* mine = G + grp * area;
  float* rowf = G + max(2 * area, 3 * msz);           // N x C pooled row features
  float* colf = rowf + N * C;                         // N x C pooled column features
  float* af = colf + N * C;                           // N x 4r row factors
  float* bf = af + N * R4;                            // N x 4r column factors
  float* colp = bf + N * R4;                          // 2 x 8 warps' column sums

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* qp = qs + b * st[0] + h * st[1];
  const float* kp = ks + b * st[4] + h * st[5];
  const float* vp = vs + b * st[8] + h * st[9];
  float* op = out + b * st[12] + h * st[13];
  const float w = *chain_w;
  const int n_ct = (dk + kTile - 1) / kTile;

  // ---- 1. the views, two at a time: group g takes views g, g + 2, ... ----
  // View statistics in the tile's registers: S_0 (group 0), the sum of this
  // group's other views, and the running max and sum of exp over its views.
  float s0[4][4], ot[4][4], mx[4][4], ls[4][4], t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s0[i][j] = ot[i][j] = ls[i][j] = 0.f;
      mx[i][j] = -INFINITY;
    }
  {
    float* Q = mine;          // N x ldd: q_i * scale
    float* KT = mine + N * ldd;  // dk x ldn: k_i^T
    for (int vi = grp; vi < V; vi += 2) {
      group_sync(grp);  // the last view's operands are read
      load_rows(Q, ldd, qp + vi * st[2], st[3], N, dk, false, scale, gt);
      load_rows(KT, ldn, kp + vi * st[6], st[7], N, dk, true, 1.f, gt);
      group_sync(grp);
      mm4(Q, ldd, KT, ldn, dk, N, N, 0, gt, t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = t[i][j];
          if (vi == 0)
            s0[i][j] = x;
          else
            ot[i][j] += x;
          if (x > mx[i][j]) {
            ls[i][j] = ls[i][j] * expf(mx[i][j] - x) + 1.f;
            mx[i][j] = x;
          } else {
            ls[i][j] += expf(x - mx[i][j]);
          }
        }
      tile_means(t, N, grp, gt, colp, rowf, colf, C, vi, V + vi);
      tile_softmax(t, N, gt, A + vi * msz, ldn);
    }
  }
  // Group 1's statistics join group 0's: the other views' sum, and the
  // log-sum-exp over all views (kept in mx).
  __syncthreads();
  if (grp == 1) {
    put4(G, ldn, N, N, 0, gt, ot);
    put4(G + msz, ldn, N, N, 0, gt, mx);
    put4(G + 2 * msz, ldn, N, N, 0, gt, ls);
  }
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int o = min(4 * ty + i, N - 1) * ldn + min(4 * tx + j, N - 1);
        const float m1 = G[msz + o], m = fmaxf(mx[i][j], m1);
        ot[i][j] += G[o];
        mx[i][j] = m + logf(ls[i][j] * expf(mx[i][j] - m) + G[2 * msz + o] * expf(m1 - m));
      }
  }
  __syncthreads();

  // ---- 2. the chains: group 0 c_fwd, group 1 c_bwd ----
  {
    float* M = mine;  // the running product
    for (int j = 1; j < V; ++j) {
      const int view = grp == 0 ? j : V - 1 - j;
      const float* X = j == 1 ? A + (grp == 0 ? 0 : V - 1) * msz : M;
      mm4(X, ldn, A + view * msz, ldn, N, N, N, 0, gt, t);
      if (j + 1 < V) {
        group_sync(grp);  // the group is done reading M
        put4(M, ldn, N, N, 0, gt, t);
        group_sync(grp);
      }
    }
  }
  // log(c + 1e-6): group 0 keeps log c_fwd in t for the mix.
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = logf(t[i][j] + 1e-6f);
  tile_means(t, N, grp, gt, colp, rowf, colf, C, 2 * V + grp, -1);
  __syncthreads();

  // ---- 3. the rank-r factors ----
  for (int idx = tid; idx < N * R4; idx += kF32Threads) {
    const int i = idx / R4, c = idx - i * R4;
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < C; ++k) {
      sa = fmaf(rowf[i * C + k], wrow[k * R4 + c], sa);
      sb = fmaf(colf[i * C + k], wcol[k * R4 + c], sb);
    }
    af[idx] = sa + brow[c];
    bf[idx] = sb + bcol[c];
  }
  __syncthreads();

  float y[2][4][4];
  if (grp == 1) {
    // ---- 4a. the transport: P = v_{V-1}, P = A_i P (i = V-1 .. 1), then A_0 P ----
    float* P = mine;
    load_rows(P, ldd, vp + (V - 1) * st[10], st[11], N, dk, false, 1.f, gt);
    for (int i = V - 1; i >= 0; --i) {
      group_sync(grp);
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
        if (ct < n_ct) mm4(A + i * msz, ldn, P, ldd, N, N, dk, ct * kTile, gt, y[ct]);
      group_sync(grp);
#pragma unroll
      for (int ct = 0; ct < 2; ++ct)
        if (ct < n_ct) put4(P, ldd, N, dk, ct * kTile, gt, y[ct]);
    }
  } else {
    // ---- 4b. the gated mix, its softmax, and att v_0 ----
    const float n_others = (float)max(1, V - 1);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ri = min(4 * ty + i, N - 1), cj = min(4 * tx + j, N - 1);
        float g[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float z = 0.f;
          for (int u = 0; u < r; ++u) z = fmaf(af[ri * R4 + c * r + u], bf[cj * R4 + c * r + u], z);
          g[c] = 1.f / (1.f + expf(-z));
        }
        const float s1 = s0[i][j], others = ot[i][j];
        float smix = s1;
        smix = smix + g[0] * others;
        smix = smix + g[1] * (mx[i][j] - s1);
        smix = smix - g[2] * (beta_not * (others / n_others));
        smix = smix + g[3] * t[i][j];
        s0[i][j] = smix;
      }
    float* ATT = mine;
    float* V0 = mine + msz;
    tile_softmax(s0, N, gt, ATT, ldn);
    load_rows(V0, ldd, vp, st[11], N, dk, false, 1.f, gt);
    group_sync(grp);
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_ct) mm4(ATT, ldn, V0, ldd, N, N, dk, ct * kTile, gt, y[ct]);
  }
  __syncthreads();  // group 1's A_0 P sits in its area
  if (grp == 0) {
    const float* CH = G + area;
#pragma unroll
    for (int ct = 0; ct < 2; ++ct) {
      if (ct >= n_ct) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = ct * kTile + 4 * tx + j;
          if (rr < N && c < dk) op[rr * st[14] + c] = y[ct][i][j] + w * CH[rr * ldd + c];
        }
      }
    }
  }
}

size_t smem_bytes_f32(int V, int N, int dk, int r) {
  const size_t ldn = ld4(N), ldd = ld4(dk), C = 2 * V + 2;
  const size_t area = std::max(N * ldd + dk * ldn, N * ldn + N * ldd);
  const size_t groups = std::max(2 * area, 3 * N * ldn);
  return sizeof(float) *
         (V * N * ldn + groups + 2 * N * C + 2 * (size_t)N * 4 * r + 2 * (kThreads / 32) * N);
}

// ========================== bf16: tensor cores ==========================
//
// Eight warps tile every 64 x 64 product as 4 x 2 warp tiles of 16 x 32
// (`MTile`); a thread holds rows r0 and r0 + 8 of eight columns. Shared
// memory: the V maps Ac_i (bf16, 64 rows of mma_ld(N)), four operand
// buffers of 64 rows of mma_ld(max(N, dk)) (q and k of this view and the
// next; then the running c(F_j) and c(B_j), then c(att), v_{V-1} and the
// running transport, and v_0), the features and factors, and the
// cross-warp sums.

// The rows (r0, r0 + 8) and the first column of a thread's MTile elements.
struct TileIdx {
  int r0, cb, half, quarter;
  __device__ TileIdx() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = 16 * (warp & 3) + (lane >> 2);
    cb = 32 * (warp >> 2) + 2 * (lane & 3);
    half = warp >> 2;
    quarter = warp & 3;
  }
};

// v[h] of row r0 + 8h over the 64 columns: each thread's part summed (or
// maxed) over its quad, then the two column halves' warps through red
// (2 x 64 floats), half 0 first. Every thread gets its rows' totals; ends
// with the barrier that makes red reusable only after a later barrier.
__device__ __forceinline__ void rows_reduce(float (&v)[2], float* red, const TileIdx& ti,
                                            bool is_max) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float u = __shfl_xor_sync(0xffffffffu, v[h], o);
      v[h] = is_max ? fmaxf(v[h], u) : v[h] + u;
    }
    if ((lane & 3) == 0) red[ti.half * kTile + ti.r0 + 8 * h] = v[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float a = red[ti.r0 + 8 * h], b = red[kTile + ti.r0 + 8 * h];
    v[h] = is_max ? fmaxf(a, b) : a + b;
  }
}

// Row and column means of an N x N MTile (the columns' partials over the
// four row quarters through cred), into rowf/colf channel ch and, with
// ch_t >= 0, the transposed channel ch_t. Ends with a barrier.
__device__ void mtile_means(const MTile& t, int N, const TileIdx& ti, float* rred, float* cred,
                            float* rowf, float* colf, int C, int ch, int ch_t) {
  const int lane = threadIdx.x & 31;
  const float inv_n = 1.f / (float)N;
  float rs[2] = {0.f, 0.f}, cs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = ti.r0 + 8 * (e >> 1), c = ti.cb + 8 * j + (e & 1);
      const float x = c < N ? t.v[j][e] : 0.f;
      rs[e >> 1] += x;
      if (e < 2) cs[j][e] = 0.f;
      if (r < N) cs[j][e & 1] += x;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int o = 4; o <= 16; o <<= 1) cs[j][e] += __shfl_xor_sync(0xffffffffu, cs[j][e], o);
      if (lane < 4) cred[ti.quarter * kTile + ti.cb + 8 * j + e] = cs[j][e];
    }
  rows_reduce(rs, rred, ti, false);
  if ((lane & 3) == 0 && ti.half == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = ti.r0 + 8 * h;
      if (r < N) {
        rowf[r * C + ch] = rs[h] * inv_n;
        if (ch_t >= 0) colf[r * C + ch_t] = rs[h] * inv_n;
      }
    }
  }
  for (int c = threadIdx.x; c < N; c += kThreads) {
    const float s = (cred[c] + cred[kTile + c] + cred[2 * kTile + c] + cred[3 * kTile + c]) * inv_n;
    colf[c * C + ch] = s;
    if (ch_t >= 0) rowf[c * C + ch_t] = s;
  }
  __syncthreads();
}

// Row softmax of an N x N MTile, rounded to bf16 into D (row stride ld),
// with zeros at rows and columns [N, N rounded up to 16). rred holds two
// rounds of row partials.
__device__ void mtile_softmax(const MTile& t, int N, const TileIdx& ti, float* rred, bf16* D,
                              int ld) {
  float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ti.cb + 8 * j + (e & 1) < N) m[e >> 1] = fmaxf(m[e >> 1], t.v[j][e]);
  rows_reduce(m, rred, ti, true);
  float s[2] = {0.f, 0.f};  // each exponential is taken again for the store
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ti.cb + 8 * j + (e & 1) < N) s[e >> 1] += expf(t.v[j][e] - m[e >> 1]);
  rows_reduce(s, rred + 2 * kTile, ti, false);
  const int n16 = (N + 15) & ~15;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ti.r0 + 8 * hh, c = ti.cb + 8 * j;
      if (r < n16 && c < n16) {
        const float x0 = r < N && c < N ? expf(t.v[j][2 * hh] - m[hh]) / s[hh] : 0.f;
        const float x1 = r < N && c + 1 < N ? expf(t.v[j][2 * hh + 1] - m[hh]) / s[hh] : 0.f;
        st2(D + r * ld + c, c, n16, x0, x1, true);
      }
    }
}

// D = c(t) (bf16, row stride ld) inside rows x cols, zeros at rows and
// columns up to the next multiple of 16.
__device__ __forceinline__ void mtile_store(const MTile& t, int rows, int cols, int c0,
                                            const TileIdx& ti, bf16* D, int ld) {
  const int r16 = (rows + 15) & ~15, c16 = (cols + 15) & ~15;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = ti.r0 + 8 * hh, c = c0 + ti.cb + 8 * j;
      if (r < r16 && c < c16) {
        const bool in = r < rows;
        st2(D + r * ld + c, c, c16, in && c < cols ? t.v[j][2 * hh] : 0.f,
            in && c + 1 < cols ? t.v[j][2 * hh + 1] : 0.f, true);
      }
    }
}

__global__ void __launch_bounds__(kThreads, 2) edgewise_lowrank_tc_kernel(
    const bf16* __restrict__ qs, const bf16* __restrict__ ks, const bf16* __restrict__ vs,
    bf16* __restrict__ out, const float* __restrict__ wrow, const float* __restrict__ brow,
    const float* __restrict__ wcol, const float* __restrict__ bcol,
    const float* __restrict__ chain_w, int H, int V, int N, int dk, int r, Strides strides,
    float beta_not, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long* st = strides.s;
  const int ldn = mma_ld(N), ldb = mma_ld(max(N, dk));
  const int C = 2 * V + 2, R4 = 4 * r;
  bf16* Acs = reinterpret_cast<bf16*>(smem_raw);  // the V maps Ac_i
  bf16* bufs = Acs + V * kTile * ldn;              // four operand buffers
  auto Ac = [&](int i) { return Acs + i * kTile * ldn; };
  auto Bf = [&](int i) { return bufs + i * kTile * ldb; };
  float* rowf = reinterpret_cast<float*>(bufs + 4 * kTile * ldb);
  float* colf = rowf + N * C;
  float* af = colf + N * C;
  float* bfac = af + N * R4;
  float* rred = bfac + N * R4;   // two rounds of 2 x 64 row partials, and one more
  float* cred = rred + 6 * kTile;  // 4 x 64 column partials

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bf16* qp = qs + b * st[0] + h * st[1];
  const bf16* kp = ks + b * st[4] + h * st[5];
  const bf16* vp = vs + b * st[8] + h * st[9];
  bf16* op = out + b * st[12] + h * st[13];
  const float sc = rnd<bf16>(scale);
  const float w = *chain_w;
  const int n_ct = (dk + kTile - 1) / kTile;
  const TileIdx ti;
  MTile t;

  // ---- 1. the views; view i + 1's q and k are copied in during view i ----
  MTile s0, ot, mx, ls;  // S_0, the other views' sum, running max and sum of exp
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s0.v[j][e] = ot.v[j][e] = ls.v[j][e] = 0.f;
      mx.v[j][e] = -INFINITY;
    }
  stage_async(Bf(0), ldb, qp, st[3], N, dk, vec);
  stage_async(Bf(1), ldb, kp, st[7], N, dk, vec);
  cp_async_commit();
  for (int vi = 0; vi < V; ++vi) {
    const int cur = 2 * (vi & 1);
    if (vi + 1 < V) {
      stage_async(Bf(2 - cur), ldb, qp + (vi + 1) * st[2], st[3], N, dk, vec);
      stage_async(Bf(3 - cur), ldb, kp + (vi + 1) * st[6], st[7], N, dk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scale_rows(Bf(cur), ldb, N, dk, sc);
    __syncthreads();
    mma_mm(t, {Bf(cur), false}, {Bf(cur + 1), true}, ldb, dk, N, N, 0, false);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = t.v[j][e];
        if (vi == 0)
          s0.v[j][e] = x;
        else
          ot.v[j][e] += x;
        if (x > mx.v[j][e]) {
          ls.v[j][e] = ls.v[j][e] * expf(mx.v[j][e] - x) + 1.f;
          mx.v[j][e] = x;
        } else {
          ls.v[j][e] += expf(x - mx.v[j][e]);
        }
      }
    mtile_means(t, N, ti, rred, cred, rowf, colf, C, vi, V + vi);
    mtile_softmax(t, N, ti, rred, Ac(vi), ldn);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx.v[j][e] += logf(ls.v[j][e]);  // the log-sum-exp

  // ---- 2. both chains, the running c(F_j), c(B_j) in buffers 0 and 1 (row stride ldn) ----
  bf16* RF = bufs;
  bf16* RB = bufs + kTile * ldn;
  MTile tb;
  for (int j = 1; j < V; ++j) {
    __syncthreads();  // the last step's operands are stored
    mma_mm(t, {j == 1 ? Ac(0) : RF, false}, {Ac(j), false}, ldn, N, N, N, 0, false);
    mma_mm(tb, {j == 1 ? Ac(V - 1) : RB, false}, {Ac(V - 1 - j), false}, ldn, N, N, N, 0, false);
    if (j + 1 < V) {
      __syncthreads();  // every warp is done reading RF and RB
      mtile_store(t, N, N, 0, ti, RF, ldn);
      mtile_store(tb, N, N, 0, ti, RB, ldn);
    }
  }
  // v_{V-1} and v_0 come in while the logs, means and factors are taken.
  stage_async(Bf(2), ldb, vp + (V - 1) * st[10], st[11], N, dk, vec);
  stage_async(Bf(3), ldb, vp, st[11], N, dk, vec);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      t.v[j][e] = logf(t.v[j][e] + 1e-6f);  // log c_fwd, kept for the mix
      tb.v[j][e] = logf(tb.v[j][e] + 1e-6f);
    }
  mtile_means(t, N, ti, rred, cred, rowf, colf, C, 2 * V, -1);
  mtile_means(tb, N, ti, rred, cred, rowf, colf, C, 2 * V + 1, -1);

  // ---- 3. the rank-r factors ----
  for (int idx = tid; idx < N * R4; idx += kThreads) {
    const int i = idx / R4, c = idx - i * R4;
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < C; ++k) {
      sa = fmaf(rowf[i * C + k], wrow[k * R4 + c], sa);
      sb = fmaf(colf[i * C + k], wcol[k * R4 + c], sb);
    }
    af[idx] = sa + brow[c];
    bfac[idx] = sb + bcol[c];
  }
  __syncthreads();

  // ---- 4. the gated mix and its softmax: c(att) into buffer 0 ----
  const float n_others = (float)max(1, V - 1);
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ri = min(ti.r0 + 8 * (e >> 1), N - 1), cj = min(ti.cb + 8 * j + (e & 1), N - 1);
      float g[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float z = 0.f;
        for (int u = 0; u < r; ++u) z = fmaf(af[ri * R4 + c * r + u], bfac[cj * R4 + c * r + u], z);
        g[c] = 1.f / (1.f + expf(-z));
      }
      const float s1 = s0.v[j][e], others = ot.v[j][e];
      float smix = s1;
      smix = smix + g[0] * others;
      smix = smix + g[1] * (mx.v[j][e] - s1);
      smix = smix - g[2] * (beta_not * (others / n_others));
      smix = smix + g[3] * t.v[j][e];
      s0.v[j][e] = smix;
    }
  bf16* AT = bufs;  // c(att), row stride ldn
  mtile_softmax(s0, N, ti, rred, AT, ldn);

  // ---- 5. the transport P = c(Ac_i P) from v_{V-1} (buffer 2), and the output ----
  cp_async_wait<0>();
  __syncthreads();
  MTile y[2];
  for (int i = V - 1; i >= 1; --i) {
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_ct) mma_mm(y[ct], {Ac(i), false}, ldn, {Bf(2), false}, ldb, N, N, dk, ct * kTile, false);
    __syncthreads();  // every warp is done reading the running P
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_ct) mtile_store(y[ct], N, dk, ct * kTile, ti, Bf(2), ldb);
    __syncthreads();
  }
  const bool vecD = dk % 2 == 0;
#pragma unroll
  for (int ct = 0; ct < 2; ++ct) {
    if (ct >= n_ct) continue;
    MTile ya;
    mma_mm(ya, {AT, false}, ldn, {Bf(3), false}, ldb, N, N, dk, ct * kTile, false);
    mma_mm(y[ct], {Ac(0), false}, ldn, {Bf(2), false}, ldb, N, N, dk, ct * kTile, false);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ya.v[j][e] += w * y[ct].v[j][e];
    for_pairs(ya, N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
      st2(op + rr * st[14] + c, c, dk, x0, x1, vecD);
    });
  }
}

size_t smem_bytes_tc(int V, int N, int dk, int r) {
  const size_t bf = (size_t)V * kTile * mma_ld(N) + 4 * (size_t)kTile * mma_ld(std::max(N, dk));
  return 2 * bf + sizeof(float) * (2 * (size_t)N * (2 * V + 2) + 2 * (size_t)N * 4 * r + kRed);
}

size_t smem_bytes(int dtype, int V, int N, int dk, int r) {
  return dtype == 1 ? smem_bytes_tc(V, N, dk, r) : smem_bytes_f32(V, N, dk, r);
}

int launch(int dtype, const void* qs, const void* ks, const void* vs, void* out,
           const float* const* w, int B, int H, int V, int N, int dk, int r, const long long* st,
           float beta_not, float scale, int vec, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(dtype, V, N, dk, r);
  cudaError_t e;
  if (dtype == 0) {
    e = cudaFuncSetAttribute(edgewise_lowrank_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    edgewise_lowrank_fwd_kernel<<<B * H, kF32Threads, smem, stream>>>(
        (const float*)qs, (const float*)ks, (const float*)vs, (float*)out, w[0], w[1], w[2], w[3],
        w[4], H, V, N, dk, r, strides, beta_not, scale);
  } else {
    e = cudaFuncSetAttribute(edgewise_lowrank_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    edgewise_lowrank_tc_kernel<<<B * H, kThreads, smem, stream>>>(
        (const bf16*)qs, (const bf16*)ks, (const bf16*)vs, (bf16*)out, w[0], w[1], w[2], w[3],
        w[4], H, V, N, dk, r, strides, beta_not, scale, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes one program needs (`dtype` 0 fp32, 1 bf16); the Python
// wrapper computes the same count and refuses shapes above the card's
// per-block limit before it launches.
extern "C" long long mop_edgewise_lowrank_smem_bytes(int dtype, int V, int N, int dk, int r) {
  return (long long)mop::smem_bytes(dtype, V, N, dk, r);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for out; feature strides are 1.
// Weights and chain_w are fp32 device arrays: wrow/wcol (2V+2, 4r) row-major,
// brow/bcol (4r,), chain_w one scalar. `vec` is the width in bytes (16, 8, 4
// or 2) of the bf16 kernel's asynchronous copies of q, k and v rows, which
// must divide their addresses, strides and rows (the fp32 kernel ignores
// it). Returns a cudaError_t code.
extern "C" int mop_edgewise_lowrank_fwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, void* out, const void* wrow,
                                        const void* brow, const void* wcol,
                                        const void* bcol, const void* chain_w, int B,
                                        int H, int V, int N, int dk, int r,
                                        const long long* strides, float beta_not,
                                        float scale, int vec, void* stream) {
  if (V < 2 || N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk || r < 1 || B < 1 ||
      H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* w[5] = {(const float*)wrow, (const float*)brow, (const float*)wcol,
                       (const float*)bcol, (const float*)chain_w};
  return mop::launch(dtype, qs, ks, vs, out, w, B, H, V, N, dk, r, strides, beta_not, scale, vec,
                     (cudaStream_t)stream);
}
