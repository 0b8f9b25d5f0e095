// The forward kernels of the E-mode (edgewise) attention, shared by K2
// (lowrank gate head, edgewise_lowrank_fwd.cu) and K3 (dense gate head,
// edgewise_dense_fwd.cu), templated on the gate-head policy class of
// edgewise_stages.cuh (`LowrankGate`, `DenseGate`), as the JAX package
// shares `_edgewise_output` between `_edgewise_math` and
// `_edgewise_dense_math`. One CTA runs one (batch*head) program through the
// whole pipeline:
//   1. per view i: S_i = (q_i * scale) k_i^T and A_i = softmax(S_i) (fp32
//      statistics, stored rounded to the compute dtype, the only form the
//      pipeline reads A_i in);
//   2. c_fwd = A_0 A_1 ... A_{V-1}, c_bwd = A_{V-1} ... A_0 (each partial
//      product rounded before the next dot), then log(c + 1e-6);
//   3. the gate head over the channels [S_1..S_V, S_1^T..S_V^T, logC_fwd,
//      logC_bwd], folded into the gated logit mix:
//      - lowrank: the row and column means of every channel (taken as each
//        map is formed), the rank-r factors a = row_feat wrow + brow,
//        b = col_feat wcol + bcol, gates sigmoid(a_c b_c^T); S_0, the other
//        views' sum and the running log-sum-exp over views stay in the
//        registers each S_i comes out of its product in;
//      - dense: per edge (i, j), the 1x1 MLP C -> 16 -> 4 (tanh GELU,
//        sigmoid) on S_c(i, j), S_c(j, i) of every view and both logs. An
//        edge reads the V scores at (i, j) and at (j, i), so the V fp32
//        score maps are written once, as they are formed, to a per-program
//        workspace in device memory (V N round4(N) floats: 80 KB at the main
//        shape, which the L2 holds for the resident programs), and read back
//        once by the mix, one edge at a time with the next edge's lines
//        prefetched into L1; log c_fwd and log c_bwd stay in registers
//        (bf16) or go to shared memory (fp32, whose two thread groups split
//        the mix); the view statistics are taken per edge from the scores;
//   4. the final softmax, and y = att v_0 + w A_0 (A_1 (... (A_{V-1} v_{V-1}))).
// Every other map stays on chip. Two kernels:
// - bf16 (`edgewise_fwd_tc_kernel`): every product on the tensor cores
//   (`mma.sync` from `ldmatrix`, q, k and v brought in by `cp.async`, the
//   next view's while this one's product runs); the A_i kept in bf16; two
//   programs an SM at the main shape.
// - fp32 (`edgewise_fwd_f32_kernel`): true fp32 on CUDA cores (the JAX
//   kernel uses HIGHEST precision). The fp32 A_i keep a program to one SM,
//   so the program takes 512 threads, two groups of 256 that run
//   independent products side by side: the views two at a time, the forward
//   chain beside the backward chain, the transport beside the lowrank mix
//   (the dense mix, longer, both groups share; the transport then runs
//   beside att v_0). Where the dense head's V maps A_i do not fit beside
//   the rest (many views with wide heads) they sit in the workspace. Each
//   thread owns a 4 x 4 tile whose operands it reads as float4s (the left
//   operand along k, the right one along its columns).
#pragma once

#include <algorithm>

#include "edgewise_stages.cuh"

namespace mop {

constexpr int kF32Threads = 512;  // the fp32 kernel: two groups of kThreads
constexpr int kMaxSmem = 232448;  // shared memory one block may take on the H100
constexpr int kRed = 10 * kTile;  // the bf16 kernel's cross-warp row and column sums

// Row stride, in floats, of a dense-head score map in the workspace: float4
// (fp32 kernel) and float2 (bf16 kernel) stores stay aligned.
__host__ __device__ inline int ws_ld(int N) { return round4(N); }

// The gated logit mix at edge (i, j) with the dense head: the features are
// S_c(i, j), S_c(j, i) of the V maps at S (row stride lds, map stride msz),
// then lf, lb; the channel sums run in the JAX math's order, and the view
// statistics as `view_stats`.
__device__ __forceinline__ float dense_edge_mix(const DenseGate& gate, const float* S, int lds,
                                                int msz, int V, int i, int j, float lf,
                                                float lb, float beta_not) {
  float s[kMaxViews], x[kHidden], th[kHidden], g[4];
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c) s[c] = c < V ? S[c * msz + i * lds + j] : 0.f;
  float ssum, lse;
  view_stats(s, V, ssum, lse);
  const float s0 = s[0], others = ssum - s0;
  gate.init(x);
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c)
    if (c < V) gate.pre_add(s[c], c, x);
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c)
    if (c < V) gate.pre_add(S[c * msz + j * lds + i], V + c, x);
  gate.pre_add(lf, 2 * V, x);
  gate.pre_add(lb, 2 * V + 1, x);
  gate.gates(x, th, g);
  const float n_others = (float)max(1, V - 1);
  float smix = s0;
  smix = smix + g[0] * others;
  smix = smix + g[1] * (lse - s0);
  smix = smix - g[2] * (beta_not * (others / n_others));
  smix = smix + g[3] * lf;
  return smix;
}

// A hint to bring the line of p into L1 (the mixes read the score maps
// from device memory, one edge at a time).
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];" ::"l"(p));
}

// The lowrank mix at edge (i, j): gates from the factors, the view
// statistics from the registers.
__device__ __forceinline__ float lowrank_edge_mix(const LowrankGate& gate, int i, int j, float s1,
                                                  float others, float lse, float lf,
                                                  float n_others, float beta_not) {
  float g[4];
  gate(0, i, j, g);
  float smix = s1;
  smix = smix + g[0] * others;
  smix = smix + g[1] * (lse - s1);
  smix = smix - g[2] * (beta_not * (others / n_others));
  smix = smix + g[3] * lf;
  return smix;
}

// The rank-r factors of the lowrank head from its pooled features, by
// `nthr` threads. Ends without a barrier.
__device__ __forceinline__ void factors(const LowrankGate& gate, int N, int C, int tid, int nthr) {
  const int R4 = 4 * gate.r;
  for (int idx = tid; idx < N * R4; idx += nthr) {
    const int i = idx / R4, c = idx - i * R4;
    float sa = 0.f, sb = 0.f;
    for (int k = 0; k < C; ++k) {
      sa = fmaf(gate.rowf[i * C + k], gate.wrow[k * R4 + c], sa);
      sb = fmaf(gate.colf[i * C + k], gate.wcol[k * R4 + c], sb);
    }
    gate.af[idx] = sa + gate.brow[c];
    gate.bf[idx] = sb + gate.bcol[c];
  }
}

// =========================== fp32: CUDA cores ===========================

// Floats of the fp32 kernel's shared memory before the gate head's arrays:
// the V maps A_i (unless `a_ws`: then they sit in the workspace) and the two
// groups' areas (or the lowrank statistics merge).
__host__ __device__ inline int f32_maps_floats(bool dense, int V, int N, int dk, bool a_ws) {
  const int ldn = ld4(N), ldd = ld4(dk), msz = N * ldn;
  const int area = max(N * ldd + dk * ldn, msz + N * ldd);
  return (a_ws ? 0 : V * msz) + (dense ? 2 * area : max(2 * area, 3 * msz));
}

inline size_t smem_bytes_f32(bool dense, int V, int N, int dk, int r, bool a_ws) {
  const int C = 2 * V + 2, msz = N * ld4(N);
  const size_t tail = dense ? (size_t)msz + round4(dense_gate_floats(C))
                            : 2 * (size_t)N * C + 2 * (size_t)N * 4 * r + 2 * (kThreads / 32) * N;
  return sizeof(float) * (f32_maps_floats(dense, V, N, dk, a_ws) + tail);
}

// Whether the dense head's fp32 kernel keeps its V maps A_i in the workspace:
// only where they do not fit on chip beside the rest (at N = 64: V = 5 with dk > 100,
// V >= 6 with dk >= 100, V = 8 with dk >= 80).
inline bool dense_a_ws(int dtype, int V, int N, int dk) {
  return dtype == 0 && smem_bytes_f32(true, V, N, dk, 1, false) > (size_t)kMaxSmem;
}

// Floats of one program's dense-head workspace: the V score maps, then (fp32,
// `a_ws`) the V maps A_i.
__host__ __device__ inline long long dense_ws_floats(int V, int N, bool a_ws) {
  return (long long)V * N * ws_ld(N) + (a_ws ? (long long)V * N * ld4(N) : 0);
}

// Barrier of one group of kThreads threads (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kThreads) : "memory");
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

// The weights of either head: wts.p[0..3] the head's (lowrank wrow, brow,
// wcol, bcol; dense w1, b1, w2, b2), p[4] chain_w. The lowrank head reads
// its weights from device memory and keeps its pooled features and factors
// at `arr`; the dense head is copied to `arr` (16-byte aligned) by all
// `nthr` threads, which the caller's next barrier publishes.
template <class Gate>
__device__ __forceinline__ Gate make_gate(const Weights& wts, int N, int C, int r, float* arr);

template <>
__device__ __forceinline__ LowrankGate make_gate<LowrankGate>(const Weights& wts, int N, int C,
                                                              int r, float* arr) {
  LowrankGate g;
  g.wrow = wts.p[0];
  g.brow = wts.p[1];
  g.wcol = wts.p[2];
  g.bcol = wts.p[3];
  g.r = r;
  g.rowf = arr;
  g.colf = arr + N * C;
  g.af = g.colf + N * C;
  g.bf = g.af + N * 4 * r;
  return g;
}

template <>
__device__ __forceinline__ DenseGate make_gate<DenseGate>(const Weights& wts, int, int C, int,
                                                          float* arr) {
  return load_dense_gate(wts, C, arr);
}

// Floats of the gate head's shared-memory arrays (16-byte aligned size).
__host__ __device__ inline int gate_floats(bool dense, int N, int C, int r) {
  return dense ? round4(dense_gate_floats(C)) : 2 * N * C + 2 * N * 4 * r;
}

template <class Gate, bool kAWs>
__global__ void __launch_bounds__(kF32Threads, 1) edgewise_fwd_f32_kernel(
    const float* __restrict__ qs, const float* __restrict__ ks, const float* __restrict__ vs,
    float* __restrict__ out, Weights wts, float* __restrict__ maps, int H, int V, int N, int dk,
    int r, Strides strides, float beta_not, float scale) {
  constexpr bool kDense = Gate::kDense;
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const int ldn = ld4(N), ldd = ld4(dk);
  const int C = 2 * V + 2;
  const int tid = threadIdx.x, grp = tid >> 8, gt = tid & (kThreads - 1);
  const int ty = gt >> 4, tx = gt & 15;
  const int msz = N * ldn;
  const int area = max(N * ldd + dk * ldn, msz + N * ldd);
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int lds = ws_ld(N), wsz = N * lds;
  float* S = kDense ? maps + bh * dense_ws_floats(V, N, kAWs) : nullptr;  // the score maps
  float* A = kAWs ? S + V * wsz : smem;                 // the V maps A_i
  float* G = kAWs ? smem : smem + V * msz;              // the groups' areas, or the merge maps
  float* mine = G + grp * area;
  float* tail = smem + f32_maps_floats(kDense, V, N, dk, kAWs);
  // lowrank: features and factors, then each warp's column sums; dense: the
  // head's weights, then log c_bwd.
  const Gate gate = make_gate<Gate>(wts, N, C, r, tail);
  float* colp = tail + gate_floats(false, N, C, r);
  float* LB = tail + gate_floats(true, N, C, r);

  const float* qp = qs + b * st[0] + h * st[1];
  const float* kp = ks + b * st[4] + h * st[5];
  const float* vp = vs + b * st[8] + h * st[9];
  float* op = out + b * st[12] + h * st[13];
  const float w = *wts.p[4];
  const int n_ct = (dk + kTile - 1) / kTile;

  // ---- 1. the views, two at a time: group g takes views g, g + 2, ... ----
  // lowrank: view statistics in the tile's registers: S_0 (group 0), the sum
  // of this group's other views, and the running max and sum of exp over
  // its views. dense: each S_i to the workspace.
  float s0[4][4], ot[4][4], mx[4][4], ls[4][4], t[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s0[i][j] = ot[i][j] = ls[i][j] = 0.f;
      mx[i][j] = -INFINITY;
    }
  {
    float* Q = mine;             // N x ldd: q_i * scale
    float* KT = mine + N * ldd;  // dk x ldn: k_i^T
    for (int vi = grp; vi < V; vi += 2) {
      group_sync(grp);  // the last view's operands are read
      load_rows(Q, ldd, qp + vi * st[2], st[3], N, dk, false, scale, gt);
      load_rows(KT, ldn, kp + vi * st[6], st[7], N, dk, true, 1.f, gt);
      group_sync(grp);
      mm4(Q, ldd, KT, ldn, dk, N, N, 0, gt, t);
      if constexpr (kDense) {
        if (4 * tx < N) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (4 * ty + i < N)
              *reinterpret_cast<float4*>(S + vi * wsz + (4 * ty + i) * lds + 4 * tx) =
                  make_float4(t[i][0], t[i][1], t[i][2], t[i][3]);
        }
      } else {
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
        tile_means(t, N, grp, gt, colp, gate.rowf, gate.colf, C, vi, V + vi);
      }
      tile_softmax(t, N, gt, A + vi * msz, ldn);
    }
  }
  __syncthreads();
  if constexpr (!kDense) {
    // Group 1's statistics join group 0's: the other views' sum, and the
    // log-sum-exp over all views (kept in mx).
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
  }

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
  if constexpr (kDense) {
    put4(grp == 0 ? mine : LB, ldn, N, N, 0, gt, t);  // log c_fwd over the dead running product
  } else {
    tile_means(t, N, grp, gt, colp, gate.rowf, gate.colf, C, 2 * V + grp, -1);
  }
  __syncthreads();

  if constexpr (kDense) {
    // ---- 3. the dense mix, both groups: group g takes rows 4ty + 2g, + 1 of
    // the thread's tile, one edge at a time; smix replaces log c_fwd ----
    float* LF = G;
#pragma unroll 1
    for (int k = 0; k < 8; ++k) {
      const int ri = 4 * ty + 2 * grp + (k >> 2), cj = 4 * tx + (k & 3);
      if (k + 1 < 8) {  // the next edge's scores toward L1 while this one mixes
        const int r1 = min(4 * ty + 2 * grp + ((k + 1) >> 2), N - 1);
        const int c1 = min(4 * tx + ((k + 1) & 3), N - 1);
        for (int c = 0; c < V; ++c) {
          prefetch_l1(S + c * wsz + r1 * lds + c1);
          prefetch_l1(S + c * wsz + c1 * lds + r1);
        }
      }
      if (ri < N && cj < N) {
        float* lf = LF + ri * ldn + cj;
        *lf = dense_edge_mix(gate, S, lds, wsz, V, ri, cj, *lf, LB[ri * ldn + cj], beta_not);
      }
    }
  } else {
    // ---- 3. the lowrank head's rank-r factors ----
    factors(gate, N, C, tid, kF32Threads);
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
    if constexpr (kDense) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s0[i][j] = mine[min(4 * ty + i, N - 1) * ldn + min(4 * tx + j, N - 1)];
      group_sync(grp);  // att overwrites the mixed logits
    } else {
      const float n_others = (float)max(1, V - 1);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ri = min(4 * ty + i, N - 1), cj = min(4 * tx + j, N - 1);
          s0[i][j] = lowrank_edge_mix(gate, ri, cj, s0[i][j], ot[i][j], mx[i][j], t[i][j],
                                      n_others, beta_not);
        }
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

// ========================== bf16: tensor cores ==========================
//
// Eight warps tile every 64 x 64 product as 4 x 2 warp tiles of 16 x 32
// (`MTile`); a thread holds rows r0 and r0 + 8 of eight columns. Shared
// memory: the V maps Ac_i (bf16, 64 rows of mma_ld(N)), four operand
// buffers of 64 rows of mma_ld(max(N, dk)) (q and k of this view and the
// next; then the running c(F_j) and c(B_j), then c(att), v_{V-1} and the
// running transport, and v_0), the gate head's arrays (lowrank: features
// and factors; dense: its weights), and the cross-warp sums.

inline size_t smem_bytes_tc(bool dense, int V, int N, int dk, int r) {
  const size_t bf = (size_t)V * kTile * mma_ld(N) + 4 * (size_t)kTile * mma_ld(std::max(N, dk));
  return 2 * bf + sizeof(float) * ((size_t)gate_floats(dense, N, 2 * V + 2, r) + kRed);
}

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

template <class Gate>
__global__ void __launch_bounds__(kThreads, 2) edgewise_fwd_tc_kernel(
    const bf16* __restrict__ qs, const bf16* __restrict__ ks, const bf16* __restrict__ vs,
    bf16* __restrict__ out, Weights wts, float* __restrict__ maps, int H, int V, int N, int dk,
    int r, Strides strides, float beta_not, float scale, int vec) {
  constexpr bool kDense = Gate::kDense;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long* st = strides.s;
  const int ldn = mma_ld(N), ldb = mma_ld(max(N, dk));
  const int C = 2 * V + 2;
  bf16* Acs = reinterpret_cast<bf16*>(smem_raw);  // the V maps Ac_i
  bf16* bufs = Acs + V * kTile * ldn;              // four operand buffers
  auto Ac = [&](int i) { return Acs + i * kTile * ldn; };
  auto Bf = [&](int i) { return bufs + i * kTile * ldb; };
  float* arr = reinterpret_cast<float*>(bufs + 4 * kTile * ldb);
  const Gate gate = make_gate<Gate>(wts, N, C, r, arr);
  float* rred = arr + gate_floats(kDense, N, C, r);  // three rounds of 2 x 64 row partials
  float* cred = rred + 6 * kTile;                    // 4 x 64 column partials

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const bf16* qp = qs + b * st[0] + h * st[1];
  const bf16* kp = ks + b * st[4] + h * st[5];
  const bf16* vp = vs + b * st[8] + h * st[9];
  bf16* op = out + b * st[12] + h * st[13];
  const int lds = ws_ld(N), wsz = N * lds;
  float* S = kDense ? maps + bh * dense_ws_floats(V, N, false) : nullptr;
  const float sc = rnd<bf16>(scale);
  const float w = *wts.p[4];
  const int n_ct = (dk + kTile - 1) / kTile;
  const TileIdx ti;
  MTile t;

  // ---- 1. the views; view i + 1's q and k are copied in during view i ----
  // lowrank: S_0, the other views' sum, running max and sum of exp in
  // registers; dense: each S_i to the workspace.
  MTile s0, ot, mx, ls;
  if constexpr (!kDense) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s0.v[j][e] = ot.v[j][e] = ls.v[j][e] = 0.f;
        mx.v[j][e] = -INFINITY;
      }
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
    if constexpr (kDense) {
      float* Sv = S + vi * wsz;
      for_pairs(t, N, N, 0, [&](int rr, int c, float x0, float x1) {
        st2(Sv + rr * lds + c, c, N, x0, x1, true);
      });
    } else {
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
      mtile_means(t, N, ti, rred, cred, gate.rowf, gate.colf, C, vi, V + vi);
    }
    mtile_softmax(t, N, ti, rred, Ac(vi), ldn);
  }
  if constexpr (!kDense) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx.v[j][e] += logf(ls.v[j][e]);  // the log-sum-exp
  }

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
  if constexpr (!kDense) {
    mtile_means(t, N, ti, rred, cred, gate.rowf, gate.colf, C, 2 * V, -1);
    mtile_means(tb, N, ti, rred, cred, gate.rowf, gate.colf, C, 2 * V + 1, -1);
    // ---- 3. the rank-r factors ----
    factors(gate, N, C, threadIdx.x, kThreads);
  }
  __syncthreads();  // the factors, or the score maps and the dense head's weights

  // ---- 4. the gated mix and its softmax: c(att) into buffer 0 ----
  if constexpr (kDense) {
    // One edge at a time (the head unrolled 16 times would spill), both logs
    // and the results through per-thread arrays.
    float lf[16], lb[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      lf[k] = t.v[k >> 2][k & 3];
      lb[k] = tb.v[k >> 2][k & 3];
    }
#pragma unroll 1
    for (int k = 0; k < 16; ++k) {
      const int j = k >> 2, e = k & 3;
      const int ri = min(ti.r0 + 8 * (e >> 1), N - 1), cj = min(ti.cb + 8 * j + (e & 1), N - 1);
      if (k + 1 < 16) {  // the next edge's scores toward L1 while this one mixes
        const int j1 = (k + 1) >> 2, e1 = (k + 1) & 3;
        const int r1 = min(ti.r0 + 8 * (e1 >> 1), N - 1), c1 = min(ti.cb + 8 * j1 + (e1 & 1), N - 1);
        for (int c = 0; c < V; ++c) {
          prefetch_l1(S + c * wsz + r1 * lds + c1);
          prefetch_l1(S + c * wsz + c1 * lds + r1);
        }
      }
      lf[k] = dense_edge_mix(gate, S, lds, wsz, V, ri, cj, lf[k], lb[k], beta_not);
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) t.v[k >> 2][k & 3] = lf[k];
  } else {
    const float n_others = (float)max(1, V - 1);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = min(ti.r0 + 8 * (e >> 1), N - 1), cj = min(ti.cb + 8 * j + (e & 1), N - 1);
        t.v[j][e] = lowrank_edge_mix(gate, ri, cj, s0.v[j][e], ot.v[j][e], mx.v[j][e], t.v[j][e],
                                     n_others, beta_not);
      }
  }
  bf16* AT = bufs;  // c(att), row stride ldn
  mtile_softmax(t, N, ti, rred, AT, ldn);

  // ---- 5. the transport P = c(Ac_i P) from v_{V-1} (buffer 2), and the output ----
  cp_async_wait<0>();
  __syncthreads();
  MTile y[2];
  for (int i = V - 1; i >= 1; --i) {
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_ct)
        mma_mm(y[ct], {Ac(i), false}, ldn, {Bf(2), false}, ldb, N, N, dk, ct * kTile, false);
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

// Shared-memory bytes of one program (`dtype` 0 fp32, 1 bf16).
inline size_t fwd_smem_bytes(bool dense, int dtype, int V, int N, int dk, int r) {
  return dtype == 1 ? smem_bytes_tc(dense, V, N, dk, r)
                    : smem_bytes_f32(dense, V, N, dk, r, dense && dense_a_ws(dtype, V, N, dk));
}

// Launch the forward of head `Gate`; `maps` is the dense head's workspace
// (B*H programs of dense_ws_floats each), null for the lowrank head.
template <class Gate>
int launch_fwd(int dtype, const void* qs, const void* ks, const void* vs, void* out,
               const Weights& w, float* maps, int B, int H, int V, int N, int dk, int r,
               const long long* st, float beta_not, float scale, int vec, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = fwd_smem_bytes(Gate::kDense, dtype, V, N, dk, r);
  cudaError_t e;
  if (dtype == 0) {
    // The dense head's maps A_i in the workspace only where they do not fit.
    auto kernel = edgewise_fwd_f32_kernel<Gate, false>;
    if constexpr (Gate::kDense)
      if (dense_a_ws(dtype, V, N, dk)) kernel = edgewise_fwd_f32_kernel<Gate, true>;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B * H, kF32Threads, smem, stream>>>(
        (const float*)qs, (const float*)ks, (const float*)vs, (float*)out, w, maps, H, V, N, dk,
        r, strides, beta_not, scale);
  } else {
    e = cudaFuncSetAttribute(edgewise_fwd_tc_kernel<Gate>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    edgewise_fwd_tc_kernel<Gate><<<B * H, kThreads, smem, stream>>>(
        (const bf16*)qs, (const bf16*)ks, (const bf16*)vs, (bf16*)out, w, maps, H, V, N, dk, r,
        strides, beta_not, scale, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace mop
