// Stages shared by the edgewise kernels that keep their N x N maps in a
// per-program workspace in device memory, the backward K2b / K3b
// (edgewise_bwd.cu, both instantiations), and the gate-head policy classes
// that the forward kernels K2 and K3 (edgewise_fwd.cuh) take too. The gate
// heads, `lowrank_factors` and
// `gated_mix` take any program type with the workspace accessors (`Prog`
// here, the bf16 backward's `ProgTC`), and load an edge's V scores together
// (`load_views`) before they use any. The dense head walks the edges in
// 16 x 16 blocks staged in shared memory (`stage_block`, `dense_mix`).
//
// One CTA runs one (batch*head) program. `recompute_forward` rebuilds the
// forward of `_edgewise_math` (lowrank gate head) or `_edgewise_dense_math`
// (dense gate head) + `_edgewise_output` of mop_tpu/ops/fused.py up to the
// softmaxed attention and the value transport, leaving every map the
// backward reads in the workspace. The gate head is a policy class:
// `LowrankGate` pools row and column features into rank-r factors,
// `DenseGate` runs the per-edge 1x1 MLP C -> 16 -> 4 (tanh GELU, sigmoid)
// over the feature stack [S_1..S_V, S_1^T..S_V^T, log c_fwd, log c_bwd].
//
// Rounding follows the JAX math: the operands of every product are rounded
// to T where it casts them; softmax statistics, the gate heads, the logit
// algebra and every cotangent stay fp32.
#pragma once

#include "common.cuh"

namespace mop {

constexpr int kMaxN = kTile;
constexpr int kMaxDk = 2 * kTile;
constexpr int kMaxViews = 8;
constexpr int kHidden = 16;                 // hidden width of the dense gate head
constexpr int kMaxC = 2 * kMaxViews + 2;    // gate-head input channels at most

// (b, h, view, row) element strides of qs, ks and vs, then (b, h, row) of
// the output (forward) or of dy (backward).
struct Strides {
  long long s[15];
};

// Five fp32 device pointers: a gate head's weights and chain_w, or their grads.
struct Weights {
  const float* p[5];
};
struct Grads {
  float* p[5];
};

// Floats of one staging buffer: an N x N map, an N x dk or a dk x N operand.
__host__ __device__ inline int buf_floats(int N, int dk) {
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  return max(max(N * ldm, N * ldd), dk * ldm);
}

// Floats of one program's workspace: 5V - 1 maps of N x N and V - 1
// transports of N x dk.
__host__ __device__ inline long long ws_floats(int V, int N, int dk) {
  return (long long)(5 * V - 1) * N * N + (long long)(V - 1) * N * dk;
}

// One program's inputs and its workspace maps, row stride N: S_i (later
// dS_i), A_i, F_1..F_{V-1} (F_{V-1} later d c_fwd), B_1..B_{V-1} (B_{V-1}
// later d c_bwd), att (later d LF in the lowrank backward), dAc_i; then the
// rounded transports P_1..P_{V-1}, row stride dk.
template <typename T>
struct Prog {
  const T* qp;
  const T* kp;
  const T* vp;
  const long long* st;
  int V, N, dk, nn;
  long long vsz;
  float* ws;
  __device__ float* S(int i) const { return ws + i * nn; }
  __device__ float* A(int i) const { return ws + (V + i) * nn; }
  __device__ float* Fm(int j) const { return ws + (2 * V + j - 1) * nn; }
  __device__ float* Bm(int j) const { return ws + (3 * V - 1 + j - 1) * nn; }
  __device__ float* ATT() const { return ws + (4 * V - 2) * nn; }
  __device__ float* DA(int i) const { return ws + (4 * V - 1 + i) * nn; }
  __device__ float* P(int i) const { return ws + (5 * V - 1) * nn + (i - 1) * vsz; }
};

template <typename T>
__device__ __forceinline__ Prog<T> make_prog(const T* qs, const T* ks, const T* vs,
                                             const long long* st, float* workspace, int H,
                                             int V, int N, int dk) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  Prog<T> p;
  p.qp = qs + b * st[0] + h * st[1];
  p.kp = ks + b * st[4] + h * st[5];
  p.vp = vs + b * st[8] + h * st[9];
  p.st = st;
  p.V = V;
  p.N = N;
  p.dk = dk;
  p.nn = N * N;
  p.vsz = (long long)N * dk;
  p.ws = workspace + bh * ws_floats(V, N, dk);
  return p;
}

// dst = src (rows x cols, row stride lds), or its transpose, rounded to T
// when asked.
template <typename T>
__device__ void stage(float* dst, int ldst, const float* src, int lds, int rows, int cols,
                      bool trans, bool round) {
  for (int idx = threadIdx.x; idx < rows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx - r * cols;
    float x = src[r * lds + c];
    if (round) x = rnd<T>(x);
    if (trans)
      dst[c * ldst + r] = x;
    else
      dst[r * ldst + c] = x;
  }
}

// D (=|+=) alpha * tile, optionally rounded to T after the scaling.
template <typename T>
__device__ __forceinline__ void put(float* D, int ld, int rows, int cols, int c0,
                                    const Tile& t, float alpha, bool add, bool round) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < rows && c < cols) {
        float x = alpha * t.v[i][j];
        if (add) x += D[r * ld + c];
        D[r * ld + c] = round ? rnd<T>(x) : x;
      }
    }
  }
}

// An output row block of T (rows of row stride ld) = alpha * tile.
template <typename T>
__device__ __forceinline__ void put_out(T* D, long long ld, int rows, int cols, int c0,
                                        const Tile& t, float alpha) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < rows && c < cols) D[r * ld + c] = from_f<T>(alpha * t.v[i][j]);
    }
  }
}

// D = P * (D - rowsum(D * P)) over N x N maps: the softmax VJP, with P the
// probabilities and D the cotangent of P. With `out` set the result is
// added into out instead of overwriting D.
__device__ void softmax_vjp_rows(const float* P, int ldp, float* D, int ldd_, float* out,
                                 int ldo, int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kThreads / 32) {
    const float p0 = lane < N ? P[r * ldp + lane] : 0.f;
    const float p1 = lane + 32 < N ? P[r * ldp + lane + 32] : 0.f;
    const float d0 = lane < N ? D[r * ldd_ + lane] : 0.f;
    const float d1 = lane + 32 < N ? D[r * ldd_ + lane + 32] : 0.f;
    const float s = warp_sum(p0 * d0 + p1 * d1);
    if (out) {
      if (lane < N) out[r * ldo + lane] += p0 * (d0 - s);
      if (lane + 32 < N) out[r * ldo + lane + 32] += p1 * (d1 - s);
    } else {
      if (lane < N) D[r * ldd_ + lane] = p0 * (d0 - s);
      if (lane + 32 < N) D[r * ldd_ + lane + 32] = p1 * (d1 - s);
    }
  }
}

// Row means into rowf[r * C + ch] and column means into colf[c * C + ch] of
// an N x N map (of log(x + 1e-6) with `logc`); with ch_t >= 0 the same
// means also fill the transposed channel ch_t.
__device__ void means(const float* M, int ld, int N, float* rowf, float* colf, int C, int ch,
                      int ch_t, bool logc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kThreads / 32) {
    const float* row = M + r * ld;
    float x0 = lane < N ? row[lane] : 0.f, x1 = lane + 32 < N ? row[lane + 32] : 0.f;
    if (logc) {
      x0 = lane < N ? logf(x0 + 1e-6f) : 0.f;
      x1 = lane + 32 < N ? logf(x1 + 1e-6f) : 0.f;
    }
    const float s = warp_sum(x0 + x1) / (float)N;
    if (lane == 0) {
      rowf[r * C + ch] = s;
      if (ch_t >= 0) colf[r * C + ch_t] = s;
    }
  }
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < N; ++r) s += logc ? logf(M[r * ld + c] + 1e-6f) : M[r * ld + c];
    s /= (float)N;
    colf[c * C + ch] = s;
    if (ch_t >= 0) rowf[c * C + ch_t] = s;
  }
}

// ------------------------------ gate heads ------------------------------

// Lowrank head: g_c(i, j) = sigmoid(a_c[i] . b_c[j]) over rank blocks, with
// a = row_feat wrow + brow and b = col_feat wcol + bcol from the row and
// column means of the feature stack (shared-memory arrays rowf .. bf).
struct LowrankGate {
  static constexpr bool kDense = false;
  const float *wrow, *brow, *wcol, *bcol;
  int r;
  float *rowf, *colf, *af, *bf;

  template <typename P>
  __device__ __forceinline__ void operator()(const P&, int i, int j, float g[4]) const {
    const int R4 = 4 * r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float z = 0.f;
      for (int u = 0; u < r; ++u) z = fmaf(af[i * R4 + c * r + u], bf[j * R4 + c * r + u], z);
      g[c] = 1.f / (1.f + expf(-z));
    }
  }
};

// d gelu / dx of the tanh GELU 0.5 x (1 + t), given t = tanh(sqrt(2 / pi)
// (x + 0.044715 x^3)).
__device__ __forceinline__ float gelu_tanh_grad(float x, float t) {
  const float k = 0.7978845608028654f;
  return 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * k * (1.f + 3.f * 0.044715f * x * x);
}

// Four consecutive floats of 16-byte-aligned shared memory.
__device__ __forceinline__ float4 ld4s(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Dense head: per edge, pre = b1 + feat w1 (C x 16), hidden = gelu(pre),
// g = sigmoid(b2 + hidden w2 (16 x 4)); the sums run in the JAX math's order.
// The weights are shared-memory copies, 16-byte aligned, read four at a
// time (w1 row-major C x 16, w2 16 x 4).
struct DenseGate {
  static constexpr bool kDense = true;
  const float *w1, *b1, *w2, *b2;
  int C;

  // sum over h of w1[c][h] y[h], in h order.
  __device__ __forceinline__ float dot_w1(int c, const float (&y)[kHidden]) const {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kHidden / 4; ++q) {
      const float4 w = ld4s(w1 + c * kHidden + 4 * q);
      s = fmaf(w.x, y[4 * q], s);
      s = fmaf(w.y, y[4 * q + 1], s);
      s = fmaf(w.z, y[4 * q + 2], s);
      s = fmaf(w.w, y[4 * q + 3], s);
    }
    return s;
  }

  // x += f * w1[c][0 .. 15].
  __device__ __forceinline__ void pre_add(float f, int c, float (&x)[kHidden]) const {
#pragma unroll
    for (int q = 0; q < kHidden / 4; ++q) {
      const float4 w = ld4s(w1 + c * kHidden + 4 * q);
      x[4 * q] = x[4 * q] + f * w.x;
      x[4 * q + 1] = x[4 * q + 1] + f * w.y;
      x[4 * q + 2] = x[4 * q + 2] + f * w.z;
      x[4 * q + 3] = x[4 * q + 3] + f * w.w;
    }
  }

  // From the C features f (in registers: the channel loop unrolled; or in
  // shared memory: one channel at a time, fewer registers): the
  // pre-activations x, th = tanh of the GELU's argument (its backward reuses
  // it) and the four gates g.
  __device__ __forceinline__ void head(const float (&f)[kMaxC], float (&x)[kHidden],
                                       float (&th)[kHidden], float (&g)[4]) const {
    init(x);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      if (c < C) pre_add(f[c], c, x);
    gates(x, th, g);
  }

  __device__ __forceinline__ void head(const float* f, float (&x)[kHidden],
                                       float (&th)[kHidden], float (&g)[4]) const {
    init(x);
#pragma unroll 2
    for (int c = 0; c < C; ++c) pre_add(f[c], c, x);
    gates(x, th, g);
  }

  __device__ __forceinline__ void init(float (&x)[kHidden]) const {
#pragma unroll
    for (int q = 0; q < kHidden / 4; ++q) {
      const float4 b = ld4s(b1 + 4 * q);
      x[4 * q] = b.x;
      x[4 * q + 1] = b.y;
      x[4 * q + 2] = b.z;
      x[4 * q + 3] = b.w;
    }
  }

  __device__ __forceinline__ void gates(const float (&x)[kHidden], float (&th)[kHidden],
                                        float (&g)[4]) const {
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    const float4 b = ld4s(b2);
    g[0] = b.x;
    g[1] = b.y;
    g[2] = b.z;
    g[3] = b.w;
#pragma unroll
    for (int h = 0; h < kHidden; ++h) {
      const float u = x[h];
      th[h] = tanhf(k * (u + 0.044715f * u * u * u));
      const float a = 0.5f * u * (1.f + th[h]);
      const float4 w = ld4s(w2 + 4 * h);
      g[0] = g[0] + a * w.x;
      g[1] = g[1] + a * w.y;
      g[2] = g[2] + a * w.z;
      g[3] = g[3] + a * w.w;
    }
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4) g[c4] = 1.f / (1.f + expf(-g[c4]));
  }

  // The head's backward through GELU: x (the pre-activations) becomes
  // dpre = (w2 dz) * gelu'(x).
  __device__ __forceinline__ void dpre(const float (&dz)[4], const float (&th)[kHidden],
                                       float (&x)[kHidden]) const {
#pragma unroll
    for (int h = 0; h < kHidden; ++h) {
      const float4 w = ld4s(w2 + 4 * h);
      float dh = 0.f;
      dh = fmaf(w.x, dz[0], dh);
      dh = fmaf(w.y, dz[1], dh);
      dh = fmaf(w.z, dz[2], dh);
      dh = fmaf(w.w, dz[3], dh);
      x[h] = dh * gelu_tanh_grad(x[h], th[h]);
    }
  }
};

// Copy the dense head's weights (w1 C x 16, b1 16, w2 16 x 4, b2 4) into
// shared memory at dst (16-byte aligned) and return the head over that copy.
__device__ inline DenseGate load_dense_gate(const Weights& w, int C, float* dst) {
  const int n1 = C * kHidden, n2 = kHidden * 4;
  for (int k = threadIdx.x; k < n1; k += kThreads) dst[k] = w.p[0][k];
  for (int k = threadIdx.x; k < kHidden; k += kThreads) dst[n1 + k] = w.p[1][k];
  for (int k = threadIdx.x; k < n2; k += kThreads) dst[n1 + kHidden + k] = w.p[2][k];
  for (int k = threadIdx.x; k < 4; k += kThreads) dst[n1 + kHidden + n2 + k] = w.p[3][k];
  DenseGate g;
  g.w1 = dst;
  g.b1 = dst + n1;
  g.w2 = dst + n1 + kHidden;
  g.b2 = dst + n1 + kHidden + n2;
  g.C = C;
  return g;
}

// Floats of the dense head's shared-memory copy.
__host__ __device__ inline int dense_gate_floats(int C) { return C * kHidden + kHidden + kHidden * 4 + 4; }

// The lowrank head's pooled log-chain features and its rank factors
// a = row_feat wrow + brow, b = col_feat wcol + bcol (the score channels'
// means are taken as each S_i is formed). Ends without a barrier.
template <class P>
__device__ void lowrank_factors(const P& p, const LowrankGate& gate) {
  const int V = p.V, N = p.N, C = 2 * V + 2;
  const int r = gate.r, R4 = 4 * r;
  means(p.Fm(V - 1), N, N, gate.rowf, gate.colf, C, 2 * V, -1, true);
  means(p.Bm(V - 1), N, N, gate.rowf, gate.colf, C, 2 * V + 1, -1, true);
  __syncthreads();
  for (int idx = threadIdx.x; idx < N * R4; idx += kThreads) {
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

// The V score values of edge idx, all loads issued before any is used (the
// views past V read nothing); kept in registers by the unrolled loops.
template <class P>
__device__ __forceinline__ void load_views(const P& p, int idx, float (&s)[kMaxViews]) {
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c) s[c] = c < p.V ? p.S(c)[idx] : 0.f;
}

// The sum and the log-sum-exp over views 0..V-1 of s, in view order.
__device__ __forceinline__ void view_stats(const float (&s)[kMaxViews], int V, float& ssum,
                                           float& lse) {
  float m = -INFINITY;
  ssum = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c)
    if (c < V) {
      m = fmaxf(m, s[c]);
      ssum += s[c];
    }
  float l = 0.f;
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c)
    if (c < V) l += expf(s[c] - m);
  lse = m + logf(l);
}

// The gated logit mix of every edge into ATT (before its softmax).
template <class P, class Gate>
__device__ void gated_mix(const P& p, const Gate& gate, float beta_not) {
  const int V = p.V, N = p.N, nn = p.nn;
  const float n_others = (float)max(1, V - 1);
  for (int idx = threadIdx.x; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    float s[kMaxViews];
    load_views(p, idx, s);
    const float lf = logf(p.Fm(V - 1)[idx] + 1e-6f);
    float g[4];
    gate(p, i, j, g);
    float ssum, lse;
    view_stats(s, V, ssum, lse);
    const float others = ssum - s[0];
    float smix = s[0];
    smix = smix + g[0] * others;
    smix = smix + g[1] * (lse - s[0]);
    smix = smix - g[2] * (beta_not * (others / n_others));
    smix = smix + g[3] * lf;
    p.ATT()[idx] = smix;
  }
}

// --------------------------- the dense head's edge walk ---------------------------
//
// The dense head reads, at edge (i, j), the V scores S_c(i, j), the V
// transposed scores S_c(j, i) and log c_fwd(i, j), log c_bwd(i, j). The stages
// that run it (`dense_mix` below, `dense_gate_backward` in edgewise_bwd.cu)
// walk the edges in 16 x 16 blocks: a block's S_c, c_fwd and c_bwd tiles and
// the S_c tiles of its transposed block are staged in shared memory with
// row-contiguous loads, so a transposed channel costs no column walk of the
// workspace, and each log is taken once.

constexpr int kEB = 16;         // edge block side
constexpr int kEL = kEB + 1;    // row stride of an edge tile
constexpr int kET = kEB * kEL;  // floats of an edge tile

// Stage `ntiles` (at most V + 2) tiles of edge block (bi, bj) at dst:
// S_0 .. S_{V-1}, then (ntiles = V + 2) c_fwd and c_bwd; entries past N are
// zero. A thread loads its element of every tile before it stores any.
template <class P>
__device__ void stage_block(const P& p, float* dst, int bi, int bj, int ntiles) {
  const int N = p.N, V = p.V;
  const int r = threadIdx.x >> 4, c = threadIdx.x & (kEB - 1);
  const int i = bi * kEB + r, j = bj * kEB + c;
  const bool in = i < N && j < N;
  float v[kMaxViews + 2];
#pragma unroll
  for (int t = 0; t < kMaxViews + 2; ++t) {
    const float* src = t < V ? p.S(t) : (t == V ? p.Fm(V - 1) : p.Bm(V - 1));
    v[t] = (t < ntiles && in) ? src[i * N + j] : 0.f;
  }
#pragma unroll
  for (int t = 0; t < kMaxViews + 2; ++t)
    if (t < ntiles) dst[t * kET + r * kEL + c] = v[t];
}

// Feature c of edge (r, cc) of the staged block X, with Y its transposed
// block's tiles: S_c at (r, cc) of X; S_{c-V} at (cc, r) of Y; then X's
// c_fwd and c_bwd tiles (whose logs the caller takes).
__device__ __forceinline__ const float* feat_at(const float* X, const float* Y, int V, int c,
                                                int r, int cc) {
  return c < V       ? X + c * kET + r * kEL + cc
         : c < 2 * V ? Y + (c - V) * kET + cc * kEL + r
                     : X + (c - V) * kET + r * kEL + cc;
}

// The C features of edge (r, cc) of block X into f, the two log channels
// taken here (once) and also returned in lf, lb; s gets the V scores.
__device__ __forceinline__ void edge_features(const float* X, const float* Y, int V, int C,
                                              int r, int cc, float (&f)[kMaxC],
                                              float (&s)[kMaxViews], float& lf, float& lb) {
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) {
    float x = 0.f;
    if (c < C) {
      x = *feat_at(X, Y, V, c, r, cc);
      if (c >= 2 * V) x = logf(x + 1e-6f);
      if (c == 2 * V) lf = x;
      if (c == 2 * V + 1) lb = x;
    }
    f[c] = x;
  }
#pragma unroll
  for (int c = 0; c < kMaxViews; ++c) s[c] = c < V ? f[c] : 0.f;
}

// The gated logit mix of every edge into ATT with the dense head, the edges
// walked in 16 x 16 blocks staged at scr (2V + 2 tiles). Ends without a barrier.
template <class P>
__device__ void dense_mix(const P& p, const DenseGate& gate, float* scr, float beta_not) {
  const int V = p.V, N = p.N, nb = (N + kEB - 1) / kEB;
  const float n_others = (float)max(1, V - 1);
  float* X = scr;
  float* Y = scr + (V + 2) * kET;
  const int r = threadIdx.x >> 4, cc = threadIdx.x & (kEB - 1);
  for (int bi = 0; bi < nb; ++bi)
    for (int bj = 0; bj < nb; ++bj) {
      __syncthreads();  // the last block's tiles are read
      stage_block(p, X, bi, bj, V + 2);
      stage_block(p, Y, bj, bi, V);
      __syncthreads();
      const int i = bi * kEB + r, j = bj * kEB + cc;
      if (i < N && j < N) {
        float f[kMaxC], s[kMaxViews], x[kHidden], th[kHidden], g[4];
        float lf = 0.f, lb = 0.f;
        edge_features(X, Y, V, gate.C, r, cc, f, s, lf, lb);
        gate.head(f, x, th, g);
        float ssum, lse;
        view_stats(s, V, ssum, lse);
        const float others = ssum - s[0];
        float smix = s[0];
        smix = smix + g[0] * others;
        smix = smix + g[1] * (lse - s[0]);
        smix = smix - g[2] * (beta_not * (others / n_others));
        smix = smix + g[3] * lf;
        p.ATT()[i * N + j] = smix;
      }
    }
}

// ------------------------- the forward, recomputed -------------------------

// Rebuild the forward into the workspace: S_i, A_i (fp32, unrounded), both
// chains' partial products (unrounded: the last one feeds the log), the
// softmaxed attention att, and the rounded transports P_i. X, Y, Z and W are
// staging buffers of at least buf_floats(N, dk) floats (W at least N x
// odd_stride(N)); the dense head's mix walks its edge blocks in dscr
// ((2V + 2) edge tiles). Ends without a barrier.
template <typename T, class Gate>
__device__ void recompute_forward(const Prog<T>& p, const Gate& gate, float* X, float* Y, float* Z,
                                  float* W, float beta_not, float sc, float* dscr) {
  const int V = p.V, N = p.N, dk = p.dk;
  const long long* st = p.st;
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  const int C = 2 * V + 2;
  const int n_col_tiles = (dk + kTile - 1) / kTile;
  Tile t;

  for (int vi = 0; vi < V; ++vi) {
    __syncthreads();
    stage_in<T>(X, ldd, p.qp + vi * st[2], st[3], N, dk, false, sc);
    stage_in<T>(Y, ldm, p.kp + vi * st[6], st[7], N, dk, true, 1.f);
    __syncthreads();
    mm_nn(X, ldd, Y, ldm, dk, N, N, 0, t);
    put<T>(p.S(vi), N, N, N, 0, t, 1.f, false, false);
    __syncthreads();
    if constexpr (!Gate::kDense) means(p.S(vi), N, N, gate.rowf, gate.colf, C, vi, V + vi, false);
    softmax_rows<float>(p.S(vi), p.A(vi), N, N);
  }
  // Chains: each partial product is stored unrounded (the last one feeds the
  // log) and rounded when it is read as the next product's operand.
  for (int j = 1; j < V; ++j) {
    __syncthreads();
    if (j == 1) {
      stage<T>(X, ldm, p.A(0), N, N, N, false, true);
      stage<T>(Y, ldm, p.A(1), N, N, N, false, true);
      stage<T>(Z, ldm, p.A(V - 1), N, N, N, false, true);
      stage<T>(W, ldm, p.A(V - 2), N, N, N, false, true);
    } else {
      stage<T>(X, ldm, p.Fm(j - 1), N, N, N, false, true);
      stage<T>(Y, ldm, p.A(j), N, N, N, false, true);
      stage<T>(Z, ldm, p.Bm(j - 1), N, N, N, false, true);
      stage<T>(W, ldm, p.A(V - 1 - j), N, N, N, false, true);
    }
    __syncthreads();
    mm_nn(X, ldm, Y, ldm, N, N, N, 0, t);
    put<T>(p.Fm(j), N, N, N, 0, t, 1.f, false, false);
    mm_nn(Z, ldm, W, ldm, N, N, N, 0, t);
    put<T>(p.Bm(j), N, N, N, 0, t, 1.f, false, false);
  }
  __syncthreads();
  if constexpr (Gate::kDense) {
    dense_mix(p, gate, dscr, beta_not);
  } else {
    lowrank_factors(p, gate);
    __syncthreads();
    gated_mix(p, gate, beta_not);
  }
  __syncthreads();
  softmax_rows<float>(p.ATT(), p.ATT(), N, N);
  // Transport: P_{V-1} = Ac_{V-1} v_{V-1}, P_i = Ac_i c(P_{i+1}), stored rounded.
  for (int i = V - 1; i >= 1; --i) {
    __syncthreads();
    stage<T>(X, ldm, p.A(i), N, N, N, false, true);
    if (i == V - 1)
      stage_in<T>(Y, ldd, p.vp + (V - 1) * st[10], st[11], N, dk, false, 1.f);
    else
      stage<T>(Y, ldd, p.P(i + 1), dk, N, dk, false, false);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put<T>(p.P(i), dk, N, dk, ct * kTile, t, 1.f, false, true);
    }
  }
}

}  // namespace mop
