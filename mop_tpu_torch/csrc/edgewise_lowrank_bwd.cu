// K2b: backward of the fused E-mode (edgewise, lowrank gate head) attention
// for Hopper.
//
// Replaces the Pallas kernel `_edgewise_generic_bwd_kernel` in
// mop_tpu/ops/fused.py, which recomputes `_edgewise_math` +
// `_edgewise_output` per (batch*head) program and applies `jax.vjp` to it
// inside the kernel. CUDA has no such tool, so the VJP below is written out
// by hand. One CTA runs one program: it recomputes the forward, then walks
// the cotangents back. Notation per program, c(x) the cast to the compute
// dtype T (identity in fp32), Ac_i = c(A_i):
//
//   S_i = c(q_i * c(scale)) k_i^T, A_i = softmax(S_i)
//   F_1 = Ac_0 Ac_1, F_j = c(F_{j-1}) Ac_j        (c_fwd = F_{V-1})
//   B_1 = Ac_{V-1} Ac_{V-2}, B_j = c(B_{j-1}) Ac_{V-1-j}   (c_bwd = B_{V-1})
//   LF = log(c_fwd + 1e-6), LB = log(c_bwd + 1e-6)
//   a = row_feat wrow + brow, b = col_feat wcol + bcol, g_c = sigmoid(a_c b_c^T)
//   smix = S_0 + g_0 (sum - S_0) + g_1 (lse - S_0) - g_2 beta mean_others + g_3 LF
//   att = softmax(smix), P_V = v_{V-1}, P_i = Ac_i c(P_{i+1}) (i = V-1 .. 1)
//   y = c(att) v_0 + w Ac_0 c(P_1)
//
// Cotangents, in the order the kernel computes them (dy given):
//
// 1. Output and transport. dw = sum(dy * (Ac_0 c(P_1))), d att = dy v_0^T,
//    dv_0 = c(att)^T dy, dAc_0 = w dy c(P_1)^T, dP_1 = w Ac_0^T dy, then for
//    i = 1 .. V-1: dAc_i = dP_i c(P_{i+1})^T and dP_{i+1} = Ac_i^T dP_i;
//    dv_{V-1} = dP_V. Only v_0 and v_{V-1} receive a gradient: the views in
//    between are written with zeros.
// 2. Softmax of smix and the mix. d smix = att * (d att - rowsum(d att * att)).
//    With p_i = exp(S_i - lse) the softmax over views and n_o = max(1, V-1):
//    dS_0 = d smix (1 - g_1) + d smix g_1 p_0,
//    dS_i = d smix (g_0 - g_2 beta / n_o) + d smix g_1 p_i     (i >= 1),
//    dg_0 = d smix (sum - S_0), dg_1 = d smix (lse - S_0),
//    dg_2 = -d smix beta mean_others, dg_3 = d smix LF, d LF = d smix g_3.
// 3. Gates. dz_c = dg_c g_c (1 - g_c); da_c = dz_c b_c, db_c = dz_c^T a_c;
//    dwrow = row_feat^T da, dbrow = colsum(da) (and col likewise, per
//    program); d row_feat = da wrow^T, d col_feat = db wcol^T.
// 4. Pooled features, channels [S_1..S_V, S_1^T..S_V^T, LF, LB]. For c < V:
//    dS_c[i, j] += (drf[i, c] + dcf[i, V+c] + drf[j, V+c] + dcf[j, c]) / N;
//    d LF[i, j] += (drf[i, 2V] + dcf[j, 2V]) / N, d LB likewise with 2V+1;
//    then d c_fwd = d LF / (c_fwd + 1e-6), d c_bwd = d LB / (c_bwd + 1e-6).
// 5. Chains. From dF_{V-1} = d c_fwd, for j = V-1 .. 2:
//    dAc_j += c(F_{j-1})^T dF_j, dF_{j-1} = dF_j Ac_j^T; then
//    dAc_0 += dF_1 Ac_1^T, dAc_1 += Ac_0^T dF_1. The backward chain the same
//    way with Ac_{V-1-j} in place of Ac_j.
// 6. Score maps. dS_i += A_i * (dAc_i - rowsum(dAc_i * A_i)),
//    dq_i = c(scale) dS_i k_i, dk_i = dS_i^T c(q_i * c(scale)).
//
// The state does not fit in shared memory: the backward needs about 5V maps
// of N x N fp32 per program (about 400 KB at V = 5, N = 64) against the
// 227 KB one block may take. So every map that lives across phases sits in a
// per-program workspace in device memory, which the Python wrapper allocates
// (about 450 KB per program at the main shape, mostly served from the 50 MB
// L2 while the 132 resident programs work on it). Shared memory holds the
// operands of the product being computed (staged from the workspace, with
// the transpose and the rounding applied on the way in), the gate
// cotangents, d smix, the running dF / dP and the small feature and factor
// arrays. Every sum is taken in a fixed order inside one block, and the
// per-program weight grads are summed by the caller: no atomics anywhere.
//
// Rounding follows the forward: the operands of every product are rounded
// to T where `_edgewise_math` casts them; softmax statistics, the gate head,
// the logit algebra and every cotangent stay fp32.
//
// Bound on this card: the recompute (about 8.5 Mflop per program at the main
// shape) plus about 19 Mflop of backward products, against inputs,
// dy and grads read or written once: bound by the FMA rate in fp32. The
// products run on CUDA cores in true fp32, each thread owning 4 x 4 tiles.
#include "common.cuh"

namespace mop {

constexpr int kMaxN = kTile;
constexpr int kMaxDk = 2 * kTile;
constexpr int kMaxViews = 8;

// (b, h, view, row) element strides of qs, ks and vs, then (b, h, row) of dy.
struct Strides {
  long long s[15];
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

// dst = an input (rows x dk, row stride rs, feature stride 1) times `mul`,
// or its transpose. With mul != 1 the product is rounded to T, as the
// forward scales q in the compute dtype.
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

// An output row block of T (contiguous rows of ld elements) = alpha * tile.
template <typename T>
__device__ __forceinline__ void put_out(T* D, int ld, int rows, int cols, int c0,
                                        const Tile& t, float alpha) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (r < rows && c < cols) D[(long long)r * ld + c] = from_f<T>(alpha * t.v[i][j]);
    }
  }
}

// Row softmax of an N x N map (row stride ld) into dst, fp32, one warp a row.
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
    if (lane < N) dst[r * ld + lane] = e0 / sum;
    if (lane + 32 < N) dst[r * ld + lane + 32] = e1 / sum;
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

// The four gates of edge (i, j): sigmoid(a_c[i] . b_c[j]) over rank blocks.
__device__ __forceinline__ void gates(const float* af, const float* bf, int i, int j, int r,
                                      float g[4]) {
  const int R4 = 4 * r;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float z = 0.f;
    for (int u = 0; u < r; ++u) z = fmaf(af[i * R4 + c * r + u], bf[j * R4 + c * r + u], z);
    g[c] = 1.f / (1.f + expf(-z));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) edgewise_lowrank_bwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ dy, T* __restrict__ dq, T* __restrict__ dkey, T* __restrict__ dv,
    const float* __restrict__ wrow, const float* __restrict__ brow,
    const float* __restrict__ wcol, const float* __restrict__ bcol,
    const float* __restrict__ chain_w, float* __restrict__ dwrow, float* __restrict__ dbrow,
    float* __restrict__ dwcol, float* __restrict__ dbcol, float* __restrict__ dchain,
    float* __restrict__ workspace, int H, int V, int N, int dk, int r, Strides strides,
    float beta_not, float scale) {
  extern __shared__ float smem[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  const int C = 2 * V + 2, R4 = 4 * r;
  const int nbuf = buf_floats(N, dk);
  float* X = smem;              // staged left operand
  float* Y = X + nbuf;          // staged right operand
  float* Z = Y + nbuf;          // dy, then the running dP, dF and dB
  float* DSM = Z + nbuf;        // d att, then d smix
  float* DZ = DSM + N * ldm;    // the four gate-logit cotangents
  float* rowf = DZ + 4 * N * ldm;
  float* colf = rowf + N * C;
  float* af = colf + N * C;
  float* bf = af + N * R4;
  float* daf = bf + N * R4;
  float* dbf = daf + N * R4;
  float* drf = dbf + N * R4;
  float* dcf = drf + N * C;
  float* red = dcf + N * C;     // one float per warp

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const T* qp = qs + b * st[0] + h * st[1];
  const T* kp = ks + b * st[4] + h * st[5];
  const T* vp = vs + b * st[8] + h * st[9];
  const T* dyp = dy + b * st[12] + h * st[13];
  const long long vsz = (long long)N * dk;
  T* dqp = dq + bh * V * vsz;
  T* dkp = dkey + bh * V * vsz;
  T* dvp = dv + bh * V * vsz;
  const int nn = N * N;
  // Workspace maps, row stride N: S_i (later dS_i), A_i, F_1..F_{V-1} (F_{V-1}
  // later d c_fwd), B_1..B_{V-1} (B_{V-1} later d c_bwd), att (later d LF),
  // dAc_i; then the rounded transports P_1..P_{V-1}, row stride dk.
  float* ws = workspace + bh * ws_floats(V, N, dk);
  auto S = [&](int i) { return ws + i * nn; };
  auto A = [&](int i) { return ws + (V + i) * nn; };
  auto Fm = [&](int j) { return ws + (2 * V + j - 1) * nn; };
  auto Bm = [&](int j) { return ws + (3 * V - 1 + j - 1) * nn; };
  float* ATT = ws + (4 * V - 2) * nn;
  auto DA = [&](int i) { return ws + (4 * V - 1 + i) * nn; };
  auto P = [&](int i) { return ws + (5 * V - 1) * nn + (i - 1) * vsz; };
  const float sc = rnd<T>(scale);
  const float w = *chain_w;
  const float inv_n = 1.f / (float)N;
  const int n_col_tiles = (dk + kTile - 1) / kTile;
  Tile t, t2[2];

  // ---------------- recompute the forward ----------------
  for (int vi = 0; vi < V; ++vi) {
    __syncthreads();
    stage_in<T>(X, ldd, qp + vi * st[2], st[3], N, dk, false, sc);
    stage_in<T>(Y, ldm, kp + vi * st[6], st[7], N, dk, true, 1.f);
    __syncthreads();
    mm_nn(X, ldd, Y, ldm, dk, N, N, 0, t);
    put<T>(S(vi), N, N, N, 0, t, 1.f, false, false);
    __syncthreads();
    means(S(vi), N, N, rowf, colf, C, vi, V + vi, false);
    softmax_rows(S(vi), A(vi), N, N);
  }
  // Chains: each partial product is stored unrounded (the last one feeds the
  // log) and rounded when it is read as the next product's operand.
  for (int j = 1; j < V; ++j) {
    __syncthreads();
    if (j == 1) {
      stage<T>(X, ldm, A(0), N, N, N, false, true);
      stage<T>(Y, ldm, A(1), N, N, N, false, true);
      stage<T>(Z, ldm, A(V - 1), N, N, N, false, true);
      stage<T>(DSM, ldm, A(V - 2), N, N, N, false, true);
    } else {
      stage<T>(X, ldm, Fm(j - 1), N, N, N, false, true);
      stage<T>(Y, ldm, A(j), N, N, N, false, true);
      stage<T>(Z, ldm, Bm(j - 1), N, N, N, false, true);
      stage<T>(DSM, ldm, A(V - 1 - j), N, N, N, false, true);
    }
    __syncthreads();
    mm_nn(X, ldm, Y, ldm, N, N, N, 0, t);
    put<T>(Fm(j), N, N, N, 0, t, 1.f, false, false);
    mm_nn(Z, ldm, DSM, ldm, N, N, N, 0, t);
    put<T>(Bm(j), N, N, N, 0, t, 1.f, false, false);
  }
  __syncthreads();
  means(Fm(V - 1), N, N, rowf, colf, C, 2 * V, -1, true);
  means(Bm(V - 1), N, N, rowf, colf, C, 2 * V + 1, -1, true);
  __syncthreads();
  for (int idx = tid; idx < N * R4; idx += kThreads) {
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
  const float n_others = (float)max(1, V - 1);
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    float g[4];
    gates(af, bf, i, j, r, g);
    float s[kMaxViews];
    float m = -INFINITY, ssum = 0.f;
    for (int c = 0; c < V; ++c) {
      s[c] = S(c)[idx];
      m = fmaxf(m, s[c]);
      ssum += s[c];
    }
    float l = 0.f;
    for (int c = 0; c < V; ++c) l += expf(s[c] - m);
    const float lse = m + logf(l);
    const float others = ssum - s[0];
    float smix = s[0];
    smix = smix + g[0] * others;
    smix = smix + g[1] * (lse - s[0]);
    smix = smix - g[2] * (beta_not * (others / n_others));
    smix = smix + g[3] * logf(Fm(V - 1)[idx] + 1e-6f);
    ATT[idx] = smix;
  }
  __syncthreads();
  softmax_rows(ATT, ATT, N, N);
  // Transport: P_{V-1} = Ac_{V-1} v_{V-1}, P_i = Ac_i c(P_{i+1}), stored rounded.
  for (int i = V - 1; i >= 1; --i) {
    __syncthreads();
    stage<T>(X, ldm, A(i), N, N, N, false, true);
    if (i == V - 1)
      stage_in<T>(Y, ldd, vp + (V - 1) * st[10], st[11], N, dk, false, 1.f);
    else
      stage<T>(Y, ldd, P(i + 1), dk, N, dk, false, false);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put<T>(P(i), dk, N, dk, ct * kTile, t, 1.f, false, true);
    }
  }

  // ---------------- 1. output and transport ----------------
  __syncthreads();
  stage_in<T>(Z, ldd, dyp, st[14], N, dk, false, 1.f);
  stage<T>(X, ldm, A(0), N, N, N, false, true);
  stage<T>(Y, ldd, P(1), dk, N, dk, false, false);
  __syncthreads();
  {  // dw = sum(dy * (Ac_0 c(P_1)))
    const int ty = tid >> 4, tx = tid & 15;
    float part = 0.f;
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = 4 * ty + i, c = ct * kTile + tx + 16 * j;
          if (rr < N && c < dk) part = fmaf(t.v[i][j], Z[rr * ldd + c], part);
        }
    }
    part = warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) s += red[k];
      dchain[bh] = s;
    }
  }
  __syncthreads();
  // dv_0 = c(att)^T dy; the views strictly between 0 and V-1 get zeros.
  stage<T>(X, ldm, ATT, N, N, N, true, true);
  for (long long idx = tid; idx < (long long)(V - 2) * vsz; idx += kThreads)
    dvp[vsz + idx] = from_f<T>(0.f);
  __syncthreads();
  for (int ct = 0; ct < n_col_tiles; ++ct) {
    mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t);
    put_out<T>(dvp, dk, N, dk, ct * kTile, t, 1.f);
  }
  __syncthreads();
  // d att = dy v_0^T into DSM; dAc_0 = w dy c(P_1)^T.
  stage_in<T>(X, ldm, vp, st[11], N, dk, true, 1.f);
  stage<T>(Y, ldm, P(1), dk, N, dk, true, false);
  __syncthreads();
  mm_nn(Z, ldd, X, ldm, dk, N, N, 0, t);
  put<T>(DSM, ldm, N, N, 0, t, 1.f, false, false);
  mm_nn(Z, ldd, Y, ldm, dk, N, N, 0, t);
  put<T>(DA(0), N, N, N, 0, t, w, false, false);
  __syncthreads();
  // dP_1 = w Ac_0^T dy, into Z once every reader of dy is done.
  stage<T>(X, ldm, A(0), N, N, N, true, true);
  __syncthreads();
#pragma unroll
  for (int ct = 0; ct < 2; ++ct)
    if (ct < n_col_tiles) mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t2[ct]);
  __syncthreads();
#pragma unroll
  for (int ct = 0; ct < 2; ++ct)
    if (ct < n_col_tiles) put<T>(Z, ldd, N, dk, ct * kTile, t2[ct], w, false, false);
  for (int i = 1; i < V; ++i) {
    __syncthreads();
    if (i + 1 == V)
      stage_in<T>(Y, ldm, vp + (V - 1) * st[10], st[11], N, dk, true, 1.f);
    else
      stage<T>(Y, ldm, P(i + 1), dk, N, dk, true, false);
    stage<T>(X, ldm, A(i), N, N, N, true, true);
    __syncthreads();
    mm_nn(Z, ldd, Y, ldm, dk, N, N, 0, t);
    put<T>(DA(i), N, N, N, 0, t, 1.f, false, false);
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_col_tiles) mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t2[ct]);
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_col_tiles) put<T>(Z, ldd, N, dk, ct * kTile, t2[ct], 1.f, false, false);
  }
  __syncthreads();
  for (int idx = tid; idx < N * dk; idx += kThreads) {
    const int rr = idx / dk, c = idx - rr * dk;
    dvp[(V - 1) * vsz + idx] = from_f<T>(Z[rr * ldd + c]);
  }

  // ---------------- 2. softmax of smix and the mix ----------------
  softmax_vjp_rows(ATT, N, DSM, ldm, nullptr, 0, N);
  __syncthreads();
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    const int o = i * ldm + j;
    float g[4];
    gates(af, bf, i, j, r, g);
    float s[kMaxViews];
    float m = -INFINITY, ssum = 0.f;
    for (int c = 0; c < V; ++c) {
      s[c] = S(c)[idx];
      m = fmaxf(m, s[c]);
      ssum += s[c];
    }
    float l = 0.f;
    for (int c = 0; c < V; ++c) l += expf(s[c] - m);
    const float lse = m + logf(l);
    const float others = ssum - s[0];
    const float lf = logf(Fm(V - 1)[idx] + 1e-6f);
    const float d = DSM[o];
    const float d_lse = d * g[1];
    const float d_rest = d * (g[0] - g[2] * beta_not / n_others);
    for (int c = 0; c < V; ++c)
      S(c)[idx] = (c == 0 ? d * (1.f - g[1]) : d_rest) + d_lse * expf(s[c] - lse);
    ATT[idx] = d * g[3];  // d LF from the mix
    const float dg[4] = {d * others, d * (lse - s[0]), -d * beta_not * (others / n_others),
                         d * lf};
#pragma unroll
    for (int c = 0; c < 4; ++c) DZ[c * N * ldm + o] = dg[c] * g[c] * (1.f - g[c]);
  }
  __syncthreads();

  // ---------------- 3. gates and the gate head ----------------
  for (int idx = tid; idx < N * R4; idx += kThreads) {
    const int i = idx / R4, col = idx - i * R4, c = col / r;
    const float* dz = DZ + c * N * ldm;
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < N; ++j) {
      sa = fmaf(dz[i * ldm + j], bf[j * R4 + col], sa);
      sb = fmaf(dz[j * ldm + i], af[j * R4 + col], sb);
    }
    daf[idx] = sa;
    dbf[idx] = sb;
  }
  __syncthreads();
  for (int idx = tid; idx < C * R4; idx += kThreads) {
    const int k = idx / R4, col = idx - k * R4;
    float sr = 0.f, sc2 = 0.f;
    for (int i = 0; i < N; ++i) {
      sr = fmaf(rowf[i * C + k], daf[i * R4 + col], sr);
      sc2 = fmaf(colf[i * C + k], dbf[i * R4 + col], sc2);
    }
    dwrow[(long long)bh * C * R4 + idx] = sr;
    dwcol[(long long)bh * C * R4 + idx] = sc2;
  }
  for (int col = tid; col < R4; col += kThreads) {
    float sr = 0.f, sc2 = 0.f;
    for (int i = 0; i < N; ++i) {
      sr += daf[i * R4 + col];
      sc2 += dbf[i * R4 + col];
    }
    dbrow[(long long)bh * R4 + col] = sr;
    dbcol[(long long)bh * R4 + col] = sc2;
  }
  for (int idx = tid; idx < N * C; idx += kThreads) {
    const int i = idx / C, k = idx - i * C;
    float sr = 0.f, sc2 = 0.f;
    for (int col = 0; col < R4; ++col) {
      sr = fmaf(daf[i * R4 + col], wrow[k * R4 + col], sr);
      sc2 = fmaf(dbf[i * R4 + col], wcol[k * R4 + col], sc2);
    }
    drf[idx] = sr;
    dcf[idx] = sc2;
  }
  __syncthreads();

  // ---------------- 4. pooled features ----------------
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    for (int c = 0; c < V; ++c)
      S(c)[idx] += (drf[i * C + c] + dcf[i * C + V + c] + drf[j * C + V + c] + dcf[j * C + c]) *
                   inv_n;
    const float dlf = ATT[idx] + (drf[i * C + 2 * V] + dcf[j * C + 2 * V]) * inv_n;
    const float dlb = (drf[i * C + 2 * V + 1] + dcf[j * C + 2 * V + 1]) * inv_n;
    Fm(V - 1)[idx] = dlf / (Fm(V - 1)[idx] + 1e-6f);
    Bm(V - 1)[idx] = dlb / (Bm(V - 1)[idx] + 1e-6f);
  }

  // ---------------- 5. both chains ----------------
  // Forward chain: view(j) = j, prev(j) = F_{j-1}; backward chain: view(j) =
  // V-1-j, prev(j) = B_{j-1}; the first product pairs views (0, 1) and
  // (V-1, V-2).
  for (int chain = 0; chain < 2; ++chain) {
    __syncthreads();
    stage<T>(Z, ldm, chain == 0 ? Fm(V - 1) : Bm(V - 1), N, N, N, false, false);
    for (int j = V - 1; j >= 2; --j) {
      const int view = chain == 0 ? j : V - 1 - j;
      __syncthreads();
      stage<T>(X, ldm, chain == 0 ? Fm(j - 1) : Bm(j - 1), N, N, N, true, true);
      stage<T>(Y, ldm, A(view), N, N, N, true, true);
      __syncthreads();
      mm_nn(X, ldm, Z, ldm, N, N, N, 0, t);
      put<T>(DA(view), N, N, N, 0, t, 1.f, true, false);
      mm_nn(Z, ldm, Y, ldm, N, N, N, 0, t);
      __syncthreads();
      put<T>(Z, ldm, N, N, 0, t, 1.f, false, false);
    }
    const int v0 = chain == 0 ? 0 : V - 1, v1 = chain == 0 ? 1 : V - 2;
    __syncthreads();
    stage<T>(X, ldm, A(v0), N, N, N, true, true);
    stage<T>(Y, ldm, A(v1), N, N, N, true, true);
    __syncthreads();
    mm_nn(Z, ldm, Y, ldm, N, N, N, 0, t);
    put<T>(DA(v0), N, N, N, 0, t, 1.f, true, false);
    mm_nn(X, ldm, Z, ldm, N, N, N, 0, t);
    put<T>(DA(v1), N, N, N, 0, t, 1.f, true, false);
  }
  __syncthreads();

  // ---------------- 6. score maps, dq and dk ----------------
  for (int vi = 0; vi < V; ++vi) softmax_vjp_rows(A(vi), N, DA(vi), N, S(vi), N, N);
  for (int vi = 0; vi < V; ++vi) {
    __syncthreads();
    stage<T>(X, ldm, S(vi), N, N, N, false, false);
    stage<T>(Z, ldm, S(vi), N, N, N, true, false);
    stage_in<T>(Y, ldd, kp + vi * st[6], st[7], N, dk, false, 1.f);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put_out<T>(dqp + vi * vsz, dk, N, dk, ct * kTile, t, sc);
    }
    __syncthreads();
    stage_in<T>(Y, ldd, qp + vi * st[2], st[3], N, dk, false, sc);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(Z, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put_out<T>(dkp + vi * vsz, dk, N, dk, ct * kTile, t, 1.f);
    }
  }
}

size_t smem_bytes(int V, int N, int dk, int r) {
  const int ldm = odd_stride(N), C = 2 * V + 2;
  return sizeof(float) * (3 * (size_t)buf_floats(N, dk) + 5 * (size_t)N * ldm +
                          4 * (size_t)N * C + 4 * (size_t)N * 4 * r + kThreads / 32);
}

template <typename T>
int launch(const void* qs, const void* ks, const void* vs, const void* dy, void* dq, void* dk_out,
           void* dv, const float* const* w, float* const* dw, float* workspace, int B, int H,
           int V, int N, int dk, int r, const long long* st, float beta_not, float scale,
           cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(V, N, dk, r);
  cudaError_t e = cudaFuncSetAttribute(edgewise_lowrank_bwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  edgewise_lowrank_bwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)qs, (const T*)ks, (const T*)vs, (const T*)dy, (T*)dq, (T*)dk_out, (T*)dv, w[0],
      w[1], w[2], w[3], w[4], dw[0], dw[1], dw[2], dw[3], dw[4], workspace, H, V, N, dk, r,
      strides, beta_not, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes one program needs; the Python wrapper refuses shapes
// above the card's per-block limit before it launches.
extern "C" long long mop_edgewise_lowrank_bwd_smem_bytes(int V, int N, int dk, int r) {
  return (long long)mop::smem_bytes(V, N, dk, r);
}

// fp32 elements of one program's device-memory workspace.
extern "C" long long mop_edgewise_lowrank_bwd_ws_floats(int V, int N, int dk) {
  return mop::ws_floats(V, N, dk);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for dy; feature strides are 1.
// dq, dk and dv are contiguous (B, H, V, N, dk) outputs in the input dtype.
// Weights and chain_w are fp32 device arrays as for the forward. The fp32
// per-program outputs are dwrow and dwcol (B*H, 2V+2, 4r), dbrow and dbcol
// (B*H, 4r) and dchain (B*H,). `workspace` holds B*H times
// mop_edgewise_lowrank_bwd_ws_floats floats. Returns a cudaError_t code.
extern "C" int mop_edgewise_lowrank_bwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, const void* dy, void* dq, void* dk,
                                        void* dv, const void* wrow, const void* brow,
                                        const void* wcol, const void* bcol, const void* chain_w,
                                        void* dwrow, void* dbrow, void* dwcol, void* dbcol,
                                        void* dchain, void* workspace, int B, int H, int V,
                                        int N, int dkh, int r, const long long* strides,
                                        float beta_not, float scale, void* stream) {
  if (V < 2 || V > mop::kMaxViews || N < 1 || N > mop::kMaxN || dkh < 1 || dkh > mop::kMaxDk ||
      r < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w[5] = {(const float*)wrow, (const float*)brow, (const float*)wcol,
                       (const float*)bcol, (const float*)chain_w};
  float* dw[5] = {(float*)dwrow, (float*)dbrow, (float*)dwcol, (float*)dbcol, (float*)dchain};
  if (dtype == 0)
    return mop::launch<float>(qs, ks, vs, dy, dq, dk, dv, w, dw, (float*)workspace, B, H, V, N,
                              dkh, r, strides, beta_not, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(qs, ks, vs, dy, dq, dk, dv, w, dw, (float*)workspace, B,
                                      H, V, N, dkh, r, strides, beta_not, scale, s);
  return (int)cudaErrorInvalidValue;
}
