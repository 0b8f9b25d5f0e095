// K2b and K3b: backward of the fused E-mode (edgewise) attention for
// Hopper, with the lowrank gate head (K2b) or the dense gate head (K3b).
//
// Replaces the Pallas kernel `_edgewise_generic_bwd_kernel` in
// mop_tpu/ops/fused.py over `_edgewise_math` (lowrank) and
// `_edgewise_dense_math` (dense), which recomputes the math + `_edgewise_output`
// per (batch*head) program and applies `jax.vjp` to it inside the kernel.
// CUDA has no such tool, so the VJP below is written out by hand. One CTA
// runs one program: it recomputes the forward (edgewise_stages.cuh), then
// walks the cotangents back. One kernel template serves both heads: only the
// gate stages differ. Notation per program, c(x) the cast to the compute
// dtype T (identity in fp32), Ac_i = c(A_i):
//
//   S_i = c(q_i * c(scale)) k_i^T, A_i = softmax(S_i)
//   F_1 = Ac_0 Ac_1, F_j = c(F_{j-1}) Ac_j        (c_fwd = F_{V-1})
//   B_1 = Ac_{V-1} Ac_{V-2}, B_j = c(B_{j-1}) Ac_{V-1-j}   (c_bwd = B_{V-1})
//   LF = log(c_fwd + 1e-6), LB = log(c_bwd + 1e-6)
//   lowrank: a = row_feat wrow + brow, b = col_feat wcol + bcol, g_c = sigmoid(a_c b_c^T)
//   dense, per edge e = (i, j) with feat(e) = [S_c(i,j), S_c(j,i), LF(i,j), LB(i,j)]:
//     pre = b1 + feat w1, hid = gelu(pre), g = sigmoid(b2 + hid w2)
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
//    dg_2 = -d smix beta mean_others, dg_3 = d smix LF, d LF = d smix g_3;
//    dz_c = dg_c g_c (1 - g_c), the cotangent of gate c's logit.
// 3. Lowrank gates. da_c = dz_c b_c, db_c = dz_c^T a_c;
//    dwrow = row_feat^T da, dbrow = colsum(da) (and col likewise, per
//    program); d row_feat = da wrow^T, d col_feat = db wcol^T.
// 4. Lowrank pooled features, channels [S_1..S_V, S_1^T..S_V^T, LF, LB]. For c < V:
//    dS_c[i, j] += (drf[i, c] + dcf[i, V+c] + drf[j, V+c] + dcf[j, c]) / N;
//    d LF[i, j] += (drf[i, 2V] + dcf[j, 2V]) / N, d LB likewise with 2V+1;
//    then d c_fwd = d LF / (c_fwd + 1e-6), d c_bwd = d LB / (c_bwd + 1e-6).
// 3-4. Dense head, per edge e (the 1x1 MLP's backward):
//    dhid = w2 dz, dw2 += hid (x) dz, db2 += dz;
//    dpre = dhid * gelu'(pre), dw1 += feat (x) dpre, db1 += dpre;
//    dfeat = w1 dpre, scattered back: dS_c(i,j) += dfeat_c(e),
//    dS_c(j,i) += dfeat_{V+c}(e) (the transposed channel),
//    d LF(e) += dfeat_{2V}(e), d LB(e) += dfeat_{2V+1}(e); then d c_fwd and
//    d c_bwd as for lowrank.
// 5. Chains. From dF_{V-1} = d c_fwd, for j = V-1 .. 2:
//    dAc_j += c(F_{j-1})^T dF_j, dF_{j-1} = dF_j Ac_j^T; then
//    dAc_0 += dF_1 Ac_1^T, dAc_1 += Ac_0^T dF_1. The backward chain the same
//    way with Ac_{V-1-j} in place of Ac_j.
// 6. Score maps. dS_i += A_i * (dAc_i - rowsum(dAc_i * A_i)),
//    dq_i = c(scale) dS_i k_i, dk_i = dS_i^T c(q_i * c(scale)).
//
// The dense stages 2-4 run as three passes, because an edge reads the
// transposed scores S_c(j, i) that another edge's cotangent overwrites:
//   a. per edge, the gates and the mix give dz, kept in shared memory;
//   b. the weight grads, four hidden units at a time: each thread sums
//      feat dpre, dpre and hid dz over its edges, then a fixed-order block
//      reduction writes the program's dw1, db1, dw2 (and db2 = sum dz);
//   c. per unordered pair {(i, j), (j, i)}, one thread recomputes both
//      edges' heads and mix cotangents and writes dS at both places (and
//      d c_fwd, d c_bwd), so the in-place update of S_c races with nothing.
//
// The state does not fit in shared memory: the backward needs about 5V maps
// of N x N fp32 per program (about 400 KB at V = 5, N = 64) against the
// 227 KB one block may take. So every map that lives across phases sits in a
// per-program workspace in device memory, which the Python wrapper allocates
// (about 450 KB per program at the main shape, mostly served from the 50 MB
// L2 while the 132 resident programs work on it). Shared memory holds the
// operands of the product being computed (staged from the workspace, with
// the transpose and the rounding applied on the way in), the gate
// cotangents, d smix, the running dF / dP and the small feature, factor and
// weight arrays. Every sum is taken in a fixed order inside one block, and
// the per-program weight grads are summed by the caller: no atomics anywhere.
//
// Bound on this card: the recompute (about 8.5 Mflop per program at the main
// shape) plus about 19 Mflop of backward products (and, dense, about 5 Mflop
// of per-edge head arithmetic), against inputs, dy and grads read or written
// once: bound by the FMA rate in fp32. The products run on CUDA cores in
// true fp32, each thread owning 4 x 4 tiles.
#include "edgewise_stages.cuh"

namespace mop {

constexpr int kGroup = 4;  // hidden units per pass of the dense weight-grad sums
constexpr int kRed = kMaxC * kGroup + kGroup + 4 * kGroup;  // sums per group, at most

// Row i and column j >= i of the u-th entry of an N x N upper triangle
// (diagonal included), rows in order.
__device__ __forceinline__ void tri_index(int u, int N, int& i, int& j) {
  const float b = 2.f * N + 1.f;
  int r = (int)((b - sqrtf(b * b - 8.f * u)) * 0.5f);
  r = max(0, min(r, N - 1));
  while (r > 0 && r * N - r * (r - 1) / 2 > u) --r;
  while (r + 1 < N && (r + 1) * N - (r + 1) * r / 2 <= u) ++r;
  i = r;
  j = r + (u - (r * N - r * (r - 1) / 2));
}

// Sum each of `n` per-thread values over the block in a fixed order and
// write sum k to out[k]. red holds kThreads / 32 * n floats.
template <int n>
__device__ __forceinline__ void block_sums(const float (&v)[n], float* red, float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < n; ++k) {
    const float s = warp_sum(v[k]);
    if (lane == 0) red[warp * n + k] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w * n + k];
    out[k] = s;
  }
  __syncthreads();
}

// Dense stages 2-4 (passes a, b, c of the header). DSM holds d smix, DZ four
// N x ldm maps; the per-program grads go to dw (dw1 C x 16, db1 16, dw2
// 16 x 4, db2 4).
template <typename T>
__device__ void dense_gate_backward(const Prog<T>& p, const DenseGate& gate, const float* DSM,
                                    float* DZ, float* red, const Grads& dw, int bh,
                                    float beta_not) {
  const int V = p.V, N = p.N, nn = p.nn, C = gate.C;
  const int ldm = odd_stride(N);
  const int tid = threadIdx.x;
  const float n_others = (float)max(1, V - 1);

  // a. dz of every edge.
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    const int o = i * ldm + j;
    float g[4];
    gate(p, i, j, g);
    float m = -INFINITY, ssum = 0.f;
    for (int c = 0; c < V; ++c) {
      const float s = p.S(c)[idx];
      m = fmaxf(m, s);
      ssum += s;
    }
    float l = 0.f;
    for (int c = 0; c < V; ++c) l += expf(p.S(c)[idx] - m);
    const float lse = m + logf(l);
    const float s0 = p.S(0)[idx];
    const float others = ssum - s0;
    const float lf = logf(p.Fm(V - 1)[idx] + 1e-6f);
    const float d = DSM[o];
    const float dg[4] = {d * others, d * (lse - s0), -d * beta_not * (others / n_others),
                         d * lf};
#pragma unroll
    for (int c = 0; c < 4; ++c) DZ[c * N * ldm + o] = dg[c] * g[c] * (1.f - g[c]);
  }
  __syncthreads();

  // b. Weight grads, kGroup hidden units at a time.
  float* out = dw.p[0] + (long long)bh * C * kHidden;
  for (int h0 = 0; h0 < kHidden; h0 += kGroup) {
    float acc[kRed];
#pragma unroll
    for (int k = 0; k < kRed; ++k) acc[k] = 0.f;
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / N, j = idx - i * N;
      const int o = i * ldm + j, et = j * N + i;
      float f[kMaxC];
      float x[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) x[u] = gate.b1[h0 + u];
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          f[c] = dense_feature(p, c, idx, et);
#pragma unroll
          for (int u = 0; u < kGroup; ++u) x[u] = x[u] + f[c] * gate.w1[c * kHidden + h0 + u];
        }
      }
      float dz[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) dz[c4] = DZ[c4 * N * ldm + o];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float dh = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) dh = fmaf(gate.w2[(h0 + u) * 4 + c4], dz[c4], dh);
        const float dpre = dh * gelu_tanh_grad(x[u]);
        const float hid = gelu_tanh(x[u]);
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C) acc[c * kGroup + u] = fmaf(f[c], dpre, acc[c * kGroup + u]);
        acc[kMaxC * kGroup + u] += dpre;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          acc[kMaxC * kGroup + kGroup + u * 4 + c4] = fmaf(hid, dz[c4],
                                                         acc[kMaxC * kGroup + kGroup + u * 4 + c4]);
      }
    }
    // red: the block's sums, then the program's grads in place.
    float* sums = red + (kThreads / 32) * kRed;
    block_sums(acc, red, sums);
    for (int k = tid; k < C * kGroup; k += kThreads) {
      const int c = k / kGroup, u = k - c * kGroup;
      out[c * kHidden + h0 + u] = sums[k];
    }
    for (int u = tid; u < kGroup; u += kThreads) {
      dw.p[1][(long long)bh * kHidden + h0 + u] = sums[kMaxC * kGroup + u];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
        dw.p[2][(long long)bh * kHidden * 4 + (h0 + u) * 4 + c4] =
            sums[kMaxC * kGroup + kGroup + u * 4 + c4];
    }
  }
  {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int o = (idx / N) * ldm + idx % N;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) acc[c4] += DZ[c4 * N * ldm + o];
    }
    float* sums = red + (kThreads / 32) * kRed;
    block_sums(acc, red, sums);
    for (int c4 = tid; c4 < 4; c4 += kThreads) dw.p[3][(long long)bh * 4 + c4] = sums[c4];
  }

  // c. dS, d c_fwd and d c_bwd, one unordered pair of edges per step.
  for (int u = tid; u < N * (N + 1) / 2; u += kThreads) {
    int i, j;
    tri_index(u, N, i, j);
    const int ea = i * N + j, eb = j * N + i;
    float dsa[kMaxViews], dsb[kMaxViews];  // dS at (i, j) and at (j, i)
    float dcf[2], dcb[2];                  // d c_fwd, d c_bwd at ea, eb
#pragma unroll
    for (int c = 0; c < kMaxViews; ++c) dsa[c] = dsb[c] = 0.f;
    const int sides = i == j ? 1 : 2;
    for (int side = 0; side < sides; ++side) {
      const int e = side ? eb : ea, et = side ? ea : eb;
      const int o = (e / N) * ldm + e % N;
      float* ds = side ? dsb : dsa;   // the edge's own place
      float* dst = side ? dsa : dsb;  // its transpose's place
      float x[kHidden], g[4];
      gate.pre(p, e, et, x);
      gate.out(x, g);
      // The mix at e.
      float s[kMaxViews];
      float m = -INFINITY, ssum = 0.f;
      for (int c = 0; c < V; ++c) {
        s[c] = p.S(c)[e];
        m = fmaxf(m, s[c]);
        ssum += s[c];
      }
      float l = 0.f;
      for (int c = 0; c < V; ++c) l += expf(s[c] - m);
      const float lse = m + logf(l);
      const float d = DSM[o];
      const float d_lse = d * g[1];
      const float d_rest = d * (g[0] - g[2] * beta_not / n_others);
      for (int c = 0; c < V; ++c)
        ds[c] += (c == 0 ? d * (1.f - g[1]) : d_rest) + d_lse * expf(s[c] - lse);
      // The head at e.
      float dz[4];
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) dz[c4] = DZ[c4 * N * ldm + o];
#pragma unroll
      for (int h = 0; h < kHidden; ++h) {
        float dh = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) dh = fmaf(gate.w2[h * 4 + c4], dz[c4], dh);
        x[h] = dh * gelu_tanh_grad(x[h]);  // x now holds dpre
      }
      float dlf = d * g[3];
      float dlb = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (c < C) {
          float df = 0.f;
#pragma unroll
          for (int h = 0; h < kHidden; ++h) df = fmaf(gate.w1[c * kHidden + h], x[h], df);
          if (c < V)
            ds[c] += df;
          else if (c < 2 * V)
            dst[c - V] += df;
          else if (c == 2 * V)
            dlf += df;
          else
            dlb += df;
        }
      }
      dcf[side] = dlf / (p.Fm(V - 1)[e] + 1e-6f);
      dcb[side] = dlb / (p.Bm(V - 1)[e] + 1e-6f);
    }
    // Every read of this pair's places is done: write them.
    if (sides == 1) {
      for (int c = 0; c < V; ++c) p.S(c)[ea] = dsa[c] + dsb[c];
    } else {
      for (int c = 0; c < V; ++c) {
        p.S(c)[ea] = dsa[c];
        p.S(c)[eb] = dsb[c];
      }
    }
    for (int side = 0; side < sides; ++side) {
      const int e = side ? eb : ea;
      p.Fm(V - 1)[e] = dcf[side];
      p.Bm(V - 1)[e] = dcb[side];
    }
  }
}

template <typename T, class Gate>
__global__ void __launch_bounds__(kThreads, 1) edgewise_bwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ dy, T* __restrict__ dq, T* __restrict__ dkey, T* __restrict__ dv,
    Weights wts, Grads dw, float* __restrict__ workspace, int H, int V, int N, int dk, int r,
    Strides strides, float beta_not, float scale) {
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
  float* rest = DZ + 4 * N * ldm;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Prog<T> p = make_prog(qs, ks, vs, st, workspace, H, V, N, dk);
  const T* qp = p.qp;
  const T* kp = p.kp;
  const T* vp = p.vp;
  const T* dyp = dy + b * st[12] + h * st[13];
  const long long vsz = p.vsz;
  T* dqp = dq + bh * V * vsz;
  T* dkp = dkey + bh * V * vsz;
  T* dvp = dv + bh * V * vsz;
  const int nn = p.nn;
  const float sc = rnd<T>(scale);
  const float w = *wts.p[4];
  const float inv_n = 1.f / (float)N;
  const int n_col_tiles = (dk + kTile - 1) / kTile;
  Tile t, t2[2];

  // The gate head, over its shared-memory arrays.
  Gate gate;
  float* red;
  float *rowf = nullptr, *colf = nullptr, *af = nullptr, *bf = nullptr;
  float *daf = nullptr, *dbf = nullptr, *drf = nullptr, *dcf = nullptr;
  if constexpr (Gate::kDense) {
    gate = load_dense_gate(wts, C, rest);
    red = rest + dense_gate_floats(C);  // the block sums of the weight grads
  } else {
    rowf = rest;
    colf = rowf + N * C;
    af = colf + N * C;
    bf = af + N * R4;
    daf = bf + N * R4;
    dbf = daf + N * R4;
    drf = dbf + N * R4;
    dcf = drf + N * C;
    red = dcf + N * C;  // one float per warp
    gate = Gate{wts.p[0], wts.p[1], wts.p[2], wts.p[3], r, rowf, colf, af, bf};
  }

  // ---------------- recompute the forward ----------------
  recompute_forward<T>(p, gate, X, Y, Z, DSM, beta_not, sc);
  auto S = [&](int i) { return p.S(i); };
  auto A = [&](int i) { return p.A(i); };
  auto Fm = [&](int j) { return p.Fm(j); };
  auto Bm = [&](int j) { return p.Bm(j); };
  auto DA = [&](int i) { return p.DA(i); };
  auto P = [&](int i) { return p.P(i); };
  float* ATT = p.ATT();

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
      dw.p[4][bh] = s;
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
  if constexpr (Gate::kDense) {
    // ------------- 2-4. the mix and the dense head, per edge -------------
    dense_gate_backward(p, gate, DSM, DZ, red, dw, bh, beta_not);
  } else {
    const float n_others = (float)max(1, V - 1);
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int i = idx / N, j = idx - i * N;
      const int o = i * ldm + j;
      float g[4];
      gate(p, i, j, g);
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
    const float* wrow = wts.p[0];
    const float* wcol = wts.p[2];
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
      dw.p[0][(long long)bh * C * R4 + idx] = sr;
      dw.p[2][(long long)bh * C * R4 + idx] = sc2;
    }
    for (int col = tid; col < R4; col += kThreads) {
      float sr = 0.f, sc2 = 0.f;
      for (int i = 0; i < N; ++i) {
        sr += daf[i * R4 + col];
        sc2 += dbf[i * R4 + col];
      }
      dw.p[1][(long long)bh * R4 + col] = sr;
      dw.p[3][(long long)bh * R4 + col] = sc2;
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

size_t smem_bytes(int V, int N, int dk, int r, bool dense) {
  const int ldm = odd_stride(N), C = 2 * V + 2;
  const size_t common = 3 * (size_t)buf_floats(N, dk) + 5 * (size_t)N * ldm;
  if (dense)
    return sizeof(float) * (common + dense_gate_floats(C) + (kThreads / 32 + 1) * (size_t)kRed);
  return sizeof(float) * (common + 4 * (size_t)N * C + 4 * (size_t)N * 4 * r + kThreads / 32);
}

template <typename T, class Gate>
int launch(const void* qs, const void* ks, const void* vs, const void* dy, void* dq, void* dk_out,
           void* dv, const Weights& w, const Grads& dw, float* workspace, int B, int H, int V,
           int N, int dk, int r, const long long* st, float beta_not, float scale,
           cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(V, N, dk, r, Gate::kDense);
  cudaError_t e = cudaFuncSetAttribute(edgewise_bwd_kernel<T, Gate>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  edgewise_bwd_kernel<T, Gate><<<B * H, kThreads, smem, stream>>>(
      (const T*)qs, (const T*)ks, (const T*)vs, (const T*)dy, (T*)dq, (T*)dk_out, (T*)dv, w, dw,
      workspace, H, V, N, dk, r, strides, beta_not, scale);
  return (int)cudaGetLastError();
}

template <class Gate>
int dispatch(int dtype, const void* qs, const void* ks, const void* vs, const void* dy, void* dq,
             void* dk, void* dv, const void* const* w, void* const* dw, void* workspace, int B,
             int H, int V, int N, int dkh, int r, const long long* strides, float beta_not,
             float scale, void* stream) {
  if (V < 2 || V > kMaxViews || N < 1 || N > kMaxN || dkh < 1 || dkh > kMaxDk || r < 1 ||
      B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Weights wts;
  Grads grads;
  for (int i = 0; i < 5; ++i) {
    wts.p[i] = (const float*)w[i];
    grads.p[i] = (float*)dw[i];
  }
  if (dtype == 0)
    return launch<float, Gate>(qs, ks, vs, dy, dq, dk, dv, wts, grads, (float*)workspace, B, H,
                               V, N, dkh, r, strides, beta_not, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, Gate>(qs, ks, vs, dy, dq, dk, dv, wts, grads,
                                       (float*)workspace, B, H, V, N, dkh, r, strides, beta_not,
                                       scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace mop

// Shared-memory bytes one program needs; the Python wrapper refuses shapes
// above the card's per-block limit before it launches. `dense` selects the
// gate head (r is ignored for it).
extern "C" long long mop_edgewise_bwd_smem_bytes(int V, int N, int dk, int r, int dense) {
  return (long long)mop::smem_bytes(V, N, dk, r, dense != 0);
}

// fp32 elements of one program's device-memory workspace.
extern "C" long long mop_edgewise_bwd_ws_floats(int V, int N, int dk) {
  return mop::ws_floats(V, N, dk);
}

// C entry points, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for dy; feature strides are 1.
// dq, dk and dv are contiguous (B, H, V, N, dk) outputs in the input dtype.
// `workspace` holds B*H times mop_edgewise_bwd_ws_floats floats. Weights,
// chain_w and the per-program grads are fp32 device arrays; returns a
// cudaError_t code.
//
// Lowrank (K2b): weights wrow, wcol (2V+2, 4r) row-major, brow, bcol (4r,),
// chain_w one scalar; grads dwrow and dwcol (B*H, 2V+2, 4r), dbrow and dbcol
// (B*H, 4r), dchain (B*H,).
extern "C" int mop_edgewise_lowrank_bwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, const void* dy, void* dq, void* dk,
                                        void* dv, const void* wrow, const void* brow,
                                        const void* wcol, const void* bcol, const void* chain_w,
                                        void* dwrow, void* dbrow, void* dwcol, void* dbcol,
                                        void* dchain, void* workspace, int B, int H, int V,
                                        int N, int dkh, int r, const long long* strides,
                                        float beta_not, float scale, void* stream) {
  const void* w[5] = {wrow, brow, wcol, bcol, chain_w};
  void* dw[5] = {dwrow, dbrow, dwcol, dbcol, dchain};
  return mop::dispatch<mop::LowrankGate>(dtype, qs, ks, vs, dy, dq, dk, dv, w, dw, workspace, B,
                                         H, V, N, dkh, r, strides, beta_not, scale, stream);
}

// Dense (K3b): weights w1 (2V+2, 16) row-major, b1 (16,), w2 (16, 4), b2
// (4,), chain_w one scalar; grads dw1 (B*H, 2V+2, 16), db1 (B*H, 16), dw2
// (B*H, 16, 4), db2 (B*H, 4), dchain (B*H,).
extern "C" int mop_edgewise_dense_bwd(int dtype, const void* qs, const void* ks, const void* vs,
                                      const void* dy, void* dq, void* dk, void* dv,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* chain_w, void* dw1, void* db1,
                                      void* dw2, void* db2, void* dchain, void* workspace, int B,
                                      int H, int V, int N, int dkh, const long long* strides,
                                      float beta_not, float scale, void* stream) {
  const void* w[5] = {w1, b1, w2, b2, chain_w};
  void* dw[5] = {dw1, db1, dw2, db2, dchain};
  return mop::dispatch<mop::DenseGate>(dtype, qs, ks, vs, dy, dq, dk, dv, w, dw, workspace, B, H,
                                       V, N, dkh, 1, strides, beta_not, scale, stream);
}
