// K2w and K2bw: E-mode (edgewise, lowrank gate head) attention, forward and
// backward, for 64 < N <= 256 tokens, the rest of the JAX kernels' envelope
// (N <= 256, dk <= 128, 2 <= V <= 8).
//
// Replaces the Pallas forward `_edgewise_generic_fwd_kernel` and backward
// `_edgewise_generic_bwd_kernel` over `_edgewise_math` + `_edgewise_output`
// (mop_tpu/ops/fused.py) where K2 and K2b (edgewise_lowrank_fwd.cu,
// edgewise_bwd.cu) stop: they hold every N x N map of one program in shared
// memory, and at N = 196 the V fp32 score maps alone take 600 KB, beyond the
// 227 KB an SM has. The TPU kernel keeps them in VMEM (up to 64 MB); here
// they live in a per-program fp32 workspace in device memory and the
// pipeline runs as a sequence of stages, each a kernel over every program
// at once: batched tiled products, row softmaxes, the channel means and
// rank-r factors, the gated logit mix with its softmax, and for the
// backward the hand-derived VJP of each stage in reverse.
//
// Precision follows the plain version (`fused_edgewise_lowrank_attention_plain`
// and its autograd backward): every product accumulates in fp32; in bf16
// an operand is rounded to bf16 on load wherever the plain version casts it
// to the compute dtype, and a cotangent is rounded where the plain
// backward's casts round it. The products run on the CUDA cores.
#include "common.cuh"

namespace mop {
namespace wide {

constexpr int kMaxN = 256, kMaxDk = 128, kMaxV = 8;
constexpr int kBM = 64, kBN = 64, kBK = 16;
constexpr int kRowsPerBlock = 8;  // row kernels: one warp a row

// A matrix operand of a batched product. Batch z = (i0 * d1 + i1) * d2 + i2
// reads element (r, c) at p + off + i0 s0 + i1 s1 + i2 s2 + r rs + c cs.
// `round` rounds each loaded value to bf16 precision.
struct Mat {
  const void* p;
  int bf16;
  int round;
  long long off, s0, s1, s2, rs, cs;
};

struct Gemm {
  Mat a, b, cin;  // out = alpha * A B (+ cin where cin.p is set)
  Mat out;        // written; `round` unused
  int M, N, K, Z, d1, d2;
  float alpha;
  const float* alpha_ptr;  // a device scalar alpha is multiplied by, or null
  int round_acc;           // round A B to bf16 before alpha
};

__device__ __forceinline__ float rbf(float x) { return rnd<__nv_bfloat16>(x); }

__device__ __forceinline__ long long base(const Mat& m, int z, int d1, int d2) {
  const int i2 = z % d2, i1 = (z / d2) % d1, i0 = z / (d2 * d1);
  return m.off + i0 * m.s0 + i1 * m.s1 + i2 * m.s2;
}

__device__ __forceinline__ float load(const Mat& m, long long at) {
  const float x = m.bf16 ? __bfloat162float(((const __nv_bfloat16*)m.p)[at])
                         : ((const float*)m.p)[at];
  return m.round ? rbf(x) : x;
}

__device__ __forceinline__ void store(const Mat& m, long long at, float x) {
  if (m.bf16)
    ((__nv_bfloat16*)m.p)[at] = __float2bfloat16(x);
  else
    ((float*)m.p)[at] = x;
}

// One 64 x 64 output tile a block, 16 x 16 threads of 4 x 4 outputs each,
// k in steps of 16 through shared memory. Each operand's tile loads along
// its contiguous axis (ARow: A's k axis, BRow: B's n axis), a template
// argument so that the index arithmetic folds.
template <bool ARow, bool BRow>
__global__ void __launch_bounds__(256) gemm_kernel(Gemm g) {
  __shared__ __align__(16) float As[kBK][kBM + 4];
  __shared__ __align__(16) float Bs[kBK][kBN + 4];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float alpha = g.alpha * (g.alpha_ptr ? *g.alpha_ptr : 1.f);
  for (int z = blockIdx.z; z < g.Z; z += gridDim.z) {
    const long long oa = base(g.a, z, g.d1, g.d2), ob = base(g.b, z, g.d1, g.d2);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < g.K; k0 += kBK) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + 256 * e;
        const int r = ARow ? idx / kBK : idx % kBM, c = ARow ? idx % kBK : idx / kBM;
        const int gr = m0 + r, gc = k0 + c;
        As[c][r] = (gr < g.M && gc < g.K) ? load(g.a, oa + gr * g.a.rs + gc * g.a.cs) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int idx = tid + 256 * e;
        const int r = BRow ? idx / kBN : idx % kBK, c = BRow ? idx % kBN : idx / kBK;
        const int gr = k0 + r, gc = n0 + c;
        Bs[r][c] = (gr < g.K && gc < g.N) ? load(g.b, ob + gr * g.b.rs + gc * g.b.cs) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
        const float a4[4] = {av.x, av.y, av.z, av.w}, b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
      }
      __syncthreads();
    }
    const long long oo = base(g.out, z, g.d1, g.d2);
    const long long oc = g.cin.p ? base(g.cin, z, g.d1, g.d2) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + ty * 4 + i;
      if (r >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + tx * 4 + j;
        if (c >= g.N) continue;
        float v = g.round_acc ? rbf(acc[i][j]) : acc[i][j];
        v *= alpha;
        if (g.cin.p) v += load(g.cin, oc + r * g.cin.rs + c * g.cin.cs);
        store(g.out, oo + r * g.out.rs + c * g.out.cs, v);
      }
    }
  }
}

// q scaled by the (compute-dtype) 1/sqrt(dk) and rounded as the plain
// version's q: QS[bh][v][i][d], from q's (b, h, view, row) strides.
__global__ void scale_q_kernel(const void* q, int bf, long long sb, long long sh, long long sv,
                               long long srow, float* QS, int H, int V, int N, int dk,
                               float scale, long long total) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int d = e % dk;
    const int i = (e / dk) % N;
    const int v = (e / ((long long)dk * N)) % V;
    const long long bh = e / ((long long)dk * N * V);
    const long long at = (bh / H) * sb + (bh % H) * sh + v * sv + i * srow + d;
    const float x = bf ? __bfloat162float(((const __nv_bfloat16*)q)[at]) : ((const float*)q)[at];
    QS[e] = bf ? rbf(x * scale) : x * scale;
  }
}

// Row softmax of `rows` contiguous rows of N (N <= 256), one warp a row.
__global__ void softmax_rows_kernel(const float* S, float* A, long long rows, int N) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* s = S + row * N;
  float v[8], m = -INFINITY;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    v[t] = j < N ? s[j] : -INFINITY;
    m = fmaxf(m, v[t]);
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    v[t] = lane + 32 * t < N ? expf(v[t] - m) : 0.f;
    sum += v[t];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    if (lane + 32 * t < N) A[row * N + lane + 32 * t] = v[t] / sum;
}

// The softmax VJP of the score maps: DS_v += A_v (c(dA_v) - rowsum(c(dA_v) A_v)),
// one warp a row of every view's maps.
__global__ void softmax_vjp_kernel(const float* A, const float* DA, float* DS, long long rows,
                                   int N, int round) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long o = row * N;
  float a[8], da[8], dot = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    a[t] = j < N ? A[o + j] : 0.f;
    da[t] = j < N ? (round ? rbf(DA[o + j]) : DA[o + j]) : 0.f;
    dot += a[t] * da[t];
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    if (j < N) DS[o + j] += a[t] * (da[t] - dot);
  }
}

// Row and column means of V + 2 maps a program: the V score maps S_v, then
// log(c_fwd + 1e-6) and log(c_bwd + 1e-6). One block a (program, map):
// each thread a column, each warp a row at a time.
__global__ void means_kernel(const float* S, const float* FL, const float* BL, long long fl_bh,
                             float* RM, float* CM, int V, int N) {
  const int M = V + 2;
  const long long bh = blockIdx.x / M;
  const int m = blockIdx.x % M;
  const long long nn = (long long)N * N;
  const bool lg = m >= V;
  const float* X = m < V ? S + (bh * V + m) * nn : (m == V ? FL : BL) + bh * fl_bh;
  float* rm = RM + (bh * M + m) * N;
  float* cm = CM + (bh * M + m) * N;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float s = 0.f;
    for (int i = 0; i < N; ++i) s += lg ? logf(X[(long long)i * N + j] + 1e-6f) : X[(long long)i * N + j];
    cm[j] = s / N;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < N; i += blockDim.x / 32) {
    float s = 0.f;
    for (int j = lane; j < N; j += 32) s += lg ? logf(X[(long long)i * N + j] + 1e-6f) : X[(long long)i * N + j];
    s = warp_sum(s);
    if (lane == 0) rm[i] = s / N;
  }
}

// The pooled features of token i, [S_1..S_V, S_1^T..S_V^T, logC_fwd,
// logC_bwd] row means (RF) and column means (CF), and the rank factors
// AF = RF wrow + brow, BF = CF wcol + bcol. One thread a (program, token).
__global__ void factors_kernel(const float* RM, const float* CM, const float* wrow,
                               const float* brow, const float* wcol, const float* bcol,
                               float* RF, float* CF, float* AF, float* BF, long long total,
                               int V, int N, int R4) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / N;
  const int i = e % N, M = V + 2, C = 2 * V + 2;
  const float* rm = RM + bh * M * N;
  const float* cm = CM + bh * M * N;
  float rf[2 * kMaxV + 2], cf[2 * kMaxV + 2];
  for (int v = 0; v < V; ++v) {
    rf[v] = rm[v * N + i];
    rf[V + v] = cm[v * N + i];
    cf[v] = cm[v * N + i];
    cf[V + v] = rm[v * N + i];
  }
  rf[2 * V] = rm[V * N + i];
  rf[2 * V + 1] = rm[(V + 1) * N + i];
  cf[2 * V] = cm[V * N + i];
  cf[2 * V + 1] = cm[(V + 1) * N + i];
  for (int c = 0; c < C; ++c) {
    RF[e * C + c] = rf[c];
    CF[e * C + c] = cf[c];
  }
  for (int t = 0; t < R4; ++t) {
    float a = 0.f, b = 0.f;
    for (int c = 0; c < C; ++c) {
      a = fmaf(rf[c], wrow[c * R4 + t], a);
      b = fmaf(cf[c], wcol[c * R4 + t], b);
    }
    AF[e * R4 + t] = a + brow[t];
    BF[e * R4 + t] = b + bcol[t];
  }
}

// Everything one edge (i, j) of the logit mix needs.
struct Edge {
  float s[kMaxV], s_sum, lse, mx, sumexp, g[4], lcf;
};

__device__ __forceinline__ void edge(Edge& e, const float* S, long long nn, long long ij, int V,
                                     const float* af, const float* bf, int r, float fl) {
  e.s_sum = 0.f;
  e.mx = -INFINITY;
  for (int v = 0; v < V; ++v) {
    e.s[v] = S[v * nn + ij];
    e.s_sum = v ? e.s_sum + e.s[v] : e.s[v];
    e.mx = fmaxf(e.mx, e.s[v]);
  }
  e.sumexp = 0.f;
  for (int v = 0; v < V; ++v) e.sumexp += expf(e.s[v] - e.mx);
  e.lse = e.mx + logf(e.sumexp);
  for (int q = 0; q < 4; ++q) {
    float z = 0.f;
    for (int u = 0; u < r; ++u) z = fmaf(af[q * r + u], bf[q * r + u], z);
    e.g[q] = 1.f / (1.f + expf(-z));
  }
  e.lcf = logf(fl + 1e-6f);
}

__device__ __forceinline__ float edge_mix(const Edge& e, int V, float beta) {
  const float s1 = e.s[0], others = e.s_sum - s1;
  float smix = s1 + e.g[0] * others;
  smix = smix + e.g[1] * (e.lse - s1);
  smix = smix - e.g[2] * (beta * (others / max(1, V - 1)));
  return smix + e.g[3] * e.lcf;
}

// The gated logit mix of row i and its softmax: ATT. One warp a row.
__global__ void mix_fwd_kernel(const float* S, const float* FL, long long fl_bh, const float* AF,
                               const float* BF, float* ATT, long long rows, int V, int N, int r,
                               float beta) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / N, nn = (long long)N * N;
  const int i = row % N, R4 = 4 * r;
  const float* Sb = S + bh * V * nn;
  const float* af = AF + row * R4;
  float x[8], m = -INFINITY;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    x[t] = -INFINITY;
    if (j < N) {
      Edge e;
      const long long ij = (long long)i * N + j;
      edge(e, Sb, nn, ij, V, af, BF + (bh * N + j) * R4, r, FL[bh * fl_bh + ij]);
      x[t] = edge_mix(e, V, beta);
    }
    m = fmaxf(m, x[t]);
  }
  m = warp_max(m);
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    x[t] = lane + 32 * t < N ? expf(x[t] - m) : 0.f;
    sum += x[t];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int t = 0; t < 8; ++t)
    if (lane + 32 * t < N) ATT[row * N + lane + 32 * t] = x[t] / sum;
}

// The backward of the mix and its softmax for row i: from datt (rounded as
// the cast of att rounds it) to d smix, then the gate-logit cotangents DZ_q
// = d g_q g_q (1 - g_q), the direct score cotangents DS_v (written, the
// first of their terms) and d log c_fwd (DL).
__global__ void mix_bwd_kernel(const float* S, const float* FL, long long fl_bh, const float* AF,
                               const float* BF, const float* ATT, const float* DATT, float* DS,
                               float* DZ, float* DL, long long rows, int V, int N, int r,
                               float beta, int round) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / N, nn = (long long)N * N;
  const int i = row % N, R4 = 4 * r;
  float at[8], da[8], dot = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    at[t] = j < N ? ATT[row * N + j] : 0.f;
    da[t] = j < N ? (round ? rbf(DATT[row * N + j]) : DATT[row * N + j]) : 0.f;
    dot += at[t] * da[t];
  }
  dot = warp_sum(dot);
  const float* Sb = S + bh * V * nn;
  float* DSb = DS + bh * V * nn;
  float* DZb = DZ + bh * 4 * nn;
  const float* af = AF + row * R4;
  const float others_w = beta / max(1, V - 1);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    if (j >= N) continue;
    const long long ij = (long long)i * N + j;
    Edge e;
    edge(e, Sb, nn, ij, V, af, BF + (bh * N + j) * R4, r, FL[bh * fl_bh + ij]);
    const float ds = at[t] * (da[t] - dot);
    const float s1 = e.s[0], others = e.s_sum - s1;
    const float dg[4] = {ds * others, ds * (e.lse - s1), -ds * (beta * (others / max(1, V - 1))),
                         ds * e.lcf};
    for (int q = 0; q < 4; ++q) DZb[q * nn + ij] = dg[q] * e.g[q] * (1.f - e.g[q]);
    const float dlse = ds * e.g[1];
    const float d_others = ds * (e.g[0] - e.g[2] * others_w);
    for (int v = 0; v < V; ++v) {
      const float p = expf(e.s[v] - e.mx) / e.sumexp;
      DSb[v * nn + ij] = (v ? d_others : ds * (1.f - e.g[1])) + dlse * p;
    }
    DL[bh * nn + ij] = ds * e.g[3];
  }
}

// The means' backward: each channel's row- and column-mean cotangents
// (from DRF, DCF: N x C a program) spread over its map, added to DS_v; then
// d c_fwd = d log c_fwd / (c_fwd + 1e-6) in place of DL, and d c_bwd into
// DLB. One thread an edge.
__global__ void means_bwd_kernel(const float* DRF, const float* DCF, float* DS, float* DL,
                                 float* DLB, const float* FL, const float* BL, long long fl_bh,
                                 long long total, int V, int N) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long nn = (long long)N * N, bh = e / nn, ij = e % nn;
  const int i = ij / N, j = ij % N, C = 2 * V + 2;
  const float* dri = DRF + (bh * N + i) * C;
  const float* dci = DCF + (bh * N + i) * C;
  const float* drj = DRF + (bh * N + j) * C;
  const float* dcj = DCF + (bh * N + j) * C;
  for (int v = 0; v < V; ++v)
    DS[(bh * V + v) * nn + ij] += (dri[v] + dci[V + v]) / N + (drj[V + v] + dcj[v]) / N;
  const float dlf = DL[e] + dri[2 * V] / N + dcj[2 * V] / N;
  DL[e] = dlf / (FL[bh * fl_bh + ij] + 1e-6f);
  DLB[e] = (dri[2 * V + 1] / N + dcj[2 * V + 1] / N) / (BL[bh * fl_bh + ij] + 1e-6f);
}

// Column sums of a program's N x R4 factor cotangents: the bias grads.
__global__ void colsum_kernel(const float* X, float* out, long long total, int N, int R4) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / R4;
  const int t = e % R4;
  float s = 0.f;
  for (int i = 0; i < N; ++i) s += X[(bh * N + i) * R4 + t];
  out[e] = s;
}

// dchain[bh] = sum(dy * P0), P0 = c(A_0) c(pt_1) (N x dk fp32). One block a
// program.
__global__ void dchain_kernel(const void* dy, int bf, long long sb, long long sh, long long srow,
                              const float* P0, float* dch, int H, int N, int dk) {
  const long long bh = blockIdx.x;
  const long long o = (bh / H) * sb + (bh % H) * sh;
  float s = 0.f;
  for (int e = threadIdx.x; e < N * dk; e += blockDim.x) {
    const int i = e / dk, d = e % dk;
    const long long at = o + i * srow + d;
    const float g = bf ? __bfloat162float(((const __nv_bfloat16*)dy)[at]) : ((const float*)dy)[at];
    s += g * P0[bh * N * dk + e];
  }
  __shared__ float red[32];
  s = warp_sum(s);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    s = threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : 0.f;
    s = warp_sum(s);
    if (threadIdx.x == 0) dch[bh] = s;
  }
}

// ------------------------------ host side ------------------------------

// Per-program float counts of the workspace's buffers, in order.
struct Layout {
  long long QS, S, A, FCH, BCH, RM, CM, RF, CF, AF, BF, ATT, PT, Y0;            // forward
  long long DATT, DAC, DS, DZ, DL, DLB, DCH, DP, DAF, DBF, DRF, DCF;            // backward
  long long fwd_total, bwd_total;
};

inline Layout layout(int V, int N, int dk, int r) {
  const long long nn = (long long)N * N, nd = (long long)N * dk, C = 2 * V + 2, R4 = 4 * r;
  Layout l;
  long long at = 0;
  auto take = [&](long long n) { const long long o = at; at += n; return o; };
  l.QS = take(V * nd);
  l.S = take(V * nn);
  l.A = take(V * nn);
  l.FCH = take((V - 1) * nn);
  l.BCH = take((V - 1) * nn);
  l.RM = take((V + 2) * (long long)N);
  l.CM = take((V + 2) * (long long)N);
  l.RF = take(N * C);
  l.CF = take(N * C);
  l.AF = take(N * R4);
  l.BF = take(N * R4);
  l.ATT = take(nn);
  l.PT = take((V - 1) * nd);
  l.Y0 = take(nd);
  l.fwd_total = at;
  l.DATT = take(nn);
  l.DAC = take(V * nn);
  l.DS = take(V * nn);
  l.DZ = take(4 * nn);
  l.DL = take(nn);
  l.DLB = take(nn);
  l.DCH = take(2 * nn);
  l.DP = take(2 * nd);
  l.DAF = take(N * R4);
  l.DBF = take(N * R4);
  l.DRF = take(N * C);
  l.DCF = take(N * C);
  l.bwd_total = at;
  return l;
}

inline long long ws_bytes(int V, int N, int dk, int r, bool bwd) {
  const Layout l = layout(V, N, dk, r);
  return 4 * (bwd ? l.bwd_total : l.fwd_total);
}

// The run's shapes, stream and workspace; buffers are [program][per-program].
struct Run {
  int B, H, V, N, dk, r, bf;
  long long BH, nn, nd;
  float* ws;
  Layout l;
  cudaStream_t st;
  cudaError_t err = cudaSuccess;

  float* buf(long long off) const { return ws + BH * off; }
};

// A workspace buffer as a batched operand: `size` floats a program, `inner`
// floats between the inner batch index's matrices, then row and column
// strides.
inline Mat wmat(const Run& R, const float* p, long long size, long long inner, long long rs,
                long long cs, int round = 0) {
  return Mat{p, 0, round, 0, R.H * size, size, inner, rs, cs};
}

// An input or output tensor with (b, h, view, row) strides st[0..3] and a
// unit feature stride: view `view` of each program, or (per_view) every
// view as the inner batch index.
inline Mat tmat(const void* p, int bf, const long long* st, int view, bool per_view) {
  return Mat{p, bf, 0, view * st[2], st[0], st[1], per_view ? st[2] : 0, st[3], 1};
}

inline Mat tr(Mat m) {
  const long long t = m.rs;
  m.rs = m.cs;
  m.cs = t;
  return m;
}

inline Mat rounded(Mat m, int round) {
  m.round = round;
  return m;
}

const Mat kNone = {nullptr, 0, 0, 0, 0, 0, 0, 0, 0};

inline void gemm(Run& R, int inner, int M, int N, int K, Mat a, Mat b, Mat out,
                 Mat cin = kNone, float alpha = 1.f, const float* alpha_ptr = nullptr,
                 int round_acc = 0) {
  if (R.err != cudaSuccess) return;
  Gemm g{a, b, cin, out, M, N, K, (int)(R.BH * inner), R.H, inner, alpha, alpha_ptr, round_acc};
  const int z = g.Z < 65535 ? g.Z : 65535;
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, z);
  const bool arow = a.cs == 1, brow = b.cs == 1;
  if (arow && brow)
    gemm_kernel<true, true><<<grid, 256, 0, R.st>>>(g);
  else if (arow)
    gemm_kernel<true, false><<<grid, 256, 0, R.st>>>(g);
  else if (brow)
    gemm_kernel<false, true><<<grid, 256, 0, R.st>>>(g);
  else
    gemm_kernel<false, false><<<grid, 256, 0, R.st>>>(g);
  R.err = cudaGetLastError();
}

inline int row_blocks(long long rows) { return (int)((rows + kRowsPerBlock - 1) / kRowsPerBlock); }
inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

inline void check(Run& R) {
  if (R.err == cudaSuccess) R.err = cudaGetLastError();
}

// The forward's stages into the workspace: QS, S_v, A_v, both chains, the
// means and factors, att and the transports; then, unless `to_out` is null,
// y = c(att) v_0 + w c(A_0) c(pt_1) into `to_out`.
void forward(Run& R, const void* qs, const void* ks, const void* vs, const long long* st,
             const float* const* w, float beta, float scale, void* to_out) {
  const int V = R.V, N = R.N, dk = R.dk, r = R.r, bf = R.bf, rd = R.bf;
  const long long nn = R.nn, nd = R.nd;
  const long long *sq = st, *sk = st + 4, *sv = st + 8;
  float* QS = R.buf(R.l.QS);
  float* S = R.buf(R.l.S);
  float* A = R.buf(R.l.A);
  float* FCH = R.buf(R.l.FCH);
  float* BCH = R.buf(R.l.BCH);
  float* ATT = R.buf(R.l.ATT);
  float* PT = R.buf(R.l.PT);
  const long long total_q = R.BH * V * nd;
  const float sc = bf ? __bfloat162float(__float2bfloat16(scale)) : scale;
  const int qb = blocks(total_q, 256) < 4 * 65535 ? blocks(total_q, 256) : 4 * 65535;
  scale_q_kernel<<<qb, 256, 0, R.st>>>(qs, bf, sq[0], sq[1], sq[2], sq[3], QS, R.H, V, N, dk, sc,
                                       total_q);
  check(R);
  // S_v = q_v k_v^T.
  gemm(R, V, N, N, dk, wmat(R, QS, V * nd, nd, dk, 1), tr(tmat(ks, bf, sk, 0, true)),
       wmat(R, S, V * nn, nn, N, 1));
  if (R.err != cudaSuccess) return;
  softmax_rows_kernel<<<row_blocks(R.BH * V * N), 256, 0, R.st>>>(S, A, R.BH * V * N, N);
  check(R);
  auto amap = [&](int v) { return wmat(R, A + v * nn, V * nn, 0, N, 1, rd); };
  auto chain = [&](float* CH, int j) { return wmat(R, CH + (j - 1) * nn, (V - 1) * nn, 0, N, 1); };
  // c_fwd = c(A_0) c(A_1) ... ; c_bwd = c(A_{V-1}) c(A_{V-2}) ...
  gemm(R, 1, N, N, N, amap(0), amap(1), chain(FCH, 1));
  gemm(R, 1, N, N, N, amap(V - 1), amap(V - 2), chain(BCH, 1));
  for (int j = 2; j < V; ++j) {
    gemm(R, 1, N, N, N, rounded(chain(FCH, j - 1), rd), amap(j), chain(FCH, j));
    gemm(R, 1, N, N, N, rounded(chain(BCH, j - 1), rd), amap(V - 1 - j), chain(BCH, j));
  }
  if (R.err != cudaSuccess) return;
  const float* FL = FCH + (V - 2) * nn;
  const float* BL = BCH + (V - 2) * nn;
  const long long fl_bh = (V - 1) * nn;
  float* RM = R.buf(R.l.RM);
  float* CM = R.buf(R.l.CM);
  means_kernel<<<(unsigned)(R.BH * (V + 2)), 256, 0, R.st>>>(S, FL, BL, fl_bh, RM, CM, V, N);
  check(R);
  factors_kernel<<<blocks(R.BH * N, 128), 128, 0, R.st>>>(
      RM, CM, w[0], w[1], w[2], w[3], R.buf(R.l.RF), R.buf(R.l.CF), R.buf(R.l.AF),
      R.buf(R.l.BF), R.BH * N, V, N, 4 * r);
  check(R);
  mix_fwd_kernel<<<row_blocks(R.BH * N), 256, 0, R.st>>>(S, FL, fl_bh, R.buf(R.l.AF),
                                                         R.buf(R.l.BF), ATT, R.BH * N, V, N, r,
                                                         beta);
  check(R);
  // pt_{V-1} = c(A_{V-1}) v_{V-1}; pt_i = c(A_i) c(pt_{i+1}); PT[i-1] holds pt_i.
  auto ptm = [&](int i) { return wmat(R, PT + (i - 1) * nd, (V - 1) * nd, 0, dk, 1); };
  gemm(R, 1, N, dk, N, amap(V - 1), tmat(vs, bf, sv, V - 1, false), ptm(V - 1));
  for (int i = V - 2; i >= 1; --i) gemm(R, 1, N, dk, N, amap(i), rounded(ptm(i + 1), rd), ptm(i));
  if (!to_out) return;
  float* Y0 = R.buf(R.l.Y0);
  const Mat y0 = wmat(R, Y0, nd, 0, dk, 1);
  gemm(R, 1, N, dk, N, wmat(R, ATT, nn, 0, N, 1, rd), tmat(vs, bf, sv, 0, false), y0);
  const long long so[4] = {st[12], st[13], 0, st[14]};
  Mat out = tmat(to_out, bf, so, 0, false);
  gemm(R, 1, N, dk, N, amap(0), rounded(ptm(1), rd), out, y0, 1.f, w[4]);
}

void backward(Run& R, const void* qs, const void* ks, const void* vs, const void* dy,
              const long long* st, const float* const* w, float beta, float scale, void* dq,
              void* dk_out, void* dv, float* const* dw) {
  forward(R, qs, ks, vs, st, w, beta, scale, nullptr);
  if (R.err != cudaSuccess) return;
  const int V = R.V, N = R.N, dk = R.dk, r = R.r, bf = R.bf, rd = R.bf, R4 = 4 * r;
  const int C = 2 * V + 2;
  const long long nn = R.nn, nd = R.nd;
  const long long *sk = st + 4, *sv = st + 8;
  const long long sdy[4] = {st[12], st[13], 0, st[14]};
  // dq, dk and dv are contiguous (B, H, V, N, dk).
  const long long sg[4] = {(long long)R.H * V * nd, V * nd, nd, dk};
  float* A = R.buf(R.l.A);
  float* FCH = R.buf(R.l.FCH);
  float* BCH = R.buf(R.l.BCH);
  float* ATT = R.buf(R.l.ATT);
  float* PT = R.buf(R.l.PT);
  float* Y0 = R.buf(R.l.Y0);
  float* DATT = R.buf(R.l.DATT);
  float* DAC = R.buf(R.l.DAC);
  float* DS = R.buf(R.l.DS);
  float* DZ = R.buf(R.l.DZ);
  float* DL = R.buf(R.l.DL);
  float* DLB = R.buf(R.l.DLB);
  float* DCH = R.buf(R.l.DCH);
  float* DP = R.buf(R.l.DP);
  auto amap = [&](int v) { return wmat(R, A + v * nn, V * nn, 0, N, 1, rd); };
  auto dac = [&](int v) { return wmat(R, DAC + v * nn, V * nn, 0, N, 1); };
  auto ptm = [&](int i) { return wmat(R, PT + (i - 1) * nd, (V - 1) * nd, 0, dk, 1, rd); };
  auto dpm = [&](int k) { return wmat(R, DP + k * nd, 2 * nd, 0, dk, 1); };
  const Mat dym = tmat(dy, bf, sdy, 0, false);
  const float* chain_w = w[4];

  // The value paths: P0 = c(A_0) c(pt_1) and dchain = sum(dy P0); dv_0 =
  // c(att)^T dy; datt = dy v_0^T (rounded where read); dA_0 = w dy c(pt_1)^T.
  const Mat y0 = wmat(R, Y0, nd, 0, dk, 1);
  gemm(R, 1, N, dk, N, amap(0), ptm(1), y0);
  if (R.err != cudaSuccess) return;
  dchain_kernel<<<(unsigned)R.BH, 256, 0, R.st>>>(dy, bf, st[12], st[13], st[14], Y0, dw[4],
                                                 R.H, N, dk);
  check(R);
  gemm(R, 1, N, dk, N, tr(wmat(R, ATT, nn, 0, N, 1, rd)), dym, tmat(dv, bf, sg, 0, false));
  gemm(R, 1, N, N, dk, dym, tr(tmat(vs, bf, sv, 0, false)), wmat(R, DATT, nn, 0, N, 1));
  gemm(R, 1, N, N, dk, dym, tr(ptm(1)), dac(0), kNone, 1.f, chain_w);
  // The transport's backward: dp = c(w c(A_0)^T dy), then for i = 1..V-1
  // dA_i = c(dp) c(pt_{i+1})^T and dp <- c(A_i)^T c(dp); the last is dv_{V-1}.
  gemm(R, 1, N, dk, N, tr(amap(0)), dym, dpm(0), kNone, 1.f, chain_w);
  int cur = 0;
  for (int i = 1; i < V; ++i) {
    const Mat next = i + 1 == V ? tmat(vs, bf, sv, V - 1, false) : ptm(i + 1);
    gemm(R, 1, N, N, dk, rounded(dpm(cur), rd), tr(next), dac(i));
    const Mat to = i + 1 == V ? tmat(dv, bf, sg, V - 1, false) : dpm(1 - cur);
    gemm(R, 1, N, dk, N, tr(amap(i)), rounded(dpm(cur), rd), to);
    cur = 1 - cur;
  }
  if (R.err != cudaSuccess) return;
  // The mix: DS_v (first terms), DZ_q and d log c_fwd.
  const float* FL = FCH + (V - 2) * nn;
  const float* BL = BCH + (V - 2) * nn;
  const long long fl_bh = (V - 1) * nn;
  float* AF = R.buf(R.l.AF);
  float* BF = R.buf(R.l.BF);
  mix_bwd_kernel<<<row_blocks(R.BH * N), 256, 0, R.st>>>(R.buf(R.l.S), FL, fl_bh, AF, BF, ATT, DATT,
                                                         DS, DZ, DL, R.BH * N, V, N, r, beta, rd);
  check(R);
  // The factors: dAF_q = DZ_q BF_q, dBF_q = DZ_q^T AF_q (rank-r column slices).
  float* DAF = R.buf(R.l.DAF);
  float* DBF = R.buf(R.l.DBF);
  const Mat dz = wmat(R, DZ, 4 * nn, nn, N, 1);
  auto fac = [&](float* p) { return wmat(R, p, N * (long long)R4, r, R4, 1); };
  gemm(R, 4, N, r, N, dz, fac(BF), fac(DAF));
  gemm(R, 4, N, r, N, tr(dz), fac(AF), fac(DBF));
  // The head: dRF = dAF wrow^T, dCF = dBF wcol^T; dwrow = RF^T dAF, dwcol =
  // CF^T dBF per program; the bias grads are dAF's and dBF's column sums.
  float* DRF = R.buf(R.l.DRF);
  float* DCF = R.buf(R.l.DCF);
  auto feat = [&](float* p) { return wmat(R, p, N * (long long)C, 0, C, 1); };
  auto head = [&](const float* p) { return Mat{p, 0, 0, 0, 0, 0, 0, 1, R4}; };
  auto dwm = [&](float* p) { return wmat(R, p, (long long)C * R4, 0, R4, 1); };
  gemm(R, 1, N, C, R4, fac(DAF), head(w[0]), feat(DRF));
  gemm(R, 1, N, C, R4, fac(DBF), head(w[2]), feat(DCF));
  gemm(R, 1, C, R4, N, tr(feat(R.buf(R.l.RF))), fac(DAF), dwm(dw[0]));
  gemm(R, 1, C, R4, N, tr(feat(R.buf(R.l.CF))), fac(DBF), dwm(dw[2]));
  if (R.err != cudaSuccess) return;
  colsum_kernel<<<blocks(R.BH * R4, 128), 128, 0, R.st>>>(DAF, dw[1], R.BH * R4, N, R4);
  colsum_kernel<<<blocks(R.BH * R4, 128), 128, 0, R.st>>>(DBF, dw[3], R.BH * R4, N, R4);
  means_bwd_kernel<<<blocks(R.BH * nn, 256), 256, 0, R.st>>>(DRF, DCF, DS, DL, DLB, FL, BL,
                                                             fl_bh, R.BH * nn, V, N);
  check(R);
  // Both chains backward, from d c_fwd (DL) and d c_bwd (DLB). Step j's
  // left factor is c(chain_{j-1}); its view is j (forward) or V-1-j.
  for (int c = 0; c < 2; ++c) {
    float* CH = c == 0 ? FCH : BCH;
    auto view = [&](int j) { return c == 0 ? j : V - 1 - j; };
    Mat d = wmat(R, c == 0 ? DL : DLB, nn, 0, N, 1);
    int k = 0;
    for (int j = V - 1; j >= 2; --j) {
      const Mat left = wmat(R, CH + (j - 2) * nn, (V - 1) * nn, 0, N, 1, rd);
      gemm(R, 1, N, N, N, tr(left), d, dac(view(j)), dac(view(j)));
      const Mat next = wmat(R, DCH + k * nn, 2 * nn, 0, N, 1);
      gemm(R, 1, N, N, N, d, tr(amap(view(j))), next);
      d = rounded(next, rd);
      k = 1 - k;
    }
    gemm(R, 1, N, N, N, d, tr(amap(view(1))), dac(view(0)), dac(view(0)));
    gemm(R, 1, N, N, N, tr(amap(view(0))), d, dac(view(1)), dac(view(1)));
  }
  if (R.err != cudaSuccess) return;
  // The score softmaxes, then dq_v = c(c(dS_v k_v) sc) and dk_v = dS_v^T q_v.
  softmax_vjp_kernel<<<row_blocks(R.BH * V * N), 256, 0, R.st>>>(A, DAC, DS, R.BH * V * N, N, rd);
  check(R);
  const float sc = bf ? __bfloat162float(__float2bfloat16(scale)) : scale;
  const Mat ds = wmat(R, DS, V * nn, nn, N, 1);
  gemm(R, V, N, dk, N, ds, tmat(ks, bf, sk, 0, true), tmat(dq, bf, sg, 0, true), kNone, sc,
       nullptr, rd);
  gemm(R, V, N, dk, N, tr(ds), wmat(R, R.buf(R.l.QS), V * nd, nd, dk, 1),
       tmat(dk_out, bf, sg, 0, true));
}

}  // namespace wide
}  // namespace mop

using mop::wide::Run;

static bool bad_shape(int dtype, int B, int H, int V, int N, int dk, int r) {
  return V < 2 || V > mop::wide::kMaxV || N < 1 || N > mop::wide::kMaxN || dk < 1 ||
         dk > mop::wide::kMaxDk || r < 1 || B < 1 || H < 1 || (dtype != 0 && dtype != 1);
}

static Run make_run(int dtype, int B, int H, int V, int N, int dk, int r, void* ws,
                    void* stream) {
  Run R;
  R.B = B, R.H = H, R.V = V, R.N = N, R.dk = dk, R.r = r, R.bf = dtype;
  R.BH = (long long)B * H;
  R.nn = (long long)N * N;
  R.nd = (long long)N * dk;
  R.ws = (float*)ws;
  R.l = mop::wide::layout(V, N, dk, r);
  R.st = (cudaStream_t)stream;
  return R;
}

// Workspace bytes one program needs, forward (`bwd` 0) or backward (1); the
// Python wrapper computes the same count and allocates B*H times it.
extern "C" long long mop_edgewise_wide_ws_bytes(int V, int N, int dk, int r, int bwd) {
  return mop::wide::ws_bytes(V, N, dk, r, bwd != 0);
}

// C entry points, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) of qs, ks and vs, then (b, h, row) of out (forward) or dy
// (backward); feature strides are 1. Weights are fp32 device arrays: wrow,
// wcol (2V+2, 4r) row-major, brow, bcol (4r,), chain_w one scalar. `ws` is
// an fp32 workspace of B*H times `mop_edgewise_wide_ws_bytes`, `ws_bytes`
// its size. The backward writes dq, dk, dv contiguous (B, H, V, N, dk) (dv's
// views 1..V-2 are not written: the caller zeroes them), the per-program
// fp32 weight grads dwrow, dwcol (BH, 2V+2, 4r), dbrow, dbcol (BH, 1, 4r)
// and dchain (BH,). Return a cudaError_t code.
extern "C" int mop_edgewise_wide_fwd(int dtype, const void* qs, const void* ks, const void* vs,
                                     void* out, const void* wrow, const void* brow,
                                     const void* wcol, const void* bcol, const void* chain_w,
                                     void* ws, long long ws_bytes, int B, int H, int V, int N,
                                     int dk, int r, const long long* strides, float beta_not,
                                     float scale, void* stream) {
  if (bad_shape(dtype, B, H, V, N, dk, r) ||
      ws_bytes < (long long)B * H * mop::wide::ws_bytes(V, N, dk, r, false))
    return (int)cudaErrorInvalidValue;
  Run R = make_run(dtype, B, H, V, N, dk, r, ws, stream);
  const float* w[5] = {(const float*)wrow, (const float*)brow, (const float*)wcol,
                       (const float*)bcol, (const float*)chain_w};
  mop::wide::forward(R, qs, ks, vs, strides, w, beta_not, scale, out);
  return (int)R.err;
}

extern "C" int mop_edgewise_wide_bwd(int dtype, const void* qs, const void* ks, const void* vs,
                                     const void* dy, void* dq, void* dk_out, void* dv,
                                     const void* wrow, const void* brow, const void* wcol,
                                     const void* bcol, const void* chain_w, void* dwrow,
                                     void* dbrow, void* dwcol, void* dbcol, void* dchain,
                                     void* ws, long long ws_bytes, int B, int H, int V, int N,
                                     int dk, int r, const long long* strides, float beta_not,
                                     float scale, void* stream) {
  if (bad_shape(dtype, B, H, V, N, dk, r) ||
      ws_bytes < (long long)B * H * mop::wide::ws_bytes(V, N, dk, r, true))
    return (int)cudaErrorInvalidValue;
  Run R = make_run(dtype, B, H, V, N, dk, r, ws, stream);
  const float* w[5] = {(const float*)wrow, (const float*)brow, (const float*)wcol,
                       (const float*)bcol, (const float*)chain_w};
  float* dw[5] = {(float*)dwrow, (float*)dbrow, (float*)dwcol, (float*)dbcol, (float*)dchain};
  mop::wide::backward(R, qs, ks, vs, dy, strides, w, beta_not, scale, dq, dk_out, dv, dw);
  return (int)R.err;
}
