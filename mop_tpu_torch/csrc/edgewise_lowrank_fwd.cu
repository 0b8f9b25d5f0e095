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
// The per-view maps are never written to device memory: S_0, sum_i S_i and
// the running log-sum-exp over views are kept as three maps beside the V
// probability maps and the forward chain, so a program holds V + 5 maps of
// N x N fp32 plus q/k staging. At V = 5, N = 64, dk = 56 that is 205 KB of
// the 227 KB of shared memory one block may take; larger shapes raise in the
// Python wrapper instead of composing quietly.
//
// Bound on this card: about 9.4 Mflop per program (the 2(V-1) N^3 chain
// products are almost half) against 3 V N dk inputs read once, so in fp32 it
// is bound by the FMA rate. The products run on CUDA cores in true fp32
// (the JAX kernel uses HIGHEST precision on fp32 operands), each thread
// owning a 4 x 4 register tile.
#include "common.cuh"

namespace mop {

constexpr int kMaxN = kTile;
constexpr int kMaxDk = 2 * kTile;

// (b, h, view, row) element strides of qs, ks and vs, then (b, h, row) of out.
struct Strides {
  long long s[15];
};

// Row means of a map into rowf[r * C + ch] and column means into
// colf[c * C + ch]. With ch_t >= 0 the same means also fill the transposed
// channel ch_t: the row mean of S^T is the column mean of S.
__device__ void means(const float* M, int ldm, int N, float* rowf, float* colf, int C,
                      int ch, int ch_t) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kThreads / 32) {
    const float* row = M + r * ldm;
    float s = (lane < N ? row[lane] : 0.f) + (lane + 32 < N ? row[lane + 32] : 0.f);
    s = warp_sum(s) / (float)N;
    if (lane == 0) {
      rowf[r * C + ch] = s;
      if (ch_t >= 0) colf[r * C + ch_t] = s;
    }
  }
  for (int c = threadIdx.x; c < N; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < N; ++r) s += M[r * ldm + c];
    s /= (float)N;
    colf[c * C + ch] = s;
    if (ch_t >= 0) rowf[c * C + ch_t] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) edgewise_lowrank_fwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks, const T* __restrict__ vs,
    T* __restrict__ out, const float* __restrict__ wrow, const float* __restrict__ brow,
    const float* __restrict__ wcol, const float* __restrict__ bcol,
    const float* __restrict__ chain_w, int H, int V, int N, int dk, int r,
    Strides strides, float beta_not, float scale) {
  extern __shared__ float smem[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N);
  const int ldd = odd_stride(dk);
  const int C = 2 * V + 2;
  const int R4 = 4 * r;
  const int msz = N * ldm;
  float* A = smem;                 // V probability maps (holding S_i while pooled)
  float* S0 = A + V * msz;         // S_0, then the mixed logits, then att
  float* SS = S0 + msz;            // sum_i S_i
  float* MX = SS + msz;            // running max over views, then the LSE
  float* LS = MX + msz;            // running sum of exp, then c_bwd
  float* CF = LS + msz;            // c_fwd
  float* Xs = CF + msz;            // q staging, then the transport
  float* Ys = Xs + N * ldd;        // k staging, then v_0
  float* rowf = Ys + N * ldd;      // N x C pooled row features
  float* colf = rowf + N * C;      // N x C pooled column features
  float* af = colf + N * C;        // N x 4r row factors
  float* bf = af + N * R4;         // N x 4r column factors

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const T* qp = qs + b * st[0] + h * st[1];
  const T* kp = ks + b * st[4] + h * st[5];
  const T* vp = vs + b * st[8] + h * st[9];
  T* op = out + b * st[12] + h * st[13];
  const float sc = rnd<T>(scale);
  const float w = *chain_w;
  const int nn = N * N;

  Tile t;
  for (int vi = 0; vi < V; ++vi) {
    __syncthreads();
    for (int idx = tid; idx < N * dk; idx += kThreads) {
      const int rr = idx / dk, c = idx - rr * dk;
      Xs[rr * ldd + c] = rnd<T>(to_f<T>(qp[vi * st[2] + rr * st[3] + c]) * sc);
      Ys[rr * ldd + c] = to_f<T>(kp[vi * st[6] + rr * st[7] + c]);
    }
    __syncthreads();
    mm_nt(Xs, Ys, ldd, dk, N, t);
    float* Ai = A + vi * msz;
    store<T>(Ai, ldm, N, N, 0, t, false);
    __syncthreads();
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int o = (idx / N) * ldm + idx % N;
      const float x = Ai[o];
      if (vi == 0) {
        S0[o] = x;
        SS[o] = x;
        MX[o] = x;
        LS[o] = 1.f;
      } else {
        SS[o] += x;
        const float mo = MX[o];
        if (x > mo) {
          LS[o] = LS[o] * expf(mo - x) + 1.f;
          MX[o] = x;
        } else {
          LS[o] += expf(x - mo);
        }
      }
    }
    means(Ai, ldm, N, rowf, colf, C, vi, V + vi);
    __syncthreads();
    softmax_rows<T>(Ai, Ai, ldm, N);
  }
  __syncthreads();

  for (int idx = tid; idx < nn; idx += kThreads) {
    const int o = (idx / N) * ldm + idx % N;
    MX[o] += logf(LS[o]);
  }
  // c_fwd = ((A_0 A_1) A_2) ... and c_bwd = ((A_{V-1} A_{V-2}) ...) A_0.
  mm_nn(A, ldm, A + msz, ldm, N, N, N, 0, t);
  store<T>(CF, ldm, N, N, 0, t, false);
  mm_nn(A + (V - 1) * msz, ldm, A + (V - 2) * msz, ldm, N, N, N, 0, t);
  __syncthreads();  // LS is free once the LSE is final
  store<T>(LS, ldm, N, N, 0, t, false);
  for (int i = 2; i < V; ++i) {
    __syncthreads();
    for (int idx = tid; idx < nn; idx += kThreads) {
      const int o = (idx / N) * ldm + idx % N;
      CF[o] = rnd<T>(CF[o]);
      LS[o] = rnd<T>(LS[o]);
    }
    __syncthreads();
    mm_nn(CF, ldm, A + i * msz, ldm, N, N, N, 0, t);
    Tile t2;
    mm_nn(LS, ldm, A + (V - 1 - i) * msz, ldm, N, N, N, 0, t2);
    __syncthreads();
    store<T>(CF, ldm, N, N, 0, t, false);
    store<T>(LS, ldm, N, N, 0, t2, false);
  }
  __syncthreads();
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int o = (idx / N) * ldm + idx % N;
    CF[o] = logf(CF[o] + 1e-6f);
    LS[o] = logf(LS[o] + 1e-6f);
  }
  __syncthreads();
  means(CF, ldm, N, rowf, colf, C, 2 * V, -1);
  means(LS, ldm, N, rowf, colf, C, 2 * V + 1, -1);
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
    const int o = i * ldm + j;
    float g[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float z = 0.f;
      for (int u = 0; u < r; ++u) z = fmaf(af[i * R4 + c * r + u], bf[j * R4 + c * r + u], z);
      g[c] = 1.f / (1.f + expf(-z));
    }
    const float s1 = S0[o];
    const float others = SS[o] - s1;
    float smix = s1;
    smix = smix + g[0] * others;
    smix = smix + g[1] * (MX[o] - s1);
    smix = smix - g[2] * (beta_not * (others / n_others));
    smix = smix + g[3] * CF[o];
    S0[o] = smix;
  }
  // transport = v_{V-1}, staged exactly; every later value is rounded to T
  // because the next dot reads it in the compute dtype.
  for (int idx = tid; idx < N * dk; idx += kThreads) {
    const int rr = idx / dk, c = idx - rr * dk;
    Xs[rr * ldd + c] = to_f<T>(vp[(V - 1) * st[10] + rr * st[11] + c]);
    Ys[rr * ldd + c] = to_f<T>(vp[rr * st[11] + c]);
  }
  __syncthreads();
  softmax_rows<T>(S0, S0, ldm, N);
  for (int i = V - 1; i >= 1; --i) {
    for (int c0 = 0; c0 < dk; c0 += kTile) {
      __syncthreads();
      mm_nn(A + i * msz, ldm, Xs, ldd, N, N, dk, c0, t);
      __syncthreads();
      store<T>(Xs, ldd, N, dk, c0, t, true);
    }
  }
  __syncthreads();
  const int ty = tid >> 4, tx = tid & 15;
  for (int c0 = 0; c0 < dk; c0 += kTile) {
    Tile t2;
    mm_nn(S0, ldm, Ys, ldd, N, N, dk, c0, t);
    mm_nn(A, ldm, Xs, ldd, N, N, dk, c0, t2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rr = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (rr < N && c < dk) op[rr * st[14] + c] = from_f<T>(t.v[i][j] + w * t2.v[i][j]);
      }
    }
  }
}

size_t smem_bytes(int V, int N, int dk, int r) {
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  return sizeof(float) * ((size_t)(V + 5) * N * ldm + 2 * (size_t)N * ldd +
                          2 * (size_t)N * (2 * V + 2) + 2 * (size_t)N * 4 * r);
}

template <typename T>
int launch(const void* qs, const void* ks, const void* vs, void* out, const float* wrow,
           const float* brow, const float* wcol, const float* bcol, const float* chain_w,
           int B, int H, int V, int N, int dk, int r, const long long* st,
           float beta_not, float scale, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(V, N, dk, r);
  cudaError_t e = cudaFuncSetAttribute(edgewise_lowrank_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  edgewise_lowrank_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)qs, (const T*)ks, (const T*)vs, (T*)out, wrow, brow, wcol, bcol, chain_w,
      H, V, N, dk, r, strides, beta_not, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes one program needs; the Python wrapper refuses shapes
// above the card's per-block limit before it launches.
extern "C" long long mop_edgewise_lowrank_smem_bytes(int V, int N, int dk, int r) {
  return (long long)mop::smem_bytes(V, N, dk, r);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for out; feature strides are 1.
// Weights and chain_w are fp32 device arrays: wrow/wcol (2V+2, 4r) row-major,
// brow/bcol (4r,), chain_w one scalar. Returns a cudaError_t code.
extern "C" int mop_edgewise_lowrank_fwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, void* out, const void* wrow,
                                        const void* brow, const void* wcol,
                                        const void* bcol, const void* chain_w, int B,
                                        int H, int V, int N, int dk, int r,
                                        const long long* strides, float beta_not,
                                        float scale, void* stream) {
  if (V < 2 || N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk || r < 1 || B < 1 ||
      H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float* w[5] = {(const float*)wrow, (const float*)brow, (const float*)wcol,
                       (const float*)bcol, (const float*)chain_w};
  if (dtype == 0)
    return mop::launch<float>(qs, ks, vs, out, w[0], w[1], w[2], w[3], w[4], B, H, V, N,
                              dk, r, strides, beta_not, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(qs, ks, vs, out, w[0], w[1], w[2], w[3], w[4], B,
                                      H, V, N, dk, r, strides, beta_not, scale, s);
  return (int)cudaErrorInvalidValue;
}
