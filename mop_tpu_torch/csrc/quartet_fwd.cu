// K5: fused Quartet causal attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_quartet_kernel` / `_quartet_pallas` in
// mop_tpu/ops/fused.py. For each (batch*head):
//   S1 = (q * scale) k^T and S2 = (q2 * scale) k2^T (q * scale rounded to
//   the compute dtype, scores in fp32); each standardized per row over EVERY
//   column, before the causal mask, with the unbiased variance and eps after
//   the sqrt: Sn = (S - mu) / (sqrt(M2 / max(1, N - 1)) + eps);
//   scores = (1 - m) S1n + m (S1n * S2n) qscale, causal mask, softmax, times V.
// The TPU kernel holds whole N x N rows per program; at N = 256 one fp32 row
// block of both maps alone is 512 KB, more than a Hopper block has. So one
// CTA takes one (batch*head, block of 64 query rows) through two passes over
// the keys, 64 keys at a time:
//   1. every key block, the masked ones too (they enter mu and sigma):
//      S1 and S2 tiles, each row's tile mean and M2, merged into the running
//      ones by Chan et al.'s pairwise update, which stays exact to rounding
//      where a raw sum of squares would cancel;
//   2. the key blocks up to the diagonal: S1 and S2 again, standardized,
//      mixed and masked in registers, an online softmax with fp32
//      statistics, and P V. In fp32 P V accumulates unnormalised
//      probabilities and divides by the row sum at the end. In bf16 the TPU
//      kernel rounds the normalised softmax to bf16 before P V, so this pass
//      sweeps the causal blocks twice: first for each row's final max and
//      sum, then for P V with P = rnd(exp(s - max) / sum).
// In both dtypes the result is the TPU kernel's up to fp32 rounding.
//
// Bound on this card: at (BH, N, dk) = (512, 256, 80) the function needs the
// full score maps for the statistics (2 x 2 N^2 dk flops) and the causal half
// of P V, about 13.4 Gflop against 252 MB of inputs and output in fp32, so
// it is bound by the fp32 FMA rate. The kernel computes the causal score
// tiles twice (pass 2 recomputes them instead of keeping N x N maps) and
// whole 64 x 64 tiles on the diagonal, about 1.55x that work (bf16's extra
// sweep adds the causal score tiles a third time). Products run
// on CUDA cores in true fp32, each thread owning a 4 x 4 register tile of the
// 64 x 64 score tile.
#include <type_traits>

#include "common.cuh"

namespace mop {

constexpr int kMaxDk = 128;
constexpr int kOutCols = kMaxDk / 16;  // output columns owned by one thread

// (b, h, row) element strides of q, k, v, q2, k2 and out.
struct Strides {
  long long s[18];
};

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
__global__ void __launch_bounds__(kThreads, 2) quartet_fwd_kernel(
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

size_t smem_bytes(int dk) {
  return sizeof(float) * (4 * (size_t)kTile * odd_stride(dk) + (size_t)kTile * (kTile + 1));
}

template <typename T>
int launch(const void* const* in, void* out, const float* mix, int B, int H, int N, int dk,
           const long long* st, float eps, float scale, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 18; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(dk);
  cudaError_t e = cudaFuncSetAttribute(quartet_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (N + kTile - 1) / kTile);
  quartet_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3], (const T*)in[4],
      (T*)out, mix, H, N, dk, strides, eps, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 18 element strides: (b, h, row) of
// q, k, v, q2, k2 and out, in that order; feature strides are 1. `mix` is an
// fp32 device array (m, qscale): the sigmoid'd mixture and the quartet scale.
// Returns a cudaError_t code.
extern "C" int mop_quartet_fwd(int dtype, const void* q, const void* k, const void* v,
                               const void* q2, const void* k2, void* out, const void* mix, int B,
                               int H, int N, int dk, const long long* strides, float eps,
                               float scale, void* stream) {
  if (N < 1 || N > 65535 * mop::kTile || dk < 1 || dk > mop::kMaxDk || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[5] = {q, k, v, q2, k2};
  const float* mx = (const float*)mix;
  if (dtype == 0) return mop::launch<float>(in, out, mx, B, H, N, dk, strides, eps, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(in, out, mx, B, H, N, dk, strides, eps, scale, s);
  return (int)cudaErrorInvalidValue;
}
