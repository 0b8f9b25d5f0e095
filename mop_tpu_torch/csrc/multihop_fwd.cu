// K4: fused D-mode (multi-hop, dual-path) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_multihop_kernel` / `_multihop_forward` in
// mop_tpu/ops/fused.py. One CTA runs one (batch*head) program:
//   1. S1 = (q1 * scale) k1^T and S2 = (q2 * scale) k2^T, with q * scale
//      rounded to the compute dtype and the scores in fp32;
//   2. A1c = c(softmax(S1)); the base, and, or and not terms of the mix
//      folded into S1's map; A2c = c(softmax(S2)) in place of S2;
//   3. C = A1c A2c, then c(C) A2c for each further hop. At N <= 64 the whole
//      N x N product is one register tile of the 256 threads, so the chain
//      term g_chain log(C + 1e-6) goes into the mix straight from registers;
//   4. the final softmax (rounded, as the TPU kernel casts it), the value
//      transport t = c(A2c (... c(A2c v2))) over hops - 1 products, and
//      y = c(att) v1 + w A1c t in fp32, cast once.
// Shared memory holds four N x N fp32 maps (S1 -> mix -> att; S2 -> A2c;
// A1c; the rounded chain between hops) and two N x dk staging buffers (q and
// k, then the transport and v1): 99.8 KB at N = 64, dk = 64, so two programs
// share an SM, and at most 130 KB anywhere in the envelope (N <= 64,
// dk <= 128). `c(x)` is the round to the compute dtype (`rnd<T>`), placed
// where the JAX kernel casts.
//
// Bound on this card: at N = 64, dk = 64, hops 3 a program does about
// 4.2 Mflop (two score products, hops - 1 chain products, hops transport
// products and the att v1 product, each 2 N^2 dk or 2 N^3) against 6 N dk
// inputs read once and N dk written, so in fp32 it is bound by the FMA rate.
// The products run on CUDA cores in true fp32 (the JAX kernel asks for
// HIGHEST precision on fp32 operands), each thread owning a 4 x 4 register
// tile of the 64 x 64 product.
#include "common.cuh"

namespace mop {

constexpr int kMaxN = kTile;
constexpr int kMaxDk = 2 * kTile;

// (b, h, row) element strides of q1, k1, v1, q2, k2, v2 and out.
struct Strides {
  long long s[21];
};

// The scalar gates of the logit mix.
struct Gates {
  float base, and_, or_, not_, chain;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) multihop_fwd_kernel(
    const T* __restrict__ q1, const T* __restrict__ k1, const T* __restrict__ v1,
    const T* __restrict__ q2, const T* __restrict__ k2, const T* __restrict__ v2,
    T* __restrict__ out, const float* __restrict__ chain_w, int H, int N, int dk, int hops,
    Strides strides, Gates g, float beta_not, float scale) {
  extern __shared__ float smem[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  const int msz = N * ldm;
  float* S1 = smem;          // S1, then the mixed logits, then att (rounded)
  float* A2 = S1 + msz;      // S2, then A2c
  float* A1 = A2 + msz;      // A1c
  float* CT = A1 + msz;      // the chain rounded to T, between hops
  float* Xs = CT + msz;      // q staging, then the transport
  float* Ys = Xs + N * ldd;  // k staging, then v1

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const T* in[6] = {q1, k1, v1, q2, k2, v2};
  const T* p[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) p[i] = in[i] + b * st[3 * i] + h * st[3 * i + 1];
  T* op = out + b * st[18] + h * st[19];
  const float sc = rnd<T>(scale);
  const int nn = N * N;
  Tile t;

  // 1. Score maps: S1 into S1, S2 into A2.
  for (int s = 0; s < 2; ++s) {
    const int qi = s == 0 ? 0 : 3;
    __syncthreads();
    stage_in<T>(Xs, ldd, p[qi], st[3 * qi + 2], N, dk, false, sc);
    stage_in<T>(Ys, ldd, p[qi + 1], st[3 * qi + 5], N, dk, false, 1.f);
    __syncthreads();
    mm_nt(Xs, Ys, ldd, dk, N, t);
    store<T>(s == 0 ? S1 : A2, ldm, N, N, 0, t, false);
  }
  __syncthreads();

  // 2. A1c; the mix up to its chain term, in S1's place; A2c in S2's.
  softmax_rows<T>(S1, A1, ldm, N);
  __syncthreads();
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int o = (idx / N) * ldm + idx % N;
    const float s1 = S1[o], s2 = A2[o];
    const float lse = fmaxf(s1, s2) + log1pf(expf(-fabsf(s1 - s2)));
    float m = g.base * s1;
    m = m + g.and_ * s2;
    m = m + g.or_ * (lse - s1);
    m = m - g.not_ * (beta_not * s2);
    S1[o] = m;
  }
  __syncthreads();
  softmax_rows<T>(A2, A2, ldm, N);
  __syncthreads();

  // 3. The chain C = A1c A2c (c(C) A2c per further hop), then its term.
  mm_nn(A1, ldm, A2, ldm, N, N, N, 0, t);
  for (int hop = 2; hop < hops; ++hop) {
    __syncthreads();  // the previous product has read CT
    store<T>(CT, ldm, N, N, 0, t, true);
    __syncthreads();
    mm_nn(CT, ldm, A2, ldm, N, N, N, 0, t);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      if (r < N && c < N) {
        const int o = r * ldm + c;
        S1[o] = S1[o] + g.chain * logf(t.v[i][j] + 1e-6f);
      }
    }
  }
  __syncthreads();

  // 4. att = c(softmax(mix)); the transport from v2, rounded after every
  //    product because the next one reads it in the compute dtype; the output.
  softmax_rows<T>(S1, S1, ldm, N);
  stage_in<T>(Xs, ldd, p[5], st[17], N, dk, false, 1.f);
  stage_in<T>(Ys, ldd, p[2], st[8], N, dk, false, 1.f);
  for (int hop = 1; hop < hops; ++hop) {
    for (int c0 = 0; c0 < dk; c0 += kTile) {
      __syncthreads();
      mm_nn(A2, ldm, Xs, ldd, N, N, dk, c0, t);
      __syncthreads();
      store<T>(Xs, ldd, N, dk, c0, t, true);
    }
  }
  __syncthreads();
  const float w = *chain_w;
  for (int c0 = 0; c0 < dk; c0 += kTile) {
    Tile t2;
    mm_nn(S1, ldm, Ys, ldd, N, N, dk, c0, t);
    mm_nn(A1, ldm, Xs, ldd, N, N, dk, c0, t2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (r < N && c < dk) op[r * st[20] + c] = from_f<T>(t.v[i][j] + w * t2.v[i][j]);
      }
    }
  }
}

size_t smem_bytes(int N, int dk) {
  return sizeof(float) * (4 * (size_t)N * odd_stride(N) + 2 * (size_t)N * odd_stride(dk));
}

template <typename T>
int launch(const void* const* in, void* out, const float* chain_w, int B, int H, int N, int dk,
           int hops, const long long* st, Gates g, float beta_not, float scale,
           cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 21; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(N, dk);
  cudaError_t e = cudaFuncSetAttribute(multihop_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  multihop_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)in[0], (const T*)in[1], (const T*)in[2], (const T*)in[3], (const T*)in[4],
      (const T*)in[5], (T*)out, chain_w, H, N, dk, hops, strides, g, beta_not, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 21 element strides: (b, h, row) of
// q1, k1, v1, q2, k2, v2 and out, in that order; feature strides are 1.
// `chain_w` is one fp32 device scalar; the gates, beta_not and the score
// scale are host floats. Returns a cudaError_t code.
extern "C" int mop_multihop_fwd(int dtype, const void* q1, const void* k1, const void* v1,
                                const void* q2, const void* k2, const void* v2, void* out,
                                const void* chain_w, int B, int H, int N, int dk, int hops,
                                const long long* strides, float base, float and_, float or_,
                                float not_, float chain, float beta_not, float scale,
                                void* stream) {
  if (N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk || hops < 2 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[6] = {q1, k1, v1, q2, k2, v2};
  const mop::Gates g = {base, and_, or_, not_, chain};
  const float* w = (const float*)chain_w;
  if (dtype == 0)
    return mop::launch<float>(in, out, w, B, H, N, dk, hops, strides, g, beta_not, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(in, out, w, B, H, N, dk, hops, strides, g, beta_not,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
