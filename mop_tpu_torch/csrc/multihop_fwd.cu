// K4: fused D-mode (multi-hop, dual-path) attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_multihop_kernel` / `_multihop_forward` in
// mop_tpu/ops/fused.py. One CTA runs one (batch*head) program:
//   1. S1 = (q1 * scale) k1^T and S2 = (q2 * scale) k2^T, with q * scale
//      rounded to the compute dtype and the scores in fp32;
//   2. A1 = softmax(S1), A2 = softmax(S2) and the base, and, or and not
//      terms of the gated mix;
//   3. C = A1 A2^(hops-1), and the mix's chain term g_chain log(C + 1e-6);
//   4. att = softmax(mix) and y = att v1 + w A1 A2^(hops-1) v2.
// Bound on this card: at N = 64, dk = 64 a program reads 6 N dk inputs and
// writes N dk, and does 2 N^2 dk flops per score map, 2 N^3 per chain
// product and 2 N^2 dk per value product, so in fp32 it is bound by the FMA
// rate. The products run on CUDA cores in true fp32 (the JAX kernel asks for
// HIGHEST precision on fp32 operands). Two kernels:
//
// - fp32 (`multihop_f32_kernel`). Every cast of the JAX kernel is the
//   identity in fp32, so the value chain is the one product C v2 with the
//   fp32 C that feeds the log term, and y = [att | w C] [v1 ; v2], one
//   product over K = 2 N: at hops 3 a program does 6 units of 2 * 64^3
//   flops where the transport A1 (A2 (A2 v2)) took 8. 256 threads in two
//   groups of 128, each with its own named barrier: group 0 stages q1 and
//   k1 and computes S1 while group 1 stages q2 and k2 and computes S2, 8 x 4
//   thread tiles whose q and k rows are read as float4 (128 FMAs per 12
//   shared-memory loads). Then each group owns 32 rows: their softmaxes and
//   mix (four threads a row, 16 columns each), their rows of the chain (a
//   row of C needs only its row of A1 and all of A2), of att and of y, 4 x 4
//   tiles read as float4 (`mm4`). v1 and v2 come in by `cp.async` from the
//   start, into a space of their own, while the scores, the mix and the
//   chain run. Shared memory (`F32Layout`): [att | C] with S1 first in its
//   left half, A1, A2 (S2 first) and the stacked [v1 ; v2], with each
//   group's q and k staged where only its own score map lands: 104.4 KB
//   at N = 64, dk = 64 (two programs an SM), 202.8 KB at dk = 128.
// - bf16 (`multihop_fwd_kernel<__nv_bfloat16>`): the JAX kernel rounds C
//   before every further hop and the transport after every product, so the
//   kernel keeps its steps: the chain C = A1c A2c (c(C) A2c per further
//   hop), the transport t = c(A2c (... c(A2c v2))) over hops - 1 products,
//   and y = c(att) v1 + w A1c t in fp32, cast once; `c(x)` is the round to
//   the compute dtype (`rnd<T>`), placed where the JAX kernel casts. All 256
//   threads run each product in turn, each owning a 4 x 4 tile of the
//   64 x 64 product; four N x N fp32 maps and two N x dk staging buffers at
//   an odd row stride, 99.8 KB at N = 64, dk = 64.
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

// ------------------------------- fp32 -------------------------------

constexpr int kGroup = kThreads / 2;  // threads of one group
constexpr int kRows = kTile / 2;      // rows of the chain, att and y one group owns

__host__ __device__ inline long long max_ll(long long a, long long b) { return a > b ? a : b; }

// Float offsets of the fp32 kernel's shared memory at (N, dk), np = round4(N):
// - [att | C] at 0: N rows of stride lp = 2 np + 4, S1, then the mix and
//   att, in columns [0, np); the chain between hops, then w C, in [np, 2 np);
// - A1: N rows of stride lm = np + 4;
// - A2: np rows of stride lm, S2 first, rows past N zero;
// - [v1 ; v2] last: 2 np rows of stride lq = ld4(dk), v2 from row np, rows
//   past N zero (the value product reads round4(N) rows of each).
// The float4 products read np columns of A1, A2 and att, zero past N.
// q1 and k1 (N rows of stride lq each) are staged at 0, q2 and k2 after
// them and after S1's map, and A2 after q1 and k1: each group's score map
// lands on its own q and k only, so it writes its map after its own
// barrier. v1 and v2 have their own space: they come in from the start.
struct F32Layout {
  int np, lm, lp, lq;
  long long a1, a2, q2, v, total;
  __host__ __device__ F32Layout(int N, int dk) {
    np = round4(N);
    lm = np + 4;
    lp = 2 * np + 4;
    lq = ld4(dk);
    const long long att = (long long)N * lp, qk = 2LL * N * lq;  // qk: one group's q and k
    a1 = att;
    a2 = max_ll(a1 + (long long)N * lm, qk);
    q2 = max_ll(qk, att);
    v = max_ll(a2 + (long long)np * lm, q2 + qk);
    total = v + 2LL * np * lq;
  }
};

size_t f32_smem_bytes(int N, int dk) { return sizeof(float) * (size_t)F32Layout(N, dk).total; }

// The row passes: four threads a row (an aligned lane quad), each holding
// 16 of its columns, [qc0, qc0 + 16) with qc0 = 16 (t & 3).
constexpr int kQuarter = 16;

// A quarter row (from `row`, of which the first n columns are valid) into
// x, -inf past them and for a row that is not live.
__device__ __forceinline__ void load_quarter(float (&x)[kQuarter], const float* row, bool live,
                                             int n) {
#pragma unroll
  for (int j = 0; j < kQuarter; j += 4) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (live && j < n) a = *reinterpret_cast<const float4*>(row + j);
    const float v[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int u = 0; u < 4; ++u) x[j + u] = live && j + u < n ? v[u] : -INFINITY;
  }
}

// x = exp(x - the row's max) in place (0 where x is -inf), and the row's sum
// (each lane's 16 in order, then the quad).
__device__ __forceinline__ float quarter_exp(float (&x)[kQuarter]) {
  float mx = x[0];
#pragma unroll
  for (int e = 1; e < kQuarter; ++e) mx = fmaxf(mx, x[e]);
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < kQuarter; ++e) {
    x[e] = x[e] == -INFINITY ? 0.f : expf(x[e] - mx);
    sum += x[e];
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  return sum + __shfl_xor_sync(0xffffffffu, sum, 2);
}

// row[0, 16) = x * mul as float4 stores, the first n columns only (n a
// multiple of 4).
__device__ __forceinline__ void store_quarter(float* row, const float (&x)[kQuarter], float mul,
                                              int n) {
#pragma unroll
  for (int j = 0; j < kQuarter; j += 4)
    if (j < n)
      *reinterpret_cast<float4*>(row + j) =
          make_float4(x[j] * mul, x[j + 1] * mul, x[j + 2] * mul, x[j + 3] * mul);
}

// See the file's head. Group 0 is warps 0-3, group 1 warps 4-7; group g
// owns rows [32 g, 32 g + 32) of the mix, the chain, att and y.
__global__ void __launch_bounds__(kThreads, 2) multihop_f32_kernel(
    const float* __restrict__ q1, const float* __restrict__ k1, const float* __restrict__ v1,
    const float* __restrict__ q2, const float* __restrict__ k2, const float* __restrict__ v2,
    float* __restrict__ out, const float* __restrict__ chain_w, int H, int N, int dk, int hops,
    Strides strides, Gates g, float beta_not, float scale, int vec) {
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const F32Layout L(N, dk);
  const int np = L.np, lm = L.lm, lp = L.lp, lq = L.lq, d4 = round4(dk);
  float* AC = smem;         // [att | C]
  float* A1 = smem + L.a1;
  float* VV = smem + L.v;   // [v1 ; v2]
  float* A2 = smem + L.a2;  // S2, then A2
  const int tid = threadIdx.x, grp = tid >> 7, gt = tid & (kGroup - 1);
  const int qr = kRows * grp + (gt >> 2), qc0 = kQuarter * (gt & 3);  // the row passes
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const float* in[6] = {q1, k1, v1, q2, k2, v2};
  auto src = [&](int i) { return in[i] + b * st[3 * i] + h * st[3 * i + 1]; };

  // 1. The group's score map: its q and k by cp.async (their float4 tails
  //    past dk zeroed), q scaled in place, then a thread's 8 x 4 tile (rows
  //    rg + 8i, keys kg + 16j) over dk from float4 rows.
  {
    const int qi = 3 * grp;  // q1 or q2; its k follows
    float* Qs = smem + (grp ? L.q2 : 0);
    float* Ks = Qs + N * lq;
    copy_rows_async(Qs, lq, src(qi), st[3 * qi + 2], N, N, dk, vec, gt, kGroup);
    copy_rows_async(Ks, lq, src(qi + 1), st[3 * qi + 5], N, N, dk, vec, gt, kGroup);
    cp_async_commit();
    // v1 and v2 come in from the start, into their own space.
    copy_rows_async(VV, lq, src(2), st[8], np, N, dk, vec, tid, kThreads);
    copy_rows_async(VV + np * lq, lq, src(5), st[17], np, N, dk, vec, tid, kThreads);
    cp_async_commit();
    const int pad = d4 - dk;
    if (pad) {
      for (int idx = gt; idx < 2 * N * pad; idx += kGroup)
        Qs[(idx / pad) * lq + dk + idx % pad] = 0.f;
    }
    cp_async_wait<1>();
    named_sync(grp);
    for (int idx = gt; idx < N * dk; idx += kGroup) {
      const int r = idx / dk, c = idx - r * dk;
      Qs[r * lq + c] *= scale;
    }
    named_sync(grp);
    const int rg = gt & 7, kg = gt >> 3;
    const float* qr[8];
    const float* kr[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[i] = Qs + min(rg + 8 * i, N - 1) * lq;
#pragma unroll
    for (int j = 0; j < 4; ++j) kr[j] = Ks + min(kg + 16 * j, N - 1) * lq;
    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < d4; d += 4) {
      float4 kb[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(kr[j] + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = *reinterpret_cast<const float4*>(qr[i] + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, kb[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, kb[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, kb[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, kb[j].w, s[i][j]);
        }
      }
    }
    named_sync(grp);  // the group is done with its q and k
    float* S = grp ? A2 : AC;
    const int ls = grp ? lm : lp;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = rg + 8 * i, c = kg + 16 * j;
        if (r < N && c < N) S[r * ls + c] = s[i][j];
      }
  }
  __syncthreads();

  // 2. The group's rows, a quad of threads a row: A1, A2 (zero past N, and
  //    A2's rows past N zero) and the mix up to its chain term in S1's place.
  {
    float* mr = AC + qr * lp + qc0;
    float* a1r = A1 + qr * lm + qc0;
    float* a2r = A2 + qr * lm + qc0;
    const bool live = qr < N;
    float x1[kQuarter], x2[kQuarter], mix[kQuarter];
    load_quarter(x1, mr, live, N - qc0);
    load_quarter(x2, a2r, live, N - qc0);
#pragma unroll
    for (int e = 0; e < kQuarter; ++e) {
      const float s1 = x1[e], s2 = x2[e];
      float m = g.base * s1;
      m = m + g.and_ * s2;
      if (g.or_ != 0.f) {  // + 0 * (lse - s1) leaves m as it is
        const float lse = fmaxf(s1, s2) + log1pf(expf(-fabsf(s1 - s2)));
        m = m + g.or_ * (lse - s1);
      }
      mix[e] = m - g.not_ * (beta_not * s2);
    }
    const float z1 = quarter_exp(x1), z2 = quarter_exp(x2);
    if (live) {
#pragma unroll
      for (int e = 0; e < kQuarter; ++e)
        if (qc0 + e < N) mr[e] = mix[e];
      store_quarter(a1r, x1, 1.f / z1, np - qc0);
      store_quarter(a2r, x2, 1.f / z2, np - qc0);
    } else if (qr < np) {
      store_quarter(a2r, x2, 0.f, np - qc0);
    }
  }
  __syncthreads();  // A2 is whole

  // 3. The group's rows of C = A1 A2^(hops-1) in registers (between hops in
  //    C's half of [att | C]), 4 x 4 tiles; the chain term into the mix,
  //    then w C over C. 4. att = softmax(mix) on the group's rows.
  const int r0 = kRows * grp;
  const int nr = N - r0;  // rows from r0 on; a tile covers 32 of them
  float* Cr = AC + r0 * lp + np;
  if (nr > 0) {
    const int ty = gt >> 4, tx = gt & 15;
    float t[4][4];
    mm4(A1 + r0 * lm, lm, A2, lm, np, nr, np, 0, gt, t);
    for (int hop = 2; hop < hops; ++hop) {
      named_sync(grp);  // the previous product has read C
      put4(Cr, lp, nr, np, 0, gt, t);
      named_sync(grp);
      mm4(Cr, lp, A2, lm, np, nr, np, 0, gt, t);
    }
    const float w = *chain_w;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        if (g.chain != 0.f && r < nr && c < N) {  // + 0 * log(C + 1e-6) leaves the mix
          float* o = AC + (r0 + r) * lp + c;
          *o = *o + g.chain * logf(t[i][j] + 1e-6f);
        }
        t[i][j] *= w;
      }
    }
    named_sync(grp);  // the last product has read C
    put4(Cr, lp, nr, np, 0, gt, t);
    named_sync(grp);  // the mix's rows are whole
    float* mr = AC + qr * lp + qc0;
    float x[kQuarter];
    load_quarter(x, mr, qr < N, N - qc0);
    const float z = quarter_exp(x);
    if (qr < N) store_quarter(mr, x, 1.f / z, np - qc0);
  }
  cp_async_wait<0>();
  __syncthreads();  // att, w C, v1 and v2 are whole

  // 5. y = [att | w C] [v1 ; v2] over K = 2 np on the group's rows, 64
  //    columns at a time; float4 stores where the output rows allow.
  if (nr > 0) {
    const int ty = gt >> 4, tx = gt & 15;
    float* op = out + b * st[18] + h * st[19];
    const bool v4 = (dk & 3) == 0 && (st[20] & 3) == 0 &&
                    (reinterpret_cast<unsigned long long>(op) & 15) == 0;
    for (int c0 = 0; c0 < dk; c0 += kTile) {
      float t[4][4];
      mm4(AC + r0 * lp, lp, VV, lq, 2 * np, nr, dk, c0, gt, t);
      const int c = c0 + 4 * tx;
      if (c >= dk) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        if (r >= nr) continue;
        float* o = op + (r0 + r) * st[20] + c;
        if (v4) {
          *reinterpret_cast<float4*>(o) = make_float4(t[i][0], t[i][1], t[i][2], t[i][3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (c + j < dk) o[j] = t[i][j];
        }
      }
    }
  }
}

int launch_f32(const void* const* in, void* out, const float* chain_w, int B, int H, int N,
               int dk, int hops, const long long* st, Gates g, float beta_not, float scale,
               int vec, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 21; ++i) strides.s[i] = st[i];
  const size_t smem = f32_smem_bytes(N, dk);
  cudaError_t e = cudaFuncSetAttribute(multihop_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  multihop_f32_kernel<<<B * H, kThreads, smem, stream>>>(
      (const float*)in[0], (const float*)in[1], (const float*)in[2], (const float*)in[3],
      (const float*)in[4], (const float*)in[5], (float*)out, chain_w, H, N, dk, hops, strides, g,
      beta_not, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace mop

// C entry points, bound from Python with ctypes. `dtype` is 0 for fp32 and
// 1 for bf16. `strides` is a host array of 21 element strides: (b, h, row) of
// q1, k1, v1, q2, k2, v2 and out, in that order; feature strides are 1.
// `chain_w` is one fp32 device scalar; the gates, beta_not and the score
// scale are host floats; `vec` is the fp32 kernel's cp.async width in bytes
// (16, 8 or 4, dividing every input's address, row stride and dk * 4; else
// 4-byte element copies). Returns a cudaError_t code.
extern "C" int mop_multihop_fwd(int dtype, const void* q1, const void* k1, const void* v1,
                                const void* q2, const void* k2, const void* v2, void* out,
                                const void* chain_w, int B, int H, int N, int dk, int hops,
                                const long long* strides, float base, float and_, float or_,
                                float not_, float chain, float beta_not, float scale, int vec,
                                void* stream) {
  if (N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk || hops < 2 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* in[6] = {q1, k1, v1, q2, k2, v2};
  const mop::Gates g = {base, and_, or_, not_, chain};
  const float* w = (const float*)chain_w;
  if (dtype == 0)
    return mop::launch_f32(in, out, w, B, H, N, dk, hops, strides, g, beta_not, scale, vec, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(in, out, w, B, H, N, dk, hops, strides, g, beta_not,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}

// Shared memory one K4 block takes at (N, dk) in `dtype` (0 fp32, 1 bf16).
extern "C" long long mop_multihop_smem_bytes(int dtype, int N, int dk) {
  return (long long)(dtype == 0 ? mop::f32_smem_bytes(N, dk) : mop::smem_bytes(N, dk));
}
