// K1: blockwise flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_fwd_kernel` / `_flash_forward` in
// mop_tpu/ops/fused.py. Computes softmax(Q K^T * scale [causal]) V for one
// (batch*head, 64-row query block) per CTA: K/V blocks of 64 keys stream
// through shared memory, the softmax is online with fp32 statistics, and the
// output accumulates in fp32 registers. Masks and guards follow the TPU
// kernel: keys at or beyond `nkv` are masked, the causal mask is row >= col,
// and a row whose running max is still -inf contributes nothing.
//
// Bound on this card: at the ViT shape (N = 64, dk = 56) one CTA reads its
// Q, K and V once and writes O once, so the kernel is bound by device-memory
// bytes at the fp32 FMA rate (4 N^2 dk flops against 16 N dk bytes). The
// design keeps every score and probability in registers or shared memory;
// the products run on CUDA cores in true fp32, because the JAX kernel asks
// for HIGHEST precision on fp32 operands (no TF32). bf16 inputs are
// converted on load, which is exact, and P is rounded to bf16 before P V as
// the TPU kernel casts it.
#include "common.cuh"

namespace mop {

constexpr int kMaxDk = 128;
constexpr int kOutCols = kMaxDk / 16;  // output columns owned by one thread

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int H, int N, int Nkv, int dk,
    long long qsb, long long qsh, long long qsn,
    long long ksb, long long ksh, long long ksn,
    long long vsb, long long vsh, long long vsn,
    long long osb, long long osh, long long osn,
    int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = odd_stride(dk);
  const int ldp = kTile + 1;
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* Ps = Vs + kTile * ld;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.y * kTile;
  const T* qp = q + b * qsb + h * qsh;
  const T* kp = k + b * ksb + h * ksh;
  const T* vp = v + b * vsb + h * vsh;
  T* op = o + b * osb + h * osh;

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int idx = tid; idx < kTile * dk; idx += kThreads) {
    const int r = idx / dk, c = idx - r * dk;
    Qs[r * ld + c] = (q0 + r < N) ? to_f<T>(qp[(long long)(q0 + r) * qsn + c]) : 0.f;
  }

  float m[4], l[4], acc[4][kOutCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  int num_kv = (Nkv + kTile - 1) / kTile;
  if (causal) num_kv = min(num_kv, (q0 + 2 * kTile - 1) / kTile);

  for (int kb = 0; kb < num_kv; ++kb) {
    const int k0 = kb * kTile;
    __syncthreads();  // Q is loaded; the previous block is done with K, V, P
    for (int idx = tid; idx < kTile * dk; idx += kThreads) {
      const int r = idx / dk, c = idx - r * dk;
      const bool live = k0 + r < Nkv;
      Ks[r * ld + c] = live ? to_f<T>(kp[(long long)(k0 + r) * ksn + c]) : 0.f;
      Vs[r * ld + c] = live ? to_f<T>(vp[(long long)(k0 + r) * vsn + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dk; ++d) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(4 * ty + i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (col >= Nkv || (causal && row < col)) x = -INFINITY;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = isfinite(m[i]) ? expf(m[i] - m_safe) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_safe);
        rs += p;
        Ps[(4 * ty + i) * ldp + tx + 16 * j] = rnd<T>(p);
      }
      rs = half_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int mm = 0; mm < kTile; ++mm) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * ldp + mm];
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) {
        const int col = tx + 16 * c;
        if (col < dk) {
          const float vv = Vs[mm * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= N) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) {
      const int col = tx + 16 * c;
      if (col < dk) op[(long long)row * osn + col] = from_f<T>(acc[i][c] / denom);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int N, int Nkv, int dk, const long long* st, int causal, float scale,
           cudaStream_t stream) {
  const int ld = odd_stride(dk);
  const size_t smem = sizeof(float) * (size_t)(3 * kTile * ld + kTile * (kTile + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * H, (N + kTile - 1) / kTile);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, N, Nkv, dk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      st[9], st[10], st[11], causal, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16; `strides` holds the (batch, head, row) element strides of q, k,
// v and o in that order (the feature stride must be 1). Returns a
// cudaError_t code: 0 when the launch was accepted.
extern "C" int mop_flash_fwd(int dtype, const void* q, const void* k, const void* v,
                             void* o, int B, int H, int N, int Nkv, int dk,
                             const long long* strides, int causal, float scale,
                             void* stream) {
  if (dk < 1 || dk > mop::kMaxDk || N < 1 || Nkv < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return mop::launch<float>(q, k, v, o, B, H, N, Nkv, dk, strides, causal, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(q, k, v, o, B, H, N, Nkv, dk, strides, causal,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
