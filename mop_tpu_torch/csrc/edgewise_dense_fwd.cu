// K3: fused E-mode (edgewise, dense gate head) attention forward for Hopper.
//
// Replaces the Pallas forward `_edgewise_generic_fwd_kernel` over
// `_edgewise_dense_math` + `_edgewise_output` in mop_tpu/ops/fused.py. One
// CTA runs one (batch*head) program through the whole pipeline:
//   1. per view i: S_i = (q_i * scale) k_i^T and A_i = softmax(S_i);
//   2. c_fwd = A_0 A_1 ... A_{V-1}, c_bwd = A_{V-1} ... A_0 (each partial
//      product rounded to the compute dtype before the next dot);
//   3. per edge (i, j), the dense gate head on the feature stack
//      [S_1..S_V at (i, j), S_1..S_V at (j, i), log c_fwd, log c_bwd]:
//      pre = b1 + feat w1 (C -> 16), tanh GELU, g = sigmoid(b2 + hid w2)
//      (16 -> 4), folded straight into the gated logit mix, the edges walked
//      in 16 x 16 blocks whose S_c, c_fwd, c_bwd tiles and transposed S_c
//      tiles are staged in shared memory (`dense_mix`);
//   4. the final softmax, the value transport and
//      y = c(att) v_0 + w A_0 (A_1 (... (A_{V-1} v_{V-1}))).
// No feature map of its own is built: an edge reads S_c(i, j) and S_c(j, i)
// of every view, so all V score maps stay live until the gates are done.
// Those maps, the V probability maps, both chains and the transports sit in
// a per-program fp32 workspace in device memory, as in the backward kernel,
// whose recompute of the forward (edgewise_stages.cuh) this kernel shares;
// shared memory holds the staged operands of the product at hand, the
// head's weights and the mix's edge tiles. The workspace makes any N <= 64, dk <= 128, V <= 8 fit.
//
// Bound on this card: about 12 Mflop per program at the main shape (the
// 2(V-1) N^3 chain products and the per-edge head's 2 x (16 C + 64) flops
// are most of it) against 3 V N dk inputs read once, so in fp32 it is bound
// by the FMA rate. The products run on CUDA cores in true fp32, each thread
// owning a 4 x 4 register tile.
#include "edgewise_stages.cuh"

namespace mop {

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) edgewise_dense_fwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks, const T* __restrict__ vs,
    T* __restrict__ out, Weights wts, float* __restrict__ workspace, int H, int V, int N, int dk,
    Strides strides, float beta_not, float scale) {
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  const int nbuf = buf_floats(N, dk);
  float* X = smem;
  float* Y = X + nbuf;
  float* Z = Y + nbuf;
  float* W = Z + nbuf;
  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Prog<T> p = make_prog(qs, ks, vs, st, workspace, H, V, N, dk);
  // The head's weights, read four at a time (16-byte aligned), then the mix's edge blocks.
  const DenseGate gate = load_dense_gate(wts, 2 * V + 2, smem + round4(4 * nbuf));
  float* tiles = smem + round4(4 * nbuf) + dense_gate_floats(2 * V + 2);
  const float w = *wts.p[4];
  recompute_forward<T>(p, gate, X, Y, Z, W, beta_not, rnd<T>(scale), tiles);

  // y = c(att) v_0 + w Ac_0 c(P_1).
  __syncthreads();
  stage<T>(X, ldm, p.ATT(), N, N, N, false, true);
  stage_in<T>(Y, ldd, p.vp, st[11], N, dk, false, 1.f);
  stage<T>(Z, ldm, p.A(0), N, N, N, false, true);
  stage<T>(W, ldd, p.P(1), dk, N, dk, false, false);
  __syncthreads();
  T* op = out + b * st[12] + h * st[13];
  const int ty = tid >> 4, tx = tid & 15;
  for (int c0 = 0; c0 < dk; c0 += kTile) {
    Tile t, t2;
    mm_nn(X, ldm, Y, ldd, N, N, dk, c0, t);
    mm_nn(Z, ldm, W, ldd, N, N, dk, c0, t2);
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

size_t smem_bytes(int V, int N, int dk) {
  return sizeof(float) *
         (round4(4 * buf_floats(N, dk)) + dense_gate_floats(2 * V + 2) + (2 * V + 2) * kET);
}

template <typename T>
int launch(const void* qs, const void* ks, const void* vs, void* out, const Weights& w,
           float* workspace, int B, int H, int V, int N, int dk, const long long* st,
           float beta_not, float scale, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  const size_t smem = smem_bytes(V, N, dk);
  cudaError_t e = cudaFuncSetAttribute(edgewise_dense_fwd_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  edgewise_dense_fwd_kernel<T><<<B * H, kThreads, smem, stream>>>(
      (const T*)qs, (const T*)ks, (const T*)vs, (T*)out, w, workspace, H, V, N, dk, strides,
      beta_not, scale);
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes one program needs; the Python wrapper refuses shapes
// above the card's per-block limit before it launches.
extern "C" long long mop_edgewise_dense_smem_bytes(int V, int N, int dk) {
  return (long long)mop::smem_bytes(V, N, dk);
}

// fp32 elements of one program's device-memory workspace.
extern "C" long long mop_edgewise_dense_ws_floats(int V, int N, int dk) {
  return mop::ws_floats(V, N, dk);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for out; feature strides are 1.
// Weights and chain_w are fp32 device arrays: w1 (2V+2, 16) row-major, b1
// (16,), w2 (16, 4) row-major, b2 (4,), chain_w one scalar. `workspace`
// holds B*H times mop_edgewise_dense_ws_floats floats. Returns a
// cudaError_t code.
extern "C" int mop_edgewise_dense_fwd(int dtype, const void* qs, const void* ks, const void* vs,
                                      void* out, const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* chain_w, void* workspace, int B,
                                      int H, int V, int N, int dk, const long long* strides,
                                      float beta_not, float scale, void* stream) {
  if (V < 2 || V > mop::kMaxViews || N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk ||
      B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  mop::Weights w;
  const void* ptrs[5] = {w1, b1, w2, b2, chain_w};
  for (int i = 0; i < 5; ++i) w.p[i] = (const float*)ptrs[i];
  if (dtype == 0)
    return mop::launch<float>(qs, ks, vs, out, w, (float*)workspace, B, H, V, N, dk, strides,
                              beta_not, scale, s);
  if (dtype == 1)
    return mop::launch<__nv_bfloat16>(qs, ks, vs, out, w, (float*)workspace, B, H, V, N, dk,
                                      strides, beta_not, scale, s);
  return (int)cudaErrorInvalidValue;
}
