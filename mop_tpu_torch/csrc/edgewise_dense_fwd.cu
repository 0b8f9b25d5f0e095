// K3: fused E-mode (edgewise, dense gate head) attention forward for Hopper.
//
// Replaces the Pallas forward `_edgewise_generic_fwd_kernel` over
// `_edgewise_dense_math` + `_edgewise_output` in mop_tpu/ops/fused.py. The
// kernels are K2's (edgewise_fwd.cuh: bf16 on the tensor cores, fp32 on CUDA
// cores in two groups of 256 threads), instantiated with the dense head
// (`DenseGate`): per edge (i, j), pre = b1 + feat w1 (C -> 16), tanh GELU,
// g = sigmoid(b2 + hid w2) (16 -> 4) on the features
// [S_1..S_V at (i, j), S_1..S_V at (j, i), log c_fwd, log c_bwd], folded
// straight into the gated logit mix on CUDA cores in fp32.
//
// An edge reads the V scores at (i, j) and at (j, i), so the V fp32 score
// maps go to a per-program workspace in device memory as they are formed
// (V N round4(N) floats, 80 KB at the main shape) and are read back once, by
// the mix. At the main shape the 264 resident programs (two an SM in bf16,
// one of 512 threads in fp32) keep 21 MB of maps, which the 50 MB L2 holds.
// Every other map stays on chip: the probability maps, both chains, att
// and the transport in shared memory, log c_fwd and log c_bwd in registers
// (fp32: log c_bwd in shared memory, the backward chain runs in the other
// thread group).
//
// Bound on this card: about 11.5 Mflop per program at the main shape (the
// 2(V-1) N^3 chain products and the per-edge head's 2 x 16 x (C + 4) flops
// are most of it) against 3 V N dk inputs read once, so it is bound by the
// FMA rate in fp32 and by the bytes in bf16.
#include "edgewise_fwd.cuh"

namespace mop {

size_t smem_bytes(int dtype, int V, int N, int dk) {
  return fwd_smem_bytes(true, dtype, V, N, dk, 1);
}

}  // namespace mop

// Shared-memory bytes one program needs (`dtype` 0 fp32, 1 bf16); the Python
// wrapper refuses shapes above the card's per-block limit before it launches.
extern "C" long long mop_edgewise_dense_smem_bytes(int dtype, int V, int N, int dk) {
  return (long long)mop::smem_bytes(dtype, V, N, dk);
}

// Bytes of one program's device-memory workspace: the V fp32 score maps (row
// stride round4(N)), and where the fp32 kernel cannot keep its V maps A_i on
// chip (many views with wide heads), those too.
extern "C" long long mop_edgewise_dense_ws_bytes(int dtype, int V, int N, int dk) {
  return (long long)sizeof(float) * mop::dense_ws_floats(V, N, mop::dense_a_ws(dtype, V, N, dk));
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for out; feature strides are 1.
// Weights and chain_w are fp32 device arrays: w1 (2V+2, 16) row-major, b1
// (16,), w2 (16, 4) row-major, b2 (4,), chain_w one scalar. `workspace`
// holds B*H times mop_edgewise_dense_ws_bytes bytes, 16-byte aligned. `vec`
// is the width in bytes (16, 8, 4 or 2) of the bf16 kernel's asynchronous
// copies of q, k and v rows (the fp32 kernel ignores it). Returns a
// cudaError_t code.
extern "C" int mop_edgewise_dense_fwd(int dtype, const void* qs, const void* ks, const void* vs,
                                      void* out, const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* chain_w, void* workspace, int B,
                                      int H, int V, int N, int dk, const long long* strides,
                                      float beta_not, float scale, int vec, void* stream) {
  if (V < 2 || V > mop::kMaxViews || N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk ||
      B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  mop::Weights w;
  const void* ptrs[5] = {w1, b1, w2, b2, chain_w};
  for (int i = 0; i < 5; ++i) w.p[i] = (const float*)ptrs[i];
  return mop::launch_fwd<mop::DenseGate>(dtype, qs, ks, vs, out, w, (float*)workspace, B, H, V,
                                         N, dk, 1, strides, beta_not, scale, vec,
                                         (cudaStream_t)stream);
}
