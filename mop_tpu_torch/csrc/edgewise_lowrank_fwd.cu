// K2: fused E-mode (edgewise, lowrank gate head) attention forward for Hopper.
//
// Replaces the Pallas forward `_edgewise_generic_fwd_kernel` over
// `_edgewise_math` + `_edgewise_output` in mop_tpu/ops/fused.py. The kernels
// (bf16 on the tensor cores, fp32 on CUDA cores in two groups of 256
// threads) are edgewise_fwd.cuh's, which K3 shares, instantiated here with
// the lowrank head (`LowrankGate`): the row and column means of every
// channel pooled into rank-r factors, gates sigmoid(a_c b_c^T). No map goes
// to device memory: S_0, the other views' sum and the running log-sum-exp
// over views stay in the registers each S_i comes out of its product in.
//
// Bound on this card: about 9.4 Mflop per program at the main shape (the
// 2(V-1) N^3 chain products are almost half) against 3 V N dk inputs read
// once. bf16 takes 99 KB of shared memory at the main shape, so two programs
// share an SM; fp32 171 KB, one program of 512 threads an SM.
#include "edgewise_fwd.cuh"

namespace mop {

size_t smem_bytes(int dtype, int V, int N, int dk, int r) {
  return fwd_smem_bytes(false, dtype, V, N, dk, r);
}

}  // namespace mop

// Shared-memory bytes one program needs (`dtype` 0 fp32, 1 bf16); the Python
// wrapper computes the same count and refuses shapes above the card's
// per-block limit before it launches.
extern "C" long long mop_edgewise_lowrank_smem_bytes(int dtype, int V, int N, int dk, int r) {
  return (long long)mop::smem_bytes(dtype, V, N, dk, r);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for out; feature strides are 1.
// Weights and chain_w are fp32 device arrays: wrow/wcol (2V+2, 4r) row-major,
// brow/bcol (4r,), chain_w one scalar. `vec` is the width in bytes (16, 8, 4
// or 2) of the bf16 kernel's asynchronous copies of q, k and v rows, which
// must divide their addresses, strides and rows (the fp32 kernel ignores
// it). Returns a cudaError_t code.
extern "C" int mop_edgewise_lowrank_fwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, void* out, const void* wrow,
                                        const void* brow, const void* wcol,
                                        const void* bcol, const void* chain_w, int B,
                                        int H, int V, int N, int dk, int r,
                                        const long long* strides, float beta_not,
                                        float scale, int vec, void* stream) {
  if (V < 2 || N < 1 || N > mop::kMaxN || dk < 1 || dk > mop::kMaxDk || r < 1 || B < 1 ||
      H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  mop::Weights w;
  const void* ptrs[5] = {wrow, brow, wcol, bcol, chain_w};
  for (int i = 0; i < 5; ++i) w.p[i] = (const float*)ptrs[i];
  return mop::launch_fwd<mop::LowrankGate>(dtype, qs, ks, vs, out, w, nullptr, B, H, V, N, dk, r,
                                           strides, beta_not, scale, vec, (cudaStream_t)stream);
}
