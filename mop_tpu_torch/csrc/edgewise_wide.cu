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
// at once.
//
// What bounds them on the H100. (1) The products: at VOC E's (V, N, dk) =
// (4, 196, 64) two thirds of the forward's operations are the six N x N x N
// chain products, and the backward adds twelve more; for 256 programs in
// fp32 that is 0.21 ms forward and 0.62 ms backward as 3xTF32 (three passes
// at the tensor cores' 495 TF32 TFLOP/s), 0.52 and 1.52 ms at the CUDA
// cores' 67 fp32 TFLOP/s. (2) The workspace traffic between stages: each
// N x N map of one program is 150 KB, a stage's maps for every program far
// beyond the 50 MB L2.
//
// What the design does about each. (1) Every product runs on the tensor
// cores (`mm_kernel`): an fp32 operand as 3xTF32, x = hi + lo with hi and lo
// rounded to TF32 (to nearest, ties away, as cvt.rna), a b = lo hi + hi lo +
// hi hi with fp32 accumulators: about 2^-21 relative a product, never
// single-pass TF32. An operand whose values are bf16 (rounded as the plain
// version casts) is exact in TF32, so its low part's mma is skipped. A
// block owns 64 rows (two warps of two m16 tiles) and every column of its
// output (N <= 256; four warps take the n8 tiles in turn, each the same
// count, past N zeros), so N = 196 pads to 208 rows of live m16 tiles and
// 224 columns; the operands arrive by 16-byte `cp.async` along their
// contiguous axis into a two-stage ring of k steps of 32, the row- or
// column-major layout of each operand a template argument. The products
// are bound by latency, not issue: two blocks an SM (128 registers a
// thread) and no branch the compiler cannot prove warp-uniform around an
// mma are what moved them. (2) Fewer passes: the scores S_v = (q_v /
// sqrt(dk)) k_v^T take the scale on load and write S_v, the softmax A_v, the
// row means of S_v and the column sums of the block's rows in one epilogue;
// both chains advance in one launch a step, and the last step writes the
// log maps' row means and column sums; the chains' backward runs both
// chains a launch and updates their cotangents in place (a block reads and
// writes only its own rows); the means' backward for the scores folds into
// the score softmaxes' VJP.
//
// Precision follows the plain version (`fused_edgewise_lowrank_attention_plain`
// and its autograd backward): every product accumulates in fp32; in bf16
// an operand is rounded to bf16 on load wherever the plain version casts it
// to the compute dtype, and a cotangent is rounded where the plain
// backward's casts round it.
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "common.cuh"

namespace mop {
namespace wide {

constexpr int kMaxN = 256, kMaxDk = 128, kMaxV = 8;
constexpr int kRowsPerBlock = 8;  // row kernels: one warp a row

// The product engine's block: 256 threads, kBM = 64 rows (two warps of kMT =
// 2 m16 tiles each) by up to 256 columns (four warps; n8 tile t goes to warp
// t % 4), k in steps of kBK = 32 (four m16n8k8 steps) through a ring of two
// stages; two blocks an SM (at most 128 registers a thread).
constexpr int kThreads = 256, kMT = 2, kBM = 32 * kMT, kBN = 256, kBK = 32, kStages = 2;
constexpr int kWarpsN = 4;
constexpr int kMaxNT = kBN / 8 / kWarpsN;  // n8 tiles a warp holds
// Shared-memory row strides: a tile stored k-contiguous, A stored
// m-contiguous, B stored n-contiguous (ld_bn, for the block's columns), the
// output tile. Each makes the fragment reads of one warp hit 32 distinct
// banks.
constexpr int kLdK = kBK + 4, kLdAM = kBM + 8, kLdC = kBN + 8;
constexpr int kATile = kBM * kLdK > kBK * kLdAM ? kBM * kLdK : kBK * kLdAM;

__host__ __device__ constexpr int ld_bn(int ncols8) { return ((ncols8 + 31) & ~31) + 8; }

// Floats of one ring stage for a block of ncols8 columns: the A tile, then
// the B tile in either layout, its columns rounded up to 32.
__host__ __device__ constexpr int stage_floats(int ncols8) {
  return kATile + ((ld_bn(ncols8) - 8) * kLdK > kBK * ld_bn(ncols8) ? (ld_bn(ncols8) - 8) * kLdK
                                                                    : kBK * ld_bn(ncols8));
}

__host__ __device__ constexpr int smem_bytes(int ncols8) {
  return 4 * (kStages * stage_floats(ncols8) > kBM * kLdC ? kStages * stage_floats(ncols8)
                                                           : kBM * kLdC);
}

enum { kStore = 0, kSoftmax = 1, kLogMeans = 2 };

// A matrix operand of a batched product. Batch z = (i0 * d1 + i1) * d2 + i2
// starts at p + off + i0 s0 + i1 s1 + i2 s2; `ld` is the stride of its
// non-unit axis (the layout, which axis is contiguous, is the kernel's
// template argument). Each value is multiplied by `scale` and, with
// `round`, rounded to bf16 on load. `vec`: 16-byte copies are aligned.
// `exact`: every loaded value is a TF32 value.
struct Operand {
  const void* p;
  long long off, s0, s1, s2, ld;
  float scale;
  int round, vec, exact;
};

// An output (row-major, row stride ld) or an fp32 side array of a product.
struct Out {
  void* p;
  long long off, s0, s1, s2, ld;
};

struct Gemm {
  Operand a, b;
  Out out;   // kStore: alpha * A B (+ cin); kSoftmax: S; kLogMeans: the map
  Out out2;  // kSoftmax: the row softmax of S
  Out cin;   // kStore: added where p is set (fp32)
  Out rm;    // kSoftmax, kLogMeans: the row means (of S, or of log(x + 1e-6))
  Out cmp;   // ... and the column sums of this block's rows, N a row block
  int M, N, K, Z, d1, d2;
  float alpha;
  const float* alpha_ptr;  // a device scalar alpha is multiplied by, or null
  int round_acc;           // round A B to bf16 before alpha
};

__device__ __forceinline__ float rbf(float x) { return rnd<__nv_bfloat16>(x); }

__device__ __forceinline__ long long boff(long long off, long long s0, long long s1,
                                          long long s2, int z, int d1, int d2) {
  const int i2 = z % d2, t = z / d2;
  return off + (t / d1) * s0 + (t % d1) * s1 + i2 * s2;
}

template <class M>
__device__ __forceinline__ long long boff(const M& m, const Gemm& g, int z) {
  return boff(m.off, m.s0, m.s1, m.s2, z, g.d1, g.d2);
}

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32's
// result for a finite x, in two integer operations (the cvt, measurably
// slower in the products on the H100, does the same).
__device__ __forceinline__ unsigned tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The TF32 residual of x, whose TF32 rounding is hi: tf32(x - hi).
__device__ __forceinline__ unsigned lo_tf32(float x, unsigned hi) {
  return tf32(x - __uint_as_float(hi));
}

// d += a b over one m16n8k8 step: TF32 operands, fp32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// cp.async of kBytes, of which the first src_bytes are read and the rest
// zero-filled.
template <int kBytes>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int src_bytes) {
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "n"(kBytes), "r"(src_bytes));
}

// One OUTER x INNER tile of an operand into shared memory as fp32 (row
// stride LDS), INNER its contiguous axis in device memory (row stride gld
// there), W elements a copy. Tile element (o, i) is the operand's (o0 + o,
// i0 + i), zero outside [0, omax) x [0, imax); rows o >= olim and columns
// i >= ilim are not written (no fragment reads them). fp32 goes by
// cp.async (the caller commits); bf16 through registers, where the scale
// and rounding apply on the way (`fix_tile` applies them to fp32).
template <class T, int OUTER, int INNER, int W>
__device__ __forceinline__ void load_tile(float* sm, int lds, const T* g, long long gld, int o0,
                                          int omax, int olim, int i0, int imax, int ilim,
                                          float scale, int round) {
  constexpr int kChunks = INNER / W;
#pragma unroll 1  // unrolled, the copies' addresses crowd out the accumulators
  for (int c = threadIdx.x; c < OUTER * kChunks; c += kThreads) {
    const int o = c / kChunks, i = (c % kChunks) * W;
    if (o >= olim || i >= ilim) continue;
    const int go = o0 + o, gi = i0 + i;
    const int nv = go < omax ? min(W, imax - gi) : 0;
    float* dst = sm + o * lds + i;
    const T* src = g + (long long)go * gld + gi;
    if constexpr (std::is_same<T, float>::value) {
      const int bytes = nv > 0 ? 4 * nv : 0;
      cp_async_zfill<4 * W>(dst, bytes ? (const void*)src : (const void*)g, bytes);
    } else {
      float x[W];
      if (W == 8 && nv == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(src);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int e = 0; e < W / 2; ++e) {
          const float2 f = __bfloat1622float2(h[e]);
          x[2 * e] = f.x;
          x[2 * e + 1] = f.y;
        }
      } else {
#pragma unroll
        for (int e = 0; e < W; ++e) x[e] = e < nv ? __bfloat162float(src[e]) : 0.f;
      }
#pragma unroll
      for (int e = 0; e < W; ++e) {
        x[e] *= scale;
        if (round) x[e] = rbf(x[e]);
      }
      if constexpr (W == 8) {
        reinterpret_cast<float4*>(dst)[0] = make_float4(x[0], x[1], x[2], x[3]);
        reinterpret_cast<float4*>(dst)[1] = make_float4(x[4], x[5], x[6], x[7]);
      } else {
        dst[0] = x[0];
      }
    }
  }
}

// The scale and rounding of an fp32 tile, in place, over the same copies
// this thread issued (after it waited for them).
template <int OUTER, int INNER, int W>
__device__ __forceinline__ void fix_tile(float* sm, int lds, int olim, int ilim, float scale,
                                         int round) {
  constexpr int kChunks = INNER / W;
  for (int c = threadIdx.x; c < OUTER * kChunks; c += kThreads) {
    const int o = c / kChunks, i = (c % kChunks) * W;
    if (o >= olim || i >= ilim) continue;
    float* x = sm + o * lds + i;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const float v = x[e] * scale;
      x[e] = round ? rbf(v) : v;
    }
  }
}

// An OUTER x INNER tile of operand `op` as `load_tile` takes it: 16-byte
// copies where `op.vec` allows them, else one element a copy.
template <class T, int OUTER, int INNER>
__device__ __forceinline__ void load_op(float* sm, int lds, const Operand& op, const T* g,
                                        int o0, int omax, int olim, int i0, int imax, int ilim) {
  if (op.vec)
    load_tile<T, OUTER, INNER, 16 / (int)sizeof(T)>(sm, lds, g, op.ld, o0, omax, olim, i0, imax,
                                                    ilim, op.scale, op.round);
  else
    load_tile<T, OUTER, INNER, 1>(sm, lds, g, op.ld, o0, omax, olim, i0, imax, ilim, op.scale,
                                  op.round);
}

template <int OUTER, int INNER>
__device__ __forceinline__ void fix_op(float* sm, int lds, const Operand& op, int olim,
                                       int ilim) {
  if (op.vec)
    fix_tile<OUTER, INNER, 4>(sm, lds, olim, ilim, op.scale, op.round);
  else
    fix_tile<OUTER, INNER, 1>(sm, lds, olim, ilim, op.scale, op.round);
}

// The output tile (rows x ncols in Cs) to device memory.
template <int EPI, class TO>
__device__ __forceinline__ void epilogue(const Gemm& g, float* Cs, int z, int m0, int n0,
                                         int rows, int ncols, int rb) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, nw = blockDim.x / 32;
  if constexpr (EPI == kStore) {
    TO* out = (TO*)g.out.p + boff(g.out, g, z);
    const float* cin = g.cin.p ? (const float*)g.cin.p + boff(g.cin, g, z) : nullptr;
    const float alpha = g.alpha * (g.alpha_ptr ? *g.alpha_ptr : 1.f);
    for (int r = warp; r < rows; r += nw) {
      const long long ro = (long long)(m0 + r) * g.out.ld + n0;
      const long long rc = (long long)(m0 + r) * g.cin.ld + n0;
      for (int c = lane; c < ncols; c += 32) {
        float v = Cs[r * kLdC + c];
        if (g.round_acc) v = rbf(v);
        v *= alpha;
        if (cin) v += cin[rc + c];
        out[ro + c] = from_f<TO>(v);
      }
    }
  } else {
    // Whole rows (n0 = 0, ncols = N <= 256): each warp a row at a time.
    float* S = (float*)g.out.p + boff(g.out, g, z);
    float* rm = (float*)g.rm.p + boff(g.rm, g, z);
    for (int r = warp; r < rows; r += nw) {
      float* c_row = Cs + r * kLdC;
      const long long ro = (long long)(m0 + r) * g.out.ld;
      float rs = 0.f;
      if constexpr (EPI == kSoftmax) {
        float* A = (float*)g.out2.p + boff(g.out2, g, z);
        float x[8], m = -INFINITY;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = lane + 32 * t;
          x[t] = j < ncols ? c_row[j] : -INFINITY;
          m = fmaxf(m, x[t]);
        }
        m = warp_max(m);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = lane + 32 * t;
          if (j < ncols) {
            S[ro + j] = x[t];
            rs += x[t];
            x[t] = expf(x[t] - m);
            sum += x[t];
          }
        }
        sum = warp_sum(sum);
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = lane + 32 * t;
          if (j < ncols) A[ro + j] = x[t] / sum;
        }
      } else {
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const int j = lane + 32 * t;
          if (j < ncols) {
            const float v = c_row[j];
            S[ro + j] = v;
            const float l = logf(v + 1e-6f);
            c_row[j] = l;
            rs += l;
          }
        }
      }
      rs = warp_sum(rs);
      if (lane == 0) rm[m0 + r] = rs / g.N;
    }
    __syncthreads();
    float* cmp = (float*)g.cmp.p + boff(g.cmp, g, z) + (long long)rb * g.N;
    for (int c = threadIdx.x; c < ncols; c += blockDim.x) {
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += Cs[r * kLdC + c];
      cmp[c] = s;
    }
  }
}

// One m16n8k8 step (k offset kk in the stage) of a warp's NM m16 tiles
// (rows wr..) by its nt n8 tiles (wn, wn + 4, ...): every operand split
// into TF32 hi + lo, acc += a_lo b_hi + a_hi b_lo + a_hi b_hi, the low
// terms of an operand whose values are TF32 values skipped.
template <int NM, bool AK, bool BK>
__device__ __forceinline__ void mma_step(float (&acc)[kMaxNT][kMT][4], const float* As,
                                         const float* Bs, int ldb, int kk, int wr, int wn, int gq,
                                         int tq, int nt, int a_exact, int b_exact) {
  unsigned ah[NM][4], al[NM][4];
#pragma unroll
  for (int u = 0; u < NM; ++u) {
    float a[4];
    if constexpr (AK) {
      const float* p = As + (wr + 16 * u + gq) * kLdK + kk + tq;
      a[0] = p[0], a[1] = p[8 * kLdK], a[2] = p[4], a[3] = p[8 * kLdK + 4];
    } else {
      const float* p = As + (kk + tq) * kLdAM + wr + 16 * u + gq;
      a[0] = p[0], a[1] = p[8], a[2] = p[4 * kLdAM], a[3] = p[4 * kLdAM + 8];
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[u][e] = tf32(a[e]);
      al[u][e] = lo_tf32(a[e], ah[u][e]);
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxNT; ++t) {
    if (t >= nt) break;
    const int tile = wn + kWarpsN * t;
    float b0, b1;
    if constexpr (BK) {
      const float* p = Bs + (tile * 8 + gq) * kLdK + kk + tq;
      b0 = p[0], b1 = p[4];
    } else {
      const float* p = Bs + (kk + tq) * ldb + tile * 8 + gq;
      b0 = p[0], b1 = p[4 * ldb];
    }
    const unsigned bh0 = tf32(b0), bh1 = tf32(b1);
    const unsigned bl0 = lo_tf32(b0, bh0), bl1 = lo_tf32(b1, bh1);
#pragma unroll
    for (int u = 0; u < NM; ++u) {
      if (!a_exact) mma_tf32(acc[t][u], al[u], bh0, bh1);
      if (!b_exact) mma_tf32(acc[t][u], ah[u], bl0, bl1);
      mma_tf32(acc[t][u], ah[u], bh0, bh1);
    }
  }
}

// The batched product: out = A B (M x K by K x N) for every batch z, one
// 64-row block of it a block (and up to 256 columns), on the tensor cores.
// AK: A is stored k-contiguous (row-major M x K), else m-contiguous; BK: B
// is stored k-contiguous (B^T row-major), else n-contiguous. TA, TB: the
// operands' element types in device memory; EPI the epilogue, TO the type
// kStore writes.
template <bool AK, bool BK, class TA, class TB, int EPI, class TO>
__global__ void __launch_bounds__(kThreads, 2) mm_kernel(const Gemm g) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wm = warp % 2, wn = warp / 2, gq = lane / 4, tq = lane % 4;
  const int nrb = (g.M + kBM - 1) / kBM;
  const int rb = blockIdx.x % nrb, m0 = rb * kBM, n0 = (blockIdx.x / nrb) * kBN;
  const int ncols = min(kBN, g.N - n0), ncols8 = (ncols + 7) & ~7, ntiles = ncols8 / 8;
  // Warp wn takes the n8 tiles wn, wn + 4, ... below ntiles: ntw or ntw - 1
  // of them. The shared tile holds 32 ntw columns (zeros past ncols8), and
  // the warp's count comes from a vote, so that the compiler knows the
  // branches on it are warp-uniform (one it cannot prove uniform puts a
  // WARPSYNC before every mma).
  const int ntw = (ntiles + kWarpsN - 1) / kWarpsN, ncolsL = 32 * ntw;
  const int nt = ntw - (__all_sync(0xffffffffu, wn + kWarpsN * (ntw - 1) >= ntiles) ? 1 : 0);
  const int stage = stage_floats(ncols8), ldb = BK ? kLdK : ld_bn(ncols8);
  const int rows = min(kBM, g.M - m0);
  const int wr = wm * 16 * kMT;           // the warp's first row
  // Whether the warp's first and second m16 tiles hold an output row, as
  // votes for the same reason.
  const bool live = __all_sync(0xffffffffu, wr < rows);
  const bool live2 = __all_sync(0xffffffffu, wr + 16 < rows);
  const int KT = (g.K + kBK - 1) / kBK;
  const bool fixA = std::is_same<TA, float>::value && (g.a.round || g.a.scale != 1.f);
  const bool fixB = std::is_same<TB, float>::value && (g.b.round || g.b.scale != 1.f);

  for (int z = blockIdx.y; z < g.Z; z += gridDim.y) {
    const TA* pa = (const TA*)g.a.p + boff(g.a, g, z);
    const TB* pb = (const TB*)g.b.p + boff(g.b, g, z);
    auto load = [&](int s, int kt) {
      float* As = sm + s * stage;
      float* Bs = As + kATile;
      const int k0 = kt * kBK;
      if constexpr (AK)
        load_op<TA, kBM, kBK>(As, kLdK, g.a, pa, m0, g.M, kBM, k0, g.K, kBK);
      else
        load_op<TA, kBK, kBM>(As, kLdAM, g.a, pa, k0, g.K, kBK, m0, g.M, kBM);
      if constexpr (BK)
        load_op<TB, kBN, kBK>(Bs, ldb, g.b, pb, n0, g.N, ncolsL, k0, g.K, kBK);
      else
        load_op<TB, kBK, kBN>(Bs, ldb, g.b, pb, k0, g.K, kBK, n0, g.N, ncolsL);
    };
    auto fix = [&](int s) {
      float* As = sm + s * stage;
      float* Bs = As + kATile;
      if (fixA) {
        if constexpr (AK)
          fix_op<kBM, kBK>(As, kLdK, g.a, kBM, kBK);
        else
          fix_op<kBK, kBM>(As, kLdAM, g.a, kBK, kBM);
      }
      if (fixB) {
        if constexpr (BK)
          fix_op<kBN, kBK>(Bs, ldb, g.b, ncolsL, kBK);
        else
          fix_op<kBK, kBN>(Bs, ldb, g.b, kBK, ncolsL);
      }
    };

    float acc[kMaxNT][kMT][4];
#pragma unroll
    for (int t = 0; t < kMaxNT; ++t)
#pragma unroll
      for (int u = 0; u < kMT; ++u) acc[t][u][0] = acc[t][u][1] = acc[t][u][2] = acc[t][u][3] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();
      if (fixA || fixB) fix(kt % kStages);
      __syncthreads();
      if (kt + kStages - 1 < KT) load((kt + kStages - 1) % kStages, kt + kStages - 1);
      cp_async_commit();
      if (!live) continue;
      const float* As = sm + (kt % kStages) * stage;
      const float* Bs = As + kATile;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        if (kt * kBK + kk >= g.K) break;
        if (live2)
          mma_step<kMT, AK, BK>(acc, As, Bs, ldb, kk, wr, wn, gq, tq, nt, g.a.exact, g.b.exact);
        else
          mma_step<1, AK, BK>(acc, As, Bs, ldb, kk, wr, wn, gq, tq, nt, g.a.exact, g.b.exact);
      }
    }
    cp_async_wait<0>();
    __syncthreads();
    float* Cs = sm;
    if (live) {
#pragma unroll
      for (int t = 0; t < kMaxNT; ++t) {
        const int tile = wn + kWarpsN * t;
        if (t >= ntw) break;
#pragma unroll
        for (int u = 0; u < kMT; ++u) {
          float* c = Cs + (wr + 16 * u + gq) * kLdC + tile * 8 + 2 * tq;
          *reinterpret_cast<float2*>(c) = make_float2(acc[t][u][0], acc[t][u][1]);
          *reinterpret_cast<float2*>(c + 8 * kLdC) = make_float2(acc[t][u][2], acc[t][u][3]);
        }
      }
    }
    __syncthreads();
    epilogue<EPI, TO>(g, Cs, z, m0, n0, rows, ncols, rb);
    __syncthreads();  // the next batch's copies reuse the tile
  }
}

// The per-program buffers of the workspace (offsets and sizes in floats).
struct Buf {
  long long off, size;
};

// The pooled features of token i, [S_1..S_V, S_1^T..S_V^T, logC_fwd,
// logC_bwd] row means (RF) and column means (CF; the column sums of the
// score and log maps arrive as one partial sum per 64-row block), and the
// rank factors AF = RF wrow + brow (N x 4r), BF = CF wcol + bcol (stored
// transposed, 4r x N). One thread a (program, token).
__global__ void factors_kernel(const float* RM, const float* CMP, Buf rm, Buf cmp,
                               const float* wrow, const float* brow, const float* wcol,
                               const float* bcol, float* RF, float* CF, float* AF, float* BF,
                               Buf feat, Buf af_buf, Buf bf_buf, long long total, int V, int N,
                               int R4, int ldc, int ldn, int nrb) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / N;
  const int i = e % N, M = V + 2, C = 2 * V + 2;
  const float* rmp = RM + bh * rm.size;
  const float* cmpp = CMP + bh * cmp.size;
  float row[kMaxV + 2], col[kMaxV + 2];
  for (int m = 0; m < M; ++m) {
    row[m] = rmp[m * N + i];
    float s = 0.f;
    for (int b = 0; b < nrb; ++b) s += cmpp[((long long)m * nrb + b) * N + i];
    col[m] = s / N;
  }
  float rf[2 * kMaxV + 2], cf[2 * kMaxV + 2];
  for (int v = 0; v < V; ++v) {
    rf[v] = row[v];
    rf[V + v] = col[v];
    cf[v] = col[v];
    cf[V + v] = row[v];
  }
  rf[2 * V] = row[V];
  rf[2 * V + 1] = row[V + 1];
  cf[2 * V] = col[V];
  cf[2 * V + 1] = col[V + 1];
  float* rfp = RF + bh * feat.size + (long long)i * ldc;
  float* cfp = CF + bh * feat.size + (long long)i * ldc;
  for (int c = 0; c < C; ++c) {
    rfp[c] = rf[c];
    cfp[c] = cf[c];
  }
  float* afp = AF + bh * af_buf.size + (long long)i * R4;
  float* bfp = BF + bh * bf_buf.size + i;  // BF transposed: 4r rows of ldn
  for (int t = 0; t < R4; ++t) {
    float a = 0.f, b = 0.f;
    for (int c = 0; c < C; ++c) {
      a = fmaf(rf[c], wrow[c * R4 + t], a);
      b = fmaf(cf[c], wcol[c * R4 + t], b);
    }
    afp[t] = a + brow[t];
    bfp[(long long)t * ldn] = b + bcol[t];
  }
}

// Everything one edge (i, j) of the logit mix needs. S points at the
// program's first score map, `nn` floats a map; af at row i's rank factors
// (4r), bf at column j's (4r of them, ldn apart: BF is stored transposed so
// that the lanes' columns are read together). V is a template argument so
// that the views' scores stay in registers.
template <int V>
struct Edge {
  float s[V], s_sum, lse, mx, sumexp, g[4], lcf;
};

template <int V>
__device__ __forceinline__ void edge(Edge<V>& e, const float* S, long long nn, long long ij,
                                     const float* af, const float* bf, int ldn, int r,
                                     float fl) {
  e.s_sum = 0.f;
  e.mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    e.s[v] = S[v * nn + ij];
    e.s_sum = v ? e.s_sum + e.s[v] : e.s[v];
    e.mx = fmaxf(e.mx, e.s[v]);
  }
  e.sumexp = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) e.sumexp += expf(e.s[v] - e.mx);
  e.lse = e.mx + logf(e.sumexp);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float z = 0.f;
    for (int u = q * r; u < (q + 1) * r; ++u) z = fmaf(af[u], bf[(long long)u * ldn], z);
    e.g[q] = 1.f / (1.f + expf(-z));
  }
  e.lcf = logf(fl + 1e-6f);
}

template <int V>
__device__ __forceinline__ float edge_mix(const Edge<V>& e, float beta) {
  const float s1 = e.s[0], others = e.s_sum - s1;
  float smix = s1 + e.g[0] * others;
  smix = smix + e.g[1] * (e.lse - s1);
  smix = smix - e.g[2] * (beta * (others / max(1, V - 1)));
  return smix + e.g[3] * e.lcf;
}

// The maps the row kernels read: a program's V score maps, its c_fwd (the
// forward chain's last map), the rank factors AF (N x 4r) and BF (4r x N);
// maps are N rows of ldn.
struct Maps {
  const float* S;
  const float* FL;
  const float* AF;
  const float* BF;
  long long s_size, fl_size, af_size, bf_size, nn;
  int ldn;
};

// The gated logit mix of row i and its softmax: ATT. One warp a row.
template <int V>
__global__ void mix_fwd_kernel(Maps mp, float* ATT, long long att_size, long long rows, int N,
                               int r, float beta) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / N;
  const int i = row % N;
  const float* Sb = mp.S + bh * mp.s_size;
  const float* FLb = mp.FL + bh * mp.fl_size;
  const float* af = mp.AF + bh * mp.af_size + (long long)i * 4 * r;
  const float* bfb = mp.BF + bh * mp.bf_size;
  float* att = ATT + bh * att_size + (long long)i * mp.ldn;
  float x[8], m = -INFINITY;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    x[t] = -INFINITY;
    if (j < N) {
      Edge<V> e;
      const long long ij = (long long)i * mp.ldn + j;
      edge<V>(e, Sb, mp.nn, ij, af, bfb + j, mp.ldn, r, FLb[ij]);
      x[t] = edge_mix<V>(e, beta);
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
    if (lane + 32 * t < N) att[lane + 32 * t] = x[t] / sum;
}

// The backward of the mix and its softmax for row i: from datt (rounded as
// the cast of att rounds it) to d smix, then the gate-logit cotangents DZ_q
// = d g_q g_q (1 - g_q), the direct score cotangents DS_v (written, the
// first of their terms) and d log c_fwd (DL). Maps with the same per-program
// sizes: ATT, DATT (n1_size); DS (the score maps'); DZ (dz_size), DL (dl_size).
template <int V>
__global__ void mix_bwd_kernel(Maps mp, const float* ATT, const float* DATT, long long n1_size,
                               float* DS, float* DZ, long long dz_size, float* DL,
                               long long dl_size, long long rows, int N, int r, float beta,
                               int round) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long long bh = row / N, nn = mp.nn;
  const int i = row % N;
  const long long o = (long long)i * mp.ldn;
  const float* at_row = ATT + bh * n1_size + o;
  const float* da_row = DATT + bh * n1_size + o;
  float at[8], da[8], dot = 0.f;
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    at[t] = j < N ? at_row[j] : 0.f;
    da[t] = j < N ? (round ? rbf(da_row[j]) : da_row[j]) : 0.f;
    dot += at[t] * da[t];
  }
  dot = warp_sum(dot);
  const float* Sb = mp.S + bh * mp.s_size;
  const float* FLb = mp.FL + bh * mp.fl_size;
  float* DSb = DS + bh * mp.s_size;
  float* DZb = DZ + bh * dz_size;
  float* DLb = DL + bh * dl_size;
  const float* af = mp.AF + bh * mp.af_size + (long long)i * 4 * r;
  const float* bfb = mp.BF + bh * mp.bf_size;
  const float others_w = beta / max(1, V - 1);
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    const int j = lane + 32 * t;
    if (j >= N) continue;
    const long long ij = o + j;
    Edge<V> e;
    edge<V>(e, Sb, nn, ij, af, bfb + j, mp.ldn, r, FLb[ij]);
    const float ds = at[t] * (da[t] - dot);
    const float s1 = e.s[0], others = e.s_sum - s1;
    const float dg[4] = {ds * others, ds * (e.lse - s1), -ds * (beta * (others / max(1, V - 1))),
                         ds * e.lcf};
#pragma unroll
    for (int q = 0; q < 4; ++q) DZb[q * nn + ij] = dg[q] * e.g[q] * (1.f - e.g[q]);
    const float dlse = ds * e.g[1];
    const float d_others = ds * (e.g[0] - e.g[2] * others_w);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const float p = expf(e.s[v] - e.mx) / e.sumexp;
      DSb[v * nn + ij] = (v ? d_others : ds * (1.f - e.g[1])) + dlse * p;
    }
    DLb[ij] = ds * e.g[3];
  }
}

// The row kernels below take a row's columns four at a time (16-byte
// accesses; a row of ldn floats, so the last four may reach into its
// padding, which no stage reads): lane l the columns 4 (l + 32 t), t < 2.
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ float& at4(float4& v, int k) { return (&v.x)[k]; }

// The log maps' share of the means' backward: from the row- and
// column-mean cotangents of log c_fwd and log c_bwd (channels 2V, 2V+1 of
// DRF, DCF: C x N a program, rows of ldn), d c_fwd = d log c_fwd / (c_fwd +
// 1e-6) in place of DL and d c_bwd in the map after it (nn floats on). c_bwd
// is bl_off floats after c_fwd. One thread four edges of a row.
__global__ void means_bwd_kernel(const float* DRF, const float* DCF, long long feat_size,
                                 float* DL, long long dl_size, const float* FL, long long fl_size,
                                 long long nn, long long bl_off, int ldn, long long total, int V,
                                 int N) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int nc = ldn / 4;
  const long long bh = e / ((long long)N * nc);
  const int i = (e / nc) % N, j0 = 4 * (e % nc);
  const float* drf = DRF + bh * feat_size + 2LL * V * ldn;  // channel 2V, then 2V + 1
  const float* dcf = DCF + bh * feat_size + 2LL * V * ldn;
  const long long at = (long long)i * ldn + j0;
  float* dl = DL + bh * dl_size + at;
  const float* fl = FL + bh * fl_size + at;
  float4 d = ld4(dl), db;
  const float4 f = ld4(fl), b = ld4(fl + bl_off), c = ld4(dcf + j0), cb = ld4(dcf + ldn + j0);
  const float ri = drf[i], rib = drf[ldn + i];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    at4(d, k) = (at4(d, k) + ri / N + (&c.x)[k] / N) / ((&f.x)[k] + 1e-6f);
    at4(db, k) = (rib / N + (&cb.x)[k] / N) / ((&b.x)[k] + 1e-6f);
  }
  st4(dl, d);
  st4(dl + nn, db);
}

// The score softmaxes' VJP with the means' share of the score cotangents:
// DS_v += (row and column mean cotangents of S_v, channels v and V + v of
// DRF, DCF (C x N, rows of ldn), spread over the map) +
// A_v (c(dA_v) - rowsum(c(dA_v) A_v)), one warp a row of every view's maps.
__global__ void softmax_vjp_kernel(const float* A, const float* DA, float* DS, long long s_size,
                                   const float* DRF, const float* DCF, long long feat_size,
                                   long long rows, int V, int N, int ldn, int round) {
  const long long row = blockIdx.x * (long long)kRowsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int i = row % N, v = (row / N) % V;
  const long long bh = row / ((long long)N * V);
  const long long o = bh * s_size + ((long long)v * N + i) * ldn;
  const float* drf = DRF + bh * feat_size;
  const float* dcf = DCF + bh * feat_size;
  const float* drf_v = drf + (long long)v * ldn, *dcf_v = dcf + (long long)v * ldn;
  const float* drf_vv = drf + (long long)(V + v) * ldn, *dcf_vv = dcf + (long long)(V + v) * ldn;
  const float ri = (drf_v[i] + dcf_vv[i]) / N;
  float4 a[2], da[2];
  float dot = 0.f;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j0 = 4 * (lane + 32 * t);
    a[t] = da[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j0 < N) {
      const float4 x = ld4(A + o + j0), y = ld4(DA + o + j0);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (j0 + k >= N) break;
        at4(a[t], k) = (&x.x)[k];
        at4(da[t], k) = round ? rbf((&y.x)[k]) : (&y.x)[k];
        dot += at4(a[t], k) * at4(da[t], k);
      }
    }
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int j0 = 4 * (lane + 32 * t);
    if (j0 >= N) continue;
    float4 ds = ld4(DS + o + j0);
    const float4 c1 = ld4(drf_vv + j0), c2 = ld4(dcf_v + j0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float rj = ((&c1.x)[k] + (&c2.x)[k]) / N;
      at4(ds, k) = (at4(ds, k) + (ri + rj)) + at4(a[t], k) * (at4(da[t], k) - dot);
    }
    st4(DS + o + j0, ds);
  }
}

// Column sums of a program's N x R4 factor cotangents: the bias grads.
__global__ void colsum_kernel(const float* X, long long x_size, float* out, long long total,
                              int N, int R4) {
  const long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (e >= total) return;
  const long long bh = e / R4;
  const int t = e % R4;
  float s = 0.f;
  for (int i = 0; i < N; ++i) s += X[bh * x_size + (long long)i * R4 + t];
  out[e] = s;
}

// dchain[bh] = sum(dy * P0), P0 = c(A_0) c(pt_1) (N x dk fp32, row stride
// ldd). One block a program.
template <class T>
__global__ void dchain_kernel(const T* dy, long long sb, long long sh, long long srow,
                              const float* P0, long long p0_size, int ldd, float* dch, int H,
                              int N, int dk) {
  const long long bh = blockIdx.x;
  const long long o = (bh / H) * sb + (bh % H) * sh;
  float s = 0.f;
  for (int e = threadIdx.x; e < N * dk; e += blockDim.x) {
    const int i = e / dk, d = e % dk;
    s += to_f<T>(dy[o + i * srow + d]) * P0[bh * p0_size + (long long)i * ldd + d];
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

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// The per-program buffers of the workspace, each a multiple of four floats
// (so that every buffer and every program's share is 16-byte aligned). N x N
// maps have rows of ldn = round4(N) floats, N x dk ones of ldd, the pooled
// features of ldc = round4(2V + 2); the column factors and the features'
// cotangents are stored transposed, rows of ldn.
struct Layout {
  long long ldn, ldd, ldc, nn, nd;
  int nrb;
  Buf S, A, CH, RM, CMP, RF, CF, AF, BF, ATT, PT, Y0;       // forward
  Buf DATT, DAC, DS, DZ, DL, DP, DAF, DBF, DRF, DCF;        // backward
  long long fwd_total, bwd_total;
};

inline Layout layout(int V, int N, int dk, int r) {
  Layout l;
  l.ldn = round4(N), l.ldd = round4(dk), l.ldc = round4(2 * V + 2);
  l.nn = N * l.ldn, l.nd = N * l.ldd;
  l.nrb = (N + kBM - 1) / kBM;
  const long long nn = l.nn, nd = l.nd, R4 = 4 * r;
  long long at = 0;
  auto take = [&](long long n) {
    const Buf b{at, round4(n)};
    at += b.size;
    return b;
  };
  l.S = take(V * nn);
  l.A = take(V * nn);
  l.CH = take(2 * (V - 1) * nn);  // the forward chain's V - 1 maps, then the backward one's
  l.RM = take((V + 2) * (long long)N);
  l.CMP = take((V + 2) * (long long)l.nrb * N);
  l.RF = take(N * l.ldc);
  l.CF = take(N * l.ldc);
  l.AF = take(N * R4);
  l.BF = take(R4 * l.ldn);  // transposed: 4r rows of ldn
  l.ATT = take(nn);
  l.PT = take((V - 1) * nd);
  l.Y0 = take(nd);
  l.fwd_total = at;
  l.DATT = take(nn);
  l.DAC = take(V * nn);
  l.DS = take(V * nn);
  l.DZ = take(4 * nn);
  l.DL = take(2 * nn);  // d c_fwd, then d c_bwd
  l.DP = take(2 * nd);
  l.DAF = take(N * R4);
  l.DBF = take(N * R4);
  l.DRF = take((2 * V + 2) * l.ldn);  // channel-major: C x N, rows of ldn
  l.DCF = take((2 * V + 2) * l.ldn);
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
  long long BH;
  float* ws;
  Layout l;
  cudaStream_t st;
  cudaError_t err = cudaSuccess;

  float* buf(const Buf& b) const { return ws + BH * b.off; }
};

// An operand; 16-byte copies where the address and every stride allow them.
inline Operand make_op(const void* p, int esize, long long off, long long s0, long long s1,
                       long long s2, long long ld, float scale, int round, bool bf_input) {
  const int w = 16 / esize;
  const bool vec = (uintptr_t)p % 16 == 0 && off % w == 0 && s0 % w == 0 && s1 % w == 0 &&
                   s2 % w == 0 && ld % w == 0;
  return Operand{p, off, s0, s1, s2, ld, scale, round, vec ? 1 : 0,
                 (round || (bf_input && scale == 1.f)) ? 1 : 0};
}

// A workspace buffer of `b.size` floats a program as an operand: `inner`
// floats between the inner batch index's matrices, row stride ld.
inline Operand wop(const Run& R, const float* p, const Buf& b, long long inner, long long ld,
                   int round = 0) {
  return make_op(p, 4, 0, R.H * b.size, b.size, inner, ld, 1.f, round, false);
}

inline Out wout(const Run& R, float* p, const Buf& b, long long inner, long long ld) {
  return Out{p, 0, R.H * b.size, b.size, inner, ld};
}

// An input tensor with (b, h, view, row) strides st[0..3] and a unit
// feature stride: view `view` of each program, or (per_view) every view as
// the inner batch index.
template <class T>
inline Operand in_op(const T* p, const long long* st, int view, bool per_view, float scale = 1.f,
                     int round = 0) {
  return make_op(p, sizeof(T), view * st[2], st[0], st[1], per_view ? st[2] : 0, st[3], scale,
                 round, std::is_same<T, __nv_bfloat16>::value);
}

template <class T>
inline Out in_out(T* p, const long long* st, int view, bool per_view) {
  return Out{p, view * st[2], st[0], st[1], per_view ? st[2] : 0, st[3]};
}

const Out kNoOut = {nullptr, 0, 0, 0, 0, 0};

inline Gemm gemm_of(const Run& R, int inner, int M, int N, int K, Operand a, Operand b, Out out) {
  Gemm g;
  g.a = a, g.b = b, g.out = out;
  g.out2 = g.cin = g.rm = g.cmp = kNoOut;
  g.M = M, g.N = N, g.K = K;
  g.Z = (int)(R.BH * inner), g.d1 = R.H, g.d2 = inner;
  g.alpha = 1.f, g.alpha_ptr = nullptr, g.round_acc = 0;
  return g;
}

// The kernels this library has launched since it was loaded, each launch
// once (`mop_edgewise_wide_launches`: a profile's kernel records are held
// to it).
static std::atomic<long long> g_launches{0};

template <bool AK, bool BK, class TA, class TB, int EPI = kStore, class TO = float>
void launch(Run& R, const Gemm& g) {
  if (R.err != cudaSuccess) return;
  auto kernel = mm_kernel<AK, BK, TA, TB, EPI, TO>;
  // The shared-memory limit is set once an instantiation and device (bit
  // `dev` of `limit_set`), not before each launch.
  static std::atomic<unsigned long long> limit_set{0};
  int dev = 0;
  R.err = cudaGetDevice(&dev);
  if (R.err != cudaSuccess) return;
  const unsigned long long bit = 1ull << (dev & 63);
  if (!(limit_set.load(std::memory_order_relaxed) & bit)) {
    R.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem_bytes(kBN));
    if (R.err != cudaSuccess) return;
    limit_set.fetch_or(bit, std::memory_order_relaxed);
  }
  const int nrb = (g.M + kBM - 1) / kBM, ncb = (g.N + kBN - 1) / kBN;
  const int ncols8 = ((g.N < kBN ? g.N : kBN) + 7) & ~7;
  dim3 grid(nrb * ncb, g.Z < 65535 ? g.Z : 65535);
  kernel<<<grid, kThreads, smem_bytes(ncols8), R.st>>>(g);
  g_launches.fetch_add(1, std::memory_order_relaxed);
  R.err = cudaGetLastError();
}

// A two-chain launch (inner index 2: the forward chain, then the backward
// one) as one launch per chain, for steps where both chains write the same
// map.
template <bool AK, bool BK>
void launch_each_chain(Run& R, Gemm g) {
  for (int c = 0; c < 2; ++c) {
    Gemm gc = g;
    gc.d2 = 1, gc.Z = (int)R.BH;
    for (Operand* o : {&gc.a, &gc.b}) o->off += c * o->s2, o->s2 = 0;
    for (Out* o : {&gc.out, &gc.cin}) o->off += c * o->s2, o->s2 = 0;
    launch<AK, BK, float, float>(R, gc);
  }
}

inline int row_blocks(long long rows) { return (int)((rows + kRowsPerBlock - 1) / kRowsPerBlock); }
inline int blocks(long long n, int t) { return (int)((n + t - 1) / t); }

// After each row kernel's launch: counts it and keeps its launch error.
inline void launched(Run& R) {
  g_launches.fetch_add(1, std::memory_order_relaxed);
  if (R.err == cudaSuccess) R.err = cudaGetLastError();
}

// f(std::integral_constant<int, V>) for the run's view count (2..8).
template <class F>
void with_views(int V, F f) {
  switch (V) {
    case 2: f(std::integral_constant<int, 2>()); break;
    case 3: f(std::integral_constant<int, 3>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 5: f(std::integral_constant<int, 5>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    case 7: f(std::integral_constant<int, 7>()); break;
    default: f(std::integral_constant<int, 8>()); break;
  }
}

inline float score_scale(const Run& R, float scale) {
  return R.bf ? __bfloat162float(__float2bfloat16(scale)) : scale;
}

inline Maps maps(const Run& R) {
  const Layout& l = R.l;
  return Maps{R.buf(l.S), R.buf(l.CH) + (R.V - 2) * l.nn, R.buf(l.AF), R.buf(l.BF), l.S.size,
              l.CH.size,  l.AF.size, l.BF.size, l.nn, (int)l.ldn};
}

// The forward's stages into the workspace: the scores with their softmaxes
// and means, both chains with the log maps' means, the factors, att and the
// transports; then, unless `y` is null, y = c(att) v_0 + w c(A_0) c(pt_1).
template <class T>
void forward(Run& R, const T* q, const T* k, const T* v, const long long* st,
             const float* const* w, float beta, float scale, T* y) {
  const Layout& l = R.l;
  const int V = R.V, N = R.N, dk = R.dk, r = R.r, rd = R.bf;
  const long long nn = l.nn, nd = l.nd, ldn = l.ldn, ldd = l.ldd;
  const long long *sq = st, *sk = st + 4, *sv = st + 8;
  float* S = R.buf(l.S);
  float* A = R.buf(l.A);
  float* CH = R.buf(l.CH);
  float* RM = R.buf(l.RM);
  float* CMP = R.buf(l.CMP);
  float* ATT = R.buf(l.ATT);
  float* PT = R.buf(l.PT);
  const long long cmp_map = (long long)l.nrb * N;
  // S_v = c(q_v sc) k_v^T with its softmax A_v and the means' sums.
  {
    Gemm g = gemm_of(R, V, N, N, dk, in_op(q, sq, 0, true, score_scale(R, scale), rd),
                     in_op(k, sk, 0, true), wout(R, S, l.S, nn, ldn));
    g.out2 = wout(R, A, l.A, nn, ldn);
    g.rm = wout(R, RM, l.RM, N, 0);
    g.cmp = wout(R, CMP, l.CMP, cmp_map, 0);
    launch<true, true, T, T, kSoftmax>(R, g);
  }
  // Both chains a step: c_fwd = c(A_0) c(A_1) ..., c_bwd = c(A_{V-1})
  // c(A_{V-2}) ...; step j's right factor is view j (forward) or V-1-j.
  const long long chain = (V - 1) * nn;
  for (int j = 1; j < V; ++j) {
    const Operand left = j == 1 ? wop(R, A, l.A, chain, ldn, rd)
                                : wop(R, CH + (j - 2) * nn, l.CH, chain, ldn, rd);
    const Operand right = wop(R, A + j * nn, l.A, (V - 1 - 2 * j) * nn, ldn, rd);
    Gemm g = gemm_of(R, 2, N, N, N, left, right, wout(R, CH + (j - 1) * nn, l.CH, chain, ldn));
    if (j < V - 1) {
      launch<true, false, float, float>(R, g);
    } else {
      g.rm = wout(R, RM + V * N, l.RM, N, 0);
      g.cmp = wout(R, CMP + V * cmp_map, l.CMP, cmp_map, 0);
      launch<true, false, float, float, kLogMeans>(R, g);
    }
  }
  if (R.err != cudaSuccess) return;
  factors_kernel<<<blocks(R.BH * N, 128), 128, 0, R.st>>>(
      RM, CMP, l.RM, l.CMP, w[0], w[1], w[2], w[3], R.buf(l.RF), R.buf(l.CF), R.buf(l.AF),
      R.buf(l.BF), l.RF, l.AF, l.BF, R.BH * N, V, N, 4 * r, (int)l.ldc, (int)l.ldn, l.nrb);
  launched(R);
  with_views(V, [&](auto views) {
    mix_fwd_kernel<decltype(views)::value><<<row_blocks(R.BH * N), 256, 0, R.st>>>(
        maps(R), ATT, l.ATT.size, R.BH * N, N, r, beta);
  });
  launched(R);
  // pt_{V-1} = c(A_{V-1}) v_{V-1}; pt_i = c(A_i) c(pt_{i+1}); PT[i-1] holds pt_i.
  auto amap = [&](int i) { return wop(R, A + i * nn, l.A, 0, ldn, rd); };
  auto ptm = [&](int i) { return wop(R, PT + (i - 1) * nd, l.PT, 0, ldd, rd); };
  auto pto = [&](int i) { return wout(R, PT + (i - 1) * nd, l.PT, 0, ldd); };
  launch<true, false, float, T>(
      R, gemm_of(R, 1, N, dk, N, amap(V - 1), in_op(v, sv, V - 1, false), pto(V - 1)));
  for (int i = V - 2; i >= 1; --i)
    launch<true, false, float, float>(R, gemm_of(R, 1, N, dk, N, amap(i), ptm(i + 1), pto(i)));
  if (!y) return;
  float* Y0 = R.buf(l.Y0);
  launch<true, false, float, T>(R, gemm_of(R, 1, N, dk, N, wop(R, ATT, l.ATT, 0, ldn, rd),
                                           in_op(v, sv, 0, false), wout(R, Y0, l.Y0, 0, ldd)));
  const long long so[4] = {st[12], st[13], 0, st[14]};
  Gemm g = gemm_of(R, 1, N, dk, N, amap(0), ptm(1), in_out(y, so, 0, false));
  g.cin = wout(R, Y0, l.Y0, 0, ldd);
  g.alpha_ptr = w[4];
  launch<true, false, float, float, kStore, T>(R, g);
}

template <class T>
void backward(Run& R, const T* q, const T* k, const T* v, const T* dy, const long long* st,
              const float* const* w, float beta, float scale, T* dq, T* dk_out, T* dv,
              float* const* dw) {
  forward(R, q, k, v, st, w, beta, scale, (T*)nullptr);
  if (R.err != cudaSuccess) return;
  const Layout& l = R.l;
  const int V = R.V, N = R.N, dk = R.dk, r = R.r, rd = R.bf, R4 = 4 * r;
  const int C = 2 * V + 2;
  const long long nn = l.nn, nd = l.nd, ldn = l.ldn, ldd = l.ldd, ldc = l.ldc;
  const long long *sq = st, *sk = st + 4, *sv = st + 8;
  const long long sdy[4] = {st[12], st[13], 0, st[14]};
  // dq, dk and dv are contiguous (B, H, V, N, dk).
  const long long sg[4] = {(long long)R.H * V * N * dk, (long long)V * N * dk, (long long)N * dk,
                           dk};
  float* A = R.buf(l.A);
  float* CH = R.buf(l.CH);
  float* ATT = R.buf(l.ATT);
  float* PT = R.buf(l.PT);
  float* Y0 = R.buf(l.Y0);
  float* DATT = R.buf(l.DATT);
  float* DAC = R.buf(l.DAC);
  float* DS = R.buf(l.DS);
  float* DZ = R.buf(l.DZ);
  float* DL = R.buf(l.DL);
  float* DP = R.buf(l.DP);
  float* AF = R.buf(l.AF);
  float* BF = R.buf(l.BF);
  float* DAF = R.buf(l.DAF);
  float* DBF = R.buf(l.DBF);
  float* DRF = R.buf(l.DRF);
  float* DCF = R.buf(l.DCF);
  auto amap = [&](int i) { return wop(R, A + i * nn, l.A, 0, ldn, rd); };
  auto dac = [&](int i) { return wout(R, DAC + i * nn, l.DAC, 0, ldn); };
  auto ptm = [&](int i) { return wop(R, PT + (i - 1) * nd, l.PT, 0, ldd, rd); };
  auto dpm = [&](int i, int round) { return wop(R, DP + i * nd, l.DP, 0, ldd, round); };
  const Operand dyo = in_op(dy, sdy, 0, false);
  const float* chain_w = w[4];

  // The value paths: P0 = c(A_0) c(pt_1) and dchain = sum(dy P0); dv_0 =
  // c(att)^T dy; datt = dy v_0^T (rounded where read); dA_0 = w dy c(pt_1)^T.
  launch<true, false, float, float>(
      R, gemm_of(R, 1, N, dk, N, amap(0), ptm(1), wout(R, Y0, l.Y0, 0, ldd)));
  if (R.err != cudaSuccess) return;
  dchain_kernel<T><<<(unsigned)R.BH, 256, 0, R.st>>>(dy, st[12], st[13], st[14], Y0, l.Y0.size,
                                                     (int)ldd, dw[4], R.H, N, dk);
  launched(R);
  launch<false, false, float, T, kStore, T>(
      R, gemm_of(R, 1, N, dk, N, wop(R, ATT, l.ATT, 0, ldn, rd), dyo, in_out(dv, sg, 0, false)));
  launch<true, true, T, T>(R, gemm_of(R, 1, N, N, dk, dyo, in_op(v, sv, 0, false),
                                      wout(R, DATT, l.DATT, 0, ldn)));
  {
    Gemm g = gemm_of(R, 1, N, N, dk, dyo, ptm(1), dac(0));
    g.alpha_ptr = chain_w;
    launch<true, true, T, float>(R, g);
  }
  // The transport's backward: dp = c(w c(A_0)^T dy), then for i = 1..V-1
  // dA_i = c(dp) c(pt_{i+1})^T and dp <- c(A_i)^T c(dp); the last is dv_{V-1}.
  {
    Gemm g = gemm_of(R, 1, N, dk, N, amap(0), dyo, wout(R, DP, l.DP, 0, ldd));
    g.alpha_ptr = chain_w;
    launch<false, false, float, T>(R, g);
  }
  int cur = 0;
  for (int i = 1; i < V; ++i) {
    if (i + 1 == V) {
      launch<true, true, float, T>(
          R, gemm_of(R, 1, N, N, dk, dpm(cur, rd), in_op(v, sv, V - 1, false), dac(i)));
      launch<false, false, float, float, kStore, T>(
          R, gemm_of(R, 1, N, dk, N, amap(i), dpm(cur, rd), in_out(dv, sg, V - 1, false)));
    } else {
      launch<true, true, float, float>(
          R, gemm_of(R, 1, N, N, dk, dpm(cur, rd), ptm(i + 1), dac(i)));
      launch<false, false, float, float>(
          R, gemm_of(R, 1, N, dk, N, amap(i), dpm(cur, rd),
                     wout(R, DP + (1 - cur) * nd, l.DP, 0, ldd)));
    }
    cur = 1 - cur;
  }
  if (R.err != cudaSuccess) return;
  // The mix: DS_v (first terms), DZ_q and d log c_fwd.
  with_views(V, [&](auto views) {
    mix_bwd_kernel<decltype(views)::value><<<row_blocks(R.BH * N), 256, 0, R.st>>>(
        maps(R), ATT, DATT, l.ATT.size, DS, DZ, l.DZ.size, DL, l.DL.size, R.BH * N, N, r, beta,
        rd);
  });
  launched(R);
  // The factors: dAF_q = DZ_q BF_q, dBF_q = DZ_q^T AF_q (rank-r column slices).
  auto fac = [&](float* p, const Buf& b) { return wop(R, p, b, r, R4); };
  auto faco = [&](float* p, const Buf& b) { return wout(R, p, b, r, R4); };
  launch<true, true, float, float>(  // BF is stored transposed: k-contiguous
      R, gemm_of(R, 4, N, r, N, wop(R, DZ, l.DZ, nn, ldn), wop(R, BF, l.BF, r * ldn, ldn),
                 faco(DAF, l.DAF)));
  launch<false, false, float, float>(
      R, gemm_of(R, 4, N, r, N, wop(R, DZ, l.DZ, nn, ldn), fac(AF, l.AF), faco(DBF, l.DBF)));
  // The head: dRF^T = wrow dAF^T, dCF^T = wcol dBF^T (channel-major, so that
  // the means' terms read them along the tokens); dwrow = RF^T dAF, dwcol =
  // CF^T dBF per program; the bias grads are dAF's and dBF's column sums.
  auto head = [&](const float* p) { return make_op(p, 4, 0, 0, 0, 0, R4, 1.f, 0, false); };
  auto feat = [&](float* p, const Buf& b) { return wop(R, p, b, 0, ldc); };
  auto dwm = [&](float* p) {
    return Out{p, 0, (long long)R.H * C * R4, (long long)C * R4, 0, R4};
  };
  launch<true, true, float, float>(R, gemm_of(R, 1, C, N, R4, head(w[0]), wop(R, DAF, l.DAF, 0, R4),
                                              wout(R, DRF, l.DRF, 0, ldn)));
  launch<true, true, float, float>(R, gemm_of(R, 1, C, N, R4, head(w[2]), wop(R, DBF, l.DBF, 0, R4),
                                              wout(R, DCF, l.DCF, 0, ldn)));
  launch<false, false, float, float>(
      R, gemm_of(R, 1, C, R4, N, feat(R.buf(l.RF), l.RF), wop(R, DAF, l.DAF, 0, R4), dwm(dw[0])));
  launch<false, false, float, float>(
      R, gemm_of(R, 1, C, R4, N, feat(R.buf(l.CF), l.CF), wop(R, DBF, l.DBF, 0, R4), dwm(dw[2])));
  if (R.err != cudaSuccess) return;
  colsum_kernel<<<blocks(R.BH * R4, 128), 128, 0, R.st>>>(DAF, l.DAF.size, dw[1], R.BH * R4, N,
                                                          R4);
  launched(R);
  colsum_kernel<<<blocks(R.BH * R4, 128), 128, 0, R.st>>>(DBF, l.DBF.size, dw[3], R.BH * R4, N,
                                                          R4);
  launched(R);
  means_bwd_kernel<<<blocks(R.BH * N * (ldn / 4), 256), 256, 0, R.st>>>(
      DRF, DCF, l.DRF.size, DL, l.DL.size, CH + (V - 2) * nn, l.CH.size, nn,
      (V - 1) * nn, (int)ldn, R.BH * N * (ldn / 4), V, N);
  launched(R);
  // Both chains backward, a launch a step, from d c_fwd and d c_bwd (DL and
  // the map after it, updated in place). Chain c's step j has left factor
  // c(chain_{c,j-1}) and view j (c = 0) or V-1-j (c = 1).
  const long long chain = (V - 1) * nn;
  auto dmap = [&](int round) { return wop(R, DL, l.DL, nn, ldn, round); };
  auto view = [&](int j) { return wop(R, A + j * nn, l.A, (V - 1 - 2 * j) * nn, ldn, rd); };
  auto dview = [&](int j) { return wout(R, DAC + j * nn, l.DAC, (V - 1 - 2 * j) * nn, ldn); };
  for (int j = V - 1; j >= 2; --j) {
    const int rdd = j < V - 1 ? rd : 0;  // d c_fwd and d c_bwd enter unrounded
    Gemm g = gemm_of(R, 2, N, N, N, wop(R, CH + (j - 2) * nn, l.CH, chain, ldn, rd), dmap(rdd),
                     dview(j));
    g.cin = dview(j);
    if (2 * j == V - 1)
      launch_each_chain<false, false>(R, g);
    else
      launch<false, false, float, float>(R, g);
    launch<true, true, float, float>(
        R, gemm_of(R, 2, N, N, N, dmap(rdd), view(j), wout(R, DL, l.DL, nn, ldn)));
  }
  {
    const int rdd = V > 2 ? rd : 0;
    Gemm g = gemm_of(R, 2, N, N, N, dmap(rdd), view(1), dview(0));
    g.cin = dview(0);
    launch<true, true, float, float>(R, g);
    g = gemm_of(R, 2, N, N, N, view(0), dmap(rdd), dview(1));
    g.cin = dview(1);
    if (V == 3)
      launch_each_chain<false, false>(R, g);
    else
      launch<false, false, float, float>(R, g);
  }
  if (R.err != cudaSuccess) return;
  // The score softmaxes (with the means' terms), then dq_v = c(c(dS_v k_v)
  // sc) and dk_v = dS_v^T c(q_v sc).
  softmax_vjp_kernel<<<row_blocks(R.BH * V * N), 256, 0, R.st>>>(
      A, DAC, DS, l.S.size, DRF, DCF, l.DRF.size, R.BH * V * N, V, N, (int)ldn, rd);
  launched(R);
  const float sc = score_scale(R, scale);
  const Operand ds = wop(R, DS, l.DS, nn, ldn);
  {
    Gemm g = gemm_of(R, V, N, dk, N, ds, in_op(k, sk, 0, true), in_out(dq, sg, 0, true));
    g.alpha = sc;
    g.round_acc = rd;
    launch<true, false, float, T, kStore, T>(R, g);
  }
  launch<false, false, float, T, kStore, T>(
      R, gemm_of(R, V, N, dk, N, ds, in_op(q, sq, 0, true, sc, rd), in_out(dk_out, sg, 0, true)));
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

// Kernels launched by K2w and K2bw since the library was loaded.
extern "C" long long mop_edgewise_wide_launches() { return mop::wide::g_launches.load(); }

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
  if (dtype == 0)
    mop::wide::forward(R, (const float*)qs, (const float*)ks, (const float*)vs, strides, w,
                       beta_not, scale, (float*)out);
  else
    mop::wide::forward(R, (const __nv_bfloat16*)qs, (const __nv_bfloat16*)ks,
                       (const __nv_bfloat16*)vs, strides, w, beta_not, scale,
                       (__nv_bfloat16*)out);
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
  using bf = __nv_bfloat16;
  if (dtype == 0)
    mop::wide::backward(R, (const float*)qs, (const float*)ks, (const float*)vs,
                        (const float*)dy, strides, w, beta_not, scale, (float*)dq,
                        (float*)dk_out, (float*)dv, dw);
  else
    mop::wide::backward(R, (const bf*)qs, (const bf*)ks, (const bf*)vs, (const bf*)dy, strides,
                        w, beta_not, scale, (bf*)dq, (bf*)dk_out, (bf*)dv, dw);
  return (int)R.err;
}
