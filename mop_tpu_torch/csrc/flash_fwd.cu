// K1: blockwise flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_flash_fwd_kernel` / `_flash_forward` in
// mop_tpu/ops/fused.py: softmax(Q K^T * scale [causal]) V with an online
// softmax over 64-key blocks, fp32 statistics and an fp32 accumulator. Masks
// and guards follow the TPU kernel: keys at or beyond `nkv` are masked, the
// causal mask is row >= col, and a row whose running max is still -inf
// contributes nothing.
//
// Bound on this card: at the ViT shape (BH, N, dk) = (1024, 64, 56) each
// (b*h) program reads its Q, K and V once and writes O once (16 N dk bytes
// in fp32) against 4 N^2 dk flops, so the kernel is bound by device-memory
// bytes, and a single program is too small to hide its own load latency.
// The design therefore keeps loads in flight:
//
// - A persistent grid (about the blocks that fit on the SMs at once) walks
//   over the (b*h, 64-row query block) tiles and, within each tile, over its
//   64-key blocks. `cp.async` fills the second of two shared-memory stages
//   with the next work item's K and V (and the next tile's Q) while the
//   current item computes; long sequences stream their key blocks through
//   the same ring. The copy width (16, 8 or 4 bytes) comes from the
//   pointers' and strides' alignment, computed by the Python wrapper.
// - bf16 runs on the tensor cores: four warps each own 16 query rows,
//   S = Q K^T and P V are `mma.sync.m16n8k16` with fp32 accumulation, S
//   stays in its accumulator fragment (row max and sum by quad shuffles),
//   and the unnormalised P is rounded to bf16 in registers and fed straight
//   back as the A operand of P V, as the TPU kernel casts p before its dot.
//   dk is zero-padded to a multiple of 16 in shared memory; only dk columns
//   are written. (`mma.sync` rather than `wgmma`: a 64-row tile is one
//   warp group's single m64 instruction, but with P fed from registers and
//   N = 64 the per-warp m16 tiles keep every step inside one warp, with no
//   warp-group barriers.)
// - fp32 stays true fp32 (the JAX kernel asks for HIGHEST on fp32
//   operands): the products run on CUDA cores, 256 threads each owning a
//   4 x 4 tile, reading Q and K rows as float4 (rows padded to a stride of 4
//   mod 8 floats, conflict-free per quarter warp), and the accumulator holds
//   only ceil(dk / 16) columns a thread.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace mop {

constexpr int kMaxDk = 128;
constexpr int kBlock = 64;        // query rows of a tile and keys of a block
constexpr int kThreadsBf16 = 128;  // four warps, 16 query rows each
constexpr int kThreadsF32 = 256;   // 16 x 16 threads, 4 x 4 tiles

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int BH, H, N, Nkv, dk, causal, vec;  // vec: copy width in bytes
  float scale;
  long long st[12];  // (batch, head, row) strides of q, k, v, o
};

// Shared-memory row stride (elements) of the Q, K and V stages.
template <typename T>
__host__ __device__ __forceinline__ int stage_ld(int dk) {
  if constexpr (sizeof(T) == 2) return mma_ld(dk);
  return ((dk + 7) & ~7) + 4;  // float4 rows, a stride of 4 mod 8: odd in 16-byte units
}

template <typename T>
__host__ __device__ __forceinline__ size_t flash_smem_bytes(int dk) {
  const size_t tile = (size_t)kBlock * stage_ld<T>(dk) * sizeof(T);
  size_t bytes = 6 * tile;  // two stages of Q, K and V
  if constexpr (sizeof(T) == 4) bytes += sizeof(float) * kBlock * (kBlock + 1);  // P
  return bytes;
}

// Key blocks of query tile `qb`.
__device__ __forceinline__ int kv_blocks(const FlashArgs& a, int qb) {
  int n = (a.Nkv + kBlock - 1) / kBlock;
  if (a.causal) n = min(n, (qb * kBlock + 2 * kBlock - 1) / kBlock);
  return n;
}

// The persistent walk: tile `t` (b*h major, query block minor) and key block `kb`.
struct Item {
  int t, kb;
};

__device__ __forceinline__ bool next_item(const FlashArgs& a, int n_qb, int n_tiles, Item& it) {
  if (++it.kb < kv_blocks(a, it.t % n_qb)) return true;
  it.kb = 0;
  it.t += gridDim.x;
  return it.t < n_tiles;
}

// Start the copies of one item: K and V of its key block and, at the first
// key block of a tile, the tile's Q.
template <typename T, int kThr>
__device__ __forceinline__ void issue_item(const FlashArgs& a, int n_qb, const Item& it, T* Qs,
                                           T* Ks, T* Vs, int ld) {
  const int bh = it.t / n_qb, qb = it.t - bh * n_qb;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x;
  if (it.kb == 0) {
    const int q0 = qb * kBlock;
    const T* qp = (const T*)a.q + b * a.st[0] + h * a.st[1] + (long long)q0 * a.st[2];
    copy_rows_async(Qs, ld, qp, a.st[2], kBlock, min(kBlock, a.N - q0), a.dk, a.vec, tid, kThr);
  }
  const int k0 = it.kb * kBlock, valid = min(kBlock, a.Nkv - k0);
  const T* kp = (const T*)a.k + b * a.st[3] + h * a.st[4] + (long long)k0 * a.st[5];
  const T* vp = (const T*)a.v + b * a.st[6] + h * a.st[7] + (long long)k0 * a.st[8];
  copy_rows_async(Ks, ld, kp, a.st[5], kBlock, valid, a.dk, a.vec, tid, kThr);
  copy_rows_async(Vs, ld, vp, a.st[8], kBlock, valid, a.dk, a.vec, tid, kThr);
  cp_async_commit();
}

// --------------------------- bf16: tensor cores ---------------------------

template <int kDkp>  // dk padded to 64 or 128
struct Bf16State {
  static constexpr int kKs = kDkp / 16;  // k-steps over dk
  static constexpr int kNt = kDkp / 8;   // output n-tiles
  unsigned qf[kKs][4];                   // Q's A fragments, per tile
  float o[kNt][4];                       // the accumulator
  float m[2], l[2];                      // rows g and g + 8: running max and partial sum
};

template <int kDkp>
__device__ __forceinline__ void bf16_item(const FlashArgs& a, int n_qb, const Item& it,
                                          const __nv_bfloat16* Qs, const __nv_bfloat16* Ks,
                                          const __nv_bfloat16* Vs, int ld, Bf16State<kDkp>& st) {
  using S = Bf16State<kDkp>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int qb = it.t % n_qb;
  const int r0 = qb * kBlock + 16 * warp + g;  // this thread's rows r0 and r0 + 8
  if (it.kb == 0) {
#pragma unroll
    for (int ks = 0; ks < S::kKs; ++ks)  // k-steps past dk would read the next row
      if (16 * ks < a.dk) load_a(st.qf[ks], Qs, ld, false, 16 * warp, 16 * ks);
#pragma unroll
    for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[nt][e] = 0.f;
    st.m[0] = st.m[1] = -INFINITY;
    st.l[0] = st.l[1] = 0.f;
  }
  // S = Q K^T over this key block: 8 n-tiles of 8 keys.
  float s[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < S::kKs; ++ks) {
    if (16 * ks >= a.dk) break;
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      unsigned b[4];
      load_b2(b, Ks, ld, true, 16 * ks, 16 * np);
      mma_bf16(s[2 * np], st.qf[ks], b[0], b[1]);
      mma_bf16(s[2 * np + 1], st.qf[ks], b[2], b[3]);
    }
  }
  // Scale, mask and the online softmax; rows r0 (e < 2) and r0 + 8 (e >= 2).
  const int k0 = it.kb * kBlock;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e >> 1), col = k0 + 8 * nt + 2 * tq + (e & 1);
      float x = s[nt][e] * a.scale;
      if (col >= a.Nkv || (a.causal && row < col)) x = -INFINITY;
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], msafe[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    msafe[h] = isfinite(m_new) ? m_new : 0.f;
    alpha[h] = isfinite(st.m[h]) ? expf(st.m[h] - msafe[h]) : 0.f;
    st.m[h] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[nt][e] - msafe[e >> 1]);
      rs[e >> 1] += p;
      s[nt][e] = p;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + rs[h];
#pragma unroll
  for (int nt = 0; nt < S::kNt; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[nt][e] *= alpha[e >> 1];
  // O += c(P) V: P's accumulator fragments of n-tiles 2kk, 2kk + 1 are the
  // A fragment of k-step kk.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned pa[4];
    pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
    for (int np = 0; np < S::kNt / 2; ++np) {
      if (16 * np < a.dk) {
        unsigned b[4];
        load_b2(b, Vs, ld, false, 16 * kk, 16 * np);
        mma_bf16(st.o[2 * np], pa, b[0], b[1]);
        mma_bf16(st.o[2 * np + 1], pa, b[2], b[3]);
      }
    }
  }
}

template <int kDkp>
__device__ __forceinline__ void bf16_finish(const FlashArgs& a, int n_qb, const Item& it,
                                            Bf16State<kDkp>& st) {
  const int bh = it.t / n_qb, qb = it.t - bh * n_qb;
  const int b = bh / a.H, h = bh - b * a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  __nv_bfloat16* op = (__nv_bfloat16*)a.o + b * a.st[9] + h * a.st[10];
  // Pairs of columns are 4-byte aligned when the output's base and strides are even.
  const bool pairs = (((size_t)op | (size_t)(a.st[11] * 2)) & 3) == 0;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float l = st.l[hr];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float denom = fmaxf(l, 1e-30f);
    const int row = qb * kBlock + 16 * warp + g + 8 * hr;
    if (row >= a.N) continue;
    __nv_bfloat16* orow = op + (long long)row * a.st[11];
#pragma unroll
    for (int nt = 0; nt < Bf16State<kDkp>::kNt; ++nt) {
      const int col = 8 * nt + 2 * tq;  // even: a pair is one 4-byte store when both fit
      const float x0 = st.o[nt][2 * hr] / denom, x1 = st.o[nt][2 * hr + 1] / denom;
      if (col + 1 < a.dk && pairs)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      else if (col < a.dk) {
        orow[col] = __float2bfloat16(x0);
        if (col + 1 < a.dk) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// ----------------------------- fp32: CUDA cores -----------------------------

template <int kCols>  // output columns a thread owns: ceil(dk / 16), 4 or 8
struct F32State {
  float o[4][kCols];
  float m[4], l[4];
};

template <int kCols>
__device__ __forceinline__ void f32_item(const FlashArgs& a, int n_qb, const Item& it,
                                         const float* Qs, const float* Ks, const float* Vs,
                                         float* Ps, int ld, F32State<kCols>& st) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int ldp = kBlock + 1;
  const int q0 = (it.t % n_qb) * kBlock, k0 = it.kb * kBlock;
  if (it.kb == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      st.m[i] = -INFINITY;
      st.l[i] = 0.f;
#pragma unroll
      for (int c = 0; c < kCols; ++c) st.o[i][c] = 0.f;
    }
  }
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
  // The padded columns are zero in Q and K, so whole float4 steps are exact.
  for (int d = 0; d < a.dk; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (4 * ty + i) * ld + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) kb[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(qa[i].x, kb[j].x, x);
        x = fmaf(qa[i].y, kb[j].y, x);
        x = fmaf(qa[i].z, kb[j].z, x);
        s[i][j] = fmaf(qa[i].w, kb[j].w, x);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * a.scale;
      if (col >= a.Nkv || (a.causal && row < col)) x = -INFINITY;
      s[i][j] = x;
      mx = fmaxf(mx, x);
    }
    mx = half_max(mx);
    const float m_new = fmaxf(st.m[i], mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    const float alpha = isfinite(st.m[i]) ? expf(st.m[i] - m_safe) : 0.f;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float p = expf(s[i][j] - m_safe);
      rs += p;
      Ps[(4 * ty + i) * ldp + tx + 16 * j] = p;
    }
    rs = half_sum(rs);
    st.l[i] = st.l[i] * alpha + rs;
    st.m[i] = m_new;
#pragma unroll
    for (int c = 0; c < kCols; ++c) st.o[i][c] *= alpha;
  }
  __syncthreads();  // P is complete
  for (int mm = 0; mm < kBlock; ++mm) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ps[(4 * ty + i) * ldp + mm];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const float vv = Vs[mm * ld + tx + 16 * c];  // columns >= dk are never stored
#pragma unroll
      for (int i = 0; i < 4; ++i) st.o[i][c] = fmaf(p[i], vv, st.o[i][c]);
    }
  }
}

template <int kCols>
__device__ __forceinline__ void f32_finish(const FlashArgs& a, int n_qb, const Item& it,
                                           F32State<kCols>& st) {
  const int bh = it.t / n_qb, qb = it.t - bh * n_qb;
  const int b = bh / a.H, h = bh - b * a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float* op = (float*)a.o + b * a.st[9] + h * a.st[10];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qb * kBlock + 4 * ty + i;
    if (row >= a.N) continue;
    const float denom = fmaxf(st.l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tx + 16 * c;
      if (col < a.dk) op[(long long)row * a.st[11] + col] = st.o[i][c] / denom;
    }
  }
}

// ------------------------------ the kernel ------------------------------

// kW: 64 or 128 for bf16 (dk padded to a k-step multiple), 4 or 8 for fp32
// (accumulator columns a thread).
template <typename T, int kW>
__global__ void __launch_bounds__(sizeof(T) == 2 ? kThreadsBf16 : kThreadsF32)
    flash_fwd_kernel(FlashArgs a) {
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kThr = kBf16 ? kThreadsBf16 : kThreadsF32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = stage_ld<T>(a.dk);
  const int tile = kBlock * ld;
  T* stages = reinterpret_cast<T*>(smem_raw);  // Q0, Q1, K0, V0, K1, V1
  float* Ps = reinterpret_cast<float*>(stages + 6 * tile);

  const int n_qb = (a.N + kBlock - 1) / kBlock;
  const int n_tiles = a.BH * n_qb;
  Item it{(int)blockIdx.x, 0};
  if (it.t >= n_tiles) return;
  auto Q = [&](int s) { return stages + s * tile; };
  auto K = [&](int s) { return stages + (2 + 2 * s) * tile; };
  auto V = [&](int s) { return stages + (3 + 2 * s) * tile; };
  std::conditional_t<kBf16, Bf16State<kW>, F32State<kW>> st;
  int qs = 0, kvs = 0;  // the stage of Q (flips per tile) and of K, V (per item)
  issue_item<T, kThr>(a, n_qb, it, Q(qs), K(kvs), V(kvs), ld);
  // Zero the columns past dk of every stage row once, while the first copies
  // fly: the copies write only columns < dk (and zeros to the rows past the
  // end), so the padding stays zero. The loop's first barrier publishes it.
  const int pad = ld - a.dk;
  for (int i = threadIdx.x; i < 6 * kBlock * pad; i += kThr)
    stages[(i / pad) * ld + a.dk + i % pad] = from_f<T>(0.f);
  for (;;) {
    Item nx = it;
    const bool more = next_item(a, n_qb, n_tiles, nx);
    const int nqs = nx.kb == 0 ? qs ^ 1 : qs;
    if (more) {
      issue_item<T, kThr>(a, n_qb, nx, Q(nqs), K(kvs ^ 1), V(kvs ^ 1), ld);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this item's Q, K and V have landed
    if constexpr (kBf16) {
      bf16_item<kW>(a, n_qb, it, Q(qs), K(kvs), V(kvs), ld, st);
      if (it.kb + 1 == kv_blocks(a, it.t % n_qb)) bf16_finish<kW>(a, n_qb, it, st);
    } else {
      f32_item<kW>(a, n_qb, it, Q(qs), K(kvs), V(kvs), Ps, ld, st);
      if (it.kb + 1 == kv_blocks(a, it.t % n_qb)) f32_finish<kW>(a, n_qb, it, st);
    }
    if (!more) break;
    __syncthreads();  // every thread is done with the stages the next copies refill
    it = nx;
    qs = nqs;
    kvs ^= 1;
  }
}

template <typename T, int kW>
int launch_flash(const FlashArgs& a, cudaStream_t stream) {
  constexpr int kThr = sizeof(T) == 2 ? kThreadsBf16 : kThreadsF32;
  const int smem = (int)flash_smem_bytes<T>(a.dk);
  auto kernel = flash_fwd_kernel<T, kW>;
  // The persistent grid: as many blocks as are resident at once (at most
  // one a tile). The attribute and the occupancy depend on smem alone, which
  // depends on dk: both are kept for the last smem of this instantiation.
  static int sms = 0, last_smem = -1, resident = 0;
  cudaError_t e;
  if (smem != last_smem) {
    int dev = 0, per_sm = 0;
    if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess ||
        (e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThr, smem)) !=
            cudaSuccess)
      return (int)e;
    resident = sms * std::max(per_sm, 1);
    last_smem = smem;
  }
  const long long n_tiles = (long long)a.BH * ((a.N + kBlock - 1) / kBlock);
  const int grid = (int)std::min<long long>(n_tiles, resident);
  kernel<<<grid, kThr, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace mop

// Shared-memory bytes of one block (both stages, and fp32's P tile).
extern "C" long long mop_flash_smem_bytes(int dtype, int dk) {
  return dtype == 1 ? (long long)mop::flash_smem_bytes<__nv_bfloat16>(dk)
                    : (long long)mop::flash_smem_bytes<float>(dk);
}

// C entry point, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16; `strides` holds the (batch, head, row) element strides of q, k,
// v and o in that order (the feature stride must be 1); `vec` is the width
// in bytes (16, 8, 4, or the element size) of the asynchronous copies, which
// must divide every q, k and v address, stride and row. Returns a
// cudaError_t code: 0 when the launch was accepted.
extern "C" int mop_flash_fwd(int dtype, const void* q, const void* k, const void* v, void* o,
                             int B, int H, int N, int Nkv, int dk, const long long* strides,
                             int causal, float scale, int vec, void* stream) {
  if (dk < 1 || dk > mop::kMaxDk || N < 1 || Nkv < 1 || B < 1 || H < 1)
    return (int)cudaErrorInvalidValue;
  mop::FlashArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.BH = B * H;
  a.H = H;
  a.N = N;
  a.Nkv = Nkv;
  a.dk = dk;
  a.causal = causal;
  a.vec = vec;
  a.scale = scale;
  for (int i = 0; i < 12; ++i) a.st[i] = strides[i];
  cudaStream_t s = (cudaStream_t)stream;
  const bool wide = dk > 64;
  if (dtype == 0)
    return wide ? mop::launch_flash<float, 8>(a, s) : mop::launch_flash<float, 4>(a, s);
  if (dtype == 1)
    return wide ? mop::launch_flash<__nv_bfloat16, 128>(a, s)
                : mop::launch_flash<__nv_bfloat16, 64>(a, s);
  return (int)cudaErrorInvalidValue;
}
