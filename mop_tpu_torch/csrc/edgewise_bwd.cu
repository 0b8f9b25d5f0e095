// K2b and K3b: backward of the fused E-mode (edgewise) attention for
// Hopper, with the lowrank gate head (K2b) or the dense gate head (K3b).
//
// Replaces the Pallas kernel `_edgewise_generic_bwd_kernel` in
// mop_tpu/ops/fused.py over `_edgewise_math` (lowrank) and
// `_edgewise_dense_math` (dense), which recomputes the math + `_edgewise_output`
// per (batch*head) program and applies `jax.vjp` to it inside the kernel.
// CUDA has no such tool, so the VJP below is written out by hand. One CTA
// runs one program: it recomputes the forward (edgewise_stages.cuh), then
// walks the cotangents back. One kernel template serves both heads: only the
// gate stages differ. Notation per program, c(x) the cast to the compute
// dtype T (identity in fp32), Ac_i = c(A_i):
//
//   S_i = c(q_i * c(scale)) k_i^T, A_i = softmax(S_i)
//   F_1 = Ac_0 Ac_1, F_j = c(F_{j-1}) Ac_j        (c_fwd = F_{V-1})
//   B_1 = Ac_{V-1} Ac_{V-2}, B_j = c(B_{j-1}) Ac_{V-1-j}   (c_bwd = B_{V-1})
//   LF = log(c_fwd + 1e-6), LB = log(c_bwd + 1e-6)
//   lowrank: a = row_feat wrow + brow, b = col_feat wcol + bcol, g_c = sigmoid(a_c b_c^T)
//   dense, per edge e = (i, j) with feat(e) = [S_c(i,j), S_c(j,i), LF(i,j), LB(i,j)]:
//     pre = b1 + feat w1, hid = gelu(pre), g = sigmoid(b2 + hid w2)
//   smix = S_0 + g_0 (sum - S_0) + g_1 (lse - S_0) - g_2 beta mean_others + g_3 LF
//   att = softmax(smix), P_V = v_{V-1}, P_i = Ac_i c(P_{i+1}) (i = V-1 .. 1)
//   y = c(att) v_0 + w Ac_0 c(P_1)
//
// Cotangents, in the order the kernel computes them (dy given):
//
// 1. Output and transport. dw = sum(dy * (Ac_0 c(P_1))), d att = dy v_0^T,
//    dv_0 = c(att)^T dy, dAc_0 = w dy c(P_1)^T, dP_1 = w Ac_0^T dy, then for
//    i = 1 .. V-1: dAc_i = dP_i c(P_{i+1})^T and dP_{i+1} = Ac_i^T dP_i;
//    dv_{V-1} = dP_V. Only v_0 and v_{V-1} receive a gradient: the views in
//    between are written with zeros.
// 2. Softmax of smix and the mix. d smix = att * (d att - rowsum(d att * att)).
//    With p_i = exp(S_i - lse) the softmax over views and n_o = max(1, V-1):
//    dS_0 = d smix (1 - g_1) + d smix g_1 p_0,
//    dS_i = d smix (g_0 - g_2 beta / n_o) + d smix g_1 p_i     (i >= 1),
//    dg_0 = d smix (sum - S_0), dg_1 = d smix (lse - S_0),
//    dg_2 = -d smix beta mean_others, dg_3 = d smix LF, d LF = d smix g_3;
//    dz_c = dg_c g_c (1 - g_c), the cotangent of gate c's logit.
// 3. Lowrank gates. da_c = dz_c b_c, db_c = dz_c^T a_c;
//    dwrow = row_feat^T da, dbrow = colsum(da) (and col likewise, per
//    program); d row_feat = da wrow^T, d col_feat = db wcol^T.
// 4. Lowrank pooled features, channels [S_1..S_V, S_1^T..S_V^T, LF, LB]. For c < V:
//    dS_c[i, j] += (drf[i, c] + dcf[i, V+c] + drf[j, V+c] + dcf[j, c]) / N;
//    d LF[i, j] += (drf[i, 2V] + dcf[j, 2V]) / N, d LB likewise with 2V+1;
//    then d c_fwd = d LF / (c_fwd + 1e-6), d c_bwd = d LB / (c_bwd + 1e-6).
// 3-4. Dense head, per edge e (the 1x1 MLP's backward):
//    dhid = w2 dz, dw2 += hid (x) dz, db2 += dz;
//    dpre = dhid * gelu'(pre), dw1 += feat (x) dpre, db1 += dpre;
//    dfeat = w1 dpre, scattered back: dS_c(i,j) += dfeat_c(e),
//    dS_c(j,i) += dfeat_{V+c}(e) (the transposed channel),
//    d LF(e) += dfeat_{2V}(e), d LB(e) += dfeat_{2V+1}(e); then d c_fwd and
//    d c_bwd as for lowrank.
// 5. Chains. From dF_{V-1} = d c_fwd, for j = V-1 .. 2:
//    dAc_j += c(F_{j-1})^T dF_j, dF_{j-1} = dF_j Ac_j^T; then
//    dAc_0 += dF_1 Ac_1^T, dAc_1 += Ac_0^T dF_1. The backward chain the same
//    way with Ac_{V-1-j} in place of Ac_j.
// 6. Score maps. dS_i += A_i * (dAc_i - rowsum(dAc_i * A_i)),
//    dq_i = c(scale) dS_i k_i, dk_i = dS_i^T c(q_i * c(scale)).
//
// The dense stages 2-4 visit each edge once (`dense_gate_backward`): the
// edges are walked in pairs of 16 x 16 blocks {(bi, bj), (bj, bi)} whose
// features are staged in shared memory, each edge writes its own dS share
// to its block's dS tile and its transposed channels' share to the other
// block's, and the pair's tiles overwrite S_c once both blocks are done; the
// weight grads are fixed-order products over the edges.
//
// The state does not fit in shared memory: the backward needs about 5V maps
// of N x N fp32 per program (about 400 KB at V = 5, N = 64) against the
// 227 KB one block may take. So every map that lives across phases sits in a
// per-program workspace in device memory, which the Python wrapper allocates.
// Shared memory holds the operands of the product being computed, the gate
// cotangents, d smix, the running dF / dP and the small feature, factor and
// weight arrays. Every sum is taken in a fixed order inside one block, and
// the per-program weight grads are summed by the caller: no atomics anywhere.
//
// Bound on this card: the recompute (about 8.5 Mflop per program at the main
// shape) plus about 19 Mflop of backward products (and, dense, about 5 Mflop
// of per-edge head arithmetic), against inputs, dy and grads read or written
// once: in fp32 bound by the FMA rate, in bf16 by those bytes (the tensor
// cores would do the flops in about a tenth of the time the bytes take).
// What holds both back is neither: each program walks its maps through the
// workspace in some forty dependent phases, and every phase waits on device
// memory. Two instantiations:
//
// - fp32 (the eval gradient): the products on CUDA cores in true fp32, each
//   thread owning 4 x 4 tiles of operands staged in fp32 shared memory (with
//   the transpose applied on the way in); an fp32 workspace of 5V - 1 maps
//   and V - 1 transports (450,560 bytes a program at the main shape); one
//   program an SM (162 KB of shared memory).
// - bf16 (E's and E_dense's train steps, `edgewise_bwd_tc_kernel` below):
//   the products on the tensor cores from bf16 operands brought in by
//   `cp.async`, the maps that are only read rounded kept in bf16 (413,696
//   bytes a program); with the lowrank head 112 KB of shared memory and at
//   most 128 registers, so two programs share an SM and their phases' waits
//   overlap; the dense head (82 KB) takes one program an SM, whose
//   registers it needs not to spill.
#include <algorithm>

#include "edgewise_stages.cuh"

namespace mop {

// One edge's row in the dense walk's staging: dpre (16), hid (16), dz (4),
// then its C features; an odd stride, so that a warp's rows fall in distinct banks.
constexpr int kStDpre = 0, kStHid = kHidden, kStDz = 2 * kHidden, kStFeat = 2 * kHidden + 4;
constexpr int kSt = kStFeat + kMaxC + 1;

// Floats of the dense edge walk's shared memory: a pair of edge blocks' tiles
// (S_c, c_fwd, c_bwd), their dS tiles, and 256 edges' staging rows.
__host__ __device__ inline int dense_scratch_floats(int V) {
  return (4 * V + 4) * kET + kThreads * kSt;
}

// Dense stages 2-4: the mix and the head's backward at every edge, each edge
// visited once. The edges are walked in pairs of 16 x 16 blocks {A = (bi, bj),
// B = (bj, bi)}, bi <= bj: the pair's S_c, c_fwd and c_bwd tiles are staged in
// scr (`stage_block`); each edge of A, then of B, reads its features from the
// tiles (its two logs taken once), takes its head, gates, mix cotangents, dz,
// dpre and dfeat = w1 dpre, stages its features, hid, dz and dpre in its row
// for the weight grads, adds its own dS share (the mix's and its own
// channels') to its block's dS tile and its transposed channels' share to the
// other block's tile at (j, i) (a diagonal pair's to a spare tile); d c_fwd
// and d c_bwd replace c_fwd and c_bwd at its own place. The pair's dS tiles
// then overwrite S_c: only this pair reads or writes those places, so the
// in-place update races with nothing. The weight grads are
// fixed-order products over the edges: each warp sums its 32 edges of every
// block (dw1 = feat^T dpre, db1 = sum dpre, dw2 = hid^T dz, db2 = sum dz) in
// registers, a lane holding dw1[c][h] for its half's channels c and hidden
// unit h, and the warps' sums are added in warp order at the end; no atomics.
template <class P>
__device__ void dense_gate_backward(const P& p, const DenseGate& gate, const float* DSM, float* scr,
                                    const Grads& dw, int bh, float beta_not) {
  const int V = p.V, N = p.N, C = gate.C, nb = (N + kEB - 1) / kEB;
  const int ldm = odd_stride(N);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hb = lane >> 4, hl = lane & 15;  // the lane's half and hidden unit in the sums
  const int r = tid >> 4, cc = tid & (kEB - 1);  // the thread's edge in a block
  const float n_others = (float)max(1, V - 1);
  float* TA = scr;                  // block A: S_c, c_fwd, c_bwd
  float* TB = TA + (V + 2) * kET;   // block B
  float* DA_ = TB + (V + 2) * kET;  // dS tiles of A, then of B
  float* DB_ = DA_ + V * kET;
  float* ST = DB_ + V * kET;        // the half's edges' dpre, hid, dz
  float a1[kMaxC / 2], a2[2] = {0.f, 0.f}, a3 = 0.f;
#pragma unroll
  for (int m = 0; m < kMaxC / 2; ++m) a1[m] = 0.f;

  for (int bi = 0; bi < nb; ++bi)
    for (int bj = bi; bj < nb; ++bj) {
      const bool diag = bi == bj;
      __syncthreads();  // the last pair's tiles are written back
      stage_block(p, TA, bi, bj, V + 2);
      if (!diag) stage_block(p, TB, bj, bi, V + 2);
      for (int idx = tid; idx < 2 * V * kET; idx += kThreads) DA_[idx] = 0.f;
      for (int half = 0; half < (diag ? 1 : 2); ++half) {
        float* X = half ? TB : TA;
        const float* Y = diag ? TA : (half ? TA : TB);
        // The edge's own dS share goes to its block's tile, its transposed
        // channels' share to the other block's (for a diagonal pair, to the
        // spare tile, added at the write-back): one writer per place.
        float* DX = half ? DB_ : DA_;
        float* DY = half ? DA_ : DB_;
        const int b0 = half ? bj : bi, b1 = half ? bi : bj;
        const int i = b0 * kEB + r, j = b1 * kEB + cc;
        __syncthreads();  // staged, and the last half's rows are read
        if (i < N && j < N) {
          const int o = r * kEL + cc, ot = cc * kEL + r;
          const float cf = X[V * kET + o], cb = X[(V + 1) * kET + o];
          const float lf = logf(cf + 1e-6f), lb = logf(cb + 1e-6f);
          // The features go to the edge's row (the weight grads read them
          // there) and are read back one channel at a time.
          float* row = ST + tid * kSt;
          const float* fr = row + kStFeat;
          for (int c = 0; c < C; ++c)
            row[kStFeat + c] = c < 2 * V ? *feat_at(X, Y, V, c, r, cc) : (c == 2 * V ? lf : lb);
          float x[kHidden], th[kHidden], g[4];
          gate.head(fr, x, th, g);
#pragma unroll
          for (int h = 0; h < kHidden; ++h) row[kStHid + h] = 0.5f * x[h] * (1.f + th[h]);
          float m = -INFINITY, ssum = 0.f, l = 0.f;  // view_stats over the row
          for (int c = 0; c < V; ++c) {
            m = fmaxf(m, fr[c]);
            ssum += fr[c];
          }
          for (int c = 0; c < V; ++c) l += expf(fr[c] - m);
          const float lse = m + logf(l);
          const float others = ssum - fr[0];
          const float d = DSM[i * ldm + j];
          const float d_lse = d * g[1];
          const float d_rest = d * (g[0] - g[2] * beta_not / n_others);
          const float dg[4] = {d * others, d * (lse - fr[0]), -d * beta_not * (others / n_others),
                               d * lf};
          float dz[4];
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            dz[c4] = dg[c4] * g[c4] * (1.f - g[c4]);
            row[kStDz + c4] = dz[c4];
          }
          gate.dpre(dz, th, x);  // x becomes dpre
#pragma unroll
          for (int h = 0; h < kHidden; ++h) row[kStDpre + h] = x[h];
          // dfeat = w1 dpre: view c's own channel (with the mix's share) and
          // its transposed channel, then the two logs.
          for (int c = 0; c < V; ++c) {
            const float mix = (c == 0 ? d * (1.f - g[1]) : d_rest) + d_lse * expf(fr[c] - lse);
            DX[c * kET + o] += mix + gate.dot_w1(c, x);
            DY[c * kET + ot] += gate.dot_w1(V + c, x);
          }
          const float dlf = d * g[3] + gate.dot_w1(2 * V, x);
          const float dlb = gate.dot_w1(2 * V + 1, x);
          p.Fm(V - 1)[i * N + j] = dlf / (cf + 1e-6f);
          p.Bm(V - 1)[i * N + j] = dlb / (cb + 1e-6f);
        }
        __syncthreads();  // the half's rows are in place
        // The weight grads over the half's edges: warp w takes edges 32w .. 32w + 31.
        for (int e = 32 * warp; e < 32 * warp + 32; ++e) {
          if (b0 * kEB + (e >> 4) >= N || b1 * kEB + (e & (kEB - 1)) >= N) continue;
          const float* sr = ST + e * kSt;
          const float dp = sr[kStDpre + hl], hd = sr[kStHid + hl];
#pragma unroll
          for (int m = 0; m < kMaxC / 2; ++m)
            if (hb + 2 * m < C) a1[m] = fmaf(sr[kStFeat + hb + 2 * m], dp, a1[m]);
          a2[0] = fmaf(hd, sr[kStDz + 2 * hb], a2[0]);
          a2[1] = fmaf(hd, sr[kStDz + 2 * hb + 1], a2[1]);
          a3 += hb == 0 ? dp : (hl < 4 ? sr[kStDz + hl] : 0.f);
        }
      }
      __syncthreads();  // the pair's dS tiles are complete: they overwrite S_c
      for (int idx = tid; idx < (diag ? 1 : 2) * V * kEB * kEB; idx += kThreads) {
        const int t = idx >> 8, rr = (idx >> 4) & (kEB - 1), c = idx & (kEB - 1);
        const int blk = t / V, ch = t - blk * V;
        const int i = (blk ? bj : bi) * kEB + rr, j = (blk ? bi : bj) * kEB + c;
        const float* D = DA_ + t * kET + rr * kEL + c;
        if (i < N && j < N) p.S(ch)[i * N + j] = diag ? D[0] + D[V * kET] : D[0];
      }
    }

  // Each warp's sums, then the program's grads as their sum in warp order:
  // rows of [dw1 (C x 16), db1 (16), dw2 (16 x 4), db2 (4)].
  const int n_out = C * kHidden + kHidden + 4 * kHidden + 4;
  __syncthreads();
  float* pw = ST + warp * n_out;
#pragma unroll
  for (int m = 0; m < kMaxC / 2; ++m) {
    const int c = hb + 2 * m;
    if (c < C) pw[c * kHidden + hl] = a1[m];
  }
  pw[C * kHidden + kHidden + hl * 4 + 2 * hb] = a2[0];
  pw[C * kHidden + kHidden + hl * 4 + 2 * hb + 1] = a2[1];
  if (hb == 0)
    pw[C * kHidden + hl] = a3;
  else if (hl < 4)
    pw[C * kHidden + 5 * kHidden + hl] = a3;
  __syncthreads();
  for (int k = tid; k < n_out; k += kThreads) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += ST[w * n_out + k];
    const int k1 = k - C * kHidden, k2 = k1 - kHidden, k3 = k2 - 4 * kHidden;
    if (k1 < 0)
      dw.p[0][(long long)bh * C * kHidden + k] = sum;
    else if (k2 < 0)
      dw.p[1][(long long)bh * kHidden + k1] = sum;
    else if (k3 < 0)
      dw.p[2][(long long)bh * 4 * kHidden + k2] = sum;
    else
      dw.p[3][(long long)bh * 4 + k3] = sum;
  }
}

// Lowrank stages 2-4 of the header: the mix (dS_i in place of S_i, d LF in
// place of att), the gate-logit cotangents DZ (four N x ldm maps), the
// per-program weight grads, and the pooled features' cotangents folded into
// dS_i, d c_fwd (in place of c_fwd) and d c_bwd (in place of c_bwd).
// With kFoldS false the pooled features' share of dS_i is left out of the
// S_i maps (the caller adds it where it reads dS_i: `ds_rows`).
template <bool kFoldS = true, class P>
__device__ void lowrank_gate_backward(const P& p, const LowrankGate& gate, const float* DSM,
                                      float* DZ, float* daf, float* dbf, float* drf, float* dcf,
                                      const Weights& wts, const Grads& dw, int bh,
                                      float beta_not) {
  const int V = p.V, N = p.N, nn = p.nn, r = gate.r;
  const int C = 2 * V + 2, R4 = 4 * r;
  const int ldm = odd_stride(N);
  const int tid = threadIdx.x;
  const float inv_n = 1.f / (float)N;
  const float *rowf = gate.rowf, *colf = gate.colf, *af = gate.af, *bf = gate.bf;
  auto S = [&](int i) { return p.S(i); };
  auto Fm = [&](int j) { return p.Fm(j); };
  auto Bm = [&](int j) { return p.Bm(j); };
  float* ATT = p.ATT();
  const float n_others = (float)max(1, V - 1);
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    const int o = i * ldm + j;
    float s[kMaxViews];
    load_views(p, idx, s);
    const float lf = logf(Fm(V - 1)[idx] + 1e-6f);
    float g[4];
    gate(p, i, j, g);
    float ssum, lse;
    view_stats(s, V, ssum, lse);
    const float others = ssum - s[0];
    const float d = DSM[o];
    const float d_lse = d * g[1];
    const float d_rest = d * (g[0] - g[2] * beta_not / n_others);
#pragma unroll
    for (int c = 0; c < kMaxViews; ++c)
      if (c < V) S(c)[idx] = (c == 0 ? d * (1.f - g[1]) : d_rest) + d_lse * expf(s[c] - lse);
    ATT[idx] = d * g[3];  // d LF from the mix
    const float dg[4] = {d * others, d * (lse - s[0]), -d * beta_not * (others / n_others),
                         d * lf};
#pragma unroll
    for (int c = 0; c < 4; ++c) DZ[c * N * ldm + o] = dg[c] * g[c] * (1.f - g[c]);
  }
  __syncthreads();

  // ---------------- 3. gates and the gate head ----------------
  const float* wrow = wts.p[0];
  const float* wcol = wts.p[2];
  for (int idx = tid; idx < N * R4; idx += kThreads) {
    const int i = idx / R4, col = idx - i * R4, c = col / r;
    const float* dz = DZ + c * N * ldm;
    float sa = 0.f, sb = 0.f;
    for (int j = 0; j < N; ++j) {
      sa = fmaf(dz[i * ldm + j], bf[j * R4 + col], sa);
      sb = fmaf(dz[j * ldm + i], af[j * R4 + col], sb);
    }
    daf[idx] = sa;
    dbf[idx] = sb;
  }
  __syncthreads();
  for (int idx = tid; idx < C * R4; idx += kThreads) {
    const int k = idx / R4, col = idx - k * R4;
    float sr = 0.f, sc2 = 0.f;
    for (int i = 0; i < N; ++i) {
      sr = fmaf(rowf[i * C + k], daf[i * R4 + col], sr);
      sc2 = fmaf(colf[i * C + k], dbf[i * R4 + col], sc2);
    }
    dw.p[0][(long long)bh * C * R4 + idx] = sr;
    dw.p[2][(long long)bh * C * R4 + idx] = sc2;
  }
  for (int col = tid; col < R4; col += kThreads) {
    float sr = 0.f, sc2 = 0.f;
    for (int i = 0; i < N; ++i) {
      sr += daf[i * R4 + col];
      sc2 += dbf[i * R4 + col];
    }
    dw.p[1][(long long)bh * R4 + col] = sr;
    dw.p[3][(long long)bh * R4 + col] = sc2;
  }
  for (int idx = tid; idx < N * C; idx += kThreads) {
    const int i = idx / C, k = idx - i * C;
    float sr = 0.f, sc2 = 0.f;
    for (int col = 0; col < R4; ++col) {
      sr = fmaf(daf[i * R4 + col], wrow[k * R4 + col], sr);
      sc2 = fmaf(dbf[i * R4 + col], wcol[k * R4 + col], sc2);
    }
    drf[idx] = sr;
    dcf[idx] = sc2;
  }
  __syncthreads();

  // ---------------- 4. pooled features ----------------
  for (int idx = tid; idx < nn; idx += kThreads) {
    const int i = idx / N, j = idx - i * N;
    const float att = ATT[idx], fm = Fm(V - 1)[idx], bm = Bm(V - 1)[idx];
    if constexpr (kFoldS) {
      float s[kMaxViews];  // every old value is loaded before any is stored
      load_views(p, idx, s);
#pragma unroll
      for (int c = 0; c < kMaxViews; ++c)
        if (c < V)
          S(c)[idx] = s[c] + (drf[i * C + c] + dcf[i * C + V + c] + drf[j * C + V + c] +
                              dcf[j * C + c]) * inv_n;
    }
    const float dlf = att + (drf[i * C + 2 * V] + dcf[j * C + 2 * V]) * inv_n;
    const float dlb = (drf[i * C + 2 * V + 1] + dcf[j * C + 2 * V + 1]) * inv_n;
    Fm(V - 1)[idx] = dlf / (fm + 1e-6f);
    Bm(V - 1)[idx] = dlb / (bm + 1e-6f);
  }
}

template <typename T, class Gate>
__global__ void __launch_bounds__(kThreads, 1) edgewise_bwd_kernel(
    const T* __restrict__ qs, const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ dy, T* __restrict__ dq, T* __restrict__ dkey, T* __restrict__ dv,
    Weights wts, Grads dw, float* __restrict__ workspace, int H, int V, int N, int dk, int r,
    Strides strides, float beta_not, float scale) {
  extern __shared__ __align__(16) float smem[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N), ldd = odd_stride(dk);
  const int C = 2 * V + 2, R4 = 4 * r;
  const int nbuf = buf_floats(N, dk);
  float* X = smem;              // staged left operand
  float* Y = X + nbuf;          // staged right operand
  float* Z = Y + nbuf;          // dy, then the running dP, dF and dB
  float* DSM = Z + nbuf;        // d att, then d smix
  float* DZ = DSM + N * ldm;    // the four gate-logit cotangents, or the dense edge walk
  // The dense head's weights are read four at a time: 16-byte aligned.
  float* rest = Gate::kDense ? smem + round4(3 * nbuf + N * ldm + dense_scratch_floats(V))
                             : DZ + 4 * N * ldm;

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const Prog<T> p = make_prog(qs, ks, vs, st, workspace, H, V, N, dk);
  const T* qp = p.qp;
  const T* kp = p.kp;
  const T* vp = p.vp;
  const T* dyp = dy + b * st[12] + h * st[13];
  const long long vsz = p.vsz;
  T* dqp = dq + bh * V * vsz;
  T* dkp = dkey + bh * V * vsz;
  T* dvp = dv + bh * V * vsz;
  const float sc = rnd<T>(scale);
  const float w = *wts.p[4];
  const int n_col_tiles = (dk + kTile - 1) / kTile;
  Tile t, t2[2];

  // The gate head, over its shared-memory arrays.
  Gate gate;
  float* red;
  float *rowf = nullptr, *colf = nullptr, *af = nullptr, *bf = nullptr;
  float *daf = nullptr, *dbf = nullptr, *drf = nullptr, *dcf = nullptr;
  if constexpr (Gate::kDense) {
    gate = load_dense_gate(wts, C, rest);
    red = rest + dense_gate_floats(C);  // one float per warp
  } else {
    rowf = rest;
    colf = rowf + N * C;
    af = colf + N * C;
    bf = af + N * R4;
    daf = bf + N * R4;
    dbf = daf + N * R4;
    drf = dbf + N * R4;
    dcf = drf + N * C;
    red = dcf + N * C;  // one float per warp
    gate = Gate{wts.p[0], wts.p[1], wts.p[2], wts.p[3], r, rowf, colf, af, bf};
  }

  // ---------------- recompute the forward ----------------
  recompute_forward<T>(p, gate, X, Y, Z, DSM, beta_not, sc, DZ);
  auto S = [&](int i) { return p.S(i); };
  auto A = [&](int i) { return p.A(i); };
  auto Fm = [&](int j) { return p.Fm(j); };
  auto Bm = [&](int j) { return p.Bm(j); };
  auto DA = [&](int i) { return p.DA(i); };
  auto P = [&](int i) { return p.P(i); };
  float* ATT = p.ATT();

  // ---------------- 1. output and transport ----------------
  __syncthreads();
  stage_in<T>(Z, ldd, dyp, st[14], N, dk, false, 1.f);
  stage<T>(X, ldm, A(0), N, N, N, false, true);
  stage<T>(Y, ldd, P(1), dk, N, dk, false, false);
  __syncthreads();
  {  // dw = sum(dy * (Ac_0 c(P_1)))
    const int ty = tid >> 4, tx = tid & 15;
    float part = 0.f;
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = 4 * ty + i, c = ct * kTile + tx + 16 * j;
          if (rr < N && c < dk) part = fmaf(t.v[i][j], Z[rr * ldd + c], part);
        }
    }
    part = warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) s += red[k];
      dw.p[4][bh] = s;
    }
  }
  __syncthreads();
  // dv_0 = c(att)^T dy; the views strictly between 0 and V-1 get zeros.
  stage<T>(X, ldm, ATT, N, N, N, true, true);
  for (long long idx = tid; idx < (long long)(V - 2) * vsz; idx += kThreads)
    dvp[vsz + idx] = from_f<T>(0.f);
  __syncthreads();
  for (int ct = 0; ct < n_col_tiles; ++ct) {
    mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t);
    put_out<T>(dvp, dk, N, dk, ct * kTile, t, 1.f);
  }
  __syncthreads();
  // d att = dy v_0^T into DSM; dAc_0 = w dy c(P_1)^T.
  stage_in<T>(X, ldm, vp, st[11], N, dk, true, 1.f);
  stage<T>(Y, ldm, P(1), dk, N, dk, true, false);
  __syncthreads();
  mm_nn(Z, ldd, X, ldm, dk, N, N, 0, t);
  put<T>(DSM, ldm, N, N, 0, t, 1.f, false, false);
  mm_nn(Z, ldd, Y, ldm, dk, N, N, 0, t);
  put<T>(DA(0), N, N, N, 0, t, w, false, false);
  __syncthreads();
  // dP_1 = w Ac_0^T dy, into Z once every reader of dy is done.
  stage<T>(X, ldm, A(0), N, N, N, true, true);
  __syncthreads();
#pragma unroll
  for (int ct = 0; ct < 2; ++ct)
    if (ct < n_col_tiles) mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t2[ct]);
  __syncthreads();
#pragma unroll
  for (int ct = 0; ct < 2; ++ct)
    if (ct < n_col_tiles) put<T>(Z, ldd, N, dk, ct * kTile, t2[ct], w, false, false);
  for (int i = 1; i < V; ++i) {
    __syncthreads();
    if (i + 1 == V)
      stage_in<T>(Y, ldm, vp + (V - 1) * st[10], st[11], N, dk, true, 1.f);
    else
      stage<T>(Y, ldm, P(i + 1), dk, N, dk, true, false);
    stage<T>(X, ldm, A(i), N, N, N, true, true);
    __syncthreads();
    mm_nn(Z, ldd, Y, ldm, dk, N, N, 0, t);
    put<T>(DA(i), N, N, N, 0, t, 1.f, false, false);
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_col_tiles) mm_nn(X, ldm, Z, ldd, N, N, dk, ct * kTile, t2[ct]);
    __syncthreads();
#pragma unroll
    for (int ct = 0; ct < 2; ++ct)
      if (ct < n_col_tiles) put<T>(Z, ldd, N, dk, ct * kTile, t2[ct], 1.f, false, false);
  }
  __syncthreads();
  for (int idx = tid; idx < N * dk; idx += kThreads) {
    const int rr = idx / dk, c = idx - rr * dk;
    dvp[(V - 1) * vsz + idx] = from_f<T>(Z[rr * ldd + c]);
  }

  // ---------------- 2. softmax of smix and the mix ----------------
  softmax_vjp_rows(ATT, N, DSM, ldm, nullptr, 0, N);
  __syncthreads();
  if constexpr (Gate::kDense) {
    // ------------- 2-4. the mix and the dense head, per edge -------------
    dense_gate_backward(p, gate, DSM, DZ, dw, bh, beta_not);
  } else {
    lowrank_gate_backward(p, gate, DSM, DZ, daf, dbf, drf, dcf, wts, dw, bh, beta_not);
  }

  // ---------------- 5. both chains ----------------
  // Forward chain: view(j) = j, prev(j) = F_{j-1}; backward chain: view(j) =
  // V-1-j, prev(j) = B_{j-1}; the first product pairs views (0, 1) and
  // (V-1, V-2).
  for (int chain = 0; chain < 2; ++chain) {
    __syncthreads();
    stage<T>(Z, ldm, chain == 0 ? Fm(V - 1) : Bm(V - 1), N, N, N, false, false);
    for (int j = V - 1; j >= 2; --j) {
      const int view = chain == 0 ? j : V - 1 - j;
      __syncthreads();
      stage<T>(X, ldm, chain == 0 ? Fm(j - 1) : Bm(j - 1), N, N, N, true, true);
      stage<T>(Y, ldm, A(view), N, N, N, true, true);
      __syncthreads();
      mm_nn(X, ldm, Z, ldm, N, N, N, 0, t);
      put<T>(DA(view), N, N, N, 0, t, 1.f, true, false);
      mm_nn(Z, ldm, Y, ldm, N, N, N, 0, t);
      __syncthreads();
      put<T>(Z, ldm, N, N, 0, t, 1.f, false, false);
    }
    const int v0 = chain == 0 ? 0 : V - 1, v1 = chain == 0 ? 1 : V - 2;
    __syncthreads();
    stage<T>(X, ldm, A(v0), N, N, N, true, true);
    stage<T>(Y, ldm, A(v1), N, N, N, true, true);
    __syncthreads();
    mm_nn(Z, ldm, Y, ldm, N, N, N, 0, t);
    put<T>(DA(v0), N, N, N, 0, t, 1.f, true, false);
    mm_nn(X, ldm, Z, ldm, N, N, N, 0, t);
    put<T>(DA(v1), N, N, N, 0, t, 1.f, true, false);
  }
  __syncthreads();

  // ---------------- 6. score maps, dq and dk ----------------
  for (int vi = 0; vi < V; ++vi) softmax_vjp_rows(A(vi), N, DA(vi), N, S(vi), N, N);
  for (int vi = 0; vi < V; ++vi) {
    __syncthreads();
    stage<T>(X, ldm, S(vi), N, N, N, false, false);
    stage<T>(Z, ldm, S(vi), N, N, N, true, false);
    stage_in<T>(Y, ldd, kp + vi * st[6], st[7], N, dk, false, 1.f);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(X, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put_out<T>(dqp + vi * vsz, dk, N, dk, ct * kTile, t, sc);
    }
    __syncthreads();
    stage_in<T>(Y, ldd, qp + vi * st[2], st[3], N, dk, false, sc);
    __syncthreads();
    for (int ct = 0; ct < n_col_tiles; ++ct) {
      mm_nn(Z, ldm, Y, ldd, N, N, dk, ct * kTile, t);
      put_out<T>(dkp + vi * vsz, dk, N, dk, ct * kTile, t, 1.f);
    }
  }
}

// =================== bf16: the products on the tensor cores ===================
//
// The bf16 instantiation (E's train step) runs every product as
// `mma.sync.m16n8k16` with bf16 operands and fp32 accumulation: the eight
// warps tile a 64 x 64 output as 4 x 2 warp tiles of 16 x 32. Operands sit
// in shared memory in bf16 (`mma_ld` rows, zero-padded to a multiple of 16
// in both dimensions); `ldmatrix(.trans)` reads them in either orientation,
// so nothing is transposed on the way in. Maps that are read only rounded
// live in the workspace in bf16 (Ac_i, F_1..F_{V-2}, B_1..B_{V-2}, the
// transports P_i) and arrive by `cp.async`, as do q, k, v and dy, while the
// product before them runs; the maps read in fp32 stay fp32 (S_i / dS_i,
// A_i for the softmax VJP, F_{V-1} and B_{V-1} for the logs and then d c_fwd
// and d c_bwd, att, dAc_i).
//
// Rounding follows the plain backward (autograd through the casts of the
// forward): a cotangent is rounded to bf16 where it passes back through a
// cast, i.e. d att, each dP_i, each dF_j / dB_j below the top of its chain,
// and the total dAc_i once, before the softmax VJP; dq = c(c(dS k) c(scale)).
// So both operands of those products are bf16. The two cotangents that no
// cast rounds, d c_fwd / d c_bwd at the top of the chains and dS_i before
// dq_i and dk_i, enter their products as a two-term bf16 split (x = hi + lo,
// hi = c(x), lo = c(x - hi)): two products, error about 2^-17 of |x|.

constexpr int kNbuf = 7;  // bf16 operand buffers of 64 rows

// One program's workspace in the bf16 backward: fp32 maps (row stride N),
// then bf16 maps (row stride nw = N rounded up to 8; transports dw = dk
// rounded up to 8), every map 16-byte aligned.
struct ProgTC {
  const bf16* qp;
  const bf16* kp;
  const bf16* vp;
  const long long* st;
  int V, N, dk, nn, nw, dw;
  float* wf;
  bf16* wb;
  __device__ float* S(int i) const { return wf + i * nn; }
  __device__ float* A(int i) const { return wf + (V + i) * nn; }
  __device__ float* Fm(int) const { return wf + 2 * V * nn; }  // F_{V-1} only
  __device__ float* Bm(int) const { return wf + (2 * V + 1) * nn; }
  __device__ float* ATT() const { return wf + (2 * V + 2) * nn; }
  __device__ float* DA(int i) const { return wf + (2 * V + 3 + i) * nn; }
  __device__ bf16* Ac(int i) const { return wb + (long long)i * N * nw; }
  __device__ bf16* Fr(int j) const { return wb + (long long)(V + j - 1) * N * nw; }
  __device__ bf16* Br(int j) const { return wb + (long long)(2 * V - 2 + j - 1) * N * nw; }
  __device__ bf16* P(int i) const {
    return wb + (long long)(3 * V - 4) * N * nw + (long long)(i - 1) * N * dw;
  }
};

__host__ __device__ inline long long tc_wf_floats(int V, int N) {
  return ((long long)(3 * V + 3) * N * N + 3) & ~3LL;
}

// Bytes of one program's bf16-backward workspace (a multiple of 16).
__host__ __device__ inline long long tc_ws_bytes(int V, int N, int dk) {
  const long long nw = (N + 7) & ~7, dw = (dk + 7) & ~7;
  return 4 * tc_wf_floats(V, N) + 2 * ((3LL * V - 4) * N * nw + (V - 1LL) * N * dw);
}

// D += t over an N x N tile (columns from 0) inside rows x cols, every old
// value loaded before any is stored; pairs as float2 when `vec`.
__device__ __forceinline__ void add_tile(float* D, int ld, const MTile& t, int rows, int cols,
                                         bool vec) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = 16 * (warp & 3) + (lane >> 2), cb = 32 * (warp >> 2) + 2 * (lane & 3);
  float old[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e >> 1), c = cb + 8 * j + (e & 1);
      old[j][e] = (r < rows && c < cols) ? D[r * ld + c] : 0.f;
    }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = cb + 8 * j;
      if (r < rows && c < cols)
        st2(D + r * ld + c, c, cols, old[j][2 * h] + t.v[j][2 * h],
            old[j][2 * h + 1] + t.v[j][2 * h + 1], vec);
    }
}

// An fp32 map rounded to bf16 (hi), and with lo the rest rounded (lo = c(x - hi)).
__device__ void stage_round(bf16* hi, bf16* lo, int ld, const float* src, int lds, int rows,
                            int cols) {
  constexpr int kU = 4;  // loads in flight a thread
  const int n = rows * cols;
  for (int base = threadIdx.x; base < n; base += kU * kThreads) {
    float x[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kThreads;
      x[u] = idx < n ? src[(idx / cols) * lds + idx % cols] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int idx = base + u * kThreads;
      if (idx < n) {
        const int r = idx / cols, c = idx - r * cols;
        const bf16 h = __float2bfloat16(x[u]);
        hi[r * ld + c] = h;
        if (lo) lo[r * ld + c] = __float2bfloat16(x[u] - __bfloat162float(h));
      }
    }
  }
  zero_pad(hi, ld, rows, cols);
  if (lo) zero_pad(lo, ld, rows, cols);
}

// Row softmax of an N x N fp32 map M in shared memory (row stride ldm) into
// A (fp32) and Ac = c(A) (bf16, row stride nw), with M copied to S; row
// strides N in device memory.
__device__ void softmax_rows_tc(const float* M, int ldm, float* S, float* A, bf16* Ac, int nw,
                                int N) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < N; r += kThreads / 32) {
    const float* row = M + r * ldm;
    const float x0 = lane < N ? row[lane] : -INFINITY;
    const float x1 = lane + 32 < N ? row[lane + 32] : -INFINITY;
    if (lane < N) S[r * N + lane] = x0;
    if (lane + 32 < N) S[r * N + lane + 32] = x1;
    const float mx = warp_max(fmaxf(x0, x1));
    const float e0 = lane < N ? expf(x0 - mx) : 0.f;
    const float e1 = lane + 32 < N ? expf(x1 - mx) : 0.f;
    const float sum = warp_sum(e0 + e1);
    if (lane < N) {
      A[r * N + lane] = e0 / sum;
      Ac[r * nw + lane] = __float2bfloat16(e0 / sum);
    }
    if (lane + 32 < N) {
      A[r * N + lane + 32] = e1 / sum;
      Ac[r * nw + lane + 32] = __float2bfloat16(e1 / sum);
    }
  }
}

// dS_i in full, split into bf16 hi and lo (row stride ld, padding zeroed):
// the mix's share (in S_i), the lowrank pooled features' share (from drf and
// dcf of the lowrank gate backward, when given) and the softmax VJP
// A_i (c(dAc_i) - rowsum(c(dAc_i) A_i)), c the cast to bf16. One warp a row,
// two rows at a time with all their loads issued first.
__device__ void ds_rows(const ProgTC& p, int vi, const float* drf, const float* dcf, bf16* hi,
                        bf16* lo, int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int V = p.V, N = p.N, C = 2 * V + 2;
  constexpr int kW = kThreads / 32;
  const float inv_n = 1.f / (float)N;
  const float* A = p.A(vi);
  const float* D = p.DA(vi);
  const float* S = p.S(vi);
  for (int r0 = warp; r0 < N; r0 += 2 * kW) {
    float a[2][2], d[2][2], sv[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + u * kW, c = lane + 32 * h;
        const bool in = r < N && c < N;
        a[u][h] = in ? A[r * N + c] : 0.f;
        d[u][h] = in ? rnd<bf16>(D[r * N + c]) : 0.f;
        sv[u][h] = in ? S[r * N + c] : 0.f;
      }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = r0 + u * kW;
      const float rs = warp_sum(a[u][0] * d[u][0] + a[u][1] * d[u][1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = lane + 32 * h;
        if (r >= N || c >= N) continue;
        float x = sv[u][h] + a[u][h] * (d[u][h] - rs);
        if (drf)
          x += (drf[r * C + vi] + dcf[r * C + V + vi] + drf[c * C + V + vi] + dcf[c * C + vi]) *
               inv_n;
        const bf16 xh = __float2bfloat16(x);
        hi[r * ld + c] = xh;
        lo[r * ld + c] = __float2bfloat16(x - __bfloat162float(xh));
      }
    }
  }
  zero_pad(hi, ld, N, N);
  zero_pad(lo, ld, N, N);
}

// Two programs an SM for the lowrank head; the dense head's instantiation
// does not fit the 128 registers a thread that allows without spilling, so
// it keeps one program an SM.
template <class Gate>
__global__ void __launch_bounds__(kThreads, Gate::kDense ? 1 : 2) edgewise_bwd_tc_kernel(
    const bf16* __restrict__ qs, const bf16* __restrict__ ks, const bf16* __restrict__ vs,
    const bf16* __restrict__ dy, bf16* __restrict__ dq, bf16* __restrict__ dkey,
    bf16* __restrict__ dv, Weights wts, Grads dw, unsigned char* __restrict__ workspace, int H,
    int V, int N, int dk, int r, Strides strides, float beta_not, float scale, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long* st = strides.s;
  const int ldm = odd_stride(N), ldb = mma_ld(max(N, dk));
  const int C = 2 * V + 2, R4 = 4 * r;
  const int bufsz = kTile * ldb;
  const long long region = max((long long)kNbuf * bufsz * 2,
                               Gate::kDense ? 4LL * dense_scratch_floats(V) : 16LL * N * ldm);
  bf16* bufs = reinterpret_cast<bf16*>(smem_raw);
  auto Bf = [&](int i) { return bufs + i * bufsz; };
  // The buffers, during the gate stages: the lowrank gate cotangents or the dense edge walk.
  float* DZ = reinterpret_cast<float*>(smem_raw);
  float* DSM = reinterpret_cast<float*>(smem_raw + region);  // d att, then d smix
  float* rest = DSM + (Gate::kDense ? round4(N * ldm) : N * ldm);  // dense: 16-byte aligned

  const int tid = threadIdx.x;
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  ProgTC p;
  p.qp = qs + b * st[0] + h * st[1];
  p.kp = ks + b * st[4] + h * st[5];
  p.vp = vs + b * st[8] + h * st[9];
  p.st = st;
  p.V = V;
  p.N = N;
  p.dk = dk;
  p.nn = N * N;
  p.nw = (N + 7) & ~7;
  p.dw = (dk + 7) & ~7;
  p.wf = reinterpret_cast<float*>(workspace + bh * tc_ws_bytes(V, N, dk));
  p.wb = reinterpret_cast<bf16*>(p.wf + tc_wf_floats(V, N));
  const bf16* dyp = dy + b * st[12] + h * st[13];
  const long long vsz = (long long)N * dk;
  bf16* dqp = dq + bh * V * vsz;
  bf16* dkp = dkey + bh * V * vsz;
  bf16* dvp = dv + bh * V * vsz;
  const float sc = rnd<bf16>(scale);
  const float w = *wts.p[4];
  const int n_ct = (dk + kTile - 1) / kTile;  // column tiles of an N x dk product
  const int nw = p.nw, dwd = p.dw;
  const int vn = row_vec(N), vd = row_vec(dk);  // copy widths of N- and dk-wide workspace rows
  // Paired stores: fp32 maps (row stride N) need an even N, the bf16 outputs
  // (row stride dk) an even dk; bf16 workspace and shared rows are even.
  const bool vecN = N % 2 == 0, vecD = dk % 2 == 0;
  auto q_in = [&](int i) { return p.qp + i * st[2]; };
  auto k_in = [&](int i) { return p.kp + i * st[6]; };
  auto v_in = [&](int i) { return p.vp + i * st[10]; };
  MTile t, t2[2];

  Gate gate;
  float* red;
  float *daf = nullptr, *dbf = nullptr, *drf = nullptr, *dcf = nullptr;
  if constexpr (Gate::kDense) {
    gate = load_dense_gate(wts, C, rest);
    red = rest + dense_gate_floats(C);
  } else {
    float* rowf = rest;
    float* colf = rowf + N * C;
    float* af = colf + N * C;
    float* bfac = af + N * R4;
    daf = bfac + N * R4;
    dbf = daf + N * R4;
    drf = dbf + N * R4;
    dcf = drf + N * C;
    red = dcf + N * C;
    gate = Gate{wts.p[0], wts.p[1], wts.p[2], wts.p[3], r, rowf, colf, af, bfac};
  }

  // ---------------- recompute: S_i, A_i, Ac_i ----------------
  // View i's q and k go to buffers (0, 1) or (2, 3); the next view's copies
  // run while this one's product does.
  stage_async(Bf(0), ldb, q_in(0), st[3], N, dk, vec);
  stage_async(Bf(1), ldb, k_in(0), st[7], N, dk, vec);
  cp_async_commit();
  for (int vi = 0; vi < V; ++vi) {
    const int cur = 2 * (vi & 1);
    if (vi + 1 < V) {
      stage_async(Bf(2 - cur), ldb, q_in(vi + 1), st[3], N, dk, vec);
      stage_async(Bf(3 - cur), ldb, k_in(vi + 1), st[7], N, dk, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    scale_rows(Bf(cur), ldb, N, dk, sc);
    __syncthreads();
    mma_mm(t, {Bf(cur), false}, {Bf(cur + 1), true}, ldb, dk, N, N, 0, false);
    float* Ssm = DSM;  // S_i in shared memory for its means and softmax
    for_tile(t, N, N, 0, [&](int rr, int c, float x) { Ssm[rr * ldm + c] = x; });
    __syncthreads();
    if constexpr (!Gate::kDense) means(Ssm, ldm, N, gate.rowf, gate.colf, C, vi, V + vi, false);
    softmax_rows_tc(Ssm, ldm, p.S(vi), p.A(vi), p.Ac(vi), nw, N);
  }

  // ---------------- recompute: both chains ----------------
  // Left operands (the running c(F_j), c(B_j)) in buffers 0 and 2, right
  // operands (Ac of the next view) in yf, yb, prefetched into nf, nb.
  __syncthreads();
  stage_async(Bf(0), ldb, p.Ac(0), nw, N, N, vn);
  stage_async(Bf(1), ldb, p.Ac(1), nw, N, N, vn);
  stage_async(Bf(2), ldb, p.Ac(V - 1), nw, N, N, vn);
  stage_async(Bf(3), ldb, p.Ac(V - 2), nw, N, N, vn);
  cp_async_commit();
  {
    int yf = 1, yb = 3, nf = 4, nb = 5;
    for (int j = 1; j < V; ++j) {
      cp_async_wait<0>();
      __syncthreads();
      if (j + 1 < V) {
        stage_async(Bf(nf), ldb, p.Ac(j + 1), nw, N, N, vn);
        stage_async(Bf(nb), ldb, p.Ac(V - 2 - j), nw, N, N, vn);
        cp_async_commit();
      }
      MTile tb;
      mma_mm(t, {Bf(0), false}, {Bf(yf), false}, ldb, N, N, N, 0, false);
      mma_mm(tb, {Bf(2), false}, {Bf(yb), false}, ldb, N, N, N, 0, false);
      if (j + 1 == V) {  // the chains' ends feed the logs: fp32, unrounded
        float* fm = p.Fm(V - 1);
        float* bm = p.Bm(V - 1);
        for_pairs(t, N, N, 0, [&](int rr, int c, float x0, float x1) {
          st2(fm + rr * N + c, c, N, x0, x1, vecN);
        });
        for_pairs(tb, N, N, 0, [&](int rr, int c, float x0, float x1) {
          st2(bm + rr * N + c, c, N, x0, x1, vecN);
        });
      } else {
        __syncthreads();  // every warp is done reading buffers 0 and 2
        bf16* fr = p.Fr(j);
        bf16* br = p.Br(j);
        bf16* x0 = Bf(0);
        bf16* x2 = Bf(2);
        for_pairs(t, N, N, 0, [&](int rr, int c, float y0, float y1) {
          st2(fr + rr * nw + c, c, N, y0, y1, true);
          st2(x0 + rr * ldb + c, c, N, y0, y1, true);
        });
        for_pairs(tb, N, N, 0, [&](int rr, int c, float y0, float y1) {
          st2(br + rr * nw + c, c, N, y0, y1, true);
          st2(x2 + rr * ldb + c, c, N, y0, y1, true);
        });
        int tmp = yf;
        yf = nf;
        nf = tmp;
        tmp = yb;
        yb = nb;
        nb = tmp;
      }
    }
  }
  __syncthreads();
  if constexpr (!Gate::kDense) {
    lowrank_factors(p, gate);
    __syncthreads();
  }
  if constexpr (Gate::kDense)
    dense_mix(p, gate, DZ, beta_not);
  else
    gated_mix(p, gate, beta_not);
  __syncthreads();
  softmax_rows<float>(p.ATT(), p.ATT(), N, N);

  // ---------------- recompute: the transport ----------------
  // P_{V-1} = c(Ac_{V-1} v_{V-1}), P_i = c(Ac_i P_{i+1}): Ac_i in buffer x
  // (the next one prefetched into nx), the running P in buffer 1.
  stage_async(Bf(0), ldb, p.Ac(V - 1), nw, N, N, vn);
  stage_async(Bf(1), ldb, v_in(V - 1), st[11], N, dk, vec);
  cp_async_commit();
  {
    int x = 0, nx = 2;
    for (int i = V - 1; i >= 1; --i) {
      cp_async_wait<0>();
      __syncthreads();
      if (i > 1) {
        stage_async(Bf(nx), ldb, p.Ac(i - 1), nw, N, N, vn);
        cp_async_commit();
      }
      for (int ct = 0; ct < n_ct; ++ct)
        mma_mm(t2[ct], {Bf(x), false}, {Bf(1), false}, ldb, N, N, dk, ct * kTile, false);
      __syncthreads();  // every warp is done reading the running P
      bf16* pi = p.P(i);
      bf16* y1 = Bf(1);
      for (int ct = 0; ct < n_ct; ++ct)
        for_pairs(t2[ct], N, dk, ct * kTile, [&](int rr, int c, float v0, float v1) {
          st2(pi + rr * dwd + c, c, dk, v0, v1, true);
          st2(y1 + rr * ldb + c, c, dk, v0, v1, true);
        });
      const int tmp = x;
      x = nx;
      nx = tmp;
    }
  }

  // ---------------- 1. output and transport ----------------
  // dy in buffer 0 throughout; Ac_0, P_1 (buffer 1 already holds it), v_0 and c(att).
  __syncthreads();
  stage_async(Bf(0), ldb, dyp, st[14], N, dk, vec);
  stage_async(Bf(2), ldb, p.Ac(0), nw, N, N, vn);
  stage_async(Bf(3), ldb, v_in(0), st[11], N, dk, vec);
  cp_async_commit();
  stage_round(Bf(4), nullptr, ldb, p.ATT(), N, N, N);
  for (long long idx = tid; idx < (long long)(V - 2) * vsz; idx += kThreads)
    dvp[vsz + idx] = __float2bfloat16(0.f);
  cp_async_wait<0>();
  __syncthreads();
  {  // dw = sum(dy * (Ac_0 P_1))
    float part = 0.f;
    const bf16* dyb = Bf(0);
    for (int ct = 0; ct < n_ct; ++ct) {
      mma_mm(t, {Bf(2), false}, {Bf(1), false}, ldb, N, N, dk, ct * kTile, false);
      for_tile(t, N, dk, ct * kTile, [&](int rr, int c, float x) {
        part = fmaf(x, __bfloat162float(dyb[rr * ldb + c]), part);
      });
    }
    part = warp_sum(part);
    if ((tid & 31) == 0) red[tid >> 5] = part;
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int k = 0; k < kThreads / 32; ++k) s += red[k];
      dw.p[4][bh] = s;
    }
  }
  // dv_0 = c(c(att)^T dy); d att = c(dy v_0^T) into DSM.
  for (int ct = 0; ct < n_ct; ++ct) {
    mma_mm(t, {Bf(4), true}, {Bf(0), false}, ldb, N, N, dk, ct * kTile, false);
    for_pairs(t, N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
      st2(dvp + rr * dk + c, c, dk, x0, x1, vecD);
    });
  }
  mma_mm(t, {Bf(0), false}, {Bf(3), true}, ldb, dk, N, N, 0, false);
  for_tile(t, N, N, 0, [&](int rr, int c, float x) { DSM[rr * ldm + c] = rnd<bf16>(x); });
  __syncthreads();  // buffers 3 and 4 are free: Ac_1 and P_2 (or v_{V-1}) start
  auto issue_transport = [&](int i, int a_buf) {  // Ac_i and P_{i+1} for step i
    stage_async(Bf(a_buf), ldb, p.Ac(i), nw, N, N, vn);
    if (i + 1 < V)
      stage_async(Bf(a_buf + 1), ldb, p.P(i + 1), dwd, N, dk, vd);
    else
      stage_async(Bf(a_buf + 1), ldb, v_in(V - 1), st[11], N, dk, vec);
    cp_async_commit();
  };
  issue_transport(1, 3);
  // dAc_0 = w dy P_1^T (unrounded: the total is rounded once);
  // dP_1 = c(w Ac_0^T dy) into buffer 5.
  mma_mm(t, {Bf(0), false}, {Bf(1), true}, ldb, dk, N, N, 0, false);
  {
    float* da = p.DA(0);
    for_pairs(t, N, N, 0, [&](int rr, int c, float x0, float x1) {
      st2(da + rr * N + c, c, N, w * x0, w * x1, vecN);
    });
  }
  int d = 5, dn = 6;
  {
    bf16* dp = Bf(d);
    for (int ct = 0; ct < n_ct; ++ct) {
      mma_mm(t, {Bf(2), true}, {Bf(0), false}, ldb, N, N, dk, ct * kTile, false);
      for_pairs(t, N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
        st2(dp + rr * ldb + c, c, dk, w * x0, w * x1, true);
      });
    }
    zero_pad(dp, ldb, N, dk);
  }
  // Step i (Ac_i and P_{i+1} in buffers (3, 4) for odd i, (1, 2) for even):
  // dAc_i = dP_i P_{i+1}^T, dP_{i+1} = c(Ac_i^T dP_i); dv_{V-1} = c(Ac_{V-1}^T dP_{V-1}).
  for (int i = 1; i < V; ++i) {
    const int ab = (i & 1) ? 3 : 1;
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < V) issue_transport(i + 1, (i & 1) ? 1 : 3);
    mma_mm(t, {Bf(d), false}, {Bf(ab + 1), true}, ldb, dk, N, N, 0, false);
    float* da = p.DA(i);
    for_pairs(t, N, N, 0, [&](int rr, int c, float x0, float x1) {
      st2(da + rr * N + c, c, N, x0, x1, vecN);
    });
    for (int ct = 0; ct < n_ct; ++ct)
      mma_mm(t2[ct], {Bf(ab), true}, {Bf(d), false}, ldb, N, N, dk, ct * kTile, false);
    if (i + 1 == V) {
      bf16* out = dvp + (V - 1) * vsz;
      for (int ct = 0; ct < n_ct; ++ct)
        for_pairs(t2[ct], N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
          st2(out + rr * dk + c, c, dk, x0, x1, vecD);
        });
    } else {
      bf16* dp = Bf(dn);
      for (int ct = 0; ct < n_ct; ++ct)
        for_pairs(t2[ct], N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
          st2(dp + rr * ldb + c, c, dk, x0, x1, true);
        });
      zero_pad(dp, ldb, N, dk);
      const int tmp = d;
      d = dn;
      dn = tmp;
    }
  }
  __syncthreads();

  // ---------------- 2-4. the mix and the gate head (fp32) ----------------
  softmax_vjp_rows(p.ATT(), N, DSM, ldm, nullptr, 0, N);
  __syncthreads();
  if constexpr (Gate::kDense)
    dense_gate_backward(p, gate, DSM, DZ, dw, bh, beta_not);
  else
    lowrank_gate_backward<false>(p, gate, DSM, DZ, daf, dbf, drf, dcf, wts, dw, bh, beta_not);

  // ---------------- 5. both chains ----------------
  // The top cotangent d c_fwd (d c_bwd) is fp32: split into buffers 0 (hi)
  // and 1 (lo); below it dF_j is rounded in place into buffer 0. Step j's
  // operands (c(F_{j-1}) and Ac_view, or the last pair's Ac_v0 and Ac_v1)
  // alternate between buffers (2, 3) and (4, 5).
  for (int chain = 0; chain < 2; ++chain) {
    auto left = [&](int j) { return chain == 0 ? p.Fr(j) : p.Br(j); };
    auto view = [&](int j) { return chain == 0 ? j : V - 1 - j; };
    auto issue_chain = [&](int j, int pb) {  // operands of step j (j = 1: the last pair)
      if (j >= 2) {
        stage_async(Bf(pb), ldb, left(j - 1), nw, N, N, vn);
        stage_async(Bf(pb + 1), ldb, p.Ac(view(j)), nw, N, N, vn);
      } else {
        stage_async(Bf(pb), ldb, p.Ac(view(0)), nw, N, N, vn);
        stage_async(Bf(pb + 1), ldb, p.Ac(view(1)), nw, N, N, vn);
      }
      cp_async_commit();
    };
    __syncthreads();  // the gate backward (or the last chain) is done with the buffers
    issue_chain(V - 1, 2);
    stage_round(Bf(0), Bf(1), ldb, chain == 0 ? p.Fm(V - 1) : p.Bm(V - 1), N, N, N);
    bool split = true;
    int pb = 2;
    for (int j = V - 1; j >= 2; --j) {
      cp_async_wait<0>();
      __syncthreads();
      issue_chain(j - 1, pb ^ 6);
      // dAc_view += c(F_{j-1})^T dF_j
      mma_mm(t, {Bf(pb), true}, {Bf(0), false}, ldb, N, N, N, 0, false);
      if (split) mma_mm(t, {Bf(pb), true}, {Bf(1), false}, ldb, N, N, N, 0, true);
      add_tile(p.DA(view(j)), N, t, N, N, vecN);
      // dF_{j-1} = c(dF_j Ac_view^T)
      mma_mm(t, {Bf(0), false}, {Bf(pb + 1), true}, ldb, N, N, N, 0, false);
      if (split) mma_mm(t, {Bf(1), false}, {Bf(pb + 1), true}, ldb, N, N, N, 0, true);
      __syncthreads();  // every warp is done reading dF_j
      bf16* d0 = Bf(0);
      for_pairs(t, N, N, 0, [&](int rr, int c, float x0, float x1) {
        st2(d0 + rr * ldb + c, c, N, x0, x1, true);
      });
      split = false;
      pb ^= 6;
    }
    cp_async_wait<0>();
    __syncthreads();
    // dAc_v0 += dF_1 Ac_v1^T, dAc_v1 += Ac_v0^T dF_1
    mma_mm(t, {Bf(0), false}, {Bf(pb + 1), true}, ldb, N, N, N, 0, false);
    if (split) mma_mm(t, {Bf(1), false}, {Bf(pb + 1), true}, ldb, N, N, N, 0, true);
    add_tile(p.DA(view(0)), N, t, N, N, vecN);
    mma_mm(t, {Bf(pb), true}, {Bf(0), false}, ldb, N, N, N, 0, false);
    if (split) mma_mm(t, {Bf(pb), true}, {Bf(1), false}, ldb, N, N, N, 0, true);
    add_tile(p.DA(view(1)), N, t, N, N, vecN);
  }
  __syncthreads();

  // ---------------- 6. score maps, dq and dk ----------------
  // dS_i in full (ds_rows) split into buffers 0 and 1, k_i and q_i in (2, 3)
  // or (4, 5), the next view's copies in flight during this view's products.
  auto issue_view = [&](int vi, int pb) {
    stage_async(Bf(pb), ldb, k_in(vi), st[7], N, dk, vec);
    stage_async(Bf(pb + 1), ldb, q_in(vi), st[3], N, dk, vec);
    cp_async_commit();
  };
  __syncthreads();
  issue_view(0, 2);
  for (int vi = 0; vi < V; ++vi) {
    const int pb = (vi & 1) ? 4 : 2;
    __syncthreads();  // the previous view's products are done with buffers 0 and 1
    ds_rows(p, vi, Gate::kDense ? nullptr : drf, Gate::kDense ? nullptr : dcf, Bf(0), Bf(1), ldb);
    cp_async_wait<0>();
    __syncthreads();
    scale_rows(Bf(pb + 1), ldb, N, dk, sc);
    __syncthreads();
    if (vi + 1 < V) issue_view(vi + 1, pb ^ 6);
    bf16* dqo = dqp + vi * vsz;
    bf16* dko = dkp + vi * vsz;
    for (int ct = 0; ct < n_ct; ++ct) {
      mma_mm(t, {Bf(0), false}, {Bf(pb), false}, ldb, N, N, dk, ct * kTile, false);
      mma_mm(t, {Bf(1), false}, {Bf(pb), false}, ldb, N, N, dk, ct * kTile, true);
      for_pairs(t, N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
        st2(dqo + rr * dk + c, c, dk, rnd<bf16>(x0) * sc, rnd<bf16>(x1) * sc, vecD);
      });
      mma_mm(t, {Bf(0), true}, {Bf(pb + 1), false}, ldb, N, N, dk, ct * kTile, false);
      mma_mm(t, {Bf(1), true}, {Bf(pb + 1), false}, ldb, N, N, dk, ct * kTile, true);
      for_pairs(t, N, dk, ct * kTile, [&](int rr, int c, float x0, float x1) {
        st2(dko + rr * dk + c, c, dk, x0, x1, vecD);
      });
    }
  }
}

// Shared-memory bytes of one bf16 program.
size_t smem_bytes_tc(int V, int N, int dk, int r, bool dense) {
  const int ldm = odd_stride(N), C = 2 * V + 2;
  const size_t gate_maps = dense ? sizeof(float) * dense_scratch_floats(V) : (size_t)16 * N * ldm;
  const size_t region =
      std::max((size_t)kNbuf * kTile * mma_ld(std::max(N, dk)) * 2, gate_maps);
  if (dense)
    return region + sizeof(float) * (round4(N * ldm) + dense_gate_floats(C) + kThreads / 32);
  const size_t common = region + sizeof(float) * (size_t)N * ldm;
  return common + sizeof(float) * (4 * (size_t)N * C + 4 * (size_t)N * 4 * r + kThreads / 32);
}

size_t smem_bytes(int V, int N, int dk, int r, bool dense) {
  const int ldm = odd_stride(N), C = 2 * V + 2;
  const size_t common = 3 * (size_t)buf_floats(N, dk) + (size_t)N * ldm;
  if (dense)
    return sizeof(float) * (round4((int)common + dense_scratch_floats(V)) + dense_gate_floats(C) +
                            kThreads / 32);
  return sizeof(float) *
         (common + 4 * (size_t)N * ldm + 4 * (size_t)N * C + 4 * (size_t)N * 4 * r + kThreads / 32);
}

template <class Gate>
int launch(int dtype, const void* qs, const void* ks, const void* vs, const void* dy, void* dq,
           void* dk_out, void* dv, const Weights& w, const Grads& dw, void* workspace, int B,
           int H, int V, int N, int dk, int r, const long long* st, float beta_not, float scale,
           int vec, cudaStream_t stream) {
  Strides strides;
  for (int i = 0; i < 15; ++i) strides.s[i] = st[i];
  cudaError_t e;
  if (dtype == 0) {
    const size_t smem = smem_bytes(V, N, dk, r, Gate::kDense);
    e = cudaFuncSetAttribute(edgewise_bwd_kernel<float, Gate>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    edgewise_bwd_kernel<float, Gate><<<B * H, kThreads, smem, stream>>>(
        (const float*)qs, (const float*)ks, (const float*)vs, (const float*)dy, (float*)dq,
        (float*)dk_out, (float*)dv, w, dw, (float*)workspace, H, V, N, dk, r, strides, beta_not,
        scale);
  } else {
    const size_t smem = smem_bytes_tc(V, N, dk, r, Gate::kDense);
    e = cudaFuncSetAttribute(edgewise_bwd_tc_kernel<Gate>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    edgewise_bwd_tc_kernel<Gate><<<B * H, kThreads, smem, stream>>>(
        (const bf16*)qs, (const bf16*)ks, (const bf16*)vs, (const bf16*)dy, (bf16*)dq,
        (bf16*)dk_out, (bf16*)dv, w, dw, (unsigned char*)workspace, H, V, N, dk, r, strides,
        beta_not, scale, vec);
  }
  return (int)cudaGetLastError();
}

template <class Gate>
int dispatch(int dtype, const void* qs, const void* ks, const void* vs, const void* dy, void* dq,
             void* dk, void* dv, const void* const* w, void* const* dw, void* workspace, int B,
             int H, int V, int N, int dkh, int r, const long long* strides, float beta_not,
             float scale, int vec, void* stream) {
  if (V < 2 || V > kMaxViews || N < 1 || N > kMaxN || dkh < 1 || dkh > kMaxDk || r < 1 ||
      B < 1 || H < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Weights wts;
  Grads grads;
  for (int i = 0; i < 5; ++i) {
    wts.p[i] = (const float*)w[i];
    grads.p[i] = (float*)dw[i];
  }
  return launch<Gate>(dtype, qs, ks, vs, dy, dq, dk, dv, wts, grads, workspace, B, H, V, N, dkh,
                      r, strides, beta_not, scale, vec, (cudaStream_t)stream);
}

}  // namespace mop

// Shared-memory bytes one program needs (`dtype` 0 fp32, 1 bf16); the Python
// wrapper computes the same count and refuses shapes above the card's
// per-block limit before it launches. `dense` selects the gate head (r is
// ignored for it).
extern "C" long long mop_edgewise_bwd_smem_bytes(int dtype, int V, int N, int dk, int r,
                                                 int dense) {
  return dtype == 1 ? (long long)mop::smem_bytes_tc(V, N, dk, r, dense != 0)
                    : (long long)mop::smem_bytes(V, N, dk, r, dense != 0);
}

// Bytes of one program's device-memory workspace.
extern "C" long long mop_edgewise_bwd_ws_bytes(int dtype, int V, int N, int dk) {
  return dtype == 1 ? mop::tc_ws_bytes(V, N, dk) : 4 * mop::ws_floats(V, N, dk);
}

// C entry points, bound from Python with ctypes. `dtype` is 0 for fp32 and 1
// for bf16. `strides` is a host array of 15 element strides: (b, h, view,
// row) for qs, ks and vs, then (b, h, row) for dy; feature strides are 1.
// dq, dk and dv are contiguous (B, H, V, N, dk) outputs in the input dtype.
// `workspace` holds B*H times mop_edgewise_bwd_ws_bytes bytes, 16-byte
// aligned. `vec` is the width in bytes (16, 8, 4 or 2) of the bf16 kernel's
// asynchronous copies of q, k, v and dy rows, which must divide their
// addresses, strides and rows (the fp32 kernel ignores it). Weights,
// chain_w and the per-program grads are fp32 device arrays; returns a
// cudaError_t code.
//
// Lowrank (K2b): weights wrow, wcol (2V+2, 4r) row-major, brow, bcol (4r,),
// chain_w one scalar; grads dwrow and dwcol (B*H, 2V+2, 4r), dbrow and dbcol
// (B*H, 4r), dchain (B*H,).
extern "C" int mop_edgewise_lowrank_bwd(int dtype, const void* qs, const void* ks,
                                        const void* vs, const void* dy, void* dq, void* dk,
                                        void* dv, const void* wrow, const void* brow,
                                        const void* wcol, const void* bcol, const void* chain_w,
                                        void* dwrow, void* dbrow, void* dwcol, void* dbcol,
                                        void* dchain, void* workspace, int B, int H, int V,
                                        int N, int dkh, int r, const long long* strides,
                                        float beta_not, float scale, int vec, void* stream) {
  const void* w[5] = {wrow, brow, wcol, bcol, chain_w};
  void* dw[5] = {dwrow, dbrow, dwcol, dbcol, dchain};
  return mop::dispatch<mop::LowrankGate>(dtype, qs, ks, vs, dy, dq, dk, dv, w, dw, workspace, B,
                                         H, V, N, dkh, r, strides, beta_not, scale, vec, stream);
}

// Dense (K3b): weights w1 (2V+2, 16) row-major, b1 (16,), w2 (16, 4), b2
// (4,), chain_w one scalar; grads dw1 (B*H, 2V+2, 16), db1 (B*H, 16), dw2
// (B*H, 16, 4), db2 (B*H, 4), dchain (B*H,).
extern "C" int mop_edgewise_dense_bwd(int dtype, const void* qs, const void* ks, const void* vs,
                                      const void* dy, void* dq, void* dk, void* dv,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* chain_w, void* dw1, void* db1,
                                      void* dw2, void* db2, void* dchain, void* workspace, int B,
                                      int H, int V, int N, int dkh, const long long* strides,
                                      float beta_not, float scale, int vec, void* stream) {
  const void* w[5] = {w1, b1, w2, b2, chain_w};
  void* dw[5] = {dw1, db1, dw2, db2, dchain};
  return mop::dispatch<mop::DenseGate>(dtype, qs, ks, vs, dy, dq, dk, dv, w, dw, workspace, B, H,
                                       V, N, dkh, 1, strides, beta_not, scale, vec, stream);
}
