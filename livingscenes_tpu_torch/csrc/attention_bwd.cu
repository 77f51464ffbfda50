// Backward of vector attention (attention.cu): the VJP of
//   out[n] = sum_k softmax_k(logit[n, k, head(o)]) vf[n, k, o]
// w.r.t. the source features, ydst (both branches' W_r - W_l halves times
// dst), q_n, the W_l halves of W_K and W_V, D_K and D_V.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_attention_bwd_kernel. A block
// owns whole destination points (edge_common.cuh), so the softmax over each
// point's K edges and its backward stay inside the block:
//   1. V branch forward: vf, and d_attn[e][h] = sum_{o in h} g[n][o] . vf[o]
//   2. K branch forward: kf, the logits and the softmax (attention.cu),
//      keeping the head sums S_h of kf . q_n
//   3. d_logit = attn (d_attn - sum_k attn d_attn); per edge the cotangent
//      of max(|k|, 1e-12), -(sum_h d_logit_h S_h / sqrt(3 head_c)) / cross^2
//      (masked to cross > 1e-12)
//   4. K branch backward (edge_bwd.cuh branch_bwd): the channel
//      normalisation's VJP per channel gives d_kf, and d_q_n, summed over
//      the point's edges; then d_ydst (K half), d_W_Kl, the scatter of
//      d_y W_Kl to the sources, d_D_K
//   5. V branch backward, from d_vf = attn g: the same for the V half.
// Nothing per edge leaves the block but the scatter to the sources; the
// weight gradients go to the block's replica (edge_bwd.cuh). The tie rules
// are JAX's: where(qpara >= 0, ...), r > 1e-12, max(., 1e-12) in the
// channel normalisation of K.
//
// What bounds it on the H100: operations, per edge 3 (12 O O + 8 C O) flops
// (both branches' conv and direction recomputed, V twice and K twice, d_y
// D, d_D, d_y W_l, d_W_l).
#include "edge_bwd.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, cross, dcross, w, dl, sh, bs, nn, part, y, dkt, total;
  __host__ __device__ Smem(int C, int O, int H) {
    using T = Tile<TX>;
    const int part_size = 2 * T::EB * (O / 4);
    idx = 0;
    cross = idx + T::EB;     // max(|k|, 1e-12) per edge
    dcross = cross + T::EB;  // its cotangent
    w = dcross + T::EB;      // (EB, H) attention weights
    dl = w + T::EB * H;      // (EB, H) d_attn, then d_logit / sqrt(3 head_c)
    sh = dl + T::EB * H;     // (EB, H) head sums of kf . q_n
    bs = sh + T::EB * H;
    nn = bs + T::BS;
    part = nn + T::EB * 3 * row_stride(C);  // partial sums, later the K sum
    y = part + (part_size > T::RED ? part_size : T::RED);
    dkt = y + T::EB * 3 * row_stride(O);
    total = dkt + T::EB * 3 * (T::OT + 4);
  }
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
    attention_bwd_kernel(const float* __restrict__ src,
                         const float* __restrict__ ydst,
                         const float* __restrict__ qn,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ wl_t,
                         const float* __restrict__ WK,
                         const float* __restrict__ WV,
                         const float* __restrict__ dk_t,
                         const float* __restrict__ dv_t,
                         const float* __restrict__ DK,
                         const float* __restrict__ DV,
                         const float* __restrict__ g, float* d_src,
                         float* __restrict__ d_ydst, float* __restrict__ d_qn,
                         float* rep, int Ns, int Nd, int C, int O, int K,
                         int head_c, float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  constexpr int NT = BwdTiles<TX>::NT;
  const int H = O / head_c, Oq = O / 4;
  const Smem<TX> lay(C, O, H);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* cross_s = smem + lay.cross;
  float* dcross_s = smem + lay.dcross;
  float* w_s = smem + lay.w;
  float* dl_s = smem + lay.dl;
  float* sh_s = smem + lay.sh;
  float* Bs = smem + lay.bs;
  float* nn_s = smem + lay.nn;
  float* sq = smem + lay.part;
  float* c2q = sq + T::EB * Oq;
  float* y_s = smem + lay.y;
  float* dkt = smem + lay.dkt;
  const int ldn = row_stride(C), ldy = row_stride(O), ldt = T::OT + 4;
  const Block blk = make_block<TX>(Nd, K);
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  const float* ydst_b = ydst + (size_t)blk.b * Nd * 3 * (2 * O);
  const float* qn_b = qn + (size_t)blk.b * Nd * O * 3;
  const float* g_b = g + (size_t)blk.b * Nd * O * 3;
  float* dsrc_b = d_src + (size_t)blk.b * Ns * C * 3;
  float* dydst_b = d_ydst + (size_t)blk.b * Nd * 3 * (2 * O);
  float* rep_b = replica(rep, (size_t)C * 2 * O + 2 * (size_t)O * O);
  float* dWl = rep_b;                      // (C, 2 O) = d(W_l^T), K then V
  float* dDK = rep_b + (size_t)C * 2 * O;  // (O, O)
  float* dDV = dDK + (size_t)O * O;

  load_idx<TX>(idx_s, idx, blk);
  zero_pad(nn_s, T::EB * 3, ldn, C);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  gather_rows<TX>(nn_s, ldn, src + (size_t)blk.b * Ns * C * 3, C, idx_s);
  __syncthreads();

  float acc[kEPT][3][4];
  // 1. V branch forward: sq[e][o / 4] = sum of g[n][o'] . vf[o'] over the
  // thread's four columns; then their head sums, d_attn, into dl_s
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t + O, 2 * O, O, ydst_b + O, 2 * O,
                blk, Bs);
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, dv_t, O, o0, O, Bs);
    const int o = o0 + 4 * to;
    if (o >= O) continue;
    activate<TX>(acc, y_s, ldy, o, slope);
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
      if (e >= blk.e_act) continue;
      const float* gp = g_b + ((size_t)(blk.n0 + e / K) * O + o) * 3;
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int i = 0; i < 3; ++i) s += gp[3 * v + i] * acc[j][i][v];
      sq[e * Oq + o / 4] = s;
    }
  }
  __syncthreads();
  const int hq = head_c / 4;
  for (int t = threadIdx.x; t < blk.e_act * H; t += kThreads) {
    const int e = t / H, h = t % H;
    float s = 0.0f;
    for (int q = 0; q < hq; ++q) s += sq[e * Oq + h * hq + q];
    dl_s[e * H + h] = s;
  }
  __syncthreads();

  // 2. K branch forward, as attention.cu
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t, 2 * O, O, ydst_b, 2 * O, blk,
                Bs);
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, dk_t, O, o0, O, Bs);
    const int o = o0 + 4 * to;
    if (o < O) {
      activate<TX>(acc, y_s, ldy, o, slope);
      key_scores<TX>(acc, qn_b, O, o, sq, c2q, blk);
    }
  }
  attention_weights(sq, c2q, cross_s, w_s, sh_s, O, head_c, blk);

  // 3. the softmax's backward over each (point, head), then per edge the
  // cotangent of cross; dl_s ends as d_logit / sqrt(3 head_c) = d(q.k)
  for (int t = threadIdx.x; t < (blk.e_act / K) * H; t += kThreads) {
    const int nl = t / H, h = t % H;
    float* a = w_s + nl * K * H + h;
    float* d = dl_s + nl * K * H + h;
    float s = 0.0f;
    for (int k = 0; k < K; ++k) s += a[k * H] * d[k * H];
    for (int k = 0; k < K; ++k) d[k * H] = a[k * H] * (d[k * H] - s);
  }
  __syncthreads();
  const float inv_s = 1.0f / sqrtf((float)(3 * head_c));
  for (int e = threadIdx.x; e < blk.e_act; e += kThreads) {
    float s = 0.0f;
    for (int h = 0; h < H; ++h) {
      const float dq = dl_s[e * H + h] * inv_s;
      dl_s[e * H + h] = dq;
      s += dq * sh_s[e * H + h];
    }
    const float mc = cross_s[e];
    dcross_s[e] = mc > 1e-12f ? -s / (mc * mc) : 0.0f;
  }
  __syncthreads();

  // 4. K branch backward (y_s still holds the K rows)
  float* dqn_b = d_qn + (size_t)blk.b * Nd * O * 3;
  auto up_k = [&](const float (&kd)[kEPT][3][4], int o0,
                  float (&df)[kEPT][3][4]) {
    float qacc[kEPT][3][4];
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int o = o0 + 4 * to + v;
#pragma unroll
        for (int i = 0; i < 3; ++i) df[j][i][v] = qacc[j][i][v] = 0.0f;
        if (e >= blk.e_act || o >= O) continue;
        const float yv[3] = {y_s[(e * 3) * ldy + o], y_s[(e * 3 + 1) * ldy + o],
                             y_s[(e * 3 + 2) * ldy + o]};
        const float k3[3] = {kd[j][0][v], kd[j][1][v], kd[j][2][v]};
        float f[3];
        vec_act(yv, k3, slope, f);
        const float* qp = qn_b + ((size_t)(blk.n0 + e / K) * O + o) * 3;
        const float knorm =
            sqrtf(fmaxf(f[0] * f[0] + f[1] * f[1] + f[2] * f[2], 0.0f));
        const float mk = fmaxf(knorm, 1e-12f), mc = cross_s[e];
        const float a = knorm / mc, scale = a / mk;
        const float dqk = dl_s[e * H + o / head_c];
        const float dot = f[0] * qp[0] + f[1] * qp[1] + f[2] * qp[2];
        const float d_scale = dqk * dot;
        const float d_a = d_scale / mk;
        const float d_mk = -d_scale * a / (mk * mk);
        const float d_knorm = (knorm > 1e-12f ? d_mk : 0.0f) + d_a / mc +
                              dcross_s[e] * knorm / mc;
        const float coef = d_knorm / mk;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          df[j][i][v] = dqk * qp[i] * scale + coef * f[i];
          qacc[j][i][v] = dqk * (f[i] * scale);
        }
      }
    }
    weighted_sum_store<TX>(qacc, nullptr, 0, 1, sq, dqn_b, O, o0, 1.0f, blk);
  };
  float dy[NT][kEPT][3][4];
  branch_bwd<TX, NT>(dy, y_s, ldy, O, dk_t, DK, dkt, ldt, Bs, dDK, blk, slope,
                     up_k);
  store_rows<TX, NT>(dy, y_s, ldy, O);
  sum_over_k(y_s, ldy, O, dydst_b, 2 * O, blk);
  wgrad(dWl, 2 * O, nn_s, ldn, C, y_s, ldy, O, 3 * blk.e_act);
  scatter_sources<TX>(y_s, ldy, O, WK, 2 * C, C, dsrc_b, idx_s, blk, Bs);

  // 5. V branch backward: the rows again, then d_vf = attn g
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t + O, 2 * O, O, ydst_b + O, 2 * O,
                blk, Bs);
  auto up_v = [&](const float (&)[kEPT][3][4], int o0,
                  float (&df)[kEPT][3][4]) {
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
      const int n = blk.n0 + e / K;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int o = o0 + 4 * to + v;
        const bool live = e < blk.e_act && o < O;
        const float wt = live ? w_s[e * H + o / head_c] : 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          df[j][i][v] = live ? g_b[((size_t)n * O + o) * 3 + i] * wt : 0.0f;
      }
    }
  };
  branch_bwd<TX, NT>(dy, y_s, ldy, O, dv_t, DV, dkt, ldt, Bs, dDV, blk, slope,
                     up_v);
  store_rows<TX, NT>(dy, y_s, ldy, O);
  sum_over_k(y_s, ldy, O, dydst_b + O, 2 * O, blk);
  wgrad(dWl + O, 2 * O, nn_s, ldn, C, y_s, ldy, O, 3 * blk.e_act);
  scatter_sources<TX>(y_s, ldy, O, WV, 2 * C, C, dsrc_b, idx_s, blk, Bs);
}

template <int TX>
int launch(const float* src, const float* ydst, const float* qn,
           const int32_t* idx, const float* wl_t, const float* WK,
           const float* WV, const float* dk_t, const float* dv_t,
           const float* DK, const float* DV, const float* g, float* d_src,
           float* d_ydst, float* d_qn, float* rep, float* out, int B, int Ns,
           int Nd, int C, int O, int K, int head_c, float slope,
           cudaStream_t stream) {
  const Smem<TX> lay(C, O, O / head_c);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((Nd + tn - 1) / tn, B);
  attention_bwd_kernel<TX><<<grid, kThreads, bytes, stream>>>(
      src, ydst, qn, idx, wl_t, WK, WV, dk_t, dv_t, DK, DV, g, d_src, d_ydst,
      d_qn, rep, Ns, Nd, C, O, K, head_c, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_replicas(rep, out, 2 * C * O + 2 * O * O, stream);
}

}  // namespace

// src (B, Ns, C, 3); ydst (B, Nd, 3, 2 O) and wl_t (C, 2 O) as attention.cu
// takes them; W_K, W_V (O, 2 C); dk_t, dv_t = D_K^T, D_V^T and D_K, D_V
// (O, O); qn, g (B, Nd, O, 3). d_src (B, Ns, C, 3) and rep (kReplicas, 2 C O +
// 2 O O) zeroed by the caller; d_ydst (B, Nd, 3, 2 O); d_qn (B, Nd, O, 3);
// out (2 C O + 2 O O) receives [d(W_l^T) (C, 2 O) | d_D_K | d_D_V]. f32,
// contiguous. C, O, head_c multiples of 4, head_c divides O, O up to 512,
// 1 <= K <= 16.
extern "C" int lstpu_edge_attention_bwd(
    const void* src, const void* ydst, const void* qn, const void* idx,
    const void* wl_t, const void* WK, const void* WV, const void* dk_t,
    const void* dv_t, const void* DK, const void* DV, const void* g,
    void* d_src, void* d_ydst, void* d_qn, void* rep, void* out, int B, int Ns,
    int Nd, int C, int O, int K, int head_c, float slope, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || head_c <= 0 ||
      C % 4 || O % 4 || head_c % 4 || O % head_c || O > kMaxTiles * 128 ||
      K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto m = [](void* p) { return static_cast<float*>(p); };
  auto i = static_cast<const int32_t*>(idx);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(f(src), f(ydst), f(qn), i, f(wl_t), f(WK), f(WV),
                       f(dk_t), f(dv_t), f(DK), f(DV), f(g), m(d_src),
                       m(d_ydst), m(d_qn), m(rep), m(out), B, Ns, Nd, C, O, K,
                       head_c, slope, st);
    case 16:
      return launch<16>(f(src), f(ydst), f(qn), i, f(wl_t), f(WK), f(WV),
                        f(dk_t), f(dv_t), f(DK), f(DV), f(g), m(d_src),
                        m(d_ydst), m(d_qn), m(rep), m(out), B, Ns, Nd, C, O, K,
                        head_c, slope, st);
    default:
      return launch<32>(f(src), f(ydst), f(qn), i, f(wl_t), f(WK), f(WV),
                        f(dk_t), f(dv_t), f(DK), f(DV), f(g), m(d_src),
                        m(d_ydst), m(d_qn), m(rep), m(out), B, Ns, Nd, C, O, K,
                        head_c, slope, st);
  }
}
