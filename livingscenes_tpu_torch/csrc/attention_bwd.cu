// Backward of vector attention (attention.cu): the VJP of
//   out[n] = sum_k softmax_k(logit[n, k, head(o)]) vf[n, k, o]
// w.r.t. the source features, ydst (both branches' W_r - W_l halves times
// dst), q_n, the W_l halves of W_K and W_V, D_K and D_V.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_attention_bwd_kernel, which
// recomputes the forward per edge (both edge convolutions and direction
// products) and runs every product of the VJP per edge. Per branch, for
// edge e = (n, k) with source j = idx[n, k], the forward is linear in the
// per-point rows of attention.cu (point_products.cuh):
//   y[e] = Ysrc[j] + Ydst[n],  D y[e] = Kdsrc[j] + Kddst[n]
// with P_src = src [W_l | D W_l] and P_dst = dst [W_delta | D W_delta]. Only
// the activation, the channel normalisation, the head scores and the
// softmax are per edge; they give per edge the cotangents d_y[e] and
// d_kd[e] (O x 3 each) of y and D y. Everything after them is linear. With
// U_j, V_j the sums of d_y and d_kd over the edges whose source is j, and
// Ub_n, Vb_n the sums over n's own K edges:
//   d_src[j]  = W_l^T U_j + (D W_l)^T V_j = W_l^T Z_j,  Z_j = U_j + D^T V_j
//   d_ydst[n] = Ub_n + D^T Vb_n = Z_n,  d_dst[n] = W_delta^T Z_n
//   d_D       = sum_j V_j Ysrc_j^T + sum_n Vb_n Ydst_n^T
//   d_W_l     = sum_j Z_j src_j^T,  d_W_delta = sum_n Z_n dst_n^T
// so the products run once per point or as reductions over the points.
// Six launches a layer, the edge pass counted apart from the five others:
//
// 1. lstpu_attention_products (attention.cu, two launches): P_src and P_dst
//    again. The autograd Function saves only its inputs (the forward's rows
//    are 200 MB at layer 2), so the backward recomputes them.
// 2. attention_bwd_edges_kernel (this file, one launch): per edge the
//    nonlinear VJP. Thread layout of attention.cu's edge pass: a block of
//    256 threads owns P = 256 / (O / 4) destination points with all their
//    edges, thread (point, quad) 4 channels of one point, so the
//    destination's rows, q_n and the cotangent g stay in its registers
//    while it walks the point's K edges three times (K forward: the
//    scores; V forward and backward: d_attn, and the VJP from
//    d_vf = attn g; K backward), each time gathering its source's 16-byte
//    pieces of the Y and Kd rows from L2.
//    The softmax and its backward over each (point, head) stay in shared
//    memory, as in attention.cu. It sums d_q_n, Ub_n and Vb_n over the K
//    edges in ascending k in registers and writes them once; U_j and V_j
//    go to the sources as vector float atomics (atomicAdd on a float4, one
//    red.global.add.v4.f32 on sm_90) into a zeroed buffer with P_src's
//    layout: 12 O floats an edge over both branches.
// 3. lstpu_attention_bwd_products (this file, three launches of
//    point_products.cuh edge_bwd_products, shared with mean_edge_bwd.cu's
//    one branch): Z = U + D^T V for every source and destination
//    row (in place of U) beside the split reductions of d_D_K and d_D_V;
//    then d_src = Z_src W_l and d_dst = Z_dst W_delta (per point) beside
//    the split reductions of d_W_l and d_W_delta; then the fold of the
//    reductions' partial sums.
//
// What bounds it on the H100: operations (chip_smoke.py edge_work with
// backward=True counts the same products once per point): the per-point
// products of point_products.cuh, and per edge and channel the two
// activations, their VJPs, the channel normalisation's and the softmax's.
// The edge pass gathers 3 x 24 O bytes an edge from L2 and adds 48 O bytes
// an edge by atomics.
//
// Sums: U_j and V_j are added with float atomics in no fixed order, so
// d_src, d_W_l and d_D agree with the plain version to rounding, not bit
// for bit, and differ from run to run at rounding; the reductions over the
// points and every sum over a point's own edges are in a fixed order. The
// tie rules are JAX's: where(qpara >= 0, ...), r > 1e-12, max(., 1e-12) in
// the channel normalisation of K.
#include "edge_common.cuh"
#include "point_products.cuh"

namespace {

using namespace lstpu_edge;

constexpr int kMaxO = 512;

// float offsets into the dynamic shared memory of the edge pass
struct EdgeBwdSmem {
  int idx, cross, dcross, w, dl, sh, sq, c2q, total;
  __host__ __device__ EdgeBwdSmem(int O, int K, int head_c) {
    const int Oq = O / 4, E = (kThreads / Oq) * K, H = O / head_c;
    idx = 0;
    cross = idx + E;       // max(|k|, 1e-12) per edge
    dcross = cross + E;    // its cotangent
    w = dcross + E;        // (E, H) softmax weights
    dl = w + E * H;        // (E, H) d_attn, then d_logit / sqrt(3 head_c)
    sh = dl + E * H;       // (E, H) head sums of kf . q_n
    sq = sh + E * H;       // (E, O / 4) partial sums of g . vf, then kf . q_n
    c2q = sq + E * Oq;     // (E, O / 4) partial sums of knorm^2
    total = c2q + E * Oq;
  }
};

// two blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
    attention_bwd_edges_kernel(const float* __restrict__ psrc,
                               const float* __restrict__ pdst,
                               const float* __restrict__ qn,
                               const int32_t* __restrict__ idx,
                               const float* __restrict__ g, float* gsrc,
                               float* __restrict__ gdst,
                               float* __restrict__ dqn, int Ns, int Nd, int O,
                               int K, int head_c, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int Oq = O / 4, H = O / head_c, P = kThreads / Oq;
  const EdgeBwdSmem lay(O, K, head_c);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* cross_s = smem + lay.cross;
  float* dcross_s = smem + lay.dcross;
  float* w_s = smem + lay.w;
  float* dl_s = smem + lay.dl;
  float* sh_s = smem + lay.sh;
  float* sq = smem + lay.sq;
  float* c2q = smem + lay.c2q;

  Block blk;
  blk.b = blockIdx.y;
  blk.tn = P;
  blk.n0 = blockIdx.x * P;
  blk.e_act = min(P, Nd - blk.n0) * K;
  blk.K = K;
  blk.Nd = Nd;
  const int32_t* idx_b = idx + ((size_t)blk.b * Nd + blk.n0) * K;
  for (int e = threadIdx.x; e < blk.e_act; e += kThreads) idx_s[e] = idx_b[e];
  __syncthreads();

  const int ld = 4 * O;  // row length of the per-point products
  const int pl = threadIdx.x / Oq, o = 4 * (threadIdx.x % Oq);
  const int n = blk.n0 + pl;
  const bool on = pl < P && n < Nd;
  const size_t pt = (size_t)blk.b * Nd + n;  // the destination point
  const float* psrc_b = psrc + (size_t)blk.b * Ns * 3 * ld;
  const float* pdst_n = pdst + pt * 3 * ld;
  float* gsrc_b = gsrc + (size_t)blk.b * Ns * 3 * ld;
  const int* idx_n = idx_s + pl * K;
  // g[n][o..o+3][0..2] and q_n likewise, each loaded where it is used
  const float* g_n = g + (pt * O + o) * 3;
  const float* q_nn = qn + (pt * O + o) * 3;
  float gq[12], q[12], yd[3][4], kdd[3][4], f[3][4];

  // 1. K branch forward, as attention.cu: the key scores, then cross, the
  // logits and the softmax (attention_weights), with the head sums in sh_s
  if (on) {
    load_quad(q_nn, q);
    load12(pdst_n + o, yd, ld);
    load12(pdst_n + 2 * O + o, kdd, ld);
    for (int k = 0; k < K; ++k) {
      edge_features(psrc_b + (size_t)idx_n[k] * 3 * ld + o, ld, yd, kdd,
                    slope, f);
      const int e = pl * K + k;
      quad_key_score(f, q, sq[e * Oq + o / 4], c2q[e * Oq + o / 4]);
    }
  }
  attention_weights(sq, c2q, cross_s, w_s, sh_s, O, head_c, blk);

  float* gdst_n = gdst + pt * 3 * ld;
  const int head = o / head_c;  // the quad lies in one head
  float y[3][4], kd[3][4], dy[3][4], dkd[3][4], ub[3][4], vb[3][4];

  // 2. V branch, forward and backward in one walk over the edges: vf gives
  // sq[e][o / 4], the sum of g[n][o'] . vf[o'] over the thread's four
  // channels (its head sums are d_attn), and d_vf = attn g the activation's
  // VJP d_y and d_kd
  if (on) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) ub[i][v] = vb[i][v] = 0.0f;
    load_quad(g_n, gq);
    load12(pdst_n + O + o, yd, ld);
    load12(pdst_n + 3 * O + o, kdd, ld);
    for (int k = 0; k < K; ++k) {
      const int j = idx_n[k], e = pl * K + k;
      edge_rows(psrc_b + (size_t)j * 3 * ld + O + o, 2 * O, ld, yd, kdd, y,
                kd);
      const float wt = w_s[e * H + head];
      float s = 0.0f;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float yv[3] = {y[0][v], y[1][v], y[2][v]};
        const float k3[3] = {kd[0][v], kd[1][v], kd[2][v]};
        float fv[3], gy[3], gk[3];
        vec_act(yv, k3, slope, fv);
#pragma unroll
        for (int i = 0; i < 3; ++i) s += gq[3 * v + i] * fv[i];
        const float df[3] = {gq[3 * v] * wt, gq[3 * v + 1] * wt,
                             gq[3 * v + 2] * wt};
        vec_act_bwd(yv, k3, df, slope, gy, gk);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          dy[i][v] = gy[i];
          dkd[i][v] = gk[i];
          ub[i][v] += gy[i];
          vb[i][v] += gk[i];
        }
      }
      sq[e * Oq + o / 4] = s;
      float* gs = gsrc_b + (size_t)j * 3 * ld + O + o;
      add12(gs, ld, dy);
      add12(gs + 2 * O, ld, dkd);
    }
    store12(gdst_n + O + o, ld, ub);
    store12(gdst_n + 3 * O + o, ld, vb);
  }
  __syncthreads();
  const int hq = head_c / 4;
  for (int t = threadIdx.x; t < blk.e_act * H; t += kThreads) {
    const int e = t / H, h = t % H;
    float s = 0.0f;
    for (int p = 0; p < hq; ++p) s += sq[e * Oq + h * hq + p];
    dl_s[e * H + h] = s;
  }
  __syncthreads();

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
  if (!on) return;

  // 4. K branch backward: the channel normalisation's VJP per channel gives
  // d_kf and d_q_n, then the activation's VJP d_y and d_kd
  float dq_acc[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) ub[i][v] = vb[i][v] = dq_acc[i][v] = 0.0f;
  load_quad(q_nn, q);
  load12(pdst_n + o, yd, ld);
  load12(pdst_n + 2 * O + o, kdd, ld);
  for (int k = 0; k < K; ++k) {
    const int j = idx_n[k], e = pl * K + k;
    edge_rows(psrc_b + (size_t)j * 3 * ld + o, 2 * O, ld, yd, kdd, y, kd);
    const float mc = cross_s[e], dcr = dcross_s[e], dqk = dl_s[e * H + head];
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float yv[3] = {y[0][v], y[1][v], y[2][v]};
      const float k3[3] = {kd[0][v], kd[1][v], kd[2][v]};
      float fv[3];
      vec_act(yv, k3, slope, fv);
      const float* qv = q + 3 * v;
      const float knorm =
          sqrtf(fmaxf(fv[0] * fv[0] + fv[1] * fv[1] + fv[2] * fv[2], 0.0f));
      const float mk = fmaxf(knorm, 1e-12f);
      const float a = knorm / mc, scale = a / mk;
      const float dot = fv[0] * qv[0] + fv[1] * qv[1] + fv[2] * qv[2];
      const float d_scale = dqk * dot;
      const float d_a = d_scale / mk;
      const float d_mk = -d_scale * a / (mk * mk);
      const float d_knorm =
          (knorm > 1e-12f ? d_mk : 0.0f) + d_a / mc + dcr * knorm / mc;
      const float coef = d_knorm / mk;
      float df[3], gy[3], gk[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        df[i] = dqk * qv[i] * scale + coef * fv[i];
        dq_acc[i][v] += dqk * (fv[i] * scale);
      }
      vec_act_bwd(yv, k3, df, slope, gy, gk);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dy[i][v] = gy[i];
        dkd[i][v] = gk[i];
        ub[i][v] += gy[i];
        vb[i][v] += gk[i];
      }
    }
    float* gs = gsrc_b + (size_t)j * 3 * ld + o;
    add12(gs, ld, dy);
    add12(gs + 2 * O, ld, dkd);
  }
  store12(gdst_n + o, ld, ub);
  store12(gdst_n + 2 * O + o, ld, vb);
  // d_q_n[n][o..o+3][0..2]: 12 floats in (channel, component) order
  float4* dq4 = reinterpret_cast<float4*>(dqn + (pt * O + o) * 3);
  dq4[0] = make_float4(dq_acc[0][0], dq_acc[1][0], dq_acc[2][0], dq_acc[0][1]);
  dq4[1] = make_float4(dq_acc[1][1], dq_acc[2][1], dq_acc[0][2], dq_acc[1][2]);
  dq4[2] = make_float4(dq_acc[2][2], dq_acc[0][3], dq_acc[1][3], dq_acc[2][3]);
}

}  // namespace

// The edge pass. psrc (B, Ns, 3, 4 O), pdst (B, Nd, 3, 4 O) the per-point
// rows of lstpu_attention_products, columns [Y_K | Y_V | Kd_K | Kd_V]; qn,
// g (B, Nd, O, 3) the channel-normalised queries and the cotangent; idx
// (B, Nd, K) int32 in [0, Ns). Adds U_j, V_j into gsrc (B, Ns, 3, 4 O),
// zeroed by the caller, and writes Ub_n, Vb_n to gdst (B, Nd, 3, 4 O), both
// with columns [U_K | U_V | V_K | V_V], and d_qn (B, Nd, O, 3). f32,
// contiguous. O and head_c multiples of 4, head_c divides O, O <= 512,
// 1 <= K <= 16.
extern "C" int lstpu_edge_attention_bwd(const void* psrc, const void* pdst,
                                        const void* qn, const void* idx,
                                        const void* g, void* gsrc, void* gdst,
                                        void* dqn, int B, int Ns, int Nd,
                                        int O, int K, int head_c, float slope,
                                        void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || O <= 0 || head_c <= 0 || O % 4 ||
      head_c % 4 || O % head_c || O > kMaxO || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const EdgeBwdSmem lay(O, K, head_c);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int P = kThreads / (O / 4);
  const dim3 grid((Nd + P - 1) / P, B);
  attention_bwd_edges_kernel<<<grid, kThreads, bytes,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psrc), static_cast<const float*>(pdst),
      static_cast<const float*>(qn), static_cast<const int32_t*>(idx),
      static_cast<const float*>(g), static_cast<float*>(gsrc),
      static_cast<float*>(gdst), static_cast<float*>(dqn), Ns, Nd, O, K,
      head_c, slope);
  return (int)cudaGetLastError();
}

// The linear rest of the backward. grows (B (Ns + Nd), 3, 4 O): the source
// rows' U, V (the edge pass's gsrc), then the destination rows' Ub, Vb
// (gdst), columns [U_K | U_V | V_K | V_V]; prows the same points' P_src,
// P_dst rows (columns [Y_K | Y_V | Kd_K | Kd_V]); src3 (B, Ns, 3, C) and
// dst3 (B, Nd, 3, C) the features, components first; W_l, W_delta (2 O, C)
// = [W_Kl; W_Vl] and the W_r - W_l halves; D_K, D_V (O, O). Writes
// Z = U + D^T V over U in grows, dsrc3 (B, Ns, 3, C) = Z_src W_l, ddst3
// (B, Nd, 3, C) = Z_dst W_delta, and out (4 C O + 2 O O) = [d_W_l (2 O, C)
// | d_D_K | d_D_V | d_W_delta (2 O, C)] through part, scratch of
// lstpu_edge_bwd_splits(B, Ns, Nd) x (4 C O + 2 O O) floats. f32,
// contiguous, C and O multiples of 4. Three launches on `stream`.
extern "C" int lstpu_attention_bwd_products(
    void* grows, const void* prows, const void* src3, const void* dst3,
    const void* W_l, const void* W_delta, const void* D_K, const void* D_V,
    void* dsrc3, void* ddst3, void* part, void* out, int B, int Ns, int Nd,
    int C, int O, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || C % 4 || O % 4)
    return (int)cudaErrorInvalidValue;
  const float* D[2] = {static_cast<const float*>(D_K),
                       static_cast<const float*>(D_V)};
  return lstpu_points::edge_bwd_products(
      static_cast<float*>(grows), static_cast<const float*>(prows),
      static_cast<const float*>(src3), static_cast<const float*>(dst3),
      static_cast<const float*>(W_l), static_cast<const float*>(W_delta), D, 2,
      static_cast<float*>(dsrc3), static_cast<float*>(ddst3),
      static_cast<float*>(part), static_cast<float*>(out), B, Ns, Nd, C, O,
      static_cast<cudaStream_t>(stream));
}

// The count of partial sums that the edge backwards' products
// (lstpu_attention_bwd_products here, lstpu_mean_bwd_products in
// mean_edge_bwd.cu: point_products.cuh edge_bwd_products) need scratch for.
extern "C" int lstpu_edge_bwd_splits(int B, int Ns, int Nd) {
  return lstpu_points::reduction_splits(3 * B * (Ns + Nd));
}
