// Vector attention over the kNN graph: gather, the K and V edge VecLNAs,
// channel normalisation of K, q.k per head, softmax over the K neighbours,
// weighted sum of V.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_attention_kernel. Per edge e of
// destination point n (W_l, ydst as in mean_edge.cu, one pair per branch):
//
//   kf = act_K(W_Kl nn + ydst_K),  vf = act_V(W_Vl nn + ydst_V)   (O, 3)
//   knorm[o] = |kf[o]|,  cross = sqrt(sum_o knorm[o]^2)
//   k_n[o] = kf[o] * (knorm[o] / max(cross, 1e-12)) / max(knorm[o], 1e-12)
//   logit[h] = sum_{o in head h} k_n[o] . q_n[n][o] / sqrt(3 head_c)
//   out[n][o] = sum_k softmax_k(logit)[head(o)] vf[o]
//
// The TPU kernel runs the C x O edge convolution and the O x O direction
// product of both branches once per edge. Both are linear in the gathered
// row:
//   y[e]   = (W_l src)[idx[e]] + (W_delta dst)[n]
//   D y[e] = (D W_l src)[idx[e]] + (D W_delta dst)[n]
// so this file computes them once per point and leaves the edges only the
// work that is not linear. Two stages, three launches a layer:
//
// 1. lstpu_attention_products (point_products.cuh). A first launch forms
//    the weight products D W_l and D W_delta (K and V branches; C x O x O
//    each, a few blocks) beside W_l^T and W_delta^T, the second multiplies
//    every point's (3, C) rows by them: P_src = src [W_l | D W_l] and P_dst
//    = dst [W_delta | D W_delta], (B, N, 3, 4 O), columns [Y_K | Y_V |
//    Kd_K | Kd_V]. Per point 2 C x 4 O flops instead of 2 (C + O) x 2 O for
//    W then D, and no launch waits on a product of points. About 40 GFLOP
//    an encode of the production encoder (B = 64), against 322 GFLOP for
//    the same products per edge. Bound: operations at layers 4-6, bytes at
//    layers 2-3.
// 2. attention_edges_kernel: per edge, gather the Y and Kd rows of its
//    source and add the destination's; then the activation (vec_act), the
//    key scores, the softmax over K and the weighted sum of V, with the
//    rules, epsilons and the order of the sum over K of edge_common.cuh. No
//    product is left per edge. Bound: the gathered bytes, 2 branches x 2
//    rows x 3 x O floats = 48 O bytes an edge (at B = 64 and K = 16: 1.6 GB
//    at layers 2 and 3, 0.8 GB at layers 4 and 6, 0.4 GB at layer 5, an
//    encode), against 4 (B Ns + B Nd) 12 O bytes of distinct rows (300 MB
//    at layer 2). Each source row serves K = 16 edges on average, so the
//    reuse has to come from the L2 cache (50 MB): the grid runs an
//    instance's blocks one after the other (x over its points, y over
//    instances), and one instance's P_src is 3.1 MB at layer 2 and 0.8 MB
//    at layer 6.
//    Design: a block of 256 threads owns P = 256 / (O / 4) destination
//    points with all their edges; thread (point, quad) owns 4 channels of
//    one point, so the destination rows and q_n stay in its registers while
//    it walks the point's K edges, each load a 16-byte piece of a row that
//    the point's other threads read beside it. The K branch leaves per
//    (edge, quad) partial sums in shared memory (quad_key_score); the block
//    turns them into softmax weights (attention_weights) and walks the
//    edges again for V, summing w f in ascending k in registers.
//
// Rounding: D (W a + W b) becomes (D W) a + (D W) b, so results move by
// about an f32 ulp of the terms against the TPU kernel's association. The
// backward kernel (attention_bwd.cu) recomputes the same rows with this
// file's lstpu_attention_products and the same per-edge sums.
#include "edge_common.cuh"
#include "point_products.cuh"

namespace {

using namespace lstpu_edge;

// float offsets into the dynamic shared memory of attention_edges_kernel
struct EdgeSmem {
  int idx, cross, w, sq, c2q, total;
  __host__ __device__ EdgeSmem(int O, int K, int head_c) {
    const int Oq = O / 4, E = (kThreads / Oq) * K, H = O / head_c;
    idx = 0;
    cross = idx + E;
    w = cross + E;         // (E, H) logits, then softmax weights
    sq = w + E * H;        // (E, O / 4) partial sums of kf.q_n per 4 channels
    c2q = sq + E * Oq;     // (E, O / 4) partial sums of knorm^2
    total = c2q + E * Oq;
  }
};

__global__ void __launch_bounds__(kThreads)
    attention_edges_kernel(const float* __restrict__ psrc,
                           const float* __restrict__ pdst,
                           const float* __restrict__ qn,
                           const int32_t* __restrict__ idx,
                           float* __restrict__ out, int Ns, int Nd, int O,
                           int K, int head_c, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int Oq = O / 4, H = O / head_c, P = kThreads / Oq;
  const EdgeSmem lay(O, K, head_c);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* cross_s = smem + lay.cross;
  float* w_s = smem + lay.w;
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
  const float* psrc_b = psrc + (size_t)blk.b * Ns * 3 * ld;
  const float* pdst_n = pdst + ((size_t)blk.b * Nd + n) * 3 * ld;
  const int* idx_n = idx_s + pl * K;
  float yd[3][4], kdd[3][4], f[3][4];

  if (on) {  // K branch: columns o of Y_K and Kd_K
    load12(pdst_n + o, yd, ld);
    load12(pdst_n + 2 * O + o, kdd, ld);
    // q_n[n][o..o+3][0..2]: 12 consecutive floats
    const float4* qp = reinterpret_cast<const float4*>(
        qn + (((size_t)blk.b * Nd + n) * O + o) * 3);
    const float4 q0 = qp[0], q1 = qp[1], q2 = qp[2];
    const float q[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                         q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
#pragma unroll 2
    for (int k = 0; k < K; ++k) {
      edge_features(psrc_b + (size_t)idx_n[k] * 3 * ld + o, ld, yd, kdd,
                    slope, f);
      const int e = pl * K + k;
      quad_key_score(f, q, sq[e * Oq + o / 4], c2q[e * Oq + o / 4]);
    }
  }
  // cross per edge, logits per (edge, head), softmax over the K edges
  attention_weights(sq, c2q, cross_s, w_s, nullptr, O, head_c, blk);

  if (!on) return;
  // V branch: columns O + o of Y_V and Kd_V
  load12(pdst_n + O + o, yd, ld);
  load12(pdst_n + 3 * O + o, kdd, ld);
  float acc[3][4] = {};
  const float* w_n = w_s + pl * K * H + o / head_c;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    edge_features(psrc_b + (size_t)idx_n[k] * 3 * ld + O + o, ld, yd, kdd,
                  slope, f);
    const float w = w_n[k * H];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][v] += __fmul_rn(f[i][v], w);
  }
  // out[n][o..o+3][0..2]: 12 floats in (channel, component) order
  float4* dst =
      reinterpret_cast<float4*>(out + (((size_t)blk.b * Nd + n) * O + o) * 3);
  dst[0] = make_float4(acc[0][0], acc[1][0], acc[2][0], acc[0][1]);
  dst[1] = make_float4(acc[1][1], acc[2][1], acc[0][2], acc[1][2]);
  dst[2] = make_float4(acc[2][2], acc[0][3], acc[1][3], acc[2][3]);
}

}  // namespace

// The per-point products of one attention layer. src (B, Ns, C, 3), dst
// (B, Nd, C, 3); w_src, w_dst (C, 4 O) whose columns [0, 2 O) hold
// [W_Kl; W_Vl]^T and the delta halves [W_K; W_V]_r^T - [W_K; W_V]_l^T,
// and whose columns [2 O, 4 O) this writes: (D_K W_K)^T, (D_V W_V)^T of
// each; dk_t, dv_t (O, O) = D_K^T, D_V^T. Writes psrc = src w_src
// (B, Ns, 3, 4 O) and pdst = dst w_dst (B, Nd, 3, 4 O), columns [Y_K | Y_V
// | Kd_K | Kd_V]. f32, contiguous, C and O multiples of 4. Two launches on
// `stream`.
extern "C" int lstpu_attention_products(const void* src, const void* dst,
                                        void* w_src, void* w_dst,
                                        const void* dk_t, const void* dv_t,
                                        void* psrc, void* pdst, int B, int Ns,
                                        int Nd, int C, int O, void* stream) {
  using lstpu_points::GemmGroup;
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || C % 4 || O % 4)
    return (int)cudaErrorInvalidValue;
  auto ws = static_cast<float*>(w_src);
  auto wd = static_cast<float*>(w_dst);
  auto dk = static_cast<const float*>(dk_t);
  auto dv = static_cast<const float*>(dv_t);
  auto st = static_cast<cudaStream_t>(stream);
  const int ld = 4 * O;
  using lstpu_points::point_rows;
  using lstpu_points::row_major;
  // (D W)^T = W^T D^T for each branch of both weights
  GemmGroup weights{};
  weights.g[0] = row_major(ws, ld, C, dk, O, ws + 2 * O, ld, O, O);
  weights.g[1] = row_major(ws + O, ld, C, dv, O, ws + 3 * O, ld, O, O);
  weights.g[2] = row_major(wd, ld, C, dk, O, wd + 2 * O, ld, O, O);
  weights.g[3] = row_major(wd + O, ld, C, dv, O, wd + 3 * O, ld, O, O);
  weights.count = 4;
  int err = lstpu_points::run_group(weights, st);
  if (err) return err;
  GemmGroup points{};
  points.g[0] = point_rows(static_cast<const float*>(src), B * Ns, C, ws, ld,
                           static_cast<float*>(psrc));
  points.g[1] = point_rows(static_cast<const float*>(dst), B * Nd, C, wd, ld,
                           static_cast<float*>(pdst));
  points.count = 2;
  return lstpu_points::run_group(points, st);
}

// The edge pass. psrc (B, Ns, 3, 4 O), pdst (B, Nd, 3, 4 O) as above; qn
// (B, Nd, O, 3) channel-normalised queries; idx (B, Nd, K) int32 in
// [0, Ns); out (B, Nd, O, 3). f32, contiguous. O and head_c multiples of 4,
// head_c divides O, O <= 1024, 1 <= K <= 16.
extern "C" int lstpu_edge_attention(const void* psrc, const void* pdst,
                                    const void* qn, const void* idx, void* out,
                                    int B, int Ns, int Nd, int O, int K,
                                    int head_c, float slope, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || O <= 0 || head_c <= 0 || O % 4 ||
      head_c % 4 || O % head_c || O / 4 > kThreads || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const EdgeSmem lay(O, K, head_c);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_edges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int P = kThreads / (O / 4);
  const dim3 grid((Nd + P - 1) / P, B);
  attention_edges_kernel<<<grid, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psrc), static_cast<const float*>(pdst),
      static_cast<const float*>(qn), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), Ns, Nd, O, K, head_c, slope);
  return (int)cudaGetLastError();
}
