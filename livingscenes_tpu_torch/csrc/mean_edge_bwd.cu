// Backward of the mean-pooled edge convolution (mean_edge.cu): the VJP of
//   out[n] = mean_k act(W_l nn_k + W_delta dst_n)
// w.r.t. the source and destination features, W = [W_l | W_r] (W_delta =
// W_r - W_l) and D.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_mean_edge_bwd_kernel, which
// recomputes the edge convolution and the direction product per edge and
// runs every product of the VJP per edge. This is attention_bwd.cu's design
// with one branch and the mean in place of the softmax. For edge e = (n, k)
// with source j = idx[n, k], the forward is linear in the per-point rows of
// mean_edge.cu (lstpu_mean_products, point_products.cuh):
//   y[e] = Ysrc[j] + Ydst[n],  D y[e] = Kdsrc[j] + Kddst[n]
// with P_src = src [W_l | D W_l] and P_dst = dst [W_delta | D W_delta].
// Only the activation is per edge: its VJP at df = g[n] / K gives d_y[e]
// and d_kd[e] (O x 3 each). With U_j, V_j the sums of d_y and d_kd over the
// edges whose source is j, and Ub_n, Vb_n the sums over n's own K edges:
//   Z = U + D^T V (source and destination rows alike)
//   d_src[j] = W_l^T Z_j,  d_dst[n] = W_delta^T Z_n
//   d_D = sum_j V_j Ysrc_j^T + sum_n Vb_n Ydst_n^T
//   d_W_l = sum_j Z_j src_j^T,  d_W_delta = sum_n Z_n dst_n^T
// Six launches, the edge pass counted apart from the five others:
//
// 1. lstpu_mean_products (mean_edge.cu, two launches): P_src and P_dst
//    again, the forward's code, so the recomputed y and D y are the
//    forward's bits and each activation takes the forward's branch. The
//    autograd Function saves only its inputs.
// 2. mean_bwd_edges_kernel (this file, one launch): the thread layout of
//    the forward's edge pass and of attention_bwd.cu's: a block of 256
//    threads owns P = 256 / (O / 4) destination points, thread (point,
//    quad) 4 channels of one point, whose P_dst rows and cotangent stay in
//    registers while it walks the point's K edges in ascending k, gathering
//    its source's 16-byte pieces of the Y and Kd rows from L2. It sums Ub_n
//    and Vb_n in registers and writes them once; U_j and V_j go to the
//    sources as vector float atomics (add12) into a zeroed buffer with
//    P_src's layout: 6 O floats an edge in O * 3 / 2 vector atomics.
// 3. lstpu_mean_bwd_products (this file, three launches of
//    point_products.cuh edge_bwd_products, shared with attention_bwd.cu):
//    Z beside the split reductions of d_D; d_src and d_dst per point beside
//    the split reductions of d_W_l and d_W_delta; the fold of the partial
//    sums in a fixed order.
// No O x O or C x O product is left per edge.
//
// What bounds it on the H100: operations (chip_smoke.py edge_work with
// backward=True): the per-point products, and per edge and channel the
// activation's VJP. The edge pass gathers 24 O bytes an edge from L2 and
// adds 24 O bytes an edge by atomics.
//
// Sums: U_j and V_j are added with float atomics in no fixed order, so
// d_src, d_W_l and d_D agree with the plain version to rounding, not bit
// for bit, and differ from run to run at rounding; the reductions over the
// points and every sum over a point's own edges are in a fixed order. The
// tie rules are JAX's: where(qpara >= 0, ...), r > 1e-12 (vec_act_bwd).
#include "edge_common.cuh"
#include "point_products.cuh"

namespace {

using namespace lstpu_edge;

constexpr int kMaxO = 512;

// two blocks an SM: at most 128 registers a thread
__global__ void __launch_bounds__(kThreads, 2)
    mean_bwd_edges_kernel(const float* __restrict__ psrc,
                          const float* __restrict__ pdst,
                          const int32_t* __restrict__ idx,
                          const float* __restrict__ g, float* gsrc,
                          float* __restrict__ gdst, int Ns, int Nd, int O,
                          int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  int* idx_s = reinterpret_cast<int*>(smem);
  const int Oq = O / 4, P = kThreads / Oq;
  const int b = blockIdx.y, n0 = blockIdx.x * P;
  const int e_act = min(P, Nd - n0) * K;
  const int32_t* idx_b = idx + ((size_t)b * Nd + n0) * K;
  for (int e = threadIdx.x; e < e_act; e += kThreads) idx_s[e] = idx_b[e];
  __syncthreads();

  const int pl = threadIdx.x / Oq, o = 4 * (threadIdx.x % Oq);
  const int n = n0 + pl;
  if (pl >= P || n >= Nd) return;
  const int ld = 2 * O;  // row length of the per-point products
  const size_t pt = (size_t)b * Nd + n;  // the destination point
  const float* psrc_b = psrc + (size_t)b * Ns * 3 * ld;
  const float* pdst_n = pdst + pt * 3 * ld;
  float* gsrc_b = gsrc + (size_t)b * Ns * 3 * ld;
  float* gdst_n = gdst + pt * 3 * ld;
  const int* idx_n = idx_s + pl * K;
  float gq[12], yd[3][4], kdd[3][4], y[3][4], kd[3][4], dy[3][4], dkd[3][4];
  float ub[3][4] = {}, vb[3][4] = {};
  load_quad(g + (pt * O + o) * 3, gq);  // g[n][o..o+3][0..2]
  const float inv_k = 1.0f / (float)K;
  load12(pdst_n + o, yd, ld);
  load12(pdst_n + O + o, kdd, ld);
  for (int k = 0; k < K; ++k) {
    const int j = idx_n[k];
    edge_rows(psrc_b + (size_t)j * 3 * ld + o, O, ld, yd, kdd, y, kd);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float yv[3] = {y[0][v], y[1][v], y[2][v]};
      const float k3[3] = {kd[0][v], kd[1][v], kd[2][v]};
      const float df[3] = {gq[3 * v] * inv_k, gq[3 * v + 1] * inv_k,
                           gq[3 * v + 2] * inv_k};
      float gy[3], gk[3];
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
    add12(gs + O, ld, dkd);
  }
  store12(gdst_n + o, ld, ub);
  store12(gdst_n + O + o, ld, vb);
}

}  // namespace

// The edge pass. psrc (B, Ns, 3, 2 O), pdst (B, Nd, 3, 2 O) the per-point
// rows of lstpu_mean_products, columns [Y | Kd]; g (B, Nd, O, 3) the
// cotangent of the output; idx (B, Nd, K) int32 in [0, Ns). Adds U_j, V_j
// into gsrc (B, Ns, 3, 2 O), zeroed by the caller, and writes Ub_n, Vb_n to
// gdst (B, Nd, 3, 2 O), both with columns [U | V]. f32, contiguous. O a
// multiple of 4 up to 512, 1 <= K <= 16.
extern "C" int lstpu_edge_mean_bwd(const void* psrc, const void* pdst,
                                   const void* idx, const void* g, void* gsrc,
                                   void* gdst, int B, int Ns, int Nd, int O,
                                   int K, float slope, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || O <= 0 || O % 4 || O > kMaxO || K < 1 ||
      K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int P = kThreads / (O / 4);
  const int bytes = P * K * (int)sizeof(int);
  const dim3 grid((Nd + P - 1) / P, B);
  mean_bwd_edges_kernel<<<grid, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psrc), static_cast<const float*>(pdst),
      static_cast<const int32_t*>(idx), static_cast<const float*>(g),
      static_cast<float*>(gsrc), static_cast<float*>(gdst), Ns, Nd, O, K,
      slope);
  return (int)cudaGetLastError();
}

// The linear rest of the backward (point_products.cuh edge_bwd_products with
// one branch). grows (B (Ns + Nd), 3, 2 O): the edge pass's gsrc, then its
// gdst, columns [U | V]; prows the same points' P_src, P_dst rows (columns
// [Y | Kd]); src3 (B, Ns, 3, C) and dst3 (B, Nd, 3, C) the features,
// components first; W_l, W_delta (O, C); D (O, O). Writes Z = U + D^T V
// over U in grows, dsrc3 (B, Ns, 3, C) = Z_src W_l, ddst3 (B, Nd, 3, C) =
// Z_dst W_delta, and out (2 C O + O O) = [d_W_l (O, C) | d_D | d_W_delta
// (O, C)] through part, scratch of lstpu_edge_bwd_splits(B, Ns, Nd) x
// (2 C O + O O) floats. f32, contiguous, C and O multiples of 4. Three
// launches on `stream`.
extern "C" int lstpu_mean_bwd_products(void* grows, const void* prows,
                                       const void* src3, const void* dst3,
                                       const void* W_l, const void* W_delta,
                                       const void* D, void* dsrc3,
                                       void* ddst3, void* part, void* out,
                                       int B, int Ns, int Nd, int C, int O,
                                       void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || C % 4 || O % 4)
    return (int)cudaErrorInvalidValue;
  const float* Ds[1] = {static_cast<const float*>(D)};
  return lstpu_points::edge_bwd_products(
      static_cast<float*>(grows), static_cast<const float*>(prows),
      static_cast<const float*>(src3), static_cast<const float*>(dst3),
      static_cast<const float*>(W_l), static_cast<const float*>(W_delta), Ds,
      1, static_cast<float*>(dsrc3), static_cast<float*>(ddst3),
      static_cast<float*>(part), static_cast<float*>(out), B, Ns, Nd, C, O,
      static_cast<cudaStream_t>(stream));
}
