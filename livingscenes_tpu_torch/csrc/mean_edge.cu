// Mean-pooled edge convolution: gather, VecLNA(2C -> O) on [nn - dst, dst],
// mean over the K neighbours.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_mean_edge_kernel. Per edge e of
// destination point n, with W = [W_l | W_r] and W_delta = W_r - W_l:
//
//   y[e] = W_l nn + W_delta dst,  f[e] = act(y[e], D y[e])   (O, 3)
//   out[n] = (sum_k f[e_k]) / K, summed in ascending k
//
// The TPU kernel runs the C x O edge convolution and the O x O direction
// product once per edge. Both are linear in the gathered row:
//   y[e]   = (W_l src)[idx[e]] + (W_delta dst)[n]
//   D y[e] = (D W_l src)[idx[e]] + (D W_delta dst)[n]
// so, as attention.cu does for its two branches, this file computes them
// once per point and leaves the edges only the work that is not linear.
// Two stages, three launches a layer:
//
// 1. lstpu_mean_products (point_products.cuh). A first launch forms the
//    weight products D W_l and D W_delta (C x O x O each, a few blocks)
//    beside W_l^T and W_delta^T, the second multiplies every point's (3, C)
//    rows by them: P_src = src [W_l | D W_l] and P_dst = dst [W_delta |
//    D W_delta], (B, N, 3, 2 O), columns [Y | Kd]. At layer 1 of the
//    production encoder (B = 64, Ns = Nd = 1024, C = O = 32) 1.6 GFLOP and
//    150 MB (the features read, the rows written), against 13 GFLOP for
//    the same products per edge (K = 16). Bound: bytes.
// 2. mean_edges_kernel: per edge, gather the Y and Kd rows of its source
//    and add the destination's; then the activation (vec_act, slope 0.2),
//    the sum over K in ascending k and the division by K, with the rules
//    and epsilons of edge_common.cuh. No product is left per edge. Bound:
//    the gathered bytes, 3 rows x 2 O floats = 24 O bytes an edge (0.8 GB
//    at layer 1), against the 50 MB of distinct source rows: each serves
//    K = 16 edges on average, so the reuse comes from the L2 cache (50 MB;
//    the grid runs an instance's blocks one after the other, and one
//    instance's P_src is 0.8 MB). Design: a block of 256 threads owns
//    P = 256 / (O / 4) destination points with all their edges; thread
//    (point, quad) owns 4 channels of one point, keeps the destination's
//    rows and the sum in registers and walks the point's K edges, each
//    load a 16-byte piece of a row that the point's other threads read
//    beside it.
//
// Rounding: D (W a + W b) becomes (D W) a + (D W) b, so results move by
// about an f32 ulp of the terms against the TPU kernel's association (as
// attention.cu's did). The backward kernel (mean_edge_bwd.cu) still
// recomputes the forward per edge through conv_rows and gemm of
// edge_common.cuh; both are f32 roundings of the same function, and the
// training checks hold the pair together.
#include "edge_common.cuh"
#include "point_products.cuh"

namespace {

using namespace lstpu_edge;

__global__ void __launch_bounds__(kThreads)
    mean_edges_kernel(const float* __restrict__ psrc,
                      const float* __restrict__ pdst,
                      const int32_t* __restrict__ idx, float* __restrict__ out,
                      int Ns, int Nd, int O, int K, float slope) {
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
  const float* psrc_b = psrc + (size_t)b * Ns * 3 * ld;
  const float* pdst_n = pdst + ((size_t)b * Nd + n) * 3 * ld;
  const int* idx_n = idx_s + pl * K;
  float yd[3][4], kdd[3][4], f[3][4];
  load12(pdst_n + o, yd, ld);
  load12(pdst_n + O + o, kdd, ld);
  float acc[3][4] = {};
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    edge_features(psrc_b + (size_t)idx_n[k] * 3 * ld + o, ld, yd, kdd, slope,
                  f);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][v] += f[i][v];
  }
  const float div = (float)K;
  // out[n][o..o+3][0..2]: 12 floats in (channel, component) order
  float4* dst =
      reinterpret_cast<float4*>(out + (((size_t)b * Nd + n) * O + o) * 3);
  dst[0] = make_float4(acc[0][0] / div, acc[1][0] / div, acc[2][0] / div,
                       acc[0][1] / div);
  dst[1] = make_float4(acc[1][1] / div, acc[2][1] / div, acc[0][2] / div,
                       acc[1][2] / div);
  dst[2] = make_float4(acc[2][2] / div, acc[0][3] / div, acc[1][3] / div,
                       acc[2][3] / div);
}

}  // namespace

// The per-point products of the mean-edge layer. src (B, Ns, C, 3), dst
// (B, Nd, C, 3); w_src, w_dst (C, 2 O) whose columns [0, O) hold W_l^T and
// W_delta^T and whose columns [O, 2 O) this writes: (D W_l)^T, (D W_delta)^T;
// d_t (O, O) = D^T. Writes psrc = src w_src (B, Ns, 3, 2 O) and pdst =
// dst w_dst (B, Nd, 3, 2 O), columns [Y | Kd]. f32, contiguous, O a
// multiple of 4. Two launches on `stream`.
extern "C" int lstpu_mean_products(const void* src, const void* dst,
                                   void* w_src, void* w_dst, const void* d_t,
                                   void* psrc, void* pdst, int B, int Ns,
                                   int Nd, int C, int O, void* stream) {
  using lstpu_points::GemmGroup;
  using lstpu_points::point_rows;
  using lstpu_points::row_major;
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || O % 4)
    return (int)cudaErrorInvalidValue;
  auto ws = static_cast<float*>(w_src);
  auto wd = static_cast<float*>(w_dst);
  auto dt = static_cast<const float*>(d_t);
  auto st = static_cast<cudaStream_t>(stream);
  const int ld = 2 * O;
  // (D W)^T = W^T D^T for both halves of W
  GemmGroup weights{};
  weights.g[0] = row_major(ws, ld, C, dt, O, ws + O, ld, O, O);
  weights.g[1] = row_major(wd, ld, C, dt, O, wd + O, ld, O, O);
  weights.count = 2;
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

// The edge pass. psrc (B, Ns, 3, 2 O), pdst (B, Nd, 3, 2 O) as above; idx
// (B, Nd, K) int32 in [0, Ns); out (B, Nd, O, 3). f32, contiguous. O a
// multiple of 4, O <= 1024, 1 <= K <= 16.
extern "C" int lstpu_edge_mean(const void* psrc, const void* pdst,
                               const void* idx, void* out, int B, int Ns,
                               int Nd, int O, int K, float slope,
                               void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || O <= 0 || O % 4 || O / 4 > kThreads ||
      K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int P = kThreads / (O / 4);
  const int bytes = P * K * (int)sizeof(int);
  const dim3 grid((Nd + P - 1) / P, B);
  mean_edges_kernel<<<grid, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(psrc), static_cast<const float*>(pdst),
      static_cast<const int32_t*>(idx), static_cast<float*>(out), Ns, Nd, O, K,
      slope);
  return (int)cudaGetLastError();
}
