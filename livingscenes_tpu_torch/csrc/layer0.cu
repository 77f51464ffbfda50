// Layer 0 of the encoder: per edge the three vector channels
// [cross(dst^, nn), nn - dst, dst], VecLinear(3 -> O), so3 VecActivation,
// mean over the K neighbours.
//
// Replaces the TPU kernel livingscenes_tpu/nn/pallas_layer0.py::_layer0_kernel.
// Source and destination are the same cloud; dst^ = dst / max(|dst|, 1e-12).
// Every edge channel is linear in (nn, dst, dst^), so the pre-activation is
//   y[o][i] = cross_i W[o][0] + (nn_i - dst_i) W[o][1] + dst_i W[o][2].
// The TPU kernel's one-hot gather and mask-sum row and column picks are
// indexed loads here.
//
// What bounds it on the H100: operations, 3 (2 O O + 6 O) flops per edge
// (the direction product) against 12 bytes gathered per edge and 12 O bytes
// written per point. The design is the shared one of edge_common.cuh: a
// block builds the pre-activation rows of its 64 edges in shared memory
// from nine scalars per edge, runs the direction product against D^T, and
// writes only the (B, N, O, 3) mean.
#include "edge_common.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, edge, bs, red, y, total;  // float offsets
  __host__ __device__ explicit Smem(int O) {
    using T = Tile<TX>;
    idx = 0;
    edge = idx + T::EB;  // (EB, 12): cross, nn - dst, dst, padding
    bs = edge + T::EB * 12;
    red = bs + T::BS;
    y = red + T::RED;
    total = y + T::EB * 3 * row_stride(O);
  }
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
    layer0_kernel(const float* __restrict__ xyz,
                  const int32_t* __restrict__ idx, const float* __restrict__ W,
                  const float* __restrict__ d_t, float* __restrict__ out, int N,
                  int O, int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  const Smem<TX> lay(O);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* edge_s = smem + lay.edge;
  float* Bs = smem + lay.bs;
  float* red = smem + lay.red;
  float* y_s = smem + lay.y;
  const int ldy = row_stride(O);
  const Block blk = make_block<TX>(N, K);
  const float* xyz_b = xyz + (size_t)blk.b * N * 3;

  load_idx<TX>(idx_s, idx, blk);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  for (int e = threadIdx.x; e < T::EB; e += kThreads) {
    float* s = edge_s + e * 12;
    if (e < blk.e_act) {
      const float* d = xyz_b + (size_t)(blk.n0 + e / K) * 3;
      const float* p = xyz_b + (size_t)idx_s[e] * 3;
      const float d0 = d[0], d1 = d[1], d2 = d[2];
      const float n0 = p[0], n1 = p[1], n2 = p[2];
      const float dn = fmaxf(sqrtf(d0 * d0 + d1 * d1 + d2 * d2), 1e-12f);
      const float h0 = d0 / dn, h1 = d1 / dn, h2 = d2 / dn;
      s[0] = h1 * n2 - h2 * n1;
      s[1] = h2 * n0 - h0 * n2;
      s[2] = h0 * n1 - h1 * n0;
      s[3] = n0 - d0;
      s[4] = n1 - d1;
      s[5] = n2 - d2;
      s[6] = d0;
      s[7] = d1;
      s[8] = d2;
    } else {
      for (int q = 0; q < 9; ++q) s[q] = 0.0f;
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < T::EB * O; t += kThreads) {
    const int e = t / O, o = t % O;
    const float* s = edge_s + e * 12;
    const float wc = W[o * 3], wl = W[o * 3 + 1], wr = W[o * 3 + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      y_s[(e * 3 + i) * ldy + o] = s[i] * wc + s[3 + i] * wl + s[6 + i] * wr;
  }
  __syncthreads();

  float* out_b = out + (size_t)blk.b * N * O * 3;
  const int to = threadIdx.x % TX;
  float acc[kEPT][3][4];
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, d_t, O, o0, O, Bs);
    if (o0 + 4 * to < O) activate<TX>(acc, y_s, ldy, o0 + 4 * to, slope);
    weighted_sum_store<TX>(acc, nullptr, 0, 1, red, out_b, O, o0, (float)K,
                           blk);
  }
}

template <int TX>
int launch(const float* xyz, const int32_t* idx, const float* W,
           const float* d_t, float* out, int B, int N, int O, int K,
           float slope, cudaStream_t stream) {
  const Smem<TX> lay(O);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer0_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((N + tn - 1) / tn, B);
  layer0_kernel<TX><<<grid, kThreads, bytes, stream>>>(xyz, idx, W, d_t, out,
                                                       N, O, K, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// xyz (B, N, 3), idx (B, N, K) int32 in [0, N), W (O, 3) over [cross,
// nn - dst, dst], d_t (O, O) = D^T, out (B, N, O, 3); f32, contiguous.
// O a multiple of 4, 1 <= K <= 16.
extern "C" int lstpu_layer0_edge_mean(const void* xyz, const void* idx,
                                      const void* W, const void* d_t,
                                      void* out, int B, int N, int O, int K,
                                      float slope, void* stream) {
  if (B <= 0 || N <= 0 || O <= 0 || O % 4 || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto x = static_cast<const float*>(xyz);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(W);
  auto d = static_cast<const float*>(d_t);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(x, i, w, d, o, B, N, O, K, slope, st);
    case 16:
      return launch<16>(x, i, w, d, o, B, N, O, K, slope, st);
    default:
      return launch<32>(x, i, w, d, o, B, N, O, K, slope, st);
  }
}
