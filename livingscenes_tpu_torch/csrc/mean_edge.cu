// Mean-pooled edge convolution: gather, VecLNA(2C -> O) on [nn - dst, dst],
// mean over the K neighbours.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_mean_edge_kernel. The edge
// VecLinear is split as W [nn - dst, dst] = W_l nn + (W_r - W_l) dst; the
// caller computes the dst half once per point (ydst), this kernel the
// neighbour half per edge, the activation and the mean. The TPU kernel's
// one-hot matmul gather is an indexed load here.
//
// What bounds it on the H100: operations, 3 (2 C O + 2 O O) flops per edge
// against 3 C floats gathered (from L2: the source features of an instance
// are read K times but fetched from device memory once). The design is the
// shared one of edge_common.cuh: the gathered rows and the pre-activation
// rows stay in shared memory, the weights stream through a tile, and only
// the (B, Nd, O, 3) result is written.
#include "edge_common.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, bs, nn, y, total;  // float offsets
  __host__ __device__ Smem(int C, int O) {
    using T = Tile<TX>;
    const int nn_size = T::EB * 3 * row_stride(C);
    idx = 0;
    bs = idx + T::EB;
    nn = bs + T::BS;  // the gathered rows, later the K-sum buffer
    y = nn + (nn_size > T::RED ? nn_size : T::RED);
    total = y + T::EB * 3 * row_stride(O);
  }
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
    mean_edge_kernel(const float* __restrict__ src,
                     const float* __restrict__ ydst,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ wl_t,
                     const float* __restrict__ d_t, float* __restrict__ out,
                     int Ns, int Nd, int C, int O, int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  const Smem<TX> lay(C, O);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* Bs = smem + lay.bs;
  float* nn_s = smem + lay.nn;
  float* y_s = smem + lay.y;
  const int ldn = row_stride(C), ldy = row_stride(O);
  const Block blk = make_block<TX>(Nd, K);

  load_idx<TX>(idx_s, idx, blk);
  zero_pad(nn_s, T::EB * 3, ldn, C);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  gather_rows<TX>(nn_s, ldn, src + (size_t)blk.b * Ns * C * 3, C, idx_s);
  __syncthreads();

  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t, O, O,
                ydst + (size_t)blk.b * Nd * 3 * O, O, blk, Bs);

  float* out_b = out + (size_t)blk.b * Nd * O * 3;
  const int to = threadIdx.x % TX;
  float acc[kEPT][3][4];
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, d_t, O, o0, O, Bs);
    if (o0 + 4 * to < O) activate<TX>(acc, y_s, ldy, o0 + 4 * to, slope);
    weighted_sum_store<TX>(acc, nullptr, 0, 1, nn_s, out_b, O, o0, (float)K,
                           blk);
  }
}

template <int TX>
int launch(const float* src, const float* ydst, const int32_t* idx,
           const float* wl_t, const float* d_t, float* out, int B, int Ns,
           int Nd, int C, int O, int K, float slope, cudaStream_t stream) {
  const Smem<TX> lay(C, O);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mean_edge_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((Nd + tn - 1) / tn, B);
  mean_edge_kernel<TX><<<grid, kThreads, bytes, stream>>>(
      src, ydst, idx, wl_t, d_t, out, Ns, Nd, C, O, K, slope);
  return (int)cudaGetLastError();
}

}  // namespace

// src (B, Ns, C, 3), ydst (B, Nd, 3, O) = (W_r - W_l) dst, idx (B, Nd, K)
// int32 in [0, Ns), wl_t (C, O) = W_l^T, d_t (O, O) = D^T, out (B, Nd, O, 3);
// f32, contiguous. C and O multiples of 4, 1 <= K <= 16.
extern "C" int lstpu_edge_mean(const void* src, const void* ydst,
                               const void* idx, const void* wl_t,
                               const void* d_t, void* out, int B, int Ns,
                               int Nd, int C, int O, int K, float slope,
                               void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || C % 4 || O % 4 ||
      K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto y = static_cast<const float*>(ydst);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(wl_t);
  auto d = static_cast<const float*>(d_t);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(s, y, i, w, d, o, B, Ns, Nd, C, O, K, slope, st);
    case 16:
      return launch<16>(s, y, i, w, d, o, B, Ns, Nd, C, O, K, slope, st);
    default:
      return launch<32>(s, y, i, w, d, o, B, Ns, Nd, C, O, K, slope, st);
  }
}
