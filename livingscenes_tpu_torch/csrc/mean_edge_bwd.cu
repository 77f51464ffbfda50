// Backward of the mean-pooled edge convolution (mean_edge.cu): the VJP of
//   out[n] = mean_k act(W_l nn_k + ydst[n])
// w.r.t. the source features, ydst = (W_r - W_l) dst, W_l and D.
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_attention.py::_mean_edge_bwd_kernel. The block
// regathers its edges' source rows and recomputes the pre-activation rows
// (the forward's code), runs branch_bwd (edge_bwd.cuh) for d_y and d_D, and
// then writes d_ydst (the sum of d_y over each point's K edges; the block
// owns its points), adds d_W_l = sum nn^T d_y to its replica, and scatters
// d_nn = d_y W_l into d_src[idx] with atomicAdd. The TPU kernel's
// transposed one-hot matrix and block-stacked component weights are indexed
// loads and one (C, O) sum here. The caller turns d_ydst into d_dst and the
// W_r - W_l half of d_W, per point.
//
// What bounds it on the H100: operations, per edge 3 (6 O O + 4 C O) flops
// (the recomputed conv and direction, d_y D, d_D, d_y W_l, d_W_l).
#include "edge_bwd.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, bs, nn, y, dkt, total;  // float offsets
  __host__ __device__ Smem(int C, int O) {
    using T = Tile<TX>;
    idx = 0;
    bs = idx + T::EB;
    nn = bs + T::BS;
    y = nn + T::EB * 3 * row_stride(C);
    dkt = y + T::EB * 3 * row_stride(O);
    total = dkt + T::EB * 3 * (T::OT + 4);
  }
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
    mean_edge_bwd_kernel(const float* __restrict__ src,
                         const float* __restrict__ ydst,
                         const int32_t* __restrict__ idx,
                         const float* __restrict__ wl_t,
                         const float* __restrict__ W,
                         const float* __restrict__ d_t,
                         const float* __restrict__ D,
                         const float* __restrict__ g, float* d_src,
                         float* __restrict__ d_ydst, float* rep, int Ns,
                         int Nd, int C, int O, int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  constexpr int NT = BwdTiles<TX>::NT;
  const Smem<TX> lay(C, O);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* Bs = smem + lay.bs;
  float* nn_s = smem + lay.nn;
  float* y_s = smem + lay.y;
  float* dkt = smem + lay.dkt;
  const int ldn = row_stride(C), ldy = row_stride(O), ldt = T::OT + 4;
  const Block blk = make_block<TX>(Nd, K);
  const float* g_b = g + (size_t)blk.b * Nd * O * 3;
  float* rep_b = replica(rep, (size_t)C * O + (size_t)O * O);
  float* dWl = rep_b;          // (C, O) = d(W_l^T)
  float* dD = rep_b + C * O;   // (O, O)

  load_idx<TX>(idx_s, idx, blk);
  zero_pad(nn_s, T::EB * 3, ldn, C);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  gather_rows<TX>(nn_s, ldn, src + (size_t)blk.b * Ns * C * 3, C, idx_s);
  __syncthreads();
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t, O, O,
                ydst + (size_t)blk.b * Nd * 3 * O, O, blk, Bs);

  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  const float inv_k = 1.0f / (float)K;
  auto upstream = [&](const float (&)[kEPT][3][4], int o0,
                      float (&df)[kEPT][3][4]) {
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
      const int n = blk.n0 + e / K;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int o = o0 + 4 * to + v;
        const bool live = e < blk.e_act && o < O;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          df[j][i][v] = live ? g_b[((size_t)n * O + o) * 3 + i] * inv_k : 0.0f;
      }
    }
  };
  float dy[NT][kEPT][3][4];
  branch_bwd<TX, NT>(dy, y_s, ldy, O, d_t, D, dkt, ldt, Bs, dD, blk, slope,
                     upstream);
  store_rows<TX, NT>(dy, y_s, ldy, O);

  sum_over_k(y_s, ldy, O, d_ydst + (size_t)blk.b * Nd * 3 * O, O, blk);
  wgrad(dWl, O, nn_s, ldn, C, y_s, ldy, O, 3 * blk.e_act);
  scatter_sources<TX>(y_s, ldy, O, W, 2 * C, C,
                      d_src + (size_t)blk.b * Ns * C * 3, idx_s, blk, Bs);
}

template <int TX>
int launch(const float* src, const float* ydst, const int32_t* idx,
           const float* wl_t, const float* W, const float* d_t,
           const float* D, const float* g, float* d_src, float* d_ydst,
           float* rep, float* out, int B, int Ns, int Nd, int C, int O, int K,
           float slope, cudaStream_t stream) {
  const Smem<TX> lay(C, O);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      mean_edge_bwd_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((Nd + tn - 1) / tn, B);
  mean_edge_bwd_kernel<TX><<<grid, kThreads, bytes, stream>>>(
      src, ydst, idx, wl_t, W, d_t, D, g, d_src, d_ydst, rep, Ns, Nd, C, O, K,
      slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_replicas(rep, out, C * O + O * O, stream);
}

}  // namespace

// src (B, Ns, C, 3), ydst (B, Nd, 3, O), idx (B, Nd, K) int32 in [0, Ns),
// wl_t (C, O) = W_l^T, W (O, 2 C), d_t = D^T and D (O, O), g (B, Nd, O, 3)
// the cotangent; d_src (B, Ns, C, 3) and rep (kReplicas, C O + O O) zeroed by the
// caller; d_ydst (B, Nd, 3, O); out (C O + O O) receives [d(W_l^T) | d_D].
// f32, contiguous. C and O multiples of 4, O up to 512, 1 <= K <= 16.
extern "C" int lstpu_edge_mean_bwd(const void* src, const void* ydst,
                                   const void* idx, const void* wl_t,
                                   const void* W, const void* d_t,
                                   const void* D, const void* g, void* d_src,
                                   void* d_ydst, void* rep, void* out, int B,
                                   int Ns, int Nd, int C, int O, int K,
                                   float slope, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || C % 4 || O % 4 ||
      O > kMaxTiles * 128 || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto y = static_cast<const float*>(ydst);
  auto i = static_cast<const int32_t*>(idx);
  auto wl = static_cast<const float*>(wl_t);
  auto w = static_cast<const float*>(W);
  auto dt = static_cast<const float*>(d_t);
  auto d = static_cast<const float*>(D);
  auto gg = static_cast<const float*>(g);
  auto ds = static_cast<float*>(d_src);
  auto dy = static_cast<float*>(d_ydst);
  auto rp = static_cast<float*>(rep);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(s, y, i, wl, w, dt, d, gg, ds, dy, rp, o, B, Ns, Nd, C,
                       O, K, slope, st);
    case 16:
      return launch<16>(s, y, i, wl, w, dt, d, gg, ds, dy, rp, o, B, Ns, Nd, C,
                        O, K, slope, st);
    default:
      return launch<32>(s, y, i, wl, w, dt, d, gg, ds, dy, rp, o, B, Ns, Nd, C,
                        O, K, slope, st);
  }
}
