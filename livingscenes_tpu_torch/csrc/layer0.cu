// Layer 0 of the encoder: per edge the three vector channels
// [cross(dst^, nn), nn - dst, dst], VecLinear(3 -> O), so3 VecActivation,
// mean over the K neighbours.
//
// Replaces the TPU kernel livingscenes_tpu/nn/pallas_layer0.py::_layer0_kernel.
// Source and destination are the same cloud; dst^ = dst / max(|dst|, 1e-12).
// Every edge channel is linear in (cross, nn - dst, dst), so the
// pre-activation row and its direction are
//   y[o][i]  = cross_i W[o][0]  + (nn_i - dst_i) W[o][1]  + dst_i W[o][2]
//   Dy[o][i] = cross_i DW[o][0] + (nn_i - dst_i) DW[o][1] + dst_i DW[o][2]
// with DW = D W (O x 3). The TPU kernel runs the O x O direction product
// per edge (D (W e)); here each block forms D W once in shared memory
// (3 O^2 FMAs, against 3 O^2 per edge before) and every edge channel costs
// 12 FMAs for y and D y: the association becomes (D W) e.
//
// What bounds it on the H100: operations, per edge the unit dst, the
// cross product and nn - dst, and per edge and channel y and D y from
// [W | D W], the activation and the sum over K (chip_smoke.py edge_work:
// L0_EDGE_FLOPS, L0_EDGE_CHANNEL_FLOPS), against 12 bytes gathered per edge
// and 12 O bytes written per point.
//
// Design: a block of 256 threads owns P = 256 / (O / 2) destination points
// of one cloud; thread (point, pair) owns 2 channels of one point (at
// O = 32: 16 points a block, 64 registers, four blocks an SM). The block
// first copies its cloud's points (when they fit in 48 KB) and its edges'
// indices into shared memory and forms D W there, then each thread keeps
// its channels' W and D W columns, the destination's terms dst_i W[o][2]
// and dst_i DW[o][2], and the running sum in registers, walks the point's
// K edges in ascending k (the neighbour's 12 bytes from shared memory), and
// writes its 6 floats of the (B, N, O, 3) mean once. The activation's
// square root and reciprocal per edge and channel set the time: the
// kernel runs about 50 instructions an edge and channel, as the mean-edge
// layer's edge pass does for its activation alone. The tie rules are the
// TPU kernel's: the clamp of |dst|, qpara >= 0 takes the positive branch
// (edge_common.cuh vec_act), the mean in ascending k.
#include "edge_common.cuh"

namespace {

using namespace lstpu_edge;

constexpr int kCh = 2;                   // channels a thread
constexpr int kStageBytes = 48 * 1024;   // the cloud in shared memory up to

// kStage: the cloud's points in shared memory, else read from L1/L2.
template <bool kStage>
__global__ void __launch_bounds__(kThreads, 4)
    layer0_kernel(const float* __restrict__ xyz,
                  const int32_t* __restrict__ idx, const float* __restrict__ W,
                  const float* __restrict__ D, float* __restrict__ out, int N,
                  int O, int K, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int Oq = O / kCh, P = kThreads / Oq;
  float* w_s = smem;           // (O, 3) W
  float* dw_s = smem + 3 * O;  // (O, 3) D W
  int* idx_s = reinterpret_cast<int*>(smem + 6 * O);  // (P, K)
  float* x_s = smem + 6 * O + P * K;                  // kStage: (N, 3)
  const int b = blockIdx.y, n0 = blockIdx.x * P;
  const float* xyz_b = xyz + (size_t)b * N * 3;
  const int e_act = min(P, N - n0) * K;
  const int32_t* idx_b = idx + ((size_t)b * N + n0) * K;
  for (int t = threadIdx.x; t < 3 * O; t += kThreads) w_s[t] = W[t];
  for (int t = threadIdx.x; t < e_act; t += kThreads) idx_s[t] = idx_b[t];
  if (kStage)
    for (int t = threadIdx.x; t < 3 * N; t += kThreads) x_s[t] = xyz_b[t];
  layer0_dw(dw_s, W, D, O);
  __syncthreads();

  const int pl = threadIdx.x / Oq, o = kCh * (threadIdx.x % Oq);
  const int n = n0 + pl;
  if (pl >= P || n >= N) return;
  const float* pts = kStage ? x_s : xyz_b;
  const int* idx_n = idx_s + pl * K;
  const float d[3] = {pts[n * 3], pts[n * 3 + 1], pts[n * 3 + 2]};
  float h[3];
  layer0_unit(d, h);
  // the thread's channels: W and D W columns, the destination's terms
  const Layer0Channel ch[kCh] = {Layer0Channel(w_s, dw_s, o, d),
                                 Layer0Channel(w_s, dw_s, o + 1, d)};
  float acc[3][kCh] = {};
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float cr[3], nd[3];
    layer0_edge(h, d, pts + idx_n[k] * 3, cr, nd);
#pragma unroll
    for (int v = 0; v < kCh; ++v) {
      float y[3], kd[3], f[3];
      ch[v].rows(cr, nd, y, kd);
      vec_act(y, kd, slope, f);
#pragma unroll
      for (int i = 0; i < 3; ++i) acc[i][v] += f[i];
    }
  }
  const float div = (float)K;
  // out[n][o..o+1][0..2]: 6 floats in (channel, component) order
  float2* dst2 =
      reinterpret_cast<float2*>(out + (((size_t)b * N + n) * O + o) * 3);
  dst2[0] = make_float2(acc[0][0] / div, acc[1][0] / div);
  dst2[1] = make_float2(acc[2][0] / div, acc[0][1] / div);
  dst2[2] = make_float2(acc[1][1] / div, acc[2][1] / div);
}

}  // namespace

// xyz (B, N, 3), idx (B, N, K) int32 in [0, N), W (O, 3) over [cross,
// nn - dst, dst], D (O, O), out (B, N, O, 3); f32, contiguous.
// O even up to 512, 1 <= K <= 16. One launch.
extern "C" int lstpu_layer0_edge_mean(const void* xyz, const void* idx,
                                      const void* W, const void* D, void* out,
                                      int B, int N, int O, int K, float slope,
                                      void* stream) {
  if (B <= 0 || N <= 0 || O <= 0 || O % kCh || O / kCh > kThreads || K < 1 ||
      K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const int P = kThreads / (O / kCh);
  const int base = (6 * O + P * K) * (int)sizeof(float);  // W, D W, indices
  const bool stage = base + 3 * N * (int)sizeof(float) <= kStageBytes;
  const int bytes = base + (stage ? 3 * N * (int)sizeof(float) : 0);
  const dim3 grid((N + P - 1) / P, B);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xyz);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(W);
  auto d = static_cast<const float*>(D);
  auto o = static_cast<float*>(out);
  if (stage)
    layer0_kernel<true><<<grid, kThreads, bytes, st>>>(x, i, w, d, o, N, O, K,
                                                       slope);
  else
    layer0_kernel<false><<<grid, kThreads, bytes, st>>>(x, i, w, d, o, N, O, K,
                                                        slope);
  return (int)cudaGetLastError();
}
