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
// The TPU kernel's one-hot gather, zero-padded component weights and 0/1
// head matrices are indexed loads and plain sums here.
//
// What bounds it on the H100: operations, 3 (4 C O + 4 O O) flops per edge.
// The design is the shared one of edge_common.cuh, with the branches run
// one after the other so that one branch's pre-activation rows fit in
// shared memory up to O = 512 (96 KB for the 16 edges of one point). The K
// branch never stores kf: per output tile it folds kf into per-4-channel
// partial sums of kf.q_n (times knorm / max(knorm, 1e-12), which is 1
// unless the channel vanishes) and of knorm^2; once all tiles are done
// these give cross and the logits, the softmax runs over the K edges of
// each (point, head), and the V branch weights its features on the way out.
#include "edge_common.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, cross, w, bs, nn, part, y, total;  // float offsets
  __host__ __device__ Smem(int C, int O, int H) {
    using T = Tile<TX>;
    const int nn_size = T::EB * 3 * row_stride(C);
    idx = 0;
    cross = idx + T::EB;
    w = cross + T::EB;           // (EB, H) logits, then softmax weights
    bs = w + T::EB * H;
    nn = bs + T::BS;             // the gathered rows, later the K-sum buffer
    part = nn + (nn_size > T::RED ? nn_size : T::RED);
    y = part + 2 * T::EB * (O / 4);  // partial sums per 4 channels
    total = y + T::EB * 3 * row_stride(O);
  }
};

// Fold the K features of the thread's columns o..o+3 < O into the partial
// sums sq (kf.q_n, weighted) and c2q (knorm^2) of channel group o / 4.
template <int TX>
__device__ __forceinline__ void key_scores(const float (&f)[kEPT][3][4],
                                           const float* __restrict__ qn_b,
                                           int O, int o, float* sq,
                                           float* c2q, const Block& blk) {
  const int te = threadIdx.x / TX;
  const int Oq = O / 4;
#pragma unroll
  for (int j = 0; j < kEPT; ++j) {
    const int e = te * kEPT + j;
    if (e >= blk.e_act) continue;
    const int n = blk.n0 + e / blk.K;
    // q_n[n][o..o+3][0..2]: 12 consecutive floats
    const float4* qp =
        reinterpret_cast<const float4*>(qn_b + ((size_t)n * O + o) * 3);
    const float4 q0 = qp[0], q1 = qp[1], q2 = qp[2];
    const float q[12] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y,
                         q1.z, q1.w, q2.x, q2.y, q2.z, q2.w};
    float s = 0.0f, c2 = 0.0f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float f0 = f[j][0][v], f1 = f[j][1][v], f2 = f[j][2][v];
      const float kn = sqrtf(fmaxf(f0 * f0 + f1 * f1 + f2 * f2, 0.0f));
      const float u = kn / fmaxf(kn, 1e-12f);
      const float dot = f0 * q[3 * v] + f1 * q[3 * v + 1] + f2 * q[3 * v + 2];
      s += dot * u;
      c2 += kn * kn;
    }
    sq[e * Oq + o / 4] = s;
    c2q[e * Oq + o / 4] = c2;
  }
}

template <int TX>
__global__ void __launch_bounds__(kThreads)
    attention_kernel(const float* __restrict__ src,
                     const float* __restrict__ ydst,
                     const float* __restrict__ qn,
                     const int32_t* __restrict__ idx,
                     const float* __restrict__ wl_t,
                     const float* __restrict__ dk_t,
                     const float* __restrict__ dv_t, float* __restrict__ out,
                     int Ns, int Nd, int C, int O, int K, int head_c,
                     float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  const int H = O / head_c, Oq = O / 4;
  const Smem<TX> lay(C, O, H);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* cross_s = smem + lay.cross;
  float* w_s = smem + lay.w;
  float* Bs = smem + lay.bs;
  float* nn_s = smem + lay.nn;
  float* sq = smem + lay.part;
  float* c2q = sq + T::EB * Oq;
  float* y_s = smem + lay.y;
  const int ldn = row_stride(C), ldy = row_stride(O);
  const Block blk = make_block<TX>(Nd, K);
  const int to = threadIdx.x % TX;

  load_idx<TX>(idx_s, idx, blk);
  zero_pad(nn_s, T::EB * 3, ldn, C);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  gather_rows<TX>(nn_s, ldn, src + (size_t)blk.b * Ns * C * 3, C, idx_s);
  __syncthreads();

  const float* ydst_b = ydst + (size_t)blk.b * Nd * 3 * (2 * O);
  const float* qn_b = qn + (size_t)blk.b * Nd * O * 3;
  float acc[kEPT][3][4];

  // K branch: columns [0, O) of wl_t and ydst
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t, 2 * O, O, ydst_b, 2 * O, blk, Bs);
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, dk_t, O, o0, O, Bs);
    const int o = o0 + 4 * to;
    if (o < O) {
      activate<TX>(acc, y_s, ldy, o, slope);
      key_scores<TX>(acc, qn_b, O, o, sq, c2q, blk);
    }
  }
  __syncthreads();

  // cross per edge, logits per (edge, head), softmax over the K edges
  for (int e = threadIdx.x; e < blk.e_act; e += kThreads) {
    float c2 = 0.0f;
    for (int g = 0; g < Oq; ++g) c2 += c2q[e * Oq + g];
    cross_s[e] = fmaxf(sqrtf(c2), 1e-12f);
  }
  __syncthreads();
  const float inv_sqrt = 1.0f / sqrtf((float)(3 * head_c));
  const int hq = head_c / 4;
  for (int t = threadIdx.x; t < blk.e_act * H; t += kThreads) {
    const int e = t / H, h = t % H;
    float s = 0.0f;
    for (int g = 0; g < hq; ++g) s += sq[e * Oq + h * hq + g];
    w_s[e * H + h] = s / cross_s[e] * inv_sqrt;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < (blk.e_act / K) * H; t += kThreads) {
    const int nl = t / H, h = t % H;
    float* col = w_s + nl * K * H + h;  // stride H over the K edges
    float m = -INFINITY;
    for (int k = 0; k < K; ++k) m = fmaxf(m, col[k * H]);
    float sum = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float ex = expf(col[k * H] - m);
      col[k * H] = ex;
      sum += ex;
    }
    for (int k = 0; k < K; ++k) col[k * H] = col[k * H] / sum;
  }
  __syncthreads();

  // V branch: columns [O, 2 O)
  conv_rows<TX>(y_s, ldy, nn_s, ldn, C, wl_t + O, 2 * O, O, ydst_b + O, 2 * O,
                blk, Bs);
  float* out_b = out + (size_t)blk.b * Nd * O * 3;
  for (int o0 = 0; o0 < O; o0 += T::OT) {
    gemm<TX>(acc, y_s, ldy, O, dv_t, O, o0, O, Bs);
    if (o0 + 4 * to < O) activate<TX>(acc, y_s, ldy, o0 + 4 * to, slope);
    weighted_sum_store<TX>(acc, w_s, H, head_c, nn_s, out_b, O, o0, 1.0f, blk);
  }
}

template <int TX>
int launch(const float* src, const float* ydst, const float* qn,
           const int32_t* idx, const float* wl_t, const float* dk_t,
           const float* dv_t, float* out, int B, int Ns, int Nd, int C, int O,
           int K, int head_c, float slope, cudaStream_t stream) {
  const Smem<TX> lay(C, O, O / head_c);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((Nd + tn - 1) / tn, B);
  attention_kernel<TX><<<grid, kThreads, bytes, stream>>>(
      src, ydst, qn, idx, wl_t, dk_t, dv_t, out, Ns, Nd, C, O, K, head_c,
      slope);
  return (int)cudaGetLastError();
}

}  // namespace

// src (B, Ns, C, 3); ydst (B, Nd, 3, 2 O) = [W_K; W_V] delta halves times
// dst, K columns first; qn (B, Nd, O, 3) channel-normalised queries; idx
// (B, Nd, K) int32 in [0, Ns); wl_t (C, 2 O) = [W_Kl; W_Vl]^T; dk_t, dv_t
// (O, O) = D_K^T, D_V^T; out (B, Nd, O, 3). f32, contiguous. C, O and head_c
// multiples of 4, head_c divides O, 1 <= K <= 16.
extern "C" int lstpu_edge_attention(const void* src, const void* ydst,
                                    const void* qn, const void* idx,
                                    const void* wl_t, const void* dk_t,
                                    const void* dv_t, void* out, int B, int Ns,
                                    int Nd, int C, int O, int K, int head_c,
                                    float slope, void* stream) {
  if (B <= 0 || Ns <= 0 || Nd <= 0 || C <= 0 || O <= 0 || head_c <= 0 ||
      C % 4 || O % 4 || head_c % 4 || O % head_c || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto s = static_cast<const float*>(src);
  auto y = static_cast<const float*>(ydst);
  auto q = static_cast<const float*>(qn);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(wl_t);
  auto dk = static_cast<const float*>(dk_t);
  auto dv = static_cast<const float*>(dv_t);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(s, y, q, i, w, dk, dv, o, B, Ns, Nd, C, O, K, head_c,
                       slope, st);
    case 16:
      return launch<16>(s, y, q, i, w, dk, dv, o, B, Ns, Nd, C, O, K, head_c,
                        slope, st);
    default:
      return launch<32>(s, y, q, i, w, dk, dv, o, B, Ns, Nd, C, O, K, head_c,
                        slope, st);
  }
}
