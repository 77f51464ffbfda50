// Backward of layer 0 (layer0.cu): the VJP of
//   out[n] = mean_k act(W [cross(dst^, nn), nn - dst, dst])
// w.r.t. the point coordinates (as neighbours and as destinations, with the
// dst^ = dst / max(|dst|, 1e-12) normalisation), W (O, 3) and D (O, O).
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_layer0.py::_layer0_bwd_kernel. Like it, the
// block recomputes its edges' pre-activation rows from the coordinates
// (nothing per edge is saved by the forward), then runs branch_bwd
// (edge_bwd.cuh) for d_y and d_D. From d_y it forms per edge the nine
// scalars d_cross, d_nn, d_dst (sums over the O channels against W's three
// columns), d_W from the nine per-edge scalars of the forward, and the
// cross-product rules for d_nn and d_dst^. The TPU kernel's scatter through a
// transposed one-hot matrix is an atomicAdd of each edge's d_nn into
// d_xyz[idx]; each destination adds its own d_dst there too.
//
// What bounds it on the H100: operations, per edge 3 (4 O O + 10 O) flops
// (the direction recomputed, d_y D, and d_D) against 12 bytes gathered per
// edge.
#include "edge_bwd.cuh"

namespace {

using namespace lstpu_edge;

template <int TX>
struct Smem {
  int idx, edge, grad, bs, y, dkt, total;  // float offsets
  __host__ __device__ explicit Smem(int O) {
    using T = Tile<TX>;
    idx = 0;
    edge = idx + T::EB;  // (EB, 12): cross, nn - dst, dst, padding
    grad = edge + T::EB * 12;  // (EB, 12): d_cross, d_nn, d_dst, d_dst^
    bs = grad + T::EB * 12;
    y = bs + T::BS;
    dkt = y + T::EB * 3 * row_stride(O);
    total = dkt + T::EB * 3 * (T::OT + 4);
  }
};

template <int TX>
__global__ void __launch_bounds__(kThreads)
    layer0_bwd_kernel(const float* __restrict__ xyz,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ W,
                      const float* __restrict__ d_t,
                      const float* __restrict__ D, const float* __restrict__ g,
                      float* d_xyz, float* rep, int N, int O, int K,
                      float slope) {
  extern __shared__ __align__(16) float smem[];
  using T = Tile<TX>;
  constexpr int NT = BwdTiles<TX>::NT;
  const Smem<TX> lay(O);
  int* idx_s = reinterpret_cast<int*>(smem + lay.idx);
  float* edge_s = smem + lay.edge;
  float* grad_s = smem + lay.grad;
  float* Bs = smem + lay.bs;
  float* y_s = smem + lay.y;
  float* dkt = smem + lay.dkt;
  const int ldy = row_stride(O), ldt = T::OT + 4;
  const Block blk = make_block<TX>(N, K);
  const float* xyz_b = xyz + (size_t)blk.b * N * 3;
  const float* g_b = g + (size_t)blk.b * N * O * 3;
  float* dxyz_b = d_xyz + (size_t)blk.b * N * 3;
  float* rep_b = replica(rep, (size_t)O * 3 + (size_t)O * O);
  float* dW = rep_b;           // (O, 3)
  float* dD = rep_b + O * 3;   // (O, O)

  // the forward's edge scalars and pre-activation rows (layer0.cu)
  load_idx<TX>(idx_s, idx, blk);
  zero_pad(y_s, T::EB * 3, ldy, O);
  __syncthreads();
  layer0_rows<TX>(y_s, ldy, edge_s, xyz_b, W, O, idx_s, blk);

  // the mean over K: each edge gets g[n] / K
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

  // d_W[o][q] = sum over edges and components of the edge's scalar q-group
  // times d_y; per edge and component the sums over channels against W
  for (int o = threadIdx.x; o < O; o += kThreads) {
    float s[3] = {0.0f, 0.0f, 0.0f};
    for (int e = 0; e < blk.e_act; ++e)
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float d = y_s[(e * 3 + i) * ldy + o];
#pragma unroll
        for (int q = 0; q < 3; ++q) s[q] += edge_s[e * 12 + 3 * q + i] * d;
      }
#pragma unroll
    for (int q = 0; q < 3; ++q) atomicAdd(dW + o * 3 + q, s[q]);
  }
  for (int r = threadIdx.x; r < 3 * blk.e_act; r += kThreads) {
    const int e = r / 3, i = r % 3;
    float dc = 0.0f, dl = 0.0f, dr = 0.0f;
    for (int o = 0; o < O; ++o) {
      const float d = y_s[r * ldy + o];
      dc += d * W[o * 3];
      dl += d * W[o * 3 + 1];
      dr += d * (W[o * 3 + 2] - W[o * 3 + 1]);
    }
    grad_s[e * 12 + i] = dc;
    grad_s[e * 12 + 3 + i] = dl;
    grad_s[e * 12 + 6 + i] = dr;
  }
  __syncthreads();

  // cross_i = dh_j nn_k - dh_k nn_j (cyclic): d_nn to the source, d_dh kept
  for (int e = threadIdx.x; e < blk.e_act; e += kThreads) {
    const float* d = xyz_b + (size_t)(blk.n0 + e / K) * 3;
    const float* p = xyz_b + (size_t)idx_s[e] * 3;
    const float dn = fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]),
                           1e-12f);
    const float dh[3] = {d[0] / dn, d[1] / dn, d[2] / dn};
    const float nn[3] = {p[0], p[1], p[2]};
    float* q = grad_s + e * 12;
    float d_nn[3] = {q[3], q[4], q[5]}, d_dh[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int j = (i + 1) % 3, k = (i + 2) % 3;
      d_dh[j] += q[i] * nn[k];
      d_nn[k] += q[i] * dh[j];
      d_dh[k] -= q[i] * nn[j];
      d_nn[j] -= q[i] * dh[k];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      atomicAdd(dxyz_b + (size_t)idx_s[e] * 3 + i, d_nn[i]);
      q[9 + i] = d_dh[i];
    }
  }
  __syncthreads();

  // per destination: the sums over its edges, and dst^'s normalisation
  for (int nl = threadIdx.x; nl < blk.tn; nl += kThreads) {
    const int n = blk.n0 + nl;
    if (n >= N) continue;
    float dd[3] = {0.0f, 0.0f, 0.0f}, dh[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; ++k) {
      const float* q = grad_s + (nl * K + k) * 12;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        dd[i] += q[6 + i];
        dh[i] += q[9 + i];
      }
    }
    const float* d = xyz_b + (size_t)n * 3;
    const float dnorm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
    const float inv = 1.0f / fmaxf(dnorm, 1e-12f);
    const float dot = dh[0] * d[0] + dh[1] * d[1] + dh[2] * d[2];
    const float live = dnorm > 1e-12f ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < 3; ++i)
      atomicAdd(dxyz_b + (size_t)n * 3 + i,
                dd[i] + dh[i] * inv - d[i] * (dot * inv * inv * inv * live));
  }
}

template <int TX>
int launch(const float* xyz, const int32_t* idx, const float* W,
           const float* d_t, const float* D, const float* g, float* d_xyz,
           float* rep, float* out, int B, int N, int O, int K, float slope,
           cudaStream_t stream) {
  const Smem<TX> lay(O);
  const int bytes = lay.total * (int)sizeof(float);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      layer0_bwd_kernel<TX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int tn = Tile<TX>::EB / K;
  const dim3 grid((N + tn - 1) / tn, B);
  layer0_bwd_kernel<TX><<<grid, kThreads, bytes, stream>>>(
      xyz, idx, W, d_t, D, g, d_xyz, rep, N, O, K, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_replicas(rep, out, O * 3 + O * O, stream);
}

}  // namespace

// xyz (B, N, 3), idx (B, N, K) int32 in [0, N), W (O, 3), d_t = D^T and D
// (O, O), g (B, N, O, 3) the cotangent of the output; d_xyz (B, N, 3) and
// rep (kReplicas, O 3 + O O) zeroed by the caller; out (O 3 + O O) receives
// [d_W | d_D]. f32, contiguous. O a multiple of 4 up to 512, 1 <= K <= 16.
extern "C" int lstpu_layer0_edge_mean_bwd(const void* xyz, const void* idx,
                                          const void* W, const void* d_t,
                                          const void* D, const void* g,
                                          void* d_xyz, void* rep, void* out,
                                          int B, int N, int O, int K,
                                          float slope, void* stream) {
  if (B <= 0 || N <= 0 || O <= 0 || O % 4 || O > kMaxTiles * 128 || K < 1 ||
      K > kMaxK)
    return (int)cudaErrorInvalidValue;
  auto x = static_cast<const float*>(xyz);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(W);
  auto dt = static_cast<const float*>(d_t);
  auto d = static_cast<const float*>(D);
  auto gg = static_cast<const float*>(g);
  auto dx = static_cast<float*>(d_xyz);
  auto rp = static_cast<float*>(rep);
  auto o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (pick_tx(O)) {
    case 8:
      return launch<8>(x, i, w, dt, d, gg, dx, rp, o, B, N, O, K, slope, st);
    case 16:
      return launch<16>(x, i, w, dt, d, gg, dx, rp, o, B, N, O, K, slope, st);
    default:
      return launch<32>(x, i, w, dt, d, gg, dx, rp, o, B, N, O, K, slope, st);
  }
}

// The replica count of the weight gradients of all three backward kernels
// (edge_bwd.cuh): their callers zero a (kReplicas, length) buffer.
extern "C" int lstpu_wgrad_replicas() { return kReplicas; }
