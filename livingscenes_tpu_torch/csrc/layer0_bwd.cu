// Backward of layer 0 (layer0.cu): the VJP of
//   out[n] = mean_k act(W [cross(dst^, nn), nn - dst, dst])
// w.r.t. the point coordinates (as neighbours and as destinations, with the
// dst^ = dst / max(|dst|, 1e-12) normalisation), W (O, 3) and D (O, O).
//
// Replaces the TPU kernel
// livingscenes_tpu/nn/pallas_layer0.py::_layer0_bwd_kernel, which
// recomputes each edge's rows and runs the O x O products D y, d_kd D and
// d_D per edge. As in the forward, with DW = D W (O x 3) the rows of an edge
// are linear in its three vectors e_0 = cross(dst^, nn), e_1 = m = nn - dst,
// e_2 = dst:  y = W e,  D y = DW e  (edge_common.cuh Layer0Channel, the
// forward's code and association, so an activation takes the forward's
// branch). Per edge and channel only the activation's VJP at df = g[n] / K
// is not linear; it gives d_y and d_kd (O x 3). Then
//   d_e_q    = sum_o (W[o][q] d_y + DW[o][q] d_kd)[o]    per edge, q = 0, 1
//   d_dst    = sum_o (W[o][2] Ub + DW[o][2] Vb)[o] - sum_k d_m   per point
//   A = sum d_y (x) e,  G = sum d_kd (x) e                 (O x 3 each)
//   d_W = A + D^T G,  d_D = G W^T                          once a call
// with Ub, Vb the sums of d_y and d_kd over a point's K edges (the dst
// column of A and G comes from them). So no O x O product is left per edge:
// per edge and channel 12 FMAs recompute y and D y, the activation's VJP,
// and 24 more for the sums and for A and G; per edge six sums over the
// point's channels.
// The cross product's VJP gives d_nn and d_dst^ from d_cross; d_dst^ goes
// through the normalisation once a point.
//
// What bounds it on the H100: operations (chip_smoke.py edge_work with
// backward=True), against 12 bytes gathered an edge.
//
// Design: two launches.
// 1. layer0_bwd_kernel. Row 5's thread layout: thread (point, channel pair),
//    the cloud (when it fits in 48 KB), W, D W (formed per block by the
//    forward's code) and the edges' indices in shared memory. A point has L
//    threads: O / 2 rounded up to a power of two while that is at most 32,
//    so that its sums over channels are warp shuffles (xor butterflies,
//    which give every lane the same bits); past 32 (O > 64) whole warps,
//    whose shuffled sums meet in shared memory (double-buffered, one
//    barrier an edge). A block walks a fixed number of groups of points
//    (about 512 blocks at the training shape). Each thread keeps Ub, Vb and
//    its channels' A and G in registers; the block folds A and G over its
//    points in a fixed order and writes one partial (O, 6) a block. The
//    edge's d_nn and each point's d_dst go to d_xyz by float atomics (3
//    floats an edge, 3 a point): the only sums in no fixed order.
// 2. layer0_bwd_fold_kernel, one block: the partials summed in a fixed
//    order, then d_W = A + D^T G and d_D = G W^T. d_W and d_D repeat bit
//    for bit from run to run.
//
// The tie rules are the TPU kernel's: qpara >= 0 takes the positive branch
// (edge_common.cuh vec_act_bwd), the clamp of |dst| at 1e-12 and its
// gradient masked to |dst| > 1e-12.
#include "edge_common.cuh"

namespace {

using namespace lstpu_edge;

constexpr int kCh = 2;                  // channels a thread
constexpr int kMaxO = 512;
constexpr int kStageBytes = 48 * 1024;  // the cloud in shared memory up to
constexpr int kTargetBlocks = 528;      // two waves of two blocks an SM
constexpr int kWarps = kThreads / 32;
constexpr int kFoldThreads = 1024;

// Threads a point (see the top of this file).
__host__ __device__ inline int lanes_for(int O) {
  const int q = O / kCh;
  if (q > 32) return (q + 31) / 32 * 32;
  int l = 1;
  while (l < q) l *= 2;
  return l;
}

// The launch of layer0_bwd_kernel: P points a group, `per_block` groups a
// block, grid (grid_x, B).
struct Plan {
  int P, per_block, grid_x;
  Plan(int B, int N, int O) {
    P = kThreads / lanes_for(O);
    const int groups = (N + P - 1) / P;
    per_block = (B * groups + kTargetBlocks - 1) / kTargetBlocks;
    if (per_block < 1) per_block = 1;
    grid_x = (groups + per_block - 1) / per_block;
  }
};

// s[v] summed over the L threads of the calling thread's point, the same
// bits in each of them. Every thread of the block calls it (kWide: a
// barrier). kWide: red_s (2, kWarps, 6), its halves in turn (`parity`), each
// at a fixed place whatever NV: a call writes the half that the call before
// the last read, and every thread passed the last call's barrier after its
// reads of that half.
template <int NV, bool kWide>
__device__ __forceinline__ void point_sum(float (&s)[NV], int L, int P,
                                          float* red_s, int& parity) {
  static_assert(NV <= 6, "red_s holds 6 floats a warp");
  const int width = kWide ? 32 : L;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < width)
#pragma unroll
      for (int v = 0; v < NV; ++v)
        s[v] += __shfl_xor_sync(0xffffffffu, s[v], off);
  if (kWide) {
    float* r = red_s + parity * kWarps * 6;
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0)
#pragma unroll
      for (int v = 0; v < NV; ++v) r[warp * NV + v] = s[v];
    __syncthreads();
    const int per = L / 32, pl = threadIdx.x / L;
    if (pl < P)
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        float t = 0.0f;
        for (int q = 0; q < per; ++q) t += r[(pl * per + q) * NV + v];
        s[v] = t;
      }
    parity ^= 1;
  }
}

// kStage: the cloud's points in shared memory, else read from L1/L2.
// kWide: a point spans whole warps (L > 32).
template <bool kStage, bool kWide>
__global__ void __launch_bounds__(kThreads, 2)
    layer0_bwd_kernel(const float* __restrict__ xyz,
                      const int32_t* __restrict__ idx,
                      const float* __restrict__ W, const float* __restrict__ D,
                      const float* __restrict__ g, float* d_xyz,
                      float* __restrict__ part, int N, int O, int K,
                      int per_block, float slope) {
  extern __shared__ __align__(16) float smem[];
  const int L = lanes_for(O), P = kThreads / L;
  float* w_s = smem;                       // (O, 3) W
  float* dw_s = w_s + 3 * O;               // (O, 3) D W
  float* part_s = dw_s + 3 * O;            // (kThreads, 12) A and G
  float* red_s = part_s + kThreads * 12;   // kWide: (2, kWarps, 6)
  int* idx_s = reinterpret_cast<int*>(red_s + (kWide ? 2 * kWarps * 6 : 0));
  float* x_s = reinterpret_cast<float*>(idx_s + P * K);  // kStage: (N, 3)
  const int b = blockIdx.y;
  const float* xyz_b = xyz + (size_t)b * N * 3;
  const float* g_b = g + (size_t)b * N * O * 3;
  float* dxyz_b = d_xyz + (size_t)b * N * 3;
  for (int t = threadIdx.x; t < 3 * O; t += kThreads) w_s[t] = W[t];
  if (kStage)
    for (int t = threadIdx.x; t < 3 * N; t += kThreads) x_s[t] = xyz_b[t];
  layer0_dw(dw_s, W, D, O);
  const float* pts = kStage ? x_s : xyz_b;

  const int pl = threadIdx.x / L, lane = threadIdx.x % L, o = kCh * lane;
  const float inv_k = 1.0f / (float)K;
  int parity = 0;
  // A and G of the thread's channels: columns (cross, m, dst)
  float a[kCh][3] = {}, gg[kCh][3] = {};
  for (int r = 0; r < per_block; ++r) {
    const int n0 = (blockIdx.x * per_block + r) * P;
    if (n0 >= N) break;  // the same for the whole block
    __syncthreads();     // the last group's indices read; W, D W staged
    const int e_act = min(P, N - n0) * K;
    const int32_t* idx_g = idx + ((size_t)b * N + n0) * K;
    for (int t = threadIdx.x; t < e_act; t += kThreads) idx_s[t] = idx_g[t];
    __syncthreads();

    const int n = n0 + pl;
    const bool on = pl < P && n < N;  // the thread's point exists
    const bool live = on && o < O;    // and its channels
    const int* idx_n = idx_s + pl * K;
    float d[3] = {0.0f, 0.0f, 0.0f}, h[3] = {0.0f, 0.0f, 0.0f};
    if (on) {
      d[0] = pts[n * 3];
      d[1] = pts[n * 3 + 1];
      d[2] = pts[n * 3 + 2];
      layer0_unit(d, h);
    }
    float df[kCh][3] = {}, ub[kCh][3] = {}, vb[kCh][3] = {};
    const Layer0Channel ch[kCh] = {
        Layer0Channel(w_s, dw_s, live ? o : 0, d),
        Layer0Channel(w_s, dw_s, live ? o + 1 : 0, d)};
    if (live) {
      // g[n][o..o+1][0..2]: 6 floats in (channel, component) order
      const float2* gp =
          reinterpret_cast<const float2*>(g_b + ((size_t)n * O + o) * 3);
      const float2 g0 = gp[0], g1 = gp[1], g2 = gp[2];
      const float gv[6] = {g0.x, g0.y, g1.x, g1.y, g2.x, g2.y};
#pragma unroll
      for (int v = 0; v < kCh; ++v)
#pragma unroll
        for (int i = 0; i < 3; ++i) df[v][i] = gv[v * 3 + i] * inv_k;
    }
    float sum_dm[3] = {0.0f, 0.0f, 0.0f}, d_h[3] = {0.0f, 0.0f, 0.0f};
    for (int k = 0; k < K; ++k) {
      // d_cross and d_m of the edge: this thread's channels, then the point's
      float s[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      float cr[3], nd[3];
      const float* p = pts + (on ? idx_n[k] : 0) * 3;
      layer0_edge(h, d, p, cr, nd);
      if (live) {
#pragma unroll
        for (int v = 0; v < kCh; ++v) {
          float y[3], kd[3], dy[3], dkd[3];
          ch[v].rows(cr, nd, y, kd);
          vec_act_bwd(y, kd, df[v], slope, dy, dkd);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            ub[v][i] += dy[i];
            vb[v][i] += dkd[i];
            s[i] = fmaf(ch[v].wc, dy[i], fmaf(ch[v].dwc, dkd[i], s[i]));
            s[3 + i] = fmaf(ch[v].wl, dy[i], fmaf(ch[v].dwl, dkd[i], s[3 + i]));
            a[v][0] = fmaf(dy[i], cr[i], a[v][0]);
            a[v][1] = fmaf(dy[i], nd[i], a[v][1]);
            gg[v][0] = fmaf(dkd[i], cr[i], gg[v][0]);
            gg[v][1] = fmaf(dkd[i], nd[i], gg[v][1]);
          }
        }
      }
      point_sum<6, kWide>(s, L, P, red_s, parity);
      if (on) {
        // cross_i = dh_j nn_k - dh_k nn_j (cyclic): d_nn to the source
        const float nn[3] = {p[0], p[1], p[2]};
        float d_nn[3] = {s[3], s[4], s[5]};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int j = (i + 1) % 3, q = (i + 2) % 3;
          d_h[j] += s[i] * nn[q];
          d_nn[q] += s[i] * h[j];
          d_h[q] -= s[i] * nn[j];
          d_nn[j] -= s[i] * h[q];
          sum_dm[i] += s[3 + i];
        }
        if (lane == k % L)
#pragma unroll
          for (int i = 0; i < 3; ++i)
            atomicAdd(dxyz_b + (size_t)idx_n[k] * 3 + i, d_nn[i]);
      }
    }
    // the destination's own vector: d_dst from Ub and Vb, the dst columns
    // of A and G
    float s[3] = {0.0f, 0.0f, 0.0f};
    if (live)
#pragma unroll
      for (int v = 0; v < kCh; ++v)
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          s[i] = fmaf(ch[v].wr, ub[v][i], fmaf(ch[v].dwr, vb[v][i], s[i]));
          a[v][2] = fmaf(ub[v][i], d[i], a[v][2]);
          gg[v][2] = fmaf(vb[v][i], d[i], gg[v][2]);
        }
    point_sum<3, kWide>(s, L, P, red_s, parity);
    if (on && lane == 0) {
      // d_dst, and dst^ = dst / max(|dst|, 1e-12) back to dst
      const float dnorm = sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]);
      const float inv = 1.0f / fmaxf(dnorm, 1e-12f);
      const float dot = d_h[0] * d[0] + d_h[1] * d[1] + d_h[2] * d[2];
      const float alive = dnorm > 1e-12f ? 1.0f : 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i)
        atomicAdd(dxyz_b + (size_t)n * 3 + i,
                  (s[i] - sum_dm[i]) + d_h[i] * inv -
                      d[i] * (dot * inv * inv * inv * alive));
    }
  }

  // the block's A and G: each channel summed over the block's points in
  // ascending order, one partial (O, 6) a block
  __syncthreads();
  float* mine = part_s + threadIdx.x * 12;
#pragma unroll
  for (int v = 0; v < kCh; ++v)
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      mine[v * 6 + q] = a[v][q];
      mine[v * 6 + 3 + q] = gg[v][q];
    }
  __syncthreads();
  float* out = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 6 * O;
  for (int t = threadIdx.x; t < 6 * O; t += kThreads) {
    const int c = t / 6, q = t % 6;
    const float* col = part_s + (c / kCh) * 12 + (c % kCh) * 6 + q;
    float sum = 0.0f;
    for (int p = 0; p < P; ++p) sum += col[p * L * 12];
    out[t] = sum;
  }
}

// One block: A and G (O, 3 each; the partials' columns 0-2 and 3-5) summed
// over the `blocks` partials in a fixed order (S ranges of blocks, each in
// ascending order, then the ranges in ascending order), then
// out = [d_W (O, 3) | d_D (O, O)]: d_W[o][q] = A[o][q] + sum_p D[p][o]
// G[p][q], d_D[p][o] = sum_q G[p][q] W[o][q].
__global__ void __launch_bounds__(kFoldThreads)
    layer0_bwd_fold_kernel(const float* __restrict__ part,
                           const float* __restrict__ W,
                           const float* __restrict__ D,
                           float* __restrict__ out, int blocks, int O) {
  extern __shared__ __align__(16) float smem[];
  const int E4 = 6 * O / 4;  // float4s of a partial
  const int S = kFoldThreads / E4 > 1 ? kFoldThreads / E4 : 1;
  const int chunk = (blocks + S - 1) / S;
  float4* ranges = reinterpret_cast<float4*>(smem);  // (S, E4)
  float* ag = smem + 4 * S * E4;                     // (O, 6)
  const float4* part4 = reinterpret_cast<const float4*>(part);
  for (int t = threadIdx.x; t < S * E4; t += kFoldThreads) {
    const int e = t % E4, s = t / E4;
    const int hi = min(blocks, (s + 1) * chunk);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int blk = s * chunk; blk < hi; ++blk) {
      const float4 v = part4[(size_t)blk * E4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    ranges[t] = acc;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < E4; e += kFoldThreads) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s = 0; s < S; ++s) {
      const float4 v = ranges[s * E4 + e];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    *reinterpret_cast<float4*>(ag + 4 * e) = acc;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 3 * O; t += kFoldThreads) {
    const int o = t / 3, q = t % 3;
    float s = 0.0f;
    for (int p = 0; p < O; ++p) s = fmaf(D[(size_t)p * O + o], ag[p * 6 + 3 + q], s);
    out[t] = ag[o * 6 + q] + s;
  }
  for (int t = threadIdx.x; t < O * O; t += kFoldThreads) {
    const int p = t / O, o = t % O;
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < 3; ++q) s = fmaf(ag[p * 6 + 3 + q], W[o * 3 + q], s);
    out[3 * O + t] = s;
  }
}

template <bool kStage, bool kWide>
void launch_edges(const Plan& plan, int B, int bytes, cudaStream_t st,
                  const float* x, const int32_t* i, const float* w,
                  const float* d, const float* gg, float* dx, float* pt, int N,
                  int O, int K, float slope) {
  const dim3 grid(plan.grid_x, B);
  layer0_bwd_kernel<kStage, kWide><<<grid, kThreads, bytes, st>>>(
      x, i, w, d, gg, dx, pt, N, O, K, plan.per_block, slope);
}

}  // namespace

// The partials that lstpu_layer0_edge_mean_bwd needs scratch for: one
// (O, 6) a block of its first launch.
extern "C" int lstpu_layer0_bwd_blocks(int B, int N, int O) {
  if (B <= 0 || N <= 0 || O <= 0) return 0;
  return Plan(B, N, O).grid_x * B;
}

// xyz (B, N, 3), idx (B, N, K) int32 in [0, N), W (O, 3), D (O, O), g
// (B, N, O, 3) the cotangent of the output; d_xyz (B, N, 3) zeroed by the
// caller; part scratch of lstpu_layer0_bwd_blocks(B, N, O) x 6 O floats;
// out (O 3 + O O) receives [d_W | d_D]. f32, contiguous. O a multiple of 4
// up to 512, 1 <= K <= 16. Two launches on `stream`.
extern "C" int lstpu_layer0_edge_mean_bwd(const void* xyz, const void* idx,
                                          const void* W, const void* D,
                                          const void* g, void* d_xyz,
                                          void* part, void* out, int B, int N,
                                          int O, int K, float slope,
                                          void* stream) {
  if (B <= 0 || N <= 0 || O <= 0 || O % 4 || O > kMaxO || K < 1 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const Plan plan(B, N, O);
  const bool wide = lanes_for(O) > 32;
  const int base =
      (6 * O + kThreads * 12 + (wide ? 2 * kWarps * 6 : 0) + plan.P * K) *
      (int)sizeof(float);
  const bool stage = base + 3 * N * (int)sizeof(float) <= kStageBytes;
  const int bytes = base + (stage ? 3 * N * (int)sizeof(float) : 0);
  auto st = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(xyz);
  auto i = static_cast<const int32_t*>(idx);
  auto w = static_cast<const float*>(W);
  auto d = static_cast<const float*>(D);
  auto gg = static_cast<const float*>(g);
  auto dx = static_cast<float*>(d_xyz);
  auto pt = static_cast<float*>(part);
  if (stage && wide)
    launch_edges<true, true>(plan, B, bytes, st, x, i, w, d, gg, dx, pt, N, O,
                             K, slope);
  else if (stage)
    launch_edges<true, false>(plan, B, bytes, st, x, i, w, d, gg, dx, pt, N, O,
                              K, slope);
  else if (wide)
    launch_edges<false, true>(plan, B, bytes, st, x, i, w, d, gg, dx, pt, N,
                              O, K, slope);
  else
    launch_edges<false, false>(plan, B, bytes, st, x, i, w, d, gg, dx, pt, N,
                               O, K, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int E4 = 6 * O / 4;
  const int S = kFoldThreads / E4 > 1 ? kFoldThreads / E4 : 1;
  const int fold_bytes = (4 * S * E4 + 6 * O) * (int)sizeof(float);
  layer0_bwd_fold_kernel<<<1, kFoldThreads, fold_bytes, st>>>(
      pt, w, d, static_cast<float*>(out), plan.grid_x * B, O);
  return (int)cudaGetLastError();
}
