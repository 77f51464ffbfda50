// Device code shared by the backward kernels of the fused edge layers
// layer0_bwd.cu and mean_edge_bwd.cu.
//
// Each recomputes its layer's per-edge pre-activation rows y (the forward's
// code, edge_common.cuh) and pushes the cotangent back through the so3
// VecActivation of one branch (branch_bwd):
//
//   kd = D y                      recomputed per output tile of OT columns
//   (d_y, d_kd) = act'(y, kd)^T d_f    per channel, JAX's tie rules
//   d_y += d_kd D                 accumulated over the tiles of d_kd
//   d_D += d_kd^T y               summed over the block's edges
//
// d_y of the whole block stays in registers (NT tiles of 2 edges x 3
// components x 4 columns per thread), so shared memory holds only y and one
// tile of d_kd: at O = 512 a block of 16 edges needs 99 KB for y.
//
// Sums across blocks. The source rows a block gathered repeat across blocks
// (a point is a neighbour of many destinations), so their gradient is
// scattered with float atomicAdd into a zeroed buffer. The weight gradients
// (d_D, d_W_l) are the sums of every block's partial products: each block
// adds its partial with atomicAdd into one of kReplicas zeroed replicas
// (block id mod kReplicas, each block starting at its own offset, which
// spreads contention), and sum_replicas folds them. Atomics make the order of the sums
// vary from run to run: results agree with the plain version to rounding,
// relative to the largest entry, not bit for bit.
#pragma once
#include "edge_common.cuh"

namespace lstpu_edge {

// Backward kernels take O up to 4 output tiles (O <= 512 at TX = 32).
constexpr int kMaxTiles = 4;

// Replicas of the weight gradients: the caller zeroes kReplicas x the
// gradients' length (lstpu_wgrad_replicas() tells it the count).
constexpr int kReplicas = 8;

template <int TX>
struct BwdTiles {
  static constexpr int NT = TX == 32 ? kMaxTiles : 1;
};

__device__ __forceinline__ float* replica(float* rep, size_t len) {
  const unsigned id = blockIdx.x + blockIdx.y * gridDim.x;
  return rep + (size_t)(id % (unsigned)kReplicas) * len;
}

// dst[p * ldd + q] += sum_{r < rows} A[r * lda + p] * Bm[r * ldb + q] for
// p < P, q < Q, with atomics. A and Bm are shared operands; Q, ldb and Bm
// 16-byte aligned multiples of 4.
__device__ __forceinline__ void wgrad(float* dst, int ldd, const float* A,
                                      int lda, int P, const float* Bm,
                                      int ldb, int Q, int rows) {
  const int q4 = Q / 4, total = P * q4;
  if (total <= 0) return;
  const int rot =
      (int)((blockIdx.x * 977u + blockIdx.y * 131u) % (unsigned)total);
  for (int u = threadIdx.x; u < total; u += kThreads) {
    int t = u + rot;
    if (t >= total) t -= total;
    const int p = t / q4, q = 4 * (t % q4);
    float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
    for (int r = 0; r < rows; ++r) {
      const float a = A[r * lda + p];
      const float4 b = *reinterpret_cast<const float4*>(Bm + r * ldb + q);
      s0 = fmaf(a, b.x, s0);
      s1 = fmaf(a, b.y, s1);
      s2 = fmaf(a, b.z, s2);
      s3 = fmaf(a, b.w, s3);
    }
    float* d = dst + (size_t)p * ldd + q;
    atomicAdd(d, s0);
    atomicAdd(d + 1, s1);
    atomicAdd(d + 2, s2);
    atomicAdd(d + 3, s3);
  }
}

// The VJP through one branch's activation (see the top of this file). y_s
// holds the branch's pre-activation rows (3 EB, ldy; columns from O to the
// next multiple of kKC zero), d_t = D^T and D are (O, O) in device memory,
// dkt a shared (3 EB, ldt >= OT) tile, dD the block's replica of d_D.
// `upstream(kd, o0, df)` fills df[j][i][v], the cotangent of the activated
// feature of the thread's edges and columns o0 + 4 to + v, from the
// recomputed direction kd of the same entries; every thread calls it, so it
// may use barriers, and it sets df to 0 for missing edges and columns >= O.
// On return dy holds d_y of the thread's entries, tile t in dy[t].
template <int TX, int NT, class Upstream>
__device__ __forceinline__ void branch_bwd(
    float (&dy)[NT][kEPT][3][4], const float* y_s, int ldy, int O,
    const float* __restrict__ d_t, const float* __restrict__ D, float* dkt,
    int ldt, float* Bs, float* dD, const Block& blk, float slope,
    Upstream upstream) {
  using T = Tile<TX>;
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
#pragma unroll
  for (int u = 0; u < NT; ++u)
#pragma unroll
    for (int j = 0; j < kEPT; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int v = 0; v < 4; ++v) dy[u][j][i][v] = 0.0f;

  for (int t = 0; t * T::OT < O; ++t) {
    const int o0 = t * T::OT;
    float kd[kEPT][3][4], df[kEPT][3][4];
    gemm<TX>(kd, y_s, ldy, O, d_t, O, o0, O, Bs);
    upstream(kd, o0, df);
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = 4 * to + v;
        float g[3] = {0.0f, 0.0f, 0.0f}, gk[3] = {0.0f, 0.0f, 0.0f};
        if (o0 + c < O && e < blk.e_act) {
          const float yv[3] = {y_s[(e * 3) * ldy + o0 + c],
                               y_s[(e * 3 + 1) * ldy + o0 + c],
                               y_s[(e * 3 + 2) * ldy + o0 + c]};
          const float k3[3] = {kd[j][0][v], kd[j][1][v], kd[j][2][v]};
          const float d3[3] = {df[j][0][v], df[j][1][v], df[j][2][v]};
          vec_act_bwd(yv, k3, d3, slope, g, gk);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          dkt[(e * 3 + i) * ldt + c] = gk[i];
#pragma unroll
          for (int u = 0; u < NT; ++u)
            if (u == t) dy[u][j][i][v] += g[i];
        }
      }
    }
    __syncthreads();
    const int width = O - o0 < T::OT ? O - o0 : T::OT;
#pragma unroll
    for (int u = 0; u < NT; ++u)
      if (u * T::OT < O)
        gemm_acc<TX>(dy[u], dkt, ldt, width, D + (size_t)o0 * O, O, u * T::OT,
                     O, Bs);
    wgrad(dD + (size_t)o0 * O, O, dkt, ldt, width, y_s, ldy, O,
          3 * blk.e_act);
    __syncthreads();
  }
}

// Write the registers of branch_bwd into the rows of y_s (columns < O).
// Starts and ends with a barrier.
template <int TX, int NT>
__device__ __forceinline__ void store_rows(const float (&dy)[NT][kEPT][3][4],
                                           float* y_s, int ldy, int O) {
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  __syncthreads();
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int o = u * Tile<TX>::OT + 4 * to;
    if (o >= O) continue;
#pragma unroll
    for (int j = 0; j < kEPT; ++j)
#pragma unroll
      for (int i = 0; i < 3; ++i)
        *reinterpret_cast<float4*>(y_s + ((te * kEPT + j) * 3 + i) * ldy + o) =
            make_float4(dy[u][j][i][0], dy[u][j][i][1], dy[u][j][i][2],
                        dy[u][j][i][3]);
  }
  __syncthreads();
}

// out_b[(n * 3 + i) * ldo + o] = sum_k rows[((n_local K + k) * 3 + i) * ldr
// + o], o < O, for the block's destination points (the d_ydst of a branch).
__device__ __forceinline__ void sum_over_k(const float* rows, int ldr, int O,
                                           float* __restrict__ out_b, int ldo,
                                           const Block& blk) {
  for (int t = threadIdx.x; t < blk.tn * 3 * O; t += kThreads) {
    const int nl = t / (3 * O), i = (t / O) % 3, o = t % O;
    const int n = blk.n0 + nl;
    if (n >= blk.Nd) continue;
    float s = 0.0f;
    for (int k = 0; k < blk.K; ++k)
      s += rows[((nl * blk.K + k) * 3 + i) * ldr + o];
    out_b[((size_t)n * 3 + i) * ldo + o] = s;
  }
}

// d_src[idx[e]][c][i] += sum_o d_y[e][i][o] W_l[o][c] for the block's edges:
// dy_s the rows of d_y (3 EB, ldy), wl (O, C) row-major with row stride
// ldw (the neighbour half of a VecLinear weight), dsrc_b one instance's
// (Ns, C, 3). Ends with a barrier.
template <int TX>
__device__ __forceinline__ void scatter_sources(const float* dy_s, int ldy,
                                                int O,
                                                const float* __restrict__ wl,
                                                int ldw, int C, float* dsrc_b,
                                                const int* idx_s,
                                                const Block& blk, float* Bs) {
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  float acc[kEPT][3][4];
  for (int c0 = 0; c0 < C; c0 += Tile<TX>::OT) {
    gemm<TX>(acc, dy_s, ldy, O, wl, ldw, c0, C, Bs);
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
      if (e >= blk.e_act) continue;
      float* row = dsrc_b + (size_t)idx_s[e] * C * 3;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int c = c0 + 4 * to + v;
        if (c >= C) continue;
#pragma unroll
        for (int i = 0; i < 3; ++i) atomicAdd(row + c * 3 + i, acc[j][i][v]);
      }
    }
  }
  __syncthreads();
}

}  // namespace lstpu_edge

namespace {

// out[i] = sum_r rep[r * len + i]: the fold of the weight-gradient replicas.
__global__ void sum_replicas_kernel(const float* __restrict__ rep,
                                    float* __restrict__ out, int len) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int r = 0; r < lstpu_edge::kReplicas; ++r) s += rep[(size_t)r * len + i];
  out[i] = s;
}

int sum_replicas(const float* rep, float* out, int len, cudaStream_t stream) {
  const int threads = 256;
  sum_replicas_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      rep, out, len);
  return (int)cudaGetLastError();
}

}  // namespace
