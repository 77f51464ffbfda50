// Device code shared by the fused edge layers: layer0.cu, the backward
// kernels (mean_edge_bwd.cu and attention_bwd.cu through edge_bwd.cuh), and
// the per-edge functions of attention.cu and mean_edge.cu (vec_act,
// edge_features, quad_key_score, attention_weights), whose products are per
// point instead.
//
// They run, per destination point and its K <= 16 neighbours (edges),
//
//   y[e][o][i]   pre-activation rows, i = 0..2 the vector component
//   kd = D y     the activation's direction (one O x O product per row)
//   f = y - (y.k^) k^ + k^ leaky(y.k^),  k^ = kd / max(|kd|, 1e-12)
//   a weighted sum of f over the K edges
//
// (attention.cu and mean_edge.cu add y and kd from per-point rows instead
// of multiplying)
// and never write an (edges, O, 3) tensor to device memory. A block of 256
// threads owns EB edges (whole destination points). The pre-activation rows
// of one branch stay in shared memory as a row-major (3 EB) x O matrix; the
// weights stream through a small shared tile, fetched one chunk ahead into
// registers. The products are plain f32 FMAs on the CUDA cores: thread
// (to, te) accumulates 2 edges x 3 components x 4 outputs per output tile
// of OT = 4 TX columns, so one edge's three components meet in one thread
// and the activation needs no exchange. The forward kernels sum in a fixed
// order (no atomics): their results are deterministic.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstpu_edge {

constexpr int kThreads = 256;
constexpr int kKC = 16;   // reduction chunk of the weight tile
constexpr int kEPT = 2;   // edges per thread
constexpr int kMaxK = 16;
constexpr int kMaxSmem = 227 * 1024;

template <int TX>
struct Tile {
  static constexpr int OT = 4 * TX;            // output columns per tile
  static constexpr int TE = kThreads / TX;     // edge groups
  static constexpr int EB = TE * kEPT;         // edges per block
  static constexpr int LDB = OT + 4;           // weight tile row stride
  static constexpr int NLD = (kKC * TX + kThreads - 1) / kThreads;
  static constexpr int RED = EB * OT * 3;      // floats of the K-sum buffer
  static constexpr int BS = kKC * LDB;         // floats of the weight tile
};

// Row stride of a shared operand with n columns: whole chunks, plus 4 so
// that rows of different edge groups fall into different banks.
__host__ __device__ inline int row_stride(int n) {
  return (n + kKC - 1) / kKC * kKC + 4;
}

// The destination points and edges of one block.
struct Block {
  int b;       // instance
  int n0;      // first destination point
  int tn;      // destination points a block owns: EB / K
  int e_act;   // edges of the points that exist: min(tn, Nd - n0) * K
  int K;
  int Nd;
};

template <int TX>
__device__ __forceinline__ Block make_block(int Nd, int K) {
  Block blk;
  blk.b = blockIdx.y;
  blk.tn = Tile<TX>::EB / K;
  blk.n0 = blockIdx.x * blk.tn;
  const int left = Nd - blk.n0;
  blk.e_act = (left < blk.tn ? left : blk.tn) * K;
  blk.K = K;
  blk.Nd = Nd;
  return blk;
}

// idx_s[e] = source index of edge e, -1 for an edge that does not exist.
template <int TX>
__device__ __forceinline__ void load_idx(int* idx_s, const int32_t* idx,
                                         const Block& blk) {
  const int32_t* base = idx + ((size_t)blk.b * blk.Nd + blk.n0) * blk.K;
  for (int e = threadIdx.x; e < Tile<TX>::EB; e += kThreads)
    idx_s[e] = e < blk.e_act ? base[e] : -1;
}

// Zero columns [from, ld) of `rows` rows: the reduction reads whole chunks.
__device__ __forceinline__ void zero_pad(float* m, int rows, int ld, int from) {
  const int w = ld - from;
  for (int t = threadIdx.x; t < rows * w; t += kThreads)
    m[(t / w) * ld + from + t % w] = 0.0f;
}

// nn_s[(e*3 + i)*ldn + c] = src[idx_s[e]][c][i]; rows of missing edges are 0.
// src_b is one instance's (Ns, C, 3).
template <int TX>
__device__ __forceinline__ void gather_rows(float* nn_s, int ldn,
                                            const float* __restrict__ src_b,
                                            int C, const int* idx_s) {
  const int w = 3 * C;
  for (int t = threadIdx.x; t < Tile<TX>::EB * w; t += kThreads) {
    const int e = t / w, j = t % w;
    const int s = idx_s[e];
    nn_s[(e * 3 + j % 3) * ldn + j / 3] =
        s >= 0 ? src_b[(size_t)s * w + j] : 0.0f;
  }
}

template <int TX>
__device__ __forceinline__ void fetch_b(float4 (&pre)[Tile<TX>::NLD],
                                        const float* __restrict__ Bt, int ldb,
                                        int c0, int cdim, int o0, int o_end) {
#pragma unroll
  for (int l = 0; l < Tile<TX>::NLD; ++l) {
    const int v = threadIdx.x + l * kThreads;
    const int c = c0 + v / TX, o = o0 + 4 * (v % TX);
    pre[l] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (v < kKC * TX && c < cdim && o < o_end)
      pre[l] = *reinterpret_cast<const float4*>(Bt + (size_t)c * ldb + o);
  }
}

template <int TX>
__device__ __forceinline__ void stash_b(const float4 (&pre)[Tile<TX>::NLD],
                                        float* Bs) {
#pragma unroll
  for (int l = 0; l < Tile<TX>::NLD; ++l) {
    const int v = threadIdx.x + l * kThreads;
    if (v < kKC * TX)
      *reinterpret_cast<float4*>(Bs + (v / TX) * Tile<TX>::LDB +
                                 4 * (v % TX)) = pre[l];
  }
}

// acc[j][i][v] += sum_c As[((te*kEPT + j)*3 + i)*lda + c] *
//                       Bt[c*ldb + o0 + 4*to + v],   c in [0, cdim),
// for the block's 3 EB rows and the OT columns from o0 (columns at or beyond
// o_end count as 0). As is a shared operand whose columns up to the next
// multiple of kKC are finite; Bt is row-major in device memory, 16-byte
// aligned with ldb and o_end multiples of 4. Ends with a barrier.
template <int TX>
__device__ __forceinline__ void gemm_acc(float (&acc)[kEPT][3][4],
                                         const float* As, int lda, int cdim,
                                         const float* __restrict__ Bt, int ldb,
                                         int o0, int o_end, float* Bs) {
  using T = Tile<TX>;
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  float4 pre[T::NLD];
  fetch_b<TX>(pre, Bt, ldb, 0, cdim, o0, o_end);
  for (int c0 = 0; c0 < cdim; c0 += kKC) {
    stash_b<TX>(pre, Bs);
    __syncthreads();
    if (c0 + kKC < cdim) fetch_b<TX>(pre, Bt, ldb, c0 + kKC, cdim, o0, o_end);
    const float* a_base = As + (te * kEPT * 3) * lda + c0;
#pragma unroll
    for (int c4 = 0; c4 < kKC / 4; ++c4) {
      float4 bv[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        bv[kk] = *reinterpret_cast<const float4*>(Bs + (c4 * 4 + kk) * T::LDB +
                                                  4 * to);
#pragma unroll
      for (int j = 0; j < kEPT; ++j) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float4 a = *reinterpret_cast<const float4*>(
              a_base + (j * 3 + i) * lda + c4 * 4);
          float* r = acc[j][i];
          r[0] = fmaf(a.x, bv[0].x, r[0]);
          r[1] = fmaf(a.x, bv[0].y, r[1]);
          r[2] = fmaf(a.x, bv[0].z, r[2]);
          r[3] = fmaf(a.x, bv[0].w, r[3]);
          r[0] = fmaf(a.y, bv[1].x, r[0]);
          r[1] = fmaf(a.y, bv[1].y, r[1]);
          r[2] = fmaf(a.y, bv[1].z, r[2]);
          r[3] = fmaf(a.y, bv[1].w, r[3]);
          r[0] = fmaf(a.z, bv[2].x, r[0]);
          r[1] = fmaf(a.z, bv[2].y, r[1]);
          r[2] = fmaf(a.z, bv[2].z, r[2]);
          r[3] = fmaf(a.z, bv[2].w, r[3]);
          r[0] = fmaf(a.w, bv[3].x, r[0]);
          r[1] = fmaf(a.w, bv[3].y, r[1]);
          r[2] = fmaf(a.w, bv[3].z, r[2]);
          r[3] = fmaf(a.w, bv[3].w, r[3]);
        }
      }
    }
    __syncthreads();
  }
}

// gemm_acc into acc set to 0 first.
template <int TX>
__device__ __forceinline__ void gemm(float (&acc)[kEPT][3][4], const float* As,
                                     int lda, int cdim,
                                     const float* __restrict__ Bt, int ldb,
                                     int o0, int o_end, float* Bs) {
#pragma unroll
  for (int j = 0; j < kEPT; ++j)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][i][v] = 0.0f;
  gemm_acc<TX>(acc, As, lda, cdim, Bt, ldb, o0, o_end, Bs);
}

// The edge convolution of one branch into shared memory:
//   y_s[(e*3+i)*ldy + o] = sum_c nn_s[(e*3+i)*ldn + c] wl_t[c*ldw + o]
//                          + ydst_b[(n*3 + i)*ldyd + o]
// for o in [0, O), n the edge's destination point. wl_t and ydst_b point at
// the branch's first column. Ends with a barrier.
template <int TX>
__device__ __forceinline__ void conv_rows(float* y_s, int ldy,
                                          const float* nn_s, int ldn, int C,
                                          const float* __restrict__ wl_t,
                                          int ldw, int O,
                                          const float* __restrict__ ydst_b,
                                          int ldyd, const Block& blk,
                                          float* Bs) {
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  float acc[kEPT][3][4];
  for (int o0 = 0; o0 < O; o0 += Tile<TX>::OT) {
    gemm<TX>(acc, nn_s, ldn, C, wl_t, ldw, o0, O, Bs);
    const int o = o0 + 4 * to;
    if (o >= O) continue;
#pragma unroll
    for (int j = 0; j < kEPT; ++j) {
      const int e = te * kEPT + j;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (e < blk.e_act)
          d = *reinterpret_cast<const float4*>(
              ydst_b + ((size_t)(blk.n0 + e / blk.K) * 3 + i) * ldyd + o);
        *reinterpret_cast<float4*>(y_s + (e * 3 + i) * ldy + o) =
            make_float4(acc[j][i][0] + d.x, acc[j][i][1] + d.y,
                        acc[j][i][2] + d.z, acc[j][i][3] + d.w);
      }
    }
  }
  __syncthreads();
}

// Layer 0: per edge the nine scalars [cross(dst^, nn), nn - dst, dst] into
// edge_s (EB, 12), dst^ = dst / max(|dst|, 1e-12) (zeros for missing
// edges), then the pre-activation rows
//   y_s[(e*3 + i)*ldy + o] = cross_i W[o][0] + (nn - dst)_i W[o][1]
//                            + dst_i W[o][2]
// for o < O. xyz_b is one instance's (N, 3). Ends with a barrier.
template <int TX>
__device__ __forceinline__ void layer0_rows(float* y_s, int ldy,
                                            float* edge_s,
                                            const float* __restrict__ xyz_b,
                                            const float* __restrict__ W,
                                            int O, const int* idx_s,
                                            const Block& blk) {
  constexpr int EB = Tile<TX>::EB;
  for (int e = threadIdx.x; e < EB; e += kThreads) {
    float* s = edge_s + e * 12;
    if (e < blk.e_act) {
      const float* d = xyz_b + (size_t)(blk.n0 + e / blk.K) * 3;
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
  for (int t = threadIdx.x; t < EB * O; t += kThreads) {
    const int e = t / O, o = t % O;
    const float* s = edge_s + e * 12;
    const float wc = W[o * 3], wl = W[o * 3 + 1], wr = W[o * 3 + 2];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      y_s[(e * 3 + i) * ldy + o] = s[i] * wc + s[3 + i] * wl + s[6 + i] * wr;
  }
  __syncthreads();
}

// The so3 VecActivation of one channel: y (3 components), direction kd.
// Keeps the association y - qpara*k^ + k^*acted, and qpara >= 0 takes the
// positive branch.
__device__ __forceinline__ void vec_act(const float (&y)[3],
                                        const float (&kd)[3], float slope,
                                        float (&out)[3]) {
  const float r = sqrtf(kd[0] * kd[0] + kd[1] * kd[1] + kd[2] * kd[2]);
  const float inv = 1.0f / fmaxf(r, 1e-12f);
  const float k0 = kd[0] * inv, k1 = kd[1] * inv, k2 = kd[2] * inv;
  const float qpara = y[0] * k0 + y[1] * k1 + y[2] * k2;
  const float acted = qpara >= 0.0f ? qpara : slope * qpara;
  out[0] = y[0] - qpara * k0 + k0 * acted;
  out[1] = y[1] - qpara * k1 + k1 * acted;
  out[2] = y[2] - qpara * k2 + k2 * acted;
}

// 4 channels of 3 rows of stride ld: v[i][0..3] = row[i ld .. i ld + 3].
__device__ __forceinline__ void load12(const float* __restrict__ row,
                                       float (&v)[3][4], int ld) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float4 t = *reinterpret_cast<const float4*>(row + (size_t)i * ld);
    v[i][0] = t.x;
    v[i][1] = t.y;
    v[i][2] = t.z;
    v[i][3] = t.w;
  }
}

// The activated features of 4 channels of one edge from per-point rows
// (attention.cu, mean_edge.cu): the source's Y and Kd rows (3 rows of
// stride ld at ps and at ps + ld / 2) plus the destination's yd and kdd.
__device__ __forceinline__ void edge_features(const float* __restrict__ ps,
                                              int ld, const float (&yd)[3][4],
                                              const float (&kdd)[3][4],
                                              float slope, float (&f)[3][4]) {
  float ya[3][4], ka[3][4];
  load12(ps, ya, ld);
  load12(ps + ld / 2, ka, ld);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float y[3] = {ya[0][v] + yd[0][v], ya[1][v] + yd[1][v],
                        ya[2][v] + yd[2][v]};
    const float kd[3] = {ka[0][v] + kdd[0][v], ka[1][v] + kdd[1][v],
                         ka[2][v] + kdd[2][v]};
    float o[3];
    vec_act(y, kd, slope, o);
    f[0][v] = o[0];
    f[1][v] = o[1];
    f[2][v] = o[2];
  }
}

// Turn the direction products in acc into the activated features, in place.
// The thread's columns are o..o+3 < O of its kEPT edges.
template <int TX>
__device__ __forceinline__ void activate(float (&acc)[kEPT][3][4],
                                         const float* y_s, int ldy, int o,
                                         float slope) {
  const int te = threadIdx.x / TX;
#pragma unroll
  for (int j = 0; j < kEPT; ++j) {
    const int e = te * kEPT + j;
    float yv[3][4];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float4 t =
          *reinterpret_cast<const float4*>(y_s + (e * 3 + i) * ldy + o);
      yv[i][0] = t.x;
      yv[i][1] = t.y;
      yv[i][2] = t.z;
      yv[i][3] = t.w;
    }
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float y[3] = {yv[0][v], yv[1][v], yv[2][v]};
      const float kd[3] = {acc[j][0][v], acc[j][1][v], acc[j][2][v]};
      float f[3];
      vec_act(y, kd, slope, f);
      acc[j][0][v] = f[0];
      acc[j][1][v] = f[1];
      acc[j][2][v] = f[2];
    }
  }
}

// out[n][o][i] = (sum_k w[e][head(o)] f[e][o][i]) / div for the tile's
// columns, e = the k-th edge of n, summed in ascending k. w_s is (EB, H)
// in shared memory, or null for weight 1. red is the (EB, 3 OT) buffer.
// Every thread of the block calls this; it has two barriers.
template <int TX>
__device__ __forceinline__ void weighted_sum_store(
    const float (&f)[kEPT][3][4], const float* w_s, int H, int head_c,
    float* red, float* __restrict__ out_b, int O, int o0, float div,
    const Block& blk) {
  using T = Tile<TX>;
  const int to = threadIdx.x % TX, te = threadIdx.x / TX;
  const int o = o0 + 4 * to;
#pragma unroll
  for (int j = 0; j < kEPT; ++j) {
    const int e = te * kEPT + j;
    float w = 1.0f;
    if (w_s != nullptr && o < O) w = w_s[e * H + o / head_c];
    float4* dst = reinterpret_cast<float4*>(red + e * (3 * T::OT) + 12 * to);
    // 12 floats in (column, component) order
    dst[0] = make_float4(f[j][0][0] * w, f[j][1][0] * w, f[j][2][0] * w,
                         f[j][0][1] * w);
    dst[1] = make_float4(f[j][1][1] * w, f[j][2][1] * w, f[j][0][2] * w,
                         f[j][1][2] * w);
    dst[2] = make_float4(f[j][2][2] * w, f[j][0][3] * w, f[j][1][3] * w,
                         f[j][2][3] * w);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < blk.tn * 3 * T::OT; t += kThreads) {
    const int nl = t / (3 * T::OT), q = t % (3 * T::OT);
    const int n = blk.n0 + nl;
    if (n >= blk.Nd || o0 + q / 3 >= O) continue;
    float s = 0.0f;
    for (int k = 0; k < blk.K; ++k)
      s += red[(nl * blk.K + k) * (3 * T::OT) + q];
    out_b[((size_t)n * O + o0) * 3 + q] = s / div;
  }
  __syncthreads();
}

// Attention: the partial sums of 4 channels of one edge's K features f
// (component-major) against q, the 12 floats q_n[n][o..o+3][0..2]: into sq
// kf.q_n times knorm / max(knorm, 1e-12) (which is 1 unless the channel
// vanishes), into c2 knorm^2, each summed over the 4 channels in order.
__device__ __forceinline__ void quad_key_score(const float (&f)[3][4],
                                               const float (&q)[12],
                                               float& sq, float& c2) {
  float s = 0.0f, c = 0.0f;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const float f0 = f[0][v], f1 = f[1][v], f2 = f[2][v];
    const float kn = sqrtf(fmaxf(f0 * f0 + f1 * f1 + f2 * f2, 0.0f));
    const float u = kn / fmaxf(kn, 1e-12f);
    const float dot = f0 * q[3 * v] + f1 * q[3 * v + 1] + f2 * q[3 * v + 2];
    s += dot * u;
    c += kn * kn;
  }
  sq = s;
  c2 = c;
}

// Attention: fold the K features of the thread's columns o..o+3 < O into the
// partial sums sq and c2q of channel group o / 4 (quad_key_score).
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
    quad_key_score(f[j], q, sq[e * Oq + o / 4], c2q[e * Oq + o / 4]);
  }
}

// Attention weights from the partial sums of key_scores: cross_s[e] =
// max(|k|, 1e-12) over all channels of edge e, the logit of head h
// (sum of its sq) / cross / sqrt(3 head_c), and the softmax over the K edges
// of each (point, head) into w_s (EB, H). With sh_s, the head sums of sq go
// there too. Starts and ends with a barrier.
__device__ __forceinline__ void attention_weights(const float* sq,
                                                  const float* c2q,
                                                  float* cross_s, float* w_s,
                                                  float* sh_s, int O,
                                                  int head_c,
                                                  const Block& blk) {
  const int H = O / head_c, Oq = O / 4;
  __syncthreads();
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
    if (sh_s != nullptr) sh_s[e * H + h] = s;
    w_s[e * H + h] = s / cross_s[e] * inv_sqrt;
  }
  __syncthreads();
  const int K = blk.K;
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
}

// Launch configuration of the kernels that tile their outputs (layer0.cu
// and the backward kernels): TX by the output width.
inline int pick_tx(int O) { return O <= 32 ? 8 : (O <= 64 ? 16 : 32); }

}  // namespace lstpu_edge
