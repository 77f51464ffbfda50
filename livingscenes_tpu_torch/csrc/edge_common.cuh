// Device code shared by the fused edge layers' kernels: the so3
// activation and its VJP of one channel (vec_act, vec_act_bwd), with JAX's
// tie rules; the per-edge work of the kernels whose products run once per
// point (mean_edge.cu, attention.cu and their backward kernels
// mean_edge_bwd.cu, attention_bwd.cu: load12, edge_features, edge_rows,
// add12, store12, quad_key_score, attention_weights); and layer 0's edge
// geometry and its rows from [W | D W] (layer0.cu and layer0_bwd.cu:
// layer0_dw, layer0_unit, layer0_edge, Layer0Channel), so that each
// backward recomputes its forward's rows with the forward's own code and
// association, and an activation takes the same branch in both.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstpu_edge {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;
constexpr int kMaxSmem = 227 * 1024;

// The destination points and edges of one block.
struct Block {
  int b;       // instance
  int n0;      // first destination point
  int tn;      // destination points a block owns
  int e_act;   // edges of the points that exist: min(tn, Nd - n0) * K
  int K;
  int Nd;
};

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

// VJP of vec_act w.r.t. y and kd for one channel, as
// livingscenes_tpu/nn/pallas_attention.py:73-105 computes it:
// where(qpara >= 0, 0, slope - 1) for the activation, the direction's norm
// masked to r > 1e-12.
__device__ __forceinline__ void vec_act_bwd(const float (&y)[3],
                                            const float (&kd)[3],
                                            const float (&df)[3], float slope,
                                            float (&dy)[3], float (&dkd)[3]) {
  const float r = sqrtf(kd[0] * kd[0] + kd[1] * kd[1] + kd[2] * kd[2]);
  const float inv = 1.0f / fmaxf(r, 1e-12f);
  const float k[3] = {kd[0] * inv, kd[1] * inv, kd[2] * inv};
  const float qpara = y[0] * k[0] + y[1] * k[1] + y[2] * k[2];
  const float acted = qpara >= 0.0f ? qpara : slope * qpara;
  const float delta = acted - qpara;
  const float d_delta = df[0] * k[0] + df[1] * k[1] + df[2] * k[2];
  const float d_q = qpara >= 0.0f ? 0.0f : d_delta * (slope - 1.0f);
  float dk[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dy[i] = df[i] + d_q * k[i];
    dk[i] = df[i] * delta + d_q * y[i];
  }
  const float d_inv = dk[0] * kd[0] + dk[1] * kd[1] + dk[2] * kd[2];
  const float d_r = r > 1e-12f ? -d_inv * inv * inv : 0.0f;
  const float coef = d_r * inv;
#pragma unroll
  for (int i = 0; i < 3; ++i) dkd[i] = dk[i] * inv + kd[i] * coef;
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

// Attention weights from the partial sums of quad_key_score (sq, c2q:
// (edges, O / 4) in shared memory): cross_s[e] =
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

// y = Y + yd and kd = Kd + kdd of the thread's 4 channels of one edge: the
// source's rows at ps (Y) and ps + kd_off (Kd), stride ld, plus the
// destination's (the association of edge_features).
__device__ __forceinline__ void edge_rows(const float* __restrict__ ps,
                                          int kd_off, int ld,
                                          const float (&yd)[3][4],
                                          const float (&kdd)[3][4],
                                          float (&y)[3][4], float (&kd)[3][4]) {
  load12(ps, y, ld);
  load12(ps + kd_off, kd, ld);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      y[i][v] += yd[i][v];
      kd[i][v] += kdd[i][v];
    }
}

// The 12 floats of the thread's 4 channels of a (channel, component) row:
// p[0..11] of q_n or g.
__device__ __forceinline__ void load_quad(const float* __restrict__ p,
                                          float (&v)[12]) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int t = 0; t < 3; ++t) {
    const float4 a = p4[t];
    v[4 * t] = a.x;
    v[4 * t + 1] = a.y;
    v[4 * t + 2] = a.z;
    v[4 * t + 3] = a.w;
  }
}

// rows[i * ld .. + 3] += v[i][0..3] for i < 3, by vector atomics (atomicAdd
// on a float4, one red.global.add.v4.f32 on sm_90).
__device__ __forceinline__ void add12(float* rows, int ld,
                                      const float (&v)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    atomicAdd(reinterpret_cast<float4*>(rows + (size_t)i * ld),
              make_float4(v[i][0], v[i][1], v[i][2], v[i][3]));
}

// rows[i * ld .. + 3] = v[i][0..3] for i < 3.
__device__ __forceinline__ void store12(float* rows, int ld,
                                        const float (&v)[3][4]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    *reinterpret_cast<float4*>(rows + (size_t)i * ld) =
        make_float4(v[i][0], v[i][1], v[i][2], v[i][3]);
}

// Layer 0 (layer0.cu, layer0_bwd.cu). Every edge channel is linear in the
// three vectors (cross(dst^, nn), nn - dst, dst), so with DW = D W (O x 3)
//   y[o][i]  = cross_i W[o][0]  + (nn - dst)_i W[o][1]  + dst_i W[o][2]
//   Dy[o][i] = cross_i DW[o][0] + (nn - dst)_i DW[o][1] + dst_i DW[o][2]

// dw_s[o * 3 + c] = sum_p D[o][p] W[p][c] in ascending p, for the block's
// threads. W (O, 3), D (O, O) in device memory.
__device__ __forceinline__ void layer0_dw(float* dw_s,
                                          const float* __restrict__ W,
                                          const float* __restrict__ D, int O) {
  for (int t = threadIdx.x; t < 3 * O; t += blockDim.x) {
    const int o = t / 3, c = t % 3;
    const float* d_row = D + (size_t)o * O;
    float s = 0.0f;
#pragma unroll 8
    for (int p = 0; p < O; ++p) s = fmaf(d_row[p], W[p * 3 + c], s);
    dw_s[t] = s;
  }
}

// The norm of dst clamped at 1e-12 and dst^ = dst / that.
__device__ __forceinline__ float layer0_unit(const float (&d)[3],
                                             float (&h)[3]) {
  const float dn =
      fmaxf(sqrtf(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]), 1e-12f);
  h[0] = d[0] / dn;
  h[1] = d[1] / dn;
  h[2] = d[2] / dn;
  return dn;
}

// The edge's first two vectors: cross(dst^, nn) and nn - dst.
__device__ __forceinline__ void layer0_edge(const float (&h)[3],
                                            const float (&d)[3],
                                            const float* p, float (&cr)[3],
                                            float (&nd)[3]) {
  const float n0 = p[0], n1 = p[1], n2 = p[2];
  cr[0] = h[1] * n2 - h[2] * n1;
  cr[1] = h[2] * n0 - h[0] * n2;
  cr[2] = h[0] * n1 - h[1] * n0;
  nd[0] = n0 - d[0];
  nd[1] = n1 - d[1];
  nd[2] = n2 - d[2];
}

// One channel o of a destination: W's and DW's columns and the
// destination's terms dst_i W[o][2] and dst_i DW[o][2]; rows() gives y and
// D y of an edge of that destination.
struct Layer0Channel {
  float wc, wl, wr, dwc, dwl, dwr, yd[3], kdd[3];
  __device__ __forceinline__ Layer0Channel(const float* w_s,
                                           const float* dw_s, int o,
                                           const float (&d)[3]) {
    const float* w = w_s + o * 3;
    const float* dw = dw_s + o * 3;
    wc = w[0];
    wl = w[1];
    wr = w[2];
    dwc = dw[0];
    dwl = dw[1];
    dwr = dw[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      yd[i] = d[i] * wr;
      kdd[i] = d[i] * dwr;
    }
  }
  __device__ __forceinline__ void rows(const float (&cr)[3],
                                       const float (&nd)[3], float (&y)[3],
                                       float (&kd)[3]) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      y[i] = fmaf(cr[i], wc, fmaf(nd[i], wl, yd[i]));
      kd[i] = fmaf(cr[i], dwc, fmaf(nd[i], dwl, kdd[i]));
    }
  }
};

}  // namespace lstpu_edge
