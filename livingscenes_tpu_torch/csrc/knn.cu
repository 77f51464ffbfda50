// Exact k-nearest neighbours (k <= 16), sorted ascending.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_knn.py::_knn_kernel.
// Semantics (shared with livingscenes_tpu_torch/ops/knn.py): the distance
// is max(|q|^2 - 2 q.p + |p|^2, 0); the k smallest come out ascending, and
// among equal distances the lower source index comes first.
//
// What bounds it on the H100: operations. The q.p products are
// 2 * Nq * Np * D flops per instance (D = 3 * channels, up to 768), against
// (Nq + Np) * D * 4 bytes of input; the selection adds a few compares per
// distance. This first version runs the products in plain f32 on the CUDA
// cores (no TF32: the graph must stay f32-faithful).
// Design: one block of 256 threads per (instance, 64-query tile). Source
// tiles of 64 points stream through shared memory in 32-wide chunks of D;
// each thread accumulates a 4x4 block of dot products, and the norms are
// summed from the same shared chunks. The 64x64 distance tile is written to
// shared memory, and four threads per query each scan a quarter of its
// columns in ascending index order, keeping a sorted top-16 in registers.
// The list is ordered by (distance, index), so the four partial lists merge
// exactly: two butterfly exchanges inside the quad, after which every lane
// holds the query's top 16.
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using namespace lstpu_select;

constexpr int kQT = 64;    // queries per block
constexpr int kPT = 64;    // source points per tile
constexpr int kDC = 32;    // feature chunk
constexpr int kThreads = 256;
constexpr int kDistStride = kPT + 4;

__global__ void __launch_bounds__(kThreads)
    knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
               float* __restrict__ out_d, int32_t* __restrict__ out_i, int nq,
               int np, int D, int k) {
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const float* qb = q + (size_t)b * nq * D;
  const float* pb = p + (size_t)b * np * D;

  __shared__ float qs[kQT][kDC + 1];
  __shared__ float ps[kPT][kDC + 1];
  __shared__ float dist[kQT][kDistStride];
  __shared__ float q2s[kQT];
  __shared__ float p2s[kPT];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // 4x4 dot-product block
  const int row = tid >> 2, sub = tid & 3;  // selection: 4 lanes a query

  float td[kK];
  int ti[kK];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    td[m] = INFINITY;
    ti[m] = 0x7fffffff;
  }

  for (int p0 = 0; p0 < np; p0 += kPT) {
    float acc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
    float q2_part = 0.0f, p2_part = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kDC) {
      for (int e = tid; e < kQT * kDC; e += kThreads) {
        const int r = e / kDC, c = e % kDC;
        const int qi = q0 + r, d = d0 + c;
        qs[r][c] = (qi < nq && d < D) ? qb[(size_t)qi * D + d] : 0.0f;
        const int pi = p0 + r;
        ps[r][c] = (pi < np && d < D) ? pb[(size_t)pi * D + d] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kDC / 4; ++m) {
        const float qv = qs[row][sub + 4 * m];
        const float pv = ps[row][sub + 4 * m];
        q2_part += qv * qv;
        p2_part += pv * pv;
      }
#pragma unroll 8
      for (int c = 0; c < kDC; ++c) {
        float a[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = qs[ty + 16 * r][c];
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) bb[cc] = ps[tx + 16 * cc][c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) acc[r][cc] += a[r] * bb[cc];
      }
      __syncthreads();
    }
    // Norms: the four lanes of a quad hold strided partial sums of one row.
    q2_part += __shfl_xor_sync(0xffffffffu, q2_part, 1);
    q2_part += __shfl_xor_sync(0xffffffffu, q2_part, 2);
    p2_part += __shfl_xor_sync(0xffffffffu, p2_part, 1);
    p2_part += __shfl_xor_sync(0xffffffffu, p2_part, 2);
    if (sub == 0) {
      q2s[row] = q2_part;
      p2s[row] = p2_part;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int qr = ty + 16 * r, pc = tx + 16 * cc;
        const float d = q2s[qr] - 2.0f * acc[r][cc] + p2s[pc];
        dist[qr][pc] = p0 + pc < np ? fmaxf(d, 0.0f) : INFINITY;
      }
    }
    __syncthreads();
    // Ascending column order inside each lane keeps the index tie-break.
#pragma unroll
    for (int m = 0; m < kPT / 4; ++m) {
      const int c = sub + 4 * m;
      if (p0 + c < np) insert(td, ti, dist[row][c], p0 + c);
    }
  }

  merge_partner(td, ti, 1);
  merge_partner(td, ti, 2);
  const int qi = q0 + row;
  if (sub == 0 && qi < nq) {
    float* od = out_d + ((size_t)b * nq + qi) * k;
    int32_t* oi = out_i + ((size_t)b * nq + qi) * k;
#pragma unroll
    for (int m = 0; m < kK; ++m) {
      if (m < k) {
        od[m] = td[m];
        oi[m] = ti[m];
      }
    }
  }
}

}  // namespace

// q (B, nq, D), p (B, np, D) f32; out_d (B, nq, k) f32, out_i (B, nq, k)
// int32; 1 <= k <= min(16, np).
extern "C" int lstpu_knn(const void* q, const void* p, void* out_d,
                         void* out_i, int B, int nq, int np, int D, int k,
                         void* stream) {
  if (B <= 0 || nq <= 0 || np <= 0 || D <= 0 || k <= 0 || k > kK || k > np)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + kQT - 1) / kQT, B);
  knn_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(p),
      static_cast<float*>(out_d), static_cast<int32_t*>(out_i), nq, np, D, k);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_knn_max_k() { return kK; }
