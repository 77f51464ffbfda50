// The per-point products of the fused edge layers: grouped f32 matrix
// products C = A B over the (point, component) rows of a layer, launched
// from attention.cu (lstpu_attention_products) and mean_edge.cu
// (lstpu_mean_products).
//
// Part of the replacement of the TPU kernels
// livingscenes_tpu/nn/pallas_attention.py::_attention_kernel and
// ::_mean_edge_kernel, which run the edge convolution W_l nn and the
// direction products D y once per edge. Both are linear in the gathered
// row, so attention.cu and mean_edge.cu ask for them once per point instead
// (see there): first the weight products D W (a few blocks), then each
// point's row times [W | D W] (C x 4 O for attention's two branches, C x 2 O
// for the mean's one), which gives its pre-activation rows and their
// directions at once.
//
// What bounds it on the H100: at the encoder's shapes (B = 64), operations
// at layers 4-6 (2 C flops per output, C >= 64) and bytes at layers 2-3
// (C = 32 or 64: each output row of 4 O floats is written once and read
// again by the edge pass). About 40 GFLOP an encode: 0.6 ms at 67 TFLOP/s
// f32.
//
// Design: plain f32 FMAs on the CUDA cores (no TF32: three digits would
// move the near-tie kNN picks downstream and the card-against-CPU checks).
// A block of 256 threads computes a 128 x BN tile of C (BN = 64 or 128),
// 8 x BN/16 outputs a thread from 4-wide fragments of A and B in shared
// memory; the next 8-deep slice of A and B is fetched into registers while
// the present one is multiplied (two shared buffers, one barrier a slice),
// two blocks an SM. A is read through strides, (row / 3) * a_pt +
// (row % 3) * a_comp + k * a_k, so the (B, N, C, 3) features are read in
// place as (B N 3) x C rows. Up to four independent products share one
// launch: the blocks are numbered across them.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstpu_points {

constexpr int kGemmThreads = 256;
constexpr int kBM = 128;  // rows of a block's tile
constexpr int kBK = 8;    // depth of a slice

// C[r * ldc + o] = sum_k A(r, k) B[k * ldb + o] for r < M, o < N, k < Kd.
// B and C are 16-byte aligned, ldb, ldc and N multiples of 4.
struct Gemm {
  const float* A;
  size_t a_pt;  // A(r, k) = A[(r / 3) a_pt + (r % 3) a_comp + k a_k]
  int a_comp, a_k;
  const float* B;
  int ldb;
  float* C;
  int ldc;
  int M, N, Kd;
  int tiles_n;  // column tiles: ceil(N / BN)
  int first;    // the first block of this product in the launch
};

constexpr int kMaxGroup = 4;
struct GemmGroup {
  Gemm g[kMaxGroup];
  int count;
};

// two blocks an SM: at most 128 registers a thread
template <int BN>
__global__ void __launch_bounds__(kGemmThreads, 2)
    grouped_gemm_kernel(GemmGroup grp) {
  constexpr int TN = BN / 16;                   // columns a thread: 4 or 8
  constexpr int BQ = BN / 4;                    // float4s in a row of B's slice
  __shared__ float4 As4[2][kBK][kBM / 4];       // A's slice, transposed
  __shared__ float4 Bs4[2][kBK][BQ];
  Gemm g = grp.g[0];  // constant indices: the group stays out of local memory
#pragma unroll
  for (int p = 1; p < kMaxGroup; ++p)
    if (p < grp.count && (int)blockIdx.x >= grp.g[p].first) g = grp.g[p];
  const int tile = blockIdx.x - g.first;
  const int m0 = (tile / g.tiles_n) * kBM, n0 = (tile % g.tiles_n) * BN;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  // what a thread fetches: A rows am, depths ak..ak+3; one float4 of B
  const int am = threadIdx.x % kBM, ak = (threadIdx.x / kBM) * 4;
  const int ar = m0 + am;
  const float* a_row =
      g.A + (size_t)(ar / 3) * g.a_pt + (size_t)(ar % 3) * g.a_comp;
  const bool b_on = threadIdx.x < kBK * BQ;
  const int bk = threadIdx.x / BQ, bn = n0 + 4 * (threadIdx.x % BQ);
  float a_pre[4];
  float4 b_pre;
  auto fetch = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int k = k0 + ak + q;
      a_pre[q] = ar < g.M && k < g.Kd ? a_row[(size_t)k * g.a_k] : 0.0f;
    }
    b_pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (b_on && k0 + bk < g.Kd && bn < g.N)
      b_pre = *reinterpret_cast<const float4*>(g.B + (size_t)(k0 + bk) * g.ldb +
                                               bn);
  };
  auto stash = [&](int buf) {
    float* as = reinterpret_cast<float*>(&As4[buf][0][0]);
#pragma unroll
    for (int q = 0; q < 4; ++q) as[(ak + q) * kBM + am] = a_pre[q];
    if (b_on) Bs4[buf][bk][threadIdx.x % BQ] = b_pre;
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int k0 = 0, buf = 0; k0 < g.Kd; k0 += kBK, buf ^= 1) {
    const bool more = k0 + kBK < g.Kd;
    if (more) fetch(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      // rows 4 ty..4 ty+3 and 64 + 4 ty..; columns 4 tx.. (and 64 + 4 tx..)
      const float4 a0 = As4[buf][kk][ty], a1 = As4[buf][kk][16 + ty];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[TN];
      const float4 b0 = Bs4[buf][kk][tx];
      bv[0] = b0.x;
      bv[1] = b0.y;
      bv[2] = b0.z;
      bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = Bs4[buf][kk][16 + tx];
        bv[4] = b1.x;
        bv[5] = b1.y;
        bv[6] = b1.z;
        bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= g.M) continue;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int o = n0 + 64 * h + 4 * tx;
      if (o < g.N)
        *reinterpret_cast<float4*>(g.C + (size_t)r * g.ldc + o) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    }
  }
}

template <int BN>
int launch_group(GemmGroup grp, cudaStream_t stream) {
  int blocks = 0;
  for (int p = 0; p < grp.count; ++p) {
    Gemm& g = grp.g[p];
    g.tiles_n = (g.N + BN - 1) / BN;
    g.first = blocks;
    blocks += (g.M + kBM - 1) / kBM * g.tiles_n;
  }
  grouped_gemm_kernel<BN><<<blocks, kGemmThreads, 0, stream>>>(grp);
  return (int)cudaGetLastError();
}

// A row-major product: A (m, k) with rows of lda floats, times bt (k, n)
// with rows of ldb floats, into c with rows of ldc floats.
inline Gemm row_major(const float* a, int lda, int m, const float* bt, int ldb,
                      float* c, int ldc, int n, int k) {
  return Gemm{a, (size_t)3 * lda, lda, 1, bt, ldb, c, ldc, m, n, k, 0, 0};
}

// Every (point, component) row of `points` (points, C, 3) features times w
// (C, ld): out (points, 3, ld). Row (n, i) of A is feature[n][.][i], read in
// place: A(r, c) at n 3 C + 3 c + i.
inline Gemm point_rows(const float* f, int points, int C, const float* w,
                       int ld, float* out) {
  return Gemm{f, (size_t)3 * C, 1, 3, w, ld, out, ld, points * 3, ld, C, 0, 0};
}

// Launch the products of `grp` (count <= 4): tiles 128 wide when every
// product has 128 columns or more, else 64.
inline int run_group(GemmGroup grp, cudaStream_t stream) {
  int n_min = grp.g[0].N;
  for (int p = 1; p < grp.count; ++p)
    n_min = grp.g[p].N < n_min ? grp.g[p].N : n_min;
  return n_min >= 128 ? launch_group<128>(grp, stream)
                      : launch_group<64>(grp, stream);
}

}  // namespace lstpu_points
