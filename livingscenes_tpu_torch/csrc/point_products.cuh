// The per-point products of the fused edge layers: grouped f32 matrix
// products C = A B over the (point, component) rows of a layer, launched
// from attention.cu (lstpu_attention_products), mean_edge.cu
// (lstpu_mean_products) and attention_bwd.cu (lstpu_attention_bwd_products).
//
// Part of the replacement of the TPU kernels
// livingscenes_tpu/nn/pallas_attention.py::_attention_kernel,
// ::_mean_edge_kernel and ::_attention_bwd_kernel, which run the edge
// convolution W_l nn and the direction products D y once per edge (the
// backward also their transposes and the weight gradients). All are linear
// in the gathered row, so the port asks for them once per point instead
// (see there): first the weight products D W (a few blocks), then each
// point's row times [W | D W] (C x 4 O for attention's two branches, C x 2 O
// for the mean's one), which gives its pre-activation rows and their
// directions at once; in the backward, each point's summed cotangents times
// D and W_l, and the weight gradients as reductions over the points
// (A^T B: many rows, a small output).
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
// place as (B N 3) x C rows, and a matrix of rows as its transpose for a
// reduction over the rows. A reduction splits its depth into a fixed
// number of ranges, each block writes the partial product of its range
// into its own copy of C, and fold_splits adds the copies in order: no
// atomics, the same bits on every run. Up to four independent products
// share one launch: the blocks are numbered across them. The splits and
// the added term are a second instance of the kernel (kGeneral), so that
// the forward's products keep their registers.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstpu_points {

constexpr int kGemmThreads = 256;
constexpr int kBM = 128;  // rows of a block's tile
constexpr int kBK = 8;    // depth of a slice

// C[r * ldc + o] = sum_k A(r, k) B[k * ldb + o] (+ add[r * ldc + o]) for
// r < M, o < N, k < Kd. B and C are 16-byte aligned, ldb, ldc and N
// multiples of 4. With splits > 1 the depth is cut into ranges of k_chunk
// and range s writes its partial product to C + s * c_split (fold_splits
// adds them).
struct Gemm {
  const float* A;
  size_t a_pt;  // A(r, k) = A[(r / 3) a_pt + (r % 3) a_comp + k a_k]
  int a_comp, a_k;
  const float* B;
  int ldb;
  float* C;
  int ldc;
  const float* add;  // null, or added to the product (may be C itself)
  int M, N, Kd;
  int splits, k_chunk;
  size_t c_split;
  int tiles_n;  // column tiles: ceil(N / BN)
  int tiles;    // tiles of C: row tiles x tiles_n
  int first;    // the first block of this product in the launch
};

constexpr int kMaxGroup = 4;
struct GemmGroup {
  Gemm g[kMaxGroup];
  int count;
};

// two blocks an SM: at most 128 registers a thread. kGeneral: the group
// has split reductions or added terms.
template <int BN, bool kGeneral>
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
  const int local = blockIdx.x - g.first;
  const int split = kGeneral ? local / g.tiles : 0;
  const int tile = kGeneral ? local % g.tiles : local;
  const int m0 = (tile / g.tiles_n) * kBM, n0 = (tile % g.tiles_n) * BN;
  const int k_lo = kGeneral ? split * g.k_chunk : 0;
  const int k_hi = kGeneral ? min(g.Kd, k_lo + g.k_chunk) : g.Kd;
  float* c_out = kGeneral ? g.C + split * g.c_split : g.C;
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
      a_pre[q] = ar < g.M && k < k_hi ? a_row[(size_t)k * g.a_k] : 0.0f;
    }
    b_pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (b_on && k0 + bk < k_hi && bn < g.N)
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

  fetch(k_lo);
  stash(0);
  __syncthreads();
  for (int k0 = k_lo, buf = 0; k0 < k_hi; k0 += kBK, buf ^= 1) {
    const bool more = k0 + kBK < k_hi;
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
      if (o >= g.N) continue;
      float4 v = make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                             acc[i][4 * h + 2], acc[i][4 * h + 3]);
      if (kGeneral && g.add != nullptr) {
        const float4 a =
            *reinterpret_cast<const float4*>(g.add + (size_t)r * g.ldc + o);
        v = make_float4(v.x + a.x, v.y + a.y, v.z + a.z, v.w + a.w);
      }
      *reinterpret_cast<float4*>(c_out + (size_t)r * g.ldc + o) = v;
    }
  }
}

template <int BN, bool kGeneral>
int launch_group(GemmGroup grp, cudaStream_t stream) {
  int blocks = 0;
  for (int p = 0; p < grp.count; ++p) {
    Gemm& g = grp.g[p];
    g.tiles_n = (g.N + BN - 1) / BN;
    g.tiles = (g.M + kBM - 1) / kBM * g.tiles_n;
    g.first = blocks;
    blocks += g.tiles * g.splits;
  }
  grouped_gemm_kernel<BN, kGeneral><<<blocks, kGemmThreads, 0, stream>>>(grp);
  return (int)cudaGetLastError();
}

// A row-major product: A (m, k) with rows of lda floats, times bt (k, n)
// with rows of ldb floats, into c with rows of ldc floats.
inline Gemm row_major(const float* a, int lda, int m, const float* bt, int ldb,
                      float* c, int ldc, int n, int k) {
  return Gemm{a, (size_t)3 * lda, lda, 1, bt, ldb, c, ldc, nullptr, m, n, k,
              1, k, 0, 0, 0, 0};
}

// Every (point, component) row of `points` (points, C, 3) features times w
// (C, ld): out (points, 3, ld). Row (n, i) of A is feature[n][.][i], read in
// place: A(r, c) at n 3 C + 3 c + i.
inline Gemm point_rows(const float* f, int points, int C, const float* w,
                       int ld, float* out) {
  return Gemm{f, (size_t)3 * C, 1, 3, w, ld, out, ld, nullptr, points * 3,
              ld, C, 1, C, 0, 0, 0, 0};
}

// The reduction over rows C = A^T B, with the k-th row of A at a + k lda
// (P floats used) and of B at b + k ldb (Q floats used), for k < rows,
// into `splits` partial copies of the (P, Q) result at c + s c_split (row
// stride Q): fold_splits adds them.
inline Gemm rows_at_b(const float* a, int lda, int P, const float* b, int ldb,
                      int Q, int rows, float* c, int splits, size_t c_split) {
  Gemm g{};
  g.A = a;  // A(p, k) = a[p + k lda]: (p / 3) 3 + (p % 3) + k lda
  g.a_pt = 3;
  g.a_comp = 1;
  g.a_k = lda;
  g.B = b;
  g.ldb = ldb;
  g.C = c;
  g.ldc = Q;
  g.M = P;
  g.N = Q;
  g.Kd = rows;
  g.splits = splits;
  g.k_chunk = (rows + splits - 1) / splits;
  g.c_split = c_split;
  return g;
}

// Launch the products of `grp` (count <= 4): tiles 128 wide when every
// product has 128 columns or more, else 64.
inline int run_group(GemmGroup grp, cudaStream_t stream) {
  int n_min = grp.g[0].N;
  bool general = false;
  for (int p = 0; p < grp.count; ++p) {
    n_min = grp.g[p].N < n_min ? grp.g[p].N : n_min;
    general = general || grp.g[p].splits > 1 || grp.g[p].add != nullptr;
  }
  if (general)
    return n_min >= 128 ? launch_group<128, true>(grp, stream)
                        : launch_group<64, true>(grp, stream);
  return n_min >= 128 ? launch_group<128, false>(grp, stream)
                      : launch_group<64, false>(grp, stream);
}

// out[i] = sum_s part[s * len + i] in ascending s: the partial products of
// a split reduction folded in a fixed order. (static: each source that
// includes this header has its own copy.)
static __global__ void fold_splits_kernel(const float* __restrict__ part,
                                          float* __restrict__ out, int len,
                                          int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= len) return;
  float s = 0.0f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * len + i];
  out[i] = s;
}

inline int fold_splits(const float* part, float* out, int len, int splits,
                       cudaStream_t stream) {
  const int threads = 256;
  fold_splits_kernel<<<(len + threads - 1) / threads, threads, 0, stream>>>(
      part, out, len, splits);
  return (int)cudaGetLastError();
}

}  // namespace lstpu_points
