// The per-point products of the fused edge layers: grouped f32 matrix
// products C = A B over the (point, component) rows of a layer, launched
// from attention.cu (lstpu_attention_products), mean_edge.cu
// (lstpu_mean_products) and, through edge_bwd_products, from
// attention_bwd.cu (lstpu_attention_bwd_products, two branches) and
// mean_edge_bwd.cu (lstpu_mean_bwd_products, one branch).
//
// Part of the replacement of the TPU kernels
// livingscenes_tpu/nn/pallas_attention.py::_attention_kernel,
// ::_mean_edge_kernel, ::_attention_bwd_kernel and ::_mean_edge_bwd_kernel,
// which run the edge convolution W_l nn and the direction products D y
// once per edge (the backward kernels also their transposes and the weight
// gradients). All are linear in the gathered row, so the port asks for
// them once per point instead (see there): first the weight products D W
// (a few blocks), then each point's row times [W | D W] (C x 4 O for
// attention's two branches, C x 2 O for the mean's one), which gives its
// pre-activation rows and their directions at once; in the backward, each
// point's summed cotangents times D and W_l, and the weight gradients as
// reductions over the points (A^T B: many rows, a small output).
//
// What bounds it on the H100: at the encoder's shapes (B = 64), operations
// at layers 4-6 (2 C flops per output, C >= 64) and bytes at layers 1-3
// (C = 32 or 64: each output row of 2 or 4 O floats is written once and
// read again by the edge pass). About 40 GFLOP an encode: 0.6 ms at 67
// TFLOP/s f32.
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
  bool narrow;  // a reduction in narrow tiles (rows_at_b, narrow_tile)
};

constexpr int kMaxGroup = 4;
struct GemmGroup {
  Gemm g[kMaxGroup];
  int count;
};

constexpr int kNT = 32;  // a narrow reduction's tile: 32 x 32 outputs
constexpr int kNK = 32;  // the depth of its slices

// One tile of a split reduction C = A^T B (rows_at_b) whose output is
// narrow (P, Q <= 32; the wide tile of 128 x BN would leave 7/8 of its
// work idle): C's 32 x 32 tile, thread (ty, tx) of 16 x 16 its rows 2 ty,
// 2 ty + 1 and columns 2 tx, 2 tx + 1; slices of 32 rows of A and of B,
// one float4 of each a thread, the next fetched while the present one is
// multiplied. Each output sums in ascending k from 0 by fmaf, as the wide
// tile does: the same bits.
__device__ __forceinline__ void narrow_tile(const Gemm& g, int local) {
  __shared__ float4 An[2][kNK][kNT / 4];
  __shared__ float4 Bn[2][kNK][kNT / 4];
  const int split = local / g.tiles, tile = local % g.tiles;
  const int m0 = (tile / g.tiles_n) * kNT, n0 = (tile % g.tiles_n) * kNT;
  const int k_lo = split * g.k_chunk, k_hi = min(g.Kd, k_lo + g.k_chunk);
  const int lk = threadIdx.x / 8, lq = threadIdx.x % 8;  // slice row, float4
  const bool a_on = m0 + 4 * lq < g.M, b_on = n0 + 4 * lq < g.N;
  float4 a_pre, b_pre;
  auto fetch = [&](int k0) {
    const int k = k0 + lk;
    a_pre = b_pre = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (k < k_hi && a_on)
      a_pre = *reinterpret_cast<const float4*>(g.A + (size_t)k * g.a_k + m0 +
                                               4 * lq);
    if (k < k_hi && b_on)
      b_pre = *reinterpret_cast<const float4*>(g.B + (size_t)k * g.ldb + n0 +
                                               4 * lq);
  };
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[2][2] = {};
  fetch(k_lo);
  An[0][lk][lq] = a_pre;
  Bn[0][lk][lq] = b_pre;
  __syncthreads();
  for (int k0 = k_lo, buf = 0; k0 < k_hi; k0 += kNK, buf ^= 1) {
    const bool more = k0 + kNK < k_hi;
    if (more) fetch(k0 + kNK);
    const float* as = reinterpret_cast<const float*>(&An[buf][0][0]);
    const float* bs = reinterpret_cast<const float*>(&Bn[buf][0][0]);
#pragma unroll 8
    for (int kk = 0; kk < kNK; ++kk) {
      const float2 a = *reinterpret_cast<const float2*>(as + kk * kNT + 2 * ty);
      const float2 b = *reinterpret_cast<const float2*>(bs + kk * kNT + 2 * tx);
      acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
      acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
      acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
      acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
    }
    if (more) {
      An[buf ^ 1][lk][lq] = a_pre;
      Bn[buf ^ 1][lk][lq] = b_pre;
    }
    __syncthreads();
  }
  float* c_out = g.C + split * g.c_split;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = m0 + 2 * ty + i;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int o = n0 + 2 * tx + j;
      if (r < g.M && o < g.N) c_out[(size_t)r * g.ldc + o] = acc[i][j];
    }
  }
}

// two blocks an SM: at most 128 registers a thread. kGeneral: the group
// has split reductions or added terms; kNarrow: narrow reductions among
// them, whose blocks take narrow_tile.
template <int BN, bool kGeneral, bool kNarrow = false>
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
  if constexpr (kNarrow) {
    if (g.narrow) {
      narrow_tile(g, local);
      return;
    }
  }
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
  // a row-major A (a_k = 1) is read as one float4 where it is aligned, in
  // the backward's instances (kGeneral: the products by D, W_l and
  // W_delta). The forward's instance keeps the scalar read: its large
  // products read A with a stride of 3, and the vector path's registers
  // cost them 5-11 % (PERF.md §6, row 14)
  const bool a_vec = kGeneral && g.a_k == 1 &&
                     (reinterpret_cast<uintptr_t>(a_row) & 15) == 0;
  auto fetch = [&](int k0) {
    if (a_vec && ar < g.M && k0 + ak + 3 < k_hi) {
      const float4 v = *reinterpret_cast<const float4*>(a_row + k0 + ak);
      a_pre[0] = v.x;
      a_pre[1] = v.y;
      a_pre[2] = v.z;
      a_pre[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = k0 + ak + q;
        a_pre[q] = ar < g.M && k < k_hi ? a_row[(size_t)k * g.a_k] : 0.0f;
      }
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

template <int BN, bool kGeneral, bool kNarrow = false>
int launch_group(GemmGroup grp, cudaStream_t stream) {
  int blocks = 0;
  for (int p = 0; p < grp.count; ++p) {
    Gemm& g = grp.g[p];
    const int bm = g.narrow ? kNT : kBM, bn = g.narrow ? kNT : BN;
    g.tiles_n = (g.N + bn - 1) / bn;
    g.tiles = (g.M + bm - 1) / bm * g.tiles_n;
    g.first = blocks;
    blocks += g.tiles * g.splits;
  }
  grouped_gemm_kernel<BN, kGeneral, kNarrow><<<blocks, kGemmThreads, 0, stream>>>(grp);
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
// stride Q): fold_splits adds them. With P, Q <= 32 (and a, b, lda, ldb
// whole float4s) in narrow tiles.
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
  g.narrow = P <= kNT && Q <= kNT && P % 4 == 0 && Q % 4 == 0 &&
             lda % 4 == 0 && ldb % 4 == 0;
  return g;
}

// Launch the products of `grp` (count <= 4): wide tiles 128 wide when
// every product in them has 128 columns or more, else 64.
inline int run_group(GemmGroup grp, cudaStream_t stream) {
  int n_min = 128;
  bool general = false, narrow = false;
  for (int p = 0; p < grp.count; ++p) {
    if (!grp.g[p].narrow && grp.g[p].N < n_min) n_min = grp.g[p].N;
    general = general || grp.g[p].splits > 1 || grp.g[p].add != nullptr;
    narrow = narrow || grp.g[p].narrow;
  }
  if (narrow)
    return n_min >= 128 ? launch_group<128, true, true>(grp, stream)
                        : launch_group<64, true, true>(grp, stream);
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

// The number of partial sums of the backward's reductions over `rows`
// rows: about one for every 1024 rows, at most 256 (a fixed count for a
// shape).
inline int reduction_splits(int rows) {
  const int s = (rows + 1023) / 1024;
  return s < 1 ? 1 : (s > 256 ? 256 : s);
}

// The linear rest of an edge layer's backward with nb = 1 or 2 branches
// (attention_bwd.cu, mean_edge_bwd.cu: see there). Rows of ld = 2 nb O
// floats; grows (B (Ns + Nd), 3, ld): the source rows' summed cotangents
// U, V, then the destination rows' Ub, Vb, columns [U_1..U_nb | V_1..V_nb];
// prows the same points' per-point rows, columns [Y_1..Y_nb | Kd_1..]; src3
// (B, Ns, 3, C), dst3 (B, Nd, 3, C) the features, components first; W_l,
// W_delta (nb O, C); D[b] (O, O). Writes Z = U + D^T V over U in grows,
// dsrc3 = Z_src W_l, ddst3 = Z_dst W_delta, and out (2 nb C O + nb O O) =
// [d_W_l (nb O, C) | d_D_1..d_D_nb | d_W_delta (nb O, C)] through part,
// scratch of reduction_splits(3 B (Ns + Nd)) x that length. Three
// launches: Z beside the split reductions d_D_b = sum over all rows of
// V_b^T Y_b; the per-point products d_src, d_dst beside the split
// reductions d_W_l = sum Z_src^T src, d_W_delta = sum Z_dst^T dst; the
// fold of the partial sums.
inline int edge_bwd_products(float* grows, const float* prows,
                             const float* src3, const float* dst3,
                             const float* W_l, const float* W_delta,
                             const float* const* D, int nb, float* dsrc3,
                             float* ddst3, float* part, float* out, int B,
                             int Ns, int Nd, int C, int O,
                             cudaStream_t st) {
  const int ld = 2 * nb * O, V = nb * O;  // row length, V's first column
  const int rows_src = 3 * B * Ns, rows_dst = 3 * B * Nd;
  const int rows_all = rows_src + rows_dst;
  const int S = reduction_splits(rows_all);
  const size_t len = 2 * (size_t)nb * C * O + (size_t)nb * O * O;
  float* pw = part;                          // d_W_l partials
  float* pd = pw + (size_t)nb * C * O;       // d_D_b partials
  float* pwd = pd + (size_t)nb * O * O;      // d_W_delta partials
  float* Gd = grows + (size_t)rows_src * ld;  // the destination rows
  // Z = U + V D per branch (D^T V as a row times D), in place of U
  GemmGroup first{};
  for (int b = 0; b < nb; ++b) {
    first.g[b] = row_major(grows + V + b * O, ld, rows_all, D[b], O,
                           grows + b * O, ld, O, O);
    first.g[b].add = grows + b * O;
    first.g[nb + b] = rows_at_b(grows + V + b * O, ld, O, prows + b * O, ld, O,
                                rows_all, pd + (size_t)b * O * O, S, len);
  }
  first.count = 2 * nb;
  int err = run_group(first, st);
  if (err) return err;
  GemmGroup second{};
  second.g[0] = row_major(grows, ld, rows_src, W_l, C, dsrc3, C, C, V);
  second.g[1] = rows_at_b(grows, ld, V, src3, C, C, rows_src, pw, S, len);
  second.g[2] = row_major(Gd, ld, rows_dst, W_delta, C, ddst3, C, C, V);
  second.g[3] = rows_at_b(Gd, ld, V, dst3, C, C, rows_dst, pwd, S, len);
  second.count = 4;
  err = run_group(second, st);
  if (err) return err;
  return fold_splits(part, out, (int)len, S, st);
}

}  // namespace lstpu_points
