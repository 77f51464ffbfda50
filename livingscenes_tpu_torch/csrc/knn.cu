// Exact k-nearest neighbours (k <= 16), sorted ascending.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_knn.py::_knn_kernel.
// Semantics (shared with livingscenes_tpu_torch/ops/knn.py): the distance
// is max(|q|^2 - 2 q.p + |p|^2, 0) in f32; the k smallest come out
// ascending, and among equal distances the lower source index comes first.
//
// What bounds it on the H100: operations. The q.p products are 2 Nq Np D
// flops per instance (D = 3 * channels, up to 768) against (Nq + Np) D * 4
// bytes of input. They run in plain f32 on the CUDA cores: TF32 keeps about
// three decimal digits, and the graph must stay f32-faithful.
// Design: one block per (instance, QT-query tile).
// - Source tiles of PT points stream through shared memory in kDC = 16-wide
//   chunks of D, k-major, by 4-byte cp.async (zero fill past the ragged
//   edges), double-buffered: the next chunks, of this tile or the next, are
//   in flight while the present ones are multiplied.
// - Each thread accumulates an 8 x 8 block of products from four 16-byte
//   shared-memory loads per step of D: 64 FMAs for 4 loads. SPLIT groups of
//   threads take every SPLIT-th chunk of D, their sums added in group
//   order, so a small tile still has 128 threads on its products.
// - The form by shape, from measurement (PERF.md, kernel table row 2):
//   128 x 128 tiles on 256 threads, two blocks an SM; 64 x 128 with D
//   split in two where fewer than 256 such blocks would fill the card
//   twice (layers 4-5); 32 x 32 split in eight for at most 32 queries
//   among at most 32 sources (layer 6).
// - Norms from the staged chunks: |q|^2 in the first source tile only,
//   |p|^2 once per (query tile, source tile), about 2 % of the products; a
//   pass of its own would read the sources once more.
// - Selection after each tile's products: the QT x PT distances go to
//   shared memory, and two lanes a query each scan every other column in
//   ascending order, keeping a sorted top-16 of (distance, index) in
//   registers, filtered as knn_select.cuh sets out (shared with
//   knn_topk.cu): a lane's first 16 columns become its list by a sorting
//   network; a later column passes only if it comes before the query's
//   present 16th, the earlier of the two lanes' 16ths; the survivors are
//   compacted into a bit mask and inserted. The (distance, index) order
//   makes the two lists merge exactly.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"

namespace {

using namespace lstpu_select;

constexpr int kDC = 16;   // feature chunk
constexpr int kPad = 4;   // rows stay 16-byte aligned; spreads the cp.async stores
// Below this many 128-query blocks the card (132 SMs) is filled less than
// twice over, and 64-query tiles with D split in two do better.
constexpr int kMinWideBlocks = 256;

template <int QT, int PT, int SPLIT>
struct Tiles {
  float q[2][SPLIT][kDC][QT + kPad];
  float p[2][SPLIT][kDC][PT + kPad];
  // the sums of split groups 1.. for group 0 to add
  float partial[SPLIT > 1 ? SPLIT - 1 : 1][SPLIT > 1 ? QT : 1][SPLIT > 1 ? PT : 1];
  // Two lanes of adjacent rows read columns 2j and 2j + 1: a row stride of
  // 2 mod 32 puts a warp's 32 reads on 32 banks.
  float dist[QT][PT + 2];
  float q2[QT];
  float p2[PT];
};

// Stage the SPLIT chunks from c0 on of the query tile and source tile p0
// into buffer `buf`, transposed to k-major, one 4-byte cp.async an element.
template <int QT, int PT, int SPLIT>
__device__ __forceinline__ void stage(Tiles<QT, PT, SPLIT>& s, int buf,
                                      const float* __restrict__ qb,
                                      const float* __restrict__ pb, int q0,
                                      int p0, int c0, int nq, int np, int D,
                                      int tid, int threads) {
#pragma unroll 1
  for (int g = 0; g < SPLIT; ++g) {
    const int d0 = (c0 + g) * kDC;
    for (int e = tid; e < QT * kDC; e += threads) {
      const int r = e / kDC, c = e % kDC;
      const bool ok = q0 + r < nq && d0 + c < D;
      const float* src = ok ? qb + (size_t)(q0 + r) * D + d0 + c : qb;
      __pipeline_memcpy_async(&s.q[buf][g][c][r], src, 4, ok ? 0 : 4);
    }
    for (int e = tid; e < PT * kDC; e += threads) {
      const int r = e / kDC, c = e % kDC;
      const bool ok = p0 + r < np && d0 + c < D;
      const float* src = ok ? pb + (size_t)(p0 + r) * D + d0 + c : pb;
      __pipeline_memcpy_async(&s.p[buf][g][c][r], src, 4, ok ? 0 : 4);
    }
  }
}

// One lane's share of a tile's selection: columns half, half + 2, ... of
// its query's row (ascending source index), filtered against the query's
// present 16th, the survivors inserted in ascending order (knn_select.cuh).
// In the first tile the lane's first 16 columns are its list at once,
// sorted, so the filter has a threshold from the start.
template <int PT>
__device__ __forceinline__ void select_tile(const float* drow, int p0,
                                            int n_valid, int half,
                                            float (&td)[kK], int (&ti)[kK]) {
  auto col = [&](int j) { return p0 + 2 * j + half; };
  auto dist = [&](int j) { return drow[2 * j + half]; };
  int j0 = 0;
  if (p0 == 0 && n_valid >= 2 * kK) {
    seed_list(td, ti, col, dist);
    j0 = kK;
  }
  float cd;
  int ci;
  query_threshold<2>(td, ti, cd, ci);
  unsigned long long pass = 0;
#pragma unroll
  for (int j = 0; j < PT / 2; ++j) {
    const int c = 2 * j + half;
    if (j >= j0 && c < n_valid && before(drow[c], p0 + c, cd, ci))
      pass |= 1ull << j;
  }
  insert_survivors(td, ti, pass, col, dist);
}

template <int QT, int PT, int SPLIT, int MIN_BLOCKS>
__global__ void __launch_bounds__((QT / 8) * (PT / 8) * SPLIT, MIN_BLOCKS)
    knn_kernel(const float* __restrict__ q, const float* __restrict__ p,
               float* __restrict__ out_d, int32_t* __restrict__ out_i, int nq,
               int np, int D, int k) {
  constexpr int kGroup = (QT / 8) * (PT / 8);  // threads a split group
  constexpr int kThreads = kGroup * SPLIT;
  constexpr int kP2Rows = (PT + kThreads - 1) / kThreads;
  static_assert(kThreads >= 2 * QT && (2 * QT) % 32 == 0,
                "two selection lanes a query, whole warps");
  extern __shared__ __align__(16) float tiles_raw[];
  Tiles<QT, PT, SPLIT>& s = *reinterpret_cast<Tiles<QT, PT, SPLIT>*>(tiles_raw);
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * QT;
  const float* qb = q + (size_t)b * nq * D;
  const float* pb = p + (size_t)b * np * D;
  const int tid = threadIdx.x;
  // products: split group `grp`; rows ty*4 + {0..3} and QT/2 + ty*4 +
  // {0..3}, columns tx*4 + {0..3} and PT/2 + tx*4 + {0..3}
  const int grp = SPLIT == 1 ? 0 : tid / kGroup;
  const int gt = SPLIT == 1 ? tid : tid % kGroup;
  const int tx = gt % (PT / 8), ty = gt / (PT / 8);
  // selection: two lanes a query, in the first 2 QT threads
  const bool selects = kThreads == 2 * QT || tid < 2 * QT;
  const int row = tid >> 1, half = tid & 1;

  float td[kK];
  int ti[kK];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    td[m] = INFINITY;
    ti[m] = 0x7fffffff;
  }
  float acc[8][8];
  float q2_acc = 0.0f;
  float p2_acc[kP2Rows];

  const int n_chunks = (D + kDC - 1) / kDC;
  const int steps = (n_chunks + SPLIT - 1) / SPLIT;  // a source tile's
  const int total = steps * ((np + PT - 1) / PT);
  stage(s, 0, qb, pb, q0, 0, 0, nq, np, D, tid, kThreads);
  __pipeline_commit();
  for (int g = 0; g < total; ++g) {
    const int tile = g / steps, step = g % steps;
    if (g + 1 < total)
      stage(s, (g + 1) & 1, qb, pb, q0, ((g + 1) / steps) * PT,
            ((g + 1) % steps) * SPLIT, nq, np, D, tid, kThreads);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const int buf = g & 1;
    if (step == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
#pragma unroll
      for (int rr = 0; rr < kP2Rows; ++rr) p2_acc[rr] = 0.0f;
    }
    if (tile == 0 && tid < QT) {
#pragma unroll
      for (int sg = 0; sg < SPLIT; ++sg)
#pragma unroll
        for (int c = 0; c < kDC; ++c) {
          const float v = s.q[buf][sg][c][tid];
          q2_acc += v * v;
        }
    }
#pragma unroll
    for (int rr = 0; rr < kP2Rows; ++rr) {
      const int r = tid + rr * kThreads;
      if (r < PT) {
#pragma unroll
        for (int sg = 0; sg < SPLIT; ++sg)
#pragma unroll
          for (int c = 0; c < kDC; ++c) {
            const float v = s.p[buf][sg][c][r];
            p2_acc[rr] += v * v;
          }
      }
    }
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(&s.q[buf][grp][c][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&s.q[buf][grp][c][QT / 2 + ty * 4]);
      const float4 b0 =
          *reinterpret_cast<const float4*>(&s.p[buf][grp][c][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&s.p[buf][grp][c][PT / 2 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
    if (step != steps - 1) continue;

    // The tile's distances, then its selection. The next chunks' copies
    // are in flight meanwhile; the dist tile is next written after the
    // next tile's barriers, which every lane passes after selecting.
    if (SPLIT > 1 && grp > 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s.partial[grp - 1][(i < 4 ? 0 : QT / 2 - 4) + ty * 4 + i]
                   [(j < 4 ? 0 : PT / 2 - 4) + tx * 4 + j] = acc[i][j];
    }
    if (tile == 0 && tid < QT) s.q2[tid] = q2_acc;
#pragma unroll
    for (int rr = 0; rr < kP2Rows; ++rr)
      if (tid + rr * kThreads < PT) s.p2[tid + rr * kThreads] = p2_acc[rr];
    __syncthreads();
    if (grp == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qr = (i < 4 ? 0 : QT / 2 - 4) + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int pc = (j < 4 ? 0 : PT / 2 - 4) + tx * 4 + j;
          float dot = acc[i][j];
#pragma unroll
          for (int sg = 0; sg < SPLIT - 1; ++sg) dot += s.partial[sg][qr][pc];
          const float d = s.q2[qr] - 2.0f * dot + s.p2[pc];
          s.dist[qr][pc] = fmaxf(d, 0.0f);
        }
      }
    }
    __syncthreads();
    const int p0 = tile * PT;
    if (selects) select_tile<PT>(s.dist[row], p0, min(PT, np - p0), half, td, ti);
  }

  if (!selects) return;
  merge_partner(td, ti, 1);
  const int qi = q0 + row;
  if (half == 0 && qi < nq) {
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

template <int QT, int PT, int SPLIT, int MIN_BLOCKS = 1>
int launch(const float* q, const float* p, float* out_d, int32_t* out_i,
           int B, int nq, int np, int D, int k, cudaStream_t stream) {
  const int bytes = (int)sizeof(Tiles<QT, PT, SPLIT>);
  cudaError_t err = cudaFuncSetAttribute(
      knn_kernel<QT, PT, SPLIT, MIN_BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nq + QT - 1) / QT, B);
  knn_kernel<QT, PT, SPLIT, MIN_BLOCKS><<<grid, (QT / 8) * (PT / 8) * SPLIT,
                                          bytes, stream>>>(
      q, p, out_d, out_i, nq, np, D, k);
  return (int)cudaGetLastError();
}

}  // namespace

// q (B, nq, D), p (B, np, D) f32; out_d (B, nq, k) f32, out_i (B, nq, k)
// int32; 1 <= k <= min(16, np). form: 1 for 128 x 128 tiles, 2 for 64 x 128
// with D split in two, 3 for 32 x 32 split in eight, 0 for the choice by
// shape.
extern "C" int lstpu_knn(const void* q, const void* p, void* out_d,
                         void* out_i, int B, int nq, int np, int D, int k,
                         int form, void* stream) {
  if (B <= 0 || nq <= 0 || np <= 0 || D <= 0 || k <= 0 || k > kK || k > np ||
      form < 0 || form > 3)
    return (int)cudaErrorInvalidValue;
  if (form == 0) {
    if (nq <= 32 && np <= 32)
      form = 3;
    else
      form = B * ((nq + 127) / 128) >= kMinWideBlocks ? 1 : 2;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* pf = static_cast<const float*>(p);
  float* od = static_cast<float*>(out_d);
  int32_t* oi = static_cast<int32_t*>(out_i);
  switch (form) {
    // two blocks an SM: at most 128 registers, a few spilled
    case 1: return launch<128, 128, 1, 2>(qf, pf, od, oi, B, nq, np, D, k, s);
    case 2: return launch<64, 128, 2>(qf, pf, od, oi, B, nq, np, D, k, s);
    default: return launch<32, 32, 8>(qf, pf, od, oi, B, nq, np, D, k, s);
  }
}

extern "C" int lstpu_knn_max_k() { return kK; }
