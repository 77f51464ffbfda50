// The scan of a 3-D cloud's N x N squared-distance matrix shared by
// knn_topk.cu (the self-kNN graph and the scale statistic's largest
// entries) and scale.cu (the largest entries alone).
//
// Distance form: the squared difference ((dx dx + dy dy) + dz dz), each
// operation rounded on its own (no fused multiply-add), which is the plain
// versions' expression (ops/cuda_knn.py, ops/cuda_scale.py): the kernel and
// the plain version compute the same bits, so their graphs are equal. It
// cannot go negative, is exactly symmetric and gives a point distance 0 to
// itself. d[i][j] and d[j][i] are separate entries of the largest ones, as
// in the flattened top-k of the reference.
//
// What bounds it on the H100: operations, about 8 flops and two compares
// per pair against 12 N bytes read and 4 k N written per cloud. The
// selection's insertion chains (16 deep for the graph, 8 for the largest
// entries) would cost more than the distances if every column went through
// them, so only the survivors of the filters below do.
//
// Design: a block of 256 threads owns 64 query rows, four adjacent lanes a
// row. The cloud's columns stream through shared memory in chunks of 512
// points (three coordinate planes), staged by 4-byte cp.async one chunk
// ahead (double-buffered, zero fill past N), so any N is taken. A lane
// reads its columns four at a time (16-byte loads of each plane): in each
// segment of 128 columns, lane l takes columns 16 j + 4 l + q (j < 8,
// q < 4), ascending. Per segment:
// - the thresholds are refreshed: a bound on the query's present 16th
//   (knn_select.cuh query_bound: the smaller of the earliest of its four
//   lanes' 16ths and the latest of their 4ths) and, for the largest
//   entries, the larger of the warp's and the block's: the largest kTop-th
//   largest that a lane holds (exact for the values: that lane already
//   holds kTop entries at least as large), the block's kept in shared
//   memory by an atomic maximum, one a warp and segment, and read without
//   a barrier (every value it ever holds is such a threshold);
// - the lane's 32 distances are compared with both and the survivors
//   marked in two bit masks (constant bits: the loop is unrolled); only
//   the survivors go through the insertion chains, recomputed from shared
//   memory (the same bits).
// The first segment seeds each lane's kNN list with its first 16 columns by
// a sorting network and its largest-entry list with the 8 largest of them,
// so the filters have thresholds from the start. At the end the four lists
// of a row merge exactly by two bitonic merges over shuffles and the
// block's largest-entry lists by top_multiset.cuh; the caller selects over
// the row tiles.
#pragma once
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"
#include "top_multiset.cuh"

namespace lstpu_scan {

using namespace lstpu_select;
using namespace lstpu_top;

constexpr int kRows = 64;                 // query rows a block
constexpr int kLanes = 4;                 // lanes a row
constexpr int kThreads = kRows * kLanes;  // 256
constexpr int kSeg = 32;                  // a lane's columns a segment
constexpr int kSegCols = kLanes * kSeg;   // 128
constexpr int kChunk = 4 * kSegCols;      // columns staged at once: 512
constexpr int kPlane = kChunk + 4;        // plane stride (16-byte rows)

// The plain versions' squared difference, each operation rounded alone.
__device__ __forceinline__ float sqdist(float qx, float qy, float qz, float x,
                                        float y, float z) {
  const float dx = qx - x, dy = qy - y, dz = qz - z;
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Stage the chunk of columns from c0 into planes buf[0..2] (x, y, z), one
// 4-byte cp.async an element; past n, zeros.
__device__ __forceinline__ void stage(float (*buf)[kPlane],
                                      const float* __restrict__ pb, int c0,
                                      int n) {
  for (int e = threadIdx.x; e < 3 * kChunk; e += kThreads) {
    const int p = e / 3, comp = e % 3;
    const bool ok = c0 + p < n;
    const float* src = ok ? pb + (size_t)(c0 + p) * 3 + comp : pb;
    __pipeline_memcpy_async(&buf[comp][p], src, 4, ok ? 0 : 4);
  }
}

// KNN: out_i (B, n, k) the self-kNN graph, ascending (distance, index).
// Always: tops (B, ceil(n / kRows), k_top), each row tile's k_top largest
// squared distances, descending.
template <bool KNN>
__global__ void __launch_bounds__(kThreads)
    pair_scan_kernel(const float* __restrict__ pts,
                     int32_t* __restrict__ out_i, float* __restrict__ tops,
                     int n, int k, int k_top) {
  __align__(16) __shared__ float planes[2][3][kPlane];
  __shared__ float warp_top[kThreads / 32][kTop];
  // the block's present threshold for the largest entries, as float bits
  // (distances are >= 0, so the bits order as the values): the largest
  // kTop-th largest that a lane holds; 0 for none yet
  __shared__ unsigned block_tt;
  if (threadIdx.x == 0) block_tt = 0u;  // read after the first barrier
  const int b = blockIdx.y;
  const float* pb = pts + (size_t)b * n * 3;
  const int row = threadIdx.x / kLanes, sub = threadIdx.x % kLanes;
  const int qi = blockIdx.x * kRows + row;
  const bool valid = qi < n;
  float qx = 0.0f, qy = 0.0f, qz = 0.0f;
  if (valid) {
    qx = pb[3 * qi];
    qy = pb[3 * qi + 1];
    qz = pb[3 * qi + 2];
  }

  float td[kK];
  int ti[kK];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    td[m] = INFINITY;
    ti[m] = 0x7fffffff;
  }
  float top[kTop];
#pragma unroll
  for (int m = 0; m < kTop; ++m) top[m] = -INFINITY;

  const int n_chunks = (n + kChunk - 1) / kChunk;
  stage(planes[0], pb, 0, n);
  __pipeline_commit();
  for (int g = 0; g < n_chunks; ++g) {
    if (g + 1 < n_chunks) stage(planes[(g + 1) & 1], pb, (g + 1) * kChunk, n);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float* xs = planes[g & 1][0];
    const float* ys = planes[g & 1][1];
    const float* zs = planes[g & 1][2];
    const int c0 = g * kChunk;
    for (int s = 0; s < kChunk / kSegCols && c0 + s * kSegCols < n; ++s) {
      // bit j: the lane's column base + 16 (j / 4) + j % 4 of the chunk
      const int base = s * kSegCols + 4 * sub;
      auto col = [&](int j) { return c0 + base + 16 * (j >> 2) + (j & 3); };
      auto dist = [&](int j) {
        const int c = base + 16 * (j >> 2) + (j & 3);
        return sqdist(qx, qy, qz, xs[c], ys[c], zs[c]);
      };
      int j0 = 0;
      if (g == 0 && s == 0 && n >= kLanes * kK) {
        // columns 0 .. 63: each lane's first 16, all in the cloud
        if (valid) {
          seed_list(td, ti, col, dist);
#pragma unroll
          for (int m = 0; m < kTop; ++m) top[m] = td[kK - 1 - m];
        }
        j0 = kK / 4;
      }
      const float cd = KNN ? query_bound<kLanes>(td) : INFINITY;
      // the block's threshold and this warp's: any value the block's ever
      // holds is backed by a lane's kTop entries, so it is read without a
      // barrier
      const float mine = top[kTop - 1];  // -INFINITY while not full
      const unsigned wm = __reduce_max_sync(
          0xffffffffu, mine > 0.0f ? __float_as_uint(mine) : 0u);
      const unsigned tb = *reinterpret_cast<volatile unsigned*>(&block_tt);
      if (threadIdx.x % 32 == 0 && wm > tb) atomicMax(&block_tt, wm);
      const unsigned tu = wm > tb ? wm : tb;
      const float tt = tu ? __uint_as_float(tu) : -INFINITY;
      unsigned long long pk = 0, pt = 0;
#pragma unroll
      for (int j = 0; j < kSeg / 4; ++j) {
        if (j < j0) continue;
        const int c = base + 16 * j;
        const float4 x4 = *reinterpret_cast<const float4*>(xs + c);
        const float4 y4 = *reinterpret_cast<const float4*>(ys + c);
        const float4 z4 = *reinterpret_cast<const float4*>(zs + c);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
        const float zv[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float d = sqdist(qx, qy, qz, xv[q], yv[q], zv[q]);
          const unsigned long long bit = 1ull << (4 * j + q);
          if (KNN && d <= cd) pk |= bit;
          if (d > tt) pt |= bit;
        }
      }
      // rows past n take nothing; in the last segment, columns past n
      unsigned long long keep = valid ? ~0ull : 0ull;
      if (c0 + (s + 1) * kSegCols > n) {
#pragma unroll
        for (int j = 0; j < kSeg; ++j)
          if (col(j) >= n) keep &= ~(1ull << j);
      }
      if (KNN) insert_survivors(td, ti, pk & keep, col, dist);
      pt &= keep;
      while (pt != 0) {
        const int j = __ffsll((long long)pt) - 1;
        pt &= pt - 1;
        insert_top(top, dist(j));
      }
    }
    __syncthreads();  // the buffer is staged again at chunk g + 2
  }

  if (KNN) {
    merge_partner(td, ti, 1);
    merge_partner(td, ti, 2);
    if (sub == 0 && valid) {
      int32_t* oi = out_i + ((size_t)b * n + qi) * k;
#pragma unroll
      for (int m = 0; m < kK; ++m)
        if (m < k) oi[m] = ti[m];
    }
  }
  block_merge_top<kThreads>(top, warp_top);
  if (threadIdx.x == 0) {
    float* o = tops + ((size_t)b * gridDim.x + blockIdx.x) * k_top;
#pragma unroll
    for (int m = 0; m < kTop; ++m)
      if (m < k_top) o[m] = top[m];
  }
}

}  // namespace lstpu_scan
