// The multiset of the largest values of a distance matrix, shared by
// knn_topk.cu and scale.cu: each thread keeps the kTop largest values it has
// seen in registers, descending, equal values as separate entries (d[i][j]
// and d[j][i] both count), and a block merges its threads' lists exactly.
#pragma once
#include <cuda_runtime.h>

namespace lstpu_top {

constexpr int kTop = 8;  // largest values kept

// Keep the kTop largest values, descending.
__device__ __forceinline__ void insert_top(float (&top)[kTop], float d) {
  if (!(d > top[kTop - 1])) return;
#pragma unroll
  for (int m = 0; m < kTop; ++m) {
    if (d > top[m]) {
      const float t = top[m];
      top[m] = d;
      d = t;
    }
  }
}

// Merge the lists of all kThreads threads of the block; afterwards thread
// 0's `top` is the block's list. The threads' lists hold disjoint entries,
// so a butterfly over the warp counts every entry once; the warps meet in
// `warp_top`, shared memory of kThreads / 32 rows. Every thread of the
// block must call it.
template <int kThreads>
__device__ __forceinline__ void block_merge_top(float (&top)[kTop],
                                                float (*warp_top)[kTop]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int mask = 1; mask < 32; mask <<= 1) {
    float other[kTop];
#pragma unroll
    for (int m = 0; m < kTop; ++m)
      other[m] = __shfl_xor_sync(0xffffffffu, top[m], mask);
#pragma unroll
    for (int m = 0; m < kTop; ++m) insert_top(top, other[m]);
  }
  if ((tid & 31) == 0) {
#pragma unroll
    for (int m = 0; m < kTop; ++m) warp_top[tid >> 5][m] = top[m];
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kThreads / 32; ++w)
#pragma unroll
      for (int m = 0; m < kTop; ++m) insert_top(top, warp_top[w][m]);
  }
}

}  // namespace lstpu_top
