// The sorted top-16 selection shared by knn.cu and knn_topk.cu: a list of
// (distance, index) pairs in registers, ordered by distance and, among equal
// distances, by index, so that partial lists merge exactly.
#pragma once
#include <cuda_runtime.h>

namespace lstpu_select {

constexpr int kK = 16;

__device__ __forceinline__ bool before(float d, int i, float od, int oi) {
  return d < od || (d == od && i < oi);
}

__device__ __forceinline__ void insert(float (&td)[kK], int (&ti)[kK], float d,
                                       int i) {
  if (!before(d, i, td[kK - 1], ti[kK - 1])) return;
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    if (before(d, i, td[m], ti[m])) {
      const float t = td[m];
      td[m] = d;
      d = t;
      const int u = ti[m];
      ti[m] = i;
      i = u;
    }
  }
}

// Merge the partner lane's list (lane ^ mask) into this lane's list.
__device__ __forceinline__ void merge_partner(float (&td)[kK], int (&ti)[kK],
                                              int mask) {
  float od[kK];
  int oi[kK];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    od[m] = __shfl_xor_sync(0xffffffffu, td[m], mask);
    oi[m] = __shfl_xor_sync(0xffffffffu, ti[m], mask);
  }
#pragma unroll
  for (int m = 0; m < kK; ++m) insert(td, ti, od[m], oi[m]);
}

}  // namespace lstpu_select
