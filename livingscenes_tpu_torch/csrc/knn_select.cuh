// The sorted top-16 selection shared by knn.cu and knn_topk.cu (through
// pair_scan.cuh): a list of (distance, index) pairs in registers, ordered by
// distance and, among equal distances, by index, so that partial lists
// merge exactly.
//
// A query's list may be split over a few adjacent lanes, each scanning its
// share of the columns. The shared filter: a lane's first 16 columns become
// its list at once (seed_list, a sorting network); a later column can enter
// the query's top-16 only if it comes before the query's present 16th:
// before the earliest of its lanes' 16ths (query_threshold, knn.cu; exact:
// that lane already holds 16 entries before it), or not past query_bound
// (knn_topk.cu), which also takes the latest of the lanes' (16 / lanes)-th.
// The columns that pass are marked in a bit mask and inserted afterwards
// (insert_survivors), so a warp runs the insertion chain once per survivor
// of its busiest lane, not once per column where any lane has one.
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

// Merge the partner lane's list (lane ^ mask) into this lane's by a
// bitonic merge: the earlier of each entry and the partner's entry at the
// mirrored position holds the 16 earliest of both lists as a bitonic
// sequence, which four stages of compare-exchanges sort (about a tenth of
// the work of inserting the partner's 16 entries one by one). Both lanes
// end with the same list.
__device__ __forceinline__ void merge_partner(float (&td)[kK], int (&ti)[kK],
                                              int mask) {
  float od[kK];
  int oi[kK];
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    od[m] = __shfl_xor_sync(0xffffffffu, td[kK - 1 - m], mask);
    oi[m] = __shfl_xor_sync(0xffffffffu, ti[kK - 1 - m], mask);
  }
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    if (before(od[m], oi[m], td[m], ti[m])) {
      td[m] = od[m];
      ti[m] = oi[m];
    }
  }
#pragma unroll
  for (int stride = kK / 2; stride > 0; stride /= 2) {
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      const int l = i ^ stride;
      if (l > i && before(td[l], ti[l], td[i], ti[i])) {
        const float d = td[i];
        td[i] = td[l];
        td[l] = d;
        const int x = ti[i];
        ti[i] = ti[l];
        ti[l] = x;
      }
    }
  }
}

// Sort a list of 16 (distance, index) pairs by a bitonic network: 80
// compare-exchanges, ten deep, in place of 16 insertions of 16 steps each.
__device__ __forceinline__ void sort_list(float (&td)[kK], int (&ti)[kK]) {
#pragma unroll
  for (int size = 2; size <= kK; size *= 2) {
#pragma unroll
    for (int stride = size / 2; stride > 0; stride /= 2) {
#pragma unroll
      for (int i = 0; i < kK; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          const bool up = (i & size) == 0;
          if (up ? before(td[l], ti[l], td[i], ti[i])
                 : before(td[i], ti[i], td[l], ti[l])) {
            const float d = td[i];
            td[i] = td[l];
            td[l] = d;
            const int x = ti[i];
            ti[i] = ti[l];
            ti[l] = x;
          }
        }
      }
    }
  }
}

// The lane's list from its first kK columns at once, sorted: column m
// (0 <= m < kK) is col(m) at distance dist(m).
template <class Col, class Dist>
__device__ __forceinline__ void seed_list(float (&td)[kK], int (&ti)[kK],
                                          Col col, Dist dist) {
#pragma unroll
  for (int m = 0; m < kK; ++m) {
    td[m] = dist(m);
    ti[m] = col(m);
  }
  sort_list(td, ti);
}

// The query's present 16th, (cd, ci): the earliest of the 16ths of its
// LANES adjacent lanes (a power of two; lanes lane ^ m for m < LANES).
// Every lane of the warp must call it.
template <int LANES>
__device__ __forceinline__ void query_threshold(const float (&td)[kK],
                                                const int (&ti)[kK], float& cd,
                                                int& ci) {
  cd = td[kK - 1];
  ci = ti[kK - 1];
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, cd, m);
    const int oi = __shfl_xor_sync(0xffffffffu, ci, m);
    if (before(od, oi, cd, ci)) {
      cd = od;
      ci = oi;
    }
  }
}

// A bound on the distance of the query's present 16th when its list is
// split over LANES adjacent lanes (a power of two dividing kK): the smaller
// of the smallest of their 16ths and the largest of their (kK / LANES)-th
// (together the lanes hold kK entries at most that far). A column farther
// than the bound cannot enter the query's top-16; one at it is left to
// insert, which decides a tie by index. Every lane of the warp must call it.
template <int LANES>
__device__ __forceinline__ float query_bound(const float (&td)[kK]) {
  float lo = td[kK - 1], hi = td[kK / LANES - 1];
#pragma unroll
  for (int m = 1; m < LANES; m <<= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, m));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, m));
  }
  return fminf(lo, hi);
}

// Insert the survivors, the set bits j of `pass` in ascending order:
// column col(j) at distance dist(j).
template <class Col, class Dist>
__device__ __forceinline__ void insert_survivors(float (&td)[kK],
                                                 int (&ti)[kK],
                                                 unsigned long long pass,
                                                 Col col, Dist dist) {
  while (pass != 0) {
    const int j = __ffsll((long long)pass) - 1;
    pass &= pass - 1;
    insert(td, ti, dist(j), col(j));
  }
}

}  // namespace lstpu_select
