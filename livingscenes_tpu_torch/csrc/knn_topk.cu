// Self-kNN graph of a 3-D cloud (k <= 16, ascending, ties to the lower
// index) and, from the same distances, each row tile's largest entries of
// the N x N distance matrix, for the SIM(3) scale statistic (the mean of the
// five largest pairwise distances). Any N.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_knn.py::_knn_topk_kernel.
// Distance form: the squared difference (the TPU kernel expands |q|^2 -
// 2 q.p + |p|^2 and clamps at 0; with three coordinates the difference form
// costs the same, cannot go negative, is exactly symmetric and gives a point
// distance 0 to itself, so it is neighbour 0). The kernel writes squared
// distances; the caller takes the square root of the few it keeps. The
// matrix is symmetric and d[i][j], d[j][i] are separate entries: both are
// counted, as the flattened top-k of the reference does.
//
// What bounds it on the H100, and the design: pair_scan.cuh (shared with
// scale.cu). The cloud's columns stream through shared memory in chunks;
// four lanes a query row filter their columns against a bound on the
// query's present 16th and the block's present kTop-th largest, and only
// the survivors go through the insertion chains (knn_select.cuh,
// top_multiset.cuh).
#include "pair_scan.cuh"

// pts (B, n, 3) f32; out_i (B, n, k) int32; tops (B, ceil(n / 64), k_top)
// f32: per row tile the k_top largest squared distances, descending.
// 1 <= k <= min(16, n), 1 <= k_top <= min(8, n).
extern "C" int lstpu_knn_topk(const void* pts, void* out_i, void* tops, int B,
                              int n, int k, int k_top, void* stream) {
  using namespace lstpu_scan;
  if (B <= 0 || n <= 0 || k < 1 || k > kK || k > n || k_top < 1 ||
      k_top > kTop || k_top > n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, B);
  pair_scan_kernel<true><<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<int32_t*>(out_i),
      static_cast<float*>(tops), n, k, k_top);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_knn_topk_tile() { return lstpu_scan::kRows; }
extern "C" int lstpu_knn_topk_max_top() { return lstpu_top::kTop; }
