// The SIM(3) scale statistic of a 3-D cloud: the largest entries of its
// N x N distance matrix (the caller takes the mean of the five largest).
// Any N.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_scale.py::_scale_kernel.
// Distance form: the squared difference, as in knn_topk.cu (the TPU kernel
// expands |p|^2 - 2 p.q + |q|^2 and clamps at 0; the difference form cannot
// go negative and is exactly symmetric). The kernel writes squared
// distances; the caller takes the root of the few it keeps. d[i][j] and
// d[j][i] are separate entries and both count, as in the flattened top-k
// of the reference.
//
// What bounds it on the H100, and the design: pair_scan.cuh, without its
// kNN half. The columns stream through shared memory in chunks; each lane
// filters its distances against the block's present kTop-th largest and
// inserts only the survivors; the lists merge over the block
// (top_multiset.cuh) and the caller selects over the row tiles.
#include "pair_scan.cuh"

// pts (B, n, 3) f32; tops (B, ceil(n / 64), k_top) f32: per row tile the
// k_top largest squared distances, descending. 1 <= k_top <= min(8, n).
extern "C" int lstpu_scale(const void* pts, void* tops, int B, int n,
                           int k_top, void* stream) {
  using namespace lstpu_scan;
  if (B <= 0 || n <= 0 || k_top < 1 || k_top > kTop || k_top > n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kRows - 1) / kRows, B);
  pair_scan_kernel<false><<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), nullptr, static_cast<float*>(tops), n, 0,
      k_top);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_scale_tile() { return lstpu_scan::kRows; }
extern "C" int lstpu_scale_max_top() { return lstpu_top::kTop; }
