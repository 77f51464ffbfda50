// Self-kNN graph of a 3-D cloud (k <= 16, ascending, ties to the lower
// index) and, from the same distances, each row tile's largest entries of
// the N x N distance matrix, for the SIM(3) scale statistic (the mean of the
// five largest pairwise distances).
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_knn.py::_knn_topk_kernel.
// Distance form: the squared difference dx^2 + dy^2 + dz^2 (the TPU kernel
// expands |q|^2 - 2 q.p + |p|^2 and clamps at 0; with three coordinates the
// difference form costs the same, cannot go negative, is exactly symmetric
// and gives a point distance 0 to itself, so it is neighbour 0). The
// kernel writes squared distances; the caller takes the square root of the
// few it keeps. The matrix is symmetric and d[i][j], d[j][i] are separate
// entries: both are counted, as the flattened top-k of the reference does.
//
// What bounds it on the H100: operations, about 8 flops and a few compares
// per pair against 12 N bytes read and 4 k N written per cloud. Design: the
// cloud sits in shared memory (coordinate planes), one block of 256 threads
// owns 64 query rows, four lanes scan a row's columns in ascending order,
// each keeping a sorted top-16 (distance, index) and the largest kTop
// distances in registers. The four lists of a row merge exactly by two
// shuffle exchanges; the largest-distance lists merge over the block
// (top_multiset.cuh, shared with scale.cu).
#include <cuda_runtime.h>
#include <stdint.h>

#include "knn_select.cuh"
#include "top_multiset.cuh"

namespace {

using namespace lstpu_select;
using namespace lstpu_top;

constexpr int kQT = 64;     // query rows per block
constexpr int kThreads = 256;
constexpr int kMaxPoints = 4096;  // 3 planes of floats: 48 KB, opted into below

__global__ void __launch_bounds__(kThreads)
    knn_topk_kernel(const float* __restrict__ pts, int32_t* __restrict__ out_i,
                    float* __restrict__ tops, int n, int k, int k_top) {
  extern __shared__ __align__(16) float planes[];
  __shared__ float warp_top[kThreads / 32][kTop];
  float* xs = planes;
  float* ys = planes + n;
  float* zs = planes + 2 * n;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQT;
  const float* pb = pts + (size_t)b * n * 3;
  const int tid = threadIdx.x;
  for (int t = tid; t < n; t += kThreads) {
    xs[t] = pb[3 * t];
    ys[t] = pb[3 * t + 1];
    zs[t] = pb[3 * t + 2];
  }
  __syncthreads();

  const int row = tid >> 2, sub = tid & 3;
  const int qi = q0 + row;
  const bool valid = qi < n;
  const float qx = valid ? xs[qi] : 0.0f;
  const float qy = valid ? ys[qi] : 0.0f;
  const float qz = valid ? zs[qi] : 0.0f;

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

  // Ascending column order inside each lane keeps the index tie-break.
  if (valid) {
    for (int c = sub; c < n; c += 4) {
      const float dx = qx - xs[c], dy = qy - ys[c], dz = qz - zs[c];
      const float d = dx * dx + dy * dy + dz * dz;
      insert(td, ti, d, c);
      insert_top(top, d);
    }
  }

  merge_partner(td, ti, 1);
  merge_partner(td, ti, 2);
  if (sub == 0 && valid) {
    int32_t* oi = out_i + ((size_t)b * n + qi) * k;
#pragma unroll
    for (int m = 0; m < kK; ++m)
      if (m < k) oi[m] = ti[m];
  }

  block_merge_top<kThreads>(top, warp_top);
  if (tid == 0) {
    float* o = tops + ((size_t)b * gridDim.x + blockIdx.x) * k_top;
#pragma unroll
    for (int m = 0; m < kTop; ++m)
      if (m < k_top) o[m] = top[m];
  }
}

}  // namespace

// pts (B, n, 3) f32; out_i (B, n, k) int32; tops (B, ceil(n / 64), k_top)
// f32: per row tile the k_top largest squared distances, descending.
// 1 <= k <= min(16, n), 1 <= k_top <= min(8, n), n <= 4096.
extern "C" int lstpu_knn_topk(const void* pts, void* out_i, void* tops, int B,
                              int n, int k, int k_top, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxPoints || k < 1 || k > kK || k > n ||
      k_top < 1 || k_top > kTop || k_top > n)
    return (int)cudaErrorInvalidValue;
  // With warp_top the largest clouds pass the 48 KB a launch gets unasked.
  const int bytes = 3 * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      knn_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kQT - 1) / kQT, B);
  knn_topk_kernel<<<grid, kThreads, bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<int32_t*>(out_i),
      static_cast<float*>(tops), n, k, k_top);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_knn_topk_tile() { return kQT; }
extern "C" int lstpu_knn_topk_max_points() { return kMaxPoints; }
extern "C" int lstpu_knn_topk_max_top() { return kTop; }
