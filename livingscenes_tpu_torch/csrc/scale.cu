// The SIM(3) scale statistic of a 3-D cloud: the largest entries of its
// N x N distance matrix (the caller takes the mean of the five largest).
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_scale.py::_scale_kernel.
// Distance form: the squared difference dx^2 + dy^2 + dz^2, as in
// knn_topk.cu (the TPU kernel expands |p|^2 - 2 p.q + |q|^2 and clamps at 0;
// the difference form cannot go negative and is exactly symmetric). The
// kernel writes squared distances; the caller takes the root of the few it
// keeps. d[i][j] and d[j][i] are separate entries and both count, as in the
// flattened top-k of the reference.
//
// What bounds it on the H100: operations, about 8 flops and one compare per
// pair against 12 N bytes read per cloud. Design: knn_topk.cu without its
// kNN half. The cloud sits in shared memory (coordinate planes), a block of
// 256 threads owns 64 rows, four lanes scan a row's columns, each keeping
// its kTop largest distances in registers; the lists merge over the block
// (top_multiset.cuh) and the caller selects over the row tiles.
#include <cuda_runtime.h>
#include <stdint.h>

#include "top_multiset.cuh"

namespace {

using namespace lstpu_top;

constexpr int kRows = 64;  // rows per block
constexpr int kThreads = 256;
constexpr int kMaxPoints = 4096;  // 3 planes of floats: 48 KB, opted into below

__global__ void __launch_bounds__(kThreads)
    scale_kernel(const float* __restrict__ pts, float* __restrict__ tops, int n,
                 int k_top) {
  extern __shared__ __align__(16) float planes[];
  __shared__ float warp_top[kThreads / 32][kTop];
  float* xs = planes;
  float* ys = planes + n;
  float* zs = planes + 2 * n;
  const int b = blockIdx.y;
  const float* pb = pts + (size_t)b * n * 3;
  const int tid = threadIdx.x;
  for (int t = tid; t < n; t += kThreads) {
    xs[t] = pb[3 * t];
    ys[t] = pb[3 * t + 1];
    zs[t] = pb[3 * t + 2];
  }
  __syncthreads();

  const int row = tid >> 2, sub = tid & 3;
  const int qi = blockIdx.x * kRows + row;
  float top[kTop];
#pragma unroll
  for (int m = 0; m < kTop; ++m) top[m] = -INFINITY;
  if (qi < n) {
    const float qx = xs[qi], qy = ys[qi], qz = zs[qi];
    for (int c = sub; c < n; c += 4) {
      const float dx = qx - xs[c], dy = qy - ys[c], dz = qz - zs[c];
      insert_top(top, dx * dx + dy * dy + dz * dz);
    }
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

// pts (B, n, 3) f32; tops (B, ceil(n / 64), k_top) f32: per row tile the
// k_top largest squared distances, descending. 1 <= k_top <= min(8, n),
// n <= 4096.
extern "C" int lstpu_scale(const void* pts, void* tops, int B, int n,
                           int k_top, void* stream) {
  if (B <= 0 || n <= 0 || n > kMaxPoints || k_top < 1 || k_top > kTop ||
      k_top > n)
    return (int)cudaErrorInvalidValue;
  const int bytes = 3 * n * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      scale_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kRows - 1) / kRows, B);
  scale_kernel<<<grid, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pts), static_cast<float*>(tops), n, k_top);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_scale_tile() { return kRows; }
extern "C" int lstpu_scale_max_points() { return kMaxPoints; }
extern "C" int lstpu_scale_max_top() { return kTop; }
