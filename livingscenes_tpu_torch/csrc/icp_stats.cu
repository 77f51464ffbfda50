// One ICP correspondence step per active pair, reduced to the sufficient
// statistics of the rigid refit.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_icp.py::_icp_stats_kernel.
// For the moved source x (N, 3), the original source src (N, 3) and the
// target tgt (M, 3) of each pair it returns
//     S        (3, 3)  sum_i src_i nn_i^T
//     nn_sum   (3,)    sum_i nn_i
//     dmin_sum ()      sum_i max(min_j d_ij, 0)
// with d_ij = |x_i|^2 - 2 x_i.t_j + |t_j|^2 left unclamped for the minimum
// and the tie test, and nn_i the mean of every target at that minimum. Pairs
// whose `active` flag is 0 skip the work and get zeros.
// Precision: the TPU kernel ran the cross term at the matrix unit's default
// (bf16-input) precision; this kernel computes it in f32, as the JAX CPU
// path does (livingscenes_tpu/ops/icp.py, interpret mode).
//
// What bounds it on the H100: operations, about 8 flops for every (i, j)
// (N * M per pair), against 36 bytes a point of input. Design: the targets of
// a pair are staged in shared memory as float4 (x, y, z, |t|^2); each thread
// owns one source point and walks every target, keeping (dmin, sum of tied
// targets, tie count) in registers, resetting them when a strictly smaller d
// arrives. Each block then reduces its 13 statistics with warp shuffles into
// one partial row; a second small kernel sums the partial rows of a pair in
// a fixed order (blocks cannot carry sums, and a fixed order keeps the
// result deterministic, unlike atomics).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kStats = 13;  // S (9), nn_sum (3), dmin_sum (1)
constexpr int kTile = 1024;  // targets staged in shared memory at a time

__global__ void __launch_bounds__(kThreads)
    icp_partial_kernel(const float* __restrict__ x,
                       const float* __restrict__ src,
                       const float* __restrict__ tgt,
                       const uint8_t* __restrict__ active,
                       float* __restrict__ partial, int n, int m) {
  const int b = blockIdx.y;
  if (active[b] == 0) return;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool valid = i < n;
  const float* xb = x + (size_t)b * n * 3;
  const float* tb = tgt + (size_t)b * m * 3;

  __shared__ float4 ts[kTile];
  __shared__ float red[kThreads / 32][kStats];

  float x0 = 0.0f, x1 = 0.0f, x2 = 0.0f;
  if (valid) {
    x0 = xb[3 * i];
    x1 = xb[3 * i + 1];
    x2 = xb[3 * i + 2];
  }
  const float xx = x0 * x0 + x1 * x1 + x2 * x2;
  float dmin = INFINITY, a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, cnt = 0.0f;

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int jn = min(kTile, m - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < jn; j += kThreads) {
      const float t0 = tb[3 * (j0 + j)];
      const float t1 = tb[3 * (j0 + j) + 1];
      const float t2 = tb[3 * (j0 + j) + 2];
      ts[j] = make_float4(t0, t1, t2, t0 * t0 + t1 * t1 + t2 * t2);
    }
    __syncthreads();
    if (valid) {
      for (int j = 0; j < jn; ++j) {
        const float4 t = ts[j];
        const float d = xx - 2.0f * (x0 * t.x + x1 * t.y + x2 * t.z) + t.w;
        if (d < dmin) {
          dmin = d;
          a0 = t.x;
          a1 = t.y;
          a2 = t.z;
          cnt = 1.0f;
        } else if (d == dmin) {
          a0 += t.x;
          a1 += t.y;
          a2 += t.z;
          cnt += 1.0f;
        }
      }
    }
  }

  float v[kStats];
  if (valid && cnt > 0.0f) {
    const float inv = 1.0f / cnt;
    const float n0 = a0 * inv, n1 = a1 * inv, n2 = a2 * inv;
    const float* sb = src + ((size_t)b * n + i) * 3;
    const float s0 = sb[0], s1 = sb[1], s2 = sb[2];
    v[0] = s0 * n0; v[1] = s0 * n1; v[2] = s0 * n2;
    v[3] = s1 * n0; v[4] = s1 * n1; v[5] = s1 * n2;
    v[6] = s2 * n0; v[7] = s2 * n1; v[8] = s2 * n2;
    v[9] = n0; v[10] = n1; v[11] = n2;
    v[12] = fmaxf(dmin, 0.0f);
  } else {
#pragma unroll
    for (int c = 0; c < kStats; ++c) v[c] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < kStats; ++c) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < kStats; ++c) red[warp][c] = v[c];
  }
  __syncthreads();
  if (threadIdx.x < kStats) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][threadIdx.x];
    partial[((size_t)b * gridDim.x + blockIdx.x) * kStats + threadIdx.x] = s;
  }
}

// out (B, 13): row b is the fixed-order sum of pair b's partial rows.
__global__ void icp_reduce_kernel(const float* __restrict__ partial,
                                  const uint8_t* __restrict__ active,
                                  float* __restrict__ out, int B, int nblk) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * kStats) return;
  const int b = e / kStats, c = e % kStats;
  float s = 0.0f;
  if (active[b] != 0) {
    for (int k = 0; k < nblk; ++k) s += partial[((size_t)b * nblk + k) * kStats + c];
  }
  out[e] = s;
}

}  // namespace

// x, src (B, n, 3), tgt (B, m, 3) f32; active (B,) bool; partial scratch
// (B, ceil(n / 128), 13) f32; out (B, 13) f32 = [S row-major, nn_sum, dmin_sum].
extern "C" int lstpu_icp_stats(const void* x, const void* src, const void* tgt,
                               const void* active, void* partial, void* out,
                               int B, int n, int m, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nblk = (n + kThreads - 1) / kThreads;
  const uint8_t* act = static_cast<const uint8_t*>(active);
  icp_partial_kernel<<<dim3(nblk, B), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(src),
      static_cast<const float*>(tgt), act, static_cast<float*>(partial), n, m);
  const int total = B * kStats;
  icp_reduce_kernel<<<(total + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(partial), act, static_cast<float*>(out), B,
      nblk);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_icp_stats_block() { return kThreads; }
