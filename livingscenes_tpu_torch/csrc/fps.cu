// Masked farthest-point sampling, one thread block per instance.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_fps.py::_fps_kernel.
// Semantics (shared with livingscenes_tpu_torch/ops/fps.py): the first pick
// is index 0; every round updates the running minimum of (p - last)^2 and
// picks the first index of its maximum; invalid points start at -2e30 and
// are never picked while a valid one is left, so once every valid point is
// taken the tail repeats the lowest-index valid point.
//
// What bounds it on the H100: latency. The k - 1 rounds depend on each
// other, and each one ends in a block-wide argmax; the arithmetic per round
// (about 8 flops a point) and the bytes (the cloud, read once) are small.
// Design: each thread keeps its own points and their running minimum in
// registers (PPT points a thread, strided by the block so loads coalesce),
// so a round touches shared memory only for the argmax: a butterfly shuffle
// inside each warp, one __syncthreads, and every warp reducing the per-warp
// winners itself (double-buffered by round parity, so no second barrier).
// The argmax reduces (value, index) pairs with the index as tie-break, which
// gives the first index among equal maxima. The distance is formed with
// explicit round-to-nearest intrinsics as ((dx*dx + dy*dy) + dz*dz): a fused
// multiply-add would round differently from the CPU and change indices at
// near-ties.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float lx, float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// Keep the larger value; on equal values keep the lower index.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    argmax_merge(v, i, ov, oi);
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
    fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
               int32_t* __restrict__ out, int n, int k) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* p = pts + (size_t)b * n * 3;
  int32_t* o = out + (size_t)b * k;

  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = j * kThreads + tid;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      const bool valid = mask == nullptr || mask[(size_t)b * n + i] != 0;
      mind[j] = valid ? kBig : -2.0f * kBig;
    } else {
      px[j] = py[j] = pz[j] = 0.0f;
      mind[j] = -INFINITY;
    }
  }

  __shared__ float s_v[2][kWarps];
  __shared__ int s_i[2][kWarps];
  int cur = 0;
  if (tid == 0) o[0] = 0;
  for (int r = 1; r < k; ++r) {
    const float lx = p[3 * cur], ly = p[3 * cur + 1], lz = p[3 * cur + 2];
    float bv = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int i = j * kThreads + tid;
      if (i < n) {
        mind[j] = fminf(mind[j], sqdist(px[j], py[j], pz[j], lx, ly, lz));
        // j ascending means i ascending: strict > keeps the first index.
        if (mind[j] > bv) {
          bv = mind[j];
          bi = i;
        }
      }
    }
    warp_argmax(bv, bi);
    const int buf = r & 1;
    if (lane == 0) {
      s_v[buf][warp] = bv;
      s_i[buf][warp] = bi;
    }
    __syncthreads();
    float v = lane < kWarps ? s_v[buf][lane] : -INFINITY;
    int i = lane < kWarps ? s_i[buf][lane] : 0x7fffffff;
    warp_argmax(v, i);
    cur = i;
    if (tid == 0) o[r] = cur;
  }
}

}  // namespace

// pts (B, n, 3) f32, mask (B, n) bool or null, out (B, k) int32; k >= 1.
extern "C" int lstpu_fps(const void* pts, const void* mask, void* out, int B,
                         int n, int k, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  int32_t* o = static_cast<int32_t*>(out);
  const int ppt = (n + kThreads - 1) / kThreads;
  if (B <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (ppt <= 1) {
    fps_kernel<1><<<B, kThreads, 0, s>>>(p, m, o, n, k);
  } else if (ppt <= 2) {
    fps_kernel<2><<<B, kThreads, 0, s>>>(p, m, o, n, k);
  } else if (ppt <= 4) {
    fps_kernel<4><<<B, kThreads, 0, s>>>(p, m, o, n, k);
  } else if (ppt <= 8) {
    fps_kernel<8><<<B, kThreads, 0, s>>>(p, m, o, n, k);
  } else if (ppt <= 16) {
    fps_kernel<16><<<B, kThreads, 0, s>>>(p, m, o, n, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int lstpu_fps_max_points() { return 16 * kThreads; }
