// Masked farthest-point sampling.
//
// Replaces the TPU kernel livingscenes_tpu/ops/pallas_fps.py::_fps_kernel.
// Semantics (shared with livingscenes_tpu_torch/ops/fps.py): the first pick
// is the given start index (0 by default); every round updates the running
// minimum of (p - last)^2 and picks the first index of its maximum; invalid
// points start at -2e30 and are never picked while a valid one is left, so
// once every valid point is taken the tail repeats the lowest-index valid
// point.
//
// What bounds it on the H100: latency. The k - 1 rounds depend on each
// other; a round is about 12 instructions a point and one argmax over the
// cloud, so its time is the argmax's chain of dependent steps plus the
// issue time of the points each SM sub-partition owns.
// Design:
// - A group of 32 CW threads owns a cloud, each thread PPT points (strided
//   by the group, so loads coalesce) and their running minimum in
//   registers. CW = 1 is the warp form: kCloudsPerBlock clouds a block and
//   no block barrier. CW > 1 is the block form: one cloud a block.
// - Argmax: a lane's best (strict >, ascending index) becomes an unsigned
//   key in the float's order (ordered_key); the warp takes
//   __reduce_max_sync of the keys, then __reduce_min_sync of the indices of
//   the lanes that hold the largest key: two instructions that keep "the
//   first index of the maximum". The block form posts each warp's winner
//   to shared memory (double-buffered by round parity: one barrier a
//   round) and every warp reduces the posts the same way.
// - A thread's best over its slots by a tree, not a chain of compares.
// - The form by N, from measurement (PERF.md; choose_warps).
// - No global load on the chain: the points held in registers are also
//   copied to shared memory, where each round reads the winner's
//   coordinates.
// - Any N: points past the registers (32 CW PPT, at most 8192) are re-read
//   from L2 every round, with their running minimum in a scratch array the
//   caller gives; a winner among them has its coordinates read from L2.
// - The distance is formed with explicit round-to-nearest intrinsics as
//   ((dx*dx + dy*dy) + dz*dz): a fused multiply-add would round differently
//   from the CPU and change indices at near-ties.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e30f;
constexpr int kCloudsPerBlock = 4;  // the warp form
constexpr int kMaxWarps = 16;       // the block form: up to 512 threads
constexpr int kMaxPPT = 16;         // and 16 points a thread
constexpr int kMaxWarpPPT = 32;     // the warp form holds up to 1024 points

__device__ __forceinline__ float sqdist(float px, float py, float pz,
                                        float lx, float ly, float lz) {
  const float dx = __fsub_rn(px, lx);
  const float dy = __fsub_rn(py, ly);
  const float dz = __fsub_rn(pz, lz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// An unsigned key with the float's order (no NaN arises): a negative
// float's bits are flipped, a non-negative float gets the sign bit. -inf
// (a thread's empty slots) maps lowest, then -2e30 (invalid points), then
// +0 and the distances up to 1e30 (valid points not yet reached). -0 never
// arises: a running minimum is an initial value or a sum of squares.
__device__ __forceinline__ unsigned ordered_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Over the warp: the largest key, and the lowest index among the lanes
// that hold it.
__device__ __forceinline__ void warp_first_max(unsigned& key, int& idx) {
  const unsigned top = __reduce_max_sync(0xffffffffu, key);
  idx = (int)__reduce_min_sync(0xffffffffu,
                               key == top ? (unsigned)idx : 0xffffffffu);
  key = top;
}

template <int PPT, int CW>
__global__ void __launch_bounds__(CW == 1 ? 32 * kCloudsPerBlock : 32 * CW)
    fps_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
               const int32_t* __restrict__ start, int32_t* __restrict__ out,
               float* __restrict__ tail_mind, int B, int n, int k) {
  constexpr int T = 32 * CW;      // threads a cloud
  constexpr int kHeld = T * PPT;  // points a cloud holds in registers
  extern __shared__ __align__(16) float held_xyz[];
  __shared__ unsigned s_key[2][CW];
  __shared__ int s_idx[2][CW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int slot = CW == 1 ? warp : 0;  // the cloud's place in the block
  const int t = CW == 1 ? lane : threadIdx.x;
  const int b = CW == 1 ? blockIdx.x * kCloudsPerBlock + warp : blockIdx.x;
  // Only the warp form's last block has warps without a cloud; they leave
  // whole, and that form has no block barrier.
  if (b >= B) return;
  const float* p = pts + (size_t)b * n * 3;
  const uint8_t* m = mask == nullptr ? nullptr : mask + (size_t)b * n;
  float* xs = held_xyz + (size_t)slot * 3 * kHeld;
  float* ys = xs + kHeld;
  float* zs = ys + kHeld;

  float px[PPT], py[PPT], pz[PPT], md[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int i = j * T + t;
    if (i < n) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      xs[i] = px[j];
      ys[i] = py[j];
      zs[i] = pz[j];
      md[j] = m == nullptr || m[i] != 0 ? kBig : -2.0f * kBig;
    } else {
      px[j] = py[j] = pz[j] = 0.0f;
      md[j] = -INFINITY;  // stays -inf: never a pick
    }
  }
  float* tm = tail_mind + (size_t)b * (n > kHeld ? n - kHeld : 0);
  for (int i = kHeld + t; i < n; i += T)
    tm[i - kHeld] = m == nullptr || m[i] != 0 ? kBig : -2.0f * kBig;
  if (CW == 1)
    __syncwarp();
  else
    __syncthreads();

  int cur = start == nullptr ? 0 : min(max(start[b], 0), n - 1);
  int32_t* o = out + (size_t)b * k;
  if (t == 0) o[0] = cur;
  for (int r = 1; r < k; ++r) {
    float lx, ly, lz;
    if (cur < kHeld) {
      lx = xs[cur];
      ly = ys[cur];
      lz = zs[cur];
    } else {
      lx = p[3 * cur];
      ly = p[3 * cur + 1];
      lz = p[3 * cur + 2];
    }
    // The thread's best by a tree over its slots, not a chain: slot j
    // holds index j T + t, and a right half replaces a left half only if
    // strictly larger, which keeps the first index of the maximum.
    float v[PPT];
    int vi[PPT];
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      md[j] = fminf(md[j], sqdist(px[j], py[j], pz[j], lx, ly, lz));
      v[j] = md[j];
      vi[j] = j * T + t;
    }
#pragma unroll
    for (int w = 1; w < PPT; w *= 2) {
#pragma unroll
      for (int j = 0; j + w < PPT; j += 2 * w) {
        if (v[j + w] > v[j]) {
          v[j] = v[j + w];
          vi[j] = vi[j + w];
        }
      }
    }
    float bv = v[0];
    int bi = vi[0];
    for (int i = kHeld + t; i < n; i += T) {
      const float d = fminf(
          tm[i - kHeld], sqdist(p[3 * i], p[3 * i + 1], p[3 * i + 2], lx, ly, lz));
      tm[i - kHeld] = d;
      if (d > bv) {
        bv = d;
        bi = i;
      }
    }
    unsigned key = ordered_key(bv);
    warp_first_max(key, bi);
    if (CW > 1) {
      const int buf = r & 1;
      if (lane == 0) {
        s_key[buf][warp] = key;
        s_idx[buf][warp] = bi;
      }
      __syncthreads();
      key = lane < CW ? s_key[buf][lane] : 0u;
      bi = lane < CW ? s_idx[buf][lane] : 0x7fffffff;
      warp_first_max(key, bi);
    }
    cur = bi;
    if (t == 0) o[r] = cur;
  }
}

template <int PPT, int CW>
int launch(const float* p, const uint8_t* m, const int32_t* s, int32_t* o,
           float* tail, int B, int n, int k, cudaStream_t stream) {
  const int clouds = CW == 1 ? kCloudsPerBlock : 1;
  const int bytes = clouds * 3 * 32 * CW * PPT * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<PPT, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  fps_kernel<PPT, CW><<<(B + clouds - 1) / clouds, 32 * CW * clouds, bytes,
                        stream>>>(p, m, s, o, tail, B, n, k);
  return (int)cudaGetLastError();
}

// Points a thread holds for n points and `warps` warps a cloud: a power of
// two up to the form's limit.
int points_per_thread(int n, int warps) {
  const int limit = warps == 1 ? kMaxWarpPPT : kMaxPPT;
  const int need = (n + 32 * warps - 1) / (32 * warps);
  int ppt = 1;
  while (ppt < need && ppt < limit) ppt *= 2;
  return ppt;
}

// The form by n, the fastest of the forms measured at the main path's
// shapes on the H100 (PERF.md, kernel table row 1): 128 points on four
// warps, 512 on one, 1024 on four, 4096 on eight; past that the most
// threads.
int choose_warps(int n) {
  if (n <= 128) return 4;
  if (n <= 512) return 1;
  if (n <= 1024) return 4;
  if (n <= 4096) return 8;
  return kMaxWarps;
}

template <int CW>
int dispatch(int ppt, const float* p, const uint8_t* m, const int32_t* s,
             int32_t* o, float* tail, int B, int n, int k, cudaStream_t st) {
  switch (ppt) {
    case 1: return launch<1, CW>(p, m, s, o, tail, B, n, k, st);
    case 2: return launch<2, CW>(p, m, s, o, tail, B, n, k, st);
    case 4: return launch<4, CW>(p, m, s, o, tail, B, n, k, st);
    case 8: return launch<8, CW>(p, m, s, o, tail, B, n, k, st);
    case 16: return launch<16, CW>(p, m, s, o, tail, B, n, k, st);
  }
  if constexpr (CW == 1) {
    if (ppt == 32) return launch<32, 1>(p, m, s, o, tail, B, n, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

bool valid_warps(int warps) {
  return warps == 0 || warps == 1 || warps == 2 || warps == 4 || warps == 8 ||
         warps == 16;
}

}  // namespace

// pts (B, n, 3) f32, mask (B, n) bool or null, start (B,) int32 or null
// (the first picks; clamped to [0, n)), out (B, k) int32; k >= 1. warps:
// warps a cloud (1: the warp form; 2-16: the block form; 0: the choice by
// n). tail_mind: B * lstpu_fps_tail_points(n, warps) floats of scratch, or
// null when that is 0.
extern "C" int lstpu_fps(const void* pts, const void* mask, const void* start,
                         void* out, void* tail_mind, int B, int n, int k,
                         int warps, void* stream) {
  if (B <= 0 || n <= 0 || k <= 0 || !valid_warps(warps))
    return (int)cudaErrorInvalidValue;
  if (warps == 0) warps = choose_warps(n);
  const int ppt = points_per_thread(n, warps);
  if (tail_mind == nullptr && n > 32 * warps * ppt)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pts);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  const int32_t* s = static_cast<const int32_t*>(start);
  int32_t* o = static_cast<int32_t*>(out);
  float* tail = static_cast<float*>(tail_mind);
  switch (warps) {
    case 1: return dispatch<1>(ppt, p, m, s, o, tail, B, n, k, st);
    case 2: return dispatch<2>(ppt, p, m, s, o, tail, B, n, k, st);
    case 4: return dispatch<4>(ppt, p, m, s, o, tail, B, n, k, st);
    case 8: return dispatch<8>(ppt, p, m, s, o, tail, B, n, k, st);
    default: return dispatch<16>(ppt, p, m, s, o, tail, B, n, k, st);
  }
}

// Points of each cloud past the registers, whose running minimum needs
// scratch; -1 for a `warps` the kernel does not take.
extern "C" int lstpu_fps_tail_points(int n, int warps) {
  if (n <= 0 || !valid_warps(warps)) return -1;
  if (warps == 0) warps = choose_warps(n);
  const int held = 32 * warps * points_per_thread(n, warps);
  return n > held ? n - held : 0;
}
