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
// (N * M per pair), against 36 bytes a point of input; in practice the
// instruction issue rate, about 9 instructions a distance.
//
// Design. A block of 256 threads (8 warps) owns kSrc = 128 sources of one
// pair and stages the pair's targets in shared memory, kTile at a time, as
// float4 (-2 x, -2 y, -2 z, |t|^2).
// - Register blocking: every lane owns kPer = 4 sources (lane + 32 r), so
//   one broadcast shared load of a target serves four distances, and the
//   four chains are independent of each other.
// - Target split: all 8 warps own the same 128 sources and each walks its
//   own contiguous eighth of every tile, so a pair of 1024 x 1024 puts 8
//   blocks of 8 warps to work (512 blocks at B = 64).
// - One pass over a split's targets keeps, per source, the least e = |t|^2
//   - 2 x.t, its first target and the least e of the other targets (three
//   FMAs and four selects a distance, no branch). d = |x|^2 + e rounds
//   monotonically in e, so dmin = |x|^2 + min e, and another target ties
//   exactly when the second least e gives the same d. Only then (lattice
//   clouds; rare otherwise) does the warp walk its targets again and add
//   every target whose d, computed by the same FMAs, equals dmin.
// - Each split so keeps, per source, (dmin, sum of the targets at dmin,
//   their count). The splits merge in warp order: the smaller minimum wins,
//   equal minima add. The minimum and the set of tied targets are exact;
//   only the order in which exactly tied targets are added differs from a
//   single walk.
// - One thread a source then forms its 13 statistics; warp shuffles and the
//   four warps in order give the block's partial row. The last block of a
//   pair to finish (a per-pair counter behind __threadfence) sums the
//   pair's partial rows in block order and sets the counter back to 0: one
//   launch, no float atomics, the same result on every run, and no fill of
//   the counters between launches (the wrapper keeps them, per device and
//   stream, from one call to the next).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;             // sources a lane owns
constexpr int kSrc = 32 * kPer;     // sources a block owns
constexpr int kStats = 13;          // S (9), nn_sum (3), dmin_sum (1)
constexpr int kTile = 1024;         // targets staged in shared memory at a time

struct Nearest {
  float dmin, a0, a1, a2, cnt;
};

__global__ void __launch_bounds__(kThreads)
    icp_stats_kernel(const float* __restrict__ x,
                     const float* __restrict__ src,
                     const float* __restrict__ tgt,
                     const uint8_t* __restrict__ active,
                     float* __restrict__ partial,
                     unsigned int* __restrict__ arrived,
                     float* __restrict__ out, int n, int m) {
  const int b = blockIdx.y;
  if (active[b] == 0) {
    if (blockIdx.x == 0 && threadIdx.x < kStats)
      out[(size_t)b * kStats + threadIdx.x] = 0.0f;
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * kSrc;
  const float* xb = x + (size_t)b * n * 3;
  const float* tb = tgt + (size_t)b * m * 3;

  __shared__ float4 ts[kTile];
  __shared__ Nearest part[kWarps][kSrc];
  __shared__ float red[kWarps][kStats];
  __shared__ bool last;

  float x0[kPer], x1[kPer], x2[kPer], xx[kPer];
  Nearest nb[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int i = s0 + lane + 32 * r;
    x0[r] = x1[r] = x2[r] = 0.0f;
    if (i < n) {
      x0[r] = xb[3 * i];
      x1[r] = xb[3 * i + 1];
      x2[r] = xb[3 * i + 2];
    }
    xx[r] = x0[r] * x0[r] + x1[r] * x1[r] + x2[r] * x2[r];
    nb[r] = Nearest{INFINITY, 0.0f, 0.0f, 0.0f, 0.0f};
  }
  // e = |t|^2 - 2 x.t from the staged (-2 t, |t|^2)
  auto e_of = [&](const float4& t, int r) {
    return fmaf(x0[r], t.x, fmaf(x1[r], t.y, fmaf(x2[r], t.z, t.w)));
  };

  for (int j0 = 0; j0 < m; j0 += kTile) {
    const int jn = min(kTile, m - j0);
    __syncthreads();
    for (int j = threadIdx.x; j < jn; j += kThreads) {
      const float t0 = tb[3 * (j0 + j)];
      const float t1 = tb[3 * (j0 + j) + 1];
      const float t2 = tb[3 * (j0 + j) + 2];
      ts[j] = make_float4(-2.0f * t0, -2.0f * t1, -2.0f * t2,
                          t0 * t0 + t1 * t1 + t2 * t2);
    }
    __syncthreads();
    // this warp's contiguous share of the tile: per source the least e, its
    // first target and the least e of the others
    const int per = (jn + kWarps - 1) / kWarps;
    const int ja = warp * per, jb = min(jn, ja + per);
    float emin[kPer], e2[kPer];
    int jmin[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      emin[r] = e2[r] = INFINITY;
      jmin[r] = -1;
    }
    for (int j = ja; j < jb; ++j) {
      const float4 t = ts[j];
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const float e = e_of(t, r);
        const bool lt = e < emin[r];
        e2[r] = lt ? emin[r] : fminf(e2[r], e);
        emin[r] = fminf(emin[r], e);
        jmin[r] = lt ? j : jmin[r];
      }
    }
    // d = |x|^2 + e is monotone in e: another target is at the minimum d
    // exactly when the second least e gives the same d
    Nearest near[kPer];
    bool tied[kPer], any_tied = false;
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float dm = xx[r] + emin[r];
      tied[r] = jmin[r] >= 0 && xx[r] + e2[r] == dm;
      any_tied |= tied[r];
      near[r] = Nearest{INFINITY, 0.0f, 0.0f, 0.0f, 0.0f};
      if (jmin[r] >= 0) {
        const float4 t = ts[jmin[r]];
        near[r] = Nearest{dm, -0.5f * t.x, -0.5f * t.y, -0.5f * t.z, 1.0f};
      }
      if (tied[r]) near[r] = Nearest{dm, 0.0f, 0.0f, 0.0f, 0.0f};
    }
    if (any_tied) {  // rare but for lattices: add every target at dm
      for (int j = ja; j < jb; ++j) {
        const float4 t = ts[j];
#pragma unroll
        for (int r = 0; r < kPer; ++r) {
          if (tied[r] && xx[r] + e_of(t, r) == near[r].dmin) {
            near[r].a0 += -0.5f * t.x;
            near[r].a1 += -0.5f * t.y;
            near[r].a2 += -0.5f * t.z;
            near[r].cnt += 1.0f;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {  // merge with the earlier tiles
      if (near[r].dmin < nb[r].dmin) {
        nb[r] = near[r];
      } else if (near[r].dmin == nb[r].dmin) {
        nb[r].a0 += near[r].a0;
        nb[r].a1 += near[r].a1;
        nb[r].a2 += near[r].a2;
        nb[r].cnt += near[r].cnt;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) part[warp][lane + 32 * r] = nb[r];
  __syncthreads();

  // one thread a source: merge the splits in warp order, then its statistics
  float v[kStats];
#pragma unroll
  for (int c = 0; c < kStats; ++c) v[c] = 0.0f;
  const int i = s0 + threadIdx.x;
  if (threadIdx.x < kSrc && i < n) {
    Nearest q = part[0][threadIdx.x];
    for (int w = 1; w < kWarps; ++w) {
      const Nearest p = part[w][threadIdx.x];
      if (p.dmin < q.dmin) {
        q = p;
      } else if (p.dmin == q.dmin) {
        q.a0 += p.a0;
        q.a1 += p.a1;
        q.a2 += p.a2;
        q.cnt += p.cnt;
      }
    }
    if (q.cnt > 0.0f) {
      const float inv = 1.0f / q.cnt;
      const float n0 = q.a0 * inv, n1 = q.a1 * inv, n2 = q.a2 * inv;
      const float* sb = src + ((size_t)b * n + i) * 3;
      const float s0v = sb[0], s1v = sb[1], s2v = sb[2];
      v[0] = s0v * n0; v[1] = s0v * n1; v[2] = s0v * n2;
      v[3] = s1v * n0; v[4] = s1v * n1; v[5] = s1v * n2;
      v[6] = s2v * n0; v[7] = s2v * n1; v[8] = s2v * n2;
      v[9] = n0; v[10] = n1; v[11] = n2;
      v[12] = fmaxf(q.dmin, 0.0f);
    }
  }
  constexpr int kSumWarps = kSrc / 32;  // the warps that hold a source
  if (warp < kSumWarps) {
#pragma unroll
    for (int c = 0; c < kStats; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v[c] += __shfl_down_sync(0xffffffffu, v[c], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kStats; ++c) red[warp][c] = v[c];
    }
  }
  __syncthreads();
  float* row = partial + ((size_t)b * gridDim.x + blockIdx.x) * kStats;
  if (threadIdx.x < kStats) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kSumWarps; ++w) s += red[w][threadIdx.x];
    row[threadIdx.x] = s;
    __threadfence();  // the row is visible before the counter moves
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(arrived + b, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last && threadIdx.x < kStats) {
    const volatile float* rows = partial + (size_t)b * gridDim.x * kStats;
    float s = 0.0f;
    for (unsigned k = 0; k < gridDim.x; ++k) s += rows[k * kStats + threadIdx.x];
    out[(size_t)b * kStats + threadIdx.x] = s;
    if (threadIdx.x == 0) arrived[b] = 0u;  // ready for the next launch
  }
}

}  // namespace

// x, src (B, n, 3), tgt (B, m, 3) f32; active (B,) bool; partial scratch
// (B, ceil(n / 128), 13) f32; arrived (B,) uint32 counters, all 0, which
// the launch leaves at 0; out
// (B, 13) f32 = [S row-major, nn_sum, dmin_sum]. Launches on `stream`.
extern "C" int lstpu_icp_stats(const void* x, const void* src, const void* tgt,
                               const void* active, void* partial,
                               void* arrived, void* out, int B, int n, int m,
                               void* stream) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  const int nblk = (n + kSrc - 1) / kSrc;
  icp_stats_kernel<<<dim3(nblk, B), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(src),
      static_cast<const float*>(tgt), static_cast<const uint8_t*>(active),
      static_cast<float*>(partial), static_cast<unsigned int*>(arrived),
      static_cast<float*>(out), n, m);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_icp_stats_block() { return kSrc; }
