// Sinkhorn potentials of uniform-weight optimal transport between two 3-D
// clouds, their iterates, and the gradient of the final update.
//
// Replaces the TPU kernels of livingscenes_tpu/ops/pallas_sinkhorn.py:
// _extrapolated_kernel (sinkhorn_kernel with f_out and g_out),
// _potentials_kernel (sinkhorn_kernel without them: the same code stopped
// before the final pair) and _extrapolated_bwd_kernel (sinkhorn_bwd_kernel).
//
// Forward, per pair: C_ij = |x_i - y_j|^2/2 (the TPU kernel expands it as
// |x_i|^2/2 + |y_j|^2/2 - x_i.y_j: the same function), log a = -log n,
// log b = -log m, f = g = 0, and for every temperature eps of the schedule
//     ft_i = -eps logsumexp_j(log b + (g_j - C_ij) / eps)
//     gt_j = -eps logsumexp_i(log a + (f_i - C_ij) / eps)
//     f, g = (f + ft) / 2, (g + gt) / 2        (both from the old f, g)
// then one undamped pair at the last eps: f_out = ft, g_out = gt, with the
// iterates (f, g) kept for the backward.
// Backward: with W_ij = exp(log b + (f_out_i + g_it_j - C_ij) / eps) and
// V_ij = exp(log a + (f_it_i + g_out_j - C_ij) / eps), the softmax weights of
// the final pair (the saved outputs are its log-sum-exps, so no reduction is
// needed to normalize), and Q = cf W + V cg for the cotangents cf, cg:
//     dx_i = sum_j Q_ij (x_i - y_j),  dy_j = sum_i Q_ij (y_j - x_i).
//
// What bounds it on the H100: the exponentials. A forward over a schedule
// of S temperatures evaluates 2 (S + 1) n m of them per pair on the
// special-function units (16 a clock an SM), against 24 bytes a point of
// input; the backward n m with one cotangent, 2 n m with both. Nothing of
// size n m is ever stored: an entry is rebuilt from the two points wherever
// it is used.
//
// The entry. With the row's own current potential f_i as a reference (the
// softmin is the same for any shift of its argument),
//     ft_i = f_i - eps log b - log2 sum_j 2^(k u_ij) / k,
//     u_ij = (g_j + f_i) - |x_i - y_j|^2/2,   k = log2(e) / eps,
// and gt_j the same with the roles swapped: u is symmetric, so the final
// pair's row and column passes and the backward form the same bits for an
// entry. u is small wherever a weight is not negligible (f_i + g_j ~ C_ij
// there), and the cost comes from the differences, so nothing of the size
// of the coordinates, or of the potentials, is rounded on the way: a
// folded form (k |y_j|^2/2 and k g_j staged, three multiply-adds an entry)
// rounded at the size of the coordinates over eps and failed the
// backward's test against the plain version at its unchanged tolerance,
// because the backward amplifies the iterates' rounding by 1 / eps. An
// entry is three subtractions, a multiply, three multiply-adds and an add
// for u, then a maximum, a multiply-add, one ex2 and an add. The sum is
// taken online by chunks of kChunk columns: the chunk's maximum, one
// rescale of the running sum when it rises (a branch per chunk, none within it), then one ex2 an entry with
// the maximum subtracted first. A thread walks kRows rows against each
// staged column (one shared load serves kRows entries), and P threads
// split a row group's columns, merged at the end by shuffles.
//
// Forward design. The updates of a pair depend on each other, and B pairs
// alone leave SMs idle (64 pairs, 132 SMs), so a pair runs on a
// thread-block cluster of CL blocks: block r owns the slices of rows
// [r sn, (r + 1) sn) and columns [r sm, (r + 1) sm) and computes their ft,
// gt from all of (f, g). The potentials of a pair live in a scratch buffer
// in device memory, double-buffered: a step reads buffer s & 1 (past L1,
// so a peer's writes are seen) and writes the damped average of the
// block's own slices into the other. One cluster.sync() ends each step: it
// publishes the new slices, and, since the next step writes the buffer
// that this one read, it also stands between every read of a slice and its
// overwrite. Each pass streams the other side's points, with their
// potentials, through shared memory in tiles of up to kStreamTile: any n
// and m. (Keeping both clouds and the slices in shared memory, the slices
// exchanged through distributed shared memory, was slower where they fit:
// 0.7209 ms a launch against 0.6829 at 64 x 1024 x 1024 on an H100 SXM.)
//
// Backward design. One pass over the entries of a pair evaluates Q_ij once:
// W_ij = 2^(k u_ij + k (f_out_i - f_it_i) + log2(e) log b) with the
// forward's u (f_out - f_it, of two close numbers, rounds little), one ex2
// for each weight that a given cotangent needs, and adds Q_ij (x_i - y_j)
// to row i and Q_ij (y_j - x_i) to column j, as differences: rowsum(Q) x - Q y
// would cancel two terms of the size of the coordinates. A block owns 128
// rows of a pair (grid (row tiles, B)), a lane 4 of them, summed in
// registers; its four warps split the columns, staged in tiles of
// kBwdTile. A column's sum over the block's rows: each lane's 16 columns'
// sums over its 4 rows go to shared memory and are read back by columns.
// The row tiles' column sums go to a scratch buffer and the last block of
// a pair to arrive (a per-pair counter behind __threadfence, set back to 0
// by that block) folds them in tile order: no float atomics, and a run
// repeats bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxSchedule = 64;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLowest = -1e30f;  // a running maximum before any entry

// forward
constexpr int kRows = 4;       // rows a thread reduces
constexpr int kChunk = 8;      // columns between two rescales of a sum
constexpr int kMaxParts = 8;   // threads splitting one row group's columns
constexpr int kAlign = kMaxParts * kChunk;  // staged sides padded to this
constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kStreamTile = 4096;  // points of a side staged at once

// backward
constexpr int kBwdLaneRows = 4;
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRows = 32 * kBwdLaneRows;  // rows a block: 128
constexpr int kBwdGroup = 16;   // columns a warp sums over its rows at once
constexpr int kBwdStride = kBwdGroup + 1;  // shared row of a lane's sums
constexpr int kBwdTile = 1024;  // columns staged at once

struct Schedule {
  float inv[kMaxSchedule];  // 1 / eps of each temperature
  int count;
};

__device__ __forceinline__ float exp2_approx(float v) {
#ifdef __CUDA_ARCH__
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
#else
  return exp2f(v);
#endif
}

__host__ __device__ __forceinline__ int round_up(int v, int to) {
  return (v + to - 1) / to * to;
}

// u = (pot_q + pot_p) - |p - q|^2/2, written out so that every pass rounds
// an entry alike (the same bits for (p, q) and (q, p)).
__device__ __forceinline__ float entry(float px, float py, float pz,
                                       float qx, float qy, float qz,
                                       float pot_sum) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  return fmaf(-0.5f, fmaf(dx, dx, fmaf(dy, dy, dz * dz)), pot_sum);
}

// Threads that split the columns of one row group: the most (a power of
// two, at most kMaxParts) that keeps `groups` groups within `threads`.
__device__ __forceinline__ int parts_for(int groups, int threads) {
  int p = 1;
  while (p < kMaxParts && groups * p * 2 <= threads) p *= 2;
  return p;
}

// The online log-sum-exp, base 2, of k u_rj for the thread's rows r
// (points p_r with potentials ref_r) against the columns of ops[0, cnt)
// (points with potentials) that it takes, cnt a multiple of P kChunk: in
// every chunk of P kChunk columns those at part, part + P, ... (the P
// threads of a group read neighbouring columns). mx, s: the running
// maximum of u and the sum of 2^(k (u - mx)), for each row.
__device__ __forceinline__ void lse_accumulate(
    const float4* __restrict__ ops, int cnt, int P, int part, float k,
    const float4 (&p)[kRows], float (&mx)[kRows], float (&s)[kRows]) {
  for (int base = part; base < cnt; base += P * kChunk) {
    float u[kRows][kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 q = ops[base + c * P];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        u[r][c] = entry(p[r].x, p[r].y, p[r].z, q.x, q.y, q.z, q.w + p[r].w);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float cm = u[r][0];
#pragma unroll
      for (int c = 1; c < kChunk; ++c) cm = fmaxf(cm, u[r][c]);
      if (cm > mx[r]) {
        s[r] *= exp2_approx(k * (mx[r] - cm));
        mx[r] = cm;
      }
      const float kmx = -k * mx[r];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) s[r] += exp2_approx(fmaf(k, u[r][c], kmx));
    }
  }
}

// Merge the (mx, s) of the P neighbouring lanes of a group; every lane of
// the warp takes part.
__device__ __forceinline__ void lse_merge(int P, float k, float (&mx)[kRows],
                                          float (&s)[kRows]) {
  for (int off = P >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float om = __shfl_xor_sync(0xffffffffu, mx[r], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[r], off);
      const float nm = fmaxf(mx[r], om);
      s[r] = s[r] * exp2_approx(k * (mx[r] - nm)) + os * exp2_approx(k * (om - nm));
      mx[r] = nm;
    }
  }
}

// One side's own points [lo, hi) of a step: for each point p_i, with its
// potential ref_i, the change ft_i - ref_i of its softmin against the other
// side, -(mx + (log2 s + lw2) / k), handed to emit(i, ref_i, change);
// lw2 = log2(e) logw. own(i) gives (p_i, ref_i); for_tiles(fn) stages the
// other side and calls fn(ops, padded count) once a tile, between block
// barriers where it needs them. Every thread of the block calls this the
// same number of times.
template <class Own, class Tiles, class Emit>
__device__ __forceinline__ void softmin_pass(int lo, int hi, float k,
                                             float lw2, Own own,
                                             Tiles for_tiles, Emit emit) {
  const int T = blockDim.x, tid = threadIdx.x;
  const int groups = (hi - lo + kRows - 1) / kRows;
  const int P = parts_for(groups, T);
  const int part = tid % P, per_batch = T / P;
  for (int batch = 0; batch < groups; batch += per_batch) {
    const int g = batch + tid / P;
    float4 p[kRows];
    float mx[kRows], s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = lo + g * kRows + r;
      p[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (g < groups && i < hi) p[r] = own(i);
      mx[r] = kLowest;
      s[r] = 0.0f;
    }
    for_tiles([&](const float4* ops, int cnt) {
      lse_accumulate(ops, cnt, P, part, k, p, mx, s);
    });
    lse_merge(P, k, mx, s);
    if (part == 0 && g < groups) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = lo + g * kRows + r;
        if (i < hi) emit(i, p[r].w, -(mx[r] + (log2f(s[r]) + lw2) / k));
      }
    }
  }
}

// Grid: B clusters of CL blocks along x; pot (B, 2, n + m) the potentials'
// double buffer of each pair.
__global__ void __launch_bounds__(kMaxThreads)
    sinkhorn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ f_out, float* __restrict__ g_out,
                    float* __restrict__ f_it, float* __restrict__ g_it,
                    float* __restrict__ pot, Schedule sch, int n, int m) {
  extern __shared__ __align__(16) float smem[];
  float4* tile = reinterpret_cast<float4*>(smem);  // the other side's points
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / CL;
  const int tid = threadIdx.x, T = blockDim.x;
  const int sn = (n + CL - 1) / CL, sm = (m + CL - 1) / CL;
  const int i0 = min(n, rank * sn), i1 = min(n, i0 + sn);
  const int j0 = min(m, rank * sm), j1 = min(m, j0 + sm);
  const float* xb = x + (size_t)b * n * 3;
  const float* yb = y + (size_t)b * m * 3;
  float* pot_b = pot + (size_t)b * 2 * (n + m);
  const float la2 = -kLog2e * logf((float)n), lb2 = -kLog2e * logf((float)m);
  const bool extrapolate = f_out != nullptr;
  const int steps = sch.count + (extrapolate ? 1 : 0);

  for (int s = 0; s < steps; ++s) {
    const bool last = s == sch.count;  // the undamped pair
    const float k = kLog2e * sch.inv[last ? s - 1 : s];
    const float* pc = pot_b + (s & 1) * (n + m);
    float* pn = pot_b + ((s & 1) ^ 1) * (n + m);
    // a row's new value from its reference (its current potential) and
    // the change of its softmin: ft in the final pair, else the damped
    // average (ref + ft) / 2
    auto update = [&](float ref, float change) {
      return last ? ref + change : fmaf(0.5f, change, ref);
    };
    // point e of `pts` with its potential in pc[at + e] (zero before the
    // first update)
    auto point = [=](const float* pts, int at) {
      return [=](int e) {
        return make_float4(pts[3 * e], pts[3 * e + 1], pts[3 * e + 2],
                           s ? __ldcg(pc + at + e) : 0.0f);
      };
    };
    // the other side (cnt points) streamed through `tile`; points past cnt
    // have a potential of -inf: an entry of weight 0
    auto streamed = [&](auto other, int cnt) {
      return [=](auto&& fn) {
        for (int t0 = 0; t0 < cnt; t0 += kStreamTile) {
          const int c = min(kStreamTile, cnt - t0), cp = round_up(c, kAlign);
          __syncthreads();  // the last tile is consumed
          for (int e = tid; e < cp; e += T)
            tile[e] = e < c ? other(t0 + e)
                            : make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
          __syncthreads();
          fn(tile, cp);
        }
      };
    };
    softmin_pass(i0, i1, k, lb2, point(xb, 0), streamed(point(yb, n), m),
                 [&](int i, float ref, float change) {
                   if (last)
                     f_out[(size_t)b * n + i] = update(ref, change);
                   else
                     pn[i] = update(ref, change);
                 });
    softmin_pass(j0, j1, k, la2, point(yb, n), streamed(point(xb, 0), n),
                 [&](int j, float ref, float change) {
                   if (last)
                     g_out[(size_t)b * m + j] = update(ref, change);
                   else
                     pn[n + j] = update(ref, change);
                 });
    cluster.sync();
  }
  // the iterates: buffer count & 1
  const float* fin = pot_b + (sch.count & 1) * (n + m);
  for (int i = i0 + tid; i < i1; i += T) f_it[(size_t)b * n + i] = __ldcg(fin + i);
  for (int j = j0 + tid; j < j1; j += T) g_it[(size_t)b * m + j] = __ldcg(fin + n + j);
}

// The SMs of the current device, or the query's error.
cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

struct Plan {
  int cluster, threads, tile;  // tile: the points of a side staged at once
};

// The launch shape of a forward: the cluster size (the largest of 1, 2,
// 4, 8 that keeps the blocks, one an SM at kMaxThreads, within one wave: 2
// for the refinement's 64 pairs on 132 SMs, the best of the four there on
// an H100 SXM; no other B was timed), the threads a block (enough
// for kMaxParts threads on each of the larger slice's row groups, at most
// kMaxThreads) and the points of a side staged at once.
cudaError_t plan_for(int B, int n, int m, Plan* p) {
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  p->cluster = 1;
  while (p->cluster < kMaxCluster && B * p->cluster * 2 <= sms) p->cluster *= 2;
  const int sn = (n + p->cluster - 1) / p->cluster;
  const int sm = (m + p->cluster - 1) / p->cluster;
  const int groups = ((sn > sm ? sn : sm) + kRows - 1) / kRows;
  const int wanted = round_up(groups * kMaxParts, 32);
  p->threads = wanted < kMaxThreads ? wanted : kMaxThreads;
  const int side = round_up(n > m ? n : m, kAlign);
  p->tile = side < kStreamTile ? side : kStreamTile;
  return cudaSuccess;
}

// One pass of the backward over the entries of a block's rows: kW, kV say
// which cotangents are given (the W term needs cf, the V term cg).
template <bool kW, bool kV>
__global__ void __launch_bounds__(kBwdThreads)
    sinkhorn_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ f_out,
                        const float* __restrict__ g_out,
                        const float* __restrict__ f_it,
                        const float* __restrict__ g_it,
                        const float* __restrict__ cf,
                        const float* __restrict__ cg_,
                        float* __restrict__ dx, float* __restrict__ dy,
                        float* __restrict__ partial,
                        unsigned* __restrict__ arrived, float inv, int n,
                        int m) {
  extern __shared__ __align__(16) float smem[];
  float4* cq = reinterpret_cast<float4*>(smem);  // (y_j, g_it_j)
  float2* cv = reinterpret_cast<float2*>(cq + kBwdTile);  // (V's cv_j, cg_j)
  float* red = reinterpret_cast<float*>(cv + kBwdTile);
  __shared__ bool last;
  const int b = blockIdx.y, tile = blockIdx.x, tiles = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t on = (size_t)b * n, om = (size_t)b * m;
  const float k = kLog2e * inv;
  const float la2 = -kLog2e * logf((float)n), lb2 = -kLog2e * logf((float)m);
  // W_ij = 2^(k u_ij + rw_i), V_ij = 2^(k u_ij + cv_j) with the forward's
  // final-pair entry u_ij (entry(), the same bits) and rw_i = k (f_out_i -
  // f_it_i) + log2(e) log b, cv_j = k (g_out_j - g_it_j) + log2(e) log a:
  // the weights of a row (of a column for V) are normalized as precisely as
  // the output's own rounding allows, as the plain version's softmax is.
  float4 p[kBwdLaneRows];  // (x_i, f_it_i)
  float rw[kBwdLaneRows], c[kBwdLaneRows];
  float gx[kBwdLaneRows], gy[kBwdLaneRows], gz[kBwdLaneRows];
#pragma unroll
  for (int r = 0; r < kBwdLaneRows; ++r) {
    const int i = tile * kBwdRows + lane + 32 * r;
    // rows past n: a potential of -inf, every weight 0
    p[r] = make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
    rw[r] = c[r] = 0.0f;
    if (i < n) {
      p[r] = make_float4(x[(on + i) * 3], x[(on + i) * 3 + 1], x[(on + i) * 3 + 2],
                         f_it[on + i]);
      rw[r] = fmaf(k, f_out[on + i] - p[r].w, lb2);
      c[r] = kW ? cf[on + i] : 0.0f;
    }
    gx[r] = gy[r] = gz[r] = 0.0f;
  }
  float* my_red = red + warp * 3 * 32 * kBwdStride;
  for (int t0 = 0; t0 < m; t0 += kBwdTile) {
    const int cnt = min(kBwdTile, m - t0);
    const int cntp = round_up(cnt, kBwdGroup * kBwdWarps);
    __syncthreads();  // the last tile is consumed
    for (int e = threadIdx.x; e < cntp; e += kBwdThreads) {
      if (e < cnt) {
        const size_t j = om + t0 + e;
        const float gi = g_it[j];
        cq[e] = make_float4(y[j * 3], y[j * 3 + 1], y[j * 3 + 2], gi);
        cv[e] = make_float2(fmaf(k, g_out[j] - gi, la2), kV ? cg_[j] : 0.0f);
      } else {
        // past m: a weight of 0 (and a cotangent of 0)
        cq[e] = make_float4(0.0f, 0.0f, 0.0f, -INFINITY);
        cv[e] = make_float2(0.0f, 0.0f);
      }
    }
    __syncthreads();
    for (int g0 = warp * kBwdGroup; g0 < cntp; g0 += kBwdGroup * kBwdWarps) {
#pragma unroll
      for (int cc = 0; cc < kBwdGroup; ++cc) {
        const float4 q = cq[g0 + cc];
        const float2 v = cv[g0 + cc];
        float sx = 0.0f, sy = 0.0f, sz = 0.0f;
#pragma unroll
        for (int r = 0; r < kBwdLaneRows; ++r) {
          const float u = entry(p[r].x, p[r].y, p[r].z, q.x, q.y, q.z, q.w + p[r].w);
          float w = 0.0f;
          if (kW) w = c[r] * exp2_approx(fmaf(k, u, rw[r]));
          if (kV) w = fmaf(exp2_approx(fmaf(k, u, v.x)), v.y, w);
          const float ex = p[r].x - q.x, ey = p[r].y - q.y, ez = p[r].z - q.z;
          gx[r] = fmaf(w, ex, gx[r]);
          gy[r] = fmaf(w, ey, gy[r]);
          gz[r] = fmaf(w, ez, gz[r]);
          sx = fmaf(w, ex, sx);
          sy = fmaf(w, ey, sy);
          sz = fmaf(w, ez, sz);
        }
        my_red[(0 * 32 + lane) * kBwdStride + cc] = sx;
        my_red[(1 * 32 + lane) * kBwdStride + cc] = sy;
        my_red[(2 * 32 + lane) * kBwdStride + cc] = sz;
      }
      __syncwarp();
      // lane (cc, h) sums column cc over lanes 16 h .. 16 h + 15
      const int cc = lane & (kBwdGroup - 1), h = lane / kBwdGroup;
      const int j = t0 + g0 + cc;
#pragma unroll
      for (int comp = 0; comp < 3; ++comp) {
        // four interleaved partial sums, then their pairs: a fixed order
        const float* col = my_red + (comp * 32 + 16 * h) * kBwdStride + cc;
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int l = 0; l < 16; ++l) part[l & 3] += col[l * kBwdStride];
        float v = (part[0] + part[1]) + (part[2] + part[3]);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        // sum_i Q_ij (y_j - x_i) over the block's rows
        if (h == 0 && g0 + cc < cnt)
          partial[(((size_t)b * tiles + tile) * 3 + comp) * m + j] = -v;
      }
      __syncwarp();
    }
  }
  // dx: the warps' sums over their columns, folded in warp order
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kBwdLaneRows; ++r) {
    float* row = red + (warp * 3) * kBwdRows + lane + 32 * r;
    row[0] = gx[r];
    row[kBwdRows] = gy[r];
    row[2 * kBwdRows] = gz[r];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 3 * kBwdRows; e += kBwdThreads) {
    const int rr = e / 3, comp = e % 3, i = tile * kBwdRows + rr;
    float v = 0.0f;
    for (int w = 0; w < kBwdWarps; ++w) v += red[(w * 3 + comp) * kBwdRows + rr];
    if (i < n) dx[(on + i) * 3 + comp] = v;
  }
  // dy: the last block of the pair folds the row tiles' sums in tile order
  __threadfence();  // this block's sums are visible before the counter moves
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrived + b, 1u) == (unsigned)tiles - 1;
  __syncthreads();
  if (last) {
    // the (tiles, 3, m) sums of this pair, e = comp m + j, in tile order
    const float* sums = partial + (size_t)b * tiles * 3 * m;
    for (int e = threadIdx.x; e < 3 * m; e += kBwdThreads) {
      const int comp = e / m, j = e - comp * m;
      float v = 0.0f;
#pragma unroll 8
      for (int t = 0; t < tiles; ++t) v += __ldcg(sums + (size_t)t * 3 * m + e);
      dy[(om + j) * 3 + comp] = v;
    }
    if (threadIdx.x == 0) arrived[b] = 0u;  // ready for the next launch
  }
}

int bwd_bytes() {
  return kBwdTile * (16 + 8) + kBwdWarps * 3 * 32 * kBwdStride * 4;
}

}  // namespace

// The launch shape that lstpu_sinkhorn takes for (B, n, m): out[0] the
// cluster size, out[1] threads a block, out[2] the points of a side staged
// in shared memory at once, out[3] the potentials' scratch floats a pair.
extern "C" int lstpu_sinkhorn_plan(int B, int n, int m, int* out) {
  if (B <= 0 || n <= 0 || m <= 0) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t err = plan_for(B, n, m, &p);
  if (err != cudaSuccess) return (int)err;
  out[0] = p.cluster;
  out[1] = p.threads;
  out[2] = p.tile;
  out[3] = 2 * (n + m);
  return 0;
}

// x (B, n, 3), y (B, m, 3) f32; f_it (B, n), g_it (B, m): the damped
// iterates after `count` temperatures, given by their reciprocals inv[] (a
// host array). With f_out (B, n) and g_out (B, m) not null, also one undamped
// pair at the last temperature. pot: B * out[3] floats of scratch
// (lstpu_sinkhorn_plan). 1 <= count <= 64; any n and m.
extern "C" int lstpu_sinkhorn(const void* x, const void* y, void* f_out,
                              void* g_out, void* f_it, void* g_it, void* pot,
                              const float* inv, int count, int B, int n,
                              int m, void* cuda_stream) {
  int shape[4];
  const int err0 = lstpu_sinkhorn_plan(B, n, m, shape);
  if (err0 != 0) return err0;
  if (count < 1 || count > kMaxSchedule ||
      (f_out == nullptr) != (g_out == nullptr) || pot == nullptr)
    return (int)cudaErrorInvalidValue;
  Schedule sch;
  for (int s = 0; s < kMaxSchedule; ++s) sch.inv[s] = s < count ? inv[s] : 0.0f;
  sch.count = count;
  const int bytes = shape[2] * (int)sizeof(float4);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * shape[0]);
  cfg.blockDim = dim3(shape[1]);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(cuda_stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = shape[0];
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, sinkhorn_kernel, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(f_out), static_cast<float*>(g_out),
      static_cast<float*>(f_it), static_cast<float*>(g_it),
      static_cast<float*>(pot), sch, n, m);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The gradient of (f_out, g_out) of lstpu_sinkhorn with respect to the
// clouds: cf (B, n) and cg (B, m) are the cotangents, either (not both) may
// be null (then its term is skipped); dx (B, n, 3), dy (B, m, 3). inv = 1 /
// eps of the final pair. partial: (B, ceil(n / lstpu_sinkhorn_bwd_rows()),
// 3, m) f32 scratch; arrived (B,) uint32 counters, all 0, which the launch
// leaves at 0.
extern "C" int lstpu_sinkhorn_bwd(const void* x, const void* y,
                                  const void* f_out, const void* g_out,
                                  const void* f_it, const void* g_it,
                                  const void* cf, const void* cg, void* dx,
                                  void* dy, void* partial, void* arrived,
                                  float inv, int B, int n, int m,
                                  void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || (cf == nullptr && cg == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = cf == nullptr   ? sinkhorn_bwd_kernel<false, true>
                : cg == nullptr ? sinkhorn_bwd_kernel<true, false>
                                : sinkhorn_bwd_kernel<true, true>;
  const int bytes = bwd_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kBwdRows - 1) / kBwdRows, B);
  kernel<<<grid, kBwdThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(f_out), static_cast<const float*>(g_out),
      static_cast<const float*>(f_it), static_cast<const float*>(g_it),
      static_cast<const float*>(cf), static_cast<const float*>(cg),
      static_cast<float*>(dx), static_cast<float*>(dy),
      static_cast<float*>(partial), static_cast<unsigned*>(arrived), inv, n, m);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_sinkhorn_bwd_rows() { return kBwdRows; }
extern "C" int lstpu_sinkhorn_max_schedule() { return kMaxSchedule; }
