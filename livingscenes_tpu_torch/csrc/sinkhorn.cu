// Sinkhorn potentials of uniform-weight optimal transport between two 3-D
// clouds, their iterates, and the gradient of the final update.
//
// Replaces the TPU kernels of livingscenes_tpu/ops/pallas_sinkhorn.py:
// _extrapolated_kernel (sinkhorn_kernel with f_out and g_out),
// _potentials_kernel (sinkhorn_kernel without them: the same code stopped
// before the final pair) and _extrapolated_bwd_kernel (sinkhorn_bwd_kernel).
//
// Forward, per pair: C_ij = |x_i|^2/2 + |y_j|^2/2 - x_i.y_j, log a = -log n,
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
// special-function units, against about ten f32 operations each and 24
// bytes a point of input. Design: the TPU kernel keeps the (n, m) cost
// matrix in fast memory (4 MB a pair at 1024^2), which no SM holds; here an
// entry is rebuilt from the two points wherever it is used (three
// multiply-adds), so a block needs only the clouds and the potentials in
// shared memory and nothing of size n m is ever stored. One block per pair
// (the updates of one pair are sequential and need a barrier between
// them); thread t reduces rows t, t + T, ... for ft and columns t, t + T,
// ... for gt from the old (f, g), with a running maximum so that the
// arguments (up to +-1600 at eps = 0.0025) never overflow. The backward has
// no such dependency: two blocks per pair, one sums rows for dx, the other
// columns for dy, each in a fixed order (no atomics: a run repeats bit for
// bit).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSchedule = 64;
// n + m of one pair: the backward keeps 7 floats a point in shared memory
constexpr int kMaxPoints = 8192;

struct Schedule {
  float eps[kMaxSchedule];
  float inv[kMaxSchedule];  // 1 / eps
  int count;
};

// points (cnt, 3) -> (x, y, z, |p|^2 / 2)
__device__ __forceinline__ void stage_points(const float* __restrict__ p,
                                             float4* out, int cnt) {
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
    const float a = p[3 * i], b = p[3 * i + 1], c = p[3 * i + 2];
    out[i] = make_float4(a, b, c, 0.5f * (a * a + b * b + c * c));
  }
}

__device__ __forceinline__ float cost(const float4 p, const float4 q) {
  return p.w + q.w - (p.x * q.x + p.y * q.y + p.z * q.z);
}

// logsumexp_j(logw + (pot_j - C(p, q_j)) * inv) with a running maximum.
__device__ __forceinline__ float log_sum_exp(const float4 p, const float4* q,
                                             const float* pot, int cnt,
                                             float logw, float inv) {
  float mx = -INFINITY, s = 0.0f;
  for (int j = 0; j < cnt; ++j) {
    const float t = logw + (pot[j] - cost(p, q[j])) * inv;
    if (t > mx) {
      s = s * expf(mx - t) + 1.0f;
      mx = t;
    } else {
      s += expf(t - mx);
    }
  }
  return mx + logf(s);
}

__global__ void __launch_bounds__(kMaxThreads)
    sinkhorn_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ f_out, float* __restrict__ g_out,
                    float* __restrict__ f_it, float* __restrict__ g_it,
                    Schedule sch, int n, int m) {
  extern __shared__ __align__(16) float smem[];
  float4* xs = reinterpret_cast<float4*>(smem);
  float4* ys = xs + n;
  float* f = smem + 4 * (n + m);
  float* g = f + n;
  float* ft = g + m;
  float* gt = ft + n;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  stage_points(x + (size_t)b * n * 3, xs, n);
  stage_points(y + (size_t)b * m * 3, ys, m);
  for (int i = tid; i < n; i += T) f[i] = 0.0f;
  for (int j = tid; j < m; j += T) g[j] = 0.0f;
  __syncthreads();

  const float log_a = -logf((float)n), log_b = -logf((float)m);
  const bool extrapolate = f_out != nullptr;
  const int steps = sch.count + (extrapolate ? 1 : 0);
  for (int s = 0; s < steps; ++s) {
    const bool last = s == sch.count;  // the undamped pair
    const float eps = sch.eps[last ? s - 1 : s];
    const float inv = sch.inv[last ? s - 1 : s];
    for (int i = tid; i < n; i += T)
      ft[i] = -eps * log_sum_exp(xs[i], ys, g, m, log_b, inv);
    for (int j = tid; j < m; j += T)
      gt[j] = -eps * log_sum_exp(ys[j], xs, f, n, log_a, inv);
    __syncthreads();
    if (!last) {
      for (int i = tid; i < n; i += T) f[i] = 0.5f * (f[i] + ft[i]);
      for (int j = tid; j < m; j += T) g[j] = 0.5f * (g[j] + gt[j]);
      __syncthreads();
    }
  }
  for (int i = tid; i < n; i += T) {
    f_it[(size_t)b * n + i] = f[i];
    if (extrapolate) f_out[(size_t)b * n + i] = ft[i];
  }
  for (int j = tid; j < m; j += T) {
    g_it[(size_t)b * m + j] = g[j];
    if (extrapolate) g_out[(size_t)b * m + j] = gt[j];
  }
}

// One pass of the backward: d_i = sum_j Q_ij (p_i - q_j) for the cloud p
// against q. `row` holds, per point of p, the potential that enters W (wa),
// the one that enters V (va) and the cotangent that scales W (ca; null: no
// W term); `col` the same for q with the cotangent that scales V. For dx,
// p = x: wa = f_out, va = f_it, ca = cf and col wa = g_it, va = g_out,
// ca = cg, logw = log b, logv = log a. For dy the roles of W and V swap.
struct Side {
  const float* wa;
  const float* va;
  const float* ca;
};

__device__ __forceinline__ void gradient_pass(
    const float4* ps, const float4* qs, Side row, Side col, int np, int nq,
    float logw, float logv, float inv, float* __restrict__ out) {
  for (int i = threadIdx.x; i < np; i += blockDim.x) {
    const float4 p = ps[i];
    const float wa = row.wa[i], va = row.va[i];
    const float ca = row.ca != nullptr ? row.ca[i] : 0.0f;
    // The differences are summed as they are: rowsum(Q) p - Q q would
    // cancel two terms of the size of the coordinates.
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    for (int j = 0; j < nq; ++j) {
      const float4 q = qs[j];
      const float c = cost(p, q);
      float w = 0.0f;
      if (row.ca != nullptr)
        w = ca * expf(logw + (wa + col.wa[j] - c) * inv);
      if (col.ca != nullptr)
        w += expf(logv + (va + col.va[j] - c) * inv) * col.ca[j];
      a0 += w * (p.x - q.x);
      a1 += w * (p.y - q.y);
      a2 += w * (p.z - q.z);
    }
    out[3 * i] = a0;
    out[3 * i + 1] = a1;
    out[3 * i + 2] = a2;
  }
}

__device__ __forceinline__ const float* stage_vector(const float* src,
                                                     float* dst, int cnt) {
  if (src == nullptr) return nullptr;
  for (int i = threadIdx.x; i < cnt; i += blockDim.x) dst[i] = src[i];
  return dst;
}

__global__ void __launch_bounds__(kMaxThreads)
    sinkhorn_bwd_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const float* __restrict__ f_out,
                        const float* __restrict__ g_out,
                        const float* __restrict__ f_it,
                        const float* __restrict__ g_it,
                        const float* __restrict__ cf,
                        const float* __restrict__ cg, float* __restrict__ dx,
                        float* __restrict__ dy, float inv, int n, int m) {
  extern __shared__ __align__(16) float smem[];
  float4* xs = reinterpret_cast<float4*>(smem);
  float4* ys = xs + n;
  float* vec = smem + 4 * (n + m);
  const int b = blockIdx.x;
  const size_t on = (size_t)b * n, om = (size_t)b * m;
  stage_points(x + on * 3, xs, n);
  stage_points(y + om * 3, ys, m);
  Side sx, sy;  // per point of x: f_out, f_it, cf; of y: g_it, g_out, cg
  sx.wa = stage_vector(f_out + on, vec, n);
  sx.va = stage_vector(f_it + on, vec + n, n);
  sx.ca = stage_vector(cf != nullptr ? cf + on : nullptr, vec + 2 * n, n);
  float* vy = vec + 3 * n;
  sy.wa = stage_vector(g_it + om, vy, m);
  sy.va = stage_vector(g_out + om, vy + m, m);
  sy.ca = stage_vector(cg != nullptr ? cg + om : nullptr, vy + 2 * m, m);
  __syncthreads();
  const float log_a = -logf((float)n), log_b = -logf((float)m);
  if (blockIdx.y == 0) {
    gradient_pass(xs, ys, sx, sy, n, m, log_b, log_a, inv, dx + on * 3);
  } else {
    // seen from y, V is the term its own cotangent scales
    Side ry = {sy.va, sy.wa, sy.ca}, cx = {sx.va, sx.wa, sx.ca};
    gradient_pass(ys, xs, ry, cx, m, n, log_a, log_b, inv, dy + om * 3);
  }
}

int threads_for(int n, int m) {
  const int most = n > m ? n : m;
  const int rounded = (most + 31) / 32 * 32;
  return rounded < kMaxThreads ? rounded : kMaxThreads;
}

}  // namespace

// x (B, n, 3), y (B, m, 3) f32; f_it (B, n), g_it (B, m): the damped
// iterates after the `count` temperatures eps[] (host arrays; inv[] holds
// 1 / eps). With f_out (B, n) and g_out (B, m) not null, also one undamped
// pair at the last temperature. 1 <= count <= 64, n + m <= 8192.
extern "C" int lstpu_sinkhorn(const void* x, const void* y, void* f_out,
                              void* g_out, void* f_it, void* g_it,
                              const float* eps, const float* inv, int count,
                              int B, int n, int m, void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || n + m > kMaxPoints || count < 1 ||
      count > kMaxSchedule || (f_out == nullptr) != (g_out == nullptr))
    return (int)cudaErrorInvalidValue;
  Schedule sch;
  for (int s = 0; s < kMaxSchedule; ++s) {
    sch.eps[s] = s < count ? eps[s] : 0.0f;
    sch.inv[s] = s < count ? inv[s] : 0.0f;
  }
  sch.count = count;
  const int bytes = 6 * (n + m) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_kernel<<<dim3(B), threads_for(n, m), bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(f_out), static_cast<float*>(g_out),
      static_cast<float*>(f_it), static_cast<float*>(g_it), sch, n, m);
  return (int)cudaGetLastError();
}

// The gradient of (f_out, g_out) of lstpu_sinkhorn with respect to the
// clouds: cf (B, n) and cg (B, m) are the cotangents, either may be null
// (then its term is skipped); dx (B, n, 3), dy (B, m, 3). inv = 1 / eps of
// the final pair.
extern "C" int lstpu_sinkhorn_bwd(const void* x, const void* y,
                                  const void* f_out, const void* g_out,
                                  const void* f_it, const void* g_it,
                                  const void* cf, const void* cg, void* dx,
                                  void* dy, float inv, int B, int n, int m,
                                  void* stream) {
  if (B <= 0 || n <= 0 || m <= 0 || n + m > kMaxPoints)
    return (int)cudaErrorInvalidValue;
  const int bytes = 7 * (n + m) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      sinkhorn_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  sinkhorn_bwd_kernel<<<dim3(B, 2), threads_for(n, m), bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(f_out), static_cast<const float*>(g_out),
      static_cast<const float*>(f_it), static_cast<const float*>(g_it),
      static_cast<const float*>(cf), static_cast<const float*>(cg),
      static_cast<float*>(dx), static_cast<float*>(dy), inv, n, m);
  return (int)cudaGetLastError();
}

extern "C" int lstpu_sinkhorn_max_points() { return kMaxPoints; }
extern "C" int lstpu_sinkhorn_max_schedule() { return kMaxSchedule; }
