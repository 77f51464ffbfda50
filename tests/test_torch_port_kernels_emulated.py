"""The port's CUDA sources run on CPU threads and held against their plain
PyTorch versions.

There is no card and no nvcc where these tests run, so the kernels' own code
(livingscenes_tpu_torch/csrc/*.cu) is compiled by the host's g++ against a
stand-in for the CUDA runtime (CUDA_RUNTIME_STAND_IN below, written out as
the `cuda_runtime.h` the sources include: blocks one after another, a
block's threads as OS threads, barriers for __syncthreads and the warp
shuffles, dynamic shared memory poisoned with NaN). Only the launches `kernel<<<grid, block, shared, stream>>>(...)` and
the `extern __shared__` declarations are rewritten; atomicAdd is a
compare-and-swap loop. The port's real
wrappers then call the emulated library on CPU tensors, so their argument
preparation (layouts, transposes, the dst halves) is covered too.

What this shows: indexing, tiling, ragged edges, tie rules and reductions
of the kernels at small shapes (K < 16, widths that are no multiple of a
tile), before a source has seen a CUDA compiler. It holds the port against
itself, a kernel against its plain version, and says nothing of parity
with the JAX package: the other tests/test_torch_port_*.py files hold the
plain versions to that. What it cannot show: that nvcc accepts the
sources, memory alignment, or speed; `python3 chip_smoke.py` on the card
holds every kernel against its plain version at the main path's shapes
and at small ragged ones.

Tolerances: FPS and kNN indices equal (the inputs are exact in f32 where
ties occur); ICP statistics rtol 1e-4; the fused edge layers rtol 2e-4 plus
atol 2e-5 of the largest magnitude, as on the card, and their backward
kernels against autograd of the plain versions the same (the kernels add
the scatter and the weight gradients with atomics, in no fixed order); the scale statistic rtol
1e-6; the Sinkhorn potentials rtol/atol 1e-5 and their gradient rtol 1e-4
plus atol 1e-6 (f32 rounding of arguments up to 1e3 in the exponentials).
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
from livingscenes_tpu_torch.ops import (
    _cuda, cuda_fps, cuda_icp, cuda_knn, cuda_scale, cuda_sinkhorn)
from livingscenes_tpu_torch.ops.sinkhorn import eps_annealing_schedule
from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
from livingscenes_tpu_torch.ops.knn import knn

CUDA_RUNTIME_STAND_IN = r'''// A stand-in for <cuda_runtime.h> that lets a host compiler build the port's
// kernels (livingscenes_tpu_torch/csrc/*.cu) and run them on CPU threads.
// It covers only what those sources use. The blocks of a launch run one
// after another; the threads of a block are OS threads that meet at
// barriers: __syncthreads() is a barrier over the block, a warp shuffle a
// pair of barriers over the warp's 32 threads, so every thread of a warp
// must reach a shuffle, as on the card. atomicAdd on a float is a
// compare-and-swap loop on a std::atomic_ref. Dynamic shared memory is filled
// with NaN before every block: a kernel that reads shared memory it never
// wrote shows up as a wrong answer. This says nothing about whether nvcc
// accepts a source, about alignment faults, or about speed.
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 {
  float x, y, z, w;
};
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)

typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

using std::max;
using std::min;
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float atomicAdd(float* address, float v) {
  std::atomic_ref<float> ref(*address);
  float old = ref.load(std::memory_order_relaxed);
  while (!ref.compare_exchange_weak(old, old + v, std::memory_order_relaxed)) {
  }
  return old;
}

namespace cuda_emulation {

inline thread_local dim3 thread_idx, block_idx;
inline dim3 grid_dim, block_dim;
inline std::unique_ptr<std::barrier<>> block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> warp_barrier;
inline std::vector<uint64_t> warp_slots;
inline float* dynamic_shared = nullptr;

inline void poison(size_t bytes) {
  for (size_t i = 0; i < bytes / sizeof(float); ++i) dynamic_shared[i] = NAN;
}

// Run `body` once per (block, thread) of the launch.
inline void launch(dim3 grid, dim3 block, size_t shared_bytes,
                   const std::function<void()>& body) {
  grid_dim = grid;
  block_dim = block;
  const int threads = block.x;
  const int warps = (threads + 31) / 32;
  block_barrier = std::make_unique<std::barrier<>>(threads);
  warp_barrier.clear();
  for (int w = 0; w < warps; ++w)
    warp_barrier.push_back(
        std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
  warp_slots.assign(warps * 32, 0);
  dynamic_shared =
      static_cast<float*>(std::aligned_alloc(64, (shared_bytes / 64 + 2) * 64));
  poison(shared_bytes);
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; ++t)
    pool.emplace_back([&, t] {
      thread_idx = dim3(t);
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; ++bx) {
          block_idx = dim3(bx, by);
          body();
          block_barrier->arrive_and_wait();
          if (t == 0) poison(shared_bytes);
          block_barrier->arrive_and_wait();
        }
    });
  for (auto& th : pool) th.join();
  std::free(dynamic_shared);
  dynamic_shared = nullptr;
}

template <class T>
inline T exchange(T v, int source_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const int t = thread_idx.x, w = t / 32;
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  warp_slots[t] = raw;
  warp_barrier[w]->arrive_and_wait();
  if (source_lane >= 0 && source_lane < 32 &&
      w * 32 + source_lane < (int)block_dim.x)
    raw = warp_slots[w * 32 + source_lane];
  warp_barrier[w]->arrive_and_wait();
  T out;
  std::memcpy(&out, &raw, sizeof(T));
  return out;
}

}  // namespace cuda_emulation

#define threadIdx cuda_emulation::thread_idx
#define blockIdx cuda_emulation::block_idx
#define gridDim cuda_emulation::grid_dim
#define blockDim cuda_emulation::block_dim

inline void __syncthreads() {
  cuda_emulation::block_barrier->arrive_and_wait();
}
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return cuda_emulation::exchange(v, (int)(threadIdx.x % 32) ^ mask);
}
template <class T>
inline T __shfl_down_sync(unsigned, T v, int delta) {
  return cuda_emulation::exchange(v, (int)(threadIdx.x % 32) + delta);
}
template <class T>
inline T __shfl_sync(unsigned, T v, int lane) {
  return cuda_emulation::exchange(v, lane);
}
'''


def _split_args(text):
    """Split at top-level commas."""
    parts, depth, cur = [], 0, ""
    for ch in text:
        depth += ch in "(<[" 
        depth -= ch in ")>]"
        if ch == "," and depth == 0:
            parts.append(cur.strip())
            cur = ""
        else:
            cur += ch
    return parts + [cur.strip()]


def rewrite_for_host(text):
    """CUDA launch syntax and dynamic shared memory, as host C++."""
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = cuda_emulation::dynamic_shared;", text)

    def launch(m):
        grid, block, shared = _split_args(m.group(2))[:3]
        return (f"cuda_emulation::launch({grid}, {block}, {shared}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"([\w:]+(?:<\w+>)?)<<<(.*?)>>>\(\s*(.*?)\);", launch, text,
                  flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' library built for the host, bound like the real one."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    work = tmp_path_factory.mktemp("cuda_emulation")
    (work / "cuda_runtime.h").write_text(CUDA_RUNTIME_STAND_IN)
    for path in _cuda.CSRC.iterdir():
        name = path.name.replace(".cu", ".cpp") if path.suffix == ".cu" else path.name
        (work / name).write_text(rewrite_for_host(path.read_text()))
    lib = work / "libemulated.so"
    cmd = [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
           f"-I{work}", "-o", str(lib)]
    cmd += [str(work / s.replace(".cu", ".cpp")) for s in _cuda.SOURCES]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr[-4000:]
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in _cuda._SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


@pytest.fixture
def on_host(emulated, monkeypatch):
    """Point the wrappers at the emulated library and let them take CPU
    tensors."""
    monkeypatch.setattr(_cuda, "_lib", emulated)
    monkeypatch.setattr(_cuda, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_cuda, "stream_ptr", lambda t: 0)
    with torch.no_grad():
        yield


def f32(rng, *shape, scale=1.0):
    return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32))


def lattice(rng, dims):
    g = np.stack(np.meshgrid(*[np.arange(d) for d in dims], indexing="ij"), -1)
    g = rng.permutation(g.reshape(-1, 3)) - (np.asarray(dims) - 1) / 2
    return torch.as_tensor(g.astype(np.float32))


def assert_close(got, want):
    assert bool(torch.isfinite(got).all())
    tol = 2e-5 * want.abs().max() + 2e-4 * want.abs()
    assert bool(((got - want).abs() <= tol).all()), float((got - want).abs().max())


def test_rewrite_for_host():
    src = ("extern __shared__ __align__(16) float smem[];\n"
           "k<8><<<dim3(a, b), kT, n * sizeof(float),\n"
           "       static_cast<cudaStream_t>(s)>>>(x, f(y, z));\n")
    out = rewrite_for_host(src)
    assert "float* smem = cuda_emulation::dynamic_shared;" in out
    assert ("cuda_emulation::launch(dim3(a, b), kT, n * sizeof(float), "
            "[&] { k<8>(x, f(y, z)); });") in out
    assert "<<<" not in out


@pytest.mark.parametrize("N,k,masked", [(200, 50, False), (300, 64, True), (40, 60, True)])
def test_fps_kernel(on_host, N, k, masked):
    rng = np.random.default_rng(0)
    pts = f32(rng, 3, N, 3)
    mask = None
    if masked:
        mask = torch.as_tensor(rng.random((3, N)) > 0.3)
        mask[1, N // 4:] = False
    got = cuda_fps.fps_cuda(pts, k, mask)
    want = farthest_point_sampling(pts, k, mask)[1]
    assert torch.equal(got.long(), want)


@pytest.mark.parametrize("Nq,Np,D,k", [(70, 100, 3, 16), (33, 150, 48, 16), (20, 20, 96, 7)])
def test_knn_kernel(on_host, Nq, Np, D, k):
    rng = np.random.default_rng(1)
    # small integers: every product and sum is exact, ties are real ties
    p = torch.as_tensor(rng.integers(-3, 4, (2, Np, D)).astype(np.float32))
    q = p[:, :Nq].contiguous()
    dk, ik = cuda_knn.knn_cuda(q, p, k)
    dp, ip = knn(q, p, k)
    assert torch.equal(ik.long(), ip)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("N,k,tied", [(100, 16, False), (256, 16, True), (20, 5, False)])
def test_knn_topk_kernel(on_host, N, k, tied):
    rng = np.random.default_rng(2)
    pc = f32(rng, 2, N, 3)
    if tied:
        pc[0] = lattice(rng, (8, 8, 4))
    ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, k)
    ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, k)
    assert ik.dtype == torch.int32 and torch.equal(ik.long(), ip)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)


def test_icp_stats_kernel(on_host):
    rng = np.random.default_rng(3)
    x, src, tgt = f32(rng, 3, 300, 3), f32(rng, 3, 300, 3), f32(rng, 3, 130, 3)
    active = torch.tensor([True, False, True])
    got = cuda_icp.icp_stats_cuda(x, src, tgt, active)
    want = cuda_icp.icp_stats_plain(x, src, tgt, active)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert not bool(got[0][1].any())


@pytest.mark.parametrize("N,K,O", [(40, 16, 32), (33, 8, 48), (18, 16, 132)])
def test_layer0_kernel(on_host, N, K, O):
    rng = np.random.default_rng(4)
    xyz = f32(rng, 2, N, 3)
    idx = torch.as_tensor(rng.integers(0, N, (2, N, K)))
    W, D = f32(rng, O, 3, scale=0.5), f32(rng, O, O, scale=0.2)
    assert_close(cuda_layer0.fused_layer0_edge_mean_cuda(xyz, idx, W, D),
                 cuda_layer0.fused_layer0_edge_mean_plain(xyz, idx, W, D))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K", [(50, 50, 32, 32, 16), (40, 21, 16, 48, 8), (30, 5, 36, 140, 7)])
def test_mean_edge_kernel(on_host, Ns, Nd, C, O, K):
    rng = np.random.default_rng(5)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = torch.as_tensor(rng.integers(0, Ns, (2, Nd, K)))
    W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
    assert_close(cuda_attention.fused_edge_mean_cuda(src, dst, idx, W, D),
                 cuda_attention.fused_edge_mean_plain(src, dst, idx, W, D))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [
        (40, 20, 32, 64, 16, 16),   # the width of attention layers 2-3
        (40, 7, 16, 32, 8, 16),     # ragged last block, K < 16
        (24, 3, 20, 144, 5, 8),     # two output tiles, the second partial
        (20, 3, 128, 256, 16, 16),  # the width of attention layer 5
    ],
)
def test_attention_kernel(on_host, Ns, Nd, C, O, K, head_c):
    rng = np.random.default_rng(6)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = torch.as_tensor(rng.integers(0, Ns, (2, Nd, K)))
    q_n = channel_equi_vec_normalize(f32(rng, 2, Nd, O, 3))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    args = (src, dst, idx, q_n, W_K, D_K, W_V, D_V, head_c)
    assert_close(cuda_attention.fused_edge_attention_cuda(*args),
                 cuda_attention.fused_edge_attention_plain(*args))


@pytest.mark.parametrize("N,k,tied", [(100, 5, False), (150, 5, True), (7, 5, False), (64, 8, False)])
def test_scale_kernel(on_host, N, k, tied):
    rng = np.random.default_rng(7)
    pc = f32(rng, 3, N, 3)
    if tied:
        # a lattice cloud: the largest distances are tied many times over
        pc[1, :128] = lattice(rng, (8, 4, 4))
        pc[1, 128:] = 0.0
    got = cuda_scale.top_k_mean_pairwise_distance_cuda(pc, k)
    want = cuda_scale.top_k_mean_pairwise_distance_plain(pc, k)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


SINKHORN_SHAPES = [
    # N, M, schedule
    (50, 50, eps_annealing_schedule(0.05)),   # the refinement's schedule
    (70, 33, eps_annealing_schedule(0.1)),    # N != M, no multiple of a warp
    (20, 45, [0.01] * 5),                     # a single temperature, repeated
]


def sinkhorn_clouds(rng, N, M):
    x = f32(rng, 2, N, 3, scale=0.3)
    y = f32(rng, 2, M, 3, scale=0.3) + 0.1
    return x, y


@pytest.mark.parametrize("N,M,schedule", SINKHORN_SHAPES)
def test_sinkhorn_kernel(on_host, N, M, schedule):
    x, y = sinkhorn_clouds(np.random.default_rng(8), N, M)
    got = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    want = cuda_sinkhorn.ot_extrapolated_potentials_plain(x, y, schedule)
    want += cuda_sinkhorn.sinkhorn_iterates_plain(x, y, schedule)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # the same code stopped before the final pair
    for g, w in zip(cuda_sinkhorn.sinkhorn_iterates_cuda(x, y, schedule), want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M,schedule", SINKHORN_SHAPES)
@pytest.mark.parametrize("cots", ["both", "f_only", "g_only"])
def test_sinkhorn_bwd_kernel(on_host, N, M, schedule, cots):
    rng = np.random.default_rng(9)
    x, y = sinkhorn_clouds(rng, N, M)
    cf = f32(rng, 2, N) if cots != "g_only" else None
    cg = f32(rng, 2, M) if cots != "f_only" else None
    saved = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    dx, dy = cuda_sinkhorn.extrapolated_backward_cuda(
        x, y, *saved, cf, cg, schedule[-1])
    with torch.enable_grad():
        xv, yv = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        f, g = cuda_sinkhorn.ot_extrapolated_potentials_plain(xv, yv, schedule)
        total = sum(torch.sum(c * p) for c, p in ((cf, f), (cg, g)) if c is not None)
        wx, wy = torch.autograd.grad(total, (xv, yv))
    torch.testing.assert_close(dx, wx, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dy, wy, rtol=1e-4, atol=1e-6)


def graph_with_repeats(rng, n_src, n_dst, K):
    """A (2, n_dst, K) graph whose sources repeat within and across rows: a
    few sources are every row's neighbours, so the scatter adds many edges
    into one row."""
    idx = rng.integers(0, n_src, (2, n_dst, K))
    idx[:, :, 0] = 0
    idx[:, ::2, 1] = n_src - 1
    idx[:, 1::3, 2 % K] = 0  # row repeats the same source
    return torch.as_tensor(idx)


def assert_all_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w)


@pytest.mark.parametrize("N,K,O", [(40, 16, 32), (33, 8, 48), (18, 16, 132)])
def test_layer0_bwd_kernel(on_host, N, K, O):
    rng = np.random.default_rng(10)
    xyz = f32(rng, 2, N, 3)
    xyz[1, 3] = 0.0  # a point at the origin: dst^'s clamp
    idx = graph_with_repeats(rng, N, N, K)
    W, D = f32(rng, O, 3, scale=0.5), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, N, O, 3)
    assert_all_close(
        cuda_layer0.fused_layer0_edge_mean_bwd_cuda(xyz, idx, W, D, g),
        cuda_layer0.fused_layer0_edge_mean_bwd_plain(xyz, idx, W, D, g))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K", [(50, 50, 32, 32, 16), (40, 21, 16, 48, 8), (30, 5, 36, 140, 7)])
def test_mean_edge_bwd_kernel(on_host, Ns, Nd, C, O, K):
    rng = np.random.default_rng(11)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = graph_with_repeats(rng, Ns, Nd, K)
    W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, Nd, O, 3)
    args = (src, dst, idx, W, D, g)
    assert_all_close(cuda_attention.fused_edge_mean_bwd_cuda(*args),
                     cuda_attention.fused_edge_mean_bwd_plain(*args))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [
        (40, 20, 32, 64, 16, 16),   # the width of attention layers 2-3
        (40, 7, 16, 32, 8, 16),     # ragged last block, K < 16
        (24, 3, 20, 144, 5, 8),     # two output tiles, the second partial
        (20, 3, 128, 256, 16, 16),  # the width of attention layer 5
    ],
)
def test_attention_bwd_kernel(on_host, Ns, Nd, C, O, K, head_c):
    rng = np.random.default_rng(12)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = graph_with_repeats(rng, Ns, Nd, K)
    q_n = channel_equi_vec_normalize(f32(rng, 2, Nd, O, 3))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, Nd, O, 3)
    args = (src, dst, idx, q_n, W_K, D_K, W_V, D_V, g, head_c)
    assert_all_close(cuda_attention.fused_edge_attention_bwd_cuda(*args),
                     cuda_attention.fused_edge_attention_bwd_plain(*args))
