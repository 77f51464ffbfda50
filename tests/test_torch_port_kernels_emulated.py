"""The port's CUDA sources run on CPU threads and held against their plain
PyTorch versions.

There is no card and no nvcc where these tests run, so the kernels' own code
(livingscenes_tpu_torch/csrc/*.cu) is compiled by the host's g++ against a
stand-in for the CUDA runtime (CUDA_RUNTIME_STAND_IN below, written out as
the `cuda_runtime.h` the sources include: blocks one after another, a
block's threads as OS threads, barriers for __syncthreads and the warp
shuffles, dynamic shared memory poisoned with NaN; the warp reductions,
cp.async and its waits; cudaLaunchKernelEx with a cluster dimension, whose
blocks run at the same time and share cluster.sync()). Only the launches
`kernel<<<grid, block, shared, stream>>>(...)` and the `extern __shared__`
declarations are rewritten; atomicAdd and atomicMax are compare-and-swap
loops. The port's real
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

The FPS, kNN, kNN + scale and Sinkhorn kernels' cases and those of the
backward kernels are in files of their own (tests/test_torch_port_kernels_
emulated_fps.py, _knn.py, _knn_cap.py, _sinkhorn.py, _sinkhorn_stream.py,
_bwd.py and _edge_bwd.py), which take the stand-in and the `on_host` fixture from here,
so that no one file sets the length of a run of the tests over several
workers.

Tolerances: ICP statistics rtol 1e-4; the fused edge layers rtol 2e-4 plus
atol 2e-5 of the largest magnitude, as on the card, and their backward
kernels against autograd of the plain versions the same (the kernels add
the sources' gradients with atomics, in no fixed order); the scale
statistic rtol 1e-6.
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
from livingscenes_tpu_torch.ops import _cuda, cuda_icp, cuda_scale

CUDA_RUNTIME_STAND_IN = r'''// A stand-in for <cuda_runtime.h> that lets a host compiler build the port's
// kernels (livingscenes_tpu_torch/csrc/*.cu) and run them on CPU threads.
// It covers only what those sources use. The blocks of a launch run one
// after another, or, launched by cudaLaunchKernelEx in clusters, one
// cluster after another with the blocks of a cluster at the same time; the
// threads of a block are OS threads that meet at barriers: __syncthreads()
// is a barrier over the block, cluster.sync() one over the cluster's
// blocks, a warp shuffle a pair of barriers over the warp's 32 threads, so
// every thread of a warp must reach a shuffle, as on the card. atomicAdd on a float is a
// compare-and-swap loop on a std::atomic_ref (on a float4 four of them),
// on an unsigned a fetch_add;
// atomicMax on an unsigned a compare-and-swap loop;
// __threadfence a sequentially consistent fence (a counter in device memory
// is then seen by the blocks that follow). Dynamic shared memory is filled
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
struct alignas(8) float2 {
  float x, y;
};
inline float2 make_float2(float x, float y) { return float2{x, y}; }

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
// sm_90's atomicAdd on a float4 in global memory (one vector
// red.global.add.v4.f32): here four float atomics, each whole.
inline float4 atomicAdd(float4* address, float4 v) {
  float* p = reinterpret_cast<float*>(address);
  return make_float4(atomicAdd(p, v.x), atomicAdd(p + 1, v.y),
                     atomicAdd(p + 2, v.z), atomicAdd(p + 3, v.w));
}
inline unsigned atomicAdd(unsigned* address, unsigned v) {
  return std::atomic_ref<unsigned>(*address).fetch_add(v);
}
inline unsigned atomicMax(unsigned* address, unsigned v) {
  std::atomic_ref<unsigned> ref(*address);
  unsigned old = ref.load();
  while (old < v && !ref.compare_exchange_weak(old, v)) {
  }
  return old;
}
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

namespace cuda_emulation {

// One block of the running cluster: its barrier, its warps' barriers and
// shuffle slots, its dynamic shared memory.
struct Block {
  std::unique_ptr<std::barrier<>> barrier;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<uint64_t> slots;
  float* shared = nullptr;
};

inline thread_local dim3 thread_idx, block_idx;
inline thread_local unsigned block_rank = 0;  // within the cluster
inline thread_local Block* block = nullptr;
inline thread_local float* dynamic_shared = nullptr;
inline dim3 grid_dim, block_dim;
inline unsigned cluster_size = 1;
inline std::vector<Block> cluster_blocks;
inline std::unique_ptr<std::barrier<>> cluster_barrier;

inline void poison(float* shared, size_t bytes) {
  for (size_t i = 0; i < bytes / sizeof(float); ++i) shared[i] = NAN;
}

// Run `body` once per (block, thread) of the launch. The clusters of
// `cluster` consecutive blocks along x run one after another; the blocks of
// one cluster run at the same time.
inline void launch(dim3 grid, dim3 block_shape, size_t shared_bytes,
                   const std::function<void()>& body, unsigned cluster = 1) {
  grid_dim = grid;
  block_dim = block_shape;
  cluster_size = cluster;
  const int threads = block_shape.x;
  const int warps = (threads + 31) / 32;
  cluster_blocks.clear();
  cluster_blocks.resize(cluster);
  for (Block& blk : cluster_blocks) {
    blk.barrier = std::make_unique<std::barrier<>>(threads);
    for (int w = 0; w < warps; ++w)
      blk.warps.push_back(
          std::make_unique<std::barrier<>>(std::min(32, threads - 32 * w)));
    blk.slots.assign(warps * 32, 0);
    blk.shared = static_cast<float*>(
        std::aligned_alloc(64, (shared_bytes / 64 + 2) * 64));
    poison(blk.shared, shared_bytes);
  }
  cluster_barrier = std::make_unique<std::barrier<>>(threads * cluster);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < threads * cluster; ++t)
    pool.emplace_back([&, t] {
      thread_idx = dim3(t % threads);
      block_rank = t / threads;
      block = &cluster_blocks[block_rank];
      dynamic_shared = block->shared;
      for (unsigned by = 0; by < grid.y; ++by)
        for (unsigned bx = 0; bx < grid.x; bx += cluster) {
          block_idx = dim3(bx + block_rank, by);
          body();
          cluster_barrier->arrive_and_wait();
          if (thread_idx.x == 0) poison(block->shared, shared_bytes);
          cluster_barrier->arrive_and_wait();
        }
    });
  for (auto& th : pool) th.join();
  for (Block& blk : cluster_blocks) std::free(blk.shared);
  cluster_blocks.clear();
}

// Every lane's v folded with `op` over the warp's lanes, for each lane.
template <class T, class Op>
inline T warp_reduce(T v, Op op) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const int t = thread_idx.x, w = t / 32;
  const int lanes = std::min(32, (int)block_dim.x - 32 * w);
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  block->slots[t] = raw;
  block->warps[w]->arrive_and_wait();
  T out;
  std::memcpy(&out, &block->slots[w * 32], sizeof(T));
  for (int l = 1; l < lanes; ++l) {
    T other;
    std::memcpy(&other, &block->slots[w * 32 + l], sizeof(T));
    out = op(out, other);
  }
  block->warps[w]->arrive_and_wait();
  return out;
}

template <class T>
inline T exchange(T v, int source_lane) {
  static_assert(sizeof(T) <= sizeof(uint64_t));
  const int t = thread_idx.x, w = t / 32;
  uint64_t raw = 0;
  std::memcpy(&raw, &v, sizeof(T));
  block->slots[t] = raw;
  block->warps[w]->arrive_and_wait();
  if (source_lane >= 0 && source_lane < 32 &&
      w * 32 + source_lane < (int)block_dim.x)
    raw = block->slots[w * 32 + source_lane];
  block->warps[w]->arrive_and_wait();
  T out;
  std::memcpy(&out, &raw, sizeof(T));
  return out;
}

}  // namespace cuda_emulation

#define threadIdx cuda_emulation::thread_idx
#define blockIdx cuda_emulation::block_idx
// (not macros: cudaLaunchConfig_t has members of these names)
inline const dim3& gridDim = cuda_emulation::grid_dim;
inline const dim3& blockDim = cuda_emulation::block_dim;

inline void __syncthreads() { cuda_emulation::block->barrier->arrive_and_wait(); }
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
inline void __syncwarp(unsigned = 0xffffffffu) {
  cuda_emulation::block->warps[threadIdx.x / 32]->arrive_and_wait();
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return cuda_emulation::warp_reduce(v, [](unsigned a, unsigned b) { return std::max(a, b); });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return cuda_emulation::warp_reduce(v, [](unsigned a, unsigned b) { return std::min(a, b); });
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, sizeof u);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, sizeof f);
  return f;
}
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
// cp.async through the pipeline primitives of <cuda_pipeline.h>: here a
// copy done at once, with the zero fill of the last `zfill` bytes; commit
// and wait have nothing left to do. A kernel that reads a buffer before
// its wait and barrier is not caught.
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size,
                                    size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + size - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
// A load past L1 (ld.global.cg): a plain load here.
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}

// The device: an H100's 132 SMs.
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 132;
  return cudaSuccess;
}

// cudaLaunchKernelEx with a cluster dimension along x: the blocks of each
// cluster run at the same time (cuda_emulation::launch).
enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
union cudaLaunchAttributeValue {
  struct {
    unsigned x, y, z;
  } clusterDim;
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  cudaLaunchAttributeValue val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
template <class... P, class... A>
inline cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                                      void (*kernel)(P...), A&&... args) {
  unsigned cluster = 1;
  for (unsigned i = 0; i < cfg->numAttrs; ++i)
    if (cfg->attrs[i].id == cudaLaunchAttributeClusterDimension)
      cluster = cfg->attrs[i].val.clusterDim.x;
  if (cluster == 0 || cfg->gridDim.x % cluster != 0) return cudaErrorInvalidValue;
  cuda_emulation::launch(cfg->gridDim, cfg->blockDim, cfg->dynamicSmemBytes,
                         [&] { kernel(args...); }, cluster);
  return cudaSuccess;
}

// The cluster of cooperative_groups: sync() a barrier over every thread of
// the cluster's blocks.
namespace cooperative_groups {
struct cluster_group {
  void sync() const { cuda_emulation::cluster_barrier->arrive_and_wait(); }
  unsigned block_rank() const { return cuda_emulation::block_rank; }
  unsigned num_blocks() const { return cuda_emulation::cluster_size; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
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

    return re.sub(r"([\w:]+(?:<[\w, ]+>)?)<<<(.*?)>>>\(\s*(.*?)\);", launch,
                  text, flags=re.S)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The kernels' library built for the host, bound like the real one."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    work = tmp_path_factory.mktemp("cuda_emulation")
    (work / "cuda_runtime.h").write_text(CUDA_RUNTIME_STAND_IN)
    # the pipeline primitives (cp.async) and the cluster of
    # cooperative_groups are in the same stand-in
    for header in ("cuda_pipeline.h", "cooperative_groups.h"):
        (work / header).write_text('#pragma once\n#include "cuda_runtime.h"\n')
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
           "       static_cast<cudaStream_t>(s)>>>(x, f(y, z));\n"
           "g<P, CW><<<B, 32 * CW, bytes, st>>>(x);\n")
    out = rewrite_for_host(src)
    assert "float* smem = cuda_emulation::dynamic_shared;" in out
    assert ("cuda_emulation::launch(dim3(a, b), kT, n * sizeof(float), "
            "[&] { k<8>(x, f(y, z)); });") in out
    assert "cuda_emulation::launch(B, 32 * CW, bytes, [&] { g<P, CW>(x); });" in out
    assert "<<<" not in out


@pytest.mark.parametrize(
    "n,m,tied",
    [
        (300, 130, False),  # sources fill no whole block, targets no warp split
        (129, 1100, False),  # two target tiles, one source past a block
        (256, 128, True),   # exact ties: sources at half-integer offsets
        (5, 3, False),      # fewer targets than warps: most splits empty
    ],
)
def test_icp_stats_kernel(on_host, n, m, tied):
    rng = np.random.default_rng(3)
    x, src, tgt = f32(rng, 3, n, 3), f32(rng, 3, n, 3), f32(rng, 3, m, 3)
    if tied:
        # a lattice of targets; each source is equally near 2, 4 or 8 of them
        tgt[2] = lattice(rng, (8, 4, 4))
        x[2] = torch.as_tensor(
            rng.integers(-3, 3, (n, 3)) + 0.5 * rng.integers(0, 2, (n, 3)),
            dtype=torch.float32)
    active = torch.tensor([True, False, True])
    got, again = (cuda_icp.icp_stats_cuda(x, src, tgt, active) for _ in range(2))
    want = cuda_icp.icp_stats_plain(x, src, tgt, active)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert not any(bool(g[1].any()) for g in got)
    # fixed-order sums: the same bits on every launch
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # the last block of each pair set its counter back to 0 for the next call
    assert not bool(cuda_icp.pair_counters(x, 3).any())


@pytest.mark.parametrize("N,K,O", [(40, 16, 32), (33, 8, 48), (18, 16, 132),
                                   (4200, 5, 4)])  # the cloud past 48 KB
def test_layer0_kernel(on_host, N, K, O):
    rng = np.random.default_rng(4)
    xyz = f32(rng, 2, N, 3)
    idx = torch.as_tensor(rng.integers(0, N, (2, N, K)))
    W, D = f32(rng, O, 3, scale=0.5), f32(rng, O, O, scale=0.2)
    assert_close(cuda_layer0.fused_layer0_edge_mean_cuda(xyz, idx, W, D),
                 cuda_layer0.fused_layer0_edge_mean_plain(xyz, idx, W, D))


def test_layer0_kernel_origin(on_host):
    # a destination at the origin (the clamp of |dst|: dst^ = 0) that is
    # also every point's first neighbour; O = 8: 128 points a block
    rng = np.random.default_rng(22)
    xyz = f32(rng, 2, 150, 3)
    xyz[1, 3] = 0.0
    idx = torch.as_tensor(rng.integers(0, 150, (2, 150, 7)))
    idx[1, :, 0] = 3
    W, D = f32(rng, 8, 3, scale=0.5), f32(rng, 8, 8, scale=0.2)
    before = cuda_layer0.launches
    assert_close(cuda_layer0.fused_layer0_edge_mean_cuda(xyz, idx, W, D),
                 cuda_layer0.fused_layer0_edge_mean_plain(xyz, idx, W, D))
    assert cuda_layer0.launches - before == 1


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K",
    [
        (50, 50, 32, 32, 16),  # the widths of layer 1: 32 points a block
        (40, 21, 16, 48, 8),
        (30, 5, 36, 140, 7),   # 7 points a block, 245 of 256 threads
        (60, 50, 8, 24, 16),   # 42 points a block: the second partial
        (30, 70, 6, 4, 3),     # Nd > Ns, O = 4: 256 points a block; C % 4
        (20, 3, 128, 256, 11),  # one point a block of 64 threads
    ],
)
def test_mean_edge_kernel(on_host, Ns, Nd, C, O, K):
    rng = np.random.default_rng(5)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = torch.as_tensor(rng.integers(0, Ns, (2, Nd, K)))
    W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
    before = (cuda_attention.mean_launches,
              cuda_attention.mean_products_launches)
    assert_close(cuda_attention.fused_edge_mean_cuda(src, dst, idx, W, D),
                 cuda_attention.fused_edge_mean_plain(src, dst, idx, W, D))
    # the products' two launches, then the edge pass
    assert (cuda_attention.mean_launches - before[0],
            cuda_attention.mean_products_launches - before[1]) == (1, 2)


@pytest.mark.parametrize(
    "Ns,Nd,C,O",
    [
        (40, 21, 12, 8),     # narrowest: one 64-wide column tile, 16 used
        (300, 7, 36, 64),    # 7 row tiles of sources, the last partial
        (5, 130, 132, 144),  # depth 132: a partial slice; five column tiles
        (17, 9, 6, 4),       # C no multiple of 4
    ],
)
def test_mean_products_kernel(on_host, Ns, Nd, C, O):
    rng = np.random.default_rng(20)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    W_l, W_delta = f32(rng, O, C, scale=0.2), f32(rng, O, C, scale=0.2)
    D = f32(rng, O, O, scale=0.2)
    args = (src, dst, W_l, W_delta, D)
    assert_all_close(cuda_attention.mean_point_products_cuda(*args),
                     cuda_attention.mean_point_products_plain(*args))


@pytest.mark.parametrize(
    "Ns,Nd,C,O",
    [
        (40, 21, 12, 8),     # narrowest: one 64-wide column tile, 32 used
        (300, 7, 36, 64),    # 15 row tiles of sources, the last partial
        (5, 130, 132, 144),  # depth 132: a partial slice; five column tiles
    ],
)
def test_attention_products_kernel(on_host, Ns, Nd, C, O):
    rng = np.random.default_rng(14)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    W_l, W_delta = f32(rng, 2 * O, C, scale=0.2), f32(rng, 2 * O, C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    args = (src, dst, W_l, W_delta, D_K, D_V)
    assert_all_close(cuda_attention.attention_point_products_cuda(*args),
                     cuda_attention.attention_point_products_plain(*args))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [
        (40, 20, 32, 64, 16, 16),   # the width of attention layers 2-3
        (40, 7, 16, 32, 8, 16),     # ragged last block, K < 16
        (24, 3, 20, 144, 5, 8),     # two output tiles, the second partial
        (20, 3, 128, 256, 16, 16),  # the width of attention layer 5
        (30, 11, 12, 8, 5, 4),      # O = 8: two heads of 4 channels
        (60, 50, 8, 24, 16, 8),     # 42 points a block: the second partial
        (30, 70, 12, 16, 3, 16),    # Nd > Ns, one head, K = 3
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


@pytest.mark.parametrize(
    "N,k,tied",
    [(100, 5, False), (150, 5, True), (7, 5, False), (64, 8, False),
     (1100, 5, True)])  # three column chunks of 512, the last ragged
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


def assert_all_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert_close(g, w)
