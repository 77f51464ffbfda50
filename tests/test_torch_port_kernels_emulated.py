"""The port's CUDA sources run on CPU threads and held against their plain
PyTorch versions.

There is no card and no nvcc where these tests run, so the kernels' own code
(livingscenes_tpu_torch/csrc/*.cu) is compiled by the host's g++ against a
stand-in for the CUDA runtime (CUDA_RUNTIME_STAND_IN below, written out as
the `cuda_runtime.h` the sources include: blocks one after another, a
block's threads as fibers run in turns between barriers, barriers for
__syncthreads and the warp shuffles, a check of every store and of every
load from shared memory (from device memory too in a cluster launch) for
a race with another thread of the block or of its cluster, dynamic shared
memory poisoned with NaN; the warp reductions, cp.async and its waits; cudaLaunchKernelEx with a cluster dimension, whose
blocks run at the same time and share cluster.sync()). Only the launches
`kernel<<<grid, block, shared, stream>>>(...)` and the `__shared__`
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
import fcntl
import hashlib
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
from livingscenes_tpu_torch.ops import _cuda, cuda_icp, cuda_scale
from torch_threads import intra_op_share  # noqa: F401 (autouse)

CUDA_RUNTIME_STAND_IN = r'''// A stand-in for <cuda_runtime.h> that lets a host compiler build the port's
// kernels (livingscenes_tpu_torch/csrc/*.cu) and run them on the CPU.
// It covers only what those sources use. The blocks of a launch run one
// after another, or, launched by cudaLaunchKernelEx in clusters, one
// cluster after another with the blocks of a cluster at the same time; the
// threads of a block meet at barriers: __syncthreads()
// is a barrier over the block, cluster.sync() one over the cluster's
// blocks, a warp shuffle a pair of barriers over the warp's 32 threads, so
// every thread of a warp must reach a shuffle, as on the card. The
// threads are fibers that the launching OS thread runs in turns, each
// until it meets a barrier (a thread that spins on another's write without
// a barrier never lets it run). They never overlap, so a plain += where
// the kernel needs an atomic loses no update here, and a load of another
// thread's store that lacks its barrier may see the value all the same:
// the race check below names both, as it names any two accesses to one
// word by two threads of a block (or two blocks of a cluster) that no
// barrier orders, one of them a store. atomicAdd on a float is a
// compare-and-swap loop on a std::atomic_ref (on a float4 four of them),
// on an unsigned a fetch_add;
// atomicMax on an unsigned a compare-and-swap loop;
// __threadfence a sequentially consistent fence (a counter in device memory
// is then seen by the blocks that follow). Dynamic shared memory is filled
// with NaN before every block: a kernel that reads shared memory it never
// wrote shows up as a wrong answer. This says nothing about whether nvcc
// accepts a source, about alignment faults, or about speed.
#pragma once
#include <sys/mman.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

// Everything below but the sources' own entry points is internal to the
// library: its calls and variables need no indirection (the hooks run for
// every load and store).
#pragma GCC visibility push(hidden)

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
enum {
  cudaSuccess = 0,
  cudaErrorInvalidValue = 1,
  cudaErrorNotSupported = 801,
  cudaErrorRace = 999
};
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) {
  return cudaSuccess;
}

using std::max;
using std::min;
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }

#ifndef __x86_64__
#error "the stand-in switches between its fibers by x86-64 assembly"
#endif

// Stand-in code that the CUDA threads run and whose stores are its own
// bookkeeping, not the kernel's: left out of the race check below.
#define CUDA_EMULATION_UNTRACKED __attribute__((no_sanitize_thread))

namespace cuda_emulation {

// A barrier of the fibers below: each arriving fiber but the last waits
// until the phase moves; the last moves it and goes on.
struct Barrier {
  explicit Barrier(int n) : expected(n) {}
  void arrive_and_wait();
  int expected, arrived = 0;
  unsigned phase = 0;
};

// One access to a 4-byte word, for the race check below: by thread
// `thread` - 1 (0: none) of the cluster's block `rank`, at these phases of
// the block's barrier, the cluster's and the thread's warp's.
enum Kind : uint8_t { kPlain, kVolatile, kAtomic };
struct Access {
  uint16_t thread;
  uint8_t rank;
  Kind kind;
  unsigned block_phase, cluster_phase, warp_phase;
};
// A word's last store (plain or atomic) and its last two readers, two
// different threads: a store after loads by several threads meets at
// least one load that is not its own.
struct Word {
  Access store, load, other_load;
};

// One block of the running cluster: its barrier, its warps' barriers and
// shuffle slots, its dynamic shared memory and that memory's words.
struct Block {
  std::unique_ptr<Barrier> barrier;
  std::vector<std::unique_ptr<Barrier>> warps;
  std::vector<uint64_t> slots;
  std::vector<Barrier*> warp_barriers;  // the warps' barriers, for the race check
  float* shared = nullptr;
  Word* words = nullptr;
};

inline dim3 thread_idx, block_idx;
inline unsigned block_rank = 0;  // within the cluster
inline Block* block = nullptr;
inline float* dynamic_shared = nullptr;
inline dim3 grid_dim, block_dim;
inline size_t shared_span = 0;  // the launch's dynamic shared bytes, whole words
inline unsigned cluster_size = 1;
inline std::vector<Block> cluster_blocks;
inline std::unique_ptr<Barrier> cluster_barrier;

// Switching between fibers: the callee-saved registers pushed on the
// fiber's own stack, which holds its stack pointer. (ucontext's
// swapcontext, which also saves and sets the signal mask by a system call,
// made the emulated tests 4.3 times slower.)
extern "C" void cuda_emulation_switch(void** save_sp, void* load_sp);
__asm__(R"(
  .pushsection .text
  .weak cuda_emulation_switch
  .hidden cuda_emulation_switch
  .type cuda_emulation_switch, @function
cuda_emulation_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size cuda_emulation_switch, .-cuda_emulation_switch
  .popsection
)");
struct Context {
  void* sp = nullptr;
};
inline void switch_context(Context& from, Context& to) {
  cuda_emulation_switch(&from.sp, to.sp);
}
// A stack whose first switch "returns" into entry, which must not return.
inline void make_context(Context& c, void* stack, size_t size, void (*entry)()) {
  uintptr_t top = (reinterpret_cast<uintptr_t>(stack) + size) & ~uintptr_t(15);
  void** sp = reinterpret_cast<void**>(top);
  *--sp = nullptr;  // entry's own return address, never used
  *--sp = reinterpret_cast<void*>(entry);
  for (int i = 0; i < 6; ++i) *--sp = nullptr;  // rbp, rbx, r12-r15
  c.sp = sp;
}

// A CUDA thread: a fiber with a stack of its own, run by the scheduler in
// `run_threads` on the launching OS thread until it waits at a barrier or
// ends.
struct Fiber {
  Context ctx;
  dim3 tidx, bidx;
  unsigned rank = 0;
  const Barrier* waiting = nullptr;
  unsigned wait_phase = 0;
  bool done = false;
};
constexpr size_t kFiberStack = size_t(1) << 20;
inline std::vector<Fiber> fibers;
inline std::vector<void*> stacks;  // kept from launch to launch
inline size_t current = 0;
inline Context scheduler;
inline const std::function<void()>* fiber_main = nullptr;

CUDA_EMULATION_UNTRACKED inline void Barrier::arrive_and_wait() {
  if (++arrived == expected) {
    arrived = 0;
    ++phase;
    return;
  }
  Fiber& f = fibers[current];
  f.waiting = this;
  f.wait_phase = phase;
  f.bidx = block_idx;
  switch_context(f.ctx, scheduler);
}

CUDA_EMULATION_UNTRACKED inline void fiber_entry() {
  (*fiber_main)();
  fibers[current].done = true;
  switch_context(fibers[current].ctx, scheduler);  // never resumed
  std::abort();
}

// The race check. The sources are built with -fsanitize=thread and
// --param=tsan-distinguish-volatile=1, which make the compiler call a hook
// before every plain load and store and before every volatile one, and
// are linked without that sanitizer's runtime: the hooks are below. Two
// accesses to one 4-byte word race when one of them is a store and no
// barrier orders them: two threads of a block at the same phase of the
// block's barrier and of the cluster's (in one warp, also of the warp's),
// or two blocks of one cluster at the same phase of the cluster's barrier
// (they run at the same time on the card as here). On the card the
// threads run at the same time: a store may be lost (a sum made by +=
// where it needs an atomic), a load may see the word before or after
// another thread's store (a read of a tile before its barrier), a store
// may land before another thread's load (a double buffer refilled too
// early). Here the fibers run in turns, so the check goes by the phases,
// not by what the values came out as:
//   - a store meets the word's last store and its last two loads by other
//     threads; a load meets its last store;
//   - atomics are not plain stores: two atomics never race, an atomic and
//     a plain load or store do;
//   - a volatile load (`*(volatile T*)p`) that meets only atomics is an
//     intended relaxed read and no race. The sources read so only a
//     monotone bound that other threads raise by atomicMax (pair_scan.cuh's
//     block threshold): any value the word ever holds is backed by a lane's
//     own entries, and a stale one only prunes less, so the result does
//     not depend on which value the load sees. A volatile load that meets
//     a plain store races like any other.
// Watched: all of dynamic and static shared memory; stores and atomics
// anywhere but a thread's own stack; loads of device memory only in a
// cluster launch (where blocks exchange data through it; loads of device
// memory in other launches would cost a lookup for each read of an input
// and can meet only the stores of their own block). Blocks that are not in
// one cluster are not compared: here they run in turn, and on the card a
// fence and a counter order what they exchange. A launch's first races are
// printed, and cudaGetLastError() then returns cudaErrorRace.
// The records of device memory: an open-addressing table by word address
// (linear probing, doubled at half full); a slot holds a word of this
// launch when its `launch` is the launch's count, so nothing is cleared.
struct DeviceWords {
  uintptr_t* keys = nullptr;
  unsigned* launch = nullptr;
  Word* words = nullptr;
  size_t mask = 0, used = 0;
};
inline DeviceWords device_words;
// A static __shared__ array (one per process here, one per block on the
// card) and its words.
struct StaticShared {
  uintptr_t base, bytes;
  Word* words;
};
constexpr unsigned kMaxStaticShared = 64;
inline StaticShared static_shared_arrays[kMaxStaticShared];
inline unsigned static_shared_count = 0, launch_count = 0;
// The arrays that the running launch has declared, their words cleared at
// the first declaration, and the span from the lowest of them to the end
// of the highest: a kernel has a few, and one compare tells device memory
// apart from all of them.
inline StaticShared* launch_arrays[kMaxStaticShared];
inline unsigned launch_array_count = 0;
inline uintptr_t launch_arrays_lo = 0, launch_arrays_hi = 0;
inline bool watching = false;
inline unsigned races = 0, refused = 0;
// The running fiber's stack and barriers, as plain pointers: the hooks
// below call no instrumented code (the standard library's is), so they
// never run again inside themselves.
inline uintptr_t stack_now = 0;
inline Barrier *block_barrier_now = nullptr, *cluster_barrier_now = nullptr;
inline Barrier* const* warp_barriers_now = nullptr;

// Before the first use of a static __shared__ array (rewrite_for_host puts
// a call after each declaration). Its blocks would share it in a cluster
// launch here: such a launch is refused.
CUDA_EMULATION_UNTRACKED inline void static_shared(const void* p, size_t bytes) {
  if (cluster_size > 1 && !refused++)
    std::fprintf(stderr,
                 "cuda_emulation: a cluster launch of a kernel with static "
                 "__shared__ memory, which its blocks would share here\n");
  const uintptr_t a = reinterpret_cast<uintptr_t>(p), base = a & ~uintptr_t(3);
  for (unsigned i = 0; i < launch_array_count; ++i)
    if (launch_arrays[i]->base == base) return;
  StaticShared* s = nullptr;
  for (unsigned i = 0; i < static_shared_count && !s; ++i)
    if (static_shared_arrays[i].base == base) s = &static_shared_arrays[i];
  if (!s) {
    if (static_shared_count == kMaxStaticShared) std::abort();
    const uintptr_t span = ((a + bytes + 3) & ~uintptr_t(3)) - base;
    s = &static_shared_arrays[static_shared_count++];
    *s = {base, span, static_cast<Word*>(std::malloc(span / 4 * sizeof(Word)))};
  }
  std::memset(static_cast<void*>(s->words), 0, s->bytes / 4 * sizeof(Word));
  launch_arrays_lo = launch_array_count ? std::min(launch_arrays_lo, base) : base;
  launch_arrays_hi = std::max(launch_arrays_hi, base + s->bytes);
  launch_arrays[launch_array_count++] = s;
}

// The records of shared memory from the word at w on, or null outside it.
CUDA_EMULATION_UNTRACKED inline Word* shared_words(uintptr_t w) {
  const uintptr_t dyn = reinterpret_cast<uintptr_t>(block->shared);
  if (w - dyn < shared_span) return &block->words[(w - dyn) / 4];
  if (w - launch_arrays_lo >= launch_arrays_hi - launch_arrays_lo) return nullptr;
  for (unsigned i = 0; i < launch_array_count; ++i) {
    const StaticShared& s = *launch_arrays[i];
    if (w - s.base < s.bytes) return &s.words[(w - s.base) / 4];
  }
  return nullptr;
}

// Whether o, an earlier access, and s may happen at the same time on the
// card.
CUDA_EMULATION_UNTRACKED inline bool concurrent(const Access& o, const Access& s) {
  if (!o.thread || o.cluster_phase != s.cluster_phase) return false;
  if (o.rank != s.rank) return true;
  return o.thread != s.thread && o.block_phase == s.block_phase &&
         ((o.thread - 1) / 32 != (s.thread - 1) / 32 || o.warp_phase == s.warp_phase);
}

CUDA_EMULATION_UNTRACKED inline void report(const char* what, const Access& o,
                                            const Access& s, uintptr_t w) {
  if (races++ >= 4) return;
  const unsigned bx = block_idx.x, by = block_idx.y;
  if (o.rank == s.rank)
    std::fprintf(stderr,
                 "cuda_emulation: race: %s: threads %u and %u of block (%u, %u), "
                 "word %p, with no barrier between\n",
                 what, o.thread - 1, s.thread - 1, bx, by, reinterpret_cast<void*>(w));
  else
    std::fprintf(stderr,
                 "cuda_emulation: race: %s: thread %u of block (%u, %u) and thread %u "
                 "of block (%u, %u) of one cluster, word %p, with no cluster barrier "
                 "between\n",
                 what, o.thread - 1, bx - s.rank + o.rank, by, s.thread - 1, bx, by,
                 reinterpret_cast<void*>(w));
}

CUDA_EMULATION_UNTRACKED inline size_t device_slot(const DeviceWords& t, uintptr_t w) {
  size_t i = ((w >> 2) * 0x9E3779B97F4A7C15ull >> 17) & t.mask;
  while (t.launch[i] == launch_count && t.keys[i] != w) i = (i + 1) & t.mask;
  return i;
}

// The record of the device-memory word at w, a fresh one at its first
// access in the launch.
CUDA_EMULATION_UNTRACKED inline Word* device_word(uintptr_t w) {
  DeviceWords& t = device_words;
  if (2 * (t.used + 1) > t.mask + 1) {
    DeviceWords g;
    g.mask = t.mask ? 2 * t.mask + 1 : (size_t(1) << 16) - 1;
    g.keys = static_cast<uintptr_t*>(std::malloc((g.mask + 1) * sizeof(uintptr_t)));
    g.launch = static_cast<unsigned*>(std::calloc(g.mask + 1, sizeof(unsigned)));
    g.words = static_cast<Word*>(std::malloc((g.mask + 1) * sizeof(Word)));
    if (!g.keys || !g.launch || !g.words) std::abort();
    for (size_t i = 0; t.mask && i <= t.mask; ++i)
      if (t.launch[i] == launch_count) {
        const size_t j = device_slot(g, t.keys[i]);
        g.keys[j] = t.keys[i];
        g.launch[j] = launch_count;
        g.words[j] = t.words[i];
        ++g.used;
      }
    std::free(t.keys);
    std::free(t.launch);
    std::free(t.words);
    t = g;
  }
  const size_t i = device_slot(t, w);
  if (t.launch[i] != launch_count) {
    t.keys[i] = w;
    t.launch[i] = launch_count;
    t.words[i] = Word{};
    ++t.used;
  }
  return &t.words[i];
}

// An access of n bytes at p by the running thread: a store (plain or
// atomic) or a load (plain or volatile).
CUDA_EMULATION_UNTRACKED inline void on_access(const void* p, size_t n, Kind kind,
                                               bool store) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (!watching || !n || a - stack_now < kFiberStack) return;
  // an access lies in one array: shared memory or device memory
  const uintptr_t w0 = a & ~uintptr_t(3);
  Word* const words = shared_words(w0);
  if (!words && !store && cluster_size == 1) return;
  const unsigned t = thread_idx.x;
  const Access s{uint16_t(t + 1), uint8_t(block_rank), kind, block_barrier_now->phase,
                 cluster_barrier_now->phase, warp_barriers_now[t / 32]->phase};
  for (uintptr_t w = w0; w < a + n; w += 4) {
    Word* const r = words ? words + (w - w0) / 4 : device_word(w);
    if (store) {
      if (concurrent(r->store, s) && (kind != kAtomic || r->store.kind != kAtomic))
        report(kind == kAtomic || r->store.kind == kAtomic ? "an atomic and a store"
                                                           : "two stores",
               r->store, s, w);
      if (concurrent(r->load, s) && (kind != kAtomic || r->load.kind == kPlain))
        report("a load, then another thread's store", r->load, s, w);
      if (concurrent(r->other_load, s) && (kind != kAtomic || r->other_load.kind == kPlain))
        report("a load, then another thread's store", r->other_load, s, w);
      r->store = s;
    } else {
      if (concurrent(r->store, s) && (kind == kPlain || r->store.kind != kAtomic))
        report(r->store.kind == kAtomic ? "an atomic, then a plain load"
                                        : "a store, then another thread's load",
               r->store, s, w);
      if (r->load.thread != s.thread) r->other_load = r->load;
      r->load = s;
    }
  }
}

// Run `thread_main` as thread t of block t / threads of the cluster, for
// each of the n = threads * cluster threads. The scheduler runs every
// fiber that is not waiting until it waits or ends, in turns that go
// through the threads forward and backward alternately, so that a read of
// another thread's write that lacks its barrier sees the poison or an old
// value in one of the two orders.
CUDA_EMULATION_UNTRACKED inline void run_threads(size_t n, unsigned threads,
                        const std::function<void()>& thread_main) {
  fiber_main = &thread_main;
  while (stacks.size() < n) {
    void* st = mmap(nullptr, kFiberStack, PROT_READ | PROT_WRITE,
                    MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE | MAP_STACK, -1, 0);
    if (st == MAP_FAILED) std::abort();
    stacks.push_back(st);
  }
  fibers.assign(n, Fiber());
  for (size_t t = 0; t < n; ++t) {
    Fiber& f = fibers[t];
    f.tidx = dim3(t % threads);
    f.rank = t / threads;
    make_context(f.ctx, stacks[t], kFiberStack, fiber_entry);
  }
  size_t live = n;
  for (bool forward = true; live; forward = !forward) {
    bool ran = false;
    for (size_t k = 0; k < n; ++k) {
      const size_t i = forward ? k : n - 1 - k;
      Fiber& f = fibers[i];
      if (f.done || (f.waiting && f.waiting->phase == f.wait_phase)) continue;
      f.waiting = nullptr;
      current = i;
      thread_idx = f.tidx;
      block_idx = f.bidx;
      block_rank = f.rank;
      block = &cluster_blocks[f.rank];
      dynamic_shared = block->shared;
      stack_now = reinterpret_cast<uintptr_t>(stacks[i]);
      block_barrier_now = block->barrier.get();
      warp_barriers_now = block->warp_barriers.data();
      cluster_barrier_now = cluster_barrier.get();
      watching = true;
      switch_context(scheduler, f.ctx);
      watching = false;
      ran = true;
      live -= f.done;
    }
    if (!ran) {
      std::fprintf(stderr, "cuda_emulation: every thread waits at a barrier\n");
      std::abort();
    }
  }
  fibers.clear();
}

CUDA_EMULATION_UNTRACKED inline void poison(float* shared, size_t bytes) {
  for (size_t i = 0; i < bytes / sizeof(float); ++i) shared[i] = NAN;
}

CUDA_EMULATION_UNTRACKED inline void enter_block(unsigned bx, unsigned by) {
  block_idx = dim3(bx, by);
}

// Run `body` once per (block, thread) of the launch. The clusters of
// `cluster` consecutive blocks along x run one after another; the blocks of
// one cluster run at the same time.
inline void launch(dim3 grid, dim3 block_shape, size_t shared_bytes,
                   const std::function<void()>& body, unsigned cluster = 1) {
  device_words.used = 0;
  ++launch_count;
  launch_array_count = 0;
  launch_arrays_lo = launch_arrays_hi = 0;
  grid_dim = grid;
  block_dim = block_shape;
  cluster_size = cluster;
  shared_span = (shared_bytes + 3) & ~size_t(3);
  const int threads = block_shape.x;
  const int warps = (threads + 31) / 32;
  cluster_blocks.clear();
  cluster_blocks.resize(cluster);
  for (Block& blk : cluster_blocks) {
    blk.barrier = std::make_unique<Barrier>(threads);
    for (int w = 0; w < warps; ++w) {
      blk.warps.push_back(std::make_unique<Barrier>(std::min(32, threads - 32 * w)));
      blk.warp_barriers.push_back(blk.warps.back().get());
    }
    blk.slots.assign(warps * 32, 0);
    blk.shared = static_cast<float*>(
        std::aligned_alloc(64, (shared_bytes / 64 + 2) * 64));
    poison(blk.shared, shared_bytes);
    blk.words = static_cast<Word*>(std::calloc(shared_span / 4 + 1, sizeof(Word)));
  }
  cluster_barrier = std::make_unique<Barrier>(threads * cluster);
  const std::function<void()> thread_main = [&] {
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; bx += cluster) {
        enter_block(bx + block_rank, by);
        body();
        cluster_barrier->arrive_and_wait();
        if (thread_idx.x == 0) poison(block->shared, shared_bytes);
        cluster_barrier->arrive_and_wait();
      }
  };
  run_threads(size_t(threads) * cluster, threads, thread_main);
  for (Block& blk : cluster_blocks) {
    std::free(blk.shared);
    std::free(blk.words);
  }
  cluster_blocks.clear();
}

// Every lane's v folded with `op` over the warp's lanes, for each lane.
template <class T, class Op>
CUDA_EMULATION_UNTRACKED inline T warp_reduce(T v, Op op) {
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
CUDA_EMULATION_UNTRACKED inline T exchange(T v, int source_lane) {
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

inline cudaError_t cudaGetLastError() {
  const unsigned races = cuda_emulation::races, refused = cuda_emulation::refused;
  cuda_emulation::races = cuda_emulation::refused = 0;
  return refused ? cudaErrorNotSupported : races ? cudaErrorRace : cudaSuccess;
}

// Atomics: a plain read-modify-write here (the fibers never overlap), and
// for the race check an atomic store.
inline float atomicAdd(float* address, float v) {
  cuda_emulation::on_access(address, sizeof *address, cuda_emulation::kAtomic, true);
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
  cuda_emulation::on_access(address, sizeof *address, cuda_emulation::kAtomic, true);
  return std::atomic_ref<unsigned>(*address).fetch_add(v);
}
inline unsigned atomicMax(unsigned* address, unsigned v) {
  cuda_emulation::on_access(address, sizeof *address, cuda_emulation::kAtomic, true);
  std::atomic_ref<unsigned> ref(*address);
  unsigned old = ref.load();
  while (old < v && !ref.compare_exchange_weak(old, v)) {
  }
  return old;
}

// The hooks that -fsanitize=thread calls: loads and stores, plain and
// volatile, go to the race check; atomics do what they stand for.
#define CUDA_EMULATION_HOOK extern "C" __attribute__((weak, no_sanitize_thread))
CUDA_EMULATION_HOOK void __tsan_init() {}
CUDA_EMULATION_HOOK void __tsan_func_entry(void*) {}
CUDA_EMULATION_HOOK void __tsan_func_exit() {}
#define CUDA_EMULATION_ACCESS_HOOKS(n)                                          \
  CUDA_EMULATION_HOOK void __tsan_read##n(void* p) {                           \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, false);             \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_write##n(void* p) {                          \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, true);              \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_volatile_read##n(void* p) {                  \
    cuda_emulation::on_access(p, n, cuda_emulation::kVolatile, false);          \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_volatile_write##n(void* p) {                 \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, true);              \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_unaligned_read##n(void* p) {                 \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, false);             \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_unaligned_write##n(void* p) {                \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, true);              \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_unaligned_volatile_read##n(void* p) {        \
    cuda_emulation::on_access(p, n, cuda_emulation::kVolatile, false);          \
  }                                                                             \
  CUDA_EMULATION_HOOK void __tsan_unaligned_volatile_write##n(void* p) {       \
    cuda_emulation::on_access(p, n, cuda_emulation::kPlain, true);              \
  }
CUDA_EMULATION_ACCESS_HOOKS(1)
CUDA_EMULATION_ACCESS_HOOKS(2)
CUDA_EMULATION_ACCESS_HOOKS(4)
CUDA_EMULATION_ACCESS_HOOKS(8)
CUDA_EMULATION_ACCESS_HOOKS(16)
CUDA_EMULATION_HOOK void __tsan_read_range(void* p, unsigned long n) {
  cuda_emulation::on_access(p, n, cuda_emulation::kPlain, false);
}
CUDA_EMULATION_HOOK void __tsan_write_range(void* p, unsigned long n) {
  cuda_emulation::on_access(p, n, cuda_emulation::kPlain, true);
}
CUDA_EMULATION_HOOK int __tsan_atomic32_load(const volatile int* a, int) {
  return __atomic_load_n(a, __ATOMIC_SEQ_CST);
}
CUDA_EMULATION_HOOK int __tsan_atomic32_fetch_add(volatile int* a, int v, int) {
  return __atomic_fetch_add(a, v, __ATOMIC_SEQ_CST);
}
CUDA_EMULATION_HOOK int __tsan_atomic32_compare_exchange_weak(volatile int* a, int* c,
                                                              int v, int, int) {
  return __atomic_compare_exchange_n(a, c, v, true, __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST);
}
CUDA_EMULATION_HOOK void __tsan_atomic_thread_fence(int) {
  __atomic_thread_fence(__ATOMIC_SEQ_CST);
}

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
// copy done at once, with the zero fill of the last `zfill` bytes, and for
// the race check a load and a store by the issuing thread when it issues
// the copy; commit and wait have nothing left to do. Another thread's read
// before the barrier is caught; one after the barrier but before the wait
// is not.
CUDA_EMULATION_UNTRACKED inline void __pipeline_memcpy_async(void* dst, const void* src,
                                                             size_t size, size_t zfill = 0) {
  cuda_emulation::on_access(src, size - zfill, cuda_emulation::kPlain, false);
  cuda_emulation::on_access(dst, size, cuda_emulation::kPlain, true);
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

#pragma GCC visibility pop
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
    """CUDA launch syntax and shared memory, as host C++: dynamic shared
    memory is the stand-in's block's; a static __shared__ array (a static
    here) is made known to the race check before its first use."""
    text = re.sub(r"extern __shared__ __align__\(16\) float (\w+)\[\];",
                  r"float* \1 = cuda_emulation::dynamic_shared;", text)
    text = re.sub(r"(__shared__\s+[\w:]+\s+(\w+)\s*(?:\[[^\]\n]*\]\s*)*;)",
                  r"\1 cuda_emulation::static_shared(&\2, sizeof \2);", text)

    def launch(m):
        grid, block, shared = _split_args(m.group(2))[:3]
        return (f"cuda_emulation::launch({grid}, {block}, {shared}, "
                f"[&] {{ {m.group(1)}({m.group(3)}); }});")

    return re.sub(r"([\w:]+(?:<[\w, ]+>)?)<<<(.*?)>>>\(\s*(.*?)\);", launch,
                  text, flags=re.S)


# the compiler's hooks on every load and store, the volatile ones apart, for
# the stand-in's race check, and none on function entry and exit (-Wno-tsan:
# its note that fences are not checked)
RACE_CHECK = ["-fsanitize=thread", "--param=tsan-distinguish-volatile=1",
              "--param=tsan-instrument-func-entry-exit=0", "-Wno-tsan"]


def emulated_library():
    """Build the kernels' library for the host once for every test file and
    xdist worker: into a directory of livingscenes_tpu_torch/_build/ (listed
    in .gitignore) named by a hash of the stand-in, the rewritten sources
    and the compiler's command, under a file lock. Each source compiles on
    its own process, all at once, with the same flags; then one link
    without -fsanitize=thread (the stand-in has its hooks)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    files = {"cuda_runtime.h": CUDA_RUNTIME_STAND_IN}
    # the pipeline primitives (cp.async) and the cluster of
    # cooperative_groups are in the same stand-in
    for header in ("cuda_pipeline.h", "cooperative_groups.h"):
        files[header] = '#pragma once\n#include "cuda_runtime.h"\n'
    for path in sorted(_cuda.CSRC.iterdir()):
        name = path.name.replace(".cu", ".cpp") if path.suffix == ".cu" else path.name
        files[name] = rewrite_for_host(path.read_text())
    flags = ["-std=c++20", "-O1", "-fPIC", "-pthread"]
    digest = hashlib.sha256(" ".join([gxx] + flags + RACE_CHECK).encode())
    for name, text in sorted(files.items()):
        digest.update(name.encode() + b"\0" + text.encode() + b"\0")
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = _cuda.BUILD_DIR / f"emulated_{digest.hexdigest()[:16]}"
    lib = work / "libemulated.so"
    with open(work.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            shutil.rmtree(work, ignore_errors=True)
            work.mkdir()
            for name, text in files.items():
                (work / name).write_text(text)
            objs = [work / s.replace(".cu", ".o") for s in _cuda.SOURCES]
            procs = [subprocess.Popen(
                [gxx, *flags, *RACE_CHECK, f"-I{work}", "-c", "-o", str(obj),
                 str(work / s.replace(".cu", ".cpp"))],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for s, obj in zip(_cuda.SOURCES, objs)]
            logs = [p.communicate()[0] for p in procs]
            failed = [log for p, log in zip(procs, logs) if p.returncode]
            assert not failed, failed[0][-4000:]
            tmp = work / "libemulated.so.tmp"
            done = subprocess.run([gxx, *flags, "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            assert done.returncode == 0, done.stderr[-4000:]
            os.replace(tmp, lib)
    return lib


def bind(lib):
    """The library at `lib`, its entry points typed like the real one's."""
    handle = ctypes.CDLL(str(lib))
    for name, argtypes in _cuda._SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


@pytest.fixture(scope="module")
def emulated():
    """The kernels' library built for the host, bound like the real one."""
    return bind(emulated_library())


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
           "g<P, CW><<<B, 32 * CW, bytes, st>>>(x);\n"
           "__align__(16) __shared__ float planes[2][3][kPlane];\n"
           "__shared__ bool last;\n")
    out = rewrite_for_host(src)
    assert "float* smem = cuda_emulation::dynamic_shared;" in out
    assert ("__align__(16) __shared__ float planes[2][3][kPlane]; "
            "cuda_emulation::static_shared(&planes, sizeof planes);") in out
    assert ("__shared__ bool last; cuda_emulation::static_shared(&last, sizeof last);"
            in out)
    assert ("cuda_emulation::launch(dim3(a, b), kT, n * sizeof(float), "
            "[&] { k<8>(x, f(y, z)); });") in out
    assert "cuda_emulation::launch(B, 32 * CW, bytes, [&] { g<P, CW>(x); });" in out
    assert "<<<" not in out


# A scatter of one block's edges into a few sums, the pattern of the
# sources' gradients in the backward kernels: with atomicAdd, and with the
# fault of a plain read-modify-write in its place.
PLANTED_SCATTER = r'''#include <cuda_runtime.h>

__global__ void scatter(const int* idx, const float* vals, float* sums,
                        int edges, int atomic) {
  for (int e = 0; e < edges; ++e) {
    const int i = threadIdx.x * edges + e;
    if (atomic) atomicAdd(&sums[idx[i]], vals[i]);
    else sums[idx[i]] += vals[i];
  }
}

extern "C" int planted_scatter(const int* idx, const float* vals, float* sums,
                               int threads, int edges, int atomic) {
  scatter<<<1, threads, 0, 0>>>(idx, vals, sums, edges, atomic);
  return (int)cudaGetLastError();
}
'''


def build_planted(tmp_path, source, name):
    """`source` built for the host against the stand-in, with the race
    check's flags, into a library under tmp_path; its function `name`."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernels for the host")
    (tmp_path / "cuda_runtime.h").write_text(CUDA_RUNTIME_STAND_IN)
    (tmp_path / "cooperative_groups.h").write_text(
        '#pragma once\n#include "cuda_runtime.h"\n')
    src, obj = tmp_path / f"{name}.cpp", tmp_path / f"{name}.o"
    lib = tmp_path / f"lib{name}.so"
    src.write_text(rewrite_for_host(source))
    for cmd in ([gxx, "-std=c++20", "-O1", "-fPIC", *RACE_CHECK, f"-I{tmp_path}", "-c",
                 "-o", str(obj), str(src)],
                [gxx, "-shared", "-o", str(lib), str(obj)]):
        done = subprocess.run(cmd, capture_output=True, text=True)
        assert done.returncode == 0, done.stderr[-4000:]
    return getattr(ctypes.CDLL(str(lib)), name)


def test_stand_in_finds_lost_updates(tmp_path):
    """The fibers never overlap, so the planted fault (a sum made without
    atomics) gives the right sum here; the race check must still name it
    (cudaErrorRace, 999), in every launch, and let the atomic scatter by."""
    fn = build_planted(tmp_path, PLANTED_SCATTER, "planted_scatter")
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
    threads, edges, n_sums = 64, 8, 4
    idx = np.random.default_rng(0).integers(0, n_sums, threads * edges).astype(np.int32)
    vals = np.ones(threads * edges, np.float32)
    want = np.bincount(idx, minlength=n_sums).astype(np.float32)
    for atomic, rc in ((1, 0), (0, 999), (1, 0), (0, 999)):
        sums = np.zeros(n_sums, np.float32)
        assert fn(idx.ctypes.data, vals.ctypes.data, sums.ctypes.data,
                  threads, edges, atomic) == rc
        np.testing.assert_array_equal(sums, want)


# Races of loads: each kernel with its barrier (`fixed` 1) and without it
# (0), the fault. 64 threads, two warps; the cluster case two blocks of one
# cluster. Which of a race's two accesses the check meets first follows
# from the scheduler's order (forward through the threads in its first
# round, backward in its second): each kernel is laid out so that the
# check meets the access its name says.
PLANTED_RACES = r'''#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// Each thread stores its word of shared memory, then loads its lower
// neighbour's.
__global__ void read_after_write(float* out, int fixed) {
  __shared__ float s[64];
  const int t = threadIdx.x;
  s[t] = (float)t;
  if (fixed) __syncthreads();
  out[t] = s[(t + 63) % 64];
}

// Each thread loads its lower neighbour's word, then stores its own: a
// buffer refilled while other threads still read it.
__global__ void write_after_read(float* out, int fixed) {
  __shared__ float s[64];
  const int t = threadIdx.x;
  s[t] = (float)t;
  __syncthreads();
  const float v = s[(t + 63) % 64];
  if (fixed) __syncthreads();
  s[t] = v + 64.0f;
  __syncthreads();
  out[t] = s[t];
}

// Lanes of one warp swap their words through shared memory.
__global__ void lane_to_lane(float* out, int fixed) {
  __shared__ float s[64];
  const int t = threadIdx.x;
  s[t] = (float)t;
  if (fixed) __syncwarp();
  out[t] = s[t ^ 1];
}

// The two blocks of a cluster swap their rows through device memory.
__global__ void cluster_exchange(float* buf, float* out, int fixed) {
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), t = threadIdx.x, T = blockDim.x;
  buf[r * T + t] = (float)(r * T + t);
  if (fixed) cluster.sync();
  out[r * T + t] = buf[(r ^ 1) * T + t];
}

// pair_scan.cuh's block threshold: each warp raises it by atomicMax, and
// every thread reads it with no barrier, volatile (kRelaxed) or plain.
template <bool kRelaxed>
__global__ void threshold(const unsigned* vals, unsigned* out) {
  __shared__ unsigned tt;
  if (threadIdx.x == 0) tt = 0u;
  __syncthreads();
  for (int round = 0; round < 4; ++round) {
    const unsigned wm =
        __reduce_max_sync(0xffffffffu, vals[round * blockDim.x + threadIdx.x]);
    unsigned tb;
    if (kRelaxed)
      tb = *reinterpret_cast<volatile unsigned*>(&tt);
    else
      tb = tt;
    if (threadIdx.x % 32 == 0 && wm > tb) atomicMax(&tt, wm);
  }
  __syncthreads();
  if (threadIdx.x == 0) *out = tt;
}

// A cluster kernel with static shared memory, which the stand-in refuses.
__global__ void cluster_static(float* out, int) {
  __shared__ float s[64];
  s[threadIdx.x] = 1.0f;
  __syncthreads();
  out[threadIdx.x] = s[threadIdx.x];
}

extern "C" int planted_race(int which, int fixed, const unsigned* vals,
                            float* buf, float* out) {
  if (which == 0) read_after_write<<<1, 64, 0, 0>>>(out, fixed);
  if (which == 1) write_after_read<<<1, 64, 0, 0>>>(out, fixed);
  if (which == 2) lane_to_lane<<<1, 64, 0, 0>>>(out, fixed);
  if (which == 3 || which == 5) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(64);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err =
        which == 3 ? cudaLaunchKernelEx(&cfg, cluster_exchange, buf, out, fixed)
                   : cudaLaunchKernelEx(&cfg, cluster_static, out, fixed);
    if (err != cudaSuccess) return (int)err;
  }
  if (which == 4 && fixed)
    threshold<true><<<1, 64, 0, 0>>>(vals, reinterpret_cast<unsigned*>(out));
  if (which == 4 && !fixed)
    threshold<false><<<1, 64, 0, 0>>>(vals, reinterpret_cast<unsigned*>(out));
  return (int)cudaGetLastError();
}
'''

_T = np.arange(128)
# which kernel, its outputs with the barrier, and what the check reports
# without it
PLANTED_CASES = {
    "read_after_write": (0, (_T[:64] + 63) % 64, "a store, then another thread's load"),
    "write_after_read": (1, (_T[:64] + 63) % 64 + 64, "a load, then another thread's store"),
    "lane_to_lane": (2, _T[:64] ^ 1, "a store, then another thread's load"),
    "cluster_exchange": (3, _T ^ 64, "of one cluster"),
}


@pytest.fixture(scope="module")
def planted_race(tmp_path_factory):
    fn = build_planted(tmp_path_factory.mktemp("planted"), PLANTED_RACES, "planted_race")
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    return fn


@pytest.mark.parametrize("case", sorted(PLANTED_CASES))
def test_stand_in_finds_races_of_loads(planted_race, case, capfd):
    """A load of another thread's store with no barrier between, a store
    over another thread's load, a swap between lanes with no __syncwarp,
    and one between the blocks of a cluster through device memory with no
    cluster.sync(): cudaErrorRace (999) without the barrier and 0 with it,
    in every launch."""
    which, want, report = PLANTED_CASES[case]
    vals = np.zeros(256, np.uint32)
    for fixed, rc in ((1, 0), (0, 999), (1, 0), (0, 999)):
        buf, out = np.zeros(128, np.float32), np.zeros(128, np.float32)
        capfd.readouterr()
        assert planted_race(which, fixed, vals.ctypes.data, buf.ctypes.data,
                            out.ctypes.data) == rc
        err = capfd.readouterr().err
        if fixed:
            assert "race" not in err, err
            np.testing.assert_array_equal(out[:len(want)], want)
        else:
            assert report in err, err


def test_stand_in_passes_relaxed_threshold(planted_race, capfd):
    """The block threshold of pair_scan.cuh, read volatile while other
    warps raise it by atomicMax: no race (0), and the largest value; read
    plainly instead, the same kernel races with the atomics (999)."""
    vals = np.random.default_rng(1).integers(1, 1 << 30, 256).astype(np.uint32)
    for relaxed, rc in ((1, 0), (0, 999), (1, 0), (0, 999)):
        out = np.zeros(1, np.uint32)
        capfd.readouterr()
        assert planted_race(4, relaxed, vals.ctypes.data, None, out.ctypes.data) == rc
        assert out[0] == vals.max()
        assert ("an atomic" in capfd.readouterr().err) == (not relaxed)


def test_stand_in_refuses_static_shared_in_a_cluster(planted_race, capfd):
    """Static __shared__ is one array here, which the blocks of a cluster
    would share: such a launch is refused (cudaErrorNotSupported, 801)."""
    out = np.zeros(128, np.float32)
    assert planted_race(5, 0, None, None, out.ctypes.data) == 801
    assert "static __shared__" in capfd.readouterr().err
    assert planted_race(3, 1, None, np.zeros(128, np.float32).ctypes.data,
                        out.ctypes.data) == 0


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
