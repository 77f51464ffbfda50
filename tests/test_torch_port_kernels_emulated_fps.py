"""The FPS kernel (csrc/fps.cu) on CPU threads, held against its plain
version.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. Apart from the other kernels' cases so that
no one file sets the length of a run of the tests over several workers.

Tolerances: indices equal (random reals have no near-ties at these sizes).
"""
import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.ops import cuda_fps
from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    emulated, f32, on_host)


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


@pytest.mark.parametrize(
    "B,N,k,warps",
    [
        (6, 100, 30, 1),    # the warp form: four clouds a block, then two
        (3, 300, 64, 2),    # block forms
        (2, 1000, 40, 4),
        (2, 200, 30, 16),   # most of the block's threads without a point
    ],
)
def test_fps_kernel_forms(on_host, B, N, k, warps):
    rng = np.random.default_rng(16)
    pts = f32(rng, B, N, 3)
    mask = torch.as_tensor(rng.random((B, N)) > 0.3)
    mask[1, k // 2:] = False  # fewer valid points than k
    mask[0, 1:] = False       # a single valid point
    for m in (None, mask):
        got = cuda_fps.fps_cuda(pts, k, m, warps=warps)
        want = farthest_point_sampling(pts, k, m)[1]
        assert torch.equal(got.long(), want)


@pytest.mark.parametrize("warps", [0, 1, 4])
def test_fps_kernel_start(on_host, warps):
    rng = np.random.default_rng(17)
    pts = f32(rng, 5, 120, 3)
    mask = torch.as_tensor(rng.random((5, 120)) > 0.2)
    start = torch.as_tensor([0, 7, 119, 50, 3], dtype=torch.int32)
    got = cuda_fps.fps_cuda(pts, 40, mask, start, warps=warps)
    want = farthest_point_sampling(pts, 40, mask, start_idx=start)[1]
    assert torch.equal(got.long(), want)
    assert torch.equal(got[:, 0], start)


def test_fps_front_end_stacked(on_host):
    # the pipeline's front end: both sides of the scene pairs in one launch
    rng = np.random.default_rng(18)
    ref, res = f32(rng, 3, 400, 3), f32(rng, 3, 400, 3)
    m_ref = torch.as_tensor(rng.random((3, 400)) > 0.4)
    both = cuda_fps.fps_cuda(torch.cat([ref, res]), 64,
                             torch.cat([m_ref, torch.ones_like(m_ref)]))
    apart = [cuda_fps.fps_cuda(ref, 64, m_ref), cuda_fps.fps_cuda(res, 64)]
    assert torch.equal(both, torch.cat(apart))
    assert torch.equal(both[:3].long(), farthest_point_sampling(ref, 64, m_ref)[1])


def test_fps_kernel_beyond_register_points(on_host):
    # 8500 points: 8192 in registers, 308 re-read every round with their
    # running minimum in scratch; the old kernel refused N > 8192
    rng = np.random.default_rng(19)
    pts = f32(rng, 2, 8500, 3)
    pts[:, 8200:] *= 3.0  # far points past the registers: picked early
    mask = torch.ones((2, 8500), dtype=torch.bool)
    mask[1, 8300:] = False
    assert cuda_fps._cuda.lib().lstpu_fps_tail_points(8500, 0) == 308
    got = cuda_fps.fps_cuda(pts, 40, mask)
    want = farthest_point_sampling(pts, 40, mask)[1]
    assert torch.equal(got.long(), want)
    assert int(want.max()) >= 8192
