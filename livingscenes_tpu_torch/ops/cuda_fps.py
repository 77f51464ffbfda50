"""Farthest-point sampling on the card: the wrapper of csrc/fps.cu.

Counterpart of livingscenes_tpu/ops/pallas_fps.py (`fps_pallas`,
`fps_auto`). `fps_auto` takes the plain version (ops/fps.py) for a tensor on
the CPU and launches the kernel for a CUDA tensor; there is no fallback.
"""
from __future__ import annotations

import torch

from . import _cuda
from .fps import farthest_point_sampling

launches = 0  # kernel launches since the count was last set to 0


def fps_cuda(points: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """Indices (B, k) int32 from the kernel. points (B, N, 3) float32 on the
    card, mask (B, N) bool or None."""
    global launches
    _cuda.require_cuda("fps", points, dtype=torch.float32)
    B, N, three = points.shape
    if three != 3 or k < 1:
        raise ValueError(f"fps: bad shape {tuple(points.shape)} or k={k}")
    lib = _cuda.lib()
    if N > lib.lstpu_fps_max_points():
        raise ValueError(f"fps: N={N} above the kernel's limit")
    if mask is not None:
        _cuda.require_cuda("fps", points, mask, dtype=None)
        if mask.dtype != torch.bool or mask.shape != (B, N):
            raise TypeError("fps: mask must be a (B, N) bool tensor")
    out = torch.empty((B, k), dtype=torch.int32, device=points.device)
    err = lib.lstpu_fps(
        points.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), B, N, k, _cuda.stream_ptr(points),
    )
    _cuda.check(err, "fps")
    launches += 1
    return out


def fps_auto(points: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """Masked FPS: (sampled (B, k, 3), idx (B, k) int64)."""
    if points.device.type == "cpu":
        return farthest_point_sampling(points, k, mask=mask)
    idx = fps_cuda(
        points.contiguous(), k,
        None if mask is None else mask.contiguous(),
    ).long()
    B = points.shape[0]
    sampled = torch.gather(points, 1, idx[..., None].expand(B, k, 3))
    return sampled, idx
