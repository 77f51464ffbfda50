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


def fps_cuda(points: torch.Tensor, k: int, mask: torch.Tensor | None = None,
             start: torch.Tensor | None = None, warps: int = 0):
    """Indices (B, k) int32 from the kernel. points (B, N, 3) float32 on the
    card, mask (B, N) bool or None, start (B,) int32 first picks in [0, N)
    or None for 0. `warps`: warps a cloud (1 the warp form, 2-16 the block
    form, 0 the kernel's choice by N)."""
    global launches
    _cuda.require_cuda("fps", points, dtype=torch.float32)
    B, N, three = points.shape
    if three != 3 or k < 1:
        raise ValueError(f"fps: bad shape {tuple(points.shape)} or k={k}")
    if mask is not None:
        _cuda.require_cuda("fps", points, mask, dtype=None)
        if mask.dtype != torch.bool or mask.shape != (B, N):
            raise TypeError("fps: mask must be a (B, N) bool tensor")
    if start is not None:
        _cuda.require_cuda("fps", points, start, dtype=None)
        if start.dtype != torch.int32 or start.shape != (B,):
            raise TypeError("fps: start must be a (B,) int32 tensor")
    lib = _cuda.lib()
    tail = lib.lstpu_fps_tail_points(N, warps)
    if tail < 0:
        raise ValueError(f"fps: warps={warps} is not 0, 1, 2, 4, 8 or 16")
    # the running minimum of the points past the kernel's registers
    scratch = (torch.empty((B, tail), dtype=torch.float32, device=points.device)
               if tail else None)
    out = torch.empty((B, k), dtype=torch.int32, device=points.device)
    err = lib.lstpu_fps(
        points.data_ptr(), None if mask is None else mask.data_ptr(),
        None if start is None else start.data_ptr(), out.data_ptr(),
        None if scratch is None else scratch.data_ptr(), B, N, k, warps,
        _cuda.stream_ptr(points),
    )
    _cuda.check(err, "fps")
    launches += 1
    return out


def fps_auto(points: torch.Tensor, k: int, mask: torch.Tensor | None = None,
             start_idx: torch.Tensor | int = 0):
    """Masked FPS from `start_idx` (an int or (B,) indices in [0, N)):
    (sampled (B, k, 3), idx (B, k) int64)."""
    if points.device.type == "cpu":
        return farthest_point_sampling(points, k, mask=mask, start_idx=start_idx)
    B, N, _ = points.shape
    start = None
    if torch.is_tensor(start_idx):
        start = start_idx.to(points.device, torch.int32).expand(B).contiguous()
    elif start_idx:
        if not 0 <= start_idx < N:
            raise ValueError(f"fps: start_idx={start_idx} outside [0, {N})")
        start = torch.full((B,), start_idx, dtype=torch.int32, device=points.device)
    idx = fps_cuda(
        points.contiguous(), k,
        None if mask is None else mask.contiguous(), start,
    ).long()
    sampled = torch.gather(points, 1, idx[..., None].expand(B, k, 3))
    return sampled, idx


def fps_subsample_with_features(points: torch.Tensor, features: torch.Tensor,
                                factor: int):
    """The encoder's down-sampling: FPS of (B, N, 3) points down to
    N // factor by `fps_auto` (the kernel on a CUDA tensor, raising if it
    cannot run; `farthest_point_sampling` on a CPU one), and (B, N, ...)
    features gathered at the same indices. Returns (sampled (B, k, 3),
    features (B, k, ...), idx (B, k) int64)."""
    B, N, _ = points.shape
    sampled, idx = fps_auto(points, N // factor)
    rows = torch.arange(B, device=points.device)[:, None]
    return sampled, features[rows, idx], idx
