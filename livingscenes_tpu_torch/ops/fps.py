"""Farthest-point sampling, plain PyTorch.

Counterpart of livingscenes_tpu/ops/fps.py. It is the plain version of the
FPS kernel (ops/cuda_fps.py): the CPU path, and what the kernel is held
against on the card.
"""
from __future__ import annotations

import torch

_BIG = 1e10


def sqdist_to(points: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """((dx*dx + dy*dy) + dz*dz) between (B, N, 3) points and (B, 3) last,
    in that order of rounding (the kernel uses the same)."""
    d = points - last[:, None, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def farthest_point_sampling(
    points: torch.Tensor, k: int, mask: torch.Tensor | None = None,
    start_idx: torch.Tensor | int = 0,
):
    """Sample `k` farthest points of each (B, N, 3) cloud.

    Starts at `start_idx` (an int or (B,) indices); each round picks the
    first index of the maximum of the running minimum squared distance.
    Invalid points (mask False) are never picked while a valid one is left;
    with fewer than k valid points the tail repeats already-selected points.

    Returns (sampled (B, k, 3), idx (B, k) int64).
    """
    B, N, _ = points.shape
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=points.device)
    neg = torch.full((), -_BIG, dtype=points.dtype, device=points.device)
    min_d = torch.where(
        mask, torch.full_like(neg, _BIG), neg
    ).expand(B, N).clone()
    idx = torch.zeros((B, k), dtype=torch.long, device=points.device)
    idx[:, 0] = torch.as_tensor(start_idx, device=points.device)
    rows = torch.arange(B, device=points.device)
    for i in range(k - 1):
        last = points[rows, idx[:, i]]
        d = torch.where(mask, sqdist_to(points, last), neg)
        min_d = torch.minimum(min_d, d)
        idx[:, i + 1] = torch.argmax(min_d, dim=-1)
    sampled = torch.gather(points, 1, idx[..., None].expand(B, k, 3))
    return sampled, idx


def __getattr__(name):
    # fps_subsample_with_features, the encoder's down-sampling, has JAX's
    # place here but lives beside the FPS kernel's dispatch in
    # ops/cuda_fps.py, which imports this module
    if name == "fps_subsample_with_features":
        from .cuda_fps import fps_subsample_with_features
        return fps_subsample_with_features
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
