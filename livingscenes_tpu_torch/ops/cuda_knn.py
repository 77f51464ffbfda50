"""Exact kNN on the card: the wrappers of csrc/knn.cu and csrc/knn_topk.cu.

Counterpart of livingscenes_tpu/ops/pallas_knn.py (`knn_pallas`,
`knn_with_topk_scale`). `knn_auto` and `knn_with_topk_scale` take the plain
version for a tensor on the CPU and launch the kernel for a CUDA tensor;
there is no fallback.
"""
from __future__ import annotations

import torch

from . import _cuda
from .knn import knn

launches = 0  # knn.cu launches since the count was last set to 0
topk_launches = 0  # knn_topk.cu launches since the count was last set to 0


def knn_cuda(query: torch.Tensor, points: torch.Tensor, k: int, form: int = 0):
    """(dists (B, Nq, k) float32, idx (B, Nq, k) int32) from the kernel.
    query (B, Nq, D), points (B, Np, D), float32 on the card. `form`: the
    kernel's tiling (1: 128 queries x 128 sources a block; 2: 64 x 128, D
    split over two thread groups; 3: 32 x 32, D split in eight; 0: the
    kernel's choice by shape)."""
    global launches
    _cuda.require_cuda("knn", query, points, dtype=torch.float32)
    B, Nq, D = query.shape
    Bp, Np, Dp = points.shape
    if (Bp, Dp) != (B, D):
        raise ValueError(
            f"knn: shapes {tuple(query.shape)} and {tuple(points.shape)}"
        )
    lib = _cuda.lib()
    if not 1 <= k <= min(lib.lstpu_knn_max_k(), Np):
        raise ValueError(f"knn: k={k} outside [1, min(16, {Np})]")
    if form not in (0, 1, 2, 3):
        raise ValueError(f"knn: form={form} is not 0-3")
    dists = torch.empty((B, Nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=query.device)
    err = lib.lstpu_knn(
        query.data_ptr(), points.data_ptr(), dists.data_ptr(), idx.data_ptr(),
        B, Nq, Np, D, k, form, _cuda.stream_ptr(query),
    )
    _cuda.check(err, "knn")
    launches += 1
    return dists, idx


def knn_auto(query: torch.Tensor, points: torch.Tensor, k: int):
    """Exact kNN graph: (dists (B, Nq, k), idx (B, Nq, k)); idx is int64 on
    the CPU and the kernel's int32 on the card, which the fused edge
    kernels take as it is."""
    if query.device.type == "cpu":
        return knn(query, points, k)
    return knn_cuda(query.contiguous(), points.contiguous(), k)


def knn_with_topk_scale_plain(pc: torch.Tensor, k: int, k_top: int = 5):
    """The plain version: one (B, N, N) matrix of squared differences
    (the form csrc/knn_topk.cu uses) serves the self-kNN graph (a stable
    sort: ties go to the lower index, a point is its own neighbour 0) and
    the scale, the mean of the `k_top` largest distances of the full matrix
    (symmetric duplicates are separate entries). pc (B, N, 3). Returns
    (idx (B, N, k) int64, scale (B,))."""
    B = pc.shape[0]
    x, y, z = pc.unbind(-1)
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    dz = z[:, :, None] - z[:, None, :]
    d2 = (dx * dx + dy * dy) + dz * dz
    idx = torch.sort(d2, dim=-1, stable=True).indices[..., :k]
    top = torch.topk(d2.reshape(B, -1), k_top, dim=-1).values
    return idx, torch.mean(torch.sqrt(top), dim=-1)


def knn_with_topk_scale_cuda(pc: torch.Tensor, k: int, k_top: int = 5):
    """(idx (B, N, k) int32, scale (B,)) from the kernel: pc (B, N, 3)
    float32 on the card, any N. The kernel leaves the `k_top` largest squared
    distances of each 64-row tile; the final selection over the tiles and
    the mean of the roots are taken here."""
    global topk_launches
    _cuda.require_cuda("knn_topk", pc, dtype=torch.float32)
    B, N, three = pc.shape
    lib = _cuda.lib()
    if three != 3:
        raise ValueError(f"knn_topk: bad shape {tuple(pc.shape)}")
    if not 1 <= k <= min(lib.lstpu_knn_max_k(), N):
        raise ValueError(f"knn_topk: k={k} outside [1, min(16, {N})]")
    if not 1 <= k_top <= min(lib.lstpu_knn_topk_max_top(), N):
        raise ValueError(f"knn_topk: k_top={k_top} outside [1, min(8, {N})]")
    n_tiles = -(-N // lib.lstpu_knn_topk_tile())
    idx = torch.empty((B, N, k), dtype=torch.int32, device=pc.device)
    tops = torch.empty((B, n_tiles, k_top), dtype=torch.float32, device=pc.device)
    err = lib.lstpu_knn_topk(
        pc.data_ptr(), idx.data_ptr(), tops.data_ptr(), B, N, k, k_top,
        _cuda.stream_ptr(pc),
    )
    _cuda.check(err, "knn_topk")
    topk_launches += 1
    top = torch.topk(tops.reshape(B, -1), k_top, dim=-1).values
    return idx, torch.mean(torch.sqrt(top), dim=-1)


def knn_with_topk_scale(pc: torch.Tensor, k: int, k_top: int = 5):
    """Self-kNN graph and scale statistic of centred (B, N, 3) clouds in one
    pass: (idx (B, N, k), scale (B,)); idx is int64 on the CPU and int32
    from the kernel. The neighbour order is that of the scaled cloud too."""
    if pc.device.type == "cpu":
        return knn_with_topk_scale_plain(pc, k, k_top)
    return knn_with_topk_scale_cuda(pc.contiguous(), k, k_top)
