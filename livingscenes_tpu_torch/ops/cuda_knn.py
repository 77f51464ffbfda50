"""Exact kNN on the card: the wrapper of csrc/knn.cu.

Counterpart of livingscenes_tpu/ops/pallas_knn.py (`knn_pallas`).
`knn_auto` takes the plain version (ops/knn.py) for a tensor on the CPU and
launches the kernel for a CUDA tensor; there is no fallback.
"""
from __future__ import annotations

import torch

from . import _cuda
from .knn import knn

launches = 0  # kernel launches since the count was last set to 0


def knn_cuda(query: torch.Tensor, points: torch.Tensor, k: int):
    """(dists (B, Nq, k) float32, idx (B, Nq, k) int32) from the kernel.
    query (B, Nq, D), points (B, Np, D), float32 on the card."""
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
    dists = torch.empty((B, Nq, k), dtype=torch.float32, device=query.device)
    idx = torch.empty((B, Nq, k), dtype=torch.int32, device=query.device)
    err = lib.lstpu_knn(
        query.data_ptr(), points.data_ptr(), dists.data_ptr(), idx.data_ptr(),
        B, Nq, Np, D, k, _cuda.stream_ptr(query),
    )
    _cuda.check(err, "knn")
    launches += 1
    return dists, idx


def knn_auto(query: torch.Tensor, points: torch.Tensor, k: int):
    """Exact kNN graph: (dists (B, Nq, k), idx (B, Nq, k) int64)."""
    if query.device.type == "cpu":
        return knn(query, points, k)
    dists, idx = knn_cuda(query.contiguous(), points.contiguous(), k)
    return dists, idx.long()
