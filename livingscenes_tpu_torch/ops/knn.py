"""Exact k-nearest neighbours and neighbour gathers, plain PyTorch.

Counterpart of livingscenes_tpu/ops/knn.py. `knn` is the plain version of
the kNN kernel (ops/cuda_knn.py). The JAX package's one-hot matmul gather
(`gather_neighbors_onehot`) was a TPU workaround for a slow gather; here
the gather is a plain index gather, which is exact.
"""
from __future__ import annotations

import torch


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """max(|a|^2 - 2 a.b + |b|^2, 0) between (..., N, D) and (..., M, D)."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1, keepdim=True)
    ab = torch.matmul(a, b.transpose(-1, -2))
    d = a2 - 2.0 * ab + b2.transpose(-1, -2)
    return torch.clamp_min(d, 0.0)


def knn(query: torch.Tensor, points: torch.Tensor, k: int):
    """The k nearest `points` of each `query`, ascending; among equal
    distances the lower index comes first (a stable sort).

    query (..., N, D), points (..., M, D). Returns (dists (..., N, k),
    idx (..., N, k) int64).
    """
    dists, idx = torch.sort(pairwise_sqdist(query, points), dim=-1, stable=True)
    return dists[..., :k], idx[..., :k]


def gather_neighbors(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """features (B, M, F...), idx (B, N, K) -> (B, N, K, F...)."""
    rows = torch.arange(idx.shape[0], device=idx.device)[:, None, None]
    return features[rows, idx]
