"""The SIM(3) scale statistic: plain version and the wrapper of
csrc/scale.cu.

Counterpart of livingscenes_tpu/ops/pallas_scale.py
(`top_k_mean_pairwise_distance`): per cloud, the mean of the k largest
entries of the full N x N distance matrix. The matrix is symmetric and
d[i][j], d[j][i] are separate entries, so distinct distances give
[dmax, dmax, d2, d2, d3] for k = 5. Distances are the roots of squared
differences, the form the kNN + scale kernel uses (ops/cuda_knn.py). The
statistic is data: no gradient flows through it.
"""
from __future__ import annotations

import torch

from . import _cuda

launches = 0  # scale.cu launches since the count was last set to 0


def top_k_mean_pairwise_distance_plain(pc: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The plain version: one (B, N, N) matrix of squared differences, the
    top k of it flattened, the mean of their roots. pc (B, N, 3) -> (B,)."""
    x, y, z = pc.unbind(-1)
    dx = x[:, :, None] - x[:, None, :]
    dy = y[:, :, None] - y[:, None, :]
    dz = z[:, :, None] - z[:, None, :]
    d2 = (dx * dx + dy * dy) + dz * dz
    # sqrt is monotone: the top k of d2 are the top k of d
    top = torch.topk(d2.reshape(pc.shape[0], -1), k, dim=-1).values
    return torch.mean(torch.sqrt(top), dim=-1)


def top_k_mean_pairwise_distance_cuda(pc: torch.Tensor, k: int = 5) -> torch.Tensor:
    """The kernel: pc (B, N, 3) float32 on the card, any N. It leaves the k largest
    squared distances of each tile of rows; the selection over the tiles
    and the mean of the roots are taken here."""
    global launches
    _cuda.require_cuda("scale", pc, dtype=torch.float32)
    B, N, three = pc.shape
    lib = _cuda.lib()
    if three != 3:
        raise ValueError(f"scale: bad shape {tuple(pc.shape)}")
    if not 1 <= k <= min(lib.lstpu_scale_max_top(), N):
        raise ValueError(f"scale: k={k} outside [1, min(8, {N})]")
    n_tiles = -(-N // lib.lstpu_scale_tile())
    tops = torch.empty((B, n_tiles, k), dtype=torch.float32, device=pc.device)
    err = lib.lstpu_scale(pc.data_ptr(), tops.data_ptr(), B, N, k,
                          _cuda.stream_ptr(pc))
    _cuda.check(err, "scale")
    launches += 1
    top = torch.topk(tops.reshape(B, -1), k, dim=-1).values
    return torch.mean(torch.sqrt(top), dim=-1)


def top_k_mean_pairwise_distance(pc: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Mean of the k largest entries of each cloud's pairwise-distance
    matrix, (B, N, 3) -> (B,): the plain version on the CPU, the kernel on
    the card."""
    pc = pc.detach()
    if pc.device.type == "cpu":
        return top_k_mean_pairwise_distance_plain(pc, k)
    return top_k_mean_pairwise_distance_cuda(pc.contiguous(), k)
