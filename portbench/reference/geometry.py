"""Point-cloud geometry of the reference, in plain PyTorch: farthest-point
sampling, exact kNN, the scale statistic, Kabsch, point-to-point ICP, the
greedy matcher and the symmetric chamfer distance.

Each follows the published method in its plainest form: full distance
matrices, a Python loop over FPS rounds and ICP iterations, an SVD for
every rigid fit.
"""
from __future__ import annotations

import torch

_BIG = 1e10


def sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared distances (..., N, M) of (..., N, D) and (..., M, D), as
    |a|^2 - 2 a.b + |b|^2 clamped at 0."""
    ab = torch.matmul(a, b.transpose(-1, -2))
    d = (a * a).sum(-1)[..., :, None] - 2.0 * ab + (b * b).sum(-1)[..., None, :]
    return torch.clamp_min(d, 0.0)


def fps(points: torch.Tensor, k: int, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Indices (B, k) of farthest-point sampling from index 0: each round
    takes the first point of largest distance to those taken. Points with
    mask False are taken only once every valid point is."""
    B, N, _ = points.shape
    rows = torch.arange(B, device=points.device)
    if mask is None:
        mask = torch.ones((B, N), dtype=torch.bool, device=points.device)
    best = torch.where(mask, _BIG, -_BIG).to(points.dtype)
    idx = torch.zeros((B, k), dtype=torch.long, device=points.device)
    for i in range(1, k):
        d = ((points - points[rows, idx[:, i - 1]][:, None]) ** 2).sum(-1)
        best = torch.minimum(best, torch.where(mask, d, -_BIG))
        idx[:, i] = torch.argmax(best, dim=-1)
    return idx


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, ...), idx (B, ...) -> x at those indices of each batch row."""
    rows = torch.arange(x.shape[0], device=x.device).view(-1, *([1] * (idx.dim() - 1)))
    return x[rows, idx]


def knn(query: torch.Tensor, points: torch.Tensor, k: int) -> torch.Tensor:
    """Indices (B, Nq, k) of the k nearest points, nearest first, the lower
    index first among equal distances."""
    return torch.sort(sqdist(query, points), dim=-1, stable=True).indices[..., :k]


def top_k_mean_distance(pc: torch.Tensor, k: int = 5) -> torch.Tensor:
    """Mean of the k largest entries of each cloud's full N x N distance
    matrix (both (i, j) and (j, i) count); (B,)."""
    d2 = ((pc[:, :, None] - pc[:, None]) ** 2).sum(-1)
    return torch.sqrt(torch.topk(d2.flatten(1), k, dim=-1).values).mean(-1)


def proper_rotation(cov: torch.Tensor) -> torch.Tensor:
    """The rotation R maximising tr(R cov), from an SVD with the
    reflection removed."""
    U, _, Vh = torch.linalg.svd(cov)
    V, Ut = Vh.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    return (V * D[..., None, :]) @ Ut


def kabsch(x1: torch.Tensor, x2: torch.Tensor):
    """R (B, 3, 3), t (B, 3, 1) with x2 ~ R x1 + t, by least squares over
    the corresponding rows of (B, N, 3) sets, equal weights."""
    m1, m2 = x1.mean(1, keepdim=True), x2.mean(1, keepdim=True)
    R = proper_rotation((x1 - m1).transpose(-1, -2) @ (x2 - m2))
    t = m2.transpose(-1, -2) - R @ m1.transpose(-1, -2)
    return R, t


def move(R: torch.Tensor, t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R x + t for every row of (B, N, 3); t (B, 3, 1)."""
    return x @ R.transpose(-1, -2) + t.transpose(-1, -2)


def icp(src, tgt, R, t, iterations: int = 100, rel_thr: float = 1e-6):
    """Point-to-point ICP from (R, t): each round moves src, takes each
    point's nearest target (the first among equal distances), and refits
    by Kabsch. A pair stops for good once its RMSE changes by less than
    rel_thr of itself."""
    prev = torch.full(src.shape[:1], float("inf"), dtype=src.dtype, device=src.device)
    frozen = torch.zeros(src.shape[:1], dtype=torch.bool, device=src.device)
    for _ in range(iterations):
        dmin, nn = sqdist(move(R, t, src), tgt).min(dim=-1)
        rmse = torch.sqrt(dmin.mean(-1))
        R_new, t_new = kabsch(src, gather(tgt, nn))
        rel = (prev - rmse).abs() / torch.clamp_min(prev, 1e-12)
        R = torch.where(frozen[:, None, None], R, R_new)
        t = torch.where(frozen[:, None, None], t, t_new)
        prev = torch.where(frozen, prev, rmse)
        frozen = frozen | (rel < rel_thr)
    return R, t


def chamfer(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean nearest-neighbour distance from a to b plus from b to a; (B,)."""
    d = torch.sqrt(sqdist(a, b))
    return d.amin(2).mean(1) + d.amin(1).mean(1)


def greedy_match(z_ref: torch.Tensor, z_res: torch.Tensor) -> torch.Tensor:
    """matches (S, O): per scene, repeatedly pair the ref and rescan
    instances of highest cosine similarity (the first in row-major order
    among equals), then drop both; -1 for a ref instance left over."""
    S, O, _ = z_ref.shape
    T = z_res.shape[1]
    score = normalize_rows(z_ref) @ normalize_rows(z_res).transpose(-1, -2)
    matches = torch.full((S, O), -1, dtype=torch.long, device=z_ref.device)
    scenes = torch.arange(S, device=z_ref.device)
    for _ in range(min(O, T)):
        flat = score.flatten(1).argmax(-1)
        row, col = flat // T, flat % T
        matches[scenes, row] = col
        score[scenes, row, :] = -float("inf")
        score[scenes, :, col] = -float("inf")
    return matches


def normalize_rows(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp_min(torch.linalg.norm(z, dim=-1, keepdim=True), 1e-12)
