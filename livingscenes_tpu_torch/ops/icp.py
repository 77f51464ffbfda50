"""Fixed-iteration point-to-point ICP.

Counterpart of livingscenes_tpu/ops/icp.py. Every pair runs
`max_iterations` rounds of (nearest target -> rigid refit); a pair freezes
once its relative RMSE change drops below `relative_rmse_thr` and keeps its
R, t, RMSE and quaternion from then on. The first change is inf/inf = NaN,
which never freezes. By default there is no early exit and no host sync
inside the loop; `early_exit=True` reads whether every pair is frozen from
the device after each iteration and stops once they all are, with the
same result bit for bit (a frozen pair never changes again).

Two refits:
  * fused stats (default for unmasked clouds): one correspondence-step
    kernel per iteration (ops/cuda_icp.py; its plain version on the CPU)
    returns the refit's sufficient statistics, and the rotation comes from
    Horn's method warm-started from the previous quaternion;
  * Kabsch: the (B, N, M) distance matrix, the first-index nearest target
    and an SVD Kabsch refit. Used with `fused_stats=False` or with masks.

The JAX package turns the fused path on automatically only on a TPU; here
it is on for unmasked clouds on every device, so the card and the CPU
follow the same refit.

While the program trace records (tracing.py), the loop hands it the
`frozen` flags each iteration starts with and counts the iterations and
pairs on the host: no launch and no sync more.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import se3, tracing
from .cuda_icp import icp_iteration_stats
from .knn import pairwise_sqdist


class ICPResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3); y = R x + t
    t: torch.Tensor  # (B, 3)
    rmse: torch.Tensor  # (B,)
    converged: torch.Tensor  # (B,) bool


def iterative_closest_point(
    src: torch.Tensor,
    tgt: torch.Tensor,
    init_R: torch.Tensor | None = None,
    init_t: torch.Tensor | None = None,
    max_iterations: int = 100,
    relative_rmse_thr: float = 1e-6,
    src_mask: torch.Tensor | None = None,
    tgt_mask: torch.Tensor | None = None,
    fused_stats: bool | None = None,
    early_exit: bool = False,
) -> ICPResult:
    """Rigid ICP aligning src (B, N, 3) to tgt (B, M, 3)."""
    B, N, _ = src.shape
    dtype, device = src.dtype, src.device
    if init_R is None:
        R = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3)
    else:
        R = init_R.to(dtype)
    t = (torch.zeros((B, 3), dtype=dtype, device=device) if init_t is None
         else init_t.to(dtype))
    unmasked = src_mask is None and tgt_mask is None
    fused = unmasked if fused_stats is None else (fused_stats and unmasked)
    w = (torch.ones((B, N), dtype=dtype, device=device) if src_mask is None
         else src_mask.to(dtype))
    src_mean = torch.mean(src, dim=1)  # (B, 3)

    prev_rmse = torch.full((B,), float("inf"), dtype=dtype, device=device)
    frozen = torch.zeros((B,), dtype=torch.bool, device=device)
    q = se3.quat_wxyz_from_matrix(R)
    frozen_log = tracing.icp_frozen_log()
    for _ in range(max_iterations):
        if frozen_log is not None:
            frozen_log.append(frozen)
        x = torch.matmul(src, R.transpose(-1, -2)) + t[:, None, :]
        if fused:
            S, nn_sum, dmin_sum = icp_iteration_stats(
                x, src, tgt, active=torch.logical_not(frozen)
            )
            rmse = torch.sqrt(dmin_sum.to(dtype) / N)
            nn_mean = nn_sum.to(dtype) / N
            cov = S.to(dtype) / N - src_mean[:, :, None] * nn_mean[:, None, :]
            R_new, q_new = se3.rotation_from_covariance_horn(cov, q0=q, iters=8)
            q = torch.where(frozen[:, None], q, q_new)
            t_new = nn_mean - torch.matmul(R_new, src_mean[..., None])[..., 0]
        else:
            d = pairwise_sqdist(x, tgt)
            if tgt_mask is not None:
                d = torch.where(tgt_mask[:, None, :], d, 1e10)
            dmin, idx = torch.min(d, dim=-1)
            nn = torch.gather(tgt, 1, idx[..., None].expand(B, N, 3))
            rmse = torch.sqrt(
                torch.sum(dmin * w, dim=-1)
                / torch.clamp_min(torch.sum(w, dim=-1), 1.0)
            )
            R_new, t_new, _ = se3.kabsch(src, nn, weights=w)
            t_new = t_new[..., 0]
        rel = torch.abs(prev_rmse - rmse) / torch.clamp_min(prev_rmse, 1e-12)
        R = torch.where(frozen[:, None, None], R, R_new)
        t = torch.where(frozen[:, None], t, t_new)
        prev_rmse = torch.where(frozen, prev_rmse, rmse)
        frozen = frozen | (rel < relative_rmse_thr)
        if early_exit and bool(torch.all(frozen)):
            break
    if frozen_log is not None:
        tracing.count("icp.iterations", len(frozen_log))
        tracing.count("icp.pair_iterations", len(frozen_log) * B)
    return ICPResult(R=R, t=t, rmse=prev_rmse, converged=frozen)
