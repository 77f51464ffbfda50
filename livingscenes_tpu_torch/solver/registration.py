"""Pairwise rigid registration from equivariant codes.

Counterpart of livingscenes_tpu/solver/registration.py without the SE(3)
refinement (`optim=True` is a later slice): Kabsch on the (z_so3 + t)
points of the two codes, then ICP, whose pose is kept per instance by the
`icp_accept` rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import torch

from .. import se3
from ..ops.icp import iterative_closest_point

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """The ICP fields of the JAX RegistrationConfig (defaults mirror
    configs/more_3rscan.yaml:12-18); the refinement's fields come with the
    optim slice."""

    icp_iterations: int = 100
    # Fused ICP statistics; None = on for unmasked clouds (ops/icp.py).
    icp_fused: bool | None = None
    # "always": the ICP pose wins; "symch": it wins only where it lowers the
    # symmetric mean nearest-neighbour distance to the target; "sdf" needs
    # the decoder (a later slice).
    icp_accept: str = "symch"


class RegistrationResult(NamedTuple):
    R: torch.Tensor  # (B, 3, 3)
    t: torch.Tensor  # (B, 3, 1)
    residual: torch.Tensor  # (B,) mean Kabsch residual


def kabsch_from_codes(codes1: Codes, codes2: Codes) -> RegistrationResult:
    """Closed-form registration: Kabsch on z_so3 + t correspondences."""
    R, t, res = se3.kabsch(
        codes1["z_so3"] + codes1["t"], codes2["z_so3"] + codes2["t"]
    )
    return RegistrationResult(R=R, t=t, residual=torch.mean(res, dim=-1))


def symmetric_chamfer(moved: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """Mean nearest-neighbour distance both ways; (B,)."""
    d2 = (torch.sum(moved * moved, -1)[:, :, None]
          + torch.sum(tgt * tgt, -1)[:, None]
          - 2.0 * torch.einsum("bnd,bmd->bnm", moved, tgt))
    d = torch.sqrt(torch.clamp_min(d2, 0.0))
    return torch.amin(d, 2).mean(1) + torch.amin(d, 1).mean(1)


def solve_pairwise_registration(
    model,
    pc1: torch.Tensor,
    pc2: torch.Tensor,
    codes1: Optional[Codes] = None,
    codes2: Optional[Codes] = None,
    optim: bool = False,
    cfg: RegistrationConfig = RegistrationConfig(),
):
    """Register (B, N, 3) clouds pc1 -> pc2; returns (R (B, 3, 3),
    t (B, 3, 1))."""
    if optim:
        raise NotImplementedError(
            "optim=True (the SE(3) refinement with the Sinkhorn kernels) is "
            "the optim slice of the port"
        )
    if cfg.icp_accept not in ("always", "symch"):
        if cfg.icp_accept == "sdf":
            raise NotImplementedError(
                "icp_accept='sdf' needs the decoder: the optim slice of the port"
            )
        raise ValueError(f"icp_accept={cfg.icp_accept!r}")
    if codes1 is None:
        codes1 = model.encode(pc1)
    if codes2 is None:
        codes2 = model.encode(pc2)
    R, t, _ = kabsch_from_codes(codes1, codes2)
    res = iterative_closest_point(
        pc1, pc2, init_R=R, init_t=t[..., 0],
        max_iterations=cfg.icp_iterations, fused_stats=cfg.icp_fused,
    )
    R_icp, t_icp = res.R, res.t[..., None]
    if cfg.icp_accept == "always":
        return R_icp, t_icp

    def move(Rm, tm):
        return torch.einsum("bij,bnj->bni", Rm, pc1) + tm[..., 0][:, None]

    take = symmetric_chamfer(move(R_icp, t_icp), pc2) < symmetric_chamfer(move(R, t), pc2)
    R = torch.where(take[:, None, None], R_icp, R)
    t = torch.where(take[:, None, None], t_icp, t)
    return R, t
