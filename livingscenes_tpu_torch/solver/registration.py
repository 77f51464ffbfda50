"""Pairwise rigid registration from equivariant codes.

Counterpart of livingscenes_tpu/solver/registration.py:
1. Kabsch on the (z_so3 + t) points of the two codes.
2. With `optim`, the SE(3) refinement: Adam on a 6-dof tangent xi with
   g = exp(xi) o g_init, on the loss SmoothL1(SDF(g . src)) +
   SinkhornDivergence(g . src, tgt), with a stepped learning rate,
   best-loss tracking, and a freeze of every pair whose rotation has
   drifted more than `early_stop_deg` from its init. All pairs step
   together; a frozen pair keeps its iterate and its Adam moments.
3. With `use_icp`, ICP, whose pose is kept per instance by the
   `icp_accept` rule.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .. import se3
from ..ops.icp import iterative_closest_point
from ..ops.sinkhorn import sinkhorn_divergence, sinkhorn_yy_term

Codes = Dict[str, torch.Tensor]

# optax.adam's defaults
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """Defaults mirror configs/more_3rscan.yaml:12-18."""

    n_steps: int = 400
    lr: float = 0.05
    lr_milestones: tuple = (300, 340, 380)  # the rate is scaled from each on
    lr_decay: float = 0.1
    early_stop_deg: float = 10.0
    sinkhorn_blur: float = 0.05
    sinkhorn_iters: int = 30
    # Temperatures scale down from diameter^2 to blur^2 (one update each)
    # instead of `sinkhorn_iters` updates at the target.
    sinkhorn_anneal: bool = True
    sinkhorn_diameter: float = 2.0
    # The Sinkhorn iterates are detached and only the final pair is
    # differentiated: the same value, the gradient at the converged
    # potentials.
    sinkhorn_implicit_grad: bool = True
    # The Sinkhorn kernels (ops/cuda_sinkhorn.py; their plain version on the
    # CPU). False: the materialised matrix of squared differences.
    sinkhorn_pallas: bool = True
    # The refinement's decoder in bfloat16: its parameters, the moved
    # points and the codes are cast, so the invariant query is formed in
    # bfloat16 too; the SDF comes back as float32, and the pose and the
    # Adam state stay float32. The direction pick decodes in full precision.
    refine_bf16: bool = False
    icp_iterations: int = 100
    # False: the pose after Kabsch (and the refinement) is returned, with no
    # ICP and no acceptance test.
    use_icp: bool = True
    # Fused ICP statistics; None = on for unmasked clouds (ops/icp.py).
    icp_fused: bool | None = None
    direction_pick: bool = True  # False: always refine pc1 -> pc2
    track_best: bool = True  # False: return the last iterate, not the best
    # "always": the ICP pose wins; "symch": it wins only where it lowers the
    # symmetric mean nearest-neighbour distance to the target; "sdf": only
    # where it lowers the mean |SDF| of the moved source under the target's
    # code.
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


def _smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Smooth-L1 loss against zero, averaged over the last axis: (B, M) ->
    (B,)."""
    absx = torch.abs(x)
    return torch.mean(
        torch.where(absx < beta, 0.5 * absx ** 2 / beta, absx - 0.5 * beta),
        dim=-1)


def make_refine_loss(
    decode_sdf: Callable,
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    shared_codes: Codes,
    R0: torch.Tensor,
    t0: torch.Tensor,
    cfg: RegistrationConfig = RegistrationConfig(),
):
    """(apply_g, loss_fn) of the refinement. `apply_g(xi, pts)` returns the
    moved points and (R, t) of exp(xi) o (R0, t0); `loss_fn(xi)` returns
    (sum over pairs, per-pair loss (B,))."""

    def apply_g(xi, pts):
        g = se3.se3_exp(xi)
        R = torch.matmul(g[..., :3, :3], R0)
        t = torch.matmul(g[..., :3, :3], t0) + g[..., :3, 3:]
        return torch.matmul(pts, R.transpose(-1, -2)) + t.transpose(-1, -2), (R, t)

    ot_args = dict(blur=cfg.sinkhorn_blur, iters=cfg.sinkhorn_iters,
                   anneal=cfg.sinkhorn_anneal, diameter=cfg.sinkhorn_diameter,
                   pallas=cfg.sinkhorn_pallas)
    # the target does not move: its self-transport term is computed once
    half_yy = sinkhorn_yy_term(tgt_pc, **ot_args)

    def loss_fn(xi):
        moved, _ = apply_g(xi, src_pc)
        sdf_loss = _smooth_l1(decode_sdf(moved, shared_codes))
        ot = sinkhorn_divergence(
            moved, tgt_pc, implicit_grad=cfg.sinkhorn_implicit_grad,
            half_ot_yy=half_yy, **ot_args)
        per_item = sdf_loss + ot
        return torch.sum(per_item), per_item

    return apply_g, loss_fn


def refine_learning_rate(cfg: RegistrationConfig, step: int) -> float:
    """The rate of the 0-based `step`: `lr`, scaled by `lr_decay` for every
    milestone m with step >= m."""
    lr = cfg.lr
    for m in cfg.lr_milestones:
        if step >= m:
            lr *= cfg.lr_decay
    return lr


def refine_se3(
    decode_sdf: Callable,
    src_pc: torch.Tensor,
    tgt_pc: torch.Tensor,
    shared_codes: Codes,
    R0: torch.Tensor,
    t0: torch.Tensor,
    cfg: RegistrationConfig = RegistrationConfig(),
):
    """Refine initial transforms src -> tgt on the SE(3) manifold.

    decode_sdf: (query (B, M, 3), codes) -> sdf (B, M), the field with its
      parameters fixed (only xi is differentiated);
    src_pc / tgt_pc: (B, N, 3) / (B, M, 3); shared_codes: the target
      frame's codes; R0 / t0: (B, 3, 3) / (B, 3, 1).

    Returns (R, t, info) of each pair's best-loss iterate (the last one
    without `track_best`); info has `best_loss` and `stopped`, both (B,).
    Switches autograd on for its own loss, also under a caller's
    `torch.no_grad()` (not under inference mode, whose tensors autograd
    cannot save); inputs are detached. No value is read back to the host
    inside the loop.
    """
    src_pc, tgt_pc, R0, t0 = (a.detach() for a in (src_pc, tgt_pc, R0, t0))
    shared_codes = {k: v.detach() for k, v in shared_codes.items()}
    B = src_pc.shape[0]
    dtype, device = src_pc.dtype, src_pc.device
    with torch.no_grad():
        apply_g, loss_fn = make_refine_loss(
            decode_sdf, src_pc, tgt_pc, shared_codes, R0, t0, cfg)
    eye = torch.eye(3, dtype=dtype, device=device).expand(B, 3, 3)

    xi = torch.zeros((B, 6), dtype=dtype, device=device)
    mu, nu = torch.zeros_like(xi), torch.zeros_like(xi)
    best_xi = xi
    best_loss = torch.full((B,), float("inf"), dtype=dtype, device=device)
    stopped = torch.zeros((B,), dtype=torch.bool, device=device)
    for step in range(cfg.n_steps):
        with torch.enable_grad():
            xi_var = xi.detach().requires_grad_(True)
            total, per_item = loss_fn(xi_var)
            (grad,) = torch.autograd.grad(total, xi_var)
        with torch.no_grad():
            per_item = per_item.detach()
            # Adam with bias correction; the step count is shared, the
            # moments of a stopped pair stay as they were
            count = step + 1
            mu_new = _ADAM_B1 * mu + (1.0 - _ADAM_B1) * grad
            nu_new = _ADAM_B2 * nu + (1.0 - _ADAM_B2) * grad * grad
            mu_hat = mu_new / (1.0 - _ADAM_B1 ** count)
            nu_hat = nu_new / (1.0 - _ADAM_B2 ** count)
            xi_new = xi - refine_learning_rate(cfg, step) * mu_hat / (
                torch.sqrt(nu_hat) + _ADAM_EPS)

            # the loss was evaluated at xi, not at xi_new
            take = (per_item < best_loss) & ~stopped
            best_xi = torch.where(take[:, None], xi, best_xi)
            best_loss = torch.where(take, per_item, best_loss)

            # a pair whose new iterate has drifted too far stops from the
            # next step on
            drift = se3.rotation_error(se3.so3_exp(xi_new[:, 3:]), eye)
            frozen = stopped[:, None]
            xi = torch.where(frozen, xi, xi_new)
            mu = torch.where(frozen, mu, mu_new)
            nu = torch.where(frozen, nu, nu_new)
            stopped = stopped | (drift > cfg.early_stop_deg)
    with torch.no_grad():
        _, (R, t) = apply_g(best_xi if cfg.track_best else xi, src_pc)
    return R, t, {"best_loss": best_loss, "stopped": stopped}


def _bf16_decode(model) -> Callable:
    """model.decode_sdf with the query, the codes' float32 entries and the
    decoder's float32 parameters in bfloat16, returning float32 (JAX's
    refine_bf16 cast; a model of another dtype keeps its parameters, and
    the bfloat16 query is promoted to them)."""
    bf16 = torch.bfloat16
    matmul_dtype = bf16 if model.dtype == torch.float32 else None

    def decode(query, codes):
        cast = {k: v.to(bf16) if v.dtype == torch.float32 else v
                for k, v in codes.items()}
        return model.decode_sdf(query.to(bf16), cast,
                                matmul_dtype=matmul_dtype).to(torch.float32)

    return decode


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
    if cfg.use_icp and cfg.icp_accept not in ("always", "symch", "sdf"):
        raise ValueError(f"icp_accept={cfg.icp_accept!r}")
    if codes1 is None:
        codes1 = model.encode(pc1)
    if codes2 is None:
        codes2 = model.encode(pc2)
    R, t, _ = kabsch_from_codes(codes1, codes2)

    decode = model.decode_sdf

    if optim:
        refine_decode = _bf16_decode(model) if cfg.refine_bf16 else decode
        # refine toward the frame whose code explains its own cloud better
        if cfg.direction_pick:
            with torch.no_grad():
                err1 = torch.mean(torch.abs(decode(pc1, codes1)), dim=-1)
                err2 = torch.mean(torch.abs(decode(pc2, codes2)), dim=-1)
            fwd = err1 >= err2  # True: pc1 -> pc2 against codes2
        else:
            fwd = torch.ones(pc1.shape[0], dtype=torch.bool, device=pc1.device)
        R_bwd, t_bwd, _ = kabsch_from_codes(codes2, codes1)

        def sel(a, b):
            return torch.where(fwd.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        shared = {k: sel(codes2[k], codes1[k]) for k in codes2}
        R_opt, t_opt, _ = refine_se3(
            refine_decode, sel(pc1, pc2), sel(pc2, pc1), shared, sel(R, R_bwd),
            sel(t, t_bwd), cfg)
        # invert where the refinement ran pc2 -> pc1
        R_inv = R_opt.transpose(-1, -2)
        R = sel(R_opt, R_inv)
        t = sel(t_opt, -torch.matmul(R_inv, t_opt))

    if not cfg.use_icp:
        return R, t
    res = iterative_closest_point(
        pc1, pc2, init_R=R, init_t=t[..., 0],
        max_iterations=cfg.icp_iterations, fused_stats=cfg.icp_fused,
    )
    R_icp, t_icp = res.R, res.t[..., None]
    if cfg.icp_accept == "always":
        return R_icp, t_icp

    def move(Rm, tm):
        return torch.einsum("bij,bnj->bni", Rm, pc1) + tm[..., 0][:, None]

    if cfg.icp_accept == "symch":
        def proxy(moved):
            return symmetric_chamfer(moved, pc2)
    else:
        def proxy(moved):
            with torch.no_grad():
                return torch.mean(torch.abs(decode(moved, codes2)), dim=-1)

    take = proxy(move(R_icp, t_icp)) < proxy(move(R, t))
    R = torch.where(take[:, None, None], R_icp, R)
    t = torch.where(take[:, None, None], t_icp, t)
    return R, t
