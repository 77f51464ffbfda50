"""Latent code optimization against observed point clouds.

Counterpart of livingscenes_tpu/solver/code_optim.py (`CodeOptimConfig`,
`optimize_codes`): Adam on {z_inv, z_so3, t} with a rate per leaf, scaled
by `lr_decay` from step `lr_milestone` on, minimizing the mean squared SDF
at the observed points; every instance of the batch steps together and
keeps its own best-loss code. The JAX package runs optax; the Adam here is
written out as in `registration.refine_se3`.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from .registration import _ADAM_B1, _ADAM_B2, _ADAM_EPS

Codes = Dict[str, torch.Tensor]

_LEAVES = ("z_inv", "z_so3", "t")


@dataclasses.dataclass(frozen=True)
class CodeOptimConfig:
    n_steps: int = 200
    lr_z_inv: float = 1e-5
    lr_t: float = 1e-4
    lr_z_so3: float = 5e-4
    lr_milestone: int = 160
    lr_decay: float = 0.1


def optimize_codes(
    decode_sdf: Callable,
    codes: Codes,
    pc: torch.Tensor,
    cfg: CodeOptimConfig = CodeOptimConfig(),
) -> Codes:
    """Optimize codes so that the SDF vanishes at the observed points.

    decode_sdf: (query (B, M, 3), codes) -> (B, M), the field with its
      parameters fixed (e.g. model.decode_sdf in eval mode);
    codes: a batch of codes; `s` is never optimized;
    pc: (B, M, 3) observed surface points.

    The loss is sum_b mean_m sdf^2, differentiated with respect to the three
    leaves only. Step i evaluates the iterate before its own update, and an
    instance takes it as its best where its loss is strictly lower than its
    best so far (which starts at +inf); the iterate after the last update is
    never evaluated. Returns dict(codes, **best). Switches autograd on for
    its own loss, also under a caller's `torch.no_grad()`.
    """
    B = pc.shape[0]
    pc = pc.detach()
    dtype = torch.promote_types(pc.dtype, codes["z_inv"].dtype)
    lrs = {"z_inv": cfg.lr_z_inv, "z_so3": cfg.lr_z_so3, "t": cfg.lr_t}
    fixed = {k: v.detach() for k, v in codes.items() if k not in _LEAVES}
    cur = {k: codes[k].detach() for k in _LEAVES}
    mu = {k: torch.zeros_like(v) for k, v in cur.items()}
    nu = {k: torch.zeros_like(v) for k, v in cur.items()}
    best = dict(cur)
    best_loss = torch.full((B,), float("inf"), dtype=dtype, device=pc.device)
    for step in range(cfg.n_steps):
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in cur.items()}
            sdf = decode_sdf(pc, dict(fixed, **leaves))
            per_item = torch.mean(sdf ** 2, dim=-1)
            grads = torch.autograd.grad(torch.sum(per_item), list(leaves.values()))
        with torch.no_grad():
            per_item = per_item.detach()
            improved = per_item < best_loss
            best_loss = torch.where(improved, per_item, best_loss)
            count = step + 1
            scale = cfg.lr_decay if step >= cfg.lr_milestone else 1.0
            for (k, x), g in zip(cur.items(), grads):
                take = improved.reshape((B,) + (1,) * (x.dim() - 1))
                best[k] = torch.where(take, x, best[k])
                mu[k] = _ADAM_B1 * mu[k] + (1.0 - _ADAM_B1) * g
                nu[k] = _ADAM_B2 * nu[k] + (1.0 - _ADAM_B2) * g * g
                mu_hat = mu[k] / (1.0 - _ADAM_B1 ** count)
                nu_hat = nu[k] / (1.0 - _ADAM_B2 ** count)
                cur[k] = x - lrs[k] * scale * mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)
    return dict(codes, **best)
