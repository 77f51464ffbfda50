"""The debiased Sinkhorn divergence between point clouds, the refinement
loss of the registration.

Counterpart of livingscenes_tpu/ops/sinkhorn.py (`eps_annealing_schedule`,
`_sym_potentials`, `sinkhorn_yy_term`, `sinkhorn_divergence`); the
dustbin optimal transport of the Sinkhorn matcher is not ported. Uniform
weights, cost |x - y|^2 / 2, temperature eps = blur^2.

Two routes to the potentials of OT(x, y):
  * with `implicit_grad` and `pallas` not False,
    ops/cuda_sinkhorn.py `ot_extrapolated_potentials`: on the card the
    forward and backward kernels, on the CPU their plain version (the
    expanded cost |x|^2/2 + |y|^2/2 - x.y with detached iterates). The JAX
    package takes its kernels only on a TPU; here the device decides only
    between a kernel and its plain version, so the card and the CPU compute
    the same function;
  * otherwise `_sym_potentials` on the materialised matrix of squared
    differences, differentiated through every iterate unless
    `implicit_grad`.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from .cuda_sinkhorn import (
    damped_iterates,
    ot_extrapolated_potentials,
    softmin_cols,
    softmin_rows,
)


def _sq_cost(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """C(x, y) = |x - y|^2 / 2; (..., N, M)."""
    d = torch.sum((x[..., :, None, :] - y[..., None, :, :]) ** 2, dim=-1)
    return 0.5 * d


def _sym_potentials(C: torch.Tensor, eps_schedule: Sequence[float], iters: int,
                    detach_iters: bool = False):
    """Sinkhorn potentials of OT(a, b) with uniform weights on the cost
    matrix C (..., N, M): damped parallel updates f <- (f + T(g)) / 2,
    g <- (g + T(f)) / 2 along the schedule (a single temperature is held for
    `iters - 1` updates), then one undamped pair at the last temperature.
    The parallel form is symmetric in the two clouds, so for x == y the
    divergence vanishes exactly. With `detach_iters` the gradient flows
    through the final pair only."""
    if len(eps_schedule) > 1:
        steps = list(eps_schedule)
    else:
        steps = [eps_schedule[0]] * max(iters - 1, 0)
    f, g = damped_iterates(C, steps)
    if detach_iters:
        f, g = f.detach(), g.detach()
    eps = eps_schedule[-1]
    return softmin_rows(C, g, eps), softmin_cols(C, f, eps)


def _potentials_from_points(x, y, schedule: Sequence[float], iters: int,
                            implicit_grad: bool, pallas: bool):
    """Potentials (f, g) of OT(x, y) for (N, 3) or (B, N, 3) clouds. With
    `pallas`: ops/cuda_sinkhorn.py (a single temperature is repeated
    max(iters - 1, 1) times); else `_sym_potentials`."""
    if pallas:
        squeeze = x.dim() == 2
        xb = x[None] if squeeze else x
        yb = y[None] if squeeze else y
        eff = tuple(schedule) if len(schedule) > 1 else (
            (schedule[0],) * max(iters - 1, 1))
        f, g = ot_extrapolated_potentials(xb, yb, eff)
        return (f[0], g[0]) if squeeze else (f, g)
    return _sym_potentials(_sq_cost(x, y), schedule, iters,
                           detach_iters=implicit_grad)


def eps_annealing_schedule(blur: float, diameter: float = 2.0,
                           scaling: float = 0.5, tail: int = 2) -> List[float]:
    """Temperatures from diameter^2 down to blur^2 by the factor scaling^2,
    then `tail` updates at the target."""
    eps_target = blur ** 2
    schedule = []
    e = max(diameter, blur) ** 2
    while e > eps_target:
        schedule.append(e)
        e *= scaling ** 2
    schedule.extend([eps_target] * max(tail, 1))
    return schedule


def _schedule(blur: float, anneal: bool, diameter: float, scaling: float):
    if anneal:
        return eps_annealing_schedule(blur, diameter, scaling)
    return [blur ** 2]


def sinkhorn_yy_term(y: torch.Tensor, blur: float = 0.05, iters: int = 50,
                     anneal: bool = False, diameter: float = 2.0,
                     scaling: float = 0.5, pallas: bool | None = None):
    """The 0.5 OT(y, y) term of the divergence, value only: constant while
    y is fixed, so the refinement computes it once."""
    with torch.no_grad():
        f_yy, _ = _potentials_from_points(
            y, y, _schedule(blur, anneal, diameter, scaling), iters, True,
            pallas is None or pallas)
    return torch.mean(f_yy, dim=-1)


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, blur: float = 0.05,
                        iters: int = 50, anneal: bool = False,
                        diameter: float = 2.0, scaling: float = 0.5,
                        implicit_grad: bool = False,
                        half_ot_yy: torch.Tensor | None = None,
                        pallas: bool | None = None) -> torch.Tensor:
    """Debiased Sinkhorn divergence S(x, y) = OT(x, y) - OT(x, x) / 2 -
    OT(y, y) / 2 at eps = blur^2, differentiable in x and y. x (N, 3) or
    (B, N, 3); y (M, 3) or (B, M, 3).

    `anneal`: temperatures scale down from diameter^2 (one update each)
    instead of `iters` updates at the target. `implicit_grad`: the iterates
    are detached and only the final pair is differentiated (same value, the
    gradient at the converged potentials). `half_ot_yy`: a precomputed
    `sinkhorn_yy_term(y, ...)`."""
    schedule = _schedule(blur, anneal, diameter, scaling)
    use_kernels = implicit_grad and (pallas is None or pallas)
    f_xy, g_xy = _potentials_from_points(
        x, y, schedule, iters, implicit_grad, use_kernels)
    f_xx, _ = _potentials_from_points(
        x, x, schedule, iters, implicit_grad, use_kernels)
    ot_xy = torch.mean(f_xy, dim=-1) + torch.mean(g_xy, dim=-1)
    half_ot_xx = torch.mean(f_xx, dim=-1)
    if half_ot_yy is None:
        f_yy, _ = _potentials_from_points(
            y, y, schedule, iters, implicit_grad, use_kernels)
        half_ot_yy = torch.mean(f_yy, dim=-1)
    return ot_xy - half_ot_xx - half_ot_yy
