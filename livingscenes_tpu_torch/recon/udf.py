"""Surface points of an unsigned distance field by gradient walking.

Counterpart of livingscenes_tpu/recon/udf.py (`UDFExtractorConfig`,
`extract_surface_points`): candidate points drawn in the extraction box
walk along -grad|f| / |grad f| * |f| for a fixed number of steps; points
whose |f| falls below the threshold are accepted, and after each round the
rejected ones are resampled near accepted ones, chosen with equal weight,
plus a Gaussian jitter.

The draws: JAX's `jax.random` stream cannot be made in torch, so they are
an argument (`UDFDraws`, e.g. JAX's own) or drawn from a `torch.Generator`.
A resample choice is taken from a uniform u as jax.random.choice takes it:
the first index whose cumulative weight reaches total (1 - u).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class UDFExtractorConfig:
    num_points: int = 20000
    num_steps: int = 8
    num_rounds: int = 3
    threshold: float = 0.01
    box_size: float = 1.1
    sigma_resample: float = 0.02


@dataclasses.dataclass
class UDFDraws:
    """init (P, 3) uniform in [0, 1): the candidates before the box;
    choice (R, P) uniform in [0, 1): each round's resample choices; jitter
    (R, P, 3) standard normal: each round's jitter before sigma_resample."""

    init: torch.Tensor
    choice: torch.Tensor
    jitter: torch.Tensor


def udf_draws(cfg: UDFExtractorConfig, generator: torch.Generator,
              dtype: torch.dtype = torch.float32) -> UDFDraws:
    """The draws of one extraction from `generator` (on its device), in the
    order init, then each round's choices and jitters."""
    P, R = cfg.num_points, cfg.num_rounds
    dev = generator.device
    init = torch.rand((P, 3), generator=generator, dtype=dtype, device=dev)
    choice, jitter = [], []
    for _ in range(R):
        choice.append(torch.rand((P,), generator=generator, dtype=torch.float32,
                                 device=dev))
        jitter.append(torch.randn((P, 3), generator=generator, dtype=dtype,
                                  device=dev))
    return UDFDraws(init, torch.stack(choice), torch.stack(jitter))


def _walk(udf, pts: torch.Tensor, n_steps: int) -> torch.Tensor:
    """n_steps of p <- p - grad f / max(|grad f|, 1e-9) * f(p); the
    gradient of each point's own value (the field acts point by point)."""
    with torch.inference_mode(False), torch.enable_grad():
        pts = pts.clone()
        for _ in range(n_steps):
            p = pts.detach().requires_grad_(True)
            d = udf(p)
            (g,) = torch.autograd.grad(d.sum(), p)
            g = g / torch.clamp_min(torch.linalg.norm(g, dim=-1, keepdim=True), 1e-9)
            pts = (p - g * d[:, None]).detach()
    return pts


def extract_surface_points(
    udf: Callable[[torch.Tensor], torch.Tensor],
    cfg: UDFExtractorConfig = UDFExtractorConfig(),
    generator: Optional[torch.Generator] = None,
    draws: Optional[UDFDraws] = None,
    device=None,
    dtype: torch.dtype = torch.float32,
):
    """Dense samples of the surface |f| = 0.

    udf: (M, 3) -> (M,) unsigned distances, differentiable. The walk runs
    on `device`, the card unless the caller names another
    (`resolve_device`). The draws are `draws`, else drawn from `generator`
    on its own device, else from a new CPU generator seeded with 0 (not
    JAX's PRNGKey(0) stream); they are moved to `device` and `dtype`.
    Returns (points (num_points, 3) clipped to the box, accepted (num_points,)
    bool): a point not accepted never came below the threshold. The walk
    switches grad mode on, also under inference mode, so the tensors the
    field holds (a decoder's codes, say) must not be inference tensors."""
    device = resolve_device(device)
    if draws is None:
        draws = udf_draws(cfg, generator or torch.Generator().manual_seed(0), dtype)
    P = cfg.num_points
    pts = (draws.init.to(device, dtype) - 0.5) * cfg.box_size
    choice = draws.choice.to(device, torch.float32)
    jitter = draws.jitter.to(device, dtype)
    for r in range(cfg.num_rounds):
        pts = _walk(udf, pts, cfg.num_steps)
        with torch.no_grad():
            ok = udf(pts) < cfg.threshold
            weights = ok.to(torch.float32)
            weights = weights / torch.clamp_min(weights.sum(), 1.0)
            cuml = torch.cumsum(weights, dim=0)
            src = torch.searchsorted(cuml, cuml[-1] * (1 - choice[r]))
            resampled = pts[torch.clamp_max(src, P - 1)] + jitter[r] * cfg.sigma_resample
            pts = torch.where(ok[:, None], pts, resampled)
    pts = _walk(udf, pts, cfg.num_steps)
    with torch.no_grad():
        mask = udf(pts) < cfg.threshold
    half = cfg.box_size / 2
    return torch.clamp(pts, -half, half), mask
