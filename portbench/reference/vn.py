"""Vector-neuron building blocks in plain PyTorch, for the reference.

Features are (..., C, 3). Every layer here is so3 (no translation part):
a channel mixing `W v` by an (out, in) matrix, and the direction-gated
activation of Deng et al.'s Vector Neurons: the component of q along the
direction of k goes through a leaky ReLU, the orthogonal part stays.
Weights come from a flat dict keyed by the reference model's state-dict
names (`<prefix>.lin.weight`, `<prefix>.act.lin_dir.weight`).
"""
from __future__ import annotations

import torch

EPS = 1e-12


def normalize(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), EPS)


def channel_equi_vec_normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-channel direction times the channel norms normalised over the
    channels: rotation-equivariant and scale-invariant."""
    norms = torch.linalg.norm(x, dim=-1, keepdim=True)
    return normalize(x) * normalize(norms, dim=-2)


def mix(W: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v_out[o] = sum_c W[o, c] v[c]; W (out, in), v (..., in, 3)."""
    return torch.einsum("oc,...ci->...oi", W, v)


def vn_act(q: torch.Tensor, k: torch.Tensor, slope: float) -> torch.Tensor:
    k_dir = normalize(k)
    along = torch.sum(q * k_dir, dim=-1, keepdim=True)
    return q - along * k_dir + k_dir * torch.nn.functional.leaky_relu(along, slope)


def lna(w: dict, prefix: str, v: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    """VecLinear then the activation whose direction is a linear map of the
    linear output (one shared direction when that map has one row)."""
    y = mix(w[f"{prefix}.lin.weight"], v)
    return vn_act(y, mix(w[f"{prefix}.act.lin_dir.weight"], y), slope)


def invariant_heads(w: dict, prefix: str, feat: torch.Tensor, scale_factor: float):
    """(scale, z_so3, z_inv) of a pooled (B, C, 3) feature: z_so3 its
    channel-normalised directions, scale the mean channel norm times
    scale_factor, z_inv the inner products of the normalised fc_inv(feat)
    with z_so3."""
    z_so3 = channel_equi_vec_normalize(feat)
    scale = torch.mean(torch.linalg.norm(feat, dim=-1), dim=-1) * scale_factor
    dual = mix(w[f"{prefix}fc_inv.weight"], feat)
    z_inv = torch.sum(channel_equi_vec_normalize(dual) * z_so3, dim=-1)
    return scale, z_so3, z_inv
