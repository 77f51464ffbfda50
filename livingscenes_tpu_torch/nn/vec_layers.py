"""SIM(3)-equivariant vector-neuron layers (the so3 modes the production
encoder uses).

Counterpart of livingscenes_tpu/nn/vec_layers.py. Features are
(..., C, 3); every weight keeps the torch (out, in) orientation, so the
state-dict keys are those of the reference model (`lin.weight`,
`act.lin_dir.weight`, ...). Equivariance: f(s R x) = s R f(x).
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn


def _normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=dim, keepdim=True), eps)


def channel_equi_vec_normalize(x: torch.Tensor) -> torch.Tensor:
    """Per-channel direction times the channel norm normalized across
    channels: SO(3)-equivariant and scale-invariant. x: (..., C, 3)."""
    x_dir = _normalize(x, dim=-1)
    x_norm = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x_dir * _normalize(x_norm, dim=-2)


def leaky_relu(slope: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda x: torch.nn.functional.leaky_relu(x, negative_slope=slope)


class VecLinear(nn.Module):
    """Channel mixing v_out[o] = sum_c W[o, c] v_in[c] (so3 mode)."""

    def __init__(self, v_in: int, v_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(v_out, v_in))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = math.sqrt(1.0 / self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return torch.einsum("oc,...ci->...oi", self.weight, v)


def so3_activation(
    q: torch.Tensor, k: torch.Tensor, act: Callable[[torch.Tensor], torch.Tensor]
) -> torch.Tensor:
    """Apply `act` to the component of q along the direction of k and keep
    the orthogonal part."""
    k_dir = _normalize(k, dim=-1)
    q_para = torch.sum(q * k_dir, dim=-1, keepdim=True)
    return q - q_para * k_dir + k_dir * act(q_para)


class VecActivation(nn.Module):
    """Direction-gated nonlinearity; the direction is a learned linear map
    of the input (one shared direction with `shared_nonlinearity`)."""

    def __init__(self, in_features: int, act_func, shared_nonlinearity: bool = False):
        super().__init__()
        self.act_func = act_func
        self.lin_dir = VecLinear(in_features, 1 if shared_nonlinearity else in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return so3_activation(x, self.lin_dir(x), self.act_func)


class VecLNA(nn.Module):
    """VecLinear followed by VecActivation."""

    def __init__(self, in_features: int, out_features: int, act_func,
                 shared_nonlinearity: bool = False):
        super().__init__()
        self.lin = VecLinear(in_features, out_features)
        self.act = VecActivation(out_features, act_func, shared_nonlinearity)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        return self.act(self.lin(v))


class VecResBlock(nn.Module):
    """fc0 (VecLNA) -> lin1 (VecLinear), plus a linear shortcut when the
    channel counts differ, then act2 (VecActivation)."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: int, act_func):
        super().__init__()
        self.fc0 = VecLNA(in_features, hidden_features, act_func)
        self.lin1 = VecLinear(hidden_features, out_features)
        self.shortcut = (
            VecLinear(in_features, out_features)
            if in_features != out_features else None
        )
        self.act2 = VecActivation(out_features, act_func)

    def forward(self, v: torch.Tensor) -> torch.Tensor:
        dv = self.lin1(self.fc0(v))
        v_s = v if self.shortcut is None else self.shortcut(v)
        return self.act2(v_s + dv)
