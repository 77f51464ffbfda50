"""The DeepSDF implicit-field decoder.

Counterpart of livingscenes_tpu/nn/deepsdf.py (`WNDense`,
`DeepSDFDecoder`): an 8 x 768 MLP whose input, the invariant query
[z_inv (256) | <q, z_so3> (256) | |q| (1)], is concatenated back in at
layer 4, with ReLU, dropout in train mode only (flax's: keep with
probability 1 - p and scale by 1 / (1 - p), the masks drawn from a
`torch.Generator` the caller passes), and a final tanh. Layers 0-7
are weight-normalized, a ninth (the production decoder's output layer) is a
plain dense layer. The large matrix products stay `F.linear`, as they are
plain matmuls in the JAX package. `v` and `kernel` keep the flax (in, out)
orientation and the flax names, so a flax tree loads without a transpose.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn
from torch.nn import functional as F

# The layers that are weight-normalized and that drop out in train mode: the
# JAX decoder's defaults, which no configuration changes.
_NORM_LAYERS = tuple(range(8))
_DROPOUT_LAYERS = tuple(range(8))


class WNDense(nn.Module):
    """Dense layer with weight normalization per output:
    W = v * g / max(|v|_column, 1e-12), y = x W + b. v is (in, out)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.v = nn.Parameter(torch.empty(in_features, features))
        self.g = nn.Parameter(torch.empty(features))
        self.b = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """v and b uniform in +-1/sqrt(in); g = |v| per output, so that the
        effective matrix at the start is v itself (the flax init)."""
        bound = 1.0 / math.sqrt(self.v.shape[0])
        with torch.no_grad():
            self.v.uniform_(-bound, bound, generator=generator)
            self.b.uniform_(-bound, bound, generator=generator)
            self.g.copy_(torch.linalg.norm(self.v, dim=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.norm(self.v, dim=0, keepdim=True)
        w = self.v * (self.g[None, :] / torch.clamp_min(norm, 1e-12))
        return F.linear(x, w.t(), self.b)


class Dense(nn.Module):
    """Plain dense layer y = x kernel + bias; kernel is (in, out)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Both uniform in +-1/sqrt(in) (flax draws a LeCun-normal kernel
        and a zero bias; random starts are not compared)."""
        bound = 1.0 / math.sqrt(self.kernel.shape[0])
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)
            self.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.kernel.t(), self.bias)


class DeepSDFDecoder(nn.Module):
    """DeepSDF MLP: (..., latent_size + pe_dim) -> (...,) values in (-1, 1).
    The layer before each index of `latent_in` emits `dims[0]` fewer
    features, and the input is concatenated back in at that index."""

    def __init__(self, latent_size: int = 256, dims: Sequence[int] = (768,) * 8,
                 dropout_prob: float = 0.2, latent_in: Sequence[int] = (4,),
                 pe_dim: int = 257):
        super().__init__()
        widths = [latent_size + pe_dim] + list(dims) + [1]
        self.latent_in = tuple(latent_in)
        self.dropout_prob = dropout_prob
        self.lin = nn.ModuleList()
        for layer in range(len(widths) - 1):
            out_dim = widths[layer + 1]
            if layer + 1 in self.latent_in:
                out_dim -= widths[0]
            kind = WNDense if layer in _NORM_LAYERS else Dense
            self.lin.append(kind(widths[layer], out_dim))

    def forward(self, x: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """In train mode with dropout_prob > 0 the layers of _DROPOUT_LAYERS
        drop out with masks drawn from `generator` (on x's device), which is
        then required."""
        drop = self.training and self.dropout_prob > 0.0
        if drop and generator is None:
            raise ValueError("DeepSDFDecoder in train mode needs a generator "
                             "for its dropout masks")
        last = len(self.lin) - 1
        h = x
        for layer, module in enumerate(self.lin):
            if layer in self.latent_in:
                h = torch.cat([h, x], dim=-1)
            h = module(h)
            if layer < last:
                h = torch.relu(h)
                if drop and layer in _DROPOUT_LAYERS:
                    h = dropout(h, self.dropout_prob, generator)
        return torch.tanh(h)[..., 0]


def dropout(h: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """flax.linen.Dropout: keep each entry with probability 1 - p and scale
    the kept ones by 1 / (1 - p)."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - p
    return torch.where(keep, h / (1.0 - p), torch.zeros((), dtype=h.dtype,
                                                       device=h.device))
