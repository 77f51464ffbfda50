"""The OccNet decoder family.

Counterpart of livingscenes_tpu/nn/onet_decoder.py (`ResnetBlockFC`,
`Decoder`, `CondScale`, `CResnetBlockConv1d`, `DecoderCBatchNorm`). The
conditional batch norm of the reference is, as in JAX, a per-sample
affine from the code over a normalization across the features (`CondScale`,
the population variance). Names and (in, out) kernels are flax's; the
zero initializers stay (fc_1's kernel, conv_gamma's and conv_beta's
kernels; the biases of these layers start, as flax's, at 0, conv_gamma's
at 1). `DecoderCat` is in nn/deepsdf.py.
No pipeline reaches these decoders.
"""
from __future__ import annotations

import torch
from torch import nn

from .deepsdf import Dense


class DenseNoBias(nn.Module):
    """y = x kernel; kernel (in, out) (flax nn.Dense with use_bias=False)."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        bound = 1.0 / self.kernel.shape[0] ** 0.5
        with torch.no_grad():
            self.kernel.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel


def _zero_kernel(layer: Dense, bias: float) -> None:
    with torch.no_grad():
        layer.kernel.zero_()
        layer.bias.fill_(bias)


class ResnetBlockFC(nn.Module):
    """x + fc_1(relu(fc_0(relu(x)))), the shortcut a bias-free dense layer
    when size_in != size_out; size_h defaults to min(size_in, size_out)."""

    def __init__(self, size_in: int, size_out: int, size_h: int | None = None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.fc_0 = Dense(size_in, size_h)
        self.fc_1 = Dense(size_h, size_out)
        self.shortcut = (DenseNoBias(size_in, size_out)
                         if size_in != size_out else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _zero_kernel(self.fc_1, 0.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(torch.relu(x))
        dx = self.fc_1(torch.relu(net))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class Decoder(nn.Module):
    """Latent injection by addition: p (B, M, dim), c (B, c_dim) -> (B, M)."""

    def __init__(self, dim: int = 3, c_dim: int = 128, hidden_size: int = 256,
                 n_blocks: int = 5):
        super().__init__()
        self.c_dim, self.n_blocks = c_dim, n_blocks
        self.fc_p = Dense(dim, hidden_size)
        for i in range(n_blocks):
            if c_dim > 0:
                self.add_module(f"fc_c{i}", Dense(c_dim, hidden_size))
            self.add_module(f"block{i}", ResnetBlockFC(hidden_size, hidden_size))
        self.fc_out = Dense(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.fc_p(p)
        for i in range(self.n_blocks):
            if self.c_dim > 0:
                h = h + getattr(self, f"fc_c{i}")(c)[:, None]
            h = getattr(self, f"block{i}")(h)
        return self.fc_out(torch.relu(h))[..., 0]


class CondScale(nn.Module):
    """gamma(c) (x - mean) / sqrt(var + 1e-5) + beta(c), the mean and the
    population variance over the features of x (B, M, F); c (B, c_dim)."""

    def __init__(self, c_dim: int, features: int):
        super().__init__()
        self.conv_gamma = Dense(c_dim, features)
        self.conv_beta = Dense(c_dim, features)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _zero_kernel(self.conv_gamma, 1.0)
        _zero_kernel(self.conv_beta, 0.0)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        gamma = self.conv_gamma(c)
        beta = self.conv_beta(c)
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.var(x, dim=-1, keepdim=True, correction=0)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        return gamma[:, None] * xn + beta[:, None]


class CResnetBlockConv1d(nn.Module):
    """The conditional residual block: bn_0, fc_0, bn_1, fc_1 (zero init),
    and a bias-free shortcut when the sizes differ."""

    def __init__(self, c_dim: int, size_in: int, size_out: int,
                 size_h: int | None = None):
        super().__init__()
        size_h = size_h or min(size_in, size_out)
        self.bn_0 = CondScale(c_dim, size_in)
        self.fc_0 = Dense(size_in, size_h)
        self.bn_1 = CondScale(c_dim, size_h)
        self.fc_1 = Dense(size_h, size_out)
        self.shortcut = (DenseNoBias(size_in, size_out)
                         if size_in != size_out else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _zero_kernel(self.fc_1, 0.0)

    def forward(self, x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        net = self.fc_0(torch.relu(self.bn_0(x, c)))
        dx = self.fc_1(torch.relu(self.bn_1(net, c)))
        x_s = x if self.shortcut is None else self.shortcut(x)
        return x_s + dx


class DecoderCBatchNorm(nn.Module):
    """The conditioned decoder: fc_p, n_blocks CResnetBlockConv1d, bn_out,
    fc_out; p (B, M, dim), c (B, c_dim) -> (B, M)."""

    def __init__(self, dim: int = 3, c_dim: int = 128, hidden_size: int = 256,
                 n_blocks: int = 5):
        super().__init__()
        self.n_blocks = n_blocks
        self.fc_p = Dense(dim, hidden_size)
        for i in range(n_blocks):
            self.add_module(f"block{i}",
                            CResnetBlockConv1d(c_dim, hidden_size, hidden_size))
        self.bn_out = CondScale(c_dim, hidden_size)
        self.fc_out = Dense(hidden_size, 1)

    def forward(self, p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
        h = self.fc_p(p)
        for i in range(self.n_blocks):
            h = getattr(self, f"block{i}")(h, c)
        return self.fc_out(torch.relu(self.bn_out(h, c)))[..., 0]


def init_parameters(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every dense layer of `module` from `generator`, then apply the
    zero initializers (each block's after its layers'); returns module."""
    for m in module.modules():
        if isinstance(m, (Dense, DenseNoBias)):
            m.reset_parameters(generator)
    for m in module.modules():
        if isinstance(m, (ResnetBlockFC, CondScale, CResnetBlockConv1d)):
            m.reset_parameters(generator)
    return module
