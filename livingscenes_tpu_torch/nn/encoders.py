"""The ablation encoders.

Counterpart of livingscenes_tpu/nn/encoders.py, with JAX's defaults and
parameter names:

* `VecDGCNN`   four VN edge-conv layers on feature-space kNN graphs (the
               layer-0 graph reused unless use_dg), a concat skip, conv_c.
* `VecDGCNNV2` N VN edge-conv layers on a new graph each (use_dg), each
               with a global residual conv on [f, mean_N f].
* `DGCNN`      the plain (non-equivariant) DGCNN: a constant z_so3 frame
               and scale 1.
* `PCNet`      the PCN-style global-feature encoder with LayerNorm (flax's
               epsilon, 1e-6): returns (center, scale, z_so3, z_inv).
* `PointNet`   the SAL-style PointNet: a constant frame and scale 1.

Each but PCNet returns (scale (B,), z_so3 (B, C, 3), z_inv (B, C)). Every
kNN graph goes through ops/cuda_knn.py `knn_auto` (the kernel of
csrc/knn.cu on the card, its plain version on the CPU), on detached
features: indices carry no gradient. The VN edge convs are
nn/edge_conv.py's `EdgeVecLNA` and `GlobalResVecLNA`, which read the
weights of JAX's VecLNA on [nn - x, x] and [f, mean_N f] without building
the (B, N, K, 2C, 3) edge tensor.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.cuda_knn import knn_auto
from .deepsdf import Dense
from .edge_conv import EdgeVecLNA, GlobalResVecLNA, edge_features
from .vec_layers import VecLinear, VecLNA, channel_equi_vec_normalize, leaky_relu


def _knn_idx(h: torch.Tensor, k: int) -> torch.Tensor:
    """The self-kNN graph (B, N, min(k, N)) of features h (B, N, ...),
    flattened per point."""
    flat = h.detach().flatten(2)
    return knn_auto(flat, flat, min(k, h.shape[1]))[1]


def _constant_frame(x: torch.Tensor, c_dim: int, value: float) -> torch.Tensor:
    return torch.full((x.shape[0], c_dim, 3), value, dtype=x.dtype, device=x.device)


class InvariantHeads(nn.Module):
    """z_so3 = channel_equi_vec_normalize(feat), scale = the mean channel
    norm times scale_factor, z_inv = <normalized fc_inv(feat), z_so3>."""

    def __init__(self, c_dim: int):
        super().__init__()
        self.fc_inv = VecLinear(c_dim, c_dim, mode="so3")

    def forward(self, feat: torch.Tensor, scale_factor: float):
        z_so3 = channel_equi_vec_normalize(feat)
        scale = torch.mean(torch.linalg.norm(feat, dim=-1), dim=-1) * scale_factor
        dual = self.fc_inv(feat)
        z_inv = torch.sum(channel_equi_vec_normalize(dual) * z_so3, dim=-1)
        return scale, z_so3, z_inv


class VecDGCNN(nn.Module):
    def __init__(self, hidden_dim: int = 128, c_dim: int = 128,
                 first_layer_knn: int = 16, scale_factor: float = 640.0,
                 leak_neg_slope: float = 0.2, use_dg: bool = False):
        super().__init__()
        self.k, self.scale_factor, self.use_dg = first_layer_knn, scale_factor, use_dg
        act = leaky_relu(leak_neg_slope)
        for i, c_in in enumerate([1] + [hidden_dim] * 3):
            self.add_module(f"conv{i + 1}", EdgeVecLNA(c_in, hidden_dim, act))
        self.conv_c = VecLNA(hidden_dim * 4, c_dim, act, shared_nonlinearity=True,
                             mode="so3")
        self.heads = InvariantHeads(c_dim)

    def forward(self, x: torch.Tensor):
        f = x[:, :, None, :]
        feats, idx = [], None
        for i in range(4):
            graph = _knn_idx(f, self.k) if idx is None else idx
            if not self.use_dg:
                idx = graph  # the layer-0 graph serves every layer
            f = torch.mean(getattr(self, f"conv{i + 1}")(f, f, graph), dim=2)
            feats.append(f)
        feat = torch.mean(self.conv_c(torch.cat(feats, dim=-2)), dim=1)
        return self.heads(feat, self.scale_factor)


class VecDGCNNV2(nn.Module):
    def __init__(self, c_dim: int = 256, num_layers: int = 5,
                 feat_dim: Sequence[int] = (32, 64, 128, 256, 256),
                 num_knn: int = 16, scale_factor: float = 640.0,
                 leak_neg_slope: float = 0.2, use_dg: bool = True,
                 use_res_global_conv: bool = True):
        super().__init__()
        self.num_layers, self.k = num_layers, num_knn
        self.scale_factor, self.use_dg = scale_factor, use_dg
        self.use_res_global_conv = use_res_global_conv
        act = leaky_relu(leak_neg_slope)
        for i in range(num_layers):
            c_in = 1 if i == 0 else feat_dim[i - 1]
            self.add_module(f"conv{i}", EdgeVecLNA(c_in, feat_dim[i], act))
            if use_res_global_conv:
                self.add_module(f"global_conv{i}",
                                GlobalResVecLNA(feat_dim[i], feat_dim[i], act))
        self.conv_c = VecLNA(feat_dim[num_layers - 1], c_dim, act,
                             shared_nonlinearity=True, mode="so3")
        self.heads = InvariantHeads(c_dim)

    def forward(self, x: torch.Tensor):
        f, idx = x[:, :, None, :], None
        for i in range(self.num_layers):
            graph = _knn_idx(f, self.k) if idx is None else idx
            if not self.use_dg:
                idx = graph
            f = torch.mean(getattr(self, f"conv{i}")(f, f, graph), dim=2)
            if self.use_res_global_conv:
                f = getattr(self, f"global_conv{i}")(f, torch.mean(f, dim=1, keepdim=True))
        feat = torch.mean(self.conv_c(f), dim=1)
        return self.heads(feat, self.scale_factor)


class DGCNN(nn.Module):
    """The non-equivariant DGCNN: three dense edge convs on feature-space
    graphs, max over the neighbours, conv_c, max over the points. z_so3 is
    the constant frame of 1/sqrt(3) entries and the scale 1, so that the
    code paths downstream still run."""

    def __init__(self, c_dim: int = 256, hidden_dim: int = 128, num_knn: int = 16):
        super().__init__()
        self.c_dim, self.k = c_dim, num_knn
        widths = [hidden_dim, hidden_dim, hidden_dim * 2]
        for i, (c_in, c_out) in enumerate(zip([3] + widths[:-1], widths)):
            self.add_module(f"conv{i}", Dense(2 * c_in, c_out))
        self.conv_c = Dense(sum(widths), c_dim)

    def forward(self, x: torch.Tensor):
        h, feats = x, []
        for i in range(3):
            h = getattr(self, f"conv{i}")(edge_features(h, h, _knn_idx(h, self.k), dim=-1))
            h = torch.amax(torch.nn.functional.leaky_relu(h, 0.2), dim=2)
            feats.append(h)
        z_inv = torch.amax(self.conv_c(torch.cat(feats, dim=-1)), dim=1)
        z_so3 = _constant_frame(x, self.c_dim, 1.0 / math.sqrt(3.0))
        return torch.ones_like(x[:, 0, 0]), z_so3, z_inv


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis: (x - mean) / sqrt(var + eps)
    * scale + bias, var = max(mean(x^2) - mean(x)^2, 0) (flax's fast
    variance), eps 1e-6."""

    def __init__(self, features: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.clamp_min(torch.mean(x * x, dim=-1, keepdim=True) - mean * mean, 0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


class PCNet(nn.Module):
    """The PCN-style encoder: two point-MLP stages around a global max,
    a tanh projection of the global feature, centre and scale heads, and a
    constant z_so3 frame of ones. Returns (center (B, 1, 3), scale (B,),
    z_so3 (B, output_dim, 3), z_inv (B, output_dim))."""

    def __init__(self, latent_dim: int = 1024, output_dim: int = 256):
        super().__init__()
        self.output_dim = output_dim
        self.fc0, self.ln0 = Dense(3, 128), LayerNorm(128)
        self.fc1 = Dense(128, 256)
        self.fc2, self.ln1 = Dense(512, 512), LayerNorm(512)
        self.fc3 = Dense(512, latent_dim)
        self.mlp, self.ln2 = Dense(latent_dim, output_dim), LayerNorm(output_dim)
        self.head_centroid = Dense(output_dim, 3)
        self.head_scale = Dense(output_dim, 1)

    def forward(self, x: torch.Tensor):
        h = torch.relu(self.ln0(self.fc0(x)))
        h = self.fc1(h)
        g = torch.amax(h, dim=1, keepdim=True)
        h = self.fc2(torch.cat([g.expand_as(h), h], dim=-1))
        h = self.fc3(torch.relu(self.ln1(h)))
        feat = torch.tanh(self.ln2(self.mlp(torch.amax(h, dim=1))))
        center = self.head_centroid(feat)[:, None, :]
        scale = self.head_scale(feat)[:, 0]
        return center, scale, _constant_frame(x, self.output_dim, 1.0), feat


class PointNet(nn.Module):
    """The SAL-style PointNet: fc0, four stages of [h, max_N h] -> dense ->
    ReLU, fc_out of the global max; a constant frame and scale 1."""

    def __init__(self, c_dim: int = 256, hidden_dim: int = 256):
        super().__init__()
        self.c_dim = c_dim
        self.fc0 = Dense(3, hidden_dim)
        for i in range(4):
            self.add_module(f"fc{i + 1}", Dense(2 * hidden_dim, hidden_dim))
        self.fc_out = Dense(hidden_dim, c_dim)

    def forward(self, x: torch.Tensor):
        h = self.fc0(x)
        for i in range(4):
            g = torch.amax(h, dim=1, keepdim=True)
            h = torch.relu(getattr(self, f"fc{i + 1}")(torch.cat([h, g.expand_as(h)], dim=-1)))
        z_inv = self.fc_out(torch.amax(h, dim=1))
        z_so3 = _constant_frame(x, self.c_dim, 1.0 / math.sqrt(3.0))
        return torch.ones_like(x[:, 0, 0]), z_so3, z_inv
