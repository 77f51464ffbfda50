"""SIM(3)-equivariant vector-neuron layers.

Counterpart of livingscenes_tpu/nn/vec_layers.py. Features are (..., C, 3);
every weight keeps the torch (out, in) orientation, so the state-dict keys
are those of the reference model (`lin.weight`, `act.lin_dir.weight`, ...),
and the scalar paths' dense layers keep flax's names and (in, out) kernels
(`sv_linear`, `vs_linear`, `ss_linear`, `s_shortcut`).

Equivariance:
  so3 mode:  f(s R x) = s R f(x)
  se3 mode:  f(s R x + t) = s R f(x) + t  (per-channel translation)

As JAX's, the layers default to mode="se3"; every layer of the encoders
asks for so3 by name.
"""
from __future__ import annotations

import math
from typing import Callable

import torch
from torch import nn

from .deepsdf import Dense


def safe_divide(x: torch.Tensor, y: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """x / y with eps added, with y's sign, only to denominators below eps
    in magnitude."""
    unstable = (torch.abs(y) < eps).to(y.dtype) * torch.sign(y)
    return x / (y + unstable * eps)


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


def bf16_operands(*xs: torch.Tensor):
    """Each float32 tensor rounded to bfloat16 and cast back: a float32
    product of two such values is exact, so a float32 matmul of them is
    JAX's bfloat16 product with float32 accumulation
    (preferred_element_type) up to the order of the sum."""
    return tuple(x.to(torch.bfloat16).to(torch.float32) for x in xs)


class VecLinear(nn.Module):
    """Channel mixing v_out[o] = sum_c W[o, c] v_in[c], with optional scalar
    paths.

    se3 mode: each row of W sums to 1 (an affine combination of points),
    stored as (v_out, v_in - 1) free weights whose last column is 1 - sum.
    s_in > 0: an invariant per-channel scale from the scalar input
    (`sv_linear`, normalized with s2v_normalized_scale) multiplies the
    (centred in se3 mode) vector output. s_out > 0: scalars from inner
    products with a learned direction field (`vs_dir_linear`, `vs_linear`,
    plus `ss_linear` of the scalar input); forward then returns (v, s).
    `cross`: a cross product with a second linear map of the input
    (`v_out_cross`), mixed back by `v_out_cross_fc`. `mm_bf16`: the
    channel mixing of float32 inputs takes bfloat16 operands (see
    bf16_operands).
    """

    def __init__(self, v_in: int, v_out: int, s_in: int = 0, s_out: int = 0,
                 mode: str = "se3", s2v_normalized_scale: bool = True,
                 cross: bool = False, mm_bf16: bool = False):
        super().__init__()
        if mode not in ("so3", "se3"):
            raise ValueError(f"VecLinear: unknown mode {mode!r}")
        self.v_in, self.v_out, self.s_in, self.s_out = v_in, v_out, s_in, s_out
        self.mode, self.cross, self.mm_bf16 = mode, cross, mm_bf16
        self.s2v_normalized_scale = s2v_normalized_scale
        if v_out > 0:
            cols = v_in - 1 if self.se3 else v_in
            self.weight = nn.Parameter(torch.empty(v_out, cols))
        if s_in > 0 and v_out > 0:
            self.sv_linear = Dense(s_in, v_out)
        if v_out > 0 and cross:
            self.v_out_cross = VecLinear(v_in, v_out, mode=mode, mm_bf16=mm_bf16)
            self.v_out_cross_fc = VecLinear(2 * v_out, v_out, mode=mode,
                                            mm_bf16=mm_bf16)
        if s_out > 0:
            self.vs_dir_linear = VecLinear(v_in, v_in, mode="so3")
            self.vs_linear = Dense(v_in, s_out)
            if s_in > 0:
                self.ss_linear = Dense(s_in, s_out)

    @property
    def se3(self) -> bool:
        return self.mode == "se3"

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Uniform in +-sqrt(1 / fan_in), plus 1 / v_in in se3 mode (JAX's
        init)."""
        if self.v_out <= 0:
            return
        bound = math.sqrt(1.0 / self.weight.shape[1])
        with torch.no_grad():
            self.weight.uniform_(-bound, bound, generator=generator)
            if self.se3:
                self.weight.add_(1.0 / self.v_in)

    def full_weight(self) -> torch.Tensor:
        """The (v_out, v_in) mixing matrix (se3: with its last column)."""
        if not self.se3:
            return self.weight
        last = 1.0 - torch.sum(self.weight, dim=-1, keepdim=True)
        return torch.cat([self.weight, last], dim=-1)

    def forward(self, v: torch.Tensor, s: torch.Tensor | None = None):
        """v (..., v_in, 3); s (..., s_in) or None."""
        v_out = None
        if self.v_out > 0:
            W = self.full_weight()
            if self.mm_bf16 and v.dtype == torch.float32:
                W, v_mm = bf16_operands(W, v)
            else:
                v_mm = v
            v_out = torch.einsum("oc,...ci->...oi", W, v_mm)

        if self.s_in > 0 and self.v_out > 0:
            if s is None:
                raise ValueError("VecLinear: missing scalar input")
            scale = self.sv_linear(s)
            if self.s2v_normalized_scale:
                scale = _normalize(scale, dim=-1)
            if self.se3:
                v_mean = torch.mean(v_out, dim=-2, keepdim=True)
                v_out = (v_out - v_mean) * scale[..., None] + v_mean
            else:
                v_out = v_out * scale[..., None]

        if self.v_out > 0 and self.cross:
            v_dual = self.v_out_cross(v)
            if self.se3:
                dual_o = torch.mean(v_dual, dim=-2, keepdim=True)
                out_o = torch.mean(v_out, dim=-2, keepdim=True)
                v_cross = torch.cross(channel_equi_vec_normalize(v_dual - dual_o),
                                      v_out - out_o, dim=-1)
            else:
                v_cross = torch.cross(channel_equi_vec_normalize(v_dual), v_out,
                                      dim=-1)
            v_out = self.v_out_cross_fc(torch.cat([v_cross + v_out, v_out], dim=-2))

        if self.s_out > 0:
            v_sR = v - torch.mean(v, dim=-2, keepdim=True) if self.se3 else v
            dual_dir = _normalize(self.vs_dir_linear(v_sR), dim=-1)
            s_from_v = _normalize(torch.sum(v_sR * dual_dir, dim=-1), dim=-1)
            s_out = self.vs_linear(s_from_v)
            if self.s_in > 0:
                s_out = self.ss_linear(s) + s_out
            return v_out, s_out
        return v_out


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
    of the input (one shared direction with `shared_nonlinearity`). In se3
    mode an origin (`lin_ori`) is predicted too, and the activation acts
    about it."""

    def __init__(self, in_features: int, act_func, shared_nonlinearity: bool = False,
                 mode: str = "se3", cross: bool = False, mm_bf16: bool = False):
        super().__init__()
        self.act_func, self.mode = act_func, mode
        n_out = 1 if shared_nonlinearity else in_features
        self.lin_dir = VecLinear(in_features, n_out, mode=mode, cross=cross,
                                 mm_bf16=mm_bf16)
        if mode == "se3":
            self.lin_ori = VecLinear(in_features, n_out, mode=mode, cross=cross,
                                     mm_bf16=mm_bf16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode != "se3":
            return so3_activation(x, self.lin_dir(x), self.act_func)
        o = self.lin_ori(x)
        return so3_activation(x - o, self.lin_dir(x) - o, self.act_func) + o


class VecLNA(nn.Module):
    """VecLinear followed by VecActivation; with s_out_features > 0 it
    takes and returns (v, s), the scalars through act_func."""

    def __init__(self, in_features: int, out_features: int, act_func,
                 shared_nonlinearity: bool = False, s_in_features: int = 0,
                 s_out_features: int = 0, mode: str = "se3", cross: bool = False,
                 mm_bf16: bool = False):
        super().__init__()
        self.act_func = act_func
        self.s_out_features = s_out_features
        self.lin = VecLinear(in_features, out_features, s_in=s_in_features,
                             s_out=s_out_features, mode=mode, cross=cross,
                             mm_bf16=mm_bf16)
        self.act = VecActivation(out_features, act_func, shared_nonlinearity,
                                 mode=mode, cross=cross, mm_bf16=mm_bf16)

    def forward(self, v: torch.Tensor, s: torch.Tensor | None = None):
        if self.s_out_features > 0:
            v_out, s_out = self.lin(v, s)
            return self.act(v_out), self.act_func(s_out)
        return self.act(self.lin(v, s))


class VecResBlock(nn.Module):
    """fc0 (VecLNA) -> lin1 (VecLinear), plus a linear shortcut when the
    channel counts differ; in se3 mode a `subtract` map removes the
    translation that the sum of two se3 paths counts twice; then act2
    (VecActivation) unless last_activate is off. With scalar features the
    scalars take the same route (s_shortcut a dense layer when their
    counts differ) and forward returns (v, s)."""

    def __init__(self, in_features: int, out_features: int,
                 hidden_features: int, act_func, mode: str = "se3",
                 s_in_features: int = 0, s_out_features: int = 0,
                 s_hidden_features: int = 0, last_activate: bool = True,
                 cross: bool = False):
        super().__init__()
        self.act_func, self.mode, self.last_activate = act_func, mode, last_activate
        self.s_in_features = s_in_features
        self.s_out_features = s_out_features
        self.fc0 = VecLNA(in_features, hidden_features, act_func,
                          s_in_features=s_in_features,
                          s_out_features=s_hidden_features, mode=mode, cross=cross)
        self.lin1 = VecLinear(hidden_features, out_features, s_in=s_hidden_features,
                              s_out=s_out_features, mode=mode, cross=cross)
        self.shortcut = (VecLinear(in_features, out_features, mode=mode)
                         if in_features != out_features else None)
        if mode == "se3":
            self.subtract = VecLinear(in_features, out_features, mode="se3")
        if last_activate:
            self.act2 = VecActivation(out_features, act_func, False, mode=mode,
                                      cross=cross)
        if (s_in_features > 0 and s_out_features > 0
                and s_in_features != s_out_features):
            self.s_shortcut = Dense(s_in_features, s_out_features)

    def forward(self, v: torch.Tensor, s: torch.Tensor | None = None):
        if self.s_in_features == 0:
            s = None
        out = self.fc0(v, s)
        v_net, s_net = out if isinstance(out, tuple) else (out, None)
        out = self.lin1(v_net, s_net)
        dv, ds = out if isinstance(out, tuple) else (out, None)
        v_s = v if self.shortcut is None else self.shortcut(v)
        v_out = v_s + dv
        if self.mode == "se3":
            v_out = v_out - self.subtract(v)
        if self.last_activate:
            v_out = self.act2(v_out)
        if ds is None:
            return v_out
        if hasattr(self, "s_shortcut"):
            s_out = self.s_shortcut(s) + ds
        elif s is not None:
            s_out = s + ds
        else:
            s_out = ds
        if self.last_activate:
            s_out = self.act_func(s_out)
        return v_out, s_out


def vec_mean_pool(x: torch.Tensor, dim: int = -3) -> torch.Tensor:
    """Mean pool over a point or neighbour axis of (..., N, C, 3)."""
    return torch.mean(x, dim=dim)


def _take_max(x: torch.Tensor, q_para: torch.Tensor) -> torch.Tensor:
    """x (..., N, C, 3), q_para (..., N, C): per channel, the vector of x
    at the first index of the largest q_para over N (jnp.argmax's pick)."""
    n = q_para.shape[-2]
    top = torch.amax(q_para, dim=-2, keepdim=True)
    ar = torch.arange(n, device=x.device).view(*([1] * (q_para.dim() - 2)), n, 1)
    first = torch.amin(torch.where(q_para == top, ar, n), dim=-2)  # (..., C)
    idx = first[..., None, :, None].expand(*x.shape[:-3], 1, x.shape[-2], 3)
    return torch.gather(x, -3, idx)[..., 0, :, :]


class VecMaxPool(nn.Module):
    """Equivariant max or attention pooling over the point axis of
    (..., N, C, 3). A key field comes from a per-point linear map
    (k_prediction "lin") or the pooled mean through a residual block
    (k_prediction "mean", `attention_blk`); with softmax_factor > 0 the
    invariant q.k similarity weighs a softmax over N, otherwise each channel
    takes the vector whose component along the key is largest (the first
    such index). forward(x, return_weight) returns the pooled (..., C, 3),
    or (pooled, weights or None)."""

    def __init__(self, in_features: int, mode: str = "se3",
                 softmax_factor: float = -1.0, k_prediction: str = "lin",
                 attention_k_blk: bool = True,
                 softmax_norm_compression: str = "sigmoid",
                 shared_nonlinearity: bool = False):
        super().__init__()
        if k_prediction not in ("lin", "mean"):
            raise NotImplementedError(k_prediction)
        self.mode, self.softmax_factor = mode, softmax_factor
        self.k_prediction = k_prediction
        self.compression = softmax_norm_compression
        n_out = 1 if shared_nonlinearity else in_features
        if k_prediction == "lin":
            self.lin_dir = VecLinear(in_features, n_out, mode=mode)
        elif attention_k_blk:
            self.attention_blk = VecResBlock(in_features, in_features, in_features,
                                             leaky_relu(0.2), mode=mode,
                                             last_activate=False)
        if mode == "se3":
            self.lin_ori = VecLinear(in_features, n_out, mode=mode)

    def _compress(self, x: torch.Tensor) -> torch.Tensor:
        ln = torch.linalg.norm(x, dim=-1, keepdim=True)
        direction = x / torch.clamp_min(ln, 1e-12)
        if self.compression == "sigmoid":
            return direction * torch.sigmoid(ln)
        return direction * (1.0 - torch.exp(-ln))

    def forward(self, x: torch.Tensor, return_weight: bool = False):
        q = x
        if self.k_prediction == "lin":
            k = self.lin_dir(x)
        else:
            k = torch.mean(x, dim=-3, keepdim=True)
            if hasattr(self, "attention_blk"):
                k = self.attention_blk(k)
        if self.mode == "se3":
            o = self.lin_ori(x)
            q, k = q - o, k - o
        k_scale = torch.linalg.norm(torch.mean(k, dim=-2, keepdim=True), dim=-1,
                                    keepdim=True)
        k = k.expand(q.shape)
        k_inv = self._compress(safe_divide(k, k_scale))
        if self.softmax_factor > 0.0:
            q_inv = self._compress(safe_divide(q, k_scale))
            sim = torch.mean(q_inv * k_inv, dim=-1, keepdim=True)
            w = torch.softmax(self.softmax_factor * sim, dim=-3)
            out = torch.sum(x * w, dim=-3)
            return (out, w) if return_weight else out
        out = _take_max(x, torch.sum(q * k_inv, dim=-1))
        return (out, None) if return_weight else out


class VecMaxPoolV2(nn.Module):
    """The v2 pooling: the key is the pooled mean through `attention_blk`,
    and channel-wise normalization factors the scale out (no
    safe_divide). Same outputs as VecMaxPool."""

    def __init__(self, in_features: int, mode: str = "se3",
                 softmax_factor: float = -1.0, attention_k_blk: bool = True):
        super().__init__()
        self.mode, self.softmax_factor = mode, softmax_factor
        if attention_k_blk:
            self.attention_blk = VecResBlock(in_features, in_features, in_features,
                                             leaky_relu(0.2), mode=mode,
                                             last_activate=False)
        if mode == "se3":
            self.lin_ori = VecLinear(in_features, in_features, mode=mode)

    def forward(self, x: torch.Tensor, return_weight: bool = False):
        q = x
        k = torch.mean(x, dim=-3, keepdim=True)
        if hasattr(self, "attention_blk"):
            k = self.attention_blk(k)
        if self.mode == "se3":
            o = self.lin_ori(k)
            q, k = q - o, k - o
        k_inv = channel_equi_vec_normalize(k)
        if self.softmax_factor > 0.0:
            q_inv = channel_equi_vec_normalize(q)
            sim = torch.mean(q_inv * k_inv, dim=-1, keepdim=True)
            w = torch.softmax(self.softmax_factor * sim, dim=-3)
            out = torch.sum(x * w, dim=-3)
            return (out, w) if return_weight else out
        out = _take_max(x, torch.sum(q * k_inv.expand(q.shape), dim=-1))
        return (out, None) if return_weight else out
