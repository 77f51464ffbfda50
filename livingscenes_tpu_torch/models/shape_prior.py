"""The shape prior's encode surface: SIM(3) pre-normalization, the encoder,
and code transport.

Counterpart of livingscenes_tpu/models/shape_prior.py (`ShapePriorConfig`,
`ShapePrior.normalize_input`, `encode`, `encode_fps`, `transform_codes`).
Codes are the dict {"z_so3": (B, C, 3), "z_inv": (B, C), "s": (B,),
"t": (B, 1, 3)}. Two behaviours of the reference stay: a cloud of identical
points gives NaN codes (its scale statistic is 0), and `t` is
SE(3)-equivariant but not SIM(3)-equivariant.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..nn.vec_dgcnn_attn import VecDGCNNAttn
from ..nn.vec_layers import VecLinear
from ..ops.cuda_fps import fps_auto
from ..ops.cuda_knn import knn_with_topk_scale

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ShapePriorConfig:
    """The encoder's production hyperparameters
    (configs/3rscan/dgcnn_attn_inner.yaml)."""

    c_dim: int = 256
    num_layers: int = 7
    feat_dim: tuple = (32, 32, 64, 64, 128, 256, 512)
    down_sample_layers: tuple = (2, 4, 5)
    down_sample_factor: tuple = (2, 4, 4)
    atten_start_layer: int = 2
    atten_multi_head_c: int = 16
    num_knn: int = 16
    scale_factor: float = 64000.0
    n_pcl: int = 1024  # encoder input size
    # The fused path (the JAX field's name): on the card the encoder's
    # layers run as fused CUDA kernels and `encode` takes the scale and the
    # layer-0 graph from one kernel; on the CPU the plain versions of the
    # same functions run. The parameters do not depend on it.
    pallas_attention: bool = False


class ShapePrior(nn.Module):
    """The encoder with its parameters, on one device.

    `device` defaults to the card and raises without one; pass
    `device="cpu"` to run on the CPU. Weights start uniform in
    +-1/sqrt(fan_in), drawn from a `torch.Generator` seeded with `seed`;
    load trained ones with `load_state_dict(params_from_jax(...))`.
    """

    def __init__(self, config: ShapePriorConfig | None = None, device=None,
                 dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self.config = config or ShapePriorConfig()
        device = resolve_device(device)
        c = self.config
        self.encoder = VecDGCNNAttn(
            c_dim=c.c_dim,
            num_layers=c.num_layers,
            feat_dim=c.feat_dim,
            down_sample_layers=c.down_sample_layers,
            down_sample_factor=c.down_sample_factor,
            atten_start_layer=c.atten_start_layer,
            atten_multi_head_c=c.atten_multi_head_c,
            num_knn=c.num_knn,
            scale_factor=c.scale_factor,
            pallas_attention=c.pallas_attention,
        )
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, VecLinear):
                module.reset_parameters(gen)
        self.to(device=device, dtype=dtype)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.parameters()).dtype

    def normalize_input(self, pc: torch.Tensor):
        """Centre each (B, N, 3) cloud and divide by the mean of the five
        largest entries of its full N x N distance matrix (symmetric
        duplicates included). Returns (normalized, centroid (B, 3),
        scale0 (B,))."""
        centroid = torch.mean(pc, dim=1)
        centered = pc - centroid[:, None, :]
        B = pc.shape[0]
        cx, cy, cz = centered.unbind(-1)
        dx = cx[:, :, None] - cx[:, None, :]
        dy = cy[:, :, None] - cy[:, None, :]
        dz = cz[:, :, None] - cz[:, None, :]
        d2 = (dx * dx + dy * dy) + dz * dz
        # sqrt is monotone: the top five of d2 are the top five of d.
        top5 = torch.topk(d2.reshape(B, -1), 5, dim=-1).values
        scale0 = torch.mean(torch.sqrt(torch.clamp_min(top5, 0.0)), dim=-1)
        return centered / scale0[:, None, None], centroid, scale0

    def encode(self, pc: torch.Tensor) -> Codes:
        """Encode (B, N, 3) clouds into codes.

        With `pallas_attention`, clouds whose N the fused front end takes
        (N a multiple of min(256, N), the JAX condition) get their scale and
        their layer-0 graph from one pass over the centred cloud: dividing
        by the scale does not change the order of the neighbours. For any
        other N the CPU takes `normalize_input`; on the card that needs the
        scale kernel, which is not ported yet."""
        N = pc.shape[1]
        if self.config.pallas_attention and N % min(256, N) == 0:
            centroid = torch.mean(pc, dim=1)
            centered = pc - centroid[:, None, :]
            idx0, scale0 = knn_with_topk_scale(
                centered.detach(), min(self.config.num_knn, N))
            out = self.encoder(centered / scale0[:, None, None],
                               first_knn_idx=idx0)
        else:
            if self.config.pallas_attention and pc.device.type != "cpu":
                raise NotImplementedError(
                    f"pallas_attention=True with N={N}, not a multiple of "
                    "min(256, N), needs the scale kernel (kernel table row "
                    "8), which is not ported yet")
            normalized, centroid, scale0 = self.normalize_input(pc)
            out = self.encoder(normalized)
        center, pred_scale, z_so3, z_inv = out
        return {
            "z_so3": z_so3,
            "z_inv": z_inv,
            "s": scale0 * pred_scale,
            "t": (center[:, 0, :] + centroid)[:, None, :],
        }

    def encode_fps(self, pc: torch.Tensor, mask: torch.Tensor | None = None) -> Codes:
        """FPS-downsample each padded (B, N, 3) cloud with its (B, N)
        validity mask to `n_pcl` points, then encode (one FPS start, at
        index 0: the JAX `n_fps=1`)."""
        sampled, _ = fps_auto(pc, self.config.n_pcl, mask=mask)
        return self.encode(sampled)


def transform_codes(codes: Codes, tsfm: torch.Tensor) -> Codes:
    """Carry codes through (B, 3/4, 4) transforms: z_so3 -> z_so3 R^T,
    t -> t R^T + p; z_inv and s are invariant."""
    Rt = tsfm[..., :3, :3].transpose(-1, -2)
    p = tsfm[..., :3, 3]
    return {
        "z_so3": torch.matmul(codes["z_so3"], Rt),
        "z_inv": codes["z_inv"],
        "s": codes["s"],
        "t": torch.matmul(codes["t"], Rt) + p[..., None, :],
    }
