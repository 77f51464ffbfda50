"""The shape prior: SIM(3) pre-normalization, the equivariant encoder, the
invariant SDF field, and code transport.

Counterpart of livingscenes_tpu/models/shape_prior.py (`ShapePriorConfig`,
`ShapePrior.normalize_input`, `encode`, `encode_fps`, `invariant_query`,
`decode_sdf`, `occupancy_logits`, `transform_codes`), without the
positional-encoding tail of the query and without reduced-precision decoder
matmuls.
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
from ..nn.deepsdf import DeepSDFDecoder, Dense, WNDense
from ..nn.vec_dgcnn_attn import VecDGCNNAttn
from ..nn.vec_layers import VecLinear
from ..ops.cuda_fps import fps_auto
from ..ops.cuda_knn import knn_with_topk_scale
from ..ops.cuda_scale import (
    top_k_mean_pairwise_distance,
    top_k_mean_pairwise_distance_plain,
)

Codes = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ShapePriorConfig:
    """The production hyperparameters of encoder and decoder
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
    decoder_dims: tuple = (768,) * 8
    decoder_dropout_prob: float = 0.2
    decoder_latent_in: tuple = (4,)
    sdf2occ_factor: float = -1.0
    n_pcl: int = 1024  # encoder input size
    # The fused path (the JAX field's name): on the card the encoder's
    # layers run as fused CUDA kernels and `encode` takes the scale (and,
    # for N a multiple of min(256, N), the layer-0 graph) from a kernel; on
    # the CPU the plain versions of the same functions run. The parameters
    # do not depend on it.
    pallas_attention: bool = False


class ShapePrior(nn.Module):
    """Encoder and decoder with their parameters, on one device.

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
        self.decoder = DeepSDFDecoder(
            latent_size=c.c_dim,
            dims=c.decoder_dims,
            dropout_prob=c.decoder_dropout_prob,
            latent_in=c.decoder_latent_in,
            pe_dim=c.c_dim + 1,
        )
        gen = torch.Generator().manual_seed(seed)
        for module in self.modules():
            if isinstance(module, (VecLinear, WNDense, Dense)):
                module.reset_parameters(gen)
        self.eval()
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
        scale0 (B,)). With `pallas_attention` the statistic comes from
        ops/cuda_scale.py (the scale kernel on the card) and carries no
        gradient."""
        centroid = torch.mean(pc, dim=1)
        centered = pc - centroid[:, None, :]
        if self.config.pallas_attention:
            scale0 = top_k_mean_pairwise_distance(centered, 5)
        else:
            scale0 = top_k_mean_pairwise_distance_plain(centered, 5)
        return centered / scale0[:, None, None], centroid, scale0

    def encode(self, pc: torch.Tensor) -> Codes:
        """Encode (B, N, 3) clouds into codes.

        With `pallas_attention`, clouds whose N the fused front end takes
        (N a multiple of min(256, N), the JAX condition) get their scale and
        their layer-0 graph from one pass over the centred cloud: dividing
        by the scale does not change the order of the neighbours. Any
        other N goes through `normalize_input` (the scale kernel on the
        card) and the encoder's own layer-0 kNN."""
        N = pc.shape[1]
        if self.config.pallas_attention and N % min(256, N) == 0:
            centroid = torch.mean(pc, dim=1)
            centered = pc - centroid[:, None, :]
            idx0, scale0 = knn_with_topk_scale(
                centered.detach(), min(self.config.num_knn, N))
            out = self.encoder(centered / scale0[:, None, None],
                               first_knn_idx=idx0)
        else:
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

    def invariant_query(self, query: torch.Tensor, codes: Codes) -> torch.Tensor:
        """The decoder's input for world-space points (B, M, 3):
        (B, M, 2C + 1) = [z_inv | <q, z_so3> | |q|] with q = (query - t) / s."""
        q = (query - codes["t"]) / codes["s"][:, None, None]
        inner = torch.matmul(q, codes["z_so3"].transpose(-1, -2))
        length = torch.linalg.norm(q, dim=-1, keepdim=True)
        z = codes["z_inv"][:, None, :].expand(-1, query.shape[1], -1)
        return torch.cat([z, inner, length], dim=-1)

    def decode_sdf(self, query: torch.Tensor, codes: Codes,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """SDF at world-space points (B, M, 3) -> (B, M). Dropout follows
        the module's train/eval mode (eval after construction); in train
        mode its masks come from `generator`."""
        return self.decoder(self.invariant_query(query, codes), generator)

    def occupancy_logits(self, query: torch.Tensor, codes: Codes) -> torch.Tensor:
        """Bernoulli occupancy logits, sdf2occ_factor * sdf; (B, M)."""
        return self.config.sdf2occ_factor * self.decode_sdf(query, codes)


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
