"""SIM(3)-equivariant VN-DGCNN encoder with vector attention.

Counterpart of livingscenes_tpu/nn/vec_dgcnn_attn.py (`VecDGCNNAttn`), the
branches that run without the fused attention kernels:

  layer 0     cross-product edge [cross(dst_dir, nn), nn - dst, dst],
              VecLNA(3 -> C), mean over the K neighbours
  layer 1     edge [nn - dst, dst], VecLNA(2C -> C), mean over K
  layers 2-6  vector attention: fused K/V edge convs, a VecLNA query,
              per-16-channel-head softmax over K, weighted sum of V
  layers >= 2 global residual conv on [f, mean_N f]
  heads       conv_c, fc_inv, fc_center (the centre, times scale_factor)

Every layer builds a kNN graph in feature space (ops/cuda_knn.py: the
kernel on the card, its plain version on the CPU) and layers 2, 4 and 5
downsample by FPS (ops/cuda_fps.py). Features are (B, N, C, 3).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.cuda_fps import fps_auto
from ..ops.cuda_knn import knn_auto
from ..ops.knn import gather_neighbors
from .edge_conv import fused_edge_kv, lna_weights
from .vec_layers import (
    VecLinear,
    VecLNA,
    VecResBlock,
    channel_equi_vec_normalize,
    leaky_relu,
)


LEAK_NEG_SLOPE = 0.2
# Layers from this one on end in the global residual conv on [f, mean_N f].
RES_GLOBAL_START_LAYER = 2


class VecDGCNNAttn(nn.Module):
    """The production encoder; state-dict keys follow the reference model
    (V_list.i, Q_list.i, K_list.i, global_conv_list.j, conv_c, fc_inv,
    fc_center)."""

    def __init__(
        self,
        c_dim: int = 256,
        num_layers: int = 7,
        feat_dim: Sequence[int] = (32, 32, 64, 64, 128, 256, 512),
        down_sample_layers: Sequence[int] = (2, 4, 5),
        down_sample_factor: Sequence[int] = (2, 4, 4),
        atten_start_layer: int = 2,
        atten_multi_head_c: int = 16,
        num_knn: int = 16,
        scale_factor: float = 64000.0,
    ):
        super().__init__()
        self.c_dim = c_dim
        self.num_layers = num_layers
        self.feat_dim = tuple(feat_dim)
        self.down_sample = dict(zip(down_sample_layers, down_sample_factor))
        self.atten_start_layer = atten_start_layer
        self.head_c = atten_multi_head_c
        self.num_knn = num_knn
        self.scale_factor = scale_factor
        act = leaky_relu(LEAK_NEG_SLOPE)
        self.act = act

        V, Q, K, G = {}, {}, {}, {}
        for i in range(num_layers):
            c_in = 1 if i == 0 else self.feat_dim[i - 1]
            c_out = self.feat_dim[i]
            e_in = 3 if i == 0 else 2 * c_in
            V[str(i)] = VecLNA(e_in, c_out, act)
            if i >= atten_start_layer:
                K[str(i)] = VecLNA(e_in, c_out, act)
                Q[str(i)] = VecLNA(c_in, c_out, act)
            if i >= RES_GLOBAL_START_LAYER:
                G[str(i - RES_GLOBAL_START_LAYER)] = VecLNA(2 * c_out, c_out, act)
        self.V_list = nn.ModuleDict(V)
        self.Q_list = nn.ModuleDict(Q)
        self.K_list = nn.ModuleDict(K)
        self.global_conv_list = nn.ModuleDict(G)
        self.conv_c = VecLNA(self.feat_dim[-1], c_dim, act, shared_nonlinearity=True)
        self.fc_inv = VecLinear(c_dim, c_dim)
        self.fc_center = VecResBlock(c_dim, 1, c_dim // 2, act)

    def _knn_idx(self, src_f: torch.Tensor, dst_f: torch.Tensor) -> torch.Tensor:
        """Feature-space kNN graph (B, N_dst, K) of dst among src."""
        B, N_src, C, _ = src_f.shape
        q = dst_f.reshape(B, dst_f.shape[1], C * 3)
        p = src_f.reshape(B, N_src, C * 3)
        return knn_auto(q, p, min(self.num_knn, N_src))[1]

    @staticmethod
    def _layer0_edge(src_f, dst_f, idx):
        """[cross(dst_dir, nn), nn - dst, dst]: (B, N, K, 3, 3)."""
        nn_f = gather_neighbors(src_f, idx)  # (B, N, K, 1, 3)
        dst_pad = dst_f[:, :, None].expand_as(nn_f)
        dst_dir = dst_f / torch.clamp_min(
            torch.linalg.norm(dst_f, dim=-1, keepdim=True), 1e-12
        )
        crossed = torch.linalg.cross(dst_dir[:, :, None].expand_as(nn_f), nn_f, dim=-1)
        return torch.cat([crossed, nn_f - dst_pad, dst_pad], dim=-2)

    def forward(self, x: torch.Tensor):
        """x (B, N, 3), centred and scaled. Returns (center (B, 1, 3),
        scale (B,), z_so3 (B, C, 3), z_inv (B, C))."""
        B = x.shape[0]
        src_xyz, src_f = x, x[:, :, None, :]
        for i in range(self.num_layers):
            if i in self.down_sample:
                n_new = src_xyz.shape[1] // self.down_sample[i]
                dst_xyz, fidx = fps_auto(src_xyz, n_new)
                dst_f = src_f[torch.arange(B, device=x.device)[:, None], fidx]
            else:
                dst_xyz, dst_f = src_xyz, src_f
            idx = self._knn_idx(src_f, dst_f)

            if i == 0:
                edge = self._layer0_edge(src_f, dst_f, idx)
                dst_f = torch.mean(self.V_list[str(i)](edge), dim=2)
            elif i < self.atten_start_layer:
                nn_f = gather_neighbors(src_f, idx)
                dst_pad = dst_f[:, :, None].expand_as(nn_f)
                edge = torch.cat([nn_f - dst_pad, dst_pad], dim=-2)
                dst_f = torch.mean(self.V_list[str(i)](edge), dim=2)
            else:
                nn_f = gather_neighbors(src_f, idx)
                W_K, D_K = lna_weights(self.K_list[str(i)])
                W_V, D_V = lna_weights(self.V_list[str(i)])
                k_feat, v_feat = fused_edge_kv(
                    nn_f, dst_f, W_K, D_K, W_V, D_V, self.act
                )
                q_feat = self.Q_list[str(i)](dst_f)
                k_n = channel_equi_vec_normalize(k_feat)  # (B, Nd, K, C, 3)
                q_n = channel_equi_vec_normalize(q_feat)  # (B, Nd, C, 3)
                qk = torch.sum(k_n * q_n[:, :, None], dim=-1)  # (B, Nd, K, C)
                c_out = qk.shape[-1]
                n_head = c_out // self.head_c
                qk_h = qk.reshape(*qk.shape[:3], n_head, self.head_c)
                attn = torch.sum(qk_h, dim=-1, keepdim=True) / math.sqrt(
                    3 * self.head_c
                )
                attn = torch.softmax(attn, dim=2)  # over K
                attn = attn.expand_as(qk_h).reshape(qk.shape)
                dst_f = torch.sum(attn[..., None] * v_feat, dim=2)

            if i >= RES_GLOBAL_START_LAYER:
                g = torch.mean(dst_f, dim=1, keepdim=True)
                cat = torch.cat([dst_f, g.expand_as(dst_f)], dim=-2)
                j = i - RES_GLOBAL_START_LAYER
                dst_f = self.global_conv_list[str(j)](cat)
            src_xyz, src_f = dst_xyz, dst_f

        feat = torch.mean(self.conv_c(src_f), dim=1)  # (B, C, 3)
        z_so3 = channel_equi_vec_normalize(feat)
        scale = torch.mean(torch.linalg.norm(feat, dim=-1), dim=-1) * self.scale_factor
        z_inv_dual = self.fc_inv(feat)
        z_inv = torch.sum(channel_equi_vec_normalize(z_inv_dual) * z_so3, dim=-1)
        center = self.fc_center(feat) * self.scale_factor  # (B, 1, 3)
        return center, scale, z_so3, z_inv
