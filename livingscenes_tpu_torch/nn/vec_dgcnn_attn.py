"""SIM(3)-equivariant VN-DGCNN encoder with vector attention.

Counterpart of livingscenes_tpu/nn/vec_dgcnn_attn.py (`VecDGCNNAttn`):

  layer 0     cross-product edge [cross(dst_dir, nn), nn - dst, dst],
              VecLNA(3 -> C), mean over the K neighbours
  layer 1     edge [nn - dst, dst], VecLNA(2C -> C), mean over K
  layers 2-6  vector attention: fused K/V edge convs, a VecLNA query,
              per-16-channel-head softmax over K, weighted sum of V
  layers >= 2 global residual conv on [f, mean_N f]
  heads       conv_c, fc_inv, and the options' heads: fc_center (the
              centre, times scale_factor unless center_pred_scale is off;
              none with center_pred=False, and then three outputs), fc_O
              with z_so3_as_Omtx (z_so3 becomes the orthogonal polar
              factor of a 3 x 3 projection, from a float64 SVD)

Every layer builds a kNN graph in feature space (ops/cuda_knn.py: the
kernel on the card, its plain version on the CPU) and layers 2, 4 and 5
downsample by FPS (ops/cuda_fps.py fps_subsample_with_features, the FPS
kernel on the card). Features are (B, N, C, 3). Under
autograd the graph and the FPS picks are built from detached inputs, as JAX's
stop_gradient does: indices carry no gradient; the gather of the sampled
points' features stays differentiable.

The message passing of each layer is one function of nn/cuda_layer0.py and
nn/cuda_attention.py. With `pallas_attention=False` the encoder calls their
plain versions on every device; with `pallas_attention=True` (the JAX
field's name) it calls the wrappers, which launch the fused CUDA kernels
for tensors on the card and take the same plain versions on the CPU. The
parameters are the same either way.

`mixed_precision` (JAX's `mm_bf16` of the unfused layers 0 and 1): with
`pallas_attention=False` those two layers build their edge tensors and run
the edge VecLNA with bfloat16 operands (nn/vec_layers.py bf16_operands);
with `pallas_attention=True` it has no effect, as the fused kernels are
JAX's TPU path, which takes no bfloat16 there.
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.cuda_fps import fps_subsample_with_features
from ..ops.cuda_knn import knn_auto
from ..ops.knn import gather_neighbors
from .cuda_attention import (
    fused_edge_attention,
    fused_edge_attention_plain,
    fused_edge_mean,
    fused_edge_mean_plain,
)
from .cuda_layer0 import fused_layer0_edge_mean, fused_layer0_edge_mean_plain
from .edge_conv import edge_features, lna_weights
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
        center_pred: bool = True,
        center_pred_scale: bool = True,
        mixed_precision: bool = False,
        z_so3_as_Omtx: bool = False,
        pallas_attention: bool = False,
    ):
        super().__init__()
        self.pallas_attention = pallas_attention
        self.center_pred, self.center_pred_scale = center_pred, center_pred_scale
        self.mixed_precision = mixed_precision and not pallas_attention
        self.z_so3_as_Omtx = z_so3_as_Omtx
        self.c_dim = c_dim
        self.num_layers = num_layers
        self.feat_dim = tuple(feat_dim)
        self.down_sample = dict(zip(down_sample_layers, down_sample_factor))
        self.atten_start_layer = atten_start_layer
        self.head_c = atten_multi_head_c
        self.num_knn = num_knn
        self.scale_factor = scale_factor
        act = leaky_relu(LEAK_NEG_SLOPE)

        V, Q, K, G = {}, {}, {}, {}
        for i in range(num_layers):
            c_in = 1 if i == 0 else self.feat_dim[i - 1]
            c_out = self.feat_dim[i]
            e_in = 3 if i == 0 else 2 * c_in
            V[str(i)] = VecLNA(e_in, c_out, act, mode="so3",
                               mm_bf16=self.mixed_precision and i < atten_start_layer)
            if i >= atten_start_layer:
                K[str(i)] = VecLNA(e_in, c_out, act, mode="so3")
                Q[str(i)] = VecLNA(c_in, c_out, act, mode="so3")
            if i >= RES_GLOBAL_START_LAYER:
                G[str(i - RES_GLOBAL_START_LAYER)] = VecLNA(2 * c_out, c_out, act,
                                                            mode="so3")
        self.V_list = nn.ModuleDict(V)
        self.Q_list = nn.ModuleDict(Q)
        self.K_list = nn.ModuleDict(K)
        self.global_conv_list = nn.ModuleDict(G)
        self.conv_c = VecLNA(self.feat_dim[-1], c_dim, act, shared_nonlinearity=True,
                             mode="so3")
        self.fc_inv = VecLinear(c_dim, c_dim, mode="so3")
        if z_so3_as_Omtx:
            self.fc_O = VecLinear(c_dim, 3, mode="so3")
        if center_pred:
            self.fc_center = VecResBlock(c_dim, 1, c_dim // 2, act, mode="so3")

    def _knn_idx(self, src_f: torch.Tensor, dst_f: torch.Tensor) -> torch.Tensor:
        """Feature-space kNN graph (B, N_dst, K) of dst among src."""
        B, N_src, C, _ = src_f.shape
        q = dst_f.detach().reshape(B, dst_f.shape[1], C * 3)
        p = src_f.detach().reshape(B, N_src, C * 3)
        return knn_auto(q, p, min(self.num_knn, N_src))[1]

    def forward(self, x: torch.Tensor, first_knn_idx: torch.Tensor | None = None):
        """x (B, N, 3), centred and scaled. `first_knn_idx` is an optional
        precomputed (B, N, K) layer-0 graph (the fused front end of
        `ShapePrior.encode` builds it with the scale statistic). Returns
        (center (B, 1, 3), scale (B,), z_so3 (B, C, 3), z_inv (B, C)), or
        without center_pred (scale, z_so3, z_inv); z_so3 is (B, 3, 3) with
        z_so3_as_Omtx."""
        if self.pallas_attention:
            layer0, edge_mean, edge_attention = (
                fused_layer0_edge_mean, fused_edge_mean, fused_edge_attention)
        else:
            layer0, edge_mean, edge_attention = (
                fused_layer0_edge_mean_plain, fused_edge_mean_plain,
                fused_edge_attention_plain)
        src_xyz, src_f = x, x[:, :, None, :]
        for i in range(self.num_layers):
            if i in self.down_sample:
                dst_xyz, dst_f, _ = fps_subsample_with_features(
                    src_xyz.detach(), src_f, self.down_sample[i])
            else:
                dst_xyz, dst_f = src_xyz, src_f
            if i == 0 and first_knn_idx is not None:
                idx = first_knn_idx
            else:
                idx = self._knn_idx(src_f, dst_f)

            W_V, D_V = lna_weights(self.V_list[str(i)])
            if self.mixed_precision and i < self.atten_start_layer:
                dst_f = torch.mean(self.V_list[str(i)](
                    unfused_edges(src_f, dst_f, idx, i == 0)), dim=2)
            elif i == 0:
                dst_f = layer0(src_xyz, idx, W_V, D_V, LEAK_NEG_SLOPE)
            elif i < self.atten_start_layer:
                dst_f = edge_mean(src_f, dst_f, idx, W_V, D_V, LEAK_NEG_SLOPE)
            else:
                W_K, D_K = lna_weights(self.K_list[str(i)])
                q_n = channel_equi_vec_normalize(self.Q_list[str(i)](dst_f))
                dst_f = edge_attention(
                    src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                    self.head_c, LEAK_NEG_SLOPE,
                )

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
        if self.z_so3_as_Omtx:
            # U Vh is the orthogonal polar factor of R_pred: it does not
            # depend on the SVD's choice of signs
            R_pred = self.fc_O(z_so3).transpose(-1, -2)  # (B, 3, 3)
            U, _, Vh = torch.linalg.svd(R_pred.double())
            z_so3 = (U @ Vh).transpose(-1, -2).to(R_pred.dtype)
        if not self.center_pred:
            return scale, z_so3, z_inv
        center = self.fc_center(feat)  # (B, 1, 3)
        if self.center_pred_scale:
            center = center * self.scale_factor
        return center, scale, z_so3, z_inv


def unfused_edges(src_f: torch.Tensor, dst_f: torch.Tensor, idx: torch.Tensor,
                  layer0: bool) -> torch.Tensor:
    """The edge tensor (B, N_dst, K, E, 3) of layer 0, [cross(dst_dir, nn),
    nn - dst, dst], or of a later layer, [nn - dst, dst], as JAX's unfused
    layers build it."""
    edges = edge_features(src_f, dst_f, idx)
    if not layer0:
        return edges
    nn_f = gather_neighbors(src_f, idx.long())
    dst_dir = dst_f / torch.clamp_min(torch.linalg.norm(dst_f, dim=-1, keepdim=True), 1e-12)
    cross = torch.cross(dst_dir[:, :, None].expand_as(nn_f), nn_f, dim=-1)
    return torch.cat([cross, edges], dim=-2)
