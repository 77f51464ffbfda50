"""The two encoders of the benchmark's configurations, in plain PyTorch.

`encode` takes raw (B, N, 3) clouds and returns the codes {"z_so3" (B, C, 3),
"z_inv" (B, C), "s" (B,), "t" (B, 1, 3)}: the cloud is centred and divided
by its scale statistic (the mean of the five largest pairwise distances),
encoded, and s and t are put back. Edge tensors are built whole, as the
published models build them.

* `vecdgcnn_atten` -- the SIM(3) VN-DGCNN with vector attention of
  Living Scenes (Zhu et al., CVPR 2024; the reference code's
  lib_shape_prior/configs/3rscan/dgcnn_attn_inner.yaml): layer 0 is an
  edge conv on [cross(dst_dir, nn), nn - dst, dst], layer 1 on
  [nn - dst, dst], both averaged over K neighbours; from layer 2 on, K
  and V edge convs and a query conv give one softmax over the K
  neighbours per head of `head_c` channels; from layer 2 on a global
  residual conv on [f, mean f]; FPS halves or quarters the points at the
  configured layers; the heads add the predicted centre.
* `vecdgcnn` -- the Vector Neurons DGCNN (Deng et al., ICCV 2021; the
  reference code's vec_sim3/vec_dgcnn.py VecDGCNN): four edge convs on
  the layer-0 graph, their outputs joined for conv_c.
"""
from __future__ import annotations

import math

import torch

from . import geometry as geo
from .vn import channel_equi_vec_normalize, invariant_heads, lna, mix, normalize, vn_act

SLOPE = 0.2


def edges(src_f, dst_f, idx):
    """[nn - dst, dst]: (B, Nd, K, 2C, 3)."""
    nn_f = geo.gather(src_f, idx)
    dst = dst_f[:, :, None].expand_as(nn_f)
    return torch.cat([nn_f - dst, dst], dim=-2)


def knn_graph(src_f, dst_f, k):
    B = src_f.shape[0]
    return geo.knn(dst_f.reshape(B, dst_f.shape[1], -1),
                   src_f.reshape(B, src_f.shape[1], -1), min(k, src_f.shape[1]))


def attention_encoder(w: dict, x: torch.Tensor, cfg: dict):
    """(center (B, 1, 3), scale (B,), z_so3, z_inv) of centred, scaled x."""
    feat_dim, k = cfg["feat_dim"], cfg["num_knn"]
    down = dict(zip(cfg["down_sample_layers"], cfg["down_sample_factor"]))
    start, head_c = cfg["atten_start_layer"], cfg["atten_multi_head_c"]
    src_xyz, src_f = x, x[:, :, None, :]
    for i in range(len(feat_dim)):
        if i in down:
            pick = geo.fps(src_xyz, src_xyz.shape[1] // down[i])
            dst_xyz, dst_f = geo.gather(src_xyz, pick), geo.gather(src_f, pick)
        else:
            dst_xyz, dst_f = src_xyz, src_f
        idx = knn_graph(src_f, dst_f, k)
        if i == 0:
            nn_f = geo.gather(src_f, idx)
            dst_dir = normalize(dst_f)[:, :, None].expand_as(nn_f)
            e = torch.cat([torch.linalg.cross(dst_dir, nn_f, dim=-1),
                           edges(src_f, dst_f, idx)], dim=-2)
            f = lna(w, "encoder.V_list.0", e).mean(2)
        elif i < start:
            f = lna(w, f"encoder.V_list.{i}", edges(src_f, dst_f, idx)).mean(2)
        else:
            e = edges(src_f, dst_f, idx)
            key = channel_equi_vec_normalize(lna(w, f"encoder.K_list.{i}", e))
            val = lna(w, f"encoder.V_list.{i}", e)
            query = channel_equi_vec_normalize(lna(w, f"encoder.Q_list.{i}", dst_f))
            qk = (key * query[:, :, None]).sum(-1)  # (B, Nd, K, O)
            heads = qk.reshape(*qk.shape[:3], -1, head_c).sum(-1) / math.sqrt(3 * head_c)
            attn = torch.softmax(heads, dim=2).repeat_interleave(head_c, dim=-1)
            f = (attn[..., None] * val).sum(2)
        if i >= 2:
            g = f.mean(1, keepdim=True).expand_as(f)
            f = lna(w, f"encoder.global_conv_list.{i - 2}", torch.cat([f, g], dim=-2))
        src_xyz, src_f = dst_xyz, f
    feat = lna(w, "encoder.conv_c", src_f).mean(1)
    scale, z_so3, z_inv = invariant_heads(w, "encoder.", feat, cfg["scale_factor"])
    # fc_center: a residual block (VecLNA, VecLinear, linear shortcut) and
    # a final activation, times scale_factor
    p = "encoder.fc_center"
    v = (mix(w[f"{p}.shortcut.weight"], feat)
         + mix(w[f"{p}.lin1.weight"], lna(w, f"{p}.fc0", feat)))
    center = vn_act(v, mix(w[f"{p}.act2.lin_dir.weight"], v), SLOPE)
    return center * cfg["scale_factor"], scale, z_so3, z_inv


def vecdgcnn_encoder(w: dict, x: torch.Tensor, cfg: dict):
    """(scale, z_so3, z_inv) of centred, scaled x."""
    f = x[:, :, None, :]
    idx = knn_graph(f, f, cfg["num_knn"])  # the layer-0 graph serves all four
    feats = []
    for i in range(4):
        f = lna(w, f"encoder.conv{i + 1}", edges(f, f, idx)).mean(2)
        feats.append(f)
    feat = lna(w, "encoder.conv_c", torch.cat(feats, dim=-2)).mean(1)
    return invariant_heads(w, "encoder.heads.", feat, cfg["scale_factor"])


ENCODERS = {"vecdgcnn_atten": attention_encoder, "vecdgcnn": vecdgcnn_encoder}


def encode(w: dict, pc: torch.Tensor, cfg: dict) -> dict:
    """Codes of raw (B, N, 3) clouds."""
    centroid = pc.mean(1)
    centered = pc - centroid[:, None]
    scale0 = geo.top_k_mean_distance(centered, 5)
    out = ENCODERS[cfg["encoder_type"]](w, centered / scale0[:, None, None], cfg)
    if len(out) == 4:
        center, scale, z_so3, z_inv = out
        centroid = centroid + center[:, 0]
    else:
        scale, z_so3, z_inv = out
    return {"z_so3": z_so3, "z_inv": z_inv, "s": scale0 * scale,
            "t": centroid[:, None]}
