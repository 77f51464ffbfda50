"""The encoder's fused edge layers: plain versions and the wrappers of
csrc/mean_edge.cu and csrc/attention.cu.

Counterpart of livingscenes_tpu/nn/pallas_attention.py (`fused_edge_mean`,
`fused_edge_attention`), with the same argument order and layouts:
features (B, N, C, 3), graph (B, N_dst, K), VecLNA weights W (O, 2C) over
the edge [nn - dst, dst] and D (O, O). `fused_edge_mean` and
`fused_edge_attention` take the plain version for tensors on the CPU and
launch the kernel for CUDA tensors; there is no fallback. As in the JAX
wrappers, the halves of the edge convolution that do not depend on the
neighbour (W_r - W_l applied to dst, once per point) and the weight
transposes are computed here; everything per edge is the kernel's.
"""
from __future__ import annotations

import math

import torch

from ..ops import _cuda
from ..ops.knn import gather_neighbors
from .edge_conv import fused_edge_kv
from .vec_layers import channel_equi_vec_normalize, leaky_relu, so3_activation

mean_launches = 0  # mean_edge.cu launches since the count was last set to 0
attention_launches = 0  # attention.cu launches since it was last set to 0


def fused_edge_mean_plain(src_f, dst_f, idx, W, D, neg_slope: float = 0.2):
    """The plain version: gather, the (B, N_dst, K, 2C, 3) edge
    [nn - dst, dst], VecLNA, mean over K."""
    nn_f = gather_neighbors(src_f, idx.long())
    dst_pad = dst_f[:, :, None].expand_as(nn_f)
    edge = torch.cat([nn_f - dst_pad, dst_pad], dim=-2)
    y = torch.einsum("oc,...ci->...oi", W, edge)
    k = torch.einsum("oc,...ci->...oi", D, y)
    return torch.mean(so3_activation(y, k, leaky_relu(neg_slope)), dim=2)


def fused_edge_attention_plain(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                               head_c: int = 16, neg_slope: float = 0.2):
    """The plain version: gather, fused K/V edge convs, channel-normalised
    K, q.k summed per head of `head_c` channels over sqrt(3 head_c), softmax
    over K, weighted sum of V."""
    nn_f = gather_neighbors(src_f, idx.long())
    k_feat, v_feat = fused_edge_kv(
        nn_f, dst_f, W_K, D_K, W_V, D_V, leaky_relu(neg_slope)
    )
    k_n = channel_equi_vec_normalize(k_feat)  # (B, Nd, K, O, 3)
    qk = torch.sum(k_n * q_n[:, :, None], dim=-1)  # (B, Nd, K, O)
    n_head = qk.shape[-1] // head_c
    qk_h = qk.reshape(*qk.shape[:3], n_head, head_c)
    attn = torch.sum(qk_h, dim=-1, keepdim=True) / math.sqrt(3 * head_c)
    attn = torch.softmax(attn, dim=2)  # over K
    attn = attn.expand_as(qk_h).reshape(qk.shape)
    return torch.sum(attn[..., None] * v_feat, dim=2)


def _check_graph(name, src_f, dst_f, idx):
    B, Ns, C, three = src_f.shape
    Nd, K = idx.shape[1], idx.shape[2]
    if three != 3 or dst_f.shape != (B, Nd, C, 3) or idx.shape[0] != B:
        raise ValueError(f"{name}: src (B, Ns, C, 3), dst (B, Nd, C, 3), "
                         "idx (B, Nd, K)")
    return B, Ns, Nd, C, K


def fused_edge_mean_cuda(src_f, dst_f, idx, W, D, neg_slope: float = 0.2):
    """The kernel: float32 tensors on the card, idx int32 or int64."""
    global mean_launches
    name = "edge_mean"
    _cuda.require_cuda(name, src_f, dst_f, W, D, dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    _cuda.forbid_grad(name, "row 13", src_f, dst_f, W, D)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W.shape[0]
    if W.shape != (O, 2 * C) or D.shape != (O, O):
        raise ValueError(f"{name}: W (O, 2C), D (O, O)")
    W_l = W[:, :C]
    y_dst = torch.einsum("oc,bnci->bnio", W[:, C:] - W_l, dst_f).contiguous()
    wl_t = W_l.t().contiguous()
    d_t = D.t().contiguous()
    idx = idx.to(torch.int32)
    out = torch.empty((B, Nd, O, 3), dtype=torch.float32, device=src_f.device)
    err = _cuda.lib().lstpu_edge_mean(
        src_f.data_ptr(), y_dst.data_ptr(), idx.data_ptr(), wl_t.data_ptr(),
        d_t.data_ptr(), out.data_ptr(), B, Ns, Nd, C, O, K, float(neg_slope),
        _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, name)
    mean_launches += 1
    return out


def fused_edge_attention_cuda(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                              head_c: int = 16, neg_slope: float = 0.2):
    """The kernel: float32 tensors on the card, idx int32 or int64."""
    global attention_launches
    name = "edge_attention"
    _cuda.require_cuda(name, src_f, dst_f, q_n, W_K, D_K, W_V, D_V,
                       dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    _cuda.forbid_grad(name, "row 14", src_f, dst_f, q_n, W_K, D_K, W_V, D_V)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W_K.shape[0]
    if (W_K.shape != (O, 2 * C) or W_V.shape != (O, 2 * C)
            or D_K.shape != (O, O) or D_V.shape != (O, O)
            or q_n.shape != (B, Nd, O, 3)):
        raise ValueError(f"{name}: W_K, W_V (O, 2C), D_K, D_V (O, O), "
                         "q_n (B, Nd, O, 3)")
    W_l = torch.cat([W_K[:, :C], W_V[:, :C]], dim=0)  # (2O, C)
    W_delta = torch.cat([W_K[:, C:], W_V[:, C:]], dim=0) - W_l
    y_dst = torch.einsum("oc,bnci->bnio", W_delta, dst_f).contiguous()
    wl_t = W_l.t().contiguous()
    dk_t = D_K.t().contiguous()
    dv_t = D_V.t().contiguous()
    idx = idx.to(torch.int32)
    out = torch.empty((B, Nd, O, 3), dtype=torch.float32, device=src_f.device)
    err = _cuda.lib().lstpu_edge_attention(
        src_f.data_ptr(), y_dst.data_ptr(), q_n.data_ptr(), idx.data_ptr(),
        wl_t.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(), out.data_ptr(),
        B, Ns, Nd, C, O, K, head_c, float(neg_slope), _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, name)
    attention_launches += 1
    return out


def fused_edge_mean(src_f, dst_f, idx, W, D, neg_slope: float = 0.2):
    """mean_K(VecLNA(2C, O)([nn - dst, dst])): (B, N_dst, O, 3)."""
    if src_f.device.type == "cpu":
        return fused_edge_mean_plain(src_f, dst_f, idx, W, D, neg_slope)
    return fused_edge_mean_cuda(
        src_f.contiguous(), dst_f.contiguous(), idx.contiguous(), W, D,
        neg_slope,
    )


def fused_edge_attention(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                         head_c: int = 16, neg_slope: float = 0.2):
    """One attention layer's message passing: (B, N_dst, O, 3)."""
    if src_f.device.type == "cpu":
        return fused_edge_attention_plain(
            src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V, head_c, neg_slope)
    return fused_edge_attention_cuda(
        src_f.contiguous(), dst_f.contiguous(), idx.contiguous(),
        q_n.contiguous(), W_K, D_K, W_V, D_V, head_c, neg_slope,
    )
