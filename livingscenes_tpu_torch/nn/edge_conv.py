"""The attention layers' K/V edge convolutions, fused.

Counterpart of livingscenes_tpu/nn/edge_conv.py (`_LNAWeights`,
`_so3_activation`, `fused_edge_kv`). An edge VecLNA on [nn - dst, dst] is
linear in its two halves, W [nn - dst, dst] = W_l nn + (W_r - W_l) dst, so
the (B, N, K, 2C, 3) edge tensor is never built, and the K and V branches
share one matmul over the gathered neighbours.
"""
from __future__ import annotations

import torch

from .vec_layers import VecLNA, so3_activation


def lna_weights(lna: VecLNA):
    """(W (c_out, 2 c_in), D (c_out, c_out)) of an edge VecLNA: its linear
    weight and its activation's direction weight (`_LNAWeights`' tree)."""
    return lna.lin.weight, lna.act.lin_dir.weight


def fused_edge_kv(nn_f, dst_f, W_K, D_K, W_V, D_V, act_func):
    """K and V edge convs of an attention layer in one pass.

    nn_f (B, N, K, C, 3) gathered neighbours, dst_f (B, N, C, 3). Returns
    (k_feat, v_feat), each (B, N, K, c_out, 3).
    """
    c_in = dst_f.shape[-2]
    c_out = W_K.shape[0]
    W_l = torch.cat([W_K[:, :c_in], W_V[:, :c_in]], dim=0)
    W_delta = torch.cat(
        [W_K[:, c_in:] - W_K[:, :c_in], W_V[:, c_in:] - W_V[:, :c_in]], dim=0
    )
    y = (torch.einsum("oc,bnkci->bnkoi", W_l, nn_f)
         + torch.einsum("oc,bnci->bnoi", W_delta, dst_f)[:, :, None])
    y_k, y_v = y[..., :c_out, :], y[..., c_out:, :]
    k_feat = so3_activation(y_k, torch.einsum("oc,bnkci->bnkoi", D_K, y_k), act_func)
    v_feat = so3_activation(y_v, torch.einsum("oc,bnkci->bnkoi", D_V, y_v), act_func)
    return k_feat, v_feat
