"""VN edge convolutions with the edge tensor left unbuilt.

Counterpart of livingscenes_tpu/nn/edge_conv.py (`EdgeVecLNA`,
`GlobalResVecLNA`, `_LNAWeights`, `_so3_activation`, `fused_edge_kv`). An
edge VecLNA on [nn - dst, dst] is linear in its two halves,
W [nn - dst, dst] = W_l nn + (W_r - W_l) dst, so the (B, N, K, 2C, 3) edge
tensor is never built; the attention layers' K and V branches share one
matmul over the gathered neighbours. Each module keeps VecLNA's parameter
names (`lin.weight`, `act.lin_dir.weight`), so it reads the weights of the
VecLNA it replaces. `edge_features` builds the edge tensor where a
caller needs it whole.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.knn import gather_neighbors
from .vec_layers import VecActivation, VecLinear, VecLNA, so3_activation


def edge_features(src_f: torch.Tensor, dst_f: torch.Tensor, idx: torch.Tensor,
                  dim: int = -2) -> torch.Tensor:
    """The edges [nn - dst, dst] of a graph, joined along the channel axis
    `dim`: src_f (B, Ns, F...), dst_f (B, Nd, F...), idx (B, Nd, K) ->
    (B, Nd, K, F'...)."""
    nn_f = gather_neighbors(src_f, idx.long())
    dst = dst_f[:, :, None].expand_as(nn_f)
    return torch.cat([nn_f - dst, dst], dim=dim)


def lna_weights(lna: VecLNA):
    """(W (c_out, 2 c_in), D (c_out, c_out)) of an edge VecLNA: its linear
    weight and its activation's direction weight (`_LNAWeights`' tree)."""
    return lna.lin.weight, lna.act.lin_dir.weight


class EdgeVecLNA(nn.Module):
    """VecLNA(2 c_in, c_out) (so3) on the edges [nn - dst, dst] of a graph,
    from (src_f, dst_f, idx). Both channel mixings, the conv's and the
    activation's direction map (linear too), run on the ungathered
    per-point features; only elementwise work touches the edges."""

    def __init__(self, c_in: int, c_out: int, act_func):
        super().__init__()
        self.c_in, self.act_func = c_in, act_func
        self.lin = VecLinear(2 * c_in, c_out, mode="so3")
        self.act = VecActivation(c_out, act_func, mode="so3")

    def forward(self, src_f: torch.Tensor, dst_f: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
        """src_f (B, Ns, C, 3), dst_f (B, Nd, C, 3), idx (B, Nd, K) ->
        (B, Nd, K, c_out, 3)."""
        W, D = lna_weights(self)
        W_l, W_r = W[:, :self.c_in], W[:, self.c_in:]
        y_src = torch.einsum("oc,bnci->bnoi", W_l, src_f)
        y_dst = torch.einsum("oc,bnci->bnoi", W_r - W_l, dst_f)
        d_src = torch.einsum("oc,bnci->bnoi", D, y_src)
        d_dst = torch.einsum("oc,bnci->bnoi", D, y_dst)
        idx = idx.long()
        q = gather_neighbors(y_src, idx) + y_dst[:, :, None]
        k = gather_neighbors(d_src, idx) + d_dst[:, :, None]
        return so3_activation(q, k, self.act_func)


class GlobalResVecLNA(nn.Module):
    """VecLNA(2 c_in, c_out) (so3) on [f, broadcast(g)]: the global half of
    the product is formed once an instance, not once a point."""

    def __init__(self, c_in: int, c_out: int, act_func):
        super().__init__()
        self.c_in = c_in
        self.lin = VecLinear(2 * c_in, c_out, mode="so3")
        self.act = VecActivation(c_out, act_func, mode="so3")

    def forward(self, f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """f (B, N, C, 3), g (B, 1, C, 3) -> (B, N, c_out, 3)."""
        W = self.lin.weight
        y = (torch.einsum("oc,bnci->bnoi", W[:, :self.c_in], f)
             + torch.einsum("oc,bnci->bnoi", W[:, self.c_in:], g))
        return self.act(y)


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
