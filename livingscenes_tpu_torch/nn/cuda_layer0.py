"""Layer 0 of the encoder, fused: the plain version and the wrapper of
csrc/layer0.cu.

Counterpart of livingscenes_tpu/nn/pallas_layer0.py
(`fused_layer0_edge_mean`). Per edge the three vector channels
[cross(dst_dir, nn), nn - dst, dst] go through VecLinear(3 -> O) and the so3
VecActivation, and the K neighbours are averaged. `fused_layer0_edge_mean`
takes the plain version for tensors on the CPU and launches the kernel for
CUDA tensors; there is no fallback.
"""
from __future__ import annotations

import torch

from ..ops import _cuda
from ..ops.knn import gather_neighbors
from .vec_layers import leaky_relu, so3_activation

launches = 0  # kernel launches since the count was last set to 0


def layer0_edge(src_f: torch.Tensor, dst_f: torch.Tensor, idx: torch.Tensor):
    """[cross(dst_dir, nn), nn - dst, dst]: (B, N, K, 3, 3) from
    (B, N, 1, 3) features and the (B, N, K) graph."""
    nn_f = gather_neighbors(src_f, idx.long())  # (B, N, K, 1, 3)
    dst_pad = dst_f[:, :, None].expand_as(nn_f)
    dst_dir = dst_f / torch.clamp_min(
        torch.linalg.norm(dst_f, dim=-1, keepdim=True), 1e-12
    )
    crossed = torch.linalg.cross(dst_dir[:, :, None].expand_as(nn_f), nn_f, dim=-1)
    return torch.cat([crossed, nn_f - dst_pad, dst_pad], dim=-2)


def fused_layer0_edge_mean_plain(xyz, idx, W, D, neg_slope: float = 0.2):
    """The plain version: the (B, N, K, O, 3) edge features are built in
    full. xyz (B, N, 3), idx (B, N, K), W (O, 3), D (O, O) -> (B, N, O, 3)."""
    f = xyz[:, :, None, :]
    y = torch.einsum("oc,...ci->...oi", W, layer0_edge(f, f, idx))
    k = torch.einsum("oc,...ci->...oi", D, y)
    return torch.mean(so3_activation(y, k, leaky_relu(neg_slope)), dim=2)


def fused_layer0_edge_mean_cuda(xyz, idx, W, D, neg_slope: float = 0.2):
    """The kernel: float32 tensors on the card, idx int32 or int64."""
    global launches
    _cuda.require_cuda("layer0_edge_mean", xyz, W, D, dtype=torch.float32)
    _cuda.require_cuda("layer0_edge_mean", xyz, idx)
    _cuda.forbid_grad("layer0_edge_mean", "row 12", xyz, W, D)
    B, N, three = xyz.shape
    K = idx.shape[-1]
    O = W.shape[0]
    if (three != 3 or idx.shape != (B, N, K) or W.shape != (O, 3)
            or D.shape != (O, O)):
        raise ValueError("layer0_edge_mean: xyz (B, N, 3), idx (B, N, K), "
                         "W (O, 3), D (O, O)")
    idx = idx.to(torch.int32)
    d_t = D.t().contiguous()
    out = torch.empty((B, N, O, 3), dtype=torch.float32, device=xyz.device)
    err = _cuda.lib().lstpu_layer0_edge_mean(
        xyz.data_ptr(), idx.data_ptr(), W.data_ptr(), d_t.data_ptr(),
        out.data_ptr(), B, N, O, K, float(neg_slope), _cuda.stream_ptr(xyz),
    )
    _cuda.check(err, "layer0_edge_mean")
    launches += 1
    return out


def fused_layer0_edge_mean(xyz, idx, W, D, neg_slope: float = 0.2):
    """mean_K(VecLNA(3, O)([cross(dst_dir, nn), nn - dst, dst])), source and
    destination being the same cloud: (B, N, O, 3)."""
    if xyz.device.type == "cpu":
        return fused_layer0_edge_mean_plain(xyz, idx, W, D, neg_slope)
    return fused_layer0_edge_mean_cuda(
        xyz.contiguous(), idx.contiguous(), W.contiguous(), D, neg_slope
    )
