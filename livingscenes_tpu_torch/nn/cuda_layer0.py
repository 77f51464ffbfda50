"""Layer 0 of the encoder, fused: the plain version and the wrappers of
csrc/layer0.cu and its backward, csrc/layer0_bwd.cu.

Counterpart of livingscenes_tpu/nn/pallas_layer0.py
(`fused_layer0_edge_mean` and its custom VJP). Per edge the three vector
channels [cross(dst_dir, nn), nn - dst, dst] go through VecLinear(3 -> O) and
the so3 VecActivation, and the K neighbours are averaged.
`fused_layer0_edge_mean` takes the plain versions for tensors on the CPU and
launches the kernels for CUDA tensors; there is no fallback. Under autograd
it is a `torch.autograd.Function` that saves only its inputs and whose
backward recomputes the edges, as the TPU kernel's does: the plain VJP on
the CPU, the backward kernel on the card.
"""
from __future__ import annotations

import torch

from ..ops import _cuda
from ..ops.knn import gather_neighbors
from .vec_layers import leaky_relu, so3_activation

launches = 0  # layer0.cu launches since the count was last set to 0
bwd_launches = 0  # layer0_bwd.cu edge-pass launches, ditto
bwd_fold_launches = 0  # its fold of the per-block partials, ditto


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
    """The kernel: float32 tensors on the card, idx int32 or int64; O even
    up to 512. One launch, which forms D W itself."""
    global launches
    _cuda.require_cuda("layer0_edge_mean", xyz, W, D, dtype=torch.float32)
    _cuda.require_cuda("layer0_edge_mean", xyz, idx)
    B, N, three = xyz.shape
    K = idx.shape[-1]
    O = W.shape[0]
    if (three != 3 or idx.shape != (B, N, K) or W.shape != (O, 3)
            or D.shape != (O, O)):
        raise ValueError("layer0_edge_mean: xyz (B, N, 3), idx (B, N, K), "
                         "W (O, 3), D (O, O)")
    idx = idx.to(torch.int32)
    out = torch.empty((B, N, O, 3), dtype=torch.float32, device=xyz.device)
    err = _cuda.lib().lstpu_layer0_edge_mean(
        xyz.data_ptr(), idx.data_ptr(), W.data_ptr(), D.data_ptr(),
        out.data_ptr(), B, N, O, K, float(neg_slope), _cuda.stream_ptr(xyz),
    )
    _cuda.check(err, "layer0_edge_mean")
    launches += 1
    return out


def fused_layer0_edge_mean_bwd_plain(xyz, idx, W, D, g, neg_slope: float = 0.2):
    """The plain backward: the VJP of the plain version at the cotangent g
    (B, N, O, 3), by autograd. Returns (d_xyz, d_W, d_D)."""
    with torch.enable_grad():
        xyz, W, D = (t.detach().requires_grad_(True) for t in (xyz, W, D))
        out = fused_layer0_edge_mean_plain(xyz, idx, W, D, neg_slope)
        return torch.autograd.grad(out, (xyz, W, D), g)


def fused_layer0_edge_mean_bwd_cuda(xyz, idx, W, D, g, neg_slope: float = 0.2):
    """The backward kernel: (d_xyz, d_W, d_D) for float32 tensors on the
    card. O a multiple of 4 up to 512. Two launches (csrc/layer0_bwd.cu):
    the edge pass (`bwd_launches`), which leaves per block its partial sums
    of d_W's and d_D's factors, and their fold in a fixed order
    (`bwd_fold_launches`; d_W and d_D repeat bit for bit)."""
    global bwd_launches, bwd_fold_launches
    name = "layer0_edge_mean_bwd"
    _cuda.require_cuda(name, xyz, W, D, g, dtype=torch.float32)
    _cuda.require_cuda(name, xyz, idx)
    B, N, three = xyz.shape
    K = idx.shape[-1]
    O = W.shape[0]
    if (three != 3 or idx.shape != (B, N, K) or W.shape != (O, 3)
            or D.shape != (O, O) or g.shape != (B, N, O, 3)):
        raise ValueError(f"{name}: xyz (B, N, 3), idx (B, N, K), W (O, 3), "
                         "D (O, O), g (B, N, O, 3)")
    idx = idx.to(torch.int32)
    d_xyz = torch.zeros_like(xyz)
    lib = _cuda.lib()
    part = torch.empty((lib.lstpu_layer0_bwd_blocks(B, N, O), 6 * O),
                       dtype=torch.float32, device=xyz.device)
    out = torch.empty(O * 3 + O * O, dtype=torch.float32, device=xyz.device)
    err = lib.lstpu_layer0_edge_mean_bwd(
        xyz.data_ptr(), idx.data_ptr(), W.data_ptr(), D.data_ptr(),
        g.data_ptr(), d_xyz.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, N, O, K, float(neg_slope), _cuda.stream_ptr(xyz),
    )
    _cuda.check(err, name)
    bwd_launches += 1
    bwd_fold_launches += 1
    return d_xyz, out[:O * 3].view(O, 3), out[O * 3:].view(O, O)


class _Layer0EdgeMean(torch.autograd.Function):
    """Saves (xyz, idx, W, D) only; the backward recomputes the edges."""

    @staticmethod
    def forward(ctx, xyz, idx, W, D, neg_slope):
        ctx.save_for_backward(xyz, idx, W, D)
        ctx.neg_slope = neg_slope
        if xyz.device.type == "cpu":
            return fused_layer0_edge_mean_plain(xyz, idx, W, D, neg_slope)
        return fused_layer0_edge_mean_cuda(xyz, idx, W, D, neg_slope)

    @staticmethod
    def backward(ctx, g):
        xyz, idx, W, D = ctx.saved_tensors
        bwd = (fused_layer0_edge_mean_bwd_plain if xyz.device.type == "cpu"
               else fused_layer0_edge_mean_bwd_cuda)
        d_xyz, d_W, d_D = bwd(xyz, idx, W, D, g.contiguous(), ctx.neg_slope)
        return d_xyz, None, d_W, d_D, None


def fused_layer0_edge_mean(xyz, idx, W, D, neg_slope: float = 0.2):
    """mean_K(VecLNA(3, O)([cross(dst_dir, nn), nn - dst, dst])), source and
    destination being the same cloud: (B, N, O, 3). Differentiable w.r.t.
    xyz, W and D; idx carries no gradient."""
    xyz, idx, W, D = (t.contiguous() for t in (xyz, idx, W, D))
    return _Layer0EdgeMean.apply(xyz, idx, W, D, neg_slope)
