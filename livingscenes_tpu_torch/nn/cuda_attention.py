"""The encoder's fused edge layers: plain versions and the wrappers of
csrc/mean_edge.cu and csrc/attention.cu and of their backward kernels,
csrc/mean_edge_bwd.cu and csrc/attention_bwd.cu.

Counterpart of livingscenes_tpu/nn/pallas_attention.py (`fused_edge_mean`,
`fused_edge_attention`), with the same argument order and layouts:
features (B, N, C, 3), graph (B, N_dst, K), VecLNA weights W (O, 2C) over
the edge [nn - dst, dst] and D (O, O). `fused_edge_mean` and
`fused_edge_attention` take the plain version for tensors on the CPU and
launch the kernel for CUDA tensors; there is no fallback. The weight
halves (W_l and W_r - W_l) and transposes are prepared here; both forward
kernels do all their products once per point, the destination's half
included, in a first stage of their own (`mean_point_products_cuda`,
`attention_point_products_cuda`), and leave their edge passes only gathers,
sums and the non-linear work. Under
autograd each is a `torch.autograd.Function` that saves only its inputs and
whose backward recomputes the edges, as the TPU kernels' do: the plain VJP
on the CPU, the backward kernel on the card. Both backward kernels, like
their forwards, run their products once per point: the edge pass leaves
per point the summed cotangents of the rows, and the products by D, W_l
and W_r - W_l and the weight gradients follow as per-point products and
reductions over the points (csrc/mean_edge_bwd.cu, csrc/attention_bwd.cu,
through one shared helper of csrc/point_products.cuh).
"""
from __future__ import annotations

import math

import torch

from ..ops import _cuda
from ..ops.knn import gather_neighbors
from .edge_conv import fused_edge_kv
from .vec_layers import channel_equi_vec_normalize, leaky_relu, so3_activation

mean_launches = 0  # mean_edge.cu edge-pass launches since last set to 0
mean_products_launches = 0  # its per-point products' launches (two a call)
attention_launches = 0  # attention.cu edge-pass launches since last set to 0
products_launches = 0  # its per-point products' launches (two a call), ditto
mean_bwd_launches = 0  # mean_edge_bwd.cu edge-pass launches, ditto
# its per-point rows, products and reductions (five a call), ditto
mean_bwd_products_launches = 0
attention_bwd_launches = 0  # attention_bwd.cu edge-pass launches, ditto
# its per-point products and reductions (five a call), ditto
attention_bwd_products_launches = 0


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


def mean_point_products_plain(src_f, dst_f, W_l, W_delta, D):
    """The per-point products of the mean-edge kernel: for the source points
    Y = W_l src and Kd = D Y, for the destination points Y = W_delta dst and
    Kd = D Y, each (B, N, 3, 2 O) with columns [Y | Kd]. W_l and W_delta
    are (O, C)."""

    def rows(W, f):
        y = torch.einsum("oc,bnci->bnio", W, f)
        return torch.cat([y, torch.einsum("po,bnio->bnip", D, y)], -1)

    return rows(W_l, src_f), rows(W_delta, dst_f)


def _launch_mean_products(src_f, dst_f, W_l, W_delta, D, p_src, p_dst):
    """lstpu_mean_products (two launches) into p_src, p_dst."""
    B, Ns, C, _ = src_f.shape
    Nd, O = dst_f.shape[1], D.shape[0]
    dev = src_f.device
    # [W^T | (D W)^T]: the kernel writes the second half
    w_src = torch.empty((C, 2 * O), dtype=torch.float32, device=dev)
    w_dst = torch.empty_like(w_src)
    w_src[:, :O] = W_l.t()
    w_dst[:, :O] = W_delta.t()
    d_t = D.t().contiguous()
    err = _cuda.lib().lstpu_mean_products(
        src_f.data_ptr(), dst_f.data_ptr(), w_src.data_ptr(), w_dst.data_ptr(),
        d_t.data_ptr(), p_src.data_ptr(), p_dst.data_ptr(), B, Ns, Nd, C, O,
        _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, "mean_products")


def mean_point_products_cuda(src_f, dst_f, W_l, W_delta, D):
    """The per-point products (the first stage of the mean-edge kernel) for
    float32 tensors on the card: src_f (B, Ns, C, 3), dst_f (B, Nd, C, 3),
    W_l, W_delta (O, C), D (O, O). Returns (p_src, p_dst) as
    mean_point_products_plain; the kernel multiplies each point by
    [W | D W], the weight products D W in a launch of their own before it."""
    global mean_products_launches
    name = "mean_products"
    _cuda.require_cuda(name, src_f, dst_f, W_l, W_delta, D, dtype=torch.float32)
    B, Ns, C, _ = src_f.shape
    Nd, O = dst_f.shape[1], D.shape[0]
    if (src_f.shape[-1] != 3 or dst_f.shape != (B, Nd, C, 3)
            or W_l.shape != (O, C) or W_delta.shape != (O, C)
            or D.shape != (O, O) or O % 4):
        raise ValueError(f"{name}: src (B, Ns, C, 3), dst (B, Nd, C, 3), "
                         "W_l, W_delta (O, C), D (O, O), O a multiple of 4")
    dev = src_f.device
    p_src = torch.empty((B, Ns, 3, 2 * O), dtype=torch.float32, device=dev)
    p_dst = torch.empty((B, Nd, 3, 2 * O), dtype=torch.float32, device=dev)
    _launch_mean_products(src_f, dst_f, W_l, W_delta, D, p_src, p_dst)
    mean_products_launches += 2
    return p_src, p_dst


def fused_edge_mean_cuda(src_f, dst_f, idx, W, D, neg_slope: float = 0.2):
    """The kernel: float32 tensors on the card, idx int32 or int64; O a
    multiple of 4 up to 1024. Three launches: the two of the per-point
    products (`mean_products_launches`), then the edge pass
    (`mean_launches`)."""
    global mean_launches
    name = "edge_mean"
    _cuda.require_cuda(name, src_f, dst_f, W, D, dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W.shape[0]
    if W.shape != (O, 2 * C) or D.shape != (O, O):
        raise ValueError(f"{name}: W (O, 2C), D (O, O)")
    W_l = W[:, :C]
    p_src, p_dst = mean_point_products_cuda(src_f, dst_f, W_l.contiguous(),
                                            W[:, C:] - W_l, D)
    idx = idx.to(torch.int32)
    out = torch.empty((B, Nd, O, 3), dtype=torch.float32, device=src_f.device)
    err = _cuda.lib().lstpu_edge_mean(
        p_src.data_ptr(), p_dst.data_ptr(), idx.data_ptr(), out.data_ptr(),
        B, Ns, Nd, O, K, float(neg_slope), _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, name)
    mean_launches += 1
    return out


def attention_point_products_plain(src_f, dst_f, W_l, W_delta, D_K, D_V):
    """The per-point products of the attention kernel: for the source points
    Y = W_l src and Kd = D Y, for the destination points Y = W_delta dst and
    Kd = D Y, each (B, N, 3, 4 O) with columns [Y_K | Y_V | Kd_K | Kd_V].
    W_l and W_delta are (2 O, C), the K branch's rows first."""
    O = D_K.shape[0]

    def rows(W, f):
        y = torch.einsum("oc,bnci->bnio", W, f)
        return torch.cat([y, torch.einsum("po,bnio->bnip", D_K, y[..., :O]),
                          torch.einsum("po,bnio->bnip", D_V, y[..., O:])], -1)

    return rows(W_l, src_f), rows(W_delta, dst_f)


def _launch_attention_products(src_f, dst_f, W_l, W_delta, D_K, D_V, p_src,
                               p_dst):
    """lstpu_attention_products (two launches) into p_src, p_dst."""
    B, Ns, C, _ = src_f.shape
    Nd, O = dst_f.shape[1], D_K.shape[0]
    dev = src_f.device
    # [W^T | (D W)^T]: the kernel writes the second half
    w_src = torch.empty((C, 4 * O), dtype=torch.float32, device=dev)
    w_dst = torch.empty_like(w_src)
    w_src[:, :2 * O] = W_l.t()
    w_dst[:, :2 * O] = W_delta.t()
    dk_t, dv_t = D_K.t().contiguous(), D_V.t().contiguous()
    err = _cuda.lib().lstpu_attention_products(
        src_f.data_ptr(), dst_f.data_ptr(), w_src.data_ptr(),
        w_dst.data_ptr(), dk_t.data_ptr(), dv_t.data_ptr(), p_src.data_ptr(),
        p_dst.data_ptr(), B, Ns, Nd, C, O, _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, "attention_products")


def attention_point_products_cuda(src_f, dst_f, W_l, W_delta, D_K, D_V):
    """The per-point products (the first stage of the attention kernel) for
    float32 tensors on the card: src_f (B, Ns, C, 3), dst_f (B, Nd, C, 3),
    W_l, W_delta (2 O, C), D_K, D_V (O, O). Returns (p_src, p_dst) as
    attention_point_products_plain; the kernel multiplies each point by
    [W | D W], the weight products D W in a launch of their own before it."""
    global products_launches
    name = "attention_products"
    _cuda.require_cuda(name, src_f, dst_f, W_l, W_delta, D_K, D_V,
                       dtype=torch.float32)
    B, Ns, C, _ = src_f.shape
    Nd, O = dst_f.shape[1], D_K.shape[0]
    if (src_f.shape[-1] != 3 or dst_f.shape != (B, Nd, C, 3)
            or W_l.shape != (2 * O, C) or W_delta.shape != (2 * O, C)
            or D_V.shape != (O, O)):
        raise ValueError(f"{name}: src (B, Ns, C, 3), dst (B, Nd, C, 3), "
                         "W_l, W_delta (2O, C), D_K, D_V (O, O)")
    dev = src_f.device
    p_src = torch.empty((B, Ns, 3, 4 * O), dtype=torch.float32, device=dev)
    p_dst = torch.empty((B, Nd, 3, 4 * O), dtype=torch.float32, device=dev)
    _launch_attention_products(src_f, dst_f, W_l, W_delta, D_K, D_V, p_src,
                               p_dst)
    products_launches += 2
    return p_src, p_dst


def fused_edge_attention_cuda(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                              head_c: int = 16, neg_slope: float = 0.2):
    """The kernel: float32 tensors on the card, idx int32 or int64. Three
    launches: the two of the per-point products (`products_launches`), then
    the edge pass (`attention_launches`)."""
    global attention_launches
    name = "edge_attention"
    _cuda.require_cuda(name, src_f, dst_f, q_n, W_K, D_K, W_V, D_V,
                       dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W_K.shape[0]
    if (W_K.shape != (O, 2 * C) or W_V.shape != (O, 2 * C)
            or D_K.shape != (O, O) or D_V.shape != (O, O)
            or q_n.shape != (B, Nd, O, 3)):
        raise ValueError(f"{name}: W_K, W_V (O, 2C), D_K, D_V (O, O), "
                         "q_n (B, Nd, O, 3)")
    W_l = torch.cat([W_K[:, :C], W_V[:, :C]], dim=0)  # (2O, C)
    W_delta = torch.cat([W_K[:, C:], W_V[:, C:]], dim=0) - W_l
    p_src, p_dst = attention_point_products_cuda(src_f, dst_f, W_l, W_delta,
                                                 D_K, D_V)
    idx = idx.to(torch.int32)
    out = torch.empty((B, Nd, O, 3), dtype=torch.float32, device=src_f.device)
    err = _cuda.lib().lstpu_edge_attention(
        p_src.data_ptr(), p_dst.data_ptr(), q_n.data_ptr(), idx.data_ptr(),
        out.data_ptr(), B, Ns, Nd, O, K, head_c, float(neg_slope),
        _cuda.stream_ptr(src_f),
    )
    _cuda.check(err, name)
    attention_launches += 1
    return out


def _vjp(fn, inputs, g):
    """The VJP of fn at the cotangent g w.r.t. every tensor of `inputs` that
    is floating point, by autograd; None for the others."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) if t.is_floating_point() else t
                  for t in inputs]
        out = fn(*leaves)
        wrt = [t for t in leaves if t.is_floating_point()]
        grads = iter(torch.autograd.grad(out, wrt, g))
    return tuple(next(grads) if t.is_floating_point() else None for t in inputs)


def fused_edge_mean_bwd_plain(src_f, dst_f, idx, W, D, g, neg_slope: float = 0.2):
    """The plain backward: the VJP of the plain version at the cotangent g
    (B, N_dst, O, 3). Returns (d_src, d_dst, d_W, d_D)."""
    d_src, d_dst, _, d_W, d_D = _vjp(
        lambda *a: fused_edge_mean_plain(*a, neg_slope),
        (src_f, dst_f, idx, W, D), g)
    return d_src, d_dst, d_W, d_D


def _bwd_products_inputs(src_f, dst_f, size):
    """The scratch, output and feature layouts of a backward's linear rest
    (the three launches after its edge pass): part (splits, size), out
    (size), src3 and dst3 (components first) and their gradients."""
    B, Ns, Nd = src_f.shape[0], src_f.shape[1], dst_f.shape[1]
    dev = src_f.device
    splits = _cuda.lib().lstpu_edge_bwd_splits(B, Ns, Nd)
    part = torch.empty((splits, size), dtype=torch.float32, device=dev)
    out = torch.empty(size, dtype=torch.float32, device=dev)
    src3 = src_f.transpose(2, 3).contiguous()
    dst3 = dst_f.transpose(2, 3).contiguous()
    return part, out, src3, dst3, torch.empty_like(src3), torch.empty_like(dst3)


def fused_edge_mean_bwd_cuda(src_f, dst_f, idx, W, D, g, neg_slope: float = 0.2):
    """The backward kernel: (d_src, d_dst, d_W, d_D) for float32 tensors on
    the card. O a multiple of 4 up to 512. Six launches
    (csrc/mean_edge_bwd.cu): the forward's per-point rows again (two), the
    edge pass (`mean_bwd_launches`), which sums the cotangents of each
    point's rows, then the products by D, W_l and W_r - W_l and the weight
    gradients' split reductions (three); the five beside the edge pass
    count in `mean_bwd_products_launches`."""
    global mean_bwd_launches, mean_bwd_products_launches
    name = "edge_mean_bwd"
    _cuda.require_cuda(name, src_f, dst_f, W, D, g, dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W.shape[0]
    if W.shape != (O, 2 * C) or D.shape != (O, O) or g.shape != (B, Nd, O, 3):
        raise ValueError(f"{name}: W (O, 2C), D (O, O), g (B, Nd, O, 3)")
    W_l = W[:, :C].contiguous()
    W_delta = W[:, C:] - W_l
    idx = idx.to(torch.int32)
    lib = _cuda.lib()
    stream = _cuda.stream_ptr(src_f)
    n_src = B * Ns
    # the rows of the source points, then of the destination points: the
    # products' [Y | Kd], and their cotangents
    rows = torch.empty((B * (Ns + Nd), 3, 2 * O), dtype=torch.float32,
                       device=src_f.device)
    _launch_mean_products(src_f, dst_f, W_l, W_delta, D, rows[:n_src],
                          rows[n_src:])
    mean_bwd_products_launches += 2
    grows = torch.empty_like(rows)
    grows[:n_src].zero_()  # the sources' rows take atomic sums
    err = lib.lstpu_edge_mean_bwd(
        rows.data_ptr(), rows[n_src:].data_ptr(), idx.data_ptr(),
        g.data_ptr(), grows.data_ptr(), grows[n_src:].data_ptr(), B, Ns, Nd,
        O, K, float(neg_slope), stream,
    )
    _cuda.check(err, name)
    mean_bwd_launches += 1
    part, out, src3, dst3, d_src3, d_dst3 = _bwd_products_inputs(
        src_f, dst_f, 2 * C * O + O * O)
    err = lib.lstpu_mean_bwd_products(
        grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
        W_l.data_ptr(), W_delta.data_ptr(), D.data_ptr(), d_src3.data_ptr(),
        d_dst3.data_ptr(), part.data_ptr(), out.data_ptr(), B, Ns, Nd, C, O,
        stream,
    )
    _cuda.check(err, name)
    mean_bwd_products_launches += 3
    d_src = d_src3.transpose(2, 3).contiguous()
    d_dst = d_dst3.transpose(2, 3).contiguous()
    d_W_l, d_D, d_W_delta = torch.split(out, [C * O, O * O, C * O])
    d_W_l, d_W_delta = d_W_l.view(O, C), d_W_delta.view(O, C)
    d_W = torch.cat([d_W_l - d_W_delta, d_W_delta], dim=1)
    return d_src, d_dst, d_W, d_D.view(O, O)


def fused_edge_attention_bwd_plain(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                                   g, head_c: int = 16, neg_slope: float = 0.2):
    """The plain backward: the VJP of the plain version at the cotangent g.
    Returns (d_src, d_dst, d_q_n, d_W_K, d_D_K, d_W_V, d_D_V)."""
    grads = _vjp(
        lambda *a: fused_edge_attention_plain(*a, head_c, neg_slope),
        (src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V), g)
    return grads[:2] + grads[3:]


def fused_edge_attention_bwd_cuda(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                                  g, head_c: int = 16, neg_slope: float = 0.2):
    """The backward kernel, and per point the rest of JAX's `_attn_bwd_impl`:
    (d_src, d_dst, d_q_n, d_W_K, d_D_K, d_W_V, d_D_V) for float32 tensors on
    the card. O up to 512. Six launches (csrc/attention_bwd.cu): the
    forward's per-point rows again (two), the edge pass
    (`attention_bwd_launches`), which sums the cotangents of each point's
    rows, then the products by D, W_l and W_r - W_l and the weight
    gradients' split reductions (three); the five beside the edge pass
    count in `attention_bwd_products_launches`."""
    global attention_bwd_launches, attention_bwd_products_launches
    name = "edge_attention_bwd"
    _cuda.require_cuda(name, src_f, dst_f, q_n, W_K, D_K, W_V, D_V, g,
                       dtype=torch.float32)
    _cuda.require_cuda(name, src_f, idx)
    B, Ns, Nd, C, K = _check_graph(name, src_f, dst_f, idx)
    O = W_K.shape[0]
    if (W_K.shape != (O, 2 * C) or W_V.shape != (O, 2 * C)
            or D_K.shape != (O, O) or D_V.shape != (O, O)
            or q_n.shape != (B, Nd, O, 3) or g.shape != (B, Nd, O, 3)):
        raise ValueError(f"{name}: W_K, W_V (O, 2C), D_K, D_V (O, O), "
                         "q_n, g (B, Nd, O, 3)")
    W_l = torch.cat([W_K[:, :C], W_V[:, :C]], dim=0)  # (2O, C)
    W_delta = torch.cat([W_K[:, C:], W_V[:, C:]], dim=0) - W_l
    idx = idx.to(torch.int32)
    dev = src_f.device
    lib = _cuda.lib()
    stream = _cuda.stream_ptr(src_f)
    n_src = B * Ns
    # the rows of the source points, then of the destination points: the
    # products' [Y_K | Y_V | Kd_K | Kd_V], and their cotangents
    rows = torch.empty((B * (Ns + Nd), 3, 4 * O), dtype=torch.float32,
                       device=dev)
    _launch_attention_products(src_f, dst_f, W_l, W_delta, D_K, D_V,
                               rows[:n_src], rows[n_src:])
    attention_bwd_products_launches += 2
    grows = torch.empty_like(rows)
    grows[:n_src].zero_()  # the sources' rows take atomic sums
    d_qn = torch.empty((B, Nd, O, 3), dtype=torch.float32, device=dev)
    err = lib.lstpu_edge_attention_bwd(
        rows.data_ptr(), rows[n_src:].data_ptr(), q_n.data_ptr(),
        idx.data_ptr(), g.data_ptr(), grows.data_ptr(),
        grows[n_src:].data_ptr(), d_qn.data_ptr(), B, Ns, Nd, O, K, head_c,
        float(neg_slope), stream,
    )
    _cuda.check(err, name)
    attention_bwd_launches += 1
    part, out, src3, dst3, d_src3, d_dst3 = _bwd_products_inputs(
        src_f, dst_f, 4 * C * O + 2 * O * O)
    err = lib.lstpu_attention_bwd_products(
        grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
        W_l.data_ptr(), W_delta.data_ptr(), D_K.data_ptr(), D_V.data_ptr(),
        d_src3.data_ptr(), d_dst3.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, Ns, Nd, C, O, stream,
    )
    _cuda.check(err, name)
    attention_bwd_products_launches += 3
    d_src = d_src3.transpose(2, 3).contiguous()
    d_dst = d_dst3.transpose(2, 3).contiguous()
    d_W_l, d_DK, d_DV, d_W_delta = torch.split(
        out, [2 * C * O, O * O, O * O, 2 * C * O])
    d_W_l, d_W_delta = d_W_l.view(2 * O, C), d_W_delta.view(2 * O, C)
    d_DK, d_DV = d_DK.view(O, O), d_DV.view(O, O)
    d_WK = torch.cat([d_W_l[:O] - d_W_delta[:O], d_W_delta[:O]], dim=1)
    d_WV = torch.cat([d_W_l[O:] - d_W_delta[O:], d_W_delta[O:]], dim=1)
    return d_src, d_dst, d_qn, d_WK, d_DK, d_WV, d_DV


class _EdgeMean(torch.autograd.Function):
    """Saves (src, dst, idx, W, D) only; the backward recomputes the edges."""

    @staticmethod
    def forward(ctx, src_f, dst_f, idx, W, D, neg_slope):
        ctx.save_for_backward(src_f, dst_f, idx, W, D)
        ctx.neg_slope = neg_slope
        if src_f.device.type == "cpu":
            return fused_edge_mean_plain(src_f, dst_f, idx, W, D, neg_slope)
        return fused_edge_mean_cuda(src_f, dst_f, idx, W, D, neg_slope)

    @staticmethod
    def backward(ctx, g):
        src_f, dst_f, idx, W, D = ctx.saved_tensors
        bwd = (fused_edge_mean_bwd_plain if src_f.device.type == "cpu"
               else fused_edge_mean_bwd_cuda)
        d_src, d_dst, d_W, d_D = bwd(src_f, dst_f, idx, W, D, g.contiguous(),
                                     ctx.neg_slope)
        return d_src, d_dst, None, d_W, d_D, None


class _EdgeAttention(torch.autograd.Function):
    """Saves (src, dst, idx, q_n, weights) only; the backward recomputes the
    edges."""

    @staticmethod
    def forward(ctx, src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V, head_c,
                neg_slope):
        ctx.save_for_backward(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V)
        ctx.head_c, ctx.neg_slope = head_c, neg_slope
        fwd = (fused_edge_attention_plain if src_f.device.type == "cpu"
               else fused_edge_attention_cuda)
        return fwd(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V, head_c, neg_slope)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        bwd = (fused_edge_attention_bwd_plain if saved[0].device.type == "cpu"
               else fused_edge_attention_bwd_cuda)
        d_src, d_dst, d_qn, d_WK, d_DK, d_WV, d_DV = bwd(
            *saved, g.contiguous(), ctx.head_c, ctx.neg_slope)
        return d_src, d_dst, None, d_qn, d_WK, d_DK, d_WV, d_DV, None, None


def fused_edge_mean(src_f, dst_f, idx, W, D, neg_slope: float = 0.2):
    """mean_K(VecLNA(2C, O)([nn - dst, dst])): (B, N_dst, O, 3).
    Differentiable w.r.t. everything but idx."""
    args = (t.contiguous() for t in (src_f, dst_f, idx, W, D))
    return _EdgeMean.apply(*args, neg_slope)


def fused_edge_attention(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V,
                         head_c: int = 16, neg_slope: float = 0.2):
    """One attention layer's message passing: (B, N_dst, O, 3).
    Differentiable w.r.t. everything but idx."""
    args = (t.contiguous() for t in (src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V))
    return _EdgeAttention.apply(*args, head_c, neg_slope)
