"""The backward kernels of layer 0 and of the mean edge layer
(csrc/layer0_bwd.cu; csrc/mean_edge_bwd.cu with csrc/point_products.cuh) on
CPU threads: their launches, the mean edge layer's one-branch products
alone, layer 0's weight gradients repeating bit for bit, and layer 0 at
widths whose points span several warps.

The kernels' own code built by the host's g++ against the stand-in for the
CUDA runtime and run on CPU threads: the stand-in, the build and the
`on_host` fixture are those of tests/test_torch_port_kernels_emulated.py,
whose docstring says what this shows and what it cannot. Apart from the
other backward cases (tests/test_torch_port_kernels_emulated_bwd.py) so
that no one file sets the length of a run of the tests over several
workers.

Tolerances: against autograd of the plain versions rtol 2e-4 plus atol 2e-5
of the largest magnitude, as on the card (the sources' gradients are sums
of float atomics in no fixed order); the products launch against the same
products written out, the same. At O = 200 and 512 the random inputs make
f32 itself lose digits (a channel whose direction D y cancels to a small
part of its terms; an f32 evaluation of the plain VJP lies up to 1.6e-4 of
the largest entry from the f64 one), so there each gradient is held to the
f64 plain VJP: its largest error at most 2e-5 of the largest entry or 4
times that of the f32 plain VJP. The kernels form D y as (D W) e, the
forward's association, where the plain version forms D (W e); on a
channel whose direction cancels the two f32 evaluations lose different
digits (at N, K, O = 266, 5, 512 the f32 VJP in the kernels' association
lies 1.3e-4 of the largest d_W entry from the f64 one, the plain one
3.7e-6), so the repeat cases allow 4 times the larger of the two f32 VJPs'
errors.
"""
import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
from livingscenes_tpu_torch.nn.vec_layers import leaky_relu, so3_activation
from livingscenes_tpu_torch.ops import _cuda
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    assert_all_close, assert_close, emulated, f32, on_host)
from test_torch_port_kernels_emulated_bwd import graph_with_repeats
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def layer0_inputs(rng, N, K, O):
    xyz = f32(rng, 2, N, 3)
    xyz[1, 3] = 0.0  # a point at the origin: dst^'s clamp
    return (xyz, graph_with_repeats(rng, N, N, K), f32(rng, O, 3, scale=0.5),
            f32(rng, O, O, scale=0.2), f32(rng, 2, N, O, 3))


def layer0_vjp_dw_first(xyz, idx, W, D, g):
    """The VJP of layer 0's forward with D y formed as (D W) e, as the
    kernels form it (the plain version forms D (W e)), by autograd."""
    with torch.enable_grad():
        xyz, W, D = (t.detach().requires_grad_(True) for t in (xyz, W, D))
        f = xyz[:, :, None, :]
        e = cuda_layer0.layer0_edge(f, f, idx)
        y = torch.einsum("oc,...ci->...oi", W, e)
        k = torch.einsum("oc,...ci->...oi", D @ W, e)
        out = torch.mean(so3_activation(y, k, leaky_relu(0.2)), dim=2)
        return torch.autograd.grad(out, (xyz, W, D), g)


def mean_inputs(rng, Ns, Nd, C, O, K):
    return (f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3),
            graph_with_repeats(rng, Ns, Nd, K), f32(rng, O, 2 * C, scale=0.2),
            f32(rng, O, O, scale=0.2), f32(rng, 2, Nd, O, 3))


def test_layer0_bwd_kernel_launches(on_host):
    # one call: the edge pass and the fold of its partials, counted apart
    args = layer0_inputs(np.random.default_rng(30), 21, 8, 32)
    names = ("bwd_launches", "bwd_fold_launches", "launches")
    before = [getattr(cuda_layer0, n) for n in names]
    got = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
    assert [getattr(cuda_layer0, n) - b
            for n, b in zip(names, before)] == [1, 1, 0]
    assert_all_close(got, cuda_layer0.fused_layer0_edge_mean_bwd_plain(*args))


def test_mean_edge_bwd_kernel_launches(on_host):
    # six launches: the per-point rows (two), the edge pass, the products
    # and reductions (three); a ragged last block, K < 16
    args = mean_inputs(np.random.default_rng(31), 40, 7, 16, 32, 8)
    names = ("mean_bwd_launches", "mean_bwd_products_launches",
             "mean_products_launches", "mean_launches")
    before = [getattr(cuda_attention, n) for n in names]
    got = cuda_attention.fused_edge_mean_bwd_cuda(*args)
    assert [getattr(cuda_attention, n) - b
            for n, b in zip(names, before)] == [1, 5, 0, 0]
    assert_all_close(got, cuda_attention.fused_edge_mean_bwd_plain(*args))


@pytest.mark.parametrize(
    "B,Ns,Nd,C,O",
    [
        (2, 300, 77, 12, 8),     # 2262 rows: 3 partial sums of 754, C % 8
        (1, 5, 3, 4, 4),         # 24 rows, one partial sum
        (2, 200, 190, 36, 132),  # 3 partial sums, a ragged column tile of O
    ],
)
def test_mean_bwd_products_kernel(on_host, B, Ns, Nd, C, O):
    # the linear rest of the mean edge backward alone (one branch), against
    # the same products written out: Z = U + D^T V in place of U,
    # d_src = Z_src W_l, d_dst = Z_dst W_delta, and the split reductions
    # [Z_src^T src | V^T Y | Z_dst^T dst]
    rng = np.random.default_rng(32)
    n_src, n_all = B * Ns, B * (Ns + Nd)
    grows = f32(rng, n_all, 3, 2 * O)
    rows = f32(rng, n_all, 3, 2 * O)
    src3, dst3 = f32(rng, B, Ns, 3, C), f32(rng, B, Nd, 3, C)
    W_l, W_delta = f32(rng, O, C, scale=0.2), f32(rng, O, C, scale=0.2)
    D = f32(rng, O, O, scale=0.2)
    lib = _cuda.lib()
    splits = lib.lstpu_edge_bwd_splits(B, Ns, Nd)
    size = 2 * C * O + O * O
    part = torch.full((splits, size), float("nan"))
    out = torch.empty(size)
    d_src3, d_dst3 = torch.empty_like(src3), torch.empty_like(dst3)
    U, V = grows[..., :O].clone(), grows[..., O:].clone()
    err = lib.lstpu_mean_bwd_products(
        grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
        W_l.data_ptr(), W_delta.data_ptr(), D.data_ptr(), d_src3.data_ptr(),
        d_dst3.data_ptr(), part.data_ptr(), out.data_ptr(), B, Ns, Nd, C, O, 0)
    assert err == 0
    Z = U + V @ D
    assert_close(grows[..., :O], Z)
    assert torch.equal(grows[..., O:], V)  # V untouched
    Z_src = Z[:n_src].reshape(B, Ns, 3, O)
    Z_dst = Z[n_src:].reshape(B, Nd, 3, O)
    assert_close(d_src3, Z_src @ W_l)
    assert_close(d_dst3, Z_dst @ W_delta)
    want = torch.cat([
        torch.einsum("bnio,bnic->oc", Z_src, src3).reshape(-1),
        torch.einsum("rio,rip->op", V, rows[..., :O]).reshape(-1),
        torch.einsum("bnio,bnic->oc", Z_dst, dst3).reshape(-1)])
    assert_close(out, want)
    # the fold is the ordered sum of the partials
    ordered = part[0].clone()
    for p in part[1:]:
        ordered += p
    assert torch.equal(out, ordered)


@pytest.mark.parametrize("N,K,O", [(40, 16, 32), (18, 16, 132)])
def test_layer0_bwd_weights_repeat(on_host, N, K, O):
    # d_W and d_D are sums in a fixed order (per thread, per block, then
    # the partials folded in order): two calls on a graph whose sources
    # repeat give the same bits; d_xyz takes float atomics and is only close
    args = layer0_inputs(np.random.default_rng(33), N, K, O)
    first = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
    second = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    assert_all_close(second, cuda_layer0.fused_layer0_edge_mean_bwd_plain(*args))


@pytest.mark.parametrize(
    "N,K,O",
    [
        (266, 5, 512),  # 8 warps a point, 2 points a block, K odd
        (530, 4, 132),  # 3 warps a point, 2 points a group, 2 groups a block
    ],
)
def test_layer0_bwd_wide_sums_repeat(on_host, N, K, O):
    # past 64 channels a point's sums over its channels meet in shared
    # memory, in two halves taken in turn; the 6-wide sums of the edges and
    # the 3-wide one of the destination that follows must each keep to
    # their half. A block walks two groups of points (B N / P > 528), so
    # both parities of the last edge meet the destination's sum; the weight
    # gradients repeat bit for bit over calls and hold to the f64 plain VJP
    # (see the top of this file)
    args = layer0_inputs(np.random.default_rng(36), N, K, O)
    runs = [cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
            for _ in range(3)]
    for again in runs[1:]:
        assert torch.equal(runs[0][1], again[1])
        assert torch.equal(runs[0][2], again[2])
    plain = cuda_layer0.fused_layer0_edge_mean_bwd_plain
    want = plain(*(a.double() if a.is_floating_point() else a for a in args))
    for g, w, p, q in zip(runs[0], want, plain(*args),
                          layer0_vjp_dw_first(*args)):
        top = float(w.abs().max())
        err = float((g.double() - w).abs().max()) / top
        err_f32 = max(float((r.double() - w).abs().max()) / top for r in (p, q))
        assert err <= max(2e-5, 4 * err_f32), (err, err_f32)


@pytest.mark.parametrize(
    "N,K,O",
    [
        (9, 16, 200),   # 100 channel pairs: 4 warps a point, 2 points a block
        (5, 11, 512),   # the widest: one point a block over all 8 warps
        (3000, 4, 32),  # the cloud past shared memory: read from L1/L2
    ],
)
def test_layer0_bwd_kernel_wide(on_host, N, K, O):
    args = layer0_inputs(np.random.default_rng(34), N, K, O)
    plain = cuda_layer0.fused_layer0_edge_mean_bwd_plain
    got = cuda_layer0.fused_layer0_edge_mean_bwd_cuda(*args)
    want = plain(*(a.double() if a.is_floating_point() else a for a in args))
    for g, w, p in zip(got, want, plain(*args)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        top = float(w.abs().max())
        err = float((g.double() - w).abs().max()) / top
        err_plain = float((p.double() - w).abs().max()) / top
        assert err <= max(2e-5, 4 * err_plain), (err, err_plain)


def test_mean_edge_bwd_kernel_wide(on_host):
    # the widest O (two points a block), Nd < Ns, K < 16
    args = mean_inputs(np.random.default_rng(35), 14, 5, 8, 512, 9)
    assert_all_close(cuda_attention.fused_edge_mean_bwd_cuda(*args),
                     cuda_attention.fused_edge_mean_bwd_plain(*args))
