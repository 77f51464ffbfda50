"""The backward kernels of the fused edge layers (csrc/layer0_bwd.cu,
csrc/mean_edge_bwd.cu, csrc/attention_bwd.cu with csrc/point_products.cuh)
on CPU threads, held against autograd of their plain versions.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. Apart from the forward kernels' cases so that no
one file sets the length of a run of the tests over several workers.

Tolerances: rtol 2e-4 plus atol 2e-5 of the largest magnitude, as on the
card (the kernels add the sources' gradients with atomics, in no fixed
order). The new designs' launches, products and wide cases of rows 12-13
are in tests/test_torch_port_kernels_emulated_edge_bwd.py.
"""
import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
from livingscenes_tpu_torch.nn.vec_layers import channel_equi_vec_normalize
from livingscenes_tpu_torch.ops import _cuda
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    assert_all_close, assert_close, emulated, f32, on_host)
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def graph_with_repeats(rng, n_src, n_dst, K):
    """A (2, n_dst, K) graph whose sources repeat within and across rows: a
    few sources are every row's neighbours, so the scatter adds many edges
    into one row."""
    idx = rng.integers(0, n_src, (2, n_dst, K))
    idx[:, :, 0] = 0
    idx[:, ::2, 1] = n_src - 1
    idx[:, 1::3, 2 % K] = 0  # row repeats the same source
    return torch.as_tensor(idx)


@pytest.mark.parametrize("N,K,O", [(40, 16, 32), (33, 8, 48), (18, 16, 132)])
def test_layer0_bwd_kernel(on_host, N, K, O):
    rng = np.random.default_rng(10)
    xyz = f32(rng, 2, N, 3)
    xyz[1, 3] = 0.0  # a point at the origin: dst^'s clamp
    idx = graph_with_repeats(rng, N, N, K)
    W, D = f32(rng, O, 3, scale=0.5), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, N, O, 3)
    assert_all_close(
        cuda_layer0.fused_layer0_edge_mean_bwd_cuda(xyz, idx, W, D, g),
        cuda_layer0.fused_layer0_edge_mean_bwd_plain(xyz, idx, W, D, g))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K", [(50, 50, 32, 32, 16), (40, 21, 16, 48, 8), (30, 5, 36, 140, 7)])
def test_mean_edge_bwd_kernel(on_host, Ns, Nd, C, O, K):
    rng = np.random.default_rng(11)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = graph_with_repeats(rng, Ns, Nd, K)
    W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, Nd, O, 3)
    args = (src, dst, idx, W, D, g)
    assert_all_close(cuda_attention.fused_edge_mean_bwd_cuda(*args),
                     cuda_attention.fused_edge_mean_bwd_plain(*args))


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [
        (40, 20, 32, 64, 16, 16),   # the width of attention layers 2-3
        (40, 7, 16, 32, 8, 16),     # ragged last block, K < 16
        (24, 3, 20, 144, 5, 8),     # two output tiles, the second partial
        (20, 3, 128, 256, 16, 16),  # the width of attention layer 5
        (12, 2, 256, 512, 16, 16),  # the width of layer 6: 2 points a block
        (300, 70, 8, 16, 16, 16),   # 3 partial sums of 740 rows, Nd < Ns
    ],
)
def test_attention_bwd_kernel(on_host, Ns, Nd, C, O, K, head_c):
    rng = np.random.default_rng(12)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = graph_with_repeats(rng, Ns, Nd, K)
    q_n = channel_equi_vec_normalize(f32(rng, 2, Nd, O, 3))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    g = f32(rng, 2, Nd, O, 3)
    args = (src, dst, idx, q_n, W_K, D_K, W_V, D_V, g, head_c)
    assert_all_close(cuda_attention.fused_edge_attention_bwd_cuda(*args),
                     cuda_attention.fused_edge_attention_bwd_plain(*args))


def test_attention_bwd_kernel_launches(on_host):
    # six launches: the per-point rows (two), the edge pass, the products
    # and reductions (three); a ragged last block, K < 16
    rng = np.random.default_rng(23)
    Ns, Nd, C, O, K = 40, 7, 16, 32, 8
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = graph_with_repeats(rng, Ns, Nd, K)
    q_n = channel_equi_vec_normalize(f32(rng, 2, Nd, O, 3))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    args = (src, dst, idx, q_n, W_K, D_K, W_V, D_V, f32(rng, 2, Nd, O, 3))
    before = (cuda_attention.attention_bwd_launches,
              cuda_attention.attention_bwd_products_launches,
              cuda_attention.products_launches)
    got = cuda_attention.fused_edge_attention_bwd_cuda(*args)
    assert (cuda_attention.attention_bwd_launches - before[0],
            cuda_attention.attention_bwd_products_launches - before[1],
            cuda_attention.products_launches - before[2]) == (1, 5, 0)
    assert_all_close(got, cuda_attention.fused_edge_attention_bwd_plain(*args))


@pytest.mark.parametrize(
    "B,Ns,Nd,C,O",
    [
        (2, 300, 77, 12, 8),     # 2262 rows: 3 partial sums of 754 (no
                                 # multiple of a slice), C % 8
        (1, 5, 3, 4, 4),         # 24 rows, one partial sum
        (2, 200, 190, 36, 132),  # 3 partial sums, two column tiles of O
    ],
)
def test_attention_bwd_products_kernel(on_host, B, Ns, Nd, C, O):
    # the linear rest of the attention backward alone, against the same
    # products written out: Z = U + D^T V in place of U, d_src = Z_src W_l,
    # d_dst = Z_dst W_delta, and the split reductions
    # [Z_src^T src | V_K^T Y_K | V_V^T Y_V | Z_dst^T dst]
    rng = np.random.default_rng(24)
    n_src, n_all = B * Ns, B * (Ns + Nd)
    grows = f32(rng, n_all, 3, 4 * O)
    rows = f32(rng, n_all, 3, 4 * O)
    src3, dst3 = f32(rng, B, Ns, 3, C), f32(rng, B, Nd, 3, C)
    W_l, W_delta = f32(rng, 2 * O, C, scale=0.2), f32(rng, 2 * O, C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    lib = _cuda.lib()
    splits = lib.lstpu_edge_bwd_splits(B, Ns, Nd)
    assert splits == max(1, -(-3 * n_all // 1024))
    size = 4 * C * O + 2 * O * O
    part = torch.full((splits, size), float("nan"))
    out = torch.empty(size)
    d_src3, d_dst3 = torch.empty_like(src3), torch.empty_like(dst3)
    U, V = grows[..., :2 * O].clone(), grows[..., 2 * O:].clone()
    err = lib.lstpu_attention_bwd_products(
        grows.data_ptr(), rows.data_ptr(), src3.data_ptr(), dst3.data_ptr(),
        W_l.data_ptr(), W_delta.data_ptr(), D_K.data_ptr(), D_V.data_ptr(),
        d_src3.data_ptr(), d_dst3.data_ptr(), part.data_ptr(), out.data_ptr(),
        B, Ns, Nd, C, O, 0)
    assert err == 0
    Z = torch.cat([U[..., :O] + V[..., :O] @ D_K, U[..., O:] + V[..., O:] @ D_V], -1)
    assert_close(grows[..., :2 * O], Z)
    assert torch.equal(grows[..., 2 * O:], V)  # V untouched
    Z_src = Z[:n_src].reshape(B, Ns, 3, 2 * O)
    Z_dst = Z[n_src:].reshape(B, Nd, 3, 2 * O)
    assert_close(d_src3, Z_src @ W_l)
    assert_close(d_dst3, Z_dst @ W_delta)
    want = torch.cat([
        torch.einsum("bnio,bnic->oc", Z_src, src3).reshape(-1),
        torch.einsum("rio,rip->op", V[..., :O], rows[..., :O]).reshape(-1),
        torch.einsum("rio,rip->op", V[..., O:], rows[..., O:2 * O]).reshape(-1),
        torch.einsum("bnio,bnic->oc", Z_dst, dst3).reshape(-1)])
    assert_close(out, want)
    # the fold is the ordered sum of the partials
    ordered = part[0].clone()
    for p in part[1:]:
        ordered += p
    assert torch.equal(out, ordered)
