"""The VJPs of the port's fused edge layers (kernel-table rows 12-14: the
backward of layer 0, of the mean edge layer and of vector attention) held
against the JAX package on the CPU.

The port's wrappers, called on tensors that require grad, go through their
`torch.autograd.Function`, whose backward on the CPU is the plain VJP (the
card runs csrc/*_bwd.cu there; tests/test_torch_port_kernels_emulated.py
holds those sources against the same plain VJP). Inputs, cotangents and a
graph with repeated sources (one source every row's neighbour, a row that
names one source twice) and ragged N_dst come from a seed.

Tolerances:
  * f32 against JAX's custom VJP running the Pallas backward kernels in
    interpret mode: every gradient within 1e-5 of its largest entry;
  * f64 against jax.vjp of the XLA path (the encoder's unfused branch
    written out here): rtol 1e-9 of each entry plus 1e-9 of the largest
    (rounding only; the functions are the same).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.nn import pallas_attention as jpa
from livingscenes_tpu.nn import pallas_layer0 as jl0
from livingscenes_tpu.nn.edge_conv import fused_edge_kv
from livingscenes_tpu.nn.vec_layers import VecLNA, channel_equi_vec_normalize
from livingscenes_tpu.ops.knn import gather_neighbors
from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0


def act(x):
    return jax.nn.leaky_relu(x, negative_slope=0.2)


def repeated_graph(rng, n_src, n_dst, K, B=2):
    idx = rng.integers(0, n_src, (B, n_dst, K))
    idx[:, :, 0] = 0               # one source in every row
    idx[:, ::2, 1] = n_src - 1
    idx[:, 1::3, 2] = idx[:, 1::3, 3]  # a row that names a source twice
    return idx.astype(np.int32)


def torch_vjp(fn, inputs, wrt, cot):
    """Gradients of sum(fn(*inputs) * cot) w.r.t. the inputs at `wrt`."""
    ts = [torch.tensor(a, requires_grad=i in wrt) if a.dtype != np.int32
          else torch.tensor(a) for i, a in enumerate(inputs)]
    out = fn(*ts)
    grads = torch.autograd.grad(out, [ts[i] for i in wrt], torch.tensor(cot))
    return [g.numpy() for g in grads]


def jax_vjp(fn, inputs, wrt, cot):
    def f(*diff):
        full = list(inputs)
        for i, d in zip(wrt, diff):
            full[i] = d
        return fn(*full)

    vjp = jax.jit(lambda diff, c: jax.vjp(f, *diff)[1](c))
    grads = vjp([jnp.asarray(inputs[i]) for i in wrt], jnp.asarray(cot))
    return [np.asarray(g) for g in grads]


def check_f32(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * top, err_msg=name)


def check_f64(got, want, names):
    for name, g, w in zip(names, got, want):
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9 * top, err_msg=name)


# --- the XLA path of each layer, as the encoder's unfused branch ---------

def xla_layer0(xyz, idx, W, D):
    lna = VecLNA(3, W.shape[0], act_func=act, mode="so3")
    src_f = xyz[:, :, None, :]
    nn_f = jnp.take_along_axis(src_f[:, None], idx[..., None, None], axis=2)
    dst_pad = jnp.broadcast_to(src_f[:, :, None], nn_f.shape)
    dst_dir = src_f / jnp.maximum(jnp.linalg.norm(src_f, axis=-1, keepdims=True),
                                  1e-12)
    crossed = jnp.cross(jnp.broadcast_to(dst_dir[:, :, None], nn_f.shape), nn_f)
    edge = jnp.concatenate([crossed, nn_f - dst_pad, dst_pad], axis=-2)
    p = {"params": {"lin": {"weight": W}, "act": {"lin_dir": {"weight": D}}}}
    return jnp.mean(lna.apply(p, edge), axis=2)


def gather(src_f, idx):
    B, Ns, C, _ = src_f.shape
    return gather_neighbors(src_f.reshape(B, Ns, C * 3), idx).reshape(
        B, idx.shape[1], idx.shape[2], C, 3)


def xla_mean(src_f, dst_f, idx, W, D):
    lna = VecLNA(W.shape[1], W.shape[0], act_func=act, mode="so3")
    nn_f = gather(src_f, idx)
    dst_pad = jnp.broadcast_to(dst_f[:, :, None], nn_f.shape)
    edge = jnp.concatenate([nn_f - dst_pad, dst_pad], axis=-2)
    p = {"params": {"lin": {"weight": W}, "act": {"lin_dir": {"weight": D}}}}
    return jnp.mean(lna.apply(p, edge), axis=2)


def xla_attention(src_f, dst_f, idx, q_n, W_K, D_K, W_V, D_V, head_c):
    k_feat, v_feat = fused_edge_kv(gather(src_f, idx), dst_f, W_K, D_K, W_V,
                                   D_V, act)
    qk = jnp.einsum("bnkci,bnci->bnkc", channel_equi_vec_normalize(k_feat), q_n)
    B, Nd, K, O = qk.shape
    qk_h = qk.reshape(B, Nd, K, O // head_c, head_c)
    attn = jnp.sum(qk_h, axis=-1, keepdims=True) / jnp.sqrt(
        jnp.asarray(3 * head_c, qk.dtype))
    attn = jnp.broadcast_to(jax.nn.softmax(attn, axis=2), qk_h.shape)
    return jnp.einsum("bnkc,bnkci->bnci", attn.reshape(qk.shape), v_feat)


# --- inputs ---------------------------------------------------------------

def layer0_case(N, K, O, dtype, origin=False):
    rng = np.random.default_rng(30 + N)
    xyz = (rng.normal(size=(2, N, 3)) * 0.5).astype(dtype)
    if origin:  # dst^'s clamp (the XLA path's norm has no gradient there)
        xyz[1, 3] = 0.0
    idx = repeated_graph(rng, N, N, K)
    W = (rng.normal(size=(O, 3)) * 0.5).astype(dtype)
    D = (rng.normal(size=(O, O)) * 0.2).astype(dtype)
    cot = rng.normal(size=(2, N, O, 3)).astype(dtype)
    return (xyz, idx, W, D), cot


def mean_case(Ns, Nd, C, O, K, dtype):
    rng = np.random.default_rng(40 + Nd)
    src = rng.normal(size=(2, Ns, C, 3)).astype(dtype)
    dst = rng.normal(size=(2, Nd, C, 3)).astype(dtype)
    idx = repeated_graph(rng, Ns, Nd, K)
    W = (rng.normal(size=(O, 2 * C)) * 0.2).astype(dtype)
    D = (rng.normal(size=(O, O)) * 0.2).astype(dtype)
    cot = rng.normal(size=(2, Nd, O, 3)).astype(dtype)
    return (src, dst, idx, W, D), cot


def attention_case(Ns, Nd, C, O, K, head_c, dtype):
    rng = np.random.default_rng(50 + Nd)
    src = rng.normal(size=(2, Ns, C, 3)).astype(dtype)
    dst = rng.normal(size=(2, Nd, C, 3)).astype(dtype)
    idx = repeated_graph(rng, Ns, Nd, K)
    q = rng.normal(size=(2, Nd, O, 3))
    q_n = (q / np.linalg.norm(q, axis=-1, keepdims=True)
           * (np.linalg.norm(q, axis=-1, keepdims=True)
              / np.linalg.norm(q, axis=(-2, -1), keepdims=True))).astype(dtype)
    Ws = [(rng.normal(size=s) * 0.2).astype(dtype)
          for s in ((O, 2 * C), (O, O), (O, 2 * C), (O, O))]
    cot = rng.normal(size=(2, Nd, O, 3)).astype(dtype)
    return (src, dst, idx, q_n, *Ws), cot


LAYER0 = [(24, 8, 32), (16, 16, 12)]
MEAN = [(40, 20, 8, 16, 6), (30, 7, 12, 20, 16)]
ATTENTION = [(40, 12, 8, 32, 6, 8), (24, 7, 12, 16, 5, 16)]
L0_NAMES = ("xyz", "W", "D")
MEAN_NAMES = ("src", "dst", "W", "D")
ATTN_NAMES = ("src", "dst", "q_n", "W_K", "D_K", "W_V", "D_V")


@pytest.mark.parametrize("N,K,O", LAYER0)
def test_layer0_vjp_matches_pallas(N, K, O):
    inputs, cot = layer0_case(N, K, O, np.float32, origin=True)
    want = jax_vjp(lambda x, i, w, d: jl0.fused_layer0_edge_mean(
        x, i, w, d, interpret=True), inputs, (0, 2, 3), cot)
    got = torch_vjp(cuda_layer0.fused_layer0_edge_mean, inputs, (0, 2, 3), cot)
    check_f32(got, want, L0_NAMES)


@pytest.mark.parametrize("N,K,O", LAYER0)
def test_layer0_vjp_matches_xla_f64(N, K, O):
    inputs, cot = layer0_case(N, K, O, np.float64)
    want = jax_vjp(xla_layer0, inputs, (0, 2, 3), cot)
    got = torch_vjp(cuda_layer0.fused_layer0_edge_mean, inputs, (0, 2, 3), cot)
    check_f64(got, want, L0_NAMES)


@pytest.mark.parametrize("Ns,Nd,C,O,K", MEAN)
def test_edge_mean_vjp_matches_pallas(Ns, Nd, C, O, K):
    inputs, cot = mean_case(Ns, Nd, C, O, K, np.float32)
    want = jax_vjp(lambda s, d, i, w, dd: jpa.fused_edge_mean(
        s, d, i, w, dd, interpret=True), inputs, (0, 1, 3, 4), cot)
    got = torch_vjp(cuda_attention.fused_edge_mean, inputs, (0, 1, 3, 4), cot)
    check_f32(got, want, MEAN_NAMES)


@pytest.mark.parametrize("Ns,Nd,C,O,K", MEAN)
def test_edge_mean_vjp_matches_xla_f64(Ns, Nd, C, O, K):
    inputs, cot = mean_case(Ns, Nd, C, O, K, np.float64)
    want = jax_vjp(xla_mean, inputs, (0, 1, 3, 4), cot)
    got = torch_vjp(cuda_attention.fused_edge_mean, inputs, (0, 1, 3, 4), cot)
    check_f64(got, want, MEAN_NAMES)


def test_edge_mean_vjp_shared_source_and_destination():
    """Layer 1 passes one tensor as source and destination: its gradient is
    the sum of both."""
    inputs, cot = mean_case(20, 20, 8, 16, 6, np.float64)
    src, _, idx, W, D = inputs
    want = jax_vjp(lambda s, i, w, d: xla_mean(s, s, i, w, d),
                   (src, idx, W, D), (0,), cot)
    got = torch_vjp(lambda s, i, w, d: cuda_attention.fused_edge_mean(s, s, i, w, d),
                    (src, idx, W, D), (0,), cot)
    check_f64(got, want, ("src",))


@pytest.mark.parametrize("Ns,Nd,C,O,K,head_c", ATTENTION)
def test_edge_attention_vjp_matches_pallas(Ns, Nd, C, O, K, head_c):
    inputs, cot = attention_case(Ns, Nd, C, O, K, head_c, np.float32)
    wrt = (0, 1, 3, 4, 5, 6, 7)
    want = jax_vjp(lambda *a: jpa.fused_edge_attention(
        *a, head_c=head_c, interpret=True), inputs, wrt, cot)
    got = torch_vjp(lambda *a: cuda_attention.fused_edge_attention(*a, head_c),
                    inputs, wrt, cot)
    check_f32(got, want, ATTN_NAMES)


@pytest.mark.parametrize("Ns,Nd,C,O,K,head_c", ATTENTION)
def test_edge_attention_vjp_matches_xla_f64(Ns, Nd, C, O, K, head_c):
    inputs, cot = attention_case(Ns, Nd, C, O, K, head_c, np.float64)
    wrt = (0, 1, 3, 4, 5, 6, 7)
    want = jax_vjp(lambda *a: xla_attention(*a, head_c), inputs, wrt, cot)
    got = torch_vjp(lambda *a: cuda_attention.fused_edge_attention(*a, head_c),
                    inputs, wrt, cot)
    check_f64(got, want, ATTN_NAMES)


def test_backward_saves_only_inputs():
    """The Functions save their inputs (no edge tensor) and recompute."""
    inputs, cot = attention_case(24, 7, 12, 16, 5, 16, np.float64)
    ts = [torch.tensor(a, requires_grad=a.dtype != np.int32) for a in inputs]
    out = cuda_attention.fused_edge_attention(*ts, 16)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 8
    assert all(s.numel() == t.numel() for s, t in zip(saved, ts))
