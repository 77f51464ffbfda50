"""The PyTorch port's fused-encoder path (ShapePriorConfig(pallas_attention=
True)) held against the JAX package on the CPU. The same numpy inputs, made
from a seed, go into both sides.

On the CPU the port's wrappers run their plain versions; the JAX functions
that reach a Pallas kernel run it in interpret mode, as the JAX package's
own tests do. Sizes are small (B = 2, N <= 128): interpret mode is slow.

Tolerances:
  * knn_with_topk_scale: indices equal, scale rtol 1e-5 (f32; the port
    uses the squared-difference form, the Pallas kernel the expanded form,
    which agree to rounding; on the lattice cloud both are exact); past
    4096 points against JAX's XLA front end, f64 rtol 1e-12, and on a
    lattice in f32 rtol 1e-6.
  * the three fused layer functions: rtol 2e-4, atol 2e-5, the bound the
    JAX package holds its kernels to against their XLA branches
    (tests/test_pallas_attention.py); the same for the per-point form of
    attention and of the mean-edge layer (the card kernels' algebra)
    against the Pallas kernels, and rtol 1e-9 in f64 against JAX's XLA
    paths.
  * whole encoder, f32: atol 1e-4 on z_so3 and z_inv, rtol 1e-4 on s and t;
    f64 against the JAX parity path and between the port's two
    configurations: rtol 1e-9 (rounding only; the graphs are identical).
  * whole pipeline, f64, Kabsch ICP refit on both sides: matches0 equal,
    R and t to 1e-6.
"""
import glob
import math
import os
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.nn import pallas_attention as jpa
from livingscenes_tpu.nn import pallas_layer0 as jl0
from livingscenes_tpu.nn.edge_conv import fused_edge_kv as jfused_edge_kv
from livingscenes_tpu.nn.vec_layers import VecLNA as JVecLNA
from livingscenes_tpu.nn.vec_layers import (
    channel_equi_vec_normalize as j_channel_normalize,
)
from livingscenes_tpu.ops import pallas_knn as jknn
from livingscenes_tpu.ops.knn import knn as jknn_xla
from livingscenes_tpu.ops.knn import gather_neighbors as jgather
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.nn import cuda_attention, cuda_layer0
from livingscenes_tpu_torch.nn.vec_layers import (
    channel_equi_vec_normalize,
    leaky_relu,
    so3_activation,
)
from livingscenes_tpu_torch.ops import _cuda, cuda_knn
from livingscenes_tpu_torch.ops.knn import gather_neighbors
from livingscenes_tpu_torch.solver.pipeline import (
    PipelineConfig,
    build_scene_pair_pipeline,
)
from livingscenes_tpu_torch.solver.registration import RegistrationConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "livingscenes_tpu_torch")

# A 4-layer narrow encoder: layer 0, one mean-edge layer, two attention
# layers (the first downsamples), two 8-channel heads and up.
NARROW = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
              down_sample_layers=(2,), down_sample_factor=(2,),
              atten_start_layer=2, atten_multi_head_c=8, num_knn=8, n_pcl=128)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def lattice_cloud(rng):
    """A permuted, centred 4 x 4 x 4 lattice: every squared distance is
    exact in f32 and most are tied."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1)
    return (rng.permutation(g.reshape(-1, 3)) - 1.5).astype(np.float32)


@pytest.mark.parametrize(
    "N,k,tile,lattice",
    [
        (128, 16, 32, False),  # four row tiles: the per-tile tops are merged
        (64, 8, 256, False),   # one tile (tile = min(256, N))
        (64, 8, 16, True),     # exact ties: lower index first
    ],
)
def test_knn_with_topk_scale_matches_pallas(N, k, tile, lattice):
    rng = np.random.default_rng(10)
    pc = f32(rng, 2, N, 3)
    pc -= pc.mean(1, keepdims=True)
    if lattice:
        pc[0] = lattice_cloud(rng)
    idx_j, scale_j = jknn.knn_with_topk_scale(
        jnp.asarray(pc), k, tile=tile, interpret=True)
    idx_t, scale_t = cuda_knn.knn_with_topk_scale(torch.from_numpy(pc), k)
    assert idx_t.dtype == torch.int64 and idx_t.shape == (2, N, k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(scale_t.numpy(), np.asarray(scale_j), rtol=1e-5)
    # a point is its own nearest neighbour
    np.testing.assert_array_equal(idx_t[..., 0].numpy(), np.tile(np.arange(N), (2, 1)))


def jax_xla_front_end(pc, k):
    """What JAX's ShapePrior.encode takes off the TPU in place of
    knn_with_topk_scale: normalize_input's statistic
    (shape_prior.py:228-234, the mean of the five largest entries of the
    full distance matrix) and the exact kNN graph of ops/knn.py."""
    d2 = jnp.sum((pc[:, :, None, :] - pc[:, None, :, :]) ** 2, axis=-1)
    top5, _ = jax.lax.top_k(jnp.sqrt(jnp.maximum(d2, 0.0)).reshape(pc.shape[0], -1), 5)
    return np.asarray(jknn_xla(pc, pc, k)[1]), np.asarray(jnp.mean(top5, axis=-1))


@pytest.mark.parametrize("lattice", [False, True])
def test_knn_with_topk_scale_past_4096_matches_jax_xla(lattice):
    """A cloud of 4352 points (B = 1), past the 4096 that the card's front
    end once refused, against JAX's XLA path: random reals in f64 (indices
    equal, scale rtol 1e-12: rounding only), and a 17 x 16 x 16 lattice in
    f32, whose squared distances are exact in both forms and tied (the
    lower index first on both sides; scale rtol 1e-6)."""
    rng = np.random.default_rng(15)
    if lattice:
        g = np.stack(np.meshgrid(np.arange(17), np.arange(16), np.arange(16),
                                 indexing="ij"), -1).reshape(-1, 3)
        pc = (rng.permutation(g) - (8.0, 7.5, 7.5)).astype(np.float32)[None]
    else:
        pc = rng.normal(size=(1, 4352, 3))
    idx_j, scale_j = jax_xla_front_end(jnp.asarray(pc), 16)
    idx_t, scale_t = cuda_knn.knn_with_topk_scale(torch.from_numpy(pc), 16)
    assert idx_t.shape == (1, 4352, 16)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(scale_t.numpy(), scale_j,
                               rtol=1e-6 if lattice else 1e-12)


@pytest.mark.parametrize("N,K,O", [(64, 8, 16), (128, 16, 32), (64, 16, 48)])
def test_fused_layer0_edge_mean_matches_pallas(N, K, O):
    rng = np.random.default_rng(11)
    xyz = f32(rng, 2, N, 3)
    idx = rng.integers(0, N, (2, N, K)).astype(np.int32)
    W, D = f32(rng, O, 3, scale=0.5), f32(rng, O, O, scale=0.2)
    want = jl0.fused_layer0_edge_mean(
        *(jnp.asarray(a) for a in (xyz, idx, W, D)), interpret=True)
    got = cuda_layer0.fused_layer0_edge_mean(
        *(torch.from_numpy(a) for a in (xyz, idx, W, D)))
    assert got.shape == (2, N, O, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K",
    [(64, 64, 16, 16, 16), (64, 32, 16, 32, 8), (128, 32, 8, 48, 16)],
)
def test_fused_edge_mean_matches_pallas(Ns, Nd, C, O, K):
    rng = np.random.default_rng(12)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = rng.integers(0, Ns, (2, Nd, K)).astype(np.int32)
    W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
    want = jpa.fused_edge_mean(
        *(jnp.asarray(a) for a in (src, dst, idx, W, D)), interpret=True)
    got = cuda_attention.fused_edge_mean(
        *(torch.from_numpy(a) for a in (src, dst, idx, W, D)))
    assert got.shape == (2, Nd, O, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [
        (64, 64, 16, 16, 16, 16),  # one head
        (64, 32, 16, 48, 8, 16),   # three heads, downsampling, K < 16
        (128, 32, 8, 32, 16, 8),   # four heads of 8 channels
    ],
)
def test_fused_edge_attention_matches_pallas(Ns, Nd, C, O, K, head_c):
    rng = np.random.default_rng(13)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = rng.integers(0, Ns, (2, Nd, K)).astype(np.int32)
    q_n = np.array(j_channel_normalize(jnp.asarray(f32(rng, 2, Nd, O, 3))))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    args = (src, dst, idx, q_n, W_K, D_K, W_V, D_V)
    want = jpa.fused_edge_attention(
        *(jnp.asarray(a) for a in args), head_c=head_c, interpret=True)
    got = cuda_attention.fused_edge_attention(
        *(torch.from_numpy(a) for a in args), head_c=head_c)
    assert got.shape == (2, Nd, O, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def per_point_attention(src, dst, idx, q_n, W_K, D_K, W_V, D_V, head_c,
                        slope=0.2):
    """The algebra of the card's attention kernel in plain PyTorch: the
    products once per source and destination point
    (attention_point_products_plain), then per edge only the gathers, the
    sums of the two halves, the activation, the softmax and the sum."""
    C, O = src.shape[2], W_K.shape[0]
    W_l = torch.cat([W_K[:, :C], W_V[:, :C]])
    W_delta = torch.cat([W_K[:, C:], W_V[:, C:]]) - W_l
    p_src, p_dst = cuda_attention.attention_point_products_plain(
        src, dst, W_l, W_delta, D_K, D_V)  # (B, N, 3, 4O): [Y | D Y]
    p = gather_neighbors(p_src, idx) + p_dst[:, :, None]  # (B, Nd, K, 3, 4O)
    f = so3_activation(p[..., :2 * O].transpose(-1, -2),
                       p[..., 2 * O:].transpose(-1, -2), leaky_relu(slope))
    k_n = channel_equi_vec_normalize(f[..., :O, :])
    qk = torch.sum(k_n * q_n[:, :, None], dim=-1)  # (B, Nd, K, O)
    logits = qk.reshape(*qk.shape[:3], O // head_c, head_c).sum(-1)
    attn = torch.softmax(logits / math.sqrt(3 * head_c), dim=2)
    attn = attn.repeat_interleave(head_c, dim=-1)
    return torch.sum(attn[..., None] * f[..., O:, :], dim=2)


def jax_xla_attention(src, dst, idx, q_n, W_K, D_K, W_V, D_V, head_c):
    """JAX's XLA attention path (nn/vec_dgcnn_attn.py), the function the
    Pallas kernel replaces: that kernel computes in f32 whatever its inputs,
    this path in the inputs' precision."""
    B, Ns, C, _ = src.shape
    nn_f = jgather(src.reshape(B, Ns, C * 3), idx).reshape(*idx.shape, C, 3)
    k_f, v_f = jfused_edge_kv(nn_f, dst, W_K, D_K, W_V, D_V,
                              lambda x: jax.nn.leaky_relu(x, 0.2))
    qk = jnp.einsum("bnkci,bnci->bnkc", j_channel_normalize(k_f), q_n)
    O = W_K.shape[0]
    qk_h = qk.reshape(*qk.shape[:3], O // head_c, head_c)
    attn = jax.nn.softmax(jnp.sum(qk_h, -1, keepdims=True)
                          / np.sqrt(3 * head_c), axis=2)
    attn = jnp.broadcast_to(attn, qk_h.shape).reshape(qk.shape)
    return jnp.einsum("bnkc,bnkci->bnci", attn, v_f)


def per_point_mean(src, dst, idx, W, D, slope=0.2):
    """The algebra of the card's mean-edge kernel in plain PyTorch: the
    products once per source and destination point
    (mean_point_products_plain), then per edge only the gather, the sum of
    the two halves, the activation and the mean over K."""
    C, O = src.shape[2], W.shape[0]
    W_l = W[:, :C]
    p_src, p_dst = cuda_attention.mean_point_products_plain(
        src, dst, W_l, W[:, C:] - W_l, D)  # (B, N, 3, 2O): [Y | D Y]
    p = gather_neighbors(p_src, idx) + p_dst[:, :, None]  # (B, Nd, K, 3, 2O)
    f = so3_activation(p[..., :O].transpose(-1, -2),
                       p[..., O:].transpose(-1, -2), leaky_relu(slope))
    return torch.mean(f, dim=2)


def jax_xla_mean(src, dst, idx, W, D):
    """JAX's XLA path of the mean-edge layer (the edge [nn - dst, dst]
    materialised, VecLNA, mean over K; tests/test_pallas_attention.py), in
    the inputs' precision."""
    B, Ns, C, _ = src.shape
    nn_f = jgather(src.reshape(B, Ns, C * 3), idx).reshape(*idx.shape, C, 3)
    dst_pad = jnp.broadcast_to(dst[:, :, None], nn_f.shape)
    edge = jnp.concatenate([nn_f - dst_pad, dst_pad], axis=-2)
    lna = JVecLNA(2 * C, W.shape[0], act_func=lambda x: jax.nn.leaky_relu(x, 0.2),
                  mode="so3")
    params = {"params": {"lin": {"weight": W}, "act": {"lin_dir": {"weight": D}}}}
    return jnp.mean(lna.apply(params, edge), axis=2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize(
    "Ns,Nd,C,O,K,head_c",
    [(64, 32, 16, 48, 8, 16), (128, 32, 8, 32, 16, 8), (40, 40, 12, 8, 5, 4),
     # head_c None: the mean-edge layer
     pytest.param(64, 64, 16, 32, 16, None, id="mean-64-64-16-32-16"),
     pytest.param(64, 32, 12, 8, 5, None, id="mean-64-32-12-8-5")],
)
def test_per_point_factorisation_matches_jax(Ns, Nd, C, O, K, head_c, dtype):
    """The per-point form of attention (head_c given) or of the mean-edge
    layer (head_c None). f32: against JAX's fused_edge_attention or
    fused_edge_mean (the Pallas kernel in interpret mode) at the file's
    tolerance. f64: against JAX's XLA path in f64 at rtol 1e-9 (rounding
    only)."""
    rng = np.random.default_rng(14)
    src, dst = f32(rng, 2, Ns, C, 3), f32(rng, 2, Nd, C, 3)
    idx = rng.integers(0, Ns, (2, Nd, K)).astype(np.int32)
    if head_c is None:
        W, D = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, O, scale=0.2)
        args = [a.astype(dtype) for a in (src, dst)] + [idx] + [
            a.astype(dtype) for a in (W, D)]
        got = per_point_mean(
            *(torch.from_numpy(a) for a in args[:2]),
            torch.from_numpy(idx).long(),
            *(torch.from_numpy(a) for a in args[3:])).numpy()
        jargs = [jnp.asarray(a) for a in args]
        if dtype == "float32":
            want = jpa.fused_edge_mean(*jargs, interpret=True)
            np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
        else:
            want = jax_xla_mean(*jargs)
            np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-12)
        return
    q_n = np.array(j_channel_normalize(jnp.asarray(f32(rng, 2, Nd, O, 3))))
    W_K, W_V = f32(rng, O, 2 * C, scale=0.2), f32(rng, O, 2 * C, scale=0.2)
    D_K, D_V = f32(rng, O, O, scale=0.2), f32(rng, O, O, scale=0.2)
    args = [a.astype(dtype) for a in (src, dst)] + [idx] + [
        a.astype(dtype) for a in (q_n, W_K, D_K, W_V, D_V)]
    got = per_point_attention(
        *(torch.from_numpy(a) for a in args[:2]), torch.from_numpy(idx).long(),
        *(torch.from_numpy(a) for a in args[3:]), head_c).numpy()
    jargs = [jnp.asarray(a) for a in args]
    if dtype == "float32":
        want = jpa.fused_edge_attention(*jargs, head_c=head_c, interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-5)
    else:
        want = jax_xla_attention(*jargs, head_c=head_c)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9, atol=1e-12)


@pytest.fixture(scope="module")
def narrow_params():
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW))
    init = jax.jit(model.init_params, static_argnames="n_points")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(2), n_points=64))


def port_model(params, dtype, fused=True):
    m = ShapePrior(ShapePriorConfig(**NARROW, pallas_attention=fused),
                   device="cpu", dtype=dtype)
    m.load_state_dict(params_from_jax(params))
    return m


def clouds(seed, B=3, N=128):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, (B, N, 3)) * rng.uniform(0.3, 1.0, (B, 1, 3))
    return pts + rng.uniform(-2, 2, (B, 1, 3))


def jax_encode(params, pc, jdt, **cfg):
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW, **cfg))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    return {k: np.asarray(v)
            for k, v in jax.jit(jm.encode)(jp, jnp.asarray(pc, jdt)).items()}


def port_encode(params, pc, dtype, fused=True):
    with torch.no_grad():
        out = port_model(params, dtype, fused).encode(torch.as_tensor(pc, dtype=dtype))
    return {k: v.numpy() for k, v in out.items()}


def test_fused_encode_matches_jax_f32(narrow_params):
    pc = clouds(20)
    cj = jax_encode(narrow_params, pc, jnp.float32, pallas_attention=True)
    ct = port_encode(narrow_params, pc, torch.float32)
    np.testing.assert_allclose(ct["z_so3"], cj["z_so3"], atol=1e-4)
    np.testing.assert_allclose(ct["z_inv"], cj["z_inv"], atol=1e-4)
    np.testing.assert_allclose(ct["s"], cj["s"], rtol=1e-4)
    np.testing.assert_allclose(ct["t"], cj["t"], rtol=1e-4, atol=1e-5)


def test_fused_encode_matches_jax_parity_f64(narrow_params):
    pc = clouds(21)
    cj = jax_encode(narrow_params, pc, jnp.float64, pallas_attention=True, parity=True)
    ct = port_encode(narrow_params, pc, torch.float64)
    for k in ("z_so3", "z_inv", "s", "t"):
        np.testing.assert_allclose(ct[k], cj[k], rtol=1e-9, atol=1e-12, err_msg=k)


@pytest.mark.parametrize("N", [128, 100])  # 100: the plain front end on the CPU
def test_port_configurations_agree_f64(narrow_params, N):
    pc = clouds(22, N=N)
    a = port_encode(narrow_params, pc, torch.float64, fused=True)
    b = port_encode(narrow_params, pc, torch.float64, fused=False)
    for k in ("z_so3", "z_inv", "s", "t"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_fused_pipeline_matches_jax_f64(narrow_params):
    S, O, N = 2, 3, 192
    rng = np.random.default_rng(23)
    ref = clouds(24, B=S * O, N=N).reshape(S, O, N, 3)
    rescan = ref[:, ::-1] + 0.1 * rng.normal(size=(S, O, 1, 3))
    mask = np.ones((S, O, N), bool)
    mask[:, :, 160:] = rng.random((S, O, N - 160)) > 0.5
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW, pallas_attention=True, parity=True))
    jcfg = jpipe.PipelineConfig(
        encode_fps=True,
        registration=jreg.RegistrationConfig(icp_iterations=10, icp_fused=False))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), narrow_params)
    out_j = jpipe.build_scene_pair_pipeline(jm, jcfg)(
        jp, *(jnp.asarray(a) for a in (ref, rescan, mask, mask)))
    cfg = PipelineConfig(encode_fps=True, registration=RegistrationConfig(
        icp_iterations=10, icp_fused=False))
    out_t = build_scene_pair_pipeline(
        port_model(narrow_params, torch.float64), cfg)(ref, rescan, mask, mask)
    np.testing.assert_array_equal(out_t["matches0"].numpy(), np.asarray(out_j["matches0"]))
    np.testing.assert_allclose(out_t["R"].numpy(), np.asarray(out_j["R"]), atol=1e-6)
    np.testing.assert_allclose(out_t["t"].numpy(), np.asarray(out_j["t"]), atol=1e-6)


def test_same_state_dict_loads_under_both_configurations(narrow_params):
    state = params_from_jax(narrow_params)
    keys = []
    for fused in (False, True):
        m = ShapePrior(ShapePriorConfig(**NARROW, pallas_attention=fused), device="cpu")
        m.load_state_dict(state, strict=True)
        keys.append(sorted(m.state_dict()))
    assert keys[0] == keys[1] == sorted(state)


def test_cuda_wrappers_refuse_cpu_tensors_and_grad():
    """The kernel wrappers, forward and backward, take CUDA tensors only;
    under autograd a CPU call goes through the plain forward and VJP."""
    x = torch.zeros((1, 8, 3))
    f = torch.zeros((1, 8, 4, 3))
    idx = torch.zeros((1, 8, 2), dtype=torch.int32)
    W, D = torch.zeros((4, 8)), torch.zeros((4, 4))
    g = torch.zeros((1, 8, 4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_knn.knn_with_topk_scale_cuda(x, 2)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_layer0.fused_layer0_edge_mean_cuda(x, idx, torch.zeros((4, 3)), D)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.fused_edge_mean_cuda(f, f, idx, W, D)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.fused_edge_attention_cuda(f, f, idx, f, W, D, W, D, 4)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_layer0.fused_layer0_edge_mean_bwd_cuda(x, idx, torch.zeros((4, 3)), D, g)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.fused_edge_mean_bwd_cuda(f, f, idx, W, D, g)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_attention.fused_edge_attention_bwd_cuda(f, f, idx, f, W, D, W, D, g, 4)
    w = W.clone().requires_grad_(True)
    out = cuda_attention.fused_edge_mean(f, f, idx, w, D)
    assert type(out.grad_fn).__name__ == "_EdgeMeanBackward"
    (d_w,) = torch.autograd.grad(out.sum(), w)
    assert d_w.shape == W.shape


def test_fused_front_end_condition(narrow_params):
    """N a multiple of min(256, N) takes the fused front end; any other N
    takes normalize_input, whose scale statistic comes from the scale
    kernel's wrapper: the plain version on the CPU, and off the CPU the
    kernel, which refuses a tensor that is not on the card."""
    m = port_model(narrow_params, torch.float32)
    with torch.no_grad():
        assert m.encode(torch.from_numpy(clouds(25, N=300)).float())["s"].shape == (3,)
    with pytest.raises(ValueError, match="scale: expected CUDA"):
        m.encode(torch.empty((2, 300, 3), device="meta"))


def test_port_sources_import_no_jax():
    pattern = re.compile(r"^\s*(?:import|from)\s+(jax|jaxlib|flax|livingscenes_tpu)\b(?!_)", re.M)
    files = [os.path.join(ROOT, "chip_smoke.py")]
    files += glob.glob(os.path.join(ROOT, "scripts", "torch_*.py"))
    for base, _, names in os.walk(PORT):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    assert len(files) >= 20
    for path in files:
        with open(path) as f:
            assert not pattern.search(f.read()), path
    for name in ("nn/cuda_layer0.py", "nn/cuda_attention.py", "csrc/knn_topk.cu",
                 "csrc/layer0.cu", "csrc/mean_edge.cu", "csrc/attention.cu",
                 "csrc/point_products.cuh", "csrc/pair_scan.cuh",
                 "csrc/edge_common.cuh", "csrc/scale.cu", "csrc/sinkhorn.cu",
                 "csrc/top_multiset.cuh", "ops/cuda_scale.py",
                 "ops/cuda_sinkhorn.py"):
        assert os.path.exists(os.path.join(PORT, name)), name


def test_kernel_library_name_follows_every_source_and_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_cuda.CSRC, csrc)
    monkeypatch.setattr(_cuda, "CSRC", csrc)
    assert sorted(p.name for p in csrc.glob("*.cu")) == sorted(_cuda.SOURCES)
    before = _cuda.library_path()
    assert before == _cuda.library_path()
    header = csrc / "edge_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after_header = _cuda.library_path()
    assert after_header.name != before.name
    source = csrc / "attention.cu"
    source.write_bytes(source.read_bytes() + b"\n")
    assert _cuda.library_path().name not in (before.name, after_header.name)
