"""The port's vector-neuron layers in both modes, the edge convolutions,
DecoderCat and the ONet decoders, held against the JAX package on the CPU:
the JAX init (PRNGKey(0)) carried over by the converter, the same numpy
inputs from a seed, float64.

Tolerances: rtol 1e-9 (atol 1e-12) in float64, rounding only. mm_bf16 in
float32: both sides multiply the same bfloat16-rounded operands exactly and
sum in float32 in their own order, so each output is held to 4 float32 ulps
of the sum of its terms' magnitudes, sum |W_bf16| |v_bf16|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.nn import deepsdf as jdeepsdf
from livingscenes_tpu.nn import edge_conv as jedge
from livingscenes_tpu.nn import onet_decoder as jonet
from livingscenes_tpu.nn import vec_layers as jvl
from livingscenes_tpu_torch.models.convert import module_params_from_jax
from livingscenes_tpu_torch.nn import deepsdf, edge_conv, onet_decoder
from livingscenes_tpu_torch.nn import vec_layers as vl
from torch_threads import intra_op_share  # noqa: F401 (autouse)

B, N, C = 2, 33, 16
ACT_J = lambda x: jax.nn.leaky_relu(x, 0.2)
ACT_T = vl.leaky_relu(0.2)


def jax_init(module, *args, perturb=0.0):
    params = module.init(jax.random.PRNGKey(0), *args).get("params", {})
    return jax.tree.map(lambda a: np.asarray(a, np.float64) + perturb, params)


def port(module, params, dtype=torch.float64):
    module = module.to(dtype)
    module.load_state_dict(module_params_from_jax(params))
    return module


def outputs(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))]


def assert_same(jout, tout, rtol=1e-9, atol=1e-12):
    jout, tout = outputs(jout), [o.detach().numpy() for o in
                                 (tout if isinstance(tout, tuple) else (tout,))]
    assert len(jout) == len(tout)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def vec_input(seed, shape=(B, N, C, 3)):
    return np.random.default_rng(seed).normal(size=shape)


LAYERS = {
    "linear": lambda m: (jvl.VecLinear(C, 24, mode=m), vl.VecLinear(C, 24, mode=m)),
    "linear_scalar": lambda m: (
        jvl.VecLinear(C, 24, s_in=8, s_out=6, mode=m),
        vl.VecLinear(C, 24, s_in=8, s_out=6, mode=m)),
    "linear_scalar_out": lambda m: (jvl.VecLinear(C, 24, s_out=6, mode=m),
                                    vl.VecLinear(C, 24, s_out=6, mode=m)),
    "linear_unnormalized_scale": lambda m: (
        jvl.VecLinear(C, 24, s_in=8, mode=m, s2v_normalized_scale=False),
        vl.VecLinear(C, 24, s_in=8, mode=m, s2v_normalized_scale=False)),
    "linear_cross": lambda m: (jvl.VecLinear(C, 24, mode=m, cross=True),
                               vl.VecLinear(C, 24, mode=m, cross=True)),
    "activation": lambda m: (jvl.VecActivation(C, ACT_J, mode=m),
                             vl.VecActivation(C, ACT_T, mode=m)),
    "activation_shared_cross": lambda m: (
        jvl.VecActivation(C, ACT_J, shared_nonlinearity=True, mode=m, cross=True),
        vl.VecActivation(C, ACT_T, shared_nonlinearity=True, mode=m, cross=True)),
    "lna": lambda m: (jvl.VecLNA(C, 20, ACT_J, mode=m), vl.VecLNA(C, 20, ACT_T, mode=m)),
    "lna_scalar": lambda m: (
        jvl.VecLNA(C, 20, ACT_J, s_in_features=8, s_out_features=6, mode=m),
        vl.VecLNA(C, 20, ACT_T, s_in_features=8, s_out_features=6, mode=m)),
    "resblock": lambda m: (jvl.VecResBlock(C, 20, 12, ACT_J, mode=m),
                           vl.VecResBlock(C, 20, 12, ACT_T, mode=m)),
    "resblock_same": lambda m: (jvl.VecResBlock(C, C, C, ACT_J, mode=m),
                                vl.VecResBlock(C, C, C, ACT_T, mode=m)),
    "resblock_last_linear": lambda m: (
        jvl.VecResBlock(C, 20, 12, ACT_J, mode=m, last_activate=False),
        vl.VecResBlock(C, 20, 12, ACT_T, mode=m, last_activate=False)),
    "resblock_scalar": lambda m: (
        jvl.VecResBlock(C, 20, 12, ACT_J, mode=m, s_in_features=8,
                        s_out_features=6, s_hidden_features=5),
        vl.VecResBlock(C, 20, 12, ACT_T, mode=m, s_in_features=8,
                       s_out_features=6, s_hidden_features=5)),
    "resblock_scalar_same": lambda m: (
        jvl.VecResBlock(C, 20, 12, ACT_J, mode=m, s_in_features=8,
                        s_out_features=8, s_hidden_features=5),
        vl.VecResBlock(C, 20, 12, ACT_T, mode=m, s_in_features=8,
                       s_out_features=8, s_hidden_features=5)),
}
SCALAR_IN = {"linear_scalar", "linear_unnormalized_scale", "lna_scalar",
             "resblock_scalar", "resblock_scalar_same"}


@pytest.mark.parametrize("mode", ["so3", "se3"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_vec_layer_matches_jax(name, mode):
    jmod, tmod = LAYERS[name](mode)
    x = vec_input(1)
    args = (x, np.random.default_rng(2).normal(size=(B, N, 8))) if name in SCALAR_IN else (x,)
    params = jax_init(jmod, *args)
    tmod = port(tmod, params)
    want = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in args))
    assert_same(want, got)


def test_se3_linear_rows_sum_to_one():
    """se3: (v_out, v_in - 1) stored weights and a last column 1 - sum, so
    a common translation of every channel carries through."""
    m = vl.VecLinear(C, 24, mode="se3").double()
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert m.weight.shape == (24, C - 1)
    np.testing.assert_allclose(m.full_weight().sum(-1).detach().numpy(), 1.0, rtol=1e-12)
    x = torch.from_numpy(vec_input(3))
    t = torch.tensor([0.3, -1.0, 2.0], dtype=torch.float64)
    with torch.no_grad():
        np.testing.assert_allclose((m(x + t) - m(x) - t).abs().max().item(), 0, atol=1e-12)


POOLS = [
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=1.0, k_prediction="lin")),
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=1.0, k_prediction="mean")),
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=-1.0, k_prediction="lin")),
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=-1.0, k_prediction="mean")),
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=1.0, k_prediction="lin",
                                         softmax_norm_compression="exp")),
    (jvl.VecMaxPool, vl.VecMaxPool, dict(softmax_factor=1.0, k_prediction="mean",
                                         attention_k_blk=False)),
    (jvl.VecMaxPoolV2, vl.VecMaxPoolV2, dict(softmax_factor=1.0)),
    (jvl.VecMaxPoolV2, vl.VecMaxPoolV2, dict(softmax_factor=-1.0)),
]


@pytest.mark.parametrize("mode", ["so3", "se3"])
@pytest.mark.parametrize("case", range(len(POOLS)))
def test_pool_matches_jax_and_is_equivariant(case, mode):
    """Soft and hard pooling (the hard pool takes the first index of the
    largest component, jnp.argmax's pick), the weights too; then the
    port's pool is SIM(3)-equivariant (tests/test_geometry_extras.py)."""
    jcls, tcls, kw = POOLS[case]
    jpool, tpool = jcls(in_features=C, mode=mode, **kw), tcls(C, mode=mode, **kw)
    x = vec_input(4)
    params = jax_init(jpool, x)
    tpool = port(tpool, params)
    jout, jw = jpool.apply({"params": params}, x, return_weight=True)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out, w = tpool(xt, return_weight=True)
        assert (w is None) == (jw is None)
        assert_same(jout, out)
        if w is not None:
            assert_same(jw, w)
        R = torch.from_numpy(Rotation.random(B, random_state=0).as_matrix())
        s = torch.tensor([0.7, 1.6], dtype=torch.float64)
        t = (torch.tensor([[0.2, -0.4, 1.0], [-1.0, 0.5, 0.3]], dtype=torch.float64)
             if mode == "se3" else torch.zeros((B, 3), dtype=torch.float64))
        moved = torch.einsum("bij,bncj->bnci", R, xt * s[:, None, None, None]) + t[:, None, None]
        want = torch.einsum("bij,bcj->bci", R, out * s[:, None, None]) + t[:, None]
        np.testing.assert_allclose(tpool(moved).numpy(), want.numpy(), atol=1e-9)


def test_hard_pool_takes_the_first_maximum():
    """Two identical points that hold the largest component in every
    channel: the hard pool picks the first, as jnp.argmax does."""
    x = vec_input(5, (1, 6, 4, 3))
    x[0, 1] *= 10.0
    x[0, 4] = x[0, 1]
    pool = vl.VecMaxPool(4, mode="so3", softmax_factor=-1.0).double()
    with torch.no_grad():
        pool.lin_dir.weight.copy_(torch.eye(4, dtype=torch.float64))
        out = pool(torch.from_numpy(x))
    np.testing.assert_array_equal(out[0].numpy(), x[0, 1])
    assert vl.vec_mean_pool(torch.from_numpy(x)).shape == (1, 4, 3)


def test_mm_bf16_matches_jax_to_a_few_ulps():
    """VecLinear(mm_bf16=True) in float32: JAX's bfloat16 product with
    float32 accumulation, within 4 float32 ulps of sum |W_bf16| |v_bf16|
    per output; the float32 product without bfloat16 is farther off."""
    jmod = jvl.VecLinear(64, 48, mode="so3", mm_bf16=True)
    x = vec_input(6, (B, 200, 64, 3)).astype(np.float32)
    params = jax.tree.map(lambda a: np.asarray(a, np.float32),
                          jmod.init(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(jmod.apply({"params": params}, x))
    tmod = port(vl.VecLinear(64, 48, mode="so3", mm_bf16=True), params, torch.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got = tmod(xt).numpy()
        W_bf, v_bf = (a.to(torch.bfloat16).double() for a in (tmod.weight, xt))
        scale = torch.einsum("oc,...ci->...oi", W_bf.abs(), v_bf.abs()).numpy()
        exact = torch.einsum("oc,...ci->...oi", W_bf, v_bf).numpy()
        plain = torch.einsum("oc,...ci->...oi", tmod.weight, xt).numpy()
    bound = 4 * np.finfo(np.float32).eps * scale
    assert np.all(np.abs(got - want) <= bound), float(np.max(np.abs(got - want) / bound))
    assert np.all(np.abs(got - exact) <= bound)
    assert np.max(np.abs(plain - want) / bound) > 10.0
    # float64 takes no bfloat16, as JAX's condition on float32 inputs
    t64 = port(vl.VecLinear(64, 48, mode="so3", mm_bf16=True), jax_init(jmod, x))
    with torch.no_grad():
        np.testing.assert_array_equal(
            t64(xt.double()).numpy(),
            torch.einsum("oc,...ci->...oi", t64.weight, xt.double()).numpy())


def test_edge_vec_lna_matches_jax():
    Bn, Ns, Nd, K, Cc, O = 2, 40, 24, 8, 16, 12
    rng = np.random.default_rng(7)
    src, dst = rng.normal(size=(Bn, Ns, Cc, 3)), rng.normal(size=(Bn, Nd, Cc, 3))
    idx = rng.integers(0, Ns, size=(Bn, Nd, K)).astype(np.int32)
    jmod = jedge.EdgeVecLNA(Cc, O, act_func=ACT_J)
    params = jax_init(jmod, src, dst, idx)
    tmod = port(edge_conv.EdgeVecLNA(Cc, O, ACT_T), params)
    want = jmod.apply({"params": params}, src, dst, idx)
    with torch.no_grad():
        got = tmod(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(idx))
        assert_same(want, got)
        # the naive VecLNA on the built edges, from the same parameters
        naive = port(vl.VecLNA(2 * Cc, O, ACT_T, mode="so3"), params)
        nn_f = torch.from_numpy(src)[torch.arange(Bn)[:, None, None], torch.from_numpy(idx).long()]
        d = torch.from_numpy(dst)[:, :, None].expand_as(nn_f)
        np.testing.assert_allclose(naive(torch.cat([nn_f - d, d], -2)).numpy(),
                                   got.numpy(), atol=1e-10)


def test_global_res_vec_lna_matches_jax():
    f = vec_input(8, (2, 30, 16, 3))
    g = f.mean(axis=1, keepdims=True)
    jmod = jedge.GlobalResVecLNA(16, 16, act_func=ACT_J)
    params = jax_init(jmod, f, g)
    tmod = port(edge_conv.GlobalResVecLNA(16, 16, ACT_T), params)
    with torch.no_grad():
        assert_same(jmod.apply({"params": params}, f, g),
                    tmod(torch.from_numpy(f), torch.from_numpy(g)))


@pytest.mark.parametrize("leaky", [True, False])
def test_decoder_cat_matches_jax(leaky):
    x = np.random.default_rng(9).normal(size=(2, 11, 65))
    jmod = jdeepsdf.DecoderCat(input_dim=65, hidden_size=32, n_blocks=3, leaky=leaky)
    params = jax_init(jmod, x)
    tmod = port(deepsdf.DecoderCat(65, 32, 3, leaky=leaky), params)
    with torch.no_grad():
        assert_same(jmod.apply({"params": params}, x, train=True), tmod(torch.from_numpy(x)))


@pytest.mark.parametrize("name", ["Decoder", "DecoderCBatchNorm"])
def test_onet_decoder_matches_jax(name):
    """Parameters perturbed by 0.05 first (the zero initializers of fc_1,
    conv_gamma and conv_beta would hide the conditioning,
    tests/test_aux.py:71); the codes then move the output."""
    rng = np.random.default_rng(10)
    p, c = rng.normal(size=(2, 11, 3)), rng.normal(size=(2, 8))
    jmod = getattr(jonet, name)(c_dim=8, hidden_size=16, n_blocks=2)
    params = jax_init(jmod, p, c, perturb=0.05)
    tmod = port(getattr(onet_decoder, name)(c_dim=8, hidden_size=16, n_blocks=2), params)
    pt, ct = torch.from_numpy(p), torch.from_numpy(c)
    with torch.no_grad():
        out = tmod(pt, ct)
        assert_same(jmod.apply({"params": params}, p, c), out)
        assert out.shape == (2, 11)
        assert not torch.allclose(out, tmod(pt, ct + 1.0))


def test_onet_zero_initializers_as_flax():
    """init_parameters leaves each residual block an identity and each
    CondScale the plain normalization, as flax's zero initializers do."""
    dec = onet_decoder.init_parameters(
        onet_decoder.DecoderCBatchNorm(c_dim=8, hidden_size=16, n_blocks=2).double(),
        torch.Generator().manual_seed(0))
    jmod = jonet.DecoderCBatchNorm(c_dim=8, hidden_size=16, n_blocks=2)
    p, c = np.zeros((1, 4, 3)), np.zeros((1, 8))
    jparams = jmod.init(jax.random.PRNGKey(0), p, c)["params"]
    zero_init = ("fc_1", "conv_gamma", "conv_beta")
    for key, value in module_params_from_jax(jax.tree.map(np.asarray, jparams)).items():
        if any(name in key.split(".") for name in zero_init):
            np.testing.assert_array_equal(dec.state_dict()[key].numpy(), value.numpy(),
                                          err_msg=key)
    plain = onet_decoder.init_parameters(
        onet_decoder.Decoder(c_dim=8, hidden_size=16, n_blocks=2).double(),
        torch.Generator().manual_seed(0))
    assert not plain.block0.fc_1.kernel.any() and not plain.block0.fc_1.bias.any()
