"""The PyTorch port's DeepSDF decoder and field surface (WNDense,
DeepSDFDecoder, ShapePrior.invariant_query / decode_sdf / occupancy_logits)
held against the JAX package on the CPU, with the parameters carried over
by params_from_jax: a random JAX init at a narrow width and the trained r5
checkpoint at the production width (8 x 768).

Tolerances: f64 rtol 1e-10 and atol 1e-12 (the same formulas; matmul
summation order only). f32 with the trained weights: atol 2e-5 on SDF values
in (-1, 1) (513- and 768-term f32 dot products in another order through
nine layers).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.nn import deepsdf as jdeepsdf
from livingscenes_tpu_torch.models.convert import load_flax_checkpoint, params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.nn.deepsdf import DeepSDFDecoder, WNDense
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "weights", "production_r5_selected.ckpt")
# input 2 * 32 + 1 = 65; the layer before the re-injection emits 96 - 65
NARROW = dict(c_dim=32, feat_dim=(8, 8, 16, 16, 16, 32, 32), num_knn=8, n_pcl=64,
              decoder_dims=(96,) * 4, decoder_latent_in=(2,))
F64 = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope="module")
def narrow_params():
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW))
    init = jax.jit(model.init_params, static_argnames="n_points")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), n_points=64))


def random_codes(rng, B, C, dtype):
    return {"z_so3": rng.normal(size=(B, C, 3)).astype(dtype),
            "z_inv": rng.normal(size=(B, C)).astype(dtype),
            "s": rng.uniform(0.5, 2.0, size=(B,)).astype(dtype),
            "t": rng.normal(size=(B, 1, 3)).astype(dtype)}


def both_models(params, cfg_kwargs, dtype):
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**cfg_kwargs))
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    tm = ShapePrior(ShapePriorConfig(**cfg_kwargs), device="cpu",
                    dtype=torch.float64 if dtype == np.float64 else torch.float32)
    tm.load_state_dict(params_from_jax(params))
    return jm, jp, tm


def to_torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_wndense_matches_jax():
    rng = np.random.default_rng(0)
    p = {"v": rng.normal(size=(7, 5)), "g": rng.normal(size=(5,)), "b": rng.normal(size=(5,))}
    p["v"][:, 2] = 0.0  # a zero column: the clamp at 1e-12 keeps it finite
    x = rng.normal(size=(3, 4, 7))
    want = jdeepsdf.WNDense(5).apply({"params": jax.tree.map(jnp.asarray, p)}, jnp.asarray(x))
    m = WNDense(7, 5).double()
    m.load_state_dict(to_torch(p))
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_wndense_init_is_the_plain_linear_init():
    m = WNDense(16, 9)
    m.reset_parameters(torch.Generator().manual_seed(0))
    assert float(m.v.detach().abs().max()) <= 0.25 and float(m.b.detach().abs().max()) <= 0.25
    # g = |v| per output: the effective matrix at the start is v itself
    x = torch.randn((3, 16), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(m(x), x @ m.v + m.b)


@pytest.mark.parametrize("dims,latent_in", [((96,) * 4, (2,)), ((80, 90, 100), (1, 3))])
def test_decoder_matches_jax(dims, latent_in):
    jm = jdeepsdf.DeepSDFDecoder(latent_size=32, dims=dims, latent_in=latent_in, pe_dim=33)
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 10, 65))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    want = jm.apply({"params": params}, jnp.asarray(x))
    m = DeepSDFDecoder(latent_size=32, dims=dims, latent_in=latent_in, pe_dim=33).double()
    state = params_from_jax({"encoder": {}, "decoder": jax.tree.map(np.asarray, params)})
    m.load_state_dict({k[len("decoder."):]: v for k, v in state.items()})
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_decoder_dropout_only_in_train_mode():
    m = DeepSDFDecoder(latent_size=8, dims=(32,) * 3, latent_in=(2,), pe_dim=9, dropout_prob=0.5)
    gen = torch.Generator().manual_seed(0)
    for layer in m.lin:
        layer.reset_parameters(gen)
    x = torch.randn((4, 17), generator=gen)
    m.eval()
    with torch.no_grad():
        a, b = m(x), m(x)
        assert torch.equal(a, b)
        m.train()
        c = m(x, torch.Generator().manual_seed(0))
        assert not torch.equal(a, c)
        # the masks come from the generator given, which train mode needs
        assert torch.equal(c, m(x, torch.Generator().manual_seed(0)))
        with pytest.raises(ValueError, match="generator"):
            m(x)


def test_field_surface_matches_jax_f64(narrow_params):
    jm, jp, tm = both_models(narrow_params, NARROW, np.float64)
    rng = np.random.default_rng(2)
    codes = random_codes(rng, 3, 32, np.float64)
    q = rng.normal(size=(3, 20, 3))
    jc = jax.tree.map(jnp.asarray, codes)
    with torch.no_grad():
        got_q = tm.invariant_query(torch.from_numpy(q), to_torch(codes))
        got_sdf = tm.decode_sdf(torch.from_numpy(q), to_torch(codes))
        got_occ = tm.occupancy_logits(torch.from_numpy(q), to_torch(codes))
    assert got_q.shape == (3, 20, 65) and got_sdf.shape == (3, 20)
    np.testing.assert_allclose(
        got_q.numpy(), np.asarray(jm.invariant_query(jnp.asarray(q), jc)), **F64)
    np.testing.assert_allclose(
        got_sdf.numpy(), np.asarray(jm.decode_sdf(jp, jnp.asarray(q), jc)), **F64)
    np.testing.assert_allclose(
        got_occ.numpy(), np.asarray(jm.occupancy_logits(jp, jnp.asarray(q), jc)), **F64)
    assert not tm.training


def test_decode_gradient_wrt_query_matches_jax(narrow_params):
    jm, jp, tm = both_models(narrow_params, NARROW, np.float64)
    rng = np.random.default_rng(3)
    codes = random_codes(rng, 2, 32, np.float64)
    q = rng.normal(size=(2, 12, 3))
    jc = jax.tree.map(jnp.asarray, codes)
    want = jax.grad(lambda v: jnp.sum(jnp.abs(jm.decode_sdf(jp, v, jc))))(jnp.asarray(q))
    qt = torch.tensor(q, requires_grad=True)
    total = torch.sum(torch.abs(tm.decode_sdf(qt, to_torch(codes))))
    (got,) = torch.autograd.grad(total, qt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, dict(rtol=0, atol=2e-5))])
def test_trained_decoder_matches_jax(dtype, tol):
    trained = load_flax_checkpoint(CKPT)
    jm, jp, tm = both_models(trained, {}, dtype)
    assert len(tm.decoder.lin) == 9 and tm.decoder.lin[3].v.shape == (768, 255)
    assert tm.decoder.lin[8].kernel.shape == (768, 1)  # the one plain layer
    rng = np.random.default_rng(4)
    pc = (rng.uniform(-0.5, 0.5, size=(2, 256, 3)) * [1.0, 0.6, 0.3]).astype(dtype)
    with torch.no_grad():
        codes = tm.encode(torch.from_numpy(pc))
        q = torch.from_numpy((pc + 0.02 * rng.normal(size=pc.shape)).astype(dtype))
        got = tm.decode_sdf(q, codes)
    jc = {k: jnp.asarray(v.numpy()) for k, v in codes.items()}
    want = jax.jit(jm.decode_sdf)(jp, jnp.asarray(q.numpy()), jc)
    assert got.dtype == (torch.float64 if dtype == np.float64 else torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    assert float(got.abs().max()) < 1.0
