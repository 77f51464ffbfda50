"""The PyTorch port's code optimization (solver/code_optim.py
`optimize_codes`) held against the JAX package's (optax Adam, a
piecewise-constant rate, best-code tracking in a `lax.scan`) on the CPU in
f64, through a narrow DeepSDF decoder with weights made with numpy.

Tolerances: codes to 1e-9 (f64 rounding carried through the Adam steps,
whose normalized update amplifies it), `s` unchanged bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.solver import code_optim as jco
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.solver import code_optim as tco
from torch_threads import intra_op_share  # noqa: F401 (autouse)

NARROW = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
              down_sample_layers=(2,), down_sample_factor=(2,),
              atten_start_layer=2, atten_multi_head_c=8, num_knn=8, n_pcl=64,
              decoder_dims=(96,) * 4, decoder_latent_in=(2,))
B, M = 4, 48


def numpy_params(model, seed):
    """A parameter tree of the JAX model made with numpy (its shapes from
    jax.eval_shape, which compiles nothing): weights uniform in
    +-1/sqrt(fan_in), each weight-norm gain the norm of its direction (the
    effective weight is the direction, as at JAX's init), biases 0."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
            elif name in ("weight", "kernel", "v"):
                fan_in = leaf.shape[-1] if name == "weight" else leaf.shape[0]
                out[name] = rng.uniform(-1, 1, leaf.shape) / np.sqrt(fan_in)
            elif name in ("b", "bias"):
                out[name] = np.zeros(leaf.shape)
        if "g" in tree:
            out["g"] = np.linalg.norm(out["v"], axis=0)
        assert set(out) == set(tree)
        return out

    return fill(jax.eval_shape(lambda k: model.init_params(k, n_points=64),
                               jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def models():
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW, parity=True))
    params = numpy_params(jm, 3)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    tm = ShapePrior(ShapePriorConfig(**NARROW), device="cpu", dtype=torch.float64)
    tm.load_state_dict(params_from_jax(params))
    return jm, jp, tm


def inputs(seed):
    rng = np.random.default_rng(seed)
    codes = {"z_so3": rng.normal(size=(B, 32, 3)), "z_inv": rng.normal(size=(B, 32)),
             "s": rng.uniform(0.8, 1.2, size=(B,)), "t": 0.1 * rng.normal(size=(B, 1, 3))}
    pc = rng.uniform(-0.5, 0.5, size=(B, M, 3))
    return codes, pc


def run_both(models, seed, **cfg_kwargs):
    jm, jp, tm = models
    codes, pc = inputs(seed)
    tcfg = tco.CodeOptimConfig(**cfg_kwargs)
    jcfg = jco.CodeOptimConfig(**cfg_kwargs)
    got = tco.optimize_codes(tm.decode_sdf, {k: torch.from_numpy(v) for k, v in codes.items()},
                             torch.from_numpy(pc), tcfg)
    want = jax.jit(lambda c, p: jco.optimize_codes(
        lambda q, cc: jm.decode_sdf(jp, q, cc), c, p, jcfg))(
        {k: jnp.asarray(v) for k, v in codes.items()}, jnp.asarray(pc))
    return codes, pc, got, want


def assert_codes_equal(codes, got, want):
    assert set(got) == set(codes)
    for k in ("z_inv", "z_so3", "t"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got["s"].numpy(), codes["s"])
    np.testing.assert_array_equal(np.asarray(want["s"]), codes["s"])


def loss(tm, codes, pc):
    with torch.no_grad():
        sdf = tm.decode_sdf(torch.from_numpy(pc), {k: torch.as_tensor(v) for k, v in codes.items()})
    return torch.mean(sdf ** 2, dim=-1).numpy()


@pytest.mark.parametrize("cfg_kwargs", [
    # the rate scaled from step 6 on: the last 6 steps at a tenth
    dict(n_steps=12, lr_milestone=6, lr_z_inv=1e-2, lr_t=1e-2, lr_z_so3=2e-2),
    dict(n_steps=12, lr_milestone=6, lr_decay=0.5, lr_z_inv=3e-2, lr_t=1e-3, lr_z_so3=1e-2),
])
def test_optimize_codes_matches_optax(models, cfg_kwargs):
    codes, pc, got, want = run_both(models, 0, **cfg_kwargs)
    assert_codes_equal(codes, got, want)
    # the rates are small enough that the loss falls
    assert (loss(models[2], got, pc) < loss(models[2], codes, pc)).all()


def test_best_code_is_an_earlier_iterate(models):
    """A rate large enough that the loss rises again: some instances return
    an earlier iterate than the last one evaluated, and the two sides agree
    on the codes. Iterate i's index is found from the runs of 1..n steps
    (run j returns the best of iterates 0..j-1)."""
    n, cfg = 10, dict(lr_milestone=5, lr_z_inv=0.1, lr_t=0.1, lr_z_so3=0.1)
    codes, pc, got, want = run_both(models, 1, n_steps=n, **cfg)
    assert_codes_equal(codes, got, want)
    tc = {k: torch.from_numpy(v) for k, v in codes.items()}
    prefix = [tco.optimize_codes(models[2].decode_sdf, tc, torch.from_numpy(pc),
                                 tco.CodeOptimConfig(n_steps=j, **cfg))["z_inv"]
              for j in range(1, n + 1)]
    best_at = [min(j for j in range(n) if torch.equal(prefix[j][b], got["z_inv"][b]))
               for b in range(B)]
    assert any(0 < i < n - 1 for i in best_at), best_at
    # the returned codes' loss is no higher than the input's
    assert (loss(models[2], got, pc) <= loss(models[2], codes, pc)).all()


def test_gradient_reaches_the_codes_only(models):
    """Under a caller's no_grad the optimization still steps, and no
    gradient accumulates in the decoder's parameters."""
    tm = models[2]
    codes, pc = inputs(2)
    with torch.no_grad():
        got = tco.optimize_codes(tm.decode_sdf, {k: torch.from_numpy(v) for k, v in codes.items()},
                                 torch.from_numpy(pc), tco.CodeOptimConfig(n_steps=3, lr_z_inv=1e-2))
    assert not np.array_equal(got["z_inv"].numpy(), codes["z_inv"])
    assert all(p.grad is None for p in tm.parameters())
    assert not any(v.requires_grad for v in got.values())


def test_mixed_dtypes_match_jax(models):
    """f32 points with f64 codes (JAX carries the loss in their result
    type): the codes come back in f64 and match JAX's."""
    jm, jp, tm = models
    codes, pc = inputs(3)
    pc32 = pc.astype(np.float32)
    cfg = dict(n_steps=4, lr_z_inv=1e-2, lr_t=1e-2, lr_z_so3=1e-2)
    got = tco.optimize_codes(tm.decode_sdf, {k: torch.from_numpy(v) for k, v in codes.items()},
                             torch.from_numpy(pc32), tco.CodeOptimConfig(**cfg))
    want = jco.optimize_codes(lambda q, cc: jm.decode_sdf(jp, q, cc),
                              {k: jnp.asarray(v) for k, v in codes.items()},
                              jnp.asarray(pc32), jco.CodeOptimConfig(**cfg))
    assert got["z_inv"].dtype == torch.float64
    assert_codes_equal(codes, got, want)


def test_config_defaults_match_jax():
    t, j = tco.CodeOptimConfig(), jco.CodeOptimConfig()
    assert {f: getattr(t, f) for f in t.__dataclass_fields__} == {
        f: getattr(j, f) for f in j.__dataclass_fields__}
