"""The PyTorch port's encoder (VecDGCNNAttn through ShapePrior.encode) held
against the JAX package on the CPU at a small width: feat_dim
(8, 8, 16, 16, 16, 32, 32), c_dim 32, K 8, N 256, B 4. The same weights
(the JAX init, carried over by params_from_jax) and the same numpy clouds
go into both.

Tolerances:
  * f64 against ShapePriorConfig(parity=True) (exact kNN, plain gathers,
    XLA FPS, unfused K/V): rtol 1e-9 — rounding only, the graphs and FPS
    picks are identical.
  * f32 against the default config (the path the TPU build compiles off
    the chip: approx kNN, which is exact on the CPU, one-hot gathers,
    fused K/V): atol 1e-4 on z_so3 and z_inv, rtol 1e-4 on s and t.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import (
    ShapePrior,
    ShapePriorConfig,
    transform_codes,
)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

SMALL = dict(c_dim=32, feat_dim=(8, 8, 16, 16, 16, 32, 32), num_knn=8, n_pcl=256)


@pytest.fixture(scope="module")
def jax_params():
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL))
    # the parameter shapes do not depend on the cloud size; a small one
    # keeps the init quick
    init = jax.jit(model.init_params, static_argnames="n_points")
    params = init(jax.random.PRNGKey(0), n_points=64)
    return jax.tree.map(np.asarray, params)


def port_model(params, dtype):
    m = ShapePrior(ShapePriorConfig(**SMALL), device="cpu", dtype=dtype)
    m.load_state_dict(params_from_jax(params))
    return m


def clouds(seed, B=4, N=256):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * rng.uniform(0.3, 1.0, size=(B, 1, 3))
    return pts + rng.uniform(-2, 2, size=(B, 1, 3))


def encode_both(params, pc, dtype, parity):
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, parity=parity))
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jp = jax.tree.map(lambda a: jnp.asarray(a, jdt), params)
    cj = jax.jit(jm.encode)(jp, jnp.asarray(pc, jdt))
    with torch.no_grad():
        ct = port_model(params, dtype).encode(torch.as_tensor(pc, dtype=dtype))
    return {k: np.asarray(v) for k, v in cj.items()}, {k: v.numpy() for k, v in ct.items()}


def test_encode_matches_jax_parity_f64(jax_params):
    cj, ct = encode_both(jax_params, clouds(0), torch.float64, parity=True)
    for k in ("z_so3", "z_inv", "s", "t"):
        np.testing.assert_allclose(ct[k], cj[k], rtol=1e-9, atol=1e-12, err_msg=k)


def test_encode_matches_jax_default_f32(jax_params):
    cj, ct = encode_both(jax_params, clouds(1), torch.float32, parity=False)
    np.testing.assert_allclose(ct["z_so3"], cj["z_so3"], atol=1e-4)
    np.testing.assert_allclose(ct["z_inv"], cj["z_inv"], atol=1e-4)
    np.testing.assert_allclose(ct["s"], cj["s"], rtol=1e-4)
    np.testing.assert_allclose(ct["t"], cj["t"], rtol=1e-4, atol=1e-5)


def test_normalize_input_matches_jax(jax_params):
    pc = clouds(2)
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL))
    nj, cj, sj = jm.normalize_input(jnp.asarray(pc))
    nt, ct, st = port_model(jax_params, torch.float64).normalize_input(torch.from_numpy(pc))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-12)
    np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12)


def test_encode_fps_matches_jax(jax_params):
    rng = np.random.default_rng(3)
    pc = rng.normal(size=(2, 400, 3))
    mask = rng.random((2, 400)) > 0.1
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, parity=True))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jax_params)
    cj = jax.jit(jm.encode_fps)(jp, jnp.asarray(pc), jnp.asarray(mask))
    with torch.no_grad():
        ct = port_model(jax_params, torch.float64).encode_fps(
            torch.from_numpy(pc), torch.from_numpy(mask))
    for k in ("z_so3", "z_inv", "s", "t"):
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), rtol=1e-9, atol=1e-12)


def test_reference_behaviours(jax_params):
    """Identical points give NaN codes; t is SE(3)- but not
    SIM(3)-equivariant; z_inv is SIM(3)-invariant (f64)."""
    m = port_model(jax_params, torch.float64)
    with torch.no_grad():
        same = m.encode(torch.ones((1, 256, 3), dtype=torch.float64))
        assert torch.isnan(same["z_so3"]).all()

        pc = torch.from_numpy(clouds(4, B=2))
        R = torch.from_numpy(Rotation.random(2, random_state=9).as_matrix())
        tr = torch.tensor([[0.3, -0.2, 0.5], [1.0, 0.0, -0.4]], dtype=torch.float64)
        c0 = m.encode(pc)
        moved = torch.einsum("bij,bnj->bni", R, pc) + tr[:, None]
        c1 = m.encode(moved)
        g = torch.cat([R, tr[..., None]], dim=-1)
        want = transform_codes(c0, g)
        np.testing.assert_allclose(c1["z_so3"].numpy(), want["z_so3"].numpy(), atol=1e-8)
        np.testing.assert_allclose(c1["t"].numpy(), want["t"].numpy(), atol=1e-8)
        np.testing.assert_allclose(c1["z_inv"].numpy(), c0["z_inv"].numpy(), atol=1e-8)
        np.testing.assert_allclose(c1["s"].numpy(), c0["s"].numpy(), rtol=1e-8)
        c2 = m.encode(2.0 * pc)
        np.testing.assert_allclose(c2["z_inv"].numpy(), c0["z_inv"].numpy(), atol=1e-8)
        np.testing.assert_allclose(c2["s"].numpy(), 2.0 * c0["s"].numpy(), rtol=1e-8)
        assert np.abs(c2["t"].numpy() - 2.0 * c0["t"].numpy()).max() > 1e-6


def test_transform_codes_matches_jax(rng):
    codes = {"z_so3": rng.normal(size=(3, 5, 3)), "z_inv": rng.normal(size=(3, 5)),
             "s": rng.uniform(1, 2, size=(3,)), "t": rng.normal(size=(3, 1, 3))}
    R = Rotation.random(3, random_state=2).as_matrix()
    g = np.concatenate([R, rng.normal(size=(3, 3, 1))], -1)
    cj = jsp.transform_codes({k: jnp.asarray(v) for k, v in codes.items()}, jnp.asarray(g))
    ct = transform_codes({k: torch.from_numpy(v) for k, v in codes.items()}, torch.from_numpy(g))
    for k in codes:
        np.testing.assert_allclose(ct[k].numpy(), np.asarray(cj[k]), atol=1e-12)
