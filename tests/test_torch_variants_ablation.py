"""The ablation encoders (nn/encoders.py) held against the JAX package on
the CPU: the same numpy clouds from a seed, the JAX init carried over by
the converter.

* Each of the five at tests/test_aux.py's sizes (VecDGCNN, VecDGCNNV2 on
  48 points, DGCNN, PointNet and PCNet on 32): float64, rtol 1e-9; the VN
  encoders' SIM(3) equivariance as tests/test_aux.py holds JAX's.
* Each through ShapePrior(encoder_type=...).encode at JAX's default widths
  (c_dim 16, K 8, 64 points): float64, rtol 1e-9.
* One scene-pair pipeline call with encoder_type="vecdgcnn" (FPS, encode,
  match, Kabsch, ICP with the Kabsch refit) on 2 scenes x 4 objects:
  float64, matches0 equal, R and t within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.nn import encoders as jenc
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import module_params_from_jax, params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.nn import encoders
from livingscenes_tpu_torch.solver.pipeline import (
    PipelineConfig, build_scene_pair_pipeline)
from livingscenes_tpu_torch.solver.registration import RegistrationConfig
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def clouds(seed, B=3, N=256):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * rng.uniform(0.3, 1.0, size=(B, 1, 3))
    return pts + rng.uniform(-2, 2, size=(B, 1, 3))


VEC_ENCODERS = [
    ("VecDGCNN", dict(hidden_dim=16, c_dim=16, first_layer_knn=8, scale_factor=5.0)),
    ("VecDGCNNV2", dict(c_dim=16, num_layers=3, feat_dim=(8, 16, 16), num_knn=8,
                        scale_factor=5.0)),
]
BASELINES = [("DGCNN", dict(c_dim=16)), ("PointNet", dict(c_dim=16)),
             ("PCNet", dict(latent_dim=64, output_dim=16))]


def port_encoder(name, kw, params):
    enc = getattr(encoders, name)(**kw).double()
    enc.load_state_dict(module_params_from_jax(params))
    return enc


@pytest.mark.parametrize("name,kw", VEC_ENCODERS + BASELINES)
def test_ablation_encoder_matches_jax(name, kw):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 48 if (name, kw) in VEC_ENCODERS else 32, 3))
    jmod = getattr(jenc, name)(**kw)
    params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                          jmod.init(jax.random.PRNGKey(0), x)["params"])
    want = jax.jit(jmod.apply)({"params": params}, x)
    enc = port_encoder(name, kw, params)
    with torch.no_grad():
        got = enc(torch.from_numpy(x))
    assert len(got) == len(want) == (4 if name == "PCNet" else 3)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("name,kw", VEC_ENCODERS)
def test_vec_encoder_equivariance(name, kw):
    """scale * s, z_so3 rotated, z_inv invariant under x -> s R x."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 48, 3)))
    enc = getattr(encoders, name)(**kw).double()
    gen = torch.Generator().manual_seed(0)
    for mod in enc.modules():
        if hasattr(mod, "reset_parameters"):
            mod.reset_parameters(gen)
    R = torch.from_numpy(Rotation.random(2, random_state=1).as_matrix())
    s = torch.tensor([0.6, 1.7], dtype=torch.float64)
    with torch.no_grad():
        scale, z_so3, z_inv = enc(x)
        scale2, z_so3_2, z_inv_2 = enc(torch.einsum("bij,bnj->bni", R, x * s[:, None, None]))
    np.testing.assert_allclose(scale2.numpy(), (scale * s).numpy(), rtol=1e-8)
    np.testing.assert_allclose(z_so3_2.numpy(),
                               torch.einsum("bij,bcj->bci", R, z_so3).numpy(), atol=1e-8)
    np.testing.assert_allclose(z_inv_2.numpy(), z_inv.numpy(), atol=1e-8)


def test_shape_prior_encodes_with_every_encoder_type():
    """The registry at JAX's default widths: each encoder_type's parameter
    tree is JAX's, and encode through it matches JAX's (float64, rtol
    1e-9; PCNet's four outputs move t by its centre)."""
    pc = clouds(4, B=2, N=64)
    for etype in ("vecdgcnn", "vecdgcnn2", "dgcnn", "pointnet", "pcnet"):
        jcfg = jsp.ShapePriorConfig(encoder_type=etype, c_dim=16, num_knn=8,
                                    decoder_dims=(64,) * 8, n_pcl=64, parity=True)
        model = jsp.ShapePrior(jcfg)
        shapes = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        rng = np.random.default_rng(5)
        params = jax.tree.map(
            lambda s: rng.normal(size=s.shape) / np.sqrt(max(s.shape[0], 1)), shapes)
        want = jax.jit(model.encode)(params, jnp.asarray(pc))
        m = ShapePrior(ShapePriorConfig(encoder_type=etype, c_dim=16, num_knn=8,
                                        decoder_dims=(64,) * 8, n_pcl=64),
                       device="cpu", dtype=torch.float64)
        m.load_state_dict(params_from_jax(params))
        with torch.no_grad():
            got = m.encode(torch.from_numpy(pc))
        for k in ("z_so3", "z_inv", "s", "t"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{etype} {k}")


def test_pipeline_with_vecdgcnn_matches_jax():
    S, O, N = 2, 4, 384
    rng = np.random.default_rng(6)
    objs = rng.uniform(-0.5, 0.5, (S, O, N, 3)) * rng.uniform(0.3, 1.0, (S, O, 1, 3))
    ref = objs + rng.uniform(-3, 3, (S, O, 1, 3))
    Rm = Rotation.random(S * O, random_state=0).as_matrix().reshape(S, O, 3, 3)
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + 0.5 * rng.normal(size=(S, O, 1, 3))
    perm = np.stack([rng.permutation(O) for _ in range(S)])
    rescan = np.stack([rescan[s][perm[s]] for s in range(S)])
    mask = np.ones((S, O, N), bool)
    mask[:, :, 300:] = rng.random((S, O, N - 300)) > 0.5
    small = dict(encoder_type="vecdgcnn", c_dim=32, num_knn=8, n_pcl=256,
                 decoder_dims=(96,) * 8)
    jcfg = jsp.ShapePriorConfig(**small, parity=True)
    params = jax.tree.map(np.asarray, jax.jit(jsp.ShapePrior(jcfg).init_params)(
        jax.random.PRNGKey(0)))
    jout = jpipe.build_scene_pair_pipeline(
        jsp.ShapePrior(jcfg),
        jpipe.PipelineConfig(encode_fps=True, registration=jreg.RegistrationConfig(
            icp_iterations=20, icp_fused=False)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(ref), jnp.asarray(rescan),
        jnp.asarray(mask), jnp.asarray(mask))
    m = ShapePrior(ShapePriorConfig(**small), device="cpu", dtype=torch.float64)
    m.load_state_dict(params_from_jax(params))
    pipe = build_scene_pair_pipeline(m, PipelineConfig(
        encode_fps=True, registration=RegistrationConfig(icp_iterations=20,
                                                         icp_fused=False)))
    with torch.no_grad():
        out = pipe(ref, rescan, mask, mask)
    np.testing.assert_array_equal(np.asarray(out["matches0"]), np.asarray(jout["matches0"]))
    np.testing.assert_allclose(np.asarray(out["R"]), np.asarray(jout["R"]), atol=1e-6)
    np.testing.assert_allclose(np.asarray(out["t"]), np.asarray(jout["t"]), atol=1e-6)
