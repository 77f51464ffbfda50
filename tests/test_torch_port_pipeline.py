"""The PyTorch port's scene-pair pipeline (FPS -> encode -> match ->
Kabsch -> ICP) held against the JAX pipeline on the CPU, at the small
encoder width of test_torch_port_encoder.py on 2 scenes x 4 objects.

Tolerances:
  * f64, both sides on the Kabsch ICP refit (icp_fused=False): matches0
    equal; R and t to 1e-6.
  * the fused ICP statistics (icp_fused=True on the JAX side, the port's
    default): matches0 equal; after 20 iterations rotations within 0.5
    degree and translations within 1e-2. Both sides compute the
    statistics in f32 (the JAX wrapper casts), in another summation
    order, and the box clouds make the rotation fit ill-conditioned: after
    one iteration the two poses differ by about 7e-6 in R and 3e-5 in t
    (t is of order 3), and a later nearest-target flip can grow that to
    about 4e-3 (recorded in ROADMAP.md, Queue C). So one iteration is
    also held, to R within 3e-5 and t within 1e-4, which a wrong fused
    refit would miss by orders of magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch import se3
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.solver.pipeline import (
    PipelineConfig,
    build_scene_pair_pipeline,
)
from livingscenes_tpu_torch.solver.registration import (
    RegistrationConfig,
    kabsch_from_codes,
    solve_pairwise_registration,
)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

SMALL = dict(c_dim=32, feat_dim=(8, 8, 16, 16, 16, 32, 32), num_knn=8, n_pcl=256)
S, O, N = 2, 4, 384


def make_scenes(seed):
    rng = np.random.default_rng(seed)
    objs = rng.uniform(-0.5, 0.5, (S, O, N, 3)) * rng.uniform(0.3, 1.0, (S, O, 1, 3))
    ref = objs + rng.uniform(-3, 3, (S, O, 1, 3))
    Rm = Rotation.random(S * O, random_state=0).as_matrix().reshape(S, O, 3, 3)
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + 0.5 * rng.normal(size=(S, O, 1, 3))
    perm = np.stack([rng.permutation(O) for _ in range(S)])
    rescan = np.stack([rescan[s][perm[s]] for s in range(S)])
    mask = np.ones((S, O, N), bool)
    mask[:, :, 300:] = rng.random((S, O, N - 300)) > 0.5
    return ref, rescan, mask, perm


@pytest.fixture(scope="module")
def params():
    model = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL))
    init = jax.jit(model.init_params, static_argnames="n_points")
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(1), n_points=64))


def port_model(params, dtype=torch.float64):
    m = ShapePrior(ShapePriorConfig(**SMALL), device="cpu", dtype=dtype)
    m.load_state_dict(params_from_jax(params))
    return m


def run_both(params, fused, iterations=20):
    ref, rescan, mask, _ = make_scenes(0)
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, parity=True))
    jcfg = jpipe.PipelineConfig(
        encode_fps=True,
        registration=jreg.RegistrationConfig(
            icp_iterations=iterations, icp_fused=fused),
    )
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    out_j = jpipe.build_scene_pair_pipeline(jm, jcfg)(
        jp, jnp.asarray(ref), jnp.asarray(rescan), jnp.asarray(mask), jnp.asarray(mask))
    cfg = PipelineConfig(encode_fps=True, registration=RegistrationConfig(
        icp_iterations=iterations, icp_fused=None if fused else False))
    out_t = build_scene_pair_pipeline(port_model(params), cfg)(ref, rescan, mask, mask)
    assert out_t["R"].shape == (S, O, 3, 3) and out_t["t"].shape == (S, O, 3, 1)
    np.testing.assert_array_equal(out_t["matches0"].numpy(), np.asarray(out_j["matches0"]))
    return out_t, {k: np.array(v) for k, v in out_j.items()}


def test_scene_pair_pipeline_matches_jax_f64(params):
    out_t, out_j = run_both(params, fused=False)
    np.testing.assert_allclose(out_t["R"].numpy(), out_j["R"], atol=1e-6)
    np.testing.assert_allclose(out_t["t"].numpy(), out_j["t"], atol=1e-6)


def test_scene_pair_pipeline_fused_icp_matches_jax(params):
    out_t, out_j = run_both(params, fused=True)
    R_t = out_t["R"].reshape(-1, 3, 3)
    deg = se3.rotation_error(R_t, torch.from_numpy(out_j["R"].reshape(-1, 3, 3)))
    assert float(deg.max()) < 0.5
    np.testing.assert_allclose(out_t["t"].numpy(), out_j["t"], atol=1e-2)


def test_scene_pair_pipeline_fused_icp_one_iteration_matches_jax(params):
    out_t, out_j = run_both(params, fused=True, iterations=1)
    np.testing.assert_allclose(out_t["R"].numpy(), out_j["R"], atol=3e-5)
    np.testing.assert_allclose(out_t["t"].numpy(), out_j["t"], atol=1e-4)


def test_stacked_fps_front_end_matches_jax(params):
    # the port samples both sides of the scene pairs in one FPS call; each
    # side must get JAX's picks, with a mask on one side only
    from livingscenes_tpu.ops.fps import farthest_point_sampling as jfps

    ref, rescan, mask, _ = make_scenes(0)
    m = port_model(params)
    seen = []
    encode = m.encode
    m.encode = lambda pc: seen.append(pc.clone()) or encode(pc)
    build_scene_pair_pipeline(m, PipelineConfig(encode_fps=True, registration=RegistrationConfig(
        icp_iterations=1)))(ref, rescan, mask, None)
    k = SMALL["n_pcl"]
    for got, pts, msk in ((seen[0], ref, mask), (seen[1], rescan, None)):
        want, _ = jfps(jnp.asarray(pts.reshape(S * O, N, 3)), k,
                       mask=None if msk is None else jnp.asarray(msk.reshape(S * O, N)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_registration_kabsch_and_accept_rules(params):
    rng = np.random.default_rng(5)
    m = port_model(params)
    pc1 = rng.uniform(-0.5, 0.5, size=(3, 256, 3))
    R = Rotation.random(3, random_state=4).as_matrix()
    pc2 = np.einsum("bij,bnj->bni", R, pc1) + 0.2
    t1, t2 = torch.from_numpy(pc1), torch.from_numpy(pc2)
    with torch.no_grad():
        c1, c2 = m.encode(t1), m.encode(t2)
        res = kabsch_from_codes(c1, c2)
        jres = jreg.kabsch_from_codes(
            {k: jnp.asarray(v.numpy()) for k, v in c1.items()},
            {k: jnp.asarray(v.numpy()) for k, v in c2.items()})
        np.testing.assert_allclose(res.R.numpy(), np.asarray(jres.R), atol=1e-10)
        np.testing.assert_allclose(res.t.numpy(), np.asarray(jres.t), atol=1e-10)
        np.testing.assert_allclose(res.residual.numpy(), np.asarray(jres.residual), atol=1e-10)
        # equivariant codes: the init already recovers the pose
        np.testing.assert_allclose(res.R.numpy(), R, atol=1e-6)
        for accept in ("always", "symch", "sdf"):
            Rr, tr = solve_pairwise_registration(
                m, t1, t2, c1, c2, cfg=RegistrationConfig(icp_iterations=10, icp_accept=accept))
            np.testing.assert_allclose(Rr.numpy(), R, atol=1e-4)
        with pytest.raises(ValueError, match="icp_accept"):
            solve_pairwise_registration(
                m, t1, t2, c1, c2, cfg=RegistrationConfig(icp_accept="never"))
    # the refinement (tests/test_torch_port_refine.py) and the
    # reconstruction leg (tests/test_torch_port_recon_pipeline.py) are ported
    assert callable(build_scene_pair_pipeline(m, PipelineConfig(optim=True)))
    assert callable(build_scene_pair_pipeline(m, PipelineConfig(recon=True)))
