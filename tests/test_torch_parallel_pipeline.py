"""The port's scene-sharded pipeline (build_scene_pair_pipeline(mesh=...))
on 2 and 4 gloo ranks on the CPU, held against the JAX pipeline on its
8-device virtual CPU mesh and on one device.

The setup is tests/test_pipeline_sharded.py's: its TINY config, 8 scenes x 4
objects x 64 points from seed 0, the JAX init at PRNGKey(0), here in
float64 on both sides (the weights carried over by params_from_jax). The
configurations are its default (ICP 5 iterations), `optim=True` (5 steps)
and the full `encode_fps + recon` program, with the Kabsch ICP refit on
the port's side (JAX's CPU path). Each rank returns the gathered outputs.

Tolerances are the JAX test's own: matches0 equal, R and t to 1e-5, the
recon grids and their scale and translation to 2e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models.shape_prior import ShapePrior as JShapePrior
from livingscenes_tpu.parallel.sharding import make_mesh as jax_make_mesh
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig
from livingscenes_tpu_torch.solver import registration as treg
from livingscenes_tpu_torch.solver.pipeline import PipelineConfig
from test_pipeline_sharded import TINY, N, O, S
from torch_parallel_children import load, pipeline_child, spawn
from torch_threads import intra_op_share  # noqa: F401 (autouse)

PORT_FIELDS = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(ShapePriorConfig)
               if hasattr(TINY, f.name)}

RECON = dict(encode_fps=True, recon=True, recon_resolution0=8,
             recon_upsampling_steps=1, recon_chunk=512)
CASES = {
    "default": (dict(use_icp=True, icp_iterations=5), {}),
    "optim": (dict(n_steps=5, lr_milestones=(3,), sinkhorn_iters=3, use_icp=True,
                   icp_iterations=2), dict(optim=True)),
    "e2e": (dict(use_icp=True, icp_iterations=3), RECON),
}
KEYS = {"default": ("R", "t"), "optim": ("R", "t"),
        "e2e": ("R", "t", "grids_premerge", "grid_fidx", "grid_fvals", "recon_s",
                "recon_t")}


def port_config(case):
    reg, extra = CASES[case]
    return PipelineConfig(registration=treg.RegistrationConfig(icp_fused=False, **reg),
                          **extra)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_pipeline")
    model = JShapePrior(TINY)
    params = model.init_params(jax.random.PRNGKey(0), n_points=N)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    rng = np.random.default_rng(0)
    objs = rng.normal(size=(S, O, N, 3)).astype(np.float32)
    ref = objs + rng.uniform(-2, 2, (S, O, 1, 3)).astype(np.float32)
    perm = np.stack([rng.permutation(O) for _ in range(S)])
    rescan = np.stack([ref[s][perm[s]] for s in range(S)])
    rescan = rescan + rng.normal(size=(S, O, 1, 3)).astype(np.float32) * 0.1
    ref, rescan = ref.astype(np.float64), rescan.astype(np.float64)
    mask = np.ones((S, O, N), bool)
    torch.save(params_from_jax(jax.tree.map(np.asarray, params)), tmp / "weights.pt")
    np.savez(tmp / "inputs.npz", ref=ref, rescan=rescan, mask=mask)
    spawn(pipeline_child, 2, tmp, PORT_FIELDS, {c: port_config(c) for c in CASES})
    spawn(pipeline_child, 4, tmp, PORT_FIELDS, {"default": port_config("default")})
    return tmp, model, params, ref, rescan, mask


_JAX = {}


def jax_outputs(setup, case, sharded):
    """JAX's outputs of one case on one device or on its 8-device mesh."""
    if (case, sharded) in _JAX:
        return _JAX[case, sharded]
    _, model, params, ref, rescan, mask = setup
    mesh = jax_make_mesh(jax.devices()[:8], axis_names=("dp",)) if sharded else None
    reg, extra = CASES[case]
    cfg = jpipe.PipelineConfig(registration=jreg.RegistrationConfig(**reg), **extra)
    args = (params, jnp.asarray(ref), jnp.asarray(rescan))
    if cfg.encode_fps:
        args += (jnp.asarray(mask), jnp.asarray(mask))
    out = jpipe.build_scene_pair_pipeline(model, cfg, mesh=mesh)(*args)
    _JAX[case, sharded] = {k: np.asarray(v) for k, v in out.items()}
    return _JAX[case, sharded]


def check(port, want, case):
    np.testing.assert_array_equal(port["matches0"], want["matches0"])
    for key in KEYS[case]:
        tol = 1e-5 if key in ("R", "t") else 2e-5
        np.testing.assert_allclose(port[key], want[key], atol=tol, err_msg=key)


@pytest.mark.parametrize("case,world", [("default", 2), ("optim", 2), ("e2e", 2),
                                        ("default", 4)])
def test_sharded_pipeline_matches_jax(setup, case, world):
    tmp = setup[0]
    ranks = [load(tmp, f"{case}_{world}", r) for r in range(world)]
    for out in ranks[1:]:  # every rank returns the whole output
        assert out.keys() == ranks[0].keys()
        for k in out:
            np.testing.assert_array_equal(out[k], ranks[0][k], err_msg=k)
    assert ranks[0]["R"].shape == (S, O, 3, 3)
    check(ranks[0], jax_outputs(setup, case, False), case)
    check(ranks[0], jax_outputs(setup, case, True), case)
