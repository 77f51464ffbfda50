"""The port's query-sharded grids on 2 gloo ranks on the CPU, held against
JAX on its 8-device virtual CPU mesh and on one device, as
tests/test_pipeline_sharded.py holds JAX's: the sphere's dense grid
(sharded_dense_grid_values, dense_grid_values(mesh=)) to 1e-6, the
coarse-to-fine grid of the sphere through hierarchical_grid_values(mesh=)
to 1e-6 (against JAX's on one device, which its own test holds to its
sharded one), and the first instance's canonical grid through a qp-sharded
MeshExtractor (and a MoreSolver given the mesh) to 2e-5, with the TINY
model's JAX init carried over in float64.

Also: the refusal of a leading axis the mesh does not divide, a mesh of one
rank running unsharded (bit for bit), and initialize_distributed's no-op in
one process and its refusal of two NCCL ranks on one card (no card needed:
the CUDA queries are stubbed).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.models.shape_prior import ShapePrior as JShapePrior
from livingscenes_tpu.parallel.sharding import make_mesh as jax_make_mesh
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.recon import grid as jgrid
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePriorConfig
from livingscenes_tpu_torch.parallel import initialize_distributed
from livingscenes_tpu_torch.recon.grid import hierarchical_grid_values
from livingscenes_tpu_torch.solver import registration as treg
from livingscenes_tpu_torch.solver.pipeline import PipelineConfig
from test_pipeline_sharded import TINY, N, O, S
from torch_parallel_children import grid_child, load, size1_child, spawn, sphere
from torch_threads import intra_op_share  # noqa: F401 (autouse)

PORT_FIELDS = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(ShapePriorConfig)
               if hasattr(TINY, f.name)}
EXT = dict(resolution0=8, upsampling_steps=1, simplify_nfaces=None,
           points_batch_size=512)


def jsphere(pts):
    return jnp.linalg.norm(pts, axis=-1) - 0.4


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel_grid")
    model = JShapePrior(TINY)
    params = model.init_params(jax.random.PRNGKey(0), n_points=N)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), params)
    rng = np.random.default_rng(0)
    ref = (rng.normal(size=(S, O, N, 3))
           + rng.uniform(-2, 2, (S, O, 1, 3))).astype(np.float32).astype(np.float64)
    rescan = ref[:, ::-1] + 0.1
    torch.save(params_from_jax(jax.tree.map(np.asarray, params)), tmp / "weights.pt")
    np.savez(tmp / "inputs.npz", ref=ref, rescan=rescan)
    spawn(grid_child, 2, tmp, PORT_FIELDS, EXT)
    spawn(size1_child, 1, tmp, PORT_FIELDS, PipelineConfig(
        registration=treg.RegistrationConfig(icp_fused=False, icp_iterations=3)))
    return tmp, model, params, ref, [load(tmp, "grid_2", r) for r in range(2)]


def test_ranks_return_the_whole_grid(setup):
    a, b = setup[-1]
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_dense_grid_matches_jax(setup):
    port = setup[-1][0]
    qp = jax_make_mesh(jax.devices()[:8], axis_names=("qp",))
    dense = np.asarray(jgrid.dense_grid_values(jsphere, resolution=24, box_size=1.1))
    sharded = np.asarray(jgrid.sharded_dense_grid_values(jsphere, 24, qp, box_size=1.1))
    for key in ("sphere_sharded", "sphere_dense_mesh"):
        assert port[key].shape == (25, 25, 25)
        np.testing.assert_allclose(port[key], dense, atol=1e-6, err_msg=key)
        np.testing.assert_allclose(port[key], sharded, atol=1e-6, err_msg=key)


def test_sharded_hierarchical_grid_matches_jax(setup):
    port = setup[-1][0]["sphere_hier_mesh"]
    want = jgrid.hierarchical_grid_values(jsphere, resolution0=8, upsampling_steps=2,
                                          chunk_size=300)
    np.testing.assert_allclose(port, np.asarray(want), atol=1e-6)
    local = hierarchical_grid_values(sphere, resolution0=8, upsampling_steps=2,
                                     chunk_size=300, device="cpu")
    np.testing.assert_allclose(port, local.numpy(), atol=1e-6)


def test_qp_mesh_extractor_matches_jax(setup):
    _, model, params, ref, ranks = setup
    codes = model.encode(params, jnp.asarray(ref[0]))
    one = jax.tree.map(lambda x: x[:1], codes)
    canonical = dict(one, s=jnp.ones_like(one["s"]), t=jnp.zeros_like(one["t"]))
    logits = lambda q, c: model.occupancy_logits(params, q, c)
    cfg = jext.MeshExtractorConfig(**EXT)
    qp = jax_make_mesh(jax.devices()[:8], axis_names=("qp",))
    for mesh in (None, qp):
        want = np.asarray(jext.MeshExtractor(logits, cfg, mesh=mesh)._grid_fn(canonical)[0])
        for key in ("extractor_grid", "solver_grid"):
            np.testing.assert_allclose(ranks[0][key], want, atol=2e-5, err_msg=key)


def test_indivisible_axis_is_refused(setup):
    for message in setup[-1][0]["refusals"]:
        assert "3 rows does not divide over the 2 ranks" in str(message), message


def test_mesh_of_one_rank_runs_unsharded(setup):
    out = load(setup[0], "size1", 0)
    keys = [k[len("none_"):] for k in out if k.startswith("none_")]
    assert {"matches0", "R", "t", "grid"} <= set(keys)
    for k in keys:
        np.testing.assert_array_equal(out[f"mesh_{k}"], out[f"none_{k}"], err_msg=k)


def test_single_process_initialize_is_a_no_op(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_two_nccl_ranks_on_one_card_are_refused(monkeypatch, tmp_path, backend):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: pytest.fail("set_device"))
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("init_process_group"))
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="NVIDIA H100.*backend='gloo'"):
        initialize_distributed(backend=backend, init_method=f"file://{tmp_path}/r",
                               world_size=2, rank=1)
    assert not torch.distributed.is_initialized()
