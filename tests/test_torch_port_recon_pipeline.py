"""The PyTorch port's reconstruction leg as a whole:
`build_scene_pair_pipeline(PipelineConfig(encode_fps=True, recon=True))`
and `extract_scene_meshes`, held against the JAX package on the CPU with
the committed checkpoint weights/plateau_r4_selected.ckpt (the production
widths, encoder input 512 points, trained: its codes have real surfaces),
on one scene pair of three procedural shapes, at res0 = 8 with 2 refine
levels and chunks of 512 points.

Tolerances:
  * f64 on both sides, both on the Kabsch ICP refit (icp_fused=False):
    matches0 equal; R and t to 1e-6; the recon keys of the same shapes;
    grid_overflow equal; grids to 1e-6 of their largest magnitude;
    grid_fidx equal; the meshes of extract_scene_meshes equal to 1e-5.
    JAX runs the host merge; the port runs both merges, its device-merged
    grids held against JAX's host-merged ones.
  * f32, recon_bf16: each matched mesh, unsimplified, within 0.5 voxel
    (symmetric mean surface distance, 20,000 samples a mesh) of JAX's
    recon_bf16 mesh and of the port's f32 mesh: the bound of
    tests/test_recon.py, which also meshes without simplification (the
    quadric simplification's greedy order turns a change of 1e-6 in the
    grid into about 0.3 voxel).
  * refine_bf16 (f32 models, the last of 4 refinement steps): R and t
    within 5e-4 of JAX's (measured 3.5e-5 and 6.2e-5: the two frameworks
    round the bfloat16 decoder at other places, in the weight norm and
    the products' accumulation, while bfloat16 against f32 moves R by
    7e-2); the same in f32 within 1e-4 (measured 8.4e-6 and 1.8e-5;
    test_torch_port_refine.py holds the refinement in f64 to 1e-7).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.solver import pipeline as jpipe
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import load_flax_checkpoint, params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.recon.extractor import MeshExtractorConfig
from livingscenes_tpu_torch.solver import registration as treg
from livingscenes_tpu_torch.solver.pipeline import (
    PipelineConfig,
    build_scene_pair_pipeline,
    extract_scene_meshes,
)
from livingscenes_tpu_torch.train.data import SyntheticShapeDataset
from torch_threads import intra_op_share  # noqa: F401 (autouse)

CKPT = os.path.join(os.path.dirname(__file__), "..", "weights", "plateau_r4_selected.ckpt")
N_PCL = 512
S, O, N = 1, 3, 1024
RECON = dict(recon_resolution0=8, recon_upsampling_steps=2, recon_chunk=512)
VOXEL = 1.1 / 32
ICP_ITERS = 20


@pytest.fixture(scope="module")
def params():
    return load_flax_checkpoint(CKPT)


@pytest.fixture(scope="module")
def scenes():
    """One scene pair of three procedural shapes; the rescan moves each
    by its own rigid transform and permutes them."""
    ds = SyntheticShapeDataset(n_items=1, n_pcl=N, ram_cache=False)
    rng = np.random.default_rng(11)
    objs = np.stack([ds._surface_points(ds._shape_sdf(rng), rng, N) for _ in range(O)])
    ref = (objs + rng.uniform(-2, 2, (O, 1, 3)))[None]
    Rm = Rotation.random(O, random_state=2).as_matrix()[None]
    rescan = np.einsum("soij,sonj->soni", Rm, ref) + 0.3 * rng.normal(size=(S, O, 1, 3))
    rescan = rescan[:, [2, 0, 1]]
    return ref, rescan, np.ones((S, O, N), bool)


def port_model(params, dtype):
    m = ShapePrior(ShapePriorConfig(n_pcl=N_PCL), device="cpu", dtype=dtype)
    m.load_state_dict(params_from_jax(params))
    return m


def run_jax(params, scenes, dtype, **recon):
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(n_pcl=N_PCL, parity=True))
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), params)
    cfg = jpipe.PipelineConfig(
        encode_fps=True, recon=True, **RECON, **recon,
        registration=jreg.RegistrationConfig(icp_iterations=ICP_ITERS, icp_fused=False))
    out = jpipe.build_scene_pair_pipeline(jm, cfg)(
        jp, *(jnp.asarray(a, dtype if a.dtype != bool else bool) for a in scenes), scenes[2])
    return {k: np.asarray(v) for k, v in out.items()}


def run_port(params, scenes, dtype, **recon):
    cfg = PipelineConfig(
        encode_fps=True, recon=True, **RECON, **recon,
        registration=treg.RegistrationConfig(icp_iterations=ICP_ITERS, icp_fused=False))
    ref, rescan, mask = scenes
    out = build_scene_pair_pipeline(port_model(params, dtype), cfg)(ref, rescan, mask, mask)
    return {k: v.numpy() for k, v in out.items()}


@pytest.fixture(scope="module")
def f64_runs(params, scenes):
    jax_out = run_jax(params, scenes, jnp.float64)
    port = {merge: run_port(params, scenes, torch.float64, recon_final_merge=merge)
            for merge in ("host", "device")}
    return jax_out, port


@pytest.mark.parametrize("merge", ["host", "device"])
def test_recon_pipeline_matches_jax_f64(f64_runs, merge):
    from livingscenes_tpu.recon.grid import apply_final_merge as jmerge

    out_j, out_t = f64_runs[0], f64_runs[1][merge]
    np.testing.assert_array_equal(out_t["matches0"], out_j["matches0"])
    assert sorted(out_j["matches0"][0].tolist()) == [0, 1, 2]
    np.testing.assert_allclose(out_t["R"], out_j["R"], atol=1e-6)
    np.testing.assert_allclose(out_t["t"], out_j["t"], atol=1e-6)
    np.testing.assert_array_equal(out_t["grid_overflow"], out_j["grid_overflow"])
    assert out_t["grid_overflow"].shape == (S, O, 2)
    np.testing.assert_allclose(out_t["recon_s"], out_j["recon_s"], rtol=1e-6)
    np.testing.assert_allclose(out_t["recon_t"], out_j["recon_t"], atol=1e-6)
    want = np.stack([[jmerge(out_j["grids_premerge"][i, j], out_j["grid_fidx"][i, j],
                             out_j["grid_fvals"][i, j]) for j in range(O)] for i in range(S)])
    scale = np.abs(want).max()
    if merge == "host":
        assert sorted(out_t) == sorted(out_j)
        for key in ("grids_premerge", "grid_fidx", "grid_fvals"):
            assert out_t[key].shape == out_j[key].shape, key
        assert out_t["grids_premerge"].shape == (S, O, 33, 33, 33)
        np.testing.assert_array_equal(out_t["grid_fidx"], out_j["grid_fidx"])
        np.testing.assert_allclose(out_t["grids_premerge"], out_j["grids_premerge"],
                                   rtol=0, atol=1e-6 * scale)
        sel = out_j["grid_fidx"] < 33 ** 3
        np.testing.assert_allclose(out_t["grid_fvals"][sel], out_j["grid_fvals"][sel],
                                   rtol=0, atol=1e-6 * scale)
    else:
        assert "grids" in out_t and "grids_premerge" not in out_t
        np.testing.assert_allclose(out_t["grids"], want, rtol=0, atol=1e-6 * scale)


def test_scene_meshes_match_jax_f64(f64_runs):
    out_j, port = f64_runs
    meshes_j, stats_j = jpipe.extract_scene_meshes(out_j, with_stats=True)
    for merge, out_t in port.items():
        meshes_t, stats_t = extract_scene_meshes(out_t, MeshExtractorConfig(), with_stats=True)
        assert len(stats_t) == len(stats_j) == O
        for a, b in zip(stats_t, stats_j):
            assert (a["faces_raw"], a["faces"], a["empty"]) == (b["faces_raw"], b["faces"], b["empty"])
            assert a["faces_raw"] > 1000 and not a["empty"]
        for j in range(O):
            mt, mj = meshes_t[0][j], meshes_j[0][j]
            np.testing.assert_array_equal(mt.faces, mj.faces, err_msg=merge)
            np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=0, atol=1e-5, err_msg=merge)


def chamfer(a, b, n=20000):
    pa = a.sample_surface(n, seed=0)
    pb = b.sample_surface(n, seed=0)
    return 0.5 * (cKDTree(pb).query(pa)[0].mean() + cKDTree(pa).query(pb)[0].mean())


def test_recon_bf16_matches_jax_and_f32(params, scenes):
    out_j = run_jax(params, scenes, jnp.float32, recon_bf16=True)
    out_t = run_port(params, scenes, torch.float32, recon_bf16=True)
    out_f = run_port(params, scenes, torch.float32)
    np.testing.assert_array_equal(out_t["matches0"], out_j["matches0"])
    np.testing.assert_array_equal(out_f["matches0"], out_j["matches0"])
    assert out_t["grid_fvals"].dtype == np.float32
    raw = MeshExtractorConfig(simplify_nfaces=None)
    meshes_j = jpipe.extract_scene_meshes(
        out_j, jext.MeshExtractorConfig(simplify_nfaces=None))
    meshes_t = extract_scene_meshes(out_t, raw)
    meshes_f = extract_scene_meshes(out_f, raw)
    for j in range(O):
        # the meshes carry the code's scale: so does the voxel
        voxel = VOXEL * float(out_f["recon_s"][0, j])
        assert not meshes_t[0][j].is_empty
        d_jax = chamfer(meshes_t[0][j], meshes_j[0][j])
        d_f32 = chamfer(meshes_t[0][j], meshes_f[0][j])
        assert d_jax < 0.5 * voxel, (j, d_jax, voxel)
        assert d_f32 < 0.5 * voxel, (j, d_f32, voxel)


def test_refine_bf16_matches_jax(params, scenes):
    """The optim branch of the registration in f32 and with refine_bf16,
    on the three pairs' clouds (FPS to 512 points), set so that R and t are
    the refinement's last iterate: no ICP, no best-loss tracking, and no
    direction pick (the pairs are exact rigid copies, whose two directions'
    errors tie)."""
    from livingscenes_tpu.ops.fps import farthest_point_sampling as jfps

    ref, rescan, _ = scenes
    pc1 = np.asarray(jfps(jnp.asarray(ref[0], jnp.float32), N_PCL)[0])
    pc2 = np.asarray(jfps(jnp.asarray(rescan[0][[1, 2, 0]], jnp.float32), N_PCL)[0])
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(n_pcl=N_PCL, parity=True))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params)
    encode = jax.jit(jm.encode)
    c1, c2 = (encode(jp, jnp.asarray(pc)) for pc in (pc1, pc2))
    m = port_model(params, torch.float32)
    got = {}
    for bf16, tol in ((False, 1e-4), (True, 5e-4)):
        kw = dict(n_steps=4, icp_iterations=0, icp_accept="always", track_best=False,
                  direction_pick=False, icp_fused=False, sinkhorn_pallas=False,
                  refine_bf16=bf16)
        Rj, tj = jreg.solve_pairwise_registration(
            jm, jp, jnp.asarray(pc1), jnp.asarray(pc2), c1, c2, optim=True,
            cfg=jreg.RegistrationConfig(**kw))
        with torch.no_grad():
            Rt, tt = treg.solve_pairwise_registration(
                m, torch.from_numpy(pc1.copy()), torch.from_numpy(pc2.copy()),
                optim=True, cfg=treg.RegistrationConfig(**kw))
        assert Rt.dtype == torch.float32 and bool(torch.isfinite(Rt).all())
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=tol, err_msg=str(bf16))
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=tol, err_msg=str(bf16))
        got[bf16] = Rt
    # the bfloat16 decoder moves the iterate: the cast took effect
    assert float((got[True] - got[False]).abs().max()) > 1e-2


NARROW = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
              down_sample_layers=(2,), down_sample_factor=(2,),
              atten_start_layer=2, atten_multi_head_c=8, num_knn=8, n_pcl=64,
              decoder_dims=(96,) * 4, decoder_latent_in=(2,))


def test_decode_matmul_dtype_matches_jax():
    """decode_sdf(matmul_dtype=bfloat16) on a narrow random decoder: in f32
    within 8e-3 of JAX's, two bfloat16 steps at the output's magnitude of
    at most 1 (the frameworks round the bfloat16 products at other places;
    measured one step, 2e-3), with outputs that went through bfloat16, on a
    copy that follows the model's parameters and leaves them as they were;
    in f64 nothing is cast but the query, on both sides, within 1e-12."""
    from livingscenes_tpu_torch.models.shape_prior import slice_codes
    from livingscenes_tpu.models.shape_prior import slice_codes as jslice

    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**NARROW))
    init = jax.jit(jm.init_params, static_argnames="n_points")
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(3), n_points=64))
    rng = np.random.default_rng(4)
    codes = {"z_so3": rng.normal(size=(2, 32, 3)), "z_inv": rng.normal(size=(2, 32)),
             "s": rng.uniform(0.5, 1.5, 2), "t": rng.normal(size=(2, 1, 3)) * 0.1}
    q = rng.uniform(-0.5, 0.5, (2, 300, 3))
    for dtype, jdtype, tol in ((torch.float32, jnp.float32, 8e-3),
                               (torch.float64, jnp.float64, 1e-12)):
        m = ShapePrior(ShapePriorConfig(**NARROW), device="cpu", dtype=dtype)
        m.load_state_dict(params_from_jax(params))
        tc = {k: torch.tensor(v, dtype=dtype) for k, v in codes.items()}
        jc = {k: jnp.asarray(v, jdtype) for k, v in codes.items()}
        jp = jax.tree.map(lambda a: jnp.asarray(a, jdtype), params)
        want = np.asarray(jm.occupancy_logits(jp, jnp.asarray(q, jdtype), jc,
                                              matmul_dtype=jnp.bfloat16))
        with torch.inference_mode():
            got = m.occupancy_logits(torch.tensor(q, dtype=dtype), tc,
                                     matmul_dtype=torch.bfloat16)
            full = m.occupancy_logits(torch.tensor(q, dtype=dtype), tc)
        assert got.dtype == dtype and all(p.dtype == dtype for p in m.parameters())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
        if dtype == torch.float32:
            # the output went through bfloat16, the full-precision one did not
            assert torch.equal(got, got.to(torch.bfloat16).to(dtype))
            assert not torch.equal(full, full.to(torch.bfloat16).to(dtype))
    # the cast copy is reused, and made again when a parameter changes
    cast = m._cast_decoder_state(torch.bfloat16)
    assert m._cast_decoder_state(torch.bfloat16) is cast
    with torch.no_grad():
        m.decoder.lin[0].b.add_(1.0)
    assert m._cast_decoder_state(torch.bfloat16) is not cast
    # slice_codes: an int keeps the batch axis, as JAX's does
    for index in (1, np.array([1, 0])):
        got = slice_codes(tc, index)
        want = jslice(jc, index)
        for k in codes:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
