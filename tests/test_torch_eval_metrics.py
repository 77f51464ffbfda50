"""The PyTorch port's registration helpers (se3.py), host geometry
(native/bindings.py `KDTree`, `check_mesh_contains`, `voxelize_mesh`), host
IO (utils/io.py), evaluation metrics (eval/metrics.py, eval/mesh_eval.py)
and ICP's early exit (ops/icp.py) held against the JAX package on the CPU,
on the same seeded numpy inputs.

Tolerances: integer and boolean outputs equal; floats to 1e-10 in f64; a
metric that samples a mesh (in its float32 vertices) to 1e-5 relative.
`random_rotation` draws from a torch.Generator, not a JAX key, so it is
held to what it must be: from_xyzquat of the normalised Gaussian drawn
from the same generator, a proper rotation. ICP with early_exit=True
from torch_threads import intra_op_share  # noqa: F401 (autouse)
equals the fixed loop bit for bit (both refits) and stops once every pair
is frozen; against JAX's early_exit=True on the Kabsch refit in f64 it
holds tests/test_torch_port_icp.py's tolerances (R and t to 1e-6, rmse
rtol 1e-8, converged equal).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial.transform import Rotation

from livingscenes_tpu import se3 as jse3
from livingscenes_tpu.eval import mesh_eval as jmesh_eval
from livingscenes_tpu.eval import metrics as jmetrics
from livingscenes_tpu.native import bindings as jnative
from livingscenes_tpu.ops.icp import iterative_closest_point as jicp
from livingscenes_tpu.recon.mesh import Mesh as JMesh
from livingscenes_tpu.utils import io as jio
from livingscenes_tpu_torch import se3
from livingscenes_tpu_torch.eval import mesh_eval, metrics
from livingscenes_tpu_torch.native import bindings as native
from livingscenes_tpu_torch.ops import icp as ticp
from livingscenes_tpu_torch.recon.mesh import Mesh
from livingscenes_tpu_torch.utils import io

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = dict(rtol=1e-10, atol=1e-12)
SAMPLED = dict(rtol=1e-5, atol=0)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def poses(rng, B):
    """(B, 4, 4) rigid transforms."""
    g = np.tile(np.eye(4), (B, 1, 1))
    g[:, :3, :3] = Rotation.random(B, random_state=int(rng.integers(1 << 30))).as_matrix()
    g[:, :3, 3] = rng.normal(size=(B, 3))
    return g


def test_transform_helpers_match_jax():
    rng = np.random.default_rng(0)
    a, b = poses(rng, 5), poses(rng, 5)
    np.testing.assert_array_equal(se3.identity(4, torch.float64).numpy(),
                                  np.asarray(jse3.identity(4, jnp.float64)))
    np.testing.assert_allclose(se3.concatenate(t(a), t(b[:, :3])).numpy(),
                               np.asarray(jse3.concatenate(a, b[:, :3])), **F64)
    np.testing.assert_array_equal(se3.to_4x4(t(a[:, :3])).numpy(),
                                  np.asarray(jse3.to_4x4(a[:, :3])))
    assert se3.to_4x4(t(a)).shape == (5, 4, 4)
    f1, f2 = rng.normal(size=(2, 5, 40, 3))
    np.testing.assert_allclose(se3.solve_rotation(t(f1), t(f2)).numpy(),
                               np.asarray(jse3.solve_rotation(f1, f2)), **F64)
    code1 = {"z_so3": rng.normal(size=(5, 16, 3)), "t": rng.normal(size=(5, 1, 3))}
    code2 = {"z_so3": rng.normal(size=(5, 16, 3)), "t": rng.normal(size=(5, 1, 3))}
    got = se3.solve_transform_from_latent({k: t(v) for k, v in code1.items()},
                                          {k: t(v) for k, v in code2.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jse3.solve_transform_from_latent(code1, code2)), **F64)
    xyzquat = rng.normal(size=(6, 7))
    np.testing.assert_allclose(se3.from_xyzquat(t(xyzquat)).numpy(),
                               np.asarray(jse3.from_xyzquat(xyzquat)), **F64)


def test_registration_errors_match_jax():
    rng = np.random.default_rng(1)
    pc1, pc2 = rng.normal(size=(3, 96, 3)), rng.normal(size=(3, 80, 3))
    pred, gt = poses(rng, 3), poses(rng, 3)
    for i in range(3):
        one = slice(i, i + 1)
        np.testing.assert_allclose(
            float(se3.compute_transformation_error(t(pc1[one]), t(pc2[one]),
                                                   t(pred[one]), t(gt[one]))),
            float(jse3.compute_transformation_error(pc1[one], pc2[one], pred[one],
                                                    gt[one])), **F64)
    np.testing.assert_allclose(
        se3.chamfer_distance_under_transforms(t(pc1), t(pc2), t(pred), t(gt)).numpy(),
        np.asarray(jse3.chamfer_distance_under_transforms(pc1, pc2, pred, gt)), **F64)
    # at the eval's shape: 1024 x 1024 points, f32 on both sides
    x, y = rng.normal(size=(2, 1, 1024, 3)).astype(np.float32)
    p32, g32 = pred[:1].astype(np.float32), gt[:1].astype(np.float32)
    np.testing.assert_allclose(
        se3.chamfer_distance_under_transforms(t(x), t(y), t(p32), t(g32)).numpy(),
        np.asarray(jse3.chamfer_distance_under_transforms(x, y, p32, g32)), rtol=1e-5)


def test_robust_weights_match_jax():
    x = np.abs(np.random.default_rng(2).normal(scale=0.05, size=200))
    x[:3] = [0.0, 0.02, 0.0200001]
    np.testing.assert_allclose(se3.huber_norm_weights(t(x)).numpy(),
                               np.asarray(jse3.huber_norm_weights(x)), **F64)
    res = np.random.default_rng(3).normal(scale=0.05, size=(4, 50))
    for got, want in zip(se3.get_robust_res(t(res), 0.03), jse3.get_robust_res(res, 0.03)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F64)


def test_random_rotation_from_generator():
    R = se3.random_rotation(torch.Generator().manual_seed(4), (3, 5), torch.float64)
    q = torch.randn((3, 5, 4), generator=torch.Generator().manual_seed(4),
                    dtype=torch.float64)
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    want = se3.from_xyzquat(torch.cat([torch.zeros(3, 5, 3, dtype=torch.float64), q], -1))
    assert torch.equal(R, want[..., :3, :3])
    eye = torch.eye(3, dtype=torch.float64).expand(3, 5, 3, 3)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, rtol=0, atol=1e-12)
    torch.testing.assert_close(torch.linalg.det(R), torch.ones(3, 5, dtype=torch.float64))


def sphere_mesh(center=(0.0, 0.0, 0.0), radius=0.4, res=24):
    """A closed triangle mesh of a sphere (the port's marching)."""
    axis = np.linspace(-0.6, 0.6, res)
    g = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1)
    v, f = native.marching_isosurface(
        (np.linalg.norm(g, axis=-1) - radius).astype(np.float32), 0.0)
    return (v / (res - 1) * 1.2 - 0.6 + np.asarray(center)).astype(np.float32), f


@pytest.fixture(scope="module")
def meshes():
    """Two overlapping closed meshes, as (port Mesh, JAX Mesh) pairs."""
    out = []
    for center, radius in (((0.0, 0.0, 0.0), 0.4), ((0.1, -0.05, 0.0), 0.35)):
        v, f = sphere_mesh(center, radius)
        out.append((Mesh(v, f), JMesh(v.copy(), f.copy())))
    return out


def test_native_geometry_matches_jax(meshes):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(3000, 3)).astype(np.float32)
    q = rng.normal(size=(20000, 3)).astype(np.float32)
    for k in (1, 4):
        got, want = native.KDTree(pts).query(q, k=k), jnative.KDTree(pts).query(q, k=k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    # k past the point count: inf and -1 in the missing slots
    d, i = native.KDTree(pts[:3]).query(q[:5], k=5)
    assert np.isinf(d[:, 3:]).all() and (i[:, 3:] == -1).all()
    (m, _), _ = meshes
    inside = rng.uniform(-0.6, 0.6, size=(20000, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        native.check_mesh_contains(m.vertices, m.faces, inside),
        jnative.check_mesh_contains(m.vertices, m.faces, inside))
    np.testing.assert_array_equal(native.voxelize_mesh(m.vertices, m.faces, 16),
                                  jnative.voxelize_mesh(m.vertices, m.faces, 16))


def test_metrics_match_jax(meshes):
    (a, ja), (b, jb) = meshes
    gt = b.sample_surface(5000, seed=3)
    for got, want in zip(metrics.compute_chamfer_distance(gt, a),
                         jmetrics.compute_chamfer_distance(gt, ja)):
        np.testing.assert_allclose(got, want, **SAMPLED)
    assert metrics.compute_volumetric_iou(a, b) == jmetrics.compute_volumetric_iou(ja, jb)
    np.testing.assert_allclose(metrics.volumetric_iou_sampled(a, b, n_samples=20000),
                               jmetrics.volumetric_iou_sampled(ja, jb, n_samples=20000),
                               **SAMPLED)
    for thres in (0.02, 0.1):
        np.testing.assert_allclose(metrics.compute_sdf_recall(a, b, thres),
                                   jmetrics.compute_sdf_recall(ja, jb, thres), **SAMPLED)
    src, tgt = a.sample_surface(3000, seed=1), b.sample_surface(2000, seed=2)
    np.testing.assert_array_equal(metrics.distance_p2p(src, tgt),
                                  jmetrics.distance_p2p(src, tgt))
    np.testing.assert_allclose(metrics.f_score(src, tgt, 0.05),
                               jmetrics.f_score(src, tgt, 0.05), **SAMPLED)
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert metrics.compute_volumetric_iou(a, empty) == 0.0
    assert metrics.volumetric_iou_sampled(empty, a) == 0.0
    assert metrics.compute_sdf_recall(a, empty) == 0.0


def test_mesh_evaluator_matches_jax(meshes):
    (a, ja), (b, jb) = meshes
    rng = np.random.default_rng(6)
    tgt, tgt_n = b.sample_surface(4000, seed=4, return_normals=True)
    points_iou = rng.uniform(-0.6, 0.6, size=(5000, 3))
    occ = (np.linalg.norm(points_iou - [0.1, -0.05, 0.0], axis=-1) < 0.35).astype(np.float32)
    got = mesh_eval.MeshEvaluator(n_points=6000).eval_mesh(
        a, tgt, tgt_n, points_iou=points_iou, occ_tgt=occ)
    want = jmesh_eval.MeshEvaluator(n_points=6000).eval_mesh(
        ja, tgt, tgt_n, points_iou=points_iou, occ_tgt=occ)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **SAMPLED, err_msg=key)
    # without normals, and an empty mesh
    got = mesh_eval.MeshEvaluator(n_points=3000).eval_mesh(a, tgt)
    want = jmesh_eval.MeshEvaluator(n_points=3000).eval_mesh(ja, tgt)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], **SAMPLED, err_msg=key)
    empty = Mesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    got = mesh_eval.MeshEvaluator().eval_mesh(empty, tgt, points_iou=points_iou)
    assert got["iou"] == 0.0 and np.isnan(got["chamfer_l2"])
    dist, dot = mesh_eval.distance_p2p_with_normals(tgt[:50], tgt_n[:50], tgt, None)
    np.testing.assert_array_equal(dist, jmesh_eval.distance_p2p_with_normals(
        tgt[:50], tgt_n[:50], tgt, None)[0])
    assert np.isnan(dot).all()


def test_io_matches_jax(tmp_path, meshes):
    (a, _), _ = meshes
    a.export_ply(str(tmp_path / "mesh.ply"))
    pts = np.random.default_rng(7).normal(size=(50, 3)).astype(np.float32)
    with open(tmp_path / "ascii.ply", "w") as f:
        f.write("ply\nformat ascii 1.0\nelement vertex 50\nproperty float x\n"
                "property float y\nproperty float z\nproperty uchar red\n"
                "element face 2\nproperty list uchar int vertex_indices\nend_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]} 7\n")
        f.write("3 0 1 2\n3 2 3 4\n")
    for name in ("mesh.ply", "ascii.ply"):
        got, want = io.load_ply(str(tmp_path / name)), jio.load_ply(str(tmp_path / name))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    (tmp_path / "list.txt").write_text("a\n\n  b  \nc\n")
    assert io.read_list_from_txt(str(tmp_path / "list.txt")) == ["a", "b", "c"]
    (tmp_path / "x.json").write_text('{"k": [1, 2.5, "s"]}')
    assert io.load_json(str(tmp_path / "x.json")) == jio.load_json(str(tmp_path / "x.json"))
    cfg = os.path.join(ROOT, "configs", "production_r5.yaml")
    with open(cfg) as f:
        assert io.load_yaml(cfg) == yaml.safe_load(f)


def pose_problem(rng, B=4, N=150, dtype=np.float64, exact_last=False):
    """Pairs a small rotation apart, with noise, as in
    tests/test_torch_port_icp.py; with `exact_last` the last pair an exact
    copy, whose RMSE ends at round-off."""
    src = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * [1.0, 0.7, 0.4]
    R = Rotation.from_rotvec(rng.normal(scale=0.15, size=(B, 3))).as_matrix()
    tgt = np.einsum("bij,bnj->bni", R, src) + rng.normal(scale=0.05, size=(B, 1, 3))
    noisy = slice(0, B - 1) if exact_last else slice(0, B)
    tgt[noisy] += rng.normal(scale=0.01, size=tgt[noisy].shape)
    return src.astype(dtype), tgt.astype(dtype)


@pytest.mark.parametrize("fused", [False, True])
def test_icp_early_exit_equals_the_fixed_loop(fused, monkeypatch):
    src, tgt = pose_problem(np.random.default_rng(8),
                            dtype=np.float32 if fused else np.float64, exact_last=True)
    calls = []
    stats, sqdist = ticp.icp_iteration_stats, ticp.pairwise_sqdist
    monkeypatch.setattr(ticp, "icp_iteration_stats",
                        lambda *a, **k: calls.append(1) or stats(*a, **k))
    monkeypatch.setattr(ticp, "pairwise_sqdist",
                        lambda *a, **k: calls.append(1) or sqdist(*a, **k))
    fixed = ticp.iterative_closest_point(t(src), t(tgt), max_iterations=100,
                                         fused_stats=fused)
    assert len(calls) == 100
    calls.clear()
    early = ticp.iterative_closest_point(t(src), t(tgt), max_iterations=100,
                                         fused_stats=fused, early_exit=True)
    assert bool(fixed.converged.all()) and len(calls) < 100
    for a, b in zip(early, fixed):
        assert torch.equal(a, b)


def test_icp_early_exit_matches_jax_f64():
    src, tgt = pose_problem(np.random.default_rng(9))
    rj = jicp(jnp.asarray(src), jnp.asarray(tgt), max_iterations=100,
              fused_stats=False, early_exit=True)
    rt = ticp.iterative_closest_point(t(src), t(tgt), max_iterations=100,
                                      fused_stats=False, early_exit=True)
    assert bool(rt.converged.all())
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-6)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-6)
    np.testing.assert_allclose(rt.rmse.numpy(), np.asarray(rj.rmse), rtol=1e-8)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
