"""The PyTorch port's host meshing (livingscenes_tpu_torch/native, the
port's own build of the same C++) and its Mesh type, held against the JAX
package on the CPU.

The extraction and simplification run the same C++ sources on the same
grids (the port's build leaves out -fopenmp, which the sources do not
use), so vertices and faces are held bit for bit; so is
extract_mesh_from_grid with its stats, also on a field wholly on one side
of the threshold. The copied sources must stay byte-equal to
livingscenes_tpu/native/src. The Mesh methods are held to numpy's
rounding (the same expressions on both sides): equal arrays, equal files.
MeshExtractor, on a sphere field that both sides decode through the same
numpy function: equal faces, vertices within 1e-6 after the code's scale
and translation.
"""
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from livingscenes_tpu.native import bindings as jnative
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.recon.mesh import Mesh as JMesh
from livingscenes_tpu_torch.native import bindings as tnative
from livingscenes_tpu_torch.recon import extractor as text
from livingscenes_tpu_torch.recon.mesh import Mesh as TMesh
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def logit_grid(name, n=49):
    """(n, n, n) occupancy logits (positive inside) over the unit box."""
    c = np.linspace(-0.55, 0.55, n)
    p = np.stack(np.meshgrid(c, c, c, indexing="ij"), axis=-1)
    if name == "sphere":
        v = 0.35 - np.linalg.norm(p, axis=-1)
    elif name == "ellipsoid":
        v = 1.0 - np.linalg.norm((p - [0.05, -0.03, 0.02]) / [0.4, 0.25, 0.3], axis=-1)
    elif name == "torus":
        q = np.stack([np.hypot(p[..., 0], p[..., 1]) - 0.3, p[..., 2]], axis=-1)
        v = 0.12 - np.linalg.norm(q, axis=-1)
    elif name == "inside":
        v = np.full(p.shape[:-1], 3.0)
    else:
        v = np.full(p.shape[:-1], -3.0)
    return (8.0 * v).astype(np.float32)


@pytest.mark.parametrize("name", ["sphere", "ellipsoid", "torus"])
def test_isosurface_and_simplify_bit_equal(name):
    grid = logit_grid(name)
    vt, ft = tnative.marching_isosurface(grid, 0.0)
    vj, fj = jnative.marching_isosurface(grid, 0.0)
    assert vt.dtype == np.float32 and ft.dtype == np.int64 and len(ft) > 1000
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ft, fj)
    for target in (500, 2000):
        st = tnative.simplify_mesh(vt, ft, target)
        sj = jnative.simplify_mesh(vj, fj, target)
        np.testing.assert_array_equal(st[0], sj[0])
        np.testing.assert_array_equal(st[1], sj[1])
        assert len(st[1]) <= target + 2


@pytest.mark.parametrize("name", ["sphere", "ellipsoid", "torus", "inside", "outside"])
@pytest.mark.parametrize("simplify", [5000, 800, None])
def test_extract_mesh_from_grid_bit_equal(name, simplify):
    grid = logit_grid(name)
    st, sj = {}, {}
    mt = text.extract_mesh_from_grid(grid, text.MeshExtractorConfig(simplify_nfaces=simplify),
                                     stats=st)
    mj = jext.extract_mesh_from_grid(grid, jext.MeshExtractorConfig(simplify_nfaces=simplify),
                                     stats=sj)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)
    np.testing.assert_array_equal(mt.faces, mj.faces)
    assert sorted(st) == sorted(sj)
    for key in ("faces_raw", "faces"):
        assert st.get(key) == sj.get(key)
    # the one-sided fields give an empty mesh and no stats
    assert mt.is_empty == (name in ("inside", "outside")) == (not st)


def meshes():
    grid = logit_grid("torus", 33)
    v, f = jnative.marching_isosurface(grid, 0.0)
    return TMesh(v.copy(), f.copy()), JMesh(v.copy(), f.copy())


def test_mesh_methods_match_jax(tmp_path):
    mt, mj = meshes()
    np.testing.assert_array_equal(mt.face_areas(), mj.face_areas())
    np.testing.assert_array_equal(mt.face_normals(), mj.face_normals())
    for normals in (False, True):
        a = mt.sample_surface(5000, seed=3, return_normals=normals)
        b = mj.sample_surface(5000, seed=3, return_normals=normals)
        for x, y in zip(a if normals else [a], b if normals else [b]):
            np.testing.assert_array_equal(x, y)
    tsfm = np.eye(4)
    tsfm[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    tsfm[:3, 3] = [0.5, -0.25, 2.0]
    ct, cj = mt.copy(), mj.copy()
    ct.apply_transform(tsfm).apply_scale_translation(1.7, [0.1, 0.2, 0.3])
    cj.apply_transform(tsfm).apply_scale_translation(1.7, [0.1, 0.2, 0.3])
    np.testing.assert_array_equal(ct.vertices, cj.vertices)
    np.testing.assert_array_equal(mt.vertices, mj.vertices)  # copies are deep
    for kind in ("obj", "ply"):
        pt, pj = tmp_path / f"t.{kind}", tmp_path / f"j.{kind}"
        getattr(mt, f"export_{kind}")(str(pt))
        getattr(mj, f"export_{kind}")(str(pj))
        assert pt.read_bytes() == pj.read_bytes()
    bt, bj = TMesh.placeholder_box(0.8), JMesh.placeholder_box(0.8)
    np.testing.assert_array_equal(bt.vertices, bj.vertices)
    np.testing.assert_array_equal(bt.faces, bj.faces)
    empty = TMesh(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64))
    assert empty.is_empty and not mt.is_empty
    pts, nrm = empty.sample_surface(7, return_normals=True)
    assert pts.shape == nrm.shape == (7, 3) and not pts.any()


@pytest.mark.parametrize("name", ["isosurface.cpp", "simplify.cpp", "kdtree.cpp",
                                  "inside_mesh.cpp", "voxelize.cpp", "rasterize.cpp"])
def test_sources_equal_the_jax_package(name):
    with open(os.path.join(ROOT, "livingscenes_tpu", "native", "src", name), "rb") as f:
        want = f.read()
    assert (tnative.SRC / name).read_bytes() == want
    assert sorted(p.name for p in tnative.SRC.iterdir()) == sorted(tnative.SOURCES)


def test_import_builds_nothing():
    code = ("import livingscenes_tpu_torch.native.bindings as b\n"
            "import livingscenes_tpu_torch.recon, livingscenes_tpu_torch.solver.pipeline\n"
            "assert b._lib is None\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr


def test_build_raises_without_compiler(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tnative.build()
    assert not list(tmp_path.iterdir())


def test_library_name_follows_sources_and_concurrent_builds(tmp_path, monkeypatch):
    """Edited sources get a library of another name; four builds started at
    once into one directory all finish with the same loadable library and
    leave no temporary file."""
    src = tmp_path / "src"
    shutil.copytree(tnative.SRC, src)
    monkeypatch.setattr(tnative, "SRC", src)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    before = tnative.library_path()
    (src / "simplify.cpp").write_bytes((src / "simplify.cpp").read_bytes() + b"\n// edited\n")
    after = tnative.library_path()
    assert before != after and before.parent == after.parent
    paths, errors = [], []

    def one():
        try:
            paths.append(tnative.build())
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    threads = [threading.Thread(target=one) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and paths == [after] * 4
    assert [p.name for p in (tmp_path / "build").iterdir()] == [after.name]
    import ctypes

    assert ctypes.CDLL(str(after)).isosurface_extract


def sphere_logits_np(q, s, t):
    """Occupancy logits of a sphere of radius 0.3 s around t, in float64
    rounded to float32: q (B, M, 3), s (B,), t (B, 1, 3) -> (B, M)."""
    q, s, t = (np.asarray(x, np.float64) for x in (q, s, t))
    return (0.3 * s[:, None] - np.linalg.norm(q - t, axis=-1)).astype(np.float32)


def extractors(**cfg):
    """JAX's MeshExtractor and the port's on the same field (JAX through
    pure_callback, so both see the same values)."""
    import jax
    import jax.numpy as jnp
    import torch

    def jax_fn(q, codes):
        return jax.pure_callback(
            sphere_logits_np, jax.ShapeDtypeStruct(q.shape[:-1], jnp.float32),
            q, codes["s"], codes["t"], vmap_method="sequential")

    def torch_fn(q, codes):
        return torch.from_numpy(sphere_logits_np(q.numpy(), codes["s"].numpy(),
                                                 codes["t"].numpy()))

    return (jext.MeshExtractor(jax_fn, jext.MeshExtractorConfig(**cfg)),
            text.MeshExtractor(torch_fn, text.MeshExtractorConfig(**cfg)))


@pytest.mark.parametrize("simplify", [None, 800])
def test_mesh_extractor_matches_jax(simplify):
    """generate_from_codes and generate_batch: the canonical grid (s = 1,
    t = 0), meshed, then scaled and moved by the code's s and t; equal
    vertices and faces."""
    import jax.numpy as jnp
    import torch

    ej, et = extractors(resolution0=8, upsampling_steps=2, points_batch_size=1000,
                        simplify_nfaces=simplify, threshold=0.55)
    s = np.array([1.3, 0.8], np.float32)
    t = np.array([[[0.2, -0.1, 0.4]], [[-1.0, 0.5, 0.0]]], np.float32)
    mj = ej.generate_batch({"s": jnp.asarray(s), "t": jnp.asarray(t)})
    mt = et.generate_batch({"s": torch.from_numpy(s), "t": torch.from_numpy(t)})
    assert len(mt) == len(mj) == 2
    for a, b in zip(mt, mj):
        assert not a.is_empty
        np.testing.assert_array_equal(a.faces, b.faces)
        np.testing.assert_allclose(a.vertices, b.vertices, rtol=0, atol=1e-6)
    grid, overflow = et.compute_grid({"s": torch.ones(1), "t": torch.zeros((1, 1, 3))})
    assert grid.shape == (33, 33, 33) and overflow.tolist() == [0, 0]


def test_mesh_extractor_overflow_warning_and_refinement(caplog):
    import torch

    _, et = extractors(resolution0=8, upsampling_steps=2, refine_cap_factor=1)
    with caplog.at_level("WARNING"):
        mesh = et.generate_from_codes({"s": torch.ones(1), "t": torch.zeros((1, 1, 3))})
    assert not mesh.is_empty
    assert "cap overflow" in caplog.text
    # refinement_step > 0 returns the refined mesh: the same faces, its
    # vertices moved (tests/test_torch_recon_refine.py holds them to JAX's)
    field = lambda q, c: 20.0 * (0.4 - torch.linalg.norm(q, dim=-1)) + 3.0 * torch.sin(8 * q[..., 0])
    cfg = dict(resolution0=8, upsampling_steps=0, simplify_nfaces=None, refinement_lr=2e-3)
    codes = {"s": torch.ones(1), "t": torch.zeros((1, 1, 3))}
    plain = text.MeshExtractor(field, text.MeshExtractorConfig(**cfg)).generate_from_codes(codes)
    refined = text.MeshExtractor(field, text.MeshExtractorConfig(
        refinement_step=3, **cfg)).generate_from_codes(codes)
    np.testing.assert_array_equal(refined.faces, plain.faces)
    assert np.isfinite(refined.vertices).all()
    assert 1e-4 < np.abs(refined.vertices - plain.vertices).max() < 0.05
