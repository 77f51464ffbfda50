"""scripts/torch_demo_end2end.py, the port's end-to-end demo, held against
scripts/demo_end2end.py, the JAX package's, on the CPU.

- The scene: make_scene equals the construction of demo_end2end.py (its
  own lines, run here) bit for bit.
- The solve: both packages' load_solver with weights/
  production_r5_selected.ckpt (float32, the fused encoder's config, plain
  versions on the CPU) on that scene at 2 objects, extract_meshes=False:
  matches0 equal, each registration within the tolerance that
  tests/test_torch_port_pipeline.py holds the fused ICP to (rotation 0.5
  degree, translation 1e-2): the two sides sum the ICP statistics in other
  orders.
- main at a coarse mesh (resolution0 8, one upsampling step) writes its
  artifacts.
"""
import argparse
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.eval.run_flyingshape import load_solver as jax_load_solver
from livingscenes_tpu_torch import se3
from livingscenes_tpu_torch.eval.run_flyingshape import load_solver
from livingscenes_tpu_torch.recon.extractor import MeshExtractorConfig
from livingscenes_tpu_torch.solver import MoreSolverConfig
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "weights", "production_r5_selected.ckpt")


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


demo = load_script("torch_demo_end2end")


def jax_scene(objects):
    """The scene as scripts/demo_end2end.py builds it: its own lines, from
    the generator's seed to the permutation."""
    lines = open(os.path.join(ROOT, "scripts", "demo_end2end.py")).read().splitlines()
    start = next(i for i, ln in enumerate(lines) if "default_rng(0)" in ln)
    stop = next(i for i, ln in enumerate(lines) if "rescan = rescan[perm]" in ln)
    body = "\n".join(ln[4:] for ln in lines[start:stop + 1])
    scope = {"np": np, "Rotation": Rotation, "args": argparse.Namespace(objects=objects)}
    exec(body, scope)
    return scope


@pytest.mark.parametrize("objects", [2, 4])
def test_scene_matches_jax(objects):
    objs, rescan, Rm, tm, perm = demo.make_scene(objects)
    want = jax_scene(objects)
    for got, name in ((objs, "objs"), (rescan, "rescan"), (Rm, "Rm"), (tm, "tm"),
                      (perm, "perm")):
        assert got.dtype == want[name].dtype, name
        np.testing.assert_array_equal(got, want[name], err_msg=name)


def test_solve_matches_jax():
    objs, rescan, Rm, tm, perm = demo.make_scene(2)
    out = demo.solve(load_solver(CKPT, device="cpu"), objs, rescan, extract_meshes=False)
    jout = jax_load_solver(CKPT).solve_end2end(
        jnp.asarray(objs), None, jnp.asarray(rescan), None, extract_meshes=False)
    np.testing.assert_array_equal(out["matches0"].numpy(), np.asarray(jout["matches0"]))
    got, want = out["registration"].double(), torch.from_numpy(
        np.asarray(jout["registration"], np.float64))
    assert float(se3.rotation_error(got[:, :3, :3], want[:, :3, :3]).max()) < 0.5
    np.testing.assert_allclose(got[:, :3, 3].numpy(), want[:, :3, 3].numpy(), atol=1e-2)
    # and the demo's own scores: every instance matched and registered
    correct, rre, rte = demo.scores(out, Rm, tm, perm)
    assert all(correct) and max(rre) < 0.5 and max(rte) < 1e-2


def test_main_writes_artifacts(tmp_path, capsys):
    config = MoreSolverConfig(mesh_extractor=MeshExtractorConfig(
        resolution0=8, upsampling_steps=1))
    result = demo.main(["--out", str(tmp_path), "--ckpt", CKPT, "--device", "cpu"],
                       config=config)
    assert all(result["correct"])
    names = sorted(os.path.basename(p) for p in result["paths"])
    assert names == ["matching.png", "recon_0.obj", "recon_1.obj", "recon_2.obj",
                     "recon_3.obj", "registration.png"]
    for p in result["paths"]:
        assert os.path.getsize(p) > 0
    assert open(tmp_path / "matching.png", "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    printed = capsys.readouterr().out
    assert "matching: 4/4 correct" in printed and f"artifacts in {tmp_path}" in printed
