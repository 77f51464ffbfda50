"""scripts/torch_profile_simplify.py held against scripts/profile_simplify.py
on the CPU:

- the grid of a seed equals the JAX script's make_grid (its own function,
  run here) bit for bit at 33^3: both evaluate the same numpy SDF of the
  same draws;
- the script's extraction gives the vertices and faces of the JAX
  package's extract_mesh_from_grid through its native bindings, bit for
  bit (the two native builds compile byte-equal sources);
- the script, run as a program at its 129^3 grids, prints a line for each
  grid and the means, and the native phase line of each simplification.
"""
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from livingscenes_tpu.recon.extractor import (
    MeshExtractorConfig as JaxMeshExtractorConfig, extract_mesh_from_grid)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 33
TARGET = 400  # a 33^3 shape has some thousands of faces: simplified


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


profile = load_script("torch_profile_simplify")


def jax_make_grid():
    """make_grid of scripts/profile_simplify.py: its own source, run here
    (importing the script would set LSTPU_SIMPLIFY_PROFILE for the
    process)."""
    text = open(os.path.join(ROOT, "scripts", "profile_simplify.py")).read()
    start = text.index("def make_grid(")
    scope = {"np": np}
    exec(text[start:text.index("\ndef ", start + 1)], scope)
    return scope["make_grid"]


@pytest.mark.parametrize("seed", [100, 103])
def test_grid_and_mesh_match_jax(seed):
    grid = profile.make_grid(seed, N)
    want = jax_make_grid()(seed, N)
    assert grid.dtype == want.dtype == np.float32 and grid.shape == (N, N, N)
    np.testing.assert_array_equal(grid, want)
    st = profile.profile_grid(grid, TARGET)
    assert st["faces_raw"] > TARGET and st["faces"] <= TARGET
    mesh = st["mesh"]
    jmesh = extract_mesh_from_grid(want, JaxMeshExtractorConfig(simplify_nfaces=TARGET))
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    np.testing.assert_array_equal(mesh.faces, jmesh.faces)


def test_main_prints_the_profile():
    # a process of its own: the native library reads LSTPU_SIMPLIFY_PROFILE
    # once, at its first simplification
    env = {k: v for k, v in os.environ.items() if k != "LSTPU_SIMPLIFY_PROFILE"}
    done = subprocess.run(
        [sys.executable, os.path.join(ROOT, "scripts", "torch_profile_simplify.py"),
         "--n", "2", "--chamfer"], capture_output=True, text=True, env=env, timeout=300)
    assert done.returncode == 0, done.stderr[-4000:]
    out = done.stdout
    assert out.count("grid ") == 2 and "\nmean: total" in out, out
    chamfers = [float(c) for c in re.findall(r"^grid .* chamfer ([0-9.]+)$", out, re.M)]
    assert len(chamfers) == 2 and all(0 < c < 2.0 / 129 for c in chamfers), out
    phases = re.findall(r"^\[simplify\] nf=\d+ target=5000 init=[0-9.]+ms run=[0-9.]+ms "
                        r"\(prepass=[0-9.]+ms seed=[0-9.]+ms heap=[0-9.]+ms,.*output=",
                        done.stderr, re.M)
    assert len(phases) == 2, done.stderr[-4000:]
