"""The PyTorch port's matchers (solver/matcher.py: the five matchers and
`solve_object_matching`) and the dustbin transport (ops/sinkhorn.py
`log_optimal_transport`) held against the JAX package on the CPU in f64, on
random codes with masks and with built ties (z_inv rows of exact cosines,
one of them duplicated, and a duplicated z_so3 row, whose Kabsch residuals
are equal). Matches must be equal as integers, the transport to 1e-10
relative. Also: the port imports nothing of JAX or of the JAX package.

A tie is only a test of the tie rules if both sides see it: each built tie
is asserted to be exact on both sides before the matches are compared.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.ops import sinkhorn as jsink
from livingscenes_tpu.solver import matcher as jmatch
from livingscenes_tpu_torch.ops import sinkhorn as tsink
from livingscenes_tpu_torch.solver import matcher as tmatch
from torch_threads import intra_op_share  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, T, C = 7, 6, 16
METHODS = ("sequential", "nn", "sinkhorn", "sim3_seq", "eq_seq")


def ternary(rng, n):
    """n rows of C entries in {-1, 0, 1} with four nonzeros each: their
    norms are 2 and their cosines multiples of 1/4, exact in any order of
    summation, so that equal scores tie exactly on both sides."""
    z = np.zeros((n, C))
    for row in z:
        row[rng.choice(C, 4, replace=False)] = rng.choice([-1.0, 1.0], 4)
    return z


def make_codes(seed, ties=False, masked=False):
    """Random (src, tgt) codes, tgt noisy copies of a permutation of src,
    and (S,), (T,) masks or None. With `ties`: z_inv ternary (many exact
    ties in the scores) and src row 4 a copy of row 1 in z_inv and z_so3
    (equal rows of scores and of Kabsch residuals: duplicated tgt rows
    would not do, XLA's batched fits differ in the last bit between
    lanes); with `masked` src row 6 and tgt row 3 are out."""
    rng = np.random.default_rng(seed)

    def codes(n):
        return {"z_inv": rng.normal(size=(n, C)), "z_so3": rng.normal(size=(n, C, 3)),
                "s": rng.uniform(0.5, 1.5, size=(n,)), "t": rng.normal(size=(n, 1, 3))}

    src, tgt = codes(S), codes(T)
    perm = rng.permutation(S)[:T]
    tgt["z_so3"] = src["z_so3"][perm] + 0.1 * rng.normal(size=(T, C, 3))
    if ties:
        src["z_inv"] = ternary(rng, S)
        tgt["z_inv"] = src["z_inv"][perm].copy()
        for row in tgt["z_inv"]:  # move one nonzero of each row
            on, off = np.flatnonzero(row), np.flatnonzero(row == 0)
            row[rng.choice(off)], row[rng.choice(on)] = 1.0, 0.0
        for k in ("z_inv", "z_so3"):
            src[k][4] = src[k][1]
    else:
        tgt["z_inv"] = src["z_inv"][perm] + 0.3 * rng.normal(size=(T, C))
    masks = (None, None)
    if masked:
        masks = (np.arange(S) != 6, np.arange(T) != 3)
    return src, tgt, masks


def to_jnp(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def to_torch(d):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def opt(m, fn):
    return None if m is None else fn(m)


def run_both(method, src, tgt, masks):
    jm = tuple(opt(m, jnp.asarray) for m in masks)
    tm = tuple(opt(m, torch.from_numpy) for m in masks)
    want = jmatch.solve_object_matching(to_jnp(src), to_jnp(tgt), method, *jm)
    got = tmatch.solve_object_matching(to_torch(src), to_torch(tgt), method, *tm)
    return got, want


def assert_matches_equal(got, want):
    for key in ("matches0", "matches1"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


# (method, seed, ties, masked); the sinkhorn matcher takes no masks
CASES = [(method, seed, ties, masked) for method in METHODS
         for seed, ties, masked in ((0, False, False), (1, True, False),
                                    (2, False, True), (3, True, True))
         if not (method == "sinkhorn" and masked)]


@pytest.mark.parametrize("method,seed,ties,masked", CASES)
def test_matcher_matches_jax(method, seed, ties, masked):
    src, tgt, masks = make_codes(seed, ties, masked)
    got, want = run_both(method, src, tgt, masks)
    assert_matches_equal(got, want)
    m0 = got["matches0"].numpy()
    assert (m0 >= 0).any()
    if masked:
        assert m0[6] == -1 and got["matches1"].numpy()[3] == -1


def test_built_ties_are_exact_on_both_sides():
    """The scores of the tie cases tie exactly on both sides: src rows 1 and
    4 give equal rows of cosines and of Kabsch residuals, and the largest
    cosine occurs more than once, so that the greedy order is the tie
    rule's (the first index of the flattened scores)."""
    src, tgt, _ = make_codes(1, ties=True)
    z_s, z_t = (torch.from_numpy(c["z_inv"]) for c in (src, tgt))
    score = tmatch._l2_normalize(z_s) @ tmatch._l2_normalize(z_t).T
    score_j = np.asarray(jmatch._l2_normalize(jnp.asarray(src["z_inv"]))
                         @ jmatch._l2_normalize(jnp.asarray(tgt["z_inv"])).T)
    np.testing.assert_array_equal(score.numpy(), score_j)
    res = tmatch._kabsch_residual_matrix(*(torch.from_numpy(c["z_so3"]) for c in (src, tgt)))
    res_j = np.asarray(jmatch._kabsch_residual_matrix(
        jnp.asarray(src["z_so3"]), jnp.asarray(tgt["z_so3"])))
    for sc, r in ((score.numpy(), res.numpy()), (score_j, res_j)):
        assert np.array_equal(sc[1], sc[4]) and np.array_equal(r[1], r[4])
        assert (sc == sc.max()).sum() > 1
    # a matrix of exact ties: the greedy order is row-major
    out = tmatch._greedy_assign(torch.zeros((1, 3, 4), dtype=torch.float64))
    want = jmatch._greedy_assign(jnp.zeros((3, 4)), None, None)
    np.testing.assert_array_equal(out["matches0"][0].numpy(), np.asarray(want["matches0"]))
    np.testing.assert_array_equal(out["matches0"][0].numpy(), [0, 1, 2])


def test_kabsch_residual_matrix_matches_jax():
    src, tgt, _ = make_codes(4, ties=True)
    got = tmatch._kabsch_residual_matrix(torch.from_numpy(src["z_so3"]),
                                         torch.from_numpy(tgt["z_so3"]))
    want = jmatch._kabsch_residual_matrix(jnp.asarray(src["z_so3"]), jnp.asarray(tgt["z_so3"]))
    assert got.shape == (S, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12)


def test_sequential_matcher_scene_batched_form():
    """The scene-batched form (P, S, C) equals the per-scene calls and the
    JAX matcher of each scene."""
    rng = np.random.default_rng(5)
    zs, zt = rng.normal(size=(3, S, C)), rng.normal(size=(3, T, C))
    ms, mt = rng.random((3, S)) > 0.2, rng.random((3, T)) > 0.2
    out = tmatch.sequential_matcher(*(torch.from_numpy(a) for a in (zs, zt, ms, mt)))
    for p in range(3):
        want = jmatch.sequential_matcher(*(jnp.asarray(a[p]) for a in (zs, zt, ms, mt)))
        one = tmatch.sequential_matcher(*(torch.from_numpy(a[p]) for a in (zs, zt, ms, mt)))
        for key in ("matches0", "matches1"):
            np.testing.assert_array_equal(out[key][p].numpy(), np.asarray(want[key]))
            np.testing.assert_array_equal(one[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("shape,alpha,iters", [((1, 7, 6), 1.0, 100), ((2, 5, 9), 0.3, 20),
                                                ((3, 4, 4), -0.5, 1)])
def test_log_optimal_transport_matches_jax(shape, alpha, iters):
    scores = np.random.default_rng(6).normal(size=shape)
    got = tsink.log_optimal_transport(torch.from_numpy(scores), alpha, iters)
    want = jsink.log_optimal_transport(jnp.asarray(scores), jnp.asarray(alpha), iters)
    assert got.shape == (shape[0], shape[1] + 1, shape[2] + 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=0)


def test_unknown_method_raises():
    src, tgt, _ = make_codes(0)
    with pytest.raises(ValueError, match="unknown matching method"):
        tmatch.solve_object_matching(to_torch(src), to_torch(tgt), "hungarian")


def _imports(path):
    """The top-level names of the modules a file imports (absolute
    imports only; relative imports stay inside the file's package)."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    """Every module of the port (the eval, render, preprocessing, binvox, viz
    and debugging modules named), chip_smoke.py and
    the port's scripts/torch_*.py, named in their source and imported in a
    fresh interpreter in which jax and the JAX package cannot be
    imported."""
    pkg = os.path.join(ROOT, "livingscenes_tpu_torch")
    # the port's scripts: chip_smoke.py and scripts/torch_*.py
    scripts = sorted(os.path.join(ROOT, "scripts", n)
                     for n in os.listdir(os.path.join(ROOT, "scripts"))
                     if n.startswith("torch_") and n.endswith(".py"))
    files = [os.path.join(ROOT, "chip_smoke.py")] + scripts
    modules = []
    for dirpath, _, names in os.walk(pkg):
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                files.append(path)
                rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                modules.append(rel[:-len(".__init__")] if rel.endswith("__init__") else rel)
    banned = {"jax", "jaxlib", "flax", "optax", "livingscenes_tpu"}
    for path in files:
        found = banned & set(_imports(path))
        assert not found, f"{path} imports {found}"
    assert len(modules) > 30
    for name in ("se3", "utils.io", "native.bindings", "eval", "eval.metrics",
                 "eval.mesh_eval", "eval.flyingshape", "eval.rescan3r",
                 "eval.run_flyingshape", "eval.run_3rscan", "recon.render",
                 "tools", "tools.preprocess", "utils.binvox", "utils.viz",
                 "utils.debugging", "parallel", "parallel.sharding"):
        assert f"livingscenes_tpu_torch.{name}" in modules, name
    code = ("import sys\n"
            f"for name in {sorted(banned)!r}:\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {modules!r}:\n"
            "    importlib.import_module(m)\n"
            "import chip_smoke\n"
            "import importlib.util\n"
            f"for path in {scripts!r}:\n"
            "    spec = importlib.util.spec_from_file_location('script', path)\n"
            "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(banned)!r} and sys.modules[m] is not None]\n"
            "assert not bad, bad\n"
            "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.startswith("ok")
