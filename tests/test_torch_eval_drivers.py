"""The PyTorch port's evaluation drivers (eval/flyingshape.py,
eval/rescan3r.py, eval/run_flyingshape.py, eval/run_3rscan.py) held
against the JAX package's on the CPU, on the FlyingShape and 3RScan
fixture trees of tests/test_eval_drivers.py (imported from there, so the
trees are the same), with its small encoder and its f64 weights carried
across by params_from_jax. Both sides pin the plain refits: the JAX model
with parity=True (its XLA path), both solvers with icp_fused=False (the
Kabsch ICP refit), and 5 steps of code optimisation. JAX's readers hand
the solver float32 clouds, and its ICP then runs in float32; the port's
solver carries clouds in the model's precision. So the JAX side gets the
same clouds in float64 (`jax_f64`), and both run in float64 throughout.

Tolerances: recalls equal; every median and mean to 1e-6 relative, or
absolutely to the float64 round-off of an exact registration (ATOL): the
fixture's rescans are exact rigid copies, so their registration errors
(a chamfer near 1e-14) are round-off, where no relative tolerance holds.
The fixture's weights give a field of one sign in the whole box, hence no
mesh; the last decoder layer's bias is moved by the median of the field
over the fixture's instances (`params`) so that the reconstruction loops
score meshes. It changes no code, so matching and relocalization are the
fixture's. Also:
the dataset readers give the same arrays; `encode_fps(n_fps=3)` equals
JAX's in f64 (codes to 1e-10) given the start points JAX draws, which the
test reproduces with jax.random.split and jax.random.categorical; the
command lines run end to end on the CPU, `load_solver` reads a flax
checkpoint, a reference torch checkpoint (strictly) or none, and pins
icp_accept="always" with parity; `verify_conversion` passes a clean
round trip and rejects a dropped and a lossy tensor.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.eval import flyingshape as jfs
from livingscenes_tpu.eval import rescan3r as jrs
from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.recon.mesh import Mesh as JMesh
from livingscenes_tpu.solver import code_optim as jco
from livingscenes_tpu.solver import more as jmore
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.eval import flyingshape as tfs
from livingscenes_tpu_torch.eval import rescan3r as trs
from livingscenes_tpu_torch.eval import run_3rscan, run_flyingshape
from livingscenes_tpu_torch.models import convert
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.recon import extractor as text
from livingscenes_tpu_torch.recon.mesh import Mesh
from livingscenes_tpu_torch.solver import code_optim as tco
from livingscenes_tpu_torch.solver import more as tmore
from livingscenes_tpu_torch.solver import registration as treg
from test_eval_drivers import SMALL, flyingshape_dir, rescan_dir  # noqa: F401
from torch_threads import intra_op_share  # noqa: F401 (autouse)

# the refinement (optim=True, in the --parity run only) for 2 steps
REG = dict(use_icp=True, icp_iterations=10, icp_fused=False, n_steps=2,
           lr_milestones=(1,))
MESH = dict(resolution0=8, upsampling_steps=0, simplify_nfaces=None)
CODE_STEPS = 5
RTOL = 1e-6
# Absolute floors at the float64 round-off of an exact registration, by the
# key's quantity: squared distances (m^2), an arccos near 0 (degrees),
# distances (m, cm). Every other key: relative only.
ATOL = {"chamfer": 1e-12, "rre": 1e-6, "rte": 1e-8, "te_cm": 1e-6}
CUBE_V = np.array([[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0)
                   for z in (-1.0, 1.0)], np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 7, 5], [4, 6, 7], [0, 5, 1],
                   [0, 4, 5], [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4],
                   [1, 5, 7], [1, 7, 3]], np.int64)


def small_config():
    return ShapePriorConfig(**{f.name: getattr(SMALL, f.name)
                               for f in dataclasses.fields(ShapePriorConfig)})


@pytest.fixture(scope="module")
def params(flyingshape_dir):
    """The f64 weights of tests/test_eval_drivers.py's solver, the last
    decoder layer's bias less the median of the field over the meshing box
    of the FlyingShape fixture's first scan."""
    model = jsp.ShapePrior(SMALL)
    p = jax.jit(model.init_params)(jax.random.PRNGKey(0))
    p = jax.tree.map(lambda x: np.asarray(x, np.float64), p)
    port = port_solver(p)
    codes = port.encode_instances(tfs.FlyingShapeDataset(flyingshape_dir)[0][0]["pc"])
    axis = torch.linspace(-0.55, 0.55, 8, dtype=torch.float64)
    grid = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(1, -1, 3)
    canonical = dict(codes, s=torch.ones_like(codes["s"]), t=torch.zeros_like(codes["t"]))
    with torch.no_grad():
        field = port.model.decode_sdf(grid.expand(codes["s"].shape[0], -1, -1), canonical)
    last = max(p["decoder"], key=lambda name: int(name[3:]))
    p["decoder"][last]["bias"] = p["decoder"][last]["bias"] - float(field.median())
    return p


def port_solver(params, **changes):
    model = ShapePrior(small_config(), device="cpu", dtype=torch.float64)
    model.load_state_dict(params_from_jax(params))
    cfg = tmore.MoreSolverConfig(
        n_input_point=128, registration=treg.RegistrationConfig(**REG),
        mesh_extractor=text.MeshExtractorConfig(**MESH),
        code_optim=tco.CodeOptimConfig(n_steps=CODE_STEPS))
    return tmore.MoreSolver(model, dataclasses.replace(cfg, **changes))


@pytest.fixture(scope="module")
def solvers(params):
    """(JAX, port) MoreSolver on the same weights and settings."""
    jcfg = jmore.MoreSolverConfig(
        n_input_point=128, registration=jreg.RegistrationConfig(**REG),
        mesh_extractor=jext.MeshExtractorConfig(**MESH),
        code_optim=jco.CodeOptimConfig(n_steps=CODE_STEPS))
    jm = jsp.ShapePrior(dataclasses.replace(SMALL, parity=True))
    jsolver = jmore.MoreSolver(jm, jax.tree.map(jnp.asarray, params), jcfg)
    return jsolver, port_solver(params)


class JaxF64FlyingShape(jfs.FlyingShapeDataset):
    """JAX's FlyingShape reader with the clouds in float64."""

    def __getitem__(self, idx):
        scans = super().__getitem__(idx)
        for scan in scans:
            scan["pc"] = scan["pc"].astype(np.float64)
        return scans


@pytest.fixture
def jax_f64(monkeypatch):
    """JAX's 3RScan batches (heterogeneous_batching) in float64."""
    real = jrs.heterogeneous_batching

    def batching(*args, **kw):
        pc, mask = real(*args, **kw)
        return pc.astype(np.float64), mask

    monkeypatch.setattr(jrs, "heterogeneous_batching", batching)


def assert_results_match(got, want):
    """Recalls equal, every other number to RTOL relative or ATOL."""
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if w is None or g is None:
            assert g is None and w is None, key
        elif "recall" in key:
            assert g == w, (key, g, w)
        else:
            atol = next((v for k, v in ATOL.items() if k in key), 0.0)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=atol, err_msg=key)


def test_flyingshape_dataset_reader(flyingshape_dir):
    got, want = tfs.FlyingShapeDataset(flyingshape_dir), jfs.FlyingShapeDataset(flyingshape_dir)
    assert got.scene_dirs == want.scene_dirs
    for g, w in zip(got[0], want[0]):
        assert set(g) == set(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key])


def test_flyingshape_matching(flyingshape_dir, solvers):
    jsolver, tsolver = solvers
    want = jfs.eval_matching(JaxF64FlyingShape(flyingshape_dir), jsolver)
    got = tfs.eval_matching(tfs.FlyingShapeDataset(flyingshape_dir), tsolver)
    assert got == want
    assert got["object_recall"] == 100.0


def test_flyingshape_relocalization(flyingshape_dir, solvers):
    jsolver, tsolver = solvers
    want = jfs.eval_relocalization(JaxF64FlyingShape(flyingshape_dir), jsolver)
    got = tfs.eval_relocalization(tfs.FlyingShapeDataset(flyingshape_dir), tsolver)
    assert_results_match(got, want)
    assert got["recall_rre5"] == 100.0


def cube_at(obj_id, mesh_type):
    """A ground truth for object "o<i>" of the fixtures: a cube of side 1
    where the object lies, at (2 i, 0, 0)."""
    return mesh_type(CUBE_V * 0.5 + [2.0 * int(obj_id[1:]), 0, 0], CUBE_F)


def test_flyingshape_reconstruction(flyingshape_dir, solvers):
    jsolver, tsolver = solvers
    want = jfs.eval_reconstruction(JaxF64FlyingShape(flyingshape_dir), jsolver,
                                   gt_mesh_loader=lambda c, o: cube_at(o, JMesh))
    got = tfs.eval_reconstruction(tfs.FlyingShapeDataset(flyingshape_dir), tsolver,
                                  gt_mesh_loader=lambda c, o: cube_at(o, Mesh))
    assert_results_match(got, want)
    assert np.isfinite(got["chamfer_mean"])


def test_3rscan_dataset_reader(rescan_dir):
    got, want = trs.Dataset3RScan(rescan_dir, min_points=10), jrs.Dataset3RScan(
        rescan_dir, min_points=10)
    assert got.scene_list == want.scene_list
    (g_ref, g_rescans), (w_ref, w_rescans) = got.get_scene(0), want.get_scene(0)
    for g, w in [(g_ref, w_ref)] + [(a[0], b[0]) for a, b in zip(g_rescans, w_rescans)]:
        for field in dataclasses.fields(w):
            gv, wv = getattr(g, field.name), getattr(w, field.name)
            if isinstance(wv, np.ndarray):
                np.testing.assert_array_equal(gv, wv, err_msg=field.name)
            else:
                assert gv == wv, field.name
    assert len(g_rescans[0][0].moving_ids) == 3


def test_3rscan_matching(rescan_dir, solvers, jax_f64):
    jsolver, tsolver = solvers
    kw = dict(min_points=10, point_bucket=256, batch_bucket=2)
    want = jrs.eval_matching(jrs.Dataset3RScan(rescan_dir, **kw), jsolver)
    got = trs.eval_matching(trs.Dataset3RScan(rescan_dir, **kw), tsolver)
    assert got == want
    assert got["object_recall"] == 100.0


def test_3rscan_relocalization(rescan_dir, solvers, jax_f64):
    jsolver, tsolver = solvers
    kw = dict(min_points=10, point_bucket=256, batch_bucket=2)
    want = jrs.eval_relocalization(jrs.Dataset3RScan(rescan_dir, **kw), jsolver,
                                   optim=False)
    got = trs.eval_relocalization(trs.Dataset3RScan(rescan_dir, **kw), tsolver,
                                  optim=False)
    assert_results_match(got, want)
    assert got["recall_rre10"] == 100.0


def test_3rscan_reconstruction(rescan_dir, solvers, jax_f64, tmp_path):
    """With ground-truth meshes of the ref scan's three instances (a cube
    each, written as PLY) and the code optimisation."""
    jsolver, tsolver = solvers
    gt_dir = tmp_path / "ref_scan"
    gt_dir.mkdir()
    for oid in (1, 2, 3):
        cube_at(f"o{oid - 1}", Mesh).export_ply(str(gt_dir / f"objectId_{oid}.ply"))
    ds = dict(min_points=10, point_bucket=256, batch_bucket=2)
    want = jrs.eval_reconstruction(jrs.Dataset3RScan(rescan_dir, **ds), jsolver,
                                   recon_gt_dir=str(tmp_path))
    got = trs.eval_reconstruction(trs.Dataset3RScan(rescan_dir, **ds), tsolver,
                                  recon_gt_dir=str(tmp_path))
    assert_results_match(got, want)
    assert np.isfinite(got["chamfer_1way_mean"])


def test_heterogeneous_batching_and_disambiguate():
    pcs = [np.random.default_rng(0).normal(size=(n, 3)) for n in (5, 9, 2)]
    for buckets in ((1, 1), (4, 2)):
        got, want = trs.heterogeneous_batching(pcs, *buckets), jrs.heterogeneous_batching(
            pcs, *buckets)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    ambiguity = [[{"instance_source": 5, "instance_target": 7},
                  {"instance_source": 7, "instance_target": 5}]]
    pred, gt = np.array([5, 3, 7]), np.array([7, 3, 9])
    np.testing.assert_array_equal(trs.disambiguate(pred, gt, ambiguity),
                                  jrs.disambiguate(pred, gt, ambiguity))
    for label in ("armchair", "coffee table", "weird thing"):
        assert trs.get_shapenet_category(label) == jrs.get_shapenet_category(label)


def test_encode_fps_restarts_match_jax(params, flyingshape_dir):
    """n_fps = 3 restarts over padded clouds: the port given the start
    points that JAX draws (jax.random.split of the key, then a categorical
    over each cloud's valid points) averages the same codes."""
    pc = np.concatenate([s["pc"] for s in tfs.FlyingShapeDataset(flyingshape_dir)[0]])
    rng = np.random.default_rng(3)
    mask = rng.random(pc.shape[:2]) > 0.2
    jm = jsp.ShapePrior(dataclasses.replace(SMALL, parity=True))
    key = jax.random.PRNGKey(11)
    encode = jax.jit(lambda p, x, m, k: jm.encode_fps(p, x, m, n_fps=3, rng=k))
    want = encode(jax.tree.map(jnp.asarray, params), jnp.asarray(pc, jnp.float64),
                  jnp.asarray(mask), key)
    logits = jnp.where(jnp.asarray(mask), 0.0, -jnp.inf)
    starts = np.stack([np.asarray(jax.random.categorical(k, logits, axis=-1))
                       for k in jax.random.split(key, 3)])
    model = port_solver(params).model
    got = model.encode_fps(torch.from_numpy(pc).double(), torch.from_numpy(mask),
                           n_fps=3, starts=torch.from_numpy(starts))
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=0,
                                   atol=1e-10, err_msg=k)
    # drawn from a generator: start points among the valid ones, and the
    # same codes for the same seed
    a = model.encode_fps(torch.from_numpy(pc).double(), torch.from_numpy(mask), n_fps=3,
                         generator=torch.Generator().manual_seed(5))
    b = model.encode_fps(torch.from_numpy(pc).double(), torch.from_numpy(mask), n_fps=3,
                         generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in a)
    one = model.encode_fps(torch.from_numpy(pc).double(), torch.from_numpy(mask))
    assert not torch.equal(a["z_inv"], one["z_inv"])


def small_loader(params):
    """load_solver for the small model: the port's own loader's
    checkpoint handling (a torch .pt mapped and loaded strictly), on the
    CPU, with the test's solver settings."""
    def load(ckpt, fast=True, parity=False, device=None, config=None):
        solver = port_solver(params)
        if ckpt:
            solver.model.load_state_dict(convert.state_dict_from_torch(
                run_flyingshape.load_torch_state(ckpt)), strict=True)
        if parity:
            solver.cfg = dataclasses.replace(solver.cfg, registration=dataclasses.replace(
                solver.cfg.registration, icp_accept="always"))
        return solver
    return load


def reference_checkpoint(state, path):
    """Write `state` (the port's state dict) as a reference training
    checkpoint."""
    sd = {k: v.detach().to(torch.float32).clone()
          for k, v in convert.state_dict_to_torch(state).items()}
    torch.save({"model_state_dict": sd}, path)
    return sd


def test_run_flyingshape_main(flyingshape_dir, params, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(run_flyingshape, "load_solver", small_loader(params))
    out = tmp_path / "fs.json"
    results = run_flyingshape.main(["--data", flyingshape_dir, "--tasks",
                                    "matching,reloc,recon", "--device", "cpu",
                                    "--out", str(out)])
    assert set(results) == {"matching", "relocalization", "reconstruction"}
    assert json.loads(out.read_text()) == json.loads(json.dumps(results))
    assert results["matching"]["object_recall"] == 100.0
    assert '"relocalization"' in capsys.readouterr().out


def test_run_3rscan_parity_main(rescan_dir, params, tmp_path, monkeypatch, capsys):
    """--parity on a reference checkpoint the test writes from the small
    model's weights: the conversion is verified, every loop runs (the
    relocalization four times) and the reference's table is printed."""
    pt = tmp_path / "parity.pt"
    reference_checkpoint(port_solver(params).model.state_dict(), pt)
    monkeypatch.setattr(run_3rscan, "load_solver", small_loader(params))
    monkeypatch.setattr(trs.Dataset3RScan, "__init__", _small_buckets(
        trs.Dataset3RScan.__init__))
    results = run_3rscan.main(["--data", rescan_dir, "--parity", str(pt),
                               "--device", "cpu"])
    assert set(results) == {"matching", "relocalization", "relocalization_optim",
                            "relocalization_symch", "relocalization_optim_symch",
                            "reconstruction"}
    printed = capsys.readouterr().out
    table = run_3rscan.parity_table(results)
    assert table in printed
    for line in ("Object-level matching recall", "Scene-level Hits Recall",
                 "reloc (Kabsch+ICP)", "reloc (+400-step optim)", "Reconstruction: chamfer"):
        assert line in table
    assert "-" not in table.splitlines()[1].split(":", 1)[1]


def _small_buckets(init):
    """Dataset3RScan.__init__ with min_points 10 (the fixture's instances
    have 256 points) and buckets of 256 points and 2 instances."""
    def wrapped(self, root_path, **kw):
        kw.update(min_points=10, point_bucket=256, batch_bucket=2)
        init(self, root_path, **kw)
    return wrapped


def test_verify_conversion_rejects_dropped_and_lossy_tensors(params, tmp_path, monkeypatch):
    state = port_solver(params).model.state_dict()
    clean = tmp_path / "clean.pt"
    sd = reference_checkpoint(state, clean)
    assert run_3rscan.verify_conversion(str(clean)) == len(state) > 50

    dropped = dict(sd, **{"encoder.some_layer.ghost_weight": torch.zeros(3, 3)})
    torch.save({"model_state_dict": dropped}, tmp_path / "dropped.pt")
    with pytest.raises(RuntimeError, match="key mismatch"):
        run_3rscan.verify_conversion(str(tmp_path / "dropped.pt"))
    foreign = dict(sd, **{"network_dict.cls_head.0.weight": torch.zeros(3, 3)})
    torch.save({"model_state_dict": foreign}, tmp_path / "foreign.pt")
    with pytest.raises(RuntimeError, match="key mismatch"):
        run_3rscan.verify_conversion(str(tmp_path / "foreign.pt"))

    # a lossy mapping: a relative change of 1e-6 in one tensor, which
    # np.allclose's rtol=1e-5 would let through, must fail
    real = convert.state_dict_to_torch

    def lossy(state):
        out = dict(real(state))
        key = next(k for k, v in out.items() if v.numel() > 4)
        bad = out[key].clone()
        bad.view(-1)[0] = bad.view(-1)[0] * (1 + 1e-6) + 1e-30
        out[key] = bad
        return out

    monkeypatch.setattr(convert, "state_dict_to_torch", lossy)
    with pytest.raises(RuntimeError, match="mismatch"):
        run_3rscan.verify_conversion(str(clean))


def test_load_solver(tmp_path, monkeypatch):
    """The production model: the flax checkpoint's weights; a reference
    .pt loaded strictly; seed-0 random weights without a checkpoint;
    parity pins icp_accept="always"; with no device named it runs on the
    card and raises without one."""
    ckpt = "weights/production_r5_selected.ckpt"
    solver = run_flyingshape.load_solver(ckpt, device="cpu")
    want = params_from_jax(convert.load_flax_checkpoint(ckpt))
    state = solver.model.state_dict()
    assert set(state) == set(want)
    assert all(torch.equal(state[k], want[k].float()) for k in want)
    assert solver.model.config.pallas_attention
    assert solver.cfg.registration.icp_accept == "symch"

    pt = tmp_path / "r5.pt"
    reference_checkpoint(state, pt)
    again = run_flyingshape.load_solver(str(pt), parity=True, device="cpu")
    assert all(torch.equal(v, state[k]) for k, v in again.model.state_dict().items())
    assert again.cfg.registration.icp_accept == "always"
    sd = torch.load(pt)["model_state_dict"]
    sd.pop(next(iter(sd)))
    torch.save({"model_state_dict": sd}, pt)
    with pytest.raises(RuntimeError, match="Missing key"):
        run_flyingshape.load_solver(str(pt), device="cpu")

    rand = run_flyingshape.load_solver(None, device="cpu").model.state_dict()
    seeded = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cpu").state_dict()
    assert all(torch.equal(rand[k], seeded[k]) for k in rand)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_flyingshape.load_solver(None)


def test_capstone_benchmark_matches_jax(tmp_path):
    """scripts/torch_demo_trained_eval.py build_benchmark writes the files
    and ground-truth meshes of scripts/demo_trained_eval.py's, and a
    smaller build in the same root removes the scenes past it."""
    import importlib.util
    import os

    def load(name):
        path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "scripts", name)
        spec = importlib.util.spec_from_file_location(name[:-3], path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    port, ref = load("torch_demo_trained_eval.py"), load("demo_trained_eval.py")
    got = port.build_benchmark(str(tmp_path / "port"), n_scenes=3, n_pts=64)
    want = ref.build_benchmark(str(tmp_path / "jax"), n_scenes=3, n_pts=64)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key].vertices, want[key].vertices)
        np.testing.assert_array_equal(got[key].faces, want[key].faces)
    for scene in range(3):
        for scan in ("scan_000.npz", "scan_001.npz"):
            rel = os.path.join("shape_4", f"scene_{scene:03d}", scan)
            g, w = np.load(tmp_path / "port" / rel), np.load(tmp_path / "jax" / rel)
            assert set(g.files) == set(w.files)
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])
    port.build_benchmark(str(tmp_path / "port"), n_scenes=2, n_pts=64)
    assert sorted(os.listdir(tmp_path / "port" / "shape_4")) == ["scene_000", "scene_001"]
