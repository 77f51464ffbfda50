"""The PyTorch port's MORE solver (solver/more.py `MoreSolver`) and
multi-scan joint optimization (solver/joint.py `accumulate_and_optimize`)
held against the JAX package on the CPU in f64: the small encoder of
tests/test_aux.py (n_pcl 64) with weights made with numpy, 3 objects of
96 points (the last 16 of each padded out at random), both sides on the
Kabsch ICP refit (icp_fused=False). JAX's restart starts are drawn in the
test and passed to the port.

Tolerances: matches0, matches1 and the masks equal; registrations, codes
and transported codes to 1e-6; mesh vertices to 1e-6 (faces equal);
accumulated points to 1e-9; codes after `optimize_code` from the same
input codes to 1e-9.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.models import shape_prior as jsp
from livingscenes_tpu.recon import extractor as jext
from livingscenes_tpu.solver import code_optim as jco
from livingscenes_tpu.solver import joint as jjoint
from livingscenes_tpu.solver import more as jmore
from livingscenes_tpu.solver import registration as jreg
from livingscenes_tpu_torch.models.convert import params_from_jax
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig
from livingscenes_tpu_torch.recon import extractor as text
from livingscenes_tpu_torch.solver import code_optim as tco
from livingscenes_tpu_torch.solver import joint as tjoint
from livingscenes_tpu_torch.solver import more as tmore
from livingscenes_tpu_torch.solver import registration as treg
from torch_threads import intra_op_share  # noqa: F401 (autouse)

SMALL = dict(c_dim=32, num_layers=4, feat_dim=(16, 16, 32, 32),
             down_sample_layers=(2,), down_sample_factor=(2,),
             atten_start_layer=2, atten_multi_head_c=8, num_knn=8,
             scale_factor=10.0, decoder_dims=(96,) * 8, n_pcl=64)
N_OBJ, N_PTS, K = 3, 96, 64
REG = dict(n_steps=3, lr=0.005, lr_milestones=(2,), icp_iterations=5, icp_fused=False)
MESH = dict(resolution0=8, upsampling_steps=1, simplify_nfaces=None)


def make_objects(rng):
    """A box, a cross and an L (tests/test_end2end.py), placed apart."""
    box = rng.uniform(-0.5, 0.5, size=(N_PTS, 3)) * [1.0, 0.6, 0.3]
    arm1 = rng.uniform(-0.5, 0.5, size=(N_PTS // 2, 3)) * [1.0, 0.15, 0.15]
    arm2 = rng.uniform(-0.5, 0.5, size=(N_PTS // 2, 3)) * [0.15, 1.0, 0.15]
    l1 = rng.uniform(0, 1, size=(N_PTS // 2, 3)) * [0.8, 0.2, 0.2]
    l2 = rng.uniform(0, 1, size=(N_PTS // 2, 3)) * [0.2, 0.2, 0.8]
    objs = np.stack([box, np.concatenate([arm1, arm2]), np.concatenate([l1, l2]) - 0.4])
    return objs + np.array([[0, 0, 0], [2.0, 0, 0], [0, 2.0, 0]])[:, None]


def move(objs, seed):
    """A rescan: each object moved by its own rigid transform, the objects
    permuted; returns the clouds, the permutation, and the mask."""
    rng = np.random.default_rng(seed)
    R = Rotation.random(N_OBJ, random_state=seed).as_matrix()
    t = 0.5 * rng.normal(size=(N_OBJ, 1, 3))
    perm = rng.permutation(N_OBJ)
    mask = np.ones((N_OBJ, N_PTS), bool)
    mask[:, 80:] = rng.random((N_OBJ, N_PTS - 80)) > 0.5
    return (np.einsum("bij,bnj->bni", R, objs) + t)[perm], perm, mask


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(12)
    ref = make_objects(rng)
    mask = np.ones((N_OBJ, N_PTS), bool)
    mask[:, 80:] = rng.random((N_OBJ, N_PTS - 80)) > 0.5
    rescan, perm, rescan_mask = move(ref, 1)
    return ref, mask, rescan, rescan_mask, perm


def numpy_params(model, seed):
    """A parameter tree of the JAX model made with numpy (its shapes from
    jax.eval_shape, which compiles nothing): weights uniform in
    +-1/sqrt(fan_in), each weight-norm gain the norm of its direction (the
    effective weight is the direction, as at JAX's init), biases 0."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                out[name] = fill(leaf)
            elif name in ("weight", "kernel", "v"):
                fan_in = leaf.shape[-1] if name == "weight" else leaf.shape[0]
                out[name] = rng.uniform(-1, 1, leaf.shape) / np.sqrt(fan_in)
            elif name in ("b", "bias"):
                out[name] = np.zeros(leaf.shape)
        if "g" in tree:
            out["g"] = np.linalg.norm(out["v"], axis=0)
        assert set(out) == set(tree)
        return out

    return fill(jax.eval_shape(lambda k: model.init_params(k, n_points=64),
                               jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def params():
    return numpy_params(jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL)), 0)


def solvers(params, **cfg_kwargs):
    """The JAX and the port's MoreSolver on the same weights and settings;
    cfg_kwargs: MoreSolverConfig fields, `registration` a dict."""
    reg = dict(REG, **cfg_kwargs.pop("registration", {}))
    common = dict(n_input_point=K, code_optim=dict(n_steps=5), **cfg_kwargs)
    mesh = MESH
    jcfg = jmore.MoreSolverConfig(**dict(
        common, registration=jreg.RegistrationConfig(**reg),
        mesh_extractor=jext.MeshExtractorConfig(**mesh),
        code_optim=jco.CodeOptimConfig(**common["code_optim"])))
    tcfg = tmore.MoreSolverConfig(**dict(
        common, registration=treg.RegistrationConfig(**reg),
        mesh_extractor=text.MeshExtractorConfig(**mesh),
        code_optim=tco.CodeOptimConfig(**common["code_optim"])))
    jm = jsp.ShapePrior(jsp.ShapePriorConfig(**SMALL, parity=True))
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), params)
    tm = ShapePrior(ShapePriorConfig(**SMALL), device="cpu", dtype=torch.float64)
    tm.load_state_dict(params_from_jax(params))
    return jmore.MoreSolver(jm, jp, jcfg), tmore.MoreSolver(tm, tcfg)


@pytest.fixture(scope="module")
def base(params):
    return solvers(params)


def variant(pair, **changes):
    """Copies of a (JAX, port) solver pair with MoreSolverConfig fields
    changed that their compiled functions do not read (n_init, seed,
    mesh_extractor): the JAX copy keeps its jitted encoder and
    registration."""
    out = []
    for slv, ext in zip(pair, (jext, text)):
        twin = copy.copy(slv)
        kw = dict(changes)
        if "mesh_extractor" in kw:
            kw["mesh_extractor"] = dataclasses.replace(slv.cfg.mesh_extractor,
                                                       **kw["mesh_extractor"])
            twin.mesh_extractor = ext.MeshExtractor(slv.mesh_extractor._logits_fn,
                                                    kw["mesh_extractor"])
        twin.cfg = dataclasses.replace(slv.cfg, **kw)
        out.append(twin)
    return tuple(out)


def close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol)


def codes_close(got, want, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], atol)


def jnp_tree(x):
    return jax.tree.map(jnp.asarray, x)


@pytest.mark.parametrize("use_icp", [True, False])
def test_solve_end2end_matches_jax(params, base, scene, use_icp):
    ref, mask, rescan, rescan_mask, perm = scene
    if use_icp:
        js, ts = base
    else:
        js, ts = solvers(params, registration=dict(use_icp=False))
        # the encoders do not read the registration settings
        js._encode, js._encode_fps = base[0]._encode, base[0]._encode_fps
    want = js.solve_end2end(jnp.asarray(ref), jnp.asarray(mask), jnp.asarray(rescan),
                            jnp.asarray(rescan_mask), extract_meshes=False)
    got = ts.solve_end2end(ref, mask, rescan, rescan_mask, extract_meshes=False)
    for key in ("matches0", "matches1"):
        assert got[key].dtype == torch.int32
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert (got["matches0"].numpy() >= 0).all()
    close(got["registration"], want["registration"], 1e-6)
    for key in ("ref_codes", "rescan_codes", "transported_codes"):
        codes_close(got[key], want[key])
    if not use_icp:
        # the pose is Kabsch's on the codes, with nothing after it
        partner = got["matches0"].long()
        c2 = {k: v[partner] for k, v in got["rescan_codes"].items()}
        R, t, _ = treg.kabsch_from_codes(got["ref_codes"], c2)
        np.testing.assert_array_equal(got["registration"][:, :3, :3].numpy(), R.numpy())
        np.testing.assert_array_equal(got["registration"][:, :3, 3:].numpy(), t.numpy())


def mesh_threshold(ts, codes):
    """An occupancy threshold that cuts the untrained fields: the sigmoid
    of the median level-0 logit of the canonical codes."""
    ext = text.MeshExtractor(ts.model.occupancy_logits,
                             text.MeshExtractorConfig(resolution0=8, upsampling_steps=0))
    vals = [ext.compute_grid(dict({k: v[i:i + 1] for k, v in codes.items()},
                                  s=torch.ones(1, dtype=torch.float64),
                                  t=torch.zeros((1, 1, 3), dtype=torch.float64)))[0]
            for i in range(codes["s"].shape[0])]
    return float(torch.sigmoid(torch.median(torch.stack(vals))))


def assert_meshes_equal(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    np.testing.assert_array_equal(got.faces, want.faces)
    close(got.vertices, want.vertices, 1e-6)


def test_solve_end2end_meshes_match_jax(params, base, scene):
    ref, mask, rescan, rescan_mask, _ = scene
    codes = base[1].solve_end2end(ref, mask, rescan, rescan_mask,
                                  extract_meshes=False)["transported_codes"]
    js, ts = variant(base, mesh_extractor=dict(threshold=mesh_threshold(base[1], codes)))
    want = js.solve_end2end(jnp.asarray(ref), jnp.asarray(mask), jnp.asarray(rescan),
                            jnp.asarray(rescan_mask))
    got = ts.solve_end2end(ref, mask, rescan, rescan_mask)
    assert len(got["mesh_list"]) == N_OBJ
    assert sum(m is not None and not m.is_empty for m in got["mesh_list"]) >= 2
    for g, w in zip(got["mesh_list"], want["mesh_list"]):
        assert_meshes_equal(g, w)
    # mesh_from_pc: FPS, encode, mesh of the first cloud
    assert_meshes_equal(ts.mesh_from_pc(ref), js.mesh_from_pc(jnp.asarray(ref)))


def test_solve_end2end_optim_matches_jax(base, scene):
    """The refinement at 3 steps before ICP, on the same matched pairs."""
    ref, mask, rescan, rescan_mask, _ = scene
    js, ts = base
    want = js.solve_end2end(jnp.asarray(ref), jnp.asarray(mask), jnp.asarray(rescan),
                            jnp.asarray(rescan_mask), optim=True, extract_meshes=False)
    got = ts.solve_end2end(ref, mask, rescan, rescan_mask, optim=True, extract_meshes=False)
    np.testing.assert_array_equal(got["matches0"].numpy(), np.asarray(want["matches0"]))
    close(got["registration"], want["registration"], 1e-6)
    codes_close(got["transported_codes"], want["transported_codes"])


def test_restarts_match_jax(base, scene):
    """n_init = 3 FPS restarts from JAX's draw: the same candidates win and
    the registrations agree. The partners are jittered copies, so that the
    candidates' residuals differ by more than rounding (on exact rigid
    copies they tie to 1e-16)."""
    ref, _, rescan, _, perm = scene
    pc2 = rescan[np.argsort(perm)]  # each ref object's partner
    pc2 = pc2 + 0.01 * np.random.default_rng(7).normal(size=pc2.shape)
    js, ts = variant(base, n_init=3)
    key = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    starts = np.array(jax.random.randint(key, (3, N_OBJ), 0, N_PTS))
    assert len(np.unique(starts)) > 1
    want = js.solve_pairwise_registration(jnp.asarray(ref), jnp.asarray(pc2), rng=key)
    got = ts.solve_pairwise_registration(ref, pc2, starts=torch.from_numpy(starts))
    for g, w in zip(got, want):
        close(g, w, 1e-6)
    # the winner is the smallest of the three, recomputed, and the
    # candidates differ by far more than rounding (so that another pick
    # would have moved the registration)
    picked = ts._best_fps_restart(ref, pc2, torch.from_numpy(starts))
    res = []
    for start in starts:
        c1, c2 = (ts.model.encode(ts._sample(p, start_idx=torch.from_numpy(start)))
                  for p in (ref, pc2))
        res.append(treg.kabsch_from_codes(c1, c2).residual.detach())
    res = torch.stack(res)
    chosen = treg.kabsch_from_codes(picked[2], picked[3]).residual
    np.testing.assert_array_equal(chosen.numpy(), res.min(0).values.numpy())
    gaps = (res - res.min(0).values).sort(0).values[1]
    assert (gaps > 1e-6 * res.min(0).values).all()


def test_restart_generator_advances_from_its_seed(base):
    """Without `starts`, each call draws new start points from the solver's
    generator; a solver with the same seed draws the same sequence."""
    cfg = dataclasses.replace(base[1].cfg, n_init=4, seed=3)
    a, b = (tmore.MoreSolver(base[1].model, cfg) for _ in range(2))
    first, second = a.restart_starts(5, N_PTS), a.restart_starts(5, N_PTS)
    assert first.shape == (4, 5) and not torch.equal(first, second)
    assert torch.equal(b.restart_starts(5, N_PTS), first)
    assert int(first.min()) >= 0 and int(first.max()) < N_PTS


def test_optimize_code_matches_jax(base, scene):
    """From the same input codes: the masked FPS and 5 Adam steps."""
    ref, mask, *_ = scene
    js, ts = base
    codes = jax.tree.map(np.array, js.encode_instances(jnp.asarray(ref), jnp.asarray(mask)))
    got_enc = ts.encode_instances(ref, mask)
    codes_close(got_enc, codes)
    want = js.optimize_code(jnp_tree(codes), jnp.asarray(ref), jnp.asarray(mask))
    got = ts.optimize_code({k: torch.from_numpy(v) for k, v in codes.items()}, ref, mask)
    codes_close(got, want, 1e-9)
    np.testing.assert_array_equal(got["s"].numpy(), codes["s"])
    assert not np.allclose(got["z_inv"].numpy(), codes["z_inv"])


def test_accumulate_and_optimize_matches_jax(base, scene):
    """Three scans: the reference and two rigid moves of it, each permuted."""
    ref, mask, rescan, rescan_mask, perm = scene
    second, perm2, mask2 = move(ref, 2)
    scans = [(ref, mask), (rescan, rescan_mask), (second, mask2)]
    js, ts = base
    want = jjoint.accumulate_and_optimize(
        js, [(jnp.asarray(p), jnp.asarray(m)) for p, m in scans],
        code_cfg=jco.CodeOptimConfig(n_steps=5))
    got = tjoint.accumulate_and_optimize(ts, scans, code_cfg=tco.CodeOptimConfig(n_steps=5))
    assert got.accumulated_pc.shape == (N_OBJ, 3 * N_PTS, 3)
    for g, w, p in zip(got.matches, want.matches, (perm, perm2)):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.argsort(p))
    for g, w in zip(got.transforms, want.transforms):
        close(g, w, 1e-6)
    np.testing.assert_array_equal(got.accumulated_mask.numpy(), np.asarray(want.accumulated_mask))
    close(got.accumulated_pc, want.accumulated_pc, 1e-9)
    codes_close(got.codes, want.codes)


def test_config_defaults_match_jax():
    t, j = tmore.MoreSolverConfig(), jmore.MoreSolverConfig()
    for f in dataclasses.fields(j):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(jv):
            for g in dataclasses.fields(tv):
                assert getattr(tv, g.name) == getattr(jv, g.name), (f.name, g.name)
        else:
            assert tv == jv, f.name


def test_no_card_no_solver(monkeypatch):
    """A model built without a device needs the card: with none it raises
    (device.resolve_device) rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmore.MoreSolver(ShapePrior(ShapePriorConfig(**SMALL)))
