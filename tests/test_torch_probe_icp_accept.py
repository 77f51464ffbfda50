"""The ICP-acceptance probe on the PyTorch port
(scripts/torch_probe_icp_accept.py) held against the JAX script
(scripts/probe_icp_accept.py) on the CPU; the setup serves
test_torch_ablate_optim.py too (scripts/torch_ablate_optim.py against
scripts/ablate_optim.py).

One benchmark tree of build_benchmark (2 scenes x 4 shapes x 512 points,
seed 7) is read by both sides; the model is the production one with the
committed r4 checkpoint (weights/plateau_r4_selected.ckpt) in float64 on
both sides; the refinement takes 4 steps (milestone at 3) instead of 400.
The ICP runs with the Kabsch refit on both sides (JAX's CPU path). The
probe's per-scene core is the JAX script's main loop body, with its
symm_chamfer; the ablation's is its run_variant.

Tolerances (float64 rounding carried through the steps): each pose's and
each variant's rotation error within 1e-6 degree, the translation error
and the chamfer rtol 1e-6, the proxies (symch, sdf) rtol 1e-7; the
scores of the rules from these records equal.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import probe_icp_accept as jprobe  # noqa: E402
import torch_probe_icp_accept as tprobe  # noqa: E402
from livingscenes_tpu import se3 as jse3  # noqa: E402
from livingscenes_tpu.eval.flyingshape import FlyingShapeDataset as JDataset  # noqa: E402
from livingscenes_tpu.eval.run_flyingshape import load_solver as jload_solver  # noqa: E402
from livingscenes_tpu.ops.icp import iterative_closest_point as jicp  # noqa: E402
from livingscenes_tpu.solver import MoreSolver as JMoreSolver  # noqa: E402
from livingscenes_tpu.solver import MoreSolverConfig as JMoreSolverConfig  # noqa: E402
from livingscenes_tpu.solver.registration import RegistrationConfig as JRegConfig  # noqa: E402
from livingscenes_tpu_torch.eval.flyingshape import FlyingShapeDataset  # noqa: E402
from livingscenes_tpu_torch.models.convert import params_from_jax  # noqa: E402
from livingscenes_tpu_torch.models.shape_prior import ShapePrior, ShapePriorConfig  # noqa: E402
from livingscenes_tpu_torch.solver import MoreSolver, MoreSolverConfig  # noqa: E402
from livingscenes_tpu_torch.solver.registration import RegistrationConfig  # noqa: E402
from torch_demo_trained_eval import build_benchmark  # noqa: E402
from torch_threads import intra_op_share  # noqa: E402, F401 (autouse)

CKPT = os.path.join(ROOT, "weights", "plateau_r4_selected.ckpt")
N_SCENES, N_PTS = 2, 512
SHORT = dict(n_steps=4, lr_milestones=(3,))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("probe_tree"))
    build_benchmark(root, n_scenes=N_SCENES, n_pts=N_PTS)
    base = jload_solver(CKPT)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), base.params)
    model = ShapePrior(ShapePriorConfig(pallas_attention=True), device="cpu",
                       dtype=torch.float64)
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return root, base.model, params, model


def solvers(setup, treg):
    """JAX's and the port's solvers under the port's RegistrationConfig
    `treg` (JAX's keeps its CPU defaults of icp_fused and sinkhorn_pallas)."""
    _, jmodel, params, model = setup
    jreg = JRegConfig(**{f.name: getattr(treg, f.name) for f in dataclasses.fields(JRegConfig)
                         if f.name not in ("icp_fused", "sinkhorn_pallas")})
    return (JMoreSolver(jmodel, params, JMoreSolverConfig(n_input_point=N_PTS,
                                                          registration=jreg)),
            MoreSolver(model, MoreSolverConfig(n_input_point=N_PTS, registration=treg)))


def jax_probe_scene(solver, ref_scan, rescan):
    """The body of scripts/probe_icp_accept.py main's scene loop."""
    model, params = solver.model, solver.params
    gt = jse3.concatenate(jnp.asarray(rescan["transform"]),
                          jse3.inverse(jnp.asarray(ref_scan["transform"])))
    pc1 = jnp.asarray(ref_scan["pc"], jnp.float64)
    pc2 = jnp.asarray(rescan["pc"], jnp.float64)
    codes1, codes2 = solver._encode(pc1), solver._encode(pc2)
    poses = {}
    poses["kab"] = solver.solve_pairwise_registration(pc1, pc2, optim=False,
                                                      codes1=codes1, codes2=codes2)
    poses["ref"] = solver.solve_pairwise_registration(pc1, pc2, optim=True,
                                                      codes1=codes1, codes2=codes2)
    for src, dst in (("kab", "kab_icp"), ("ref", "ref_icp")):
        R0, t0 = poses[src]
        res = jicp(pc1, pc2, init_R=R0, init_t=t0[..., 0], max_iterations=100)
        poses[dst] = (res.R, res.t[..., None])
    row = {}
    for name, (R, t) in poses.items():
        moved = jnp.einsum("bij,bnj->bni", R, pc1) + t[..., 0][:, None]
        rre = np.asarray(jse3.rotation_error(R, gt[..., :3, :3]))
        rre = np.minimum.reduce([rre, np.abs(180 - rre), np.abs(90 - rre)])
        row[name] = {"rre": rre.tolist(),
                     "symch": np.asarray(jprobe.symm_chamfer(moved, pc2)).tolist(),
                     "sdf": np.asarray(jnp.abs(model.decode_sdf(params, moved, codes2))
                                       .mean(axis=-1)).tolist()}
    return row


def test_probe_matches_jax(setup):
    root = setup[0]
    jsolver, tsolver = solvers(setup, RegistrationConfig(icp_fused=False, use_icp=False,
                                                         **SHORT))
    jrecords, trecords = [], []
    for i, (jscene, tscene) in enumerate(zip(
            (JDataset(root)[k] for k in range(N_SCENES)),
            (FlyingShapeDataset(root)[k] for k in range(N_SCENES)))):
        jrecords.append(dict(scene=i, **jax_probe_scene(jsolver, jscene[0], jscene[1])))
        trecords.append(dict(scene=i, **tprobe.probe_scene(tsolver, tscene[0], tscene[1],
                                                           fused_stats=False)))
    for jr, tr in zip(jrecords, trecords):
        for pose in tprobe.POSES:
            np.testing.assert_allclose(tr[pose]["rre"], jr[pose]["rre"], rtol=0,
                                       atol=1e-6, err_msg=pose)
            for proxy in ("symch", "sdf"):
                np.testing.assert_allclose(tr[pose][proxy], jr[pose][proxy], rtol=1e-7,
                                           err_msg=f"{pose} {proxy}")
    summary = tprobe.score(trecords)
    assert summary == tprobe.score(jrecords)
    assert summary["n"] == 4 * N_SCENES
    assert set(summary["rules"]) == {"accept_by_symch", "accept_by_sdf", "oracle"}
