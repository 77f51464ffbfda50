"""The refinement ablation on the PyTorch port (scripts/torch_ablate_optim.py)
held against the JAX script (scripts/ablate_optim.py, its run_variant) on
the CPU, on test_torch_probe_icp_accept.py's benchmark tree and float64
r4 model, with the refinement cut to 4 steps: the base (Kabsch + ICP),
optim and noicp variants.

Tolerances (float64 rounding carried through the steps): each instance's
rotation error within 1e-6 degree, the translation error and the chamfer
rtol 1e-6 (atol 1e-12: exact registrations give chamfers of 1e-14); the
summaries equal, the median chamfer to the same tolerance.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                                "scripts"))

import ablate_optim as jablate  # noqa: E402
import torch_ablate_optim as tablate  # noqa: E402
from livingscenes_tpu.eval.flyingshape import FlyingShapeDataset as JDataset  # noqa: E402
from livingscenes_tpu_torch.eval.flyingshape import FlyingShapeDataset  # noqa: E402
from livingscenes_tpu_torch.solver.registration import RegistrationConfig  # noqa: E402
from test_torch_probe_icp_accept import N_SCENES, SHORT, setup, solvers  # noqa: E402, F401
from torch_threads import intra_op_share  # noqa: E402, F401 (autouse)


@pytest.mark.parametrize("name", ["base", "optim", "noicp"])
def test_ablation_variant_matches_jax(setup, name):
    root = setup[0]
    treg, optim = tablate.variants(RegistrationConfig(icp_fused=False, **SHORT))[name]
    jsolver, tsolver = solvers(setup, treg)
    jds = JDataset(root)
    jds_f64 = [[dict(s, pc=np.asarray(s["pc"], np.float64)) for s in jds[k]]
               for k in range(N_SCENES)]
    want = jablate.run_variant(jds_f64, jsolver, optim=optim)
    got = tablate.run_variant(FlyingShapeDataset(root), tsolver, optim=optim)
    assert len(got) == len(want) == 4 * N_SCENES
    for g, w in zip(got, want):
        assert (g["scene"], g["obj"]) == (w["scene"], w["obj"])
        np.testing.assert_allclose(g["rre"], w["rre"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(g["rte"], w["rte"], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(g["chamfer"], w["chamfer"], rtol=1e-6, atol=1e-12)
    summary, jsummary = tablate.summarize(got), jablate.summarize(want)
    np.testing.assert_allclose(summary.pop("median_chamfer"),
                               jsummary.pop("median_chamfer"), rtol=1e-6, atol=1e-12)
    assert summary == jsummary
