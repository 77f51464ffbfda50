"""The PyTorch port's ICP statistics and ICP solve held against the JAX
package on the CPU (same numpy inputs; the Pallas stats kernel in
interpret mode).

Tolerances:
  * stats in f32 against icp_iteration_stats(interpret=True): rtol 1e-5
    (one matmul per side, summed in another order), on clouds whose
    nearest targets are unique by a wide margin; inactive pairs are left
    out of the comparison (the TPU kernel leaves them undefined).
  * the plain stats in f64 against the same statistics built from the JAX
    XLA ops (pairwise_sqdist, argmin, gathers) in f64: rtol 1e-10. (The
    wrapper, like the JAX one, computes them in f32 whatever the dtype.)
  * the ICP solve: R and t to 1e-6 in f64, rmse rtol 1e-8, converged
    equal; the fused path (f32 statistics on both sides) in f32 with R
    and t to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu.ops.icp import iterative_closest_point as jicp
from livingscenes_tpu.ops.knn import pairwise_sqdist as jsqdist
from livingscenes_tpu.ops.pallas_icp import icp_iteration_stats as jstats
from livingscenes_tpu_torch.ops.cuda_icp import icp_iteration_stats, icp_stats_plain
from livingscenes_tpu_torch.ops.icp import iterative_closest_point
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def t(x):
    return torch.from_numpy(np.asarray(x))


def separated_clouds(rng, B, dtype):
    """Targets on a jittered-free lattice, moved sources near them."""
    g = np.stack(np.meshgrid(np.arange(8), np.arange(6), np.arange(5),
                             indexing="ij"), -1).reshape(-1, 3) * 0.1
    g = g - g.mean(0)
    M = g.shape[0]
    R = Rotation.random(B, random_state=5).as_matrix()
    tgt = np.einsum("bij,nj->bni", R, g)
    order = np.stack([rng.permutation(M) for _ in range(B)])[:, :200]
    x = np.take_along_axis(tgt, order[..., None], 1) + rng.normal(
        scale=0.005, size=(B, 200, 3))
    src = rng.normal(size=(B, 200, 3))
    return x.astype(dtype), src.astype(dtype), tgt.astype(dtype)


def test_stats_match_pallas_interpret_f32(rng):
    x, src, tgt = separated_clouds(rng, 4, np.float32)
    active = np.array([True, False, True, True])
    S, nn_sum, dmin_sum = jstats(jnp.asarray(x), jnp.asarray(src), jnp.asarray(tgt),
                                 active=jnp.asarray(active), interpret=True)
    St, nt, dt = icp_iteration_stats(t(x), t(src), t(tgt), t(active))
    for a, b in ((St, S), (nt, nn_sum), (dt, dmin_sum)):
        np.testing.assert_allclose(a.numpy()[active], np.asarray(b)[active],
                                   rtol=1e-5, atol=1e-5)
    assert (St.numpy()[~active] == 0).all() and (dt.numpy()[~active] == 0).all()


def test_stats_match_xla_f64_and_average_ties(rng):
    x, src, tgt = separated_clouds(rng, 3, np.float64)
    d = jsqdist(jnp.asarray(x), jnp.asarray(tgt))
    idx = jnp.argmin(d, axis=-1)
    nn = np.take_along_axis(tgt, np.asarray(idx)[..., None], 1)
    St, nt, dt = icp_stats_plain(t(x), t(src), t(tgt))
    np.testing.assert_allclose(St.numpy(), np.einsum("bni,bnj->bij", src, nn), rtol=1e-10)
    np.testing.assert_allclose(nt.numpy(), nn.sum(1), rtol=1e-10)
    np.testing.assert_allclose(
        dt.numpy(), np.asarray(jnp.sum(jnp.maximum(jnp.min(d, -1), 0.0), -1)),
        rtol=1e-10)
    # two targets at exactly the same distance: their mean is the match
    tg = np.array([[[1.0, 0, 0], [-1.0, 0, 0], [0, 5.0, 0]]])
    xs = np.zeros((1, 1, 3))
    _, nt, _ = icp_stats_plain(t(xs), t(xs + 1), t(tg))
    np.testing.assert_allclose(nt.numpy(), [[0.0, 0.0, 0.0]], atol=1e-15)


def _pose_problem(rng, B=3, N=150, dtype=np.float64):
    src = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * [1.0, 0.7, 0.4]
    R = Rotation.from_rotvec(rng.normal(scale=0.15, size=(B, 3))).as_matrix()
    tr = rng.normal(scale=0.05, size=(B, 3))
    # noise keeps the final RMSE well above its f32/f64 rounding floor
    tgt = np.einsum("bij,bnj->bni", R, src) + tr[:, None] \
        + rng.normal(scale=0.01, size=src.shape)
    return src.astype(dtype), tgt.astype(dtype), R, tr


@pytest.mark.parametrize("iters", [1, 30])
def test_icp_kabsch_path_matches_jax_f64(rng, iters):
    src, tgt, _, _ = _pose_problem(rng)
    rj = jicp(jnp.asarray(src), jnp.asarray(tgt), max_iterations=iters,
              fused_stats=False)
    rt = iterative_closest_point(t(src), t(tgt), max_iterations=iters,
                                 fused_stats=False)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-6)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-6)
    np.testing.assert_allclose(rt.rmse.numpy(), np.asarray(rj.rmse), rtol=1e-8)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))


def test_icp_fused_path_matches_jax_interpret(rng):
    src, tgt, R, tr = _pose_problem(rng, dtype=np.float32)
    R0 = np.broadcast_to(np.eye(3, dtype=np.float32), (3, 3, 3))
    rj = jicp(jnp.asarray(src), jnp.asarray(tgt), init_R=jnp.asarray(R0),
              max_iterations=25, fused_stats=True)
    rt = iterative_closest_point(t(src), t(tgt), init_R=t(R0.copy()),
                                 max_iterations=25, fused_stats=True)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-5)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-5)
    np.testing.assert_allclose(rt.rmse.numpy(), np.asarray(rj.rmse), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    # and it recovers the pose, to within what the 0.01 noise allows
    np.testing.assert_allclose(rt.R.numpy(), R, atol=2e-2)


def test_icp_masked_runs_kabsch_path(rng):
    src, tgt, _, _ = _pose_problem(rng)
    src_mask = np.ones(src.shape[:2], bool)
    src_mask[:, 120:] = False
    tgt_mask = np.ones(tgt.shape[:2], bool)
    tgt_mask[0, :10] = False
    rj = jicp(jnp.asarray(src), jnp.asarray(tgt), max_iterations=10,
              src_mask=jnp.asarray(src_mask), tgt_mask=jnp.asarray(tgt_mask),
              fused_stats=True)  # masks turn the fused path off on both sides
    rt = iterative_closest_point(t(src), t(tgt), max_iterations=10,
                                 src_mask=t(src_mask), tgt_mask=t(tgt_mask))
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-6)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-6)
    np.testing.assert_allclose(rt.rmse.numpy(), np.asarray(rj.rmse), rtol=1e-8)


def test_icp_first_step_never_freezes_and_frozen_pairs_hold(rng):
    src, tgt, _, _ = _pose_problem(rng)
    run = lambda n: iterative_closest_point(t(src), t(tgt), max_iterations=n,
                                            fused_stats=False)
    assert not run(1).converged.any()  # inf/inf is NaN, which never freezes
    r60, r90 = run(60), run(90)
    assert r60.converged.all()
    # frozen pairs keep their pose and RMSE from then on
    np.testing.assert_array_equal(r90.R.numpy(), r60.R.numpy())
    np.testing.assert_array_equal(r90.t.numpy(), r60.t.numpy())
    np.testing.assert_array_equal(r90.rmse.numpy(), r60.rmse.numpy())
