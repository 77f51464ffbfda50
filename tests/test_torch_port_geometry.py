"""The PyTorch port's se3, FPS and kNN held against the JAX package on the
CPU. The same numpy inputs go through both; the Pallas kernels run in
interpret mode, as tests/test_pallas_*.py run them.

Tolerances:
  * FPS and kNN indices: exact equality. Both sides compute the same f32
    (or f64) arithmetic in the same order for FPS; for kNN the distances
    come from one matmul on each side, and the random inputs have no
    near-ties at the 1e-7 level.
  * kNN distances: rtol 1e-6 in f32 of |q|^2 + d, the size of the terms
    that cancel in |q|^2 - 2 q.p + |p|^2 (matmul summation order differs
    between the two CPU backends); 1e-12 in f64.
  * se3 in f64: 1e-10 (closed-form and SVD results, rounding only).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from livingscenes_tpu import se3 as jse3
from livingscenes_tpu.ops.fps import farthest_point_sampling as jfps
from livingscenes_tpu.ops.knn import knn as jknn
from livingscenes_tpu.ops.pallas_fps import fps_pallas
from livingscenes_tpu.ops.pallas_knn import knn_pallas
from livingscenes_tpu_torch import se3
from livingscenes_tpu_torch.ops.cuda_fps import fps_auto
from livingscenes_tpu_torch.ops.cuda_knn import knn_auto
from livingscenes_tpu_torch.ops.fps import farthest_point_sampling
from livingscenes_tpu_torch.ops.knn import gather_neighbors, knn
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def t(x):
    return torch.from_numpy(np.asarray(x))


# -- se3 ---------------------------------------------------------------------

def test_kabsch_matches_jax_and_recovers_pose(rng):
    B, N = 5, 40
    x1 = rng.normal(size=(B, N, 3))
    R = Rotation.random(B, random_state=1).as_matrix()
    tr = rng.normal(size=(B, 3, 1))
    x2 = np.einsum("bij,bnj->bni", R, x1) + tr[..., 0][:, None] \
        + 1e-3 * rng.normal(size=(B, N, 3))
    w = rng.uniform(0.1, 1.0, size=(B, N))
    for weights in (None, w):
        Rj, tj, rj = jse3.kabsch(jnp.asarray(x1), jnp.asarray(x2),
                                 None if weights is None else jnp.asarray(weights))
        Rt, tt, rt = se3.kabsch(t(x1), t(x2), None if weights is None else t(weights))
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-10)
        np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-10)
        np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-10)
    # exact correspondences recover the pose
    x2c = np.einsum("bij,bnj->bni", R, x1) + tr[..., 0][:, None]
    Rt, tt, _ = se3.kabsch(t(x1), t(x2c))
    assert float(se3.rotation_error(Rt, t(R)).max()) < 1e-5
    # the weight normalization's eps (1e-7) biases t by about 1e-7
    assert float(se3.translation_error(tt, t(tr)).max()) < 1e-6


def test_kabsch_fixes_reflection(rng):
    x1 = rng.normal(size=(3, 30, 3))
    x2 = x1.copy()
    x2[..., 2] *= -1  # a mirror image: the best proper rotation has det +1
    R, _, _ = se3.kabsch(t(x1), t(x2))
    np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-12)
    Rj, _, _ = jse3.kabsch(jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-10)


def test_quaternions_and_horn_match_jax(rng):
    R = Rotation.random(16, random_state=2).as_matrix()
    qj = jse3.quat_wxyz_from_matrix(jnp.asarray(R))
    qt = se3.quat_wxyz_from_matrix(t(R))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-12)
    np.testing.assert_allclose(se3.matrix_from_quat_wxyz(qt).numpy(), R, atol=1e-12)
    cov = rng.normal(size=(16, 3, 3))
    q0 = qt
    Rj, qj2 = jse3.rotation_from_covariance_horn(jnp.asarray(cov), q0=jnp.asarray(q0.numpy()))
    Rt, qt2 = se3.rotation_from_covariance_horn(t(cov), q0=q0)
    np.testing.assert_allclose(qt2.numpy(), np.asarray(qj2), atol=1e-10)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-10)
    # a cold start converges to the SVD answer for a well-separated spectrum
    cov_r = np.einsum("bij,jk->bik", R, np.diag([3.0, 2.0, 1.0]))
    Rh, _ = se3.rotation_from_covariance_horn(t(cov_r), iters=200)
    np.testing.assert_allclose(
        Rh.numpy(), se3.rotation_from_covariance(t(cov_r)).numpy(), atol=1e-8)


def test_transforms_and_errors_match_jax(rng):
    R = Rotation.random(4, random_state=3).as_matrix()
    tr = rng.normal(size=(4, 3, 1))
    pts = rng.normal(size=(4, 10, 3))
    gj = jse3.rt_to_se3(jnp.asarray(R), jnp.asarray(tr))
    g = se3.rt_to_se3(t(R), t(tr))
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), atol=0)
    np.testing.assert_allclose(se3.inverse(g).numpy(), np.asarray(jse3.inverse(gj)), atol=1e-12)
    np.testing.assert_allclose(
        se3.transform(g, t(pts)).numpy(),
        np.asarray(jse3.transform(gj, jnp.asarray(pts))), atol=1e-12)
    np.testing.assert_allclose(
        se3.transform(se3.inverse(g), se3.transform(g, t(pts))).numpy(), pts, atol=1e-12)
    R2 = Rotation.random(4, random_state=4).as_matrix()
    np.testing.assert_allclose(
        se3.rotation_error(t(R), t(R2)).numpy(),
        np.asarray(jse3.rotation_error(jnp.asarray(R), jnp.asarray(R2))), atol=1e-9)
    np.testing.assert_allclose(
        se3.translation_error(t(tr), t(tr * 2)).numpy(),
        np.asarray(jse3.translation_error(jnp.asarray(tr), jnp.asarray(tr * 2))), atol=1e-12)


# -- FPS -----------------------------------------------------------------------

def _check_fps(pts, k, mask=None):
    _, i_ref = jfps(jnp.asarray(pts), k,
                    mask=None if mask is None else jnp.asarray(mask))
    _, i_pl = fps_pallas(jnp.asarray(pts, jnp.float32), k,
                         None if mask is None else jnp.asarray(mask),
                         batch_tile=pts.shape[0], interpret=True)
    sampled, i_t = fps_auto(t(pts), k, None if mask is None else t(mask))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_pl))
    np.testing.assert_array_equal(
        sampled.numpy(), np.take_along_axis(pts, i_t.numpy()[..., None], 1))


def test_fps_matches_jax_random_and_masked(rng):
    pts = rng.normal(size=(8, 256, 3)).astype(np.float32)
    mask = rng.random((8, 256)) > 0.2
    for k in (64, 65):
        _check_fps(pts, k, mask)
    _check_fps(pts, 32)


def test_fps_matches_jax_ties_and_tail(rng):
    # exact ties: an integer lattice with duplicated points
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), np.arange(4),
                             indexing="ij"), -1).reshape(-1, 3).astype(np.float32)
    g = np.concatenate([g, g[:32]], 0)[None].repeat(8, 0)
    _check_fps(g, 48)
    # tail: only 20 valid points, k = 64
    pts = rng.normal(size=(8, 256, 3)).astype(np.float32)
    m2 = np.arange(256)[None, :].repeat(8, 0) < 20
    _check_fps(pts, 64, m2)
    _, idx = farthest_point_sampling(t(pts), 64, t(m2))
    assert int(idx.max()) < 20  # an invalid point is never picked


@pytest.mark.parametrize("masked", [False, True])
def test_fps_start_idx_matches_jax(rng, masked):
    # a (B,) start index and an int one, as JAX's start_idx takes them
    pts = rng.normal(size=(6, 200, 3)).astype(np.float32)
    mask = rng.random((6, 200)) > 0.3 if masked else None
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else t(mask)
    start = np.array([0, 5, 199, 73, 120, 1], np.int32)
    for s in (start, 17):
        _, i_ref = jfps(jnp.asarray(pts), 48, mask=jmask,
                        start_idx=jnp.asarray(s) if np.ndim(s) else s)
        s_t = t(s) if np.ndim(s) else s
        _, i_t = farthest_point_sampling(t(pts), 48, tmask, start_idx=s_t)
        np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))
        sampled, i_a = fps_auto(t(pts), 48, tmask, start_idx=s_t)
        np.testing.assert_array_equal(i_a.numpy(), np.asarray(i_ref))
        np.testing.assert_array_equal(
            sampled.numpy(), np.take_along_axis(pts, i_a.numpy()[..., None], 1))


def test_fps_f64_matches_jax(rng):
    pts = rng.normal(size=(3, 200, 3))
    _, i_ref = jfps(jnp.asarray(pts), 50)
    _, i_t = farthest_point_sampling(t(pts), 50)
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))


# -- kNN -----------------------------------------------------------------------

@pytest.mark.parametrize("nq,np_,d,k", [(100, 120, 3, 16), (64, 64, 24, 16),
                                        (33, 40, 48, 8), (10, 12, 6, 12)])
def test_knn_matches_pallas_and_xla_f32(rng, nq, np_, d, k):
    p = rng.normal(size=(3, np_, d)).astype(np.float32)
    q = p[:, :nq] + 0.01 * rng.normal(size=(3, nq, d)).astype(np.float32)
    dp, ip = knn_pallas(jnp.asarray(q), jnp.asarray(p), k, tile=32, interpret=True)
    dx, ix = jknn(jnp.asarray(q), jnp.asarray(p), k)
    dt, it = knn_auto(t(q), t(p), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ip))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ix))
    # rtol 1e-6 of the cancelling terms' size, |q|^2 + d (small distances
    # carry the rounding of |q|^2 and |p|^2, not of d)
    scale = np.sum(q.astype(np.float64) ** 2, -1, keepdims=True) + np.asarray(dp)
    assert (np.abs(dt.numpy() - np.asarray(dp)) <= 1e-6 * scale).all()


def test_knn_f64_and_ties(rng):
    p = rng.normal(size=(2, 50, 9))
    dx, ix = jknn(jnp.asarray(p), jnp.asarray(p), 16)
    dt, it = knn(t(p), t(p), 16)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ix))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dx), rtol=1e-12, atol=1e-12)
    # duplicated points tie exactly: the lower index comes first
    g = np.concatenate([p[:, :10], p[:, :10]], 1)
    _, it = knn(t(g), t(g), 4)
    _, ix = jknn(jnp.asarray(g), jnp.asarray(g), 4)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ix))
    assert (it[:, :10, :2].numpy() == np.stack(
        [np.arange(10), np.arange(10, 20)], -1)[None]).all()


def test_gather_neighbors(rng):
    f = rng.normal(size=(2, 30, 4, 3))
    idx = rng.integers(0, 30, size=(2, 7, 5))
    out = gather_neighbors(t(f), t(idx))
    want = np.take_along_axis(f[:, None], idx[..., None, None], axis=2)
    np.testing.assert_array_equal(out.numpy(), want)
