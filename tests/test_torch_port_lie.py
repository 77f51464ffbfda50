"""The PyTorch port's so(3)/se(3) exponential and logarithm maps held
against livingscenes_tpu/se3.py on the CPU, values and gradients, at the
origin (where the refinement takes its first gradient), just beside the
Taylor switch, and away from it.

Tolerances: f64, rtol 1e-12 and atol 1e-14 (the same formulas; rounding
only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu import se3 as jse3
from livingscenes_tpu_torch import se3
from torch_threads import intra_op_share  # noqa: F401 (autouse)

TOL = dict(rtol=1e-12, atol=1e-14)


def tangents(seed, dim):
    """Rows: zero, below and above the Taylor switch (|w|^2 = 1e-12), small,
    moderate and large."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(6, dim))
    v /= np.linalg.norm(v[:, -3:], axis=-1, keepdims=True)
    scale = np.array([0.0, 0.9e-6, 1.1e-6, 1e-3, 0.7, 2.5])
    return v * scale[:, None]


def grad_pair(fn_t, fn_j, arg, cot):
    """Gradients of sum(cot * fn(arg)) on both sides."""
    a = torch.tensor(arg, requires_grad=True)
    (gt,) = torch.autograd.grad(torch.sum(torch.as_tensor(cot) * fn_t(a)), a)
    gj = jax.grad(lambda v: jnp.sum(jnp.asarray(cot) * fn_j(v)))(jnp.asarray(arg))
    return gt.numpy(), np.asarray(gj)


def test_hat_matches_jax():
    w = tangents(0, 3)
    np.testing.assert_array_equal(se3.hat(torch.as_tensor(w)).numpy(),
                                  np.asarray(jse3.hat(jnp.asarray(w))))


@pytest.mark.parametrize("name,dim,shape", [("so3_exp", 3, (3, 3)), ("se3_exp", 6, (3, 4))])
def test_exp_and_gradient_match_jax(name, dim, shape):
    v = tangents(1, dim)
    fn_t, fn_j = getattr(se3, name), getattr(jse3, name)
    got = fn_t(torch.as_tensor(v))
    assert got.shape == (6,) + shape and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(fn_j(jnp.asarray(v))), **TOL)
    cot = np.random.default_rng(2).normal(size=(6,) + shape)
    gt, gj = grad_pair(fn_t, fn_j, v, cot)
    assert np.isfinite(gt).all()
    np.testing.assert_allclose(gt, gj, **TOL)
    # at the origin the exponential's derivative is the hat map itself
    if name == "so3_exp":
        want0 = np.array([cot[0, 2, 1] - cot[0, 1, 2], cot[0, 0, 2] - cot[0, 2, 0],
                          cot[0, 1, 0] - cot[0, 0, 1]])
        np.testing.assert_allclose(gt[0], want0, **TOL)


def test_exp_is_a_rotation_and_log_inverts_it():
    w = tangents(3, 3)
    R = se3.so3_exp(torch.as_tensor(w))
    eye = torch.eye(3, dtype=torch.float64).expand(6, 3, 3)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, rtol=0, atol=1e-14)
    torch.testing.assert_close(se3.so3_log(R), torch.as_tensor(w), rtol=1e-9, atol=1e-15)


def test_log_and_gradient_match_jax():
    w = tangents(4, 3)
    R = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    np.testing.assert_allclose(se3.so3_log(torch.tensor(R)).numpy(),
                               np.asarray(jse3.so3_log(jnp.asarray(R))), **TOL)
    cot = np.random.default_rng(5).normal(size=(6, 3))
    gt, gj = grad_pair(se3.so3_log, jse3.so3_log, np.array(R), cot)
    # at the identity arccos has no finite slope: both sides give NaN on the
    # diagonal there (the trace's entries), and agree everywhere else
    assert np.isfinite(gt[1:]).all()
    np.testing.assert_allclose(gt, gj, rtol=1e-9, atol=1e-12, equal_nan=True)


def test_float32_keeps_its_dtype():
    xi = torch.zeros((2, 6), dtype=torch.float32, requires_grad=True)
    g = se3.se3_exp(xi)
    assert g.dtype == torch.float32
    (grad,) = torch.autograd.grad(g.sum(), xi)
    assert bool(torch.isfinite(grad).all())
