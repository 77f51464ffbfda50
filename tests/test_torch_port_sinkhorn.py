"""The PyTorch port's Sinkhorn divergence (ops/sinkhorn.py) and the plain
versions of its kernels (ops/cuda_sinkhorn.py) held against the JAX package
on the CPU. The same numpy clouds, made from a seed, go into both sides; the
Pallas kernels run in interpret mode, as tests/test_sinkhorn_fidelity.py
runs them.

Tolerances:
  * plain potentials and iterates against the Pallas kernels, f32: rtol and
    atol 1e-5 on values, rtol 1e-4 (atol 1e-7) on gradients, the bounds the
    JAX package holds its kernels to against its XLA path;
  * against `_sym_potentials` / `sinkhorn_divergence` / `sinkhorn_yy_term`
    of the JAX package in f64: rtol 1e-9, atol 1e-12. The port's kernel
    route expands the cost (|x|^2/2 + |y|^2/2 - x.y) where JAX's CPU path
    takes squared differences: the two agree to rounding in f64.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.ops import pallas_sinkhorn as jps
from livingscenes_tpu.ops import sinkhorn as jsk
from livingscenes_tpu_torch.ops import cuda_sinkhorn, sinkhorn
from torch_threads import intra_op_share  # noqa: F401 (autouse)

F64 = dict(rtol=1e-9, atol=1e-12)


def clouds(seed, B, N, M, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.5, 0.5, size=(B, N, 3)) * [1.0, 0.6, 0.3]
    y = rng.uniform(-0.5, 0.5, size=(B, M, 3)) * [1.0, 0.6, 0.3] + 0.05
    return x.astype(dtype), y.astype(dtype)


@pytest.mark.parametrize("kwargs", [dict(blur=0.05), dict(blur=0.05, diameter=0.7),
                                    dict(blur=0.3, scaling=0.7, tail=1), dict(blur=3.0)])
def test_eps_annealing_schedule_matches_jax(kwargs):
    got = sinkhorn.eps_annealing_schedule(**kwargs)
    assert got == jsk.eps_annealing_schedule(**kwargs)
    assert got[-1] == kwargs["blur"] ** 2


def test_refinement_schedule_has_eight_steps():
    assert len(sinkhorn.eps_annealing_schedule(0.05, 2.0)) == 8


@pytest.mark.parametrize("N,M,schedule", [
    (48, 48, tuple(jsk.eps_annealing_schedule(0.05))),
    (40, 56, tuple(jsk.eps_annealing_schedule(0.1))),
    (32, 24, (0.01,) * 4),
])
def test_plain_potentials_match_pallas_interpret(N, M, schedule):
    x, y = clouds(0, 2, N, M, np.float32)
    fj, gj = jps.ot_extrapolated_potentials(
        jnp.asarray(x), jnp.asarray(y), schedule, interpret=True)
    fij, gij = jps.sinkhorn_iterates(jnp.asarray(x), jnp.asarray(y), schedule, interpret=True)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    ft, gt = cuda_sinkhorn.ot_extrapolated_potentials(xt, yt, schedule)
    fit, git = cuda_sinkhorn.sinkhorn_iterates(xt, yt, schedule)
    assert ft.shape == (2, N) and gt.shape == (2, M) and ft.dtype == torch.float32
    for got, want in ((ft, fj), (gt, gj), (fit, fij), (git, gij)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N,M", [(48, 48), (40, 56)])
def test_plain_potentials_gradient_matches_pallas_interpret(N, M):
    schedule = tuple(jsk.eps_annealing_schedule(0.05))
    x, y = clouds(1, 2, N, M, np.float32)
    rng = np.random.default_rng(2)
    cf, cg = rng.normal(size=(2, N)).astype(np.float32), rng.normal(size=(2, M)).astype(np.float32)

    def total_j(xv, yv):
        f, g = jps.ot_extrapolated_potentials(xv, yv, schedule, interpret=True)
        return jnp.sum(jnp.asarray(cf) * f) + jnp.sum(jnp.asarray(cg) * g)

    wx, wy = jax.grad(total_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    f, g = cuda_sinkhorn.ot_extrapolated_potentials(xt, yt, schedule)
    gx, gy = torch.autograd.grad(
        torch.sum(torch.from_numpy(cf) * f) + torch.sum(torch.from_numpy(cg) * g), (xt, yt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("schedule,iters,detach", [
    (jsk.eps_annealing_schedule(0.05), 30, True),
    (jsk.eps_annealing_schedule(0.1), 30, False),
    ([0.01], 6, True),
    ([0.01], 1, False),
])
def test_sym_potentials_match_jax(schedule, iters, detach):
    x, y = clouds(3, 2, 20, 28)
    C = 0.5 * np.sum((x[:, :, None] - y[:, None]) ** 2, -1)
    fj, gj = jsk._sym_potentials(jnp.asarray(C), schedule, iters, detach_iters=detach)
    ft, gt = sinkhorn._sym_potentials(torch.from_numpy(C), schedule, iters, detach_iters=detach)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **F64)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), **F64)
    np.testing.assert_allclose(sinkhorn._sq_cost(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
                               C, **F64)
    # the gradient with respect to the cost matrix, through every iterate or
    # through the final pair alone
    wC = jax.grad(lambda c: sum(jnp.sum(p) for p in jsk._sym_potentials(
        c, schedule, iters, detach_iters=detach)))(jnp.asarray(C))
    Ct = torch.tensor(C, requires_grad=True)
    (gC,) = torch.autograd.grad(
        sum(p.sum() for p in sinkhorn._sym_potentials(Ct, schedule, iters, detach_iters=detach)), Ct)
    np.testing.assert_allclose(gC.numpy(), np.asarray(wC), rtol=1e-8, atol=1e-12)


DIVERGENCE_CASES = [
    # (N, M, batched, kwargs)
    (24, 24, True, dict(anneal=True, implicit_grad=True)),          # the refinement's settings
    (20, 30, True, dict(anneal=True, implicit_grad=True)),          # N != M
    (20, 30, False, dict(anneal=True, implicit_grad=True)),         # unbatched
    (20, 30, True, dict(anneal=True, implicit_grad=False)),         # through every iterate
    (24, 16, True, dict(anneal=False, iters=8, implicit_grad=True, blur=0.1)),
    (24, 16, False, dict(anneal=False, iters=8, implicit_grad=False, blur=0.1)),
    (24, 16, True, dict(anneal=True, implicit_grad=True, pallas=False, diameter=1.0)),
]


@pytest.mark.parametrize("N,M,batched,kwargs", DIVERGENCE_CASES)
@pytest.mark.parametrize("pass_yy", [False, True])
def test_sinkhorn_divergence_and_gradient_match_jax(N, M, batched, kwargs, pass_yy):
    x, y = clouds(4, 3, N, M)
    if not batched:
        x, y = x[0], y[0]
    yy_kwargs = {k: v for k, v in kwargs.items() if k != "implicit_grad"}
    half_j = jsk.sinkhorn_yy_term(jnp.asarray(y), **yy_kwargs) if pass_yy else None
    xt = torch.tensor(x, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    half_t = None
    if pass_yy:
        half_t = sinkhorn.sinkhorn_yy_term(yt, **yy_kwargs)
        assert not half_t.requires_grad
        np.testing.assert_allclose(half_t.numpy(), np.asarray(half_j), **F64)

    def total_j(xv, yv):
        return jnp.sum(jsk.sinkhorn_divergence(xv, yv, half_ot_yy=half_j, **kwargs))

    want = jsk.sinkhorn_divergence(jnp.asarray(x), jnp.asarray(y), half_ot_yy=half_j, **kwargs)
    wx, wy = jax.grad(total_j, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    got = sinkhorn.sinkhorn_divergence(xt, yt, half_ot_yy=half_t, **kwargs)
    assert got.shape == ((3,) if batched else ())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F64)
    gx, gy = torch.autograd.grad(got.sum(), (xt, yt))
    np.testing.assert_allclose(gx.numpy(), np.asarray(wx), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=1e-8, atol=1e-12)


def test_divergence_of_a_cloud_with_itself_is_zero():
    x, _ = clouds(5, 2, 32, 32)
    xt = torch.from_numpy(x)
    d = sinkhorn.sinkhorn_divergence(xt, xt.clone(), anneal=True, implicit_grad=True)
    np.testing.assert_allclose(d.numpy(), 0.0, atol=1e-14)


def test_kernel_route_is_taken_only_with_implicit_grad(monkeypatch):
    calls = []
    real = sinkhorn.ot_extrapolated_potentials
    monkeypatch.setattr(sinkhorn, "ot_extrapolated_potentials",
                        lambda *a: calls.append(a[2]) or real(*a))
    x, y = (torch.from_numpy(a) for a in clouds(6, 1, 12, 12))
    sinkhorn.sinkhorn_divergence(x, y, anneal=True, implicit_grad=True)
    assert len(calls) == 3 and len(calls[0]) == 8  # xy, xx, yy on the refinement's schedule
    sinkhorn.sinkhorn_divergence(x, y, anneal=True, implicit_grad=False)
    sinkhorn.sinkhorn_divergence(x, y, anneal=True, implicit_grad=True, pallas=False)
    assert len(calls) == 3
    sinkhorn.sinkhorn_divergence(x, y, iters=1, implicit_grad=True)
    assert calls[-1] == (0.05 ** 2,)  # a single temperature is repeated max(iters - 1, 1) times
    sinkhorn.sinkhorn_yy_term(y, iters=5)
    assert calls[-1] == (0.05 ** 2,) * 4


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros((1, 8, 3))
    f = torch.zeros((1, 8))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sinkhorn.extrapolated_forward_cuda(x, x, (0.1,))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sinkhorn.sinkhorn_iterates_cuda(x, x, (0.1,))
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sinkhorn.extrapolated_backward_cuda(x, x, f, f, f, f, f, None, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_sinkhorn.ot_extrapolated_potentials(x.to("meta"), x.to("meta"), (0.1,))
