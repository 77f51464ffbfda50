"""The Sinkhorn kernels (csrc/sinkhorn.cu: the forward on a thread-block
cluster a pair, its iterates, the backward) on CPU threads, held against
their plain versions and, at one shape, against the JAX package's Pallas
kernels in interpret mode.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. The stand-in runs the blocks of a cluster at the
same time, with a barrier over all their threads for cluster.sync(), so a
peer's slice of the potentials read before it was written, or after it
was overwritten, gives a wrong answer. In a file of its own so that no one file sets the length of a run
of the tests over several workers; the clouds past one tile of the
streamed sides are in tests/test_torch_port_kernels_emulated_sinkhorn_stream.py.

Tolerances: the potentials rtol/atol 1e-5 and their gradient rtol 1e-4
plus atol 1e-6 against the f32 plain versions (f32 rounding of arguments up
to 1e3 in the exponentials); against the Pallas kernels the bounds of
tests/test_torch_port_sinkhorn.py (values rtol/atol 1e-5, gradients rtol
1e-4 and atol 1e-7): f32 rounding of the expanded cost over eps, which both
sides share. The backward sums in a fixed order, so two launches give the
same bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livingscenes_tpu.ops import pallas_sinkhorn as jps
from livingscenes_tpu_torch.ops import cuda_sinkhorn
from livingscenes_tpu_torch.ops.sinkhorn import eps_annealing_schedule
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    emulated, f32, on_host)
from torch_threads import intra_op_share  # noqa: F401 (autouse)

SINKHORN_SHAPES = [
    # N, M, schedule
    (50, 50, eps_annealing_schedule(0.05)),   # the refinement's schedule
    (70, 33, eps_annealing_schedule(0.1)),    # N != M, no multiple of a warp
    (20, 45, [0.01] * 5),                     # a single temperature, repeated
]


def sinkhorn_clouds(rng, N, M, B=2):
    x = f32(rng, B, N, 3, scale=0.3)
    y = f32(rng, B, M, 3, scale=0.3) + 0.1
    return x, y


def check_forward(x, y, schedule):
    """The forward and the iterates against the plain versions."""
    got = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    want = cuda_sinkhorn.ot_extrapolated_potentials_plain(x, y, schedule)
    want += cuda_sinkhorn.sinkhorn_iterates_plain(x, y, schedule)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    # the same code stopped before the final pair
    for g, w in zip(cuda_sinkhorn.sinkhorn_iterates_cuda(x, y, schedule), want[2:]):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
    return got


def plain_grad(x, y, schedule, cf, cg):
    with torch.enable_grad():
        xv, yv = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
        f, g = cuda_sinkhorn.ot_extrapolated_potentials_plain(xv, yv, schedule)
        total = sum(torch.sum(c * p) for c, p in ((cf, f), (cg, g)) if c is not None)
        return torch.autograd.grad(total, (xv, yv))


@pytest.mark.parametrize("N,M,schedule", SINKHORN_SHAPES)
def test_sinkhorn_kernel(on_host, N, M, schedule):
    x, y = sinkhorn_clouds(np.random.default_rng(8), N, M)
    check_forward(x, y, schedule)


@pytest.mark.parametrize("N,M,schedule", SINKHORN_SHAPES)
@pytest.mark.parametrize("cots", ["both", "f_only", "g_only"])
def test_sinkhorn_bwd_kernel(on_host, N, M, schedule, cots):
    rng = np.random.default_rng(9)
    x, y = sinkhorn_clouds(rng, N, M)
    cf = f32(rng, 2, N) if cots != "g_only" else None
    cg = f32(rng, 2, M) if cots != "f_only" else None
    saved = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    dx, dy = cuda_sinkhorn.extrapolated_backward_cuda(
        x, y, *saved, cf, cg, schedule[-1])
    wx, wy = plain_grad(x, y, schedule, cf, cg)
    torch.testing.assert_close(dx, wx, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dy, wy, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize(
    "B,N,M,cluster",
    [
        (40, 77, 45, 2),    # slices of 39 and 38 rows, 23 and 22 columns
        (20, 150, 97, 4),   # 38-row slices, eight parts a row group
        (2, 25, 70, 8),     # 4-row slices, the last block's empty
        (33, 40, 30, 4),
        (67, 2100, 20, 1),  # one block a pair: two batches of row groups
    ],
)
def test_sinkhorn_kernel_cluster_split(on_host, B, N, M, cluster):
    # the refinement's schedule on clusters of 1-8 blocks, the size the
    # plan gives B pairs on 132 SMs, at shapes that no slice of cluster x 32
    # divides
    x, y = sinkhorn_clouds(np.random.default_rng(23), N, M, B=B)
    plan = cuda_sinkhorn.forward_plan(B, N, M)
    assert plan["cluster"] == cluster and plan["tile"] >= max(N, M)
    check_forward(x, y, eps_annealing_schedule(0.05))


def test_sinkhorn_plan_defaults(on_host):
    # the largest cluster whose blocks fit the SMs (132 on the H100, as
    # the stand-in says) in one wave: the refinement's 64 pairs on clusters
    # of 2, two pairs on 8; a side in one tile up to 4096 points, the
    # potentials' double buffer in the scratch
    plan = cuda_sinkhorn.forward_plan
    assert plan(64, 1024, 1024) == {"cluster": 2, "threads": 512, "tile": 1024,
                                    "scratch": 2 * 2048}
    assert plan(200, 50, 50) == {"cluster": 1, "threads": 128, "tile": 64,
                                 "scratch": 200}
    assert plan(2, 6144, 4096) == {"cluster": 8, "threads": 512, "tile": 4096,
                                   "scratch": 2 * (6144 + 4096)}
    assert plan(1, 8192, 6144)["cluster"] == 8


@pytest.mark.parametrize("N,M,cots", [(300, 1100, "both"), (129, 2100, "g_only"),
                                      (260, 1030, "f_only")])
def test_sinkhorn_bwd_kernel_tiles(on_host, N, M, cots):
    # three row tiles (the last ragged) whose column sums the last block
    # folds; columns in two or three staged tiles
    rng = np.random.default_rng(25)
    x, y = sinkhorn_clouds(rng, N, M, B=1)
    schedule = [0.05, 0.01]
    cf = f32(rng, 1, N) if cots != "g_only" else None
    cg = f32(rng, 1, M) if cots != "f_only" else None
    saved = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    dx, dy = cuda_sinkhorn.extrapolated_backward_cuda(x, y, *saved, cf, cg, schedule[-1])
    wx, wy = plain_grad(x, y, schedule, cf, cg)
    torch.testing.assert_close(dx, wx, rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(dy, wy, rtol=1e-4, atol=1e-6)


def test_sinkhorn_bwd_kernel_repeats(on_host):
    # fixed-order sums: two launches give the same bits, and the last block
    # of each pair set its counter back to 0
    rng = np.random.default_rng(26)
    x, y = sinkhorn_clouds(rng, 300, 140, B=3)
    schedule = eps_annealing_schedule(0.05)
    cf, cg = f32(rng, 3, 300), f32(rng, 3, 140)
    saved = cuda_sinkhorn.extrapolated_forward_cuda(x, y, schedule)
    first, again = (cuda_sinkhorn.extrapolated_backward_cuda(
        x, y, *saved, cf, cg, schedule[-1]) for _ in range(2))
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert not bool(cuda_sinkhorn.pair_counters(x, 3).any())


def test_sinkhorn_bwd_kernel_needs_a_cotangent(on_host):
    # no cotangent: refused before any launch, so every backward result
    # comes from a counted launch
    x, y = sinkhorn_clouds(np.random.default_rng(29), 40, 30)
    saved = cuda_sinkhorn.extrapolated_forward_cuda(x, y, [0.05])
    before = cuda_sinkhorn.bwd_launches
    with pytest.raises(ValueError, match="cf and cg"):
        cuda_sinkhorn.extrapolated_backward_cuda(x, y, *saved, None, None, 0.05)
    assert cuda_sinkhorn.bwd_launches == before


def test_sinkhorn_kernels_match_pallas_interpret(on_host):
    # the emulated kernels against the JAX package's Pallas kernels (run in
    # interpret mode) on the same clouds: potentials and the gradient; two
    # pairs take clusters of 8 blocks
    N = 50
    schedule = tuple(eps_annealing_schedule(0.05))
    rng = np.random.default_rng(27)
    x = (rng.uniform(-0.5, 0.5, (2, N, 3)) * [1.0, 0.6, 0.3]).astype(np.float32)
    y = (rng.uniform(-0.5, 0.5, (2, N, 3)) * [1.0, 0.6, 0.3] + 0.05).astype(np.float32)
    cf = rng.normal(size=(2, N)).astype(np.float32)
    cg = rng.normal(size=(2, N)).astype(np.float32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    fj, gj = jps.ot_extrapolated_potentials(xj, yj, schedule, interpret=True)
    fij, gij = jps.sinkhorn_iterates(xj, yj, schedule, interpret=True)

    def total(xv, yv):
        f, g = jps.ot_extrapolated_potentials(xv, yv, schedule, interpret=True)
        return jnp.sum(jnp.asarray(cf) * f) + jnp.sum(jnp.asarray(cg) * g)

    wx, wy = jax.grad(total, argnums=(0, 1))(xj, yj)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    assert cuda_sinkhorn.forward_plan(2, N, N)["cluster"] == 8
    got = cuda_sinkhorn.extrapolated_forward_cuda(xt, yt, schedule)
    it = cuda_sinkhorn.sinkhorn_iterates_cuda(xt, yt, schedule)
    for g, w in zip(list(got[:2]) + list(it), (fj, gj, fij, gij)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    dx, dy = cuda_sinkhorn.extrapolated_backward_cuda(
        xt, yt, *got, torch.from_numpy(cf), torch.from_numpy(cg), schedule[-1])
    np.testing.assert_allclose(dx.numpy(), np.asarray(wx), rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(dy.numpy(), np.asarray(wy), rtol=1e-4, atol=1e-7)
