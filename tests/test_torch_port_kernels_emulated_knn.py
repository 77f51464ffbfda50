"""The kNN and kNN + scale kernels (csrc/knn.cu, csrc/knn_topk.cu) on CPU
threads, held against their plain versions.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. Apart from the other kernels' cases
so that no one file sets the length of a run of the tests over several
workers; the kNN + scale kernel past 4096 points has a file of its own
(tests/test_torch_port_kernels_emulated_knn_cap.py).

Tolerances: indices equal (the inputs are exact in f32 where ties occur;
random reals have no near-ties at these sizes), distances equal on exact
inputs and within rtol 1e-5 plus atol 1e-5 of the largest on random reals
(another summation order than the plain matmul); the scale statistic
rtol 1e-6.
"""
import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.ops import cuda_knn
from livingscenes_tpu_torch.ops.knn import knn
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    emulated, f32, lattice, on_host)
from torch_threads import intra_op_share  # noqa: F401 (autouse)


@pytest.mark.parametrize("Nq,Np,D,k", [(70, 100, 3, 16), (33, 150, 48, 16), (20, 20, 96, 7)])
def test_knn_kernel(on_host, Nq, Np, D, k):
    rng = np.random.default_rng(1)
    # small integers: every product and sum is exact, ties are real ties
    p = torch.as_tensor(rng.integers(-3, 4, (2, Np, D)).astype(np.float32))
    q = p[:, :Nq].contiguous()
    dk, ik = cuda_knn.knn_cuda(q, p, k)
    dp, ip = knn(q, p, k)
    assert torch.equal(ik.long(), ip)
    assert torch.equal(dk, dp)


@pytest.mark.parametrize("form", [1, 2, 3])
@pytest.mark.parametrize(
    "Nq,Np,D,k",
    [
        (70, 300, 50, 16),  # a partial query tile, three source tiles, D % 16
        (40, 12, 21, 10),   # fewer sources than 16, k < 16
        (32, 128, 48, 16),  # the shape of layer 5
        (20, 33, 200, 16),  # two 32-source tiles, 13 chunks over 8 groups
        (128, 200, 24, 5),  # layer 4's query count, k < 16
    ],
)
def test_knn_kernel_forms(on_host, form, Nq, Np, D, k):
    rng = np.random.default_rng(15)
    # small integers, exact: ties within and across the lanes and tiles
    p = torch.as_tensor(rng.integers(-2, 3, (2, Np, D)).astype(np.float32))
    q = torch.as_tensor(rng.integers(-2, 3, (2, Nq, D)).astype(np.float32))
    dk, ik = cuda_knn.knn_cuda(q, p, k, form)
    dp, ip = knn(q, p, k)
    assert torch.equal(ik.long(), ip)
    assert torch.equal(dk, dp)
    # random reals: the filter against the query's 16th, no exact ties
    pr, qr = f32(rng, 2, Np, D), f32(rng, 2, Nq, D)
    dk, ik = cuda_knn.knn_cuda(qr, pr, k, form)
    dp, ip = knn(qr, pr, k)
    assert torch.equal(ik.long(), ip)
    torch.testing.assert_close(dk, dp, rtol=1e-5, atol=1e-5 * float(dp.max()))


@pytest.mark.parametrize(
    "N,k,tied",
    [(100, 16, False), (256, 16, True),
     (20, 5, False),      # fewer points than the 64 that seed the lists
     (1100, 16, False)],  # three column chunks of 512, the last ragged
)
def test_knn_topk_kernel(on_host, N, k, tied):
    rng = np.random.default_rng(2)
    pc = f32(rng, 2, N, 3)
    if tied:
        pc[0] = lattice(rng, (8, 8, 4))
    ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, k)
    ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, k)
    assert ik.dtype == torch.int32 and torch.equal(ik.long(), ip)
    torch.testing.assert_close(sk, sp, rtol=1e-6, atol=0)
