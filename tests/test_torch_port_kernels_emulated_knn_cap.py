"""The kNN + scale kernel (csrc/knn_topk.cu) past the 4096 points it once
refused, on CPU threads, held against its plain version.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. The
longest of the emulated cases, in a file of its own so that no one file
sets the length of a run of the tests over several workers.

Tolerances: graph and scale equal (the kernel's distances are the plain
version's bits).
"""
import numpy as np
import pytest
import torch

from livingscenes_tpu_torch.ops import cuda_knn
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    emulated, f32, lattice, on_host)
from torch_threads import intra_op_share  # noqa: F401 (autouse)


@pytest.mark.parametrize("tied", [False, True])
def test_knn_topk_kernel_past_old_cap(on_host, tied):
    # 4352 points, past the 4096 the kernel once refused: 8.5 column chunks;
    # tied: a 17 x 16 x 16 lattice. The distances are the plain version's
    # bits, so graph and scale are equal.
    rng = np.random.default_rng(21)
    pc = lattice(rng, (17, 16, 16))[None] if tied else f32(rng, 1, 4352, 3)
    ik, sk = cuda_knn.knn_with_topk_scale_cuda(pc, 16)
    ip, sp = cuda_knn.knn_with_topk_scale_plain(pc, 16)
    assert torch.equal(ik.long(), ip)
    assert torch.equal(sk, sp)
