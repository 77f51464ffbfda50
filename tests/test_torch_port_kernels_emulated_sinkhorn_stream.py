"""The Sinkhorn forward kernel (csrc/sinkhorn.cu) on clouds past one tile
of its streamed sides, on CPU threads, held against its plain version.

The kernels' own code (livingscenes_tpu_torch/csrc/*.cu) built by the
host's g++ against the stand-in for the CUDA runtime and run on CPU
threads: the stand-in, the build and the `on_host` fixture are those of
tests/test_torch_port_kernels_emulated.py, whose docstring says what this
shows and what it cannot. 8192 + 6144 points stream through shared memory
in two tiles of at most 4096 points each side, on a cluster of 8 blocks.
The longest of the emulated Sinkhorn cases, in a file of its own so that
no one file sets the length of a run of the tests over several workers.

Tolerances: the potentials and iterates rtol/atol 1e-5, as in
tests/test_torch_port_kernels_emulated_sinkhorn.py.
"""
import numpy as np
import torch

from livingscenes_tpu_torch.ops import cuda_sinkhorn
from test_torch_port_kernels_emulated import (  # noqa: F401 (fixtures)
    emulated, f32, on_host)
from test_torch_port_kernels_emulated_sinkhorn import check_forward
from torch_threads import intra_op_share  # noqa: F401 (autouse)


def test_sinkhorn_kernel_past_staging(on_host):
    rng = np.random.default_rng(28)
    x = f32(rng, 1, 8192, 3, scale=0.3)
    y = f32(rng, 1, 6144, 3, scale=0.3) + 0.1
    plan = cuda_sinkhorn.forward_plan(1, 8192, 6144)
    assert plan["cluster"] == 8 and plan["tile"] == 4096
    check_forward(x, y, [0.05, 0.01])
