"""An autouse fixture for the port's test files (`from torch_threads import
intra_op_share`): under pytest-xdist, each worker's PyTorch intra-op pool
is cut to its share of the machine's cores (cores // workers, at least 1)
for the length of the test file, then restored. With six workers each
running a pool as wide as the machine, every parallel region waits on
threads that other processes have preempted: a test of the small models
took 40 times longer under a full tier-1 run than alone."""
import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def intra_op_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // workers))
    yield
    torch.set_num_threads(before)
