"""One torch intra-op thread while a port test module runs on the CPU.

The test run shares the host's cores among several worker processes
(pytest-xdist); torch's default of one OpenMP thread per core in each of them
oversubscribes the host, and every parallel region then waits on threads that
are not scheduled: `tests/test_torch_bench.py` took 13 s alone and 272 s in a
six-worker run on eight cores. A port test module imports `one_torch_thread`,
an autouse fixture, to run its tests with one thread (restored after the
module); `TORCH_SUBPROCESS_ENV` does the same for the processes a test starts.
"""

import os

import pytest
import torch

TORCH_SUBPROCESS_ENV = {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)
