"""Each test worker's share of the CPU cores for torch's intra-op threads.

The suite runs in several pytest-xdist workers at once, and torch starts as
many intra-op threads as the process may use cores, in every worker: with 6
workers on 8 cores, 48 threads contend for 8, and a test that takes 10 s
alone takes 230 s.  The port's test modules import ``torch_threads``, an
autouse fixture that gives torch ``cores // workers`` threads (at least one)
while the module's tests run, and restores the count after; run alone, a
module keeps every core.

    from torch_threads import torch_threads  # noqa: F401  (autouse)
"""
import os

import pytest
import torch


def cores_per_worker() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, len(os.sched_getaffinity(0)) // max(1, workers))


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(before, cores_per_worker()))
    yield
    torch.set_num_threads(before)
