"""Torch's intra-op pool sized to this test process's share of the host.

Under pytest-xdist, torch's default pool of a thread a core in every
worker oversubscribes the host: under six workers a CPU train of the
port's plain kernels that takes 0.5 s alone takes 10-20 s. A port test
module that imports ``torch_worker_threads`` runs its tests with
``worker_threads()`` threads, restored after the module: max(1, cores //
workers) under xdist (``PYTEST_XDIST_WORKER_COUNT``), torch's own default
outside it. ``DEFAULT_THREADS`` is torch's default, read at import, for
the cases that hold the port to the JAX package at it."""
import os

import pytest
import torch

DEFAULT_THREADS = torch.get_num_threads()


def worker_threads() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
    if workers <= 1:
        return DEFAULT_THREADS
    return max(1, len(os.sched_getaffinity(0)) // workers)


@pytest.fixture(autouse=True, scope="module")
def torch_worker_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(worker_threads())
    yield
    torch.set_num_threads(old)
