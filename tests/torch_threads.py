"""Torch's intra-op threads for the port's CPU test modules.

Under pytest-xdist each worker process would start a thread pool as wide
as the machine, so the workers' pools oversubscribe the cores and slow
every other worker, the JAX tests' included. A module that imports
``torch_threads_share`` runs its tests with its worker's share of the
cores (at least one thread) and restores torch's setting afterwards; run
without workers, nothing changes."""

import os

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def torch_threads_share():
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
    if workers < 2:
        yield
        return
    before = torch.get_num_threads()
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))
    yield
    torch.set_num_threads(before)
