"""torch's intra-op thread pool for the port's slow test files.

Under xdist each worker would otherwise start a pool of every core, which
oversubscribes the host several times over. A slow file takes the fixture
with ``from tests.test_torch_threads import torch_threads  # noqa: F401``.
"""
import os

import pytest
import torch


def thread_share() -> int:
    """One xdist worker's share of the host's cores (at least 1)."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, os.cpu_count() // workers)


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    """torch's intra-op threads set to ``thread_share()`` for the module,
    restored after it."""
    old = torch.get_num_threads()
    torch.set_num_threads(thread_share())
    yield
    torch.set_num_threads(old)


def test_torch_threads_take_one_share_of_the_cores():
    assert torch.get_num_threads() == thread_share()
    assert 1 <= thread_share() <= os.cpu_count()
