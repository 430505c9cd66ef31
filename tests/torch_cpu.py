"""The thread rule of the port's CPU tests: torch runs on one intra-op
thread. Every tests/test_torch_*.py that runs on the CPU takes it with

    from tests.torch_cpu import one_torch_thread  # noqa: F401

The tier-1 run puts several pytest workers on one host, and torch's
default pool (one thread a core) in each of them beside JAX's own pool
makes the threads wait on each other: a small test took seven times as
long. The test shapes gain nothing from more threads. Every comparison
of two torch results in a file runs both at this one count, and the
processes the tests spawn (tests/torch_parallel_worker.py,
tests/torch_multihost_worker.py) set the same count: CPU matrix
products can round by thread count.
"""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for the module, the old count restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
