"""Each test process's share of the CPU, for the port's tests.

pytest-xdist runs several test processes on one machine.  A torch process
starts its intra-op (OpenMP) pool as wide as the machine, so with six
workers on eight CPUs the plain versions' many small tensor operations
wait on the other processes' spinning threads.  Every
``tests/test_torch_*.py`` imports this module, which caps this process's
intra-op pool at the CPUs it may run on divided by the number of xdist
workers (``PYTEST_XDIST_WORKER_COUNT``; one outside xdist), and at least
one.  ``torch.set_num_threads`` sets OpenMP's count too.  Only the tests
are capped: the package sets no thread count, so the card's host keeps
its pools."""

import os

import torch


def share():
    """The CPUs this process may run on, over the xdist workers."""
    workers = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '1'))
    return max(1, len(os.sched_getaffinity(0)) // workers)


torch.set_num_threads(share())
