"""Give torch's CPU pool in each pytest-xdist worker its share of the cores.

torch runs that pool on OpenMP, which otherwise takes every core in each
worker, so the workers' threads spin against each other. Outside xdist this
module leaves torch's default. Every ``tests/test_torch_*.py`` imports it
first.
"""
import os

import torch


def thread_share():
    """Threads for this worker's torch pool: the CPUs this process may run
    on, divided among the xdist workers; None outside xdist."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


def apply_share():
    share = thread_share()
    if share is not None:
        torch.set_num_threads(share)


apply_share()
