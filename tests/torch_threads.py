"""Pins torch's intra-op threads in the processes of the port's tests.

Every ``tests/test_torch_*.py`` imports this module first, so each
pytest-xdist worker pins its threads when it collects them.  Under
pytest-xdist (``PYTEST_XDIST_WORKER_COUNT`` workers) a worker takes its
share of the host's CPUs, at least one: otherwise each worker runs as many
threads as the host has CPUs, beside the other workers, the gloo ranks
they spawn and the JAX oracle subprocesses, and the oversubscribed host
runs the tests many times slower than alone.  A run in one process keeps
torch's default.  The worlds of gloo ranks take ``RANK_THREADS`` each
(``run_ranks(threads=)``): several ranks share their worker's share.
"""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT") or 0)
THREADS = (max(1, len(os.sched_getaffinity(0)) // WORKERS) if WORKERS
           else None)
RANK_THREADS = 1

if THREADS is not None:
    torch.set_num_threads(THREADS)
