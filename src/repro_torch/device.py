"""Device selection for the port's entry points.

Every entry point (``hashtable.init_cluster_state``, ``txloop.tx_loop``, the
workload builders) takes ``device=`` and defaults to ``"cuda"``.  There is no
quiet CPU path: without a GPU the call raises unless the caller asked for the
CPU, as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
