"""Carry dataplane words between the JAX package and the port.

The reference keeps words (arenas, keys, records, replies) as ``uint32``;
the port keeps the same words as ``int32`` bit images.  These helpers move
them across as numpy arrays — ``state_from_numpy`` takes the reference's
state (``{"arena": (N, words) uint32}``, e.g. ``jax.device_get(state)``) and
returns the port's tensors on ``device``; ``state_to_numpy`` is the inverse.
Nothing changes but the type label, so a round trip is bit-exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def words(a, device="cuda") -> torch.Tensor:
    """Integers in [0, 2**32) (any numpy-convertible array) as an int32
    word tensor on ``device``."""
    a = np.ascontiguousarray(np.asarray(a).astype(np.uint32))
    return torch.from_numpy(a.view(np.int32)).to(resolve_device(device))


def to_numpy(x: torch.Tensor) -> np.ndarray:
    """An int32 word tensor as numpy uint32 (bool and other dtypes as is)."""
    a = x.detach().cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def state_from_numpy(state, device="cuda"):
    return {k: words(v, device) for k, v in state.items()}


def state_to_numpy(state):
    return {k: to_numpy(v) for k, v in state.items()}
