"""Carry data between the JAX package and the port.

Dataplane words: the reference keeps words (arenas, keys, records, replies)
as ``uint32``; the port keeps the same words as ``int32`` bit images.
``state_from_numpy`` takes the reference's state (``{"arena": (N, words)
uint32}``, e.g. ``jax.device_get(state)``) and returns the port's tensors on
``device``; ``state_to_numpy`` is the inverse.

Model parameters: ``params_from_numpy`` takes the reference's parameter tree
as numpy arrays (nested dicts) and returns the port's tree on ``device``;
``params_to_numpy`` is the inverse; ``params_block`` cuts a rank's blocks
of a whole tree for a mesh.  A train state (``{"params", "opt":
{"master", "m", "v", "step"}}``) crosses in with ``train_state_from_numpy``
and back with ``params_to_numpy``.  JAX's bf16 arrays come out of
``np.asarray`` as ``ml_dtypes.bfloat16``, which torch cannot read, so they
cross as 16-bit integer images.  Nothing changes but the type label, so
round trips are bit-exact.
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


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """One array (bf16 included) as a tensor of the same type and bits."""
    a = np.array(a, order="C")        # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(resolve_device(device))


def tensor_to_numpy(x: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16 comes back as ``ml_dtypes.bfloat16``."""
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def params_from_numpy(tree, device="cuda"):
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def params_block(topo, spec_tree, params):
    """This rank's block of every leaf of ``params`` under ``topo``
    (``Topology.block`` by its ParamSpec's logical axes in ``spec_tree``),
    as contiguous copies: the counterpart of the reference's
    ``param_shardings`` and ``device_put``."""
    if isinstance(spec_tree, dict):
        return {k: params_block(topo, spec_tree[k], params[k])
                for k in spec_tree}
    return topo.block(params, *spec_tree.logical_axes).clone(
        memory_format=torch.contiguous_format)


def params_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tensor_to_numpy(tree)


def train_state_from_numpy(state, device="cuda"):
    """The reference's train state (``jax.device_get`` of it) as the port's:
    bf16 parameters, float32 master/m/v, the int32 step."""
    if set(state) != {"params", "opt"} or \
            set(state["opt"]) != {"master", "m", "v", "step"}:
        raise ValueError("a train state is {'params', 'opt': {'master', 'm', "
                         "'v', 'step'}}")
    return params_from_numpy(state, device)
