"""Process-group set-up and the mesh builders (counterpart of
``repro/launch/mesh.py``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the default
process group, with the reference's axis names.  Functions, not module
constants: importing this module touches no device and no process group.
``init_group`` is the one place a process group is joined; it takes the
backend from the device (NCCL for ``cuda``, gloo for ``cpu``) unless the
caller names one, as ranks sharing one card must (NCCL refuses two ranks on
one device; gloo carries CUDA tensors).
"""
from __future__ import annotations

import datetime
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}
# how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=600)


def init_group(device="cuda", *, rank: int = 0, world_size: int = 1,
               init_method: Optional[str] = None,
               backend: Optional[str] = None):
    """Join the default process group as ``rank`` of ``world_size`` (a no-op
    where this process has joined one already).  ``init_method`` is the
    rendezvous (``file://...`` or ``tcp://localhost:<port>``); a world of
    one needs none.  On ``cuda`` the current device becomes the device
    given (``cuda`` is ``cuda:0``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    if dist.is_initialized():
        return
    backend = backend or BACKENDS[dev.type]
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs an "
                             "init_method")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size, timeout=TIMEOUT)


def make_mesh(shape: Sequence[int], axes: Sequence[str], device="cuda"):
    """A DeviceMesh of ``shape`` over the default group's ranks in order,
    with axis names ``axes``; the group's world size must be prod(shape)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_group first")
    n = math.prod(shape)
    if dist.get_world_size() != n:
        raise ValueError(f"a mesh of {tuple(shape)} needs {n} ranks, the "
                         f"process group has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """16 x 16 ("data", "model"); multi_pod adds the cross-pod DP axis:
    2 x 16 x 16 ("pod", "data", "model").  Raises unless the process group
    has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_smoke_mesh(device="cuda"):
    """A one-rank ("data", "model") mesh, joining a world of one where this
    process has no process group yet."""
    init_group(device)
    return make_mesh((1, 1), ("data", "model"), device)
