"""Parameter specification trees and seeded initialisation (the one-device
part of ``repro/parallel/sharding.py``).

``ParamSpec`` keeps the reference's shape, init kind, dtype and scale; its
logical sharding axes and ``Topology`` wait for the mesh-transport slice (on
one device every ``topo.constrain`` is the identity, and the port drops it).
Draws come from an explicit ``torch.Generator``: the same seed gives the same
parameters on every run, but not the JAX package's numbers (carry those
across with ``convert.params_from_numpy``).  A leaf of more than
``SLICE_ELEMS`` elements is drawn in slices along its first axis, each in
float32 and cast into the leaf, so drawing gemma2-27b's 7.8e9-element FFN
stacks needs one slice of float32 beside the tree, not the whole leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device

# above zamba2-1.2b's largest leaf (its stacked wz/wx, 301,989,888 elements),
# so every leaf of it draws whole; 2 GiB of float32 a slice
SLICE_ELEMS = 2**29


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"        # "normal" | "zeros" | "ones" | "scaled"
    dtype: torch.dtype = torch.bfloat16
    scale: float = 0.02

    def initialize(self, generator: torch.Generator) -> torch.Tensor:
        dev = generator.device
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=dev)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=dev)
        if self.init not in ("normal", "scaled"):
            raise ValueError(f"unknown init {self.init!r}")
        numel = int(np.prod(self.shape))
        if numel <= SLICE_ELEMS:
            return self._draw(self.shape, generator).to(self.dtype)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        rows = max(1, SLICE_ELEMS // (numel // self.shape[0]))
        for i in range(0, self.shape[0], rows):
            part = out[i:i + rows]
            part.copy_(self._draw(part.shape, generator))
        return out

    def _draw(self, shape, generator) -> torch.Tensor:
        """float32 draws of ``shape`` (the leaf or a slice of it along the
        first axis), scaled by the whole leaf's fan-in."""
        x = torch.empty(shape, dtype=torch.float32, device=generator.device)
        if self.init == "scaled":   # 1/sqrt(fan_in), normal truncated at +-2
            fan_in = self.shape[0] if len(self.shape) > 1 else max(self.shape[0], 1)
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
            return x.mul_(1.0 / np.sqrt(fan_in))
        return x.normal_(0.0, 1.0, generator=generator).mul_(self.scale)


def init_params(spec_tree, generator: torch.Generator, device="cuda"):
    """The parameter tree of ``spec_tree`` (nested dicts of ParamSpec), drawn
    leaf by leaf in sorted key order on the generator's device and moved to
    ``device``."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, ParamSpec):
            return t.initialize(generator).to(dev)
        return {k: walk(t[k]) for k in sorted(t)}
    return walk(spec_tree)
