"""Logical-axis sharding rules, the ``Topology`` that maps them onto a mesh,
and parameter specification trees with seeded initialisation (counterpart
of ``repro/parallel/sharding.py``).

Model code names LOGICAL axes ("batch", "heads", "ff", ...); ``Topology``
maps them to mesh axes and silently drops any mapping that does not divide
the concrete dimension (qwen2.5's 40 heads on a 16-wide model axis fall back
to replication), exactly as the reference does.  ``spec_for`` returns the
reference's ``PartitionSpec`` entries as a tuple: per dimension ``None``, one
mesh axis name, or a tuple of them (the first the major one).  A Topology is
built over a ``torch.distributed.device_mesh.DeviceMesh``
(``repro_torch.launch.mesh``) or over :class:`AbstractMesh`, axis sizes
alone, so the rules can be checked at production sizes with no process
group.  Where the reference's ``device_put`` gives each device its block of
a global array by a ``NamedSharding``, a rank here cuts its block with
:meth:`Topology.block`.

``ParamSpec`` keeps the reference's shape, logical axes, init kind, dtype and
scale.  Draws come from an explicit ``torch.Generator``: the same seed gives
the same parameters on every run, but not the JAX package's numbers (carry
those across with ``convert.params_from_numpy``).  A leaf of more than
``SLICE_ELEMS`` elements is drawn in slices along its first axis, each in
float32 and cast into the leaf, so drawing gemma2-27b's 7.8e9-element FFN
stacks needs one slice of float32 beside the tree, not the whole leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# above zamba2-1.2b's largest leaf (its stacked wz/wx, 301,989,888 elements),
# so every leaf of it draws whole; 2 GiB of float32 a slice
SLICE_ELEMS = 2**29

# logical axis -> tuple of mesh axis names (applied only if present + divides)
DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "seq": (),
    "kv_seq": ("model",),        # decode-time sequence-sharded KV cache
    "vocab": ("model",),
    "embed": (),
    "ff": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "expert": ("model",),
    "fsdp": ("data",),           # ZeRO-3 weight dim
    "ssm_state": (),
    "conv": (),
}

# Serving: no fsdp (weights kept whole per model-shard, replicated over data)
SERVE_RULES = dict(DEFAULT_RULES, fsdp=(), batch=("pod", "data"))

# Wide-DP: the model axis goes to batch + ZeRO (sub-scale models waste it on
# narrow TP matmuls): no TP collectives, params sharded over all devices
WIDE_DP_RULES = dict(
    DEFAULT_RULES,
    batch=("pod", "data", "model"),
    fsdp=("data", "model"),
    ff=(), heads=(), kv_heads=(), vocab=(), expert=(), kv_seq=(),
)


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Mesh axis names and sizes with no devices or process group behind
    them: the two attributes of a ``DeviceMesh`` that ``Topology`` reads."""
    mesh_dim_names: Tuple[str, ...]
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Topology:
    """Logical-axis rules over a mesh: a ``DeviceMesh`` (whose groups the
    sharded branches run their collectives on) or an :class:`AbstractMesh`."""
    mesh: object
    rules: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    # axis sizes, sharded() and spec_for's entries, worked out once a
    # topology (the models ask for the same leaves' entries every layer of
    # every step); the mesh and the rules are not changed after the
    # topology is made
    _memo: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        sizes = self._memo.get("axis_sizes")
        if sizes is None:
            sizes = self._memo["axis_sizes"] = dict(zip(
                self.mesh.mesh_dim_names, tuple(self.mesh.shape)))
        return sizes

    def _prod(self, axes) -> int:
        return math.prod(self.axis_sizes[a] for a in axes)

    def _mesh_axes_for(self, logical: Optional[str], dim: int) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = tuple(a for a in self.rules.get(logical, ())
                     if a in self.mesh.mesh_dim_names)
        # drop trailing axes until the product divides the dimension
        while axes:
            if dim % self._prod(axes) == 0:
                return axes
            axes = axes[:-1]
        return ()

    def spec_for(self, shape: Sequence[int],
                 logical_axes: Sequence[Optional[str]]) -> tuple:
        """The reference's PartitionSpec entries of a (shape, logical axes)
        leaf; a mesh axis serves at most one dimension."""
        key = (tuple(shape), tuple(logical_axes))
        hit = self._memo.get(key)
        if hit is not None:
            return hit
        if len(shape) != len(logical_axes):
            raise ValueError(f"shape {tuple(shape)} vs axes {logical_axes}")
        entries = []
        used: set = set()
        for dim, name in zip(shape, logical_axes):
            axes = tuple(a for a in self._mesh_axes_for(name, dim)
                         if a not in used)
            # re-check divisibility after removing already-used axes
            while axes and dim % self._prod(axes) != 0:
                axes = axes[:-1]
            used.update(axes)
            entries.append(axes if len(axes) > 1 else (axes[0] if axes else None))
        self._memo[key] = tuple(entries)
        return self._memo[key]

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along every mesh axis (a DeviceMesh only; an
        AbstractMesh gives rank 0's, every index 0)."""
        if isinstance(self.mesh, AbstractMesh):
            return {a: 0 for a in self.mesh.mesh_dim_names}
        return dict(zip(self.mesh.mesh_dim_names, self.mesh.get_coordinate()))

    def axis_index(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 where the mesh lacks it or
        the axis is 1 wide)."""
        if self.axis_sizes.get(axis, 1) == 1:
            return 0
        return self.coordinate().get(axis, 0)

    def sharded(self) -> bool:
        """Does any mesh axis have more than one rank?"""
        hit = self._memo.get("sharded")
        if hit is None:
            hit = self._memo["sharded"] = any(
                n > 1 for n in self.axis_sizes.values())
        return hit

    def extent(self, entry, dim: int) -> Tuple[int, int]:
        """(first index, length) of this rank's block of a dimension of
        ``dim`` under a ``spec_for`` entry (None, an axis, or axes a1-major
        as :meth:`block` cuts them)."""
        axes = entry_axes(entry)
        idx = 0
        for a in axes:
            idx = idx * self.axis_sizes[a] + self.axis_index(a)
        n = dim // self._prod(axes)
        return idx * n, n

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.mesh.get_group(axis)

    def block(self, x, *logical_axes, coord: Optional[Dict[str, int]] = None):
        """This rank's block of the global tensor ``x`` under
        ``spec_for(x.shape, logical_axes)``: a dimension split over axes
        (a1, a2, ...) is cut into prod(sizes) blocks indexed a1-major.
        ``coord`` gives the mesh coordinate (default this rank's)."""
        coord = self.coordinate() if coord is None else coord
        for dim, entry in enumerate(self.spec_for(x.shape, logical_axes)):
            if entry is None:
                continue
            axes = (entry,) if isinstance(entry, str) else entry
            idx = 0
            for a in axes:
                idx = idx * self.axis_sizes[a] + coord[a]
            n = x.shape[dim] // self._prod(axes)
            x = x.narrow(dim, idx * n, n)
        return x

    def gather(self, x, dim: int, entry):
        """All-gather dimension ``dim`` of this rank's block ``x`` over the
        mesh axes of a ``spec_for`` entry: the inverse of :meth:`block`
        along it.  Axes a1-major: the minor axis is gathered first, so
        each step joins whole blocks of the next.  Axes 1 wide cost
        nothing."""
        return self.gather_many([x], [dim], entry)[0]

    def gather_many(self, xs, dims, entry):
        """:meth:`gather` of several blocks of one dtype (``xs[i]`` along
        ``dims[i]``) over the same entry, in one collective an axis: each
        rank's blocks travel flattened side by side."""
        xs = list(xs)
        for a in reversed(entry_axes(entry)):
            n = self.axis_sizes[a]
            if n == 1:
                continue
            parts = [x.movedim(d, 0) for x, d in zip(xs, dims)]
            flat = torch.cat([p.reshape(-1) for p in parts])
            out = flat.new_empty(n * flat.numel())
            dist.all_gather_into_tensor(out, flat, group=self.group(a))
            out = out.view(n, -1)
            at = 0
            for i, (p, d) in enumerate(zip(parts, dims)):
                y = out[:, at:at + p.numel()].reshape((n,) + tuple(p.shape))
                xs[i] = y.reshape((n * p.shape[0],) + tuple(
                    p.shape[1:])).movedim(0, d)
                at += p.numel()
        return xs

    def all_reduce(self, x, entry):
        """Sum ``x``, a partial result, over the mesh axes of a ``spec_for``
        entry, in place; returns it."""
        for a in entry_axes(entry):
            if self.axis_sizes[a] > 1:
                dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group(a))
        return x

    def full(self, x, shape: Sequence[int],
             logical_axes: Sequence[Optional[str]], keep: Sequence[int] = ()):
        """This rank's block ``x`` of a global tensor of ``shape`` with
        every sharded dimension gathered but those in ``keep``."""
        for dim, entry in enumerate(self.spec_for(shape, logical_axes)):
            if entry is not None and dim not in keep:
                x = self.gather(x, dim, entry)
        return x

    def constrain(self, x, *logical_axes):
        """The identity.  Where the reference pins a layout with
        ``with_sharding_constraint`` and lets GSPMD place the collectives,
        the port's tensor-parallel code (``models/transformer.py``,
        ``serving/``) already holds each rank's block in that layout and
        calls :meth:`gather` and :meth:`all_reduce` itself, so there is
        nothing left to pin."""
        return x


# one device: every logical axis maps to a mesh axis of size 1
ONE_DEVICE = Topology(AbstractMesh(("data", "model"), (1, 1)))


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of a ``spec_for`` entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)



@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
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


def init_params(spec_tree, generator: torch.Generator, device="cuda",
                topo: Optional[Topology] = None):
    """The parameter tree of ``spec_tree`` (nested dicts of ParamSpec), drawn
    leaf by leaf in sorted key order on the generator's device and moved to
    ``device``.  With ``topo`` each leaf is cut to this rank's block as soon
    as it is drawn (the same draws as without), so a rank holds one whole
    leaf at a time beside its blocks."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, ParamSpec):
            x = t.initialize(generator).to(dev)
            if topo is not None:
                x = topo.block(x, *t.logical_axes).clone(
                    memory_format=torch.contiguous_format)
            return x
        return {k: walk(t[k]) for k in sorted(t)}
    return walk(spec_tree)


def _tree_map(fn, tree):
    if isinstance(tree, ParamSpec):
        return fn(tree)
    return {k: _tree_map(fn, v) for k, v in tree.items()}


def param_specs_pspec(topo: Topology, spec_tree):
    """The tree of ``topo.spec_for`` entries of every leaf."""
    return _tree_map(lambda s: topo.spec_for(s.shape, s.logical_axes),
                     spec_tree)
