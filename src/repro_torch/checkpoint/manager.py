"""Step-atomic checkpoints whose commit is a Storm transaction (counterpart
of ``repro/checkpoint/manager.py``).

  * step-atomic: arrays go to ``step_<n>.tmp/``, fsync, then a rename
    commits them; a crash mid-write leaves the previous checkpoint whole;
  * the commit record is an OCC transaction (``core.tx.run_transactions``)
    against a one-node metadata hash table on ``SimTransport``: key 0 holds
    the latest committed step, and ``latest_committed_step`` reads it back
    through ``core.hybrid.hybrid_lookup`` (the one-sided probe, the
    ``hash_probe`` kernel on the card).  The table lives on the manager's
    device, the card by default; its arena is word for word the
    reference's after the same saves;
  * the on-disk format is the reference's: one ``.npy`` a leaf, named by
    its path with ``/`` as ``__``, bf16 stored as float32, and a
    ``manifest.json`` of each leaf's dtype.  A checkpoint written by either
    package restores in the other;
  * on a mesh (``topo`` with the state's ParamSpec tree, ``spec_tree``)
    ``save`` gathers every leaf whole on rank 0 of the default group, one
    leaf at a time (one gather of the ranks' blocks to rank 0, from the
    host under gloo and from the card under NCCL, each put in place by the
    sending rank's mesh coordinate), and rank 0 writes
    it, so the files equal a one-device save of the same global state;
    rank 0 commits the Storm record and sends its table to the other ranks
    (one broadcast), which wait at a barrier, so every rank reads the
    committed step back;
  * restore puts the arrays on a given device and, on a mesh, cuts each
    leaf to this rank's block as it loads it (``Topology.block``), so a
    rank holds one whole leaf at a time: the reference's elastic restore
    onto another ``Topology`` (save on (2, 2), restore on (1, 4));
  * resumable data: only the step is stored; the token stream is a pure
    function of (seed, step).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import hybrid as hy
from repro_torch.core import slots as sl
from repro_torch.core import tx as txm
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import SimTransport
from repro_torch.device import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = tree
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return tree


def _gather_whole(topo, x, spec):
    """Leaf ``x``, this rank's block under ParamSpec ``spec``, whole on rank
    0's host (None on the other ranks): one gather of every rank's block to
    rank 0 of the default group, each block put where ``Topology.block``
    cuts it for the rank that sent it.  Under NCCL, which takes device
    tensors only, the blocks travel on the card and rank 0 copies them to
    the host; under gloo they travel from the host."""
    nccl = dist.get_backend() == "nccl"
    blk = (x if nccl else x.cpu()).contiguous()
    world = dist.get_world_size()
    if topo.world() != world:
        raise ValueError(f"a mesh of {topo.world()} ranks in a world of "
                         f"{world}")
    first = dist.get_rank() == 0
    parts = [torch.empty_like(blk) for _ in range(world)] if first else None
    dist.gather(blk, parts, dst=0)
    if not first:
        return None
    whole = torch.empty(spec.shape, dtype=blk.dtype)
    for r, part in enumerate(parts):
        topo.block(whole, *spec.logical_axes,
                   coord=topo.coordinate_of(r)).copy_(part)
    return whole


class CheckpointManager:
    def __init__(self, directory, keep: int = 3, device="cuda"):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.device = resolve_device(device)
        # the Storm-backed commit registry (a simulated one-node control plane)
        self._ht_cfg = ht.HashTableConfig(n_nodes=1, n_buckets=64,
                                          bucket_width=2, n_overflow=64)
        self._ht_layout = ht.build_layout(self._ht_cfg)
        self._t = SimTransport(1)
        self._meta_state = ht.init_cluster_state(self._ht_cfg, self.device)

    # -- Storm commit record ------------------------------------------------
    def _commit_record(self, step: int) -> bool:
        """Flip the manifest pointer by an OCC transaction (key 0 holds the
        latest step).  Returns whether it committed."""
        dev = self.device
        write_keys = torch.zeros((1, 1, 1, 2), dtype=torch.int32, device=dev)
        val = torch.zeros((1, 1, 1, sl.VALUE_WORDS), dtype=torch.int32,
                          device=dev)
        val[..., 0] = step
        self._meta_state, _, res = txm.run_transactions(
            self._t, self._meta_state, self._ht_cfg, self._ht_layout,
            read_keys=torch.zeros((1, 1, 0, 2), dtype=torch.int32, device=dev),
            write_keys=write_keys, write_values=val)
        return bool(res.committed.all())

    def latest_committed_step(self) -> Optional[int]:
        key = torch.zeros((1, 1), dtype=torch.int32, device=self.device)
        self._meta_state, _, found, value, *_ = hy.hybrid_lookup(
            self._t, self._meta_state, key, key, self._ht_cfg, self._ht_layout)
        if bool(found[0, 0]):
            return int(value[0, 0, 0])
        return None

    # -- save / restore ------------------------------------------------------
    def save(self, step: int, state, *, topo=None,
             spec_tree=None) -> pathlib.Path:
        """Write ``state`` as step ``step`` and commit it.  On a mesh
        ``topo`` the state is this rank's blocks and ``spec_tree`` its
        ParamSpec tree: every rank calls ``save``, every leaf is gathered
        whole, rank 0 writes and commits, the others wait."""
        mesh = topo is not None and topo.sharded()
        writer = not mesh or dist.get_rank() == 0
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        manifest = {"step": step, "arrays": {}}
        if writer:
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir()
        specs = _flatten(spec_tree) if mesh else {}
        for k, v in _flatten(state).items():
            v = v.detach()
            if mesh:
                v = _gather_whole(topo, v, specs[k])
            if not writer:
                continue
            if v.dtype == torch.bfloat16:
                arr = v.float().cpu().numpy()
                manifest["arrays"][k] = {"dtype": "bfloat16"}
            else:
                arr = v.cpu().numpy()
                manifest["arrays"][k] = {"dtype": str(arr.dtype)}
            np.save(tmp / (k.replace("/", "__") + ".npy"), arr)
            del v, arr
        if writer:
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            fd = os.open(tmp, os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
            os.rename(tmp, final)                   # atomic commit on POSIX
            if not self._commit_record(step):
                raise RuntimeError("Storm commit record aborted "
                                   "(concurrent writer)")
            self._gc()
        if mesh:
            # the committed table to every rank, then every rank goes on
            for t in self._meta_state.values():
                dist.broadcast(t, src=0)
            dist.barrier()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old)

    def restore(self, step: Optional[int] = None, *, device=None, topo=None,
                spec_tree=None):
        """Read a checkpoint (the newest when ``step`` is None) onto
        ``device`` (the manager's when None).  Returns (step, state).  On a
        mesh ``topo`` each leaf is cut to this rank's block under its
        ParamSpec in ``spec_tree`` as it is read."""
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = (self.dir / f"step_{step:08d}") if step is not None else ckpts[-1]
        manifest = json.loads((path / "manifest.json").read_text())
        dev = self.device if device is None else resolve_device(device)
        specs = _flatten(spec_tree) if topo is not None else {}
        flat = {}
        for k, meta in manifest["arrays"].items():
            t = torch.from_numpy(np.load(path / (k.replace("/", "__") + ".npy")))
            if meta["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)
            if topo is not None:
                t = topo.block(t, *specs[k].logical_axes).clone(
                    memory_format=torch.contiguous_format)
            flat[k] = t.to(dev)
        return manifest["step"], _unflatten(flat)
