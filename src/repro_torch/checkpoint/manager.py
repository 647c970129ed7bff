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
  * restore puts the arrays on a given device, the one-card counterpart of
    the reference's elastic restore onto another ``Topology``;
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
    def save(self, step: int, state) -> pathlib.Path:
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        manifest = {"step": step, "arrays": {}}
        for k, v in _flatten(state).items():
            v = v.detach()
            if v.dtype == torch.bfloat16:
                arr = v.float().cpu().numpy()
                manifest["arrays"][k] = {"dtype": "bfloat16"}
            else:
                arr = v.cpu().numpy()
                manifest["arrays"][k] = {"dtype": str(arr.dtype)}
            np.save(tmp / (k.replace("/", "__") + ".npy"), arr)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        fd = os.open(tmp, os.O_RDONLY)
        os.fsync(fd)
        os.close(fd)
        os.rename(tmp, final)                       # atomic commit on POSIX
        if not self._commit_record(step):
            raise RuntimeError("Storm commit record aborted (concurrent writer)")
        self._gc()
        return final

    def _gc(self):
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        for old in ckpts[:-self.keep]:
            shutil.rmtree(old)

    def restore(self, step: Optional[int] = None, *, device=None):
        """Read a checkpoint (the newest when ``step`` is None) onto
        ``device`` (the manager's when None).  Returns (step, state)."""
        ckpts = sorted(self.dir.glob("step_*"))
        ckpts = [c for c in ckpts if not c.name.endswith(".tmp")]
        if not ckpts:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = (self.dir / f"step_{step:08d}") if step is not None else ckpts[-1]
        manifest = json.loads((path / "manifest.json").read_text())
        dev = self.device if device is None else resolve_device(device)
        flat = {}
        for k, meta in manifest["arrays"].items():
            t = torch.from_numpy(np.load(path / (k.replace("/", "__") + ".npy")))
            if meta["dtype"] == "bfloat16":
                t = t.to(torch.bfloat16)
            flat[k] = t.to(dev)
        return manifest["step"], _unflatten(flat)
