"""Primary-backup replication of the commit dataplane, PyTorch port of
``repro/core/replication.py``.

A record's PRIMARY copy lives on its home node.  With a replication factor
``f`` > 0, every COMMIT also installs the write set on ``f`` BACKUP nodes:

  * **Placement** is the node ring: ``replica_of(primary, i) = (primary + i)
    mod n_nodes`` for i in 0..f (i = 0 is the primary).  The rotation is a
    bijection on destinations, so a commit round that fits the
    per-destination send budget fits its backup fan-out too.
  * **Backup writes ride the commit round**: they are extra traffic classes
    in the SAME fused round as COMMIT/ABORT_UNLOCK, so ``f`` > 0 adds ZERO
    exchange rounds; only the commit round fans out wider.
  * **Byte-equal copies** (hash table): ``OP_BACKUP_WRITE`` installs the
    committed record image — key, committed version (predicted from the LOCK
    reply as ``(lock_version | 1) + 1``), lock 0, value; only the slot's
    ``next_ptr`` differs between copies.  The ordered index replicates
    LOGICALLY (``OP_BT_BACKUP`` upserts into the backup node's backup tree).
  * **Never dropped silently**: a dropped backup write aborts its lane
    (cause: overflow), which the retry loop retries.

Failure injection: ``kill_node`` marks nodes dead; ``failover_dest`` routes
each lane to the first LIVE replica on the ring; ``failover_lookup`` is the
reads-fail-over-to-backup path.  Requests whose every replica is dead are
parked and reported ``dead_route``.  ``f = 0`` (or ``rep=None``) is
bit-identical to the unreplicated dataplane.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.core import placement as pl
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.core.datastructs import btree as bt
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import Transport


@dataclasses.dataclass(frozen=True)
class ReplicaConfig:
    """Replication factor + placement for one cluster.

    f:         number of BACKUP copies per record (f + 1 copies in all).
    placement: optional override ``fn(primary, i, n_nodes) -> dest`` (int32
               tensors) for tests that build pathological placements;
               production placement is the ring rotation, whose bijectivity
               keeps the commit fan-out overflow-free.
    """
    n_nodes: int
    f: int = 0
    placement: Optional[Callable] = None

    def __post_init__(self):
        if not 0 <= self.f < self.n_nodes:
            raise ValueError(
                f"replication factor must satisfy 0 <= f < n_nodes "
                f"(got f={self.f}, n_nodes={self.n_nodes})")

    @property
    def n_copies(self) -> int:
        return self.f + 1

    def replica_of(self, primary, i: int):
        """Destination (int32) of copy ``i`` (0 = primary) of a record homed
        at ``primary``."""
        primary = torch.as_tensor(primary).to(torch.int32)
        if i == 0:
            return primary
        if self.placement is not None:
            return torch.as_tensor(self.placement(primary, i, self.n_nodes)
                                   ).to(torch.int32)
        return ((primary.to(torch.int64) + i) % self.n_nodes).to(torch.int32)


def committed_version(lock_version):
    """The version a commit installs, predicted from the LOCK reply:
    ``(lock_version | 1) + 1`` in 32 bits (0xFFFFFFFF wraps to 0)."""
    return sl.i32((sl.u32(torch.as_tensor(lock_version)) | 1) + 1)


def backup_write_records(lock_ctx, write_values):
    """OP_BACKUP_WRITE records for one commit round: the flattened (N, B*Wr)
    write keys of the lock context, the committed version in aux, the
    values (reshapeable to (N, B*Wr, VALUE_WORDS))."""
    n, items = lock_ctx["key_lo"].shape
    return ht.make_record(
        W.OP_BACKUP_WRITE, lock_ctx["key_lo"], lock_ctx["key_hi"],
        aux=committed_version(lock_ctx["lock_ver"]),
        value=write_values.reshape(n, items, sl.VALUE_WORDS))


def btree_backup_records(lock_ctx, write_values):
    """OP_BT_BACKUP records for the ordered index's commit round: each
    committed (key, value) is upserted into the backup replica's full-range
    backup tree (logical replication; the aux word carries the predicted
    committed leaf version for observability)."""
    n, items = lock_ctx["key_lo"].shape
    return bt.make_record(
        W.OP_BT_BACKUP, lock_ctx["key_lo"],
        torch.zeros_like(lock_ctx["key_lo"]),
        aux=committed_version(lock_ctx["lock_ver"]),
        value=write_values.reshape(n, items, sl.VALUE_WORDS))


# ---------------------------------------------------------------------------
# Failure injection + read fail-over
# ---------------------------------------------------------------------------
def all_alive(n_nodes: int, device="cuda"):
    """Fresh liveness mask: every node up."""
    return torch.ones((n_nodes,), dtype=torch.bool, device=device)


def kill_node(alive, node):
    """A copy of ``alive`` with ``node`` (an index or an index tensor)
    marked dead.  Dead nodes receive no requests from the failover paths."""
    out = alive.clone()
    out[torch.as_tensor(node, dtype=torch.int64, device=alive.device)] = False
    return out


def failover_dest(rep: ReplicaConfig, alive, primary):
    """(dest, reachable): each lane's FIRST live replica on the ring, through
    the one first-live-copy rule ``placement.live_dest``; unreachable lanes
    carry dest -1."""
    return pl.live_dest(pl.table_from_replica(rep, alive), primary)


def failover_lookup(t: Transport, state, key_lo, key_hi,
                    cfg: ht.HashTableConfig, layout, rep: ReplicaConfig,
                    alive, *, capacity: Optional[int] = None, enabled=None,
                    nic=None):
    """Hash-table reads failing over to the backup: the one-two-sided lookup
    issued at each key's first LIVE replica (``placement.failover_lookup``;
    its one-sided probe is one ``hash_probe`` launch).  Returns a dict with
    found / value / version / node / slot_idx / overflow / dead_route /
    wire."""
    table = pl.table_from_replica(rep, alive)
    return pl.failover_lookup(t, state, cfg, layout, table, key_lo, key_hi,
                              ds=ht, capacity=capacity, enabled=enabled,
                              nic=nic)
