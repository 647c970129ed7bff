"""Placement: epoch-stamped routing, PyTorch port of the part of
``repro/core/placement.py`` the data structures and replication need.

The table maps each of ``n_parts`` partitions (== the provisioned node-slot
count) to an ordered copy list: column 0 is the OWNER (the only node that
accepts lock-class ops for the partition), columns 1.. are the backups, -1 =
unused slot; plus a liveness mask and an epoch.  Every node's arena carries a
``routing`` region holding the coordinator-published image of the table,
which the hash table's handler consults for its owner check.

Ported here: the region layout (``routing_words`` / ``alive_words`` and the
word offsets), ``PlacementTable`` / ``initial_table`` /
``table_from_replica``, the routing queries ``owner_dest`` / ``live_dest`` /
``copy_nodes``, the epoch-0 ``identity_region_image``, and the generic read
fail-over ``failover_lookup`` (hash table and B-tree alike).  Refresh,
install, membership, re-replication and migration belong to a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import onesided as osd
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.core.transport import Transport, placement_dest

# Static ceiling on copies per partition (owner + up to 3 backups).
MAX_COPIES = 4
NONE = 0xFFFFFFFF          # "no copy in this slot" in the arena image

# routing-region word layout (relative to layout["routing"].base):
EPOCH_WORD = 0             # current epoch
NPARTS_WORD = 1            # n_parts (sanity / decoder self-description)
SELF_WORD = 2              # THIS node's id — what the owner check compares
COPIES_WORD = 3            # n_parts rows of MAX_COPIES words, then alive bits


def alive_words(n_nodes: int) -> int:
    return (n_nodes + 31) // 32


def routing_words(n_nodes: int) -> int:
    """Published routing-region size in words (n_parts == n_nodes)."""
    return COPIES_WORD + n_nodes * MAX_COPIES + alive_words(n_nodes)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """n_nodes: provisioned node-slot count, also the partition count;
    f: backup copies per partition (f + 1 copies total)."""
    n_nodes: int
    f: int = 0

    def __post_init__(self):
        if not 0 <= self.f < self.n_nodes:
            raise ValueError(
                f"placement needs 0 <= f < n_nodes (got f={self.f}, "
                f"n_nodes={self.n_nodes})")
        if self.f + 1 > MAX_COPIES:
            raise ValueError(
                f"f={self.f} exceeds MAX_COPIES={MAX_COPIES} copies")

    @property
    def n_parts(self) -> int:
        return self.n_nodes

    @property
    def n_copies(self) -> int:
        return self.f + 1


@dataclasses.dataclass
class PlacementTable:
    """The client-cached routing state."""
    epoch: torch.Tensor    # ()           int32 (word)
    copies: torch.Tensor   # (n_parts, K) int32 — col 0 = owner, -1 = none
    alive: torch.Tensor    # (n_nodes,)   bool


def initial_table(pcfg: PlacementConfig, device=None) -> PlacementTable:
    """Epoch-0 identity table: partition p is owned by node p with its f
    backups on the ring."""
    p = torch.arange(pcfg.n_parts, device=device)[:, None]
    i = torch.arange(MAX_COPIES, device=device)[None, :]
    copies = torch.where(i < pcfg.n_copies, (p + i) % pcfg.n_nodes, -1)
    return PlacementTable(
        epoch=torch.zeros((), dtype=torch.int32, device=device),
        copies=copies.to(torch.int32),
        alive=torch.ones((pcfg.n_nodes,), dtype=torch.bool, device=device))


def table_from_replica(rep, alive) -> PlacementTable:
    """Express a ``replication.ReplicaConfig`` (ring rotation or a test's
    placement fn) and a liveness mask as a PlacementTable, so every failover
    decision reduces to the ONE first-live-copy scan (``live_dest``)."""
    alive = torch.as_tensor(alive, dtype=torch.bool)
    n = rep.n_nodes
    p = torch.arange(n, dtype=torch.int32, device=alive.device)
    cols = [rep.replica_of(p, i).to(torch.int32) for i in range(rep.n_copies)]
    while len(cols) < MAX_COPIES:
        cols.append(torch.full((n,), -1, dtype=torch.int32,
                               device=alive.device))
    return PlacementTable(
        epoch=torch.zeros((), dtype=torch.int32, device=alive.device),
        copies=torch.stack(cols, dim=1), alive=alive)


def owner_of(table: PlacementTable, part):
    """The partition's owner — the only valid target for lock-class ops."""
    return table.copies[part.to(torch.int64), 0]


def owner_dest(table: PlacementTable, part):
    """Owner if alive, else -1 (parked by route_by_dest -> ST_DROPPED)."""
    own = owner_of(table, part)
    ok = (own >= 0) & table.alive[
        own.clamp(0, table.alive.shape[0] - 1).to(torch.int64)]
    return torch.where(ok, own, -1).to(torch.int32)


def copy_nodes(table: PlacementTable, part):
    """All copy slots of a partition: (..., K) int32 (-1 = none)."""
    return table.copies[part.to(torch.int64)]


def live_dest(table: PlacementTable, part):
    """(dest, reachable): first LIVE copy in owner-priority order — the read
    fail-over rule (owner when everything is up)."""
    return placement_dest(table.copies, table.alive, part)


def _alive_bits(n_nodes: int, alive) -> torch.Tensor:
    idx = torch.arange(n_nodes, device=alive.device)
    bits = torch.zeros((alive_words(n_nodes),), dtype=torch.int64,
                       device=alive.device)
    bits.index_add_(0, idx // 32, alive.to(torch.int64) << (idx % 32))
    return sl.i32(bits)


def region_image(pcfg: PlacementConfig, table: PlacementTable) -> torch.Tensor:
    """(routing_words,) int32 image of the published region.  The SELF_WORD
    is left 0 — init preserves each node's own id."""
    dev = table.copies.device
    cps = torch.where(table.copies >= 0, table.copies,
                      torch.tensor(sl.word(NONE), dtype=torch.int32,
                                   device=dev))
    head = torch.stack([table.epoch.to(torch.int32).reshape(()),
                        torch.tensor(pcfg.n_parts, dtype=torch.int32,
                                     device=dev),
                        torch.zeros((), dtype=torch.int32, device=dev)])
    return torch.cat([head, cps.reshape(-1), _alive_bits(pcfg.n_nodes,
                                                         table.alive)])


def identity_region_image(n_nodes: int, device=None) -> torch.Tensor:
    """The epoch-0 image the data structures install at init (f-agnostic:
    the full ring is published; the owner check only reads column 0)."""
    pcfg = PlacementConfig(n_nodes, f=min(MAX_COPIES, n_nodes) - 1)
    return region_image(pcfg, initial_table(pcfg, device=device))


def _ds_for(cfg):
    """The data-structure module of a config (hash table or B-tree)."""
    from repro_torch.core.datastructs import btree as bt
    from repro_torch.core.datastructs import hashtable as ht
    if isinstance(cfg, ht.HashTableConfig):
        return ht, "hash"
    if isinstance(cfg, bt.BTreeConfig):
        return bt, "btree"
    raise TypeError(f"unknown data-structure config {type(cfg).__name__}")


# ---------------------------------------------------------------------------
# Read fail-over (generic over the data-structure interface)
# ---------------------------------------------------------------------------
def failover_lookup(t: Transport, state, cfg, layout, table: PlacementTable,
                    key_lo, key_hi, *, ds=None,
                    capacity: Optional[int] = None, enabled=None, nic=None):
    """Point reads routed to each key's first LIVE copy: the one-sided probe
    plus RPC fallback of the hybrid lookup, with the destination resolved
    through the placement table — what serves both the hash table and the
    B-tree's backup tree after a primary dies.  The probe's owner-side read
    is ONE ``ds.probe_read`` call (for the hash table one ``hash_probe``
    launch), routed and accounted like ``onesided.remote_read``.  Returns
    dict(found, value, version, node, slot_idx, overflow, dead_route,
    wire)."""
    if ds is None:
        ds, _ = _ds_for(cfg)
    if enabled is None:
        enabled = torch.ones(key_lo.shape, dtype=torch.bool,
                             device=key_lo.device)
    part = ds.part_of(cfg, key_lo, key_hi)
    dest, reachable = live_dest(table, part)
    en = enabled & reachable
    _, off, hit = ds.lookup_start(cfg, layout, key_lo, key_hi, None)

    delivered, ovf1, s1 = osd.read_round(
        t, dest, off, length=ds.probe_words(cfg), capacity=capacity,
        enabled=en, nic=nic)
    pe = ds.probe_read(cfg, layout, state["arena"], dest, off, key_lo,
                       key_hi, hit, delivered)
    success = pe["found"] & ~ovf1 & en
    resolved = pe["resolved"] & ~ovf1 & en

    # RPC fallback at the SAME live copy (chained / stale-routed / torn lanes)
    need = en & ~resolved
    _, rep2, ovf2, s2 = R.rpc_call(
        t, state, dest, ds.lookup_records(cfg, key_lo, key_hi),
        ds.make_lookup_handler_vector(cfg, layout), capacity=capacity,
        enabled=need, nic=nic)
    rpc_ok = need & (rep2[..., 0] == W.ST_OK) & ~ovf2
    return dict(
        found=success | rpc_ok,
        value=torch.where(rpc_ok[..., None], rep2[..., 3:], pe["value"]),
        version=torch.where(rpc_ok, rep2[..., 2], pe["version"]),
        node=dest,
        slot_idx=torch.where(rpc_ok, rep2[..., 1], pe["slot_idx"]),
        overflow=need & ovf2,
        dead_route=enabled & ~reachable,
        wire=s1 + s2,
    )
