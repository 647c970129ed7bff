"""Placement: epoch-stamped routing, PyTorch port of the part of
``repro/core/placement.py`` the hash table needs.

The table maps each of ``n_parts`` partitions (== the provisioned node-slot
count) to an ordered copy list: column 0 is the OWNER (the only node that
accepts lock-class ops for the partition), columns 1.. are the backups, -1 =
unused slot; plus a liveness mask and an epoch.  Every node's arena carries a
``routing`` region holding the coordinator-published image of the table,
which the hash table's handler consults for its owner check.

Ported here: the region layout (``routing_words`` / ``alive_words`` and the
word offsets), ``PlacementTable`` / ``initial_table``, the routing queries
``owner_dest`` / ``live_dest`` / ``copy_nodes`` and the epoch-0
``identity_region_image``.  Refresh, install, membership, re-replication and
migration belong to a later slice.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import slots as sl
from repro_torch.core.transport import placement_dest

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
