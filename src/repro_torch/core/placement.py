"""Placement and membership: epoch-stamped routing, PyTorch port of
``repro/core/placement.py``.

The table maps each of ``n_parts`` partitions (== the provisioned node-slot
count) to an ordered copy list: column 0 is the OWNER (the only node that
accepts lock-class ops for the partition), columns 1.. are the backups, -1 =
unused slot; plus a liveness mask and an epoch.  Every node's arena carries a
``routing`` region holding the coordinator-published image of the table,
which the data structures' handlers consult for their owner check.

  * **Publication**: ``refresh_table`` is ONE one-sided read of the
    routing region of the first live node; ``install_table`` broadcasts the
    table as OP_PL_INSTALL RPCs, ``install_local`` writes it without wire.
  * **Staleness is owner-checked** by the serial handlers: a lock-class op
    routed with a stale table gets ``ST_WRONG_EPOCH``, the lane aborts with
    cause ``stale_route`` and ``txloop`` refreshes the table before the
    retry.
  * **Membership**: ``kill_node`` / ``join_node`` / ``leave_node`` bump the
    epoch; ``repair_plan`` and ``rereplicate`` restore f+1 copies after a
    failure over the backup classes; ``migrate_partition`` moves a
    partition transactionally (source-lock, copy, epoch flip) on the OCC
    locks, so a migration racing a client lock aborts cleanly.

**One-issuer sweeps.**  Re-replication and migration read a whole slot or
leaf region of one node with ONE one-sided read round and send its records
in ONE RPC round, issued by one node to one node.  The cluster rounds are
dense in (node, source, cell), so at 294,912 slots a node (2^18 buckets
and 2^15 overflow slots) one such round would hold a 38.6 GB reply block
that is dead but for one row.  The port runs each sweep as slices of at most ``SWEEP_LANES`` lanes,
in lane order, and bills the ONE round the unsplit call would: the owner's
fold sees the same records in the same order, the issuer gets the same
replies, and the WireStats count every lane once and the one (source,
destination) pair once.  The sweeps need the whole cluster in one process,
as the JAX package's do: on a MeshTransport ``rereplicate`` and
``migrate_partition`` raise ValueError.  Everything else here (refresh,
install, failover reads, the routing queries) runs on either transport.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import onesided as osd
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import telemetry as T
from repro_torch.core import wireproto as W
from repro_torch.core.transport import (Transport, WireStats, placement_dest,
                                        wire_for_classes)

# Static ceiling on copies per partition (owner + up to 3 backups).
MAX_COPIES = 4
NONE = 0xFFFFFFFF          # "no copy in this slot" in the arena image

# routing-region word layout (relative to layout["routing"].base):
EPOCH_WORD = 0             # current epoch
NPARTS_WORD = 1            # n_parts (sanity / decoder self-description)
SELF_WORD = 2              # THIS node's id — what the owner check compares
COPIES_WORD = 3            # n_parts rows of MAX_COPIES words, then alive bits

# lock tag of migration's source-lock phase (nonzero, and outside the
# per-lane tag space tx.py generates)
MIG_TAG = 0xB1C00000

# lanes per slice of a one-issuer sweep (module docstring)
SWEEP_LANES = 4096


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


def _parts(table: PlacementTable, part):
    """Partition ids (a Python int or a tensor) as an int64 index tensor."""
    return torch.as_tensor(part, device=table.copies.device).to(torch.int64)


def owner_of(table: PlacementTable, part):
    """The partition's owner — the only valid target for lock-class ops."""
    return table.copies[_parts(table, part), 0]


def owner_dest(table: PlacementTable, part):
    """Owner if alive, else -1 (parked by route_by_dest -> ST_DROPPED)."""
    own = owner_of(table, part)
    ok = (own >= 0) & table.alive[
        own.clamp(0, table.alive.shape[0] - 1).to(torch.int64)]
    return torch.where(ok, own, -1).to(torch.int32)


def copy_nodes(table: PlacementTable, part):
    """All copy slots of a partition: (..., K) int32 (-1 = none)."""
    return table.copies[_parts(table, part)]


def live_dest(table: PlacementTable, part):
    """(dest, reachable): first LIVE copy in owner-priority order — the read
    fail-over rule (owner when everything is up)."""
    return placement_dest(table.copies, table.alive, _parts(table, part))


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


def decode_region(pcfg: PlacementConfig, words) -> PlacementTable:
    """Inverse of region_image (SELF_WORD ignored; copy slots beyond
    pcfg.n_copies masked to -1 so the decode is pcfg-consistent)."""
    n = pcfg.n_nodes
    dev = words.device
    cps = words[COPIES_WORD:COPIES_WORD + n * MAX_COPIES].reshape(
        n, MAX_COPIES).to(torch.int32)
    col_ok = torch.arange(MAX_COPIES, device=dev) < pcfg.n_copies
    copies = torch.where(col_ok[None, :], cps, -1).to(torch.int32)
    a0 = COPIES_WORD + n * MAX_COPIES
    bw = sl.u32(words[a0:a0 + alive_words(n)])
    idx = torch.arange(n, device=dev)
    alive = ((bw[idx // 32] >> (idx % 32)) & 1).to(torch.bool)
    return PlacementTable(epoch=words[EPOCH_WORD].to(torch.int32),
                          copies=copies, alive=alive)


# ---------------------------------------------------------------------------
# Publication: refresh (one-sided read) and install (RPC broadcast / local)
# ---------------------------------------------------------------------------
def refresh_table(t: Transport, state, layout, pcfg: PlacementConfig,
                  table: PlacementTable, *, enabled=None, nic=None,
                  telemetry=None):
    """Refresh the client-cached table with ONE one-sided read of the
    published routing region of the lowest live node per the CURRENT
    (possibly stale) table.

    enabled: optional bool — when False the read issues nothing (zero wire,
    zero round trips) and the decoded table is garbage; ``txloop`` gates
    it so and keeps the old table there.  Every SimTransport client
    reads identical bytes, so lane 0's decode is the one shared table.
    ``telemetry``: the read's flight-recorder event (phase REFRESH).
    Returns (table, WireStats)."""
    n_local = t.n_local
    dev = state["arena"].device
    coord = torch.argmax(table.alive.to(torch.int32)).to(torch.int32)
    dest = coord.to(dev).expand(n_local, 1)
    off = torch.full((n_local, 1), layout["routing"].base, dtype=torch.int32,
                     device=dev)
    en = None
    if enabled is not None:
        en = torch.as_tensor(enabled, dtype=torch.bool, device=dev).expand(
            n_local, 1)
    buf, _, stats = osd.remote_read(t, state["arena"], dest, off,
                                    length=routing_words(pcfg.n_nodes),
                                    enabled=en, nic=nic, telemetry=telemetry,
                                    phase=T.PH_REFRESH)
    return decode_region(pcfg, buf[0, 0]), stats


def install_records(pcfg: PlacementConfig, table: PlacementTable):
    """(n_parts, record_words) OP_PL_INSTALL records — one per partition:
    [op, part, epoch, 0, copies row (MAX_COPIES) ++ alive bits ++ 0...]."""
    n = pcfg.n_parts
    dev = table.copies.device
    cps = table.copies[:, :MAX_COPIES]
    rows = torch.where(cps >= 0, cps, sl.word(NONE)).to(torch.int32)
    bits = _alive_bits(pcfg.n_nodes, table.alive)[None].expand(
        n, alive_words(pcfg.n_nodes))
    pad = torch.zeros((n, sl.VALUE_WORDS - MAX_COPIES
                       - alive_words(pcfg.n_nodes)), dtype=torch.int32,
                      device=dev)
    head = torch.stack([
        torch.full((n,), W.OP_PL_INSTALL, dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev),
        table.epoch.to(torch.int32).expand(n),
        torch.zeros((n,), dtype=torch.int32, device=dev)], dim=-1)
    return torch.cat([head, rows, bits, pad], dim=-1)


def install_table(t: Transport, state, layout, pcfg: PlacementConfig,
                  table: PlacementTable, handler, *, targets=None,
                  issuer: int = 0, capacity: Optional[int] = None, nic=None):
    """Broadcast the table to ``targets`` (node ids; default every node
    slot) as OP_PL_INSTALL RPCs from ``issuer`` — the wire-honest path the
    membership and migration drivers use.  Returns (state, WireStats);
    ``state["arena"]`` is updated in place."""
    tg = (list(range(pcfg.n_nodes)) if targets is None
          else [int(x) for x in targets])
    dev = state["arena"].device
    recs1 = install_records(pcfg, table).to(dev)                # (P, Wrec)
    B = len(tg) * pcfg.n_parts
    n_local = t.n_local
    dest = torch.tensor(tg, dtype=torch.int32, device=dev).repeat_interleave(
        pcfg.n_parts)[None].expand(n_local, B)
    recs = recs1.repeat(len(tg), 1)[None].expand(n_local, B, recs1.shape[-1])
    en = (t.node_ids(dev) == issuer)[:, None].expand(n_local, B)
    state, _, _, stats = R.rpc_call(t, state, dest, recs, handler,
                                    capacity=capacity, enabled=en, nic=nic)
    return state, stats


def install_local(state, layout, pcfg: PlacementConfig, table: PlacementTable,
                  nodes=None):
    """Write the table straight into the routing regions of ``nodes``
    (default all), no wire — test setup, or the coordinator updating its own
    published copy.  Each node keeps its SELF_WORD.  ``state["arena"]`` is
    updated in place; returns the state."""
    rb = layout["routing"].base
    length = routing_words(pcfg.n_nodes)
    arena = state["arena"]
    rows = (torch.arange(arena.shape[0], device=arena.device) if nodes is None
            else torch.as_tensor(nodes, dtype=torch.int64,
                                 device=arena.device).reshape(-1))
    img = region_image(pcfg, table).to(arena.device)
    img = img[None].expand(rows.shape[0], length).clone()
    img[:, SELF_WORD] = arena[rows, rb + SELF_WORD]
    arena[rows, rb:rb + length] = img
    return state


# ---------------------------------------------------------------------------
# Membership: epoch-bumping table transitions + the repair planner (host)
# ---------------------------------------------------------------------------
def _with_alive(table: PlacementTable, node, up: bool) -> PlacementTable:
    alive = table.alive.clone()
    alive[torch.as_tensor(node, dtype=torch.int64, device=alive.device)] = up
    return PlacementTable(table.epoch + 1, table.copies, alive)


def kill_node(pcfg: PlacementConfig, table: PlacementTable,
              node) -> PlacementTable:
    """Failure: mark dead, bump the epoch.  Routing fails reads over at once
    (``live_dest``) and parks writes to partitions the node owned until
    ``repair_plan`` promotes a backup."""
    return _with_alive(table, node, False)


def join_node(pcfg: PlacementConfig, table: PlacementTable,
              node) -> PlacementTable:
    """(Re)join: mark live, bump the epoch.  The joiner serves no partition
    until ``migrate_partition`` / ``repair_plan`` route one to it."""
    return _with_alive(table, node, True)


def leave_node(pcfg: PlacementConfig, table: PlacementTable,
               node) -> PlacementTable:
    """Graceful departure: the same transition as ``kill_node``; the caller
    drains first (``drain_plan``, then ``migrate_partition`` each)."""
    return kill_node(pcfg, table, node)


def _host(table: PlacementTable):
    return table.copies.cpu().numpy(), table.alive.cpu().numpy()


def drain_plan(pcfg: PlacementConfig, table: PlacementTable, node: int):
    """Partitions owned by ``node``, each with a suggested new owner: the
    next live node on the ring that holds no copy yet.  [(part, dst)]."""
    copies, alive = _host(table)
    out = []
    for p in range(pcfg.n_parts):
        if copies[p, 0] != node:
            continue
        row = {int(c) for c in copies[p] if c >= 0}
        for step in range(1, pcfg.n_nodes):
            c = (p + step) % pcfg.n_nodes
            if c != node and alive[c] and c not in row:
                out.append((p, c))
                break
    return out


def repair_plan(pcfg: PlacementConfig, table: PlacementTable):
    """Re-replication planner (host side, deterministic): for every
    partition with dead copies, promote the first surviving copy to owner
    and refill the copy list with live ring successors.

    Returns (new_table, transfers), transfers a list of (part, src, dst):
    stream partition ``part`` from live copy ``src`` to new backup ``dst``
    (``rereplicate`` runs them).  A partition whose every copy is dead is
    left as it is.  The epoch bumps iff anything changed."""
    copies, alive = _host(table)
    new = copies.copy()
    transfers = []
    changed = False
    for p in range(pcfg.n_parts):
        row = [int(c) for c in copies[p] if c >= 0]
        live_row = [c for c in row if alive[c]]
        if live_row == row and len(live_row) >= pcfg.n_copies:
            continue
        if not live_row:
            continue
        newrow = list(live_row)
        for step in range(1, pcfg.n_nodes):
            if len(newrow) >= pcfg.n_copies:
                break
            c = (p + step) % pcfg.n_nodes
            if alive[c] and c not in newrow:
                transfers.append((p, newrow[0], c))
                newrow.append(c)
        if newrow == row:
            continue
        new[p, :] = newrow + [-1] * (copies.shape[1] - len(newrow))
        changed = True
    if not changed:
        return table, []
    return PlacementTable(table.epoch + 1,
                          torch.from_numpy(new).to(table.copies.device),
                          table.alive), transfers


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
# Data movement: one-issuer sweeps, re-replication, transactional migration
# ---------------------------------------------------------------------------
def _sweep_slices(B: int):
    step = max(int(SWEEP_LANES), 1)
    return [(a, min(a + step, B)) for a in range(0, B, step)]


def _sweep_stats(n_live: int, req_words: int, reply_words: int, nic, device):
    """WireStats of ONE round in which one node sends ``n_live`` requests
    to one node — the round an unsplit sweep bills."""
    mask = torch.ones((1, 1, n_live), dtype=torch.bool, device=device)
    return wire_for_classes([mask], [req_words], [reply_words], nic=nic)


def _read_region_images(t: Transport, state, src: int, puller: int, offsets,
                        length: int, nic=None):
    """One-sided bulk read: node ``puller`` reads ``offsets.shape[0]``
    images of ``length`` words each from node ``src`` — one read round, run
    in slices of SWEEP_LANES lanes.  Returns (images (B, length), WireStats
    of the one round)."""
    arena = state["arena"]
    dev = arena.device
    n = t.n_local
    B = offsets.shape[0]
    mine = (t.node_ids(dev) == puller)[:, None]
    out = torch.empty((B, length), dtype=torch.int32, device=dev)
    for a, b in _sweep_slices(B):
        w = b - a
        buf, _, _ = osd.remote_read(
            t, arena, torch.full((n, w), src, dtype=torch.int32, device=dev),
            offsets[None, a:b].expand(n, w), length=length,
            enabled=mine.expand(n, w), nic=nic)
        out[a:b] = buf[puller]
    return out, _sweep_stats(B, 1, length, nic, dev)


def _sweep_rpc(t: Transport, state, dest: int, issuer: int, records, live,
               handler, nic=None):
    """Node ``issuer`` sends ``records`` (B, W) where ``live`` (B,) to node
    ``dest`` — one RPC round, run in slices of SWEEP_LANES lanes in lane
    order (the owner folds the same records in the same order).  Returns
    (state, the issuer's replies (B, R), WireStats of the one round)."""
    dev = state["arena"].device
    n = t.n_local
    B, Wd = records.shape
    mine = (t.node_ids(dev) == issuer)[:, None]
    out = torch.zeros((B, handler.reply_words), dtype=torch.int32, device=dev)
    out[:, 0] = W.ST_DROPPED               # what an undelivered lane reads
    for a, b in _sweep_slices(B):
        w = b - a
        if not bool(live[a:b].any()):
            continue
        state, rep, _, _ = R.rpc_call(
            t, state, torch.full((n, w), dest, dtype=torch.int32, device=dev),
            records[None, a:b].expand(n, w, Wd), handler,
            enabled=mine & live[None, a:b], nic=nic)
        out[a:b] = rep[issuer]
    n_live = int(live.sum())
    return state, out, _sweep_stats(n_live, Wd, handler.reply_words, nic, dev)


def _region_offsets(cfg, layout, kind, part: int, src: int, dev):
    """Offsets and width of a full sweep of node ``src``'s records of
    ``part``: every slot of the hash table; every leaf of the B-tree's
    primary tree when ``src`` is the partition's home, else of its backup
    tree."""
    if kind == "hash":
        from repro_torch.core.datastructs import hashtable as ht
        return (ht.slot_idx_offset(layout, torch.arange(cfg.n_slots,
                                                        device=dev)),
                sl.SLOT_WORDS)
    base = layout["leaves" if part == src else "bleaves"].base
    return (sl.i32(base + torch.arange(cfg.n_leaves, device=dev)
                   * cfg.leaf_words), cfg.leaf_words)


def _enumerate_hash(cfg, images, part: int):
    """In-partition records of a full slot sweep: dict of key_lo, key_hi,
    version, value, lock, sel (present and in the partition) and clean (sel
    with an even version)."""
    from repro_torch.core.datastructs import hashtable as ht
    klo, khi = images[:, sl.KEY_LO], images[:, sl.KEY_HI]
    ver = images[:, sl.VERSION]
    sel = (klo != sl.EMPTY_KEY) & (ht.part_of(cfg, klo, khi) == part)
    return dict(key_lo=klo, key_hi=khi, version=ver,
                value=images[:, sl.VALUE0:], lock=images[:, sl.LOCK],
                sel=sel, clean=sel & ((ver & 1) == 0))


def _btree_in_range(ds, cfg, p, part: int):
    """(leaves, leaf_width) bool: live records of parsed leaves ``p`` whose
    keys lie in ``part``'s range (unsigned)."""
    lo, hi = (int(sl.u32(x)) for x in ds.partition_bounds(cfg, part))
    ku = sl.u32(p["keys"])
    return p["live"] & (ku >= lo) & (ku <= hi)


def _btree_backup_records(ds, p, sel):
    """OP_BT_BACKUP records of every record slot of parsed leaves ``p``
    (flattened) and their live mask."""
    keys = p["keys"].reshape(-1)
    recs = ds.make_record(W.OP_BT_BACKUP, keys, torch.zeros_like(keys),
                          value=p["values"].reshape(-1, sl.VALUE_WORDS))
    return recs, sel.reshape(-1)


def _simulator_only(t: Transport, who: str):
    """The one-issuer sweeps read the issuer's replies of another node's
    region on the host and decide from them whether to send at all, so they
    need the whole cluster in this process.  The JAX package runs them on
    its simulator only (``jax.device_get(buf[puller])``,
    src/repro/core/placement.py:435, does not trace under shard_map); on a
    MeshTransport they would make the ranks disagree on their exchanges."""
    if not t.holds_all_arenas:
        raise ValueError(
            f"{who} runs only on a SimTransport: its sweeps read replies on "
            "the host, which the JAX package does only on its simulator "
            "(src/repro/core/placement.py:435), and a MeshTransport's ranks "
            "would disagree on the number of exchanges")


def rereplicate(t: Transport, state, cfg, layout, pcfg: PlacementConfig,
                transfers, *, nic=None):
    """Execute ``repair_plan`` transfers: for each (part, src, dst), the new
    backup ``dst`` pulls the partition's records from the surviving copy
    ``src`` with a one-sided sweep, then installs them into itself through
    the backup classes (OP_BACKUP_WRITE byte-equal images for the hash
    table, OP_BT_BACKUP logical upserts for the B-tree).

    Install the repaired table BEFORE streaming: new commits then already
    fan out to ``dst``, so the stream only carries the pre-failure state;
    locked or mid-commit (odd-version) records are skipped for the same
    reason.  Returns (state, WireStats) — the re-replication bytes;
    ``state["arena"]`` is updated in place.  SimTransport only (a
    MeshTransport raises ValueError: ``_simulator_only``)."""
    _simulator_only(t, "rereplicate")
    ds, kind = _ds_for(cfg)
    handler = ds.make_rpc_handler(cfg, layout)
    dev = state["arena"].device
    total = WireStats.zero(dev)
    for part, src, dst in transfers:
        part, src, dst = int(part), int(src), int(dst)
        offs, length = _region_offsets(cfg, layout, kind, part, src, dev)
        images, s = _read_region_images(t, state, src, dst, offs, length,
                                        nic=nic)
        total = total + s
        if kind == "hash":
            e = _enumerate_hash(cfg, images, part)
            recs = ds.make_record(W.OP_BACKUP_WRITE, e["key_lo"], e["key_hi"],
                                  aux=e["version"], value=e["value"])
            live = e["clean"]
        else:
            p = ds.parse_leaf(cfg, images)
            stable = ((p["version"] & 1) == 0) & (p["lock"] == 0)
            recs, live = _btree_backup_records(
                ds, p, _btree_in_range(ds, cfg, p, part) & stable[:, None])
        state, _, s2 = _sweep_rpc(t, state, dst, dst, recs, live, handler,
                                  nic=nic)
        total = total + s2
    return state, total


def migrate_partition(t: Transport, state, cfg, layout,
                      pcfg: PlacementConfig, table: PlacementTable,
                      part: int, dst: int, *, nic=None):
    """Transactionally move partition ``part`` to new owner ``dst``
    (source-lock -> copy -> epoch flip), riding the OCC machinery:

      1. ENUMERATE   — one-sided sweep of the source's slot/leaf region.
      2. SOURCE-LOCK — OP_LOCK / OP_BT_LOCK every record/leaf that carries
         the partition's keys, with the migration tag.  An in-flight client
         transaction holds one of those locks, so the migration's lock
         fails and the whole migration ABORTS (unlock, table unchanged): a
         migration never races a commit.
      3. FREEZE      — install the bumped table on the SOURCE only: it stops
         granting new lock-class ops for the partition (ST_WRONG_EPOCH).
      4. COPY        — re-read the (now lock-stable) records and install
         them on ``dst`` through the backup classes.
      5. FLIP        — install the bumped table everywhere; clients that
         still route with the old table get ST_WRONG_EPOCH and refresh.
      6. UNLOCK      — release the migration locks at the source.

    The new copy row is [dst] + the old copies (minus dst), truncated to
    f+1, so at f >= 1 the old owner stays on as a backup.

    Returns (table', state, WireStats, migrated: bool); table' is the input
    table when the migration aborted.  ``state["arena"]`` is updated in
    place.  SimTransport only (a MeshTransport raises ValueError:
    ``_simulator_only``)."""
    _simulator_only(t, "migrate_partition")
    ds, kind = _ds_for(cfg)
    handler = ds.make_rpc_handler(cfg, layout)
    part, dst = int(part), int(dst)
    dev = state["arena"].device
    copies_h = table.copies.cpu().numpy()
    src = int(copies_h[part, 0])
    total = WireStats.zero(dev)
    if src == dst:
        return table, state, total, True

    old_row = [int(c) for c in copies_h[part] if c >= 0]
    new_row = ([dst] + [c for c in old_row if c != dst])[:pcfg.n_copies]
    new_row += [-1] * (copies_h.shape[1] - len(new_row))
    copies2 = table.copies.clone()
    copies2[part] = torch.tensor(new_row, dtype=torch.int32,
                                 device=copies2.device)
    table2 = PlacementTable(table.epoch + 1, copies2, table.alive)

    def src_rpc(recs, live):
        nonlocal state, total
        state, rep, s = _sweep_rpc(t, state, src, dst, recs, live, handler,
                                   nic=nic)
        total = total + s
        return rep

    # -- 1. enumerate ------------------------------------------------------
    offs, length = _region_offsets(cfg, layout, kind, part, src, dev)
    images, s = _read_region_images(t, state, src, dst, offs, length, nic=nic)
    total = total + s

    # -- 2. source-lock ----------------------------------------------------
    B = offs.shape[0]
    tag = torch.full((B,), sl.word(MIG_TAG | part), dtype=torch.int32,
                     device=dev)
    if kind == "hash":
        e = _enumerate_hash(cfg, images, part)
        sel = e["sel"]                     # every in-partition record,
        lock_recs = ds.make_record(        # locked/mid-commit ones included:
            W.OP_LOCK, e["key_lo"], e["key_hi"], aux=tag)  # they DETECT
        lock_key = e["key_lo"]                              # conflicts
    else:
        p = ds.parse_leaf(cfg, images)
        in_rng = _btree_in_range(ds, cfg, p, part)
        sel = in_rng.any(dim=1)            # leaves carrying partition keys
        lock_key = sl.i32(torch.where(in_rng, sl.u32(p["keys"]),
                                      sl.MASK32).min(dim=1).values)
        lock_recs = ds.make_record(W.OP_BT_LOCK, lock_key,
                                   torch.zeros_like(lock_key), aux=tag)
    rep = src_rpc(lock_recs, sel)
    got = sel & (rep[:, 0] == W.ST_OK)
    lock_aux = rep[:, 1]                   # slot / header idx for the unlock

    def unlock():
        if kind == "hash":
            recs = ds.make_record(W.OP_ABORT_UNLOCK, tag,
                                  torch.zeros_like(tag), aux=lock_aux)
        else:
            recs = ds.make_record(W.OP_BT_ABORT, lock_key, tag, aux=lock_aux)
        src_rpc(recs, got)

    if bool((sel & ~got).any()):
        # an in-flight transaction holds part of the partition: abort
        unlock()
        return table, state, total, False

    # -- 3. freeze (the source learns the new epoch first) -----------------
    state, s = install_table(t, state, layout, pcfg, table2, handler,
                             targets=[src], issuer=dst, nic=nic)
    total = total + s

    # -- 4. copy (records are lock-stable now) -----------------------------
    images, s = _read_region_images(t, state, src, dst, offs, length, nic=nic)
    total = total + s
    if kind == "hash":
        e = _enumerate_hash(cfg, images, part)
        recs = ds.make_record(W.OP_BACKUP_WRITE, e["key_lo"], e["key_hi"],
                              aux=e["version"], value=e["value"])
        live = e["sel"] & ((e["version"] & 1) == 0)
    else:
        p = ds.parse_leaf(cfg, images)
        recs, live = _btree_backup_records(ds, p,
                                           _btree_in_range(ds, cfg, p, part))
    state, _, s = _sweep_rpc(t, state, dst, dst, recs, live, handler, nic=nic)
    total = total + s

    # -- 5. flip everywhere ------------------------------------------------
    state, s = install_table(t, state, layout, pcfg, table2, handler,
                             issuer=dst, nic=nic)
    total = total + s

    # -- 6. unlock the source ----------------------------------------------
    unlock()
    return table2, state, total, True


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
    and its check are ``onesided.probe_round`` (for the hash table one
    ``hash_probe`` launch), routed and accounted like
    ``onesided.remote_read``.  Returns
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

    pe, ovf1, s1 = osd.probe_round(t, state, ds, cfg, layout, dest, off,
                                   key_lo, key_hi, hit, capacity=capacity,
                                   enabled=en, nic=nic)
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
