"""Ordered remote index: a fixed-fanout B-link tree over the slot arena,
PyTorch port of ``repro/core/datastructs/btree.py``.

Storm's dataplane is data-structure-generic (Table 3): a structure registers
``lookup_start`` / ``lookup_end`` client-side and an ``rpc_handler``
owner-side, and the one-two-sided hybrid plus the OCC protocol do the rest.
The hash table exercises the pointer-chase regime; this module adds the
ORDERED regime:

  * **Layout**: the key space [0, 2^32-2] is RANGE-PARTITIONED evenly across
    nodes.  Each node owns ``n_leaves`` LEAVES; a leaf is one HEADER slot
    followed by ``leaf_width`` record slots (``slots`` word layout).  The
    header reuses the slot words: KEY_LO = low fence (immutable), KEY_HI =
    high fence (inclusive; shrinks on a split), VERSION = leaf seqlock (even
    = stable; every record or structural change bumps it), LOCK = leaf lock,
    NEXT_PTR = right-link (NULL_PTR at the partition's end), value[0] = live
    record count (records [0, count) sorted by key).
  * **Inner nodes**: a per-node separator directory (``sep``: fence_lo of
    every allocated leaf).  Clients cache it (``refresh_meta`` = one
    one-sided read per node) and walk it locally, so a probe needs ONE
    one-sided read of the predicted leaf; a stale cache mis-predicts at most
    by missing new leaves, which the probe detects from the fetched fences
    and resolves by RPC (``OP_BT_LOOKUP`` / ``OP_BT_SCAN``).
  * **Structural ops are RPC**: ``OP_BT_INSERT`` / ``OP_BT_DELETE`` run in
    the serial handler; a full leaf splits (the left keeps the lower half,
    the new right leaf is linked via NEXT_PTR and registered in ``sep``).
    Deletes never merge.
  * **Transactions at leaf granularity**: ``OP_BT_LOCK`` locks the leaf that
    covers a write key, pre-splitting a full leaf so the later
    ``OP_BT_COMMIT`` always has room.  Range scans read leaves one-sided and
    validate leaf versions (``tx.run_scan_transactions``).

Replication: every node carries a SECOND, full-range leaf arena
(``bleaves`` / ``bsep`` / ``bnleaf``) for the partitions it backs up; the
handlers select the tree by key-vs-partition (``pbounds``), so backup
installs and backup-side lookups never touch the primary fence chain.

Port notes.  Words are int32 bit images; every order comparison of keys or
fences goes through the unsigned value in int64 (keys above 2^31 must sort
after 0), and the leaf rebuild sorts stably on it.  The serial handler takes
one record for EVERY node at once (``rec (N, W)``, ``valid (N,)``) and
updates ``state["arena"]`` in place, like the hash table's.  Routing a key
through a separator directory is the reference's argmax over
``where(candidate, fence, 0)``; the owner's serial step does exactly that,
and the many-lane callers (vector handlers, cached client walks, scan plans)
sort each directory once and binary-search it, with the same answer.  The
reference's ``lax.dynamic_slice`` start clamps are kept.

Limitations (as the reference): keys are the 32-bit ``key_lo`` (``key_hi``
must be 0); one write key per leaf per transaction lane; backups replicate
logically (leaf arenas may pack records differently).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import onesided as osd
from repro_torch.core import placement as pl
from repro_torch.core import regions as rg
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.core.datastructs.hashtable import make_record  # noqa: F401
from repro_torch.device import resolve_device
# make_record is re-exported: the btree speaks the SAME record layout
# [op, key_lo, key_hi, aux, value...] as every other structure.

MAX_KEY = 0xFFFFFFFE      # 0xFFFFFFFF is the empty-slot sentinel
_BIG = 1 << 32            # an invalid directory entry's fence in the sorts


@dataclasses.dataclass(frozen=True)
class BTreeConfig:
    n_nodes: int
    n_leaves: int                # per node — static leaf arena capacity
    leaf_width: int = 4          # records per leaf (fanout)
    max_scan_leaves: int = 4     # static per-lane bound on leaves per scan

    def __post_init__(self):
        if self.leaf_width < 2:
            raise ValueError("leaf_width must be >= 2 (splits need a real "
                             f"separator key), got {self.leaf_width}")
        if self.n_leaves < 1 or self.max_scan_leaves < 1:
            raise ValueError("n_leaves and max_scan_leaves must be >= 1")

    @property
    def leaf_slots(self) -> int:        # header + records
        return 1 + self.leaf_width

    @property
    def leaf_words(self) -> int:
        return self.leaf_slots * sl.SLOT_WORDS

    @property
    def record_words(self) -> int:      # [op, key_lo, key_hi, aux, value...]
        return 4 + sl.VALUE_WORDS

    @property
    def reply_words(self) -> int:       # [status, header slot, version, value...]
        return 3 + sl.VALUE_WORDS

    @property
    def scan_reply_words(self) -> int:  # [status, header slot] + leaf image
        return 2 + self.leaf_words


def build_layout(cfg: BTreeConfig) -> rg.RegionTable:
    tbl = rg.RegionTable()
    tbl.register("leaves", cfg.n_leaves * cfg.leaf_words)
    tbl.register("sep", cfg.n_leaves)   # fence_lo per allocated leaf
    tbl.register("nleaf", 1)            # leaf bump allocator (adjacent to sep
                                        # so ONE one-sided read refreshes both)
    # the BACKUP tree: a second leaf arena whose root covers the FULL key
    # space (ring placement puts every replicated key outside the backup
    # node's own partition)
    tbl.register("bleaves", cfg.n_leaves * cfg.leaf_words)
    tbl.register("bsep", cfg.n_leaves)
    tbl.register("bnleaf", 1)
    tbl.register("pbounds", 2)          # this node's inclusive partition [lo, hi]
    tbl.register("routing", pl.routing_words(cfg.n_nodes))
    tbl.register("scratch", 1)          # must stay LAST (write sink)
    return tbl


# ---------------------------------------------------------------------------
# Range partition: the static "root" of the global tree
# ---------------------------------------------------------------------------
def _part(cfg: BTreeConfig) -> int:
    return (1 << 32) // cfg.n_nodes


def home_of(cfg: BTreeConfig, key):
    """Home node (int32) of key words — static range partition, the tail
    node clipped."""
    key = torch.as_tensor(key)
    if cfg.n_nodes == 1:
        return torch.zeros(key.shape, dtype=torch.int32, device=key.device)
    return (sl.u32(key) // _part(cfg)).clamp(max=cfg.n_nodes - 1).to(
        torch.int32)


def part_of(cfg: BTreeConfig, key_lo, key_hi=None):
    """The key's PARTITION (generic placement interface)."""
    return home_of(cfg, key_lo)


def partition_bounds(cfg: BTreeConfig, node):
    """(lo, hi) INCLUSIVE key bounds of a node's partition, as words."""
    node = torch.as_tensor(node).to(torch.int64)
    if cfg.n_nodes == 1:
        return (torch.zeros(node.shape, dtype=torch.int32, device=node.device),
                torch.full(node.shape, sl.word(MAX_KEY), dtype=torch.int32,
                           device=node.device))
    part = _part(cfg)
    lo = node * part
    hi = torch.where(node == cfg.n_nodes - 1, MAX_KEY, (node + 1) * part - 1)
    return sl.i32(lo), sl.i32(hi)


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------
def init_cluster_state(cfg: BTreeConfig, device="cuda"):
    """Cluster state {"arena": (N, words) int32}: every leaf slot formatted
    empty; the primary tree's leaf 0 covers the node's partition, the backup
    tree's leaf 0 the FULL key space; partition bounds, the epoch-0 identity
    placement table and each node's SELF_WORD published."""
    dev = resolve_device(device)
    layout = build_layout(cfg)
    N = cfg.n_nodes
    arena = torch.zeros((N, layout.total_words), dtype=torch.int32, device=dev)
    lo, hi = partition_bounds(cfg, torch.arange(N, device=dev))
    zero = torch.zeros_like(lo)
    maxk = torch.full_like(lo, sl.word(MAX_KEY))
    for leaves, sep, nleaf, flo, fhi in (
            ("leaves", "sep", "nleaf", lo, hi),
            ("bleaves", "bsep", "bnleaf", zero, maxk)):
        b = layout[leaves].base
        slots_v = arena[:, b:b + cfg.n_leaves * cfg.leaf_words].view(
            N, cfg.n_leaves * cfg.leaf_slots, sl.SLOT_WORDS)
        slots_v[..., sl.KEY_LO] = sl.EMPTY_KEY
        slots_v[..., sl.NEXT_PTR] = sl.NULL_PTR
        arena[:, b:b + sl.SLOT_WORDS] = sl.pack_slot(
            flo, fhi, 0, 0, sl.NULL_PTR,
            torch.zeros((N, sl.VALUE_WORDS), dtype=torch.int32, device=dev))
        arena[:, layout[sep].base] = flo
        arena[:, layout[nleaf].base] = 1
    pb = layout["pbounds"].base
    arena[:, pb] = lo
    arena[:, pb + 1] = hi
    rb = layout["routing"].base
    img = pl.identity_region_image(N, device=dev)
    arena[:, rb:rb + img.shape[0]] = img
    arena[:, rb + pl.SELF_WORD] = torch.arange(N, dtype=torch.int32,
                                               device=dev)
    return {"arena": arena}


def leaf_offset(cfg: BTreeConfig, layout: rg.RegionTable, leaf):
    """Arena word offset (word) of primary-tree leaf `leaf`."""
    return sl.i32(layout["leaves"].base + sl.u32(leaf) * cfg.leaf_words)


def backup_leaf_offset(cfg: BTreeConfig, layout: rg.RegionTable, leaf):
    """Arena word offset (word) of BACKUP-tree leaf `leaf`."""
    return sl.i32(layout["bleaves"].base + sl.u32(leaf) * cfg.leaf_words)


def header_slot(cfg: BTreeConfig, leaf):
    """Slot index (word, within the leaf region) of a leaf's header — the
    address unit of the validation re-read and COMMIT addressing."""
    return sl.i32(sl.u32(leaf) * cfg.leaf_slots)


# ---------------------------------------------------------------------------
# Cached inner nodes (the client's copy of every node's separator directory)
# ---------------------------------------------------------------------------
def local_meta(cfg: BTreeConfig, layout: rg.RegionTable, state,
               n_clients=None):
    """Snapshot every node's separator directory WITHOUT wire traffic (setup
    and test helper): {"sep": (C, n_nodes, n_leaves), "nleaf": (C, n_nodes)}
    words, replicated per client.  It reads every node's arena, so it is a
    SimTransport helper: on a MeshTransport a rank's directory cache comes
    from ``refresh_meta``."""
    n_clients = cfg.n_nodes if n_clients is None else n_clients
    s = layout["sep"].base
    sep = state["arena"][:, s:s + cfg.n_leaves]
    nleaf = state["arena"][:, layout["nleaf"].base]
    return {"sep": sep[None].expand((n_clients,) + sep.shape).clone(),
            "nleaf": nleaf[None].expand((n_clients,) + nleaf.shape).clone()}


def _refresh(t, state, cfg, region, nic):
    dev = state["arena"].device
    n_local = t.n_local
    dest = torch.arange(cfg.n_nodes, dtype=torch.int32, device=dev).expand(
        n_local, cfg.n_nodes)
    off = torch.full((n_local, cfg.n_nodes), region.base, dtype=torch.int32,
                     device=dev)
    # each client reads each node once, so one cell per destination holds
    # every read: capacity 1 changes no reply and no WireStats, and keeps
    # the exchange at one directory per (client, node)
    buf, _, stats = osd.remote_read(t, state["arena"], dest, off,
                                    length=cfg.n_leaves + 1, capacity=1,
                                    nic=nic)
    return {"sep": buf[..., :cfg.n_leaves], "nleaf": buf[..., cfg.n_leaves]}, \
        stats


def refresh_meta(t, state, cfg: BTreeConfig, layout: rg.RegionTable, *,
                 nic=None):
    """Refresh the cached inner nodes with ONE one-sided read per node (the
    adjacent ``sep`` and ``nleaf`` regions).  Returns (meta, WireStats)."""
    return _refresh(t, state, cfg, layout["sep"], nic)


def refresh_backup_meta(t, state, cfg: BTreeConfig, layout: rg.RegionTable,
                        *, nic=None):
    """The BACKUP trees' separator directories (``bsep`` / ``bnleaf``, again
    one one-sided read per node): what a scan served by a backup tree plans
    against once its partition's primary died."""
    return _refresh(t, state, cfg, layout["bsep"], nic)


def _route_leaf(cfg: BTreeConfig, fences, nleaf, key):
    """fences (..., n_leaves) fence_lo words; nleaf (...,); key (...,).
    Returns (leaf, fence) as int64: the first allocated leaf with the
    largest fence_lo <= key (unsigned) — the argmax over where(candidate,
    fence, 0), so leaf 0 with fence 0 when no fence qualifies."""
    valid = (torch.arange(cfg.n_leaves, device=fences.device)
             < sl.u32(nleaf)[..., None])
    fu = sl.u32(fences)
    score = torch.where(valid & (fu <= sl.u32(key)[..., None]), fu, 0)
    leaf = torch.argmax(score, dim=-1)
    return leaf, torch.gather(score, -1, leaf[..., None])[..., 0]


def _route_sorted(fences, nleaf, d, key):
    """:func:`_route_leaf` for many lanes over a few directories, by sorting
    each directory once and binary-searching it.  fences (D, L) words,
    nleaf (D,), d (...,) the directory of each lane, key (...,) words.
    Returns (leaf, fence) int64, the same answer as the argmax."""
    D, L = fences.shape
    dev = fences.device
    lb = max(1, (L - 1).bit_length())
    if (D - 1).bit_length() + 33 + lb > 62:
        raise ValueError(f"{D} directories of {L} leaves exceed the sort key")
    idx = torch.arange(L, device=dev)
    f33 = torch.where(idx[None] < sl.u32(nleaf)[:, None], sl.u32(fences),
                      _BIG)
    comp = (((torch.arange(D, device=dev)[:, None] << 33) | f33) << lb
            | idx[None]).reshape(-1)
    comp = torch.sort(comp).values
    d = d.to(torch.int64)
    # the last entry of directory d whose fence is <= key
    q = ((d << 33) | (sl.u32(key) + 1)) << lb
    pos = torch.searchsorted(comp, q.reshape(-1)).reshape(q.shape) - 1
    e = comp[pos.clamp(min=0)]
    f = (e >> lb) & ((1 << 33) - 1)
    hit = (pos >= 0) & ((e >> (33 + lb)) == d) & (f > 0)
    # the first leaf holding that fence (argmax takes the first maximum)
    first = torch.searchsorted(comp, (((d << 33) | f) << lb).reshape(-1))
    leaf = comp[first.clamp(max=comp.numel() - 1)].reshape(q.shape) & (
        (1 << lb) - 1)
    return torch.where(hit, leaf, 0), torch.where(hit, f, 0)


# ---------------------------------------------------------------------------
# Client side: the Storm Table-3 interface (consumed by hybrid via ds=btree)
# ---------------------------------------------------------------------------
def uses_probe_cache(cfg: BTreeConfig) -> bool:
    """The separator cache is per-client state, refreshed explicitly."""
    return True


def probe_words(cfg: BTreeConfig) -> int:
    """One probe reads ONE whole leaf (header + records)."""
    return cfg.leaf_words


def lookup_start(cfg: BTreeConfig, layout: rg.RegionTable, key_lo, key_hi,
                 cache=None, ptable=None):
    """Client-side metadata walk: range-partition to the node, walk the
    CACHED separator directory to the leaf.  key_lo: (C, ...) with one row
    per client; cache {"sep": (C, n_nodes, n_leaves), "nleaf": (C, n_nodes)}.
    Without a cache the probe targets leaf 0 and the RPC fallback resolves.
    ``ptable``: route to the first LIVE copy instead of the static home (a
    failed-over probe misses its fences and falls back, never fast).
    Returns (node int32, offset word, hit bool)."""
    node = home_of(cfg, key_lo)
    if ptable is not None:
        node, _ = pl.live_dest(ptable, node)
    if cache is None:
        leaf = torch.zeros(key_lo.shape, dtype=torch.int64,
                           device=key_lo.device)
        hit = torch.zeros(key_lo.shape, dtype=torch.bool,
                          device=key_lo.device)
    else:
        C, n, L = cache["sep"].shape
        client = torch.arange(C, device=key_lo.device).reshape(
            (C,) + (1,) * (key_lo.dim() - 1))
        # a negative (unreachable) node indexes from the end, as the
        # reference's cache["sep"][node] does
        row = torch.where(node < 0, node + n, node).clamp(0, n - 1)
        leaf, _ = _route_sorted(cache["sep"].reshape(C * n, L),
                                cache["nleaf"].reshape(C * n),
                                client * n + row.to(torch.int64), key_lo)
        hit = torch.ones(key_lo.shape, dtype=torch.bool, device=key_lo.device)
    return node, leaf_offset(cfg, layout, leaf), hit


def parse_leaf(cfg: BTreeConfig, buf):
    """Decode leaf images.  buf (..., leaf_words) -> dict(fence_lo,
    fence_hi, version, lock, next, count (...,), live / keys (...,
    leaf_width), values (..., leaf_width, VALUE_WORDS))."""
    shp = buf.shape[:-1]
    slots_ = buf.reshape(shp + (cfg.leaf_slots, sl.SLOT_WORDS))
    hdr, recs = slots_[..., 0, :], slots_[..., 1:, :]
    count = hdr[..., sl.VALUE0]
    live = (torch.arange(cfg.leaf_width, device=buf.device)
            < sl.u32(count)[..., None])
    return dict(
        fence_lo=sl.slot_key_lo(hdr), fence_hi=sl.slot_key_hi(hdr),
        version=sl.slot_version(hdr), lock=sl.slot_lock(hdr),
        next=sl.slot_next(hdr), count=count, live=live,
        keys=sl.slot_key_lo(recs), values=sl.slot_value(recs))


def probe_end(cfg: BTreeConfig, layout: rg.RegionTable, buf, key_lo, key_hi,
              off, hit, delivered=None):
    """Validate a one-sided leaf read (the ordered lookup_end).  ``resolved``
    = the read CONCLUSIVELY answered the probe: stable header whose fences
    cover the key (then an absent key is a definitive miss).  ``delivered``
    is not needed: an undelivered lane's words are zeros, whose fences
    cover no key."""
    p = parse_leaf(cfg, buf)
    key = sl.u32(key_lo)
    stable = ((p["version"] & 1) == 0) & (p["lock"] == 0)
    in_fence = (sl.u32(p["fence_lo"]) <= key) & (key <= sl.u32(p["fence_hi"]))
    resolved = stable & in_fence & (key_hi == 0)
    m = p["live"] & (p["keys"] == key_lo[..., None])
    found = resolved & m.any(dim=-1)
    idx = torch.argmax(m.to(torch.int32), dim=-1)
    value = torch.gather(p["values"], -2, idx[..., None, None].expand(
        idx.shape + (1, sl.VALUE_WORDS)))[..., 0, :]
    value = torch.where(found[..., None], value, 0)
    leaf = ((sl.u32(off) - layout["leaves"].base) & sl.MASK32) \
        // cfg.leaf_words
    return dict(found=found, value=value, version=p["version"],
                slot_idx=header_slot(cfg, leaf), resolved=resolved)


def probe_read(cfg: BTreeConfig, layout: rg.RegionTable, arenas, dest, off,
               key_lo, key_hi, hit, delivered):
    """The one-sided probe's owner-side read with :func:`probe_end`: a plain
    gather of the ``delivered`` lanes' leaf lines from ``arenas[dest]`` at
    ``off`` (the others read zeros, as an undelivered read does), then
    ``probe_end`` — the contract of ``hashtable.probe_read`` (the B-tree has
    no kernel of its own)."""
    rows = dest.clamp(0, arenas.shape[0] - 1).reshape(-1)
    buf = rg.arena_read_rows(arenas, rows, off.reshape(-1), cfg.leaf_words)
    buf = torch.where(delivered[..., None],
                      buf.reshape(off.shape + (cfg.leaf_words,)), 0)
    return probe_end(cfg, layout, buf, key_lo, key_hi, off, hit)


def lookup_records(cfg: BTreeConfig, key_lo, key_hi):
    """Request records for the point-lookup RPC fallback."""
    return make_record(W.OP_BT_LOOKUP, key_lo, key_hi)


def cache_update(cfg: BTreeConfig, cache, key_lo, key_hi, node, slot_idx,
                 valid):
    """No-op: the separator cache is refreshed wholesale by refresh_meta."""
    return cache


# ---------------------------------------------------------------------------
# Scan planning: which (node, leaf) sequence covers [lo, hi]?
# ---------------------------------------------------------------------------
def scan_plan(cfg: BTreeConfig, meta_sep, meta_nleaf, lo, hi):
    """Plan every client's scans from its cached separators.

    meta_sep (C, n_nodes, n_leaves), meta_nleaf (C, n_nodes), lo / hi (C, B)
    INCLUSIVE key words (lo > hi = the lane scans nothing).  Returns dict of
    (C, B, max_scan_leaves) tensors: node, leaf, fence (the expected
    fence_lo, which also addresses the RPC fallback), enabled.

    The global leaf order is (node, fence_lo): each client's flattened
    directory is sorted once (stably, on the unsigned fence, allocated leaves
    first) and every lane's leaf run is read off by rank."""
    C, n, L = meta_sep.shape
    S = cfg.max_scan_leaves
    dev = meta_sep.device
    gnode = torch.arange(n, device=dev).repeat_interleave(L)
    gleaf = torch.arange(L, device=dev).repeat(n)
    gfence = meta_sep.reshape(C, n * L)
    gvalid = (torch.arange(L, device=dev)[None, None]
              < sl.u32(meta_nleaf)[..., None]).reshape(C, n * L)
    key = (torch.where(gvalid, gnode, n) << 32) | sl.u32(gfence)
    skey, order = torch.sort(key, dim=1, stable=True)
    total = gvalid.sum(dim=1)                               # (C,)

    lo_u, hi_u = sl.u32(lo), sl.u32(hi)
    node0 = home_of(cfg, lo).to(torch.int64)                # (C, B)
    # the routed fence of lo in node0's directory: the largest allocated
    # fence <= lo, 0 if none (the argmax score of _route_leaf)
    pos = torch.searchsorted(skey, (node0 << 32) | lo_u, right=True) - 1
    e = torch.gather(skey, 1, pos.clamp(min=0))
    f0 = torch.where((pos >= 0) & ((e >> 32) == node0), e & sl.MASK32, 0)
    rank0 = torch.searchsorted(skey, (node0 << 32) | f0)    # (C, B)
    k = rank0[..., None] + torch.arange(S, device=dev)      # (C, B, S)
    kc = k.clamp(max=n * L - 1).reshape(C, -1)
    sorder = torch.gather(order, 1, kc)
    sfence = torch.gather(gfence, 1, sorder).reshape(k.shape)
    sorder = sorder.reshape(k.shape)
    en = ((k < total[:, None, None]) & (sl.u32(sfence) <= hi_u[..., None])
          & (lo_u <= hi_u)[..., None])
    return dict(node=gnode[sorder].to(torch.int32),
                leaf=gleaf[sorder].to(torch.int32), fence=sfence, enabled=en)


def scan_records(cfg: BTreeConfig, plan):
    """OP_BT_SCAN request records for the per-position RPC fallback: the
    expected (immutable) fence_lo addresses the leaf."""
    return make_record(W.OP_BT_SCAN, plan["fence"],
                       torch.zeros_like(plan["fence"]))


# ---------------------------------------------------------------------------
# Owner side: serial handler (mutations, locks, commits) + vector handlers
# ---------------------------------------------------------------------------
def _leaf_start(cfg, base, leaf, n_words):
    """First word (int64) of leaf ``leaf`` of the tree at word ``base``, with
    ``lax.dynamic_slice``'s start rule: the 32-bit offset read as int32 and
    clamped into [0, n_words - leaf_words]."""
    off = (base + (leaf & sl.MASK32) * cfg.leaf_words) & sl.MASK32
    return torch.where(off < (1 << 31),
                       off.clamp(max=n_words - cfg.leaf_words), 0)


def _leaf_index(cfg, arena, base, leaf):
    return (_leaf_start(cfg, base, leaf, arena.shape[-1])[:, None]
            + torch.arange(cfg.leaf_words, device=arena.device))


def _read_leaf(cfg, arena, rows, base, leaf):
    """Leaf images (lanes, leaf_slots, SLOT_WORDS): lane i reads leaf
    ``leaf[i]`` of the tree at word ``base[i]`` in node row ``rows[i]``
    (``rows=None``: lane n reads node n)."""
    idx = _leaf_index(cfg, arena, base, leaf)
    flat = (torch.gather(arena, 1, idx) if rows is None
            else arena[rows[:, None], idx])
    return flat.reshape(-1, cfg.leaf_slots, sl.SLOT_WORDS)


def _write_leaf(cfg, arena, base, leaf, image, enabled):
    """In place: node n's leaf ``leaf[n]`` := image[n] where enabled[n]."""
    idx = _leaf_index(cfg, arena, base, leaf)
    arena.scatter_(1, idx, torch.where(enabled[:, None], image.reshape(
        image.shape[0], -1), torch.gather(arena, 1, idx)))


# Handler constructors are memoized per (kind, config): a handler is a
# closure over (cfg, layout) and holds no tensor (its constants are made per
# device on first use), so one handler serves states on any device.
_handler_cache: dict = {}


def _cached(kind, cfg, build):
    h = _handler_cache.get((kind, cfg))
    if h is None:
        h = _handler_cache[(kind, cfg)] = build()
    return h


@functools.lru_cache(maxsize=None)
def _empty_slot(dev):
    return sl.make_empty_slot(dev)


@functools.lru_cache(maxsize=None)
def _const(dev, x):
    """0-dim word constants, made once per device (no copy per record)."""
    return torch.tensor(x, dtype=torch.int32, device=dev)


def make_rpc_handler(cfg: BTreeConfig, layout: rg.RegionTable) -> R.Handler:
    """The serial (mutating) rpc_handler serving every btree opcode.

    Record layout [op, key_lo, key_hi, aux, value...]:
      * LOOKUP/INSERT/DELETE: key in key_lo (key_hi must be 0).
      * LOCK: aux = the caller's lock tag; a full leaf that must later absorb
        an insert is PRE-SPLIT here, so COMMIT never lacks space.
      * COMMIT/ABORT: key_hi = the lock tag, aux = the header slot index
        from the LOCK reply (direct addressing, no walk).
      * BACKUP: logical replica install — an upsert on THIS node's tree.
      * OP_PL_INSTALL: update the routing region.
    Reply: [status, header slot idx of the key's leaf, leaf version, value].

    fn(state, rec (N, W), valid (N,), pre=None, ops=None) applies node n's
    record rec[n] to node n's arena, in place, for every node at once."""
    return _cached("serial", cfg, lambda: _make_rpc_handler(cfg, layout))


def _make_rpc_handler(cfg: BTreeConfig, layout: rg.RegionTable) -> R.Handler:
    lw, lslots, L, V = cfg.leaf_width, cfg.leaf_slots, cfg.n_leaves, \
        sl.VALUE_WORDS
    left_n = (lw + 1) // 2
    pb = layout["pbounds"].base
    rb = layout["routing"].base
    aw = pl.alive_words(cfg.n_nodes)
    alive_off = rb + pl.COPIES_WORD + cfg.n_nodes * pl.MAX_COPIES
    base_of = {k: layout[k].base for k in ("leaves", "bleaves", "sep", "bsep",
                                            "nleaf", "bnleaf")}

    def fn(state, rec, valid, pre=None, ops=None):
        arena = state["arena"]
        dev = arena.device
        n = rec.shape[0]
        where = torch.where
        rows = torch.arange(n, device=dev)
        lanes = torch.arange(lw, device=dev)
        empty = _empty_slot(dev)
        op, key, key_hi, aux = rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]
        val = rec[:, 4:4 + V]
        ku = sl.u32(key)
        # tree selection: in-partition keys live in the PRIMARY tree, foreign
        # keys (replica traffic) in the full-range BACKUP tree
        foreign = (ku < sl.u32(arena[:, pb])) | (ku > sl.u32(arena[:, pb + 1]))
        pick = lambda p, b: where(foreign, base_of[b], base_of[p])
        leaves_base = pick("leaves", "bleaves")
        sep_base = pick("sep", "bsep")
        nleaf_off = pick("nleaf", "bnleaf")
        nleaf = arena[rows, nleaf_off]
        sep = where(foreign[:, None],
                    arena[:, base_of["bsep"]:base_of["bsep"] + L],
                    arena[:, base_of["sep"]:base_of["sep"] + L])
        routed, _ = _route_leaf(cfg, sep, nleaf, key)

        is_lookup = op == W.OP_BT_LOOKUP
        is_ins = op == W.OP_BT_INSERT
        is_del = op == W.OP_BT_DELETE
        is_lock = op == W.OP_BT_LOCK
        is_commit = op == W.OP_BT_COMMIT
        is_abort = op == W.OP_BT_ABORT
        is_bkw = op == W.OP_BT_BACKUP
        known = (is_lookup | is_ins | is_del | is_lock | is_commit | is_abort
                 | is_bkw)

        # ---- placement epoch check (INSERT / DELETE / LOCK only) ---------
        owner = arena[rows, rb + pl.COPIES_WORD
                      + home_of(cfg, key).to(torch.int64) * pl.MAX_COPIES]
        wrong = (is_ins | is_del | is_lock) & (owner
                                               != arena[:, rb + pl.SELF_WORD])

        # COMMIT/ABORT address their leaf directly (header slot from LOCK)
        direct = is_commit | is_abort
        leaf = where(direct, sl.u32(aux) // lslots, routed)
        Lf = _read_leaf(cfg, arena, None, leaves_base, leaf)
        hdr, recs = Lf[:, 0], Lf[:, 1:]
        ver, lock = hdr[:, sl.VERSION], hdr[:, sl.LOCK]
        count_u = sl.u32(hdr[:, sl.VALUE0])
        live = lanes[None] < count_u[:, None]
        m = live & (recs[:, :, sl.KEY_LO] == key[:, None])
        present = m.any(dim=1)
        cur_val = recs[rows, torch.argmax(m.to(torch.int32), dim=1),
                       sl.VALUE0:]
        locked = lock != 0
        full = count_u >= lw
        can_alloc = sl.u32(nleaf) < L
        own = locked & (lock == key_hi)

        # ---- decide the mutation shape ----------------------------------
        mut_ok = ~locked
        upd = present & (((is_ins | is_bkw) & mut_ok) | (is_commit & own))
        dele = is_del & present & mut_ok
        space_ok = ~full | can_alloc
        want_ins = ~present & (((is_ins | is_bkw) & mut_ok & space_ok)
                               | (is_commit & own & space_ok))
        presplit = is_lock & mut_ok & ~present & full & can_alloc
        do_split = (want_ins & full) | presplit
        lock_ok = is_lock & mut_ok & (present | space_ok)

        # ---- sorted rebuild: records cleaned, update/delete applied, the
        # (possibly empty) new record appended, stably sorted on the
        # unsigned key (empties last) -------------------------------------
        new_rec = sl.pack_slot(key, 0, 0, 0, sl.NULL_PTR, val)
        base = where(live[..., None], recs, empty)
        base = where((m & upd[:, None])[..., None], new_rec[:, None], base)
        base = where((m & dele[:, None])[..., None], empty, base)
        ext = torch.cat([base, where(want_ins[:, None], new_rec,
                                     empty)[:, None]], dim=1)
        order = torch.argsort(sl.u32(ext[:, :, sl.KEY_LO]), dim=1, stable=True)
        sorted_ext = torch.gather(ext, 1, order[..., None].expand(ext.shape))
        total = (count_u + want_ins.to(torch.int64)
                 - dele.to(torch.int64)) & sl.MASK32

        split_key = sorted_ext[:, left_n, sl.KEY_LO]
        right_n = (total - left_n) & sl.MASK32
        key_right = do_split & (ku >= sl.u32(split_key))

        # ---- left (routed) leaf image ------------------------------------
        keep = lanes[None] < where(do_split, left_n, total)[:, None]
        left_recs = where(keep[..., None], sorted_ext[:, :lw], empty)
        bump = upd | dele | want_ins | do_split
        ver2 = sl.i32(sl.u32(ver) + 2)
        new_ver = where(bump, ver2, ver)
        new_lock = where(lock_ok & ~key_right, aux, lock)
        new_lock = where(direct & own, 0, new_lock)
        hval = hdr[:, sl.VALUE0:].clone()
        hval[:, 0] = sl.i32(where(do_split, left_n, total))
        left_hdr = sl.pack_slot(
            hdr[:, sl.KEY_LO],
            where(do_split, sl.i32(sl.u32(split_key) - 1), hdr[:, sl.KEY_HI]),
            new_ver, new_lock, where(do_split, nleaf, hdr[:, sl.NEXT_PTR]),
            hval)
        left_img = torch.cat([left_hdr[:, None], left_recs], dim=1)
        wrote = bump | lock_ok | (direct & own)

        # ---- right (new) leaf image on split -----------------------------
        ridx = (lanes + left_n).clamp(max=lw)
        rkeep = lanes[None] < right_n[:, None]
        right_recs = where(rkeep[..., None], sorted_ext[:, ridx], empty)
        rval = torch.zeros((n, V), dtype=torch.int32, device=dev)
        rval[:, 0] = sl.i32(right_n)
        right_hdr = sl.pack_slot(
            split_key, hdr[:, sl.KEY_HI], ver2,
            where(lock_ok & key_right, aux, 0), hdr[:, sl.NEXT_PTR], rval)
        right_img = torch.cat([right_hdr[:, None], right_recs], dim=1)

        # ---- statuses ----------------------------------------------------
        st = lambda c: _const(dev, c)
        ins_st = where(locked, st(W.ST_LOCK_FAIL),
                       where(present | space_ok, st(W.ST_OK),
                             st(W.ST_NO_SPACE)))
        status = st(W.ST_BAD_OP).expand(n)
        status = where(is_lookup, where(present, st(W.ST_OK),
                                        st(W.ST_NOT_FOUND)), status)
        status = where(is_ins | is_bkw | is_lock, ins_st, status)
        status = where(is_del, where(present, where(
            locked, st(W.ST_LOCK_FAIL), st(W.ST_OK)), st(W.ST_NOT_FOUND)),
            status)
        status = where(direct, where(own, st(W.ST_OK), st(W.ST_LOCK_FAIL)),
                       status)
        status = where(wrong, st(W.ST_WRONG_EPOCH), status)

        out_aux = header_slot(cfg, where(key_right, sl.u32(nleaf), leaf))
        # the version of the key's leaf as the caller will see it: the lock
        # reply reports the (even) post-presplit version its commit builds on
        out_ver = where(bump | presplit, ver2, ver)
        out_val = where((present & (is_lookup | is_lock))[:, None], cur_val, 0)

        # ---- apply (through the selected tree's bases) -------------------
        go = valid & known & ~wrong
        _write_leaf(cfg, arena, leaves_base, leaf, left_img, wrote & go)
        safe_right = sl.u32(nleaf).clamp(max=L - 1)
        split_go = do_split & go
        _write_leaf(cfg, arena, leaves_base, safe_right, right_img, split_go)
        sep_idx = sep_base + safe_right
        arena[rows, sep_idx] = where(split_go, split_key, arena[rows, sep_idx])
        # (also restores the word should a clamped leaf write have hit it)
        arena[rows, nleaf_off] = where(split_go, sl.i32(sl.u32(nleaf) + 1),
                                       nleaf)

        # ---- OP_PL_INSTALL: update the routing region --------------------
        # record: [op, part, epoch, 0, copies row ++ alive bits ++ 0...]
        if ops is None or W.OP_PL_INSTALL in ops:
            is_pli = op == W.OP_PL_INSTALL
            pli_go = is_pli & valid
            row_off = (rb + pl.COPIES_WORD
                       + ku.clamp(max=cfg.n_nodes - 1) * pl.MAX_COPIES)
            ridx_ = row_off[:, None] + torch.arange(pl.MAX_COPIES, device=dev)
            arena.scatter_(1, ridx_, where(pli_go[:, None],
                                           val[:, :pl.MAX_COPIES],
                                           torch.gather(arena, 1, ridx_)))
            arena[:, alive_off:alive_off + aw] = where(
                pli_go[:, None], val[:, pl.MAX_COPIES:pl.MAX_COPIES + aw],
                arena[:, alive_off:alive_off + aw])
            arena[:, rb + pl.EPOCH_WORD] = where(
                pli_go, key_hi, arena[:, rb + pl.EPOCH_WORD])
            status = where(is_pli, st(W.ST_OK), status)

        status = where(valid, status, st(W.ST_BAD_OP))
        reply = torch.cat([torch.stack([status, out_aux, out_ver], dim=1),
                           out_val], dim=1)
        return state, reply

    return R.Handler(fn=fn, reply_words=cfg.reply_words, serial=True)


def _both_trees(cfg, layout, arena):
    """Every node's primary and backup directories as (2N, L) fences and
    (2N,) counts: directory n is node n's primary tree, N + n its backup."""
    s, b = layout["sep"].base, layout["bsep"].base
    L = cfg.n_leaves
    return (torch.cat([arena[:, s:s + L], arena[:, b:b + L]]),
            torch.cat([arena[:, layout["nleaf"].base],
                       arena[:, layout["bnleaf"].base]]))


def make_lookup_handler_vector(cfg: BTreeConfig,
                               layout: rg.RegionTable) -> R.Handler:
    """Read-only vectorized OP_BT_LOOKUP handler: the owner-side separator
    walk + leaf search (the point-probe RPC fallback), over live inbox
    cells: fn(state, recs (M, W), node (M,)) -> replies (M, reply_words)."""
    return _cached("lookup", cfg, lambda: _make_lookup_vector(cfg, layout))


def _make_lookup_vector(cfg: BTreeConfig, layout: rg.RegionTable) -> R.Handler:
    pb = layout["pbounds"].base
    lb, bb = layout["leaves"].base, layout["bleaves"].base

    def fn(state, recs, node):
        arena = state["arena"]
        N = arena.shape[0]
        node = node.to(torch.int64)
        key = recs[:, 1]
        ku = sl.u32(key)
        # the serial handler's tree selection: foreign keys are replica
        # copies served from the backup tree (what a failed-over read hits)
        foreign = ((ku < sl.u32(arena[node, pb]))
                   | (ku > sl.u32(arena[node, pb + 1])))
        fences, counts = _both_trees(cfg, layout, arena)
        leaf, _ = _route_sorted(fences, counts, node + foreign * N, key)
        Lf = _read_leaf(cfg, arena, node, torch.where(foreign, bb, lb), leaf)
        hdr, rr = Lf[:, 0], Lf[:, 1:]
        live = (torch.arange(cfg.leaf_width, device=arena.device)[None]
                < sl.u32(hdr[:, sl.VALUE0])[:, None])
        m = live & (rr[:, :, sl.KEY_LO] == key[:, None])
        present = m.any(dim=1) & (recs[:, 2] == 0)
        value = rr[torch.arange(rr.shape[0], device=arena.device),
                   torch.argmax(m.to(torch.int32), dim=1), sl.VALUE0:]
        value = torch.where(present[:, None], value, 0)
        status = torch.where(
            recs[:, 0] == W.OP_BT_LOOKUP,
            torch.where(present, W.ST_OK, W.ST_NOT_FOUND),
            W.ST_BAD_OP).to(torch.int32)
        head = torch.stack([status, header_slot(cfg, leaf),
                            hdr[:, sl.VERSION]], dim=1)
        return torch.cat([head, value], dim=1)

    return R.Handler(fn=fn, reply_words=cfg.reply_words, serial=False)


def make_scan_handler_vector(cfg: BTreeConfig,
                             layout: rg.RegionTable) -> R.Handler:
    """Read-only OP_BT_SCAN handler: the FULL image of the primary-tree leaf
    covering the record's key (the range-scan fallback: the owner re-walks
    its authoritative separators).  Reply [status, header slot] ++ image."""
    return _cached("scan", cfg, lambda: _make_scan_vector(cfg, layout))


def _make_scan_vector(cfg: BTreeConfig, layout: rg.RegionTable) -> R.Handler:
    # scans are a PRIMARY-tree protocol: the fallback walks the primary tree
    s = layout["sep"].base
    nl = layout["nleaf"].base
    lb = layout["leaves"].base

    def fn(state, recs, node):
        arena = state["arena"]
        node = node.to(torch.int64)
        leaf, _ = _route_sorted(arena[:, s:s + cfg.n_leaves], arena[:, nl],
                                node, recs[:, 1])
        img = _read_leaf(cfg, arena, node, lb, leaf).reshape(
            recs.shape[0], -1)
        status = torch.where(recs[:, 0] == W.OP_BT_SCAN, W.ST_OK,
                             W.ST_BAD_OP).to(torch.int32)
        return torch.cat([torch.stack([status, header_slot(cfg, leaf)],
                                      dim=1), img], dim=1)

    return R.Handler(fn=fn, reply_words=cfg.scan_reply_words, serial=False)
