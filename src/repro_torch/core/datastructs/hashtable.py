"""Distributed MICA-style hash table (Storm §5.5) speaking the Storm
data-structure interface (Table 3): ``lookup_start`` / ``lookup_end`` /
``rpc_handler``.  PyTorch port of ``repro/core/datastructs/hashtable.py``.

Layout per node (one contiguous arena — §5.1):

  [ slots region : (n_buckets * bucket_width + n_overflow) slots of 128 B ]
  [ alloc        : 1 word — bump allocator for overflow slots              ]
  [ routing      : the coordinator-published placement table               ]
  [ scratch      : 1 word — write sink for masked lanes                    ]

A bucket is `bucket_width` consecutive slots.  Colliding items go to overflow
slots linked from the LAST bucket slot's next_ptr — the pointer chase that
motivates the one-two-sided hybrid.

Port notes.  Words are int32 bit images (``slots``).  The reference handler
runs on ONE record of ONE node (a ``lax.scan`` step under ``vmap``); here the
serial handler takes one record for EVERY node at once — ``rec (N, W)``,
``valid (N,)`` — and updates ``state["arena"]`` in place.  The owner-side
walk :func:`find` runs over any batch of (node row, key) lanes and stops as
soon as every lane's walk has ended (a walk that ended changes nothing in
the reference's remaining fixed-count iterations).
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core import placement as pl
from repro_torch.core import regions as rg
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.device import resolve_device
from repro_torch.kernels import hash_probe as hp


@dataclasses.dataclass(frozen=True)
class HashTableConfig:
    n_nodes: int
    n_buckets: int                 # per node, power of two
    bucket_width: int = 1
    n_overflow: int = 256          # per node
    max_chain: int = 8             # bounded chain walk in the handler
    cache_slots: int = 0           # client-side address cache (0 = off)

    def __post_init__(self):
        # a bucket is one hash_probe line: the kernel takes 1..MAX_WIDTH slots
        if not 1 <= self.bucket_width <= hp.MAX_WIDTH:
            raise ValueError(f"bucket_width must be in 1..{hp.MAX_WIDTH}, "
                             f"got {self.bucket_width}")

    @property
    def n_bucket_slots(self) -> int:
        return self.n_buckets * self.bucket_width

    @property
    def n_slots(self) -> int:
        return self.n_bucket_slots + self.n_overflow

    @property
    def max_probe(self) -> int:
        return self.bucket_width + self.max_chain

    # record: [op, key_lo, key_hi, aux, value...]
    @property
    def record_words(self) -> int:
        return 4 + sl.VALUE_WORDS

    # reply: [status, aux (slot idx), version, value...]
    @property
    def reply_words(self) -> int:
        return 3 + sl.VALUE_WORDS


def build_layout(cfg: HashTableConfig) -> rg.RegionTable:
    tbl = rg.RegionTable()
    tbl.register("slots", cfg.n_slots * sl.SLOT_WORDS)
    tbl.register("alloc", 1)
    tbl.register("routing", pl.routing_words(cfg.n_nodes))
    tbl.register("scratch", 1)     # must stay LAST (write sink)
    return tbl


def init_cluster_state(cfg: HashTableConfig, device="cuda"):
    """Cluster state {"arena": (N, words) int32}: every slot formatted empty,
    the epoch-0 identity placement table published, each node's SELF_WORD
    set to its id."""
    dev = resolve_device(device)
    layout = build_layout(cfg)
    arena = torch.zeros((cfg.n_nodes, layout.total_words), dtype=torch.int32,
                        device=dev)
    s0 = layout["slots"].base
    slots_v = arena[:, s0:s0 + cfg.n_slots * sl.SLOT_WORDS].view(
        cfg.n_nodes, cfg.n_slots, sl.SLOT_WORDS)
    slots_v[..., sl.KEY_LO] = sl.EMPTY_KEY
    slots_v[..., sl.NEXT_PTR] = sl.NULL_PTR
    rb = layout["routing"].base
    img = pl.identity_region_image(cfg.n_nodes, device=dev)
    arena[:, rb:rb + img.shape[0]] = img
    arena[:, rb + pl.SELF_WORD] = torch.arange(cfg.n_nodes, dtype=torch.int32,
                                               device=dev)
    return {"arena": arena}


# ---------------------------------------------------------------------------
# Addressing helpers
# ---------------------------------------------------------------------------
def home_of(cfg: HashTableConfig, key_lo, key_hi):
    """(node int32, bucket int64) for a key."""
    h1, h2 = sl.hash_key(key_lo, key_hi)
    return (h1 % cfg.n_nodes).to(torch.int32), h2 % cfg.n_buckets


def part_of(cfg: HashTableConfig, key_lo, key_hi):
    """The key's PARTITION (coincides with its home node under the identity
    placement table)."""
    node, _ = home_of(cfg, key_lo, key_hi)
    return node


def bucket_offset(cfg: HashTableConfig, layout: rg.RegionTable, bucket):
    return sl.i32(layout["slots"].base
                  + sl.u32(bucket) * (cfg.bucket_width * sl.SLOT_WORDS))


def slot_idx_offset(layout: rg.RegionTable, slot_idx):
    return rg.slot_offset(layout["slots"], slot_idx)


def _cache_index(cfg, key_lo, key_hi):
    return sl.u32(sl._mix32(key_lo) ^ key_hi) % cfg.cache_slots


# ---------------------------------------------------------------------------
# Client side: lookup_start / lookup_end (Storm Table 3)
# ---------------------------------------------------------------------------
def lookup_start(cfg: HashTableConfig, layout: rg.RegionTable, key_lo, key_hi,
                 cache=None, ptable=None):
    """Client-side metadata lookup: where *might* the item live?

    Returns (node int32, offset int32 word, cache_hit bool).  With an
    address cache a hit yields the EXACT slot; otherwise the home bucket.
    ``cache`` holds one cache per client node ((N, cache_slots) tensors)
    and keys are (N, B).  ptable: optional placement.PlacementTable — reads
    route to the partition's first LIVE copy."""
    node, bucket = home_of(cfg, key_lo, key_hi)
    if ptable is not None:
        node, _ = pl.live_dest(ptable, node)
    off = bucket_offset(cfg, layout, bucket)
    hit = torch.zeros(key_lo.shape, dtype=torch.bool, device=key_lo.device)
    if cache is not None and cfg.cache_slots > 0:
        cidx = _cache_index(cfg, key_lo, key_hi)
        at = lambda name: torch.gather(cache[name], -1, cidx)
        hit = (at("key_lo") == key_lo) & (at("key_hi") == key_hi)
        node = torch.where(hit, at("node"), node)
        off = torch.where(hit, slot_idx_offset(layout, at("slot")), off)
    return node, off, hit


def uses_probe_cache(cfg: HashTableConfig) -> bool:
    """Whether ``hybrid.onesided_probe`` consults a per-client cache."""
    return cfg.cache_slots > 0


def probe_words(cfg: HashTableConfig) -> int:
    """Words fetched by one one-sided probe (generic interface)."""
    return cfg.bucket_width * sl.SLOT_WORDS


def lookup_records(cfg: HashTableConfig, key_lo, key_hi):
    """Request records for the point-lookup RPC fallback."""
    return make_record(W.OP_LOOKUP, key_lo, key_hi)


def _probe_result(cfg, layout, found, value, version, local_idx, key_lo,
                  key_hi, off, hit):
    # global slot idx of the hit.  A cache hit reads the exact cached slot
    # and only window position 0 may match, so the matched slot IS the
    # cached one — never cached_idx + local_idx.
    _, bucket = home_of(cfg, key_lo, key_hi)
    base_idx = bucket * cfg.bucket_width + local_idx.to(torch.int64)
    cached_idx = ((sl.u32(off) - layout["slots"].base) & sl.MASK32) \
        // sl.SLOT_WORDS
    slot_idx = sl.i32(torch.where(hit, cached_idx, base_idx))
    return dict(found=found, value=value, version=version,
                slot_idx=slot_idx, resolved=found)


def probe_end(cfg: HashTableConfig, layout: rg.RegionTable, buf, key_lo,
              key_hi, off, hit, delivered=None):
    """Decode a one-sided probe's returned words ``buf`` (..., width * 32),
    as ``onesided.remote_read`` hands them to the client, into (found,
    value, version, slot_idx, resolved) with ONE ``hash_probe`` launch: the
    lines are the arenas (lane i's is row i, read at word 0) and
    ``delivered`` (all lanes where None) the live mask.  ``resolved ==
    found`` for the hash table (a miss may sit on an unread overflow
    chain)."""
    shp = key_lo.shape
    M = key_lo.numel()
    flat = lambda x: x.reshape(-1)
    lane = torch.arange(M, dtype=torch.int32, device=buf.device)
    live = (torch.ones((M,), dtype=torch.bool, device=buf.device)
            if delivered is None else flat(delivered))
    if hit is None:
        hit = torch.zeros(shp, dtype=torch.bool, device=buf.device)
    found, version, value, local_idx = hp.probe_lines(
        buf.reshape(M, -1).to(torch.int32), lane, torch.zeros_like(lane),
        flat(key_lo), flat(key_hi), live, flat(hit), width=cfg.bucket_width)
    return _probe_result(
        cfg, layout, found.reshape(shp), value.reshape(shp + (sl.VALUE_WORDS,)),
        version.reshape(shp), local_idx.reshape(shp), key_lo, key_hi, off, hit)


def probe_read(cfg: HashTableConfig, layout: rg.RegionTable, arenas, dest,
               off, key_lo, key_hi, hit, delivered):
    """The one-sided probe's owner-side read fused with :func:`probe_end`:
    ONE ``hash_probe`` launch over all lanes, reading ``arenas[dest]`` at
    ``off`` for the ``delivered`` lanes (the others read zeros, as an
    undelivered read does).  Equal to ``probe_end`` over
    ``onesided.remote_read``'s words wherever the process holds every
    owner's arena (SimTransport), since the read round runs no handler; on
    a MeshTransport the owner's arena is another rank's, and
    ``onesided.probe_round`` takes ``remote_read`` and ``probe_end``
    instead."""
    shp = key_lo.shape
    flat = lambda x: x.reshape(-1)
    found, version, value, local_idx = hp.probe_lines(
        arenas, flat(dest.to(torch.int32)), flat(off), flat(key_lo),
        flat(key_hi), flat(delivered), flat(hit), width=cfg.bucket_width)
    return _probe_result(
        cfg, layout, found.reshape(shp), value.reshape(shp + (sl.VALUE_WORDS,)),
        version.reshape(shp), local_idx.reshape(shp), key_lo, key_hi, off, hit)


def lookup_end(cfg: HashTableConfig, buf, key_lo, key_hi, cache_hit=None):
    """Validate a one-sided read result (Storm Algorithm 1 line 7).

    buf: (..., read_slots * SLOT_WORDS).  Returns (success, value,
    local_idx).  The value is that of slot argmax(match) — slot 0 on a miss.
    cache_hit: optional (...,) bool; for hit lanes only window position 0
    (the cached slot itself) may match."""
    width = buf.shape[-1] // sl.SLOT_WORDS
    success, local_idx, slot = sl.window_match(
        buf.reshape(buf.shape[:-1] + (width, sl.SLOT_WORDS)), key_lo, key_hi,
        cache_hit)
    return success, sl.slot_value(slot), local_idx


def cache_update(cfg: HashTableConfig, cache, key_lo, key_hi, node, slot_idx,
                 valid):
    """lookup_end's caching duty: remember exact addresses learned from RPC
    replies (or validated reads).  cache: (N, cache_slots) tensors; lanes
    (N, B).  Lanes that collide on a cache entry resolve as the reference's
    in-order scatter does: the LAST lane wins, and an invalid last lane
    writes the entry's current contents back."""
    if cache is None or cfg.cache_slots == 0:
        return cache
    cidx = _cache_index(cfg, key_lo, key_hi)
    N, B = cidx.shape
    lane = torch.arange(B, device=cidx.device).expand(N, B)
    last = torch.full((N, cfg.cache_slots), -1, dtype=torch.int64,
                      device=cidx.device)
    last.scatter_reduce_(1, cidx, lane, reduce="amax")
    wins = torch.gather(last, 1, cidx) == lane
    rows = torch.arange(N, device=cidx.device)[:, None].expand(N, B)

    def upd(arr, val):
        out = arr.clone()
        new = torch.where(valid, val.to(arr.dtype), torch.gather(arr, 1, cidx))
        out[rows[wins], cidx[wins]] = new[wins]
        return out

    return {"key_lo": upd(cache["key_lo"], key_lo),
            "key_hi": upd(cache["key_hi"], key_hi),
            "node": upd(cache["node"], node),
            "slot": upd(cache["slot"], slot_idx)}


def init_cache(cfg: HashTableConfig, n_clients: int, device="cuda"):
    """One empty address cache per client node ((n_clients, cache_slots))."""
    if cfg.cache_slots == 0:
        return None
    dev = resolve_device(device)
    z = lambda: torch.zeros((n_clients, cfg.cache_slots), dtype=torch.int32,
                            device=dev)
    return {"key_lo": torch.full((n_clients, cfg.cache_slots), sl.EMPTY_KEY,
                                 dtype=torch.int32, device=dev),
            "key_hi": z(), "node": z(), "slot": z()}


# ---------------------------------------------------------------------------
# Owner side: the walk + rpc_handler.  Every function takes the (N, words)
# arenas and, per lane, the node row it addresses: ``rows=None`` means lane
# n addresses node n (the serial handler: one record per node per step).
# ---------------------------------------------------------------------------
def _slot_start(layout, arena, slot_idx):
    """First word of slot ``slot_idx`` (int32 word tensor) as an int64
    index, with ``lax.dynamic_slice``'s start rule: the 32-bit offset is read
    as int32 and clamped into [0, words - SLOT_WORDS]."""
    off = (layout["slots"].base
           + (slot_idx.to(torch.int64) & sl.MASK32) * sl.SLOT_WORDS) & sl.MASK32
    return torch.where(off < (1 << 31),
                       off.clamp(max=arena.shape[-1] - sl.SLOT_WORDS), 0)


def _take(arena, rows, idx):
    """arena[row, idx] per lane: idx (L, k) int64 -> (L, k) words."""
    if rows is None:
        return torch.gather(arena, 1, idx)
    return arena[rows[:, None], idx]


def _read_slot(layout, arena, rows, slot_idx, n_words=sl.SLOT_WORDS):
    start = _slot_start(layout, arena, slot_idx)
    return _take(arena, rows, start[:, None]
                 + torch.arange(n_words, device=arena.device))


def _write_slot(layout, arena, slot_idx, slot, enabled):
    """In place: slot ``slot_idx`` of node n's arena := slot[n] where
    enabled[n] (one lane per node)."""
    idx = (_slot_start(layout, arena, slot_idx)[:, None]
           + torch.arange(sl.SLOT_WORDS, device=arena.device))
    cur = torch.gather(arena, 1, idx)
    arena.scatter_(1, idx, torch.where(enabled[:, None], slot, cur))


def _first_slot(cfg, key_lo, key_hi):
    """Index (int32 word) of the key's first bucket slot."""
    _, bucket = home_of(cfg, key_lo, key_hi)
    return sl.i32(bucket * cfg.bucket_width)


def find(cfg: HashTableConfig, layout: rg.RegionTable, arena, rows, key_lo,
         key_hi, first=None, track_free: bool = True, live=None):
    """Bounded bucket + chain walk for lanes (keys (L,); rows (L,) node rows
    or None for lane n -> node n).  Returns found, slot_idx, slot, tail_idx
    (last probed chain slot) and, with ``track_free``, free_idx / has_free
    (first empty slot on the probe path, bucket OR chain) and free_next /
    free_ver (that slot's next_ptr and version, which a reuse must
    preserve).  Slot indices are int32 words.  ``first``: the keys' first
    bucket slots when already known.  ``live``: optional (L,) bool — lanes
    whose result the caller uses; the others do not walk, so a lane the
    caller ignores (a serial step's node without a record, whose arena may
    hold anything) cannot keep the walk going."""
    L = key_lo.shape[0]
    dev = arena.device
    if first is None:
        first = _first_slot(cfg, key_lo, key_hi)
    false = torch.zeros((L,), dtype=torch.bool, device=dev)
    zero = torch.zeros((L,), dtype=torch.int32, device=dev)
    cur, found, fidx, tail = first, false, zero, first
    free_idx, free_next, free_ver = zero, torch.full_like(zero, sl.NULL_PTR), zero
    has_free, alive = false, (~false if live is None else live)
    for step in range(cfg.max_probe):
        head = _read_slot(layout, arena, rows, cur, sl.VALUE0)
        is_match = ((head[:, sl.KEY_LO] == key_lo)
                    & (head[:, sl.KEY_HI] == key_hi) & alive)
        fidx = torch.where(is_match & ~found, cur, fidx)
        found = found | is_match
        if track_free:
            is_empty = (head[:, sl.KEY_LO] == sl.EMPTY_KEY) & alive
            take_free = is_empty & ~has_free
            free_idx = torch.where(take_free, cur, free_idx)
            free_next = torch.where(take_free, head[:, sl.NEXT_PTR], free_next)
            free_ver = torch.where(take_free, head[:, sl.VERSION], free_ver)
            has_free = has_free | is_empty
        tail = torch.where(alive, cur, tail)
        nxt = cur + 1 if step < cfg.bucket_width - 1 else head[:, sl.NEXT_PTR]
        alive = alive & (nxt != sl.NULL_PTR)
        cur = torch.where(alive, nxt, cur)
        if step + 1 < cfg.max_probe and not bool(alive.any()):
            break      # every walk ended: later iterations change nothing
    slot = torch.where(found[:, None], _read_slot(layout, arena, rows, fidx), 0)
    return dict(found=found, slot_idx=fidx, slot=slot, tail_idx=tail,
                free_idx=free_idx, free_next=free_next, free_ver=free_ver,
                has_free=has_free)


def make_rpc_handler(cfg: HashTableConfig, layout: rg.RegionTable) -> R.Handler:
    """The serial (mutating-capable) rpc_handler.  Record layout:
    [op, key_lo, key_hi, aux, value...]; reply [status, aux, version,
    value...].  COMMIT_UNLOCK/ABORT_UNLOCK records carry the caller's lock
    tag in the key_lo word (the slot is addressed directly by aux).

    Lock-class ops (LOCK / INSERT / UPDATE / DELETE) are owner-checked
    against this node's published placement table (ST_WRONG_EPOCH, nothing
    written).  OP_PL_INSTALL updates this node's routing region.

    fn(state, rec (N, W), valid (N,), pre=None, ops=None) applies node n's
    record rec[n] to node n's arena, in place, for every node at once.
    ``pre`` holds the records' key hashes from ``prepare`` (computed for a
    whole fold at once); ``ops`` is a set holding at least the opcodes of
    the valid records — the blocks of absent opcodes are skipped, which
    changes nothing, because every block only acts on records of its own
    opcode."""
    alloc_off = layout["alloc"].base
    ovf_base = cfg.n_bucket_slots
    rb = layout["routing"].base
    alive_off = rb + pl.COPIES_WORD + cfg.n_nodes * pl.MAX_COPIES
    aw = pl.alive_words(cfg.n_nodes)
    V = sl.VALUE_WORDS

    @functools.lru_cache(maxsize=None)
    def const(dev, x):
        # 0-dim word constants, made once per device (no copy per record)
        return torch.tensor(x, dtype=torch.int32, device=dev)

    def prepare(records):
        """Per-record key hashes: first bucket slot and partition."""
        h1, h2 = sl.hash_key(records[..., 1], records[..., 2])
        return {"first": sl.i32((h2 % cfg.n_buckets) * cfg.bucket_width),
                "part": h1 % cfg.n_nodes}

    def fn(state, rec, valid, pre=None, ops=None):
        arena = state["arena"]
        dev = arena.device
        n = rec.shape[0]
        where = torch.where
        c = lambda x: const(dev, x)
        has = lambda *o: ops is None or any(x in ops for x in o)
        if pre is None:
            pre = prepare(rec)
        op = rec[:, 0]
        key_lo, key_hi, aux = rec[:, 1], rec[:, 2], rec[:, 3]
        val = rec[:, 4:4 + V]
        zero = c(0).expand(n)
        false = torch.zeros((n,), dtype=torch.bool, device=dev)

        status = c(W.ST_BAD_OP).expand(n)
        out_aux, out_ver, out_val = zero, zero, c(0).expand(n, V)
        write_idx, write_slot = zero, c(0).expand(n, sl.SLOT_WORDS)
        do_write, link_tail, bump_alloc = false, false, false

        inserts = has(W.OP_INSERT, W.OP_LOCK, W.OP_BACKUP_WRITE)
        if has(W.OP_LOOKUP, W.OP_INSERT, W.OP_UPDATE, W.OP_DELETE, W.OP_LOCK,
               W.OP_BACKUP_WRITE):
            f = find(cfg, layout, arena, None, key_lo, key_hi,
                     first=pre["first"], track_free=inserts, live=valid)
            slot = f["slot"]
            ver = slot[:, sl.VERSION]
            locked_other = slot[:, sl.LOCK] != 0
        alloc = arena[:, alloc_off].clone()
        if inserts:
            # fresh insert: reuse the first empty slot on the probe path
            # (keeping its next_ptr and version), else overflow alloc + link
            reuse = f["has_free"]
            ins_idx = where(reuse, f["free_idx"], alloc + ovf_base)
            ins_possible = reuse | (sl.u32(alloc) < cfg.n_overflow)
            ins_next = where(reuse, f["free_next"], c(sl.NULL_PTR))
            ins_ver = where(reuse, f["free_ver"], c(0))

        # ---- LOOKUP ------------------------------------------------------
        if has(W.OP_LOOKUP):
            is_lookup = op == W.OP_LOOKUP
            lk_ok = f["found"] & ((ver & 1) == 0)
            status = where(is_lookup, where(lk_ok, c(W.ST_OK),
                                            c(W.ST_NOT_FOUND)), status)
            out_aux = where(is_lookup, f["slot_idx"], out_aux)
            out_ver = where(is_lookup, ver, out_ver)
            out_val = where((is_lookup & lk_ok)[:, None], slot[:, sl.VALUE0:],
                            out_val)

        # ---- INSERT / UPDATE (unconditional write API, outside tx) --------
        if has(W.OP_INSERT, W.OP_UPDATE):
            is_ins = op == W.OP_INSERT
            is_upd = op == W.OP_UPDATE
            upd_ok = f["found"] & ~locked_other
            upd_slot = sl.pack_slot(key_lo, key_hi, ver + 2, 0,
                                    slot[:, sl.NEXT_PTR], val)
            wr_upd = (is_ins | is_upd) & f["found"] & upd_ok
            found_st = where(upd_ok, c(W.ST_OK), c(W.ST_LOCK_FAIL))
            status = where(is_upd, where(f["found"], found_st,
                                         c(W.ST_NOT_FOUND)), status)
            do_write = do_write | wr_upd
            write_idx = where(wr_upd, f["slot_idx"], write_idx)
            write_slot = where(wr_upd[:, None], upd_slot, write_slot)
            out_aux = where(wr_upd, write_idx, out_aux)
            if has(W.OP_INSERT):
                ins_slot = sl.pack_slot(key_lo, key_hi, ins_ver, 0, ins_next,
                                        val)
                status = where(is_ins, where(
                    f["found"], found_st,
                    where(ins_possible, c(W.ST_OK), c(W.ST_NO_SPACE))), status)
                wr_ins = is_ins & ~f["found"] & ins_possible
                do_write = do_write | wr_ins
                write_idx = where(wr_ins, ins_idx, write_idx)
                write_slot = where(wr_ins[:, None], ins_slot, write_slot)
                link_tail = link_tail | (wr_ins & ~f["has_free"])
                bump_alloc = bump_alloc | (wr_ins & ~f["has_free"])
                out_aux = where(wr_ins, write_idx, out_aux)

        # ---- DELETE --------------------------------------------------------
        if has(W.OP_DELETE):
            is_del = op == W.OP_DELETE
            del_ok = is_del & f["found"] & ~locked_other
            del_slot = slot.clone()
            del_slot[:, sl.KEY_LO] = sl.EMPTY_KEY
            del_slot[:, sl.VERSION] = ver + 2
            status = where(is_del, where(
                f["found"], where(del_ok, c(W.ST_OK), c(W.ST_LOCK_FAIL)),
                c(W.ST_NOT_FOUND)), status)
            do_write = do_write | del_ok
            write_idx = where(del_ok, f["slot_idx"], write_idx)
            write_slot = where(del_ok[:, None], del_slot, write_slot)

        # ---- LOCK (tx execution phase) ------------------------------------
        if has(W.OP_LOCK):
            is_lock = op == W.OP_LOCK
            tag = aux  # caller-unique nonzero tag
            lock_ok = is_lock & f["found"] & ~locked_other
            lk_slot = slot.clone()
            lk_slot[:, sl.LOCK] = tag
            # lock-insert for new keys: a locked, odd-version placeholder
            # that keeps a reused slot's next_ptr and builds on its version
            ph_slot = sl.pack_slot(key_lo, key_hi, ins_ver + 1, tag, ins_next,
                                   c(0).expand(n, V))
            lock_ins = is_lock & ~f["found"] & ins_possible
            status = where(is_lock, where(
                f["found"], where(~locked_other, c(W.ST_OK),
                                  c(W.ST_LOCK_FAIL)),
                where(ins_possible, c(W.ST_OK), c(W.ST_NO_SPACE))), status)
            do_write = do_write | lock_ok | lock_ins
            write_idx = where(lock_ok, f["slot_idx"], write_idx)
            write_slot = where(lock_ok[:, None], lk_slot, write_slot)
            write_idx = where(lock_ins, ins_idx, write_idx)
            write_slot = where(lock_ins[:, None], ph_slot, write_slot)
            link_tail = link_tail | (lock_ins & ~f["has_free"])
            bump_alloc = bump_alloc | (lock_ins & ~f["has_free"])
            out_aux = where(lock_ok | lock_ins,
                            where(lock_ok, f["slot_idx"], ins_idx), out_aux)
            # version + current value at lock time (read-for-update, Fig. 3);
            # lock-inserts report the even base version of the placeholder
            out_ver = where(is_lock, where(f["found"], ver, ins_ver), out_ver)
            out_val = where(lock_ok[:, None], slot[:, sl.VALUE0:], out_val)

        # ---- COMMIT_UNLOCK / ABORT_UNLOCK (direct slot addressing) ---------
        # record: [op, lock_tag, key_hi, slot_idx, value...]
        if has(W.OP_COMMIT_UNLOCK, W.OP_ABORT_UNLOCK):
            is_commit = op == W.OP_COMMIT_UNLOCK
            is_abort = op == W.OP_ABORT_UNLOCK
            tslot = _read_slot(layout, arena, None, aux)
            tver = tslot[:, sl.VERSION]
            # ownership requires the EXACT tag that acquired the lock
            own = (tslot[:, sl.LOCK] != 0) & (tslot[:, sl.LOCK] == key_lo)
            cm_ver = (tver | 1) + 1                     # -> even, bumped
            cm_slot = tslot.clone()
            cm_slot[:, sl.VERSION] = cm_ver
            cm_slot[:, sl.LOCK] = 0
            cm_slot[:, sl.VALUE0:] = val
            ab_slot = tslot.clone()
            ab_slot[:, sl.LOCK] = 0
            # an aborted placeholder becomes an empty slot (version bumped)
            ph = (tver & 1) == 1
            ab_slot[:, sl.KEY_LO] = where(ph, c(sl.EMPTY_KEY), tslot[:, sl.KEY_LO])
            ab_slot[:, sl.VERSION] = where(ph, cm_ver, tver)
            unlock = is_commit | is_abort
            status = where(unlock, where(own, c(W.ST_OK), c(W.ST_LOCK_FAIL)),
                           status)
            do_write = do_write | (unlock & own)
            write_idx = where(unlock & own, aux, write_idx)
            write_slot = where((is_commit & own)[:, None], cm_slot, write_slot)
            write_slot = where((is_abort & own)[:, None], ab_slot, write_slot)

        # ---- READ_VERSION ---------------------------------------------------
        if has(W.OP_READ_VERSION):
            is_rdv = op == W.OP_READ_VERSION
            vslot = _read_slot(layout, arena, None, aux, sl.VALUE0)
            status = where(is_rdv, c(W.ST_OK), status)
            out_aux = where(is_rdv, aux, out_aux)
            out_ver = where(is_rdv, vslot[:, sl.VERSION], out_ver)

        # ---- BACKUP_WRITE (primary-backup replication) ---------------------
        # record: [op, key_lo, key_hi, aux = committed version, value...]
        if has(W.OP_BACKUP_WRITE):
            is_bkw = op == W.OP_BACKUP_WRITE
            bk_upd = sl.pack_slot(key_lo, key_hi, aux, 0, slot[:, sl.NEXT_PTR],
                                  val)
            bk_ins = sl.pack_slot(key_lo, key_hi, aux, 0, ins_next, val)
            status = where(is_bkw, where(f["found"] | ins_possible, c(W.ST_OK),
                                         c(W.ST_NO_SPACE)), status)
            wr_bk_upd = is_bkw & f["found"]
            wr_bk_ins = is_bkw & ~f["found"] & ins_possible
            do_write = do_write | wr_bk_upd | wr_bk_ins
            write_idx = where(wr_bk_upd, f["slot_idx"], write_idx)
            write_slot = where(wr_bk_upd[:, None], bk_upd, write_slot)
            write_idx = where(wr_bk_ins, ins_idx, write_idx)
            write_slot = where(wr_bk_ins[:, None], bk_ins, write_slot)
            link_tail = link_tail | (wr_bk_ins & ~f["has_free"])
            bump_alloc = bump_alloc | (wr_bk_ins & ~f["has_free"])
            out_aux = where(wr_bk_upd | wr_bk_ins, write_idx, out_aux)
            out_ver = where(is_bkw, aux, out_ver)

        # ---- owner check (placement epoch validation) ----------------------
        if has(W.OP_INSERT, W.OP_UPDATE, W.OP_DELETE, W.OP_LOCK):
            checked = ((op == W.OP_INSERT) | (op == W.OP_UPDATE)
                       | (op == W.OP_DELETE) | (op == W.OP_LOCK))
            owner = torch.gather(
                arena, 1, (rb + pl.COPIES_WORD + pre["part"] * pl.MAX_COPIES)
                [:, None])[:, 0]
            wrong = checked & (owner != arena[:, rb + pl.SELF_WORD])
            status = where(wrong, c(W.ST_WRONG_EPOCH), status)
            do_write = do_write & ~wrong

        # ---- apply ----------------------------------------------------------
        do_write = do_write & valid & (op != W.OP_NOP)
        _write_slot(layout, arena, write_idx, write_slot, do_write)
        if inserts:
            # link tail -> new overflow slot: only the tail's next_ptr word
            # changes (the reference rewrites the slot with that one word)
            nidx = (_slot_start(layout, arena, f["tail_idx"])
                    + sl.NEXT_PTR)[:, None]
            link = (link_tail & do_write)[:, None]
            arena.scatter_(1, nidx, where(link, write_idx[:, None],
                                          torch.gather(arena, 1, nidx)))
        # (also restores the word should a clamped slot write have hit it)
        arena[:, alloc_off] = where(bump_alloc & do_write, alloc + 1, alloc)

        # ---- PL_INSTALL (update the published routing region) ---------------
        # record: [op, part, epoch, 0, copies row (MAX_COPIES) ++ alive bits]
        if has(W.OP_PL_INSTALL):
            pli_go = (op == W.OP_PL_INSTALL) & valid
            row_off = (rb + pl.COPIES_WORD
                       + torch.clamp(sl.u32(key_lo), max=cfg.n_nodes - 1)
                       * pl.MAX_COPIES)
            ridx = row_off[:, None] + torch.arange(pl.MAX_COPIES, device=dev)
            arena.scatter_(1, ridx, where(pli_go[:, None],
                                          val[:, :pl.MAX_COPIES],
                                          torch.gather(arena, 1, ridx)))
            arena[:, alive_off:alive_off + aw] = where(
                pli_go[:, None], val[:, pl.MAX_COPIES:pl.MAX_COPIES + aw],
                arena[:, alive_off:alive_off + aw])
            arena[:, rb + pl.EPOCH_WORD] = where(
                pli_go, key_hi, arena[:, rb + pl.EPOCH_WORD])
            status = where(op == W.OP_PL_INSTALL, c(W.ST_OK), status)

        status = where((op == W.OP_NOP) | ~valid, c(W.ST_BAD_OP), status)
        reply = torch.cat([torch.stack([status, out_aux, out_ver], dim=1),
                           out_val], dim=1)
        return state, reply

    return R.Handler(fn=fn, reply_words=cfg.reply_words, serial=True,
                     prepare=prepare)


def make_lookup_handler_vector(cfg: HashTableConfig,
                               layout: rg.RegionTable) -> R.Handler:
    """Read-only vectorized LOOKUP handler: fn(state, recs (L, W), node (L,))
    -> replies (L, reply_words) for live inbox cells (roundsched.vector_apply)."""

    def fn(state, recs, node):
        f = find(cfg, layout, state["arena"], node.to(torch.int64),
                 recs[:, 1], recs[:, 2], track_free=False)
        ver = sl.slot_version(f["slot"])
        ok = f["found"] & ((ver & 1) == 0)
        status = torch.where(
            recs[:, 0] == W.OP_LOOKUP,
            torch.where(ok, W.ST_OK, W.ST_NOT_FOUND),
            W.ST_BAD_OP).to(torch.int32)
        val = torch.where(ok[:, None], sl.slot_value(f["slot"]),
                          torch.zeros_like(sl.slot_value(f["slot"])))
        return torch.cat([torch.stack([status, f["slot_idx"], ver], dim=1),
                          val], dim=1)

    return R.Handler(fn=fn, reply_words=cfg.reply_words, serial=False)


def make_record(op, key_lo, key_hi, aux=None, value=None):
    """Assemble (..., record_words) int32 request records."""
    key_lo = torch.as_tensor(key_lo, dtype=torch.int32)
    shp = key_lo.shape
    dev = key_lo.device
    aux = (torch.zeros(shp, dtype=torch.int32, device=dev) if aux is None
           else torch.as_tensor(aux, dtype=torch.int32, device=dev))
    if value is None:
        value = torch.zeros(shp + (sl.VALUE_WORDS,), dtype=torch.int32,
                            device=dev)
    op = torch.as_tensor(op, dtype=torch.int32, device=dev).expand(shp)
    head = torch.stack([op, key_lo, torch.as_tensor(key_hi, dtype=torch.int32,
                                                    device=dev).expand(shp),
                        aux.expand(shp)], dim=-1)
    return torch.cat([head, torch.as_tensor(value, dtype=torch.int32,
                                            device=dev)], dim=-1)
