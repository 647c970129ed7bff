"""Storm transactional protocol (§5.4, Fig. 3): OCC + 2PC optimized for the
dataplane's two primitives.  PyTorch port of ``repro/core/tx.py``: point
transactions over the hash table (``run_transactions``) and range-scan
transactions over the B-link tree (``run_scan_transactions``), each on the
fused schedule and the 5-round reference, with primary-backup replication
(``rep=``) and routing through an epoch-stamped placement table
(``ptable=``).

Per transaction lane:
  EXECUTE   read-set via one-two-sided hybrid lookups, write-set
            read-for-update + LOCK via write-based RPC.
  VALIDATE  re-read read-set slot versions with ONE-SIDED reads.
  COMMIT    write-based RPCs install values, bump versions to even, unlock.
  ABORT     unlock / roll back placeholder inserts.

Two schedules share every phase's records, handlers and decision logic:

  * ``run_transactions(fused=False)`` — the per-phase reference: FIVE
    exchange rounds (one-sided read, RPC fallback, lock, validate, commit).
  * ``run_transactions(fused=True)`` (default) — the fused schedule:

        round 1  one-sided read of the read set
        round 2  fallback lookups ∥ LOCK ∥ validate(one-sided hits)
        round 3  validate(addresses learned via RPC)      [empty on the
                 one-sided fast path — costs no round trip]
        round 4  commit / abort (+ backup fan-out at rep.f > 0)

Aborts are classified by cause — lock conflict, validation conflict,
overflow/back-pressure, stale route — with priority overflow > stale > lock >
validate.

With a ``rep=replication.ReplicaConfig(f > 0)``, COMMIT installs the write
set on all f+1 copies: the backup writes ride the commit fused round as
extra traffic classes (zero additional exchange rounds).  ``rep=None`` and
``rep.f == 0`` are bit-identical.

With a ``ptable=placement.PlacementTable`` every route goes through the
table: reads to the partition's first live copy, lock-class ops to its
owner only, backup writes to its copy row.  A stale table surfaces as
``aborted_stale`` (the owner answered ST_WRONG_EPOCH) for ``txloop`` to
refresh and retry.  The identity table with every node up is bit-identical
to ``ptable=None``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hybrid as hy
from repro_torch.core import onesided as osd
from repro_torch.core import placement as pl
from repro_torch.core import regions as rg
from repro_torch.core import replication as repl
from repro_torch.core import roundsched as rs
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import telemetry as T
from repro_torch.core import wireproto as W
from repro_torch.core.datastructs import btree as bt
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import Transport


@dataclasses.dataclass
class TxResult:
    committed: torch.Tensor        # (N, B) bool
    read_found: torch.Tensor       # (N, B, R) bool
    read_values: torch.Tensor      # (N, B, R, VALUE_WORDS)
    locked_values: torch.Tensor    # (N, B, W, VALUE_WORDS) read-for-update values
    aborted_lock: torch.Tensor     # (N, B) bool — lost a lock race
    aborted_validate: torch.Tensor  # (N, B) bool — read-set changed underfoot
    aborted_overflow: torch.Tensor  # (N, B) bool — back-pressure / no space
    aborted_stale: torch.Tensor    # (N, B) bool — routed by a stale placement
    metrics: hy.HybridMetrics
    round_trips: torch.Tensor      # scalar


# ---------------------------------------------------------------------------
# Shared request construction / reply parsing
# ---------------------------------------------------------------------------
def _lock_requests(t: Transport, cfg: ht.HashTableConfig, layout, *,
                   write_keys, write_enabled, ptable=None):
    """Flatten the write set and build the OP_LOCK records (+ unique tags).

    With a ``ptable``, lock-class ops route to the partition OWNER, never a
    backup: a dead owner parks the lane (dest -1 -> ST_DROPPED -> abort
    overflow) until repair promotes a backup.  The lane stays ENABLED —
    masking it would make the all-locks-held conjunction vacuously true and
    commit an unlocked write set."""
    N, B, Wr = write_keys.shape[:3]
    wk_lo = write_keys[..., 0].reshape(N, B * Wr)
    wk_hi = write_keys[..., 1].reshape(N, B * Wr)
    en = write_enabled.reshape(N, B * Wr)
    dev = wk_lo.device
    part = ht.part_of(cfg, wk_lo, wk_hi)
    if ptable is None:
        wnode, _, _ = ht.lookup_start(cfg, layout, wk_lo, wk_hi, None)
    else:
        wnode = pl.owner_dest(ptable, part)
    # unique nonzero lock tag per (node, lane)
    lane = torch.arange(B * Wr, dtype=torch.int64, device=dev) // max(Wr, 1)
    tag = sl.i32(t.node_ids(dev).to(torch.int64)[:, None] * B
                 + lane[None, :] + 1)
    recs = ht.make_record(W.OP_LOCK, wk_lo, wk_hi, aux=tag)
    return dict(key_lo=wk_lo, key_hi=wk_hi, enabled=en, node=wnode, tag=tag,
                part=part), recs


def _parse_lock_replies(lk, lrep, lovf, N, B, Wr):
    """Decode the LOCK round's replies into the lock context dict."""
    status = lrep[..., 0]
    en = lk["enabled"]
    lock_ok = (status == W.ST_OK) & ~lovf & en
    return dict(
        lk,
        lock_ok=lock_ok, lock_slot=lrep[..., 1],
        lock_ver=lrep[..., 2],
        locked_values=lrep[..., 3:].reshape(N, B, Wr, sl.VALUE_WORDS),
        lock_fail=(status == W.ST_LOCK_FAIL) & en,
        # the routing table this lane used is stale: the addressed node no
        # longer owns the key's partition (abort cause stale_route)
        stale=(status == W.ST_WRONG_EPOCH) & en,
        # overflow-class outcomes: dropped by back-pressure (retryable) or
        # table full (ST_NO_SPACE, delivered) — both abort with cause overflow
        no_space=((status == W.ST_NO_SPACE) | (status == W.ST_DROPPED)
                  | lovf) & en,
        overflow=lovf & en)


def _validate_from_bytes(read_ctx, vbuf, vovf):
    """Shared VALIDATE decision: compare re-read slot words against the
    execute-phase observation.  Absent reads validate trivially."""
    unchanged = ((vbuf[..., sl.VERSION] == read_ctx["versions"])
                 & (vbuf[..., sl.KEY_LO] == read_ctx["key_lo"])
                 & (vbuf[..., sl.LOCK] == 0) & ~vovf)
    issued = read_ctx["enabled"] & read_ctx["found"]
    return dict(valid=unchanged | ~read_ctx["found"], overflow=vovf & issued)


def _lanes(x, N, B, K):
    return x.reshape(N, B, K)


# ---------------------------------------------------------------------------
# Phase functions (the per-phase reference schedule)
# ---------------------------------------------------------------------------
def execute_read_set(t: Transport, state, cfg: ht.HashTableConfig, layout, *,
                     read_keys, read_enabled, cache=None,
                     use_onesided: bool = True, capacity: Optional[int] = None,
                     nic=None, ptable=None, telemetry=None):
    """EXECUTE phase, read half: one-two-sided lookups of the read set.
    read_keys: (N, B, Rd, 2); read_enabled: (N, B, Rd) bool."""
    N, B, Rd = read_keys.shape[:3]
    rk_lo = read_keys[..., 0].reshape(N, B * Rd)
    rk_hi = read_keys[..., 1].reshape(N, B * Rd)
    en = read_enabled.reshape(N, B * Rd)
    state, cache, found, rvals, rvers, rnode, rslot, rovf, m = hy.hybrid_lookup(
        t, state, rk_lo, rk_hi, cfg, layout, cache=cache,
        use_onesided=use_onesided, rpc_serial=False, capacity=capacity,
        enabled=en, nic=nic, ptable=ptable, telemetry=telemetry)
    return state, cache, dict(
        key_lo=rk_lo, key_hi=rk_hi, enabled=en, found=found, values=rvals,
        versions=rvers, node=rnode, slot=rslot, overflow=rovf, metrics=m)


def lock_write_set(t: Transport, state, cfg: ht.HashTableConfig, layout,
                   serial_h, *, write_keys, write_enabled,
                   capacity: Optional[int] = None, nic=None, ptable=None,
                   telemetry=None):
    """EXECUTE phase, write half: LOCK + read-for-update the write set."""
    N, B, Wr = write_keys.shape[:3]
    lk, lock_recs = _lock_requests(t, cfg, layout, write_keys=write_keys,
                                   write_enabled=write_enabled, ptable=ptable)
    state, lrep, lovf, s_lock = R.rpc_call(
        t, state, lk["node"], lock_recs, serial_h, capacity=capacity,
        enabled=lk["enabled"], nic=nic, telemetry=telemetry, phase=T.PH_LOCK)
    lctx = _parse_lock_replies(lk, lrep, lovf, N, B, Wr)
    lctx["wire"] = s_lock
    return state, lctx


def validate_read_set(t: Transport, state, layout, read_ctx, *,
                      capacity: Optional[int] = None, nic=None,
                      offset_of=None, telemetry=None):
    """VALIDATE phase: one-sided re-read of every FOUND read-set slot.
    ``offset_of(layout, slot_idx)`` maps a read-set slot index to its arena
    word offset (default the hash table's ``slots`` region; the ordered
    index validates leaf HEADER slots of its ``leaves`` region)."""
    issued = read_ctx["enabled"] & read_ctx["found"]
    if offset_of is None:
        offset_of = ht.slot_idx_offset
    vbuf, vovf, s_val = osd.remote_read(
        t, state["arena"], read_ctx["node"],
        offset_of(layout, read_ctx["slot"]), length=sl.SLOT_WORDS,
        capacity=capacity, enabled=issued, nic=nic, telemetry=telemetry,
        phase=T.PH_VALIDATE)
    vctx = _validate_from_bytes(read_ctx, vbuf, vovf)
    vctx["wire"] = s_val
    return vctx


def _backup_dest(lock_ctx, rep, i, ptable=None):
    """Destination of backup copy ``i`` of each write item.

    Without a placement table: the ring rotation off the LOCK destination.
    With one: column ``i`` of the table's row for the item's PARTITION,
    which keeps the fan-out right after a migration or repair re-homed the
    partition.  A dead or absent copy routes to -1: the record is parked,
    the lane aborts (cause overflow) and retries — never a silent
    under-replication."""
    if ptable is None:
        return rep.replica_of(lock_ctx["node"], i)
    cand = pl.copy_nodes(ptable, lock_ctx["part"])[..., i]
    ok = (cand >= 0) & ptable.alive[
        cand.clamp(0, ptable.alive.shape[0] - 1).to(torch.int64)]
    return torch.where(ok, cand, -1).to(torch.int32)


def _fan_out(t, state, serial_h, lock_ctx, cm_recs, bk_recs, *, commit_item,
             capacity, nic, rep, backup_fail, ptable=None, telemetry=None):
    """The commit round: the COMMIT/ABORT class, plus one backup class per
    copy at rep.f > 0 (committing lock holders only), in ONE fused round.
    A backup write that is dropped, or answered with a ``backup_fail``
    status, aborts its lane (cause overflow) — never a silent
    under-replication.  The commit class cannot overflow: its lanes are a
    subset of those the lock round delivered, to the same destinations in
    the same order, and the ring rotation keeps the backup classes within
    the same per-destination counts."""
    classes = [rs.rpc_class(lock_ctx["node"], cm_recs, serial_h,
                            enabled=lock_ctx["lock_ok"], capacity=capacity)]
    bk_en = None
    if rep is not None and rep.f > 0:
        recs = bk_recs()
        bk_en = commit_item & lock_ctx["lock_ok"]
        for i in range(1, rep.f + 1):
            classes.append(rs.rpc_class(
                _backup_dest(lock_ctx, rep, i, ptable), recs, serial_h,
                enabled=bk_en, capacity=capacity))
    state, results, s_cm = rs.fused_round(t, state, classes, nic=nic,
                                          telemetry=telemetry,
                                          phase=T.PH_COMMIT)
    overflow = results[0][1] & lock_ctx["lock_ok"]
    for brep, bovf in results[1:]:
        bad = bovf
        for st in backup_fail:
            bad = bad | (brep[..., 0] == st)
        overflow = overflow | (bad & bk_en)
    return state, dict(overflow=overflow, wire=s_cm)


def commit_or_abort(t: Transport, state, serial_h, lock_ctx, *, commit_lane,
                    write_values, capacity: Optional[int] = None, nic=None,
                    rep=None, ptable=None, telemetry=None):
    """COMMIT / ABORT phase: lanes that hold locks either install their
    values (version += 2, unlock) or roll back.  commit_lane: (N, B) bool.

    With rep.f > 0, each of the f OP_BACKUP_WRITE classes rides this SAME
    fused round, headed for replica_of(primary, i): zero extra exchange
    rounds.  A backup write dropped by back-pressure or answered
    ST_NO_SPACE aborts its lane (cause overflow) for the retry loop; the
    primary copy of such a lane is already installed, and the retry
    reinstalls it idempotently."""
    N, B = commit_lane.shape
    Wr = lock_ctx["key_lo"].shape[1] // max(B, 1)
    commit_item = torch.repeat_interleave(commit_lane, Wr, dim=-1)
    op = torch.where(commit_item, W.OP_COMMIT_UNLOCK, W.OP_ABORT_UNLOCK)
    # the key_lo word carries the lock tag: the owner releases a lock only
    # for the exact tag that acquired it
    cm_recs = ht.make_record(
        op, lock_ctx["tag"], lock_ctx["key_hi"], aux=lock_ctx["lock_slot"],
        value=write_values.reshape(N, B * Wr, sl.VALUE_WORDS))
    return _fan_out(
        t, state, serial_h, lock_ctx, cm_recs,
        lambda: repl.backup_write_records(lock_ctx, write_values),
        commit_item=commit_item, capacity=capacity, nic=nic, rep=rep,
        backup_fail=(W.ST_NO_SPACE,), ptable=ptable, telemetry=telemetry)


# ---------------------------------------------------------------------------
# Shared tail: commit decision, abort classification, result packing.
# ---------------------------------------------------------------------------
def _decide_and_finish(t, state, serial_h, *, N, B, Rd, Wr, write_enabled,
                       write_values, rctx, lctx, vctx, read_wire,
                       onesided_success, rpc_fallback, total, capacity,
                       nic=None, rep=None, ptable=None, telemetry=None):
    lane_locks_ok = _lanes(lctx["lock_ok"] | ~lctx["enabled"], N, B, Wr).all(-1)
    lane_valid = _lanes(vctx["valid"] | ~rctx["enabled"], N, B, Rd).all(-1)
    # a read dropped by back-pressure is NOT a miss: abort (overflow), retry
    lane_reads_ok = ~_lanes(rctx["overflow"], N, B, Rd).any(-1)

    commit_lane = lane_locks_ok & lane_valid & lane_reads_ok    # (N, B)
    state, cctx = commit_or_abort(
        t, state, serial_h, lctx, commit_lane=commit_lane,
        write_values=write_values, capacity=capacity, nic=nic, rep=rep,
        ptable=ptable, telemetry=telemetry)

    has_writes = write_enabled.any(-1)
    commit_delivered = ~_lanes(cctx["overflow"], N, B, Wr).any(-1)
    committed = torch.where(has_writes, commit_lane & commit_delivered,
                            lane_valid & lane_reads_ok)

    lane_ovf = (~lane_reads_ok
                | _lanes(lctx["no_space"], N, B, Wr).any(-1)
                | _lanes(vctx["overflow"], N, B, Rd).any(-1)
                | _lanes(cctx["overflow"], N, B, Wr).any(-1))
    lane_stale = _lanes(lctx["stale"], N, B, Wr).any(-1)
    lane_lock_fail = _lanes(lctx["lock_fail"], N, B, Wr).any(-1)
    aborted = ~committed
    aborted_overflow = aborted & lane_ovf
    aborted_stale = aborted & ~lane_ovf & lane_stale
    aborted_lock = aborted & ~lane_ovf & ~lane_stale & lane_lock_fail
    aborted_validate = (aborted & ~lane_ovf & ~lane_stale & ~lane_lock_fail
                        & ~lane_valid)

    wire = read_wire + lctx["wire"] + vctx["wire"] + cctx["wire"]
    rts = (read_wire.round_trips + lctx["wire"].round_trips
           + vctx["wire"].round_trips + cctx["wire"].round_trips)
    return state, TxResult(
        committed=committed,
        read_found=rctx["found"].reshape(N, B, Rd),
        read_values=rctx["values"].reshape(N, B, Rd, sl.VALUE_WORDS),
        locked_values=lctx["locked_values"],
        aborted_lock=aborted_lock,
        aborted_validate=aborted_validate,
        aborted_overflow=aborted_overflow,
        aborted_stale=aborted_stale,
        metrics=hy.HybridMetrics(onesided_success=onesided_success,
                                 rpc_fallback=rpc_fallback, total=total,
                                 wire=wire),
        round_trips=rts,
    )


# ---------------------------------------------------------------------------
# The fused schedule (roundsched.fused_round): 3-4 exchange rounds.
# ---------------------------------------------------------------------------
def _run_transactions_fused(t: Transport, state, cfg, layout, *, read_keys,
                            write_keys, write_values, write_enabled,
                            read_enabled, cache, use_onesided, capacity,
                            nic=None, rep=None, ptable=None, telemetry=None):
    N, B, Rd = read_keys.shape[:3]
    Wr = write_keys.shape[2]
    serial_h = ht.make_rpc_handler(cfg, layout)
    rk_lo = read_keys[..., 0].reshape(N, B * Rd)
    rk_hi = read_keys[..., 1].reshape(N, B * Rd)
    ren = read_enabled.reshape(N, B * Rd)

    # ---- round 1: one-sided read of the read set --------------------------
    probe = hy.onesided_probe(t, state, rk_lo, rk_hi, cfg, layout, cache=cache,
                              use_onesided=use_onesided, capacity=capacity,
                              enabled=ren, nic=nic, ptable=ptable,
                              telemetry=telemetry)

    # ---- round 2: read-set RPC fallback ∥ LOCK ∥ validate(one-sided hits) -
    # Under an explicit capacity bound the validate phase keeps its own
    # round, so its back-pressure policy stays that of the reference round.
    lk, lock_recs = _lock_requests(t, cfg, layout, write_keys=write_keys,
                                   write_enabled=write_enabled, ptable=ptable)
    classes = [
        rs.rpc_class(probe["node"], ht.make_record(W.OP_LOOKUP, rk_lo, rk_hi),
                     ht.make_lookup_handler_vector(cfg, layout),
                     enabled=probe["need_rpc"], capacity=capacity),
        rs.rpc_class(lk["node"], lock_recs, serial_h, enabled=lk["enabled"],
                     capacity=capacity),
    ]
    fuse_v1 = capacity is None and Rd > 0
    if fuse_v1:
        classes.append(rs.read_class(
            probe["node"], ht.slot_idx_offset(layout, probe["slot_idx"]),
            length=sl.SLOT_WORDS, enabled=ren & probe["success"]))
    state, results, s2 = rs.fused_round(t, state, classes, nic=nic,
                                        telemetry=telemetry, phase=T.PH_LOCK)
    lookup_rep, lookup_ovf = results[0]
    lrep, lovf = results[1]

    lctx = _parse_lock_replies(lk, lrep, lovf, N, B, Wr)
    mg = hy.merge_rpc_fallback(probe, lookup_rep, lookup_ovf)
    cache = hy.update_lookup_cache(cfg, cache, rk_lo, rk_hi, probe["node"],
                                   mg["slot_idx"], mg["found"])
    rctx = dict(key_lo=rk_lo, key_hi=rk_hi, enabled=ren, found=mg["found"],
                values=mg["value"], versions=mg["version"],
                node=probe["node"], slot=mg["slot_idx"],
                overflow=mg["overflow"])

    # ---- round 3: validate re-reads whose address came from the RPC -------
    if fuse_v1:
        v1buf = results[2][0]
        v2buf, _, s3 = osd.remote_read(
            t, state["arena"], probe["node"],
            ht.slot_idx_offset(layout, mg["slot_idx"]), length=sl.SLOT_WORDS,
            enabled=ren & mg["rpc_ok"], nic=nic, telemetry=telemetry,
            phase=T.PH_VALIDATE)
        vbuf = torch.where(probe["success"][..., None], v1buf, v2buf)
        # without a capacity bound neither validate sub-round can overflow
        vctx = _validate_from_bytes(rctx, vbuf, torch.zeros_like(ren))
        vctx["wire"] = s3
    else:
        vctx = validate_read_set(t, state, layout, rctx, capacity=capacity,
                                 nic=nic, telemetry=telemetry)

    # the lock round's wire is fused into s2; attribute the whole fused round
    # to the lock slot of the accounting so totals stay exact
    lctx["wire"] = s2

    state, res = _decide_and_finish(
        t, state, serial_h, N=N, B=B, Rd=Rd, Wr=Wr,
        write_enabled=write_enabled, write_values=write_values,
        rctx=rctx, lctx=lctx, vctx=vctx, read_wire=probe["wire"],
        onesided_success=hy._count(probe["success"]),
        rpc_fallback=hy._count(probe["need_rpc"]),
        total=hy._count(ren), capacity=capacity, nic=nic, rep=rep,
        ptable=ptable, telemetry=telemetry)
    return state, cache, res


def run_transactions(t: Transport, state, cfg: ht.HashTableConfig, layout, *,
                     read_keys, write_keys, write_values, write_enabled=None,
                     read_enabled=None, cache=None, use_onesided: bool = True,
                     capacity: Optional[int] = None, fused: bool = True,
                     nic=None, rep=None, ptable=None, telemetry=None):
    """Execute a batch of transactions, one per lane (single shot — aborted
    lanes report their cause and stop; see txloop.tx_loop for bounded retry).

    read_keys:    (N, B, Rd, 2) int32 words (lo, hi)
    write_keys:   (N, B, Wr, 2) int32 words
    write_values: (N, B, Wr, VALUE_WORDS) int32 words
    *_enabled:    optional masks (N, B, Rd/Wr) for ragged sets.
    fused:        True (default) runs the fused 3-4-round schedule; False the
                  per-phase 5-round reference (same committed state, abort
                  causes and delivered-request counts).
    nic:          optional core.nic.ConnTable (prices the transport only).
    rep:          optional replication.ReplicaConfig — with f > 0 COMMIT
                  installs the write set on all f+1 copies, the backup
                  writes riding the commit round (zero extra rounds).
    ptable:       optional placement.PlacementTable — ALL routing (read
                  probes, lock-class ops, the backup fan-out) goes through
                  the table: reads to the first LIVE copy, lock-class ops
                  to the OWNER only; a stale table surfaces as
                  ``aborted_stale``.  The identity table with every node up
                  is bit-identical to ptable=None.
    telemetry:    optional telemetry.Recorder — one flight-recorder event
                  per exchange round, tagged with its phase.

    Returns (state, cache, TxResult); ``state["arena"]`` is updated in place.
    Read/write sets are assumed disjoint per lane.
    """
    N, B, Rd = read_keys.shape[:3]
    Wr = write_keys.shape[2]
    dev = read_keys.device
    if read_enabled is None:
        read_enabled = torch.ones((N, B, Rd), dtype=torch.bool, device=dev)
    if write_enabled is None:
        write_enabled = torch.ones((N, B, Wr), dtype=torch.bool, device=dev)

    if fused:
        return _run_transactions_fused(
            t, state, cfg, layout, read_keys=read_keys, write_keys=write_keys,
            write_values=write_values, write_enabled=write_enabled,
            read_enabled=read_enabled, cache=cache, use_onesided=use_onesided,
            capacity=capacity, nic=nic, rep=rep, ptable=ptable,
            telemetry=telemetry)

    serial_h = ht.make_rpc_handler(cfg, layout)
    state, cache, rctx = execute_read_set(
        t, state, cfg, layout, read_keys=read_keys, read_enabled=read_enabled,
        cache=cache, use_onesided=use_onesided, capacity=capacity, nic=nic,
        ptable=ptable, telemetry=telemetry)
    m = rctx["metrics"]
    state, lctx = lock_write_set(
        t, state, cfg, layout, serial_h, write_keys=write_keys,
        write_enabled=write_enabled, capacity=capacity, nic=nic,
        ptable=ptable, telemetry=telemetry)
    vctx = validate_read_set(t, state, layout, rctx, capacity=capacity,
                             nic=nic, telemetry=telemetry)
    state, res = _decide_and_finish(
        t, state, serial_h, N=N, B=B, Rd=Rd, Wr=Wr,
        write_enabled=write_enabled, write_values=write_values,
        rctx=rctx, lctx=lctx, vctx=vctx, read_wire=m.wire,
        onesided_success=m.onesided_success, rpc_fallback=m.rpc_fallback,
        total=m.total, capacity=capacity, nic=nic, rep=rep, ptable=ptable,
        telemetry=telemetry)
    return state, cache, res


# ===========================================================================
# Transactional RANGE SCANS over the ordered index (datastructs.btree).
#
# A scan transaction's READ SET is a run of B-link LEAVES: the client plans
# the (node, leaf) sequence covering [lo, hi] from its cached separator
# directory, reads each leaf with ONE one-sided read, and OCC-validates the
# leaf HEADER versions exactly like point transactions validate record
# slots.  Writes lock whole leaves (OP_BT_LOCK pre-splits full leaves so
# OP_BT_COMMIT always has room).
#
#   * fused=False — the 5-round reference: leaf reads, scan-RPC fallback,
#     LOCK, validate, COMMIT — one phase per all-to-all.
#   * fused=True (default):
#
#         round 1  one-sided reads of the planned leaves
#         round 2  scan fallback ∥ LOCK ∥ validate(one-sided-resolved)
#         round 3  validate(RPC-resolved leaves)   [empty on the fast path]
#         round 4  COMMIT / ABORT (+ OP_BT_BACKUP fan-out at rep.f > 0)
#
#     so the fast-path scan costs exactly the point-lookup schedule's
#     exchange rounds: 2 for a pure scan, 3 with writes.
#
# Stale separators (a leaf split since the last refresh) surface as a GAP in
# the fence chain: the lane aborts with cause `validate` and the retry loop
# refreshes the directory.  `truncated` lanes (range needs more than
# cfg.max_scan_leaves leaves) are reported, never silently clipped.
# ===========================================================================
@dataclasses.dataclass
class ScanTxResult:
    committed: torch.Tensor        # (N, B) bool
    scan_keys: torch.Tensor        # (N, B, S, leaf_width) key words
    scan_values: torch.Tensor      # (N, B, S, leaf_width, VALUE_WORDS)
    scan_mask: torch.Tensor        # (N, B, S, leaf_width) bool — in [lo, hi]
    scan_complete: torch.Tensor    # (N, B) bool — fence chain covered [lo, hi]
    truncated: torch.Tensor        # (N, B) bool — range needs > S leaves
    locked_values: torch.Tensor    # (N, B, Wr, VALUE_WORDS)
    aborted_lock: torch.Tensor     # (N, B) bool
    aborted_validate: torch.Tensor
    aborted_overflow: torch.Tensor
    aborted_stale: torch.Tensor    # (N, B) bool
    metrics: hy.HybridMetrics
    round_trips: torch.Tensor      # scalar


def _bt_lock_requests(t: Transport, cfg: bt.BTreeConfig, *, write_keys,
                      write_enabled, ptable=None):
    """Flatten the btree write set and build OP_BT_LOCK records (leaf-grain
    locks; unique nonzero tag per (node, lane)).  With a ``ptable``,
    lock-class ops route to the partition OWNER only (as _lock_requests)."""
    N, B, Wr = write_keys.shape
    wk = write_keys.reshape(N, B * Wr)
    en = write_enabled.reshape(N, B * Wr)
    part = bt.part_of(cfg, wk)
    wnode = part if ptable is None else pl.owner_dest(ptable, part)
    lane = torch.arange(B * Wr, dtype=torch.int64, device=wk.device) \
        // max(Wr, 1)
    tag = sl.i32(t.node_ids(wk.device).to(torch.int64)[:, None] * B
                 + lane[None, :] + 1)
    zero = torch.zeros_like(wk)
    recs = bt.make_record(W.OP_BT_LOCK, wk, zero, aux=tag)
    return dict(key_lo=wk, key_hi=zero, enabled=en, node=wnode, tag=tag,
                part=part), recs


def _bt_leaf_offset_of(layout, slot_idx):
    """Validation-offset hook: btree read-set entries are header slots in
    the `leaves` region."""
    return rg.slot_offset(layout["leaves"], slot_idx)


def _bt_commit_or_abort(t: Transport, state, serial_h, lock_ctx, *,
                        commit_lane, write_values,
                        capacity: Optional[int] = None, nic=None, rep=None,
                        ptable=None, telemetry=None):
    """COMMIT/ABORT for btree write sets: key in key_lo, the lock TAG in
    key_hi, the locked leaf's header slot in aux.  With rep.f > 0 the
    OP_BT_BACKUP classes ride this SAME fused round; a backup write that is
    dropped, finds the backup tree full (ST_NO_SPACE) or the backup leaf
    locked (ST_LOCK_FAIL) aborts its lane with cause overflow."""
    N, B = commit_lane.shape
    Wr = lock_ctx["key_lo"].shape[1] // max(B, 1)
    commit_item = torch.repeat_interleave(commit_lane, Wr, dim=-1)
    op = torch.where(commit_item, W.OP_BT_COMMIT, W.OP_BT_ABORT)
    cm_recs = bt.make_record(
        op, lock_ctx["key_lo"], lock_ctx["tag"], aux=lock_ctx["lock_slot"],
        value=write_values.reshape(N, B * Wr, sl.VALUE_WORDS))
    return _fan_out(
        t, state, serial_h, lock_ctx, cm_recs,
        lambda: repl.btree_backup_records(lock_ctx, write_values),
        commit_item=commit_item, capacity=capacity, nic=nic, rep=rep,
        backup_fail=(W.ST_NO_SPACE, W.ST_LOCK_FAIL), ptable=ptable,
        telemetry=telemetry)


def _scan_chain(fence_lo, fence_hi, lo, hi, en, resolved):
    """Client-side coverage check over the merged leaf run (all (N, B, S)).

    complete  — every enabled position resolved, fences contiguous
                (fence_lo[j] == fence_hi[j-1] + 1), the first leaf covers lo
                and some leaf reaches hi.
    truncated — the chain is sound but exhausts all S positions before
                reaching hi (reported, never silently clipped)."""
    flo, fhi = sl.u32(fence_lo), sl.u32(fence_hi)
    all_resolved = (resolved | ~en).all(dim=-1)
    first_ok = flo[..., 0] <= sl.u32(lo)
    cont = flo[..., 1:] == ((fhi[..., :-1] + 1) & sl.MASK32)
    cont_ok = (cont | ~en[..., 1:]).all(dim=-1)
    reach = (en & (fhi >= sl.u32(hi)[..., None])).any(dim=-1)
    has_scan = en.any(dim=-1)
    sound = all_resolved & first_ok & cont_ok
    complete = ~has_scan | (sound & reach)
    truncated = has_scan & en[..., -1] & sound & ~reach
    return complete, truncated


def run_scan_transactions(t: Transport, state, cfg: bt.BTreeConfig, layout, *,
                          scan_lo, scan_hi, meta, write_keys=None,
                          write_values=None, write_enabled=None,
                          scan_enabled=None, capacity: Optional[int] = None,
                          fused: bool = True, nic=None, rep=None,
                          ptable=None, telemetry=None):
    """Execute a batch of range-scan transactions over the ordered index,
    one per lane (single shot; see txloop.scan_loop for bounded retry).

    scan_lo/hi:   (N, B) INCLUSIVE key words (lo > hi scans nothing — a
                  pure-write lane).
    meta:         cached separator directory ({"sep", "nleaf"} from
                  btree.refresh_meta / local_meta).
    write_keys:   (N, B, Wr) btree key words upserted on commit (None = no
                  writes); write_values (N, B, Wr, VALUE_WORDS).
    A lane's write keys must land on distinct leaves, and a lane must not
    write into leaves its own scan reads.

    Returns (state, ScanTxResult); ``state["arena"]`` is updated in place.
    fused/nic/rep/capacity as in run_transactions — fused changes ROUND
    COUNTS only, rep=None ≡ f=0.  ptable routes the LOCK phase and the
    commit's backup fan-out through the placement table (the scan reads stay
    a primary-tree protocol planned from ``meta``); stale routes abort
    ``aborted_stale`` for scan_loop to refresh."""
    N, B = scan_lo.shape
    S = cfg.max_scan_leaves
    dev = scan_lo.device
    if write_keys is None:
        write_keys = torch.zeros((N, B, 0), dtype=torch.int32, device=dev)
        write_values = torch.zeros((N, B, 0, sl.VALUE_WORDS),
                                   dtype=torch.int32, device=dev)
    Wr = write_keys.shape[2]
    if write_enabled is None:
        write_enabled = torch.ones((N, B, Wr), dtype=torch.bool, device=dev)
    if scan_enabled is None:
        scan_enabled = torch.ones((N, B), dtype=torch.bool, device=dev)
    serial_h = bt.make_rpc_handler(cfg, layout)
    scan_h = bt.make_scan_handler_vector(cfg, layout)

    # client-side plan from the cached inner nodes (one plan per client)
    plan = bt.scan_plan(cfg, meta["sep"], meta["nleaf"], scan_lo, scan_hi)
    en = plan["enabled"] & scan_enabled[..., None]              # (N, B, S)
    en_f = en.reshape(N, B * S)
    dest = plan["node"].reshape(N, B * S)
    pleaf = plan["leaf"].reshape(N, B * S)
    pfence = plan["fence"].reshape(N, B * S)

    # ---- round 1: one-sided reads of the planned leaves -------------------
    buf, ovf1, s1 = osd.remote_read(
        t, state["arena"], dest, bt.leaf_offset(cfg, layout, pleaf),
        length=cfg.leaf_words, capacity=capacity, enabled=en_f, nic=nic,
        telemetry=telemetry, phase=T.PH_READ)
    p1 = bt.parse_leaf(cfg, buf)
    # resolved one-sided iff the image is stable and its immutable low fence
    # matches the plan (stale separators can only MISS leaves)
    pos_ok = (en_f & ~ovf1 & ((p1["version"] & 1) == 0) & (p1["lock"] == 0)
              & (p1["fence_lo"] == pfence))
    need = en_f & ~pos_ok
    scan_recs = bt.make_record(W.OP_BT_SCAN, pfence, torch.zeros_like(pfence))
    lk, lock_recs = _bt_lock_requests(t, cfg, write_keys=write_keys,
                                      write_enabled=write_enabled,
                                      ptable=ptable)

    fuse_v1 = fused and capacity is None and S > 0
    if fused:
        # ---- round 2: scan fallback ∥ LOCK ∥ validate(one-sided-resolved)
        classes = [
            rs.rpc_class(dest, scan_recs, scan_h, enabled=need,
                         capacity=capacity),
            rs.rpc_class(lk["node"], lock_recs, serial_h,
                         enabled=lk["enabled"], capacity=capacity),
        ]
        if fuse_v1:
            classes.append(rs.read_class(
                dest, _bt_leaf_offset_of(layout, bt.header_slot(cfg, pleaf)),
                length=sl.SLOT_WORDS, enabled=pos_ok))
        state, results, s2 = rs.fused_round(t, state, classes, nic=nic,
                                            telemetry=telemetry,
                                            phase=T.PH_LOCK)
        scan_rep, scan_ovf = results[0]
        lrep, lovf = results[1]
        s_fallback = None
    else:
        # ---- reference rounds 2 and 3: fallback, then LOCK ----------------
        state, scan_rep, scan_ovf, s_fallback = R.rpc_call(
            t, state, dest, scan_recs, scan_h, capacity=capacity,
            enabled=need, nic=nic, telemetry=telemetry, phase=T.PH_FALLBACK)
        state, lrep, lovf, s2 = R.rpc_call(
            t, state, lk["node"], lock_recs, serial_h, capacity=capacity,
            enabled=lk["enabled"], nic=nic, telemetry=telemetry,
            phase=T.PH_LOCK)
    lctx = _parse_lock_replies(lk, lrep, lovf, N, B, Wr)

    # merge the authoritative fallback leaf images over the one-sided reads
    rpc_ok = need & (scan_rep[..., 0] == W.ST_OK) & ~scan_ovf
    mbuf = torch.where(rpc_ok[..., None], scan_rep[..., 2:], buf)
    mslot = torch.where(rpc_ok, scan_rep[..., 1], bt.header_slot(cfg, pleaf))
    p = bt.parse_leaf(cfg, mbuf)
    resolved = pos_ok | rpc_ok
    rctx = dict(key_lo=p["fence_lo"], key_hi=torch.zeros_like(p["fence_lo"]),
                enabled=en_f, found=resolved, versions=p["version"],
                node=dest, slot=mslot, overflow=need & scan_ovf)

    # ---- validate the leaf read set (headers) -----------------------------
    if fuse_v1:
        v1 = results[2][0]
        v2, _, s3 = osd.remote_read(
            t, state["arena"], dest, _bt_leaf_offset_of(layout, mslot),
            length=sl.SLOT_WORDS, enabled=rpc_ok, nic=nic,
            telemetry=telemetry, phase=T.PH_VALIDATE)
        vbuf = torch.where(pos_ok[..., None], v1, v2)
        vctx = _validate_from_bytes(rctx, vbuf, torch.zeros_like(en_f))
        vctx["wire"] = s3
    else:
        vctx = validate_read_set(t, state, layout, rctx, capacity=capacity,
                                 nic=nic, offset_of=_bt_leaf_offset_of,
                                 telemetry=telemetry)
    read_wire = s1 if s_fallback is None else s1 + s_fallback
    lctx["wire"] = s2

    # ---- decide, commit / abort, classify ---------------------------------
    complete, truncated = _scan_chain(
        p["fence_lo"].reshape(N, B, S), p["fence_hi"].reshape(N, B, S),
        scan_lo, scan_hi, en, resolved.reshape(N, B, S))
    lane_locks_ok = _lanes(lctx["lock_ok"] | ~lctx["enabled"], N, B, Wr).all(-1)
    lane_valid = _lanes(vctx["valid"] | ~en_f, N, B, S).all(-1) & complete
    lane_reads_ok = ~_lanes(rctx["overflow"] | vctx["overflow"], N, B,
                            S).any(-1)

    commit_lane = lane_locks_ok & lane_valid & lane_reads_ok
    state, cctx = _bt_commit_or_abort(
        t, state, serial_h, lctx, commit_lane=commit_lane,
        write_values=write_values, capacity=capacity, nic=nic, rep=rep,
        ptable=ptable, telemetry=telemetry)

    has_writes = write_enabled.any(-1)
    commit_delivered = ~_lanes(cctx["overflow"], N, B, Wr).any(-1)
    committed = torch.where(has_writes, commit_lane & commit_delivered,
                            lane_valid & lane_reads_ok)

    lane_ovf = (~lane_reads_ok
                | _lanes(lctx["no_space"], N, B, Wr).any(-1)
                | _lanes(cctx["overflow"], N, B, Wr).any(-1))
    lane_stale = _lanes(lctx["stale"], N, B, Wr).any(-1)
    lane_lock_fail = _lanes(lctx["lock_fail"], N, B, Wr).any(-1)
    aborted = ~committed
    aborted_overflow = aborted & lane_ovf
    aborted_stale = aborted & ~lane_ovf & lane_stale
    aborted_lock = aborted & ~lane_ovf & ~lane_stale & lane_lock_fail
    aborted_validate = (aborted & ~lane_ovf & ~lane_stale & ~lane_lock_fail
                        & ~lane_valid)

    # ---- scan payload: records of validated leaves inside [lo, hi] --------
    LW = cfg.leaf_width
    keys = p["keys"].reshape(N, B, S, LW)
    values = p["values"].reshape(N, B, S, LW, sl.VALUE_WORDS)
    live = p["live"].reshape(N, B, S, LW)
    ku = sl.u32(keys)
    in_range = (live & (ku >= sl.u32(scan_lo)[..., None, None])
                & (ku <= sl.u32(scan_hi)[..., None, None])
                & (resolved.reshape(N, B, S) & en)[..., None])

    wire = read_wire + lctx["wire"] + vctx["wire"] + cctx["wire"]
    rts = (read_wire.round_trips + lctx["wire"].round_trips
           + vctx["wire"].round_trips + cctx["wire"].round_trips)
    return state, ScanTxResult(
        committed=committed,
        scan_keys=keys, scan_values=values, scan_mask=in_range,
        scan_complete=complete, truncated=truncated,
        locked_values=lctx["locked_values"],
        aborted_lock=aborted_lock, aborted_validate=aborted_validate,
        aborted_overflow=aborted_overflow, aborted_stale=aborted_stale,
        metrics=hy.HybridMetrics(onesided_success=hy._count(pos_ok),
                                 rpc_fallback=hy._count(need),
                                 total=hy._count(en_f), wire=wire),
        round_trips=rts)
