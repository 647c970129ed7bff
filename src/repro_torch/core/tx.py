"""Storm transactional protocol (§5.4, Fig. 3): OCC + 2PC optimized for the
dataplane's two primitives.  PyTorch port of the point-transaction path of
``repro/core/tx.py`` (``run_transactions``, fused and 5-round, without
replication or a placement table; range scans come with the B-link tree in
a later slice).

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
        round 4  commit / abort

Aborts are classified by cause — lock conflict, validation conflict,
overflow/back-pressure, stale route — with priority overflow > stale > lock >
validate.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import hybrid as hy
from repro_torch.core import onesided as osd
from repro_torch.core import roundsched as rs
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
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
                   write_keys, write_enabled):
    """Flatten the write set and build the OP_LOCK records (+ unique tags)."""
    N, B, Wr = write_keys.shape[:3]
    wk_lo = write_keys[..., 0].reshape(N, B * Wr)
    wk_hi = write_keys[..., 1].reshape(N, B * Wr)
    en = write_enabled.reshape(N, B * Wr)
    dev = wk_lo.device
    part = ht.part_of(cfg, wk_lo, wk_hi)
    wnode, _, _ = ht.lookup_start(cfg, layout, wk_lo, wk_hi, None)
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
                     nic=None):
    """EXECUTE phase, read half: one-two-sided lookups of the read set.
    read_keys: (N, B, Rd, 2); read_enabled: (N, B, Rd) bool."""
    N, B, Rd = read_keys.shape[:3]
    rk_lo = read_keys[..., 0].reshape(N, B * Rd)
    rk_hi = read_keys[..., 1].reshape(N, B * Rd)
    en = read_enabled.reshape(N, B * Rd)
    state, cache, found, rvals, rvers, rnode, rslot, rovf, m = hy.hybrid_lookup(
        t, state, rk_lo, rk_hi, cfg, layout, cache=cache,
        use_onesided=use_onesided, rpc_serial=False, capacity=capacity,
        enabled=en, nic=nic)
    return state, cache, dict(
        key_lo=rk_lo, key_hi=rk_hi, enabled=en, found=found, values=rvals,
        versions=rvers, node=rnode, slot=rslot, overflow=rovf, metrics=m)


def lock_write_set(t: Transport, state, cfg: ht.HashTableConfig, layout,
                   serial_h, *, write_keys, write_enabled,
                   capacity: Optional[int] = None, nic=None):
    """EXECUTE phase, write half: LOCK + read-for-update the write set."""
    N, B, Wr = write_keys.shape[:3]
    lk, lock_recs = _lock_requests(t, cfg, layout, write_keys=write_keys,
                                   write_enabled=write_enabled)
    state, lrep, lovf, s_lock = R.rpc_call(
        t, state, lk["node"], lock_recs, serial_h, capacity=capacity,
        enabled=lk["enabled"], nic=nic)
    lctx = _parse_lock_replies(lk, lrep, lovf, N, B, Wr)
    lctx["wire"] = s_lock
    return state, lctx


def validate_read_set(t: Transport, state, layout, read_ctx, *,
                      capacity: Optional[int] = None, nic=None):
    """VALIDATE phase: one-sided re-read of every FOUND read-set slot."""
    issued = read_ctx["enabled"] & read_ctx["found"]
    vbuf, vovf, s_val = osd.remote_read(
        t, state["arena"], read_ctx["node"],
        ht.slot_idx_offset(layout, read_ctx["slot"]), length=sl.SLOT_WORDS,
        capacity=capacity, enabled=issued, nic=nic)
    vctx = _validate_from_bytes(read_ctx, vbuf, vovf)
    vctx["wire"] = s_val
    return vctx


def commit_or_abort(t: Transport, state, serial_h, lock_ctx, *, commit_lane,
                    write_values, capacity: Optional[int] = None, nic=None):
    """COMMIT / ABORT phase: lanes that hold locks either install their
    values (version += 2, unlock) or roll back.  commit_lane: (N, B) bool.
    The commit class cannot overflow (its lanes are a subset of the lanes
    the lock round delivered, to the same destinations in the same order)."""
    N, B = commit_lane.shape
    Wr = lock_ctx["key_lo"].shape[1] // max(B, 1)
    commit_item = torch.repeat_interleave(commit_lane, Wr, dim=-1)
    op = torch.where(commit_item, W.OP_COMMIT_UNLOCK, W.OP_ABORT_UNLOCK)
    # the key_lo word carries the lock tag: the owner releases a lock only
    # for the exact tag that acquired it
    cm_recs = ht.make_record(
        op, lock_ctx["tag"], lock_ctx["key_hi"], aux=lock_ctx["lock_slot"],
        value=write_values.reshape(N, B * Wr, sl.VALUE_WORDS))
    state, results, s_cm = rs.fused_round(
        t, state, [rs.rpc_class(lock_ctx["node"], cm_recs, serial_h,
                                enabled=lock_ctx["lock_ok"],
                                capacity=capacity)], nic=nic)
    return state, dict(overflow=results[0][1] & lock_ctx["lock_ok"],
                       wire=s_cm)


# ---------------------------------------------------------------------------
# Shared tail: commit decision, abort classification, result packing.
# ---------------------------------------------------------------------------
def _decide_and_finish(t, state, serial_h, *, N, B, Rd, Wr, write_enabled,
                       write_values, rctx, lctx, vctx, read_wire,
                       onesided_success, rpc_fallback, total, capacity,
                       nic=None):
    lane_locks_ok = _lanes(lctx["lock_ok"] | ~lctx["enabled"], N, B, Wr).all(-1)
    lane_valid = _lanes(vctx["valid"] | ~rctx["enabled"], N, B, Rd).all(-1)
    # a read dropped by back-pressure is NOT a miss: abort (overflow), retry
    lane_reads_ok = ~_lanes(rctx["overflow"], N, B, Rd).any(-1)

    commit_lane = lane_locks_ok & lane_valid & lane_reads_ok    # (N, B)
    state, cctx = commit_or_abort(
        t, state, serial_h, lctx, commit_lane=commit_lane,
        write_values=write_values, capacity=capacity, nic=nic)

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
                            nic=None):
    N, B, Rd = read_keys.shape[:3]
    Wr = write_keys.shape[2]
    serial_h = ht.make_rpc_handler(cfg, layout)
    rk_lo = read_keys[..., 0].reshape(N, B * Rd)
    rk_hi = read_keys[..., 1].reshape(N, B * Rd)
    ren = read_enabled.reshape(N, B * Rd)

    # ---- round 1: one-sided read of the read set --------------------------
    probe = hy.onesided_probe(t, state, rk_lo, rk_hi, cfg, layout, cache=cache,
                              use_onesided=use_onesided, capacity=capacity,
                              enabled=ren, nic=nic)

    # ---- round 2: read-set RPC fallback ∥ LOCK ∥ validate(one-sided hits) -
    # Under an explicit capacity bound the validate phase keeps its own
    # round, so its back-pressure policy stays that of the reference round.
    lk, lock_recs = _lock_requests(t, cfg, layout, write_keys=write_keys,
                                   write_enabled=write_enabled)
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
    state, results, s2 = rs.fused_round(t, state, classes, nic=nic)
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
            enabled=ren & mg["rpc_ok"], nic=nic)
        vbuf = torch.where(probe["success"][..., None], v1buf, v2buf)
        # without a capacity bound neither validate sub-round can overflow
        vctx = _validate_from_bytes(rctx, vbuf, torch.zeros_like(ren))
        vctx["wire"] = s3
    else:
        vctx = validate_read_set(t, state, layout, rctx, capacity=capacity,
                                 nic=nic)

    # the lock round's wire is fused into s2; attribute the whole fused round
    # to the lock slot of the accounting so totals stay exact
    lctx["wire"] = s2

    state, res = _decide_and_finish(
        t, state, serial_h, N=N, B=B, Rd=Rd, Wr=Wr,
        write_enabled=write_enabled, write_values=write_values,
        rctx=rctx, lctx=lctx, vctx=vctx, read_wire=probe["wire"],
        onesided_success=hy._count(probe["success"]),
        rpc_fallback=hy._count(probe["need_rpc"]),
        total=hy._count(ren), capacity=capacity, nic=nic)
    return state, cache, res


def run_transactions(t: Transport, state, cfg: ht.HashTableConfig, layout, *,
                     read_keys, write_keys, write_values, write_enabled=None,
                     read_enabled=None, cache=None, use_onesided: bool = True,
                     capacity: Optional[int] = None, fused: bool = True,
                     nic=None):
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
            capacity=capacity, nic=nic)

    serial_h = ht.make_rpc_handler(cfg, layout)
    state, cache, rctx = execute_read_set(
        t, state, cfg, layout, read_keys=read_keys, read_enabled=read_enabled,
        cache=cache, use_onesided=use_onesided, capacity=capacity, nic=nic)
    m = rctx["metrics"]
    state, lctx = lock_write_set(
        t, state, cfg, layout, serial_h, write_keys=write_keys,
        write_enabled=write_enabled, capacity=capacity, nic=nic)
    vctx = validate_read_set(t, state, layout, rctx, capacity=capacity,
                             nic=nic)
    state, res = _decide_and_finish(
        t, state, serial_h, N=N, B=B, Rd=Rd, Wr=Wr,
        write_enabled=write_enabled, write_values=write_values,
        rctx=rctx, lctx=lctx, vctx=vctx, read_wire=m.wire,
        onesided_success=m.onesided_success, rpc_fallback=m.rpc_fallback,
        total=m.total, capacity=capacity, nic=nic)
    return state, cache, res
