"""Multi-round transaction engine: bounded retry with backoff (Storm §5.4),
PyTorch port of ``repro/core/txloop.py``: ``tx_loop`` (point transactions)
and ``scan_loop`` (range-scan transactions over the B-link tree).

``tx.run_transactions`` is single shot; ``tx_loop`` retries aborted
transactions:

  * a Python loop over ``max_rounds`` protocol rounds (the reference's
    ``lax.scan``);
  * per-round lane re-enable masks: committed lanes are parked (no handler
    work, no send-queue capacity, no wire bytes); lanes that aborted for ANY
    cause re-execute the full OCC protocol;
  * randomized-slot backoff: each round >= 1 permutes the surviving lanes'
    send-queue slots, which re-randomizes the lock serialization order.
    Round 0 is always the identity (single shot).

The permutations come from ``perms`` when given — the parity tests feed the
reference's ``jax.random`` draws, which torch cannot reproduce — and
otherwise from a ``torch.Generator``: the cluster's (n_nodes, B) draw, of
which a transport's shard takes its own rows, so a MeshTransport run draws
what ``SimTransport(n_nodes)`` draws.  (The reference's mesh run splits its
key per shard, ``split(sub, N)`` with the local N of 1, so its mesh draws
differ from its simulator's by design; a parity test feeds them per rank.)

``scan_loop`` adds one ordered-index move: every retry round REFRESHES the
cached separator directory first (one one-sided read per node, its wire
cost accounted), so lanes that aborted on a stale plan converge; truncated
lanes (range needs more than ``max_scan_leaves`` leaves) are parked and
reported.

Both loops take an optional placement table (``ptable=`` with ``pcfg=``):
every round routes through it, and a retry round entered with stale-route
aborts first REFRESHES the table with one one-sided read of the published
routing region.  Every retry round enters that read, gated off where no
lane of the process wants it (zero wire, zero round trips), so an
epoch-stable run has exactly the schedule and wire of a run without a
table; on a MeshTransport each rank decides from its own lanes, as the
reference's shard does, and every rank enters every exchange.

Both loops take an optional flight recorder (``telemetry=`` a
``telemetry.TelemetryConfig``): one event per exchange round, one SUMMARY
row per protocol round, and the modeled latency of every lane still live in
a round.  The reference issues its gated refreshes in every round and
records them; in round 0, where the port issues none, the recorder appends
the reference's zero-wire row, so the two traces agree row for row.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.convert import words
from repro_torch.core import hybrid as hy
from repro_torch.core import placement as pl
from repro_torch.core import slots as sl
from repro_torch.core import telemetry as T
from repro_torch.core import tx as txm
from repro_torch.core.datastructs import btree as bt
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import Transport, WireStats
from repro_torch.device import resolve_device

DEFAULT_SEED = 0x5707
SCAN_SEED = 0x5C0A


@dataclasses.dataclass
class TxLoopResult:
    committed: torch.Tensor            # (N, B) bool — committed in ANY round
    commit_round: torch.Tensor         # (N, B) int32 — round of commit, -1 if never
    read_found: torch.Tensor           # (N, B, R) bool — from the lane's last attempt
    read_values: torch.Tensor          # (N, B, R, VALUE_WORDS)
    # --- per-round metrics, each (max_rounds,) int32 -----------------------
    round_committed: torch.Tensor      # lanes that committed in round r
    round_attempts: torch.Tensor       # live lanes entering round r
    round_retries: torch.Tensor        # live lanes in round r > 0 (re-attempts)
    round_abort_lock: torch.Tensor     # aborts by cause, per round
    round_abort_validate: torch.Tensor
    round_abort_overflow: torch.Tensor
    round_abort_stale: torch.Tensor
    metrics: hy.HybridMetrics          # totals across all rounds
    round_trips: torch.Tensor          # scalar


def _perm_lanes(x, perm):
    """Permute the lane axis (axis 1) of (N, B, ...) by perm (N, B)."""
    idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand(
        perm.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _as_words(x, dev):
    """Keys/values as int32 word tensors on ``dev`` (numpy uint32 accepted)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return words(x, dev)


def _on_device(state, device, who):
    """The protocol's device: ``state["arena"]``'s, which must be of the
    type the caller asked for (a CUDA state never runs on the CPU)."""
    dev = resolve_device(device)
    if state["arena"].device.type != dev.type:
        raise ValueError(f"{who}: state is on {state['arena'].device}, "
                         f"expected {dev}")
    return state["arena"].device


def _round_perms(perms, max_rounds, t, B, dev, seed, who):
    """Yield each round's lane permutation of the shard's (t.n_local, B)
    lanes: the identity for round 0, then ``perms[rnd]`` when given, else
    the shard's rows of the cluster's (n_nodes, B) draw from a CPU
    generator seeded with ``seed``."""
    N = t.n_local
    if perms is not None:
        perms = torch.as_tensor(perms, dtype=torch.int64).to(dev)
        if tuple(perms.shape) != (max_rounds, N, B):
            raise ValueError(f"{who}: perms must be {(max_rounds, N, B)}, "
                             f"got {tuple(perms.shape)}")
    generator = torch.Generator().manual_seed(seed)
    ident = torch.arange(B, device=dev).expand(N, B)
    for rnd in range(max_rounds):
        if rnd == 0:
            yield ident                               # round 0 == single shot
        elif perms is not None:
            yield perms[rnd]
        else:
            draw = torch.rand((t.n_nodes, B), generator=generator)
            yield t.local(draw.argsort(dim=1)).to(dev)


def _check_placement(ptable, pcfg, who):
    if ptable is not None and pcfg is None:
        raise ValueError(f"{who}: ptable requires pcfg (PlacementConfig)")


def _refresh_table(t, state, layout, pcfg, ptable, rnd, stale_in, nic, rec):
    """A retry round entered with stale-route aborts refreshes the cached
    table (one one-sided read).  As in the reference, every retry round
    enters the read, gated by ``stale_in`` (a bool tensor: whether this
    process's lanes aborted on a stale route in the round before; no host
    sync): gated off, it issues nothing (zero wire, zero round trips), keeps
    the table and records the zero-wire REFRESH row.  On a MeshTransport
    that keeps every rank in every exchange, each deciding from its own
    lanes as the reference's shard does.  Round 0 makes no exchange and
    records the same row.  Returns (table, WireStats or None)."""
    if ptable is None:
        return ptable, None
    if rnd == 0:
        if rec is not None:
            rec.record(T.PH_REFRESH, WireStats.zero(rec.buf.rows.device))
        return ptable, None
    new, stats = pl.refresh_table(t, state, layout, pcfg, ptable,
                                  enabled=stale_in, nic=nic, telemetry=rec)
    return pl.PlacementTable(*(
        torch.where(stale_in, a, b) for a, b in (
            (new.epoch, ptable.epoch), (new.copies, ptable.copies),
            (new.alive, ptable.alive)))), stats


def _recorder(telemetry, t, max_rounds, N, B, dev):
    """(Recorder, per-lane latency accumulator), or (None, None) when the
    flight recorder is off."""
    if telemetry is None:
        return None, None
    buf = T.make_buffer(t.n_nodes, T.loop_capacity(telemetry, max_rounds),
                        device=dev)
    return (T.Recorder(telemetry, buf),
            torch.zeros((N, B), dtype=torch.float32, device=dev))


def _open_round(rec, rnd):
    """Stamp round ``rnd`` on the recorder; the row its events start at."""
    if rec is None:
        return 0
    rec.set_round(rnd)
    return rec.buf.n


def _close_round(rec, n0, lat, active, stats):
    """Every lane still live this round accumulates the round's modeled
    latency; the SUMMARY row carries the abort vector.  Returns lat."""
    if rec is None:
        return lat
    lat = lat + rec.round_cost_us(n0) * active.to(torch.float32)
    rec.summary(**{k: stats[k] for k in (
        "committed", "attempts", "abort_lock", "abort_validate",
        "abort_overflow", "abort_stale")})
    return lat


def _round_stats(rnd, newly, active, res, s_ref=None):
    """One round's counters (each an int32 scalar) and metrics."""
    count = lambda x: x.to(torch.int32).sum()
    live = lambda x: x & active
    m = res.metrics
    wire = m.wire if s_ref is None else m.wire + s_ref
    rts = res.round_trips if s_ref is None else (res.round_trips
                                                 + s_ref.round_trips)
    return dict(
        committed=count(newly),
        attempts=count(active),
        retries=count(active) if rnd > 0 else count(active) * 0,
        abort_lock=count(live(res.aborted_lock)),
        abort_validate=count(live(res.aborted_validate)),
        abort_overflow=count(live(res.aborted_overflow)),
        abort_stale=count(live(res.aborted_stale)),
        metrics=hy.HybridMetrics(m.onesided_success, m.rpc_fallback, m.total,
                                 wire),
        round_trips=rts)


def _totals(ys, extra_wire=None):
    """Per-round columns (as the results' ``round_*`` fields) and summed
    metrics and round trips of a loop's rounds."""
    col = lambda k: torch.stack([y[k] for y in ys]).to(torch.int32)
    total = lambda xs: torch.stack(xs).sum(dim=0)
    ms = [y["metrics"] for y in ys]
    wire = WireStats(**{
        f.name: total([getattr(m.wire, f.name) for m in ms])
        for f in dataclasses.fields(WireStats)})
    rts = total([y["round_trips"] for y in ys])
    if extra_wire is not None:
        wire = wire + extra_wire
        rts = rts + extra_wire.round_trips
    metrics = hy.HybridMetrics(
        onesided_success=total([m.onesided_success for m in ms]),
        rpc_fallback=total([m.rpc_fallback for m in ms]),
        total=total([m.total for m in ms]), wire=wire)
    cols = {f"round_{k}": col(k) for k in (
        "committed", "attempts", "retries", "abort_lock", "abort_validate",
        "abort_overflow", "abort_stale")}
    return cols, metrics, rts


def tx_loop(t: Transport, state, cfg: ht.HashTableConfig, layout, *,
            read_keys, write_keys, write_values, read_enabled=None,
            write_enabled=None, cache=None, use_onesided: bool = True,
            capacity: Optional[int] = None, max_rounds: int = 4, perms=None,
            fused: bool = True, nic=None, rep=None, ptable=None, pcfg=None,
            telemetry: Optional[T.TelemetryConfig] = None, device="cuda"):
    """Run a batch of transactions to convergence (bounded by max_rounds).

    Arguments mirror tx.run_transactions; additionally:
      max_rounds: retry bound (>= 1).  Round 0 is identical to the
                  single-shot protocol; each later round re-runs only the
                  still-aborted lanes with permuted send-queue slots.
      perms:      optional (max_rounds, N, B) lane permutations of the
                  shard's N = t.n_local nodes (row 0 is ignored: round 0 is
                  the identity); without them a CPU torch.Generator seeded
                  with DEFAULT_SEED draws the cluster's and the shard takes
                  its rows.
      rep:        optional replication.ReplicaConfig — every committing
                  round installs the write set on all f+1 copies (zero extra
                  exchange rounds); a dropped backup write aborts its lane
                  (cause overflow), which THIS loop retries.
      ptable/pcfg: optional placement.PlacementTable + PlacementConfig —
                  every round routes through the table; a retry round
                  entered with stale-route aborts first refreshes it with
                  one one-sided read of the published routing region.
      telemetry:  optional telemetry.TelemetryConfig — a flight recorder
                  through every exchange round (``None`` = bit-identical).
      device:     where the protocol runs; ``state["arena"]`` must be there.

    Returns (state, cache, TxLoopResult) — plus a ``telemetry.TelemetryOut``
    as a fourth element when ``telemetry`` is given; ``state["arena"]`` is
    updated in place.
    """
    _check_placement(ptable, pcfg, "tx_loop")
    dev = _on_device(state, device, "tx_loop")
    read_keys = _as_words(read_keys, dev)
    write_keys = _as_words(write_keys, dev)
    write_values = _as_words(write_values, dev)
    N, B, Rd = read_keys.shape[:3]
    if read_enabled is None:
        read_enabled = torch.ones(read_keys.shape[:3], dtype=torch.bool)
    if write_enabled is None:
        write_enabled = torch.ones(write_keys.shape[:3], dtype=torch.bool)
    read_enabled = torch.as_tensor(read_enabled, dtype=torch.bool).to(dev)
    write_enabled = torch.as_tensor(write_enabled, dtype=torch.bool).to(dev)

    done = torch.zeros((N, B), dtype=torch.bool, device=dev)
    commit_round = torch.full((N, B), -1, dtype=torch.int32, device=dev)
    rfound = torch.zeros(read_enabled.shape, dtype=torch.bool, device=dev)
    rvals = torch.zeros(read_enabled.shape + (sl.VALUE_WORDS,),
                        dtype=torch.int32, device=dev)
    rec, lat = _recorder(telemetry, t, max_rounds, N, B, dev)
    ys = []
    stale_in = None
    for rnd, perm in enumerate(_round_perms(perms, max_rounds, t, B, dev,
                                            DEFAULT_SEED, "tx_loop")):
        n0 = _open_round(rec, rnd)
        inv = torch.argsort(perm, dim=1)
        active = ~done
        p = lambda x: _perm_lanes(x, perm)
        u = lambda x: _perm_lanes(x, inv)
        act_p = p(active)
        ptable, s_ref = _refresh_table(t, state, layout, pcfg, ptable, rnd,
                                       stale_in, nic, rec)

        state, cache, res = txm.run_transactions(
            t, state, cfg, layout,
            read_keys=p(read_keys), write_keys=p(write_keys),
            write_values=p(write_values),
            read_enabled=p(read_enabled) & act_p[..., None],
            write_enabled=p(write_enabled) & act_p[..., None],
            cache=cache, use_onesided=use_onesided, capacity=capacity,
            fused=fused, nic=nic, rep=rep, ptable=ptable, telemetry=rec)
        res = dataclasses.replace(res, **{
            k: u(getattr(res, k)) for k in (
                "committed", "read_found", "read_values", "aborted_lock",
                "aborted_validate", "aborted_overflow", "aborted_stale")})
        # fully-masked (parked) lanes report committed=True — gate on active
        newly = res.committed & active
        done = done | newly
        commit_round = torch.where(newly, rnd, commit_round)
        rfound = torch.where(active[..., None], res.read_found, rfound)
        rvals = torch.where(active[..., None, None], res.read_values, rvals)
        if ptable is not None:
            stale_in = (res.aborted_stale & active).any()
        ys.append(_round_stats(rnd, newly, active, res, s_ref))
        lat = _close_round(rec, n0, lat, active, ys[-1])

    cols, metrics, rts = _totals(ys)
    result = TxLoopResult(
        committed=done,
        commit_round=commit_round,
        read_found=rfound,
        read_values=rvals,
        metrics=metrics,
        round_trips=rts,
        **cols,
    )
    if rec is not None:
        return state, cache, result, T.TelemetryOut(trace=rec.buf,
                                                    lane_latency_us=lat)
    return state, cache, result


# ===========================================================================
# Bounded-retry loop for RANGE-SCAN transactions (tx.run_scan_transactions)
# ===========================================================================
@dataclasses.dataclass
class ScanLoopResult:
    committed: torch.Tensor            # (N, B) bool — committed in ANY round
    commit_round: torch.Tensor         # (N, B) int32 — round of commit, -1 never
    truncated: torch.Tensor            # (N, B) bool — parked: range > S leaves
    scan_keys: torch.Tensor            # (N, B, S, LW) — from the last attempt
    scan_values: torch.Tensor          # (N, B, S, LW, VALUE_WORDS)
    scan_mask: torch.Tensor            # (N, B, S, LW) bool
    # --- per-round metrics, each (max_rounds,) int32 -----------------------
    round_committed: torch.Tensor
    round_attempts: torch.Tensor
    round_retries: torch.Tensor
    round_abort_lock: torch.Tensor
    round_abort_validate: torch.Tensor
    round_abort_overflow: torch.Tensor
    round_abort_stale: torch.Tensor
    metrics: hy.HybridMetrics          # totals across rounds (+ meta refresh)
    round_trips: torch.Tensor          # scalar


def scan_loop(t: Transport, state, cfg: bt.BTreeConfig, layout, *, scan_lo,
              scan_hi, meta=None, write_keys=None, write_values=None,
              scan_enabled=None, write_enabled=None,
              capacity: Optional[int] = None, max_rounds: int = 4, perms=None,
              fused: bool = True, nic=None, rep=None, refresh: bool = True,
              ptable=None, pcfg=None,
              telemetry: Optional[T.TelemetryConfig] = None, device="cuda"):
    """Run a batch of range-scan transactions to convergence.

    Arguments mirror tx.run_scan_transactions; additionally:
      meta:       initial cached separator directory; None fetches one up
                  front (wire cost counted).
      refresh:    refresh the directory before every RETRY round (default),
                  so stale-plan aborts converge; refresh=False replays the
                  initial meta.
      perms:      optional (max_rounds, N, B) lane permutations of the
                  shard's nodes (row 0 ignored); without them a CPU
                  torch.Generator seeded with SCAN_SEED draws the cluster's
                  and the shard takes its rows.
      ptable/pcfg: optional placement table + config — lock-class routing
                  and the backup fan-out go through the table; a retry
                  round entered with stale-route aborts refreshes it (after
                  the directory), as tx_loop does.
      telemetry:  optional telemetry.TelemetryConfig — tx_loop's flight
                  recorder; the up-front directory fetch is a REFRESH row
                  of round -1, each round's directory refresh a REFRESH row
                  (zero wire in round 0, where it is not accounted).
      device:     where the protocol runs; ``state["arena"]`` must be there.
    Returns (state, meta, ScanLoopResult) — plus a ``telemetry.TelemetryOut``
    as a fourth element when ``telemetry`` is given; ``state["arena"]`` is
    updated in place."""
    _check_placement(ptable, pcfg, "scan_loop")
    dev = _on_device(state, device, "scan_loop")
    scan_lo = _as_words(scan_lo, dev)
    scan_hi = _as_words(scan_hi, dev)
    N, B = scan_lo.shape
    S, LW = cfg.max_scan_leaves, cfg.leaf_width
    if write_keys is None:
        write_keys = torch.zeros((N, B, 0), dtype=torch.int32, device=dev)
        write_values = torch.zeros((N, B, 0, sl.VALUE_WORDS),
                                   dtype=torch.int32, device=dev)
    write_keys = _as_words(write_keys, dev)
    write_values = _as_words(write_values, dev)
    Wr = write_keys.shape[2]
    if scan_enabled is None:
        scan_enabled = torch.ones((N, B), dtype=torch.bool)
    if write_enabled is None:
        write_enabled = torch.ones((N, B, Wr), dtype=torch.bool)
    scan_enabled = torch.as_tensor(scan_enabled, dtype=torch.bool).to(dev)
    write_enabled = torch.as_tensor(write_enabled, dtype=torch.bool).to(dev)
    rec, lat = _recorder(telemetry, t, max_rounds, N, B, dev)
    init_wire = WireStats.zero(dev)
    if meta is None:
        meta, init_wire = bt.refresh_meta(t, state, cfg, layout, nic=nic)
        if rec is not None:
            rec.set_round(-1)
            _record_directory(rec, init_wire)

    done = torch.zeros((N, B), dtype=torch.bool, device=dev)
    trunc = torch.zeros((N, B), dtype=torch.bool, device=dev)
    commit_round = torch.full((N, B), -1, dtype=torch.int32, device=dev)
    skeys = torch.zeros((N, B, S, LW), dtype=torch.int32, device=dev)
    svals = torch.zeros((N, B, S, LW, sl.VALUE_WORDS), dtype=torch.int32,
                        device=dev)
    smask = torch.zeros((N, B, S, LW), dtype=torch.bool, device=dev)
    ys = []
    stale_in = None
    for rnd, perm in enumerate(_round_perms(perms, max_rounds, t, B, dev,
                                            SCAN_SEED, "scan_loop")):
        n0 = _open_round(rec, rnd)
        inv = torch.argsort(perm, dim=1)
        active = ~done
        p = lambda x: _perm_lanes(x, perm)
        u = lambda x: _perm_lanes(x, inv)
        act_p = p(active)

        # retry rounds refresh the separator directory first; round 0 plans
        # with the meta it was given (the reference reads it there too but
        # neither uses nor accounts it)
        s_ref = None
        if refresh and rnd > 0:
            meta, s_ref = bt.refresh_meta(t, state, cfg, layout, nic=nic)
        if refresh and rec is not None:
            _record_directory(rec, s_ref if s_ref is not None
                              else WireStats.zero(dev))
        ptable, s_pl = _refresh_table(t, state, layout, pcfg, ptable, rnd,
                                      stale_in, nic, rec)
        if s_pl is not None:
            s_ref = s_pl if s_ref is None else s_ref + s_pl

        state, res = txm.run_scan_transactions(
            t, state, cfg, layout,
            scan_lo=p(scan_lo), scan_hi=p(scan_hi), meta=meta,
            write_keys=p(write_keys), write_values=p(write_values),
            scan_enabled=p(scan_enabled) & act_p,
            write_enabled=p(write_enabled) & act_p[..., None],
            capacity=capacity, fused=fused, nic=nic, rep=rep, ptable=ptable,
            telemetry=rec)
        res = dataclasses.replace(res, **{
            k: u(getattr(res, k)) for k in (
                "committed", "truncated", "scan_keys", "scan_values",
                "scan_mask", "aborted_lock", "aborted_validate",
                "aborted_overflow", "aborted_stale")})
        newly = res.committed & active
        newly_trunc = res.truncated & active
        done = done | newly | newly_trunc           # truncation cannot retry
        trunc = trunc | newly_trunc
        commit_round = torch.where(newly, rnd, commit_round)
        upd = active[..., None, None]
        skeys = torch.where(upd, res.scan_keys, skeys)
        smask = torch.where(upd, res.scan_mask, smask)
        svals = torch.where(upd[..., None], res.scan_values, svals)
        if ptable is not None:
            stale_in = (res.aborted_stale & active).any()
        ys.append(_round_stats(rnd, newly, active, res, s_ref))
        lat = _close_round(rec, n0, lat, active, ys[-1])

    cols, metrics, rts = _totals(ys, init_wire)
    result = ScanLoopResult(
        committed=done & ~trunc,
        commit_round=commit_round,
        truncated=trunc,
        scan_keys=skeys, scan_values=svals, scan_mask=smask,
        metrics=metrics,
        round_trips=rts,
        **cols,
    )
    if rec is not None:
        return state, meta, result, T.TelemetryOut(trace=rec.buf,
                                                   lane_latency_us=lat)
    return state, meta, result


def _record_directory(rec, stats):
    """The separator-directory refresh's REFRESH row: a uniform all-to-all
    (every node reads every node), so its per-destination tails are the
    scalar split evenly.  Round 0 accounts no refresh (the reference reads
    but does not account it): its ``stats`` are zero."""
    nd = rec.buf.n_dst
    rec.record(T.PH_REFRESH, stats,
               per_dest_msgs=(stats.messages / nd).expand(nd),
               per_dest_bytes=((stats.req_bytes + stats.reply_bytes) / nd
                               ).expand(nd))
