"""Flight-recorder telemetry for the dataplane (observability layer), PyTorch
port of ``repro/core/telemetry.py``.

Three pieces:

  * :class:`TraceBuffer` + :class:`Recorder` — a fixed-capacity buffer of
    fixed-width event rows on the protocol's device, appended by
    ``roundsched.fused_round`` (and ``onesided.read_round``, the port's
    read round of ``hybrid.onesided_probe``) and by the retry loops of
    ``txloop``.  One row per exchange round (round index, phase tag, class
    count, WireStats snapshot incl. the modeled NIC hit-rate terms,
    per-destination message/byte counts) plus one SUMMARY row per protocol
    round (committed / attempts / abort-cause vector).

  * a modeled per-lane LATENCY accumulator: each protocol round's recorded
    events are priced with the constants of the benchmarks' ``ModelFabric``
    (one-sided vs RPC base round trip, link serialization of the round's
    bytes, the ``nic.ConnTable`` per-op penalty), and every lane still live
    in that round accumulates the cost — a latency sample per lane.

  * export layers: :func:`export_trace` renders the buffer as
    Chrome/Perfetto trace-event JSON (one track per destination node, one
    slice per round x phase, counter tracks for aborts), and
    :class:`MetricsRegistry` collects named host-side counters into a flat
    ``metrics.json``.

``telemetry=None`` (the default everywhere) is bit-identical to a run
without this module: recording only READS protocol values.

The port's loops are driven from the host, so each append is a host event
whose count does not depend on data: the row counter ``n``, the round
register and ``dropped`` are Python ints, while the rows stay on the device.
The recorder reads no device value on the host; only :func:`events` and
:func:`export_trace` copy the rows back, once, at the end.  A full buffer
drops further events and counts them — never an error.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Phase tags.  READ / VALIDATE / REFRESH rounds are one-sided
# (rt_onesided_us), FALLBACK / LOCK / COMMIT rounds run RPC handlers
# (rt_rpc_us); SUMMARY rows carry a protocol round's abort vector.
# ---------------------------------------------------------------------------
PH_OTHER = 0      # unclassified single rounds (direct rpc_call/remote_read)
PH_READ = 1       # one-sided read-set probe (hybrid phase 2)
PH_FALLBACK = 2   # read-set RPC fallback in its own round (unfused schedule)
PH_LOCK = 3       # LOCK round; under the fused schedule this single
                  # exchange also carries the fallback + validate classes
PH_VALIDATE = 4   # one-sided validate re-read
PH_COMMIT = 5     # COMMIT/ABORT round (+ backup fan-out classes at f > 0)
PH_REFRESH = 6    # metadata refresh (placement table / separator directory)
PH_SUMMARY = 7    # per-protocol-round summary (abort-cause vector)

PHASE_NAMES = {
    PH_OTHER: "other", PH_READ: "read", PH_FALLBACK: "fallback",
    PH_LOCK: "lock", PH_VALIDATE: "validate", PH_COMMIT: "commit",
    PH_REFRESH: "refresh", PH_SUMMARY: "summary",
}
# phases whose exchange is one-sided (priced at rt_onesided_us)
_ONESIDED_PHASES = (PH_READ, PH_VALIDATE, PH_REFRESH)

# ---------------------------------------------------------------------------
# Event-row schema.  A row is (EV_WORDS + 2 * n_dst) float32: the fixed
# columns below, then per-destination message counts, then per-destination
# byte counts (summing either tail over destinations reproduces the scalar
# WireStats of the round).
# ---------------------------------------------------------------------------
EV_ROUND = 0          # protocol round index
EV_PHASE = 1          # phase tag above
EV_CLASSES = 2        # traffic classes fused into this exchange round
EV_RT = 3             # round trips (0 for an empty / fully-parked round)
EV_MSGS = 4           # coalesced wire messages (both directions)
EV_OPS = 5            # delivered application-level requests
EV_REQ_BYTES = 6
EV_REPLY_BYTES = 7
EV_NIC_HIT_OPS = 8    # ops-weighted modeled NIC-cache hits (snapshot)
EV_NIC_PENALTY = 9    # ops-weighted modeled connection-state penalty (us)
EV_COMMITTED = 10     # SUMMARY rows only: lanes committed this round ...
EV_ATTEMPTS = 11      # ... lanes live entering the round,
EV_AB_LOCK = 12       # and the abort-cause vector
EV_AB_VALIDATE = 13
EV_AB_OVERFLOW = 14
EV_AB_STALE = 15
EV_WORDS = 16         # fixed columns; per-dest tails follow


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Flight-recorder configuration.

    capacity: event rows in the buffer (None = sized by the loop from its
              ``max_rounds``); a full buffer drops further events and counts
              them in ``TraceBuffer.dropped``.
    rt_onesided_us / rt_rpc_us / link_gbps: the latency-pricing constants,
              defaulting to the paper's fabric, which the gate's
              ``ModelFabric`` reads from here.
    """
    capacity: Optional[int] = None
    rt_onesided_us: float = 1.8
    rt_rpc_us: float = 2.7
    link_gbps: float = 100.0


@dataclasses.dataclass
class TraceBuffer:
    """Fixed-width event log: device rows, host counters."""
    rows: torch.Tensor     # (capacity, EV_WORDS + 2 * n_dst) float32
    n: int = 0             # rows written
    rnd: int = 0           # current protocol round register
    dropped: int = 0       # events dropped at capacity

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]

    @property
    def n_dst(self) -> int:
        return (self.rows.shape[1] - EV_WORDS) // 2


def make_buffer(n_dst: int, capacity: int, device="cuda") -> TraceBuffer:
    """Fresh empty buffer with per-destination tails for ``n_dst`` nodes."""
    return TraceBuffer(rows=torch.zeros(
        (capacity, EV_WORDS + 2 * n_dst), dtype=torch.float32,
        device=resolve_device(device)))


class Recorder:
    """Mutable holder threading a :class:`TraceBuffer` through a call tree.

    Dataplane functions take ``telemetry: Recorder | None = None`` and call
    :meth:`record`; the creating loop reads ``.buf`` at the end.  Every
    append writes one row in place with device ops (no value of the device
    is read here)."""

    __slots__ = ("config", "buf")

    def __init__(self, config: TelemetryConfig, buf: TraceBuffer):
        self.config = config
        self.buf = buf

    # -- appends ------------------------------------------------------------
    def set_round(self, rnd: int):
        """Stamp the protocol round index subsequent events belong to."""
        self.buf.rnd = rnd

    def _append(self, phase, n_classes, col, vals, per_dest_msgs=None,
                per_dest_bytes=None):
        """Write the next row: round, phase and class count, ``vals`` (a
        float32 vector) from column ``col``, the per-destination tails; the
        other columns stay zero.  A full buffer counts a drop instead."""
        b = self.buf
        if b.n >= b.capacity:
            b.dropped += 1
            return
        row = b.rows[b.n]
        row[EV_ROUND].fill_(b.rnd)
        row[EV_PHASE].fill_(phase)
        row[EV_CLASSES].fill_(n_classes)
        row[col:col + vals.shape[0]] = vals
        nd = b.n_dst
        if per_dest_msgs is not None:
            row[EV_WORDS:EV_WORDS + nd] = per_dest_msgs
        if per_dest_bytes is not None:
            row[EV_WORDS + nd:] = per_dest_bytes
        b.n += 1

    def record(self, phase: int, stats, *, n_classes: int = 1,
               per_dest_msgs=None, per_dest_bytes=None):
        """Append one exchange-round event: the WireStats snapshot and,
        where given, the per-destination tails (zero otherwise)."""
        vals = torch.stack([stats.round_trips, stats.messages, stats.ops,
                            stats.req_bytes, stats.reply_bytes,
                            stats.nic_hit_ops, stats.nic_penalty_us]
                           ).to(torch.float32)
        self._append(phase, n_classes, EV_RT, vals, per_dest_msgs,
                     per_dest_bytes)

    def summary(self, *, committed, attempts, abort_lock, abort_validate,
                abort_overflow, abort_stale):
        """Append one per-protocol-round SUMMARY row (abort-cause vector)."""
        vals = torch.stack([committed, attempts, abort_lock, abort_validate,
                            abort_overflow, abort_stale]).to(torch.float32)
        self._append(PH_SUMMARY, 0, EV_COMMITTED, vals)

    # -- modeled latency ----------------------------------------------------
    def round_cost_us(self, n0: int):
        """Modeled latency (us, a float32 device scalar) of the events
        appended since row ``n0``: per event a base round trip when the
        round went on the wire (one-sided vs RPC by phase tag), plus link
        serialization of its bytes, plus the per-op connection-state
        penalty, summed in float32 as the reference does.  SUMMARY rows
        cost nothing."""
        cfg = self.config
        w = self.buf.rows[n0:self.buf.n]
        phase = w[:, EV_PHASE]
        onesided = torch.zeros(phase.shape, dtype=torch.bool,
                               device=phase.device)
        for p in _ONESIDED_PHASES:
            onesided = onesided | (phase == p)
        base = torch.where(onesided, cfg.rt_onesided_us, cfg.rt_rpc_us)
        live = w[:, EV_RT] > 0
        penalty = w[:, EV_NIC_PENALTY] / torch.clamp(w[:, EV_OPS], min=1.0)
        ser = (w[:, EV_REQ_BYTES] + w[:, EV_REPLY_BYTES]) * 8.0e-3 \
            / cfg.link_gbps
        cost = torch.where(live, base + penalty, 0.0) + ser
        return cost.sum()


@dataclasses.dataclass
class TelemetryOut:
    """What a loop returns when ``telemetry=`` is enabled."""
    trace: TraceBuffer
    lane_latency_us: torch.Tensor  # (N, B) float32 — modeled latency to
    #                                commit (or to the final abort) per lane


def loop_capacity(tel: TelemetryConfig, max_rounds: int) -> int:
    """Buffer capacity for a retry loop: the worst round appends <= 9 events
    (two refreshes, five phase rounds on the unfused schedule, summary)."""
    if tel.capacity is not None:
        return tel.capacity
    return max_rounds * 10 + 4


# ---------------------------------------------------------------------------
# Host-side views + percentile summaries
# ---------------------------------------------------------------------------
def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def events(buf: TraceBuffer) -> np.ndarray:
    """The written rows as a host array (n, EV_WORDS + 2 * n_dst)."""
    return _host(buf.rows[:buf.n])


def summarize(latencies) -> dict:
    """Percentile summary of a latency sample: {p50, p90, p99, mean} floats.
    Empty samples summarize to NaNs."""
    a = np.asarray(_host(latencies), np.float64).ravel()
    if a.size == 0:
        nan = float("nan")
        return dict(p50=nan, p90=nan, p99=nan, mean=nan)
    return dict(p50=float(np.percentile(a, 50)),
                p90=float(np.percentile(a, 90)),
                p99=float(np.percentile(a, 99)),
                mean=float(a.mean()))


def latency_by_path(lane_latency_us, committed, commit_round) -> dict:
    """Latency histograms per abort-retry path: ``committed`` (all committed
    lanes), ``aborted`` (lanes that never committed: time burned to the
    final abort) and ``retryK`` (lanes that committed in round K).  Returns
    {group: summarize(...)} with empty groups omitted."""
    lat = np.asarray(_host(lane_latency_us), np.float64).ravel()
    com = np.asarray(_host(committed), bool).ravel()
    cr = np.asarray(_host(commit_round), np.int64).ravel()
    out = {}
    if com.any():
        out["committed"] = summarize(lat[com])
    if (~com).any():
        out["aborted"] = summarize(lat[~com])
    for k in sorted({int(k) for k in cr[com]}):
        out[f"retry{k}"] = summarize(lat[com & (cr == k)])
    return out


class MetricsRegistry:
    """Named host-side counters the benchmarks publish (``metrics.json``):
    plain floats, incremented from a protocol run's results.  ``observe``
    stores a whole latency distribution under dotted percentile keys."""

    def __init__(self):
        self._vals: dict = {}

    def incr(self, name: str, value=1.0):
        self._vals[name] = float(self._vals.get(name, 0.0)) + float(value)

    def set(self, name: str, value):
        self._vals[name] = float(value)

    def observe(self, name: str, latencies):
        for k, v in summarize(latencies).items():
            self._vals[f"{name}.{k}"] = v

    def get(self, name: str, default=0.0) -> float:
        return float(self._vals.get(name, default))

    def as_dict(self) -> dict:
        return dict(sorted(self._vals.items()))

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace-event export
# ---------------------------------------------------------------------------
def export_trace(buf: TraceBuffer, *, config: TelemetryConfig = None,
                 path: Optional[str] = None, label: str = "storm") -> dict:
    """Render the flight recorder as Chrome trace-event JSON.

    One PROCESS (track group) per destination node, with one slice per
    round x phase carrying that node's share of the round's messages/bytes;
    a ``cluster`` process carries the per-round abort-cause counter tracks.
    Timestamps are the MODELED timeline: events laid end to end at their
    priced durations.  Loads in https://ui.perfetto.dev or chrome://tracing.
    """
    cfg = config or TelemetryConfig()
    ev = events(buf)
    n_dst = buf.n_dst
    out = []
    for d in range(n_dst):
        out.append(dict(ph="M", name="process_name", pid=d,
                        args=dict(name=f"node {d}")))
    cluster_pid = n_dst
    out.append(dict(ph="M", name="process_name", pid=cluster_pid,
                    args=dict(name=f"{label} cluster")))
    t_us = 0.0
    for row in ev:
        phase = int(row[EV_PHASE])
        rnd = int(row[EV_ROUND])
        pname = PHASE_NAMES.get(phase, str(phase))
        if phase == PH_SUMMARY:
            out.append(dict(ph="C", name="aborts", pid=cluster_pid,
                            ts=t_us, args=dict(
                                lock=float(row[EV_AB_LOCK]),
                                validate=float(row[EV_AB_VALIDATE]),
                                overflow=float(row[EV_AB_OVERFLOW]),
                                stale=float(row[EV_AB_STALE]))))
            out.append(dict(ph="C", name="progress", pid=cluster_pid,
                            ts=t_us, args=dict(
                                committed=float(row[EV_COMMITTED]),
                                attempts=float(row[EV_ATTEMPTS]))))
            continue
        base = (cfg.rt_onesided_us if phase in _ONESIDED_PHASES
                else cfg.rt_rpc_us)
        live = bool(row[EV_RT] > 0)
        penalty = float(row[EV_NIC_PENALTY]) / max(float(row[EV_OPS]), 1.0)
        ser = float(row[EV_REQ_BYTES] + row[EV_REPLY_BYTES]) * 8.0e-3 / \
            cfg.link_gbps
        dur = (base + penalty if live else 0.0) + ser
        name = f"r{rnd}/{pname}"
        hit_rate = (row[EV_NIC_HIT_OPS] / row[EV_OPS]
                    if row[EV_OPS] > 0 else 1.0)
        for d in range(n_dst):
            msgs = row[EV_WORDS + d]
            byts = row[EV_WORDS + n_dst + d]
            if msgs <= 0 and not live:
                continue
            out.append(dict(
                ph="X", name=name, cat=pname, pid=d, tid=phase,
                ts=t_us, dur=max(dur, 0.001), args=dict(
                    round=rnd, classes=int(row[EV_CLASSES]),
                    msgs=float(msgs), bytes=float(byts),
                    ops=float(row[EV_OPS]),
                    nic_hit_rate=float(hit_rate))))
        t_us += dur
    doc = dict(traceEvents=out, displayTimeUnit="ms",
               otherData=dict(
                   source=label, n_nodes=n_dst,
                   events=buf.n, dropped=buf.dropped,
                   modeled_span_us=t_us))
    if path is not None:
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
    return doc
