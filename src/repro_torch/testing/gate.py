"""The port's bench gate: every key of ``benchmarks/BENCH_BASELINE.json``,
on the card or on the CPU — the counterpart of ``benchmarks/bench_gate.py``'s
``collect`` with the pieces it takes from the figure scripts:

  * ``ModelFabric`` / ``modeled_throughput_per_node`` (``benchmarks/common.py``):
    the paper's fabric constants (CX4 Infiniband: 1.8 us one-sided and 2.7
    us RPC round trips, 100 Gb/s links, per-op NIC-slot costs);
  * ``modeled_tx_latencies`` (``table5_latency.py``) -> ``tx_latency_us``;
  * ``conn_modeled`` (``conn_scaling.modeled``) -> ``mops_node``;
  * ``replication_mtx`` (``replication_cost.modeled_mtx``), on the f=1 gate
    run's bytes and ops per transaction -> ``replication.mops_node_f1``;
  * ``modeled_scan_mops`` (``range_scan``), on the ordered gate mix ->
    ``ordered.mops_node_32``;
  * ``run_tatp`` / ``traced_smoke`` (``fig6_tatp.run_config`` /
    ``traced_smoke``): the TATP smoke with the flight recorder ->
    ``telemetry``.

The modeled keys are arithmetic on the paper's constants and on protocol
counts the port produces; none of them is a time.

    python -m repro_torch.testing.gate --trace OUT.json [--device cpu]

writes the traced smoke's Perfetto trace to OUT.json and ``metrics.json``
beside it (with the membership and replication bills, as
``benchmarks/run.py --trace`` does) and validates both with
``check_trace``; it runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib

import numpy as np
import torch

from repro_torch.core import nic as qn
from repro_torch.core import telemetry as T
from repro_torch.core import txloop as txl
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.replication import ReplicaConfig
from repro_torch.core.transport import SimTransport
from repro_torch.device import resolve_device
from repro_torch.testing import check_trace
from repro_torch.testing import workloads as wl


# --- modeled fabric (CX4 Infiniband EDR), benchmarks/common.py ---------------
# The round-trip and link constants are the flight recorder's pricing
# defaults, so the modeled keys and the traced latencies share one fabric.
_TEL = T.TelemetryConfig()


@dataclasses.dataclass(frozen=True)
class ModelFabric:
    t_read_us: float = 0.085             # per one-sided read (2 NIC slots)
    t_rpc_us: float = 0.18               # per write-based RPC (handler+CQ)
    link_gbps: float = _TEL.link_gbps
    rt_onesided_us: float = _TEL.rt_onesided_us   # unloaded RT (Table 5)
    rt_rpc_us: float = _TEL.rt_rpc_us


FAB = ModelFabric()


def modeled_throughput_per_node(*, reads_per_op: float, rpcs_per_op: float,
                                wire_bytes_per_op: float, lanes: int,
                                extra_cpu_us_per_op: float = 0.0, nic=None):
    """Million ops/s/node for a pipelined (``lanes`` deep) workload on the
    modeled fabric: the per-op serialization cost (NIC slots + wire bytes +
    CPU terms), floored by the latency/lanes term.  ``nic`` (a
    ``nic.ConnTable``) adds its per-op connection-state penalty."""
    wire_us = wire_bytes_per_op * 8 / (FAB.link_gbps * 1e3)
    slot_us = reads_per_op * FAB.t_read_us + rpcs_per_op * FAB.t_rpc_us
    rt_us = (reads_per_op * FAB.rt_onesided_us
             + rpcs_per_op * FAB.rt_rpc_us)
    if nic is not None:
        extra_cpu_us_per_op += nic.penalty_us_per_op
    per_op_us = max(slot_us + wire_us + extra_cpu_us_per_op,
                    rt_us / max(lanes, 1))
    return 1.0 / per_op_us  # Mops/s


def modeled_tx_latencies():
    """Unloaded OCC transaction latency = the sum of its exchange rounds'
    round trips (``table5_latency.modeled_tx_latencies``): the per-phase 5
    rounds, the fused schedule with (4) and without (3) an RPC-resolved
    validate round."""
    rd, rpc = FAB.rt_onesided_us, FAB.rt_rpc_us
    return {
        "tx_5round": rd + rpc + rpc + rd + rpc,
        "tx_fused4": rd + rpc + rd + rpc,
        "tx_fused3": rd + rpc + rpc,
    }


# conn_scaling.py's per-op profile: one one-sided read of fig7's wire size,
# 32 lanes deep, 20 threads a node (the gate's emulated scale)
CONN_READS_PER_OP, CONN_WIRE_BYTES_PER_OP, CONN_LANES = 1.0, 140, 32
THREADS = 20


def conn_modeled(m_nodes: int, mode: str) -> float:
    """Modeled Mops/node of the connection-scaling profile at ``m_nodes``
    emulated nodes (``conn_scaling.modeled``)."""
    return modeled_throughput_per_node(
        reads_per_op=CONN_READS_PER_OP, rpcs_per_op=0.0,
        wire_bytes_per_op=CONN_WIRE_BYTES_PER_OP, lanes=CONN_LANES,
        nic=qn.ConnTable(n_nodes=m_nodes, threads=THREADS, mode=mode))


REPLICATION_LANES = 32          # replication_cost.py: conn_scaling's depth


def replication_mtx(row, f: int, ct) -> float:
    """Modeled Mtx/node (``replication_cost.modeled_mtx``): 2 one-sided
    exchanges and 2 + f RPC-class exchanges per tx, priced with the
    measured ``row["bytes_tx"]`` and the connection mode's per-op penalty on
    every delivered request (``row["ops_tx"]``)."""
    return modeled_throughput_per_node(
        reads_per_op=2.0, rpcs_per_op=2.0 + f,
        wire_bytes_per_op=row["bytes_tx"], lanes=REPLICATION_LANES,
        extra_cpu_us_per_op=ct.penalty_us_per_op * row["ops_tx"])


def modeled_scan_mops(res, lanes):
    """Modeled Mtx/node of a scan_loop result at 32 emulated nodes on
    exclusive RC (``range_scan.modeled_scan_mops``): every leaf read pays a
    one-sided read twice (data + validate re-read), fallbacks pay an RPC,
    per committed tx."""
    n_com = max(float(res.committed.sum()), 1.0)
    wire = res.metrics.wire
    return modeled_throughput_per_node(
        reads_per_op=2.0 * float(res.metrics.total) / n_com,
        rpcs_per_op=float(res.metrics.rpc_fallback) / n_com,
        wire_bytes_per_op=float(wire.total_bytes) / n_com, lanes=lanes,
        nic=qn.ConnTable(n_nodes=32, threads=THREADS, mode=qn.RC_EXCLUSIVE))


# ---------------------------------------------------------------------------
# TATP (fig6_tatp.py) and its traced smoke
# ---------------------------------------------------------------------------
TATP_LANES, TATP_SUBSCRIBERS_PER_NODE, TATP_MAX_ROUNDS = 16, 160, 4


def run_tatp(n_nodes, telemetry, device="cuda"):
    """``fig6_tatp.run_config`` of the oversubscribed one-sided
    configuration: populate ``TATP_SUBSCRIBERS_PER_NODE`` subscribers per
    node (``n_buckets`` 1024, populate seed 3), draw one TATP batch (seed
    4) and run it through the fused tx_loop with the flight recorder.
    Returns (modeled Mtx/node, commit rate, exchange rounds per attempted
    protocol round, TxLoopResult, TelemetryOut)."""
    dev = resolve_device(device)
    subs, lanes = TATP_SUBSCRIBERS_PER_NODE, TATP_LANES
    cfg = ht.HashTableConfig(n_nodes=n_nodes, n_buckets=1024, bucket_width=1,
                             n_overflow=subs, max_chain=12)
    layout = ht.build_layout(cfg)
    t = SimTransport(n_nodes)
    state = ht.init_cluster_state(cfg, device=dev)
    state, (klo, khi) = wl.populate(cfg, layout, t, state, subs, seed=3,
                                    device=dev)
    rk, wk, ren, wen, wv = wl.tatp_transactions(
        klo, khi, n_nodes=n_nodes, lanes=lanes, subscribers_per_node=subs,
        rng=np.random.RandomState(4), device=dev)
    _, _, res, tel = txl.tx_loop(
        t, state, cfg, layout, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen, max_rounds=TATP_MAX_ROUNDS,
        telemetry=telemetry, device=dev)
    n_tx = n_nodes * lanes
    committed = float(res.committed.sum()) / n_tx
    rounds_attempted = int((res.round_attempts > 0).sum())
    rt_round = float(res.round_trips) / max(rounds_attempted, 1)
    assert float(res.round_trips) <= 4.0 * rounds_attempted, (
        f"fused schedule exceeded 4 exchanges/round: "
        f"{float(res.round_trips)} over {rounds_attempted} rounds")
    m = res.metrics
    rpc_frac = float(m.rpc_fallback) / max(float(m.total), 1)
    # per-tx primitive counts: reads (one-sided, then the validate re-read)
    # and RPCs (fallbacks, lock + commit of the write lanes), scaled by the
    # protocol executions per tx
    exec_per_tx = float(res.round_attempts.sum()) / n_tx
    reads_in = float(ren.sum()) / n_tx
    mtps = modeled_throughput_per_node(
        reads_per_op=2.0 * reads_in * exec_per_tx,
        rpcs_per_op=(reads_in * rpc_frac + 2.0 * float(wen.sum()) / n_tx)
        * exec_per_tx,
        wire_bytes_per_op=float(m.wire.total_bytes) / n_tx, lanes=lanes)
    return mtps, committed, rt_round, res, tel


def traced_smoke(trace_path=None, metrics_path=None, *, n_nodes=4,
                 registry=None, device="cuda"):
    """``fig6_tatp.traced_smoke``: the oversubscribed TATP smoke (4 nodes,
    160 subscribers, 16 lanes, populate seed 3, draws seed 4, 4 rounds)
    with the flight recorder on, published as ``tatp.*`` registry keys
    (latency percentiles per abort-retry path, abort counters, trace
    health) and exported as a Perfetto trace.  Returns (MetricsRegistry,
    trace-event document, TelemetryOut)."""
    tcfg = T.TelemetryConfig()
    mtps, committed, rt_round, res, tel = run_tatp(n_nodes, tcfg, device)
    reg = registry if registry is not None else T.MetricsRegistry()
    reg.set("tatp.commit_rate", committed)
    reg.set("tatp.modeled_mtx_node", mtps)
    reg.set("tatp.rt_round", rt_round)
    reg.set("tatp.round_trips", float(res.round_trips))
    reg.set("tatp.retries", float(res.round_retries.sum()))
    reg.set("tatp.abort_lock", float(res.round_abort_lock.sum()))
    reg.set("tatp.abort_validate", float(res.round_abort_validate.sum()))
    reg.set("tatp.abort_overflow", float(res.round_abort_overflow.sum()))
    reg.set("tatp.trace_events", tel.trace.n)
    reg.set("tatp.trace_dropped", tel.trace.dropped)
    lat = tel.lane_latency_us.cpu().numpy()
    reg.observe("tatp.latency_us", lat[res.committed.cpu().numpy()])
    for group, summ in T.latency_by_path(tel.lane_latency_us, res.committed,
                                         res.commit_round).items():
        for k, v in summ.items():
            reg.set(f"tatp.latency_us.{group}.{k}", v)
    doc = T.export_trace(tel.trace, config=tcfg, path=trace_path,
                         label="tatp")
    if metrics_path is not None:
        reg.write(metrics_path)
    return reg, doc, tel


# ---------------------------------------------------------------------------
# The gate
# ---------------------------------------------------------------------------
def collect(device="cuda"):
    """Every key of ``BENCH_BASELINE.json``, structured and rounded as
    ``bench_gate.collect`` does, with its collect-time checks: the gate
    workload with the recorder on is bit-identical to the recorder off and
    drops nothing; f=1 adds no exchange round; epoch-stable placement
    routing costs the rep-only schedule.

    Returns (keys, runs): ``runs`` holds the gate's tx_loop runs
    (``workloads.gate_tx_runs``), the ordered mix's final ``ordered_state``
    and the traced smoke's (registry, document, TelemetryOut) as
    ``smoke``."""
    dev = resolve_device(device)
    runs = wl.gate_tx_runs(dev)
    (state, res), (_, res1) = runs["f0"], runs["f1"]
    st_t, _, res_t, tel_t = txl.tx_loop(
        runs["t"], {"arena": runs["populated"].clone()}, runs["cfg"],
        runs["layout"], telemetry=T.TelemetryConfig(), **runs["kw"])
    assert (torch.equal(st_t["arena"], state["arena"])
            and torch.equal(res_t.committed, res.committed)
            and float(res_t.round_trips) == float(res.round_trips)
            and float(res_t.metrics.wire.total_bytes)
            == float(res.metrics.wire.total_bytes)), \
        "telemetry=on must be bit-identical to telemetry=None"
    assert tel_t.trace.dropped == 0 and tel_t.trace.n > 0, \
        "the gate workload must fit the default trace buffer"

    keys = wl.gate_tx_keys(res, res1)
    rep = keys["replication"]
    assert rep["round_trips_f1"] == keys["round_trips"], \
        f"f=1 must add zero exchange rounds ({rep['round_trips_f1']} vs " \
        f"{keys['round_trips']})"
    n_tx = wl.GATE_NODES * wl.GATE_LANES
    row = dict(bytes_tx=float(res1.metrics.wire.total_bytes) / n_tx,
               ops_tx=float(res1.metrics.wire.ops) / n_tx)
    rep["mops_node_f1"] = {mode: round(replication_mtx(
        row, 1, qn.ConnTable(n_nodes=96, threads=THREADS, mode=mode)), 4)
        for mode in qn.MODES}
    res_f, ostate, ores = wl.gate_ordered_runs(dev)
    reg, doc, tel = traced_smoke(device=dev)
    keys.update(
        tx_latency_us={k: round(v, 4)
                       for k, v in modeled_tx_latencies().items()},
        mops_node={mode: {str(m): round(conn_modeled(m, mode), 4)
                          for m in (32, 96)} for mode in qn.MODES},
        ordered=dict(wl.gate_ordered_keys(res_f, ores), mops_node_32=round(
            modeled_scan_mops(ores, wl.GATE_LANES), 4)),
        telemetry={
            "latency_us_p50":
                round(reg.get("tatp.latency_us.committed.p50"), 4),
            "latency_us_p99":
                round(reg.get("tatp.latency_us.committed.p99"), 4),
            "commit_rate": round(reg.get("tatp.commit_rate"), 4),
        },
        membership=wl.gate_membership(device=dev))
    assert keys["membership"]["round_trips_stable"] == keys["round_trips"], \
        "epoch-stable placement routing must cost the rep-only schedule"
    return keys, dict(tx=runs, ordered_state=ostate, smoke=(reg, doc, tel))


def gate_keys(device="cuda") -> dict:
    """The whole ``BENCH_BASELINE.json`` dictionary, computed by the port
    on ``device`` (see :func:`collect`)."""
    return collect(device)[0]


# ---------------------------------------------------------------------------
# metrics.json: the replication bill (replication_cost.fill_registry)
# ---------------------------------------------------------------------------
def replication_fill_registry(reg, *, device="cuda"):
    """Publish the replication bill: the gate workload's wire profile at f
    = 0, 1, 2 (equal round trips, growing bytes and ops), then the
    failure-injection section — 8 lanes per node write at f=1, node 1 dies
    and its arena is scorched, and every key reads back from a surviving
    copy through ``failover_lookup``."""
    from repro_torch.core import replication as repl

    dev = resolve_device(device)
    runs = wl.gate_tx_runs(dev)
    n_tx = wl.GATE_NODES * wl.GATE_LANES
    rows = {}
    for f in (0, 1, 2):
        _, _, res = txl.tx_loop(runs["t"], {"arena": runs["populated"].clone()},
                                runs["cfg"], runs["layout"],
                                rep=ReplicaConfig(wl.GATE_NODES, f),
                                **runs["kw"])
        w = res.metrics.wire
        rows[f] = dict(round_trips=float(res.round_trips),
                       bytes_tx=float(w.total_bytes) / n_tx,
                       ops_tx=float(w.ops) / n_tx,
                       commit_rate=float(res.committed.float().mean()))
        for k, v in rows[f].items():
            reg.set(f"replication.{k}_f{f}", v)

    # replication_cost.sweep_f's invariants: f=0 is the unreplicated run
    # bit for bit; f adds no round, only ops and bytes
    none = runs["f0"][1]
    assert rows[0]["round_trips"] == float(none.round_trips) \
        and rows[0]["ops_tx"] == float(none.metrics.wire.ops) / n_tx \
        and rows[0]["bytes_tx"] == float(none.metrics.wire.total_bytes) / n_tx, \
        "f=0 must be bit-identical to the unreplicated dataplane"
    for f in (1, 2):
        assert rows[f]["round_trips"] == rows[0]["round_trips"], \
            f"f={f} must add zero exchange rounds"
        assert rows[f]["ops_tx"] > rows[f - 1]["ops_tx"]
        assert rows[f]["bytes_tx"] > rows[f - 1]["bytes_tx"]

    n, lanes = wl.GATE_NODES, wl.GATE_LANES
    cfg, layout, t = runs["cfg"], runs["layout"], runs["t"]
    rng = np.random.RandomState(17)
    klo = torch.from_numpy(rng.randint(0, 2**31, (n, lanes, 1))).to(
        dev, torch.int32)
    khi = torch.from_numpy(rng.randint(0, 2**31, (n, lanes, 1))).to(
        dev, torch.int32)
    wv = wl.value_for(klo + 7)
    rep = ReplicaConfig(n, 1)
    state, _, res = txl.tx_loop(
        t, ht.init_cluster_state(cfg, device=dev), cfg, layout,
        read_keys=torch.zeros((n, lanes, 0, 2), dtype=torch.int32,
                              device=dev),
        write_keys=torch.stack([klo, khi], -1), write_values=wv,
        max_rounds=4, rep=rep, device=dev)
    assert bool(res.committed.all())
    dead = 1
    alive = repl.kill_node(repl.all_alive(n, device=dev), dead)
    state["arena"][dead] = 0xDEAD
    out = repl.failover_lookup(t, state, klo[..., 0], khi[..., 0], cfg,
                               layout, rep, alive)
    assert bool(out["found"].all()), "reads must fail over to the backups"
    assert torch.equal(out["value"], wv.reshape(n, lanes, -1))
    home = ht.home_of(cfg, klo[..., 0], khi[..., 0])[0]
    w = out["wire"]
    reg.incr("replication.failover_reads", float(w.ops))
    reg.incr("replication.failover_rerouted", float((home == dead).sum()))
    reg.set("replication.failover_round_trips", float(w.round_trips))
    reg.set("replication.failover_found_rate",
            float(out["found"].float().mean()))
    return reg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the traced TATP smoke's Perfetto trace and "
                    "metrics.json beside it, then validate both.")
    ap.add_argument("--trace", required=True, metavar="OUT.json")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    reg = T.MetricsRegistry()
    wl.churn_fill_registry(reg, device=args.device)
    replication_fill_registry(reg, device=args.device)
    out = pathlib.Path(args.trace)
    out.parent.mkdir(parents=True, exist_ok=True)
    metrics = out.parent / "metrics.json"
    traced_smoke(str(out), str(metrics), registry=reg, device=args.device)
    print(f"# wrote {out} and {metrics}", flush=True)
    return check_trace.main([str(out), str(metrics)])


if __name__ == "__main__":
    raise SystemExit(main())
