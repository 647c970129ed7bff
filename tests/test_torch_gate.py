"""PyTorch port, the bench gate (``repro_torch.testing.gate``) and the trace
check (``repro_torch.testing.check_trace``): ``gate_keys("cpu")`` equals
every key of ``benchmarks/BENCH_BASELINE.json``; the traced TATP smoke
equals ``fig6_tatp.traced_smoke`` (its metrics to 4 decimals, its trace row
for row, its export document); the ported trace check accepts the port's
export and rejects what the reference's rejects; the ``--trace`` entry point
writes both artifacts and validates them."""
import copy
import json
import pathlib
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from repro.core import telemetry as JT  # noqa: E402
from repro_torch.core import telemetry as PT  # noqa: E402
from repro_torch.testing import check_trace as pct  # noqa: E402
from repro_torch.testing import gate  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def bench():
    """benchmarks/fig6_tatp.py and check_trace.py (the reference's), imported
    without leaving benchmarks/ on sys.path."""
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import check_trace
        import fig6_tatp
    finally:
        sys.path.remove(bench_dir)
    return fig6_tatp, check_trace


@pytest.fixture(scope="module")
def smoke(bench):
    """The traced smoke through both packages: (port registry, document,
    TelemetryOut), (reference registry, document, TelemetryOut)."""
    fig6, _ = bench
    preg, pdoc, ptel = gate.traced_smoke(device=CPU)
    tcfg = JT.TelemetryConfig()
    _, _, _, _, jtel = fig6.run_config(
        "storm_oversub_traced", 4, use_onesided=True, oversub=True,
        telemetry=tcfg)
    jreg, jdoc = fig6.traced_smoke()
    return (preg, pdoc, ptel), (jreg, jdoc, jtel)


def test_gate_keys_equal_the_whole_baseline():
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())
    keys = gate.gate_keys(CPU)
    assert keys.keys() == baseline.keys()
    for k in baseline:
        assert keys[k] == baseline[k], k
    assert keys["telemetry"] == {"latency_us_p50": 11.7533,
                                 "latency_us_p99": 13.4349,
                                 "commit_rate": 1.0}


def test_modeled_keys_are_the_reference_formulas():
    """The modeled pieces against the benchmark scripts' own functions."""
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import conn_scaling
        import replication_cost
        import table5_latency
        from repro.core import nic as jnic
    finally:
        sys.path.remove(bench_dir)
    assert gate.modeled_tx_latencies() == table5_latency.modeled_tx_latencies()
    for mode in jnic.MODES:
        for m in (8, 32, 96, 128):
            assert gate.conn_modeled(m, mode) == \
                conn_scaling.modeled(m, gate.THREADS, mode)[0]
        row = dict(bytes_tx=1031.125, ops_tx=5.09375)
        for f in (0, 1, 2):
            assert gate.replication_mtx(row, f, gate.qn.ConnTable(
                n_nodes=96, threads=20, mode=mode)) == \
                replication_cost.modeled_mtx(row, f, jnic.ConnTable(
                    n_nodes=96, threads=20, mode=mode))


def test_traced_smoke_equals_reference(smoke):
    (preg, pdoc, ptel), (jreg, jdoc, jtel) = smoke
    p, j = preg.as_dict(), jreg.as_dict()
    assert p.keys() == j.keys()
    for k, v in j.items():
        assert p[k] == pytest.approx(v, abs=5e-5), k
    for k in ("tatp.latency_us.committed.p50", "tatp.latency_us.committed.p99"):
        assert round(p[k], 4) == round(j[k], 4)
    pev, jev = PT.events(ptel.trace), JT.events(jtel.trace)
    np.testing.assert_array_equal(pev, jev)
    np.testing.assert_array_max_ulp(ptel.lane_latency_us.numpy(),
                                    np.asarray(jtel.lane_latency_us),
                                    maxulp=2)
    assert pdoc == jdoc


def test_check_trace_accepts_the_export_and_rejects_faults(smoke, bench):
    (preg, pdoc, _), _ = smoke
    _, ref = bench
    assert pct.check_trace(pdoc) == [] == ref.check_trace(pdoc)
    metrics = preg.as_dict()
    assert pct.check_metrics(metrics) == [] == ref.check_metrics(metrics)

    dropped = copy.deepcopy(pdoc)
    dropped["otherData"]["dropped"] = 1
    backwards = copy.deepcopy(pdoc)
    xs = [e for e in backwards["traceEvents"] if e["ph"] == "X"]
    xs[0]["ts"] = xs[-1]["ts"] + 1.0
    no_track = copy.deepcopy(pdoc)
    no_track["traceEvents"] = [e for e in no_track["traceEvents"]
                               if not (e["ph"] == "M" and e["pid"] == 0)]
    for bad, what in ((dropped, "dropped"), (backwards, "not monotone"),
                      (no_track, "no process")):
        fails = pct.check_trace(bad)
        assert fails and any(what in f for f in fails), (what, fails)
        assert fails == ref.check_trace(bad)
    for bad in ({k: v for k, v in metrics.items()
                 if k != "tatp.latency_us.committed.p99"},
                dict(metrics, **{"tatp.trace_dropped": 2.0}),
                dict(metrics, **{"tatp.x": float("nan")})):
        assert pct.check_metrics(bad) and \
            pct.check_metrics(bad) == ref.check_metrics(bad)


def test_trace_entry_point_writes_and_validates(tmp_path, capsys):
    out = tmp_path / "run" / "trace.json"
    assert gate.main(["--trace", str(out), "--device", CPU]) == 0
    assert "trace check green" in capsys.readouterr().out
    doc = json.loads(out.read_text())
    metrics = json.loads((out.parent / "metrics.json").read_text())
    assert pct.check_trace(doc) == [] and pct.check_metrics(metrics) == []
    for k in ("membership.rereplication_bytes", "replication.bytes_tx_f1",
              "replication.failover_found_rate", "tatp.latency_us.retry1.p50"):
        assert k in metrics, k
    assert metrics["membership.rereplication_bytes"] == 105740.0
    assert metrics["replication.bytes_tx_f1"] == 1031.125
    assert metrics["replication.failover_found_rate"] == 1.0
    assert metrics["replication.round_trips_f2"] == 4.0
