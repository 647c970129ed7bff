"""PyTorch port, the ``--trace`` entry point's ``metrics.json``
(``repro_torch.testing.gate``): its ``replication.*`` and ``tatp.*`` keys
and values equal the registry that ``benchmarks/run.py --trace`` fills
through the JAX package with ``replication_cost.fill_registry`` (the f =
0/1/2 sweep and the failover section) and ``fig6_tatp.traced_smoke``.  The
``membership.*`` keys, the rest of the file, are held in
``test_torch_gate_membership_metrics.py``."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import pathlib
import sys

import pytest

jax = pytest.importorskip("jax")

from repro.core import telemetry as JT  # noqa: E402
from repro_torch.testing import gate  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUPS = ("membership.", "replication.", "tatp.")


def test_trace_metrics_equal_reference(tmp_path):
    out = tmp_path / "trace.json"
    assert gate.main(["--trace", str(out), "--device", "cpu"]) == 0
    port = json.loads((out.parent / "metrics.json").read_text())
    assert all(k.startswith(GROUPS) for k in port)

    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import fig6_tatp
        import replication_cost
    finally:
        sys.path.remove(bench_dir)
    reg = JT.MetricsRegistry()
    replication_cost.fill_registry(reg)
    fig6_tatp.traced_smoke(None, None, registry=reg)
    ref = reg.as_dict()
    mine = {k: v for k, v in port.items() if not k.startswith(GROUPS[0])}
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert mine[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
    for k in ("replication.failover_reads", "replication.failover_rerouted",
              "replication.failover_round_trips", "replication.ops_tx_f2",
              "replication.bytes_tx_f0", "replication.commit_rate_f1"):
        assert k in mine, k
