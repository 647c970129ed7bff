"""PyTorch port, the ``--trace`` entry point's ``metrics.json``
(``repro_torch.testing.gate``): its ``membership.*`` keys and values equal
the registry that ``benchmarks/run.py --trace`` fills through the JAX
package with ``membership_churn.fill_registry``.  The other keys are held
in ``test_torch_gate_metrics.py``."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import pathlib
import sys

import pytest

jax = pytest.importorskip("jax")

from repro.core import telemetry as JT  # noqa: E402
from repro_torch.testing import gate  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_trace_membership_metrics_equal_reference(tmp_path):
    out = tmp_path / "trace.json"
    assert gate.main(["--trace", str(out), "--device", "cpu"]) == 0
    port = json.loads((out.parent / "metrics.json").read_text())

    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import membership_churn
    finally:
        sys.path.remove(bench_dir)
    ref = membership_churn.fill_registry(JT.MetricsRegistry()).as_dict()
    mine = {k: v for k, v in port.items() if k.startswith("membership.")}
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert mine[k] == pytest.approx(v, rel=1e-6, abs=1e-9), k
