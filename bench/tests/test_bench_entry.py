"""The command's refusals (no card, or a checkout without the program), and
the per-layer readers against their entries."""
from __future__ import annotations

import pathlib
import subprocess
import sys

import pytest
import torch

import faults

ARGS = ["--workload", "granite-moe-1b-a400m.prefill-8xmix", "--seed", "4000000007",
        "--seconds", "1", "--trace", "0"]


def test_without_a_card_exits_nonzero_and_prints_no_result(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    root = faults.BENCH.parent
    out = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    tree = faults.make_tree(tmp_path, add_cells=False)
    out = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=tree,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = pathlib.Path(faults.BENCH.parent)
    out = subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=root,
                         capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"correct": true' in out.stdout.strip().splitlines()[-1]


def test_metric_files_match_their_entries():
    """Each per-layer metric's reader names the layer, source, unit and
    end-to-end metric its ``BENCHMARK.json`` entry gives, and every cell a
    metric lists reports the end-to-end metric it moves."""
    sys.path.insert(0, str(faults.BENCH))
    from harness import spec
    bench = spec.benchmark(faults.BENCH.parent)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        mod = spec.metric_reader(m["name"])
        assert (mod.LAYER, mod.SOURCE, mod.UNIT, mod.MOVES) == (
            m["layer"], m["source"], m["unit"], m["moves"]), m["name"]
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(
            moved.get("workloads", [w["name"] for w in bench["workloads"]]))
