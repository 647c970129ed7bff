"""The harness on the CPU at a tiny size: cells added as new files alone
run, and a run with its timed path broken comes out not correct."""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

import faults

HERE = pathlib.Path(__file__).resolve().parent
SEED = 3_000_000_019          # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return faults.make_tree(tmp_path_factory.mktemp("checkout"))


def run_cell(tree, cell, fault="none", seed=SEED, trace=0):
    proc = subprocess.run(
        [sys.executable, str(HERE / "faults.py"), str(tree), cell, str(seed),
         fault, str(trace)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1]), proc.stderr


@pytest.mark.parametrize("cell", sorted(faults.CELLS))
def test_cell_added_as_files_runs_correct(tree, cell):
    """A configuration, a mix, limits and a cell added as files and entries
    alone: the harness finds them and the run is correct."""
    res, err = run_cell(tree, cell)
    assert res["correct"], err[-2000:]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    e2e = "train_tokens_per_s" if cell.endswith("train") else "ttft_p95_ms"
    assert set(res["metrics"]) == {e2e, "setup_s"}
    # the compared numbers beside their limits end standard error
    tail = err.strip().splitlines()[-len(res["checks"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in sorted(faults.CELLS)
    for f in (("unchanged", "half_batch", "control") if c.endswith("train")
              else ("token", "half_batch", "control"))])
def test_broken_timed_path_is_not_correct(tree, cell, fault):
    """Each fault a cell can have, planted under the timed path, and the
    control (the reference one precision step down in the program's
    place) come out not correct."""
    res, err = run_cell(tree, cell, fault)
    assert res["correct"] is False, err[-2000:]


def test_metric_added_as_a_file_is_read(tree):
    """A per-layer metric added as a reader file and an entry alone is in
    the traced run's line; the device's metrics read nothing off the
    card."""
    res, err = run_cell(tree, "tiny-ssm.train", trace=1)
    assert res["correct"], err[-2000:]
    assert res["metrics"] == {faults.METRIC: {"value": res["attempted"],
                                              "unit": "count"}}


def test_result_line_keys(tree):
    res, _ = run_cell(tree, "tiny-moe.prefill")
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
