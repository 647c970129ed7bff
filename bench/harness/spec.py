"""What a run reads, found by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``cells/<workload>.json``), the
reference of the configuration's family (``reference/<family>.py``) and a
reader for each per-layer metric (``metrics/<metric>.py``).  A cell,
configuration, mix or metric is added by adding files and entries."""
from __future__ import annotations

import hashlib
import importlib
import importlib.util
import json
import pathlib

BENCH = pathlib.Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: pathlib.Path = ROOT):
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, workload: str):
    """(workload entry, configuration entry) of ``workload``."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            cfg = next(c for c in bench["configs"] if c["name"] == w["config"])
            return w, cfg
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(root: pathlib.Path, entry: dict) -> dict:
    """The configuration file named by the ``configs`` entry."""
    return load_json(root / entry["file"])


def traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def limits(workload: str) -> dict:
    return load_json(BENCH / "cells" / f"{workload}.json")


def reference(family: str):
    """The plain reference module of a model family."""
    return importlib.import_module(f"reference.{family}")


def metric_reader(name: str):
    """The module ``metrics/<name>.py`` (names carry dots, so it is loaded
    by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, workload: str, kind: str):
    """The names of the cell's metrics: ``end_to_end`` or ``per_layer``,
    those without a ``workloads`` key and those that list the cell."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def seed_for(seed: int, *tags) -> int:
    """A 63-bit seed of its own for each stream drawn from the run's
    ``--seed`` (weights, the vocabulary's order, each batch)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") & (2**63 - 1)
