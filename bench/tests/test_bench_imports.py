"""What a run may load: nothing of JAX or of the JAX package (whose
top-level name the port's begins with), and a reference that takes nothing
of the program."""
from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import faults

BENCH = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_sources_import_no_jax_and_reference_nothing_of_the_program():
    for path in BENCH.rglob("*.py"):
        tops = {n.split(".")[0] for n in _imports(path)}
        assert not tops & FORBIDDEN, path
        if path.parent.name == "reference":
            assert tops <= {"__future__", "math", "torch", "reference",
                            "harness"}, path


def test_a_run_loads_no_jax(tmp_path):
    """Every module a whole run loads (the harness, every reader, the
    reference, the program's entry points) by top-level name."""
    tree = faults.make_tree(tmp_path)
    code = f"""
import json, sys, time
sys.path[:0] = [{str(tree / 'bench')!r}, {str(faults.SRC)!r},
                {str(faults.HERE)!r}]
import faults, run, limits
from harness import spec
b = spec.benchmark(__import__('pathlib').Path({str(tree)!r}))
for cell in ("tiny-ssm.train", "tiny-moe.prefill"):
    run.run_cell(b, cell, seed=5, seconds=0.2, trace=False, device="cpu",
                 t_start=time.time(), root=__import__('pathlib').Path({str(tree)!r}))
for m in b["per_layer"]:
    spec.metric_reader(m["name"])
print(json.dumps(sorted({{n.split('.')[0] for n in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in tops
    assert not tops & FORBIDDEN


def test_a_run_holding_the_jax_package_prints_no_result(tmp_path):
    tree = faults.make_tree(tmp_path)
    code = f"""
import sys, time, types
sys.path[:0] = [{str(tree / 'bench')!r}, {str(faults.SRC)!r}]
import pathlib, run
from harness import spec
root = pathlib.Path({str(tree)!r})
def patch(ctx):
    sys.modules["repro"] = types.ModuleType("repro")
r = run.run_cell(spec.benchmark(root), "tiny-moe.prefill", seed=5,
                 seconds=0.2, trace=False, device="cpu", t_start=time.time(),
                 root=root, patch=patch)
sys.exit(0 if r is None else 1)
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == ""
    assert "repro" in out.stderr
