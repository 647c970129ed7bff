"""Faults planted under a run's timed path, and the tiny cells the CPU
tests run.  ``python faults.py <root> <workload> <seed> <fault> [trace]``
runs one cell of the benchmark tree at ``<root>`` on the CPU (the look for
a card skipped) with the fault in place, and prints its result line."""
from __future__ import annotations

import json
import pathlib
import shutil
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
SRC = BENCH.parent / "src"

TINY = {
    "tiny-ssm": {"family": "ssm", "model": dict(
        name="tiny-ssm", family="ssm", n_layers=3, d_model=64, n_heads=0,
        n_kv_heads=0, d_ff=0, vocab_size=503, ssm_state=16, ssm_expand=2,
        ssm_head_dim=16, ssm_groups=1, conv_width=4, ssm_chunk=32)},
    "tiny-moe": {"family": "moe", "model": dict(
        name="tiny-moe", family="moe", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=32, vocab_size=503,
        rope_theta=10000.0, n_experts=4, top_k=2, capacity_factor=1.25)},
}
# a per-layer metric added as a file: the requests or steps of the window
METRIC = "attempted.tiny"
METRIC_READER = '''"""Requests or steps the window completed (a count)."""
LAYER = "harness"
SOURCE = "program_counter"
UNIT = "count"
MOVES = "setup_s"


def read(ctx):
    return float(ctx.attempted) if ctx.trace else None
'''
# tiny cell -> (configuration, mix, the benchmark cell whose metrics it has)
CELLS = {
    "tiny-ssm.train": ("tiny-ssm", "tiny-train",
                       "mamba2-780m.train-8x2048"),
    "tiny-moe.train": ("tiny-moe", "tiny-train",
                       "granite-moe-1b-a400m.train-8x2048"),
    "tiny-ssm.prefill": ("tiny-ssm", "tiny-prefill",
                         "granite-moe-1b-a400m.prefill-8xmix"),
    "tiny-moe.prefill": ("tiny-moe", "tiny-prefill",
                         "granite-moe-1b-a400m.prefill-8xmix"),
}
# The tiny cells' limits: the full-size limits do not carry over to these
# widths, so each sits between the program's largest reading and the
# control's smallest (tiny-ssm.train's change_gap: the half-batch fault's
# smallest), read on the CPU over six seeds (the seed below and 11..15) at
# these sizes (near their geometric mean).  logit_gap holds the altered
# token alone.
LIMITS = {
    "tiny-ssm.train": {"loss_gap": 1.0e-4, "grad_gap": 0.029,
                       "change_gap": 0.047},
    "tiny-moe.train": {"grad_gap": 0.041, "change_gap": 0.0085},
    "tiny-ssm.prefill": {"logit_gap": 0.5, "cache_gap": 0.051},
    "tiny-moe.prefill": {"logit_gap": 0.5, "cache_gap_first": 0.011},
}


def make_tree(root: pathlib.Path, add_cells=True) -> pathlib.Path:
    """A checkout at ``root`` holding a copy of the benchmark and, with
    ``add_cells``, the tiny configurations, mixes, limits, cells and a
    per-layer metric added as new files and entries alone."""
    shutil.copytree(BENCH, root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    if add_cells:
        b = root / "bench"
        for name, cfg in TINY.items():
            (b / "configs" / f"{name}.json").write_text(json.dumps(
                dict(cfg, name=name, source="test", reduced=[])))
            bench["configs"].append({
                "name": name, "source": "test", "reduced": [],
                "file": f"bench/configs/{name}.json", "why": "test"})
        train = json.loads((b / "traffic" / "train-8x2048.json").read_text())
        (b / "traffic" / "tiny-train.json").write_text(json.dumps(
            dict(train, batch=2, seq=64)))
        pre = json.loads((b / "traffic" / "prefill-8xmix.json").read_text())
        (b / "traffic" / "tiny-prefill.json").write_text(json.dumps(
            dict(pre, batch=2, lengths=[32, 64], check_block_every=1,
                 kv_positions=8)))
        for cell, (cfg, mix, like) in CELLS.items():
            (b / "cells" / f"{cell}.json").write_text(
                json.dumps({"limits": LIMITS[cell]}))
            bench["workloads"].append({"name": cell, "config": cfg,
                                       "traffic": mix, "chips": 1,
                                       "why": "test"})
            for m in bench["end_to_end"] + bench["per_layer"]:
                if like in m.get("workloads", ()):
                    m["workloads"].append(cell)
        (b / "metrics" / f"{METRIC}.py").write_text(METRIC_READER)
        bench["per_layer"].append({
            "name": METRIC, "unit": "count", "better": "higher",
            "source": "program_counter", "layer": "harness",
            "moves": "setup_s", "workloads": sorted(CELLS)})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def _train_fault(kind):
    from harness import train_cell

    class Broken(train_cell.ProgramTrainer):
        def step(self, batch):
            if kind == "unchanged":     # the step returns its state as it was
                from repro_torch.train.step import loss_and_grads
                metrics, _ = loss_and_grads(self.cfg, self.hp,
                                            self.state["params"], batch)
                return metrics["loss"]
            h = batch["tokens"].shape[0] // 2     # half the batch left out
            return super().step({k: v[:h] for k, v in batch.items()})

        def __init__(self, model, mix, W):
            super().__init__(model, mix, W)
            from repro_torch.configs.base import ModelConfig
            from repro_torch.models.transformer import RunOptions
            from repro_torch.optim.adamw import AdamWConfig
            from repro_torch.train.step import TrainHparams
            self.cfg = ModelConfig(**model)
            self.hp = TrainHparams(optimizer=AdamWConfig(**mix["optimizer"]),
                                   opts=RunOptions(remat=mix["remat"]))
    return Broken


def _prefill_fault(kind):
    import torch
    from harness import prefill_cell

    class Broken(prefill_cell.ProgramPrefill):
        def __call__(self, tokens):
            if kind == "token":     # each served token altered
                ids, cache = super().__call__(tokens)
                return (ids + 1) % self.cfg.vocab_size, cache
            h = tokens.shape[0] // 2    # half the batch left out
            ids, cache = super().__call__(tokens[:h])
            return torch.cat([ids, ids]), {
                k: torch.cat([v, v], 1) if v.dim() > 1 else torch.cat([v, v])
                for k, v in cache.items()}
    return Broken


def _control(ctx):
    """The control in the program's place: the plain reference one
    precision step down."""
    from harness import prefill_cell, train_cell
    from reference.common import Prec
    if ctx.mix["kind"] == "train":
        ctx.make_trainer = lambda model, mix, W: train_cell.RefTrainer(
            ctx.fam, model, mix, W, Prec(control=True))
    else:
        def make(model, W):
            ref = prefill_cell.RefPrefill(ctx.fam, model, W,
                                          Prec(control=True))
            return lambda tokens: ref(tokens)[:2]
        ctx.make_prefill = make


def patch_for(fault):
    if fault == "none":
        return None
    if fault == "control":
        return _control

    def patch(ctx):
        if ctx.mix["kind"] == "train":
            ctx.make_trainer = _train_fault(fault)
        else:
            ctx.make_prefill = _prefill_fault(fault)
    return patch


if __name__ == "__main__":
    root, name, seed, fault = sys.argv[1:5]
    trace = sys.argv[5:] == ["1"]
    root = pathlib.Path(root)
    sys.path[:0] = [str(root / "bench"), str(SRC)]
    import run
    from harness import spec
    run.run_cell(spec.benchmark(root), name, seed=int(seed), seconds=0.5,
                 trace=trace, device="cpu", t_start=time.time(), root=root,
                 patch=patch_for(fault))
