"""Run one cell of the port's benchmark once, in this process.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  The cell is
read from ``BENCHMARK.json``; its configuration, traffic mix, limits and
per-layer readers from the files named after them under ``bench/``.  It
sets up (weights and inputs drawn from the seed on the card, every shape
the cell uses warmed), measures for ``--seconds``, checks what the timed
path produced against the plain reference, and prints one JSON line.
With ``--trace 1`` it also profiles a short stretch after the window and
reports the cell's per-layer metrics instead of its end-to-end ones.

It needs the card: without CUDA, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def main(argv=None) -> int:
    from harness.context import process_start
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from harness import spec

    bench = spec.benchmark(ROOT)
    workload, entry = spec.cell(bench, args.workload)
    chips = workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, seed=args.seed,
                      seconds=args.seconds, trace=bool(args.trace),
                      device="cuda", t_start=t_start)
    return 0 if result is not None else 3


def run_cell(bench, name, *, seed, seconds, trace, device, t_start,
             root=ROOT, patch=None):
    """One run of cell ``name`` on ``device`` after the look for a card:
    prints and returns the result (None where the run held a module it
    must not).  ``patch(ctx)``, where given, may replace the program's
    entry points on the context before the cell runs (the tests break the
    timed path through it)."""
    import torch
    from harness import spec
    from harness.context import Context, emit
    # float32 products in full float32 (the reference's; the program's
    # default too)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    workload, entry = spec.cell(bench, name)
    ctx = Context(workload=name, model_entry=workload,
                  model_file=spec.config(root, entry),
                  mix=spec.traffic(workload["traffic"]),
                  limits=spec.limits(name)["limits"], seed=seed,
                  seconds=seconds, trace=trace, device=device,
                  t_start=t_start)
    driver = drive(ctx)
    if patch is not None:
        patch(ctx)
    driver.run(ctx)
    if ctx.forbidden_seen:
        print(f"bench: modules loaded that a run must not hold: "
              f"{ctx.forbidden_seen}", file=sys.stderr)
        return None
    result = ctx.result(bench)
    emit(result, ctx.notes)
    return result


def drive(ctx):
    """The cell's driver for its mix's kind, with the program in place."""
    from harness import prefill_cell, train_cell
    if ctx.mix["kind"] == "train":
        ctx.make_trainer = train_cell.ProgramTrainer
        return train_cell
    if ctx.mix["kind"] == "prefill":
        ctx.make_prefill = prefill_cell.ProgramPrefill
        return prefill_cell
    raise ValueError(f"unknown traffic kind {ctx.mix['kind']!r}")


if __name__ == "__main__":
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    sys.exit(main())
