"""End-to-end training: a reduced granite-family MoE on the synthetic
stream, on the PyTorch port (the counterpart of ``examples/train_moe.py``,
the same config, hyperparameters, flow and printed lines).

By default runs a reduced granite-family MoE (width 128, 4 layers, 8
experts, top-2, vocab 2048) for 60 steps of 4 x 128 tokens; pass
--steps/--width to scale up.  On the card each step runs the
``flash_attention`` kernel once a layer (no remat).  The reference's
docstring promises checkpoints and eval, which its code does not run, so
neither does this one.

    PYTHONPATH=src python examples/torch_train_moe.py --steps 200 [--device cpu]
"""
import argparse
import dataclasses
import time

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs.registry import get
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models.transformer import RunOptions
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel.sharding import Topology
from repro_torch.train.step import TrainHparams, init_train_state, make_train_step


def config(width: int = 128):
    """The reduced granite MoE of the example at ``width``."""
    return dataclasses.replace(
        get("granite-moe-1b-a400m").smoke(),
        d_model=width, n_heads=8, n_kv_heads=4, head_dim=16,
        n_layers=4, n_experts=8, top_k=2, d_ff=4 * width // 8,
        vocab_size=2048)


HPARAMS = TrainHparams(
    optimizer=AdamWConfig(lr=1e-3, warmup_steps=30, weight_decay=0.0,
                          grad_clip=0.5),
    opts=RunOptions(q_block=64, kv_block=64, remat=False))


def main(argv=None, device=None, state=None):
    """Train on ``--device`` (default ``cuda``; ``device`` overrides it),
    from ``state`` where given (a train state of ``config(--width)`` on that
    device, updated in place) or one drawn from a torch generator seeded 0.
    Returns {"lines", "losses", "accuracies", "grad_norms", "state"}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(device or args.device)
    lines = []

    def say(s):
        print(s, flush=True)
        lines.append(s)

    cfg = config(args.width)
    topo = Topology(make_smoke_mesh(dev))
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    step_fn = make_train_step(cfg, HPARAMS, topo)
    if state is None:
        state = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    dc = DataConfig(seed=1)

    t0, losses, accs, gnorms = time.time(), [], [], []
    for s in range(args.steps):
        batch = synthetic_batch(cfg, shape, dc, step=s, device=dev)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        accs.append(float(metrics["accuracy"]))
        gnorms.append(float(metrics["grad_norm"]))
        if s % 10 == 0 or s == args.steps - 1:
            say(f"step {s:4d}  loss {losses[-1]:.4f}  acc {accs[-1]:.3f}  "
                f"gnorm {gnorms[-1]:.2f}")
    best = min(losses[-5:])
    say(f"\nloss {losses[0]:.3f} -> {best:.3f} over {args.steps} steps "
        f"({time.time()-t0:.0f}s); MoE dispatched via the Storm hybrid "
        f"(mode chosen by the cost model at trace time)")
    if best >= losses[0]:
        say("WARNING: no improvement at this tiny scale/step budget — "
            "run with --steps 300 for a clear descent")
    return {"lines": lines, "losses": losses, "accuracies": accs,
            "grad_norms": gnorms, "state": state}


if __name__ == "__main__":
    main()
