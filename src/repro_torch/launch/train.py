"""Training launcher (counterpart of ``repro/launch/train.py``): the train
step on the synthetic token stream, checkpoints committed by a Storm
transaction, resume, and a straggler watchdog.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --batch 8 --seq 2048 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --device cpu --steps 50 --ckpt-dir build/ckpt --ckpt-every 20

``--smoke`` takes the arch's reduced config with the reference's smoke
options (64 x 64 attention tiles in the backward, no remat); otherwise the
full config with the reference's defaults (512 x 512 tiles, remat of each
layer body saving the weight products).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config with the smoke run options")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--straggler-slack", type=float, default=3.0,
                    help="warn when a step exceeds slack x median")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import RunOptions
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (TrainHparams, init_train_state,
                                        make_train_step)

    dev = resolve_device(args.device)
    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        opts = RunOptions(q_block=64, kv_block=64, remat=False)
    else:
        opts = RunOptions()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hp = TrainHparams(optimizer=AdamWConfig(lr=args.lr),
                      microbatches=args.microbatches, opts=opts)
    step_fn = make_train_step(cfg, hp)
    init = lambda: init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)

    mgr = None
    start = 0
    state = None
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir, device=dev)
        if args.resume:
            try:
                start, state = mgr.restore()
                print(f"resumed from step {start}")
            except FileNotFoundError:
                pass
    if state is None:
        state = init()

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dc = DataConfig(seed=0)
    times = []
    for s in range(start, start + args.steps):
        t0 = time.time()
        batch = synthetic_batch(cfg, shape, dc, step=s, device=dev)
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        sync()
        dt = time.time() - t0
        times.append(dt)
        med = float(np.median(times[-20:]))
        flag = ("  [STRAGGLER]" if (len(times) > 3
                                    and dt > args.straggler_slack * med)
                else "")
        print(f"step {s:5d}  loss {loss:.4f}  gnorm "
              f"{float(metrics['grad_norm']):.3f}  {dt * 1e3:7.1f} ms{flag}",
              flush=True)
        if mgr and (s + 1) % args.ckpt_every == 0:
            path = mgr.save(s + 1, state)
            print(f"  checkpoint committed: {path.name} "
                  f"(storm tx, latest={mgr.latest_committed_step()})")
    print("done")
    return state


if __name__ == "__main__":
    main()
