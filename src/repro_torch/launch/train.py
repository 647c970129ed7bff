"""Training launcher (counterpart of ``repro/launch/train.py``): the train
step on the synthetic token stream, checkpoints committed by a Storm
transaction, resume, and a straggler watchdog.  Runs on the card unless
``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --batch 8 --seq 2048 --steps 5
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-4b \
        --smoke --device cpu --steps 50 --ckpt-dir build/ckpt --ckpt-every 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b \
        --smoke --device cpu --mesh 2,2 --steps 4 --ckpt-dir build/ckpt

``--smoke`` takes the arch's reduced config with the reference's smoke
options (64 x 64 attention tiles in the backward, no remat); otherwise the
full config with the reference's defaults (512 x 512 tiles, remat of each
layer body saving the weight products).

``--mesh D,M`` trains on a (data D, model M) mesh of D x M spawned ranks
under DEFAULT_RULES (fsdp over data; heads, ff, vocab and experts over
model; the batch over data), chosen as ``launch.serve --mesh`` chooses
them: gloo on the CPU, NCCL with one card a rank where the machine has D x
M cards, else gloo on the one card.  Each rank draws its blocks of the
seeded tree and takes its block of each global batch; rank 0 prints the
step lines; the checkpoint is gathered whole and committed by rank 0, and
``--resume`` restores it onto this mesh, whatever mesh saved it.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

MESH_DEADLINE_S = 3600.0


def train(args, dev, topo=None, log=print):
    """``args.steps`` steps from step 0 or the newest checkpoint; on a mesh
    ``topo`` this rank's blocks.  Returns (state, the steps' losses)."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.models.transformer import RunOptions
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import ONE_DEVICE
    from repro_torch.train.step import (TrainHparams, init_train_state,
                                        make_train_state_specs,
                                        make_train_step)

    topo = topo or ONE_DEVICE
    cfg = get(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
        opts = RunOptions(q_block=64, kv_block=64, remat=False)
    else:
        opts = RunOptions()
    shape = ShapeConfig("cli", args.seq, args.batch, "train")
    hp = TrainHparams(optimizer=AdamWConfig(lr=args.lr),
                      microbatches=args.microbatches, opts=opts)
    step_fn = make_train_step(cfg, hp, topo)
    mesh = topo.sharded()
    if mesh and args.batch % topo._prod(topo.batch_axes()):
        raise ValueError(f"a batch of {args.batch} rows does not split over "
                         f"the batch axes {topo.batch_axes()}")
    ckpt = dict(topo=topo, spec_tree=make_train_state_specs(cfg)) \
        if mesh else {}

    mgr = None
    start = 0
    state = None
    if args.ckpt_dir:
        from repro_torch.checkpoint.manager import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir, device=dev)
        if args.resume:
            try:
                start, state = mgr.restore(**ckpt)
                log(f"resumed from step {start}")
            except FileNotFoundError:
                pass
    if state is None:
        state = init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(0), dev,
            topo=topo if mesh else None)

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dc = DataConfig(seed=0)
    times, losses = [], []
    for s in range(start, start + args.steps):
        t0 = time.time()
        batch = synthetic_batch(cfg, shape, dc, step=s, device=dev)
        if mesh:
            batch = {k: topo.block(v, "batch", *(None,) * (v.dim() - 1))
                     for k, v in batch.items()}
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        sync()
        dt = time.time() - t0
        times.append(dt)
        losses.append(loss)
        med = float(np.median(times[-20:]))
        flag = ("  [STRAGGLER]" if (len(times) > 3
                                    and dt > args.straggler_slack * med)
                else "")
        log(f"step {s:5d}  loss {loss:.4f}  gnorm "
            f"{float(metrics['grad_norm']):.3f}  {dt * 1e3:7.1f} ms{flag}")
        if mgr and (s + 1) % args.ckpt_every == 0:
            path = mgr.save(s + 1, state, **ckpt)
            log(f"  checkpoint committed: {path.name} "
                f"(storm tx, latest={mgr.latest_committed_step()})")
    log("done")
    return state, losses


def mesh_rank(rank, world, shape, args):
    """One rank of ``--mesh``: its blocks of the seeded tree, the AdamW state
    and each batch, trained under DEFAULT_RULES; rank 0 prints the lines.
    Returns (its mesh coordinate, the losses, the printed lines)."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import DEFAULT_RULES, Topology
    dev = torch.device("cpu" if args.device == "cpu"
                       else f"cuda:{torch.cuda.current_device()}")
    topo = Topology(make_mesh(shape, ("data", "model"), dev),
                    dict(DEFAULT_RULES))
    lines = []

    def log(line):
        lines.append(line)
        if rank == 0:
            print(line, flush=True)
    _, losses = train(args, dev, topo, log)
    return topo.coordinate(), losses, lines


def train_mesh(args, shape):
    """Train on a (data, model) mesh of ``shape`` across spawned ranks:
    each rank's (coordinate, losses, lines)."""
    from repro_torch.testing.ranks import run_ranks
    world = shape[0] * shape[1]
    threads = None
    if args.device == "cpu":    # the ranks share the host's CPUs
        device, backend = "cpu", "gloo"
        threads = max(1, len(os.sched_getaffinity(0)) // world)
    elif torch.cuda.device_count() >= world:
        device, backend = [f"cuda:{r}" for r in range(world)], "nccl"
    else:                       # NCCL refuses two ranks on one card
        device, backend = "cuda", "gloo"
    return run_ranks(mesh_rank, world, device=device, backend=backend,
                     args=(shape, args), deadline_s=MESH_DEADLINE_S,
                     threads=threads)


def parse(argv=None):
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
    ap.add_argument("--mesh", default=None,
                    help="D,M: train on a (data D, model M) mesh of ranks")
    return ap.parse_args(argv)


def main(argv=None):
    """The one-device run returns its state; ``--mesh`` returns each rank's
    (coordinate, losses, lines)."""
    from repro_torch.device import resolve_device
    args = parse(argv)
    dev = resolve_device(args.device)
    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split(","))
        if len(shape) != 2:
            raise SystemExit("--mesh takes D,M")
        return train_mesh(args, shape)
    return train(args, dev, log=lambda line: print(line, flush=True))[0]


if __name__ == "__main__":
    main()
