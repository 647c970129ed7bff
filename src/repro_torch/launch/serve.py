"""Serving launcher: batched prefill, then greedy decode (counterpart of
``repro/launch/serve.py``) for every registered arch: the dense family
(gemma2-27b, qwen2.5-32b, qwen1.5-4b, glm4-9b), the MoE family
(granite-moe-1b-a400m, deepseek-moe-16b), mamba2-780m, zamba2-1.2b,
whisper-medium (its frames from the synthetic batch) and
llava-next-mistral-7b (its patch embeddings from the synthetic batch, in
the prompt's first positions).  Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --batch 2 --prompt 8192 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --batch 8 --prompt 4096 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --batch 8 --prompt 416 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch llava-next-mistral-7b --batch 4 --prompt 4096 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --device cpu

``--mesh D,M`` serves any arch tensor-parallel on a (data D, model M) mesh
under ``SERVE_RULES`` (the reference's launcher builds
``Topology(mesh, SERVE_RULES)``): D x M ranks through
``testing.ranks.run_ranks``, gloo on the CPU, NCCL one card a rank where
the machine has D x M cards, else gloo with every rank on the one card.
Each rank draws the whole seeded tree leaf by leaf and keeps its blocks,
takes its block of the batch, and decodes greedily across the vocab
blocks.  The ids can part from the one-device run's where bf16 partial
sums round in another order, and for MoE archs, whose expert capacity
counts a rank's batch block (the reference's per-device capacity).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
        --smoke --device cpu --batch 2 --prompt 96 --decode 4 --mesh 1,4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b \
        --smoke --device cpu --batch 2 --prompt 96 --decode 4 --mesh 1,4
    PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-medium \
        --smoke --device cpu --batch 2 --prompt 96 --decode 4 --mesh 1,4
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs.registry import get
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.embedding import greedy
from repro_torch.parallel.sharding import (ONE_DEVICE, SERVE_RULES, Topology,
                                           init_params)
from repro_torch.serving.decode import make_decode_step, make_prefill

MESH_DEADLINE_S = 600.0     # the seconds the ranks of --mesh may take

def build(arch: str, *, smoke: bool = False, seed: int = 0, device="cuda",
          topo: Topology = None):
    """(config, parameters) of ``arch``: its full or ``smoke()`` size, drawn
    from ``seed`` on ``device``; with ``topo`` this rank's blocks of the
    same draws."""
    cfg = get(arch)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(api.param_specs(cfg), gen, dev, topo=topo)


def prompt_batch(cfg, batch: int, prompt: int, decode: int, device="cuda"):
    """The synthetic batch of step 0 for ``batch`` rows of ``prompt + decode``
    tokens, without its labels: {"tokens"}, with "frames" (audio) or
    "patch_embeds" (VLM) where the family takes them.  The prompt is the
    first ``prompt`` tokens."""
    shape = ShapeConfig("serve", prompt + decode, batch, "train")
    out = synthetic_batch(cfg, shape, DataConfig(), 0, device=device)
    del out["labels"]
    return out


def prompt_inputs(batch, prompt: int):
    """The prefill's inputs: the first ``prompt`` tokens of ``batch`` (a
    :func:`prompt_batch`), its frames, and the patch embeddings that fall
    within the prompt."""
    out = dict(batch, tokens=batch["tokens"][:, :prompt])
    if "patch_embeds" in out:
        out["patch_embeds"] = out["patch_embeds"][:, :prompt]
    return out


def serve(cfg, params, batch, prompt: int, decode: int,
          topo: Topology = ONE_DEVICE):
    """Prefill the prompt of ``batch`` (a :func:`prompt_batch`), then
    ``decode`` greedy tokens.  Returns (generated ids (B, decode), stats):
    the first id comes from the prefill logits, each later one from a
    decode step.  The prefill leaves room in the cache for ``decode``
    positions.  On a mesh ``params`` and ``batch`` are this rank's blocks
    and the ids its batch rows'."""
    dev = batch["tokens"].device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = make_prefill(cfg, prompt, room=decode, topo=topo)(
        params, prompt_inputs(batch, prompt))
    tok = greedy(cfg, logits, topo)
    sync()
    t_prefill = time.perf_counter() - t0
    step = make_decode_step(cfg, topo)
    outs = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(decode - 1):
        logits, cache = step(params, cache, tok)
        tok = greedy(cfg, logits, topo)
        outs.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    n_dec = batch["tokens"].shape[0] * (decode - 1)
    return torch.stack(outs, 1), {
        "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
        "decode_tokens": n_dec,
        "decode_tok_per_s": n_dec / t_decode if t_decode > 0 else None,
        "cache": cache, "last_logits": logits}


def mesh_rank(rank, world, shape, args):
    """One rank of ``--mesh``: its blocks of the seeded tree and of the
    batch, served under SERVE_RULES.  Returns (its mesh coordinate, its
    ids, its stats without the cache)."""
    from repro_torch.launch.mesh import make_mesh
    dev = ("cpu" if args.device == "cpu"
           else f"cuda:{torch.cuda.current_device()}")
    topo = Topology(make_mesh(shape, ("data", "model"), dev),
                    dict(SERVE_RULES))
    cfg, params = build(args.arch, smoke=args.smoke, device=dev, topo=topo)
    batch = prompt_batch(cfg, args.batch, args.prompt, args.decode,
                         device=dev)
    batch = {k: topo.block(v, "batch", *(None,) * (v.dim() - 1))
             for k, v in batch.items()}
    ids, st = serve(cfg, params, batch, args.prompt, args.decode, topo)
    st = {k: v for k, v in st.items() if k not in ("cache", "last_logits")}
    return topo.coordinate(), ids.cpu(), st


def serve_mesh(args, shape):
    """Serve on a (data, model) mesh of ``shape`` across spawned ranks:
    (ids (B, decode) in batch order, each rank's stats)."""
    from repro_torch.testing.ranks import run_ranks
    world = shape[0] * shape[1]
    if args.device == "cpu":
        device, backend = "cpu", "gloo"
    elif torch.cuda.device_count() >= world:
        device, backend = [f"cuda:{r}" for r in range(world)], "nccl"
    else:                       # NCCL refuses two ranks on one card
        device, backend = "cuda", "gloo"
    res = run_ranks(mesh_rank, world, device=device, backend=backend,
                    args=(shape, args), deadline_s=MESH_DEADLINE_S)
    rows = [ids for coord, ids, _ in res if coord["model"] == 0]
    return torch.cat(rows), [st for _, _, st in res]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=None,
                    help="D,M: serve on a (data D, model M) mesh of ranks")
    args = ap.parse_args(argv)

    if args.mesh:
        shape = tuple(int(v) for v in args.mesh.split(","))
        if len(shape) != 2:
            raise SystemExit("--mesh takes D,M")
        ids, stats = serve_mesh(args, shape)
        st = max(stats, key=lambda x: x["prefill_ms"] + x["decode_ms"])
        print(f"mesh: {shape[0]} x {shape[1]} ranks (data x model), "
              f"SERVE_RULES; the slowest rank's times")
    else:
        cfg, params = build(args.arch, smoke=args.smoke, device=args.device)
        batch = prompt_batch(cfg, args.batch, args.prompt, args.decode,
                             device=args.device)
        ids, st = serve(cfg, params, batch, args.prompt, args.decode)
    print(f"prefill: {args.batch}x{args.prompt} tokens in "
          f"{st['prefill_ms']:.1f} ms")
    if args.mesh:            # the whole batch's tokens in the ranks' time
        st["decode_tokens"] = args.batch * (args.decode - 1)
        st["decode_tok_per_s"] = (st["decode_tokens"] / st["decode_ms"] * 1e3
                                  if st["decode_ms"] > 0 else None)
    print(f"decode: {st['decode_tokens']} tokens in {st['decode_ms']:.1f} ms "
          f"({st['decode_tok_per_s'] or 0:.1f} tok/s greedy)")
    print("sample continuation ids:", ids[0][:12].tolist())
    return ids


if __name__ == "__main__":
    main()
