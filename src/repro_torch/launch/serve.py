"""Serving launcher: batched prefill, then greedy decode (counterpart of
``repro/launch/serve.py``) for every registered arch: the dense family
(gemma2-27b, qwen2.5-32b, qwen1.5-4b, glm4-9b), the MoE family
(granite-moe-1b-a400m, deepseek-moe-16b), mamba2-780m and zamba2-1.2b.
Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
        --batch 2 --prompt 8192 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch deepseek-moe-16b --batch 8 --prompt 4096 --decode 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \
        --smoke --device cpu
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
from repro_torch.parallel.sharding import init_params
from repro_torch.serving.decode import make_decode_step, make_prefill


def build(arch: str, *, smoke: bool = False, seed: int = 0, device="cuda"):
    """(config, parameters) of ``arch``: its full or ``smoke()`` size, drawn
    from ``seed`` on ``device``."""
    cfg = get(arch)
    if smoke:
        cfg = cfg.smoke()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    return cfg, init_params(api.param_specs(cfg), gen, dev)


def prompt_batch(cfg, batch: int, prompt: int, decode: int, device="cuda"):
    """The synthetic stream's first ``prompt + decode`` tokens of ``batch``
    rows; the prompt is the first ``prompt``."""
    shape = ShapeConfig("serve", prompt + decode, batch, "train")
    return synthetic_batch(cfg, shape, DataConfig(), 0, device=device)["tokens"]


def serve(cfg, params, tokens, prompt: int, decode: int):
    """Prefill ``tokens[:, :prompt]``, then ``decode`` greedy tokens.  Returns
    (generated ids (B, decode), stats): the first id comes from the prefill
    logits, each later one from a decode step.  The prefill leaves room in
    the cache for ``decode`` positions."""
    dev = tokens.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    logits, cache = make_prefill(cfg, prompt, room=decode)(
        params, {"tokens": tokens[:, :prompt]})
    tok = logits.argmax(-1)
    sync()
    t_prefill = time.perf_counter() - t0
    step = make_decode_step(cfg)
    outs = [tok]
    sync()
    t0 = time.perf_counter()
    for _ in range(decode - 1):
        logits, cache = step(params, cache, tok)
        tok = logits.argmax(-1)
        outs.append(tok)
    sync()
    t_decode = time.perf_counter() - t0
    n_dec = tokens.shape[0] * (decode - 1)
    return torch.stack(outs, 1), {
        "prefill_ms": t_prefill * 1e3, "decode_ms": t_decode * 1e3,
        "decode_tokens": n_dec,
        "decode_tok_per_s": n_dec / t_decode if t_decode > 0 else None,
        "cache": cache, "last_logits": logits}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg, params = build(args.arch, smoke=args.smoke, device=args.device)
    tokens = prompt_batch(cfg, args.batch, args.prompt, args.decode,
                          device=args.device)
    ids, st = serve(cfg, params, tokens, args.prompt, args.decode)
    print(f"prefill: {args.batch}x{args.prompt} tokens in "
          f"{st['prefill_ms']:.1f} ms")
    print(f"decode: {st['decode_tokens']} tokens in {st['decode_ms']:.1f} ms "
          f"({st['decode_tok_per_s'] or 0:.1f} tok/s greedy)")
    print("sample continuation ids:", ids[0][:12].tolist())
    return ids


if __name__ == "__main__":
    main()
