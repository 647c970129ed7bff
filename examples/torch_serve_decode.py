"""Serving scenario: batched prefill + continuous greedy decode with the
Storm-hybrid KV cache, across three architecture families, on the PyTorch
port (the counterpart of ``examples/serve_decode.py``, the same constants,
flow and printed line an arch).

The reference pads its K/V cache by DECODE positions after the prefill; the
port's prefill allocates that room once (``make_prefill(cfg, S,
room=DECODE)``) and each decode step writes the cache in place.  The
reference's ``RunOptions`` tiles its jnp attention; the port's prefill runs
the ``flash_attention`` kernel on the card (granite's layers, whisper's
three attentions) and ``ssd_scan`` (mamba2's layers), which keep their own
tiles, so it takes none.  Times end in a synchronise.  Weights are drawn
from a torch generator seeded 0 (``serve(..., params=)`` takes others, e.g.
the reference's, carried across with ``repro_torch.convert``).

    PYTHONPATH=src python examples/torch_serve_decode.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch.configs import ShapeConfig
from repro_torch.configs.registry import get
from repro_torch.data.pipeline import DataConfig, synthetic_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.models import api
from repro_torch.parallel.sharding import SERVE_RULES, Topology, init_params
from repro_torch.serving.decode import kv_mode, make_decode_step, make_prefill

PROMPT, DECODE, B = 32, 12, 2
ARCHS = ("granite-moe-1b-a400m", "mamba2-780m", "whisper-medium")


def serve(arch: str, device="cuda", params=None):
    """Prefill PROMPT tokens of B rows, then DECODE - 1 greedy steps, and
    print the arch's line.  Returns {"line", "ids" (B, DECODE) numpy,
    "logits" (each step's (B, V_padded) on the CPU), "prefill_ms",
    "tok_s"}."""
    dev = resolve_device(device)
    cfg = get(arch).smoke()
    topo = Topology(make_smoke_mesh(dev), dict(SERVE_RULES))
    if params is None:
        params = init_params(api.param_specs(cfg),
                             torch.Generator().manual_seed(0), dev)
    batch = synthetic_batch(cfg, ShapeConfig("s", PROMPT + DECODE, B, "train"),
                            DataConfig(), 0, device=dev)
    pre = {k: (v[:, :PROMPT] if k == "tokens" else v)
           for k, v in batch.items() if k != "labels"}
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    prefill = make_prefill(cfg, PROMPT, DECODE, topo)
    step = make_decode_step(cfg, topo)
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        logits, cache = prefill(params, pre)
        sync()
        t_pre = time.perf_counter() - t0
        tok = logits.argmax(-1)
        ids, seen = [tok], [logits.cpu()]
        t0 = time.perf_counter()
        for _ in range(DECODE - 1):
            logits, cache = step(params, cache, tok)
            tok = logits.argmax(-1)
            ids.append(tok)
            seen.append(logits.cpu())
        sync()
        t_dec = time.perf_counter() - t0
    ids = torch.stack(ids, 1).cpu().numpy()
    mode = ("attention-free" if cfg.family == "ssm"
            else f"KV {kv_mode(cfg, topo)}-mode")
    tok_s = B * (DECODE - 1) / max(t_dec, 1e-9)
    line = (f"{arch:26s} [{mode:14s}] prefill {t_pre*1e3:7.0f} ms, decode "
            f"{tok_s:6.1f} tok/s, continuation {ids[0][:6]}")
    print(line, flush=True)
    return {"line": line, "ids": ids, "logits": seen,
            "prefill_ms": t_pre * 1e3, "tok_s": tok_s}


def main(argv=None, device=None):
    """Serve the three archs on ``--device`` (default ``cuda``; ``device``
    overrides it): {arch: serve's result}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = device or ap.parse_args(argv).device
    return {arch: serve(arch, dev) for arch in ARCHS}


if __name__ == "__main__":
    main()
