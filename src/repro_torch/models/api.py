"""Family dispatcher (counterpart of ``repro/models/api.py``): ``dense``,
``moe`` and ``vlm`` (transformer), ``ssm`` (mamba2), ``hybrid`` (zamba) and
``audio`` (whisper).  Every family runs on a mesh."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, whisper, zamba
from repro_torch.parallel.sharding import ONE_DEVICE, Topology

FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
            "ssm": mamba2, "hybrid": zamba, "audio": whisper}


def param_specs(cfg: ModelConfig):
    return FAMILIES[cfg.family].param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any], *, opts=None,
            topo: Topology = ONE_DEVICE):
    """batch {"tokens": (B, S)}, with "frames" (audio) or "patch_embeds"
    (vlm) where the family takes them -> logits (B, S, V_padded) float32.
    ``opts``: ``transformer.RunOptions`` (tiles of the attention's backward,
    remat, ``pad_heads``, ``moe_mode``), the reference's default when None.
    On a mesh (``topo``) ``params`` and the batch are this rank's blocks
    and the logits its (B_r, S, V_padded / tp) block."""
    tokens = batch["tokens"]
    if cfg.family == "ssm":
        return mamba2.forward(cfg, params, tokens, opts=opts, topo=topo)
    if cfg.family == "hybrid":
        return zamba.forward(cfg, params, tokens, opts=opts, topo=topo)
    if cfg.family == "audio":
        return whisper.forward(cfg, params, tokens, frames=batch.get("frames"),
                               opts=opts, topo=topo)
    return transformer.forward(cfg, topo, params, tokens, opts=opts,
                               extra_embeds=batch.get("patch_embeds"))
