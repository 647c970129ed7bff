"""Family dispatcher (counterpart of ``repro/models/api.py``).  The port
serves the ``dense`` and ``moe`` (transformer), ``ssm`` (mamba2) and
``hybrid`` (zamba) families; ``vlm`` and ``audio`` raise and wait in
ROADMAP.md's queue of model families."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import mamba2, transformer, zamba

FAMILIES = {"dense": transformer, "moe": transformer, "ssm": mamba2,
            "hybrid": zamba}


def require_served(cfg: ModelConfig):
    """Raise for a family the port does not serve yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it waits "
            "in ROADMAP.md's queue of model families")


def param_specs(cfg: ModelConfig):
    require_served(cfg)
    return FAMILIES[cfg.family].param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any]):
    """batch {"tokens": (B, S)} -> logits (B, S, V_padded) float32."""
    require_served(cfg)
    return FAMILIES[cfg.family].forward(cfg, params, batch["tokens"])
