"""Family dispatcher (counterpart of ``repro/models/api.py``).  The port
serves the ``hybrid`` family (zamba2); the others raise and wait in
ROADMAP.md's queue of model families."""
from __future__ import annotations

from typing import Any, Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.models import zamba


def require_hybrid(cfg: ModelConfig):
    """Raise for a family the port does not serve yet."""
    if cfg.family != "hybrid":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: it waits "
            "in ROADMAP.md's queue of model families")


def param_specs(cfg: ModelConfig):
    require_hybrid(cfg)
    return zamba.param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict[str, Any]):
    """batch {"tokens": (B, S)} -> logits (B, S, V_padded) float32."""
    require_hybrid(cfg)
    return zamba.forward(cfg, params, batch["tokens"])
