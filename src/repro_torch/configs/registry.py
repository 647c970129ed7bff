"""The architectures the port can serve.  The JAX package registers ten;
the others wait in ROADMAP.md's queue of model families."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import zamba2_1p2b
from repro_torch.configs.base import ModelConfig

ARCHS: Dict[str, ModelConfig] = {zamba2_1p2b.CONFIG.name: zamba2_1p2b.CONFIG}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (the port serves {sorted(ARCHS)}); "
            "the other families wait in ROADMAP.md's queue of model families")
    return ARCHS[name]
