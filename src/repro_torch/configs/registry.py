"""The architectures the port can serve: the dense, pure-SSM and hybrid
families.  The JAX package registers ten; the MoE, audio and VLM ones wait
in ROADMAP.md's queue of model families."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (gemma2_27b, glm4_9b, mamba2_780m, qwen15_4b,
                                 qwen25_32b, zamba2_1p2b)
from repro_torch.configs.base import ModelConfig

_MODULES = [gemma2_27b, qwen25_32b, qwen15_4b, glm4_9b, mamba2_780m,
            zamba2_1p2b]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not ported yet (the port serves {sorted(ARCHS)}); "
            "the other families wait in ROADMAP.md's queue of model families")
    return ARCHS[name]
