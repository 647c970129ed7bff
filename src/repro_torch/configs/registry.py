"""The ten architectures of the JAX package's registry, every family: dense,
MoE, pure-SSM, hybrid, audio (encoder-decoder) and VLM."""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import (deepseek_moe_16b, gemma2_27b, glm4_9b,
                                 granite_moe_1b_a400m, llava_next_mistral_7b,
                                 mamba2_780m, qwen15_4b, qwen25_32b,
                                 whisper_medium, zamba2_1p2b)
from repro_torch.configs.base import ModelConfig

_MODULES = [gemma2_27b, qwen25_32b, qwen15_4b, glm4_9b, granite_moe_1b_a400m,
            deepseek_moe_16b, mamba2_780m, zamba2_1p2b, whisper_medium,
            llava_next_mistral_7b]

ARCHS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]
