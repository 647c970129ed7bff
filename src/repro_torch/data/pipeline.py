"""Deterministic synthetic batches (counterpart of ``repro/data/pipeline.py``):
a pure function of (seed, step), made with numpy exactly as the JAX package
makes them, the audio family's frames and the VLM family's patch
embeddings included; ``batch_specs`` gives the dry run's batch shapes."""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    ngram: int = 8          # period of the learnable repetition


def _mix(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> 16)) * np.uint64(0x85EBCA6B)
    x = (x ^ (x >> 13)) * np.uint64(0xC2B2AE35)
    return x ^ (x >> 16)


def synthetic_tokens(dc: DataConfig, step: int, batch: int, seq: int,
                     vocab: int) -> np.ndarray:
    b = np.arange(batch, dtype=np.uint64)[:, None]
    s = np.arange(seq, dtype=np.uint64)[None, :]
    base = _mix(np.uint64(dc.seed) * np.uint64(1_000_003)
                + np.uint64(step) * np.uint64(65_537) + b * np.uint64(131)
                + (s // np.uint64(dc.ngram)))
    tok = (base + s % np.uint64(dc.ngram)) % np.uint64(max(vocab - 2, 1))
    return tok.astype(np.int32) + 1          # avoid 0 (pad id)


def _stub_embeds(seed: int, rows: int, n: int, d: int) -> torch.Tensor:
    """randn (rows, n, d) x 0.02 from RandomState(seed) in float32, rounded
    to bf16 (the reference's stub frontends)."""
    x = np.random.RandomState(seed).randn(rows, n, d).astype(np.float32)
    return torch.from_numpy(x * 0.02).to(torch.bfloat16)


def synthetic_batch(cfg: ModelConfig, shape: ShapeConfig, dc: DataConfig,
                    step: int, device="cuda") -> Dict[str, torch.Tensor]:
    """{"tokens", "labels"}: (B, S) int64 on ``device``; for the audio family
    also "frames" (B, encoder_seq, d), for the VLM family "patch_embeds"
    (B, min(n_patches, S), d), both bf16."""
    toks = synthetic_tokens(dc, step, shape.global_batch, shape.seq_len + 1,
                            cfg.vocab_size)
    dev = resolve_device(device)
    t = torch.from_numpy(toks.astype(np.int64)).to(dev)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    B, d = shape.global_batch, cfg.d_model
    if cfg.family == "audio":
        batch["frames"] = _stub_embeds(dc.seed * 7919 + step, B,
                                       cfg.encoder_seq, d).to(dev)
    if cfg.family == "vlm":
        batch["patch_embeds"] = _stub_embeds(
            dc.seed * 104729 + step, B, min(cfg.n_patches, shape.seq_len),
            d).to(dev)
    return batch


def batch_specs(cfg: ModelConfig, shape: ShapeConfig):
    """{name: (shape, dtype)} of the dry run's batch for ``shape``
    (tokens, labels for training, frames or patch embeddings where the
    family takes them): the reference's ShapeDtypeStructs."""
    B, S = shape.global_batch, shape.seq_len
    specs = {"tokens": ((B, S), torch.int32)}
    if shape.kind == "train":
        specs["labels"] = ((B, S), torch.int32)
    if cfg.family == "audio":
        specs["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
    if cfg.family == "vlm":
        specs["patch_embeds"] = ((B, min(cfg.n_patches, S), cfg.d_model),
                                 torch.bfloat16)
    return specs
