"""Embedding lookup (the one-device branch of ``repro/models/embedding.py``:
a row gather).  The vocab-sharded one-sided and RPC branches wait for the
mesh-transport slice."""
from __future__ import annotations

import torch


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table (V, d); tokens (B, S) int -> (B, S, d)."""
    return table[tokens.long()]
