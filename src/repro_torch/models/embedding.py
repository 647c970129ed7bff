"""The embedding table's two uses: the token lookup (the one-device branch
of ``repro/models/embedding.py``: a row gather, with gemma's sqrt(d_model)
scale) and the LM head.  The vocab-sharded one-sided and RPC branches wait
for the mesh-transport slice."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L

# float32 elements of the LM head's table converted at once (512 MiB): the
# head never holds a float32 copy of a whole table (gemma2-27b's would be
# 4.7 GB); zamba2's and mamba2's tables fit one block
LM_HEAD_ELEMS = 2**27


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table (V, d); tokens (B, S) int -> (B, S, d)."""
    return table[tokens.long()]


def embed(cfg, table, tokens):
    """The lookup, times sqrt(d_model) where ``cfg.embed_scale``: the factor
    is rounded to the table's dtype first, as the reference rounds it
    (sqrt(4608) = 67.88 is 68.0 in bf16)."""
    h = embed_lookup(table, tokens)
    if cfg.embed_scale:
        h = h * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=h.dtype,
                             device=h.device)
    return h


def lm_head(cfg, table, h):
    """The LM head of normed h (..., d) over ``table`` (V_padded, d) in
    float32, ``logit_softcap``, and the padded vocab tail masked ->
    (..., V_padded) float32.  The table goes to float32 LM_HEAD_ELEMS at a
    time."""
    h = h.float()
    V, d = table.shape
    out = torch.empty(h.shape[:-1] + (V,), dtype=torch.float32,
                      device=h.device)
    rows = max(1, LM_HEAD_ELEMS // d)
    for i in range(0, V, rows):
        out[..., i:i + rows] = h @ table[i:i + rows].float().T
    return L.mask_pad_logits(L.softcap(out, cfg.logit_softcap), cfg.vocab_size)


def logits_of(cfg, params, h):
    """Final norm, then :func:`lm_head` over the untied ``lm_head`` where the
    config has one, else the embedding.  h (..., d) -> (..., V_padded)
    float32."""
    return lm_head(cfg, params.get("lm_head", params["embed"]),
                   L.rms_norm(h, params["final_norm"]))
