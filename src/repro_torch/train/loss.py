"""Language-model cross-entropy (counterpart of ``repro/train/loss.py``):
a float32 logsumexp, the target logit by a gather (the reference's iota
compare picks the same element), and an optional mask over positions."""
from __future__ import annotations

import torch


def lm_loss(logits, labels, mask=None):
    """logits (B, S, V); labels (B, S) int.  Returns (loss, metrics) with
    metrics {"loss", "accuracy", "tokens"}, all 0-d float32 tensors."""
    B, S, V = logits.shape
    logits = logits.float()
    m = logits.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(logits - m).sum(-1)) + m[..., 0]
    tgt = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - tgt
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=logits.device)
    mask = mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    # argmax takes the first of equal maxima, as jnp.argmax does
    hit = (logits.argmax(-1) == labels).float()
    acc = (hit * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
