"""Language-model cross-entropy (counterpart of ``repro/train/loss.py``):
a float32 logsumexp, the target logit by a gather (the reference's iota
compare picks the same element), and an optional mask over positions.

On a mesh (``topo``) the logits are the rank's vocab block of its batch
block, as ``embedding.logits_of`` gives them, and every metric is the
global batch's, the same on every rank: the logsumexp runs over the vocab
blocks (the largest logit all-reduced with MAX, outside the graph, then the
sum of exponentials all-reduced), the target logit comes from the rank
that owns its column, the argmax takes the first of equal maxima by global
index, and the sums of the loss, the hits and the mask are all-reduced
over the batch axes.  Every SUM is a differentiable ``Topology.all_reduce``,
so the loss is the global loss on every rank, with its gradient."""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.embedding import vocab_argmax


def lm_loss(logits, labels, mask=None, *, topo=None, vocab=None):
    """logits (B, S, V) (on a mesh ``topo`` the rank's (B_r, S, V_r)
    block, ``vocab`` the whole padded vocab V); labels (B, S) int.  Returns
    (loss, metrics) with metrics {"loss", "accuracy", "tokens"}, all 0-d
    float32 tensors."""
    if topo is not None and topo.sharded():
        return _mesh_loss(logits, labels, mask, topo, vocab)
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


def _mesh_loss(logits, labels, mask, topo, vocab):
    if vocab is None:
        raise ValueError("lm_loss on a mesh needs the whole vocab (vocab=)")
    ev = topo.spec_for((vocab,), ("vocab",))[0]
    lo, n = topo.extent(ev, vocab)
    B, S, Vr = logits.shape
    if Vr != n:
        raise ValueError(f"logits of {Vr} columns; the rank's vocab block "
                         f"is {n}")
    eb = topo.batch_axes()
    logits = logits.float()
    with torch.no_grad():
        m = topo.all_reduce(logits.amax(-1, keepdim=True), ev,
                            op=dist.ReduceOp.MAX)
    lse = torch.log(topo.all_reduce(torch.exp(logits - m).sum(-1), ev)) \
        + m[..., 0]
    ids = labels.long() - lo
    own = (ids >= 0) & (ids < Vr)
    tgt = logits.gather(-1, ids.clamp(0, Vr - 1)[..., None])[..., 0]
    tgt = topo.all_reduce(torch.where(own, tgt, torch.zeros_like(tgt)), ev)
    nll = lse - tgt
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=logits.device)
    mask = mask.float()
    with torch.no_grad():
        denom = torch.clamp(topo.all_reduce(mask.sum(), eb), min=1.0)
        hit = (vocab_argmax(topo, logits, ev, lo) == labels).float()
        acc = topo.all_reduce((hit * mask).sum(), eb) / denom
    loss = topo.all_reduce((nll * mask).sum(), eb) / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}
