"""The embedding table's two uses: the token lookup (a row gather, with
gemma's sqrt(d_model) scale) and the LM head (counterpart of
``repro/models/embedding.py``).

The table is a remote data structure sharded over the ``model`` axis: each
rank owns a contiguous vocab range (Storm's contiguous region).
:func:`embed_lookup` takes a rank's vocab block and its batch block of
tokens and has the reference's two sharded access modes:

  * "rpc": every rank looks up the ids it owns (the handler), the others
    give zeros, and an all-reduce (SUM) over the ``model`` group combines
    them: compute at the data, one all-reduce of (B_loc, S, d).
  * "onesided": all-gather the vocab blocks to the requester and gather
    rows locally: data to compute.  Only wins for tiny tables (cost_model).

One device, a vocab that the ``model`` axis does not divide, or rules that
give the vocab no axis take the plain gather, as in the reference.  Both
modes' collectives go through the ``Topology``, so they are differentiable
under autograd (the all-gather's backward a reduce-scatter, the
all-reduce's an all-reduce).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core import cost_model
from repro_torch.models import layers as L
from repro_torch.parallel.sharding import ONE_DEVICE, Topology

# float32 elements of the LM head's table converted at once (512 MiB): the
# head never holds a float32 copy of a whole table (gemma2-27b's would be
# 4.7 GB); zamba2's and mamba2's tables fit one block
LM_HEAD_ELEMS = 2**27


def embed_lookup(topo: Topology, table: torch.Tensor, tokens: torch.Tensor,
                 mode: str = "auto", *, vocab: Optional[int] = None):
    """table: this rank's block of a (vocab, d) table under
    ``topo.spec_for((vocab, d), ("vocab", None))``; ``vocab`` is the whole
    table's row count (None: ``table`` is the whole table).  tokens: this
    rank's (B_loc, S) block of a batch split over every batch axis of the
    mesh.  Returns (B_loc, S, d), the same on every rank of the ``model``
    group."""
    V = table.shape[0] if vocab is None else vocab
    d = table.shape[1]
    tp = topo.axis_sizes.get("model", 1)
    if tp == 1 or V % tp != 0 or not topo._mesh_axes_for("vocab", V):
        return table[tokens.long()]
    if table.shape[0] != V // tp:
        raise ValueError(f"a vocab block of {V} rows over {tp} ranks has "
                         f"{V // tp} rows, got {table.shape[0]}")
    if mode == "auto":
        # the whole batch's tokens (the reference's size(tokens))
        global_tokens = tokens.numel() * topo._prod(
            a for a in topo.rules.get("batch", ()) if a in topo.axis_sizes)
        mode = cost_model.embedding_lookup_choice(
            tokens_per_shard=global_tokens // max(
                topo.axis_sizes.get("data", 1), 1),
            d_model=d, vocab=V, shards=tp).mode
    ids = tokens.long()
    if mode == "onesided":
        return topo.gather(table, 0, "model")[ids]
    vs = V // tp
    ids = ids - topo.axis_index("model") * vs
    ok = (ids >= 0) & (ids < vs)
    rows = table[ids.clamp(0, vs - 1)]
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))
    return topo.all_reduce(rows, "model")


def embed(cfg, table, tokens, topo: Topology = ONE_DEVICE):
    """The lookup, times sqrt(d_model) where ``cfg.embed_scale``: the factor
    is rounded to the table's dtype first, as the reference rounds it
    (sqrt(4608) = 67.88 is 68.0 in bf16).  On a mesh ``table`` is the
    rank's vocab block and ``tokens`` its batch block."""
    h = embed_lookup(topo, table, tokens, vocab=cfg.vocab_padded)
    if cfg.embed_scale:
        h = h * torch.tensor(float(np.sqrt(cfg.d_model)), dtype=h.dtype,
                             device=h.device)
    return h


def vocab_block(cfg, topo: Topology):
    """(first row, rows) of this rank's block of the (V_padded, d) table."""
    V = cfg.vocab_padded
    return topo.extent(topo.spec_for((V, cfg.d_model), ("vocab", None))[0],
                       V)


def lm_head(cfg, table, h, offset: int = 0):
    """The LM head of normed h (..., d) over ``table`` (V_r, d), rows
    ``offset`` on of the (V_padded, d) table, in float32,
    ``logit_softcap``, and the padded vocab tail masked by global index ->
    (..., V_r) float32.  The table goes to float32 LM_HEAD_ELEMS at a
    time."""
    h = h.float()
    V, d = table.shape
    out = torch.empty(h.shape[:-1] + (V,), dtype=torch.float32,
                      device=h.device)
    rows = max(1, LM_HEAD_ELEMS // d)
    for i in range(0, V, rows):
        out[..., i:i + rows] = h @ table[i:i + rows].float().T
    return L.mask_pad_logits(L.softcap(out, cfg.logit_softcap),
                             cfg.vocab_size, offset)


def logits_of(cfg, params, h, topo: Topology = ONE_DEVICE):
    """Final norm, then :func:`lm_head` over the untied ``lm_head`` where the
    config has one, else the embedding.  h (..., d) -> (..., V_padded)
    float32; on a mesh the rank's vocab block (..., V_padded / tp) where the
    rules split the vocab (the reference's vocab-sharded logits)."""
    return lm_head(cfg, params.get("lm_head", params["embed"]),
                   L.rms_norm(h, params["final_norm"]),
                   vocab_block(cfg, topo)[0])


def greedy(cfg, logits, topo: Topology = ONE_DEVICE):
    """Greedy tokens (...,) int64 from logits (..., V_r), the rank's vocab
    block (:func:`vocab_argmax`)."""
    lo, n = vocab_block(cfg, topo)
    if n == cfg.vocab_padded:
        return logits.argmax(-1)
    e = topo.spec_for((cfg.vocab_padded, cfg.d_model), ("vocab", None))[0]
    return vocab_argmax(topo, logits, e, lo)


def vocab_argmax(topo: Topology, logits, entry, lo: int):
    """The global argmax (...,) int64 of vocab-sharded logits (..., V_r),
    the rank's columns from ``lo`` on under the vocab's ``spec_for`` entry:
    each rank's largest value and its first index, all-gathered over the
    entry's axes, the largest of those with ties to the lowest global index
    (``jnp.argmax``'s order)."""
    idx = logits.argmax(-1, keepdim=True)
    # value and global index side by side in float64 (both exact), one
    # all-gather
    both = torch.cat([logits.gather(-1, idx).double(), (idx + lo).double()],
                     -1)[None]
    both = topo.gather(both, 0, entry)            # (tp, ..., 2) rank order
    best = both[..., 0].argmax(0, keepdim=True)
    return both[..., 1].gather(0, best)[0].long()
