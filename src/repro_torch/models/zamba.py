"""Zamba2-style hybrid (arXiv:2411.15242): counterpart of
``repro/models/zamba.py``.  A Mamba2 backbone, and ONE shared transformer
block (attention + MLP, a single weight copy) applied after every
``shared_attn_every``-th Mamba layer; the layers past the last whole group
(``tail_layers``) run after it.  As in the JAX package the shared block acts
on the residual stream directly (no concatenated embedding, no LoRA deltas).

The functions take the parameter tree as nested dicts of tensors, the JAX
package's tree, so ``convert.params_from_numpy`` carries its weights over
unchanged.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.embedding import embed, logits_of
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS, Topology


def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, d_ff=cfg.shared_d_ff, n_experts=0,
                               local_global_pattern=0, qkv_bias=False,
                               post_norms=False)


def n_scan_layers(cfg: ModelConfig) -> int:
    """Mamba layers in whole groups of ``shared_attn_every``."""
    return (cfg.n_layers // cfg.shared_attn_every) * cfg.shared_attn_every


def param_specs(cfg: ModelConfig):
    n_scan = n_scan_layers(cfg)
    tree = {
        "embed": PS((cfg.vocab_padded, cfg.d_model), ("vocab", None), "normal"),
        "final_norm": PS((cfg.d_model,), (None,), "ones"),
        "layers": M.mamba_layer_specs(cfg, n_layers=n_scan),
        "shared": T.layer_param_specs(_shared_cfg(cfg), stacked=False),
    }
    if cfg.n_layers > n_scan:
        tree["tail_layers"] = M.mamba_layer_specs(cfg,
                                                  n_layers=cfg.n_layers - n_scan)
    return tree


def shared_block(cfg: ModelConfig, p, h, cos, sin, opts=None,
                 topo: Topology = ONE_DEVICE):
    """The shared transformer block on h (B, S, d): on a mesh the rank's
    blocks of its weights, in the attention branch ``attention_branch``
    picks for its heads (``transformer.decoder_layer``; as in the
    reference, without ``pad_heads``)."""
    opts = opts or T.RunOptions()
    return T.decoder_layer(_shared_cfg(cfg), topo, p, h, cos, sin,
                           local=False,
                           q_block=opts.q_block, kv_block=opts.kv_block)


def forward(cfg: ModelConfig, params, tokens, opts=None,
            topo: Topology = ONE_DEVICE):
    """tokens (B, S) -> logits (B, S, V_padded) float32.  As in the
    reference, a group of ``shared_attn_every`` Mamba layers and the shared
    block is one rematerialised body, and each tail layer another.  On a
    mesh the rank's blocks in and its logits block (B_r, S, V_padded / tp)
    out."""
    opts = opts or T.RunOptions()
    S = tokens.shape[1]
    k = cfg.shared_attn_every
    h = embed(cfg, params["embed"], tokens, topo)
    pos = torch.arange(S, device=tokens.device)
    cos, sin = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    scan = L.layers(params["layers"])

    def group(hh, first):
        for p in scan[first:first + k]:
            hh, _ = M.mamba_block(cfg, p, hh, topo=topo)
        return shared_block(cfg, params["shared"], hh, cos, sin, opts, topo)
    body = T.maybe_remat(group, opts)
    for first in range(0, n_scan_layers(cfg), k):
        h = body(h, first)
    if "tail_layers" in params:
        tail = T.maybe_remat(
            lambda hh, p: M.mamba_block(cfg, p, hh, topo=topo)[0], opts)
        for p in L.layers(params["tail_layers"]):
            h = tail(h, p)
    return logits_of(cfg, params, h, topo)
