"""Prefill (the hybrid part of ``repro/serving/prefill.py``): the forward
pass over the prompt, emitting each Mamba layer's conv tails and final SSM
state and each shared-block application's K/V rows into the cache, with the
LM head on the last position only."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models.api import require_hybrid
from repro_torch.models.embedding import embed_lookup
from repro_torch.models.zamba import _shared_cfg, layer, logits_of, n_scan_layers
from repro_torch.serving.decode import SSM_CACHE


def _attn_with_cache(cfg, p, h, cos, sin, *, window):
    """The attention block, also returning its (B, S, Hkv, hd) K/V rows."""
    return T.attention_block(cfg, p, h, cos, sin, window=window,
                             return_kv=True)


def _hybrid_prefill(cfg: ModelConfig, S, params, batch):
    tokens = batch["tokens"]
    B = tokens.shape[0]
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    h = embed_lookup(params["embed"], tokens)
    pos = torch.arange(S, device=tokens.device)
    cos, sin = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    scfg = _shared_cfg(cfg)
    K, di = cfg.conv_width, cfg.d_inner
    GN = cfg.ssm_groups * cfg.ssm_state
    new = {n: [] for n in SSM_CACHE}
    shared_k, shared_v = [], []

    def ssm_layer(h, p):
        zc = lambda C: torch.zeros((B, K - 1, C), dtype=h.dtype,
                                   device=h.device)
        h, (ncs, nst) = M.mamba_block(cfg, p, h, conv_state=(zc(di), zc(GN),
                                                             zc(GN)),
                                      ssm_state=None)
        for n, t in zip(SSM_CACHE, (*ncs, nst)):
            new[n].append(t)
        return h

    for i in range(n_scan):
        h = ssm_layer(h, layer(params["layers"], i))
        if i % k == k - 1:
            h, sk, sv = _attn_with_cache(scfg, params["shared"], h, cos, sin,
                                         window=None)
            h = T.ffn_block(scfg, params["shared"], h)
            shared_k.append(sk)
            shared_v.append(sv)
    for i in range(cfg.n_layers - n_scan):
        h = ssm_layer(h, layer(params["tail_layers"], i))

    cache = {n: torch.stack(new[n]) for n in SSM_CACHE}
    cache["shared_k"] = torch.stack(shared_k)
    cache["shared_v"] = torch.stack(shared_v)
    cache["len"] = torch.full((B,), S, dtype=torch.int32, device=h.device)
    return logits_of(cfg, params, h[:, -1]), cache


def prefill_fn(cfg: ModelConfig, S: int, params, batch):
    require_hybrid(cfg)
    return _hybrid_prefill(cfg, S, params, batch)
