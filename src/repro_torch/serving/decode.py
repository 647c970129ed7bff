"""Serving: the decode step and its cache (the hybrid part of
``repro/serving/decode.py``).

The cache holds, per Mamba layer, the conv tails (bf16) and the SSM state
(f32), and per application of the shared block its K/V rows.  On one device
every head is local (the reference's "heads" mode); the sequence-sharded
RPC mode (``_flash_decode_shardmap``) waits for the mesh slice.  The new
token's K/V is written at offset ``len`` of each row.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models.api import require_hybrid
from repro_torch.models.embedding import embed_lookup
from repro_torch.models.zamba import layer, logits_of, n_scan_layers

SSM_CACHE = ("conv_x", "conv_B", "conv_C", "ssm")


def cache_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Tuple]:
    """{name: (shape, dtype)} of the hybrid cache for B rows of S positions."""
    require_hybrid(cfg)
    nl, K = cfg.n_layers, cfg.conv_width
    GN = cfg.ssm_groups * cfg.ssm_state
    kv = (cfg.n_layers // cfg.shared_attn_every, B, S, cfg.n_kv_heads,
          cfg.head_dim)
    return {
        "len": ((B,), torch.int32),
        "conv_x": ((nl, B, K - 1, cfg.d_inner), torch.bfloat16),
        "conv_B": ((nl, B, K - 1, GN), torch.bfloat16),
        "conv_C": ((nl, B, K - 1, GN), torch.bfloat16),
        "ssm": ((nl, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                torch.float32),
        "shared_k": (kv, torch.bfloat16),
        "shared_v": (kv, torch.bfloat16),
    }


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda"):
    dev = resolve_device(device)
    return {k: torch.zeros(shp, dtype=dt, device=dev)
            for k, (shp, dt) in cache_specs(cfg, B, S).items()}


def grow_cache(cache, extra: int):
    """Room for ``extra`` more positions in the K/V regions (zeros)."""
    out = dict(cache)
    for n in ("shared_k", "shared_v"):
        out[n] = torch.nn.functional.pad(cache[n], (0, 0, 0, 0, 0, extra))
    return out


def append_kv(kc, vc, k_new, v_new, lens):
    """Write the new token's K/V (B, Hkv, hd) at offset ``lens`` of each row
    of kc/vc (B, S, Hkv, hd); returns new tensors."""
    rows = torch.arange(lens.shape[0], device=lens.device)
    kc, vc = kc.clone(), vc.clone()
    kc[rows, lens.long()] = k_new.to(kc.dtype)
    vc[rows, lens.long()] = v_new.to(vc.dtype)
    return kc, vc


def _rope_single(x, lens, theta):
    """x (B, H, hd) rotated at per-row positions lens (B,)."""
    cos, sin = L.rope_tables(lens, x.shape[-1], theta)
    return L.apply_rope(x[:, None], cos[:, None], sin[:, None])[:, 0]


def hybrid_decode_attention(cfg: ModelConfig, q, kc, vc, lens, *, window=None):
    """q (B, Hq, hd); kc/vc (B, S, Hkv, hd); lens (B,).  Every head is local
    on one device (the reference's "heads" mode)."""
    return L.decode_attention(q, kc, vc, lens, window=window,
                              attn_softcap=cfg.attn_softcap)


def _tf_decode_layer(cfg, p, h, kc, vc, lens, *, local: bool):
    """Dense decoder layer for one token.  h (B, d)."""
    B = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hn = L.rms_norm(h, p["attn_norm"])
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope_single(q.reshape(B, Hq, hd), lens, cfg.rope_theta)
    k = _rope_single(k.reshape(B, Hkv, hd), lens, cfg.rope_theta)
    kc, vc = append_kv(kc, vc, k, v.reshape(B, Hkv, hd), lens)
    window = cfg.sliding_window if local else None
    att = hybrid_decode_attention(cfg, q, kc, vc, lens + 1, window=window)
    o = att.reshape(B, Hq * hd) @ p["wo"]
    if cfg.post_norms:
        o = L.rms_norm(o, p["attn_post_norm"])
    h = h + o
    out = L.swiglu(L.rms_norm(h, p["mlp_norm"]), p["w_gate"], p["w_up"],
                   p["w_down"])
    if cfg.post_norms:
        out = L.rms_norm(out, p["mlp_post_norm"])
    return h + out, kc, vc


def _ssm_decode_layer(cfg, p, h, conv_x, conv_B, conv_C, ssm_st):
    h2, (ncs, nss) = M.mamba_block(cfg, p, h[:, None],
                                   conv_state=(conv_x, conv_B, conv_C),
                                   ssm_state=ssm_st, decode=True)
    return h2[:, 0], ncs, nss


def _shared_decode_block(cfg, p, h, kc, vc, lens):
    """The shared block for one token (the reference's decode flavour of its
    config, which agrees with ``zamba._shared_cfg`` for zamba2)."""
    scfg = dataclasses.replace(cfg, d_ff=cfg.shared_d_ff, n_experts=0,
                               qkv_bias=False, post_norms=False)
    return _tf_decode_layer(scfg, p, h, kc, vc, lens, local=False)


def _hybrid_decode(cfg: ModelConfig, params, cache, tokens):
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    lens = cache["len"]
    h = embed_lookup(params["embed"], tokens[:, None])[:, 0]
    new = {n: [] for n in SSM_CACHE}
    shared_k, shared_v = [], []

    def ssm_layer(h, p, i):
        h, (cx, cb, cc), st = _ssm_decode_layer(
            cfg, p, h, *(cache[n][i] for n in SSM_CACHE))
        for n, t in zip(SSM_CACHE, (cx, cb, cc, st)):
            new[n].append(t.to(cache[n].dtype))
        return h

    for i in range(n_scan):
        h = ssm_layer(h, layer(params["layers"], i), i)
        if i % k == k - 1:
            a = i // k
            h, kc, vc = _shared_decode_block(
                cfg, params["shared"], h, cache["shared_k"][a],
                cache["shared_v"][a], lens)
            shared_k.append(kc)
            shared_v.append(vc)
    for i in range(n_scan, cfg.n_layers):
        h = ssm_layer(h, layer(params["tail_layers"], i - n_scan), i)

    out = {n: torch.stack(new[n]) for n in SSM_CACHE}
    out["shared_k"] = torch.stack(shared_k)
    out["shared_v"] = torch.stack(shared_v)
    out["len"] = lens + 1
    return logits_of(cfg, params, h), out


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,)) -> (logits (B, V_padded) f32,
    new cache)."""
    require_hybrid(cfg)
    return partial(_hybrid_decode, cfg)


def make_prefill(cfg: ModelConfig, S: int):
    """prefill(params, batch) -> (last-position logits (B, V_padded), cache
    holding S positions)."""
    from repro_torch.serving.prefill import prefill_fn
    return partial(prefill_fn, cfg, S)
