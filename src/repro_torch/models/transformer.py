"""Decoder-only dense LM (the dense part of ``repro/models/transformer.py``):
parameter specs, the attention block (prefill attention through the
``flash_attention`` kernel), the SwiGLU FFN block, the decoder layer and the
forward pass, with gemma2's local/global alternation, GQA, qkv bias,
post-norms and softcaps.  The zamba2 shared block is one such decoder layer.
MoE, head padding and rematerialisation are not on the port's path, and
neither is the reference's ``RunOptions``: its attention tiles are the
kernel's own.  On one device every head is local (the reference's
``head_tp``, ``tp == 1``), so the padded and sequence-parallel branches
wait for the mesh slice."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed, logits_of
from repro_torch.parallel.sharding import ParamSpec as PS


def layer_param_specs(cfg: ModelConfig, n_layers: Optional[int] = None,
                      stacked: bool = True):
    if cfg.is_moe:
        raise NotImplementedError("MoE layers are not ported yet (ROADMAP.md)")
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    Ld = (n_layers if n_layers is not None else cfg.n_layers,) if stacked else ()
    p = {
        "attn_norm": PS(Ld + (d,), "ones"),
        "wq": PS(Ld + (d, qd), "scaled"),
        "wk": PS(Ld + (d, kvd), "scaled"),
        "wv": PS(Ld + (d, kvd), "scaled"),
        "wo": PS(Ld + (qd, d), "scaled"),
        "mlp_norm": PS(Ld + (d,), "ones"),
        "w_gate": PS(Ld + (d, cfg.d_ff), "scaled"),
        "w_up": PS(Ld + (d, cfg.d_ff), "scaled"),
        "w_down": PS(Ld + (cfg.d_ff, d), "scaled"),
    }
    if cfg.qkv_bias:
        p["bq"] = PS(Ld + (qd,), "zeros")
        p["bk"] = PS(Ld + (kvd,), "zeros")
        p["bv"] = PS(Ld + (kvd,), "zeros")
    if cfg.post_norms:
        p["attn_post_norm"] = PS(Ld + (d,), "ones")
        p["mlp_post_norm"] = PS(Ld + (d,), "ones")
    return p


def param_specs(cfg: ModelConfig):
    """The whole tree: embedding, final norm, the stacked layers, and an LM
    head where the embeddings are not tied (qwen2.5-32b)."""
    tree = {
        "embed": PS((cfg.vocab_padded, cfg.d_model), "normal"),
        "final_norm": PS((cfg.d_model,), "ones"),
        "layers": layer_param_specs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = PS((cfg.vocab_padded, cfg.d_model), "normal")
    return tree


def is_local(cfg: ModelConfig, i: int) -> bool:
    """Does layer ``i`` take the sliding window?  Layer 0 of each group of
    ``local_global_pattern`` layers does, where the pattern is 2 (gemma2:
    local, global, local, ...)."""
    return cfg.local_global_pattern == 2 and i % 2 == 0


def qkv(cfg: ModelConfig, p, h, cos, sin):
    """Normed projections with RoPE: h (B, S, d) -> q (B, S, Hq, hd), k and v
    (B, S, Hkv, hd)."""
    B, S, _ = h.shape
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hn = L.rms_norm(h, p["attn_norm"])
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = L.apply_rope(q.reshape(B, S, Hq, hd), cos, sin)
    k = L.apply_rope(k.reshape(B, S, Hkv, hd), cos, sin)
    return q, k, v.reshape(B, S, Hkv, hd)


def attention_out(cfg: ModelConfig, p, h, att):
    """Residual add of the output projection of att (B, S, Hq, hd)."""
    B, S = att.shape[:2]
    o = att.reshape(B, S, cfg.n_heads * cfg.head_dim) @ p["wo"]
    if cfg.post_norms:
        o = L.rms_norm(o, p["attn_post_norm"])
    return h + o


def attention_block(cfg: ModelConfig, p, h, cos, sin, *,
                    window: Optional[int], return_kv: bool = False):
    """Causal self-attention block; with ``return_kv`` also the (B, S, Hkv,
    hd) K and V rows for the serving cache."""
    q, k, v = qkv(cfg, p, h, cos, sin)
    att = L.block_attention(q, k, v, causal=True, window=window,
                            attn_softcap=cfg.attn_softcap)
    h = attention_out(cfg, p, h, att)
    return (h, k, v) if return_kv else h


def ffn_block(cfg: ModelConfig, p, h):
    out = L.swiglu(L.rms_norm(h, p["mlp_norm"]), p["w_gate"], p["w_up"],
                   p["w_down"])
    if cfg.post_norms:
        out = L.rms_norm(out, p["mlp_post_norm"])
    return h + out


def decoder_layer(cfg: ModelConfig, p, h, cos, sin, *, local: bool):
    window = cfg.sliding_window if local else None
    h = attention_block(cfg, p, h, cos, sin, window=window)
    return ffn_block(cfg, p, h)


def forward(cfg: ModelConfig, params, tokens):
    """tokens (B, S) -> logits (B, S, V_padded) float32."""
    g = max(1, cfg.local_global_pattern)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {g}")
    h = embed(cfg, params["embed"], tokens)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        h = decoder_layer(cfg, L.layer(params["layers"], i), h, cos, sin,
                          local=is_local(cfg, i))
    return logits_of(cfg, params, h)
