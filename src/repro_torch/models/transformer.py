"""Decoder-only LM, dense and MoE (``repro/models/transformer.py``):
parameter specs, the attention block (prefill attention through the
``flash_attention`` kernel), the FFN block (SwiGLU, or the routed experts of
``models/moe.py`` with their shared experts), the decoder layer and the
forward pass, with gemma2's local/global alternation, GQA, qkv bias,
post-norms and softcaps.  The zamba2 shared block is one such decoder layer.
Head padding and rematerialisation are not on the port's path, and neither
is the reference's ``RunOptions``: its attention tiles are the kernel's own.
On one device every head is local (the reference's ``head_tp``,
``tp == 1``), so the padded and sequence-parallel branches wait for the mesh
slice."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed, logits_of
from repro_torch.models.moe import moe_ffn
from repro_torch.parallel.sharding import ParamSpec as PS


def layer_param_specs(cfg: ModelConfig, n_layers: Optional[int] = None,
                      stacked: bool = True):
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
    }
    f = cfg.d_ff
    if cfg.is_moe:
        E = cfg.n_experts
        p["router"] = PS(Ld + (d, E), "scaled")
        p["we_gate"] = PS(Ld + (E, d, f), "scaled")
        p["we_up"] = PS(Ld + (E, d, f), "scaled")
        p["we_down"] = PS(Ld + (E, f, d), "scaled")
        if cfg.n_shared_experts:
            sf = cfg.n_shared_experts * f
            p["ws_gate"] = PS(Ld + (d, sf), "scaled")
            p["ws_up"] = PS(Ld + (d, sf), "scaled")
            p["ws_down"] = PS(Ld + (sf, d), "scaled")
    else:
        p["w_gate"] = PS(Ld + (d, f), "scaled")
        p["w_up"] = PS(Ld + (d, f), "scaled")
        p["w_down"] = PS(Ld + (f, d), "scaled")
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
    """h (B, S, d) plus the FFN of its norm: SwiGLU, or the routed experts
    over the B x S tokens plus the shared experts' SwiGLU, added in h's
    dtype.  The decode step calls it on (B, 1, d), so its B tokens are
    routed together."""
    hn = L.rms_norm(h, p["mlp_norm"])
    if cfg.is_moe:
        out = moe_ffn(cfg, hn, p["router"], p["we_gate"], p["we_up"],
                      p["we_down"])
        if cfg.n_shared_experts:
            out = out + L.swiglu(hn, p["ws_gate"], p["ws_up"], p["ws_down"])
    else:
        out = L.swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
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
