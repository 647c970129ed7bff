"""Serving: the decode step and its cache (counterpart of
``repro/serving/decode.py``).

The cache holds, per attention layer (dense, MoE, VLM and the audio
decoder) or per application of the shared block (hybrid), its K/V rows, per
Mamba layer the conv tails (bf16) and the SSM state (f32), and per audio
decoder layer the cross K/V over the encoder's frames, which decode only
reads.  On one device every head is local (the reference's "heads" mode);
the sequence-sharded RPC mode (``_flash_decode_shardmap``, the reference's
choice where the kv heads do not split over the model axis) waits for the
mesh slice.

A decode step writes into the cache it is given, in place, as XLA does the
reference's ``.at[].set``: the new token's K/V at offset ``len`` of each row,
each Mamba layer's new states over its old ones.  It returns the cache with
``len`` advanced; clone the tensors first to keep the old cache.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.embedding import embed, embed_lookup, logits_of
from repro_torch.models.zamba import _shared_cfg, n_scan_layers

SSM_CACHE = ("conv_x", "conv_B", "conv_C", "ssm")


def cache_specs(cfg: ModelConfig, B: int, S: int) -> Dict[str, Tuple]:
    """{name: (shape, dtype)} of the cache for B rows of S positions."""
    out: Dict[str, Tuple] = {"len": ((B,), torch.int32)}
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = (kv, torch.bfloat16)
        out["v"] = (kv, torch.bfloat16)
        if cfg.family == "audio":
            x = (cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
            out["xk"] = (x, torch.bfloat16)
            out["xv"] = (x, torch.bfloat16)
        return out
    nl, K = cfg.n_layers, cfg.conv_width
    GN = cfg.ssm_groups * cfg.ssm_state
    out["conv_x"] = ((nl, B, K - 1, cfg.d_inner), torch.bfloat16)
    out["conv_B"] = ((nl, B, K - 1, GN), torch.bfloat16)
    out["conv_C"] = ((nl, B, K - 1, GN), torch.bfloat16)
    out["ssm"] = ((nl, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                  torch.float32)
    if cfg.family == "hybrid":
        kv = (cfg.n_layers // cfg.shared_attn_every, B, S, cfg.n_kv_heads,
              cfg.head_dim)
        out["shared_k"] = (kv, torch.bfloat16)
        out["shared_v"] = (kv, torch.bfloat16)
    return out


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda"):
    dev = resolve_device(device)
    return {k: torch.zeros(shp, dtype=dt, device=dev)
            for k, (shp, dt) in cache_specs(cfg, B, S).items()}


def append_kv(kc, vc, k_new, v_new, lens):
    """Write the new token's K/V (B, Hkv, hd) at offset ``lens`` of each row
    of kc/vc (B, S, Hkv, hd), in place."""
    rows = torch.arange(lens.shape[0], device=lens.device)
    kc[rows, lens.long()] = k_new.to(kc.dtype)
    vc[rows, lens.long()] = v_new.to(vc.dtype)


def _rope_single(x, lens, theta):
    """x (B, H, hd) rotated at per-row positions lens (B,)."""
    cos, sin = L.rope_tables(lens, x.shape[-1], theta)
    return L.apply_rope(x[:, None], cos[:, None], sin[:, None])[:, 0]


def decode_attention(cfg: ModelConfig, q, kc, vc, lens, *, window=None):
    """q (B, Hq, hd); kc/vc (B, S, Hkv, hd); lens (B,).  Every head is local
    on one device (the reference's "heads" mode)."""
    return L.decode_attention(q, kc, vc, lens, window=window,
                              attn_softcap=cfg.attn_softcap)


def _tf_decode_layer(cfg, p, h, kc, vc, lens, *, local: bool):
    """Dense or MoE decoder layer for one token.  h (B, d); the token's K/V
    go into kc/vc at ``lens``.  The FFN is the prefill's
    (``transformer.ffn_block``) over the B tokens."""
    B = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hn = L.rms_norm(h, p["attn_norm"])
    q, k, v = hn @ p["wq"], hn @ p["wk"], hn @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = _rope_single(q.reshape(B, Hq, hd), lens, cfg.rope_theta)
    k = _rope_single(k.reshape(B, Hkv, hd), lens, cfg.rope_theta)
    append_kv(kc, vc, k, v.reshape(B, Hkv, hd), lens)
    window = cfg.sliding_window if local else None
    att = decode_attention(cfg, q, kc, vc, lens + 1, window=window)
    o = att.reshape(B, Hq * hd) @ p["wo"]
    if cfg.post_norms:
        o = L.rms_norm(o, p["attn_post_norm"])
    return T.ffn_block(cfg, p, (h + o)[:, None])[:, 0]


def _ssm_decode_layer(cfg, p, h, cache, i: int):
    """Mamba layer ``i`` for one token from its cached states, which it
    overwrites with the new ones.  h (B, d)."""
    h2, ((cx, cb, cc), st) = M.mamba_block(
        cfg, p, h[:, None], conv_state=tuple(cache[n][i] for n in SSM_CACHE[:3]),
        ssm_state=cache["ssm"][i], decode=True)
    for n, t in zip(SSM_CACHE, (cx, cb, cc, st)):
        cache[n][i].copy_(t)
    return h2[:, 0]


def _tf_decode(cfg: ModelConfig, params, cache, tokens):
    lens = cache["len"]
    h = embed(cfg, params["embed"], tokens[:, None])[:, 0]
    for i in range(cfg.n_layers):
        h = _tf_decode_layer(cfg, L.layer(params["layers"], i), h,
                             cache["k"][i], cache["v"][i], lens,
                             local=T.is_local(cfg, i))
    return logits_of(cfg, params, h), dict(cache, len=lens + 1)


def _ssm_decode(cfg: ModelConfig, params, cache, tokens):
    h = embed_lookup(params["embed"], tokens[:, None])[:, 0]
    for i in range(cfg.n_layers):
        h = _ssm_decode_layer(cfg, L.layer(params["layers"], i), h, cache, i)
    return logits_of(cfg, params, h), dict(cache, len=cache["len"] + 1)


def _hybrid_decode(cfg: ModelConfig, params, cache, tokens):
    """The shared block runs in its decode flavour (the reference's
    ``_shared_decode_block``, whose config agrees with ``_shared_cfg``)."""
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    lens = cache["len"]
    scfg = _shared_cfg(cfg)
    h = embed_lookup(params["embed"], tokens[:, None])[:, 0]
    for i in range(n_scan):
        h = _ssm_decode_layer(cfg, L.layer(params["layers"], i), h, cache, i)
        if i % k == k - 1:
            a = i // k
            h = _tf_decode_layer(scfg, params["shared"], h,
                                 cache["shared_k"][a], cache["shared_v"][a],
                                 lens, local=False)
    for i in range(n_scan, cfg.n_layers):
        h = _ssm_decode_layer(cfg, L.layer(params["tail_layers"], i - n_scan),
                              h, cache, i)
    return logits_of(cfg, params, h), dict(cache, len=lens + 1)


def _wh_decode_layer(cfg, p, h, kc, vc, xk, xv, lens, xlen):
    """Whisper decoder layer for one token: self-attention over its cache
    (the token's K/V go in at ``lens``), cross-attention over all the
    frames' K/V, MLP.  h (B, d).  The residual adds run as the reference's
    decode writes them, ``(h + o) + b``."""
    B = h.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    q = (W.dot(hn, p["s_wq"]) + p["s_bq"]).reshape(B, Hq, hd)
    k = W.dot(hn, p["s_wk"]).reshape(B, Hkv, hd)
    v = (W.dot(hn, p["s_wv"]) + p["s_bv"]).reshape(B, Hkv, hd)
    append_kv(kc, vc, k, v, lens)
    att = decode_attention(cfg, q, kc, vc, lens + 1)
    h = h + W.dot(att.reshape(B, Hq * hd), p["s_wo"]) + p["s_bo"]
    hn = L.layer_norm(h, p["x_ln_w"], p["x_ln_b"])
    q = (W.dot(hn, p["x_wq"]) + p["x_bq"]).reshape(B, Hq, hd)
    att = decode_attention(cfg, q, xk, xv, xlen)
    h = h + W.dot(att.reshape(B, Hq * hd), p["x_wo"]) + p["x_bo"]
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    return h + L.gelu_mlp(hn, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def _wh_decode(cfg: ModelConfig, params, cache, tokens):
    """The token's position is row ``len`` of the sinusoid table."""
    lens = cache["len"]
    pos = W.sinusoid(cache["k"].shape[2], cfg.d_model, tokens.device)
    h = embed_lookup(params["embed"], tokens[:, None])[:, 0] + pos[lens.long()]
    xlen = torch.full_like(lens, cache["xk"].shape[2])     # every frame
    for i in range(cfg.n_layers):
        h = _wh_decode_layer(cfg, L.layer(params["dec_layers"], i), h,
                             cache["k"][i], cache["v"][i], cache["xk"][i],
                             cache["xv"][i], lens, xlen)
    return W.head(cfg, params, h), dict(cache, len=lens + 1)


_DECODE = {"dense": _tf_decode, "moe": _tf_decode, "vlm": _tf_decode,
           "ssm": _ssm_decode, "hybrid": _hybrid_decode, "audio": _wh_decode}


def make_decode_step(cfg: ModelConfig):
    """decode_step(params, cache, tokens (B,)) -> (logits (B, V_padded) f32,
    the cache, written in place, with ``len`` advanced)."""
    return partial(_DECODE[cfg.family], cfg)


def make_prefill(cfg: ModelConfig, S: int, room: int = 0):
    """prefill(params, batch) -> (last-position logits (B, V_padded), cache
    holding S positions and ``room`` more, zeros, for decode)."""
    from repro_torch.serving.prefill import prefill_fn
    return partial(prefill_fn, cfg, S, room)
