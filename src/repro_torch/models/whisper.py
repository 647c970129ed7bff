"""Whisper-style encoder-decoder backbone (arXiv:2212.04356): counterpart of
``repro/models/whisper.py``.  The conv/mel frontend is a stub there too: the
batch gives precomputed frame embeddings (B, encoder_seq, d).  The encoder
layers run bidirectional self-attention, the decoder layers causal
self-attention and cross-attention over the encoder's output, all three
through the ``flash_attention`` kernel (``layers.block_attention``), with
LayerNorms, GELU MLPs and biases (q and v projections have one, k has
none).  Positions are sinusoidal in both stacks, as in the reference.

Dtypes follow the reference's promotion: the encoder's input is rounded to
bf16 whatever the weights' dtype (``encode``), and a product of a bf16
activation with float32 weights runs in float32 (jnp's einsum promotes),
so with float32 weights the stream is float32 from the first residual on.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed_lookup, lm_head
from repro_torch.models.transformer import RunOptions, maybe_remat
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS


def _attn_specs(cfg, Ldim, cross: bool = False):
    La = (None,)
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    pre = "x" if cross else "s"
    return {
        f"{pre}_ln_w": PS(Ldim + (d,), La + (None,), "ones"),
        f"{pre}_ln_b": PS(Ldim + (d,), La + (None,), "zeros"),
        f"{pre}_wq": PS(Ldim + (d, qd), La + ("fsdp", "heads"), "scaled"),
        f"{pre}_bq": PS(Ldim + (qd,), La + ("heads",), "zeros"),
        f"{pre}_wk": PS(Ldim + (d, kvd), La + ("fsdp", "kv_heads"), "scaled"),
        f"{pre}_wv": PS(Ldim + (d, kvd), La + ("fsdp", "kv_heads"), "scaled"),
        f"{pre}_bv": PS(Ldim + (kvd,), La + ("kv_heads",), "zeros"),
        f"{pre}_wo": PS(Ldim + (qd, d), La + ("heads", "fsdp"), "scaled"),
        f"{pre}_bo": PS(Ldim + (d,), La + (None,), "zeros"),
    }


def _mlp_specs(cfg, Ldim):
    d, f = cfg.d_model, cfg.d_ff
    La = (None,)
    return {
        "m_ln_w": PS(Ldim + (d,), La + (None,), "ones"),
        "m_ln_b": PS(Ldim + (d,), La + (None,), "zeros"),
        "w_in": PS(Ldim + (d, f), La + ("fsdp", "ff"), "scaled"),
        "b_in": PS(Ldim + (f,), La + ("ff",), "zeros"),
        "w_out": PS(Ldim + (f, d), La + ("ff", "fsdp"), "scaled"),
        "b_out": PS(Ldim + (d,), La + (None,), "zeros"),
    }


def param_specs(cfg: ModelConfig):
    d = cfg.d_model
    Le, Ld = (cfg.encoder_layers,), (cfg.n_layers,)
    return {
        "embed": PS((cfg.vocab_padded, d), ("vocab", None), "normal"),
        "enc_layers": {**_attn_specs(cfg, Le), **_mlp_specs(cfg, Le)},
        "dec_layers": {**_attn_specs(cfg, Ld),
                       **_attn_specs(cfg, Ld, cross=True),
                       **_mlp_specs(cfg, Ld)},
        "enc_ln_w": PS((d,), (None,), "ones"),
        "enc_ln_b": PS((d,), (None,), "zeros"),
        "dec_ln_w": PS((d,), (None,), "ones"),
        "dec_ln_b": PS((d,), (None,), "zeros"),
    }


@functools.lru_cache(maxsize=16)
def _sinusoid(S: int, d: int, device: str):
    pos = np.arange(S)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    table = np.concatenate([np.sin(ang), np.cos(ang)], -1)
    return torch.from_numpy(table).to(torch.bfloat16).to(device)


def sinusoid(S: int, d: int, device="cpu"):
    """(S, d) bf16: sin then cos of pos / 10000^(2i/d), computed in float64
    and rounded to bf16 as the reference's ``jnp.asarray`` rounds it.  Row
    p does not depend on S.  Memoized per (S, d, device); do not write into
    it."""
    return _sinusoid(S, d, str(torch.device(device)))


def dot(x, w):
    """x @ w in the promoted dtype (a bf16 activation against float32
    weights runs in float32, as jnp's einsum does)."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


def _mha(cfg, h_q, h_kv, p, pre, *, causal, opts, return_kv=False):
    """Attention of h_q (B, Sq, d) over h_kv (B, Sk, d) with prefix ``pre``'s
    weights; with ``return_kv`` also its (B, Sk, Hkv, hd) K and V."""
    B, Sq, _ = h_q.shape
    Sk = h_kv.shape[1]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = (dot(h_q, p[f"{pre}_wq"]) + p[f"{pre}_bq"]).reshape(B, Sq, Hq, hd)
    k = dot(h_kv, p[f"{pre}_wk"]).reshape(B, Sk, Hkv, hd)
    v = (dot(h_kv, p[f"{pre}_wv"]) + p[f"{pre}_bv"]).reshape(B, Sk, Hkv, hd)
    out = L.block_attention(q, k, v, causal=causal, q_block=opts.q_block,
                            kv_block=opts.kv_block)
    o = dot(out.reshape(B, Sq, Hq * hd), p[f"{pre}_wo"]) + p[f"{pre}_bo"]
    return (o, k, v) if return_kv else o


def encoder_layer(cfg, p, h, opts):
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    h = h + _mha(cfg, hn, hn, p, "s", causal=False, opts=opts)
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    return h + L.gelu_mlp(hn, p["w_in"], p["b_in"], p["w_out"], p["b_out"])


def decoder_layer(cfg, p, h, enc_out, opts, return_kv=False):
    """Causal self-attention, cross-attention over enc_out (B, Se, d), MLP.
    With ``return_kv`` also the self-attention's K/V and the cross K/V."""
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    o, k, v = _mha(cfg, hn, hn, p, "s", causal=True, opts=opts,
                   return_kv=True)
    h = h + o
    hn = L.layer_norm(h, p["x_ln_w"], p["x_ln_b"])
    o, xk, xv = _mha(cfg, hn, enc_out, p, "x", causal=False, opts=opts,
                     return_kv=True)
    h = h + o
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    h = h + L.gelu_mlp(hn, p["w_in"], p["b_in"], p["w_out"], p["b_out"])
    return (h, k, v, xk, xv) if return_kv else h


def encode(cfg, params, frames, opts=None):
    """frames (B, encoder_seq, d), the stub frontend's output -> the
    encoder's normed output.  Its input is rounded to bf16, as the
    reference's."""
    opts = opts or RunOptions()
    h = (frames + sinusoid(frames.shape[1], cfg.d_model, frames.device)[None]
         ).to(torch.bfloat16)
    per_layer = L.layers(params["enc_layers"])
    body = maybe_remat(lambda hh, i: encoder_layer(cfg, per_layer[i], hh,
                                                   opts), opts)
    for i in range(cfg.encoder_layers):
        h = body(h, i)
    return L.layer_norm(h, params["enc_ln_w"], params["enc_ln_b"])


def no_frames(cfg, B, device):
    """The reference's default when a batch has no frames: zeros, bf16."""
    return torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                       device=device)


def embed_tokens(cfg, params, tokens):
    """The token embeddings plus their sinusoidal positions (B, S, d)."""
    return embed_lookup(ONE_DEVICE, params["embed"], tokens) + sinusoid(
        tokens.shape[1], cfg.d_model, tokens.device)[None]


def head(cfg, params, h):
    """``dec_ln``, then the tied ``embed`` table in float32 with the padded
    vocab masked -> (..., V_padded) float32."""
    return lm_head(cfg, params["embed"],
                   L.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"]))


def forward(cfg: ModelConfig, params, tokens, *, frames=None, opts=None):
    """Teacher-forced: encode ``frames`` (zeros when None), decode tokens
    (B, S) -> logits (B, S, V_padded) float32.  Each layer body runs under
    ``maybe_remat``."""
    opts = opts or RunOptions()
    if frames is None:
        frames = no_frames(cfg, tokens.shape[0], tokens.device)
    enc_out = encode(cfg, params, frames, opts)
    h = embed_tokens(cfg, params, tokens)
    per_layer = L.layers(params["dec_layers"])
    body = maybe_remat(lambda hh, enc, i: decoder_layer(
        cfg, per_layer[i], hh, enc, opts), opts)
    for i in range(cfg.n_layers):
        h = body(h, enc_out, i)
    return head(cfg, params, h)
