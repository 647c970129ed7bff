"""Decoder-only LM, dense, MoE and the VLM backbone
(``repro/models/transformer.py``):
parameter specs, the attention block (prefill attention through the
``flash_attention`` kernel), the FFN block (SwiGLU, or the routed experts of
``models/moe.py`` with their shared experts), the decoder layer and the
forward pass, with gemma2's local/global alternation, GQA, qkv bias,
post-norms and softcaps.  The zamba2 shared block is one such decoder layer.
``RunOptions`` carries the reference's attention tiles (they tile the
attention's backward; the kernel keeps its own) and its rematerialisation:
with ``remat`` each scanned layer body runs under
``torch.utils.checkpoint``, saving the weight products (``"dots"``) or
nothing (``"full"``).  Head padding is not on the port's path.  On one
device every head is local (the reference's ``head_tp``, ``tp == 1``), so
the padded and sequence-parallel branches wait for the mesh slice."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.utils.checkpoint as C

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed, logits_of
from repro_torch.models.moe import moe_ffn
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS


def layer_param_specs(cfg: ModelConfig, n_layers: Optional[int] = None,
                      stacked: bool = True):
    d, hd = cfg.d_model, cfg.head_dim
    qd, kvd = cfg.n_heads * hd, cfg.n_kv_heads * hd
    Ld = (n_layers if n_layers is not None else cfg.n_layers,) if stacked else ()
    La = (None,) if stacked else ()
    p = {
        "attn_norm": PS(Ld + (d,), La + (None,), "ones"),
        "wq": PS(Ld + (d, qd), La + ("fsdp", "heads"), "scaled"),
        "wk": PS(Ld + (d, kvd), La + ("fsdp", "kv_heads"), "scaled"),
        "wv": PS(Ld + (d, kvd), La + ("fsdp", "kv_heads"), "scaled"),
        "wo": PS(Ld + (qd, d), La + ("heads", "fsdp"), "scaled"),
        "mlp_norm": PS(Ld + (d,), La + (None,), "ones"),
    }
    f = cfg.d_ff
    if cfg.is_moe:
        E = cfg.n_experts
        p["router"] = PS(Ld + (d, E), La + (None, None), "scaled")
        p["we_gate"] = PS(Ld + (E, d, f), La + ("expert", "fsdp", None),
                           "scaled")
        p["we_up"] = PS(Ld + (E, d, f), La + ("expert", "fsdp", None),
                         "scaled")
        p["we_down"] = PS(Ld + (E, f, d), La + ("expert", None, "fsdp"),
                           "scaled")
        if cfg.n_shared_experts:
            sf = cfg.n_shared_experts * f
            p["ws_gate"] = PS(Ld + (d, sf), La + ("fsdp", "ff"), "scaled")
            p["ws_up"] = PS(Ld + (d, sf), La + ("fsdp", "ff"), "scaled")
            p["ws_down"] = PS(Ld + (sf, d), La + ("ff", "fsdp"), "scaled")
    else:
        p["w_gate"] = PS(Ld + (d, f), La + ("fsdp", "ff"), "scaled")
        p["w_up"] = PS(Ld + (d, f), La + ("fsdp", "ff"), "scaled")
        p["w_down"] = PS(Ld + (f, d), La + ("ff", "fsdp"), "scaled")
    if cfg.qkv_bias:
        p["bq"] = PS(Ld + (qd,), La + ("heads",), "zeros")
        p["bk"] = PS(Ld + (kvd,), La + ("kv_heads",), "zeros")
        p["bv"] = PS(Ld + (kvd,), La + ("kv_heads",), "zeros")
    if cfg.post_norms:
        p["attn_post_norm"] = PS(Ld + (d,), La + (None,), "ones")
        p["mlp_post_norm"] = PS(Ld + (d,), La + (None,), "ones")
    return p


def param_specs(cfg: ModelConfig):
    """The whole tree: embedding, final norm, the stacked layers, and an LM
    head where the embeddings are not tied (qwen2.5-32b)."""
    tree = {
        "embed": PS((cfg.vocab_padded, cfg.d_model), ("vocab", None), "normal"),
        "final_norm": PS((cfg.d_model,), (None,), "ones"),
        "layers": layer_param_specs(cfg),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = PS((cfg.vocab_padded, cfg.d_model), ("vocab", None),
                             "normal")
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
                    window: Optional[int], return_kv: bool = False,
                    q_block: int = 512, kv_block: int = 512):
    """Causal self-attention block; with ``return_kv`` also the (B, S, Hkv,
    hd) K and V rows for the serving cache."""
    q, k, v = qkv(cfg, p, h, cos, sin)
    att = L.block_attention(q, k, v, causal=True, window=window,
                            attn_softcap=cfg.attn_softcap, q_block=q_block,
                            kv_block=kv_block)
    h = attention_out(cfg, p, h, att)
    return (h, k, v) if return_kv else h


def ffn_block(cfg: ModelConfig, p, h):
    """h (B, S, d) plus the FFN of its norm: SwiGLU, or the routed experts
    over the B x S tokens plus the shared experts' SwiGLU, added in h's
    dtype.  The decode step calls it on (B, 1, d), so its B tokens are
    routed together."""
    hn = L.rms_norm(h, p["mlp_norm"])
    if cfg.is_moe:
        out = moe_ffn(cfg, ONE_DEVICE, hn, p["router"], p["we_gate"],
                      p["we_up"], p["we_down"])
        if cfg.n_shared_experts:
            out = out + L.swiglu(hn, p["ws_gate"], p["ws_up"], p["ws_down"])
    else:
        out = L.swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
    if cfg.post_norms:
        out = L.rms_norm(out, p["mlp_post_norm"])
    return h + out


def decoder_layer(cfg: ModelConfig, p, h, cos, sin, *, local: bool,
                  q_block: int = 512, kv_block: int = 512):
    window = cfg.sliding_window if local else None
    h = attention_block(cfg, p, h, cos, sin, window=window, q_block=q_block,
                        kv_block=kv_block)
    return ffn_block(cfg, p, h)


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """The reference's ``RunOptions``, its one-device fields: attention tiles
    and rematerialisation.  ``pad_heads`` and ``moe_mode`` wait for the mesh
    slice (ROADMAP.md, item 12)."""
    q_block: int = 512
    kv_block: int = 512
    remat: bool = True
    remat_policy: Optional[str] = "dots"   # None | "dots" | "full"


# the products the "dots" policy keeps: those without batch dimensions (the
# reference's dots_with_no_batch_dims_saveable), i.e. activations x weights
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (C.CheckpointPolicy.MUST_SAVE if op in _DOTS
            else C.CheckpointPolicy.PREFER_RECOMPUTE)


def maybe_remat(fn, opts: RunOptions):
    """``fn`` under ``torch.utils.checkpoint`` when ``opts.remat`` and the
    body's input carries a gradient (a forward without one saves nothing
    anyway): policy ``"dots"`` saves the weight products, ``"full"`` (or
    None) nothing, and the backward reruns the rest, the kernels
    included.  ``fn(h, *rest)``: ``h`` the hidden state."""
    if not opts.remat:
        return fn
    ctx_fn = (functools.partial(C.create_selective_checkpoint_contexts,
                                _save_dots)
              if opts.remat_policy == "dots" else C.noop_context_fn)

    def wrapped(*args):
        if not (torch.is_grad_enabled() and args[0].requires_grad):
            return fn(*args)
        return C.checkpoint(fn, *args, use_reentrant=False,
                            context_fn=ctx_fn)
    return wrapped


def with_patches(h, patch_embeds):
    """The VLM stub's precomputed patch embeddings (B, P, d), P <= S, in the
    first P positions of the embeddings h (B, S, d)."""
    if patch_embeds is None:
        return h
    P = patch_embeds.shape[1]
    return torch.cat([patch_embeds.to(h.dtype), h[:, P:]], dim=1)


def forward(cfg: ModelConfig, params, tokens, opts: Optional[RunOptions] = None,
            *, extra_embeds=None):
    """tokens (B, S) -> logits (B, S, V_padded) float32; ``extra_embeds``
    (B, P, d), the VLM's patch embeddings, take the first P positions.  The
    layers run in groups of ``local_global_pattern`` (the reference's
    scanned body), each group rematerialised as ``opts`` says."""
    opts = opts or RunOptions()
    g = max(1, cfg.local_global_pattern)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {g}")
    h = with_patches(embed(cfg, params["embed"], tokens), extra_embeds)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    per_layer = L.layers(params["layers"])

    def group(hh, first):
        for i in range(first, first + g):
            hh = decoder_layer(cfg, per_layer[i], hh, cos, sin,
                               local=is_local(cfg, i), q_block=opts.q_block,
                               kv_block=opts.kv_block)
        return hh
    body = maybe_remat(group, opts)
    for first in range(0, cfg.n_layers, g):
        h = body(h, first)
    return logits_of(cfg, params, h)
