"""Prefill (counterpart of ``repro/serving/prefill.py``): the forward pass
over the prompt, emitting each attention layer's K/V rows and each Mamba
layer's conv tails and final SSM state into the cache, with the LM head on
the last position only.  The VLM family's patch embeddings take the first
positions, as in the forward; the audio family encodes its frames once and
emits, besides the decoder's self-attention K/V, each decoder layer's cross
K/V over the encoder's output (``xk``/``xv``, n_layers x B x encoder_seq x
Hkv x hd), which decode reads and never writes.

The K/V regions are allocated once, for the prompt and ``room`` more
positions, and each layer's rows are written into them: at gemma2-27b's
2 x 8,192 positions the region is 6.2 GB, so neither a stack of per-layer
rows nor a later pad copies it.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.embedding import embed, embed_lookup, logits_of
from repro_torch.models.zamba import _shared_cfg, n_scan_layers
from repro_torch.parallel.sharding import ONE_DEVICE
from repro_torch.serving.decode import SSM_CACHE


def _rope(cfg, S, device):
    return L.rope_tables(torch.arange(S, device=device), cfg.head_dim,
                         cfg.rope_theta)


def _ssm_prefill_layer(cfg, p, h, states):
    """A Mamba layer from zero conv states, appending its conv tails and final
    SSM state to ``states``."""
    B, K = h.shape[0], cfg.conv_width
    GN = cfg.ssm_groups * cfg.ssm_state
    zero = tuple(torch.zeros((B, K - 1, C), dtype=h.dtype, device=h.device)
                 for C in (cfg.d_inner, GN, GN))
    h, (ncs, nst) = M.mamba_block(cfg, p, h, conv_state=zero, ssm_state=None)
    for n, t in zip(SSM_CACHE, (*ncs, nst)):
        states[n].append(t)
    return h


def _kv_region(cfg, n, h, room):
    """K and V regions of ``n`` attention layers of ``cfg``: (n, B, S + room,
    Hkv, hd) zeros in the dtype of the activations h (B, S, d) they are
    projected from."""
    B, S = h.shape[:2]
    shape = (n, B, S + room, cfg.n_kv_heads, cfg.head_dim)
    return tuple(torch.zeros(shape, dtype=h.dtype, device=h.device)
                 for _ in "kv")


def _lens(B, S, device):
    return torch.full((B,), S, dtype=torch.int32, device=device)


def _tf_prefill(cfg: ModelConfig, S, room, params, batch):
    tokens = batch["tokens"]
    h = T.with_patches(embed(cfg, params["embed"], tokens),
                       batch.get("patch_embeds"))
    cos, sin = _rope(cfg, S, tokens.device)
    kc, vc = _kv_region(cfg, cfg.n_layers, h, room)
    for i in range(cfg.n_layers):
        p = L.layer(params["layers"], i)
        window = cfg.sliding_window if T.is_local(cfg, i) else None
        h, kc[i, :, :S], vc[i, :, :S] = T.attention_block(
            cfg, p, h, cos, sin, window=window, return_kv=True)
        h = T.ffn_block(cfg, p, h)
    cache = {"k": kc, "v": vc, "len": _lens(h.shape[0], S, h.device)}
    return logits_of(cfg, params, h[:, -1]), cache


def _ssm_prefill(cfg: ModelConfig, S, room, params, batch):
    tokens = batch["tokens"]
    h = embed_lookup(ONE_DEVICE, params["embed"], tokens)
    states = {n: [] for n in SSM_CACHE}
    for i in range(cfg.n_layers):
        h = _ssm_prefill_layer(cfg, L.layer(params["layers"], i), h, states)
    cache = {n: torch.stack(states[n]) for n in SSM_CACHE}
    cache["len"] = _lens(h.shape[0], S, h.device)
    return logits_of(cfg, params, h[:, -1]), cache


def _hybrid_prefill(cfg: ModelConfig, S, room, params, batch):
    tokens = batch["tokens"]
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    h = embed_lookup(ONE_DEVICE, params["embed"], tokens)
    cos, sin = _rope(cfg, S, tokens.device)
    scfg = _shared_cfg(cfg)
    states = {n: [] for n in SSM_CACHE}
    kc, vc = _kv_region(scfg, cfg.n_layers // k, h, room)
    for i in range(n_scan):
        h = _ssm_prefill_layer(cfg, L.layer(params["layers"], i), h, states)
        if i % k == k - 1:
            a = i // k
            h, kc[a, :, :S], vc[a, :, :S] = T.attention_block(
                scfg, params["shared"], h, cos, sin, window=None,
                return_kv=True)
            h = T.ffn_block(scfg, params["shared"], h)
    for i in range(cfg.n_layers - n_scan):
        h = _ssm_prefill_layer(cfg, L.layer(params["tail_layers"], i), h,
                               states)
    cache = {n: torch.stack(states[n]) for n in SSM_CACHE}
    cache["shared_k"], cache["shared_v"] = kc, vc
    cache["len"] = _lens(h.shape[0], S, h.device)
    return logits_of(cfg, params, h[:, -1]), cache


def _wh_prefill(cfg: ModelConfig, S, room, params, batch):
    """Encode the frames (zeros when the batch has none), then the decoder
    layers over the prompt, emitting their self-attention K/V into the
    region of S + ``room`` positions and their cross K/V."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    frames = batch.get("frames")
    if frames is None:
        frames = W.no_frames(cfg, B, tokens.device)
    opts = T.RunOptions()
    enc = W.encode(cfg, params, frames, opts)
    h = W.embed_tokens(cfg, params, tokens)
    kc, vc = _kv_region(cfg, cfg.n_layers, h, room)
    xk, xv = _kv_region(cfg, cfg.n_layers, enc, 0)
    for i in range(cfg.n_layers):
        h, kc[i, :, :S], vc[i, :, :S], xk[i], xv[i] = W.decoder_layer(
            cfg, L.layer(params["dec_layers"], i), h, enc, opts,
            return_kv=True)
    cache = {"k": kc, "v": vc, "xk": xk, "xv": xv,
             "len": _lens(B, S, h.device)}
    return W.head(cfg, params, h[:, -1]), cache


_PREFILL = {"dense": _tf_prefill, "moe": _tf_prefill, "vlm": _tf_prefill,
            "ssm": _ssm_prefill, "hybrid": _hybrid_prefill,
            "audio": _wh_prefill}


def prefill_fn(cfg: ModelConfig, S: int, room: int, params, batch):
    return _PREFILL[cfg.family](cfg, S, room, params, batch)
