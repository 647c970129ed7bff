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

On a mesh (``_tf_prefill`` and the hybrid's shared block run the
reference's ``_attn_with_cache``, ``_wh_prefill`` its ``_wh_prefill``) a
rank's self-attention region is its block of the cache in
``decode.kv_mode``'s layout: its kv heads in "heads" mode; in "seq" mode
its rows of every head, positions [r L/tp, (r + 1) L/tp) of the L = S +
room positions, where ``room`` is rounded up so that tp divides L.  The
audio family's cross region is its kv heads in either mode.  The Mamba
layers' states come out as the rank's blocks of ``decode.cache_specs``:
``conv_x`` its ``d_inner`` channels, ``conv_B`` and ``conv_C`` whole,
``ssm`` its heads.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.embedding import embed, logits_of
from repro_torch.models.zamba import _shared_cfg, n_scan_layers
from repro_torch.parallel.sharding import ONE_DEVICE, Topology
from repro_torch.serving.decode import (SSM_CACHE, XKV_AXES, _kv_axes, kv_mode,
                                        seq_block)


def _rope(cfg, S, device):
    return L.rope_tables(torch.arange(S, device=device), cfg.head_dim,
                         cfg.rope_theta)


def _ssm_prefill_layer(cfg, topo, p, h, states):
    """A Mamba layer from zero states, appending its conv tails and final
    SSM state (on a mesh the rank's blocks of the cache's) to ``states``."""
    h, (ncs, nst) = M.mamba_block(cfg, p, h, return_state=True, topo=topo)
    for n, t in zip(SSM_CACHE, (*ncs, nst)):
        states[n].append(t)
    return h


def _kv_region(cfg, n, h, room, topo: Topology = ONE_DEVICE, axes=None):
    """K and V regions of ``n`` attention layers of ``cfg``: (n, B, S + room,
    Hkv, hd) zeros in the dtype of the activations h (B, S, d) they are
    projected from; on a mesh the rank's block of them in the cache's
    layout (``axes``; the self-attention cache's ``kv_mode`` layout when
    None), with room rounded up in "seq" mode (see the module)."""
    B, S = h.shape[:2]
    axes = list(axes or _kv_axes(kv_mode(cfg, topo)))
    if "kv_seq" in axes:
        tp = seq_block(topo, 0)[2]
        room = -(-(S + room) // tp) * tp - S
    axes[1] = None                       # h is the rank's batch block
    shape = (n, B, S + room, cfg.n_kv_heads, cfg.head_dim)
    shape = topo.block(torch.empty(shape, device="meta"), *axes).shape
    return tuple(torch.zeros(shape, dtype=h.dtype, device=h.device)
                 for _ in "kv")


def _region_first(cfg, topo: Topology, kc) -> int:
    """The first position of this rank's rows of a K/V region kc (n, B,
    L_r, H, hd): its sequence block's start in "seq" mode, else 0."""
    if kv_mode(cfg, topo) == "seq":
        return seq_block(topo, kc.shape[2])[1]
    return 0


def _put_kv(kc, vc, k, v, first):
    """Rows [first, first + kc.shape[1]) of the prompt's K/V (B, S, H, hd)
    into this rank's region rows kc/vc (B, S_r, H, hd), as far as the prompt
    reaches."""
    n = max(0, min(kc.shape[1], k.shape[1] - first))
    kc[:, :n] = k[:, first:first + n]
    vc[:, :n] = v[:, first:first + n]


def _lens(B, S, device):
    return torch.full((B,), S, dtype=torch.int32, device=device)


def _tf_prefill(cfg: ModelConfig, topo: Topology, S, room, params, batch):
    tokens = batch["tokens"]
    h = T.with_patches(embed(cfg, params["embed"], tokens, topo),
                       batch.get("patch_embeds"))
    cos, sin = _rope(cfg, S, tokens.device)
    kc, vc = _kv_region(cfg, cfg.n_layers, h, room, topo)
    first = _region_first(cfg, topo, kc)
    for i in range(cfg.n_layers):
        p = L.layer(params["layers"], i)
        window = cfg.sliding_window if T.is_local(cfg, i) else None
        h, k, v = T.attention_block(cfg, topo, p, h, cos, sin, window=window,
                                    return_kv=True)
        _put_kv(kc[i], vc[i], k, v, first)
        h = T.ffn_block(cfg, topo, p, h)
    cache = {"k": kc, "v": vc, "len": _lens(h.shape[0], S, h.device)}
    return logits_of(cfg, params, h[:, -1], topo), cache


def _ssm_states(h, S, states):
    cache = {n: torch.stack(states[n]) for n in SSM_CACHE}
    cache["len"] = _lens(h.shape[0], S, h.device)
    return cache


def _ssm_prefill(cfg: ModelConfig, topo: Topology, S, room, params, batch):
    h = embed(cfg, params["embed"], batch["tokens"], topo)
    states = {n: [] for n in SSM_CACHE}
    for i in range(cfg.n_layers):
        h = _ssm_prefill_layer(cfg, topo, L.layer(params["layers"], i), h,
                               states)
    return logits_of(cfg, params, h[:, -1], topo), _ssm_states(h, S, states)


def _hybrid_prefill(cfg: ModelConfig, topo: Topology, S, room, params,
                    batch):
    """The Mamba layers' states as in ``_ssm_prefill``; each application
    of the shared block writes its K/V rows into the region as
    ``_tf_prefill`` does (the rank's kv heads, or its sequence block in
    "seq" mode)."""
    tokens = batch["tokens"]
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    h = embed(cfg, params["embed"], tokens, topo)
    cos, sin = _rope(cfg, S, tokens.device)
    scfg = _shared_cfg(cfg)
    states = {n: [] for n in SSM_CACHE}
    kc, vc = _kv_region(scfg, cfg.n_layers // k, h, room, topo)
    first = _region_first(scfg, topo, kc)
    for i in range(n_scan):
        h = _ssm_prefill_layer(cfg, topo, L.layer(params["layers"], i), h,
                               states)
        if i % k == k - 1:
            a = i // k
            h, sk, sv = T.attention_block(scfg, topo, params["shared"], h,
                                          cos, sin, window=None,
                                          return_kv=True)
            _put_kv(kc[a], vc[a], sk, sv, first)
            h = T.ffn_block(scfg, topo, params["shared"], h)
    for i in range(cfg.n_layers - n_scan):
        h = _ssm_prefill_layer(cfg, topo, L.layer(params["tail_layers"], i),
                               h, states)
    cache = _ssm_states(h, S, states)
    cache["shared_k"], cache["shared_v"] = kc, vc
    return logits_of(cfg, params, h[:, -1], topo), cache


def _wh_prefill(cfg: ModelConfig, topo: Topology, S, room, params, batch):
    """Encode the frames (zeros when the batch has none), then the decoder
    layers over the prompt, emitting their self-attention K/V into the
    region of S + ``room`` positions (on a mesh the rank's block in
    ``kv_mode``'s layout) and their cross K/V, whose region is always split
    by kv heads (``XKV_AXES``: in "seq" mode too the 1,500 frames stay
    whole on a rank).  Each rank projects its heads' cross K/V from its
    batch block of the encoder output, with no collective."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    frames = batch.get("frames")
    if frames is None:
        frames = W.no_frames(cfg, B, tokens.device)
    opts = T.RunOptions()
    enc = W.encode(cfg, params, frames, opts, topo)
    h = W.embed_tokens(cfg, params, tokens, topo)
    kc, vc = _kv_region(cfg, cfg.n_layers, h, room, topo)
    first = _region_first(cfg, topo, kc)
    xk, xv = _kv_region(cfg, cfg.n_layers, enc, 0, topo, axes=XKV_AXES)
    for i in range(cfg.n_layers):
        h, k, v, xk[i], xv[i] = W.decoder_layer(
            cfg, L.layer(params["dec_layers"], i), h, enc, opts,
            return_kv=True, topo=topo)
        _put_kv(kc[i], vc[i], k, v, first)
    cache = {"k": kc, "v": vc, "xk": xk, "xv": xv,
             "len": _lens(B, S, h.device)}
    return W.head(cfg, params, h[:, -1], topo), cache


_PREFILL = {"dense": _tf_prefill, "moe": _tf_prefill, "vlm": _tf_prefill,
            "ssm": _ssm_prefill, "hybrid": _hybrid_prefill,
            "audio": _wh_prefill}


def prefill_fn(cfg: ModelConfig, topo: Topology, S: int, room: int, params,
               batch):
    return _PREFILL[cfg.family](cfg, topo, S, room, params, batch)
