"""Serving: the decode step and its cache (counterpart of
``repro/serving/decode.py``).

The cache holds, per attention layer (dense, MoE, VLM and the audio
decoder) or per application of the shared block (hybrid), its K/V rows, per
Mamba layer the conv tails (bf16) and the SSM state (f32), and per audio
decoder layer the cross K/V over the encoder's frames, which decode only
reads.

The K/V cache is a remote data structure sharded over the ``model`` axis,
in one of two modes (``kv_mode``), as in the reference:

  * "heads" (one-sided): the kv heads split over ``model``; a rank's decode
    attention reads only its own heads' rows.  Needs n_kv_heads and n_heads
    divisible by the axis.  On one device every head is local.
  * "seq" (RPC): the cache splits over SEQUENCE; the query goes to every
    rank, each computes the partial flash-decode statistics (m, l, o) of
    its block, and all-reduces (MAX, then SUM) combine them: a small request
    out, small partials back, the owner does the walking
    (``hybrid_decode_attention``).

A decode step writes into the cache it is given, in place, as XLA does the
reference's ``.at[].set``: the new token's K/V at offset ``len`` of each row,
each Mamba layer's new states over its old ones.  It returns the cache with
``len`` advanced; clone the tensors first to keep the old cache.

On a mesh (``make_decode_step(cfg, topo=)``) a rank holds its blocks of
the parameters, the batch and the cache: in
"heads" mode it projects and attends its own query and kv heads and the
output projection is row-parallel (one all-reduce over ``model``); in
"seq" mode the query and the new K/V are every head's (the projections'
column blocks all-gathered), the rank that owns position ``len`` of a row
writes it (the reference's ``.at[rows, lens].set`` on a sequence-sharded
cache), the attention runs as ``_flash_decode_shardmap`` and the output
projection row-parallel.  The FFN and the vocab-sharded LM head are the
prefill's.  A Mamba layer's step (``mamba2.mamba_block``) reads and writes
the rank's blocks of its states (``conv_x`` its ``d_inner`` channels,
``ssm`` its heads); the hybrid's shared block decodes as a transformer
layer over the ``shared_k``/``shared_v`` region.  The audio family's
self-attention decodes as the transformer's (without rotation, with its
biases), its cross-attention always on the rank's heads of ``xk``/``xv``,
which are split by kv heads in either mode (``XKV_AXES``).
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W
from repro_torch.models.embedding import embed, embed_lookup, logits_of
from repro_torch.models.zamba import _shared_cfg, n_scan_layers
from repro_torch.parallel.sharding import ONE_DEVICE, Topology

SSM_CACHE = ("conv_x", "conv_B", "conv_C", "ssm")


def kv_mode(cfg: ModelConfig, topo: Topology) -> str:
    """"heads" where the kv heads and the query heads divide over the
    ``model`` axis (or it is 1), else "seq"."""
    tp = topo.axis_sizes.get("model", 1)
    if tp == 1:
        return "heads"
    return "heads" if (cfg.n_kv_heads % tp == 0 and cfg.n_heads % tp == 0) \
        else "seq"


def _kv_axes(mode: str):
    return ((None, "batch", None, "kv_heads", None) if mode == "heads"
            else (None, "batch", "kv_seq", None, None))


# the audio family's cross K/V (xk, xv): split by kv heads in either mode
XKV_AXES = (None, "batch", None, "kv_heads", None)


def cache_specs(cfg: ModelConfig, B: int, S: int,
                topo: Topology = ONE_DEVICE) -> Dict[str, Tuple]:
    """{name: (shape, logical axes, dtype)} of the cache for B rows of S
    positions; the K/V axes follow ``kv_mode(cfg, topo)``."""
    out: Dict[str, Tuple] = {"len": ((B,), ("batch",), torch.int32)}
    kv_ax = _kv_axes(kv_mode(cfg, topo))
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        kv = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.head_dim)
        out["k"] = (kv, kv_ax, torch.bfloat16)
        out["v"] = (kv, kv_ax, torch.bfloat16)
        if cfg.family == "audio":
            x = (cfg.n_layers, B, cfg.encoder_seq, cfg.n_kv_heads, cfg.head_dim)
            out["xk"] = (x, XKV_AXES, torch.bfloat16)
            out["xv"] = (x, XKV_AXES, torch.bfloat16)
        return out
    nl, K = cfg.n_layers, cfg.conv_width
    GN = cfg.ssm_groups * cfg.ssm_state
    out["conv_x"] = ((nl, B, K - 1, cfg.d_inner), (None, "batch", None, "ff"),
                     torch.bfloat16)
    out["conv_B"] = ((nl, B, K - 1, GN), (None, "batch", None, None),
                     torch.bfloat16)
    out["conv_C"] = ((nl, B, K - 1, GN), (None, "batch", None, None),
                     torch.bfloat16)
    out["ssm"] = ((nl, B, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                  (None, "batch", "heads", None, None), torch.float32)
    if cfg.family == "hybrid":
        kv = (cfg.n_layers // cfg.shared_attn_every, B, S, cfg.n_kv_heads,
              cfg.head_dim)
        out["shared_k"] = (kv, kv_ax, torch.bfloat16)
        out["shared_v"] = (kv, kv_ax, torch.bfloat16)
    return out


def init_cache(cfg: ModelConfig, B: int, S: int, device="cuda"):
    dev = resolve_device(device)
    return {k: torch.zeros(shp, dtype=dt, device=dev)
            for k, (shp, _, dt) in cache_specs(cfg, B, S).items()}


def append_kv(kc, vc, k_new, v_new, lens):
    """Write the new token's K/V (B, Hkv, hd) at offset ``lens`` of each row
    of kc/vc (B, S, Hkv, hd), in place."""
    rows = torch.arange(lens.shape[0], device=lens.device)
    kc[rows, lens.long()] = k_new.to(kc.dtype)
    vc[rows, lens.long()] = v_new.to(vc.dtype)


def append_kv_owned(kc, vc, k_new, v_new, pos):
    """The sequence-sharded cache's append on a rank: kc/vc (B, S_r, Hkv,
    hd) hold positions [first, first + S_r) of each row and ``pos`` (B,) is
    ``lens - first``; a row's new K/V is written where 0 <= pos < S_r (this
    rank owns position ``lens``), the others keep their words.  No host
    sync."""
    S_r = kc.shape[1]
    ok = ((pos >= 0) & (pos < S_r))[:, None, None]
    at = pos.clamp(0, S_r - 1).long()
    rows = torch.arange(pos.shape[0], device=pos.device)
    kc[rows, at] = torch.where(ok, k_new.to(kc.dtype), kc[rows, at])
    vc[rows, at] = torch.where(ok, v_new.to(vc.dtype), vc[rows, at])


def seq_block(topo: Topology, rows: int):
    """(entry, first position, tp) of a rank's block of a sequence-sharded
    cache whose blocks hold ``rows`` positions: the ``spec_for`` entry of
    ``kv_seq`` (None where the rules give it no axis, then the whole cache
    is the block), where the block starts, and the number of blocks."""
    axes = tuple(a for a in topo.rules.get("kv_seq", ())
                 if a in topo.axis_sizes)
    n = topo._prod(axes)
    e = None if not axes else (axes[0] if len(axes) == 1 else axes)
    return e, topo.extent(e, rows * n)[0], n


def _rope_single(x, lens, theta):
    """x (B, H, hd) rotated at per-row positions lens (B,)."""
    cos, sin = L.rope_tables(lens, x.shape[-1], theta)
    return L.apply_rope(x[:, None], cos[:, None], sin[:, None])[:, 0]


def decode_attention(cfg: ModelConfig, q, kc, vc, lens, *, window=None):
    """q (B, Hq, hd); kc/vc (B, S, Hkv, hd); lens (B,).  Every head is local
    on one device (the reference's "heads" mode)."""
    return L.decode_attention(q, kc, vc, lens, window=window,
                              attn_softcap=cfg.attn_softcap)


def _flash_decode_shardmap(cfg: ModelConfig, topo: Topology, q, kc, vc, lens,
                           window):
    """The "seq" (RPC) path on a rank: q (B_loc, Hq, hd) is every rank's
    query, kc/vc (B_loc, S_loc, Hkv, hd) the rank's sequence block (its
    positions and its group from :func:`seq_block`), lens (B_loc,).  The
    block's partial (m, l, o) travel in one all-gather over the ``kv_seq``
    axes and every rank combines them alike: the largest m, then the sums
    of l * corr and o * corr in rank order (the reference's pmax and two
    psums, one collective instead of three)."""
    B, S_loc, Hkv, hd = kc.shape
    G = q.shape[1] // Hkv
    es, first, _ = seq_block(topo, S_loc)
    pos = first + torch.arange(S_loc, device=q.device)
    mask = pos[None] < lens[:, None]
    if window is not None:
        mask &= pos[None] > (lens[:, None] - 1) - window
    qg = q.reshape(B, Hkv, G, hd).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.float()) * hd ** -0.5
    s = L.softcap(s, cfg.attn_softcap)
    s = torch.where(mask[:, None, None], s, torch.full_like(s, -1e30))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(vc.dtype).float(), vc.float())
    part = torch.cat([m[..., None], l[..., None], o], -1)[None]
    part = topo.gather(part, 0, es)             # (tp, B, Hkv, G, 2 + hd)
    m_all = part[..., 0].amax(0)
    corr = torch.exp(part[..., 0] - m_all)
    l_all = (part[..., 1] * corr).sum(0)
    o_all = (part[..., 2:] * corr[..., None]).sum(0)
    out = o_all / l_all.clamp(min=1e-30)[..., None]
    return out.reshape(q.shape).to(q.dtype)


def hybrid_decode_attention(cfg: ModelConfig, topo: Topology, q, kc, vc,
                            lens, *, window=None, mode=None):
    """Decode attention under the cache's sharding on a rank: "heads" runs
    :func:`decode_attention` over the rank's heads (q (B, Hq/tp, hd),
    kc/vc (B, S, Hkv/tp, hd)); "seq" runs :func:`_flash_decode_shardmap`
    over the rank's sequence block.  ``mode`` defaults to ``kv_mode``."""
    mode = mode or kv_mode(cfg, topo)
    if mode == "heads":
        return decode_attention(cfg, q, kc, vc, lens, window=window)
    return _flash_decode_shardmap(cfg, topo, q, kc, vc, lens, window)


def _self_attention_decode(cfg, topo, lv, p, hn, kc, vc, lens, *, pre="",
                           rope=None, window=None, f32_sum=False):
    """One token's self-attention on a rank, up to the output projection
    (no output bias): hn (B, d) normed; the token's K/V go into kc/vc (this
    rank's cache block) at ``lens``.  Leaves ``{pre}wq`` ... ``{pre}wo`` of
    ``lv`` (the layer's ``transformer.Leaves``); ``rope`` turns q and k
    (B, H, hd) where the family rotates them.  In "heads" cache mode the
    rank's query and kv heads and ``wo`` row-parallel; in "seq" mode every
    head's q/k/v (the projections' column blocks all-gathered), the append
    at the owner of position ``len`` only, ``_flash_decode_shardmap`` and
    ``wo`` row-parallel over the rank's rows.  ``f32_sum`` as in
    ``transformer._local_rows``."""
    B = hn.shape[0]
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    wq, wk, wv, wo = (pre + n for n in ("wq", "wk", "wv", "wo"))
    rope = rope or (lambda x: x)
    if kv_mode(cfg, topo) == "heads":
        eq, lo, nh = T._heads(topo, "heads", Hq)
        ekv, klo, nk = T._heads(topo, "kv_heads", Hkv)
        q = T._local_cols(topo, lv, p, wq, hn, lo * hd, nh * hd, eq)
        k = T._local_cols(topo, lv, p, wk, hn, klo * hd, nk * hd, ekv)
        v = T._local_cols(topo, lv, p, wv, hn, klo * hd, nk * hd, ekv)
        q = rope(q.reshape(B, nh, hd))
        k = rope(k.reshape(B, nk, hd))
        append_kv(kc, vc, k, v.reshape(B, nk, hd), lens)
        att = decode_attention(cfg, q, kc, vc, lens + 1, window=window)
        return T._local_rows(topo, lv, p, wo, att.reshape(B, nh * hd),
                             lo * hd, nh * hd, eq, f32_sum=f32_sum)
    q, k, v = T._project(topo, lv, p, hn, (wq, wk, wv))
    q = rope(q.reshape(B, Hq, hd))
    k = rope(k.reshape(B, Hkv, hd))
    es, first, _ = seq_block(topo, kc.shape[1])
    append_kv_owned(kc, vc, k, v.reshape(B, Hkv, hd), lens - first)
    att = (decode_attention(cfg, q, kc, vc, lens + 1, window=window)
           if es is None else
           _flash_decode_shardmap(cfg, topo, q, kc, vc, lens + 1, window))
    er = T._entry(topo, lv, wo, 0)
    rlo, rn = topo.extent(er, Hq * hd)
    return T._local_rows(topo, lv, p, wo,
                         att.reshape(B, Hq * hd)[:, rlo:rlo + rn], rlo, rn,
                         er, f32_sum=f32_sum)


def _tf_decode_layer(cfg, topo, p, h, kc, vc, lens, *, local: bool):
    """Dense or MoE decoder layer for one token.  h (B, d); the token's K/V
    go into kc/vc (this rank's cache block) at ``lens``
    (:func:`_self_attention_decode`).  The FFN is the prefill's
    (``transformer.ffn_block``) over the B tokens."""
    o = _self_attention_decode(
        cfg, topo, T.leaves(cfg), p, L.rms_norm(h, p["attn_norm"]), kc, vc,
        lens, rope=lambda x: _rope_single(x, lens, cfg.rope_theta),
        window=cfg.sliding_window if local else None)
    if cfg.post_norms:
        o = L.rms_norm(o, p["attn_post_norm"])
    return T.ffn_block(cfg, topo, p, (h + o)[:, None])[:, 0]


def _ssm_decode_layer(cfg, topo, p, h, cache, i: int):
    """Mamba layer ``i`` for one token from its cached states (on a mesh
    the rank's blocks), which it overwrites with the new ones.  h (B, d)."""
    h2, ((cx, cb, cc), st) = M.mamba_block(
        cfg, p, h[:, None], conv_state=tuple(cache[n][i] for n in SSM_CACHE[:3]),
        ssm_state=cache["ssm"][i], decode=True, topo=topo)
    for n, t in zip(SSM_CACHE, (cx, cb, cc, st)):
        cache[n][i].copy_(t)
    return h2[:, 0]


def _tf_decode(cfg: ModelConfig, topo: Topology, params, cache, tokens):
    lens = cache["len"]
    h = embed(cfg, params["embed"], tokens[:, None], topo)[:, 0]
    for i in range(cfg.n_layers):
        h = _tf_decode_layer(cfg, topo, L.layer(params["layers"], i), h,
                             cache["k"][i], cache["v"][i], lens,
                             local=T.is_local(cfg, i))
    return logits_of(cfg, params, h, topo), dict(cache, len=lens + 1)


def _ssm_decode(cfg: ModelConfig, topo: Topology, params, cache, tokens):
    h = embed(cfg, params["embed"], tokens[:, None], topo)[:, 0]
    for i in range(cfg.n_layers):
        h = _ssm_decode_layer(cfg, topo, L.layer(params["layers"], i), h,
                              cache, i)
    return (logits_of(cfg, params, h, topo),
            dict(cache, len=cache["len"] + 1))


def _hybrid_decode(cfg: ModelConfig, topo: Topology, params, cache, tokens):
    """The shared block runs in its decode flavour (the reference's
    ``_shared_decode_block``, whose config agrees with ``_shared_cfg``):
    on a mesh ``_tf_decode_layer``'s, so in "seq" cache mode only the
    owner of position ``len`` appends (``append_kv_owned``)."""
    k = cfg.shared_attn_every
    n_scan = n_scan_layers(cfg)
    lens = cache["len"]
    scfg = _shared_cfg(cfg)
    h = embed(cfg, params["embed"], tokens[:, None], topo)[:, 0]
    for i in range(n_scan):
        h = _ssm_decode_layer(cfg, topo, L.layer(params["layers"], i), h,
                              cache, i)
        if i % k == k - 1:
            a = i // k
            h = _tf_decode_layer(scfg, topo, params["shared"], h,
                                 cache["shared_k"][a], cache["shared_v"][a],
                                 lens, local=False)
    for i in range(n_scan, cfg.n_layers):
        h = _ssm_decode_layer(cfg, topo,
                              L.layer(params["tail_layers"], i - n_scan), h,
                              cache, i)
    return logits_of(cfg, params, h, topo), dict(cache, len=lens + 1)


def _wh_decode_layer(cfg, topo, p, h, kc, vc, xk, xv, lens, xlen):
    """Whisper decoder layer for one token: self-attention over its cache
    (:func:`_self_attention_decode`: the token's K/V go in at ``lens``),
    cross-attention over all the frames' K/V (the reference's
    ``mode="heads"``: the rank's heads of the cross cache, every head where
    it is not split), MLP.  h (B, d).  The residual adds run as the
    reference's decode writes them, ``(h + o) + b``, each row-parallel
    output's bias added once after its all-reduce."""
    B, hd = h.shape[0], cfg.head_dim
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    h = h + _self_attention_decode(cfg, topo, W.leaves(cfg), p, hn, kc, vc,
                                   lens, pre="s_", f32_sum=True) + p["s_bo"]
    hn = L.layer_norm(h, p["x_ln_w"], p["x_ln_b"])
    (eq, lo, nh), _ = W.heads(cfg, topo)
    q, = W.project_heads(cfg, topo, p, hn, ["x_wq"], lo * hd, nh * hd, eq)
    att = hybrid_decode_attention(cfg, topo, q.reshape(B, nh, hd), xk, xv,
                                  xlen, mode="heads")
    h = h + W.out_proj(cfg, topo, p, "x_wo", att.reshape(B, nh * hd),
                       lo * hd, nh * hd, eq) + p["x_bo"]
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    return h + W.mlp(cfg, topo, p, hn)


def _wh_decode(cfg: ModelConfig, topo: Topology, params, cache, tokens):
    """The token's position is row ``len`` of the sinusoid table, taken at
    the cache's global length (on a "seq" rank its block holds L/tp of
    them)."""
    lens = cache["len"]
    rows = cache["k"].shape[2]
    if kv_mode(cfg, topo) == "seq":
        rows *= seq_block(topo, rows)[2]
    pos = W.sinusoid(rows, cfg.d_model, device=tokens.device)
    h = (embed_lookup(topo, params["embed"], tokens[:, None],
                      vocab=cfg.vocab_padded)[:, 0] + pos[lens.long()])
    xlen = torch.full_like(lens, cache["xk"].shape[2])     # every frame
    for i in range(cfg.n_layers):
        h = _wh_decode_layer(cfg, topo, L.layer(params["dec_layers"], i), h,
                             cache["k"][i], cache["v"][i], cache["xk"][i],
                             cache["xv"][i], lens, xlen)
    return W.head(cfg, params, h, topo), dict(cache, len=lens + 1)


_DECODE = {"dense": _tf_decode, "moe": _tf_decode, "vlm": _tf_decode,
           "ssm": _ssm_decode, "hybrid": _hybrid_decode, "audio": _wh_decode}


def make_decode_step(cfg: ModelConfig, topo: Topology = ONE_DEVICE):
    """decode_step(params, cache, tokens (B,)) -> (logits (B, V_padded) f32,
    the cache, written in place, with ``len`` advanced).  On a mesh the
    rank's blocks in and its logits block (B_r, V_padded / tp) out."""
    return partial(_DECODE[cfg.family], cfg, topo)


def make_prefill(cfg: ModelConfig, S: int, room: int = 0,
                 topo: Topology = ONE_DEVICE):
    """prefill(params, batch) -> (last-position logits (B, V_padded), cache
    holding S positions and ``room`` more, zeros, for decode).  On a mesh
    the rank's blocks in, its logits and cache blocks out; in "seq" cache mode the room is rounded up so that S +
    room divides over the ``kv_seq`` axes."""
    from repro_torch.serving.prefill import prefill_fn
    return partial(prefill_fn, cfg, topo, S, room)
