"""Decoder-only LM, dense, MoE and the VLM backbone
(``repro/models/transformer.py``):
parameter specs, the attention block (prefill attention through the
``flash_attention`` kernel), the FFN block (SwiGLU, or the routed experts of
``models/moe.py`` with their shared experts), the decoder layer and the
forward pass, with gemma2's local/global alternation, GQA, qkv bias,
post-norms and softcaps.  The zamba2 shared block is one such decoder layer.
``RunOptions`` carries the reference's attention tiles (they tile the
attention's backward; the kernel keeps its own), its rematerialisation
(with ``remat`` each scanned layer body runs under
``torch.utils.checkpoint``, saving the weight products (``"dots"``) or
nothing (``"full"``)) and its two mesh transforms, ``pad_heads`` and
``moe_mode``.

Every function takes a ``Topology``.  On one device (``ONE_DEVICE``) every
head, row and expert is local and no collective runs.  On a
``torch.distributed`` mesh a rank holds its blocks of the parameters, the
batch and the cache, and the collectives the reference's GSPMD places
where ``topo.constrain`` pins a layout are explicit: the fsdp dimension of
every weight gathered before use (ZeRO-3), the attention in one of the
reference's three branches (:func:`attention_branch`), the FFN
column-parallel then row-parallel on ``ff`` with one all-reduce over
``model``, the vocab-sharded embedding and LM head
(``models/embedding.py``).  Each choice between a local block and a gather
is made from global shapes, so every rank of a group enters the same
collectives in the same order."""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as C

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed, logits_of
from repro_torch.models.moe import moe_dispatch, moe_ffn
from repro_torch.parallel.sharding import ParamSpec as PS, Topology


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


_BIAS = {"wq": "bq", "wk": "bk", "wv": "bv"}


@dataclasses.dataclass(frozen=True, eq=False)
class Leaves:
    """One layer's leaves as the mesh helpers below read them: each leaf's
    ParamSpec (unstacked) by name, so a rank's block of a stacked leaf is a
    block of it layer by layer, and the bias leaf that follows each
    projection (``bq`` after ``wq``; whisper's ``s_bq`` after ``s_wq``,
    ``b_in`` after ``w_in``).  The transformer's is :func:`leaves`;
    ``whisper.leaves`` is the audio family's."""
    specs: dict
    bias: dict


@functools.lru_cache(maxsize=None)
def leaves(cfg: ModelConfig) -> Leaves:
    """The transformer layer's :class:`Leaves`: ``layer_param_specs``, with
    the qkv biases where the config has them."""
    return Leaves(layer_param_specs(cfg, stacked=False),
                  dict(_BIAS) if cfg.qkv_bias else {})


def _w(topo: Topology, lv: Leaves, p, name: str, keep=()):
    """Leaf ``name`` of layer ``p`` with every sharded dimension gathered
    but those in ``keep`` (the fsdp dimension is always gathered: the
    reference's ZeRO-3 gather before use)."""
    if not topo.sharded():
        return p[name]
    s = lv.specs[name]
    return topo.full(p[name], s.shape, s.logical_axes, keep=keep)


def _entry(topo: Topology, lv: Leaves, name: str, dim: int):
    s = lv.specs[name]
    return topo.spec_for(s.shape, s.logical_axes)[dim]


def _whole(topo: Topology, lv: Leaves, p, names):
    """Leaves ``names`` of layer ``p`` gathered whole: the fsdp dimension
    leaf by leaf, then the head dimensions of all of them that the rank
    holds a block of in one collective an entry and dtype
    (``Topology.gather_many``)."""
    out, groups = {}, {}
    for n in names:
        s = lv.specs[n]
        dim = next((d for d, ax in enumerate(s.logical_axes)
                    if ax in ("heads", "kv_heads")), None)
        w = _w(topo, lv, p, n, keep=() if dim is None else (dim,))
        if dim is None or w.shape[dim] == s.shape[dim]:
            out[n] = w
        else:
            groups.setdefault((_entry(topo, lv, n, dim), w.dtype),
                              []).append((n, w, dim))
    for (e, _), items in groups.items():
        got = topo.gather_many([w for _, w, _ in items],
                               [d for _, _, d in items], e)
        out.update((n, g) for (n, _, _), g in zip(items, got))
    return out


def _project(topo: Topology, lv: Leaves, p, x, names):
    """x (..., d), the same on every rank of the group, times every column
    of each leaf in ``names`` (d, N), plus its bias where the layer has
    one (``lv.bias``), in one collective: the products of the stored
    column blocks all-gathered where x has fewer rows than d (decode), else
    the weights gathered whole (:func:`_whole`)."""
    d = lv.specs[names[0]].shape[0]
    ws = {n: _w(topo, lv, p, n, keep=(1,)) for n in names}
    part = [n for n in names if ws[n].shape[1] != lv.specs[n].shape[1]]
    bias = lambda n, W: 0 if n not in lv.bias else W[lv.bias[n]]
    if part and x[..., 0].numel() < d:
        ys = {n: L.dot(x, ws[n]) + bias(n, p) for n in names}
        groups = {}
        for n in part:
            groups.setdefault(_entry(topo, lv, n, 1), []).append(n)
        for e, ns in groups.items():
            ys.update(zip(ns, topo.gather_many(
                [ys[n] for n in ns], [ys[n].dim() - 1 for n in ns], e)))
        return [ys[n] for n in names]
    W = _whole(topo, lv, p, list(names) + [
        lv.bias[n] for n in names if n in lv.bias])
    return [L.dot(x, W[n]) + bias(n, W) for n in names]


def _local_cols(topo: Topology, lv: Leaves, p, name: str, x,
                lo: int, n: int, entry):
    """x (..., d) times columns [lo, lo + n) of leaf ``name`` (plus bias):
    the rank's share of the heads (or ``ff`` columns) under ``entry``,
    which its stored block holds (the heads branch: whole heads of the
    rank) unless the leaf is stored whole."""
    w = _w(topo, lv, p, name, keep=(1,))
    b = p[lv.bias[name]] if name in lv.bias else None
    if not topo.sharded() or w.shape[1] == lv.specs[name].shape[1]:
        if n != w.shape[1]:             # a whole leaf: the rank's columns
            w = w[:, lo:lo + n]
            b = None if b is None else b[lo:lo + n]
    elif w.shape[1] != n or _entry(topo, lv, name, 1) != entry:
        raise ValueError(f"{name}: the rank's columns are not its heads")
    y = L.dot(x, w)
    return y if b is None else y + b


def _local_rows(topo: Topology, lv: Leaves, p, name: str, x,
                lo: int, n: int, entry, f32_sum: bool = False):
    """x (..., n) times rows [lo, lo + n) of leaf ``name`` (N, d), x's
    columns the rank's share of the heads under ``entry``, the partial sum
    all-reduced over it; the stored block holds those rows unless the leaf
    is stored whole.  With ``f32_sum`` a partial sum over more than one
    rank goes in float32 and is rounded once after the all-reduce, so a
    bf16 product rounds as on one device up to the order of float32
    sums."""
    w = _w(topo, lv, p, name, keep=(0,))
    if not topo.sharded() or w.shape[0] == lv.specs[name].shape[0]:
        if n != w.shape[0]:             # a whole leaf: the rank's rows
            w = w[lo:lo + n]
    elif w.shape[0] != n or _entry(topo, lv, name, 0) != entry:
        raise ValueError(f"{name}: the rank's rows are not its heads")
    if f32_sum and n != lv.specs[name].shape[0]:
        t = torch.promote_types(x.dtype, w.dtype)
        return topo.all_reduce(x.float() @ w.float(), entry).to(t)
    return topo.all_reduce(L.dot(x, w), entry)


def _heads(topo: Topology, logical: str, n: int):
    """(entry, first, count) of this rank's share of ``n`` heads (or rows)
    under a logical axis: its mesh axes where they divide ``n``."""
    if not topo.sharded():
        return None, 0, n
    axes = topo._mesh_axes_for(logical, n)
    e = None if not axes else (axes[0] if len(axes) == 1 else axes)
    lo, cnt = topo.extent(e, n)
    return e, lo, cnt


def attention_branch(cfg: ModelConfig, topo: Topology,
                     pad_heads: bool = False) -> str:
    """The reference's choice (``attention_block``): "heads" where the
    ``model`` axis is 1 or divides the query heads, else "padded" under
    ``pad_heads``, else "seq" (sequence-parallel)."""
    tp = topo.axis_sizes.get("model", 1)
    if tp == 1 or cfg.n_heads % tp == 0:
        return "heads"
    return "padded" if pad_heads else "seq"


def _rope_qk(q, k, cos, sin, hd):
    B, S = q.shape[:2]
    q = L.apply_rope(q.reshape(B, S, -1, hd), cos, sin)
    k = L.apply_rope(k.reshape(B, S, -1, hd), cos, sin)
    return q, k


def attention_block(cfg: ModelConfig, topo: Topology, p, h, cos, sin, *,
                    window: Optional[int], return_kv: bool = False,
                    q_block: int = 512, kv_block: int = 512,
                    pad_heads: bool = False):
    """Causal self-attention block on this rank's batch block h (B, S, d),
    the same on every rank of its ``model`` group, in the reference's
    branch (:func:`attention_branch`):

    * "heads": the rank's Hq/tp query heads (every head where the rules
      give heads no axis); the kv heads it owns where they split the same
      way, else every kv head computed and repeated to its query heads
      (glm4's 2, granite's 8); the output projection row-parallel, one
      all-reduce over ``model``;
    * "padded": query heads zero-padded to a multiple of tp (K/V repeated
      to them), the rank's Hpad/tp heads through the kernel, ``wo`` with
      zero rows for the padding, one all-reduce;
    * "seq": the rank's S/tp query rows of every head through the kernel
      with ``q_offset`` against every key, its rows of the output
      projection, then an all-gather on the sequence.

    Projection columns that are not whole heads of the rank (qwen1.5-4b's
    ``wq`` at tp 8 is 2.5 heads a rank, glm4's ``wk`` at tp 4 half a head)
    are gathered first, and the padded and sequence-parallel branches
    gather ``wq``, ``wk``, ``wv`` and ``wo`` whole in one collective.
    With ``return_kv`` also the K and V rows (B, S, Hkv_r, hd) in the
    serving cache's layout: the rank's kv heads in "heads" cache mode,
    every kv head in "seq" mode."""
    B, S, _ = h.shape
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    G = Hq // Hkv
    hn = L.rms_norm(h, p["attn_norm"])
    lv = leaves(cfg)
    branch = attention_branch(cfg, topo, pad_heads)
    gather_seq = None
    attn = functools.partial(L.block_attention, causal=True, window=window,
                             attn_softcap=cfg.attn_softcap, q_block=q_block,
                             kv_block=kv_block)
    if branch == "heads":
        eq, lo, nh = _heads(topo, "heads", Hq)
        ekv, klo, nk = _heads(topo, "kv_heads", Hkv)
        q = _local_cols(topo, lv, p, "wq", hn, lo * hd, nh * hd, eq)
        if nh == Hq or (ekv == eq and nk * G == nh):
            if nh == Hq:
                ekv, klo, nk = None, 0, Hkv
            k = _local_cols(topo, lv, p, "wk", hn, klo * hd, nk * hd, ekv)
            v = _local_cols(topo, lv, p, "wv", hn, klo * hd, nk * hd, ekv)
            q, k = _rope_qk(q, k, cos, sin, hd)
            v = v.reshape(B, S, nk, hd)
            ka, va = k, v
        else:                       # repeat K/V to the rank's query heads
            k, v = _project(topo, lv, p, hn, ("wk", "wv"))
            q, k = _rope_qk(q, k, cos, sin, hd)
            v = v.reshape(B, S, Hkv, hd)
            idx = torch.arange(lo, lo + nh, device=h.device) // G
            ka, va = k[:, :, idx], v[:, :, idx]
        out = attn(q, ka, va)
        o = _local_rows(topo, lv, p, "wo", out.reshape(B, S, nh * hd),
                        lo * hd, nh * hd, eq)
    else:
        names = ["wq", "wk", "wv", "wo"] + [
            lv.bias[n] for n in ("wq", "wk", "wv") if n in lv.bias]
        W = _whole(topo, lv, p, names)
        proj = lambda x, n: x @ W[n] + (W[lv.bias[n]] if n in lv.bias
                                        else 0)
        k = L.apply_rope(proj(hn, "wk").reshape(B, S, Hkv, hd), cos, sin)
        v = proj(hn, "wv").reshape(B, S, Hkv, hd)
        if branch == "padded":
            tp = topo.axis_sizes["model"]
            eq, lo, nh = _heads(topo, "heads", -(-Hq // tp) * tp)
            real = max(0, min(lo + nh, Hq) - lo)      # the rank's real heads
            c0 = min(lo, Hq) * hd
            W["wq"] = W["wq"][:, c0:c0 + real * hd]
            if "wq" in lv.bias:
                W["bq"] = W["bq"][c0:c0 + real * hd]
            q = L.apply_rope(proj(hn, "wq").reshape(B, S, real, hd), cos,
                             sin)
            idx = torch.arange(lo, lo + real, device=h.device) // G
            zpad = (0, 0, 0, nh - real)
            out = attn(F.pad(q, zpad), F.pad(k[:, :, idx], zpad),
                       F.pad(v[:, :, idx], zpad))
            o = topo.all_reduce(out[:, :, :real].reshape(B, S, real * hd)
                                @ W["wo"][c0:c0 + real * hd], eq)
        else:                                         # sequence-parallel
            gather_seq, q_off, ns = _heads(topo, "kv_seq", S)
            q = L.apply_rope(proj(hn[:, q_off:q_off + ns], "wq").reshape(
                B, ns, Hq, hd), cos[q_off:q_off + ns], sin[q_off:q_off + ns])
            out = attn(q, k, v, q_offset=q_off)
            o = out.reshape(B, ns, Hq * hd) @ W["wo"]
    if cfg.post_norms:
        o = L.rms_norm(o, p["attn_post_norm"])
    if gather_seq is not None:
        o = topo.gather(o, 1, gather_seq)
    h = h + o
    return (h, k, v) if return_kv else h


def _swiglu(topo: Topology, cfg: ModelConfig, p, x, gate, up, down):
    """SwiGLU with ``gate``/``up`` column-parallel and ``down`` row-parallel
    on ``ff``: one all-reduce over the axes ``ff`` is split over."""
    lv = leaves(cfg)
    e = _entry(topo, lv, gate, 1) if topo.sharded() else None
    y = L.swiglu(x, _w(topo, lv, p, gate, keep=(1,)),
                 _w(topo, lv, p, up, keep=(1,)),
                 _w(topo, lv, p, down, keep=(0,)))
    return topo.all_reduce(y, e)


def ffn_block(cfg: ModelConfig, topo: Topology, p, h,
              moe_mode: str = "auto"):
    """h (B, S, d) plus the FFN of its norm: SwiGLU, or the routed experts
    over the B x S tokens (``moe_ffn`` in ``moe_mode``) plus the shared
    experts' SwiGLU, added in h's dtype.  The decode step calls it on
    (B, 1, d), so its B tokens are routed together.  On a mesh the expert
    stacks' fsdp dimension is gathered, and the experts themselves where
    the dispatch mode runs every expert on the rank."""
    hn = L.rms_norm(h, p["mlp_norm"])
    if cfg.is_moe:
        B, S = hn.shape[:2]
        mode = moe_dispatch(cfg, topo, B * S, moe_mode)
        keep = () if mode in ("local", "replicated") else (0,)
        ws = [_w(topo, leaves(cfg), p, n, keep=keep)
              for n in ("we_gate", "we_up", "we_down")]
        out = moe_ffn(cfg, topo, hn, p["router"], *ws, mode=mode)
        if cfg.n_shared_experts:
            out = out + _swiglu(topo, cfg, p, hn, "ws_gate", "ws_up",
                                "ws_down")
    else:
        out = _swiglu(topo, cfg, p, hn, "w_gate", "w_up", "w_down")
    if cfg.post_norms:
        out = L.rms_norm(out, p["mlp_post_norm"])
    return h + out


def decoder_layer(cfg: ModelConfig, topo: Topology, p, h, cos, sin, *,
                  local: bool, q_block: int = 512, kv_block: int = 512,
                  pad_heads: bool = False, moe_mode: str = "auto"):
    window = cfg.sliding_window if local else None
    h = attention_block(cfg, topo, p, h, cos, sin, window=window,
                        q_block=q_block, kv_block=kv_block,
                        pad_heads=pad_heads)
    return ffn_block(cfg, topo, p, h, moe_mode=moe_mode)


@dataclasses.dataclass(frozen=True)
class RunOptions:
    """The reference's ``RunOptions``: attention tiles, rematerialisation,
    and its two exact transforms on a mesh, ``pad_heads`` (zero-pad the
    query heads to shard over ``model`` where they do not divide it) and
    ``moe_mode`` (force the MoE dispatch mode)."""
    q_block: int = 512
    kv_block: int = 512
    remat: bool = True
    remat_policy: Optional[str] = "dots"   # None | "dots" | "full"
    pad_heads: bool = False
    moe_mode: str = "auto"


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


def forward(cfg: ModelConfig, topo: Topology, params, tokens,
            opts: Optional[RunOptions] = None, *, extra_embeds=None):
    """tokens (B, S) -> logits (B, S, V) float32; ``extra_embeds``
    (B, P, d), the VLM's patch embeddings, take the first P positions.  The
    layers run in groups of ``local_global_pattern`` (the reference's
    scanned body), each group rematerialised as ``opts`` says.  On a mesh
    ``params`` are this rank's blocks (``convert.params_block``), tokens
    and patch embeddings its batch block, and the logits its block:
    (B_r, S, V/tp) where the rules split the vocab over ``model``."""
    opts = opts or RunOptions()
    g = max(1, cfg.local_global_pattern)
    if cfg.n_layers % g:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"groups of {g}")
    h = with_patches(embed(cfg, params["embed"], tokens, topo), extra_embeds)
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    cos, sin = L.rope_tables(pos, cfg.head_dim, cfg.rope_theta)
    per_layer = L.layers(params["layers"])

    def group(hh, first):
        for i in range(first, first + g):
            hh = decoder_layer(cfg, topo, per_layer[i], hh, cos, sin,
                               local=is_local(cfg, i), q_block=opts.q_block,
                               kv_block=opts.kv_block,
                               pad_heads=opts.pad_heads,
                               moe_mode=opts.moe_mode)
        return hh
    body = maybe_remat(group, opts)
    for first in range(0, cfg.n_layers, g):
        h = body(h, first)
    return logits_of(cfg, params, h, topo)
