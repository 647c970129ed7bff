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

Every function takes a ``Topology`` (``ONE_DEVICE`` by default).  On a
``torch.distributed`` mesh a rank holds its blocks of the parameters
(:func:`leaves`: the reference's axes), the batch and the cache, and runs
the reference's GSPMD layout with its collectives explicit, through the
transformer's mesh helpers: each attention (encoder self, decoder self,
cross) on the rank's heads where the ``model`` axis divides them (q/k/v
column blocks with ``s_bq``/``s_bv`` beside them, ``wo`` row-parallel with
one all-reduce, ``s_bo`` added once after it), else every head on every
rank (the reference's ``spec_for`` drops the axis; there is no padded or
sequence-parallel branch), the weights gathered whole and nothing reduced,
or in decode ``wo``'s stored rows and one all-reduce; the GELU
MLP column-parallel over ``ff`` (``b_in`` with it) and row-parallel, one
all-reduce, ``b_out`` once; the fsdp dimension of every weight gathered
before use; the vocab-sharded embedding and tied LM head.  Row-parallel
partial sums go in float32 and are rounded once.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.embedding import embed_lookup, lm_head, vocab_block
from repro_torch.models.transformer import RunOptions, maybe_remat
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS, Topology


def _attn_specs(cfg, Ldim, cross: bool = False):
    La = (None,) * len(Ldim)
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
    La = (None,) * len(Ldim)
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


def sinusoid(S: int, d: int, *, device):
    """(S, d) bf16: sin then cos of pos / 10000^(2i/d), computed in float64
    and rounded to bf16 as the reference's ``jnp.asarray`` rounds it.  Row
    p does not depend on S.  Memoized per (S, d, device); do not write into
    it."""
    return _sinusoid(S, d, str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def leaves(cfg: ModelConfig) -> T.Leaves:
    """A whisper layer's leaves for the transformer's mesh helpers: the
    decoder layer's specs, unstacked (the encoder layer's are the same
    names and shapes without ``x_*``), and the bias after each
    projection."""
    return T.Leaves({**_attn_specs(cfg, ()), **_attn_specs(cfg, (), True),
                     **_mlp_specs(cfg, ())},
                    {"s_wq": "s_bq", "s_wv": "s_bv", "x_wq": "x_bq",
                     "x_wv": "x_bv", "w_in": "b_in"})


def attention_branch(cfg: ModelConfig, topo: Topology) -> str:
    """"heads" where the ``model`` axis is 1 or divides the heads, else
    "every head": each rank computes all of them (the reference's
    ``spec_for`` drops the axis)."""
    tp = topo.axis_sizes.get("model", 1)
    return "heads" if tp == 1 or cfg.n_heads % tp == 0 else "every head"


def heads(cfg: ModelConfig, topo: Topology):
    """((entry, first, count) of the rank's query heads, the same of its kv
    heads): the kv heads its blocks of ``wk``/``wv`` and of the cross cache
    hold, which must be those its query heads attend.  Every head where
    the rules or the shape give heads no axis."""
    q = T._heads(topo, "heads", cfg.n_heads)
    kv = T._heads(topo, "kv_heads", cfg.n_kv_heads)
    if kv[2] * (cfg.n_heads // cfg.n_kv_heads) != q[2]:
        raise ValueError(f"{cfg.name}: a rank's kv heads are not those of "
                         f"its query heads on {topo.axis_sizes}")
    return q, kv


def project_heads(cfg, topo, p, x, names, lo: int, n: int, entry):
    """x (..., d) times columns [lo, lo + n) of each leaf in ``names`` (the
    rank's heads, or kv heads, under ``entry``; each leaf's bias with
    them): its stored blocks where they hold those columns; where every
    rank computes every head while a leaf's columns still split (6 heads of
    dim 16 over 4 ranks: 24 of 96 columns a rank), every column through
    ``transformer._project`` (one collective)."""
    lv = leaves(cfg)
    if topo.sharded() and n == lv.specs[names[0]].shape[1]:
        return T._project(topo, lv, p, x, names)
    return [T._local_cols(topo, lv, p, nm, x, lo, n, entry) for nm in names]


def out_proj(cfg, topo, p, name, x, lo: int, n: int, entry):
    """x (..., n), the attention output of the rank's heads [lo, lo + n) of
    leaf ``name`` (N, d), times their rows, the float32 partial sums
    all-reduced over ``entry`` and rounded once.  Where every rank computes
    every head (n = N) on a mesh: the leaf gathered whole and nothing
    reduced, or, for fewer rows of x than d (decode), the rank's stored
    rows and one all-reduce."""
    lv = leaves(cfg)
    N, d = lv.specs[name].shape
    if not topo.sharded() or n != N:
        return T._local_rows(topo, lv, p, name, x, lo, n, entry, f32_sum=True)
    er = T._entry(topo, lv, name, 0)
    if er is not None and x[..., 0].numel() < d:
        rlo, rn = topo.extent(er, N)
        return T._local_rows(topo, lv, p, name, x[..., rlo:rlo + rn], rlo,
                             rn, er, f32_sum=True)
    return L.dot(x, T._whole(topo, lv, p, [name])[name])


def _mha(cfg, topo, h_q, h_kv, p, pre, *, causal, opts, return_kv=False):
    """Attention of h_q (B, Sq, d) over h_kv (B, Sk, d) with prefix ``pre``'s
    weights, on the rank's heads (every head on one device, or where the
    ``model`` axis does not divide them); with ``return_kv`` also its (B,
    Sk, Hkv_r, hd) K and V, the rank's kv heads."""
    B, Sq, _ = h_q.shape
    Sk = h_kv.shape[1]
    hd = cfg.head_dim
    (eq, lo, nh), (ekv, klo, nk) = heads(cfg, topo)
    q, = project_heads(cfg, topo, p, h_q, [f"{pre}_wq"], lo * hd, nh * hd,
                       eq)
    k, v = project_heads(cfg, topo, p, h_kv, [f"{pre}_wk", f"{pre}_wv"],
                         klo * hd, nk * hd, ekv)
    q = q.reshape(B, Sq, nh, hd)
    k, v = (t.reshape(B, Sk, nk, hd) for t in (k, v))
    out = L.block_attention(q, k, v, causal=causal, q_block=opts.q_block,
                            kv_block=opts.kv_block)
    o = out_proj(cfg, topo, p, f"{pre}_wo", out.reshape(B, Sq, nh * hd),
                 lo * hd, nh * hd, eq) + p[f"{pre}_bo"]
    return (o, k, v) if return_kv else o


def mlp(cfg, topo, p, x):
    """The GELU MLP of x (..., d): ``w_in`` column-parallel over ``ff``
    with ``b_in``, ``w_out`` row-parallel with one all-reduce, ``b_out``
    once (``layers.gelu_mlp`` on one device)."""
    lv = leaves(cfg)
    e = T._entry(topo, lv, "w_in", 1) if topo.sharded() else None
    lo, n = topo.extent(e, cfg.d_ff)
    hid = L.gelu(T._local_cols(topo, lv, p, "w_in", x, lo, n, e))
    return T._local_rows(topo, lv, p, "w_out", hid, lo, n, e,
                         f32_sum=True) + p["b_out"]


def encoder_layer(cfg, p, h, opts, topo: Topology = ONE_DEVICE):
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    h = h + _mha(cfg, topo, hn, hn, p, "s", causal=False, opts=opts)
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    return h + mlp(cfg, topo, p, hn)


def decoder_layer(cfg, p, h, enc_out, opts, return_kv=False,
                  topo: Topology = ONE_DEVICE):
    """Causal self-attention, cross-attention over enc_out (B, Se, d), MLP.
    With ``return_kv`` also the self-attention's K/V and the cross K/V (on
    a mesh the rank's kv heads)."""
    hn = L.layer_norm(h, p["s_ln_w"], p["s_ln_b"])
    o, k, v = _mha(cfg, topo, hn, hn, p, "s", causal=True, opts=opts,
                   return_kv=True)
    h = h + o
    hn = L.layer_norm(h, p["x_ln_w"], p["x_ln_b"])
    o, xk, xv = _mha(cfg, topo, hn, enc_out, p, "x", causal=False, opts=opts,
                     return_kv=True)
    h = h + o
    hn = L.layer_norm(h, p["m_ln_w"], p["m_ln_b"])
    h = h + mlp(cfg, topo, p, hn)
    return (h, k, v, xk, xv) if return_kv else h


def encode(cfg, params, frames, opts=None, topo: Topology = ONE_DEVICE):
    """frames (B, encoder_seq, d), the stub frontend's output (on a mesh
    the rank's batch block) -> the encoder's normed output.  Its input is
    rounded to bf16, as the reference's."""
    opts = opts or RunOptions()
    h = (frames + sinusoid(frames.shape[1], cfg.d_model,
                           device=frames.device)[None]
         ).to(torch.bfloat16)
    per_layer = L.layers(params["enc_layers"])
    body = maybe_remat(lambda hh, i: encoder_layer(cfg, per_layer[i], hh,
                                                   opts, topo), opts)
    for i in range(cfg.encoder_layers):
        h = body(h, i)
    return L.layer_norm(h, params["enc_ln_w"], params["enc_ln_b"])


def no_frames(cfg, B, device):
    """The reference's default when a batch has no frames: zeros, bf16."""
    return torch.zeros((B, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                       device=device)


def embed_tokens(cfg, params, tokens, topo: Topology = ONE_DEVICE):
    """The token embeddings plus their sinusoidal positions (B, S, d); on a
    mesh ``params["embed"]`` is the rank's vocab block."""
    return embed_lookup(topo, params["embed"], tokens,
                        vocab=cfg.vocab_padded) + sinusoid(
        tokens.shape[1], cfg.d_model, device=tokens.device)[None]


def head(cfg, params, h, topo: Topology = ONE_DEVICE):
    """``dec_ln``, then the tied ``embed`` table in float32 with the padded
    vocab masked -> (..., V_padded) float32; on a mesh the rank's vocab
    block (..., V_padded / tp)."""
    return lm_head(cfg, params["embed"],
                   L.layer_norm(h, params["dec_ln_w"], params["dec_ln_b"]),
                   vocab_block(cfg, topo)[0])


def forward(cfg: ModelConfig, params, tokens, *, frames=None, opts=None,
            topo: Topology = ONE_DEVICE):
    """Teacher-forced: encode ``frames`` (zeros when None), decode tokens
    (B, S) -> logits (B, S, V_padded) float32.  Each layer body runs under
    ``maybe_remat``.  On a mesh the rank's blocks in (tokens and frames
    its batch block) and its logits block (B_r, S, V_padded / tp) out."""
    opts = opts or RunOptions()
    if frames is None:
        frames = no_frames(cfg, tokens.shape[0], tokens.device)
    enc_out = encode(cfg, params, frames, opts, topo)
    h = embed_tokens(cfg, params, tokens, topo)
    per_layer = L.layers(params["dec_layers"])
    body = maybe_remat(lambda hh, enc, i: decoder_layer(
        cfg, per_layer[i], hh, enc, opts, topo=topo), opts)
    for i in range(cfg.n_layers):
        h = body(h, enc_out, i)
    return head(cfg, params, h, topo)
