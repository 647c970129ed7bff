"""Mamba2 (SSD, arXiv:2405.21060): counterpart of ``repro/models/mamba2.py``,
the layer (which zamba2 stacks too) and the pure-SSM model (mamba2-780m).

Prefill runs the chunked SSD scan through the ``ssd_scan`` kernel
(``ssd_chunked`` folds ``xdt = x * dt`` and ``dA = dt * A`` and cuts the
sequence into chunks); decode is the O(1) recurrent step ``ssd_step``.

On a mesh (``topo``) a rank holds its blocks of ``mamba_layer_specs``
(the reference's axes) and runs the reference's GSPMD layout with its
collectives explicit: :func:`mamba_block` computes the rank's ``d_inner``
channels and SSM heads (:func:`layout`), so the ``ssd_scan`` kernel runs
at the rank's head count.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed, logits_of
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS, Topology


def mamba_layer_specs(cfg: ModelConfig, n_layers: Optional[int] = None,
                      stacked: bool = True):
    d, di = cfg.d_model, cfg.d_inner
    H, N, G, K = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, cfg.conv_width
    Ld = (n_layers if n_layers is not None else cfg.n_layers,) if stacked else ()
    La = (None,) if stacked else ()
    return {
        "norm": PS(Ld + (d,), La + (None,), "ones"),
        "wz": PS(Ld + (d, di), La + ("fsdp", "ff"), "scaled"),
        "wx": PS(Ld + (d, di), La + ("fsdp", "ff"), "scaled"),
        "wB": PS(Ld + (d, G * N), La + ("fsdp", None), "scaled"),
        "wC": PS(Ld + (d, G * N), La + ("fsdp", None), "scaled"),
        "wdt": PS(Ld + (d, H), La + ("fsdp", "heads"), "scaled"),
        "conv_x_w": PS(Ld + (K, di), La + (None, "ff"), "normal", scale=0.1),
        "conv_x_b": PS(Ld + (di,), La + ("ff",), "zeros"),
        "conv_B_w": PS(Ld + (K, G * N), La + (None, None), "normal",
                       scale=0.1),
        "conv_B_b": PS(Ld + (G * N,), La + (None,), "zeros"),
        "conv_C_w": PS(Ld + (K, G * N), La + (None, None), "normal",
                       scale=0.1),
        "conv_C_b": PS(Ld + (G * N,), La + (None,), "zeros"),
        "A_log": PS(Ld + (H,), La + ("heads",), "zeros"),
        "D": PS(Ld + (H,), La + ("heads",), "ones"),
        "dt_bias": PS(Ld + (H,), La + ("heads",), "zeros"),
        "gnorm": PS(Ld + (di,), La + ("ff",), "ones"),
        "wo": PS(Ld + (di, d), La + ("ff", "fsdp"), "scaled"),
    }


def param_specs(cfg: ModelConfig):
    return {
        "embed": PS((cfg.vocab_padded, cfg.d_model), ("vocab", None), "normal"),
        "final_norm": PS((cfg.d_model,), (None,), "ones"),
        "layers": mamba_layer_specs(cfg),
    }


def causal_conv(x, w, b, state=None):
    """Depthwise causal conv.  x (B, S, C); w (K, C); state (B, K-1, C) holds
    the last K-1 inputs.  Returns (silu(conv + b) in x's dtype, new state)."""
    B, S, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    xp = torch.cat([state, x], dim=1)
    y = torch.zeros((B, S, C), dtype=torch.float32, device=x.device)
    for j in range(K):
        y = y + xp[:, j:j + S].float() * w[j].float()
    y = F.silu(y + b.float()).to(x.dtype)
    return y, xp[:, S:]


def ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan through the ``ssd_scan`` kernel.

    xh (B, S, H, P) bf16; dt (B, S, H) f32 (post-softplus); A (H,) f32
    negative; Bm/Cm (B, S, N) (one group).  Returns (y (B, S, H, P) in xh's
    dtype, final state (B, H, N, P) f32)."""
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        raise ValueError(f"ssd_chunked: sequence {S} is not a multiple of the "
                         f"chunk {Q}")
    nc = S // Q
    xdt = (xh.float() * dt[..., None]).reshape(B, nc, Q, H, P)
    dA = (dt * A).reshape(B, nc, Q, H)
    Bc = Bm.float().reshape(B, nc, Q, N)
    Cc = Cm.float().reshape(B, nc, Q, N)
    # h_tile is the TPU contract's; on the card the kernels take one head
    # per CTA and compute C·Bᵀ once for all heads
    y, state = ops.ssd_scan(xdt, dA, Bc, Cc, h_tile=1, init_state=init_state)
    return y.reshape(B, S, H, P).to(xh.dtype), state


def ssd_step(state, x1, dt1, A, B1, C1):
    """One decode step.  state (B, H, N, P) f32; x1 (B, H, P); dt1 (B, H);
    B1/C1 (B, N).  Returns (new state, y (B, H, P) in x1's dtype)."""
    dA = torch.exp(dt1 * A)
    upd = torch.einsum("bn,bhp->bhnp", B1.float(), x1.float() * dt1[..., None])
    state = state * dA[..., None, None] + upd
    y = torch.einsum("bn,bhnp->bhp", C1.float(), state)
    return state, y.to(x1.dtype)


class Layout(NamedTuple):
    """A rank's share of a Mamba layer on a mesh: its ``d_inner`` channels
    [flo, flo + fn) under the ``ff`` entry ``ef`` and its SSM heads
    [hlo, hlo + hn) under the ``heads`` entry ``eh`` (``spec_for`` entries,
    None where the rules or the shape give the axis nothing)."""
    ef: object
    flo: int
    fn: int
    eh: object
    hlo: int
    hn: int


def layout(cfg: ModelConfig, topo: Topology) -> Optional[Layout]:
    """The rank's :class:`Layout`, from global shapes only (so every rank
    of a group enters the same collectives); None on one device.  The
    channels follow ``gnorm``'s spec and the heads ``A_log``'s, which are
    the cache's ``conv_x`` and ``ssm`` blocks."""
    if not topo.sharded():
        return None
    di, H = cfg.d_inner, cfg.ssm_heads
    ef = topo.spec_for((di,), ("ff",))[0]
    eh = topo.spec_for((H,), ("heads",))[0]
    return Layout(ef, *topo.extent(ef, di), eh, *topo.extent(eh, H))


@functools.lru_cache(maxsize=None)
def _leaf_specs(cfg: ModelConfig):
    return mamba_layer_specs(cfg, stacked=False)


def _rank_weights(topo: Topology, cfg: ModelConfig, p, lay: Layout):
    """Layer ``p``'s leaves as the rank computes with them: the ``fsdp``
    dimension gathered (one collective an entry and dtype), the ``ff`` and
    ``heads`` dimensions cut to the layout's channels and heads (gathered
    first where a leaf's block is not the layout's)."""
    blocks = {"ff": (lay.ef, lay.flo, lay.fn),
              "heads": (lay.eh, lay.hlo, lay.hn)}
    out, groups, cut = dict(p), {}, []
    for n, s in _leaf_specs(cfg).items():
        spec = topo.spec_for(s.shape, s.logical_axes)
        for d, ax in enumerate(s.logical_axes):
            if ax == "fsdp" and spec[d] is not None:
                groups.setdefault((spec[d], p[n].dtype), []).append((n, d))
            elif ax in blocks and spec[d] != blocks[ax][0]:
                cut.append((n, d, spec[d], blocks[ax]))
    for (e, _), items in groups.items():
        got = topo.gather_many([p[n] for n, _ in items],
                               [d for _, d in items], e)
        out.update((n, g) for (n, _), g in zip(items, got))
    for n, d, have, (_, lo, cnt) in cut:
        w = out[n] if have is None else topo.gather(out[n], d, have)
        out[n] = w.narrow(d, lo, cnt)
    return out


def _heads_of(topo: Topology, xc, lay: Optional[Layout], P: int):
    """The conv output's rank channels (B, S, fn) as the rank's heads
    (B, S, hn, P): the same block where channels and heads split alike,
    else the channels gathered whole and the heads cut from them (trap:
    ``heads`` dropped while ``ff`` is kept, e.g. 2 heads over 4 ranks)."""
    B, S = xc.shape[:2]
    if lay is not None and lay.ef != lay.eh:
        if lay.ef is not None:
            xc = topo.gather(xc, 2, lay.ef)
        xc = xc[..., lay.hlo * P:(lay.hlo + lay.hn) * P]
    return xc.reshape(B, S, -1, P)


def _channels_of(topo: Topology, y, lay: Optional[Layout]):
    """The inverse of :func:`_heads_of` on y (B, S, hn * P): the rank's
    channels (B, S, fn)."""
    if lay is not None and lay.ef != lay.eh:
        if lay.eh is not None:
            y = topo.gather(y, 2, lay.eh)
        y = y[..., lay.flo:lay.flo + lay.fn]
    return y


def _gnorm(topo: Topology, cfg: ModelConfig, y, weight,
           lay: Optional[Layout], eps: float = 1e-6):
    """``layers.rms_norm`` over the whole ``d_inner``: on a rank's channel
    block the sum of squares is all-reduced over the ``ff`` entry first
    (the block's own mean square is not the layer's)."""
    if lay is None or lay.ef is None:
        return L.rms_norm(y, weight, eps)
    yf = y.float()
    ss = topo.all_reduce((yf * yf).sum(-1, keepdim=True), lay.ef)
    out = yf * torch.rsqrt(ss / cfg.d_inner + eps)
    return (out * (1.0 + weight.float())).to(y.dtype)


def mamba_block(cfg: ModelConfig, p, h, *, conv_state=None, ssm_state=None,
                decode: bool = False, return_state: bool = False,
                topo: Topology = ONE_DEVICE):
    """One Mamba2 layer with its residual.  h (B, S, d); in decode mode
    S == 1 and the states are carried.  Returns (h, None), or (h,
    (conv states, ssm state)) when decoding, when a state was passed in or
    with ``return_state`` (the states start at zero when none is given).

    On a mesh (``topo``) ``p`` holds the rank's blocks, h is its batch
    block, the same on every rank of its ``model`` group, and the rank
    computes its :func:`layout`'s channels of ``z``, ``x`` and the conv
    (depthwise, so a channel block needs no other channel), ``B`` and
    ``C`` whole, and ``dt`` and the SSD scan (the ``ssd_scan`` kernel) on
    its heads; ``gnorm`` normalises over the whole ``d_inner`` (one
    all-reduce of the sums of squares) and ``wo`` is row-parallel (one
    all-reduce over ``ff`` of float32 partial products, rounded once, so a
    bf16 layer rounds as on one device up to the order of float32 sums)
    before the residual.  The states in and out
    are the rank's blocks of the cache: ``conv_x`` its channels, ``conv_B``
    and ``conv_C`` whole, ``ssm`` its heads."""
    B, S, _ = h.shape
    P, N = cfg.ssm_head_dim, cfg.ssm_state
    lay = layout(cfg, topo)
    if lay is not None:
        p = _rank_weights(topo, cfg, p, lay)
    hn = L.rms_norm(h, p["norm"])
    z = hn @ p["wz"]
    xr = hn @ p["wx"]
    Br = hn @ p["wB"]
    Cr = hn @ p["wC"]
    dt = F.softplus((hn @ p["wdt"]).float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    cs_x = cs_B = cs_C = None
    if conv_state is not None:
        cs_x, cs_B, cs_C = conv_state
    xc, ns_x = causal_conv(xr, p["conv_x_w"], p["conv_x_b"], cs_x)
    Bc, ns_B = causal_conv(Br, p["conv_B_w"], p["conv_B_b"], cs_B)
    Cc, ns_C = causal_conv(Cr, p["conv_C_w"], p["conv_C_b"], cs_C)

    xh = _heads_of(topo, xc, lay, P)
    if decode:
        if S != 1:
            raise ValueError(f"mamba_block: decode takes one token, got {S}")
        st = (torch.zeros((B, xh.shape[2], N, P), dtype=torch.float32,
                          device=h.device)
              if ssm_state is None else ssm_state)
        new_state, y1 = ssd_step(st, xh[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0])
        y = y1[:, None]
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk,
                                   init_state=ssm_state)
    y = y + xh * p["D"].to(y.dtype)[:, None]
    y = _channels_of(topo, y.reshape(B, S, -1), lay)
    y = y * F.silu(z.float()).to(y.dtype)
    y = _gnorm(topo, cfg, y, p["gnorm"], lay)
    if lay is None or lay.ef is None:
        out = y @ p["wo"]
    else:
        out = topo.all_reduce(y.float() @ p["wo"].float(), lay.ef).to(y.dtype)
    h = h + out
    if decode or return_state or conv_state is not None \
            or ssm_state is not None:
        return h, ((ns_x, ns_B, ns_C), new_state)
    return h, None


def forward(cfg: ModelConfig, params, tokens, opts=None,
            topo: Topology = ONE_DEVICE):
    """tokens (B, S) -> logits (B, S, V_padded) float32 (tied head, no
    softcap); each layer rematerialised as ``opts`` says.  On a mesh the
    rank's blocks in (``convert.params_block``; tokens its batch block)
    and its logits block (B_r, S, V_padded / tp) out."""
    from repro_torch.models.transformer import RunOptions, maybe_remat
    body = maybe_remat(lambda hh, p: mamba_block(cfg, p, hh, topo=topo)[0],
                       opts or RunOptions())
    h = embed(cfg, params["embed"], tokens, topo)
    for p in L.layers(params["layers"]):
        h = body(h, p)
    return logits_of(cfg, params, h, topo)
