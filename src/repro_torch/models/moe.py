"""Mixture-of-Experts FFN with Storm's one-two-sided dispatch (counterpart of
``repro/models/moe.py``).

Experts are a remote data structure: tokens are routed to them as requests
are routed to their owners in ``transport.route_by_dest``, with the same
code shape (sort by destination, position within destination, scatter) and
a fixed capacity per expert, so an assignment past it is dropped
(deterministically), the static analogue of send-queue back-pressure.

Routing is the reference's exactly: router logits in float32 (no TF32: one
rounding can move a token to another expert); ties in the top-k go to the
lowest expert index, as ``lax.top_k`` breaks them (``torch.topk`` does not);
an expert's slots fill in flat (token, k) order over the whole batch, and
assignments past its capacity fall into a sentinel cell that is cut away and
weigh nothing in the combine.  The combine sums each token's K rows in
float32, k = 0 first, with no atomics, so it is the same from run to run.

On one device the dispatch is "local": every expert runs over the tokens
routed to it.  Over a ``model`` axis larger than 1 a rank holds its batch
block of tokens (the same on every rank of its ``model`` group) and the
reference's sharded modes run on it, chosen per shape by the cost model:

  * "rpc" (compute at the data): the rank runs its E/tp local experts over
    the tokens routed to them, and an all-reduce (SUM) over ``model``
    combines the partial outputs;
  * "onesided" (data to compute): the rank all-gathers the expert stacks
    (the one-sided read of the remote region), routes its 1/tp slice of the
    tokens through every expert at that slice's capacity, and all-gathers
    the outputs; "rpc" where the tokens do not split over the axis;
  * "replicated": where the rules give the experts no mesh axis (wide-DP),
    every rank holds every expert and routes its own tokens;
  * "local" on a mesh (a ``model`` axis of 1, or one the experts do not
    divide): the batch blocks are all-gathered and routed together, at
    the whole batch's capacity, as the reference routes its global batch.

``moe_dispatch`` says which mode a call runs; ``transformer.ffn_block``
asks it first, to hand the experts' blocks or the whole stacks.

No mode reads a device value on the host.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core import cost_model
from repro_torch.parallel.sharding import Topology

MODES = ("auto", "local", "rpc", "onesided", "replicated")


@contextlib.contextmanager
def _no_tf32():
    m = torch.backends.cuda.matmul
    old, m.allow_tf32 = m.allow_tf32, False
    try:
        yield
    finally:
        m.allow_tf32 = old


def _top_k(x, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (``lax.top_k``'s order)."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _router(cfg: ModelConfig, xt, router_w):
    """xt (T, d), router_w (d, E) -> (topv (T, K) float32, topi (T, K))."""
    with _no_tf32():
        logits = xt.float() @ router_w.float()
    if cfg.router_renorm:   # deepseek: softmax-all -> top-k -> renormalize
        topv, topi = _top_k(torch.softmax(logits, dim=-1), cfg.top_k)
        topv = topv / topv.sum(-1, keepdim=True)
    else:                   # granite: top-k logits -> softmax over them
        tlog, topi = _top_k(logits, cfg.top_k)
        topv = torch.softmax(tlog, dim=-1)
    return topv, topi


def _route(xt, topv, topi, n_experts_local: int, e_offset: int,
           capacity: int):
    """Capacity-routed dispatch of one device's tokens xt (T, d) by topv /
    topi (T, K).  Returns (buf (E_l, C, d) in xt's dtype, meta), meta =
    (dst_e, dst_c, tok, w, keep) over the T*K assignments in flat order."""
    T, K = topi.shape
    E = n_experts_local
    dev = xt.device
    flat_e = topi.reshape(-1).to(torch.int64) - e_offset
    w = topv.reshape(-1)
    local = (flat_e >= 0) & (flat_e < E)
    slot = torch.where(local, flat_e, torch.full_like(flat_e, E))
    # position within destination: an assignment's rank among those to
    # its expert, in flat order (a stable sort by destination keeps it;
    # searchsorted finds each destination's first row without a host sync)
    dest, order = torch.sort(slot, stable=True)
    start = torch.searchsorted(dest, torch.arange(E + 1, device=dev))
    pos = torch.empty_like(slot)
    pos[order] = torch.arange(T * K, device=dev) - start[dest]
    keep = local & (pos < capacity)
    dst_e = torch.where(keep, slot, torch.full_like(slot, E))
    dst_c = torch.where(keep, pos, torch.full_like(pos, capacity))
    tok = torch.arange(T * K, device=dev) // K
    buf = torch.zeros((E + 1, capacity + 1, xt.shape[-1]), dtype=xt.dtype,
                      device=dev)
    buf[dst_e, dst_c] = xt[tok]
    return buf[:E, :capacity], (dst_e, dst_c, tok, w, keep)


def _combine(outbuf, meta, T: int, d: int):
    """Each token's kept rows of outbuf (E, C, d), weighted, summed in
    float32 over k = 0, 1, ... and cast to outbuf's dtype -> (T, d)."""
    dst_e, dst_c, _, w, keep = meta
    padded = F.pad(outbuf, (0, 0, 0, 1, 0, 1))
    rows = padded[dst_e, dst_c].float()                           # (T*K, d)
    rows.mul_(torch.where(keep, w, torch.zeros_like(w))[:, None])
    rows = rows.view(T, -1, d)
    out = rows[:, 0].clone()
    for k in range(1, rows.shape[1]):
        out += rows[:, k]
    return out.to(outbuf.dtype)


def _expert_ffn(buf, wg, wu, wd):
    """buf (E, C, d); wg/wu (E, d, f), wd (E, f, d): SwiGLU per expert."""
    g = torch.bmm(buf, wg)
    u = torch.bmm(buf, wu)
    h = F.silu(g.float()).to(buf.dtype) * u
    return torch.bmm(h, wd)


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens routed at once."""
    return max(1, int(np.ceil(tokens * cfg.top_k / cfg.n_experts
                              * cfg.capacity_factor)))


def moe_dispatch_mode(cfg: ModelConfig, topo: Topology,
                      tokens_per_device: int) -> str:
    """The reference's choice: "local" where the ``model`` axis is 1 or the
    experts do not divide over it, else the cost model's."""
    tp = topo.axis_sizes.get("model", 1)
    if tp == 1 or cfg.n_experts % tp != 0:
        return "local"
    choice = cost_model.moe_dispatch_choice(
        tokens_per_shard=tokens_per_device, d_model=cfg.d_model,
        d_ff=cfg.d_ff, n_experts=cfg.n_experts, top_k=cfg.top_k, shards=tp)
    return choice.mode


def moe_dispatch(cfg: ModelConfig, topo: Topology, tokens: int,
                 mode: str = "auto") -> str:
    """The mode ``moe_ffn`` runs for ``tokens`` tokens on this rank when
    asked for ``mode``: the cost model's under "auto"; "replicated" where
    the rules give the experts no mesh axis on a ``model`` axis above 1
    (wide-DP); "local" where the axis is 1 or does not divide the experts;
    "rpc" for "onesided" where the tokens do not split over the axis."""
    if mode not in MODES:
        raise ValueError(f"unknown MoE dispatch mode {mode!r}")
    E = cfg.n_experts
    tp = topo.axis_sizes.get("model", 1)
    if mode == "auto":
        mode = moe_dispatch_mode(cfg, topo, tokens_per_device=tokens)
    if tp > 1 and not topo._mesh_axes_for("expert", E):
        return "replicated"
    if mode == "local" or tp == 1 or E % tp != 0:
        return "local" if mode != "replicated" else mode
    if mode == "onesided" and tokens % tp != 0:
        return "rpc"      # decode-sized batches: too few tokens to split
    return mode


def route(cfg: ModelConfig, x, router_w):
    """The local path's routing of x (B, S, d): (topi, buf, meta)."""
    B, S, d = x.shape
    xt = x.reshape(B * S, d)
    topv, topi = _router(cfg, xt, router_w)
    buf, meta = _route(xt, topv, topi, cfg.n_experts, 0,
                       capacity(cfg, B * S))
    return topi, buf, meta


def _routed_ffn(cfg, xt, router_w, wg, wu, wd, e_offset: int, cap: int):
    """Route xt (T, d) over every expert, keep the assignments to the
    wg.shape[0] experts from ``e_offset`` at ``cap`` slots each, and combine
    their outputs -> (T, d)."""
    topv, topi = _router(cfg, xt, router_w)
    buf, meta = _route(xt, topv, topi, wg.shape[0], e_offset, cap)
    return _combine(_expert_ffn(buf, wg, wu, wd), meta, xt.shape[0],
                    xt.shape[1])


def _gather(x, group, tp: int):
    """all_gather of x's blocks along its first axis over ``group``."""
    out = x.new_empty((tp * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _batch_axes(topo: Topology):
    return tuple(a for a in topo.rules.get("batch", ())
                 if topo.axis_sizes.get(a, 1) > 1)


def moe_ffn(cfg: ModelConfig, topo: Topology, x, router_w, wg, wu, wd,
            mode: str = "auto"):
    """x (B_loc, S, d): this rank's block of a batch split over every batch
    axis of the mesh; router_w (d, E); wg/wu (E_r, d, f), wd (E_r, f, d):
    this rank's block of the expert stacks, E_r = E / tp where the mode
    shards the experts over ``model`` ("rpc", "onesided") and E where it
    runs them all (``moe_dispatch``).  Returns (B_loc, S, d) in x's
    dtype."""
    B, S, d = x.shape
    E = cfg.n_experts
    tp = topo.axis_sizes.get("model", 1)
    T_loc = B * S
    mode = moe_dispatch(cfg, topo, T_loc, mode)
    xt = x.reshape(T_loc, d)
    if mode == "replicated":
        # wide-DP rules: every rank holds every expert and routes its own
        # tokens, with no dispatch collective
        _, buf, meta = route(cfg, x, router_w)
        out = _combine(_expert_ffn(buf, wg, wu, wd), meta, T_loc, d)
        return out.reshape(B, S, d)
    if mode == "local":
        # the reference routes the whole batch at once (one capacity for
        # it): a batch split over the mesh is gathered, routed and cut back
        axes = _batch_axes(topo)
        xg = topo.gather(x, 0, axes) if axes else x
        _, buf, meta = route(cfg, xg, router_w)
        out = _combine(_expert_ffn(buf, wg, wu, wd), meta, xg.shape[0] * S,
                       d).reshape(xg.shape)
        if axes:
            lo, n = topo.extent(axes, xg.shape[0])
            out = out[lo:lo + n]
        return out
    E_l = E // tp
    if wg.shape[0] != E_l:
        raise ValueError(f"expert blocks of {E} experts over {tp} ranks hold "
                         f"{E_l}, got {wg.shape[0]}")
    m = topo.axis_index("model")
    group = topo.group("model")
    if mode == "rpc":
        out = _routed_ffn(cfg, xt, router_w, wg, wu, wd, m * E_l,
                          capacity(cfg, T_loc))
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out.reshape(B, S, d)
    # one-sided: all-gather the expert stacks, route 1/tp of the tokens
    T_my = T_loc // tp
    out_my = _routed_ffn(cfg, xt[m * T_my:(m + 1) * T_my], router_w,
                         _gather(wg, group, tp), _gather(wu, group, tp),
                         _gather(wd, group, tp), 0, capacity(cfg, T_my))
    return _gather(out_my, group, tp).reshape(B, S, d)
