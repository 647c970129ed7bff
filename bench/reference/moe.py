"""Plain reference of the MoE family (granite-moe): decoder layers of
grouped-query causal attention with rotary positions, then a routed
mixture of SwiGLU experts, tied embeddings.

The routing is the published one (top-k of the router's logits, softmax
over those k), with a fixed capacity per expert for the whole batch:
``ceil(tokens * k / experts * capacity_factor)`` slots, filled in the order
of the (token, choice) pairs, token-major; an assignment past its expert's
capacity is computed by no expert.  Ties in the top-k go to the lower
expert index.  Everything is float32; :class:`common.Prec` makes the
control (the router, a float32 product of the configuration, then runs in
bfloat16).
"""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint as C

from reference.common import Prec, attention, lm_logits, rms_norm, swiglu


def param_table(m):
    """{path: (shape, init)}, as :func:`ssm.param_table`."""
    d, L = m["d_model"], m["n_layers"]
    vp = -(-m["vocab_size"] // 512) * 512
    qd, kvd = m["n_heads"] * m["head_dim"], m["n_kv_heads"] * m["head_dim"]
    E, f = m["n_experts"], m["d_ff"]
    return {
        "embed": ((vp, d), "normal"), "final_norm": ((d,), "zeros"),
        "layers/attn_norm": ((L, d), "zeros"),
        "layers/wq": ((L, d, qd), "scaled"),
        "layers/wk": ((L, d, kvd), "scaled"),
        "layers/wv": ((L, d, kvd), "scaled"),
        "layers/wo": ((L, qd, d), "scaled"),
        "layers/mlp_norm": ((L, d), "zeros"),
        "layers/router": ((L, d, E), "scaled"),
        "layers/we_gate": ((L, E, d, f), "scaled"),
        "layers/we_up": ((L, E, d, f), "scaled"),
        "layers/we_down": ((L, E, f, d), "scaled"),
    }


def capacity(m, tokens: int) -> int:
    return max(1, math.ceil(tokens * m["top_k"] / m["n_experts"]
                            * m["capacity_factor"]))


def moe_ffn(m, prec: Prec, p, x, route=None):
    """x (B, S, d), already normed -> the experts' weighted sum (B, S, d).
    ``route(top)``, where given, sees each token's k experts (T, K) and
    returns those the layer uses (the routing diagnostics of
    ``limits.py``)."""
    B, S, d = x.shape
    T, E, K = B * S, m["n_experts"], m["top_k"]
    xt = x.reshape(T, d)
    logits = prec.mm32(xt, p["router"])
    top = torch.sort(logits, dim=-1, descending=True, stable=True)[1][:, :K]
    if route is not None:
        top = route(top)
    weight = torch.softmax(logits.gather(1, top), dim=-1).reshape(-1)
    expert = top.reshape(-1)
    token = torch.arange(T * K, device=x.device) // K
    cap = capacity(m, T)
    out = torch.zeros_like(xt)
    for e in range(E):
        a = (expert == e).nonzero().squeeze(1)[:cap]
        t = token[a]
        y = swiglu(prec, xt[t], p["we_gate"][e], p["we_up"][e],
                   p["we_down"][e])
        out = out.index_add(0, t, y * weight[a][:, None])
    return out.reshape(B, S, d)


def decoder_layer(m, prec: Prec, p, h, positions, kv=None, route=None):
    if kv is None:
        h = attention(prec, p, h, positions, m["n_heads"], m["n_kv_heads"],
                      m["head_dim"], m["rope_theta"])
    else:
        h, k, v = attention(prec, p, h, positions, m["n_heads"],
                            m["n_kv_heads"], m["head_dim"], m["rope_theta"],
                            return_kv=True)
        kv.append((k, v))
    return h + moe_ffn(m, prec, p, rms_norm(h, p["mlp_norm"]), route)


def forward(m, W, tokens, prec: Prec, *, remat: bool = False, cache=None,
            route=None):
    """tokens (B, S) -> logits (B, S, vocab) float32; ``cache`` (a dict)
    gets each layer's rotated keys and values under ``"kv"``.  The whole
    batch is routed together, as the program routes it.  ``route(layer,
    top)``: as :func:`moe_ffn`'s, told the layer."""
    S = tokens.shape[1]
    pos = torch.arange(S, device=tokens.device)
    h = W["embed"][tokens.long()]
    layers = {k[7:]: v for k, v in W.items() if k.startswith("layers/")}
    kv = None if cache is None else cache.setdefault("kv", [])
    run = (lambda f, *a: C.checkpoint(f, *a, use_reentrant=False)) \
        if remat else (lambda f, *a: f(*a))
    for i in range(m["n_layers"]):
        p = {k: v[i] for k, v in layers.items()}
        r = None if route is None else (lambda top, i=i: route(i, top))
        h = run(lambda hh, pp: decoder_layer(m, prec, pp, hh, pos, kv, r), h,
                p)
    return lm_logits(prec, h, W["final_norm"], W["embed"], m["vocab_size"])


def forward_flops(m, B: int, S: int) -> int:
    """Model FLOPs of one forward pass over B x S tokens: the attention
    projections and causal pairs, the router, the top-k experts each token
    is routed to (SwiGLU, 3 products), the LM head over the real
    vocabulary."""
    from harness.counts import attention_flops
    d, T = m["d_model"], B * S
    layer = attention_flops(B, S, d, m["n_heads"], m["n_kv_heads"],
                            m["head_dim"]) \
        + 2 * T * d * m["n_experts"] + m["top_k"] * 2 * T * 3 * d * m["d_ff"]
    return m["n_layers"] * layer + 2 * T * d * m["vocab_size"]


def kernel_shapes(m, B: int, S: int) -> dict:
    """The shape of one launch of each of the program's kernels."""
    return {"flash_attention": dict(BH=B * m["n_heads"], S=S, D=m["head_dim"],
                                    group=m["n_heads"] // m["n_kv_heads"])}


STACKED = ("layers/",)
