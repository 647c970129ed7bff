"""Plain reference of the SSM family (mamba2): a stack of Mamba2 layers
(arXiv:2405.21060, the SSD form), each a pre-norm residual block, then the
final norm and the tied LM head.  Everything is float32;
:class:`common.Prec` makes the control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
import torch.utils.checkpoint as C

from reference.common import Prec, lm_logits, rms_norm


def _mamba_leaves(m, stack):
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    H, GN, K = di // m["ssm_head_dim"], m["ssm_groups"] * m["ssm_state"], \
        m["conv_width"]
    L = (stack,)
    return {
        "norm": (L + (d,), "zeros"), "wz": (L + (d, di), "scaled"),
        "wx": (L + (d, di), "scaled"), "wB": (L + (d, GN), "scaled"),
        "wC": (L + (d, GN), "scaled"), "wdt": (L + (d, H), "scaled"),
        "conv_x_w": (L + (K, di), "normal0.1"), "conv_x_b": (L + (di,), "zeros"),
        "conv_B_w": (L + (K, GN), "normal0.1"), "conv_B_b": (L + (GN,), "zeros"),
        "conv_C_w": (L + (K, GN), "normal0.1"), "conv_C_b": (L + (GN,), "zeros"),
        "A_log": (L + (H,), "zeros"), "D": (L + (H,), "ones"),
        "dt_bias": (L + (H,), "zeros"), "gnorm": (L + (di,), "zeros"),
        "wo": (L + (di, d), "scaled"),
    }


def param_table(m):
    """{path: (shape, init)}: the parameter tree the program takes, by
    "/"-joined path; init "normal" (std 0.02), "normal0.1", "scaled"
    (std 1/sqrt(fan-in), clipped at 2 std), "zeros" or "ones"."""
    vp = -(-m["vocab_size"] // 512) * 512
    out = {"embed": ((vp, m["d_model"]), "normal"),
           "final_norm": ((m["d_model"],), "zeros")}
    out.update({f"layers/{k}": v
                for k, v in _mamba_leaves(m, m["n_layers"]).items()})
    return out


def causal_conv(x, w, b):
    """Depthwise causal convolution over the sequence with zero history,
    then SiLU.  x (B, S, C); w (K, C): w[K-1] weighs the current input."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, j:j + S] * w[j] for j in range(K))
    return F.silu(y + b)


def ssd(prec: Prec, x, dt, A, Bm, Cm, chunk: int):
    """The SSD recurrence h_t = exp(dt_t A) h_{t-1} + B_t (dt_t x_t)ᵀ,
    y_t = C_t h_t, from a zero state, in chunks of ``chunk``: within a
    chunk the quadratic (attention-like) form, across chunks the carried
    state.  x (B, S, H, P); dt (B, S, H); A (H,); Bm/Cm (B, S, N).
    Returns (y (B, S, H, P), final state (B, H, N, P))."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    xdt = prec.r32(x * dt[..., None]).reshape(B, nc, Q, H, P)
    Bc = prec.r32(Bm).reshape(B, nc, Q, N)
    Cc = prec.r32(Cm).reshape(B, nc, Q, N)
    cum = (dt * A).reshape(B, nc, Q, H).cumsum(2)
    causal = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]        # b c q k h
    decay = torch.exp(torch.where(causal[None, None, :, :, None], seg,
                                  torch.full_like(seg, -torch.inf)))
    cb = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    y = torch.einsum("bcqkh,bckhp->bcqhp", cb[..., None] * decay, xdt)
    to_end = torch.exp(cum[:, :, -1:, :] - cum)
    local = torch.einsum("bckn,bckhp->bchnp", Bc, xdt * to_end[..., None])
    state = torch.zeros(B, H, N, P, device=x.device)
    carried = []
    for c in range(nc):
        carried.append(state)
        state = torch.exp(cum[:, c, -1])[..., None, None] * state + local[:, c]
    y = y + torch.einsum("bcqn,bchnp->bcqhp", Cc, torch.stack(carried, 1)) \
        * torch.exp(cum)[..., None]
    return y.reshape(B, S, H, P), state


def mamba_layer(m, prec: Prec, p, h, states=None):
    """One Mamba2 layer with its residual.  With ``states`` (a list) append
    what a prefill leaves for decoding: the last K-1 inputs of each
    convolution (x, B, C) and the final SSM state."""
    B, S, _ = h.shape
    P = m["ssm_head_dim"]
    K = m["conv_width"]
    hn = rms_norm(h, p["norm"])
    z, xr = prec.mm(hn, p["wz"]), prec.mm(hn, p["wx"])
    Br, Cr = prec.mm(hn, p["wB"]), prec.mm(hn, p["wC"])
    dt = F.softplus(prec.mm(hn, p["wdt"]) + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xc = causal_conv(xr, p["conv_x_w"], p["conv_x_b"])
    Bc = causal_conv(Br, p["conv_B_w"], p["conv_B_b"])
    Cc = causal_conv(Cr, p["conv_C_w"], p["conv_C_b"])
    xh = xc.reshape(B, S, -1, P)
    y, state = ssd(prec, xh, dt, A, Bc, Cc, m["ssm_chunk"])
    y = (y + xh * p["D"][:, None]).reshape(B, S, -1) * F.silu(z)
    out = h + prec.mm(rms_norm(y, p["gnorm"]), p["wo"])
    if states is not None:
        states.append({"conv_x": xr[:, S - K + 1:], "conv_B": Br[:, S - K + 1:],
                       "conv_C": Cr[:, S - K + 1:], "ssm": state})
    return out


def _layer(stack, i):
    return {k: v[i] for k, v in stack.items()}


def forward(m, W, tokens, prec: Prec, *, remat: bool = False, cache=None):
    """tokens (B, S) -> logits (B, S, vocab) float32.  ``W``: the tree of
    :func:`param_table` paths (float32).  ``remat`` recomputes each layer
    in the backward (memory only).  With ``cache`` (a dict) it is filled
    with each layer's states (``"mamba"``, in order)."""
    h = W["embed"][tokens.long()]
    layers = {k[7:]: v for k, v in W.items() if k.startswith("layers/")}
    states = None if cache is None else cache.setdefault("mamba", [])
    run = (lambda f, *a: C.checkpoint(f, *a, use_reentrant=False)) \
        if remat else (lambda f, *a: f(*a))
    for i in range(m["n_layers"]):
        h = run(lambda hh, p: mamba_layer(m, prec, p, hh, states), h,
                _layer(layers, i))
    return lm_logits(prec, h, W["final_norm"], W["embed"], m["vocab_size"])


def forward_flops(m, B: int, S: int) -> int:
    """Model FLOPs of one forward pass over B x S tokens: each product's
    2mnk (the Mamba projections, the LM head over the real vocabulary) and
    the chunked scan's ``ssd_flops``."""
    from harness.counts import ssd_flops
    s = kernel_shapes(m, B, S)["ssd_scan"]
    d, di, T = m["d_model"], m["ssm_expand"] * m["d_model"], B * S
    proj = 2 * T * d * (2 * di + 2 * m["ssm_groups"] * s["N"] + s["H"]) \
        + 2 * T * di * d
    return m["n_layers"] * (proj + ssd_flops(**s)) \
        + 2 * T * d * m["vocab_size"]


def kernel_shapes(m, B: int, S: int) -> dict:
    """The shape of one launch of each of the program's kernels when it
    runs a forward pass over B x S tokens."""
    P, di = m["ssm_head_dim"], m["ssm_expand"] * m["d_model"]
    Q = min(m["ssm_chunk"], S)
    return {"ssd_scan": dict(B=B, nc=S // Q, Q=Q, H=di // P, P=P,
                             N=m["ssm_state"])}


# leaves stacked over layers: compared layer by layer
STACKED = ("layers/",)
