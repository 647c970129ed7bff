"""Mamba2 (SSD, arXiv:2405.21060): counterpart of ``repro/models/mamba2.py``,
the layer (which zamba2 stacks too) and the pure-SSM model (mamba2-780m).

Prefill runs the chunked SSD scan through the ``ssd_scan`` kernel
(``ssd_chunked`` folds ``xdt = x * dt`` and ``dA = dt * A`` and cuts the
sequence into chunks); decode is the O(1) recurrent step ``ssd_step``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.embedding import embed_lookup, logits_of
from repro_torch.parallel.sharding import ONE_DEVICE, ParamSpec as PS


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


def mamba_block(cfg: ModelConfig, p, h, *, conv_state=None, ssm_state=None,
                decode: bool = False):
    """One Mamba2 layer with its residual.  h (B, S, d); in decode mode
    S == 1 and the states are carried.  Returns (h, None), or (h,
    (conv states, ssm state)) when decoding or when a state was passed in."""
    B, S, _ = h.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
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

    xh = xc.reshape(B, S, H, P)
    if decode:
        if S != 1:
            raise ValueError(f"mamba_block: decode takes one token, got {S}")
        st = (torch.zeros((B, H, N, P), dtype=torch.float32, device=h.device)
              if ssm_state is None else ssm_state)
        new_state, y1 = ssd_step(st, xh[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0])
        y = y1[:, None]
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bc, Cc, cfg.ssm_chunk,
                                   init_state=ssm_state)
    y = y + xh * p["D"].to(y.dtype)[:, None]
    y = y.reshape(B, S, cfg.d_inner)
    y = y * F.silu(z.float()).to(y.dtype)
    y = L.rms_norm(y, p["gnorm"])
    h = h + y @ p["wo"]
    if decode or conv_state is not None or ssm_state is not None:
        return h, ((ns_x, ns_B, ns_C), new_state)
    return h, None


def forward(cfg: ModelConfig, params, tokens, opts=None):
    """tokens (B, S) -> logits (B, S, V_padded) float32 (tied head, no
    softcap); each layer rematerialised as ``opts`` says."""
    from repro_torch.models.transformer import RunOptions, maybe_remat
    body = maybe_remat(lambda hh, p: mamba_block(cfg, p, hh)[0],
                       opts or RunOptions())
    h = embed_lookup(ONE_DEVICE, params["embed"], tokens)
    for p in L.layers(params["layers"]):
        h = body(h, p)
    return logits_of(cfg, params, h)
