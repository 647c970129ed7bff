"""Plain oracles of the kernels (counterpart of ``repro/kernels/ref.py``):
materialising attention in the heads-major layout and the SSD recurrence
step by step.  Neither shares code with the kernels' plain versions."""
from __future__ import annotations

import torch

from repro_torch.models.layers import attention_ref


def attention_ref_bhsd(q, k, v, *, causal=True, window=None, softcap=None):
    """(BH, S, D) layout around ``models.layers.attention_ref``."""
    BH, Sq, D = q.shape
    BHkv = k.shape[0]
    q4 = q.reshape(1, BH, Sq, D).transpose(1, 2)
    k4 = k.reshape(1, BHkv, -1, D).transpose(1, 2)
    v4 = v.reshape(1, BHkv, -1, D).transpose(1, 2)
    out = attention_ref(q4, k4, v4, causal=causal, window=window,
                        attn_softcap=softcap)
    return out.transpose(1, 2).reshape(BH, Sq, D)


def ssd_scan_ref(xdt, dA, Bc, Cc):
    """h_t = exp(dA_t) h_{t-1} + B_t xdt_t;  y_t = C_t h_t, one step at a
    time.  Shapes as ``kernels.ssd_scan.ssd_scan``."""
    B, nc, Q, H, P = xdt.shape
    S = nc * Q
    flat = lambda t: t.reshape((B, S) + t.shape[3:])
    xf, df, Bf, Cf = flat(xdt), flat(dA), flat(Bc), flat(Cc)
    state = torch.zeros((B, H, Bc.shape[-1], P), dtype=torch.float32,
                        device=xdt.device)
    ys = []
    for t in range(S):
        upd = torch.einsum("bn,bhp->bhnp", Bf[:, t], xf[:, t])
        state = state * torch.exp(df[:, t])[..., None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cf[:, t], state))
    return torch.stack(ys, dim=1).reshape(B, nc, Q, H, P), state
