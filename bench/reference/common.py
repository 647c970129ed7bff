"""Plain PyTorch pieces of the references: the arithmetic of the models the
benchmark runs, written from their published descriptions, in float32, with
no kernel, cache or batching trick, and nothing imported from the program.

Every product goes through :class:`Prec`, so one switch turns a reference
into its control: the same arithmetic one precision step down from what the
configuration states (bfloat16 products as float8 e4m3 with per-tensor
scales, their gradients as e5m2; float32 products as bfloat16).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG = -1e30


def _q8(x, fmt):
    """``x`` rounded to the float8 format ``fmt`` under one per-tensor scale
    (its largest magnitude onto the format's largest), back in float32."""
    if x.numel() == 0:
        return x.float()
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = torch.finfo(fmt).max / amax
    return (x.float() * s).to(fmt).float() / s


class _MatmulF8(torch.autograd.Function):
    """a @ b with both inputs in e4m3 and the incoming gradient in e5m2
    (the float8 training recipe), products summed in float32."""

    @staticmethod
    def forward(ctx, a, b):
        aq, bq = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(aq, bq)
        return aq @ bq

    @staticmethod
    def backward(ctx, g):
        aq, bq = ctx.saved_tensors
        gq = _q8(g, torch.float8_e5m2)
        ga = gq @ bq.transpose(-1, -2)
        gb = aq.transpose(-1, -2) @ gq
        # a broadcast operand (weights against batched activations) sums
        # its gradient over the broadcast dimensions
        while gb.dim() > bq.dim():
            gb = gb.sum(0)
        while ga.dim() > aq.dim():
            ga = ga.sum(0)
        return ga, gb


class _RoundBF16(torch.autograd.Function):
    """x rounded to bfloat16 and back, the gradient rounded the same way."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).float()

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).float()


class Prec:
    """How a reference multiplies.  ``control=False``: float32 throughout
    (TF32 must be off: the caller sets
    ``torch.backends.cuda.matmul.allow_tf32 = False``).  ``control=True``:
    products the configuration states in bfloat16 run in float8, and those
    it states in float32 (the scan, the router, the LM head) in
    bfloat16."""

    def __init__(self, control: bool = False):
        self.control = control

    def mm(self, a, b):
        """A bfloat16 product of the configuration: float32 in the
        reference, float8 in the control."""
        if self.control:
            return _MatmulF8.apply(a, b)
        return a @ b

    def mm32(self, a, b):
        """A float32 product of the configuration: bfloat16 inputs in the
        control."""
        if self.control:
            return _RoundBF16.apply(a) @ _RoundBF16.apply(b)
        return a @ b

    def r32(self, x):
        """A float32 operand of the configuration (the scan's inputs)."""
        return _RoundBF16.apply(x) if self.control else x


def rms_norm(x, w, eps: float = 1e-6):
    """RMS norm scaling by (1 + w): the zero-centred weight of the
    configurations' norms."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, positions, theta: float):
    """Rotary embedding, half-split (the first half of each head rotates
    with the second).  x (B, S, H, D); positions (S,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = positions.float()[:, None] * freqs
    c, s = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def causal_attention(prec: Prec, q, k, v, q_rows: int = 512):
    """Causal softmax attention, query head j reading kv head j // (Hq /
    Hkv).  q (B, S, Hq, D), k/v (B, S, Hkv, D) -> (B, S, Hq, D); the
    scores are formed ``q_rows`` query rows at a time."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    kt = k.repeat_interleave(rep, dim=2).permute(0, 2, 3, 1)   # B H D S
    vt = v.repeat_interleave(rep, dim=2).permute(0, 2, 1, 3)   # B H S D
    out = []
    for lo in range(0, S, q_rows):
        hi = min(S, lo + q_rows)
        qb = q[:, lo:hi].permute(0, 2, 1, 3)                    # B H r D
        s = prec.mm(qb, kt[..., :hi]) / math.sqrt(D)
        qpos = torch.arange(lo, hi, device=q.device)[:, None]
        kpos = torch.arange(hi, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG)
        p = torch.softmax(s, dim=-1)
        out.append(prec.mm(p, vt[:, :, :hi]).permute(0, 2, 1, 3))
    return torch.cat(out, dim=1)


def attention(prec: Prec, p, h, positions, n_heads: int, n_kv: int,
              head_dim: int, theta: float, return_kv: bool = False):
    """Pre-norm causal self-attention with rotary positions and its output
    projection: ``h + attn(rms_norm(h))``.  With ``return_kv`` also the
    rotated keys and the values (B, S, Hkv, D)."""
    B, S, _ = h.shape
    hn = rms_norm(h, p["attn_norm"])
    q = rope(prec.mm(hn, p["wq"]).view(B, S, n_heads, head_dim), positions,
             theta)
    k = rope(prec.mm(hn, p["wk"]).view(B, S, n_kv, head_dim), positions,
             theta)
    v = prec.mm(hn, p["wv"]).view(B, S, n_kv, head_dim)
    o = causal_attention(prec, q, k, v).reshape(B, S, n_heads * head_dim)
    out = h + prec.mm(o, p["wo"])
    return (out, k, v) if return_kv else out


def swiglu(prec: Prec, x, wg, wu, wd):
    return prec.mm(F.silu(prec.mm(x, wg)) * prec.mm(x, wu), wd)


def lm_logits(prec: Prec, h, final_norm, table, vocab: int):
    """Tied LM head over the real vocabulary: (..., vocab) float32."""
    return prec.mm32(rms_norm(h, final_norm), table[:vocab].t())


def lm_loss(logits, labels):
    """Mean next-token cross-entropy over every position."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def adamw_step(W: dict, grads: dict, m: dict, v: dict, t: int, hp: dict):
    """One AdamW step (Loshchilov and Hutter) on float32 weights, in place:
    the gradients clipped to a global norm of ``grad_clip``, the rate
    warmed up linearly over ``warmup_steps``, bias-corrected moments, decay
    inside the update.  Returns the clipped gradients."""
    norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
    scale = torch.clamp(hp["grad_clip"] / torch.clamp(norm, min=1e-12),
                        max=1.0)
    lr = hp["lr"] * min(1.0, t / max(hp["warmup_steps"], 1))
    b1, b2 = hp["b1"], hp["b2"]
    clipped = {}
    with torch.no_grad():
        for p, g in grads.items():
            g = g * scale
            clipped[p] = g
            m[p].mul_(b1).add_((1 - b1) * g)
            v[p].mul_(b2).add_((1 - b2) * g * g)
            mh, vh = m[p] / (1 - b1 ** t), v[p] / (1 - b2 ** t)
            W[p].sub_(lr * (mh / (torch.sqrt(vh) + hp["eps"])
                            + hp["weight_decay"] * W[p]))
    return clipped
