"""Core neural layers (counterpart of ``repro/models/layers.py``).

Arithmetic follows the JAX package step for step, including where it rounds
to bf16: norms and RoPE compute in float32 and cast back; products of bf16
tensors return bf16.  ``block_attention`` is the prefill attention and goes
through the ``flash_attention`` kernel (``kernels/ops.py``); ``attention_ref``
is its materialising plain version, and ``decode_attention`` the one-token
path, both plain PyTorch.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG = -1e30


def layer(stack, i: int):
    """Layer ``i`` of a stacked parameter dict (views, no copies)."""
    return {k: v[i] for k, v in stack.items()}


def rms_norm(x, weight, eps: float = 1e-6):
    """Scales by ``1 + weight`` (zero-centred weights), so it is not
    ``torch.nn.RMSNorm``."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def rope_tables(positions, head_dim: int, theta: float):
    """positions (..., S) int -> (cos, sin) of shape (..., S, head_dim // 2),
    float32."""
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Half-split (not interleaved) rotation.  x (B, S, H, D); cos/sin
    (B, S, D/2) or (S, D/2)."""
    half = x.shape[-1] // 2
    if cos.dim() == 2:
        cos, sin = cos[None], sin[None]
    c = cos[..., None, :].float()
    s = sin[..., None, :].float()
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def softcap(x, cap: Optional[float]):
    if cap is None:
        return x
    return torch.tanh(x / cap) * cap


def mask_pad_logits(logits, vocab_real: int):
    """-1e30 on the padded vocab tail (``ModelConfig.vocab_padded``)."""
    if logits.shape[-1] == vocab_real:
        return logits
    out = logits.clone()
    out[..., vocab_real:] = NEG
    return out


def block_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None):
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), Hq % Hkv == 0 -> (B, Sq, Hq, D)
    in q's dtype, through the flash_attention kernel."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=attn_softcap)


def attention_ref(q, k, v, *, causal=True, window=None, attn_softcap=None):
    """Materialising attention (the oracle of the JAX package's tests)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    s = softcap(s, attn_softcap)
    qpos = torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)


def decode_attention(q, k_cache, v_cache, cache_len, *, window=None,
                     attn_softcap=None):
    """One-token attention over a (B, S, Hkv, D) cache.  q (B, Hq, D);
    cache_len (B,) counts the valid positions (the new token's K/V already
    appended)."""
    B, S, Hkv, D = k_cache.shape
    Hq = q.shape[1]
    G = Hq // Hkv
    scale = D ** -0.5
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * scale
    s = softcap(s, attn_softcap)
    pos = torch.arange(S, device=q.device)
    mask = pos[None] < cache_len[:, None]
    if window is not None:
        mask &= pos[None] > (cache_len[:, None] - 1) - window
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down
