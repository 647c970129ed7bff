"""Core neural layers (counterpart of ``repro/models/layers.py``).

Arithmetic follows the JAX package step for step, including where it rounds
to bf16: norms and RoPE compute in float32 and cast back; products of bf16
tensors return bf16.  ``block_attention`` is the prefill and training
attention and goes through the ``flash_attention`` kernel
(``kernels/ops.py``), whose gradient is that of ``block_attention_jnp``, the
reference's pair-scheduled jnp attention (the function its train step
differentiates); ``attention_ref`` is the materialising plain version, and
``decode_attention`` the one-token path, both plain PyTorch.
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


def layers(stack):
    """Every layer of a stacked parameter dict, as views.  One ``unbind`` a
    leaf, so a backward writes each stacked leaf's gradient once, not once a
    layer."""
    parts = {k: v.unbind(0) for k, v in stack.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def dot(x, w):
    """x @ w in the promoted dtype (a bf16 activation against float32
    weights runs in float32, as jnp's einsum does); x @ w itself where the
    dtypes agree."""
    t = torch.promote_types(x.dtype, w.dtype)
    return x.to(t) @ w.to(t)


def rms_norm(x, weight, eps: float = 1e-6):
    """Scales by ``1 + weight`` (zero-centred weights), so it is not
    ``torch.nn.RMSNorm``."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """LayerNorm in float32 with the population variance, returned in x's
    dtype (whisper's norms)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


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


def mask_pad_logits(logits, vocab_real: int, offset: int = 0):
    """-1e30 on the padded vocab tail (``ModelConfig.vocab_padded``): the
    columns whose global index ``offset + j`` is ``vocab_real`` or more
    (``offset``: the first column of a rank's vocab block)."""
    first = max(0, vocab_real - offset)
    if logits.shape[-1] <= first:
        return logits
    out = logits.clone()
    out[..., first:] = NEG
    return out


def block_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    attn_softcap: Optional[float] = None,
                    q_block: int = 512, kv_block: int = 512,
                    q_offset: int = 0):
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), Hq % Hkv == 0 -> (B, Sq, Hq, D)
    in q's dtype, through the flash_attention kernel; q's rows sit at
    positions ``q_offset`` on (the sequence-parallel rank's rows against
    every key).  ``q_block`` and ``kv_block`` tile the backward
    (``block_attention_jnp``); the kernel keeps its own tiles."""
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=attn_softcap, q_block=q_block,
                               kv_block=kv_block, q_offset=q_offset)


def pair_schedule(n_q: int, n_k: int, q_block: int, kv_block: int,
                  causal: bool, window: Optional[int], q_offset: int = 0):
    """The (q block, kv block) pairs that intersect the mask, in the
    reference's order (``_pair_schedule``: q positions from q_offset)."""
    pairs = []
    for i in range(n_q):
        q_lo = q_offset + i * q_block
        q_hi = q_offset + (i + 1) * q_block - 1
        for j in range(n_k):
            k_lo, k_hi = j * kv_block, (j + 1) * kv_block - 1
            if causal and k_lo > q_hi:
                continue
            if window is not None and k_hi < q_lo - (window - 1):
                continue
            pairs.append((i, j))
    return pairs


def block_attention_jnp(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        attn_softcap: Optional[float] = None,
                        q_block: int = 512, kv_block: int = 512,
                        q_offset: int = 0):
    """The reference's pair-scheduled blockwise attention
    (``repro/models/layers.py::block_attention``) in PyTorch: an online
    softmax over the needed (q block, kv block) pairs in the reference's
    order, products in float32 from the inputs' values (its
    ``preferred_element_type``), ``p`` rounded to v's dtype before the PV
    product, GQA by grouped einsums.  Differentiable; the backward of the
    ``flash_attention`` kernel.  Shapes as :func:`block_attention`."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    scale = D ** -0.5
    qb, kb = min(q_block, Sq), min(kv_block, Sk)
    pad_q, pad_k = (-Sq) % qb, (-Sk) % kb
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
    n_q, n_k = (Sq + pad_q) // qb, (Sk + pad_k) // kb
    qg = q.reshape(B, Sq + pad_q, Hkv, G, D)
    dev = q.device
    # one (acc, m, l) per q block, replaced pair by pair (the reference's
    # dynamic_update_slice into one carry)
    acc = [torch.zeros((B, Hkv, G, qb, D), dtype=torch.float32, device=dev)
           for _ in range(n_q)]
    m = [torch.full((B, Hkv, G, qb), NEG, dtype=torch.float32, device=dev)
         for _ in range(n_q)]
    l = [torch.zeros((B, Hkv, G, qb), dtype=torch.float32, device=dev)
         for _ in range(n_q)]
    for i, j in pair_schedule(n_q, n_k, qb, kb, causal, window, q_offset):
        qs = qg[:, i * qb:(i + 1) * qb].float()
        ks = k[:, j * kb:(j + 1) * kb].float()
        vs = v[:, j * kb:(j + 1) * kb]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qs, ks) * scale
        s = softcap(s, attn_softcap)
        qpos = q_offset + i * qb + torch.arange(qb, device=dev)
        kpos = j * kb + torch.arange(kb, device=dev)
        mask = torch.ones((qb, kb), dtype=torch.bool, device=dev)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        if pad_k:
            mask &= kpos[None, :] < Sk
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m[i], s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m[i] - m_new)
        l[i] = corr * l[i] + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                          vs.float())
        acc[i] = corr[..., None] * acc[i] + pv
        m[i] = m_new
    out = torch.cat([a / torch.clamp(x, min=1e-30)[..., None]
                     for a, x in zip(acc, l)], dim=3)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq + pad_q, Hq, D)
    return out[:, :Sq].to(q.dtype)


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


def gelu(h):
    """``jax.nn.gelu``'s default, the tanh approximation (not torch's
    default erf), in float32 and rounded to h's dtype."""
    return F.gelu(h.float(), approximate="tanh").to(h.dtype)


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    """Whisper's MLP, :func:`gelu` between the two products."""
    return gelu(x @ w_in + b_in) @ w_out + b_out
