"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

There is no ``use_pallas``-style switch: each wrapper runs its kernel's
plain PyTorch version for CPU tensors and launches the CUDA kernel for CUDA
tensors, or raises.  All three of the reference's kernels are ported:
``hash_probe`` (the OCC path's one-sided probe), ``flash_attention`` and
``ssd_scan`` (the models' forward).

Gradients.  The reference never differentiates a Pallas kernel: its train
step differentiates the jnp ``block_attention`` and ``ssd_chunked``.  So
when grad is enabled and an input requires it, ``flash_attention`` and
``ssd_scan`` run through a ``torch.autograd.Function`` whose forward is the
dispatch above (the kernel on the card) and whose backward recomputes the
reference's differentiated function under autograd from the saved inputs:
``layers.block_attention_jnp`` at the ``q_block`` x ``kv_block`` tiles,
and ``ssd_scan.ssd_scan_plain`` (the chunk step of the reference's
``ssd_chunked``).  Under ``torch.no_grad()``, or when no input requires
grad, the wrappers launch exactly what they launched before.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import ssd_scan as ss

# a named span of a profile (torch.profiler), which reads the device time
# of the kernels launched inside it
RANGE = torch.profiler.record_function

probe_lines = hp.probe_lines      # the dataplane's contract
hash_probe = hp.hash_probe        # the TPU kernel's contract: (B, 29) rows
flash_attention_bhsd = fa.flash_attention_bhsd


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _flash(q, k, v, causal, window, softcap, q_offset=0):
    """The forward dispatch in the models' layout."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2).reshape(B * Hq, Sq, D)
    kh = k.transpose(1, 2).reshape(B * Hkv, Sk, D)
    vh = v.transpose(1, 2).reshape(B * Hkv, Sk, D)
    out = fa.flash_attention_bhsd(qh, kh, vh, causal=causal, window=window,
                                  softcap=softcap, group=Hq // Hkv,
                                  q_offset=q_offset)
    return out.reshape(B, Hq, Sq, D).transpose(1, 2)


class FlashAttention(torch.autograd.Function):
    """Forward: the kernel (plain version on the CPU).  Backward: autograd
    through ``layers.block_attention_jnp`` recomputed from q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_block, kv_block,
                q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.kw = dict(causal=causal, window=window, attn_softcap=softcap,
                      q_block=q_block, kv_block=kv_block, q_offset=q_offset)
        return _flash(q, k, v, causal, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, g):
        from repro_torch.models.layers import block_attention_jnp
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad(), RANGE("flash_attention backward"):
            out = block_attention_jnp(*leaves, **ctx.kw)
            grads = torch.autograd.grad(out, leaves, g)
        return (*grads, None, None, None, None, None, None)


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None,
                    q_block=512, kv_block=512, q_offset=0):
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), the models' layout, adapted to
    the kernel's heads-major (B*H, S, D); q's rows at positions
    ``q_offset`` on.  ``q_block`` / ``kv_block`` tile the backward only."""
    if _wants_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_block, kv_block, q_offset)
    return _flash(q, k, v, causal, window, softcap, q_offset)


class SSDScan(torch.autograd.Function):
    """Forward: the kernels (plain version on the CPU).  Backward: autograd
    through ``ssd_scan.ssd_scan_plain`` recomputed from the inputs."""

    @staticmethod
    def forward(ctx, xdt, dA, Bc, Cc, init_state, h_tile):
        ctx.save_for_backward(xdt, dA, Bc, Cc, init_state)
        return ss.ssd_scan(xdt, dA, Bc, Cc, h_tile=h_tile,
                           init_state=init_state)

    @staticmethod
    def backward(ctx, gy, gstate):
        saved = ctx.saved_tensors
        leaves = [None if t is None else t.detach().requires_grad_()
                  for t in saved]
        live = [t for t in leaves if t is not None]
        with torch.enable_grad(), RANGE("ssd_scan backward"):
            y, state = ss.ssd_scan_plain(*leaves[:4], init_state=leaves[4])
            got = iter(torch.autograd.grad((y, state), live, (gy, gstate)))
        return (*(None if t is None else next(got) for t in leaves), None)


def ssd_scan(xdt, dA, Bc, Cc, *, h_tile: int = 4, init_state=None):
    """Shapes as ``kernels.ssd_scan.ssd_scan``."""
    if _wants_grad(xdt, dA, Bc, Cc, init_state):
        return SSDScan.apply(xdt, dA, Bc, Cc, init_state, h_tile)
    return ss.ssd_scan(xdt, dA, Bc, Cc, h_tile=h_tile, init_state=init_state)
