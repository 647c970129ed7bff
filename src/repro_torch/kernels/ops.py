"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

There is no ``use_pallas``-style switch: each wrapper runs its kernel's
plain PyTorch version for CPU tensors and launches the CUDA kernel for CUDA
tensors, or raises.  All three of the reference's kernels are ported:
``hash_probe`` (the OCC path's one-sided probe), ``flash_attention`` and
``ssd_scan`` (the serving path's prefill).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import hash_probe as hp
from repro_torch.kernels import ssd_scan as ss

probe_lines = hp.probe_lines      # the dataplane's contract
hash_probe = hp.hash_probe        # the TPU kernel's contract: (B, 29) rows
flash_attention_bhsd = fa.flash_attention_bhsd
ssd_scan = ss.ssd_scan


def flash_attention(q, k, v, *, causal=True, window=None, softcap=None):
    """q (B, Sq, Hq, D); k/v (B, Sk, Hkv, D), the models' layout, adapted to
    the kernel's heads-major (B*H, S, D)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2).reshape(B * Hq, Sq, D)
    kh = k.transpose(1, 2).reshape(B * Hkv, Sk, D)
    vh = v.transpose(1, 2).reshape(B * Hkv, Sk, D)
    out = fa.flash_attention_bhsd(qh, kh, vh, causal=causal, window=window,
                                  softcap=softcap, group=Hq // Hkv)
    return out.reshape(B, Hq, Sq, D).transpose(1, 2)
