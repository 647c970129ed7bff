"""Public wrappers around the port's kernels (counterpart of
``repro/kernels/ops.py``).

There is no ``use_pallas``-style switch: each wrapper runs its kernel's
plain PyTorch version for CPU tensors and launches the CUDA kernel for CUDA
tensors, or raises.  Of the reference's three kernels only ``hash_probe`` is
on this slice's path; ``flash_attention`` and ``ssd_scan`` are still to be
ported.
"""
from __future__ import annotations

from repro_torch.kernels import hash_probe as hp

probe_lines = hp.probe_lines      # the dataplane's contract
hash_probe = hp.hash_probe        # the TPU kernel's contract: (B, 29) rows
