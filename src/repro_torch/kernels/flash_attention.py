"""Forward flash attention: ``csrc/flash_attention.cu``, a hand-written CUDA
port of the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention_bhsd``).

Heads-major layout: q (BHq, Sq, D), k/v (BHkv, Sk, D) with BHq = BHkv *
group; q head ``b`` reads kv head ``b // group``.  Query row ``i`` sits at
position ``q_offset + i`` for the causal and window masks (the reference's
``block_attention(q_offset=)``; the sequence-parallel attention's rank
holds rows ``[r S/tp, (r + 1) S/tp)`` against every key).  Online softmax with
float32 ``m``/``l``/``acc``; causal and sliding-window blocks outside the
mask are skipped; optional tanh softcap; scale ``D ** -0.5``; ``p`` is
rounded to the input type before the PV product, as the TPU kernel does.

Dispatch: a CPU tensor takes :func:`flash_attention_plain`, a CUDA tensor
launches the kernel or raises.  ``launches`` counts kernel launches.

Bound: operations.  At the serving shape (BH 256, S 2048, D 64, causal,
bf16) the two products are ~137 GFLOP against ~268 MB of q/k/v/out, far
above the card's ~295 bf16 FLOP per byte, so the tensor-core rate bounds it.
The C entry point dispatches on dtype to one of two hand-written kernels:

* bfloat16 (the serving path): FlashAttention-3's shape on the tensor
  cores.  A CTA per (head, 128-row q block), the heavier causal blocks
  first and one head's blocks together (K/V from L2); a producer warpgroup
  keeps TMA loads of 128-row K/V tiles in flight through a swizzled ring of
  mbarrier-guarded stages; two consumer warpgroups of 64 q rows each run
  ``S = Q Kᵀ`` as a ``wgmma`` from shared memory, the online softmax in
  registers (exp2 with the scale folded in, float32 ``m``/``l``), and
  ``O += P V`` as a ``wgmma`` with the bf16 ``p`` in registers and V read
  transposed from shared memory; S of one block is issued with the PV
  product of the one before, and at D <= 64 the two warpgroups take turns
  to issue.  Mask and softcap run only on blocks that need them.  Tiles
  128 x 128 (``TC_BLOCK``).
* float32 (the float32 model checks only): the CUDA-core kernel, float32
  products in 64 x 64 tiles (``BLOCK``).

The plain version tiles as the kernel of the input's dtype does, so both
round ``p`` at the same running maxima.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128)          # the CUDA kernel's instantiations
BLOCK = 64          # the float32 kernel's q and kv tile (kBQ, kBK in the .cu)
TC_BLOCK = 128      # the bf16 tensor-core kernel's tiles (tc::kBM, tc::kBN)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0                            # kernel launches since the last reset


def tile(dtype) -> int:
    """The q and kv tile of the CUDA kernel for ``dtype``."""
    return TC_BLOCK if dtype == torch.bfloat16 else BLOCK


def flash_attention_plain(q, k, v, *, causal=True, window=None, softcap=None,
                          q_block=None, kv_block=None, group=1, q_offset=0):
    """Plain PyTorch version: the TPU kernel's algorithm, kv block by kv
    block over all q blocks at once, with its block skipping.  Its default
    tiles are the CUDA kernel's for q's dtype (:func:`tile`), so both round
    ``p`` at the same running maxima; the TPU kernel's tiles can be given
    to compare with it."""
    q_block = tile(q.dtype) if q_block is None else q_block
    kv_block = tile(q.dtype) if kv_block is None else kv_block
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    qb, kb = min(q_block, Sq), min(kv_block, Sk)
    n_q, n_kv = -(-Sq // qb), -(-Sk // kb)
    pad = lambda t, n: torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))
    qf = pad(q, n_q * qb).float().reshape(BH, n_q, qb, D)
    kx = pad(k, n_kv * kb).repeat_interleave(group, 0)
    vx = pad(v, n_kv * kb).repeat_interleave(group, 0)
    dev = q.device
    acc = torch.zeros((BH, n_q, qb, D), dtype=torch.float32, device=dev)
    m = torch.full((BH, n_q, qb), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((BH, n_q, qb), dtype=torch.float32, device=dev)
    q_lo = q_offset + torch.arange(n_q, device=dev) * qb       # positions
    qpos = q_lo[:, None] + torch.arange(qb, device=dev)          # (n_q, qb)
    for j in range(n_kv):
        k_lo = j * kb
        needed = torch.ones(n_q, dtype=torch.bool, device=dev)
        if causal:
            needed &= k_lo <= q_lo + qb - 1
        if window is not None:
            needed &= k_lo + kb - 1 >= q_lo - (window - 1)
        ks = kx[:, k_lo:k_lo + kb].float()
        vs = vx[:, k_lo:k_lo + kb]
        s = torch.einsum("bnqd,bkd->bnqk", qf, ks) * D ** -0.5
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        kpos = k_lo + torch.arange(kb, device=dev)
        mask = (kpos < Sk)[None, None, :].expand(n_q, qb, kb)
        if causal:
            mask = mask & (qpos[:, :, None] >= kpos)
        if window is not None:
            mask = mask & (kpos > qpos[:, :, None] - window)
        s = torch.where(mask, s, torch.full_like(s, NEG))
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l_new = corr * l + p.sum(-1)
        pv = torch.einsum("bnqk,bkd->bnqd", p.to(v.dtype).float(), vs.float())
        a_new = corr[..., None] * acc + pv
        keep = needed[None, :, None]
        acc = torch.where(keep[..., None], a_new, acc)
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(BH, n_q * qb, D)[:, :Sq].to(q.dtype)


def _launch(q, k, v, *, causal, window, softcap, group, q_offset=0):
    global launches
    from repro_torch.kernels import build
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q/k/v must all be float32 or "
                         f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if k.shape != v.shape or k.shape != (BH // group, Sk, D) or BH % group:
        raise ValueError(f"flash_attention: k/v must be (BHq/group, Sk, D) = "
                         f"({BH}/{group}, Sk, {D}), got {tuple(k.shape)} "
                         f"and {tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k and v must be on one device")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    # TMA (the bf16 kernel) reads from 16-byte aligned bases
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (q, k, v))
    fn = build.load("flash_attention").flash_attention_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                           ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH,
                 Sq, Sk, int(q_offset), D, group, int(causal),
                 -1 if window is None else window, int(softcap is not None),
                 0.0 if softcap is None else float(softcap), _DTYPES[q.dtype],
                 stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def flash_attention_bhsd(q, k, v, *, causal=True, window=None, softcap=None,
                         group=1, q_offset=0):
    """q (BHq, Sq, D); k/v (BHkv, Sk, D) with BHq == BHkv * group -> (BHq,
    Sq, D) in q's dtype, tiled ``tile(q.dtype)`` square on either device;
    q's rows at positions ``q_offset`` on."""
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (Sk == 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be >= 0, got "
                         f"{q_offset}")
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap, group=group,
                                     q_offset=q_offset)
    if q.device.type == "meta":          # a dry run: shapes only
        return torch.empty_like(q)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _launch(q.contiguous(), k.contiguous(), v.contiguous(),
                   causal=causal, window=window, softcap=softcap, group=group,
                   q_offset=q_offset)
