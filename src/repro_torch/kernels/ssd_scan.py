"""Mamba2 SSD chunk scan: ``csrc/ssd_scan.cu``, a hand-written CUDA port of
the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``).

Per chunk and head, with ``cum = cumsum(dA)``:
    y     = (C Bᵀ ∘ exp(cum_q - cum_k) ∘ [k <= q]) xdt + (C state) ∘ exp(cum)
    state = exp(cum_Q) state + (B ∘ exp(cum_Q - cum))ᵀ xdt
with the state starting at zero (or at ``init_state``) and carried across
the chunks in order.

Dispatch: a CPU tensor takes :func:`ssd_scan_plain`, a CUDA tensor launches
the kernels or raises.  ``launches`` counts calls that launched them (one
call runs three CUDA kernels).

Bound: float32 operations.  At the serving shape (B 8, 8 chunks of 256, H 64,
P 64, N 64) the causal work is ~35 GFLOP against ~0.56 GB moved (mostly the
f32 ``xdt`` in and ``y`` out): 0.52 ms at the CUDA cores' float32 rate, 0.21
ms as 3xTF32 on the tensor cores.  The card runs the chunked SSD
decomposition, so only an elementwise pass is sequential over chunks
(:func:`ssd_scan_phased` is the same algorithm in PyTorch), in three CUDA
kernels over float32 scratch the wrapper allocates:

1. per (batch row, chunk, head): ``cum`` and the chunk-local state
   ``S_c = (B ∘ exp(cum_last - cum))ᵀ xdt``; and per causal 64 x 64 tile of
   each chunk, ``C·Bᵀ``, computed once for all heads (every head shares B
   and C);
2. elementwise over (b, h, N, P), chunk after chunk: ``state_in[c+1] =
   exp(cum_last[c]) state_in[c] + S_c`` from ``init_state`` or zero, in
   place; the last one is the final state;
3. per (batch row, chunk, head, 64-row q tile):
   ``y = (C·Bᵀ ∘ exp(cum_q - cum_k) ∘ causal) xdt + exp(cum) ∘ (C state_in)``.

Every product runs on the tensor cores in 3xTF32 (each float32 operand split
into two TF32 parts, three products summed in float32), which keeps float32
accuracy.  The CTAs are small (4 warps) so several share an SM and one's
loads overlap another's products; operands stream through three cp.async
stages.  There is no head tile on the card: ``h_tile`` is the TPU
contract's argument and is only checked.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e30
DIMS = (16, 32, 64, 128)               # N and P instantiations of the kernel
SMEM_LIMIT = 232_448                    # bytes of shared memory a block may use

launches = 0                            # calls that launched the kernels


def ssd_scan_plain(xdt, dA, Bc, Cc, *, init_state=None):
    """Plain PyTorch version: the chunk step of ``mamba2.ssd_chunked``,
    vectorised over batch and heads, chunk after chunk."""
    B, nc, Q, H, P = xdt.shape
    N = Bc.shape[-1]
    state = (torch.zeros((B, H, N, P), dtype=torch.float32, device=xdt.device)
             if init_state is None else init_state.float())
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    ys = []
    for c in range(nc):
        x, cum = xdt[:, c], torch.cumsum(dA[:, c], dim=1)
        Bm, Cm = Bc[:, c], Cc[:, c]
        CB = torch.einsum("bqn,bkn->bqk", Cm, Bm)
        delta = cum[:, :, None, :] - cum[:, None, :, :]
        delta = torch.where(causal[None, :, :, None], delta,
                            torch.full_like(delta, NEG))
        y = torch.einsum("bqkh,bkhp->bqhp", CB[..., None] * torch.exp(delta), x)
        y = y + torch.einsum("bqn,bhnp->bqhp", Cm, state) * torch.exp(cum)[..., None]
        dec_end = torch.exp(cum[:, -1:, :] - cum)
        state = (torch.exp(cum[:, -1])[..., None, None] * state
                 + torch.einsum("bkn,bkhp->bhnp", Bm, x * dec_end[..., None]))
        ys.append(y)
    return torch.stack(ys, dim=1), state


def ssd_scan_phased(xdt, dA, Bc, Cc, *, init_state=None):
    """The CUDA kernels' algorithm in plain PyTorch: chunk-local states for
    every chunk at once, the elementwise state passing over chunks, then the
    outputs of every chunk at once with the carry-in from ``state_in``."""
    B, nc, Q, H, P = xdt.shape
    N = Bc.shape[-1]
    dev = xdt.device
    cum = torch.cumsum(dA, dim=2)                              # (B, nc, Q, H)
    last = cum[:, :, -1]                                       # (B, nc, H)
    # 1. chunk-local states
    dec = torch.exp(last[:, :, None] - cum)
    S = torch.einsum("bckn,bckhp->bchnp", Bc, xdt * dec[..., None])
    # 2. state passing
    state = (torch.zeros((B, H, N, P), dtype=torch.float32, device=dev)
             if init_state is None else init_state.float())
    state_in = []
    for c in range(nc):
        state_in.append(state)
        state = torch.exp(last[:, c])[..., None, None] * state + S[:, c]
    state_in = torch.stack(state_in, dim=1)                    # (B, nc, H, N, P)
    # 3. outputs: intra-chunk with C·Bᵀ shared by the heads, then carry-in
    CB = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (B, nc, q, k, H)
    decay = torch.where(causal[None, None, :, :, None], torch.exp(delta),
                        torch.zeros_like(delta))
    y = torch.einsum("bcqkh,bckhp->bcqhp", CB[..., None] * decay, xdt)
    y = y + (torch.einsum("bcqn,bchnp->bcqhp", Cc, state_in)
             * torch.exp(cum)[..., None])
    return y, state


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of the larger of the two product kernels'
    CTAs (``ssd_scan.cu``'s ``run``: cum or the decays, and three stages
    of streamed tiles, or the C and B tiles of one C·Bᵀ tile)."""
    qa = -(-Q // 4) * 4
    state = max(3 * 32 * (N + 8 + P + 8), 2 * 64 * (N + 4))
    out = 3 * (64 * 36 + 32 * (P + 8))
    return 4 * (qa + max(state, out))


def _aligned(t):
    """``t`` contiguous on a 16-byte aligned base (the kernels copy 16-byte
    words), or None."""
    if t is None:
        return None
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(xdt, dA, Bc, Cc, init_state):
    global launches
    from repro_torch.kernels import build
    B, nc, Q, H, P = xdt.shape
    N = Bc.shape[-1]
    if N not in DIMS or P not in DIMS:
        raise ValueError(f"ssd_scan: N={N} and P={P} must be in {DIMS}")
    if smem_bytes(Q, N, P) > SMEM_LIMIT:
        raise ValueError(f"ssd_scan: chunk of {Q} needs more shared memory "
                         f"than a block has")
    want = {"xdt": (B, nc, Q, H, P), "dA": (B, nc, Q, H), "Bc": (B, nc, Q, N),
            "Cc": (B, nc, Q, N)}
    if init_state is not None:
        want["init_state"] = (B, H, N, P)
    got = {"xdt": xdt, "dA": dA, "Bc": Bc, "Cc": Cc, "init_state": init_state}
    for name, shape in want.items():
        x = got[name]
        if x.dtype != torch.float32 or tuple(x.shape) != shape \
                or x.device != xdt.device:
            raise ValueError(f"ssd_scan: {name} must be float32 {shape} on "
                             f"{xdt.device}, got {x.dtype} {tuple(x.shape)} "
                             f"on {x.device}")
    y = torch.empty_like(xdt)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=xdt.device)
    if B * nc * Q * H == 0:
        return y, state.zero_() if init_state is None else state.copy_(init_state)
    # scratch: the chunk-local states (then state_in, in place), cum_last,
    # cum, and C·Bᵀ, the last two with rows padded to a multiple of 4
    qa = -(-Q // 4) * 4
    scratch = lambda *shape: torch.empty(shape, dtype=torch.float32,
                                         device=xdt.device)
    chunk_states = scratch(B, nc, H, N, P)
    chunk_last, cum, cb = scratch(B, nc, H), scratch(B, nc, H, qa), \
        scratch(B, nc, Q, qa)
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                 0 if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), chunk_states.data_ptr(),
                 chunk_last.data_ptr(), cum.data_ptr(), cb.data_ptr(), B, nc,
                 Q, H, P, N, stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd_scan(xdt, dA, Bc, Cc, *, h_tile: int = 4, init_state=None):
    """xdt (B, nc, Q, H, P) f32 (= x * dt); dA (B, nc, Q, H) f32 (= dt * A);
    Bc/Cc (B, nc, Q, N) f32; optional init_state (B, H, N, P) f32.  Returns
    (y (B, nc, Q, H, P) f32, final state (B, H, N, P) f32).  ``h_tile`` is
    the TPU contract's head tile and must divide H; the card's kernels take
    one head per CTA and share C·Bᵀ across all heads."""
    H = xdt.shape[3]
    if h_tile < 1 or H % h_tile:
        raise ValueError(f"ssd_scan: h_tile {h_tile} must divide H = {H}")
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, dA, Bc, Cc, init_state=init_state)
    if xdt.device.type == "meta":        # a dry run: shapes only
        B, H, P, N = xdt.shape[0], xdt.shape[3], xdt.shape[4], Bc.shape[-1]
        return (torch.empty_like(xdt, dtype=torch.float32),
                torch.empty((B, H, N, P), dtype=torch.float32, device="meta"))
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xdt.device}")
    return _launch(*map(_aligned, (xdt, dA, Bc, Cc, init_state)))
