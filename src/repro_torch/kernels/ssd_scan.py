"""Mamba2 SSD chunk scan: ``csrc/ssd_scan.cu``, a hand-written CUDA port of
the Pallas TPU kernel ``repro/kernels/ssd_scan.py`` (``ssd_scan``).

Per chunk and head, with ``cum = cumsum(dA)``:
    y     = (C Bᵀ ∘ exp(cum_q - cum_k) ∘ [k <= q]) xdt + (C state) ∘ exp(cum)
    state = exp(cum_Q) state + (B ∘ exp(cum_Q - cum))ᵀ xdt
with the state starting at zero (or at ``init_state``) and carried across
the chunks in order.

Dispatch: a CPU tensor takes :func:`ssd_scan_plain`, a CUDA tensor launches
the kernel or raises.  ``launches`` counts kernel launches.

Bound: float32 operations.  At the serving shape (B 8, 8 chunks of 256, H 64,
P 64, N 64) the causal work is ~35 GFLOP against ~0.56 GB moved (mostly the
f32 ``xdt`` in and ``y`` out), so the CUDA cores' float32 rate bounds it
before the memory does.  One CTA walks the chunks of ``h_tile`` heads of one
batch row, one head after the other, keeping the (N, P) state in shared
memory; see the CUDA source for the tiling.
"""
from __future__ import annotations

import ctypes

import torch

NEG = -1e30
DIMS = (16, 32, 64, 128)               # N and P instantiations of the kernel
SMEM_LIMIT = 232_448                    # bytes of shared memory a block may use

launches = 0                            # kernel launches since the last reset


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


def smem_bytes(Q: int, N: int, P: int) -> int:
    """Dynamic shared memory of one CTA (``ssd_scan.cu``: cum, C and B tiles,
    xdt tile, score tile, state)."""
    return 4 * (Q + 2 * 64 * (N + 1) + 64 * P + 64 * 80 + N * P)


def _launch(xdt, dA, Bc, Cc, init_state, h_tile):
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
    fn = build.load("ssd_scan").ssd_scan_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = fn(xdt.data_ptr(), dA.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                 0 if init_state is None else init_state.data_ptr(),
                 y.data_ptr(), state.data_ptr(), B, nc, Q, H, P, N, h_tile,
                 stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd_scan(xdt, dA, Bc, Cc, *, h_tile: int = 4, init_state=None):
    """xdt (B, nc, Q, H, P) f32 (= x * dt); dA (B, nc, Q, H) f32 (= dt * A);
    Bc/Cc (B, nc, Q, N) f32; optional init_state (B, H, N, P) f32.  Returns
    (y (B, nc, Q, H, P) f32, final state (B, H, N, P) f32).  ``h_tile`` heads
    share a CTA on the card (H % h_tile == 0, as on the TPU)."""
    H = xdt.shape[3]
    if h_tile < 1 or H % h_tile:
        raise ValueError(f"ssd_scan: h_tile {h_tile} must divide H = {H}")
    if xdt.device.type == "cpu":
        return ssd_scan_plain(xdt, dA, Bc, Cc, init_state=init_state)
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {xdt.device}")
    c = lambda t: None if t is None else t.contiguous()
    return _launch(c(xdt), c(dA), c(Bc), c(Cc), c(init_state), h_tile)
