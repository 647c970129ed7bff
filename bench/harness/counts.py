"""The yardstick's arithmetic: the published peaks of the card, and the
operations and bytes of the program's kernels and of a model's forward
pass, worked out from shapes alone.

``flash_flops`` / ``flash_bytes`` and ``ssd_flops`` / ``ssd_bytes`` are the
counts the port's on-card checks use for its kernels table; the scan's
least time is taken at the TF32 tensor-core peak at one pass, since no
float32-accurate method of the scan needs less than one TF32 pass.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet: dense tensor-core rates without sparsity, HBM3
PEAK_BF16_FLOP_S = 989e12
PEAK_TF32_FLOP_S = 495e12
PEAK_HBM_BYTES_S = 3.35e12


def flash_flops(BH: int, Sq: int, Sk: int, D: int, causal: bool) -> int:
    """The two products (QKᵀ and PV) over the (q, k) pairs the causal mask
    keeps, queries at positions 0 .. Sq - 1."""
    if causal:
        pairs = sum(min(q, Sk - 1) + 1 for q in range(Sq))
    else:
        pairs = Sq * Sk
    return 4 * BH * D * pairs


def flash_bytes(BH: int, Sq: int, Sk: int, D: int, group: int,
                elem: int = 2) -> int:
    """q and the output (BH heads), k and v (BH / group heads), each read or
    written once."""
    return elem * D * (2 * BH * Sq + 2 * (BH // group) * Sk)


def flash_least_s(BH, S, D, group, causal=True) -> float:
    return max(flash_flops(BH, S, S, D, causal) / PEAK_BF16_FLOP_S,
               flash_bytes(BH, S, S, D, group) / PEAK_HBM_BYTES_S)


def ssd_flops(B: int, nc: int, Q: int, H: int, P: int, N: int) -> int:
    """Per chunk the causal half of C Bᵀ, and per head the causal half of
    the intra-chunk product, the carry-in and the state products."""
    tri = Q * (Q + 1) // 2
    return 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))


def ssd_bytes(B: int, nc: int, Q: int, H: int, P: int, N: int) -> int:
    """float32 xdt in and y out, dA, B and C in, the final state out."""
    return 4 * (2 * B * nc * Q * H * P + B * nc * Q * H + 2 * B * nc * Q * N
                + B * H * N * P)


def ssd_least_s(B, nc, Q, H, P, N) -> float:
    return max(ssd_flops(B, nc, Q, H, P, N) / PEAK_TF32_FLOP_S,
               ssd_bytes(B, nc, Q, H, P, N) / PEAK_HBM_BYTES_S)


def causal_pairs(S: int) -> int:
    return S * (S + 1) // 2


def attention_flops(B, S, d, n_heads, n_kv, head_dim) -> int:
    """One causal attention layer: the q, k, v and output projections (2mnk
    each) and the two products over the causal pairs."""
    qd, kvd = n_heads * head_dim, n_kv * head_dim
    proj = 2 * B * S * d * (2 * qd + 2 * kvd)
    return proj + 4 * B * n_heads * head_dim * causal_pairs(S)
