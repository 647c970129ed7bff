"""The benchmark's counting file against the bounds of the port's kernels
table (PERF.md), and the model FLOPs against the parameters a token
passes through."""
from __future__ import annotations

import pathlib
import sys

import pytest

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from harness import counts, spec  # noqa: E402

F32_PEAK = 67e12          # the float32 CUDA-core peak the table used


@pytest.mark.parametrize("BH,S,D,group,gflop,ms", [
    (256, 2048, 64, 1, 137.5, 0.13904),      # zamba2
    (64, 8192, 128, 2, 1099.6, 1.11188),     # gemma2 global
    (128, 4096, 128, 1, 549.9, 0.55601),     # deepseek-moe-16b
    (128, 4096, 64, 2, 274.9, 0.27800),      # granite-moe-1b-a400m
])
def test_flash_bounds_match_kernels_table(BH, S, D, group, gflop, ms):
    flops = counts.flash_flops(BH, S, S, D, True)
    assert flops / 1e9 == pytest.approx(gflop, abs=0.05)
    assert counts.flash_least_s(BH, S, D, group) * 1e3 == pytest.approx(
        ms, abs=5e-6)


def test_flash_bytes_bound_matches_kernels_table():
    # whisper's decoder self-attention: BH 128, S 416, D 64, bytes-bound
    assert counts.flash_least_s(128, 416, 64, 1) * 1e3 == pytest.approx(
        0.00814, abs=5e-6)


@pytest.mark.parametrize("H,N,ms", [(64, 64, 0.51786), (48, 128, 0.58573)])
def test_ssd_counts_match_kernels_table(H, N, ms):
    flops = counts.ssd_flops(8, 8, 256, H, 64, N)
    assert flops / F32_PEAK * 1e3 == pytest.approx(ms, abs=5e-6)


def test_ssd_least_is_one_tf32_pass_or_bytes():
    shape = (8, 8, 256, 64, 64, 64)
    least = counts.ssd_least_s(*shape)
    assert least == max(counts.ssd_flops(*shape) / 495e12,
                        counts.ssd_bytes(*shape) / 3.35e12)
    assert least * 1e3 == pytest.approx(0.16652, abs=1e-5)   # bytes-bound


def _matmul_params(table, m, family):
    """Weights a token is multiplied by once in a forward pass."""
    n = 0
    for path, (shape, init) in table.items():
        if init != "scaled":
            continue
        size = 1
        for s in shape:
            size *= s
        if family == "moe" and "/we_" in path:
            size = size // m["n_experts"] * m["top_k"]
        n += size
    return n + m["vocab_size"] * m["d_model"]       # the tied LM head


@pytest.mark.parametrize("name", ["mamba2-780m", "granite-moe-1b-a400m"])
def test_forward_flops_are_2N_plus_attention_and_scan(name):
    cfg = spec.load_json(BENCH / "configs" / f"{name}.json")
    m, fam = cfg["model"], spec.reference(cfg["family"])
    B, S = 2, 512
    got = fam.forward_flops(m, B, S)
    extra = 0
    if cfg["family"] == "ssm":
        s = fam.kernel_shapes(m, B, S)["ssd_scan"]
        extra = m["n_layers"] * counts.ssd_flops(**s)
    else:
        extra = m["n_layers"] * 4 * B * m["n_heads"] * m["head_dim"] \
            * counts.causal_pairs(S)
    want = 2 * B * S * _matmul_params(fam.param_table(m), m,
                                      cfg["family"]) + extra
    assert got == want
