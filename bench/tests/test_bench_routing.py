"""The routing diagnostics of ``limits.py`` on the tiny MoE, on the CPU."""
from __future__ import annotations

import pathlib
import sys

import torch

BENCH = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

import faults  # noqa: E402
import limits  # noqa: E402
from harness import spec  # noqa: E402

MODEL = faults.TINY["tiny-moe"]["model"]


def test_dropped_share_counts_assignments_past_capacity():
    # 8 tokens, top 2 over 4 experts: capacity ceil(8 * 2 / 4 * 1.25) = 5;
    # expert 0 takes 8 assignments, 3 past its capacity
    top = torch.tensor([[0, 1]] * 4 + [[0, 2]] * 4)
    assert limits.dropped_share(MODEL, top) == 3 / 16


def test_forced_program_routing_follows_the_queue():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import moe
    torch.manual_seed(0)
    cfg = ModelConfig(**MODEL)
    xt, w = torch.randn(16, 64), torch.randn(64, 4)
    forced = torch.tensor([[3, 2]] * 16)
    queue, seen = [forced], []
    undo = limits._force_program_routing(queue, seen)
    try:
        topv, topi = moe._router(cfg, xt, w)
        free = moe._router(cfg, xt, w)[1]
    finally:
        undo()
    assert torch.equal(topi.long(), forced) and torch.equal(seen[0], forced)
    assert torch.allclose(topv.sum(-1), torch.ones(16))
    assert torch.equal(free.long(), moe._router(cfg, xt, w)[1].long())
    assert queue == [] and len(seen) == 2


def test_routing_readings_of_a_prefill_mix():
    mix = dict(spec.traffic("prefill-8xmix"), batch=2, lengths=[32, 64],
               kv_positions=8)
    got = limits.routing_readings(MODEL, spec.reference("moe"), mix, 5,
                                  torch.device("cpu"), 1)
    L = MODEL["n_layers"]
    assert len(got["dropped"]) == len(got["flipped"]) == L
    assert all(0 <= x <= 1 for x in got["dropped"] + got["flipped"])
    for who in ("program", "program_forced", "control", "control_forced"):
        assert set(got[who]) == {"logit_gap", "logit_gap_mean", "cache_gap",
                                 "cache_gap_median", "cache_gap_first"}
    # forced onto the reference's choices, the program's worst layer is no
    # farther from the reference than when it routes itself
    assert got["program_forced"]["cache_gap"] <= got["program"]["cache_gap"]
