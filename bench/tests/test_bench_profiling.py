"""The traced window's reduction on a hand-made timeline."""
from __future__ import annotations

import pathlib
import sys
from types import SimpleNamespace as NS

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from harness import profiling, readers  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def ev(name, start_us, end_us, dev=CUDA, annot=False):
    return NS(name=name, device_type=dev, is_user_annotation=annot,
              time_range=NS(start=start_us, end=end_us))


def test_reduce_events():
    events = [
        ev("void flash_tc_kernel<64>", 0, 100),
        ev("ssd_chunk_out", 150, 250),
        ev("elementwise", 240, 300),            # overlaps the one before
        ev("adamw", 140, 320, annot=True),      # the span, on the device
        ev("adamw", 130, 330, dev=CPU, annot=True),
        ev("aten::item", 100, 150, dev=CPU),
        ev("void flash_tc_kernel<64>", 1000, 1100),
    ]
    r = profiling.reduce_events(events, wall_s=2e-3, span_names=("adamw",))
    assert r["busy_s"] == pytest.approx(350e-6)
    assert r["kernels"]["void flash_tc_kernel<64>"] == pytest.approx(200e-6)
    assert r["spans"]["adamw"] == pytest.approx(160e-6)
    assert r["breakdown"]["idle_gaps"][0][1] == pytest.approx(700e-6)
    assert r["breakdown"]["idle_gaps"][1] == ["aten::item",
                                              pytest.approx(50e-6)]
    ctx = NS(mix={"kind": "train"}, prof=r,
             launches=[("flash_attention", 2, dict(BH=256, S=2048, D=64,
                                                   group=1))])
    share = readers.roofline(ctx, "train", "flash_attention")
    assert share == pytest.approx(100 * 2 * 0.13904e-3 / 200e-6, rel=1e-4)
    assert readers.device_idle(ctx, "train") == pytest.approx(82.5)
    assert readers.roofline(ctx, "train", "ssd_scan") is None
    assert readers.device_idle(ctx, "prefill") is None
