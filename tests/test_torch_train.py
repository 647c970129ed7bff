"""PyTorch port, training: the train launcher (checkpoint and resume on the
CPU) and the tests that need the card (the kernels' gradients against
their backwards).  This file imports no JAX, so the card's machine runs it;
the other training tests are in ``tests/test_torch_train_*.py``, their
limits in ``tests/torch_train_common.py``."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import layers as L

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_train_launcher_checkpoints_and_resumes(tmp_path):
    """``launch.train --smoke --device cpu``: 4 steps with a checkpoint
    every 2, then a resume from step 4 for 2 more; the resumed run's steps
    equal an uninterrupted 6-step run's."""
    ck = tmp_path / "ck"
    env = {**os.environ, "PYTHONPATH": "src"}

    def run(*args):
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch",
             "qwen1.5-4b", "--smoke", "--device", "cpu", "--batch", "2",
             "--seq", "64", *args], capture_output=True, text=True, env=env,
            cwd=str(ROOT), timeout=300)
        assert out.returncode == 0, out.stderr
        return [ln for ln in out.stdout.splitlines() if ln.startswith("step")], \
            out.stdout
    first, log = run("--steps", "4", "--ckpt-dir", str(ck), "--ckpt-every", "2")
    assert "checkpoint committed: step_00000004 (storm tx, latest=4)" in log
    assert sorted(p.name for p in ck.glob("step_*")) == ["step_00000002",
                                                          "step_00000004"]
    manifest = json.loads((ck / "step_00000004" / "manifest.json").read_text())
    assert manifest["step"] == 4
    resumed, log = run("--steps", "2", "--ckpt-dir", str(ck), "--resume")
    assert "resumed from step 4" in log
    whole, _ = run("--steps", "6")
    loss = lambda line: line.split("loss")[1].split()[0]
    assert [loss(x) for x in first + resumed] == [loss(x) for x in whole]
    assert resumed[0].split()[1] == "4"


# --- on the card -------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_card_attention_gradients_match_the_backward(cuda, dtype):
    """On the card the forward launches the kernel and the gradients equal
    autograd through ``block_attention_jnp`` on the same device."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 256, 4, 64, generator=g, device=cuda).to(dtype)
    k, v = (torch.randn(2, 256, 2, 64, generator=g, device=cuda).to(dtype)
            for _ in range(2))
    w = torch.randn(q.shape, generator=g, device=cuda)

    def grads(fn):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * w).sum(), leaves)
    n = fa.launches
    through = grads(lambda *a: L.block_attention(*a, q_block=128,
                                                 kv_block=128))
    assert fa.launches == n + 1
    want = grads(lambda *a: L.block_attention_jnp(*a, q_block=128,
                                                  kv_block=128))
    for a, b in zip(through, want):
        assert torch.equal(a, b)
        assert float(a.abs().max()) > 0


@pytest.mark.cuda
def test_card_ssd_gradients_match_the_backward(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    Bn, nc, Q, H, P, N = 2, 4, 64, 4, 64, 64
    x = torch.randn(Bn, nc, Q, H, P, generator=g, device=cuda)
    dA = -torch.rand(Bn, nc, Q, H, generator=g, device=cuda) * 0.1
    Bc, Cc = (torch.randn(Bn, nc, Q, N, generator=g, device=cuda)
              for _ in range(2))
    wy = torch.randn(x.shape, generator=g, device=cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() for t in (x, dA, Bc, Cc)]
        y, st = fn(*leaves)
        return torch.autograd.grad((y * wy).sum() + st.sum(), leaves)
    n = ss.launches
    through = grads(lambda *a: ops.ssd_scan(*a, h_tile=1))
    assert ss.launches == n + 1
    want = grads(lambda *a: ss.ssd_scan_plain(*a))
    for a, b in zip(through, want):
        assert torch.equal(a, b)
        assert float(a.abs().max()) > 0
