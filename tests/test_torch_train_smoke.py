"""PyTorch port, training: the reference's smoke tests of training
(``tests/test_smoke_archs.py``) on the port alone: a train step of every
arch, learnability, the eval step; then the train step against the
reference's at one microbatch, zamba2-1.2b and granite-moe-1b-a400m
(``torch_train_common.check_train_step``; two microbatches:
``tests/test_torch_train_f32.py``)."""

import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_train_common import (A, ARCHS, check_train_step, CPU, fa, get,
    OPTS, RunOptions, S, SMOKE_SHAPE, smoke_topology, ss, synthetic_batch,
    TDataConfig)  # noqa: E402


@pytest.fixture(scope="module")
def topo():
    return smoke_topology()


# --- the port alone: the reference's smoke tests of training --------------------------
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_train_step_runs_and_loss_finite(arch):
    """tests/test_smoke_archs.py's test of the same name, on the port."""
    cfg = get(arch).smoke()
    state = S.init_train_state(cfg, torch.Generator().manual_seed(1), CPU)
    step_fn = S.make_train_step(cfg, S.TrainHparams(opts=RunOptions(
        q_block=32, kv_block=32, remat=False)))
    batch = synthetic_batch(cfg, SMOKE_SHAPE, TDataConfig(), 0, device=CPU)
    state, metrics = step_fn(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"]))
    assert float(metrics["grad_norm"]) > 0
    batch2 = synthetic_batch(cfg, SMOKE_SHAPE, TDataConfig(), 1, device=CPU)
    state, metrics2 = step_fn(state, batch2)
    assert np.isfinite(float(metrics2["loss"]))
    assert fa.launches == 0 and ss.launches == 0


def test_loss_decreases_on_repetitive_stream():
    """tests/test_smoke_archs.py's learnability test, on the port."""
    cfg = get("qwen1.5-4b").smoke()
    state = S.init_train_state(cfg, torch.Generator().manual_seed(2), CPU)
    hp = S.TrainHparams(opts=RunOptions(q_block=32, kv_block=32, remat=False),
                        optimizer=A.AdamWConfig(lr=5e-3, warmup_steps=10,
                                                weight_decay=0.0))
    step_fn = S.make_train_step(cfg, hp)
    losses = []
    for s in range(100):
        batch = synthetic_batch(cfg, SMOKE_SHAPE, TDataConfig(), s, device=CPU)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    assert np.isfinite(losses).all()
    assert min(losses[-10:]) < losses[0] * 0.99, (losses[:5], losses[-10:])
    assert min(losses[-10:]) < min(losses[:5]), (losses[:5], losses[-10:])


def test_eval_step_matches_train_metrics():
    cfg = get("glm4-9b").smoke()
    state = S.init_train_state(cfg, torch.Generator().manual_seed(0), CPU)
    batch = synthetic_batch(cfg, SMOKE_SHAPE, TDataConfig(), 0, device=CPU)
    ev = S.make_eval_step(cfg, OPTS)(state["params"], batch)
    _, m = S.make_train_step(cfg, S.TrainHparams(opts=OPTS))(state, batch)
    for k in ("loss", "accuracy", "tokens"):
        assert float(ev[k]) == float(m[k])


# --- the train step ----------------------------------------------------------
@pytest.mark.parametrize("arch,micro", [("zamba2-1.2b", 1),
                                        ("granite-moe-1b-a400m", 1)])
def test_train_step_matches_reference(arch, micro, topo):
    """Two float32 steps, then two bf16 steps, of ``make_train_step``
    against the reference's (``check_train_step``)."""
    check_train_step(arch, micro, topo)
