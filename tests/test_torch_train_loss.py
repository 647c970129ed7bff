"""PyTorch port, training: ``lm_loss`` and AdamW (``apply_updates``) against
the JAX package (limits: ``tests/torch_train_common.py``)."""

import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_train_common import (A, CPU, jA, japi, JARCHS, jinit, jloss, jnp,
    leaves_named, lm_loss, OPT_REL, params_from_numpy, rel_err)  # noqa: E402


# --- lm_loss --------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    rng = np.random.RandomState(0)
    logits = (rng.randn(3, 17, 251) * 3).astype(np.float32)
    labels = rng.randint(0, 251, (3, 17)).astype(np.int32)
    labels[0, :5] = logits[0, :5].argmax(-1)        # some hits
    mask = (rng.rand(3, 17) < 0.7).astype(np.float32) if masked else None
    lj, mj = jloss(jnp.asarray(logits), jnp.asarray(labels),
                   None if mask is None else jnp.asarray(mask))
    lt, mt = lm_loss(torch.from_numpy(logits), torch.from_numpy(labels).long(),
                     None if mask is None else torch.from_numpy(mask))
    for k in ("loss", "accuracy", "tokens"):
        assert rel_err(float(mt[k]), float(mj[k])) <= OPT_REL, k
    assert float(mt["accuracy"]) > 0
    assert lt is mt["loss"]


def test_lm_loss_argmax_takes_the_first_maximum():
    logits = torch.zeros((1, 2, 5))
    logits[0, 1, 3] = 1.0
    _, m = lm_loss(logits, torch.tensor([[0, 3]]))
    j = jloss(jnp.zeros((1, 2, 5)).at[0, 1, 3].set(1.0), jnp.asarray([[0, 3]]))
    assert float(m["accuracy"]) == float(j[1]["accuracy"]) == 1.0


# --- AdamW given the same gradients -----------------------------------------------
def _midpoint_ok(pt, pj, wj):
    """bf16 params equal except where the JAX master sits at a bf16 rounding
    midpoint (within a few float32 ulps of it)."""
    a = pt.float().numpy()
    b = np.asarray(pj, np.float32)
    diff = a != b
    if not diff.any():
        return True
    mid = (a[diff] + b[diff]) / 2
    w = np.asarray(wj, np.float32)[diff]
    return bool((np.abs(w - mid) <= 4 * np.spacing(np.abs(mid))).all())


def test_apply_updates_matches_reference():
    cfg_j = JARCHS["qwen1.5-4b"].smoke()
    pj = jinit(japi.param_specs(cfg_j), jax.random.key(3))
    oj = jA.init_opt_state(pj)
    pt = params_from_numpy(jax.device_get(pj), CPU)
    ot = A.init_opt_state(pt)
    hp = jA.AdamWConfig(warmup_steps=2)
    tp = A.AdamWConfig(warmup_steps=2)
    rng = np.random.RandomState(0)
    upd = jax.jit(lambda g, o: jA.apply_updates(hp, g, o))
    norms = []
    # a clipped step, an unclipped one (global norm below 1), a clipped one
    for scale in (1.0, 1e-4, 0.3):
        g = jax.tree.map(lambda p: (rng.randn(*p.shape) * scale).astype(np.float32),
                         jax.device_get(pj))
        pj, oj, mj = upd(g, oj)
        pt, ot, mt = A.apply_updates(tp, params_from_numpy(g, CPU), ot)
        for k in ("grad_norm", "lr"):
            assert rel_err(float(mt[k]), float(mj[k])) <= OPT_REL, k
        norms.append(float(mj["grad_norm"]))
        for part in ("master", "m", "v"):
            for (n, a), (_, b) in zip(leaves_named(ot[part]),
                                      leaves_named(jax.device_get(oj[part]))):
                assert rel_err(a.numpy(), b) <= OPT_REL, (scale, part, n)
        assert int(ot["step"]) == int(oj["step"])
        for (n, a), (_, b), (_, w) in zip(
                leaves_named(pt), leaves_named(jax.device_get(pj)),
                leaves_named(jax.device_get(oj["master"]))):
            assert a.dtype == torch.bfloat16
            assert _midpoint_ok(a, b, w), (scale, n)
    assert norms[0] > 1 > norms[1] and norms[2] > 1, norms


def test_apply_updates_in_place_keeps_the_parameters_dtype():
    params = {"w": torch.ones((3, 4), dtype=torch.bfloat16),
              "b": torch.zeros(4, dtype=torch.float32)}
    opt = A.init_opt_state(params)
    w, b = params["w"], params["b"]
    grads = {"w": torch.full((3, 4), 0.5, dtype=torch.bfloat16),
             "b": torch.full((4,), -0.5)}
    out, opt2, m = A.apply_updates(A.AdamWConfig(warmup_steps=1), grads, opt,
                                   params=params)
    assert out is params and opt2 is opt
    assert params["w"] is w and params["b"] is b
    assert w.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert torch.equal(w, opt["master"]["w"].to(torch.bfloat16))
    assert torch.equal(b, opt["master"]["b"])
    assert int(opt["step"]) == 1 and float(m["lr"]) == pytest.approx(3e-4)
