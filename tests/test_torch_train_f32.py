"""PyTorch port, training: whole-model float32 gradients of every arch
against the reference's, remat, the train state across the packages, and
the train step against the reference's at two microbatches (float32
accumulation), zamba2-1.2b and granite-moe-1b-a400m, granite's second step
held to its own measured limit (``torch_train_common.check_train_step``;
one microbatch: ``tests/test_torch_train_smoke.py``; limits:
``tests/torch_train_common.py``)."""

import torch_threads  # noqa: F401  (first: pins torch's threads)
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from torch_train_common import (ARCHS, batch_of, check_train_step, CPU,
    f32_weights, get, GRAD_REL, japi, JARCHS, jloss, JOPTS, jS, leaves_named,
    LOSS_REL, params_to_numpy, port_grads, rel_err, RunOptions,
    smoke_topology, TILE, train_state_from_numpy)  # noqa: E402


@pytest.fixture(scope="module")
def topo():
    return smoke_topology()


# --- whole-model float32 gradients --------------------------------------------------
@pytest.mark.parametrize("arch", [a for a in sorted(ARCHS)
                                  if get(a).family not in ("audio", "vlm")])
def test_float32_gradients_match_reference(arch, topo):
    cfg_j, cfg, pj, pt = f32_weights(arch)
    jb, tb = batch_of(cfg)

    def lf(p, b):
        return jloss(japi.forward(cfg_j, topo, p, b, opts=JOPTS),
                     b["labels"])[0]
    lj, gj = jax.jit(jax.value_and_grad(lf))(pj, jb)
    lt, gt = port_grads(cfg, pt, tb)
    assert abs(float(lt) - float(lj)) <= LOSS_REL * abs(float(lj))
    worst = (0.0, None)
    for (n, b), (m, a) in zip(leaves_named(jax.device_get(gj)), gt.items()):
        assert n == m
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        assert rel_err(a.numpy(), b) <= GRAD_REL, (n, rel_err(a.numpy(), b))
        worst = max(worst, (rel_err(a.numpy(), b), n))
    print(f"{arch}: loss {abs(float(lt) - float(lj)) / abs(float(lj)):.3e} "
          f"apart; worst leaf {worst[1]} at {worst[0]:.3e} of its largest "
          "|grad|")


@pytest.mark.parametrize("arch,policy", [("zamba2-1.2b", "dots"),
                                         ("zamba2-1.2b", "full"),
                                         ("gemma2-27b", "dots"),
                                         ("granite-moe-1b-a400m", "full")])
def test_remat_gives_the_same_gradients(arch, policy):
    """Rematerialising each layer body (the reference's scanned bodies)
    changes no gradient on the CPU, bit for bit."""
    _, cfg, _, pt = f32_weights(arch)
    _, tb = batch_of(cfg)
    l0, g0 = port_grads(cfg, pt, tb)
    l1, g1 = port_grads(cfg, pt, tb, RunOptions(q_block=TILE, kv_block=TILE,
                                                remat=True,
                                                remat_policy=policy))
    assert torch.equal(l0, l1)
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n



def test_train_state_crosses_from_jax_and_back():
    cfg_j = JARCHS["qwen1.5-4b"].smoke()
    sj = jS.init_train_state(cfg_j, jax.random.key(0))
    st = train_state_from_numpy(jax.device_get(sj), CPU)
    assert st["opt"]["step"].dtype == torch.int32
    assert st["params"]["embed"].dtype == torch.bfloat16
    back = params_to_numpy(st)
    for (n, a), (_, b) in zip(leaves_named(back),
                              leaves_named(jax.device_get(sj))):
        assert a.dtype == np.asarray(b).dtype, n
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# --- the train step ----------------------------------------------------------
@pytest.mark.parametrize("arch,micro", [("zamba2-1.2b", 2),
                                        ("granite-moe-1b-a400m", 2)])
def test_train_step_matches_reference(arch, micro, topo):
    """Two float32 steps, then two bf16 steps, of ``make_train_step``
    against the reference's (``check_train_step``)."""
    check_train_step(arch, micro, topo)
