"""Shared inputs, limits and helpers of the training tests of the PyTorch
port (``tests/test_torch_train*.py``: the loss and AdamW, the kernels'
gradients, whole-model float32 gradients and train steps, the train step
against the reference, the launcher and the card tests), held against the
JAX package on the same weights and inputs at the ``smoke()`` size.

The JAX side runs on ``Topology(make_smoke_mesh())`` (Auto axes; see
ROADMAP.md section 3), its weights cross with ``convert.params_from_numpy``.
Gradients are held in float32 weights: in bf16 they are dominated by
rounding at init in both packages (the total gradient norms of one batch
differ by tens of per cent between them), so a bf16 step is held by its
loss only.

Limits (the readings that set them are in CHANGES.md):
  * ``GRAD_REL`` = 5e-3 of each leaf's largest |grad| for whole-model float32
    gradients; the eight archs read 3.1e-5 to 1.52e-3 (the audio and VLM
    archs: tests/test_torch_audio_vlm.py);
  * ``ILL_STEP_REL`` = 5e-2 for granite-moe-1b-a400m's second train step,
    which is ill-conditioned in float32: a 1e-7 relative change of the
    embeddings moves its gradients by up to 9.8e-3 of a leaf's largest
    value (perturbation seeds 0-7 read 5.46e-3, 9.80e-3, 3.83e-3, 5.92e-3,
    1.35e-3, 1.39e-3, 3.17e-3, 2.38e-3 at one microbatch; 5.55e-3,
    9.59e-3, 3.44e-3, 5.28e-3, 1.22e-3, 1.69e-3, 3.12e-3, 2.61e-3 at two);
    the test measures the worst of seeds 0-3 and fails above a quarter of
    the limit;
  * ``LOSS_REL`` = 1e-5 for a float32 loss (read: at most 3.8e-7);
  * ``BF16_LOSS_REL`` = 3e-3 for the bf16 step's loss;
  * 1e-6 relative for ``lm_loss`` and for AdamW given the same gradients.
"""
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCHS as JARCHS  # noqa: E402
from repro.data.pipeline import DataConfig, synthetic_tokens  # noqa: E402
from repro.launch.mesh import make_smoke_mesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import mamba2 as jM  # noqa: E402
from repro.models.transformer import RunOptions as JOpts  # noqa: E402
from repro.optim import adamw as jA  # noqa: E402
from repro.parallel.sharding import Topology, init_params as jinit  # noqa: E402
from repro.train import step as jS  # noqa: E402
from repro.train.loss import lm_loss as jloss  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import ARCHS, get  # noqa: E402
from repro_torch.convert import (params_from_numpy, params_to_numpy,  # noqa: E402
                                 train_state_from_numpy)
from repro_torch.data.pipeline import DataConfig as TDataConfig  # noqa: E402
from repro_torch.data.pipeline import synthetic_batch  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.parallel.sharding import ONE_DEVICE  # noqa: E402
from repro_torch.models import mamba2 as M  # noqa: E402
from repro_torch.models.transformer import RunOptions  # noqa: E402
from repro_torch.optim import adamw as A  # noqa: E402
from repro_torch.train import step as S  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402


ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
B, SEQ = 2, 96          # past gemma2's smoke window of 64; 3 SSD chunks of 32
TILE = 32               # the attention backward's tiles: 3 x 3 blocks
GRAD_REL = 5e-3
LOSS_REL = 1e-5
BF16_LOSS_REL = 3e-3
OPT_REL = 1e-6
# (arch, step) of test_train_step_matches_reference held to their own limit:
# after one update at lr 0.1 granite's float32 gradients are ill-conditioned
# (float64 runs of both packages agree to 5e-12, and each package's float32
# run is 3.3e-3 (the port) and 9.8e-3 (the reference) of a leaf's largest
# gradient away from them; at the first step both are 5e-3 away but round
# alike).  The limit sits more than four times above the measured
# conditioning (COND_REL's change of the embeddings, the worst of
# COND_SEEDS), which must stay under a quarter of it.
ILL_STEP_REL = {("granite-moe-1b-a400m", 1): 5e-2}
COND_REL = 1e-7
COND_SEEDS = range(4)
SMOKE_SHAPE = ShapeConfig("smoke", seq_len=64, global_batch=2, kind="train")
JOPTS = JOpts(q_block=TILE, kv_block=TILE, remat=False)
OPTS = RunOptions(q_block=TILE, kv_block=TILE, remat=False)


def smoke_topology():
    """The reference's Topology on make_smoke_mesh() (Auto axes); each test
    module that needs it holds it in a module-scoped ``topo`` fixture."""
    return Topology(make_smoke_mesh())


def leaves_named(tree, pre=""):
    """(path, leaf) in sorted key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves_named(tree[k],
                                                              f"{pre}/{k}")]
    return [(pre, tree)]


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def batch_of(cfg, n=B, seq=SEQ, step=0):
    toks = synthetic_tokens(DataConfig(), step, n, seq + 1, cfg.vocab_size)
    jb = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]).long(),
          "labels": torch.from_numpy(toks[:, 1:]).long()}
    return jb, tb


def f32_weights(arch):
    cfg_j, cfg = JARCHS[arch].smoke(), get(arch).smoke()
    pj = jax.tree.map(lambda a: a.astype(jnp.float32),
                      jinit(japi.param_specs(cfg_j), jax.random.key(0)))
    return cfg_j, cfg, pj, params_from_numpy(jax.device_get(pj), CPU)


def port_grads(cfg, params, batch, opts=OPTS):
    live = A.tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = lm_loss(api.forward(cfg, live, batch, opts=opts),
                      batch["labels"])
    names = [n for n, _ in leaves_named(live)]
    return loss.detach(), dict(zip(names, torch.autograd.grad(
        loss, A.tree_leaves(live))))


def conditioning(cfg, params, batch, seed=0):
    """How far the port's float32 gradients move, as a share of each leaf's
    largest |grad| (the worst leaf), for a COND_REL relative change of the
    embeddings drawn from ``seed``."""
    _, g = port_grads(cfg, params, batch)
    e = params["embed"]
    noise = torch.randn(e.shape, generator=torch.Generator().manual_seed(seed))
    _, h = port_grads(cfg, dict(params, embed=e * (1 + COND_REL * noise)),
                      batch)
    return max(float((g[n] - h[n]).abs().max() / g[n].abs().max()) for n in g)


# --- the train step ------------------------------------------------------------------
def _as_f32_params(state):
    """The state with its parameters replaced by the float32 master copy, so
    a second step runs in float32 (the reference's step leaves bf16)."""
    return {"params": state["opt"]["master"], "opt": state["opt"]}


def check_train_step(arch, micro, topo):
    """Two float32 steps of ``make_train_step`` against the reference's, each
    from the same state (the reference's, carried across): the metrics; m
    and v per leaf within GRAD_REL of the leaf's largest value; the master
    weights' update (master - before) within GRAD_REL of the leaf's
    largest update plus two float32 spacings of its largest weight (the
    master's own rounding).  granite's second step is ill-conditioned in
    float32 (its routing has no near tie there: the 8th and 9th router
    logits are 3.9e-3 apart at the least), so it is held to its
    ILL_STEP_REL after its conditioning is measured over COND_SEEDS.
    AdamW here has eps 1 (at the default 1e-8 an element whose gradient is
    within rounding of zero moves by +-lr either way: the update is a sign,
    which no two implementations agree on), lr 0.1 from the first step and
    no weight decay, so the update is the gradient's own arithmetic.  Then two bf16 steps at the defaults, each
    package from its own state, held by their loss."""
    cfg_j, cfg, pj, _ = f32_weights(arch)
    adam = dict(lr=0.1, eps=1.0, warmup_steps=1, weight_decay=0.0)
    hpj = jS.TrainHparams(opts=JOPTS, microbatches=micro,
                          optimizer=jA.AdamWConfig(**adam))
    hpt = S.TrainHparams(opts=OPTS, microbatches=micro,
                         optimizer=A.AdamWConfig(**adam))
    step_j = jax.jit(jS.make_train_step(cfg_j, topo, hpj))
    step_t = S.make_train_step(cfg, hpt)
    sj = {"params": pj, "opt": jA.init_opt_state(pj)}
    for s in range(2):
        jb, tb = batch_of(cfg, n=4, step=s)
        st = train_state_from_numpy(jax.device_get(sj), CPU)
        before = dict(leaves_named(jax.device_get(sj["opt"]["master"])))
        limit = ILL_STEP_REL.get((arch, s), GRAD_REL)
        if limit != GRAD_REL:
            moved = [conditioning(cfg, st["opt"]["master"], tb, seed=k)
                     for k in COND_SEEDS]
            assert max(moved) <= limit / 4, (s, moved)
        embed = st["params"]["embed"]
        sj, mj = step_j(sj, jb)
        sj = _as_f32_params(sj)
        st, mt = step_t(st, tb)
        for k in ("tokens", "lr"):
            assert float(mt[k]) == pytest.approx(float(mj[k]), rel=1e-7), k
        for k in ("loss", "accuracy"):
            assert rel_err(float(mt[k]), float(mj[k])) <= LOSS_REL, (s, k)
        assert rel_err(float(mt["grad_norm"]), float(mj["grad_norm"])) \
            <= limit
        assert st["params"]["embed"] is embed       # updated in place
        assert int(st["opt"]["step"]) == s + 1
        for part in ("master", "m", "v"):
            for (n, a), (_, b) in zip(leaves_named(st["opt"][part]),
                                      leaves_named(jax.device_get(
                                          sj["opt"][part]))):
                a, floor = a.numpy(), 0.0
                if part == "master":
                    floor = 2 * np.spacing(np.abs(b).max())
                    a, b = a - before[n], b - before[n]
                err = np.abs(a - b).max()
                assert err <= limit * np.abs(b).max() + floor, (s, part, n)
                assert np.abs(b).max() > 0, (s, part, n)
    # bf16: the reference's own parameters, its step's loss
    hpj = jS.TrainHparams(opts=JOPTS, microbatches=micro)
    hpt = S.TrainHparams(opts=OPTS, microbatches=micro)
    step_j = jax.jit(jS.make_train_step(cfg_j, topo, hpj))
    step_t = S.make_train_step(cfg, hpt)
    pj16 = jinit(japi.param_specs(cfg_j), jax.random.key(0))
    sj = {"params": pj16, "opt": jA.init_opt_state(pj16)}
    p16 = params_from_numpy(jax.device_get(pj16), CPU)
    st = {"params": p16, "opt": A.init_opt_state(p16)}
    for s in range(2):
        jb, tb = batch_of(cfg, n=4, step=s)
        sj, mj = step_j(sj, jb)
        st, mt = step_t(st, tb)
        assert rel_err(float(mt["loss"]), float(mj["loss"])) <= BF16_LOSS_REL
        assert st["params"]["embed"].dtype == torch.bfloat16
