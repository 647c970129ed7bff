"""PyTorch port, training: the loss, AdamW, the kernels' gradients, the
train step and the train launcher, held against the JAX package on the same
weights and inputs at the ``smoke()`` size.

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
import json
import os
import pathlib
import subprocess
import sys

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


@pytest.fixture(scope="module")
def topo():
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


# --- the kernels' gradients on the CPU ------------------------------------------------
ATTN_CASES = [
    # (B, Sq, Hq, Hkv, D, causal, window, softcap, q_block, kv_block)
    (2, 96, 4, 4, 16, True, None, None, 32, 32),
    (1, 80, 4, 2, 16, True, 24, None, 32, 16),        # window, GQA, ragged
    (2, 64, 2, 2, 32, True, None, 20.0, 16, 32),      # softcap
    (1, 48, 8, 2, 16, False, None, None, 16, 16),     # not causal, GQA 4
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_gradients_match_jax(case):
    """Gradients of ``block_attention_jnp`` against ``jax.grad`` of the
    reference's jnp ``block_attention``, float32, with the Function (the
    kernel's dispatch, the plain version on the CPU) giving the same
    gradients as ``block_attention_jnp``."""
    Bn, Sq, Hq, Hkv, D, causal, window, cap, qb, kb = case
    rng = np.random.RandomState(1)
    q, w = (rng.randn(Bn, Sq, Hq, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(Bn, Sq, Hkv, D).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, attn_softcap=cap)

    def jf(q, k, v):
        o = jL.block_attention(q, k, v, q_block=qb, kv_block=kb, **kw)
        return jnp.sum(o * w)
    want = jax.grad(jf, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))

    def grads(fn):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        out = fn(*leaves)
        return out, torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                        leaves)
    out_j, got = grads(lambda *a: L.block_attention_jnp(
        *a, q_block=qb, kv_block=kb, **kw))
    launched = fa.launches
    out_f, through = grads(lambda *a: L.block_attention(
        *a, q_block=qb, kv_block=kb, **kw))
    assert fa.launches == launched            # the CPU launches nothing
    for a, b, c in zip(got, through, want):
        assert rel_err(a.numpy(), np.asarray(c)) <= 1e-5
        assert torch.equal(a, b)
        assert float(a.abs().max()) > 0
    ref = jL.attention_ref(*map(jnp.asarray, (q, k, v)), **kw)
    assert rel_err(out_j.detach().numpy(), ref) <= 1e-5
    assert rel_err(out_f.detach().numpy(), ref) <= 1e-5


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_gradients_match_jax(with_state):
    """Gradients of ``mamba2.ssd_chunked`` (through ``ops.ssd_scan``'s
    Function, whose backward differentiates ``ssd_scan_plain``) against
    ``jax.grad`` of the reference's ``ssd_chunked``, float32."""
    rng = np.random.RandomState(2)
    Bn, Sn, H, P, N, Q = 2, 96, 4, 8, 16, 32
    xh = rng.randn(Bn, Sn, H, P).astype(np.float32)
    dt = (np.log1p(np.exp(rng.randn(Bn, Sn, H))) * 0.5).astype(np.float32)
    Av = -np.exp(rng.randn(H) * 0.3).astype(np.float32)
    Bm, Cm = (rng.randn(Bn, Sn, N).astype(np.float32) for _ in range(2))
    s0 = rng.randn(Bn, H, N, P).astype(np.float32) if with_state else None
    wy = rng.randn(Bn, Sn, H, P).astype(np.float32)
    ws = rng.randn(Bn, H, N, P).astype(np.float32)
    ins = [xh, dt, Av, Bm, Cm] + ([s0] if with_state else [])

    def jf(xh, dt, Av, Bm, Cm, *s):
        y, st = jM.ssd_chunked(xh, dt, Av, Bm, Cm, Q,
                               init_state=s[0] if s else None)
        return jnp.sum(y * wy) + jnp.sum(st * ws)
    want = jax.grad(jf, argnums=tuple(range(len(ins))))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(x).requires_grad_() for x in ins]
    launched = ss.launches
    y, st = M.ssd_chunked(*leaves[:5], Q,
                          init_state=leaves[5] if with_state else None)
    assert ss.launches == launched
    got = torch.autograd.grad((y * torch.from_numpy(wy)).sum()
                              + (st * torch.from_numpy(ws)).sum(), leaves)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-5
        assert float(a.abs().max()) > 0


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "deepseek-moe-16b"])
def test_moe_capacity_drops_carry_no_gradient(arch, topo):
    """At a capacity of 2 slots an expert most assignments are dropped: the
    MoE layer's gradients (input, router, experts) equal ``jax.grad`` of the
    reference's in float32, and a token whose every assignment was dropped
    gets no gradient through the layer (the scatter's backward is a gather
    that never reads the sentinel cell)."""
    import dataclasses
    from repro.models import moe as jmoe
    from repro_torch.models import moe
    cfg_j = dataclasses.replace(JARCHS[arch].smoke(), capacity_factor=0.05)
    cfg = dataclasses.replace(get(arch).smoke(), capacity_factor=0.05)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    rng = np.random.RandomState(4)
    ins = [rng.randn(4, 16, d), rng.randn(d, E) * 0.3,
           rng.randn(E, d, f) * 0.2, rng.randn(E, d, f) * 0.2,
           rng.randn(E, f, d) * 0.2]
    ins = [a.astype(np.float32) for a in ins]
    w = rng.randn(4, 16, d).astype(np.float32)

    def jf(*a):
        return jnp.sum(jmoe.moe_ffn(cfg_j, topo, *a) * w)
    want = jax.grad(jf, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = torch.autograd.grad((moe.moe_ffn(cfg, ONE_DEVICE, *leaves)
                               * torch.from_numpy(w)).sum(), leaves)
    for a, b in zip(got, want):
        assert rel_err(a.numpy(), np.asarray(b)) <= 1e-5
    _, _, meta = moe.route(cfg, leaves[0].detach(), leaves[1].detach())
    dropped = ~meta[4].reshape(-1, cfg.top_k).any(-1)
    assert moe.capacity(cfg, 64) == 2 and dropped.sum() >= 32
    assert float(got[0].reshape(-1, d)[dropped].abs().max()) == 0.0
    assert float(got[0].reshape(-1, d)[~dropped].abs().max()) > 0


def test_functions_only_under_grad():
    """Without grad, or with no input requiring it, the wrappers return
    what the kernels' dispatch returns, with no autograd node."""
    q = torch.randn(1, 32, 2, 16, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
    assert ops.flash_attention(q.detach(), q.detach(), q.detach()).grad_fn is None
    assert type(ops.flash_attention(q, q, q).grad_fn).__name__ == \
        "FlashAttentionBackward"
    x = torch.randn(1, 1, 8, 2, 16, requires_grad=True)
    dA, Bc = -torch.rand(1, 1, 8, 2), torch.randn(1, 1, 8, 16)
    y, _ = ops.ssd_scan(x, dA, Bc, Bc, h_tile=1)
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    with torch.no_grad():
        assert ops.ssd_scan(x, dA, Bc, Bc, h_tile=1)[0].grad_fn is None


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


# --- the train step ------------------------------------------------------------------
def _as_f32_params(state):
    """The state with its parameters replaced by the float32 master copy, so
    a second step runs in float32 (the reference's step leaves bf16)."""
    return {"params": state["opt"]["master"], "opt": state["opt"]}


@pytest.mark.parametrize("arch,micro", [("zamba2-1.2b", 1),
                                        ("zamba2-1.2b", 2),
                                        ("granite-moe-1b-a400m", 1),
                                        ("granite-moe-1b-a400m", 2)])
def test_train_step_matches_reference(arch, micro, topo):
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
