"""What each rank of tests/test_torch_tp_train.py's world runs, and the
cases' inputs: the port alone (torch and repro_torch, never jax or the JAX
package; ``ranks.run_ranks`` asserts it on every rank).

Every case's inputs are seeded numpy: float32 weights drawn leaf by leaf
from the port's ``param_specs`` (``torch_tp_ranks.np_params``), the tokens
and labels of a (B, S + 1) token draw, whisper's frames (float32 values
rounded to bf16).  A rank takes its blocks of the train state the
reference's ``init_opt_state`` makes of the weights
(``convert.train_state_block``), its block of the batch (rows over every
batch axis), and
returns its blocks of the gradients, the metrics and the state after each
step on the CPU, with its mesh coordinate, and the collectives its first
train step called (``ranks.collective_log``).  While it trains, every raw
``torch.distributed`` collective must run with grad mode off (inside a
differentiable collective's forward or backward, or under ``no_grad``) and
torch's "an autograd kernel was not registered" warning is an error.
"""
import argparse
import contextlib
import dataclasses
import warnings

import numpy as np
import torch
import torch.distributed as dist

from torch_tp_ranks import np_params
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import get
from repro_torch.convert import train_state_block, train_state_to_numpy
from repro_torch.models import api
from repro_torch.models.transformer import RunOptions
from repro_torch.optim import adamw as A
from repro_torch.parallel import sharding as S
from repro_torch.testing.ranks import collective_log
from repro_torch.train import step as T

CPU = "cpu"
MESHES = ((1, 4), (2, 2))
TILE = 16                # the reference's RunOptions tiles
# AdamW with eps 1 and no decay, lr 0.1 from the first step: the update is
# the gradient's own arithmetic (tests/torch_train_common.check_train_step)
ADAM = dict(lr=0.1, eps=1.0, warmup_steps=1, weight_decay=0.0)
QWEN_5H = dict(n_heads=5, n_kv_heads=1)


def _case(arch, mesh, seed, B=4, S_=64, rules="DEFAULT_RULES", **kw):
    return dict(arch=arch, mesh=mesh, rules=rules, B=B, S=S_, seed=seed,
                **kw)


# (a) fsdp gathers with the batch over data and the heads branch (two
# steps, the reference's gradient by value_and_grad, its eval step);
# (b) sequence-parallel and padded heads (5 heads over 4); (c) the MoE
# modes at the default capacity factor (assignments dropped); (d) the
# Mamba layouts and the shared block; (e) whisper's biases; (f) the
# WIDE_DP rules; (g) two microbatches
CASES = {
    "glm4_2x2": _case("glm4-9b", (2, 2), 1, steps=2),
    "qwen25_seq": _case("qwen2.5-32b", (1, 4), 2, B=2, over=QWEN_5H),
    "qwen25_pad": _case("qwen2.5-32b", (1, 4), 2, B=2, over=QWEN_5H,
                        pad_heads=True),
    "granite_rpc": _case("granite-moe-1b-a400m", (2, 2), 3,
                         moe_mode="rpc"),
    "granite_onesided": _case("granite-moe-1b-a400m", (2, 2), 3,
                              moe_mode="onesided"),
    "zamba2_2x2": _case("zamba2-1.2b", (2, 2), 4),
    "zamba2_1x4": _case("zamba2-1.2b", (1, 4), 5, B=2),
    "whisper_2x2": _case("whisper-medium", (2, 2), 6),
    "glm4_wide": _case("glm4-9b", (2, 2), 7, rules="WIDE_DP_RULES"),
    "glm4_micro": _case("glm4-9b", (2, 2), 8, micro=2),
}
# (i) remat of each layer body against none, bit for bit, on a case's
# inputs
REMAT = {"full": "zamba2_1x4", "dots": "glm4_2x2"}
# the launcher on (2, 2): 4 steps with a checkpoint every 2, a resume from
# step 4 for 2 more, 6 steps whole
CLI = dict(arch="qwen1.5-4b", smoke=True, device="cpu", batch=2, seq=64,
           lr=1e-3, microbatches=1, ckpt_every=2, resume=False,
           straggler_slack=3.0)


def case_cfg(c):
    return dataclasses.replace(get(c["arch"]).smoke(), **c.get("over", {}))


def case_opts(c, remat=None):
    return RunOptions(q_block=TILE, kv_block=TILE, remat=remat is not None,
                      remat_policy=remat, pad_heads=c.get("pad_heads", False),
                      moe_mode=c.get("moe_mode", "auto"))


def case_hparams(c, remat=None):
    return T.TrainHparams(optimizer=A.AdamWConfig(**ADAM),
                          microbatches=c.get("micro", 1),
                          opts=case_opts(c, remat))


def case_inputs(c):
    """Weights, tokens and labels (and whisper's frames) of a case."""
    cfg = case_cfg(c)
    rng = np.random.RandomState(2000 + c["seed"])
    toks = rng.randint(1, cfg.vocab_size, (c["B"], c["S"] + 1)).astype(
        np.int32)
    out = {"params": np_params(cfg, c["seed"]), "tokens": toks[:, :-1],
           "labels": toks[:, 1:]}
    if cfg.family == "audio":
        x = rng.standard_normal((c["B"], cfg.encoder_seq, cfg.d_model))
        out["frames"] = torch.from_numpy((x * 0.5).astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return out


@contextlib.contextmanager
def strict_collectives():
    """Every raw collective checked for grad mode (the offenders' names
    kept), and torch's warning of a collective with no autograd kernel
    raised as an error.  Yields (calls, offenders)."""
    calls, bad = [0], []
    names = ["all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
             "broadcast"]
    saved = {n: getattr(dist, n) for n in names}

    def spy(name):
        def call(*a, **k):
            calls[0] += 1
            if torch.is_grad_enabled():
                bad.append(name)
            return saved[name](*a, **k)
        return call
    for n in names:
        setattr(dist, n, spy(n))
    try:
        with warnings.catch_warnings():
            warnings.filterwarnings(
                "error", message=".*autograd kernel was not registered.*")
            yield calls, bad
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def batch_block(topo, inp):
    """The rank's rows of the case's batch."""
    return {k: topo.block(torch.from_numpy(np.ascontiguousarray(inp[k])),
                          "batch", *(None,) * (inp[k].ndim - 1)).long()
            if k != "frames" else
            topo.block(torch.from_numpy(inp[k]), "batch", None, None)
            for k in ("tokens", "labels", "frames") if k in inp}


def initial_state(topo, cfg, params):
    """This rank's blocks of the train state the reference's
    ``init_opt_state`` makes of the case's float32 ``params`` (numpy):
    ``convert.train_state_block``."""
    zeros = lambda t: {k: zeros(v) for k, v in t.items()} \
        if isinstance(t, dict) else np.zeros_like(t)
    return train_state_block(topo, T.make_train_state_specs(cfg), {
        "params": params, "opt": {"master": params, "m": zeros(params),
                                  "v": zeros(params),
                                  "step": np.zeros((), np.int32)}}, CPU)


def _cpu(tree):
    return {k: _cpu(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else tree.detach().clone()


def train_case(topo, c, inp, remat=None):
    """The case's gradients (``loss_and_grads``), then its train steps
    (``make_train_step``), on this rank's blocks: {"metrics", "grads",
    "steps": [{"metrics", "state"}]}."""
    cfg = case_cfg(c)
    specs = api.param_specs(cfg)
    state = initial_state(topo, cfg, inp["params"])
    pb = state["params"]
    batch = batch_block(topo, inp)
    hp = case_hparams(c, remat)
    metrics, grads = T.loss_and_grads(cfg, hp, pb, batch, topo,
                                      S.param_specs_pspec(topo, specs))
    out = dict(metrics={k: float(v) for k, v in metrics.items()},
               grads=_cpu(grads), steps=[])
    if remat is not None:
        return out
    step = T.make_train_step(cfg, hp, topo)
    for _ in range(c.get("steps", 1)):
        with collective_log() as log:
            state, m = step(state, batch)
        out.setdefault("collectives", log)
        out["steps"].append(dict(metrics={k: float(v) for k, v in m.items()},
                                 state=_cpu(state)))
    if c.get("steps", 1) > 1:
        out["eval"] = {k: float(v) for k, v in T.make_eval_step(
            cfg, case_opts(c), topo)(state["params"], batch).items()}
        out["state"] = state
    return out


def checkpoint_rank(meshes, state, c, ckpt_dir):
    """The case's state on (2, 2) saved (gathered whole, rank 0 writing),
    then restored onto (1, 4): the gathered global state (rank 0), the
    restored blocks and the committed step read back on this rank."""
    cfg = case_cfg(c)
    spec_tree = T.make_train_state_specs(cfg)
    t22 = S.Topology(meshes[(2, 2)])
    t14 = S.Topology(meshes[(1, 4)])
    mgr = CheckpointManager(ckpt_dir, device=CPU)
    mgr.save(7, state, topo=t22, spec_tree=spec_tree)
    whole = train_state_to_numpy(t22, spec_tree, state)
    step, restored = CheckpointManager(ckpt_dir, device=CPU).restore(
        topo=t14, spec_tree=spec_tree)
    return dict(whole=whole if dist.get_rank() == 0 else None, step=step,
                restored=restored, latest=mgr.latest_committed_step(),
                coord14=t14.coordinate(), dir=ckpt_dir)


def cli_rank(rank, world, tmp):
    """``launch.train --mesh 2,2``'s rank: 4 steps checkpointed every 2, a
    resume for 2, and 6 steps whole."""
    from repro_torch.launch import train
    run = lambda **kw: train.mesh_rank(rank, world, (2, 2),
                                       argparse.Namespace(**dict(CLI, **kw)))
    return dict(first=run(steps=4, ckpt_dir=tmp),
                resumed=run(steps=2, ckpt_dir=tmp, resume=True),
                whole=run(steps=6, ckpt_dir=None))


def tie_rank(topo):
    """``lm_loss(topo=)`` on vocab blocks of 2 over (1, 4) (vocab 8) with
    the largest logit tied at columns 1 and 2, either side of the boundary
    of blocks 0 and 1: labels 1 then 2, each position's loss and hit with
    the whole logits beside them for the one-device loss."""
    whole = torch.zeros(1, 2, 8)
    whole[..., 1] = whole[..., 2] = 3.0
    whole[..., 5] = -1.0
    labels = torch.tensor([[1, 2]])
    lo, n = topo.extent(topo.spec_for((8,), ("vocab",))[0], 8)
    loss, m = T.lm_loss(whole[..., lo:lo + n], labels, topo=topo, vocab=8)
    return dict(loss=float(loss), accuracy=float(m["accuracy"]),
                tokens=float(m["tokens"]), whole=whole, labels=labels)


def train_rank(rank, world, cases, inputs, tmp):
    """Every case on its mesh of this world (meshed (1, 4) and (2, 2) over
    the one process group) under ``strict_collectives``, the remat cases,
    the checkpoint of glm4_2x2's state, and the launcher."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {m: make_mesh(m, ("data", "model"), CPU) for m in MESHES}
    topo_of = lambda c: S.Topology(meshes[tuple(c["mesh"])],
                                   dict(getattr(S, c["rules"])))
    out = {}
    with strict_collectives() as (calls, bad):
        for name, c in cases.items():
            out[name] = (topo_of(c).coordinate(),
                         train_case(topo_of(c), c, inputs[name]))
        for policy, name in REMAT.items():
            c = cases[name]
            out["remat_" + policy] = train_case(topo_of(c), c, inputs[name],
                                                remat=policy)
    out["strict"] = dict(calls=calls[0], bad=bad)
    out["tie"] = tie_rank(S.Topology(meshes[(1, 4)]))
    state = out["glm4_2x2"][1].pop("state")
    out["checkpoint"] = checkpoint_rank(meshes, state, cases["glm4_2x2"],
                                        f"{tmp}/ckpt")
    out["cli"] = cli_rank(rank, world, f"{tmp}/cli")
    return out
