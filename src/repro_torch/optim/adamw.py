"""AdamW with float32 master weights and moments (counterpart of
``repro/optim/adamw.py``): the global-norm clip in float32, linear warm-up,
bias correction and weight decay inside the update, written term for term
as the reference writes them; the bf16 parameters are re-derived from the
master copy each step.  Plain functions on trees of tensors (nested dicts),
not ``torch.optim.AdamW``."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel.sharding import ParamSpec


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure, in
    sorted key order (``tree_leaves``'s); the result's keys in that order."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees))
                for k in sorted(trees[0])}
    return fn(*trees)


def tree_leaves(tree):
    """Leaves in sorted key order (``jax.tree.leaves``'s order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def opt_state_specs(param_spec_tree):
    """Master, m and v: the parameters' shapes in float32 (m and v zero)."""
    f32 = lambda s, init=None: dataclasses.replace(
        s, dtype=torch.float32, init=init or s.init)
    return {
        "master": tree_map(f32, param_spec_tree),
        "m": tree_map(lambda s: f32(s, "zeros"), param_spec_tree),
        "v": tree_map(lambda s: f32(s, "zeros"), param_spec_tree),
        "step": ParamSpec((), "zeros", torch.int32),
    }


def init_opt_state(params):
    return {
        "master": tree_map(lambda p: p.float().clone(), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def _schedule(cfg: AdamWConfig, step):
    warm = torch.clamp(step.float() / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def apply_updates(cfg: AdamWConfig, grads, opt_state,
                  param_dtype=torch.bfloat16, params=None):
    """One AdamW step.  Returns (params, opt_state, metrics {"grad_norm",
    "lr"}).  ``opt_state``'s tensors are updated in place (the reference's
    donation); so is ``params`` when given (a tree of the parameters, each
    written with the new master in its own dtype), else new ``param_dtype``
    tensors are returned."""
    step = opt_state["step"] + 1
    leaves = tree_leaves(grads)
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = _schedule(cfg, step)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)

    def upd(g, m, v, w):
        g = g.float() * scale
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * g * g)
        mh = m / b1c
        vh = v / b2c
        w.copy_(w - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                          + cfg.weight_decay * w))
    tree_map(upd, grads, opt_state["m"], opt_state["v"], opt_state["master"])
    opt_state["step"].copy_(step)
    if params is None:
        params = tree_map(lambda w: w.to(param_dtype), opt_state["master"])
    else:
        tree_map(lambda p, w: p.copy_(w), params, opt_state["master"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
