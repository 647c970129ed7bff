"""The train step (counterpart of ``repro/train/step.py``): forward with the
layer bodies rematerialised, backward, AdamW, with optional microbatched
gradient accumulation in float32.

The state is ``{"params", "opt"}`` as in the reference.  The step updates it
in place, the counterpart of the reference's buffer donation: the
gradients come from ``torch.autograd.grad`` against aliases of the
parameters, and ``optim.adamw.apply_updates`` writes the new master weights,
moments, step and parameters into the state's tensors.  On the card the
forward runs the ``flash_attention`` and ``ssd_scan`` kernels, and their
backward is the reference's differentiated jnp arithmetic
(``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import RANGE
from repro_torch.models import api
from repro_torch.models.transformer import RunOptions
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     init_opt_state, opt_state_specs,
                                     tree_leaves, tree_map)
from repro_torch.parallel.sharding import init_params
from repro_torch.train.loss import lm_loss


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    opts: RunOptions = RunOptions()


def make_train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    pspecs = api.param_specs(cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs)}


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda"):
    """Parameters drawn from ``generator`` (on its device), moved to
    ``device``, and their optimizer state."""
    params = init_params(api.param_specs(cfg), generator, resolve_device(device))
    return {"params": params, "opt": init_opt_state(params)}


def _grads(cfg, opts, params, batch):
    """(metrics, gradients in the parameters' dtypes) of one (micro)batch.
    The profile span "train forward" names the forward (the backward runs
    on autograd's own thread, whose kernels a span here would not see)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    with RANGE("train forward"):
        logits = api.forward(cfg, live, batch, opts=opts)
        loss, metrics = lm_loss(logits, batch["labels"], batch.get("mask"))
        del logits
    # a parameter the forward does not reach (zamba2's shared block when
    # every layer is a tail layer) gets a zero gradient, as under jax.grad
    grads = torch.autograd.grad(loss, tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def make_train_step(cfg: ModelConfig, hp: TrainHparams = TrainHparams()):
    """train_step(state, batch) -> (state, metrics): ``state`` updated in
    place and returned; metrics {"loss", "accuracy", "tokens",
    "grad_norm", "lr"} as 0-d tensors on the state's device."""
    def train_step(state, batch):
        params = state["params"]
        n = hp.microbatches
        if n > 1:
            if any(v.shape[0] % n for v in batch.values()):
                raise ValueError(f"batch of {next(iter(batch.values())).shape[0]}"
                                 f" rows does not split into {n} microbatches")
            micro = [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
                     for i in range(n)]
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            metrics = None
            for mb in micro:
                m, g = _grads(cfg, hp.opts, params, mb)
                tree_map(lambda a, b: a.add_(b.float()), grads, g)
                del g
                metrics = m if metrics is None else {
                    k: metrics[k] + m[k] for k in metrics}
            grads = tree_map(lambda g: g / n, grads)
            metrics = {k: v / n for k, v in metrics.items()}
        else:
            metrics, grads = _grads(cfg, hp.opts, params, batch)
        with RANGE("adamw"):
            _, _, opt_metrics = apply_updates(hp.optimizer, grads,
                                              state["opt"], params=params)
        return state, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, opts: RunOptions = RunOptions()):
    @torch.no_grad()
    def eval_step(params, batch):
        logits = api.forward(cfg, params, batch, opts=opts)
        _, metrics = lm_loss(logits, batch["labels"], batch.get("mask"))
        return metrics
    return eval_step
