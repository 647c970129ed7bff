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

On a ``torch.distributed`` mesh (``topo``) a rank holds its blocks of the
parameters, the AdamW state and the batch (its block of the global batch,
split over every batch axis of the mesh), and the step computes the
reference's global step on them.  Every collective of the forward is a
differentiable ``Topology`` collective whose backward is its exact adjoint
(a gather's a reduce-scatter, an all-reduce's an all-reduce), the loss is
the global loss on every rank (``lm_loss(topo=)``), and each rank seeds
its backward with 1 / (the number of ranks), so the ranks' backwards
together differentiate the global loss once.  A rank's gradient of a leaf
it stores whole, on ranks that all hold a copy, is then its share of the
leaf's gradient: the shares are all-reduced over the axes the leaf is
stored whole on (``sync_grads``), which also keeps those copies equal bit
for bit.  Remat re-enters the forward's collectives inside the backward in
the same order on every rank: the ranks run the same graph.
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
from repro_torch.parallel.sharding import (ONE_DEVICE, Topology, init_params,
                                           param_specs_pspec)
from repro_torch.train.loss import lm_loss


@dataclasses.dataclass(frozen=True)
class TrainHparams:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    opts: RunOptions = RunOptions()


def make_train_state_specs(cfg: ModelConfig) -> Dict[str, Any]:
    pspecs = api.param_specs(cfg)
    return {"params": pspecs, "opt": opt_state_specs(pspecs)}


def state_shardings(topo: Topology, specs):
    """The tree of ``topo.spec_for`` entries of a ParamSpec tree (the train
    state's, ``make_train_state_specs``): the reference's ``NamedSharding``
    of every leaf, as the entries ``Topology.block`` cuts by."""
    return param_specs_pspec(topo, specs)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device="cuda", topo: Topology = None):
    """Parameters drawn from ``generator`` (on its device), moved to
    ``device``, and their optimizer state; with ``topo`` this rank's blocks
    (the same draws, each leaf cut as it is drawn)."""
    params = init_params(api.param_specs(cfg), generator,
                         resolve_device(device), topo=topo)
    return {"params": params, "opt": init_opt_state(params)}


def sync_grads(topo: Topology, specs, grads):
    """``grads`` with every leaf's gradient all-reduced over the mesh axes
    it is stored whole on (``specs``: the leaves' ``spec_for`` entries), in
    float32, one collective a set of axes and an axis, each leaf rounded
    once to its dtype."""
    leaves = tree_leaves(grads)
    groups = {}
    for i, spec in enumerate(tree_leaves(specs)):
        axes = topo.replicated_axes(spec)
        if axes:
            groups.setdefault(axes, []).append(i)
    for axes, idx in groups.items():
        buf = topo.all_reduce(torch.cat([leaves[i].float().reshape(-1)
                                         for i in idx]), axes)
        at = 0
        for i in idx:
            g = leaves[i]
            leaves[i] = buf[at:at + g.numel()].view(g.shape).to(g.dtype)
            at += g.numel()
    it = iter(leaves)
    return tree_map(lambda _: next(it), grads)


def _grads(cfg, opts, params, batch, topo: Topology = ONE_DEVICE):
    """(metrics, gradients in the parameters' dtypes) of one (micro)batch:
    on a mesh the rank's gradients before ``sync_grads``, the metrics the
    global batch's.  The profile span "train forward" names the forward
    (the backward runs on autograd's own thread, whose kernels a span here
    would not see)."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    mesh = topo.sharded()
    with RANGE("train forward"):
        logits = api.forward(cfg, live, batch, opts=opts, topo=topo)
        loss, metrics = lm_loss(logits, batch["labels"], batch.get("mask"),
                                topo=topo if mesh else None,
                                vocab=cfg.vocab_padded)
        del logits
    # a parameter the forward does not reach (zamba2's shared block when
    # every layer is a tail layer) gets a zero gradient, as under jax.grad
    grads = torch.autograd.grad(loss / topo.world() if mesh else loss,
                                tree_leaves(live), allow_unused=True,
                                materialize_grads=True)
    it = iter(grads)
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(it), live))


def loss_and_grads(cfg: ModelConfig, hp: TrainHparams, params, batch,
                   topo: Topology = ONE_DEVICE, specs=None):
    """(metrics {"loss", "accuracy", "tokens"}, gradients) of the step's
    loss, averaged over ``hp.microbatches`` (gradients then float32): on a
    mesh this rank's blocks of the global gradients (``specs``: the
    parameters' ``spec_for`` entries).  The reference splits its global
    batch into microbatches; a rank splits its own rows, which gives the
    same sums where no mask weighs the rows (a mask on a mesh raises)."""
    n = hp.microbatches
    if n > 1:
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"batch of {next(iter(batch.values())).shape[0]}"
                             f" rows does not split into {n} microbatches")
        if topo.sharded() and batch.get("mask") is not None:
            raise ValueError("masked microbatches on a mesh: the reference "
                             "weighs each microbatch by its own mask")
        micro = [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()}
                 for i in range(n)]
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device), params)
        metrics = None
        for mb in micro:
            m, g = _grads(cfg, hp.opts, params, mb, topo)
            tree_map(lambda a, b: a.add_(b.float()), grads, g)
            del g
            metrics = m if metrics is None else {
                k: metrics[k] + m[k] for k in metrics}
        grads = tree_map(lambda g: g / n, grads)
        metrics = {k: v / n for k, v in metrics.items()}
    else:
        metrics, grads = _grads(cfg, hp.opts, params, batch, topo)
    if topo.sharded():
        with torch.no_grad():
            grads = sync_grads(topo, specs, grads)
    return metrics, grads


def make_train_step(cfg: ModelConfig, hp: TrainHparams = TrainHparams(),
                    topo: Topology = ONE_DEVICE):
    """train_step(state, batch) -> (state, metrics): ``state`` updated in
    place and returned; metrics {"loss", "accuracy", "tokens",
    "grad_norm", "lr"} as 0-d tensors on the state's device, on a mesh
    the global values on every rank (``state`` and ``batch`` the rank's
    blocks)."""
    specs = (param_specs_pspec(topo, api.param_specs(cfg))
             if topo.sharded() else None)

    def train_step(state, batch):
        params = state["params"]
        metrics, grads = loss_and_grads(cfg, hp, params, batch, topo, specs)
        with RANGE("adamw"), torch.no_grad():
            _, _, opt_metrics = apply_updates(hp.optimizer, grads,
                                              state["opt"], params=params,
                                              topo=topo, specs=specs)
        return state, {**metrics, **opt_metrics}

    return train_step


def make_eval_step(cfg: ModelConfig, opts: RunOptions = RunOptions(),
                   topo: Topology = ONE_DEVICE):
    """eval_step(params, batch) -> metrics {"loss", "accuracy", "tokens"},
    on a mesh the global batch's (``params`` and ``batch`` the rank's
    blocks)."""
    mesh = topo.sharded()

    @torch.no_grad()
    def eval_step(params, batch):
        logits = api.forward(cfg, params, batch, opts=opts, topo=topo)
        _, metrics = lm_loss(logits, batch["labels"], batch.get("mask"),
                             topo=topo if mesh else None,
                             vocab=cfg.vocab_padded)
        return metrics
    return eval_step
