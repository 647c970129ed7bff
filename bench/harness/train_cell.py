"""A training cell: the program's train step (``train.step.make_train_step``,
built as ``launch.train`` builds it) over fresh seeded batches.

Set-up builds one state from the seed's weights and drives it through the
mix's ``checked_steps`` first steps through the window's own call and feed,
reading each step's loss, the first gradient as the optimizer got it (its
first moment after one step, divided by 1 - b1) and the change of the
float32 master weights after the last of them.  The window then runs whole
steps on that same state.  After the window the state is freed and the
plain reference, from the same weights and batches, follows those first
steps; :func:`compare` holds the readings against it.
"""
from __future__ import annotations

import gc
import statistics
import time

import torch

from harness import inputs
from reference.common import Prec, adamw_step, lm_loss


def flatten(tree, prefix=""):
    """{"/"-joined path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        p = f"{prefix}{k}"
        out.update(flatten(v, p + "/") if isinstance(v, dict) else {p: v})
    return out


def leaf_norms(paths, get, stacked) -> dict:
    """{leaf: L2 norm of get(path)}, one leaf at a time, a leaf stacked
    over layers taken layer by layer ("layers/wz[3]")."""
    out = {}
    for p in sorted(paths):
        t = get(p).detach().float()
        if p.startswith(stacked):
            out.update({f"{p}[{i}]": v for i, v in
                        enumerate(t.flatten(1).norm(dim=1).tolist())})
        else:
            out[p] = float(t.norm())
    return out


class ProgramTrainer:
    """The program's train step and its state, built from the seed's
    weights."""

    def __init__(self, model: dict, mix: dict, W: dict):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models.transformer import RunOptions
        from repro_torch.optim.adamw import AdamWConfig, init_opt_state
        from repro_torch.train.step import TrainHparams, make_train_step
        params = inputs.as_tree(W)
        self.state = {"params": params, "opt": init_opt_state(params)}
        self.b1 = mix["optimizer"]["b1"]
        hp = TrainHparams(optimizer=AdamWConfig(**mix["optimizer"]),
                          microbatches=mix["microbatches"],
                          opts=RunOptions(remat=mix["remat"]))
        self.fn = make_train_step(ModelConfig(**model), hp)

    def step(self, batch):
        self.state, metrics = self.fn(self.state, batch)
        return metrics["loss"]

    def grad1_norms(self, stacked):
        m = flatten(self.state["opt"]["m"])
        return {n: v / (1 - self.b1)
                for n, v in leaf_norms(m, m.get, stacked).items()}

    def master(self):
        return flatten(self.state["opt"]["master"])


class RefTrainer:
    """The plain reference trained as the configuration states: float32
    master weights and moments, bfloat16 parameters, float32 products (or,
    with ``Prec(control=True)``, the control's)."""

    def __init__(self, fam, model, mix, W, prec, fault=None):
        self.fam, self.model, self.prec, self.fault = fam, model, prec, fault
        self.hp = mix["optimizer"]
        self.W = {p: t.float() for p, t in W.items()}
        self.m = {p: torch.zeros_like(t) for p, t in self.W.items()}
        self.v = {p: torch.zeros_like(t) for p, t in self.W.items()}
        self.t, self.grad1 = 0, None

    def step(self, batch):
        tok, lab = batch["tokens"], batch["labels"]
        if self.fault == "half_batch":
            tok, lab = tok[: len(tok) // 2], lab[: len(lab) // 2]
        # the forward sees the master weights rounded to bfloat16, the
        # configuration's parameters; their gradients update the master
        live = {p: w.detach().to(torch.bfloat16).float().requires_grad_()
                for p, w in self.W.items()}
        logits = self.fam.forward(self.model, live, tok, self.prec,
                                  remat=True)
        loss = lm_loss(logits, lab)
        del logits
        grads = torch.autograd.grad(loss, list(live.values()))
        del live
        self.t += 1
        clipped = adamw_step(self.W, dict(zip(self.W, grads)), self.m, self.v,
                             self.t, self.hp)
        if self.grad1 is None:
            self.grad1 = clipped
        return loss.detach()

    def grad1_norms(self, stacked):
        return leaf_norms(self.grad1, self.grad1.get, stacked)

    def master(self):
        return self.W


def readings(trainer, feed, steps: int, weights, stacked):
    """Drive ``trainer`` through ``steps`` steps of ``feed``: {"loss": [each
    step's], "grad1": {leaf: norm of the first clipped gradient},
    "change": {leaf: norm of master - the first weights after the last
    step}}; ``weights()`` draws the first weights again."""
    out = {"loss": []}
    for i in range(steps):
        out["loss"].append(float(trainer.step(feed(i))))
        if i == 0:
            out["grad1"] = trainer.grad1_norms(stacked)
    master, W0 = trainer.master(), weights()
    out["change"] = leaf_norms(
        W0, lambda p: master[p].detach() - W0[p].float(), stacked)
    return out


def reference_readings(fam, model, mix, table, seed, device, steps: int,
                       control: bool = False, fault=None):
    """The same readings from the plain reference (float32; with
    ``control`` one precision step down; ``fault`` "half_batch" leaves the
    second half of every batch out)."""
    feed = inputs.TrainFeed(mix, model["vocab_size"], seed, device)
    ref = RefTrainer(fam, model, mix, inputs.make_weights(table, seed, device),
                      Prec(control), fault)
    out = readings(ref, feed, steps,
                   lambda: inputs.make_weights(table, seed, device),
                   fam.STACKED)
    del ref
    gc.collect()
    return out


def leaf_gaps(prog: dict, ref: dict):
    """({leaf: gap of the first clipped gradient's norm}, {leaf: gap of the
    master weights' change}): the gap between the two norms over the larger
    of the reference's norm of that leaf and of the median leaf; the
    change leaves out the leaves whose first reference gradient is under a
    thousandth of the median leaf's (their change is round-off under
    Adam's normalisation)."""
    g_med = statistics.median(ref["grad1"].values())
    grad = {n: abs(prog["grad1"][n] - r) / max(r, g_med)
            for n, r in ref["grad1"].items()}
    moved = [n for n, r in ref["grad1"].items() if r >= 1e-3 * g_med]
    c_med = statistics.median(ref["change"][n] for n in moved)
    change = {n: abs(prog["change"][n] - ref["change"][n])
              / max(ref["change"][n], c_med) for n in moved}
    return grad, change


def compare(prog: dict, ref: dict):
    """{name: reading}: ``loss_gap``, the largest relative gap of a step's
    loss; ``grad_gap`` and ``change_gap``, the worst leaf's of
    :func:`leaf_gaps`; ``grad_gap_median`` and ``change_gap_median``, the
    median leaf's."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                        ref["loss"]))
    grad, change = leaf_gaps(prog, ref)
    return {"loss_gap": loss_gap, "grad_gap": max(grad.values()),
            "change_gap": max(change.values()),
            "grad_gap_median": statistics.median(grad.values()),
            "change_gap_median": statistics.median(change.values())}


def run(ctx):
    """The cell: set-up, the window, the traced stretch where asked, the
    readings; fills ``ctx`` (see ``run.py``)."""
    fam, model, mix, dev = ctx.fam, ctx.model, ctx.mix, ctx.device
    table = fam.param_table(model)
    steps = mix["checked_steps"]
    feed = inputs.TrainFeed(mix, model["vocab_size"], ctx.seed, dev)
    ctx.phase("imports")
    W = inputs.make_weights(table, ctx.seed, dev)
    trainer = ctx.make_trainer(model, mix, W)
    ctx.sync()
    ctx.phase("weights and state")
    prog = readings(trainer, feed, steps,
                    lambda: inputs.make_weights(table, ctx.seed, dev),
                    fam.STACKED)
    ctx.sync()
    ctx.phase("checked steps")
    ctx.setup_done()

    tokens_per_step = mix["batch"] * mix["seq"]
    done, failed, i = 0, 0, steps
    t0 = time.perf_counter()
    while True:
        loss = float(trainer.step(feed(i)))
        ctx.sync()
        i += 1
        done += 1
        failed += 0 if loss == loss and abs(loss) != float("inf") else 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    ctx.window_closed()
    ctx.attempted, ctx.failed = done, failed
    ctx.e2e["train_tokens_per_s"] = done * tokens_per_step / elapsed
    ctx.window_s = elapsed
    ctx.window_flops = 3 * done * fam.forward_flops(model, mix["batch"],
                                                    mix["seq"])
    if ctx.trace:
        shapes = fam.kernel_shapes(model, mix["batch"], mix["seq"])

        def traced():
            for j in range(i, i + mix["trace_steps"]):
                before = ctx.launch_counts()
                float(trainer.step(feed(j)))
                ctx.record_launches(before, shapes)
        ctx.run_traced(traced)
    ctx.read_memory()
    del trainer, W
    gc.collect()
    ctx.free()
    t1 = time.perf_counter()
    ref = reference_readings(fam, model, mix, table, ctx.seed, dev, steps)
    ctx.note(f"reference: {time.perf_counter() - t1:.1f} s")
    ctx.judge(compare(prog, ref))
