"""The readings a cell's limits are set from, on the card at the cell's own
size (no measured window: the checked steps of a training cell, and as many
checked batches of a serving cell as a run compares).

    python3 bench/limits.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--blocks 4]

For each seed it prints one JSON line: the compared numbers of the program
against the plain reference, of the control (the reference one precision
step down, in the program's place) and of the faults a cell can have
("half_batch": half of each batch left out, the mean over the rest; for a
serving cell also "token": each served token altered where it is
produced).  A state left unchanged reads 1 on ``change_gap`` by its
definition and needs no run.  ``bench/cells/<workload>.json`` holds the
limits set from these readings.

With ``--routing`` (a routed configuration) it prints instead, for each
seed, each layer's routing: the share of assignments past their expert's
capacity (dropped) in the reference; for a serving cell also the share of
tokens whose k experts differ between the program and the reference, and
the compared numbers of the program and of the control with every layer's
routing forced to the reference's choices.
"""
from __future__ import annotations

import argparse
import gc
import json
import pathlib
import sys
import time

import torch

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent


def _ints(s):
    return [int(x) for x in s.split(",")] if s else []


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def train_readings(model, fam, mix, seed, dev, who):
    from harness import inputs, train_cell
    table = fam.param_table(model)
    steps = mix["checked_steps"]
    ref = train_cell.reference_readings(fam, model, mix, table, seed, dev,
                                        steps)
    out = {}
    for w in who:
        t = time.perf_counter()
        if w == "program":
            feed = inputs.TrainFeed(mix, model["vocab_size"], seed, dev)
            tr = train_cell.ProgramTrainer(
                model, mix, inputs.make_weights(table, seed, dev))
            got = train_cell.readings(
                tr, feed, steps,
                lambda: inputs.make_weights(table, seed, dev), fam.STACKED)
            del tr
        else:
            got = train_cell.reference_readings(
                fam, model, mix, table, seed, dev, steps,
                control=(w == "control"),
                fault="half_batch" if w == "half_batch" else None)
        _free(dev)
        grad, change = train_cell.leaf_gaps(got, ref)
        out[w] = dict(train_cell.compare(got, ref),
                      seconds=time.perf_counter() - t,
                      worst_grad=sorted(grad, key=grad.get)[-3:],
                      worst_change=sorted(change, key=change.get)[-3:])
    return out


def prefill_readings(model, fam, mix, seed, dev, who, blocks):
    from harness import inputs, prefill_cell
    from reference.common import Prec
    table = fam.param_table(model)
    n = len(mix["lengths"])
    idx = list(range(blocks * n))
    feed = inputs.PrefillFeed(mix, model["vocab_size"], seed, dev)
    pos = {i: prefill_cell.positions(mix, seed, i, feed.length(i), dev)
           for i in idx}
    ref = prefill_cell.reference_outputs(fam, model, mix, table, seed, dev,
                                         pos)
    out = {}
    for w in who:
        t = time.perf_counter()
        W = inputs.make_weights(table, seed, dev)
        if w == "control":
            pf = prefill_cell.RefPrefill(fam, model, W, Prec(control=True))
        else:
            pf = prefill_cell.ProgramPrefill(model, W)
        served, kept = prefill_cell.outputs(pf, feed, mix, seed, idx, dev)
        del pf, W
        if w == "token":
            served = {i: [(t + 1) % model["vocab_size"] for t in ids]
                      for i, ids in served.items()}
        if w == "half_batch":
            h = mix["batch"] // 2
            served = {i: ids[:h] + ids[:h] for i, ids in served.items()}
            kept = {i: {k: torch.cat([v[:, :h], v[:, :h]], 1)
                        for k, v in s.items()} for i, s in kept.items()}
        _free(dev)
        out[w] = dict(prefill_cell.compare(served, kept, ref,
                                           model["vocab_size"]),
                      seconds=time.perf_counter() - t)
    return out


def dropped_share(model, top) -> float:
    """Share of a layer's assignments (T, K) past their expert's
    capacity."""
    from reference.moe import capacity
    n = torch.bincount(top.reshape(-1), minlength=model["n_experts"])
    cap = capacity(model, top.shape[0])
    return float((n - cap).clamp(min=0).sum()) / top.numel()


def _force_program_routing(queue, seen):
    """Wrap the program's router: record each call's choices in ``seen``
    and, while ``queue`` holds any, replace them by its next (weights from
    the program's own logits at the forced experts)."""
    from repro_torch.models import moe
    orig = moe._router

    def router(cfg, xt, w):
        topv, topi = orig(cfg, xt, w)
        if queue:
            topi = queue.pop(0).to(topi.dtype)
            with moe._no_tf32():
                logits = xt.float() @ w.float()
            topv = torch.softmax(logits.gather(1, topi.long()), dim=-1)
        seen.append(topi.long())
        return topv, topi
    moe._router = router
    return lambda: setattr(moe, "_router", orig)


def routing_readings(model, fam, mix, seed, dev, blocks):
    from harness import inputs, prefill_cell
    from reference.common import Prec
    table = fam.param_table(model)
    if mix["kind"] == "train":
        batch = inputs.TrainFeed(mix, model["vocab_size"], seed, dev)(0)
        W = {p: t.float() for p, t in
             inputs.make_weights(table, seed, dev).items()}
        tops = {}
        with torch.no_grad():
            fam.forward(model, W, batch["tokens"], Prec(),
                        route=lambda l, top: tops.setdefault(l, top))
        return {"dropped": [dropped_share(model, tops[l])
                            for l in sorted(tops)]}
    n = len(mix["lengths"])
    idx = list(range(blocks * n))
    feed = inputs.PrefillFeed(mix, model["vocab_size"], seed, dev)
    pos = {i: prefill_cell.positions(mix, seed, i, feed.length(i), dev)
           for i in idx}
    # the reference's choices, batch by batch, layer by layer
    ref_tops, ref = {}, {}
    rp = prefill_cell.RefPrefill(
        fam, model, inputs.make_weights(table, seed, dev), Prec(),
        route=lambda l, top: ref_tops.setdefault(cur[0], []).append(top)
        or top)
    cur = [None]
    for i in idx:
        cur[0] = i
        _, cache, last = rp(feed(i))
        ref[i] = (last, prefill_cell.snippet(cache, pos[i]))
        del cache
    del rp
    _free(dev)
    L = model["n_layers"]
    out = {"dropped": [max(dropped_share(model, ref_tops[i][l]) for i in idx)
                       for l in range(L)]}
    # the program free, then forced to the reference's choices
    for forced in (False, True):
        queue, seen = [], []
        undo = _force_program_routing(queue, seen)
        try:
            pf = prefill_cell.ProgramPrefill(
                model, inputs.make_weights(table, seed, dev))
            served, kept = {}, {}
            for i in idx:
                if forced:
                    queue[:] = list(ref_tops[i])
                s, k = prefill_cell.outputs(pf, feed, mix, seed, [i], dev)
                served.update(s)
                kept.update(k)
            del pf
        finally:
            undo()
        got = prefill_cell.compare(served, kept, ref, model["vocab_size"])
        if not forced:
            flips = [0.0] * L
            for j, i in enumerate(idx):
                for l in range(L):
                    a = seen[j * L + l].sort(-1).values
                    b = ref_tops[i][l].sort(-1).values
                    flips[l] = max(flips[l], float(
                        (a != b).any(-1).float().mean()))
            out["flipped"] = flips
            out["program"] = got
        else:
            out["program_forced"] = got
        _free(dev)
    # the control, its routing forced alike
    for forced in (False, True):
        rp = prefill_cell.RefPrefill(
            fam, model, inputs.make_weights(table, seed, dev),
            Prec(control=True),
            route=(lambda l, top: ref_tops[cur[0]][l]) if forced else None)
        served, kept = prefill_cell.outputs(
            lambda t: rp(t)[:2], _Tracked(feed, cur), mix, seed, idx, dev)
        del rp
        out["control_forced" if forced else "control"] = \
            prefill_cell.compare(served, kept, ref, model["vocab_size"])
        _free(dev)
    return out


class _Tracked:
    """A feed that notes in ``cur[0]`` which batch it handed out last."""

    def __init__(self, feed, cur):
        self.feed, self.cur = feed, cur

    def __call__(self, i):
        self.cur[0] = i
        return self.feed(i)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--routing", action="store_true")
    args = ap.parse_args(argv)
    from harness import spec
    bench = spec.benchmark(ROOT)
    workload, entry = spec.cell(bench, args.workload)
    cfg = spec.config(ROOT, entry)
    model, fam = cfg["model"], spec.reference(cfg["family"])
    mix = spec.traffic(workload["traffic"])
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = _ints(args.seeds)
    ctrl, faults = _ints(args.control_seeds), _ints(args.fault_seeds)
    fault_kinds = ["half_batch"] + (["token"] if mix["kind"] == "prefill"
                                    else [])
    for seed in dict.fromkeys(seeds + ctrl + faults):
        who = (["program"] if seed in seeds else []) \
            + (["control"] if seed in ctrl else []) \
            + (fault_kinds if seed in faults else [])
        t = time.perf_counter()
        if args.routing:
            got = routing_readings(model, fam, mix, seed, dev, args.blocks)
        elif mix["kind"] == "train":
            got = train_readings(model, fam, mix, seed, dev, who)
        else:
            got = prefill_readings(model, fam, mix, seed, dev, who,
                                   args.blocks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "readings": got,
                          "seconds": time.perf_counter() - t}), flush=True)
        _free(dev)


if __name__ == "__main__":
    sys.path[:0] = [str(BENCH), str(ROOT / "src")]
    main()
