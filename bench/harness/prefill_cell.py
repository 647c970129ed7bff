"""A long-prompt serving cell: batches of prompts through the program's
prefill (``serving.decode.make_prefill``) and ``models.embedding.greedy``,
as ``launch.serve.serve`` calls them, in a closed loop with one batch in
flight.  A request's time to first token runs from when its batch is
handed to the prefill to when its first greedy id is on the host.

The check: every block of batches (one of each length of the mix) whose
index falls on the seed's residue of ``check_block_every`` is checked.  Of
those batches the run keeps the served ids and what the prefill left in
the cache (every Mamba layer's convolution tails and final state, the
keys and values at ``kv_positions`` positions drawn from the seed and the
last); after the window the plain reference runs over the same prompts and
:func:`compare` reads the served tokens' logits and the cache against it.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from harness import inputs
from harness.spec import seed_for
from reference.common import Prec

MAMBA = ("conv_x", "conv_B", "conv_C", "ssm")
KV = ("k", "v")


class ProgramPrefill:
    """The program's prefill and greedy pick: tokens (B, S) -> (first ids
    (B,) on the device, the cache it leaves)."""

    def __init__(self, model: dict, W: dict):
        from repro_torch.configs.base import ModelConfig
        from repro_torch.models.embedding import greedy
        from repro_torch.serving.decode import make_prefill
        self.cfg, self.params = ModelConfig(**model), inputs.as_tree(W)
        self.make_prefill, self.greedy = make_prefill, greedy

    def __call__(self, tokens):
        logits, cache = self.make_prefill(self.cfg, tokens.shape[1])(
            self.params, {"tokens": tokens})
        return self.greedy(self.cfg, logits), cache


class RefPrefill:
    """The plain reference in the same place: the argmax of its last
    position's logits and its cache in the program's layout.  With
    ``Prec(control=True)`` it is the control.  ``route``, where given, is
    handed to a routed family's forward (``limits.py``'s diagnostics)."""

    def __init__(self, fam, model: dict, W: dict, prec: Prec, route=None):
        self.fam, self.model, self.prec = fam, model, prec
        self.W = {p: t.float() for p, t in W.items()}
        self.kw = {} if route is None else {"route": route}

    def __call__(self, tokens):
        with torch.no_grad():
            cache = {}
            logits = self.fam.forward(self.model, self.W, tokens, self.prec,
                                      cache=cache, **self.kw)
            out = {n: torch.stack([s[n] for s in cache.get("mamba", [])])
                   for n in MAMBA if cache.get("mamba")}
            if cache.get("kv"):
                out["k"] = torch.stack([k for k, _ in cache["kv"]])
                out["v"] = torch.stack([v for _, v in cache["kv"]])
            # the last position alone, so that no view keeps the whole
            # (B, S, vocab) logits alive
            last = logits[:, -1].clone()
            del logits
            return last.argmax(-1), out, last


def snippet(cache: dict, pos) -> dict:
    """What the check keeps of a cache: the Mamba states whole, the keys
    and values (layers, B, S, H, D) at positions ``pos``, in float32."""
    out = {n: cache[n].float().clone() for n in MAMBA if n in cache}
    out.update({n: cache[n][:, :, pos].float().clone()
                for n in KV if n in cache})
    return out


def positions(mix, seed, i, S, device):
    g = torch.Generator(device="cpu").manual_seed(seed_for(seed, "kvpos", i))
    pos = torch.randperm(S - 1, generator=g)[:mix["kv_positions"] - 1]
    return torch.cat([pos.sort().values, torch.tensor([S - 1])]).to(device)


def compare(served: dict, kept: dict, ref_out: dict, vocab):
    """``logit_gap``: the widest gap by which a served token's logit lies
    below the reference's best at that position; ``logit_gap_mean`` the
    mean of those gaps over the served tokens.  Of the cache, each layer's
    distance of each entry from the reference's (the L2 norm of the
    difference over the reference's, over the batch's rows), the worst
    over the entries and the checked batches: ``cache_gap`` is the worst
    layer's, ``cache_gap_median`` the median layer's and
    ``cache_gap_first`` the first layer's (in a routed model a routing
    choice that flips at a near tie moves the deeper layers' entries by
    more than the precision does).  ``served`` and ``kept`` by batch
    index; ``ref_out[i]`` = (reference last-position logits (B, V),
    reference snippet)."""
    gaps, layers = [], {}
    for i, (ref_logits, ref_snip) in ref_out.items():
        ids = torch.tensor(served[i], device=ref_logits.device)
        if bool(((ids < 0) | (ids >= vocab)).any()):
            gaps.append(float("inf"))
            continue
        best = ref_logits.max(-1).values
        got = ref_logits.gather(-1, ids[:, None])[:, 0]
        gaps += (best - got).tolist()
        for n, r in ref_snip.items():
            L = r.shape[0]
            d = (kept[i][n] - r).reshape(L, -1).norm(dim=1)
            scale = r.reshape(L, -1).norm(dim=1).clamp(min=1e-30)
            for l, g in enumerate((d / scale).tolist()):
                layers[l] = max(layers.get(l, 0.0), g)
    if not gaps:
        gaps = [float("inf")]
    if not layers:
        layers = {0: float("inf")}
    worst = [layers[l] for l in sorted(layers)]
    return {"logit_gap": max(gaps), "logit_gap_mean": float(np.mean(gaps)),
            "cache_gap": max(worst),
            "cache_gap_median": float(np.median(worst)),
            "cache_gap_first": worst[0]}


def reference_outputs(fam, model, mix, table, seed, device, batches: dict,
                      control: bool = False):
    """{batch index: (last-position logits, snippet)} of the plain
    reference over the prompts of ``batches`` ({index: positions})."""
    feed = inputs.PrefillFeed(mix, model["vocab_size"], seed, device)
    ref = RefPrefill(fam, model, inputs.make_weights(table, seed, device),
                     Prec(control))
    out = {}
    for i, pos in sorted(batches.items()):
        _, cache, last = ref(feed(i))
        out[i] = (last, snippet(cache, pos))
        del cache
    del ref
    gc.collect()
    return out


def outputs(prefill, feed, mix, seed, batches, device):
    """{index: served ids}, {index: snippet} of ``prefill`` (the program's
    or a stand-in) over the batches ``batches`` of ``feed``, outside any
    window: the readings that set a cell's limits."""
    served, kept = {}, {}
    for i in batches:
        tokens = feed(i)
        ids, cache = prefill(tokens)[:2]
        served[i] = ids.tolist()
        kept[i] = snippet(cache, positions(mix, seed, i, tokens.shape[1],
                                           device))
        del cache
    return served, kept


def run(ctx):
    """The cell: set-up, the window, the traced stretch where asked, the
    check; fills ``ctx`` (see ``run.py``)."""
    fam, model, mix, dev = ctx.fam, ctx.model, ctx.mix, ctx.device
    table = fam.param_table(model)
    feed = inputs.PrefillFeed(mix, model["vocab_size"], ctx.seed, dev)
    ctx.phase("imports")
    prog = ctx.make_prefill(model, inputs.make_weights(table, ctx.seed, dev))
    ctx.sync()
    ctx.phase("weights")
    B, n_len = mix["batch"], len(mix["lengths"])
    warm = inputs.Tokens(mix, model["vocab_size"], ctx.seed, dev)
    for S in sorted(set(mix["lengths"]), reverse=True):
        ids, cache = prog(warm.draw((B, S), "warm", S))
        ids.tolist()
        del cache
    every = mix["check_block_every"]
    residue = seed_for(ctx.seed, "check") % every
    ctx.sync()
    ctx.phase("warm-up")
    ctx.setup_done()

    served, kept, ttft, flops = {}, {}, [], 0
    i, failed = 0, 0
    t0 = time.perf_counter()
    while True:
        tokens = feed(i)
        ctx.sync()
        ts = time.perf_counter()
        ids, cache = prog(tokens)
        host = ids.tolist()
        te = time.perf_counter()
        ttft += [(te - ts) * 1e3] * B
        served[i] = host
        failed += sum(not 0 <= t < model["vocab_size"] for t in host)
        if (i // n_len) % every == residue:
            kept[i] = snippet(cache, positions(mix, ctx.seed, i,
                                               tokens.shape[1], dev))
        flops += fam.forward_flops(model, B, tokens.shape[1])
        del cache
        i += 1
        if te - t0 >= ctx.seconds:
            break
    ctx.window_closed()
    ctx.window_s = time.perf_counter() - t0
    ctx.attempted, ctx.failed = len(ttft), failed
    ctx.e2e["ttft_p95_ms"] = float(np.percentile(ttft, 95))
    ctx.window_flops = flops
    if ctx.trace:
        def traced():
            for j in range(i, i + mix["trace_batches"]):
                tok = feed(j)
                before = ctx.launch_counts()
                prog(tok)[0].tolist()
                ctx.record_launches(before, fam.kernel_shapes(
                    model, B, tok.shape[1]))
        ctx.run_traced(traced)
    ctx.read_memory()
    del prog
    gc.collect()
    ctx.free()
    t1 = time.perf_counter()
    pos = {j: positions(mix, ctx.seed, j, feed.length(j), dev) for j in kept}
    ref = reference_outputs(fam, model, mix, table, ctx.seed, dev, pos)
    ctx.note(f"reference: {time.perf_counter() - t1:.1f} s over "
             f"{len(pos)} batches")
    ctx.judge(compare(served, kept, ref, model["vocab_size"]))
