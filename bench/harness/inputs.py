"""The inputs a run hands to the program and to the reference alike, made
from ``--seed`` on the run's device: the weights of a configuration and the
one general generator of traffic, which reads a mix's parameters.

Weights: every random leaf of the family's ``param_table`` is cut from one
buffer drawn by one ``torch.randn`` call in bfloat16 (the type the program
serves them in), then scaled in place: "normal" by 0.02, "normal0.1" by
0.1, "scaled" clipped at 2 and scaled by 1 / sqrt(fan-in), the
second-to-last dimension.  "zeros" and "ones" leaves are filled.

Tokens: fresh ids drawn uniformly over 1 .. vocab - 1.  Every batch has
its own generator, so batch i is the same whatever ran before it.
"""
from __future__ import annotations

import random

import torch

from harness.spec import seed_for

SCALE = {"normal": 0.02, "normal0.1": 0.1}


def make_weights(table: dict, seed: int, device, dtype=torch.bfloat16):
    """{path: tensor} of the family's ``param_table``, drawn from ``seed``."""
    g = torch.Generator(device=device).manual_seed(seed_for(seed, "weights"))
    drawn = [(p, shape, init) for p, (shape, init) in sorted(table.items())
             if init in ("normal", "normal0.1", "scaled")]
    sizes = [torch.Size(shape).numel() for _, shape, _ in drawn]
    flat = torch.randn(sum(sizes), generator=g, device=device, dtype=dtype)
    out, at = {}, 0
    for (p, shape, init), n in zip(drawn, sizes):
        t = flat[at:at + n].view(shape)
        at += n
        if init == "scaled":
            t.clamp_(-2.0, 2.0).mul_(shape[-2] ** -0.5)
        else:
            t.mul_(SCALE[init])
        out[p] = t
    for p, (shape, init) in table.items():
        if init in ("zeros", "ones"):
            out[p] = (torch.zeros if init == "zeros" else torch.ones)(
                shape, dtype=dtype, device=device)
    return out


def as_tree(flat: dict):
    """The nested dict the program takes, from "/"-joined paths."""
    tree = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = t
    return tree


class Tokens:
    """Token ids of a mix (``mix["tokens"]``: {"law": "uniform"}) over ids
    1 .. vocab - 1."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        if mix["tokens"]["law"] != "uniform":
            raise ValueError(f"unknown token law {mix['tokens']['law']!r}")
        self.device, self.seed, self.vocab = device, seed, vocab

    def draw(self, shape, *tags):
        g = torch.Generator(device=self.device).manual_seed(
            seed_for(self.seed, *tags))
        return torch.randint(1, self.vocab, tuple(shape), generator=g,
                             device=self.device)


class TrainFeed:
    """Step i's batch: {"tokens", "labels"} (B, S), the labels the tokens
    shifted by one, from fresh ids (mix: "batch", "seq")."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.B, self.S = mix["batch"], mix["seq"]
        self.tokens = Tokens(mix, vocab, seed, device)

    def __call__(self, i: int):
        ids = self.tokens.draw((self.B, self.S + 1), "train", i)
        return {"tokens": ids[:, :-1], "labels": ids[:, 1:]}


class PrefillFeed:
    """Batch i of a closed loop of prompts (mix: "batch", "lengths"): its
    length comes from blocks of len(lengths) batches, each block every
    length once in an order drawn from the seed, so every seed serves the
    same lengths in another order."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.B, self.lengths = mix["batch"], list(mix["lengths"])
        self.seed = seed
        self.tokens = Tokens(mix, vocab, seed, device)

    def length(self, i: int) -> int:
        n = len(self.lengths)
        order = random.Random(seed_for(self.seed, "lengths", i // n)).sample(
            self.lengths, n)
        return order[i % n]

    def __call__(self, i: int):
        return self.tokens.draw((self.B, self.length(i)), "prefill", i)
