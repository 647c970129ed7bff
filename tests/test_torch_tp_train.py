"""PyTorch port, training on the mesh: the train step, AdamW and the
Storm-committed checkpoint on a rank's blocks, with gradients through
every collective, held against the JAX package's
``jax.jit(make_train_step(cfg, topo, hp))`` on the same mesh.

The port runs in one world of 4 gloo ranks (``run_ranks``; what each rank
runs is ``tests/torch_tp_train_ranks.train_rank``, which imports no JAX),
meshed (2, 2) and (1, 4) over the one process group.  The JAX package's
runs come from ``tests/torch_tp_oracle.py train`` in three subprocesses
started when this module starts, on 8 forced host devices with Auto axes,
the state placed by ``state_shardings`` under the case's rules.  Inputs
are seeded numpy: float32 weights of each arch's ``smoke()`` config,
tokens and labels, whisper's frames.

Cases: (a) glm4-9b on (2, 2), the fsdp gathers with the batch over data
and the heads branch, two steps, the reference's gradient by
``jax.value_and_grad`` and its eval step; (b) qwen2.5-32b at 5 query heads
on (1, 4), sequence-parallel and with ``pad_heads``; (c)
granite-moe-1b-a400m on (2, 2), ``moe_mode`` "rpc" and "onesided" at the
default capacity factor (assignments past capacity dropped, carrying no
gradient); (d) zamba2-1.2b on (2, 2) and (1, 4); (e) whisper-medium on
(2, 2); (f) glm4-9b under ``WIDE_DP_RULES``; (g) two microbatches; (h) two
consecutive steps (glm4_2x2); (i) remat "full" and "dots" against no
remat, bit for bit.  Also: ``lm_loss(topo=)`` at a tie across a vocab
block boundary, replicated leaves bit-equal across ranks after the steps,
every raw collective run with grad mode off and torch's "autograd kernel
was not registered" warning an error on every rank, the checkpoint saved
on (2, 2) byte-equal to a one-device save of the gathered state and
restored onto (1, 4), ``launch.train --mesh 2,2`` (its rank function in
the world, and ``main`` itself) with a checkpoint and ``--resume``, and
the MoE cases' routing replayed on one device to show assignments are
dropped, and every rank's collectives of its first step against the dry
run's meta record of the same cut (``launch/dryrun.step_collectives``).

Limits: those of ``tests/torch_train_common.py``.  Each rank's gradient
of every leaf within ``GRAD_REL`` of the leaf's largest |grad| (the
reference's gradient: ``value_and_grad`` for glm4_2x2, else its first
moment after the step, m / ((1 - b1) x the clip's scale)); the master
update within ``GRAD_REL`` of its largest plus two float32 spacings of the
largest weight (the master's own rounding); loss, accuracy and grad_norm
within ``LOSS_REL``, tokens and lr within ``OPT_REL``; the launcher's
losses within ``BF16_LOSS_REL`` of the one-device launcher's.
"""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import torch_tp_train_ranks as TR
from torch_train_common import BF16_LOSS_REL, GRAD_REL, LOSS_REL, OPT_REL
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.convert import params_from_numpy
from repro_torch.models import api
from repro_torch.parallel import sharding as S
from repro_torch.testing.ranks import run_ranks
from repro_torch.train import step as T
from repro_torch.train.loss import lm_loss

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = pathlib.Path(__file__).with_name("torch_tp_oracle.py")
DEADLINE_S = 240          # the world of ranks
ORACLE_S = 300            # every oracle subprocess
B1 = 0.9                  # AdamW's first-moment decay (the default)
INPUTS = {name: TR.case_inputs(c) for name, c in TR.CASES.items()}
# the oracle subprocesses, by their cases: each compiles one train step a
# case (zamba2's take the longest)
GROUPS = (("zamba2_2x2", "zamba2_1x4"),
          ("glm4_2x2", "glm4_wide", "glm4_micro", "qwen25_seq",
           "qwen25_pad"),
          ("granite_rpc", "granite_onesided", "whisper_2x2"))
ORACLE_CASE = {"glm4_2x2": dict(grads=True, eval=True)}


def _flat(tree, prefix):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


class Oracles:
    def __init__(self, d):
        self.d, self.procs, self.outs = d, {}, None
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        for i, names in enumerate(GROUPS):
            cases = {n: dict(TR.CASES[n], adam=TR.ADAM,
                             **ORACLE_CASE.get(n, {})) for n in names}
            inp = {"cases": np.asarray(json.dumps({"cases": cases}))}
            for n in names:
                for k, v in INPUTS[n].items():
                    inp.update(_flat(v, f"{n}/{k}"))
            np.savez(d / f"train{i}_in.npz", **inp)
            self.procs[i] = subprocess.Popen(
                [sys.executable, str(ORACLE), "train",
                 str(d / f"train{i}_in.npz"), str(d / f"train{i}_out.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
        self.t0 = time.monotonic()

    def get(self):
        if self.outs is None:
            self.outs = {}
            for i, p in self.procs.items():
                left = ORACLE_S - (time.monotonic() - self.t0)
                try:
                    so, se = p.communicate(timeout=max(left, 1))
                except subprocess.TimeoutExpired:
                    p.kill()
                    raise
                assert "ORACLE_OK" in so, se[-3000:]
                self.outs.update(np.load(self.d / f"train{i}_out.npz"))
        return self.outs

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def oracles(tmp_path_factory):
    o = Oracles(tmp_path_factory.mktemp("train_oracles"))
    yield o
    o.close()


@pytest.fixture(scope="module", autouse=True)
def _world(oracles, tmp_path_factory):
    """The world of ranks, started with the oracles when the module starts
    and run in a thread."""
    box = {}
    tmp = tmp_path_factory.mktemp("train_world")

    def run():
        try:
            box["res"] = run_ranks(
                TR.train_rank, 4, device="cpu",
                args=(TR.CASES, INPUTS, str(tmp)), deadline_s=DEADLINE_S,
                workdir=tmp, threads=torch_threads.RANK_THREADS)
        except BaseException as e:          # re-raised by the tests
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield t, box
    t.join()


@pytest.fixture(scope="module")
def world(_world):
    """Every rank's results, in rank order."""
    t, box = _world
    t.join()
    if "err" in box:
        raise box["err"]
    return box["res"]


def topo_of(c):
    return S.Topology(S.AbstractMesh(("data", "model"), tuple(c["mesh"])),
                      dict(getattr(S, c["rules"])))


def named_specs(cfg):
    """(path, ParamSpec) of every parameter leaf in sorted key order."""
    out = []

    def walk(t, pre):
        if isinstance(t, S.ParamSpec):
            out.append((pre, t))
            return
        for k in sorted(t):
            walk(t[k], f"{pre}/{k}")
    walk(api.param_specs(cfg), "")
    return out


def leaf(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def assert_metrics(got, o, prefix):
    for k in ("loss", "accuracy"):
        assert rel(got[k], float(o[f"{prefix}/{k}"])) <= LOSS_REL, (prefix,
                                                                    k)
    for k in ("tokens", "lr"):
        if k in got:
            assert rel(got[k], float(o[f"{prefix}/{k}"])) <= OPT_REL, k
    if "grad_norm" in got:
        assert rel(got["grad_norm"], float(o[f"{prefix}/grad_norm"])) <= \
            LOSS_REL, prefix


def reference_grads(name, o):
    """The reference's global gradient of every leaf: ``value_and_grad``'s
    where the case has it, else m / ((1 - b1) x scale) after the first
    step, scale = min(1, grad_clip / grad_norm)."""
    if f"{name}/vg/metrics/loss" in o:
        return lambda p: o[f"{name}/vg/grads{p}"]
    gn = float(o[f"{name}/step0/metrics/grad_norm"])
    scale = min(1.0, 1.0 / max(gn, 1e-12))
    return lambda p: o[f"{name}/step0/m{p}"] / ((1 - B1) * scale)


@pytest.mark.parametrize("case", list(TR.CASES))
def test_train_matches_reference(case, world, oracles):
    """Every rank's metrics, gradient blocks (``loss_and_grads``) and
    master-update blocks of each step (``make_train_step``, each package
    from its own state) against the same blocks of the reference's global
    arrays; the parameters written with the master's values."""
    c = TR.CASES[case]
    cfg = TR.case_cfg(c)
    topo = topo_of(c)
    o = oracles.get()
    want_grad = reference_grads(case, o)
    vg = f"{case}/vg/metrics" if f"{case}/vg/metrics/loss" in o else \
        f"{case}/step0/metrics"
    for coord, r in (rank[case] for rank in world):
        blk = lambda a, s: topo.block(torch.from_numpy(np.asarray(a)),
                                      *s.logical_axes, coord=coord)
        assert_metrics(r["metrics"], o, vg)
        for path, s in named_specs(cfg):
            g = want_grad(path)
            err = float((leaf(r["grads"], path) - blk(g, s)).abs().max())
            assert err <= GRAD_REL * np.abs(g).max(), (path, err)
            assert np.abs(g).max() > 0, path
        for i, st in enumerate(r["steps"]):
            assert_metrics(st["metrics"], o, f"{case}/step{i}/metrics")
            assert int(st["state"]["opt"]["step"]) == i + 1
            for path, s in named_specs(cfg):
                if i == 0:
                    ref0 = leaf(INPUTS[case]["params"], path)
                    port0 = blk(ref0, s)
                else:
                    ref0 = o[f"{case}/step{i - 1}/master{path}"]
                    port0 = leaf(r["steps"][i - 1]["state"]["opt"]["master"],
                                 path)
                want = o[f"{case}/step{i}/master{path}"] - ref0
                got = leaf(st["state"]["opt"]["master"], path) - port0
                floor = 2 * np.spacing(np.abs(ref0).max())
                err = float((got - blk(want, s)).abs().max())
                assert err <= GRAD_REL * np.abs(want).max() + floor, (i, path)
                assert torch.equal(leaf(st["state"]["params"], path),
                                   leaf(st["state"]["opt"]["master"], path))


@pytest.mark.parametrize("case", list(TR.CASES))
def test_train_step_collectives_match_dry_run(case, world):
    """Every rank's collectives of its first train step (op, output bytes,
    group size, in call order: the forward, remat's recompute and the
    backward's adjoints, ``sync_grads``, the clip's norm) equal to the dry
    run's meta record of the same config, mesh, rules, options and batch
    (``dryrun.step_collectives`` on an AbstractMesh, rank 0's blocks in
    float32), and so its collective mix."""
    from repro_torch.launch import dryrun
    c = TR.CASES[case]
    cfg = TR.case_cfg(c)
    batch = {k: (v.shape, torch.float32) for k, v in INPUTS[case].items()
             if k != "params"}
    want = dryrun.step_collectives(cfg, topo_of(c), "train", c["B"], c["S"],
                                   hp=TR.case_hparams(c),
                                   dtype=torch.float32, batch=batch)
    ops = {op for op, _, _ in want}
    assert "all-reduce" in ops, ops
    if c["mesh"][0] > 1 and c["rules"] == "DEFAULT_RULES":
        assert "reduce-scatter" in ops, ops  # the fsdp gathers' adjoints
    for rank in world:
        assert rank[case][1]["collectives"] == want
    assert dryrun.collective_mix(world[0][case][1]["collectives"]) == \
        dryrun.collective_mix(want)


def test_lm_loss_tie_across_a_vocab_block_boundary(world):
    """``lm_loss(topo=)`` with the largest logit tied at the last column of
    one rank's vocab block and the first of the next: the argmax is the
    lower global index (``jnp.argmax``'s), so label 1 hits and label 2
    does not; the loss equals the one-device loss of the whole logits."""
    for r in world:
        t = r["tie"]
        want, m = lm_loss(t["whole"], t["labels"])
        assert t["accuracy"] == 0.5 == float(m["accuracy"])
        assert t["tokens"] == 2.0
        assert rel(t["loss"], float(want)) <= 1e-6


@pytest.mark.parametrize("policy", list(TR.REMAT))
def test_remat_is_bit_for_bit(policy, world):
    """Each layer body under ``torch.utils.checkpoint`` (saving nothing, or
    the weight products) re-enters the forward's collectives inside the
    backward on every rank, and its gradients and metrics equal the run
    without remat bit for bit."""
    name = TR.REMAT[policy]
    for rank in world:
        r, want = rank["remat_" + policy], rank[name][1]
        assert r["metrics"] == want["metrics"]
        for (_, s), a, b in zip(named_specs(TR.case_cfg(TR.CASES[name])),
                                _leaves(r["grads"]), _leaves(want["grads"])):
            assert torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def test_replicated_leaves_are_bit_equal(world):
    """After the last step of every case, each leaf of the parameters,
    the master copy and both moments stored whole on several ranks holds
    the same bits on all of them (ranks at the same coordinate along the
    axes the leaf is split over)."""
    shared = 0
    for name, c in TR.CASES.items():
        topo = topo_of(c)
        for path, s in named_specs(TR.case_cfg(c)):
            split = {a for e in topo.spec_for(s.shape, s.logical_axes)
                     for a in S.entry_axes(e)}
            held = {}
            for coord, r in (rank[name] for rank in world):
                key = tuple(coord[a] for a in sorted(split))
                st = r["steps"][-1]["state"]
                for part in ("params", "master", "m", "v"):
                    x = leaf(st["params"] if part == "params"
                             else st["opt"][part], path)
                    if (key, part) in held:
                        assert torch.equal(x, held[key, part]), (name, path,
                                                                 part)
                        shared += 1
                    held[key, part] = x
    assert shared > 0


def test_no_raw_collective_under_grad(world):
    """Every raw ``torch.distributed`` collective of every case's
    gradients and steps ran with grad mode off (inside a differentiable
    collective or under ``no_grad``), with torch's "an autograd kernel was
    not registered" warning raised as an error, on every rank."""
    for r in world:
        assert r["strict"]["calls"] > 0
        assert r["strict"]["bad"] == []


def test_eval_step_matches_reference(world, oracles):
    """``make_eval_step(topo=)`` after glm4_2x2's two steps: the global
    metrics on every rank against the reference's eval step."""
    o = oracles.get()
    for rank in world:
        assert_metrics(rank["glm4_2x2"][1]["eval"], o, "glm4_2x2/eval")


def test_checkpoint_saved_on_a_mesh(world, tmp_path):
    """glm4_2x2's state after two steps saved on (2, 2) (every leaf
    gathered whole, rank 0 writing and committing): the files byte for
    byte those of a one-device save of the gathered state; restored onto
    (1, 4), each rank's leaves the blocks ``Topology.block`` cuts of the
    saved leaves; the committed step read back on every rank."""
    cfg = TR.case_cfg(TR.CASES["glm4_2x2"])
    ck = [r["checkpoint"] for r in world]
    whole = ck[0]["whole"]
    CheckpointManager(tmp_path / "one", device="cpu").save(
        7, params_from_numpy(whole, "cpu"))
    one = tmp_path / "one" / "step_00000007"
    mesh = pathlib.Path(ck[0]["dir"]) / "step_00000007"
    names = sorted(f.name for f in one.iterdir())
    assert names == sorted(f.name for f in mesh.iterdir()) and names
    for n in names:
        assert (mesh / n).read_bytes() == (one / n).read_bytes(), n
    t14 = S.Topology(S.AbstractMesh(("data", "model"), (1, 4)))
    specs = T.make_train_state_specs(cfg)
    for r in ck:
        assert r["step"] == 7 and r["latest"] == 7
        for path, s in _named(specs):
            want = t14.block(torch.from_numpy(np.asarray(leaf(whole, path))),
                             *s.logical_axes, coord=r["coord14"])
            assert torch.equal(leaf(r["restored"], path), want), path


def _named(tree, pre=""):
    if isinstance(tree, S.ParamSpec):
        return [(pre, tree)]
    return [x for k in sorted(tree) for x in _named(tree[k], f"{pre}/{k}")]


def test_train_cli_on_a_mesh(world):
    """``launch.train --mesh 2,2``'s rank (``train.mesh_rank``, run by the
    world's ranks) for qwen1.5-4b at smoke() size, bf16: 4 steps with a
    checkpoint every 2, then ``--resume`` for 2 more: the resumed losses
    equal the uninterrupted 6-step run's, every rank's losses the same
    (the global loss), rank 0's lines name the commit and the resume, and
    the losses within BF16_LOSS_REL of the one-device launcher's."""
    from repro_torch.launch import train
    runs = [r["cli"] for r in world]
    for r in runs:
        (_, first, lines), (_, resumed, rlines), (_, whole, _) = (
            r["first"], r["resumed"], r["whole"])
        assert first + resumed == whole == runs[0]["whole"][1]
        assert "  checkpoint committed: step_00000004 (storm tx, latest=4)" \
            in lines
        assert rlines[0] == "resumed from step 4"
    args = train.parse(["--arch", TR.CLI["arch"], "--smoke", "--device",
                        "cpu", "--batch", str(TR.CLI["batch"]), "--seq",
                        str(TR.CLI["seq"]), "--steps", "6"])
    _, one = train.train(args, torch.device("cpu"), log=lambda _: None)
    for a, b in zip(runs[0]["whole"][1], one):
        assert rel(a, b) <= BF16_LOSS_REL


@pytest.mark.parametrize("case", ["granite_rpc", "granite_onesided"])
def test_moe_cases_drop_assignments(case):
    """The MoE cases route at the default capacity factor, and some of
    their assignments fall past capacity (so the cases hold dropped
    assignments to carrying no gradient): each rank's routing of its
    tokens ("rpc": its data block's 2 rows at their capacity; "onesided":
    its 1/tp of them, one row) replayed on one device over the same rows,
    layer by layer, counting the kept assignments."""
    from repro_torch.models import moe
    c = TR.CASES[case]
    cfg = TR.case_cfg(c)
    inp = INPUTS[case]
    params = params_from_numpy(inp["params"], "cpu")
    rows = 2 if c["moe_mode"] == "rpc" else 1
    inner, kept = moe._route, []

    def route(*a):
        buf, meta = inner(*a)
        kept.append((int(meta[4].sum()), meta[4].numel()))
        return buf, meta
    moe._route = route
    try:
        for r in range(0, c["B"], rows):
            api.forward(cfg, params, {"tokens": torch.from_numpy(
                inp["tokens"][r:r + rows]).long()}, opts=TR.case_opts(c))
    finally:
        moe._route = inner
    assert len(kept) == cfg.n_layers * c["B"] // rows
    assert sum(n - k for k, n in kept) > 0


def test_train_cli_mesh_flag(tmp_path):
    """``launch.train --mesh 2,2 --smoke --device cpu`` itself (argument
    parsing, ``train_mesh``'s spawned gloo ranks): 3 steps with a
    checkpoint at step 2, then ``--resume`` for 1 step: the resumed step's
    loss equals the first run's third, on every rank."""
    from repro_torch.launch import train
    argv = ["--arch", TR.CLI["arch"], "--smoke", "--device", "cpu",
            "--batch", str(TR.CLI["batch"]), "--seq", str(TR.CLI["seq"]),
            "--mesh", "2,2", "--ckpt-dir", str(tmp_path)]
    first = train.main(argv + ["--steps", "3", "--ckpt-every", "2"])
    resumed = train.main(argv + ["--steps", "1", "--resume"])
    assert len(first) == len(resumed) == 4
    for (_, a, lines), (_, b, rlines) in zip(first, resumed):
        assert len(a) == 3 and b == a[2:]
        assert "  checkpoint committed: step_00000002 (storm tx, latest=2)" \
            in lines
        assert rlines[0] == "resumed from step 2"
