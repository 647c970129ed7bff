"""PyTorch port, tensor-parallel serving on the mesh: every family's
forward, prefill and decode (the transformer, SSM, hybrid and audio
families) on a rank's blocks of the parameters, the batch and the cache,
in the reference's three attention branches (heads, padded heads,
sequence-parallel), with the MoE modes, the Mamba layer's channel and head
layouts, whisper's heads (or every head) and its cross cache, the rule
sets, the query offset of the ``flash_attention`` kernel's plain version
and the dry run, held against the JAX package.

The port runs in one world of 4 gloo ranks (``run_ranks``; what each rank
runs is ``tests/torch_tp_ranks.tp_rank``, which imports no JAX), meshed
(1, 4) and (2, 2) over the one process group.  The JAX package's runs come
from ``tests/torch_tp_oracle.py`` in three subprocesses started when this
module starts: the forwards and the serving runs on 8 forced host devices
with Auto axes (as ``repro.launch.mesh.make_smoke_mesh`` builds them), the
production meshes' shard shapes on 512.  Inputs are seeded numpy (float32
weights of each arch's ``smoke()`` config, tokens, patch embeddings,
frames); the audio cases' reference runs its encoder's scans as loops with
the bf16 roundings it writes kept (the oracle's docstring).

Cases: (a) the query offset (causal, window, softcap, GQA) against
``layers.block_attention(q_offset=)``; (b) glm4-9b's heads branch with K/V
repeated and half-head kv column blocks on (1, 4), the fsdp gathers with
the batch over ``data`` on (2, 2), llava's patch embeddings on (2, 2); (c)
qwen2.5-32b at 5 query heads over 1 kv head on (1, 4), sequence-parallel
and with ``pad_heads``, each against the reference's forward with the same
``RunOptions``, and padded against unpadded (``test_pad_heads_is_exact``'s
counterpart); (d) granite at capacity factor 16, ``moe_mode`` "rpc" and
"onesided", routing equal (``test_moe_modes_agree``); (e)
``WIDE_DP_RULES`` against ``DEFAULT_RULES`` on (2, 2) through granite and
through mamba2-780m (the reference's
``test_wide_dp_rules_forward_matches_default``); (f) prefill 96 + 4 decode
steps under ``SERVE_RULES`` on (1, 4), qwen1.5-4b in "heads" cache mode,
gemma2-27b in "seq" mode, mamba2-780m and zamba2-1.2b with every cache
entry's block (conv tails, SSM states, the shared block's K/V); (g) the
dry run's shard shapes and bytes against ``NamedSharding(...).shard_shape``
on the production meshes; (h) mamba2-780m on (1, 4) and (2, 2), and at
head dim 64 (2 heads over 4 ranks: ``heads`` dropped, ``ff`` kept),
zamba2-1.2b on (1, 4) and (2, 2); (i) whisper-medium on (1, 4), on (2, 2)
under DEFAULT_RULES (the batch over data, the fsdp gathers) and at 6 heads
over 4 ranks (every head on every rank, ``wo`` whole), served in "heads"
cache mode and at 6 heads in "seq" mode (the self cache split by sequence,
the cross cache ``xk``/``xv`` whole); ``launch.serve --mesh 1,4`` for
qwen1.5-4b, mamba2-780m, zamba2-1.2b and whisper-medium.

Tolerances: logits within ``F32_REL_FAMILY`` (3e-4) of the reference's
logit range (float32 weights: only the order of sums differs); K/V cache
blocks within 1e-5 of their largest |value|; routing, greedy tokens, shard
shapes and bytes equal.
"""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses
import json
import math
import os
import pathlib
import functools
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_tp_ranks as TR
from repro.configs import SHAPES as JSHAPES
from repro.configs import shape_applicable as jshape_applicable
from repro.configs.registry import ARCHS as JARCHS
from repro.models import layers as jL
from repro_torch.configs import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCHS, get
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models import layers as L
from repro_torch.parallel import sharding as S
from repro_torch.serving import decode as D
from repro_torch.testing.ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = pathlib.Path(__file__).with_name("torch_tp_oracle.py")
DEADLINE_S = 180          # the world of ranks
ORACLE_S = 240            # every oracle subprocess
F32_REL_FAMILY = 3e-4     # of the reference's logit range
KV_REL = 1e-5             # of a cache entry's largest |value|
CASES = {**TR.FWD, **TR.SERVE}
INPUTS = {name: TR.case_inputs(c) for name, c in CASES.items()}


# --- the JAX package's runs, started together at module start ----------------
def _flat(tree, prefix):
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}/{k}"))
    return out


def _oracle_inputs(cases):
    out = {"cases": np.asarray(json.dumps({
        "cases": cases, "prompt": TR.PROMPT, "decode": TR.DECODE}))}
    for name in cases:
        for k, v in INPUTS[name].items():
            out.update(_flat(v, f"{name}/{k}"))
    return out


class Oracles:
    def __init__(self, d):
        self.d, self.procs, self.outs = d, {}, {}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        for kind, cases in (("fwd", TR.FWD), ("serve", TR.SERVE),
                            ("dryrun", {})):
            np.savez(d / f"{kind}_in.npz", **_oracle_inputs(cases))
            self.procs[kind] = subprocess.Popen(
                [sys.executable, str(ORACLE), kind, str(d / f"{kind}_in.npz"),
                 str(d / f"{kind}_out.npz")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.t0 = time.monotonic()

    def get(self, kind):
        if kind not in self.outs:
            p = self.procs[kind]
            left = ORACLE_S - (time.monotonic() - self.t0)
            try:
                so, se = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                p.kill()
                raise
            assert "ORACLE_OK" in so, se[-3000:]
            self.outs[kind] = dict(np.load(self.d / f"{kind}_out.npz"))
        return self.outs[kind]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def oracles(tmp_path_factory):
    o = Oracles(tmp_path_factory.mktemp("tp_oracles"))
    yield o
    o.close()


@pytest.fixture(scope="module", autouse=True)
def _world(oracles, tmp_path_factory):
    """The world of ranks, started with the oracles when the module starts
    and run in a thread while the query-offset tests run here."""
    box = {}

    def run():
        try:
            box["res"] = run_ranks(
                TR.tp_rank, 4, device="cpu", args=(CASES, INPUTS),
                deadline_s=DEADLINE_S,
                workdir=tmp_path_factory.mktemp("tp_ranks"),
                threads=torch_threads.RANK_THREADS)
        except BaseException as e:          # re-raised by the tests
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    yield t, box
    t.join()


@pytest.fixture(scope="module")
def world(_world):
    """Every case on the four ranks: {case: [(coordinate, outputs)] in rank
    order}, each rank's helper checks and its ``serve.mesh_rank`` run."""
    t, box = _world
    t.join()
    if "err" in box:
        raise box["err"]
    res = box["res"]
    out = {name: [r[name] for r in res] for name in CASES}
    for k in ("helpers", "cli", "cli_ssm", "cli_audio"):
        out[k] = [r[k] for r in res]
    return out


def topo_of(c):
    return S.Topology(S.AbstractMesh(("data", "model"), tuple(c["mesh"])),
                      dict(getattr(S, c["rules"])))


def assert_logits_block(cfg, topo, coord, got, want_full, vocab_axis=-1):
    """A rank's logits block against the same block of the reference's
    logits, within F32_REL_FAMILY of the reference's (real-vocab) range;
    the padded tail -1e30 by global index."""
    axes = ["batch"] + [None] * (want_full.ndim - 2) + ["vocab"]
    want = topo.block(torch.from_numpy(want_full), *axes, coord=coord)
    assert got.shape == want.shape and got.dtype == torch.float32
    V = cfg.vocab_size
    real = want_full[..., :V]
    lo, _ = topo.extent(topo.spec_for((cfg.vocab_padded, cfg.d_model),
                                      ("vocab", None))[0], cfg.vocab_padded)
    cols = lo + torch.arange(got.shape[-1])
    ok = cols < V
    err = float((got[..., ok] - want[..., ok]).abs().max()) if ok.any() else 0
    assert err <= F32_REL_FAMILY * float(real.max() - real.min()), err
    assert bool((got[..., ~ok] == -1e30).all())
    return err


# --- (a) the query offset ------------------------------------------------------
QOFF = {"causal": dict(Hq=4, Hkv=4), "window": dict(Hq=4, Hkv=2, window=40),
        "softcap": dict(Hq=4, Hkv=1, softcap=20.0),
        "gqa_window_softcap": dict(Hq=8, Hkv=2, window=24, softcap=30.0)}


def _qoff_inputs(name):
    c = QOFF[name]
    rng = np.random.RandomState(len(name))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return c, f(2, 96, c["Hq"], 16), f(2, 96, c["Hkv"], 16), \
        f(2, 96, c["Hkv"], 16)


OFFSETS = (24, 72)         # off the plain version's 64-row float32 tiles


@functools.lru_cache(maxsize=None)
def _qoff_reference(name):
    """The reference's rows at each offset (computed once for both of the
    port's functions)."""
    c, q, k, v = _qoff_inputs(name)
    return {off: np.asarray(jax.jit(lambda q_: jL.block_attention(
        q_, k, v, causal=True, window=c.get("window"),
        attn_softcap=c.get("softcap"), q_block=16, kv_block=16,
        q_offset=off))(q[:, off:off + 24])) for off in OFFSETS}


@pytest.mark.parametrize("fn", ["block_attention", "flash_attention_plain"])
@pytest.mark.parametrize("name", list(QOFF))
def test_q_offset_matches_reference(name, fn):
    """Row blocks of 24 queries at offsets 24 and 72 against the keys of
    all 96 positions, through the port's ``block_attention`` (its kernel's
    plain version on the CPU, in the models' layout) or
    ``flash_attention_plain`` (heads-major) at the TPU kernel's 16 x 16
    tiles, against the reference's ``block_attention(q_offset=)``, within
    1e-5 of the largest |value|; and each block equal to the same rows of
    the port's offset-free attention over all rows."""
    c, q, k, v = _qoff_inputs(name)
    kw = dict(causal=True, window=c.get("window"))
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    whole = L.block_attention(torch.from_numpy(q), tk, tv,
                              attn_softcap=c.get("softcap"), **kw)
    G = c["Hq"] // c["Hkv"]
    for off, want in _qoff_reference(name).items():
        qs = q[:, off:off + 24]
        if fn == "block_attention":
            got = L.block_attention(torch.from_numpy(qs), tk, tv,
                                    attn_softcap=c.get("softcap"),
                                    q_offset=off, **kw)
        else:
            bh = lambda x: torch.from_numpy(np.ascontiguousarray(
                x.transpose(0, 2, 1, 3))).reshape(-1, x.shape[1], 16)
            got = fa.flash_attention_plain(
                bh(qs), bh(k), bh(v), softcap=c.get("softcap"), group=G,
                q_block=16, kv_block=16, q_offset=off, **kw).reshape(
                    2, c["Hq"], 24, 16).transpose(1, 2)
        err = float(np.abs(got.numpy() - want).max())
        assert err <= 1e-5 * float(np.abs(want).max()), (off, err)
        if fn == "block_attention":
            assert float((got - whole[:, off:off + 24]).abs().max()) <= \
                1e-5 * float(whole.abs().max())


def test_q_offset_negative_is_refused():
    q = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_bhsd(q, q, q, q_offset=-1)


# --- (b)-(e) the forward -------------------------------------------------------
@pytest.mark.parametrize("case", list(TR.FWD))
def test_forward_matches_reference(case, world, oracles):
    """Every rank's logits block of ``api.forward(topo=)`` against the same
    block of the reference's ``api.forward`` on the same forced mesh under
    the same rules and RunOptions."""
    c = TR.FWD[case]
    cfg = TR.case_cfg(c)
    want = oracles.get("fwd")[case + "/logits"]
    assert want.shape == (c["B"], c["S"], cfg.vocab_padded)
    topo = topo_of(c)
    for coord, r in world[case]:
        assert_logits_block(cfg, topo, coord, r["logits"], want)


def test_attention_branches_are_reached(world):
    """The cases reach each of the reference's three branches (whisper its
    heads, and every head where 6 heads do not divide 4), and the MoE cases
    the modes they ask for."""
    branch = {name: world[name][0][1]["branch"] for name in TR.FWD}
    assert branch["glm4_1x4"] == branch["glm4_2x2"] == "heads"
    assert branch["qwen25_seq"] == "seq" and branch["qwen25_pad"] == "padded"
    assert branch["whisper_1x4"] == branch["whisper_2x2"] == "heads"
    assert branch["whisper_6h"] == "every head"
    modes = {name: world[name][0][1]["moe_mode"] for name in TR.FWD
             if name.startswith("granite")}
    assert modes["granite_rpc"] == "rpc"
    assert modes["granite_onesided"] == "onesided"
    assert modes["granite_wide_2x2"] == "replicated"


def _gathered(per_rank):
    """The logits blocks of ranks whose batch splits over ``data`` and
    vocab over ``model``, put back together: (B, S, V)."""
    rows = {}
    for coord, r in per_rank:
        rows.setdefault(coord["data"], {})[coord["model"]] = r["logits"]
    return torch.cat([torch.cat([blocks[m] for m in sorted(blocks)], -1)
                      for _, blocks in sorted(rows.items())], 0)


def test_pad_heads_is_exact(world):
    """The padded branch (5 heads padded to 8 over 4 ranks, one rank all
    padding) against the sequence-parallel one on the same weights: the
    same logits within F32_REL_FAMILY of their range
    (``test_pad_heads_is_exact``'s counterpart)."""
    a = _gathered(world["qwen25_pad"])
    b = _gathered(world["qwen25_seq"])
    V = TR.case_cfg(TR.FWD["qwen25_seq"]).vocab_size
    a, b = a[..., :V], b[..., :V]
    assert float((a - b).abs().max()) <= F32_REL_FAMILY * float(
        b.max() - b.min())


def test_moe_modes_agree(world):
    """granite at capacity factor 16 (no assignment dropped): "rpc" and
    "onesided" give the same logits within F32_REL_FAMILY and the same
    routing, call by call: each "rpc" rank routes its whole batch block,
    each "onesided" rank its 1/tp of it (``test_moe_modes_agree``)."""
    rpc, one = world["granite_rpc"], world["granite_onesided"]
    a = _gathered(rpc)
    b = _gathered(one)
    assert float((a - b).abs().max()) <= F32_REL_FAMILY * float(
        a.max() - a.min())
    n_layers = TR.case_cfg(TR.FWD["granite_rpc"]).n_layers
    for _, r in rpc:
        assert len(r["routing"]) == n_layers
        for x, y in zip(r["routing"], rpc[0][1]["routing"]):
            assert torch.equal(x, y)
    for i in range(n_layers):
        parts = [r["routing"][i] for _, r in sorted(
            one, key=lambda x: x[0]["model"])]
        assert torch.equal(torch.cat(parts), rpc[0][1]["routing"][i])


def _wide_against_default(world, wide_case, default_case):
    """The WIDE_DP_RULES case's logits (one batch row a rank, data-major,
    the whole vocab) against the DEFAULT_RULES case's, gathered: the
    largest difference and the default's logit range."""
    wide = sorted(world[wide_case],
                  key=lambda x: (x[0]["data"], x[0]["model"]))
    full = torch.cat([r["logits"] for _, r in wide])
    default = _gathered(world[default_case])
    V = TR.case_cfg(TR.FWD[wide_case]).vocab_size
    a, b = full[..., :V], default[..., :V]
    return float((a - b).abs().max()), float(b.max() - b.min())


def test_wide_dp_rules_forward_matches_default(world):
    """WIDE_DP_RULES (batch over every axis, experts replicated, ZeRO over
    data and model) against DEFAULT_RULES on (2, 2) through granite: the
    same function, so the same logits within F32_REL_FAMILY.  The
    reference's test of this runs mamba2-780m: that case is
    ``test_wide_dp_rules_ssm_forward_matches_default``."""
    err, span = _wide_against_default(world, "granite_wide_2x2",
                                      "granite_default_2x2")
    assert err <= F32_REL_FAMILY * span


def test_wide_dp_rules_ssm_forward_matches_default(world):
    """The reference's ``test_wide_dp_rules_forward_matches_default``
    itself: mamba2-780m on (2, 2) under WIDE_DP_RULES (batch over every
    axis, ZeRO over data and model, no ``ff`` or ``heads`` split) against
    DEFAULT_RULES, within F32_REL_FAMILY of the logit range."""
    err, span = _wide_against_default(world, "mamba2_wide_2x2",
                                      "mamba2_2x2")
    assert err <= F32_REL_FAMILY * span


def test_ssm_layouts_are_reached(world):
    """The Mamba cases reach the layouts they ask for: channels and heads
    split alike over model (1, 4); at head dim 64 the 2 heads dropped and
    the 128 channels kept, so the rank gathers them before the scan; under
    WIDE_DP_RULES nothing split."""
    lay = {name: world[name][0][1]["layout"] for name in TR.FWD
           if name.startswith(("mamba2", "zamba2"))}
    for name in ("mamba2_1x4", "mamba2_2x2", "zamba2_1x4", "zamba2_2x2"):
        assert lay[name].ef == lay[name].eh == "model", name
    d = lay["mamba2_heads_dropped"]
    assert (d.ef, d.fn, d.eh, d.hlo, d.hn) == ("model", 32, None, 0, 2)
    w = lay["mamba2_wide_2x2"]
    assert (w.ef, w.eh, w.fn, w.hn) == (None, None, 128, 8)


# --- (f) serving ---------------------------------------------------------------
@pytest.mark.parametrize("case", list(TR.SERVE))
def test_serving_matches_reference(case, world, oracles):
    """Prefill 96 + 4 teacher-forced decode steps under SERVE_RULES: each
    rank's logits block of every step against the reference's, and the
    greedy tokens across the vocab blocks equal to the argmax of the
    reference's whole logits."""
    c = TR.SERVE[case]
    cfg = TR.case_cfg(c)
    o = oracles.get("serve")
    topo = topo_of(c)
    for coord, r in world[case]:
        assert r["kv_mode"] == {"qwen15_heads": "heads",
                                "gemma2_seq": "seq", "mamba2_serve": "heads",
                                "zamba2_serve": "heads",
                                "whisper_heads": "heads",
                                "whisper_seq": "seq"}[case]
        for i in range(TR.DECODE + 1):
            want = o[f"{case}/logits{i}"]
            assert_logits_block(cfg, topo, coord, r["logits"][i], want)
            rows = topo.block(torch.from_numpy(want[..., :cfg.vocab_size]
                                               .argmax(-1)), "batch",
                              coord=coord)
            assert torch.equal(r["greedy"][i], rows)


@pytest.mark.parametrize("stage", ["prefill_cache", "cache"])
@pytest.mark.parametrize("case", list(TR.SERVE))
def test_cache_blocks_match_reference(case, stage, world, oracles):
    """Each rank's block of every cache entry (after the prefill, with the
    decode steps' room, and after the last step) against the block of the
    reference's cache under ``cache_shardings``: the K/V (the shared
    block's too, whisper's cross K/V by kv heads or whole), the conv tails
    on their ``ff`` channels and whole, the SSM states on their heads, each
    within KV_REL of its largest |value|; ``len`` exactly."""
    c = TR.SERVE[case]
    cfg = TR.case_cfg(c)
    o = oracles.get("serve")
    topo = topo_of(c)
    L_ = TR.PROMPT + TR.DECODE
    specs = D.cache_specs(cfg, c["B"], L_, topo)
    for coord, r in world[case]:
        got = r[stage]
        assert set(got) == set(specs)
        for name in specs:
            want_full = o[f"{case}/{stage}/{name}"]
            shape, axes, _ = specs[name]
            assert want_full.shape == shape
            want = topo.block(torch.from_numpy(want_full), *axes, coord=coord)
            assert tuple(got[name].shape) == tuple(want.shape), name
            if name == "len":
                assert torch.equal(got[name], want)
                continue
            err = float((got[name].float() - want.float()).abs().max())
            assert err <= KV_REL * float(np.abs(want_full).max()), (name,
                                                                    err)


def test_helpers_on_the_mesh(world):
    """Topology.gather over one axis and over (data, model) a1-major, an
    all-reduce over both, and greedy's ties across vocab blocks (to the
    lowest global index, ``jnp.argmax``'s order)."""
    for h in world["helpers"]:
        assert h["gather_ff"] and h["gather_two"]
        assert h["reduce"] == [4.0, 4.0, 4.0]
        assert h["greedy"] == [0, h["block_of"] - 1]


def test_serve_cli_on_a_mesh(world):
    """``launch.serve --mesh 1,4``'s rank (``serve.mesh_rank``, run by the
    world's ranks): qwen1.5-4b at smoke() size, its bf16 seeded weights cut
    to each rank's blocks, 2 x 64 + 3 greedy tokens; the ids of every rank
    the same, in the vocabulary, the first (the prefill's) equal to the
    one-device launcher's.  Later ids can part: bf16 partial sums round in
    another order on the mesh."""
    from repro_torch.launch import serve
    cfg = get(TR.CLI["arch"]).smoke()
    ranks = world["cli"]
    for coord, ids, st in ranks:
        assert tuple(ids.shape) == (TR.CLI["batch"], TR.CLI["decode"])
        assert torch.equal(ids, ranks[0][1])
        assert bool(((ids >= 0) & (ids < cfg.vocab_size)).all())
        assert st["prefill_ms"] > 0 and "cache" not in st
    one = serve.main(["--arch", TR.CLI["arch"], "--smoke", "--device", "cpu",
                      "--batch", str(TR.CLI["batch"]), "--prompt",
                      str(TR.CLI["prompt"]), "--decode",
                      str(TR.CLI["decode"])])
    assert torch.equal(ranks[0][1][:, 0], one[:, 0])


def _cli_matches_one_device(ranks, c):
    """Each rank's ``launch.serve --mesh`` result (coordinate, ids, stats)
    for the case ``c``: the ids of every rank the same, and equal to the
    one-device launcher's."""
    from repro_torch.launch import serve
    for coord, ids, st in ranks:
        assert tuple(ids.shape) == (c["batch"], c["decode"])
        assert torch.equal(ids, ranks[0][1])
        assert st["prefill_ms"] > 0 and "cache" not in st
    one = serve.main(["--arch", c["arch"], "--smoke", "--device", "cpu",
                      "--batch", str(c["batch"]), "--prompt",
                      str(c["prompt"]), "--decode", str(c["decode"])])
    assert torch.equal(ranks[0][1], one)


@pytest.mark.parametrize("arch", list(TR.CLI_SSM))
def test_serve_cli_on_a_mesh_ssm_hybrid(arch, world):
    """``launch.serve --mesh 1,4``'s rank for mamba2-780m and zamba2-1.2b
    at smoke() size (bf16 seeded weights cut to each rank's blocks, 2 x 64
    + 3 greedy tokens): the ids of every rank the same, and equal to the
    one-device launcher's."""
    _cli_matches_one_device([r[arch] for r in world["cli_ssm"]],
                            TR.CLI_SSM[arch])


def test_serve_cli_on_a_mesh_audio(world):
    """``launch.serve --mesh 1,4``'s rank for whisper-medium at smoke() size
    (its synthetic frames, bf16 seeded weights cut to each rank's blocks,
    one head a rank, 2 x 64 + 3 greedy tokens): the ids of every rank the
    same, and equal to the one-device launcher's (row-parallel partial sums
    go in float32, rounded once as on one device)."""
    _cli_matches_one_device(world["cli_audio"], TR.CLI_AUDIO)


# --- (g) the dry run -----------------------------------------------------------
def _dtypes(tree, path=""):
    if isinstance(tree, S.ParamSpec):
        return {path: tree.dtype}
    out = {}
    for k in sorted(tree):
        out.update(_dtypes(tree[k], f"{path}['{k}']"))
    return out


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_dryrun_matches_reference(mesh, oracles):
    """Every arch x SHAPES cell on the production mesh (16 x 16, or 2 x 16
    x 16): rank 0's block shape of every parameter, AdamW, batch and cache
    leaf equal to the reference's ``NamedSharding(...).shard_shape`` under
    the cell's rules (DEFAULT_RULES for training, SERVE_RULES for serving),
    each part's bytes the sum of its blocks; skips as the reference's
    ``shape_applicable``."""
    from repro_torch.data.pipeline import batch_specs
    from repro_torch.optim.adamw import opt_state_specs
    ref = json.loads(str(oracles.get("dryrun")["json"]))
    nbytes = lambda shapes, dts: sum(math.prod(s) * dts[k].itemsize
                                     for k, s in shapes.items())
    for arch in ARCHS:
        cfg = get(arch)
        for sname, shape in SHAPES.items():
            rec = dryrun.build_cell(arch, sname, mesh)
            ok, why = jshape_applicable(JARCHS[arch], JSHAPES[sname])
            assert (rec["status"] == "ok") == ok
            if not ok:
                assert rec["skipped"] == why
                continue
            rname = "DEFAULT_RULES" if shape.kind == "train" else \
                "SERVE_RULES"
            assert rec["rules"] == rname
            key = f"{mesh}/{rname}/{arch}"
            pspecs = api.param_specs(cfg)
            assert rec["params"]["shapes"] == ref[key + "/params"], key
            assert rec["params"]["bytes"] == nbytes(
                ref[key + "/params"], _dtypes(pspecs))
            assert rec["batch"]["shapes"] == ref[f"{key}/{sname}/batch"]
            bdt = {k: dt for k, (_, dt) in batch_specs(cfg, shape).items()}
            assert rec["batch"]["bytes"] == nbytes(
                ref[f"{key}/{sname}/batch"], bdt)
            if shape.kind == "train":
                assert rec["adamw"]["shapes"] == ref[key + "/adamw"], key
                assert rec["adamw"]["bytes"] == nbytes(
                    ref[key + "/adamw"], _dtypes(opt_state_specs(pspecs)))
            else:
                want = ref[f"{key}/{sname}/cache"]
                assert rec["cache"]["shapes"] == want, (key, sname)
                cdt = {k: dt for k, (_, _, dt) in D.cache_specs(
                    cfg, shape.global_batch, shape.seq_len).items()}
                assert rec["cache"]["bytes"] == nbytes(want, cdt)


def test_dryrun_records_layouts():
    """The branches, cache modes and MoE modes the production cells take:
    qwen2.5-32b (40 heads over 16) and qwen1.5-4b (20) sequence-parallel,
    padded under ``--opt tuned``; gemma2-27b's local and global layers by
    heads; glm4-9b heads with a "seq" cache; whisper-medium's three
    attentions by heads with a "heads" cache; the MoE archs' dispatch."""
    br = lambda a, s, m="single", opt="baseline": dryrun.build_cell(
        a, s, m, opt)
    assert br("qwen2.5-32b", "prefill_32k")["attention_branch"] == {
        "global": "seq"}
    assert br("qwen1.5-4b", "train_4k", opt="tuned")["attention_branch"] \
        == {"global": "padded"}
    assert br("gemma2-27b", "decode_32k")["attention_branch"] == {
        "local": "heads", "global": "heads"}
    g = br("glm4-9b", "decode_32k")
    assert g["attention_branch"] == {"global": "heads"}
    assert g["kv_mode"] == "seq"
    w = br("whisper-medium", "decode_32k")        # 16 heads over 16
    assert w["attention_branch"] == dict.fromkeys(
        ("encoder", "self", "cross"), "heads")
    assert w["kv_mode"] == "heads"
    for arch in ("granite-moe-1b-a400m", "deepseek-moe-16b"):
        rec = br(arch, "prefill_32k")
        assert rec["moe_dispatch_mode"] in ("rpc", "onesided")
    wide = br("granite-moe-1b-a400m", "train_4k", opt="tuned")
    assert wide["rules"] == "WIDE_DP_RULES"
    assert wide["moe_dispatch_mode"] == "replicated"


def test_dryrun_cli_writes_every_cell_on_meta(tmp_path, monkeypatch):
    """``python -m repro_torch.launch.dryrun --all``: one JSON a cell (10
    archs x 4 shapes x 2 meshes, the skipped cells with their reason), and
    no tensor made anywhere but on the meta device."""
    made = []
    for name in ("empty", "zeros", "ones", "full"):
        inner = getattr(torch, name)

        def spy(*a, _inner=inner, **k):
            made.append(str(k.get("device")))
            return _inner(*a, **k)
        monkeypatch.setattr(torch, name, spy)
    n_ok, n_skip = dryrun.main(["--all", "--out", str(tmp_path)])
    files = sorted(tmp_path.glob("*.json"))
    assert len(files) == len(ARCHS) * len(SHAPES) * 2 == n_ok + n_skip
    assert n_skip == 2 * sum(not shape_applicable(get(a), SHAPES[s])[0]
                             for a in ARCHS for s in SHAPES)
    rec = json.loads((tmp_path / "glm4-9b__train_4k__multi.json").read_text())
    assert rec["status"] == "ok" and rec["per_device_bytes"] > 0
    assert made and set(made) == {"meta"}
