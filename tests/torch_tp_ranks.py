"""What each rank of tests/test_torch_tp.py's world runs, and the cases'
inputs: the port alone (torch and repro_torch, never jax or the JAX
package; ``ranks.run_ranks`` asserts it on every rank).

Every case's inputs are seeded numpy: float32 weights drawn leaf by leaf
from the port's ``param_specs`` (norm weights and biases drawn too, so no
leaf is a constant), tokens and, for the VLM, patch embeddings, for the
audio family frames (float32 values rounded to bf16).  A rank
carries the whole tree across with ``params_from_numpy`` and keeps its
blocks (``params_block``), takes its batch block, and returns its outputs'
blocks on the CPU with its mesh coordinate.
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs.registry import get
from repro_torch.convert import params_block, params_from_numpy
from repro_torch.models import api, mamba2, moe, transformer, whisper
from repro_torch.models.embedding import greedy
from repro_torch.parallel import sharding as S
from repro_torch.serving import decode as D

CPU = "cpu"
MESHES = ((1, 4), (2, 2))
PROMPT, DECODE = 96, 4
TILE = 16                 # the reference's RunOptions tiles (q_block, kv_block)


def _fwd(arch, mesh, seed, B=2, S_=64, rules="DEFAULT_RULES", **kw):
    return dict(kind="fwd", arch=arch, mesh=mesh, rules=rules, B=B, S=S_,
                seed=seed, **kw)


# (b) heads with K/V repeat and half-head kv blocks (glm4: kv 2, 8 of a
# head's 16 columns a rank at tp 4), the fsdp gathers and the batch over
# data, llava's patch embeddings; (c) the sequence-parallel and padded
# branches (5 heads over 4); (d) the MoE modes; (e) the rule sets
QWEN_5H = dict(n_heads=5, n_kv_heads=1)
WHISPER_6H = dict(n_heads=6, n_kv_heads=6)
FWD = {
    "glm4_1x4": _fwd("glm4-9b", (1, 4), 1),
    "glm4_2x2": _fwd("glm4-9b", (2, 2), 2, B=4),
    "llava_2x2": _fwd("llava-next-mistral-7b", (2, 2), 3, B=4),
    "qwen25_seq": _fwd("qwen2.5-32b", (1, 4), 4, over=QWEN_5H),
    "qwen25_pad": _fwd("qwen2.5-32b", (1, 4), 4, over=QWEN_5H,
                       pad_heads=True),
    "granite_rpc": _fwd("granite-moe-1b-a400m", (1, 4), 5,
                        over=dict(capacity_factor=16.0), moe_mode="rpc"),
    "granite_onesided": _fwd("granite-moe-1b-a400m", (1, 4), 5,
                             over=dict(capacity_factor=16.0),
                             moe_mode="onesided"),
    "granite_default_2x2": _fwd("granite-moe-1b-a400m", (2, 2), 6, B=4,
                                over=dict(capacity_factor=16.0)),
    "granite_wide_2x2": _fwd("granite-moe-1b-a400m", (2, 2), 6, B=4,
                             over=dict(capacity_factor=16.0),
                             rules="WIDE_DP_RULES"),
    # (h) the SSM and hybrid families: mamba2's 8 smoke heads and 128
    # d_inner channels split alike over model 4; at head dim 64 its 2 heads
    # do not divide 4 ("heads" dropped, "ff" kept: the channels gathered
    # before the scan); the batch over data and the fsdp gathers on
    # (2, 2); WIDE_DP_RULES against DEFAULT_RULES; zamba2's 7 smoke layers,
    # 6 Mamba layers, the shared block once and 1 tail layer
    "mamba2_1x4": _fwd("mamba2-780m", (1, 4), 9),
    "mamba2_2x2": _fwd("mamba2-780m", (2, 2), 10, B=4),
    "mamba2_heads_dropped": _fwd("mamba2-780m", (1, 4), 11,
                                 over=dict(ssm_head_dim=64)),
    "mamba2_wide_2x2": _fwd("mamba2-780m", (2, 2), 10, B=4,
                            rules="WIDE_DP_RULES"),
    "zamba2_1x4": _fwd("zamba2-1.2b", (1, 4), 12),
    "zamba2_2x2": _fwd("zamba2-1.2b", (2, 2), 13, B=4),
    # the audio family: whisper's 4 smoke heads one a rank; the batch over
    # data and the fsdp gathers on (2, 2); 6 heads over 4 ranks, which do
    # not divide, so every rank computes every head and wo is whole
    "whisper_1x4": _fwd("whisper-medium", (1, 4), 16),
    "whisper_2x2": _fwd("whisper-medium", (2, 2), 17, B=4),
    "whisper_6h": _fwd("whisper-medium", (1, 4), 18, over=WHISPER_6H),
}
# (f) serving under SERVE_RULES: qwen1.5's 4 kv heads split ("heads" cache
# mode), gemma2's 2 do not ("seq" mode, with its window and softcaps)
SERVE = {
    "qwen15_heads": dict(kind="serve", arch="qwen1.5-4b", mesh=(1, 4),
                         rules="SERVE_RULES", B=2, seed=7),
    "gemma2_seq": dict(kind="serve", arch="gemma2-27b", mesh=(1, 4),
                       rules="SERVE_RULES", B=2, seed=8),
    # the SSM states (conv_x on ff, ssm on heads) and the shared block's K/V
    "mamba2_serve": dict(kind="serve", arch="mamba2-780m", mesh=(1, 4),
                         rules="SERVE_RULES", B=2, seed=14),
    "zamba2_serve": dict(kind="serve", arch="zamba2-1.2b", mesh=(1, 4),
                         rules="SERVE_RULES", B=2, seed=15),
    # whisper's self cache by heads; at 6 heads by sequence, its cross
    # cache then whole on every rank
    "whisper_heads": dict(kind="serve", arch="whisper-medium", mesh=(1, 4),
                          rules="SERVE_RULES", B=2, seed=19),
    "whisper_seq": dict(kind="serve", arch="whisper-medium", mesh=(1, 4),
                        rules="SERVE_RULES", B=2, seed=20, over=WHISPER_6H),
}


# launch.serve --mesh 1,4's rank function, on this world
CLI = dict(arch="qwen1.5-4b", smoke=True, device="cpu", batch=2, prompt=64,
           decode=3)
CLI_SSM = {a: dict(CLI, arch=a) for a in ("mamba2-780m", "zamba2-1.2b")}
CLI_AUDIO = dict(CLI, arch="whisper-medium")


def case_cfg(c):
    return dataclasses.replace(get(c["arch"]).smoke(), **c.get("over", {}))


def _draw(rng, spec):
    """float32 draws of one leaf: N(0, 1) / sqrt(fan_in) clipped at 2 for
    "scaled" (fan_in the input dimension, the second from last: the
    reference's init takes a stacked leaf's layer count), N(0, scale) for
    "normal", 1 + N(0, 0.02) for "ones" and N(0, 0.02) for "zeros"."""
    x = rng.standard_normal(spec.shape).astype(np.float32)
    if spec.init == "scaled":
        return np.clip(x, -2, 2) / np.float32(np.sqrt(spec.shape[-2]))
    if spec.init == "normal":
        return x * np.float32(spec.scale)
    return x * np.float32(0.02) + np.float32(spec.init == "ones")


def np_params(cfg, seed):
    """The case's whole parameter tree as float32 numpy."""
    rng = np.random.RandomState(seed)

    def walk(t):
        if isinstance(t, S.ParamSpec):
            return _draw(rng, t)
        return {k: walk(t[k]) for k in sorted(t)}
    return walk(api.param_specs(cfg))


def case_inputs(c):
    """Weights, tokens (and patch embeddings or frames) of a case."""
    cfg = case_cfg(c)
    rng = np.random.RandomState(1000 + c["seed"])
    S_ = c.get("S", PROMPT + DECODE)
    out = {"params": np_params(cfg, c["seed"]),
           "tokens": rng.randint(1, cfg.vocab_size, (c["B"], S_)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (c["B"], cfg.n_patches, cfg.d_model)) * 0.02).astype(np.float32)
    if cfg.family == "audio":
        x = rng.standard_normal((c["B"], cfg.encoder_seq, cfg.d_model))
        out["frames"] = torch.from_numpy((x * 0.5).astype(np.float32)).to(
            torch.bfloat16).float().numpy()
    return out


STUB = ("patch_embeds", "frames")


def attention_branch(cfg, topo, pad_heads=False):
    """The attention branch a case's family takes on ``topo``."""
    if cfg.family == "audio":
        return whisper.attention_branch(cfg, topo)
    return transformer.attention_branch(cfg, topo, pad_heads)


def routed():
    """Record every ``moe._router`` call's top-k experts: (the calls, a
    function that puts the router back)."""
    inner, calls = moe._router, []

    def router(cfg, xt, rw):
        v, i = inner(cfg, xt, rw)
        calls.append(i.clone())
        return v, i
    moe._router = router
    return calls, lambda: setattr(moe, "_router", inner)


def _fwd_rank(topo, c, inp):
    cfg = case_cfg(c)
    pb = params_block(topo, api.param_specs(cfg),
                      params_from_numpy(inp["params"], CPU))
    batch = {k: topo.block(torch.from_numpy(inp[k]), "batch",
                           *(None,) * (inp[k].ndim - 1))
             for k in ("tokens",) + STUB if k in inp}
    batch["tokens"] = batch["tokens"].long()
    opts = transformer.RunOptions(q_block=TILE, kv_block=TILE, remat=False,
                                  pad_heads=c.get("pad_heads", False),
                                  moe_mode=c.get("moe_mode", "auto"))
    calls, restore = routed()
    try:
        logits = api.forward(cfg, pb, batch, opts=opts, topo=topo)
    finally:
        restore()
    T = batch["tokens"].numel()
    return dict(logits=logits, routing=calls,
                layout=(mamba2.layout(cfg, topo) if cfg.ssm_state else None),
                branch=attention_branch(cfg, topo, c.get("pad_heads", False)),
                moe_mode=(moe.moe_dispatch(cfg, topo, T,
                                           c.get("moe_mode", "auto"))
                          if cfg.is_moe else None))


def _serve_rank(topo, c, inp):
    cfg = case_cfg(c)
    pb = params_block(topo, api.param_specs(cfg),
                      params_from_numpy(inp["params"], CPU))
    toks = topo.block(torch.from_numpy(inp["tokens"]).long(), "batch", None)
    stub = {k: topo.block(torch.from_numpy(inp[k]), "batch", None, None)
            for k in STUB if k in inp}
    logits, cache = D.make_prefill(cfg, PROMPT, DECODE, topo)(
        pb, dict(stub, tokens=toks[:, :PROMPT]))
    out = dict(logits=[logits], greedy=[greedy(cfg, logits, topo)],
               prefill_cache={k: v.clone() for k, v in cache.items()},
               kv_mode=D.kv_mode(cfg, topo))
    step = D.make_decode_step(cfg, topo)
    for i in range(PROMPT, PROMPT + DECODE):
        logits, cache = step(pb, cache, toks[:, i])
        out["logits"].append(logits)
        out["greedy"].append(greedy(cfg, logits, topo))
    out["cache"] = cache
    return out


def helpers_rank(topo):
    """Topology.gather over two axes a1-major, all_reduce, and greedy's
    ties across vocab blocks, on this rank."""
    full = torch.arange(4 * 6 * 8, dtype=torch.float32).reshape(4, 6, 8)
    blk = topo.block(full, "batch", None, "ff")
    both = ("data", "model")                   # a1-major: data, then model
    two = full.narrow(
        2, 2 * (topo.axis_index("data") * 2 + topo.axis_index("model")), 2)
    ones = torch.ones(3)
    cfg = dataclasses.replace(get("qwen1.5-4b").smoke(), vocab_size=1024)
    V = cfg.vocab_padded
    tie = torch.zeros(2, V // topo.axis_sizes["model"])
    tie[1, -1] = 1.0                           # the last column of each block
    return dict(gather_ff=torch.equal(topo.gather(blk, 2, "model"),
                                      topo.block(full, "batch", None, None)),
                gather_two=torch.equal(topo.gather(two, 2, both), full),
                reduce=topo.all_reduce(ones.clone(), both).tolist(),
                greedy=greedy(cfg, tie, topo).tolist(),
                block_of=V // topo.axis_sizes["model"])


def tp_rank(rank, world, cases, inputs):
    """Every case on its mesh of this world (meshed (1, 4) and (2, 2) over
    the one process group), then the helpers on (2, 2), then
    ``launch.serve --mesh 1,4``'s rank for qwen1.5-4b, mamba2-780m,
    zamba2-1.2b and whisper-medium."""
    from repro_torch.launch.mesh import make_mesh
    meshes = {m: make_mesh(m, ("data", "model"), CPU) for m in MESHES}
    out = {}
    for name, c in cases.items():
        topo = S.Topology(meshes[tuple(c["mesh"])],
                          dict(getattr(S, c["rules"])))
        run = _fwd_rank if c["kind"] == "fwd" else _serve_rank
        out[name] = (topo.coordinate(), run(topo, c, inputs[name]))
    out["helpers"] = helpers_rank(S.Topology(meshes[(2, 2)]))
    from repro_torch.launch import serve
    out["cli"] = serve.mesh_rank(rank, world, (1, 4),
                                 argparse.Namespace(**CLI))
    out["cli_ssm"] = {a: serve.mesh_rank(rank, world, (1, 4),
                                         argparse.Namespace(**c))
                      for a, c in CLI_SSM.items()}
    out["cli_audio"] = serve.mesh_rank(rank, world, (1, 4),
                                       argparse.Namespace(**CLI_AUDIO))
    return out
