"""The JAX package's tensor-parallel runs that tests/test_torch_tp.py holds
the port against.  Run as a script in a subprocess, so the test session
keeps its one-device view of JAX:

    python tests/torch_tp_oracle.py KIND INPUTS.npz OUT.npz

KIND is ``fwd`` (``api.forward`` of each case on its (data, model) mesh of
forced host devices with Auto axes, as ``repro.launch.mesh.make_smoke_mesh``
builds them, under the case's rules and ``RunOptions``), ``serve``
(``make_prefill`` over the prompt, then ``make_decode_step`` teacher-forced
under ``SERVE_RULES``: the logits of each step, the prefill's cache with
its K/V padded by the decode steps' room, and the last cache) or
``dryrun`` (the production meshes on 512 forced devices: every leaf's
``NamedSharding(...).shard_shape`` of the parameters under DEFAULT_RULES
and SERVE_RULES, of the AdamW state under DEFAULT_RULES, of the batch and
the cache of every shape under its cell's rules; INPUTS.npz is ignored).
Each case's inputs come in INPUTS.npz as ``<case>/<key>`` arrays (the
parameter tree flattened as ``<case>/params/<path>``) beside a JSON
``cases``.  Everything goes to OUT.npz.

The audio family's encoder rounds its input to bf16, so with float32
weights its ``lax.scan`` carry changes dtype and JAX refuses it: its cases
run that module's scans as Python loops and are jitted with
``xla_allow_excess_precision`` off, which keeps the bf16 roundings the code
writes (``tests/torch_parity.py``'s ``reference_scan_as_loop`` and
``jit``).
"""
import json
import os
import sys

KIND, INPUTS, OUT = sys.argv[1:4]
# no Eigen thread pool inside an op: the oracle runs beside the suite's
# workers
os.environ["XLA_FLAGS"] = (
    "--xla_cpu_multi_thread_eigen=false "
    "--xla_force_host_platform_device_count=%d") % (
    512 if KIND == "dryrun" else 8)
os.environ["JAX_PLATFORMS"] = "cpu"

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402

from repro.configs.registry import ARCHS  # noqa: E402
from repro.models import api  # noqa: E402
from repro.models import whisper as jW  # noqa: E402
from repro.models.transformer import RunOptions  # noqa: E402
from repro.parallel import sharding as S  # noqa: E402
from repro.serving import decode as D  # noqa: E402

out = {}
TILE = 16
STUB = ("patch_embeds", "frames")


def loop_scan(f, init, xs):
    """``lax.scan`` as a Python loop over the leading axis of xs: the same
    steps, but the carry may change dtype."""
    n = jax.tree.leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree.map(lambda a: a[i], xs))
        ys.append(y)
    if ys[0] is None:
        return carry, None
    return carry, jax.tree.map(lambda *a: jnp.stack(a), *ys)


@contextlib.contextmanager
def audio_scans(cfg):
    """While tracing an audio case, ``repro.models.whisper``'s scans as
    :func:`loop_scan`."""
    saved = jW.lax
    if cfg.family == "audio":
        jW.lax = types.SimpleNamespace(scan=loop_scan)
    try:
        yield
    finally:
        jW.lax = saved


def jit(cfg, f):
    """``jax.jit``; for an audio case with every bf16 rounding the code
    writes kept."""
    if cfg.family != "audio":
        return jax.jit(f)
    return jax.jit(f, compiler_options={"xla_allow_excess_precision": False})


def mesh_of(shape):
    return jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


def unflat(inp, prefix):
    tree = {}
    for k in inp.files:
        if k.startswith(prefix):
            node = tree
            parts = k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(inp[k])
    return tree


def setup(inp, name, c):
    cfg = dataclasses.replace(ARCHS[c["arch"]].smoke(), **c.get("over", {}))
    topo = S.Topology(mesh_of(c["mesh"]), dict(getattr(S, c["rules"])))
    opts = RunOptions(q_block=TILE, kv_block=TILE, remat=False,
                      pad_heads=c.get("pad_heads", False),
                      moe_mode=c.get("moe_mode", "auto"))
    return cfg, topo, opts, unflat(inp, f"{name}/params/")


def fwd(inp, cases):
    for name, c in cases.items():
        cfg, topo, opts, params = setup(inp, name, c)
        batch = {k: jnp.asarray(inp[f"{name}/{k}"])
                 for k in ("tokens",) + STUB
                 if f"{name}/{k}" in inp.files}
        with audio_scans(cfg):
            out[name + "/logits"] = np.asarray(jit(
                cfg, lambda p, b: api.forward(cfg, topo, p, b, opts=opts))(
                    params, batch))


def serve(inp, cases, prompt, decode):
    for name, c in cases.items():
        cfg, topo, opts, params = setup(inp, name, c)
        toks = jnp.asarray(inp[f"{name}/tokens"])
        stub = {k: jnp.asarray(inp[f"{name}/{k}"]) for k in STUB
                if f"{name}/{k}" in inp.files}
        with audio_scans(cfg):
            logits, cache = jit(cfg, D.make_prefill(cfg, topo, prompt, opts))(
                params, dict(stub, tokens=toks[:, :prompt]))
        pad = ((0, 0), (0, 0), (0, decode), (0, 0), (0, 0))
        cache = {k: jnp.pad(v, pad) if k in ("k", "v", "shared_k",
                                             "shared_v") else v
                 for k, v in cache.items()}
        for k, v in cache.items():
            out[f"{name}/prefill_cache/{k}"] = np.asarray(v)
        out[f"{name}/logits0"] = np.asarray(logits)
        step = jit(cfg, D.make_decode_step(cfg, topo))
        for i in range(decode):
            logits, cache = step(params, cache, toks[:, prompt + i])
            out[f"{name}/logits{i + 1}"] = np.asarray(logits)
        for k, v in cache.items():
            out[f"{name}/cache/{k}"] = np.asarray(v)


def dryrun():
    from repro.configs import SHAPES
    from repro.data.pipeline import batch_specs
    from repro.launch.mesh import make_production_mesh
    from repro.optim.adamw import opt_state_specs
    res = {}

    def shards(topo, tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, S.ParamSpec))[0]
        return {"".join(f"['{p.key}']" for p in path): list(
            NamedSharding(topo.mesh, topo.spec_for(s.shape, s.logical_axes))
            .shard_shape(s.shape)) for path, s in leaves}

    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        kind = "multi" if multi else "single"
        for rname in ("DEFAULT_RULES", "SERVE_RULES"):
            topo = S.Topology(mesh, dict(getattr(S, rname)))
            for arch, cfg in ARCHS.items():
                pspecs = api.param_specs(cfg)
                key = f"{kind}/{rname}/{arch}"
                res[key + "/params"] = shards(topo, pspecs)
                if rname == "DEFAULT_RULES":
                    res[key + "/adamw"] = shards(topo, opt_state_specs(pspecs))
                for sname, shape in SHAPES.items():
                    res[f"{key}/{sname}/batch"] = {
                        k: list(NamedSharding(mesh, topo.spec_for(
                            v.shape, ("batch",) + (None,) * (len(v.shape) - 1)))
                            .shard_shape(v.shape))
                        for k, v in batch_specs(cfg, shape).items()}
                    if rname == "SERVE_RULES":
                        B, S_ = shape.global_batch, shape.seq_len
                        res[f"{key}/{sname}/cache"] = {
                            k: list(NamedSharding(mesh, topo.spec_for(shp, ax))
                                    .shard_shape(shp))
                            for k, (shp, ax, _) in D.cache_specs(
                                cfg, topo, B, S_).items()}
    out["json"] = np.asarray(json.dumps(res))


if KIND == "dryrun":
    dryrun()
else:
    inp = np.load(INPUTS)
    meta = json.loads(str(inp["cases"]))
    if KIND == "fwd":
        fwd(inp, meta["cases"])
    else:
        serve(inp, meta["cases"], meta["prompt"], meta["decode"])
np.savez(OUT, **out)
print("ORACLE_OK")
