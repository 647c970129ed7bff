"""The JAX package's mesh runs that tests/test_torch_mesh.py holds the port
against.  Run as a script in a subprocess, so the test session keeps its
one-device view of JAX:

    python tests/torch_mesh_oracle.py KIND INPUTS.npz OUT.npz

KIND is ``protocol`` (rpc_call inserts then hybrid_lookup, and
run_transactions, each on the reference's MeshTransport under shard_map
over 8 forced host devices, the lookups on SimTransport too), ``branches``
(embed_lookup, hybrid_decode_attention and moe_ffn on (1, tp) and (2, 2)
meshes with Auto axes, as ``repro.launch.mesh.make_smoke_mesh`` builds
them) or ``specs`` (param_specs_pspec, cache_specs' axes and kv_mode of
every arch on the production meshes, 512 forced devices; INPUTS.npz is
ignored).  Per-rank scalars come back as (N,) arrays; everything goes to
OUT.npz.
"""
import dataclasses
import os
import sys

KIND, INPUTS, OUT = sys.argv[1:4]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%d" % (
    512 if KIND == "specs" else 8)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.core import hybrid as hy  # noqa: E402
from repro.core import rpc as R  # noqa: E402
from repro.core import tx  # noqa: E402
from repro.core.datastructs import hashtable as ht  # noqa: E402
from repro.core.transport import MeshTransport, SimTransport  # noqa: E402

out = {}


def smap(fn, mesh, in_specs, out_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, check_vma=False))


def per_rank(tree):
    """Per-rank scalars as (1,) blocks of an (N,) output."""
    return jax.tree.map(lambda x: jnp.reshape(x, (1,)), tree)


def put(mesh, tree):
    sh = NamedSharding(mesh, P("node"))
    return jax.tree.map(lambda x: jax.device_put(x, sh), tree)


def wire_dict(prefix, w):
    import dataclasses
    for f in dataclasses.fields(w):
        out[f"{prefix}wire_{f.name}"] = np.asarray(getattr(w, f.name))


def hash_cfg(inp, case):
    return ht.HashTableConfig(
        n_nodes=int(inp[f"{case}n_nodes"]), n_buckets=32, bucket_width=2,
        n_overflow=32, cache_slots=int(inp[f"{case}cache_slots"]))


def cluster_cache(cfg):
    c = ht.init_cache(cfg)
    if c is None:
        return None
    return jax.tree.map(lambda x: jnp.broadcast_to(x, (cfg.n_nodes,) + x.shape),
                        c)


def lookup_case(inp, case):
    """Insert every node's keys by rpc_call, then ``lookups`` rounds of
    hybrid_lookup of the same keys (the cache, where on, carried across)."""
    cfg = hash_cfg(inp, case)
    N = cfg.n_nodes
    layout = ht.build_layout(cfg)
    h = ht.make_rpc_handler(cfg, layout)
    klo, khi, vals = (jnp.asarray(inp[case + k]) for k in ("klo", "khi",
                                                             "vals"))
    n_look = int(inp[case + "lookups"])
    node, _, _ = ht.lookup_start(cfg, layout, klo, khi)

    def run(t, state, node, klo, khi, vals, cache):
        recs = ht.make_record(R.OP_INSERT, klo, khi, value=vals)
        state, rep, _, _ = R.rpc_call(t, state, node, recs, h)
        looks = []
        for _ in range(n_look):
            state, cache, found, value, version, owner, slot, ovf, m = \
                hy.hybrid_lookup(t, state, klo, khi, cfg, layout, cache=cache)
            looks.append((found, value, version, slot, ovf, m))
        return rep, state["arena"], looks

    cache = cluster_cache(cfg)
    rep, arena, looks = jax.jit(lambda *a: run(SimTransport(N), *a))(
        ht.init_cluster_state(cfg), node, klo, khi, vals, cache)
    out[case + "sim_rep0"] = np.asarray(rep[..., 0])
    out[case + "sim_arena"] = np.asarray(arena)
    for i, (f, v, ver, s, o, _) in enumerate(looks):
        for k, x in (("found", f), ("value", v), ("version", ver),
                     ("slot", s), ("overflow", o)):
            out[f"{case}sim{i}_{k}"] = np.asarray(x)

    mesh = jax.make_mesh((N,), ("node",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:N])
    tm = MeshTransport(N, axis_name="node")

    def mesh_run(state, node, klo, khi, vals, cache):
        rep, arena, looks = run(tm, state, node, klo, khi, vals, cache)
        return rep, arena, [(f, v, ver, s, o, per_rank(m))
                            for f, v, ver, s, o, m in looks]
    fn = smap(mesh_run, mesh, (P("node"),) * 6, P("node"))
    rep, arena, looks = fn(put(mesh, ht.init_cluster_state(cfg)),
                           *put(mesh, (node, klo, khi, vals)),
                           put(mesh, cache))
    out[case + "mesh_rep0"] = np.asarray(rep[..., 0])
    out[case + "mesh_arena"] = np.asarray(arena)
    for i, (f, v, ver, s, o, m) in enumerate(looks):
        for k, x in (("found", f), ("value", v), ("version", ver),
                     ("slot", s), ("overflow", o),
                     ("onesided_success", m.onesided_success),
                     ("rpc_fallback", m.rpc_fallback), ("total", m.total)):
            out[f"{case}mesh{i}_{k}"] = np.asarray(x)
        wire_dict(f"{case}mesh{i}_", m.wire)


def tx_case(inp, case):
    """Insert the key pool by rpc_call, then one run_transactions batch on
    the mesh."""
    cfg = hash_cfg(inp, case)
    N = cfg.n_nodes
    layout = ht.build_layout(cfg)
    h = ht.make_rpc_handler(cfg, layout)
    g = lambda k: jnp.asarray(inp[case + k])
    plo, phi, pval = g("pool_lo"), g("pool_hi"), g("pool_val")
    pnode, _, _ = ht.lookup_start(cfg, layout, plo, phi)
    cap = int(inp[case + "capacity"])
    kw = dict(use_onesided=bool(inp[case + "use_onesided"]),
              capacity=None if cap < 0 else cap,
              fused=bool(inp[case + "fused"]))
    mesh = jax.make_mesh((N,), ("node",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:N])
    tm = MeshTransport(N, axis_name="node")

    def run(state, pnode, plo, phi, pval, rk, wk, wv, ren, wen):
        state, _, _, _ = R.rpc_call(
            tm, state, pnode, ht.make_record(R.OP_INSERT, plo, phi,
                                             value=pval), h)
        state, _, res = tx.run_transactions(
            tm, state, cfg, layout, read_keys=rk, write_keys=wk,
            write_values=wv, read_enabled=ren, write_enabled=wen, **kw)
        return state["arena"], res.committed, res.read_found, \
            res.read_values, res.aborted_lock, res.aborted_validate, \
            res.aborted_overflow, res.aborted_stale, \
            per_rank(res.round_trips), per_rank(res.metrics)
    fn = smap(run, mesh, (P("node"),) * 10, P("node"))
    res = fn(put(mesh, ht.init_cluster_state(cfg)),
             *put(mesh, (pnode, plo, phi, pval, g("rk"), g("wk"), g("wv"),
                         g("ren"), g("wen"))))
    names = ("arena", "committed", "read_found", "read_values",
             "aborted_lock", "aborted_validate", "aborted_overflow",
             "aborted_stale", "round_trips")
    for k, x in zip(names, res):
        out[case + k] = np.asarray(x)
    m = res[-1]
    for k in ("onesided_success", "rpc_fallback", "total"):
        out[case + k] = np.asarray(getattr(m, k))
    wire_dict(case, m.wire)


def branch_mesh(shape):
    return jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])


def branches(inp):
    from repro.configs.registry import ARCHS
    from repro.models import embedding as E
    from repro.models import moe
    from repro.parallel.sharding import Topology
    from repro.serving import decode as D
    for case in str(inp["cases"]).split(","):
        g = lambda k: jnp.asarray(inp[case + k])
        topo = Topology(branch_mesh(tuple(int(v) for v in inp[case + "mesh"])))
        kind = str(inp[case + "kind"])
        mode = str(inp[case + "mode"])
        if kind == "embed":
            out[case + "out"] = np.asarray(jax.jit(
                lambda t, k: E.embed_lookup(topo, t, k, mode=mode))(
                    g("table"), g("tokens")))
        elif kind == "decode":
            cfg = ARCHS[str(inp[case + "arch"])].smoke()
            cfg = dataclasses.replace(
                cfg, n_kv_heads=int(inp[case + "n_kv_heads"]))
            w = int(inp[case + "window"])
            out[case + "out"] = np.asarray(jax.jit(
                lambda *a: D.hybrid_decode_attention(
                    cfg, topo, *a, window=None if w < 0 else w, mode=mode))(
                        g("q"), g("kc"), g("vc"), g("lens")))
        else:
            cfg = ARCHS[str(inp[case + "arch"])].smoke()
            x = g("x")
            out[case + "out"] = np.asarray(jax.jit(
                lambda *a: moe.moe_ffn(cfg, topo, *a, mode=mode))(
                    x, g("router"), g("wg"), g("wu"), g("wd")))
            B, S, d = x.shape
            dp = topo.axis_sizes["data"]
            out[case + "auto"] = np.asarray(moe.moe_dispatch_mode(
                cfg, topo, tokens_per_device=(B * S) // dp))


def specs():
    import json
    from repro.configs.registry import ARCHS
    from repro.launch.mesh import make_production_mesh
    from repro.models import api
    from repro.parallel import sharding as S
    from repro.serving import decode as D
    res = {}
    for multi in (False, True):
        mesh = make_production_mesh(multi_pod=multi)
        for rname in ("DEFAULT_RULES", "SERVE_RULES", "WIDE_DP_RULES"):
            topo = S.Topology(mesh, dict(getattr(S, rname)))
            for arch, cfg in ARCHS.items():
                tree = S.param_specs_pspec(topo, api.param_specs(cfg))
                leaves = jax.tree_util.tree_flatten_with_path(
                    tree, is_leaf=lambda x: isinstance(x, P))[0]
                key = f"{int(multi)}/{rname}/{arch}"
                res[key] = {jax.tree_util.keystr(p): [
                    list(e) if isinstance(e, tuple) else e for e in spec]
                    for p, spec in leaves}
                res[key + "/kv_mode"] = D.kv_mode(cfg, topo)
                res[key + "/heads"] = [
                    list(e) if isinstance(e, tuple) else e for e in
                    topo.spec_for((32, 64, cfg.n_heads, cfg.head_dim),
                                  ("batch", None, "heads", None))]
                res[key + "/cache"] = {
                    k: list(ax) for k, (_, ax, _) in D.cache_specs(
                        cfg, topo, 2, 64).items()}
    out["json"] = np.asarray(json.dumps(res))


if KIND == "specs":
    specs()
else:
    inp = np.load(INPUTS)
    if KIND == "branches":
        branches(inp)
    else:
        for case in str(inp["cases"]).split(","):
            (tx_case if case.startswith("tx") else lookup_case)(inp, case)
np.savez(OUT, **out)
print("ORACLE_OK")
