"""What each rank of tests/test_torch_mesh.py's worlds runs: the port alone
(torch and repro_torch, never jax or the JAX package: ``ranks.run_ranks``
asserts it on every rank).  Inputs arrive as global numpy arrays; a rank
takes its own rows or blocks, and returns its results on the CPU."""
import numpy as np
import torch

from repro_torch.convert import words
from repro_torch.core import hybrid as hy
from repro_torch.core import rpc as R
from repro_torch.core import tx
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import MeshTransport, SimTransport
from repro_torch.kernels import hash_probe as hp

CPU = "cpu"


def counting_probe():
    """Count the calls of hash_probe's plain version (the CPU's kernel)."""
    inner, calls = hp.probe_lines_plain, [0]

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)
    hp.probe_lines_plain = counted
    return calls


def exchange_rank(rank, world, cases):
    """MeshTransport.exchange of each global (N, N, C, ...) tensor against
    SimTransport's, as (rank's mesh block, rank's simulator rows)."""
    t = MeshTransport(world)
    res = []
    for x in cases:
        x = torch.from_numpy(x)
        res.append((t.exchange(t.local(x)),
                    t.local(SimTransport(world).exchange(x))))
    return res


def hash_cfg(c):
    return ht.HashTableConfig(n_nodes=int(c["n_nodes"]), n_buckets=32,
                              bucket_width=2, n_overflow=32,
                              cache_slots=int(c["cache_slots"]))


def _local_state(t, cfg):
    return {k: t.local(v).clone()
            for k, v in ht.init_cluster_state(cfg, device=CPU).items()}


def _wire(w):
    return {f: getattr(w, f).reshape(1) for f in (
        "round_trips", "messages", "ops", "req_bytes", "reply_bytes",
        "nic_hit_ops", "nic_penalty_us")}


def lookup_rank(rank, world, cases):
    """rpc_call inserts, then ``lookups`` rounds of hybrid_lookup, on a
    MeshTransport; with the plain probe's calls of each lookup."""
    calls = counting_probe()
    out = []
    for c in cases:
        cfg = hash_cfg(c)
        layout = ht.build_layout(cfg)
        t = MeshTransport(world)
        state = _local_state(t, cfg)
        klo, khi, vals = (t.local(words(c[k], CPU))
                          for k in ("klo", "khi", "vals"))
        node, _, _ = ht.lookup_start(cfg, layout, klo, khi)
        state, rep, _, _ = R.rpc_call(
            t, state, node, ht.make_record(R.OP_INSERT, klo, khi, value=vals),
            ht.make_rpc_handler(cfg, layout))
        cache = (None if cfg.cache_slots == 0
                 else ht.init_cache(cfg, 1, device=CPU))
        r = dict(rep0=rep[..., 0], looks=[])
        for _ in range(int(c["lookups"])):
            before = calls[0]
            state, cache, found, value, version, _, slot, ovf, m = \
                hy.hybrid_lookup(t, state, klo, khi, cfg, layout, cache=cache)
            r["looks"].append(dict(
                found=found, value=value, version=version, slot=slot,
                overflow=ovf, probes=calls[0] - before,
                onesided_success=m.onesided_success.reshape(1),
                rpc_fallback=m.rpc_fallback.reshape(1),
                total=m.total.reshape(1), **_wire(m.wire)))
        r["arena"] = state["arena"]
        out.append(r)
    return out


def tx_inputs(t, c):
    g = lambda k: t.local(torch.from_numpy(c[k]))
    w = lambda k: t.local(words(c[k], CPU))
    return dict(read_keys=w("rk"), write_keys=w("wk"), write_values=w("wv"),
                read_enabled=g("ren"), write_enabled=g("wen"))


def tx_run(t, c):
    """Insert the key pool, then one run_transactions batch."""
    cfg = hash_cfg(c)
    layout = ht.build_layout(cfg)
    state = _local_state(t, cfg)
    plo, phi, pval = (t.local(words(c[k], CPU))
                      for k in ("pool_lo", "pool_hi", "pool_val"))
    pnode, _, _ = ht.lookup_start(cfg, layout, plo, phi)
    state, _, _, _ = R.rpc_call(
        t, state, pnode, ht.make_record(R.OP_INSERT, plo, phi, value=pval),
        ht.make_rpc_handler(cfg, layout))
    cap = int(c["capacity"])
    state, _, res = tx.run_transactions(
        t, state, cfg, layout, use_onesided=bool(c["use_onesided"]),
        capacity=None if cap < 0 else cap, fused=bool(c["fused"]),
        **tx_inputs(t, c))
    return state, res


def tx_rank(rank, world, cases):
    calls = counting_probe()
    out = []
    for c in cases:
        before = calls[0]
        state, res = tx_run(MeshTransport(world), c)
        m = res.metrics
        out.append(dict(
            arena=state["arena"], committed=res.committed,
            read_found=res.read_found, read_values=res.read_values,
            aborted_lock=res.aborted_lock,
            aborted_validate=res.aborted_validate,
            aborted_overflow=res.aborted_overflow,
            aborted_stale=res.aborted_stale,
            round_trips=res.round_trips.reshape(1),
            onesided_success=m.onesided_success.reshape(1),
            rpc_fallback=m.rpc_fallback.reshape(1), total=m.total.reshape(1),
            probes=calls[0] - before,
            **{"wire_" + k: v for k, v in _wire(m.wire).items()}))
    return out


def branch_rank(rank, world, shape, cases):
    """The sharded branches on a (data, model) mesh of ``shape``: each case
    cuts this rank's blocks of its global inputs and returns the rank's
    output block with its mesh coordinate."""
    from repro_torch.configs.registry import get
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import embedding as E
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import Topology
    from repro_torch.serving import decode as D
    topo = Topology(make_mesh(shape, ("data", "model"), CPU))
    out = []
    for c in cases:
        a = {k: torch.from_numpy(v) for k, v in c.items()
             if isinstance(v, np.ndarray) and v.dtype != np.str_}
        b = topo.block
        if c["kind"] == "embed":
            y = E.embed_lookup(topo, b(a["table"], "vocab", None),
                               b(a["tokens"], "batch", None),
                               mode=str(c["mode"]),
                               vocab=a["table"].shape[0])
        elif c["kind"] == "decode":
            cfg = get(str(c["arch"])).smoke()
            if int(c["n_kv_heads"]) != cfg.n_kv_heads:
                import dataclasses
                cfg = dataclasses.replace(cfg, n_kv_heads=int(c["n_kv_heads"]))
            kv_ax = (("batch", None, "kv_heads", None) if c["mode"] == "heads"
                     else ("batch", "kv_seq", None, None))
            q_ax = (("batch", "heads", None) if c["mode"] == "heads"
                    else ("batch", None, None))
            w = int(c["window"])
            y = D.hybrid_decode_attention(
                cfg, topo, b(a["q"], *q_ax), b(a["kc"], *kv_ax),
                b(a["vc"], *kv_ax), b(a["lens"], "batch"),
                window=None if w < 0 else w, mode=str(c["mode"]))
        else:
            cfg = get(str(c["arch"])).smoke()
            mode = str(c["mode"])
            w_ax = ((None, None, None) if mode == "replicated"
                    else ("expert", None, None))
            x = b(a["x"], "batch", None, None)
            y = moe.moe_ffn(cfg, topo, x, a["router"], b(a["wg"], *w_ax),
                            b(a["wu"], *w_ax), b(a["wd"], *w_ax), mode=mode)
            y = (y, moe.moe_dispatch_mode(cfg, topo,
                                          x.shape[0] * x.shape[1]))
        out.append((topo.coordinate(), y))
    return out


def nccl_rank(rank, world):
    """World size 1 over NCCL on the card: a gate-sized insert,
    hybrid_lookup and one run_transactions batch on MeshTransport(1),
    against the same on SimTransport(1)."""
    from repro_torch.launch.mesh import make_smoke_mesh
    make_smoke_mesh("cuda")
    c = lookup_case_1()
    got, want = {}, {}
    for t, out in ((MeshTransport(1), got), (SimTransport(1), want)):
        cfg = hash_cfg(c)
        layout = ht.build_layout(cfg)
        state = {k: v.cuda() for k, v in _local_state(t, cfg).items()}
        klo, khi, vals = (words(c[k], "cuda") for k in ("klo", "khi", "vals"))
        node, _, _ = ht.lookup_start(cfg, layout, klo, khi)
        state, rep, _, _ = R.rpc_call(
            t, state, node, ht.make_record(R.OP_INSERT, klo, khi, value=vals),
            ht.make_rpc_handler(cfg, layout))
        state, _, found, value, *_ = hy.hybrid_lookup(t, state, klo, khi, cfg,
                                                      layout)
        out.update(rep=rep.cpu(), found=found.cpu(), value=value.cpu(),
                   arena=state["arena"].cpu())
    return got, want


def lookup_case_1():
    rng = np.random.RandomState(0)
    u = lambda shape, hi: rng.randint(0, hi, size=shape,
                                      dtype=np.uint64).astype(np.uint32)
    return dict(n_nodes=1, cache_slots=0, klo=u((1, 64), 2**31),
                khi=u((1, 64), 2**31), vals=u((1, 64, 27), 2**32))


# --- tests/test_torch_mesh_protocol.py: the retry loops on the mesh ----------
LOOP_FIELDS = ("committed", "commit_round", "round_committed",
               "round_attempts", "round_retries", "round_abort_lock",
               "round_abort_validate", "round_abort_overflow",
               "round_abort_stale")
TX_READS = ("read_found", "read_values")
SCAN_READS = ("truncated", "scan_keys", "scan_values", "scan_mask")


def loop_fields(state, res, tel=None):
    """A loop's results as a flat dict on the CPU: the arena, the per-lane
    and per-round fields, round_trips, the hybrid counts and every WireStats
    field (scalars as (1,) tensors), and the trace where traced."""
    reads = TX_READS if hasattr(res, "read_found") else SCAN_READS
    m = res.metrics
    out = {k: getattr(res, k) for k in LOOP_FIELDS + reads}
    out.update(arena=state["arena"], round_trips=res.round_trips.reshape(1),
               onesided_success=m.onesided_success.reshape(1),
               rpc_fallback=m.rpc_fallback.reshape(1),
               total=m.total.reshape(1),
               **{"wire_" + k: v for k, v in _wire(m.wire).items()})
    if tel is not None:
        from repro_torch.core import telemetry as T
        out.update(trace_rows=tel.trace.rows, trace_n=tel.trace.n,
                   trace_dropped=tel.trace.dropped,
                   lane_latency_us=tel.lane_latency_us,
                   trace_events=len(T.export_trace(tel.trace)["traceEvents"]))
    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                else v) for k, v in out.items()}


def loop_hash_cfg(c):
    return ht.HashTableConfig(n_nodes=int(c["n_nodes"]), n_buckets=32,
                              bucket_width=2, n_overflow=32)


def pooled(t, c, device=CPU):
    """The hash table with the key pool inserted by rpc_call: (cfg, layout,
    state), the state the transport's shard of it."""
    cfg = loop_hash_cfg(c)
    layout = ht.build_layout(cfg)
    state = {k: t.local(v).clone()
             for k, v in ht.init_cluster_state(cfg, device=device).items()}
    plo, phi, pval = (t.local(words(c[k], device))
                      for k in ("pool_lo", "pool_hi", "pool_val"))
    pnode, _, _ = ht.lookup_start(cfg, layout, plo, phi)
    state, _, _, _ = R.rpc_call(
        t, state, pnode, ht.make_record(R.OP_INSERT, plo, phi, value=pval),
        ht.make_rpc_handler(cfg, layout))
    return cfg, layout, state


def loop_batch(t, c, device=CPU):
    g = lambda k: t.local(torch.from_numpy(c[k])).to(device)
    w = lambda k: t.local(words(c[k], device))
    return dict(read_keys=w("rk"), write_keys=w("wk"), write_values=w("wv"),
                read_enabled=g("ren"), write_enabled=g("wen"))


def tx_loop_case(t, c, *, f, perms=None, traced=False, ptable=None,
                 capacity=None, device=CPU):
    """The pool inserted, then (with ``ptable``) the handed-off table
    installed from node 0, then tx_loop over the batch.  Returns
    loop_fields."""
    from repro_torch.core import placement as pl
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.replication import ReplicaConfig
    from repro_torch.testing import workloads as wl
    cfg, layout, state = pooled(t, c, device)
    kw = {}
    if ptable is not None:
        pcfg = pl.PlacementConfig(cfg.n_nodes, f=1)
        new = wl.handoff_table(pl.initial_table(pcfg, device=device),
                               int(c["handoff_part"]))
        state, _ = pl.install_table(t, state, layout, pcfg, new,
                                    ht.make_rpc_handler(cfg, layout),
                                    issuer=0)
        kw = dict(ptable=ptable, pcfg=pcfg)
    out = txl.tx_loop(
        t, state, cfg, layout, capacity=capacity,
        max_rounds=int(c["max_rounds"]), perms=perms,
        rep=ReplicaConfig(cfg.n_nodes, f),
        telemetry=T.TelemetryConfig() if traced else None, device=device,
        **loop_batch(t, c, device), **kw)
    return loop_fields(out[0], out[2], out[3] if traced else None)


def failover_case(t, c, arena, dead, only=None, device=CPU):
    """failover_lookup at f=1 of every write key of the batch from
    ``arena`` (the f=1 run's), node ``dead`` dead: its lanes issue nothing,
    its rank still enters every exchange.  ``only``: a node whose lanes
    alone are enabled."""
    from repro_torch.core import replication as repl
    cfg = loop_hash_cfg(c)
    N = cfg.n_nodes
    wk = t.local(words(c["wk"], device))
    klo, khi = (wk[..., i].reshape(wk.shape[0], -1) for i in (0, 1))
    en = (t.node_ids(device) != dead)[:, None].expand(klo.shape)
    if only is not None:
        en = en & (t.node_ids(device) == only)[:, None]
    alive = repl.kill_node(repl.all_alive(N, device=device), dead)
    r = repl.failover_lookup(t, {"arena": arena.clone()}, klo, khi, cfg,
                             ht.build_layout(cfg),
                             repl.ReplicaConfig(N, 1), alive, enabled=en)
    out = {k: v.cpu() for k, v in r.items() if k != "wire"}
    out.update({"wire_" + k: v for k, v in _wire(r["wire"]).items()})
    return out


def tree_of(t, c, device=CPU):
    from repro_torch.testing import workloads as wl
    return wl.build_tree(int(c["n_nodes"]), n_keys=int(c["tree_keys"]),
                         seed=int(c["tree_seed"]), t=t, device=device)


def scan_loop_case(t, c, tree, *, f, perms=None, device=CPU):
    """scan_loop over the built tree (its directory fetched up front), the
    scan mix of the inputs."""
    from repro_torch.core import txloop as txl
    from repro_torch.core.replication import ReplicaConfig
    cfg, layout, _, state, _, _ = tree
    g = lambda k: t.local(torch.from_numpy(c[k])).to(device)
    w = lambda k: t.local(words(c[k], device))
    state = {"arena": state["arena"].clone()}
    state, _, res = txl.scan_loop(
        t, state, cfg, layout, scan_lo=w("scan_lo"), scan_hi=w("scan_hi"),
        meta=None, write_keys=w("scan_wk"), write_values=w("scan_wv"),
        write_enabled=g("scan_wen"), max_rounds=int(c["max_rounds"]),
        perms=perms, rep=ReplicaConfig(cfg.n_nodes, f), device=device)
    return loop_fields(state, res)


def sweeps_refused(t, c, device=CPU):
    """rereplicate and migrate_partition on a MeshTransport: the error each
    raises (None where it ran)."""
    from repro_torch.core import placement as pl
    cfg, layout, state = pooled(t, c, device)
    pcfg = pl.PlacementConfig(cfg.n_nodes, f=1)
    table = pl.initial_table(pcfg, device=device)
    out = []
    for run in (lambda: pl.rereplicate(t, state, cfg, layout, pcfg,
                                       [(0, 0, 2)]),
                lambda: pl.migrate_partition(t, state, cfg, layout, pcfg,
                                             table, 0, 2)):
        try:
            run()
            out.append(None)
        except ValueError as e:
            out.append(str(e))
    return out


def replicated_population(t, c, device=CPU):
    """``workloads.populate_replicated`` at f=1 through the initial
    placement table (write-only tx_loop batches, no read round) of
    ``rep_keys`` keys a node: the arena."""
    from repro_torch.core import placement as pl
    from repro_torch.core.replication import ReplicaConfig
    from repro_torch.testing import workloads as wl
    cfg = loop_hash_cfg(c)
    layout = ht.build_layout(cfg)
    state = {k: t.local(v).clone()
             for k, v in ht.init_cluster_state(cfg, device=device).items()}
    pcfg = pl.PlacementConfig(cfg.n_nodes, f=1)
    state, _ = wl.populate_replicated(
        cfg, layout, t, state, int(c["rep_keys"]),
        ReplicaConfig(cfg.n_nodes, 1), lanes=int(c["rep_keys"]) // 2,
        seed=9, ptable=pl.initial_table(pcfg, device=device), pcfg=pcfg,
        device=device)
    return state["arena"].clone()


def table_rows(c, name, rank):
    """A rank's own placement table of the per-rank tables ``name``."""
    from repro_torch.core import placement as pl
    return pl.PlacementTable(
        epoch=torch.tensor(int(c[name + "_epoch"][rank]), dtype=torch.int32),
        copies=torch.from_numpy(c[name + "_copies"][rank]),
        alive=torch.from_numpy(c[name + "_alive"][rank]))


def loops_rank(rank, world, c, perms):
    """Every case of the protocol world on MeshTransport(world), once fed
    the reference's per-shard draws ``perms`` (N, rounds, 1, B) and once
    with the default draws; plus the plain probe's calls per tx_loop and
    the membership sweeps' refusals."""
    calls = counting_probe()
    t = MeshTransport(world)
    out = {"sweeps": sweeps_refused(t, c),
           "rep_population": replicated_population(t, c)}
    cap = int(c["capacity"])
    for mode, pm in (("fed", torch.from_numpy(perms[rank])), ("default",
                                                               None)):
        r = out[mode] = {}
        for name, f, traced in (("tx0", 0, False), ("tx1", 1, False),
                                ("tx1traced", 1, True)):
            before = calls[0]
            r[name] = tx_loop_case(t, c, f=f, perms=pm, traced=traced,
                                   capacity=cap)
            r[name]["probes"] = calls[0] - before
        for name in ("stale", "stale_some"):
            if mode == "default" and name == "stale_some":
                continue
            for traced in (False, True):
                r[name + "traced" * traced] = tx_loop_case(
                    t, c, f=1, perms=pm, traced=traced,
                    ptable=table_rows(c, name, rank))
        for dead in range(world):
            before = calls[0]
            r[f"fo{dead}"] = failover_case(t, c, r["tx1"]["arena"], dead)
            r[f"fo{dead}"]["probes"] = calls[0] - before
        tree = tree_of(t, c)
        r["tree_arena"] = tree[3]["arena"].clone()
        for name, f in (("scan0", 0), ("scan1", 1)):
            r[name] = scan_loop_case(t, c, tree, f=f, perms=pm)
    return out
