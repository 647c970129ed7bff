"""Workload builders of the port: counterparts of ``benchmarks/common.py``'s
``populate`` / ``make_tx_workload``, of the TATP transaction draw in
``benchmarks/fig6_tatp.py``, of ``benchmarks/range_scan.py``'s
``build_tree`` / ``scan_workload``, of ``repro/testing/workloads.py``'s
``zipf_write_keys`` (the contention regime), and of the bench gate's replicated,
ordered and membership workloads, making the SAME ``np.random.RandomState``
draws in the same order, so a workload built here equals the reference's
word for word.  Every builder takes ``device=`` (default ``"cuda"``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import to_numpy, words
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.core.datastructs import btree as bt
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.device import resolve_device

POPULATE_BATCH = 64      # inserts per node per RPC round, as the reference
TREE_BATCH = 16          # B-tree inserts per node per RPC round, as the reference
SPAN = 4                 # range_scan.py: scans cover this many consecutive keys


def distinct_uint32(rng, n, lo=0, hi=2**32 - 2):
    """n DISTINCT uint32 keys uniform over [lo, hi) by randint + dedup (the
    reference's ``repro.testing.workloads.distinct_uint32``, same draws)."""
    out = np.array([], dtype=np.uint64)
    while out.size < n:
        draw = rng.randint(lo, hi, size=2 * n).astype(np.uint64)
        out = np.unique(np.concatenate([out, draw]))
    rng.shuffle(out)
    return out[:n].astype(np.uint32)


def value_for(key_lo):
    """Deterministic per-key slot value (VALUE_WORDS words)."""
    i = torch.arange(sl.VALUE_WORDS, dtype=torch.int32, device=key_lo.device)
    return sl._mix32(key_lo[..., None] + i)


def zipf_write_keys(n_nodes: int, lanes: int, *, n_hot: int = 4,
                    theta: float = 1.5, seed: int = 0, stride: int = 7919,
                    device="cuda"):
    """One write key per lane, Zipf(theta)-distributed over n_hot hot keys
    (Storm's contention regime: a few keys take most of the writes, so lock
    races abound), the reference's draw.  Returns (hot (n_hot,), key_lo
    (n_nodes, lanes, 1), key_hi same) int32 words on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    hot = (np.arange(n_hot, dtype=np.uint32) + 1) * np.uint32(stride)
    rank = np.arange(1, n_hot + 1, dtype=np.float64)
    p = 1.0 / rank ** theta
    p /= p.sum()
    pick = rng.choice(n_hot, size=(n_nodes, lanes, 1), p=p)
    klo = words(hot[pick], dev)
    return words(hot, dev), klo, torch.zeros_like(klo)


def skew_contention(max_rounds: int, *, theta: float = 1.2, seed: int = 11,
                    n_nodes: int = 4, lanes: int = 16, n_hot: int = 16,
                    perms=None, device="cuda"):
    """``benchmarks/skew_contention.py``'s ``run_config`` (its defaults are
    the smoke configuration): n_hot hot keys pre-inserted, then one
    Zipf(theta) write a lane (``zipf_write_keys``) through ``tx_loop`` at
    ``max_rounds`` (``perms``: its backoff permutations, the port's
    default draws when None).  Returns (state, TxLoopResult)."""
    from repro_torch.core import txloop
    from repro_torch.core.transport import SimTransport
    dev = resolve_device(device)
    cfg = ht.HashTableConfig(n_nodes=n_nodes, n_buckets=256, bucket_width=1,
                             n_overflow=64, max_chain=8)
    layout = ht.build_layout(cfg)
    t = SimTransport(n_nodes)
    hot, klo, khi = zipf_write_keys(n_nodes, lanes, n_hot=n_hot, theta=theta,
                                    seed=seed, device=dev)
    hk = hot[None].repeat(n_nodes, 1)
    hz = torch.zeros_like(hk)
    node, _, _ = ht.lookup_start(cfg, layout, hk, hz)
    state, _, _, _ = R.rpc_call(
        t, ht.init_cluster_state(cfg, device=dev), node,
        ht.make_record(R.OP_INSERT, hk, hz, value=value_for(hk)),
        ht.make_rpc_handler(cfg, layout))
    state, _, res = txloop.tx_loop(
        t, state, cfg, layout,
        read_keys=torch.zeros((n_nodes, lanes, 0, 2), dtype=torch.int32,
                              device=dev),
        write_keys=torch.stack([klo, khi], -1), write_values=value_for(klo),
        max_rounds=max_rounds, perms=perms, device=dev)
    return state, res


def _draw_keys(cfg, t, n_keys_per_node, seed, dev):
    """The cluster's (N, n) int32 key words from ``seed``, and this
    transport's rows of them: every rank of a MeshTransport draws the same
    keys.  Returns (klo, khi, mine_lo, mine_hi)."""
    rng = np.random.RandomState(seed)
    N = cfg.n_nodes
    klo = words(rng.randint(0, 2**31, (N, n_keys_per_node)), dev)
    khi = words(rng.randint(0, 2**31, (N, n_keys_per_node)), dev)
    return klo, khi, t.local(klo), t.local(khi)


def populate(cfg, layout, t, state, n_keys_per_node, seed=0, device="cuda"):
    """Insert n keys per node (RPC inserts from every node to the keys'
    homes, POPULATE_BATCH per node per round); returns (state, (klo, khi))
    with (N, n) int32 key words.  Every rank of a MeshTransport draws the
    same keys and inserts its own node's row."""
    dev = resolve_device(device)
    klo, khi, mine_lo, mine_hi = _draw_keys(cfg, t, n_keys_per_node, seed,
                                            dev)
    h = ht.make_rpc_handler(cfg, layout)
    for i in range(0, n_keys_per_node, POPULATE_BATCH):
        kl = mine_lo[:, i:i + POPULATE_BATCH]
        kh = mine_hi[:, i:i + POPULATE_BATCH]
        node, _, _ = ht.lookup_start(cfg, layout, kl, kh)
        state, _, _, _ = R.rpc_call(
            t, state, node,
            ht.make_record(R.OP_INSERT, kl, kh, value=value_for(kl)), h)
    return state, (klo, khi)


def populate_replicated(cfg, layout, t, state, n_keys_per_node, rep, *,
                        lanes=POPULATE_BATCH, seed=0, ptable=None, pcfg=None,
                        device="cuda"):
    """Insert n keys per node THROUGH the replicated commit path, as
    ``churn_populated`` (the reference's ``_populated_placement_cluster``)
    does: write-only ``tx_loop`` batches of ``lanes`` lanes a node at
    ``rep`` (and through ``ptable``, when given), so every key lands on its
    f+1 copies.  Keys are ``populate``'s draws; every rank of a
    MeshTransport commits its own node's row.  Returns (state, (klo, khi))
    with (N, n) int32 key words; raises RuntimeError where a key did not
    commit."""
    from repro_torch.core import txloop as txl

    dev = resolve_device(device)
    klo, khi, mine_lo, mine_hi = _draw_keys(cfg, t, n_keys_per_node, seed,
                                            dev)
    for i in range(0, n_keys_per_node, lanes):
        kl = mine_lo[:, i:i + lanes]
        kh = mine_hi[:, i:i + lanes]
        no_reads = torch.zeros(kl.shape + (0, 2), dtype=torch.int32,
                               device=dev)
        state, _, res = txl.tx_loop(
            t, state, cfg, layout, read_keys=no_reads,
            write_keys=torch.stack([kl, kh], -1)[:, :, None],
            write_values=value_for(kl)[:, :, None], max_rounds=2, rep=rep,
            ptable=ptable, pcfg=pcfg, device=dev)
        if not bool(res.committed.all()):
            raise RuntimeError("populate_replicated: a key did not commit")
    return state, (klo, khi)


def make_tx_workload(t, cfg, layout, state, *, lanes, n_keys, seed,
                     device="cuda"):
    """Populate the table and draw the deterministic one-read/one-write
    transaction batch per lane of the bench gate.

    Returns (state, read_keys (N, lanes, 1, 2), write_keys, write_values)."""
    dev = resolve_device(device)
    state, (klo, khi) = populate(cfg, layout, t, state, n_keys, seed=seed,
                                 device=dev)
    rng = np.random.RandomState(seed + 1)
    s = rng.randint(0, cfg.n_nodes, (cfg.n_nodes, lanes, 1))
    i = rng.randint(0, n_keys, (cfg.n_nodes, lanes, 1))
    lo, hi = klo.cpu().numpy(), khi.cpu().numpy()
    rk = torch.from_numpy(np.stack([lo[s, i], hi[s, i]], -1)).to(dev)
    wk = rk ^ sl.word(0x9E3779B9)          # disjoint write set
    wv = (sl._mix32(wk[..., 0] + (seed + 11))[..., None]
          .expand(wk.shape[:-1] + (sl.VALUE_WORDS,)).contiguous())
    return state, rk, wk, wv


def tatp_transactions(klo, khi, *, n_nodes, lanes, subscribers_per_node,
                      rng, rd=2, wr=1, device="cuda"):
    """One TATP batch (the 80/16/4 mix of ``fig6_tatp.draw_tx``): 80% read
    transactions (half of them read two rows), 16% updates and 4%
    inserts/deletes (1 write each; updates also read 1 row).

    klo/khi: (N, subscribers) populated key words; rng: the RandomState the
    reference draws from.  Returns (read_keys (N, L, rd, 2), write_keys
    (N, L, wr, 2), read_enabled, write_enabled, write_values)."""
    dev = resolve_device(device)
    lo, hi = klo.cpu().numpy(), khi.cpu().numpy()

    def pick(n):
        s = rng.randint(0, n_nodes, (n_nodes, lanes, n))
        i = rng.randint(0, subscribers_per_node, (n_nodes, lanes, n))
        return lo[s, i], hi[s, i]

    rl, rh = pick(rd)
    wl, wh = pick(wr)
    kind = rng.rand(n_nodes, lanes)
    is_read = kind < 0.80                 # read-only tx
    two_reads = kind < 0.40               # GET_NEW_DESTINATION-like
    read_en = np.ones((n_nodes, lanes, rd), bool)
    read_en[..., 1] = two_reads
    read_en[~is_read, 1] = False          # updates read 1 row
    write_en = np.repeat((~is_read)[..., None], wr, axis=-1)
    rk = torch.from_numpy(np.stack([rl, rh], -1)).to(dev)
    wk = torch.from_numpy(np.stack([wl, wh], -1)).to(dev)
    wvals = (sl._mix32(wk[..., 0] + 99)[..., None]
             .expand(wk.shape[:-1] + (sl.VALUE_WORDS,)).contiguous())
    return (rk, wk, torch.from_numpy(read_en).to(dev),
            torch.from_numpy(write_en).to(dev), wvals)


GATE_NODES, GATE_LANES, GATE_MAX_ROUNDS = 4, 8, 2


def gate_tx_runs(device="cuda"):
    """The bench gate's fused tx_loop workload (``bench_gate._tx_smoke``: 4
    nodes, 8 lanes, 256 buckets, 64 keys per node, seed 5, 2 rounds), run
    unreplicated and then, from the same populated state, at
    ``ReplicaConfig(4, 1)``.

    Returns a dict: ``t``, ``cfg``, ``layout``, the ``populated`` arenas
    (untouched), the loop's keyword arguments ``kw`` (the batch, the bound,
    the device) and the two runs' (final state, TxLoopResult) as ``f0`` and
    ``f1``."""
    from repro_torch.core import txloop as txl
    from repro_torch.core.replication import ReplicaConfig
    from repro_torch.core.transport import SimTransport

    dev = resolve_device(device)
    cfg = ht.HashTableConfig(n_nodes=GATE_NODES, n_buckets=256,
                             bucket_width=1, n_overflow=64, max_chain=8)
    layout = ht.build_layout(cfg)
    t = SimTransport(GATE_NODES)
    state = ht.init_cluster_state(cfg, device=dev)
    state, rk, wk, wv = make_tx_workload(t, cfg, layout, state,
                                         lanes=GATE_LANES, n_keys=64, seed=5,
                                         device=dev)
    populated = state["arena"].clone()
    kw = dict(read_keys=rk, write_keys=wk, write_values=wv,
              max_rounds=GATE_MAX_ROUNDS, device=dev)
    state, _, res = txl.tx_loop(t, state, cfg, layout, **kw)
    state1, _, res1 = txl.tx_loop(t, {"arena": populated.clone()}, cfg,
                                  layout, rep=ReplicaConfig(GATE_NODES, 1),
                                  **kw)
    return dict(t=t, cfg=cfg, layout=layout, populated=populated, kw=kw,
                f0=(state, res), f1=(state1, res1))


def gate_tx_keys(res, res1):
    """The gate's top-level keys ``round_trips`` / ``rt_round`` /
    ``commit_rate`` / ``wire_bytes_tx`` of the f=0 TxLoopResult, with the
    ``replication`` keys ``round_trips_f1`` / ``wire_bytes_tx_f1`` /
    ``commit_rate_f1`` of the f=1 one, rounded as ``bench_gate.collect``
    rounds them."""
    rounds_attempted = int((res.round_attempts > 0).sum())
    n_tx = GATE_NODES * GATE_LANES
    return {
        "round_trips": float(res.round_trips),
        "rt_round": round(float(res.round_trips) / max(rounds_attempted, 1), 4),
        "commit_rate": round(float(res.committed.float().mean()), 4),
        "wire_bytes_tx": round(float(res.metrics.wire.total_bytes) / n_tx, 2),
        "replication": {
            "round_trips_f1": float(res1.round_trips),
            "wire_bytes_tx_f1": round(
                float(res1.metrics.wire.total_bytes) / n_tx, 2),
            "commit_rate_f1": round(float(res1.committed.float().mean()), 4),
        },
    }


# ---------------------------------------------------------------------------
# The ordered index: benchmarks/range_scan.py's tree and scan mixes
# ---------------------------------------------------------------------------
def build_tree(n_nodes, *, n_keys=48, seed=3, batch=TREE_BATCH, t=None,
               device="cuda"):
    """``range_scan.build_tree``: a B-tree of n_nodes x n_keys distinct keys
    (``leaf_width`` 4, ``n_leaves`` 2 x n_keys, ``max_scan_leaves`` 8),
    inserted by OP_BT_INSERT RPCs from every node to the keys' homes,
    ``batch`` per node per round (the reference's 16 by default; the tree's
    layout depends on it), then a refreshed separator cache.

    ``t``: the transport (default ``SimTransport(n_nodes)``).  Every rank of
    a MeshTransport draws the same keys and inserts its own node's row, so
    its state and directory cache are its rows of the simulator's.

    Returns (cfg, layout, t, state, allk, meta); ``allk`` is the sorted key
    array (numpy uint64)."""
    from repro_torch.core.transport import SimTransport

    dev = resolve_device(device)
    cfg = bt.BTreeConfig(n_nodes=n_nodes, n_leaves=2 * n_keys, leaf_width=4,
                         max_scan_leaves=8)
    layout = bt.build_layout(cfg)
    t = SimTransport(n_nodes) if t is None else t
    state = {k: t.local(v).clone()
             for k, v in bt.init_cluster_state(cfg, device=dev).items()}
    rng = np.random.RandomState(seed)
    allk = np.sort(distinct_uint32(rng, n_nodes * n_keys).astype(np.uint64))
    h = bt.make_rpc_handler(cfg, layout)
    flat = allk.astype(np.uint32)
    rng.shuffle(flat)
    per = t.local(words(flat.reshape(n_nodes, n_keys), dev))
    for i in range(0, n_keys, batch):
        k = per[:, i:i + batch]
        state, rep, _, _ = R.rpc_call(
            t, state, bt.home_of(cfg, k),
            bt.make_record(W.OP_BT_INSERT, k, torch.zeros_like(k),
                           value=value_for(k)), h)
        if not bool((rep[..., 0] == W.ST_OK).all()):
            raise RuntimeError("build_tree: an insert failed")
    meta, _ = bt.refresh_meta(t, state, cfg, layout)
    return cfg, layout, t, state, allk, meta


def scan_workload(allk, n_nodes, lanes, *, scan_frac, seed, theta=0.0,
                  device="cuda"):
    """``range_scan.scan_workload``: ``scan_frac`` of the lanes scan SPAN
    consecutive keys (start Zipf(theta)-skewed over the key array; 0 =
    uniform), the rest upsert a fresh gap key.  Returns (lo (N, B), hi,
    write_keys (N, B, 1), write_enabled (N, B, 1)) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    M = len(allk) - SPAN - 1
    if theta > 0:
        rank = np.arange(1, M + 1, dtype=np.float64)
        p = 1.0 / rank ** theta
        p /= p.sum()
        starts = rng.choice(M, (n_nodes, lanes), p=p)
    else:
        starts = rng.randint(0, M, (n_nodes, lanes))
    lo = allk[starts]
    hi = allk[starts + SPAN - 1]
    is_scan = rng.rand(n_nodes, lanes) < scan_frac
    g = rng.randint(0, len(allk) - 1, (n_nodes, lanes))
    wk = (allk[g] + np.maximum((allk[g + 1] - allk[g]) // 2, 1)).astype(
        np.uint64)
    return (words(np.where(is_scan, lo, 1), dev),
            words(np.where(is_scan, hi, 0), dev),
            words(wk, dev)[..., None],
            torch.from_numpy(~is_scan)[..., None].to(dev))


def gate_ordered_runs(device="cuda"):
    """The bench gate's ordered workload (``range_scan.gate_numbers``): a
    fused pure scan over a fresh directory (``check_schedule_claims``: 4
    nodes x 48 keys, tree seed 5, scans seed 9), then the scan-heavy mix
    (scan_frac 0.9, seed 7) through scan_loop with 2 rounds.  Returns (the
    pure scan's ScanTxResult, the tree's state after the loop, the loop's
    ScanLoopResult)."""
    from repro_torch.core import tx as txm
    from repro_torch.core import txloop as txl

    cfg, layout, t, state, allk, meta = build_tree(GATE_NODES, seed=5,
                                                   device=device)
    lo, hi, _, _ = scan_workload(allk, GATE_NODES, GATE_LANES, scan_frac=1.0,
                                 seed=9, device=device)
    _, res_f = txm.run_scan_transactions(t, state, cfg, layout, scan_lo=lo,
                                         scan_hi=hi, meta=meta)
    lo, hi, wk, wen = scan_workload(allk, GATE_NODES, GATE_LANES,
                                    scan_frac=0.9, seed=7, device=device)
    state, _, res = txl.scan_loop(
        t, state, cfg, layout, scan_lo=lo, scan_hi=hi, meta=meta,
        write_keys=wk, write_values=value_for(wk), write_enabled=wen,
        max_rounds=2, device=device)
    return res_f, state, res


def gate_ordered_keys(res_f, res):
    """The gate's ``ordered`` protocol keys of :func:`gate_ordered_runs`:
    ``scan_round_trips`` of the pure scan and ``commit_rate`` of the mix,
    as ``range_scan.gate_numbers`` rounds them."""
    return {"scan_round_trips": float(res_f.round_trips),
            "commit_rate": round(float(res.committed.float().mean()), 4)}


def fence_chain_keys(cfg, layout, arena, node):
    """Check node ``node``'s primary tree (``arena`` its cluster arenas) and
    return its keys in chain order.  Checked, as ``tests/test_btree.py``'s
    ``walk_leaves`` walks them from leaf 0: the right-links visit every
    allocated leaf once, in fence order; the fences tile the node's
    partition with no gap or overlap; the separator directory holds each
    leaf's low fence; every leaf is stable (even version) and unlocked; its
    records are sorted and inside its fences.  Raises AssertionError."""
    nleaf = int(to_numpy(arena[node, layout["nleaf"].base]))
    assert 1 <= nleaf <= cfg.n_leaves, f"node {node}: {nleaf} leaves"
    lv, sb = layout["leaves"].base, layout["sep"].base
    leaves = to_numpy(arena[node, lv:lv + nleaf * cfg.leaf_words]).astype(
        np.int64).reshape(nleaf, cfg.leaf_slots, sl.SLOT_WORDS)
    hdr = leaves[:, 0]
    flo, fhi = hdr[:, sl.KEY_LO], hdr[:, sl.KEY_HI]
    sep = to_numpy(arena[node, sb:sb + nleaf]).astype(np.int64)
    assert (sep == flo).all(), f"node {node}: directory out of sync"
    order = np.argsort(flo, kind="stable")
    lo, hi = (int(to_numpy(x)) for x in bt.partition_bounds(cfg, node))
    assert order[0] == 0 and flo[0] == lo, f"node {node}: chain start"
    assert (flo[order[1:]] == fhi[order[:-1]] + 1).all(), \
        f"node {node}: fence gap or overlap"
    assert fhi[order[-1]] == hi, f"node {node}: chain must end at {hi}"
    nxt = hdr[:, sl.NEXT_PTR]
    assert (nxt[order[:-1]] == order[1:]).all() and \
        nxt[order[-1]] == sl.MASK32, f"node {node}: right-links broken"
    assert (hdr[:, sl.VERSION] % 2 == 0).all() and \
        (hdr[:, sl.LOCK] == 0).all(), f"node {node}: unstable or locked leaf"
    count = hdr[:, sl.VALUE0]
    assert (count <= cfg.leaf_width).all()
    live = np.arange(cfg.leaf_width)[None] < count[:, None]
    keys = leaves[:, 1:, sl.KEY_LO]
    inside = (keys >= flo[:, None]) & (keys <= fhi[:, None])
    assert (inside | ~live).all(), f"node {node}: record outside its fences"
    ordered = keys[order][live[order]]
    assert (np.diff(ordered) > 0).all(), f"node {node}: records out of order"
    return ordered.tolist()


# ---------------------------------------------------------------------------
# Membership churn: benchmarks/membership_churn.py's events and gate keys
# ---------------------------------------------------------------------------
CHURN_NODES, CHURN_LANES, CHURN_MAX_ROUNDS = 4, 8, 2


def churn_cluster(seed=5, device="cuda"):
    """``membership_churn._cluster``: the bench gate's cluster and workload
    (4 nodes, 256 buckets, 64 keys per node, 8 lanes).  Returns (cfg,
    layout, t, state, read_keys, write_keys, write_values)."""
    from repro_torch.core.transport import SimTransport

    cfg = ht.HashTableConfig(n_nodes=CHURN_NODES, n_buckets=256,
                             bucket_width=1, n_overflow=64, max_chain=8)
    layout = ht.build_layout(cfg)
    t = SimTransport(CHURN_NODES)
    state = ht.init_cluster_state(cfg, device=device)
    state, rk, wk, wv = make_tx_workload(t, cfg, layout, state,
                                         lanes=CHURN_LANES, n_keys=64,
                                         seed=seed, device=device)
    return cfg, layout, t, state, rk, wk, wv


def churn_steady_state(device="cuda"):
    """The gate workload at f=1 with and without the identity placement
    table: identical rounds, no stale abort, equal commits."""
    from repro_torch.core import placement as pl
    from repro_torch.core import txloop as txl
    from repro_torch.core.replication import ReplicaConfig

    cfg, layout, t, state, rk, wk, wv = churn_cluster(device=device)
    rep = ReplicaConfig(CHURN_NODES, 1)
    pcfg = pl.PlacementConfig(CHURN_NODES, f=1)
    kw = dict(read_keys=rk, write_keys=wk, write_values=wv,
              max_rounds=CHURN_MAX_ROUNDS, rep=rep, device=device)
    _, _, res0 = txl.tx_loop(t, {"arena": state["arena"].clone()}, cfg,
                             layout, **kw)
    _, _, res1 = txl.tx_loop(t, state, cfg, layout,
                             ptable=pl.initial_table(pcfg, device=device),
                             pcfg=pcfg, **kw)
    rt0, rt1 = float(res0.round_trips), float(res1.round_trips)
    assert rt1 == rt0, \
        f"identity placement table must add ZERO exchange rounds ({rt0} -> {rt1})"
    assert int(res1.round_abort_stale.sum()) == 0, \
        "no stale-route aborts at a stable epoch"
    assert torch.equal(res0.committed, res1.committed)
    return dict(
        round_trips_stable=rt1, round_trips_rep_only=rt0,
        commit_rate_stable=round(float(res1.committed.float().mean()), 4),
        wire_bytes_stable=round(float(res1.metrics.wire.total_bytes)
                                / (CHURN_NODES * CHURN_LANES), 2))


def churn_refresh_cost(device="cuda"):
    """ONE one-sided read per table refresh; a gated-off refresh issues
    nothing."""
    from repro_torch.core import placement as pl

    cfg, layout, t, state, *_ = churn_cluster(device=device)
    pcfg = pl.PlacementConfig(CHURN_NODES, f=1)
    table = pl.initial_table(pcfg, device=device)
    _, stats = pl.refresh_table(t, state, layout, pcfg, table)
    _, s_off = pl.refresh_table(t, state, layout, pcfg, table, enabled=False)
    assert float(s_off.round_trips) == 0.0 and float(s_off.ops) == 0.0, \
        "a gated-off refresh must issue nothing"
    return dict(round_trips=float(stats.round_trips),
                bytes=float(stats.total_bytes))


def churn_populated(seed=5, perms=None, device="cuda"):
    """``_populated_placement_cluster``: the cluster with its write set
    committed through the replicated commit path at f=1 with placement
    routing (write-only lanes, 4 rounds; ``perms`` as tx_loop's).  Returns
    (cfg, layout, t, state, write_keys, write_values, rep, pcfg, table)."""
    from repro_torch.core import placement as pl
    from repro_torch.core import txloop as txl
    from repro_torch.core.replication import ReplicaConfig

    cfg, layout, t, state, rk, wk, wv = churn_cluster(seed=seed,
                                                      device=device)
    rep = ReplicaConfig(CHURN_NODES, 1)
    pcfg = pl.PlacementConfig(CHURN_NODES, f=1)
    table = pl.initial_table(pcfg, device=device)
    no_reads = torch.zeros((CHURN_NODES, CHURN_LANES, 0, 2), dtype=torch.int32,
                           device=wk.device)
    state, _, res = txl.tx_loop(
        t, state, cfg, layout, read_keys=no_reads, write_keys=wk,
        write_values=wv, max_rounds=4, rep=rep, ptable=table, pcfg=pcfg,
        perms=perms, device=device)
    assert bool(res.committed.all())
    return cfg, layout, t, state, wk, wv, rep, pcfg, table


def churn_kill_event(device="cuda"):
    """Fail node 1 at f=1: repair_plan + rereplicate restore the copy count;
    the re-replication bytes and the transfer count."""
    from repro_torch.core import placement as pl

    cfg, layout, t, state, wk, wv, rep, pcfg, table = churn_populated(
        device=device)
    dead = 1
    table = pl.kill_node(pcfg, table, dead)
    table, transfers = pl.repair_plan(pcfg, table)
    state["arena"][dead] = 0xDEAD
    state = pl.install_local(state, layout, pcfg, table,
                             nodes=[n for n in range(CHURN_NODES)
                                    if n != dead])
    state, s_rr = pl.rereplicate(t, state, cfg, layout, pcfg, transfers)
    return dict(rereplication_bytes=round(float(s_rr.total_bytes), 2),
                transfers=len(transfers))


def churn_stale_mix(perms=(None, None), device="cuda"):
    """Partition 0 migrates to node 3; clients still holding the pre-flip
    table run a write batch: partition 0's lanes are refused by the old
    owner in round 0 (stale_route), pay ONE refresh read in round 1 and
    commit.  ``perms``: tx_loop's permutations for the population and the
    batch.  Returns (numbers, final state, TxLoopResult)."""
    from repro_torch.core import placement as pl
    from repro_torch.core import txloop as txl

    cfg, layout, t, state, wk, wv, rep, pcfg, table = churn_populated(
        perms=perms[0], device=device)
    stale_table = table                       # the pre-flip client view
    table, state, _, ok = pl.migrate_partition(t, state, cfg, layout, pcfg,
                                               table, 0, 3)
    assert ok, "uncontended migration must succeed"
    wk2 = wk ^ sl.word(0x5DEECE66)
    no_reads = torch.zeros((CHURN_NODES, CHURN_LANES, 0, 2), dtype=torch.int32,
                           device=wk.device)
    state, _, res = txl.tx_loop(
        t, state, cfg, layout, read_keys=no_reads, write_keys=wk2,
        write_values=wv, max_rounds=3, rep=rep, ptable=stale_table, pcfg=pcfg,
        perms=perms[1], device=device)
    stale_r = res.round_abort_stale
    assert bool(res.committed.all()), \
        "stale clients must converge after one refresh"
    assert int(stale_r[0]) > 0, \
        "the flipped partition's lanes must abort stale_route in round 0"
    assert int(stale_r[1:].sum()) == 0, \
        "one refresh resolves every stale route"
    numbers = dict(
        abort_stale_round0=int(stale_r[0]),
        abort_lock=int(res.round_abort_lock.sum()),
        abort_validate=int(res.round_abort_validate.sum()),
        abort_overflow=int(res.round_abort_overflow.sum()),
        stale_rounds_to_converge=int(res.commit_round.max()) + 1,
        stale_round_trips=float(res.round_trips))
    return numbers, state, res


def handoff_table(table, part: int):
    """The placement table after partition ``part``'s owner hands it to its
    first backup: the partition's copy row rotated by one (the old owner
    stays on as the last backup), the epoch bumped.  Clients still holding
    ``table`` route the partition's lock-class ops to the old owner, which
    answers ST_WRONG_EPOCH once the new table is installed: a stale-route
    case that moves no data (at f >= 1 the backup already holds the
    partition's replicated records), so it runs on a MeshTransport too,
    where ``placement.migrate_partition`` does not."""
    from repro_torch.core import placement as pl

    row = [int(c) for c in table.copies[part].tolist() if c >= 0]
    if len(row) < 2:
        raise ValueError(f"partition {part} has no backup to hand over to")
    copies = table.copies.clone()
    copies[part, :len(row)] = torch.tensor(row[1:] + row[:1],
                                           dtype=copies.dtype,
                                           device=copies.device)
    return pl.PlacementTable(table.epoch + 1, copies, table.alive.clone())


def churn_fill_registry(reg, device="cuda"):
    """``membership_churn.fill_registry``: publish the membership bill —
    refresh reads, re-replication bytes, the stale-retry schedule and the
    epoch-stable baseline — to a telemetry.MetricsRegistry."""
    ss = churn_steady_state(device)
    rf = churn_refresh_cost(device)
    kl = churn_kill_event(device)
    sm, _, _ = churn_stale_mix(device=device)
    reg.set("membership.round_trips_stable", ss["round_trips_stable"])
    reg.set("membership.commit_rate_stable", ss["commit_rate_stable"])
    reg.set("membership.wire_bytes_stable", ss["wire_bytes_stable"])
    reg.incr("membership.refresh_reads_issued", rf["round_trips"])
    reg.set("membership.refresh_round_trips", rf["round_trips"])
    reg.set("membership.refresh_bytes", rf["bytes"])
    reg.set("membership.rereplication_bytes", kl["rereplication_bytes"])
    reg.incr("membership.rereplication_transfers", kl["transfers"])
    reg.set("membership.stale_round_trips", sm["stale_round_trips"])
    reg.incr("membership.stale_aborts_round0", sm["abort_stale_round0"])
    reg.set("membership.stale_rounds_to_converge",
            sm["stale_rounds_to_converge"])
    return reg


def gate_membership(registry=None, device="cuda"):
    """The bench gate's ``membership`` keys (``membership_churn.
    gate_numbers``), derived from the ``churn_fill_registry`` counters after
    its structural asserts: round_trips_stable, commit_rate_stable,
    refresh_round_trips, rereplication_bytes, stale_round_trips."""
    from repro_torch.core import telemetry as T

    reg = churn_fill_registry(registry if registry is not None
                              else T.MetricsRegistry(), device)
    assert reg.get("membership.refresh_round_trips") == 1.0, \
        "a table refresh is ONE one-sided read"
    assert reg.get("membership.stale_rounds_to_converge") <= 2.0, \
        "one refresh must resolve every stale route"
    return {k: reg.get(f"membership.{k}") for k in (
        "round_trips_stable", "commit_rate_stable", "refresh_round_trips",
        "rereplication_bytes", "stale_round_trips")}
