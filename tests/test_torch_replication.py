"""PyTorch port, primary-backup replication (``repro_torch.core.replication``
and the ``rep=`` paths of ``tx`` / ``txloop``) — the counterparts of
``tests/test_replication.py``, each held bit for bit against the JAX package
from the same numpy inputs: results, abort causes, WireStats, round trips,
arenas and fail-over reads.  Retry rounds are fed the reference's own
backoff permutations.  Also the bench gate's ``replication`` keys and the
committed-version wrap."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import placement as jpl  # noqa: E402
from repro.core import replication as jrepl  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import tx as jtx  # noqa: E402
from repro.core import txloop as jtxl  # noqa: E402
from repro.core.datastructs import btree as jbt  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro.testing.workloads import value_for as jvalue_for  # noqa: E402
from repro_torch.convert import state_to_numpy, to_numpy, words  # noqa: E402
from repro_torch.core import hybrid as phy  # noqa: E402
from repro_torch.core import onesided as posd  # noqa: E402
from repro_torch.core import placement as ppl  # noqa: E402
from repro_torch.core import replication as repl  # noqa: E402
from repro_torch.core import rpc as PR  # noqa: E402
from repro_torch.core import tx as ptx  # noqa: E402
from repro_torch.core import txloop as ptxl  # noqa: E402
from repro_torch.core.datastructs import btree as pbt  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.testing import workloads as pwl  # noqa: E402
from tests.test_btree import walk_leaves  # noqa: E402
from tests.test_replication import (assert_replicas_byte_equal,  # noqa: E402
                                    make_workload)
from tests.test_torch_btree import same  # noqa: E402
from tests.test_torch_txloop import jax_perms  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
N = 4
KW = dict(n_nodes=N, n_buckets=16, bucket_width=2, n_overflow=64,
          max_chain=10)
JCFG, PCFG = jht.HashTableConfig(**KW), pht.HashTableConfig(**KW)
JL, PL = jht.build_layout(JCFG), pht.build_layout(PCFG)
_JIT = {}


def jrep(f, pathological=False):
    return jrepl.ReplicaConfig(N, f, placement=(
        (lambda p, i, n: jnp.zeros_like(p)) if pathological else None))


def prep(f, pathological=False):
    return repl.ReplicaConfig(N, f, placement=(
        (lambda p, i, n: torch.zeros_like(p)) if pathological else None))


def j_call(name, make, *args):
    """A jitted JAX call, compiled once per ``name`` and shape."""
    if name not in _JIT:
        _JIT[name] = jax.jit(make())
    return _JIT[name](*args)


def populated(klo, khi):
    """The table with (klo, khi) inserted, in both packages (klo, khi numpy
    (N, K))."""
    def make():
        h = jht.make_rpc_handler(JCFG, JL)

        def ins(st, lo, hi):
            node, _, _ = jht.lookup_start(JCFG, JL, lo, hi)
            return JR.rpc_call(JSim(N), st, node, jht.make_record(
                JR.OP_INSERT, lo, hi, value=jvalue_for(lo)), h)
        return ins
    js, rep, _, _ = j_call(("insert", klo.shape), make,
                           jht.init_cluster_state(JCFG), jnp.asarray(klo),
                           jnp.asarray(khi))
    assert (np.asarray(rep[..., 0]) == JR.ST_OK).all()
    ps = pht.init_cluster_state(PCFG, device=CPU)
    lo, hi = words(klo, CPU), words(khi, CPU)
    node, _, _ = pht.lookup_start(PCFG, PL, lo, hi)
    ps, _, _, _ = PR.rpc_call(PSim(N), ps, node, pht.make_record(
        PR.OP_INSERT, lo, hi, value=pwl.value_for(lo)),
        pht.make_rpc_handler(PCFG, PL))
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    return js, ps


def run_both(js, ps, rk, wk, wv, *, f=None, fused=True, capacity=None,
             pathological=False, **kw):
    """run_transactions through both packages (the port on a clone);
    everything must agree.  Returns (JAX state, port state, port result)."""
    def make():
        rep = None if f is None else jrep(f, pathological)
        return lambda st, rk, wk, wv: jtx.run_transactions(
            JSim(N), st, JCFG, JL, read_keys=rk, write_keys=wk,
            write_values=wv, fused=fused, capacity=capacity, rep=rep, **kw)
    js2, _, jres = j_call(("run", f, fused, capacity, pathological, rk.shape,
                           wk.shape), make, js, *(jnp.asarray(x)
                                                  for x in (rk, wk, wv)))
    ps2, _, pres = ptx.run_transactions(
        PSim(N), {"arena": ps["arena"].clone()}, PCFG, PL,
        read_keys=words(rk, CPU), write_keys=words(wk, CPU),
        write_values=words(wv, CPU), fused=fused, capacity=capacity,
        rep=None if f is None else prep(f, pathological))
    same(pres, jres, f"run_transactions f={f} fused={fused}")
    np.testing.assert_array_equal(state_to_numpy(ps2)["arena"],
                                  np.asarray(js2["arena"]))
    return js2, ps2, pres


def loop_both(js, ps, rk, wk, wv, *, max_rounds, f=None, capacity=None,
              pathological=False):
    """tx_loop through both packages, the port fed the reference's
    permutations.  Returns (JAX state, port state, port result)."""
    def make():
        rep = None if f is None else jrep(f, pathological)
        return lambda st, rk, wk, wv: jtxl.tx_loop(
            JSim(N), st, JCFG, JL, read_keys=rk, write_keys=wk,
            write_values=wv, capacity=capacity, max_rounds=max_rounds,
            rep=rep)
    js2, _, jres = j_call(("loop", f, capacity, pathological, max_rounds,
                           rk.shape, wk.shape), make, js,
                          *(jnp.asarray(x) for x in (rk, wk, wv)))
    B = rk.shape[1]
    ps2, _, pres = ptxl.tx_loop(
        PSim(N), {"arena": ps["arena"].clone()}, PCFG, PL,
        read_keys=words(rk, CPU), write_keys=words(wk, CPU),
        write_values=words(wv, CPU), capacity=capacity,
        max_rounds=max_rounds, rep=None if f is None else prep(f, pathological),
        perms=torch.from_numpy(jax_perms(jax.random.PRNGKey(0x5707),
                                         max_rounds, N, B)), device=CPU)
    same(pres, jres, f"tx_loop f={f}")
    np.testing.assert_array_equal(state_to_numpy(ps2)["arena"],
                                  np.asarray(js2["arena"]))
    return js2, ps2, pres


def workload(seed, **kw):
    klo, khi, rk, wk, wv = make_workload(seed, **kw)
    return (np.asarray(klo), np.asarray(khi), np.asarray(rk), np.asarray(wk),
            np.asarray(wv))


def byte_equal(ps, f, wk, committed_item, pathological=False):
    return assert_replicas_byte_equal(
        state_to_numpy(ps), JCFG, JL, jrep(f, pathological), jnp.asarray(wk),
        committed_item)


# ---------------------------------------------------------------------------
# f = 0 is bit-identical to the unreplicated dataplane
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
def test_f0_bit_identical(fused):
    klo, khi, rk, wk, wv = workload(0)
    js, ps = populated(klo.reshape(N, -1), khi.reshape(N, -1))
    _, s_none, r_none = run_both(js, ps, rk, wk, wv, fused=fused)
    _, s_f0, r_f0 = run_both(js, ps, rk, wk, wv, fused=fused, f=0)
    assert torch.equal(s_none["arena"], s_f0["arena"])
    for fld in ("committed", "read_found", "read_values", "locked_values",
                "aborted_lock", "aborted_validate", "aborted_overflow",
                "round_trips"):
        assert torch.equal(getattr(r_none, fld), getattr(r_f0, fld)), fld
    for fld in ("round_trips", "messages", "ops", "req_bytes",
                "reply_bytes"):
        assert float(getattr(r_none.metrics.wire, fld)) == \
            float(getattr(r_f0.metrics.wire, fld)), fld


def test_f0_loop_bit_identical():
    klo, khi, rk, wk, wv = workload(1, B=6)
    js, ps = populated(klo.reshape(N, -1), khi.reshape(N, -1))
    _, s_a, a = loop_both(js, ps, rk, wk, wv, capacity=2, max_rounds=4)
    _, s_b, b = loop_both(js, ps, rk, wk, wv, capacity=2, max_rounds=4, f=0)
    assert torch.equal(a.committed, b.committed)
    assert torch.equal(a.commit_round, b.commit_round)
    assert torch.equal(s_a["arena"], s_b["arena"])
    assert float(a.round_trips) == float(b.round_trips)
    assert int(a.round_retries.sum()) > 0            # capacity 2 retries


# ---------------------------------------------------------------------------
# f >= 1: zero extra exchange rounds; fused/unfused equivalence holds
# ---------------------------------------------------------------------------
def test_f1_zero_extra_rounds():
    klo, khi, rk, wk, wv = workload(2)
    js, ps = populated(klo.reshape(N, -1), khi.reshape(N, -1))
    _, _, r0 = run_both(js, ps, rk, wk, wv)
    for f in (1, 2):
        _, _, rf = run_both(js, ps, rk, wk, wv, f=f)
        assert float(rf.round_trips) == float(r0.round_trips)
        assert torch.equal(rf.committed, r0.committed)
        extra = float(rf.metrics.wire.ops) - float(r0.metrics.wire.ops)
        assert extra == f * int(r0.committed.sum()) * wk.shape[2]


def test_fused_unfused_equivalence_with_replication():
    klo, khi, rk, wk, wv = workload(3)
    js, ps = populated(klo.reshape(N, -1), khi.reshape(N, -1))
    _, s_ref, ref = run_both(js, ps, rk, wk, wv, f=2, fused=False)
    _, s_fus, fus = run_both(js, ps, rk, wk, wv, f=2, fused=True)
    for fld in ("committed", "read_found", "read_values", "locked_values",
                "aborted_lock", "aborted_validate", "aborted_overflow"):
        assert torch.equal(getattr(ref, fld), getattr(fus, fld)), fld
    assert torch.equal(s_ref["arena"], s_fus["arena"])
    assert float(ref.metrics.wire.ops) == float(fus.metrics.wire.ops)
    assert float(fus.round_trips) <= float(ref.round_trips)


@pytest.mark.parametrize("seed,f,fused", [(0, 1, True), (1000, 2, False),
                                          (137, 1, False), (555, 2, True)])
def test_backup_copies_byte_equal(seed, f, fused):
    """Write keys are FRESH, so commits take the lock-insert placeholder
    path: every committed record's f copies equal the primary, word for
    word but next_ptr."""
    klo, khi, rk, wk, wv = workload(seed)
    js, ps = populated(klo[..., :2].reshape(N, -1),
                       khi[..., :2].reshape(N, -1))
    _, ps2, res = run_both(js, ps, rk, wk, wv, f=f, fused=fused)
    com_item = np.repeat(res.committed.numpy(), wk.shape[2], axis=-1)
    checked = byte_equal(ps2, f, wk, com_item)
    assert checked == int(res.committed.sum()) * wk.shape[2] > 0


def test_backup_overflow_aborts_and_retries():
    B, cap = 8, 2
    rng = np.random.RandomState(11)
    klo = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
    khi = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
    js, ps = populated(klo.reshape(N, -1), khi.reshape(N, -1))
    rk = np.zeros((N, B, 0, 2), np.uint32)
    wk = np.stack([klo, khi], -1)
    wv = np.asarray(jvalue_for(jnp.asarray(klo + 5)))
    _, ps1, single = run_both(js, ps, rk, wk, wv, f=1, capacity=cap,
                              pathological=True)
    assert int(single.aborted_overflow.sum()) > 0
    com = single.committed.numpy()
    assert byte_equal(ps1, 1, wk, com, pathological=True) == com.sum()
    _, psl, res = loop_both(js, ps, rk, wk, wv, f=1, capacity=cap,
                            max_rounds=10, pathological=True)
    assert bool(res.committed.all())
    assert int(res.round_abort_overflow[0]) > 0
    assert byte_equal(psl, 1, wk, np.ones((N, B, 1), bool),
                      pathological=True) == N * B


def test_replica_config_validates():
    with pytest.raises(ValueError):
        repl.ReplicaConfig(4, -1)
    with pytest.raises(ValueError):
        repl.ReplicaConfig(4, 4)
    assert repl.ReplicaConfig(4, 3).n_copies == 4
    p = torch.arange(4, dtype=torch.int32)
    for f in (1, 2, 3):
        for i in range(f + 1):
            np.testing.assert_array_equal(
                repl.ReplicaConfig(4, f).replica_of(p, i).numpy(),
                np.asarray(jrepl.ReplicaConfig(4, f).replica_of(
                    jnp.arange(4, dtype=jnp.int32), i)))


@pytest.mark.parametrize("lock_version", [0, 1, 2, 0x7FFFFFFF, 0x80000000,
                                          0xFFFFFFFD, 0xFFFFFFFE, 0xFFFFFFFF])
def test_committed_version(lock_version):
    """(v | 1) + 1 in 32 bits: 0xFFFFFFFE and 0xFFFFFFFF both wrap to 0."""
    want = np.asarray(jrepl.committed_version(jnp.uint32(lock_version)))
    got = repl.committed_version(words(np.uint32(lock_version), CPU))
    assert to_numpy(got) == want
    if lock_version >= 0xFFFFFFFE:
        assert int(want) == 0


# ---------------------------------------------------------------------------
# Failure injection: reads fail over to the first live replica
# ---------------------------------------------------------------------------
def failover_both(js, ps, klo, khi, alive_dead):
    jal = jrepl.all_alive(N)
    pal = repl.all_alive(N, device=CPU)
    for d in alive_dead:
        jal, pal = jrepl.kill_node(jal, d), repl.kill_node(pal, d)
    jout = jax.jit(lambda st, lo, hi, al: jrepl.failover_lookup(
        JSim(N), st, lo, hi, JCFG, JL, jrep(1), al))(
        js, jnp.asarray(klo), jnp.asarray(khi), jal)
    pout = repl.failover_lookup(PSim(N), ps, words(klo, CPU),
                                words(khi, CPU), PCFG, PL, prep(1), pal)
    same(pout, jout, "failover_lookup")
    return pout


def test_kill_node_reads_fail_over():
    B = 8
    rng = np.random.RandomState(21)
    klo = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
    khi = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
    wk = np.stack([klo, khi], -1)
    wv = np.asarray(jvalue_for(jnp.asarray(klo + 7)))
    js, ps, res = loop_both(jht.init_cluster_state(JCFG),
                            pht.init_cluster_state(PCFG, device=CPU),
                            np.zeros((N, B, 0, 2), np.uint32), wk, wv,
                            f=1, max_rounds=4)
    assert bool(res.committed.all())
    dead = 1
    js = dict(js, arena=js["arena"].at[dead].set(jnp.uint32(0xDEADBEEF)))
    ps["arena"][dead] = words(np.uint32(0xDEADBEEF), CPU)
    fl, fh = klo.reshape(N, B), khi.reshape(N, B)
    out = failover_both(js, ps, fl, fh, [dead])
    assert bool(out["found"].all()) and not out["dead_route"].any()
    np.testing.assert_array_equal(to_numpy(out["value"]),
                                  wv.reshape(N, B, -1))
    home = pht.home_of(PCFG, words(fl, CPU), words(fh, CPU))[0].numpy()
    served = out["node"].numpy()
    assert (served[home == dead] == (dead + 1) % N).all()
    assert (served[home != dead] == home[home != dead]).all()
    out2 = failover_both(js, ps, fl, fh, [dead, (dead + 1) % N])
    dr = out2["dead_route"].numpy()
    np.testing.assert_array_equal(dr, home == dead)
    assert not out2["found"].numpy()[dr].any()


def test_failover_lookup_matches_hybrid_when_all_alive():
    rng = np.random.RandomState(31)
    klo = rng.randint(0, 2**31, (N, 6)).astype(np.uint32)
    khi = rng.randint(0, 2**31, (N, 6)).astype(np.uint32)
    js, ps = populated(klo, khi)
    out = failover_both(js, ps, klo, khi, [])
    _, _, found, value, version, node, _, _, _ = phy.hybrid_lookup(
        PSim(N), ps, words(klo, CPU), words(khi, CPU), PCFG, PL)
    for a, b in ((out["found"], found), (out["value"], value),
                 (out["node"], node), (out["version"], version)):
        assert torch.equal(a, b)
    assert bool(found.all())


# ---------------------------------------------------------------------------
# Ordered index under failure: kill a primary, serve from the backup tree
# ---------------------------------------------------------------------------
def btree_cluster(seed, n_per_node=6):
    """test_replication's replicated B-tree cluster, in both packages: every
    key committed through the f=1 scan-transaction path (scan_loop, the
    port fed the reference's permutations)."""
    bkw = dict(n_nodes=N, n_leaves=32, leaf_width=4)
    jcfg, pcfg = jbt.BTreeConfig(**bkw), pbt.BTreeConfig(**bkw)
    jl, pl = jbt.build_layout(jcfg), pbt.build_layout(pcfg)
    rng = np.random.RandomState(seed)
    wk = rng.randint(0, 2**32, (N, n_per_node, 1), dtype=np.uint32)
    wv = np.asarray(jvalue_for(jnp.asarray(wk)))
    off = np.zeros((N, n_per_node), bool)
    js, _, jres = jax.jit(lambda st: jtxl.scan_loop(
        JSim(N), st, jcfg, jl, scan_lo=jnp.asarray(wk[..., 0]),
        scan_hi=jnp.asarray(wk[..., 0]), scan_enabled=jnp.asarray(off),
        write_keys=jnp.asarray(wk), write_values=jnp.asarray(wv),
        max_rounds=10, rep=jrepl.ReplicaConfig(N, 1)))(
        jbt.init_cluster_state(jcfg))
    ps, _, pres = ptxl.scan_loop(
        PSim(N), pbt.init_cluster_state(pcfg, device=CPU), pcfg, pl,
        scan_lo=words(wk[..., 0], CPU), scan_hi=words(wk[..., 0], CPU),
        scan_enabled=torch.from_numpy(off), write_keys=words(wk, CPU),
        write_values=words(wv, CPU), max_rounds=10,
        rep=repl.ReplicaConfig(N, 1), perms=torch.from_numpy(jax_perms(
            jax.random.PRNGKey(0x5C0A), 10, N, n_per_node)), device=CPU)
    same(pres, jres, "scan_loop f=1")
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    assert bool(pres.committed.all())
    return dict(jcfg=jcfg, pcfg=pcfg, jl=jl, pl=pl, js=js, ps=ps,
                keys=wk[..., 0], wv=wv)


def test_btree_primary_death_point_lookups_from_backup_tree():
    c = btree_cluster(47)
    dead = 1
    js = dict(c["js"], arena=c["js"]["arena"].at[dead].set(
        jnp.uint32(0xDEAD)))
    ps = {"arena": c["ps"]["arena"].clone()}
    ps["arena"][dead] = 0xDEAD
    jtab = jpl.table_from_replica(jrepl.ReplicaConfig(N, 1),
                                  jrepl.kill_node(jrepl.all_alive(N), dead))
    ptab = ppl.table_from_replica(repl.ReplicaConfig(N, 1), repl.kill_node(
        repl.all_alive(N, device=CPU), dead))
    same(ptab, jtab, "table_from_replica")
    keys = c["keys"]
    jout = jax.jit(lambda st, k: jpl.failover_lookup(
        JSim(N), st, c["jcfg"], c["jl"], jtab, k, jnp.zeros_like(k),
        ds=jbt))(js, jnp.asarray(keys))
    pk = words(keys, CPU)
    pout = ppl.failover_lookup(PSim(N), ps, c["pcfg"], c["pl"], ptab, pk,
                               torch.zeros_like(pk), ds=pbt)
    same(pout, jout, "failover_lookup(ds=btree)")
    assert bool(pout["found"].all()) and not pout["dead_route"].any()
    np.testing.assert_array_equal(to_numpy(pout["value"]),
                                  c["wv"].reshape(N, -1, 27))
    home = pbt.home_of(c["pcfg"], pk).numpy()
    served = pout["node"].numpy()
    assert (served[home == dead] == (dead + 1) % N).all()
    assert (served[home != dead] == home[home != dead]).all()


def test_btree_primary_death_scans_from_backup_tree():
    c = btree_cluster(53)
    dead, backup = 1, 2
    ps = {"arena": c["ps"]["arena"].clone()}
    ps["arena"][dead] = 0xDEAD
    js = dict(c["js"], arena=c["js"]["arena"].at[dead].set(
        jnp.uint32(0xDEAD)))
    pmeta, pstats = pbt.refresh_backup_meta(PSim(N), ps, c["pcfg"], c["pl"])
    jmeta, jstats = jax.jit(lambda st: jbt.refresh_backup_meta(
        JSim(N), st, c["jcfg"], c["jl"]))(js)
    same((pmeta, pstats), (jmeta, jstats), "refresh_backup_meta")
    assert float(pstats.round_trips) == 1.0
    nleaf = int(to_numpy(pmeta["nleaf"])[0, backup])
    lo, hi = (int(to_numpy(x)) for x in pbt.partition_bounds(c["pcfg"], dead))
    offs = pbt.backup_leaf_offset(c["pcfg"], c["pl"], torch.arange(nleaf))
    buf, ovf, _ = posd.remote_read(
        PSim(N), ps["arena"], torch.full((N, nleaf), backup,
                                         dtype=torch.int32),
        offs.expand(N, nleaf), length=c["pcfg"].leaf_words)
    assert not ovf.any()
    p = pbt.parse_leaf(c["pcfg"], buf[0])
    ks, live = to_numpy(p["keys"]), p["live"].numpy()
    got = sorted(int(k) for k in ks[live] if lo <= int(k) <= hi)
    want = sorted(int(k) for k in c["keys"].reshape(-1) if lo <= int(k) <= hi)
    assert want and set(want) <= set(got)
    for n in range(N):
        if n != dead:
            assert pwl.fence_chain_keys(c["pcfg"], c["pl"], ps["arena"], n) \
                == walk_leaves(js, c["jcfg"], c["jl"], n)


@pytest.fixture(scope="module")
def bench_common():
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import common
    finally:
        sys.path.remove(bench_dir)
    return common


def test_gate_f1_keys_exact(bench_common):
    """The bench gate's replication keys, exact, with the f=1 run's arenas
    equal to the reference's (bench_gate._tx_smoke's f=1 tx_loop)."""
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())["replication"]
    runs = pwl.gate_tx_runs(device=CPU)
    keys = pwl.gate_tx_keys(runs["f0"][1], runs["f1"][1])
    state_f1 = runs["f1"][0]
    assert keys["replication"] == {"round_trips_f1": 4.0,
                                   "wire_bytes_tx_f1": 1031.12,
                                   "commit_rate_f1": 1.0}
    assert keys["replication"] == {k: baseline[k]
                                   for k in keys["replication"]}
    cfg = jht.HashTableConfig(n_nodes=4, n_buckets=256, bucket_width=1,
                              n_overflow=64, max_chain=8)
    lay = jht.build_layout(cfg)
    js, rk, wk, wv = bench_common.make_tx_workload(
        JSim(4), cfg, lay, jht.init_cluster_state(cfg), lanes=8, n_keys=64,
        seed=5)
    js1, _, _ = jax.jit(lambda st: jtxl.tx_loop(
        JSim(4), st, cfg, lay, read_keys=rk, write_keys=wk, write_values=wv,
        max_rounds=2, rep=jrepl.ReplicaConfig(4, 1)))(js)
    np.testing.assert_array_equal(state_to_numpy(state_f1)["arena"],
                                  np.asarray(js1["arena"]))
