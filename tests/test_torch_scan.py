"""PyTorch port, range-scan transactions over the B-link tree
(``tx.run_scan_transactions``, ``txloop.scan_loop``) — the counterparts of
``tests/test_btree_scan_tx.py``, each held bit for bit against the JAX
package from the same numpy inputs: committed lanes, commit rounds, abort
causes, ``truncated``, ``scan_keys`` / ``scan_values`` / ``scan_mask``,
WireStats, round trips and arenas.  Retry rounds are fed the reference's
own backoff permutations.  Also the bench gate's ordered keys."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import txloop as jtxl  # noqa: E402
from repro.core.datastructs import btree as jbt  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro.testing.workloads import distinct_uint32  # noqa: E402
from repro_torch.convert import state_to_numpy, to_numpy, words  # noqa: E402
from repro_torch.core import tx as ptx  # noqa: E402
from repro_torch.core import txloop as ptxl  # noqa: E402
from repro_torch.core import wireproto as W  # noqa: E402
from repro_torch.core.datastructs import btree as pbt  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.replication import ReplicaConfig  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.testing import workloads as pwl  # noqa: E402
from tests.test_btree import node_keys  # noqa: E402
from tests.test_btree_scan_tx import mixed_workload  # noqa: E402
from tests.test_torch_btree import (World, jitted, same, scan_both,  # noqa: E402
                                    vals)
from tests.test_torch_txloop import jax_perms  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
N = 4
B = 4


@pytest.fixture(scope="module")
def populated():
    """test_btree_scan_tx's populated tree, in both packages: 48 keys, a
    fresh directory and scans of 6 keys each."""
    w = World(n_leaves=32, max_scan_leaves=4)
    rng = np.random.RandomState(17)
    allk = np.sort(distinct_uint32(rng, N * 12).astype(np.uint64))
    keys = allk.reshape(N, 12).astype(np.uint32)
    assert (w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))[..., 0]
            == W.ST_OK).all()
    starts = rng.choice(len(allk) - 6, N * B, replace=False)
    lo = allk[starts].reshape(N, B).astype(np.uint32)
    hi = allk[starts + 5].reshape(N, B).astype(np.uint32)
    return w, allk, lo, hi


def mixed(allk, lo, hi):
    slo, shi, wk, wen = mixed_workload(allk, lo, hi)
    wk = np.asarray(wk)
    return (np.asarray(slo), np.asarray(shi),
            dict(write_keys=wk, write_values=vals(wk),
                 write_enabled=np.asarray(wen)))


def expected(allk, lo, hi):
    return sorted(int(k) for k in allk if lo <= k <= hi)


def test_pure_scan_matches_reference_and_costs_point_rounds(populated):
    w, allk, lo, hi = populated
    _, _, _, res = scan_both(w, lo, hi)
    assert res.committed.all() and res.scan_complete.all()
    assert not res.truncated.any()
    sk, sm = to_numpy(res.scan_keys), res.scan_mask.numpy()
    for n in range(N):
        for b in range(B):
            assert sorted(sk[n, b][sm[n, b]].tolist()) == expected(
                allk, lo[n, b], hi[n, b])
    sv = to_numpy(res.scan_values)
    np.testing.assert_array_equal(sv[sm], vals(sk)[sm])
    assert float(res.metrics.rpc_fallback) == 0.0
    # a read-only point transaction on the fast path takes as many rounds
    cfg = pht.HashTableConfig(n_nodes=N, n_buckets=64, n_overflow=8)
    lay = pht.build_layout(cfg)
    st = pht.init_cluster_state(cfg, device=CPU)
    k = words(np.arange(1, 9, dtype=np.uint32).reshape(N, 2), CPU)
    z = torch.zeros_like(k)
    node, _, _ = pht.lookup_start(cfg, lay, k, z)
    from repro_torch.core import rpc as PR
    st, _, _, _ = PR.rpc_call(PSim(N), st, node, pht.make_record(
        W.OP_INSERT, k, z, value=pwl.value_for(k)),
        pht.make_rpc_handler(cfg, lay))
    _, _, pt = ptx.run_transactions(
        PSim(N), st, cfg, lay, read_keys=torch.stack([k, z], -1)[:, :, None],
        write_keys=torch.zeros((N, 2, 0, 2), dtype=torch.int32),
        write_values=torch.zeros((N, 2, 0, 27), dtype=torch.int32))
    assert float(pt.metrics.rpc_fallback) == 0.0
    assert float(res.round_trips) == float(pt.round_trips) == 2.0


def test_fused_unfused_bit_identical(populated):
    w, allk, lo, hi = populated
    slo, shi, writes = mixed(allk, lo, hi)
    for args, kw in (((lo, hi), {}), ((slo, shi), writes)):
        _, _, s_ref, r_ref = scan_both(w, *args, fused=False, **kw)
        _, _, s_fus, r_fus = scan_both(w, *args, fused=True, **kw)
        for f in ("committed", "scan_keys", "scan_values", "scan_mask",
                  "scan_complete", "truncated", "locked_values",
                  "aborted_lock", "aborted_validate", "aborted_overflow"):
            assert torch.equal(getattr(r_ref, f), getattr(r_fus, f)), f
        assert torch.equal(s_ref["arena"], s_fus["arena"])
        assert float(r_ref.metrics.wire.ops) == float(r_fus.metrics.wire.ops)
        assert float(r_fus.round_trips) <= float(r_ref.round_trips)


def test_rep_none_equals_f0(populated):
    w, allk, lo, hi = populated
    slo, shi, writes = mixed(allk, lo, hi)
    for fused in (False, True):
        _, _, s_a, r_a = scan_both(w, slo, shi, fused=fused, **writes)
        _, _, s_b, r_b = scan_both(w, slo, shi, fused=fused, f=0, **writes)
        same(r_b, to_np(r_a), "f=0")
        assert torch.equal(s_a["arena"], s_b["arena"])


def to_np(res):
    """A port result's tensors as numpy (for ``same`` against a port run)."""
    import dataclasses
    return dataclasses.replace(res, **{
        f.name: (to_np(getattr(res, f.name))
                 if dataclasses.is_dataclass(getattr(res, f.name))
                 else to_numpy(getattr(res, f.name)))
        for f in dataclasses.fields(res)})


def test_f1_zero_extra_rounds_and_logical_copies(populated):
    w, allk, lo, hi = populated
    slo, shi, writes = mixed(allk, lo, hi)
    _, _, _, r0 = scan_both(w, slo, shi, **writes)
    _, _, s1, r1 = scan_both(w, slo, shi, f=1, **writes)
    assert float(r1.round_trips) == float(r0.round_trips)
    assert torch.equal(r1.committed, r0.committed)
    com_w = r1.committed.numpy() & writes["write_enabled"][..., 0]
    assert com_w.any()
    wkf = writes["write_keys"].reshape(N, B)
    pn = pbt.home_of(w.pcfg, words(wkf, CPU))
    rc = ReplicaConfig(N, 1)
    h = pbt.make_rpc_handler(w.pcfg, w.pl)
    from repro_torch.core import rpc as PR
    for dest in (pn, rc.replica_of(pn, 1)):
        _, rep, _, _ = PR.rpc_call(PSim(N), {"arena": s1["arena"].clone()},
                                   dest, pbt.make_record(
                                       W.OP_BT_LOOKUP, words(wkf, CPU),
                                       torch.zeros_like(pn)), h)
        rep = to_numpy(rep)
        assert (rep[..., 0][com_w] == W.ST_OK).all()
        np.testing.assert_array_equal(rep[..., 3:][com_w],
                                      writes["write_values"][..., 0, :][com_w])


def _loops(w, lo, hi, max_rounds, refresh=True, **kw):
    """scan_loop through both packages from ``w``'s states, the port fed
    the reference's backoff permutations; everything must agree."""
    names = tuple(sorted(kw))
    fn = jitted(("scan_loop", max_rounds, refresh) + names, w.jcfg, w.jl,
                lambda c, lay: (lambda st, lo, hi, meta, *a: jtxl.scan_loop(
                    JSim(c.n_nodes), st, c, lay, scan_lo=lo, scan_hi=hi,
                    meta=meta, max_rounds=max_rounds, refresh=refresh,
                    **dict(zip(names, a)))))
    js, jmeta, jres = fn(w.js, jnp.asarray(lo), jnp.asarray(hi),
                         jbt.local_meta(w.jcfg, w.jl, w.js),
                         *(jnp.asarray(kw[k]) for k in names))
    conv = lambda x: (torch.from_numpy(np.array(x)) if np.asarray(x).dtype
                      == bool else words(np.asarray(x), CPU))
    perms = jax_perms(jax.random.PRNGKey(0x5C0A), max_rounds, w.n,
                      lo.shape[1])
    ps = {"arena": w.ps["arena"].clone()}
    ps, pmeta, pres = ptxl.scan_loop(
        PSim(w.n), ps, w.pcfg, w.pl, scan_lo=conv(lo), scan_hi=conv(hi),
        meta=pbt.local_meta(w.pcfg, w.pl, ps), max_rounds=max_rounds,
        refresh=refresh, perms=torch.from_numpy(perms), device=CPU,
        **{k: conv(v) for k, v in kw.items()})
    same(pres, jres, "scan_loop")
    same(pmeta, jmeta, "meta")
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    return ps, pres


def test_scan_write_conflict_aborts_scanner_then_loop_converges():
    w = World(n_leaves=32, max_scan_leaves=8)
    rng = np.random.RandomState(23)
    allk = np.sort(distinct_uint32(rng, N * 8, 0, 2**31))
    keys = allk.reshape(N, 8)
    w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))
    lo = np.zeros((N, 1), np.uint32)
    hi = np.zeros((N, 1), np.uint32)
    lo[0, 0], hi[0, 0] = allk[0], allk[5]
    wkey = allk[2] + 1 if allk[2] + 1 != allk[3] else allk[2] + 2
    wk = np.zeros((N, 1, 1), np.uint32)
    wk[1, 0, 0] = wkey
    wen = np.zeros((N, 1, 1), bool)
    wen[1, 0, 0] = True
    writes = dict(write_keys=wk, write_values=vals(wk), write_enabled=wen)
    _, _, _, res = scan_both(w, lo, hi, **writes)
    assert res.committed[1, 0] and not res.committed[0, 0]
    assert res.aborted_validate[0, 0]
    _, resL = _loops(w, lo, hi, 4, **writes)
    assert resL.committed.all() and int(resL.round_abort_validate[0]) > 0
    got = sorted(to_numpy(resL.scan_keys)[0, 0][resL.scan_mask[0, 0].numpy()]
                 .tolist())
    assert got == sorted([int(k) for k in allk[:6]] + [int(wkey)])


def test_truncated_scan_reported_never_clipped():
    w = World(n_leaves=32, max_scan_leaves=4)
    p_lo = 0
    keys = (p_lo + 64 + 8 * np.arange(40)).reshape(N, 10).astype(np.uint32)
    assert (w.rpc(W.OP_BT_INSERT, keys, values=vals(keys),
                  dest=np.zeros((N, 10), np.int32))[..., 0] == W.ST_OK).all()
    assert int(to_numpy(w.ps["arena"])[0, w.pl["nleaf"].base]) > 4
    lo = np.zeros((N, 1), np.uint32)
    hi = np.zeros((N, 1), np.uint32)
    hi[0, 0] = p_lo + 64 + 8 * 39
    _, _, _, res = scan_both(w, lo, hi)
    assert res.truncated[0, 0] and not res.committed[0, 0]
    _, resL = _loops(w, lo, hi, 3)
    assert resL.truncated[0, 0] and not resL.committed[0, 0]


def test_backup_installs_never_corrupt_the_primary_tree():
    w = World(n_leaves=32, max_scan_leaves=4)
    own = np.asarray(node_keys(w.jcfg, 8, seed=41))
    w.rpc(W.OP_BT_INSERT, own, values=vals(own))
    rng = np.random.RandomState(43)
    part = int(to_numpy(pbt.partition_bounds(w.pcfg, 1)[0]))
    fk = distinct_uint32(rng, N * 16, 0, part // 2).reshape(N, 16)
    dest = np.ones(fk.shape, np.int32)
    assert (w.rpc(W.OP_BT_BACKUP, fk, values=vals(fk), dest=dest)[..., 0]
            == W.ST_OK).all()
    a = to_numpy(w.ps["arena"])
    assert a[1, w.pl["bnleaf"].base] > 1
    assert a[1, w.pl["nleaf"].base] == a[0, w.pl["nleaf"].base]
    for n in range(N):
        assert pwl.fence_chain_keys(w.pcfg, w.pl, w.ps["arena"], n) == sorted(
            int(k) for k in own[n])
    assert (w.rpc(W.OP_BT_LOOKUP, own)[..., 0] == W.ST_OK).all()
    rep = w.rpc(W.OP_BT_LOOKUP, fk, dest=dest)
    assert (rep[..., 0] == W.ST_OK).all()
    np.testing.assert_array_equal(rep[..., 3:], vals(fk))


@pytest.fixture(scope="module")
def range_scan():
    """benchmarks/range_scan.py (the reference's tree and mixes), imported
    without leaving benchmarks/ on sys.path."""
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import range_scan
    finally:
        sys.path.remove(bench_dir)
    return range_scan


def test_build_tree_and_scan_workload_match_reference(range_scan):
    jcfg, jl, jt, js, jallk, jmeta = range_scan.build_tree(4, seed=5)
    cfg, lay, t, ps, allk, meta = pwl.build_tree(4, seed=5, device=CPU)
    np.testing.assert_array_equal(allk, jallk)
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    same(meta, jmeta, "meta")
    for frac, seed in ((1.0, 9), (0.9, 7), (0.5, 13)):
        for a, b in zip(pwl.scan_workload(allk, 4, 8, scan_frac=frac,
                                          seed=seed, device=CPU),
                        range_scan.scan_workload(jallk, 4, 8,
                                                 scan_frac=frac, seed=seed)):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))


def test_ordered_gate_numbers_exact(range_scan):
    """The gate's ``ordered`` keys, exact; and the scan-heavy mix's loop
    (which retries 2 lanes) bit-identical to the reference's when fed its
    permutations."""
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())["ordered"]
    res_f, _, res = pwl.gate_ordered_runs(device=CPU)
    keys = pwl.gate_ordered_keys(res_f, res)
    assert keys == {"scan_round_trips": 2.0, "commit_rate": 1.0}
    assert keys == {k: baseline[k] for k in keys}
    jcfg, jl, jt, js, jallk, jmeta = range_scan.build_tree(4, seed=5)
    lo, hi, wk, wen = range_scan.scan_workload(jallk, 4, 8, scan_frac=0.9,
                                               seed=7)
    js, _, jres = jax.jit(lambda st: jtxl.scan_loop(
        jt, st, jcfg, jl, scan_lo=lo, scan_hi=hi, meta=jmeta, write_keys=wk,
        write_values=range_scan.value_for(wk), write_enabled=wen,
        max_rounds=2))(js)
    cfg, lay, t, ps, allk, meta = pwl.build_tree(4, seed=5, device=CPU)
    plo, phi, pwk, pwen = pwl.scan_workload(allk, 4, 8, scan_frac=0.9,
                                            seed=7, device=CPU)
    ps, _, pres = ptxl.scan_loop(
        t, ps, cfg, lay, scan_lo=plo, scan_hi=phi, meta=meta,
        write_keys=pwk, write_values=pwl.value_for(pwk), write_enabled=pwen,
        max_rounds=2, perms=torch.from_numpy(jax_perms(
            jax.random.PRNGKey(0x5C0A), 2, 4, 8)), device=CPU)
    same(pres, jres, "gate scan_loop")
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    assert int(jres.round_attempts[1]) > 0


@pytest.mark.parametrize("refresh", [True, False])
def test_scan_loop_mixed_batch_with_reference_permutations(populated,
                                                           refresh):
    """The mixed scan/upsert batch through scan_loop, with and without the
    per-retry directory refresh (refresh=False replays the initial meta)."""
    w, allk, lo, hi = populated
    slo, shi, writes = mixed(allk, lo, hi)
    _, res = _loops(w, slo, shi, 3, refresh=refresh, **writes)
    assert res.committed.any()
