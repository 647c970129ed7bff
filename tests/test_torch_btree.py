"""PyTorch port, the B-link tree (``repro_torch.core.datastructs.btree``):
every handler opcode, splits, leaf exhaustion, leaf locks and the lock-time
pre-split, the generic one-two-sided probe (``hybrid`` with ``ds=btree``)
and the sorted-dict churn property — each driven through the JAX package and
the port from the same numpy inputs and held bit for bit: replies, arenas,
probe outcomes, scan results and WireStats.  Also: keys above 2^31 in
partitions that straddle it, the many-lane directory walk against the
serial one, and the handler memo."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhy  # noqa: E402
from repro.core import replication as jrepl  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import tx as jtx  # noqa: E402
from repro.core import wireproto as JW  # noqa: E402
from repro.core.datastructs import btree as jbt  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro.testing.workloads import value_for as jvalue_for  # noqa: E402
from repro_torch.convert import (state_from_numpy, state_to_numpy,  # noqa: E402
                                 to_numpy, words)
from repro_torch.core import hybrid as phy  # noqa: E402
from repro_torch.core import replication as prepl  # noqa: E402
from repro_torch.core import rpc as PR  # noqa: E402
from repro_torch.core import tx as ptx  # noqa: E402
from repro_torch.core import wireproto as W  # noqa: E402
from repro_torch.core.datastructs import btree as pbt  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.testing import workloads as pwl  # noqa: E402
from tests.test_btree import node_keys, walk_leaves  # noqa: E402
from tests.test_btree_property import _draw_keys, model_apply  # noqa: E402

CPU = "cpu"
N = 4


def same(p, j, what=""):
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            same(getattr(p, f.name), getattr(j, f.name), f"{what}.{f.name}")
        return
    if isinstance(j, dict):
        for k in j:
            same(p[k], j[k], f"{what}[{k}]")
        return
    if isinstance(j, (tuple, list)):
        for i, (a, b) in enumerate(zip(p, j)):
            same(a, b, f"{what}[{i}]")
        return
    a, b = to_numpy(p), np.asarray(j)
    if b.dtype == np.int32 and a.dtype == np.uint32:
        a = a.view(np.int32)           # the reference's signed words
    np.testing.assert_array_equal(a, b, err_msg=what)


_JIT = {}


def jitted(name, cfg, layout, make):
    """One jax.jit per (function, config): the JAX package compiles each
    shape once instead of dispatching every op eagerly."""
    key = (name, cfg)
    if key not in _JIT:
        _JIT[key] = jax.jit(make(cfg, layout))
    return _JIT[key]


def _j_rpc(vector):
    def make(cfg, layout):
        h = (jbt.make_lookup_handler_vector(cfg, layout) if vector
             else jbt.make_rpc_handler(cfg, layout))
        return lambda st, op, k, kh, aux, v, dest: JR.rpc_call(
            JSim(cfg.n_nodes), st, dest,
            jbt.make_record(op, k, kh, aux=aux, value=v), h)
    return make


def j_scan(cfg, layout, state, lo, hi, meta=None, fused=True, f=None, **kw):
    """tx.run_scan_transactions of the JAX package (numpy inputs; keyword
    arrays in kw; a fresh local_meta without ``meta``; ``f``: a ring
    ReplicaConfig), jitted per config and shape."""
    names = tuple(sorted(kw))

    def make(c, lay):
        rep = None if f is None else jrepl.ReplicaConfig(c.n_nodes, f)

        def run(st, lo, hi, meta, *a):
            if meta is None:
                meta = jbt.local_meta(c, lay, st)
            return jtx.run_scan_transactions(
                JSim(c.n_nodes), st, c, lay, scan_lo=lo, scan_hi=hi,
                meta=meta, fused=fused, rep=rep, **dict(zip(names, a)))
        return run
    fn = jitted(("scan", fused, f, meta is None) + names, cfg, layout, make)
    return fn(state, jnp.asarray(lo), jnp.asarray(hi), meta,
              *(jnp.asarray(kw[k]) for k in names))


def p_scan(cfg, layout, state, lo, hi, meta=None, fused=True, f=None, **kw):
    """The port's run_scan_transactions on a CLONE of ``state`` (the port
    updates arenas in place), from the same numpy inputs as :func:`j_scan`."""
    st = {"arena": state["arena"].clone()}
    if meta is None:
        meta = pbt.local_meta(cfg, layout, st)
    conv = lambda x: (torch.from_numpy(np.array(x)) if np.asarray(x).dtype
                      == bool else words(np.asarray(x), CPU))
    return ptx.run_scan_transactions(
        PSim(cfg.n_nodes), st, cfg, layout, scan_lo=conv(lo),
        scan_hi=conv(hi), meta=meta, fused=fused,
        rep=None if f is None else prepl.ReplicaConfig(cfg.n_nodes, f),
        **{k: conv(v) for k, v in kw.items()})


def scan_both(w, lo, hi, **kw):
    """One scan batch through both packages from ``w``'s states (left as
    they were): results, WireStats and final arenas must agree.  Returns
    (JAX state, JAX result, port state, port result)."""
    js, jres = j_scan(w.jcfg, w.jl, w.js, lo, hi, **kw)
    ps, pres = p_scan(w.pcfg, w.pl, w.ps, lo, hi, **kw)
    same(pres, jres, "run_scan_transactions")
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    return js, jres, ps, pres


class World:
    """One B-tree cluster held twice: the JAX package's and the port's."""

    def __init__(self, n_nodes=N, n_leaves=16, leaf_width=4,
                 max_scan_leaves=4):
        kw = dict(n_nodes=n_nodes, n_leaves=n_leaves, leaf_width=leaf_width,
                  max_scan_leaves=max_scan_leaves)
        self.n = n_nodes
        self.jcfg, self.pcfg = jbt.BTreeConfig(**kw), pbt.BTreeConfig(**kw)
        self.jl, self.pl = jbt.build_layout(self.jcfg), pbt.build_layout(self.pcfg)
        self.js = jbt.init_cluster_state(self.jcfg)
        self.ps = pbt.init_cluster_state(self.pcfg, device=CPU)
        self.check_arenas()

    def check_arenas(self):
        np.testing.assert_array_equal(state_to_numpy(self.ps)["arena"],
                                      np.asarray(self.js["arena"]))

    def rpc(self, op, keys, aux=None, values=None, key_hi=None, dest=None,
            vector=False):
        """One RPC round through both packages; replies and arenas must
        agree.  Returns the replies (numpy uint32)."""
        keys = np.asarray(keys, np.uint32)
        z = np.zeros_like(keys)
        kh = z if key_hi is None else np.asarray(key_hi, np.uint32)
        aux = z if aux is None else np.asarray(aux, np.uint32)
        values = (np.zeros(keys.shape + (27,), np.uint32) if values is None
                  else np.asarray(values, np.uint32))
        op = np.broadcast_to(np.asarray(op, np.uint32), keys.shape)
        if dest is None:
            dest = np.asarray(jbt.home_of(self.jcfg, jnp.asarray(keys)))
        dest = np.asarray(dest, np.int32)
        fn = jitted(("rpc", vector), self.jcfg, self.jl, _j_rpc(vector))
        self.js, jrep, jovf, jw = fn(self.js, *(jnp.asarray(x) for x in (
            op, keys, kh, aux, values, dest)))
        ph = (pbt.make_lookup_handler_vector(self.pcfg, self.pl) if vector
              else pbt.make_rpc_handler(self.pcfg, self.pl))
        self.ps, prep, povf, pw = PR.rpc_call(
            PSim(self.n), self.ps, torch.from_numpy(dest.copy()),
            pbt.make_record(words(op, CPU), words(keys, CPU),
                            words(kh, CPU), aux=words(aux, CPU),
                            value=words(values, CPU)), ph)
        same((prep, povf, pw), (jrep, jovf, jw), f"op {op.flat[0]}")
        self.check_arenas()
        return np.asarray(jrep)


def vals(keys):
    return np.asarray(jvalue_for(jnp.asarray(np.asarray(keys, np.uint32))))


def test_insert_lookup_update_delete():
    w = World()
    keys = np.asarray(node_keys(w.jcfg, 10))
    rep = w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))
    assert (rep[..., 0] == W.ST_OK).all()
    rep = w.rpc(W.OP_BT_LOOKUP, keys)
    np.testing.assert_array_equal(rep[..., 3:], vals(keys))
    rep = w.rpc(W.OP_BT_INSERT, keys, values=vals(keys + 3))     # upsert
    assert (rep[..., 0] == W.ST_OK).all()
    rep = w.rpc(W.OP_BT_LOOKUP, keys)
    np.testing.assert_array_equal(rep[..., 3:], vals(keys + 3))
    dk = keys[:, ::2]
    assert (w.rpc(W.OP_BT_DELETE, dk)[..., 0] == W.ST_OK).all()
    assert (w.rpc(W.OP_BT_DELETE, dk)[..., 0] == W.ST_NOT_FOUND).all()
    st = w.rpc(W.OP_BT_LOOKUP, keys)[..., 0]
    assert (st[:, ::2] == W.ST_NOT_FOUND).all() and (st[:, 1::2] == W.ST_OK).all()
    for n in range(N):
        assert walk_leaves(w.js, w.jcfg, w.jl, n) == sorted(
            int(k) for k in keys[n, 1::2])


def test_split_invariants_and_vector_lookup():
    w = World()
    keys = np.asarray(node_keys(w.jcfg, 24, seed=3))
    for i in range(0, 24, 8):
        rep = w.rpc(W.OP_BT_INSERT, keys[:, i:i + 8],
                    values=vals(keys[:, i:i + 8]))
        assert (rep[..., 0] == W.ST_OK).all()
    ps = {"arena": words(state_to_numpy(w.ps)["arena"], CPU)}
    for n in range(N):
        assert walk_leaves(state_to_numpy(ps), w.jcfg, w.jl, n) == sorted(
            int(k) for k in keys[n])
        assert pwl.fence_chain_keys(w.pcfg, w.pl, ps["arena"], n) == sorted(
            int(k) for k in keys[n])
    rep = w.rpc(W.OP_BT_LOOKUP, keys, vector=True)
    assert (rep[..., 0] == W.ST_OK).all()
    np.testing.assert_array_equal(rep[..., 3:], vals(keys))
    # absent keys and a foreign key (served from the empty backup tree)
    rep = w.rpc(W.OP_BT_LOOKUP, keys + 1, vector=True,
                dest=np.asarray(jbt.home_of(w.jcfg, jnp.asarray(keys))[:, ::-1]))
    assert (rep[..., 0] == W.ST_NOT_FOUND).all()


def test_leaf_exhaustion_reports_no_space():
    w = World(n_leaves=2, leaf_width=2, max_scan_leaves=2)
    keys = np.asarray(node_keys(w.jcfg, 8, seed=5))
    st = w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))[..., 0]
    assert (st == W.ST_NO_SPACE).any()
    assert ((st == W.ST_OK) | (st == W.ST_NO_SPACE)).all()
    rep2 = w.rpc(W.OP_BT_LOOKUP, keys)
    np.testing.assert_array_equal(rep2[..., 0] == W.ST_OK, st == W.ST_OK)
    for n in range(N):
        walk_leaves(w.js, w.jcfg, w.jl, n)


def test_leaf_lock_blocks_mutations_and_unlocks():
    w = World()
    keys = np.asarray(node_keys(w.jcfg, 4, seed=7))
    w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))
    k0 = keys[:, :1]
    tag = np.full(k0.shape, 77, np.uint32)
    rep = w.rpc(W.OP_BT_LOCK, k0, aux=tag)
    assert (rep[..., 0] == W.ST_OK).all()
    hslot, lock_ver = rep[..., 1], rep[..., 2].copy()
    np.testing.assert_array_equal(rep[..., 3:], vals(k0))
    assert (w.rpc(W.OP_BT_INSERT, k0, values=vals(k0))[..., 0]
            == W.ST_LOCK_FAIL).all()
    assert (w.rpc(W.OP_BT_DELETE, k0)[..., 0] == W.ST_LOCK_FAIL).all()
    assert (w.rpc(W.OP_BT_LOCK, k0, aux=tag + 1)[..., 0]
            == W.ST_LOCK_FAIL).all()
    assert (w.rpc(W.OP_BT_ABORT, k0, key_hi=tag + 1, aux=hslot)[..., 0]
            == W.ST_LOCK_FAIL).all()
    assert (w.rpc(W.OP_BT_ABORT, k0, key_hi=tag, aux=hslot)[..., 0]
            == W.ST_OK).all()
    np.testing.assert_array_equal(w.rpc(W.OP_BT_LOOKUP, k0)[..., 2], lock_ver)
    assert (w.rpc(W.OP_BT_DELETE, k0)[..., 0] == W.ST_OK).all()


def test_lock_presplits_full_leaf_then_commit():
    w = World(n_leaves=8, leaf_width=2, max_scan_leaves=2)
    base = np.asarray(node_keys(w.jcfg, 2, seed=9))
    assert (w.rpc(W.OP_BT_INSERT, base, values=vals(base))[..., 0]
            == W.ST_OK).all()
    nleaf0 = state_to_numpy(w.ps)["arena"][:, w.pl["nleaf"].base].copy()
    fresh = base[:, 1:2] + 1
    tag = np.full(fresh.shape, 5, np.uint32)
    rep = w.rpc(W.OP_BT_LOCK, fresh, aux=tag)
    assert (rep[..., 0] == W.ST_OK).all()
    assert (state_to_numpy(w.ps)["arena"][:, w.pl["nleaf"].base]
            == nleaf0 + 1).all(), "lock must pre-split the full leaf"
    hslot, lock_ver = rep[..., 1], rep[..., 2]
    rep = w.rpc(W.OP_BT_COMMIT, fresh, key_hi=tag, aux=hslot,
                values=vals(fresh))
    assert (rep[..., 0] == W.ST_OK).all()
    np.testing.assert_array_equal(rep[..., 2], lock_ver + 2)
    rep = w.rpc(W.OP_BT_LOOKUP, fresh)
    np.testing.assert_array_equal(rep[..., 3:], vals(fresh))
    for n in range(N):
        assert int(fresh[n, 0]) in walk_leaves(w.js, w.jcfg, w.jl, n)


def _hybrid(w, keys, jmeta, pmeta):
    keys = np.asarray(keys, np.uint32)
    jk = jnp.asarray(keys)
    fn = jitted("hybrid", w.jcfg, w.jl, lambda c, l: (
        lambda st, k, meta: jhy.hybrid_lookup(
            JSim(c.n_nodes), st, k, jnp.zeros_like(k), c, l, cache=meta,
            ds=jbt)))
    jout = fn(w.js, jk, jmeta)
    pk = words(keys, CPU)
    pout = phy.hybrid_lookup(PSim(N), w.ps, pk, torch.zeros_like(pk), w.pcfg,
                             w.pl, cache=pmeta, ds=pbt)
    same(pout[2:], jout[2:], "hybrid_lookup")
    return jout


def test_hybrid_probe_onesided_fast_path_and_stale_fallback():
    w = World()
    keys = np.asarray(node_keys(w.jcfg, 12, seed=11))
    w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))
    jmeta = jbt.local_meta(w.jcfg, w.jl, w.js)
    pmeta = pbt.local_meta(w.pcfg, w.pl, w.ps)
    same(pmeta, jmeta)
    kk = keys[:, ::2]
    out = _hybrid(w, kk, jmeta, pmeta)
    assert bool(np.asarray(out[2]).all()) and float(out[-1].rpc_fallback) == 0
    out = _hybrid(w, kk + 1, jmeta, pmeta)          # resolved misses
    assert not bool(np.asarray(out[2]).any())
    assert float(out[-1].rpc_fallback) == 0
    extra = keys + 1                                # splits: stale meta
    w.rpc(W.OP_BT_INSERT, extra, values=vals(extra))
    out = _hybrid(w, extra, jmeta, pmeta)
    assert bool(np.asarray(out[2]).all()) and float(out[-1].rpc_fallback) > 0
    jmeta2, js = jax.jit(lambda st: jbt.refresh_meta(JSim(N), st, w.jcfg,
                                                     w.jl))(w.js)
    pmeta2, ps = pbt.refresh_meta(PSim(N), w.ps, w.pcfg, w.pl)
    same((pmeta2, ps), (jmeta2, js), "refresh_meta")
    out = _hybrid(w, extra, jmeta2, pmeta2)
    assert float(out[-1].rpc_fallback) == 0


# ---------------------------------------------------------------------------
# The sorted-dict churn property (tests/test_btree_property.py), both
# packages in lockstep
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("seed,key_space", [(1234, 2**14), (7, 2**10),
                                            (4242, 2**16), (99, 2**28)])
def test_btree_against_sorted_dict_reference(seed, key_space):
    w = World(n_nodes=2, n_leaves=24, leaf_width=4, max_scan_leaves=6)
    rng = np.random.RandomState(seed)
    model = {}
    committed_scans = 0
    for _ in range(3):
        ops = rng.randint(0, 2, (2, 8))
        keys = _draw_keys(rng, model, key_space, 16).reshape(2, 8)
        keys = keys.astype(np.uint32)
        st = w.rpc(np.where(ops == 0, W.OP_BT_INSERT, W.OP_BT_DELETE), keys,
                   values=vals(keys))[..., 0]
        assert ((st == W.ST_OK) | (st == W.ST_NOT_FOUND)).all()
        model_apply(model, ops, keys)
        st = w.rpc(W.OP_BT_LOOKUP, keys)[..., 0].reshape(-1)
        np.testing.assert_array_equal(
            st == W.ST_OK, [int(k) in model for k in keys.reshape(-1)])
        live = sorted(model)
        if len(live) < 2:
            continue
        pick = rng.randint(0, len(live) - 1, (2, 2))
        lo = np.asarray(live, np.uint32)[pick]
        hi = np.asarray(live, np.uint32)[np.minimum(pick + 3, len(live) - 1)]
        _, _, _, pres = scan_both(w, lo, hi)
        com = pres.committed.numpy()
        assert (com | pres.truncated.numpy()).all()
        sk, sm = to_numpy(pres.scan_keys), pres.scan_mask.numpy()
        for n in range(2):
            for b in range(2):
                if com[n, b]:
                    committed_scans += 1
                    assert sorted(sk[n, b][sm[n, b]].tolist()) == [
                        k for k in live if lo[n, b] <= k <= hi[n, b]]
    assert committed_scans > 0


@pytest.mark.parametrize("n_nodes", [1, 3])
def test_keys_above_2_31(n_nodes):
    """Partitions that straddle 2^31 (1 node, or the middle one of 3) hold
    keys on both sides of it, up to MAX_KEY: the unsigned order must hold in
    the leaf sort, the routing and the scans."""
    w = World(n_nodes=n_nodes, n_leaves=24, leaf_width=4, max_scan_leaves=6)
    mid = [0x7FFFFFF0 + i for i in range(0, 32, 3)] + [0x80000000,
                                                       0x7FFFFFFF]
    top = [0xFFFFFFFE, 0xFFFFFFF0, 0xC0000000, 5, 0]
    pool = np.asarray(sorted(set(mid + top)), np.uint32)
    rng = np.random.RandomState(n_nodes)
    keys = rng.permutation(pool)[:n_nodes * (len(pool) // n_nodes)]
    keys = keys.reshape(n_nodes, -1)
    for i in range(0, keys.shape[1], 4):
        st = w.rpc(W.OP_BT_INSERT, keys[:, i:i + 4],
                   values=vals(keys[:, i:i + 4]))[..., 0]
        assert (st == W.ST_OK).all()
    allk = sorted(int(k) for k in keys.reshape(-1))
    got = []
    for n in range(n_nodes):
        chain = walk_leaves(w.js, w.jcfg, w.jl, n)
        assert chain == pwl.fence_chain_keys(w.pcfg, w.pl, w.ps["arena"], n)
        got += chain
    assert got == allk
    st = w.rpc(W.OP_BT_LOOKUP, keys, vector=True)[..., 0]
    assert (st == W.ST_OK).all()
    # one scan per node across 2^31 and one up to MAX_KEY
    lo = np.full((n_nodes, 2), 0x7FFFFFF0, np.uint32)
    hi = np.full((n_nodes, 2), 0x80000000, np.uint32)
    lo[:, 1], hi[:, 1] = 0xC0000000, 0xFFFFFFFE
    if n_nodes == 3:
        lo[:, 1] = 0xF0000000          # stay within max_scan_leaves
    _, _, _, pres = scan_both(w, lo, hi)
    assert pres.committed.all()
    sk, sm = to_numpy(pres.scan_keys), pres.scan_mask.numpy()
    for n in range(n_nodes):
        for b in range(2):
            assert sorted(sk[n, b][sm[n, b]].tolist()) == [
                k for k in allk if lo[n, b] <= k <= hi[n, b]]


def test_route_sorted_matches_the_serial_walk():
    """The many-lane directory walk equals the serial handler's argmax walk
    on directories with unallocated entries, duplicate and zero fences and
    keys at both ends of the 32-bit space."""
    cfg = pbt.BTreeConfig(n_nodes=1, n_leaves=12)
    g = torch.Generator().manual_seed(3)
    D = 6
    fences = torch.randint(-2**31, 2**31, (D, 12), generator=g,
                           dtype=torch.int64).to(torch.int32)
    fences[1, :4] = torch.tensor([0, 7, 7, 3], dtype=torch.int32)
    fences[2, 5] = fences[2, 2]
    fences[3] = 0
    nleaf = torch.tensor([12, 4, 9, 1, 0, 7], dtype=torch.int32)
    keys = torch.cat([torch.randint(-2**31, 2**31, (200,), generator=g,
                                    dtype=torch.int64).to(torch.int32),
                      torch.tensor([0, -1, -2, 7, 6, 3, 2**31 - 1, -2**31],
                                   dtype=torch.int32)])
    keys = torch.cat([keys, fences.reshape(-1)])
    d = torch.randint(0, D, keys.shape, generator=g)
    leaf, fence = pbt._route_sorted(fences, nleaf, d, keys)
    want_leaf, want_fence = pbt._route_leaf(cfg, fences[d], nleaf[d], keys)
    assert torch.equal(leaf, want_leaf) and torch.equal(fence, want_fence)


def test_configs_do_not_share_a_memoized_handler():
    a = pbt.BTreeConfig(n_nodes=2, n_leaves=4)
    b = pbt.BTreeConfig(n_nodes=2, n_leaves=8)
    la, lb = pbt.build_layout(a), pbt.build_layout(b)
    assert pbt.make_rpc_handler(a, la) is pbt.make_rpc_handler(a, la)
    assert pbt.make_rpc_handler(a, la) is not pbt.make_rpc_handler(b, lb)
    assert pbt.make_lookup_handler_vector(a, la) is not \
        pbt.make_lookup_handler_vector(b, lb)
    assert pbt.make_scan_handler_vector(a, la) is not \
        pbt.make_scan_handler_vector(b, lb)
    # each handler serves its own config's state (no tensor is held, so one
    # handler serves a state on any device)
    for cfg, lay in ((a, la), (b, lb)):
        st = pbt.init_cluster_state(cfg, device=CPU)
        k = words(np.asarray([[1], [2**31 + 5]], np.uint32), CPU)
        st, rep, _, _ = PR.rpc_call(
            PSim(2), st, pbt.home_of(cfg, k),
            pbt.make_record(W.OP_BT_INSERT, k, torch.zeros_like(k),
                            value=pwl.value_for(k)),
            pbt.make_rpc_handler(cfg, lay))
        assert (rep[..., 0] == W.ST_OK).all()
        assert st["arena"].shape[1] == lay.total_words


def test_cluster_state_carries_across():
    """convert.state_from_numpy / state_to_numpy carry a B-tree cluster
    state both ways, word for word."""
    w = World()
    keys = np.asarray(node_keys(w.jcfg, 6, seed=13))
    w.rpc(W.OP_BT_INSERT, keys, values=vals(keys))
    carried = state_from_numpy(jax.device_get(w.js), CPU)
    assert carried["arena"].dtype == torch.int32
    assert torch.equal(carried["arena"], w.ps["arena"])
    np.testing.assert_array_equal(state_to_numpy(carried)["arena"],
                                  np.asarray(w.js["arena"]))
    assert JW.OP_BT_BACKUP == W.OP_BT_BACKUP
