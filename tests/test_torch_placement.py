"""PyTorch port, placement and membership (``repro_torch.core.placement``,
the ``ptable=`` paths of ``tx`` / ``txloop``, ``route_by_placement``,
``MetricsRegistry`` and ``workloads.gate_membership``) — the counterparts of
``tests/test_placement.py``, each held bit for bit against the JAX package
from the same numpy inputs: tables, arenas, replies, abort causes, WireStats
and round counts.  Retry rounds are fed the reference's own backoff
permutations.  Also: one-issuer sweeps split into tiny slices against the
reference's unsplit round, B-tree keys above 2^31 in rereplication and
migration, the plans, and the bench gate's ``membership`` keys.

The reference's ``rpc_call`` and ``remote_read`` run jitted here, with its
handler factories memoized so each compiled round is reused: the same
computation, compiled once per shape instead of dispatched op by op
(rereplication and migration are host-driven and cannot be jitted whole)."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import onesided as josd  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import replication as jrepl  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import slots as jsl  # noqa: E402
from repro.core import telemetry as JT  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro.core import txloop as jtxl  # noqa: E402
from repro.core import wireproto as JW  # noqa: E402
from repro.core.datastructs import btree as jbt  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro.testing.workloads import value_for as jvalue_for  # noqa: E402
from repro_torch.convert import state_to_numpy, to_numpy, words  # noqa: E402
from repro_torch.core import placement as ppl  # noqa: E402
from repro_torch.core import replication as prepl  # noqa: E402
from repro_torch.core import rpc as PR  # noqa: E402
from repro_torch.core import slots as psl  # noqa: E402
from repro_torch.core import telemetry as PT  # noqa: E402
from repro_torch.core import transport as ptr  # noqa: E402
from repro_torch.core import txloop as ptxl  # noqa: E402
from repro_torch.core.datastructs import btree as pbt  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.testing import workloads as pwl  # noqa: E402
from tests.test_placement import find_copy, keys_in_part, slots_of  # noqa: E402
from tests.test_torch_btree import same  # noqa: E402
from tests.test_torch_txloop import jax_perms  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"
N = 4
KW = dict(n_nodes=N, n_buckets=16, bucket_width=2, n_overflow=64,
          max_chain=10)
JCFG, PCFG = jht.HashTableConfig(**KW), pht.HashTableConfig(**KW)
JL, PL = jht.build_layout(JCFG), pht.build_layout(PCFG)
BKW = dict(n_nodes=N, n_leaves=32, leaf_width=4)
JBCFG, PBCFG = jbt.BTreeConfig(**BKW), pbt.BTreeConfig(**BKW)
JBL, PBL = jbt.build_layout(JBCFG), pbt.build_layout(PBCFG)
TX_KEY, SCAN_KEY = jax.random.PRNGKey(0x5707), jax.random.PRNGKey(0x5C0A)
_JIT = {}


@pytest.fixture(scope="module", autouse=True)
def compiled_reference():
    """Jit the reference's rpc_call / remote_read and memoize its handler
    factories (by config and layout) for this module's tests."""
    def memo(make):
        cache = {}

        def get(cfg, layout):
            k = (cfg, id(layout))
            if k not in cache:
                cache[k] = (make(cfg, layout), layout)
            return cache[k][0]
        return get

    rpc = jax.jit(JR.rpc_call, static_argnums=(0, 4),
                  static_argnames=("capacity", "nic", "telemetry", "phase"))
    read = jax.jit(josd.remote_read, static_argnums=(0,), static_argnames=(
        "length", "capacity", "mode", "nic", "telemetry", "phase"))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jht, jbt):
            for name in ("make_rpc_handler", "make_lookup_handler_vector",
                         "make_scan_handler_vector"):
                if hasattr(mod, name):
                    mp.setattr(mod, name, memo(getattr(mod, name)))
        mp.setattr(JR, "rpc_call", lambda t, st, d, r, h, **kw:
                   rpc(t, st, d, r, h, **kw))
        mp.setattr(josd, "remote_read", lambda t, a, d, o, **kw:
                   read(t, a, d, o, **kw))
        yield


def jcall(name, make, *args):
    """A jitted JAX call, compiled once per ``name`` (its static
    configuration; the arrays are arguments)."""
    if name not in _JIT:
        _JIT[name] = jax.jit(make())
    return _JIT[name](*args)


def ptab(j):
    """The port's copy of a JAX PlacementTable."""
    return ppl.PlacementTable(
        epoch=words(np.asarray(j.epoch), CPU),
        copies=torch.from_numpy(np.array(j.copies)),
        alive=torch.from_numpy(np.array(j.alive)))


def same_arena(ps, js, what="arena"):
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]), err_msg=what)


def write_keys(klo):
    """(N, B, Wr) uint32 key_lo -> (N, B, Wr, 2) write keys (key_hi 0)."""
    klo = np.asarray(klo, np.uint32)
    return np.stack([klo, np.zeros_like(klo)], -1)


def no_reads(B):
    return np.zeros((N, B, 0, 2), np.uint32)


def jvals(k):
    return np.asarray(jvalue_for(jnp.asarray(k, jnp.uint32)))


def loop_both(name, js, ps, *, read_keys, write_keys_, write_values,
              max_rounds, rep=None, table=None, pcfg=None):
    """tx_loop over the hash table through both packages (the port fed the
    reference's permutations); results and arenas must agree.  ``table``
    is a JAX PlacementTable (the port gets its copy).  Returns (JAX state,
    port state, port result)."""
    f = None if rep is None else rep

    def make():
        jrep = None if f is None else jrepl.ReplicaConfig(N, f)
        jpc = None if pcfg is None else jpl.PlacementConfig(N, f=pcfg)
        return lambda st, tab, rk, wk, wv: jtxl.tx_loop(
            JSim(N), st, JCFG, JL, read_keys=rk, write_keys=wk,
            write_values=wv, max_rounds=max_rounds, rep=jrep, ptable=tab,
            pcfg=jpc)
    js2, _, jres = jcall(("loop", f, pcfg, max_rounds, table is None,
                          read_keys.shape, write_keys_.shape), make, js,
                         table, *(jnp.asarray(x, jnp.uint32) for x in (
                             read_keys, write_keys_, write_values)))
    B = write_keys_.shape[1]
    ps2, _, pres = ptxl.tx_loop(
        PSim(N), ps, PCFG, PL, read_keys=read_keys, write_keys=write_keys_,
        write_values=write_values, max_rounds=max_rounds,
        rep=None if f is None else prepl.ReplicaConfig(N, f),
        ptable=None if table is None else ptab(table),
        pcfg=None if pcfg is None else ppl.PlacementConfig(N, f=pcfg),
        perms=torch.from_numpy(jax_perms(TX_KEY, max_rounds, N, B)),
        device=CPU)
    same(pres, jres, f"{name}: tx_loop")
    same_arena(ps2, js2, f"{name}: tx_loop arena")
    return js2, ps2, pres


def hash_cluster():
    """An empty hash-table cluster in both packages."""
    return jht.init_cluster_state(JCFG), pht.init_cluster_state(PCFG,
                                                                device=CPU)


def insert_both(name, js, ps, klo, enabled, dest):
    """OP_INSERT rpc_call of (N, K) keys from every enabled lane to
    ``dest`` (N, K), in both packages."""
    kj = jnp.asarray(klo, jnp.uint32)
    js, jrep_, _, _ = JR.rpc_call(
        JSim(N), js, jnp.asarray(dest, jnp.int32),
        jht.make_record(JW.OP_INSERT, kj, jnp.zeros_like(kj),
                        value=jvalue_for(kj)),
        jht.make_rpc_handler(JCFG, JL), enabled=jnp.asarray(enabled))
    kp = words(klo, CPU)
    ps, prep_, _, _ = PR.rpc_call(
        PSim(N), ps, torch.as_tensor(np.asarray(dest, np.int32)),
        pht.make_record(JW.OP_INSERT, kp, torch.zeros_like(kp),
                        value=pwl.value_for(kp)),
        pht.make_rpc_handler(PCFG, PL), enabled=torch.as_tensor(enabled))
    same(prep_, jrep_, f"{name}: insert replies")
    same_arena(ps, js, f"{name}: insert arena")
    return js, ps, np.asarray(jrep_)



HASH = ((JCFG, JL), (PCFG, PL))
BTREE = ((JBCFG, JBL), (PBCFG, PBL))


def lookup_both(name, js, ps, jt, klo, cfgs=HASH, ds=(jht, pht)):
    """failover_lookup of (N, K) key_lo words through both packages."""
    (jc, jl), (pc, pl_) = cfgs
    jout = jcall(("lookup", jc, klo.shape), lambda: lambda st, tab, k:
                 jpl.failover_lookup(JSim(N), st, jc, jl, tab, k,
                                     jnp.zeros_like(k), ds=ds[0]),
                 js, jt, jnp.asarray(klo, jnp.uint32))
    kp = words(klo, CPU)
    out = ppl.failover_lookup(PSim(N), ps, pc, pl_, ptab(jt), kp,
                              torch.zeros_like(kp), ds=ds[1])
    same(out, jout, f"{name}: failover_lookup")
    return out


# ---------------------------------------------------------------------------
# The identity table IS the static partition math (bit-identity)
# ---------------------------------------------------------------------------
def test_identity_table_bit_identical_tx():
    rng = np.random.RandomState(7)
    B, Rd, Wr = 6, 2, 2
    klo = rng.randint(0, 2**31, (N, B, Rd + Wr)).astype(np.uint32)
    rk, wk = write_keys(klo[..., :Rd]), write_keys(klo[..., Rd:])
    wv = jvals(klo[..., Rd:])
    js, ps = hash_cluster()
    kw = dict(read_keys=rk, write_keys_=wk, write_values=wv, max_rounds=4,
              rep=1)
    _, s0, r0 = loop_both("ident-rep", js, {"arena": ps["arena"].clone()},
                          **kw)
    _, s1, r1 = loop_both("ident-pl", js, ps, table=jpl.initial_table(
        jpl.PlacementConfig(N, f=1)), pcfg=1, **kw)
    assert torch.equal(s0["arena"], s1["arena"])
    assert torch.equal(r0.committed, r1.committed)
    assert float(r0.round_trips) == float(r1.round_trips), \
        "epoch-stable routing must not add a single exchange round"
    assert int(r1.round_abort_stale.sum()) == 0


def scan_both(name, js, ps, max_rounds, table=None, pcfg=None, rep=None,
              **kw):
    """scan_loop through both packages, the port fed the reference's
    permutations.  kw: numpy scan_lo / scan_hi / write_keys / write_values
    (and scan_enabled).  Returns (JAX state, port state, port result)."""
    def make():
        jpc = None if pcfg is None else jpl.PlacementConfig(N, f=pcfg)
        jrep = None if rep is None else jrepl.ReplicaConfig(N, rep)
        return lambda st, tab, kw: jtxl.scan_loop(
            JSim(N), st, JBCFG, JBL, max_rounds=max_rounds, ptable=tab,
            pcfg=jpc, rep=jrep, **kw)
    js2, _, jres = jcall(("scan", max_rounds, pcfg, rep, table is None,
                          tuple(sorted((k, v.shape) for k, v in kw.items()))),
                         make, js, table,
                         {k: jnp.asarray(v) for k, v in kw.items()})
    B = kw["scan_lo"].shape[1]
    ps2, _, pres = ptxl.scan_loop(
        PSim(N), ps, PBCFG, PBL, max_rounds=max_rounds,
        ptable=None if table is None else ptab(table),
        pcfg=None if pcfg is None else ppl.PlacementConfig(N, f=pcfg),
        rep=None if rep is None else prepl.ReplicaConfig(N, rep),
        perms=torch.from_numpy(jax_perms(SCAN_KEY, max_rounds, N, B)),
        device=CPU, **{k: (torch.from_numpy(v) if v.dtype == bool
                           else words(v, CPU)) for k, v in kw.items()})
    same(pres, jres, f"{name}: scan_loop")
    same_arena(ps2, js2, f"{name}: scan_loop arena")
    return js2, ps2, pres


def btree_inserted(keys):
    """Both packages' B-trees with (N, K) ``keys`` inserted at their
    homes."""
    js = jbt.init_cluster_state(JBCFG)
    kj = jnp.asarray(keys, jnp.uint32)
    js, jrep_, _, _ = JR.rpc_call(
        JSim(N), js, jbt.home_of(JBCFG, kj),
        jbt.make_record(JW.OP_BT_INSERT, kj, jnp.zeros_like(kj),
                        value=jvalue_for(kj)), jbt.make_rpc_handler(JBCFG, JBL))
    assert (np.asarray(jrep_[..., 0]) == JW.ST_OK).all()
    ps = pbt.init_cluster_state(PBCFG, device=CPU)
    kp = words(keys, CPU)
    ps, _, _, _ = PR.rpc_call(
        PSim(N), ps, pbt.home_of(PBCFG, kp),
        pbt.make_record(JW.OP_BT_INSERT, kp, torch.zeros_like(kp),
                        value=pwl.value_for(kp)),
        pbt.make_rpc_handler(PBCFG, PBL))
    same_arena(ps, js, "btree insert")
    return js, ps


def test_identity_table_bit_identical_scan():
    rng = np.random.RandomState(11)
    keys = rng.randint(0, 2**30, (N, 6)).astype(np.uint32)
    js, ps = btree_inserted(keys)
    B = 6
    lo = rng.randint(0, 2**30, (N, B)).astype(np.uint32)
    hi = lo + np.uint32(1 << 20)
    wk = rng.randint(0, 2**30, (N, B, 1)).astype(np.uint32)
    kw = dict(scan_lo=lo, scan_hi=hi, write_keys=wk, write_values=jvals(wk))
    _, s0, r0 = scan_both("scan-ident", js, {"arena": ps["arena"].clone()},
                          3, **kw)
    _, s1, r1 = scan_both("scan-ident-pl", js, ps, 3,
                          table=jpl.initial_table(jpl.PlacementConfig(N)),
                          pcfg=0, **kw)
    assert torch.equal(s0["arena"], s1["arena"])
    assert torch.equal(r0.committed, r1.committed)
    assert float(r0.round_trips) == float(r1.round_trips)
    assert int(r1.round_abort_stale.sum()) == 0


# ---------------------------------------------------------------------------
# Region codec + wire publication round-trip
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_nodes", [4, 32, 40])
def test_region_codec_roundtrip(n_nodes):
    """decode_region ∘ region_image is the identity and both equal the
    reference's words; at 32 and 40 nodes the alive bit of node 31 (bit 31
    of a word, a negative int32 image) is set and a second alive word is
    used."""
    jpc, ppc = jpl.PlacementConfig(n_nodes, f=1), ppl.PlacementConfig(
        n_nodes, f=1)
    jt = jpl.kill_node(jpc, jpl.initial_table(jpc), 3)
    jt = jpl.PlacementTable(jt.epoch, jt.copies.at[2].set(
        jnp.asarray([1, 0, -1, -1], jnp.int32)), jt.alive)
    pt = ptab(jt)
    img = ppl.region_image(ppc, pt)
    np.testing.assert_array_equal(to_numpy(img),
                                  np.asarray(jpl.region_image(jpc, jt)))
    dec = ppl.decode_region(ppc, img)
    same(dec, jpl.decode_region(jpc, jpl.region_image(jpc, jt)), "decode")
    same(dec, jt, "roundtrip")
    assert int(dec.epoch) == 1
    # a decode at f=0 masks the backup columns
    same(ppl.decode_region(ppl.PlacementConfig(n_nodes), img),
         jpl.decode_region(jpl.PlacementConfig(n_nodes),
                           jpl.region_image(jpc, jt)), "decode f=0")


def test_install_then_refresh_round_trips_the_table():
    """install_table broadcasts OP_PL_INSTALL records; refresh_table reads
    the published region back with ONE one-sided read and decodes the same
    table; a disabled refresh issues zero wire; install_local on some nodes
    writes their regions only.  Each equal to the reference."""
    jpc, ppc = jpl.PlacementConfig(N, f=1), ppl.PlacementConfig(N, f=1)
    jt = jpl.kill_node(jpc, jpl.initial_table(jpc), 1)
    jt, _ = jpl.repair_plan(jpc, jt)
    pt = ptab(jt)
    js, ps = hash_cluster()
    js, jst = jcall("install", lambda: lambda st: jpl.install_table(
        JSim(N), st, JL, jpc, jt, jht.make_rpc_handler(JCFG, JL)), js)
    ps, pst = ppl.install_table(PSim(N), ps, PL, ppc, pt,
                                pht.make_rpc_handler(PCFG, PL))
    same(pst, jst, "install wire")
    same_arena(ps, js, "install arena")
    same(ppl.install_records(ppc, pt), jpl.install_records(jpc, jt),
         "install records")

    got, stats = ppl.refresh_table(PSim(N), ps, PL, ppc,
                                   ppl.initial_table(ppc, device=CPU))
    jgot, jstats = jcall("refresh", lambda: lambda st: jpl.refresh_table(
        JSim(N), st, JL, jpc, jpl.initial_table(jpc)), js)
    same(got, jgot, "refreshed table")
    same(stats, jstats, "refresh wire")
    same(got, jt, "refresh returns the installed table")
    assert float(stats.round_trips) == 1.0, \
        "a table refresh is ONE one-sided read"
    _, s_off = ppl.refresh_table(PSim(N), ps, PL, ppc, pt, enabled=False)
    assert float(s_off.ops) == 0.0 and float(s_off.round_trips) == 0.0, \
        "a gated-off refresh must cost zero wire"

    jt2 = jpl.kill_node(jpc, jt, 2)
    js = jpl.install_local(js, JL, jpc, jt2, nodes=[0, 3])
    ps = ppl.install_local(ps, PL, ppc, ptab(jt2), nodes=[0, 3])
    same_arena(ps, js, "install_local arena")


def test_routing_queries_and_parking():
    pcfg = ppl.PlacementConfig(N, f=1)
    table = ppl.initial_table(pcfg, device=CPU)
    assert int(ppl.owner_of(table, 2)) == 2
    np.testing.assert_array_equal(to_numpy(ppl.copy_nodes(table, 1))[:2]
                                  .view(np.int32), [1, 2])
    table = ppl.kill_node(pcfg, table, 1)
    # dead owner: writes park (-1), reads fail over to the live backup
    assert int(ppl.owner_dest(table, torch.tensor(1))) == -1
    d, ok = ppl.live_dest(table, 1)
    assert int(d) == 2 and bool(ok)
    # every copy dead: both park, and the lane reports unreachable
    table = ppl.kill_node(pcfg, table, 2)
    d, ok = ppl.live_dest(table, 1)
    assert int(d) == -1 and not bool(ok)
    jt = jpl.kill_node(jpl.PlacementConfig(N, f=1), jpl.kill_node(
        jpl.PlacementConfig(N, f=1), jpl.initial_table(
            jpl.PlacementConfig(N, f=1)), 1), 2)
    same(table, jt, "table after two kills")
    part = torch.arange(N)
    same(ppl.owner_dest(table, part), jpl.owner_dest(jt, jnp.arange(N)),
         "owner_dest")
    same(ppl.live_dest(table, part), jpl.live_dest(jt, jnp.arange(N)),
         "live_dest")


def test_route_by_placement_matches_reference():
    """route_by_placement: destinations through the table, unreachable
    partitions parked — dest, reachable, buffer, mask, cell and overflow
    equal to the reference's."""
    rng = np.random.RandomState(3)
    jpc = jpl.PlacementConfig(N, f=1)
    jt = jpl.kill_node(jpc, jpl.kill_node(jpc, jpl.initial_table(jpc), 1), 2)
    part = rng.randint(0, N, (12,)).astype(np.int32)
    payload = rng.randint(0, 2**31, (12, 5)).astype(np.uint32)
    en = rng.rand(12) < 0.8
    for cap in (2, 12):
        j = jtr.route_by_placement(jt, jnp.asarray(part), jnp.asarray(payload),
                                   N, cap, jnp.asarray(en))
        p = ptr.route_by_placement(ptab(jt), torch.from_numpy(part),
                                   words(payload, CPU), N, cap,
                                   torch.from_numpy(en))
        same(p, j, f"route_by_placement cap={cap}")


# ---------------------------------------------------------------------------
# Stale-route abort -> refresh -> converge
# ---------------------------------------------------------------------------
def test_stale_route_aborts_then_refresh_converges():
    """A client whose cached table predates a migration routes lock-class
    ops to the OLD owner, gets ST_WRONG_EPOCH (cause stale_route, nothing
    written), refreshes on the retry round and commits at the new owner."""
    jpc, ppc = jpl.PlacementConfig(N), ppl.PlacementConfig(N)
    fresh = jpl.PlacementTable(
        jnp.uint32(1), jpl.initial_table(jpc).copies.at[0, 0].set(2),
        jnp.ones((N,), bool))
    js, ps = hash_cluster()
    js = jpl.install_local(js, JL, jpc, fresh)
    ps = ppl.install_local(ps, PL, ppc, ptab(fresh))
    same_arena(ps, js, "install_local")
    B = 4
    wk0 = keys_in_part(JCFG, 0, N * B, seed=3).reshape(N, B, 1)
    wk = write_keys(wk0)
    js, ps, res = loop_both("stale", js, ps, read_keys=no_reads(B),
                            write_keys_=wk, write_values=jvals(wk0),
                            max_rounds=4, table=jpl.initial_table(jpc),
                            pcfg=0)
    assert int(res.round_abort_stale[0]) == N * B, \
        "round 0 must abort every lane with cause stale_route"
    assert int(res.round_abort_stale[1:].sum()) == 0, \
        "one refresh must clear the staleness"
    assert bool(res.committed.all()), "retry must converge at the new owner"
    st = state_to_numpy(ps)
    for k in wk0.reshape(-1):
        assert find_copy(st, JCFG, JL, 2, k) is not None, \
            "committed writes must land at the NEW owner"
        assert find_copy(st, JCFG, JL, 0, k) is None, \
            "the old owner must reject (and not install) stale-routed locks"


# ---------------------------------------------------------------------------
# Membership: kill -> repair_plan -> rereplicate restores f+1 copies
# ---------------------------------------------------------------------------
@pytest.fixture(params=["whole", "sliced"])
def sweep(request, monkeypatch):
    """Run each sweep as the default slices or as slices of 7 lanes."""
    if request.param == "sliced":
        monkeypatch.setattr(ppl, "SWEEP_LANES", 7)
    return request.param


def test_kill_repair_rereplicate_restores_copies_hash(sweep):
    jpc, ppc = jpl.PlacementConfig(N, f=1), ppl.PlacementConfig(N, f=1)
    rng = np.random.RandomState(23)
    B = 6
    klo = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
    js, ps = hash_cluster()
    js, ps, res = loop_both("rr-hash", js, ps, read_keys=no_reads(B),
                            write_keys_=write_keys(klo), write_values=jvals(klo),
                            max_rounds=4, rep=1, table=jpl.initial_table(jpc),
                            pcfg=1)
    assert bool(res.committed.all())

    dead = 1
    jt = jpl.kill_node(jpc, jpl.initial_table(jpc), dead)
    jt2, jtr_ = jpl.repair_plan(jpc, jt)
    table = ppl.kill_node(ppc, ppl.initial_table(ppc, device=CPU), dead)
    table2, transfers = ppl.repair_plan(ppc, table)
    same(table, jt, "killed table")
    same(table2, jt2, "repaired table")
    assert transfers == jtr_ and len(transfers) > 0
    assert int(table2.epoch) == int(table.epoch) + 1
    cps = to_numpy(table2.copies).view(np.int32)
    alive = to_numpy(table2.alive)
    for p in range(N):
        row = [c for c in cps[p] if c >= 0]
        assert len(row) == ppc.n_copies and all(alive[c] for c in row), \
            "repair must refill every partition with live copies"
    assert cps[dead, 0] != dead, "the dead owner must be demoted"

    # scorch the dead arena; nothing below may read it
    js = dict(js, arena=js["arena"].at[dead].set(jnp.uint32(0xDEAD)))
    ps["arena"][dead] = 0xDEAD
    live = [n for n in range(N) if n != dead]
    js = jpl.install_local(js, JL, jpc, jt2, nodes=live)
    ps = ppl.install_local(ps, PL, ppc, table2, nodes=live)
    js, jstats = jpl.rereplicate(JSim(N), js, JCFG, JL, jpc, jtr_)
    ps, stats = ppl.rereplicate(PSim(N), ps, PCFG, PL, ppc, transfers)
    same(stats, jstats, "rereplication wire")
    same_arena(ps, js, "rereplicated arena")
    assert float(stats.total_bytes) > 0.0

    # every committed key now has f+1 LIVE byte-equal copies per the table
    keep = [j for j in range(psl.SLOT_WORDS) if j != psl.NEXT_PTR]
    st = state_to_numpy(ps)
    part = to_numpy(pht.part_of(PCFG, words(klo[..., 0], CPU),
                                torch.zeros((N, B), dtype=torch.int32)))
    for k, p in zip(klo[..., 0].reshape(-1), part.reshape(-1)):
        row = [int(c) for c in cps[p] if c >= 0]
        imgs = [find_copy(st, JCFG, JL, c, k) for c in row]
        for c, img in zip(row, imgs):
            assert img is not None, \
                f"key {k} (part {p}) missing its copy on node {c}"
            np.testing.assert_array_equal(imgs[0][keep], img[keep])


def btree_replicated(seed):
    """Both packages' B-trees populated THROUGH the replicated scan-tx
    commit path at f=1 (write-only lanes, keys over the whole unsigned
    range).  Returns (JAX state, port state, keys (N, B, 1))."""
    rng = np.random.RandomState(seed)
    B = 6
    wk = rng.randint(0, 2**32, (N, B, 1), dtype=np.uint32)
    js, ps = (jbt.init_cluster_state(JBCFG),
              pbt.init_cluster_state(PBCFG, device=CPU))
    js, ps, res = scan_both(("bt-pop", seed), js, ps, 10, rep=1,
                            scan_lo=wk[..., 0], scan_hi=wk[..., 0],
                            scan_enabled=np.zeros((N, B), bool),
                            write_keys=wk, write_values=jvals(wk))
    assert bool(res.committed.all())
    return js, ps, wk


@pytest.mark.parametrize("dead", [1, 3])
def test_kill_repair_rereplicate_btree_logical(dead, sweep):
    """Dead node 1 streams partitions 0 and 1; dead node 3 streams
    partitions 2 and 3, whose keys lie above 2^31 (partition 3 from node
    0's backup tree)."""
    js, ps, wk = btree_replicated(29)
    jpc, ppc = jpl.PlacementConfig(N, f=1), ppl.PlacementConfig(N, f=1)
    jt2, jtr_ = jpl.repair_plan(jpc, jpl.kill_node(jpc, jpl.initial_table(
        jpc), dead))
    table2, transfers = ppl.repair_plan(ppc, ppl.kill_node(
        ppc, ppl.initial_table(ppc, device=CPU), dead))
    same(table2, jt2, "repaired table")
    assert transfers == jtr_
    live = [n for n in range(N) if n != dead]
    js = jpl.install_local(js, JBL, jpc, jt2, nodes=live)
    ps = ppl.install_local(ps, PBL, ppc, table2, nodes=live)
    js, jstats = jpl.rereplicate(JSim(N), js, JBCFG, JBL, jpc, jtr_)
    ps, stats = ppl.rereplicate(PSim(N), ps, PBCFG, PBL, ppc, transfers)
    same(stats, jstats, "rereplication wire")
    same_arena(ps, js, "rereplicated arena")
    assert float(stats.total_bytes) > 0.0

    # logical equality: every committed key is found with its value through
    # the repaired table, and the NEW backup holds the dead partition's keys
    out = lookup_both("bt-rr", js, ps, jt2, wk[..., 0], BTREE, (jbt, pbt))
    assert bool(out["found"].all())
    np.testing.assert_array_equal(to_numpy(out["value"]),
                                  jvals(wk).reshape(N, 6, psl.VALUE_WORDS))
    cps = to_numpy(table2.copies).view(np.int32)
    new_backup = int(cps[dead, 1])
    assert new_backup != dead and new_backup != int(cps[dead, 0])
    lo, hi = (int(psl.u32(x)) for x in pbt.partition_bounds(PBCFG, dead))
    want = sorted(int(k) for k in wk.reshape(-1) if lo <= int(k) <= hi)
    arena = state_to_numpy(ps)["arena"][new_backup]
    bl = PBL["bleaves"]
    leaves = arena[bl.base:bl.base + PBCFG.n_leaves
                   * PBCFG.leaf_words].reshape(PBCFG.n_leaves,
                                               PBCFG.leaf_slots, psl.SLOT_WORDS)
    got = sorted(int(k) for k in leaves[:, 1:, psl.KEY_LO].reshape(-1)
                 if lo <= int(k) <= hi and k != 0xFFFFFFFF)
    assert set(want) <= set(got), \
        "re-replication must stream the dead partition to the new backup"


# ---------------------------------------------------------------------------
# Transactional migration: source-lock -> copy -> epoch flip
# ---------------------------------------------------------------------------
def migrate_both(name, js, ps, jt, cfgs, part, dst, pcfg_f=0):
    """migrate_partition through both packages; table, arena, wire and the
    outcome must agree.  Returns (JAX table, JAX state, port table, port
    state, migrated)."""
    (jc, jl), (pc, pl_) = cfgs
    jpc, ppc = jpl.PlacementConfig(N, f=pcfg_f), ppl.PlacementConfig(
        N, f=pcfg_f)
    jt2, js, jstats, jok = jpl.migrate_partition(JSim(N), js, jc, jl, jpc, jt,
                                                 part, dst)
    pt2, ps, pstats, pok = ppl.migrate_partition(PSim(N), ps, pc, pl_, ppc,
                                                 ptab(jt), part, dst)
    assert pok == jok, f"{name}: migrated {pok} vs {jok}"
    same(pt2, jt2, f"{name}: table")
    same(pstats, jstats, f"{name}: migration wire")
    same_arena(ps, js, f"{name}: migrated arena")
    return jt2, js, pt2, ps, pok


def test_migration_moves_partition_and_stale_clients_converge(sweep):
    jpc = jpl.PlacementConfig(N)
    jt = jpl.initial_table(jpc)
    js, ps = hash_cluster()
    B = 4
    k0 = keys_in_part(JCFG, 0, N * B, seed=41).reshape(N, B, 1)
    wk, wv = write_keys(k0), jvals(k0)
    js, ps, res = loop_both("mig-fill", js, ps, read_keys=no_reads(B),
                            write_keys_=wk, write_values=wv, max_rounds=4,
                            table=jt, pcfg=0)
    assert bool(res.committed.all())

    jt2, js, pt2, ps, ok = migrate_both("mig", js, ps, jt, HASH, 0, 2)
    assert ok and int(pt2.epoch) == int(jt.epoch) + 1
    assert int(ppl.owner_of(pt2, 0)) == 2
    # every committed record was copied and is served at the new owner
    out = lookup_both("mig", js, ps, jt2, k0[..., 0])
    assert bool(out["found"].all())
    np.testing.assert_array_equal(to_numpy(out["value"]),
                                  wv.reshape(N, B, psl.VALUE_WORDS))
    assert bool((out["node"] == 2).all())
    # no dangling migration locks anywhere
    st = state_to_numpy(ps)
    for n in range(N):
        assert (slots_of(st, JCFG, JL, n)[:, psl.LOCK] == 0).all()

    # a stale client still converges: wrong-epoch abort, refresh, commit
    js, ps, res2 = loop_both("mig-stale", js, ps, read_keys=no_reads(B),
                             write_keys_=wk, write_values=jvals(k0 + 5),
                             max_rounds=4, table=jt, pcfg=0)
    assert int(res2.round_abort_stale[0]) == N * B
    assert bool(res2.committed.all())


def test_migration_aborts_cleanly_under_conflicting_lock(sweep):
    """The no-lost-write guarantee: a migration racing an in-flight client
    lock fails its source-lock phase, releases everything it took and leaves
    the table unchanged; once the client unlocks, the retry goes through."""
    jt = jpl.initial_table(jpl.PlacementConfig(N))
    js, ps = hash_cluster()
    keys = keys_in_part(JCFG, 0, 4, seed=53)
    kj = np.tile(keys[None], (N, 1))
    only0 = np.zeros((N, 4), bool)
    only0[0] = True
    js, ps, rep_ = insert_both("abort", js, ps, kj, only0,
                               np.zeros((N, 4), np.int32))
    assert (rep_[0, :, 0] == JW.ST_OK).all()

    # a client holds a lock on one key of the partition
    tag = 0x7E570001
    one = np.zeros((N, 1), bool)
    one[0] = True

    def client(js, ps, op, klo, aux):
        jrec = jht.make_record(op, jnp.asarray(klo, jnp.uint32),
                               jnp.zeros((N, 1), jnp.uint32),
                               aux=jnp.asarray(aux, jnp.uint32))
        js, jr, _, _ = JR.rpc_call(JSim(N), js, jnp.zeros((N, 1), jnp.int32),
                                   jrec, jht.make_rpc_handler(JCFG, JL),
                                   enabled=jnp.asarray(one))
        prec = pht.make_record(op, words(klo, CPU),
                               torch.zeros((N, 1), dtype=torch.int32),
                               aux=words(aux, CPU))
        ps, pr, _, _ = PR.rpc_call(PSim(N), ps,
                                   torch.zeros((N, 1), dtype=torch.int32),
                                   prec, pht.make_rpc_handler(PCFG, PL),
                                   enabled=torch.from_numpy(one))
        same(pr, jr, f"client op {op}")
        same_arena(ps, js, f"client op {op}")
        return js, ps, np.asarray(jr)

    js, ps, lrep = client(js, ps, JW.OP_LOCK, kj[:, :1],
                          np.full((N, 1), tag, np.uint32))
    assert int(lrep[0, 0, 0]) == JW.ST_OK
    lock_slot = lrep[0, 0, 1]

    jt2, js, pt2, ps, ok = migrate_both("abort", js, ps, jt, HASH, 0, 2)
    assert not ok, "migration must abort while a client lock is in flight"
    assert int(pt2.epoch) == int(jt.epoch), "an aborted migration flips nothing"
    locks = slots_of(state_to_numpy(ps), JCFG, JL, 0)[:, psl.LOCK]
    assert (locks == np.uint32(tag)).sum() == 1, \
        "the client's lock survives; every migration lock is released"
    assert (locks != 0).sum() == 1

    # the client unlocks; the retried migration goes through
    js, ps, _ = client(js, ps, JW.OP_ABORT_UNLOCK,
                       np.full((N, 1), tag, np.uint32),
                       np.full((N, 1), lock_slot, np.uint32))
    _, _, pt3, ps, ok = migrate_both("abort-retry", js, ps, jt, HASH, 0, 2)
    assert ok and int(ppl.owner_of(pt3, 0)) == 2


def test_migration_churn_loses_no_committed_write():
    """Alternate commit batches with partition migrations (clients one
    epoch stale).  After every round the union of committed writes reads
    back, with its latest value, through the CURRENT table."""
    jt = jpl.initial_table(jpl.PlacementConfig(N))
    js, ps = hash_cluster()
    rng = np.random.RandomState(67)
    committed = {}
    B = 4
    stale_view = jt
    for rnd in range(3):
        klo = rng.randint(0, 2**31, (N, B, 1)).astype(np.uint32)
        wv = jvals(klo + np.uint32(rnd))
        js, ps, res = loop_both(("churn", rnd), js, ps, read_keys=no_reads(B),
                                write_keys_=write_keys(klo), write_values=wv,
                                max_rounds=5, table=stale_view, pcfg=0)
        assert bool(res.committed.all())
        for i, k in enumerate(klo.reshape(-1)):
            committed[int(k)] = wv.reshape(-1, psl.VALUE_WORDS)[i]

        part = int(rng.randint(0, N))
        dst = int(rng.randint(0, N))
        jt2, js, pt2, ps, ok = migrate_both(("churn", rnd), js, ps, jt, HASH,
                                            part, dst)
        assert ok, "no client lock is in flight between batches"
        stale_view, jt = jt, jt2           # clients lag one epoch behind

        # every committed key, repeated to one shape for all three rounds
        ks = np.tile(np.resize(np.asarray(sorted(committed), np.uint32),
                               3 * N * B)[None], (N, 1))
        out = lookup_both(("churn", rnd), js, ps, jt, ks)
        assert bool(out["found"].all()), \
            f"round {rnd}: a committed key vanished after migration"
        want = np.stack([committed[int(k)] for k in ks[0]])
        np.testing.assert_array_equal(to_numpy(out["value"])[0], want)


@pytest.mark.parametrize("part,dst", [(0, 2), (2, 1), (3, 0)])
def test_btree_migration_matches_reference(part, dst, sweep):
    """B-tree migration (OP_BT_LOCK of each leaf's least in-range key,
    OP_BT_BACKUP copy, flip, unlock), f=1: partitions 2 and 3 hold keys
    above 2^31, whose range tests and least key are unsigned.  Every
    committed key then reads back through the new table."""
    js, ps, wk = btree_replicated(31)
    jt = jpl.initial_table(jpl.PlacementConfig(N, f=1))
    jt2, js, pt2, ps, ok = migrate_both(("bt-mig", part, dst), js, ps, jt,
                                        BTREE, part, dst, pcfg_f=1)
    assert ok and int(ppl.owner_of(pt2, part)) == dst
    out = lookup_both(("bt-mig", part), js, ps, jt2, wk[..., 0], BTREE,
                      (jbt, pbt))
    assert bool(out["found"].all())
    np.testing.assert_array_equal(to_numpy(out["value"]),
                                  jvals(wk).reshape(N, 6, psl.VALUE_WORDS))
    lo, hi = (int(psl.u32(x)) for x in pbt.partition_bounds(PBCFG, part))
    assert lo >= 2**31 or part < 2

    # the same upserts from the pre-migration table: the moved partition's
    # lanes abort stale_route in round 0, refresh once and commit
    hits = int(((wk >= lo) & (wk <= hi)).sum())
    _, _, res = scan_both("bt-stale", js, ps, 10, table=jt, pcfg=1, rep=1,
                          scan_lo=wk[..., 0], scan_hi=wk[..., 0],
                          scan_enabled=np.zeros((N, 6), bool),
                          write_keys=wk, write_values=jvals(wk + 1))
    assert int(res.round_abort_stale[0]) == hits > 0
    assert int(res.round_abort_stale[1:].sum()) == 0
    assert bool(res.committed.all())


# ---------------------------------------------------------------------------
# Dead-owner parking: writes park and are REPORTED, never misrouted
# ---------------------------------------------------------------------------
def test_dead_owner_parks_writes_until_repair():
    jpc, ppc = jpl.PlacementConfig(N, f=1), ppl.PlacementConfig(N, f=1)
    jt = jpl.kill_node(jpc, jpl.initial_table(jpc), 1)
    js, ps = hash_cluster()
    js = jpl.install_local(js, JL, jpc, jt)
    ps = ppl.install_local(ps, PL, ppc, ptab(jt))
    B = 4
    k1 = keys_in_part(JCFG, 1, B, seed=71)        # owned by the dead node
    k2 = keys_in_part(JCFG, 2, B, seed=72)        # healthy partition
    klo = np.stack([np.tile(k1, (N, 1)), np.tile(k2, (N, 1))], axis=-1)
    js, ps, res = loop_both("park", js, ps, read_keys=no_reads(B),
                            write_keys_=write_keys(klo),
                            write_values=jvals(klo), max_rounds=3, rep=1,
                            table=jt, pcfg=1)
    assert not bool(res.committed.any()), \
        "a lane touching a dead-owner partition must not commit"
    assert int(res.round_abort_overflow.sum()) > 0, \
        "parked lanes surface as overflow (dropped), never silent"
    st = state_to_numpy(ps)
    for k in k1:
        assert find_copy(st, JCFG, JL, 2, int(k)) is None


# ---------------------------------------------------------------------------
# Membership transition bookkeeping and the host planners
# ---------------------------------------------------------------------------
def test_join_leave_kill_bump_epoch_and_drain_plan():
    pcfg, jpc = ppl.PlacementConfig(N, f=1), jpl.PlacementConfig(N, f=1)
    table = ppl.initial_table(pcfg, device=CPU)
    t1 = ppl.kill_node(pcfg, table, 3)
    t2 = ppl.join_node(pcfg, t1, 3)
    t3 = ppl.leave_node(pcfg, t2, 0)
    assert [int(x.epoch) for x in (t1, t2, t3)] == [1, 2, 3]
    assert bool(t2.alive[3]) and not bool(t3.alive[0])
    j1 = jpl.kill_node(jpc, jpl.initial_table(jpc), 3)
    j2 = jpl.join_node(jpc, j1, 3)
    j3 = jpl.leave_node(jpc, j2, 0)
    for p, j in ((t1, j1), (t2, j2), (t3, j3)):
        same(p, j, "membership transition")
    plan = ppl.drain_plan(pcfg, t2, 0)
    assert plan == jpl.drain_plan(jpc, j2, 0)
    assert len(plan) == 1 and plan[0][0] == 0
    p, dst = plan[0]
    assert dst not in set(int(c) for c in to_numpy(t2.copies)[p]
                          .view(np.int32)), \
        "the drain destination must not already hold a copy"


PLAN_CASES = [  # (n_nodes, f, dead nodes, a rewritten copy row or None)
    (4, 1, [1], None), (4, 1, [1, 2], None), (4, 3, [0], None),
    (8, 2, [2, 5], None), (8, 1, [7], (3, [5, 6, -1, -1])),
    (6, 0, [4], None), (4, 1, [], None), (5, 2, [0, 1, 2], None),
]


@pytest.mark.parametrize("n_nodes,f,dead,row", PLAN_CASES)
def test_repair_and_drain_plans_match_reference(n_nodes, f, dead, row):
    """repair_plan's table and transfer list and drain_plan's moves equal
    the reference's (host planners, deterministic)."""
    jpc, ppc = jpl.PlacementConfig(n_nodes, f=f), ppl.PlacementConfig(
        n_nodes, f=f)
    jt = jpl.initial_table(jpc)
    if row is not None:
        jt = jpl.PlacementTable(jt.epoch, jt.copies.at[row[0]].set(
            jnp.asarray(row[1], jnp.int32)), jt.alive)
    for d in dead:
        jt = jpl.kill_node(jpc, jt, d)
    pt = ptab(jt)
    jr, jtrans = jpl.repair_plan(jpc, jt)
    pr, ptrans = ppl.repair_plan(ppc, pt)
    same(pr, jr, "repair_plan table")
    assert ptrans == jtrans
    for node in range(n_nodes):
        assert ppl.drain_plan(ppc, pr, node) == jpl.drain_plan(jpc, jr, node)


def test_placement_config_validates():
    with pytest.raises(ValueError):
        ppl.PlacementConfig(4, f=-1)
    with pytest.raises(ValueError):
        ppl.PlacementConfig(4, f=4)
    with pytest.raises(ValueError):
        ppl.PlacementConfig(8, f=4)        # f + 1 > MAX_COPIES
    assert ppl.PlacementConfig(4, f=3).n_copies == 4
    with pytest.raises(ValueError):
        ptxl.tx_loop(PSim(N), pht.init_cluster_state(PCFG, device=CPU),
                     PCFG, PL, read_keys=no_reads(2),
                     write_keys=np.zeros((N, 2, 1, 2), np.uint32),
                     write_values=np.zeros((N, 2, 1, psl.VALUE_WORDS),
                                           np.uint32),
                     ptable=ppl.initial_table(ppl.PlacementConfig(N)),
                     device=CPU)


# ---------------------------------------------------------------------------
# One-issuer sweeps: slices of SWEEP_LANES lanes equal the unsplit round
# ---------------------------------------------------------------------------
def test_sweep_slices_equal_the_unsplit_round(monkeypatch):
    """At slices of 7 lanes, a one-issuer bulk read and a one-issuer RPC
    round (the OP_BACKUP_WRITE stream of a sweep, some lanes dead) give the
    reference's unsplit round exactly: the issuer's replies, the owner's
    state and the WireStats (every lane once, the one pair once)."""
    monkeypatch.setattr(ppl, "SWEEP_LANES", 7)
    rng = np.random.RandomState(5)
    klo = rng.randint(0, 2**31, (N, 24)).astype(np.uint32)
    js, ps = hash_cluster()
    js, ps, _ = insert_both("sweep", js, ps, klo, np.ones((N, 24), bool),
                            np.asarray(jht.lookup_start(
                                JCFG, JL, jnp.asarray(klo),
                                jnp.zeros_like(jnp.asarray(klo)))[0]))
    src, puller = 2, 1
    offs = np.asarray([int(jht.slot_idx_offset(JL, jnp.uint32(i)))
                       for i in range(JCFG.n_slots)], np.uint32)
    B = offs.size
    jbuf, _, jst = jcall("sweep-read", lambda: lambda st: josd.remote_read(
        JSim(N), st["arena"], jnp.full((N, B), src, jnp.int32),
        jnp.broadcast_to(jnp.asarray(offs)[None], (N, B)),
        length=jsl.SLOT_WORDS,
        enabled=jnp.broadcast_to((jnp.arange(N) == puller)[:, None], (N, B))),
        js)
    poffs = pht.slot_idx_offset(PL, torch.arange(PCFG.n_slots))
    np.testing.assert_array_equal(to_numpy(poffs), offs)
    images, pst = ppl._read_region_images(PSim(N), ps, src, puller, poffs,
                                          psl.SLOT_WORDS)
    same(images, np.asarray(jbuf)[puller], "sweep read images")
    same(pst, jst, "sweep read wire")

    # the slot images as OP_BACKUP_WRITE records from node 1 to node 3
    live = rng.rand(B) < 0.6
    img = np.asarray(jbuf)[puller]
    jrec = jht.make_record(JW.OP_BACKUP_WRITE, jnp.asarray(img[:, 0]),
                           jnp.asarray(img[:, 1]), aux=jnp.asarray(img[:, 2]),
                           value=jnp.asarray(img[:, jsl.VALUE0:]))
    js, jrep_, _, jst = JR.rpc_call(
        JSim(N), js, jnp.full((N, B), 3, jnp.int32),
        jnp.broadcast_to(jrec[None], (N,) + jrec.shape),
        jht.make_rpc_handler(JCFG, JL),
        enabled=(jnp.arange(N) == puller)[:, None] & jnp.asarray(live)[None])
    prec = pht.make_record(JW.OP_BACKUP_WRITE, images[:, 0], images[:, 1],
                           aux=images[:, 2], value=images[:, psl.VALUE0:])
    ps, prep_, pst = ppl._sweep_rpc(PSim(N), ps, 3, puller, prec,
                                    torch.from_numpy(live),
                                    pht.make_rpc_handler(PCFG, PL))
    same(prep_, np.asarray(jrep_)[puller], "sweep rpc replies")
    same(pst, jst, "sweep rpc wire")
    same_arena(ps, js, "sweep rpc arena")
    assert float(pst.round_trips) == 1.0 and float(pst.messages) == 2.0


def test_sweep_enumeration_of_unsigned_words():
    """A sweep's record selection on int32 bit images: versions at and
    above 2^31 (negative images) keep their parity under ``& 1``, key words
    above 2^31 hash to the reference's partitions, empty slots drop out —
    equal to the reference's numpy enumeration."""
    rng = np.random.RandomState(13)
    img = rng.randint(0, 2**32, (64, jsl.SLOT_WORDS), dtype=np.uint64)
    img = img.astype(np.uint32)
    img[:16, jsl.VERSION] = [0, 1, 2, 3, 0x7FFFFFFE, 0x7FFFFFFF, 0x80000000,
                             0x80000001, 0xFFFFFFFE, 0xFFFFFFFF, 0x80000002,
                             0xC0000001, 4, 5, 0xFFFFFFFC, 0x90000003]
    img[::7, jsl.KEY_LO] = 0xFFFFFFFF                  # empty slots
    for part in range(N):
        want = jpl._enumerate_hash(JCFG, JL, img, part)
        got = ppl._enumerate_hash(PCFG, words(img, CPU), part)
        for k in ("key_lo", "key_hi", "version", "value", "lock", "sel",
                  "clean"):
            same(got[k], want[k], f"part {part}: {k}")
    assert (img[:, jsl.KEY_LO] >= 2**31).sum() > 16


# ---------------------------------------------------------------------------
# The bench gate's membership keys and the stale mix
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def churn():
    """benchmarks/membership_churn.py, imported without leaving benchmarks/
    on sys.path."""
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import membership_churn
    finally:
        sys.path.remove(bench_dir)
    return membership_churn


def test_gate_membership_keys_exact():
    """workloads.gate_membership, with the port's own retry permutations,
    gives the baseline's five membership keys exactly."""
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())["membership"]
    reg = PT.MetricsRegistry()
    keys = pwl.gate_membership(registry=reg, device=CPU)
    assert keys == {"round_trips_stable": 4.0, "commit_rate_stable": 1.0,
                    "refresh_round_trips": 1.0, "rereplication_bytes": 105740.0,
                    "stale_round_trips": 5.0}
    assert keys == baseline
    assert reg.get("membership.rereplication_transfers") == 2.0
    assert reg.get("membership.stale_rounds_to_converge") == 2.0


def test_stale_mix_with_reference_permutations(churn):
    """membership_churn's stale mix (population at f=1 through the table,
    migration of partition 0 to node 3, a write batch from the pre-flip
    table) fed the reference's permutations: arenas, results and the
    abort-cause mix equal to the reference's; with the port's own draws the
    mix still converges after ONE refresh with the same bill."""
    cfg, layout, t, js, _, wk, wv = churn._cluster()
    rep = jrepl.ReplicaConfig(4, 1)
    pcfg = jpl.PlacementConfig(4, f=1)
    jt = jpl.initial_table(pcfg)
    run = jax.jit(lambda st, wk, rounds: jtxl.tx_loop(
        t, st, cfg, layout, read_keys=jnp.zeros((4, 8, 0, 2), jnp.uint32),
        write_keys=wk, write_values=wv, max_rounds=rounds, rep=rep, ptable=jt,
        pcfg=pcfg), static_argnums=(2,))
    js, _, jpop = run(js, wk, 4)       # churn._populated_placement_cluster
    assert bool(np.asarray(jpop.committed).all())
    _, js, _, ok = jpl.migrate_partition(t, js, cfg, layout, pcfg, jt, 0, 3)
    assert ok
    js, _, jres = run(js, wk ^ jnp.uint32(0x5DEECE66), 3)

    perms = (torch.from_numpy(jax_perms(TX_KEY, 4, 4, 8)),
             torch.from_numpy(jax_perms(TX_KEY, 3, 4, 8)))
    numbers, ps, res = pwl.churn_stale_mix(perms=perms, device=CPU)
    same(res, jres, "stale mix")
    same_arena(ps, js, "stale mix arena")
    stale_r = np.asarray(jres.round_abort_stale)
    assert numbers["abort_stale_round0"] == int(stale_r[0]) > 0
    assert numbers["stale_round_trips"] == float(jres.round_trips) == 5.0
    assert numbers["stale_rounds_to_converge"] == int(
        np.asarray(jres.commit_round).max()) + 1

    own, _, _ = pwl.churn_stale_mix(device=CPU)
    assert own == numbers


def test_metrics_registry_matches_reference(tmp_path):
    jreg, preg = JT.MetricsRegistry(), PT.MetricsRegistry()
    for reg in (jreg, preg):
        reg.incr("a.count")
        reg.incr("a.count", 2.5)
        reg.set("b.value", 7)
        reg.observe("lat", [1.0, 2.0, 3.0, 10.0])
    assert preg.as_dict() == jreg.as_dict()
    assert preg.get("missing", 4.0) == 4.0 and preg.get("a.count") == 3.5
    preg.write(str(tmp_path / "p.json"))
    jreg.write(str(tmp_path / "j.json"))
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
