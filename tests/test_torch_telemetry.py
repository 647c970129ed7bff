"""PyTorch port, the flight recorder (``core/telemetry.py``) — the
counterparts of ``tests/test_telemetry.py``, each held against the JAX
package on the same inputs, the port fed the reference's own backoff
permutations:

  * ``telemetry=on`` is bit-identical to ``telemetry=None`` (arenas, results,
    WireStats, round trips), fused and unfused, under back-pressure, at f=1,
    through a stale placement table, and in ``scan_loop``;
  * the trace equals the reference's row for row: integer columns exact, the
    modeled NIC columns within a relative 1e-6; ``n`` and ``dropped`` equal;
    the per-lane modeled latencies within 2 float32 ulps;
  * the rows the port does not issue (gated-off refreshes) are still
    appended as the reference's zero-wire rows;
  * saturation, export, the registry, and a recorder that reads no device
    value on the host."""
import ast
import dataclasses
import inspect
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import nic as jnic  # noqa: E402
from repro.core import onesided as josd  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import telemetry as JT  # noqa: E402
from repro.core import transport as jtp  # noqa: E402
from repro.core import txloop as jtxl  # noqa: E402
from repro.core.datastructs import btree as jbt  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.replication import ReplicaConfig as JRep  # noqa: E402
from repro_torch.convert import state_from_numpy, words  # noqa: E402
from repro_torch.core import nic as pnic  # noqa: E402
from repro_torch.core import onesided as posd  # noqa: E402
from repro_torch.core import placement as ppl  # noqa: E402
from repro_torch.core import rpc as PR  # noqa: E402
from repro_torch.core import telemetry as PT  # noqa: E402
from repro_torch.core import transport as ptp  # noqa: E402
from repro_torch.core import txloop as ptxl  # noqa: E402
from repro_torch.core.datastructs import btree as pbt  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.replication import ReplicaConfig as PRep  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.core.transport import WireStats  # noqa: E402
from tests.test_telemetry import _bt_cluster, _ht_cluster  # noqa: E402
from tests.test_torch_btree import same  # noqa: E402
from tests.test_torch_txloop import jax_perms  # noqa: E402

CPU = "cpu"
N = 4
TX_KEY, SCAN_KEY = jax.random.PRNGKey(0x5707), jax.random.PRNGKey(0x5C0A)
HT_KW = dict(n_nodes=N, n_buckets=64, bucket_width=2, n_overflow=64,
             max_chain=6)
BT_KW = dict(n_nodes=N, n_leaves=32, leaf_width=4, max_scan_leaves=4)
# modeled columns (the ConnTable's float constants times ops); the other
# columns hold integer counts and must agree exactly
FLOAT_COLS = (JT.EV_NIC_HIT_OPS, JT.EV_NIC_PENALTY)


def as_port(x):
    """A JAX word/bool array as the port's tensor."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy()) if a.dtype == bool else words(a, CPU)


def same_port(a, b, what=""):
    """Two port results (dataclasses of tensors, dicts, tuples) equal."""
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_port(getattr(a, f.name), getattr(b, f.name),
                      f"{what}.{f.name}")
    elif isinstance(a, dict):
        for k in a:
            same_port(a[k], b[k], f"{what}[{k}]")
    elif isinstance(a, (tuple, list)):
        for i, (x, y) in enumerate(zip(a, b)):
            same_port(x, y, f"{what}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), what
    else:
        assert a == b, what


def same_trace(ptel, jtel):
    """The port's TelemetryOut against the reference's: rows, counters and
    per-lane latencies."""
    pt, jt = ptel.trace, jtel.trace
    assert (pt.capacity, pt.n_dst) == (jt.capacity, jt.n_dst)
    assert (pt.n, pt.dropped) == (int(jt.n), int(jt.dropped))
    pev, jev = PT.events(pt), JT.events(jt)
    assert pev.shape == jev.shape
    exact = [c for c in range(jev.shape[1]) if c not in FLOAT_COLS]
    np.testing.assert_array_equal(pev[:, exact], jev[:, exact])
    np.testing.assert_allclose(pev[:, FLOAT_COLS], jev[:, FLOAT_COLS],
                               rtol=1e-6)
    np.testing.assert_array_max_ulp(
        ptel.lane_latency_us.numpy(), np.asarray(jtel.lane_latency_us),
        maxulp=2)
    return pev


# ---------------------------------------------------------------------------
# WireStats and per-destination tails
# ---------------------------------------------------------------------------
def test_wirestats_zero_add_roundtrip_every_field():
    fields = dataclasses.fields(WireStats)
    z = WireStats.zero() + WireStats.zero()
    for f in fields:
        assert float(getattr(z, f.name)) == 0.0, f"zero()+zero() leaked {f.name}"
    w = WireStats(**{f.name: torch.tensor(i + 1.0)
                     for i, f in enumerate(fields)})
    s = w + WireStats.zero()
    for i, f in enumerate(fields):
        assert float(getattr(s, f.name)) == i + 1.0, \
            f"zero() + w misassigned {f.name}"
    d = w + w
    for i, f in enumerate(fields):
        assert float(getattr(d, f.name)) == 2.0 * (i + 1.0)


def test_per_dest_wire_reconciles_with_scalar_accounting():
    rng = np.random.RandomState(3)
    n_src, n_dst = 4, 5
    masks = [rng.rand(n_src, n_dst, c) < 0.4 for c in (3, 2)]
    req_w, rep_w = [4, 7], [2, 0]
    msgs, byts = ptp.per_dest_wire([torch.from_numpy(m) for m in masks],
                                   req_w, rep_w)
    jm, jb = jtp.per_dest_wire([jnp.asarray(m) for m in masks], req_w, rep_w)
    np.testing.assert_array_equal(msgs.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(byts.numpy(), np.asarray(jb))
    scalar = ptp.wire_for_classes([torch.from_numpy(m) for m in masks],
                                  req_w, rep_w)
    assert float(msgs.sum()) == float(scalar.messages)
    assert float(byts.sum()) == float(scalar.total_bytes)


# ---------------------------------------------------------------------------
# tx_loop: recorder on vs off, and against the reference's trace
# ---------------------------------------------------------------------------
def ht_both(seed=1, B=8):
    """test_telemetry's contended hash-table cluster in both packages."""
    cfg, layout, t, js, rk, wk, wv = _ht_cluster(seed=seed, B=B)
    pcfg = pht.HashTableConfig(**HT_KW)
    ps = state_from_numpy(jax.device_get(js), CPU)
    return (cfg, layout, t, js, rk, wk, wv), (
        pcfg, pht.build_layout(pcfg), PSim(N), ps,
        as_port(rk), as_port(wk), as_port(wv))


def tx_both(max_rounds, tcfg=JT.TelemetryConfig(), ptcfg=PT.TelemetryConfig(),
            *, capacity=None, rep_f=0, fused=True, nic=None, ptable=None,
            pcfg=None, setup=None):
    """tx_loop through both packages with the recorder on, and through the
    port with it off.  ``setup`` edits both states first.  Returns (port
    result, port TelemetryOut, JAX TelemetryOut)."""
    (cfg, layout, t, js, rk, wk, wv), (c, lay, pt, ps, prk, pwk, pwv) = \
        ht_both()
    if setup is not None:
        js, ps = setup(cfg, layout, js, ps)
    B = rk.shape[1]
    jkw = dict(read_keys=rk, write_keys=wk, write_values=wv,
               max_rounds=max_rounds, capacity=capacity, fused=fused,
               rep=JRep(N, rep_f) if rep_f else None,
               nic=None if nic is None else jnic.ConnTable(**nic),
               ptable=None if ptable is None else ptable[0],
               pcfg=None if pcfg is None else jpl.PlacementConfig(N, f=pcfg))
    js2, _, jres, jtel = jax.jit(lambda st: jtxl.tx_loop(
        t, st, cfg, layout, telemetry=tcfg, **jkw))(js)
    kw = dict(read_keys=prk, write_keys=pwk, write_values=pwv,
              max_rounds=max_rounds, capacity=capacity, fused=fused,
              rep=PRep(N, rep_f) if rep_f else None,
              nic=None if nic is None else pnic.ConnTable(**nic),
              pcfg=None if pcfg is None else ppl.PlacementConfig(N, f=pcfg),
              perms=torch.from_numpy(jax_perms(TX_KEY, max_rounds, N, B)),
              device=CPU)
    off = ptxl.tx_loop(pt, {"arena": ps["arena"].clone()}, c, lay,
                       ptable=None if ptable is None else ptable[1], **kw)
    s1, _, r1, tel = ptxl.tx_loop(pt, ps, c, lay, telemetry=ptcfg,
                                  ptable=None if ptable is None else
                                  ptable[1], **kw)
    same_port((s1, r1), (off[0], off[2]), "recorder on vs off")
    same(r1, jres, "tx_loop")
    np.testing.assert_array_equal(s1["arena"].numpy().view(np.uint32),
                                  np.asarray(js2["arena"]))
    return r1, tel, jtel


@pytest.mark.parametrize("capacity,rep_f,fused", [
    (None, 0, True), (2, 0, True), (None, 1, True), (None, 0, False),
    (2, 1, False)], ids=["plain", "backpressure", "f1", "unfused",
                         "unfused-backpressure-f1"])
def test_tx_loop_telemetry_equivalence(capacity, rep_f, fused):
    res, tel, jtel = tx_both(5, capacity=capacity, rep_f=rep_f, fused=fused)
    ev = same_trace(tel, jtel)
    assert tel.trace.n > 0 and tel.trace.dropped == 0
    lat = tel.lane_latency_us.numpy()
    assert lat.shape == res.committed.shape
    assert np.isfinite(lat).all() and (lat > 0).all()
    assert int(res.round_retries.sum()) > 0          # the retry path ran
    if not fused:
        assert {JT.PH_FALLBACK, JT.PH_VALIDATE} <= set(ev[:, JT.EV_PHASE])


def test_trace_rows_reconcile_and_price():
    """With a ConnTable the modeled NIC columns and the per-op penalty
    enter the price; rows reconcile with the loop's WireStats and SUMMARY
    rows carry its abort vector."""
    nic = dict(n_nodes=96, threads=20, mode="rc_exclusive")
    res, tel, jtel = tx_both(4, nic=nic)
    ev = same_trace(tel, jtel)
    assert ev.shape[1] == PT.EV_WORDS + 2 * N
    assert (ev[:, PT.EV_NIC_PENALTY] > 0).any()
    phases = set(int(r[PT.EV_PHASE]) for r in ev)
    assert {PT.PH_READ, PT.PH_LOCK, PT.PH_COMMIT, PT.PH_SUMMARY} <= phases
    np.testing.assert_array_equal(ev[:, PT.EV_WORDS:PT.EV_WORDS + N].sum(1),
                                  ev[:, PT.EV_MSGS])
    np.testing.assert_array_equal(
        ev[:, PT.EV_WORDS + N:].sum(1),
        ev[:, PT.EV_REQ_BYTES] + ev[:, PT.EV_REPLY_BYTES])
    w = res.metrics.wire
    assert ev[:, PT.EV_MSGS].sum() == float(w.messages)
    assert ev[:, PT.EV_WORDS + N:].sum() == float(w.total_bytes)
    assert ev[:, PT.EV_RT].sum() == float(res.round_trips)
    summ = ev[ev[:, PT.EV_PHASE] == PT.PH_SUMMARY]
    assert len(summ) == 4
    for col, name in ((PT.EV_COMMITTED, "committed"),
                      (PT.EV_ATTEMPTS, "attempts"),
                      (PT.EV_AB_LOCK, "abort_lock"),
                      (PT.EV_AB_VALIDATE, "abort_validate"),
                      (PT.EV_AB_OVERFLOW, "abort_overflow"),
                      (PT.EV_AB_STALE, "abort_stale")):
        np.testing.assert_array_equal(
            summ[:, col], getattr(res, f"round_{name}").numpy())


def test_trace_buffer_saturates_without_error():
    res, tel, jtel = tx_both(4, JT.TelemetryConfig(capacity=3),
                             PT.TelemetryConfig(capacity=3))
    same_trace(tel, jtel)
    assert tel.trace.n == 3 and tel.trace.dropped > 0


def test_stale_placement_mix_records_the_reference_zero_refresh_rows():
    """A client whose table predates a migration: round 0 aborts
    stale_route, round 1 pays the one refresh, and every other round's
    gated-off refresh — which the port never issues — is still the
    reference's zero-wire REFRESH row."""
    fresh = jpl.PlacementTable(
        jnp.uint32(1),
        jpl.initial_table(jpl.PlacementConfig(N)).copies.at[0, 0].set(2),
        jnp.ones((N,), bool))
    pfresh = ppl.PlacementTable(
        epoch=words(np.asarray(fresh.epoch), CPU),
        copies=torch.from_numpy(np.array(fresh.copies)),
        alive=torch.from_numpy(np.array(fresh.alive)))

    def setup(cfg, layout, js, ps):
        js = jpl.install_local(js, layout, jpl.PlacementConfig(N), fresh)
        ps = ppl.install_local(ps, pht.build_layout(pht.HashTableConfig(
            **HT_KW)), ppl.PlacementConfig(N), pfresh)
        return js, ps

    stale = (jpl.initial_table(jpl.PlacementConfig(N)),
             ppl.initial_table(ppl.PlacementConfig(N), device=CPU))
    res, tel, jtel = tx_both(4, ptable=stale, pcfg=0, setup=setup)
    ev = same_trace(tel, jtel)
    assert int(res.round_abort_stale[0]) > 0
    assert int(res.round_abort_stale[1:].sum()) == 0
    ref = ev[ev[:, PT.EV_PHASE] == PT.PH_REFRESH]
    np.testing.assert_array_equal(ref[:, PT.EV_ROUND], np.arange(4))
    assert ref[1, PT.EV_RT] == 1.0 and ref[1, PT.EV_OPS] == N
    zero = ref[[0, 2, 3]]
    assert (zero[:, PT.EV_RT:] == 0).all() and (zero[:, PT.EV_CLASSES] == 1).all()


# ---------------------------------------------------------------------------
# scan_loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["fetch", "given-meta", "no-refresh",
                                  "placement"])
def test_scan_loop_telemetry_equivalence(case):
    """Recorder on == off, and the reference's trace: the up-front
    directory fetch (round -1), the gated directory refresh of every round
    (zero wire in round 0) and, through an epoch-stable placement table,
    its gated-off refresh rows."""
    cfg, layout, t, js, lo, hi, wk, wv = _bt_cluster()
    pcfg = pbt.BTreeConfig(**BT_KW)
    lay = pbt.build_layout(pcfg)
    ps = state_from_numpy(jax.device_get(js), CPU)
    max_rounds, B = 3, lo.shape[1]
    meta = None if case == "fetch" else jbt.local_meta(cfg, layout, js)
    pmeta = None if case == "fetch" else pbt.local_meta(pcfg, lay, ps)
    refresh = case != "no-refresh"
    jtab = ptab = jpc = ppc = None
    if case == "placement":
        jpc, ppc = jpl.PlacementConfig(N), ppl.PlacementConfig(N)
        jtab = jpl.initial_table(jpc)
        ptab = ppl.initial_table(ppc, device=CPU)
    js2, jm, jres, jtel = jax.jit(lambda st, m: jtxl.scan_loop(
        t, st, cfg, layout, scan_lo=lo, scan_hi=hi, meta=m, write_keys=wk,
        write_values=wv, max_rounds=max_rounds, refresh=refresh,
        ptable=jtab, pcfg=jpc, telemetry=JT.TelemetryConfig()))(js, meta)
    kw = dict(scan_lo=as_port(lo), scan_hi=as_port(hi), write_keys=as_port(wk),
              write_values=as_port(wv), max_rounds=max_rounds,
              refresh=refresh, ptable=ptab, pcfg=ppc,
              perms=torch.from_numpy(jax_perms(SCAN_KEY, max_rounds, N, B)),
              device=CPU)
    off = ptxl.scan_loop(PSim(N), {"arena": ps["arena"].clone()}, pcfg, lay,
                         meta=pmeta, **kw)
    s1, m1, r1, tel = ptxl.scan_loop(PSim(N), ps, pcfg, lay, meta=pmeta,
                                     telemetry=PT.TelemetryConfig(), **kw)
    same_port((s1, m1, r1), off, "recorder on vs off")
    same(r1, jres, "scan_loop")
    np.testing.assert_array_equal(s1["arena"].numpy().view(np.uint32),
                                  np.asarray(js2["arena"]))
    ev = same_trace(tel, jtel)
    assert int((ev[:, PT.EV_ROUND] < 0).sum()) == (case == "fetch")
    ref = ev[(ev[:, PT.EV_PHASE] == PT.PH_REFRESH) & (ev[:, PT.EV_ROUND] >= 0)]
    per_round = (refresh + (case == "placement"))
    assert len(ref) == per_round * max_rounds
    if refresh:
        d = ref[::per_round]                   # the directory rows
        assert (d[0, PT.EV_RT:] == 0).all()
        assert (d[1:, PT.EV_RT] == 1).all() and (d[1:, PT.EV_OPS] > 0).all()
    if case == "placement":
        assert (ref[1::2, PT.EV_RT:] == 0).all()


# ---------------------------------------------------------------------------
# Export, summaries, registry, and the recorder's host discipline
# ---------------------------------------------------------------------------
def test_export_trace_and_summaries():
    res, tel, jtel = tx_both(4)
    doc = PT.export_trace(tel.trace)
    assert doc == JT.export_trace(jtel.trace)
    json.dumps(doc)
    kinds = {e["ph"] for e in doc["traceEvents"]}
    assert kinds == {"M", "X", "C"}
    assert doc["otherData"]["dropped"] == 0
    ts = [e["ts"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert ts == sorted(ts), "modeled timeline must be monotone"
    s = PT.summarize([1.0, 2.0, 3.0, 4.0])
    assert s["p50"] == pytest.approx(2.5) and s["mean"] == pytest.approx(2.5)
    assert s["p50"] <= s["p90"] <= s["p99"]
    assert all(np.isnan(v) for v in PT.summarize([]).values())
    paths = PT.latency_by_path(tel.lane_latency_us, res.committed,
                               res.commit_round)
    jpaths = JT.latency_by_path(jtel.lane_latency_us,
                                np.asarray(res.committed),
                                np.asarray(res.commit_round))
    assert paths.keys() == jpaths.keys() and "committed" in paths
    for k, grp in paths.items():
        assert grp["p50"] <= grp["p99"]
        for q, v in grp.items():
            assert v == pytest.approx(jpaths[k][q], rel=1e-6)


def test_metrics_registry():
    reg = PT.MetricsRegistry()
    reg.incr("a.count")
    reg.incr("a.count", 2.5)
    reg.set("b", 7)
    reg.observe("lat_us", [1.0, 9.0])
    d = reg.as_dict()
    assert d["a.count"] == 3.5 and d["b"] == 7.0
    assert d["lat_us.p50"] == pytest.approx(5.0)
    assert reg.get("missing", 1.25) == 1.25


def test_recorder_reads_no_device_value_on_the_host():
    """Recording costs the protocol no host synchronisation: Recorder calls
    no .item() / .tolist() and no int() / bool() / float() at all."""
    tree = ast.parse(inspect.getsource(PT.Recorder))
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        f = node.func
        assert not (isinstance(f, ast.Name)
                    and f.id in ("int", "bool", "float")), ast.unparse(node)
        assert not (isinstance(f, ast.Attribute)
                    and f.attr in ("item", "tolist", "cpu", "numpy")), \
            ast.unparse(node)


def test_single_rounds_record_like_reference():
    """Direct rounds (PH_OTHER) record as the reference's: an rpc_call, a
    remote_read, and a read that can deliver nothing (capacity 0) both
    through remote_read (the fused round's early return) and through the
    port's read_round (the probe's READ row)."""
    (cfg, layout, t, js, *_), (c, lay, pt, ps, *_) = ht_both()
    jh = jht.make_lookup_handler_vector(cfg, layout)
    ph = pht.make_lookup_handler_vector(c, lay)
    rng = np.random.RandomState(5)
    jk = jnp.asarray(rng.randint(0, 2**31, (N, 3)), jnp.uint32)
    jdest = jnp.asarray(rng.randint(0, N, (N, 3)), jnp.int32)
    jrec = JT.Recorder(JT.TelemetryConfig(), JT.make_buffer(N, 5))
    prec = PT.Recorder(PT.TelemetryConfig(), PT.make_buffer(N, 5, CPU))
    jrecs = jht.make_record(JR.OP_LOOKUP, jk, jnp.zeros_like(jk))
    JR.rpc_call(t, js, jdest, jrecs, jh, telemetry=jrec)
    PR.rpc_call(pt, ps, as_port(jdest), as_port(jrecs), ph, telemetry=prec)
    joff = jnp.zeros((N, 3), jnp.uint32)
    for cap in (None, 0, 0):
        jout = josd.remote_read(t, js["arena"], jdest, joff, length=8,
                                capacity=cap, telemetry=jrec)
    for cap in (None, 0):
        pout = posd.remote_read(pt, ps["arena"], as_port(jdest),
                                as_port(joff), length=8, capacity=cap,
                                telemetry=prec)
    for j, p in zip(jout, pout[:2]):      # the early return's replies
        np.testing.assert_array_equal(p.numpy(), np.asarray(j))
    posd.read_round(pt, as_port(jdest), as_port(joff), length=8, capacity=0,
                    telemetry=prec)
    np.testing.assert_array_equal(PT.events(prec.buf), JT.events(jrec.buf))
    assert prec.buf.n == 4 and prec.buf.dropped == 0
