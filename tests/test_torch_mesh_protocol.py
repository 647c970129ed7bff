"""PyTorch port, the Storm protocol's retry loops on the mesh: ``tx_loop``
at f=0 and f=1, with a placement table that goes stale (on every rank, and
on some), with the flight recorder on, ``failover_lookup`` with each node
dead in turn, the B-link tree built on the mesh and ``scan_loop`` at f=0 and
f=1, each on ``MeshTransport(4)`` (four gloo ranks, one node a rank), held
bit for bit against:

  * the JAX package's mesh run (its MeshTransport under shard_map over four
    forced host devices, ``tests/torch_mesh_oracle.py loops``, one
    subprocess started when this module starts), the port fed the
    reference's per-shard backoff draws: each shard splits its own key,
    ``split(sub, 1)``, so its draws differ from the simulator's by design;
  * the port's ``SimTransport(4)`` in this process, with the default draws
    (the cluster's draw, of which each rank takes its row).

Fields compared: arenas, commits, commit rounds, reads (or scan results),
abort causes and attempts by round, the hybrid counts, every WireStats
field and round_trips, and the traced runs' rows, all bit for bit; the
modeled per-lane latencies within LATENCY_ULPS float32 ulps.  Against the reference each rank's values equal its
shard's; against the simulator the lanes concatenate, the per-round counts
and the additive WireStats sum over the ranks, and every exchange's
round_trips is the ranks' largest (read off the traces, row by row).

The world runs in one set of spawned ranks (``run_ranks``, what each rank
runs is ``tests/torch_mesh_ranks.loops_rank``, which imports no JAX).  The
workload contends on purpose: 4 hot keys (4x as likely) in a pool of 48 keys
a node, 32 lanes a node reading 2 and writing 1 of them, and a
per-destination capacity of 8 that overflows, so every round commits some
lanes and aborts others (on the simulator at f=1: 25, 25, 22 and 12 of 128
commit in rounds 0-3) and the draws matter; the stale cases run without a
capacity bound, so each rank's lane 0 (a write to the handed-off partition)
aborts stale in round 0.
"""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import importlib.util
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as MR
from repro_torch.convert import to_numpy
from repro_torch.core import placement as pl
from repro_torch.core import slots as sl
from repro_torch.core import telemetry as T
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import SimTransport
from repro_torch.testing import workloads as wl
from repro_torch.testing.ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = pathlib.Path(__file__).with_name("torch_mesh_oracle.py")
DEADLINE_S = 120          # the world of ranks
ORACLE_S = 240            # the oracle subprocess
N, LANES, ROUNDS, POOL, CAPACITY = 4, 32, 4, 48, 8
HOT, HOT_WEIGHT = 4, 4.0
HANDOFF_PART = 0
REP_KEYS = 24             # keys a node of the replicated population
TREE_KEYS, TREE_SEED, SCAN_SEED, SCAN_FRAC, SCAN_THETA = 24, 5, 11, 0.7, 0.99
PERM_SEED = 0x5707
# the modeled per-lane latency sums each round's event costs in float32: the
# reference over its whole buffer with the rows outside the round masked to
# zero, the port over the round's rows, so the sums may part by an ulp
# (tests/test_torch_telemetry.py holds the simulator's to the same 2 ulps)
LATENCY_ULPS = 2

TX_CASES = ("tx0", "tx1", "tx1traced", "stale", "staletraced", "stale_some",
            "stale_sometraced")
SCAN_CASES = ("scan0", "scan1")
TRACED = ("tx1traced", "staletraced", "stale_sometraced")
# the cases the simulator can run (it holds one table for all its clients)
SIM_CASES = ("tx0", "tx1", "tx1traced", "stale", "staletraced") + SCAN_CASES
PER_ROUND = MR.LOOP_FIELDS[2:]
WIRE = ("round_trips", "messages", "ops", "req_bytes", "reply_bytes",
        "nic_hit_ops", "nic_penalty_us")


# --- inputs (numpy, seeded) ---------------------------------------------------
def _u32(rng, shape, hi=2**32):
    return rng.randint(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def _words(x):
    return to_numpy(x)


def loop_inputs():
    rng = np.random.RandomState(24)
    plo, phi = _u32(rng, (N, POOL), 2**31), _u32(rng, (N, POOL), 2**31)
    flat_lo, flat_hi = plo.reshape(-1), phi.reshape(-1)
    M = N * POOL
    p = np.ones(M)
    p[:HOT] = HOT_WEIGHT
    pick = np.stack([rng.choice(M, 3, replace=False, p=p / p.sum())
                     for _ in range(N * LANES)]).reshape(N, LANES, 3)
    # lane 0 of every node writes a key of the handed-off partition
    cfg = MR.loop_hash_cfg({"n_nodes": N})
    part = to_numpy(ht.part_of(cfg, torch.from_numpy(flat_lo.view(np.int32)),
                               torch.from_numpy(flat_hi.view(np.int32))))
    in_part = np.flatnonzero(part == HANDOFF_PART)
    for n in range(N):
        k = in_part[n % len(in_part)]
        pick[n, 0] = [x for x in range(M) if x != k][:2] + [k]
    keys = np.stack([flat_lo[pick], flat_hi[pick]], -1)
    ren = np.ones((N, LANES, 2), bool)
    ren[..., 1] = rng.rand(N, LANES) < 0.5
    wen = rng.rand(N, LANES, 1) < 0.7
    wen[:, 0] = True
    c = dict(n_nodes=N, lanes=LANES, max_rounds=ROUNDS, capacity=CAPACITY,
             rep_keys=REP_KEYS,
             perm_seed=PERM_SEED, handoff_part=HANDOFF_PART, pool_lo=plo,
             pool_hi=phi, pool_val=_u32(rng, (N, POOL, 27)),
             rk=keys[:, :, :2], wk=keys[:, :, 2:],
             wv=_u32(rng, (N, LANES, 1, 27)), ren=ren, wen=wen)
    # the placement tables: initial, and partition 0 handed to its backup
    pcfg = pl.PlacementConfig(N, f=1)
    old = pl.initial_table(pcfg, device="cpu")
    new = wl.handoff_table(old, HANDOFF_PART)
    c.update(new_epoch=np.uint32(int(new.epoch)), new_copies=new.copies.numpy(),
             new_alive=new.alive.numpy())
    for name, held in (("stale", [old] * N),
                       ("stale_some", [old, new, old, new])):
        c[name + "_epoch"] = np.array([int(x.epoch) for x in held], np.uint32)
        c[name + "_copies"] = np.stack([x.copies.numpy() for x in held])
        c[name + "_alive"] = np.stack([x.alive.numpy() for x in held])
    # the B-link tree's scan mix (range_scan.scan_workload's draws)
    *_, allk, _ = wl.build_tree(N, n_keys=TREE_KEYS, seed=TREE_SEED,
                                device="cpu")
    lo, hi, swk, swen = wl.scan_workload(allk, N, LANES, scan_frac=SCAN_FRAC,
                                         seed=SCAN_SEED, theta=SCAN_THETA,
                                         device="cpu")
    c.update(tree_keys=TREE_KEYS, tree_seed=TREE_SEED, scan_lo=_words(lo),
             scan_hi=_words(hi), scan_wk=_words(swk),
             scan_wv=_words(wl.value_for(swk)), scan_wen=swen.numpy())
    return c


INPUTS = loop_inputs()


def shard_perms(jax, key, rounds, B):
    """The reference loop's draws on a shard of one node (its
    txloop.py:129-131 with N = 1), round 0 the identity: (rounds, 1, B)."""
    jnp = jax.numpy
    out = []
    for rnd in range(rounds):
        key, sub = jax.random.split(key)
        perm = jax.vmap(lambda k: jax.random.permutation(k, B))(
            jax.random.split(sub, 1)).astype(jnp.int32)
        out.append(np.arange(B, dtype=np.int32)[None] if rnd == 0
                   else np.asarray(perm))
    return np.stack(out)


# --- the JAX package's run, started at module start ---------------------------
class Oracle:
    def __init__(self, d):
        self.d, self.out = d, None
        np.savez(d / "loops_in.npz", **INPUTS)
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        self.proc = subprocess.Popen(
            [sys.executable, str(ORACLE), "loops", str(d / "loops_in.npz"),
             str(d / "loops_out.npz")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.t0 = time.monotonic()

    def get(self):
        if self.out is None:
            left = ORACLE_S - (time.monotonic() - self.t0)
            try:
                so, se = self.proc.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                self.proc.kill()
                raise
            assert "ORACLE_OK" in so, se[-3000:]
            self.out = dict(np.load(self.d / "loops_out.npz"))
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:    # the card's machine
        pytest.skip("the reference's runs need JAX")
    o = Oracle(tmp_path_factory.mktemp("loops_oracle"))
    yield o
    o.close()


@pytest.fixture(scope="module")
def perms(oracle):
    import jax
    keys = jax.random.split(jax.random.PRNGKey(PERM_SEED), N)
    return np.stack([shard_perms(jax, keys[r], ROUNDS, LANES)
                     for r in range(N)])


@pytest.fixture(scope="module")
def world(perms, tmp_path_factory):
    t0 = time.monotonic()
    res = run_ranks(MR.loops_rank, N, device="cpu", args=(INPUTS, perms),
                    deadline_s=DEADLINE_S,
                    workdir=tmp_path_factory.mktemp("ranks"),
                    threads=torch_threads.RANK_THREADS)
    print(f"world of {N} ranks: {time.monotonic() - t0:.1f} s")
    return res


@pytest.fixture(scope="module")
def sim():
    """The simulator's runs, default draws."""
    t = SimTransport(N)
    out = {}
    cap = CAPACITY
    for name, f, traced in (("tx0", 0, False), ("tx1", 1, False),
                            ("tx1traced", 1, True)):
        out[name] = MR.tx_loop_case(t, INPUTS, f=f, traced=traced,
                                    capacity=cap)
    for traced in (False, True):
        out["stale" + "traced" * traced] = MR.tx_loop_case(
            t, INPUTS, f=1, traced=traced, ptable=MR.table_rows(
                INPUTS, "stale", 0))
    for dead in range(N):
        out[f"fo{dead}"] = MR.failover_case(t, INPUTS, out["tx1"]["arena"],
                                            dead)
        for r in range(N):
            out[f"fo{dead}only{r}"] = MR.failover_case(
                t, INPUTS, out["tx1"]["arena"], dead, only=r)
    tree = MR.tree_of(t, INPUTS)
    out["tree_arena"] = tree[3]["arena"]
    for name, f in (("scan0", 0), ("scan1", 1)):
        out[name] = MR.scan_loop_case(t, INPUTS, tree, f=f)
    return out


def cat(world, mode, case, key):
    """The ranks' values of ``key``: lanes concatenated, per-round columns
    stacked (rank, round)."""
    join = torch.stack if key in PER_ROUND else torch.cat
    return join([r[mode][case][key] for r in world])


def same(got, want, msg):
    """A port tensor against a reference array, words as their bits."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    if got.dtype == np.int32 and want.dtype == np.uint32:
        want = want.view(np.int32)
    assert got.shape == want.shape, (msg, got.shape, want.shape)
    np.testing.assert_array_equal(got, want, err_msg=msg)


def oracle_case(case):
    """The oracle's key prefix of a port case: the reference runs tx1 and
    the stale cases traced, and its traced runs equal its untraced ones."""
    return case.replace("traced", "")


# --- 1. against the reference's mesh run (the world starts first, beside the
# oracle's compiles) -----------------------------------------------------------
def _loop_keys(case):
    reads = MR.SCAN_READS if case.startswith("scan") else MR.TX_READS
    return MR.LOOP_FIELDS + reads


@pytest.mark.parametrize("case", TX_CASES + SCAN_CASES)
def test_loop_matches_reference(case, world, oracle):
    """Each rank's arena, lanes, per-round counts, hybrid counts, WireStats
    and round_trips equal its shard's of the reference's mesh run, bit for
    bit."""
    o = oracle.get()
    pre = oracle_case(case)
    same(cat(world, "fed", case, "arena"), o[pre + "arena"], "arena")
    for k in _loop_keys(case):
        same(cat(world, "fed", case, k), o[pre + k], k)
    for k in ("onesided_success", "rpc_fallback", "total"):
        same(cat(world, "fed", case, k), o[pre + k], k)
    for k in WIRE:
        same(cat(world, "fed", case, "wire_" + k), o[f"{pre}wire_{k}"], k)
    same(cat(world, "fed", case, "round_trips"), o[pre + "round_trips"],
         "round_trips")
    assert int(cat(world, "fed", case, "commit_round").max()) >= 1, \
        "the workload must contend: a lane commits after a retry"


@pytest.mark.parametrize("case", TRACED)
def test_trace_matches_reference(case, world, oracle):
    """Each rank's flight-recorder rows, row count and drops equal its
    shard's, its per-lane modeled latencies lie within LATENCY_ULPS, and the
    rank exports its own trace."""
    o = oracle.get()
    pre = case.replace("traced", "")
    for r, rk in enumerate(world):
        got = rk["fed"][case]
        n = int(got["trace_n"])
        assert n == int(o[pre + "trace_n"][r]) and n > 0
        assert got["trace_dropped"] == int(o[pre + "trace_dropped"][r]) == 0
        same(got["trace_rows"][:n], o[pre + "trace_rows"][r][:n], "rows")
        np.testing.assert_array_max_ulp(
            got["lane_latency_us"].numpy(), o[pre + "lane_latency_us"][r:r + 1],
            maxulp=LATENCY_ULPS)
        assert got["trace_events"] > n


@pytest.mark.parametrize("case,mode", [
    (c, m) for m in ("fed", "default") for c in TRACED
    if c in SIM_CASES or m == "fed"])
def test_traced_runs_equal_untraced(case, mode, world):
    """The recorder reads the protocol and changes nothing (the default
    draws run no mixed-table case)."""
    for rk in world:
        a, b = rk[mode][case.replace("traced", "")], rk[mode][case]
        for k in a:
            if k != "probes":
                assert torch.equal(a[k], b[k]), (case, k)


@pytest.mark.parametrize("dead", range(N))
def test_failover_matches_reference(dead, world, oracle):
    """failover_lookup from the f=1 run's arenas with node ``dead`` dead:
    each rank's found, values, versions, serving node, slot, overflow and
    dead routes, and its WireStats, equal its shard's."""
    o = oracle.get()
    for k in ("found", "value", "version", "node", "slot_idx", "overflow",
              "dead_route"):
        same(cat(world, "fed", f"fo{dead}", k), o[f"fo{dead}{k}"], k)
    for k in WIRE:
        same(cat(world, "fed", f"fo{dead}", "wire_" + k),
             o[f"fo{dead}wire_{k}"], k)
    node = cat(world, "fed", f"fo{dead}", "node")
    found = cat(world, "fed", f"fo{dead}", "found")
    assert not (node == dead).any() and found.any()


def test_perms_are_the_references_shard_draws(perms, oracle):
    """The per-shard draws fed to the ranks are the oracle's, and differ by
    rank from round 1 on (each shard splits its own key)."""
    o = oracle.get()
    np.testing.assert_array_equal(perms, o["perms"])
    assert (perms[:, 0] == np.arange(LANES)).all()
    assert len({perms[r, 1].tobytes() for r in range(N)}) == N


def test_tree_built_on_the_mesh_is_the_references(world, sim, oracle):
    """build_tree on the mesh (each rank inserts its own node's keys) gives
    the reference's tree (range_scan.build_tree) and the simulator's."""
    o = oracle.get()
    for mode in ("fed", "default"):
        got = torch.cat([r[mode]["tree_arena"] for r in world])
        same(got, o["tree_arena"], "tree arena")
        assert torch.equal(got, sim["tree_arena"])


# --- 2. against the port's simulator --------------------------------------------
@pytest.mark.parametrize("case", SIM_CASES)
def test_loop_matches_the_ports_simulator(case, world, sim):
    """Default draws: the ranks' arenas and lanes concatenate to the
    simulator's, the per-round counts, hybrid counts and additive WireStats
    sum to its, and the loop's round_trips lie between the ranks' largest
    and their sum."""
    s = sim[case]
    for k in ("arena",) + _loop_keys(case):
        got = cat(world, "default", case, k)
        got = got.sum(0).to(got.dtype) if k in PER_ROUND else got
        assert torch.equal(got, s[k]), k
    for k in ("onesided_success", "rpc_fallback", "total") + tuple(
            "wire_" + w for w in WIRE[1:]):
        assert float(cat(world, "default", case, k).sum()) == float(s[k]), k
    rts = cat(world, "default", case, "round_trips")
    assert float(rts.max()) <= float(s["round_trips"]) <= float(rts.sum())


@pytest.mark.parametrize("case", ["tx1traced", "staletraced"])
def test_every_exchange_bills_the_ranks_largest(case, world, sim):
    """Row by row of the traces (default draws): every exchange's
    round_trips on the simulator is the ranks' largest, its other WireStats
    columns and per-destination tails and every SUMMARY count sum over the
    ranks, and the loop's round_trips is the sum of those largest."""
    s = sim[case]
    n = int(s["trace_n"])
    rows = [r["default"][case] for r in world]
    assert all(int(r["trace_n"]) == n for r in rows)
    ranks = torch.stack([r["trace_rows"][:n] for r in rows])
    want = s["trace_rows"][:n]
    fixed = [T.EV_ROUND, T.EV_PHASE, T.EV_CLASSES]
    assert torch.equal(ranks[:, :, fixed], want[None, :, fixed].expand(
        N, n, 3))
    assert torch.equal(ranks[:, :, T.EV_RT].max(0).values, want[:, T.EV_RT])
    add = [c for c in range(want.shape[1]) if c not in fixed + [T.EV_RT]]
    assert torch.equal(ranks[:, :, add].sum(0), want[:, add])
    assert float(want[:, T.EV_RT].sum()) == float(s["round_trips"])


@pytest.mark.parametrize("dead", range(N))
def test_failover_matches_the_ports_simulator(dead, world, sim):
    """The ranks' reads concatenate to the simulator's and their additive
    WireStats sum to its; each rank's WireStats, round_trips included,
    equal the simulator's run with only that rank's node's lanes enabled."""
    s = sim[f"fo{dead}"]
    for k in ("found", "value", "version", "node", "slot_idx", "overflow",
              "dead_route"):
        assert torch.equal(cat(world, "default", f"fo{dead}", k), s[k]), k
    for k in WIRE[1:]:
        assert float(cat(world, "default", f"fo{dead}", "wire_" + k).sum()) \
            == float(s["wire_" + k]), k
    for r, rk in enumerate(world):
        own = sim[f"fo{dead}only{r}"]
        for k in WIRE:
            assert float(rk["default"][f"fo{dead}"]["wire_" + k]) \
                == float(own["wire_" + k]), (r, k)


def test_replicated_population_matches_the_ports_simulator(world):
    """``populate_replicated`` (write-only tx_loop batches at f=1, so no
    read round has a lane) on the mesh: the ranks' arenas are the
    simulator's, and every key sits on its two copies."""
    got = torch.cat([r["rep_population"] for r in world])
    want = MR.replicated_population(SimTransport(N), INPUTS)
    assert torch.equal(got, want)
    layout = ht.build_layout(MR.loop_hash_cfg(INPUTS))
    cfg = MR.loop_hash_cfg(INPUTS)
    base = layout["slots"].base
    slots = got[:, base:base + cfg.n_slots * sl.SLOT_WORDS].reshape(
        N, cfg.n_slots, sl.SLOT_WORDS)
    present = (slots[..., sl.KEY_LO] != sl.EMPTY_KEY).sum()
    assert int(present) == 2 * N * REP_KEYS


# --- 3. the mesh's own rules ----------------------------------------------------
def test_hash_probe_once_per_read_round_per_rank(world):
    """The plain probe (the CPU's hash_probe) is called once per read round
    on every rank: ROUNDS per tx_loop, one per failover lookup."""
    for r in world:
        for mode in ("fed", "default"):
            for case in ("tx0", "tx1", "tx1traced"):
                assert r[mode][case]["probes"] == ROUNDS, (mode, case)
            for dead in range(N):
                assert r[mode][f"fo{dead}"]["probes"] == 1


def test_a_rank_refreshes_only_its_own_stale_table(world):
    """Ranks 0 and 2 hold the pre-handoff table, 1 and 3 the new one: only
    the stale ranks abort stale in round 0 and pay the refresh read in round
    1, while every rank records a REFRESH row in every round."""
    for r, rk in enumerate(world):
        got = rk["fed"]["stale_sometraced"]
        rows = got["trace_rows"][:int(got["trace_n"])]
        ref = rows[rows[:, T.EV_PHASE] == T.PH_REFRESH]
        assert ref.shape[0] == ROUNDS
        stale = r % 2 == 0
        assert (int(got["round_abort_stale"][0]) > 0) == stale
        assert int(got["round_abort_stale"][1:].sum()) == 0
        assert float(ref[1, T.EV_OPS]) == float(stale)
        assert float(ref[[0, 2, 3], T.EV_OPS].sum()) == 0.0


@pytest.mark.parametrize("which", [0, 1], ids=["rereplicate",
                                               "migrate_partition"])
def test_membership_sweeps_refuse_a_mesh(which, world):
    """rereplicate and migrate_partition raise ValueError on every rank of
    a MeshTransport before any exchange, naming the reference's
    simulator-only sweep, instead of leaving the ranks to disagree."""
    for r in world:
        msg = r["sweeps"][which]
        assert msg is not None and "placement.py:435" in msg
