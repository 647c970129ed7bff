"""PyTorch port, the mesh dataplane: ``MeshTransport`` over a
``torch.distributed`` process group, the protocol and OCC transactions on
it, ``Topology`` and the three sharded branches (vocab-sharded embedding,
sequence-sharded decode attention, the sharded MoE dispatch modes), held
against the JAX package.

The port runs in worlds of gloo ranks spawned by
``repro_torch.testing.ranks.run_ranks`` (a ``file://`` rendezvous under
pytest's temporary directory, a deadline per world); what each rank runs is
in ``tests/torch_mesh_ranks.py``, which imports nothing of JAX.  The JAX
package's runs come from ``tests/torch_mesh_oracle.py`` in subprocesses
with forced host devices (8, or 512 for the production meshes), started
together when this module starts and read back from ``.npz`` files.

Tolerances: the dataplane (replies, found, values, arenas, commits, abort
causes, WireStats per rank) and the embedding lookups are bit for bit; the
decode attention and the MoE layer, float32, within 1e-5 of the largest
|value| of the reference's output (the sums run in another order; the MoE
outputs are exact functions of the routing, so a routing that differed
would show far above that).
"""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import torch_mesh_ranks as MR
from repro_torch.configs.registry import ARCHS, get
from repro_torch.convert import to_numpy
from repro_torch.core.transport import SimTransport
from repro_torch.models import api
from repro_torch.parallel import sharding as S
from repro_torch.serving import decode as D
from repro_torch.testing.ranks import run_ranks

ROOT = pathlib.Path(__file__).resolve().parents[1]
ORACLE = pathlib.Path(__file__).with_name("torch_mesh_oracle.py")
DEADLINE_S = 120          # every world of ranks
ORACLE_S = 300            # every oracle subprocess
REL = 1e-5                # decode attention and MoE, float32


# --- inputs (numpy, seeded) ---------------------------------------------------
def _u32(rng, shape, hi=2**32):
    return rng.randint(0, hi, size=shape, dtype=np.uint64).astype(np.uint32)


def lookup_case(n_nodes, B, seed, cache_slots=0, lookups=1):
    rng = np.random.RandomState(seed)
    return dict(n_nodes=n_nodes, cache_slots=cache_slots, lookups=lookups,
                klo=_u32(rng, (n_nodes, B), 2**31),
                khi=_u32(rng, (n_nodes, B), 2**31),
                vals=_u32(rng, (n_nodes, B, 27)))


def tx_case(seed, *, pool, capacity, use_onesided, fused, N=4, B=8, Rd=2,
            Wr=1):
    """N nodes x B lanes of transactions over a pool of ``pool`` keys a node
    (all inserted first): each lane reads Rd and writes Wr distinct keys of
    the whole pool, a ragged share of them disabled."""
    rng = np.random.RandomState(seed)
    plo, phi = _u32(rng, (N, pool), 2**31), _u32(rng, (N, pool), 2**31)
    flat_lo, flat_hi = plo.reshape(-1), phi.reshape(-1)
    pick = np.stack([rng.permutation(N * pool)[:Rd + Wr]
                     for _ in range(N * B)]).reshape(N, B, Rd + Wr)
    keys = np.stack([flat_lo[pick], flat_hi[pick]], -1)
    ren = np.ones((N, B, Rd), bool)
    ren[..., 1:] = rng.rand(N, B, Rd - 1) < 0.5
    wen = rng.rand(N, B, Wr) < 0.6
    return dict(n_nodes=N, cache_slots=0, pool_lo=plo, pool_hi=phi,
                pool_val=_u32(rng, (N, pool, 27)), rk=keys[:, :, :Rd],
                wk=keys[:, :, Rd:], wv=_u32(rng, (N, B, Wr, 27)), ren=ren,
                wen=wen, capacity=capacity, use_onesided=use_onesided,
                fused=fused)


LOOKUPS = {"look4": lookup_case(4, 16, 0),
           "look4c": lookup_case(4, 16, 1, cache_slots=64, lookups=2),
           "look8": lookup_case(8, 16, 0)}
# a contended batch under a per-destination capacity of 3 < B (lanes
# dropped by back-pressure) and an RPC-only one, each on both schedules
TXS = {f"tx{w}{s}": tx_case(seed, fused=s == "f", **kw)
       for w, seed, kw in (("a", 5, dict(pool=4, capacity=3,
                                         use_onesided=True)),
                           ("b", 6, dict(pool=8, capacity=-1,
                                         use_onesided=False)))
       for s in ("f", "p")}
MESHES = ((1, 2), (1, 4), (2, 2))


def branch_cases(shape):
    """The sharded branches on a (data, model) mesh of ``shape``, float32:
    embed_lookup "rpc"/"onesided" at a vocab the model axis divides and
    "rpc" at one it does not; gemma2's smoke decode attention ("seq", and
    "heads" with kv heads that split) with its window and softcap; granite's
    smoke MoE layer in every mode at the default capacity factor."""
    dp, tp = shape
    rng = np.random.RandomState(10 * dp + tp)
    f32 = lambda *s: rng.randn(*s).astype(np.float32)
    cases = {}
    B = 2 * dp
    for V, modes in ((64, ("rpc", "onesided")), (64 + tp // 2 + 1, ("rpc",))):
        table, tokens = f32(V, 16), rng.randint(0, V, (B, 8)).astype(np.int32)
        for mode in modes:
            cases[f"emb{V}{mode}"] = dict(kind="embed", mode=mode,
                                          table=table, tokens=tokens)
    g = get("gemma2-27b").smoke()
    S_ = 128
    for mode, kvh in (("seq", g.n_kv_heads), ("heads", tp)):
        q = f32(B, g.n_heads, g.head_dim)
        kc, vc = (f32(B, S_, kvh, g.head_dim) for _ in range(2))
        lens = rng.randint(1, S_ + 1, B).astype(np.int32)
        cases[f"dec{mode}"] = dict(kind="decode", arch="gemma2-27b",
                                   mode=mode, n_kv_heads=kvh, window=64, q=q,
                                   kc=kc, vc=vc, lens=lens)
    m = get("granite-moe-1b-a400m").smoke()
    E, d, f = m.n_experts, m.d_model, m.d_ff
    x = f32(B, 8, d)
    w = dict(router=f32(d, E), wg=f32(E, d, f) * 0.2, wu=f32(E, d, f) * 0.2,
             wd=f32(E, f, d) * 0.2)
    for mode in ("rpc", "onesided", "replicated", "auto"):
        cases[f"moe{mode}"] = dict(kind="moe", arch="granite-moe-1b-a400m",
                                   mode=mode, x=x, **w)
    return cases


BRANCHES = {f"m{dp}x{tp}": branch_cases((dp, tp)) for dp, tp in MESHES}


def _flat_inputs(cases, extra=None):
    out = {"cases": np.asarray(",".join(cases))}
    for name, c in cases.items():
        for k, v in c.items():
            out[name + k] = np.asarray(v)
        for k, v in (extra or {}).get(name, {}).items():
            out[name + k] = np.asarray(v)
    return out


# --- the JAX package's runs, started together at module start ----------------
class Oracles:
    def __init__(self, d):
        self.d, self.procs, self.outs = d, {}, {}
        branch = {}
        for mname, cases in BRANCHES.items():
            shape = tuple(int(v) for v in mname[1:].split("x"))
            for cname, c in cases.items():
                branch[f"{mname}{cname}"] = dict(c, mesh=np.asarray(shape))
        inputs = {"protocol": _flat_inputs({**LOOKUPS, **TXS}),
                  "branches": _flat_inputs(branch), "specs": {}}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        env.pop("XLA_FLAGS", None)
        for kind, inp in inputs.items():
            np.savez(d / f"{kind}_in.npz", **inp)
            self.procs[kind] = subprocess.Popen(
                [sys.executable, str(ORACLE), kind, str(d / f"{kind}_in.npz"),
                 str(d / f"{kind}_out.npz")], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        self.t0 = time.monotonic()

    def get(self, kind):
        if kind not in self.outs:
            p = self.procs[kind]
            left = ORACLE_S - (time.monotonic() - self.t0)
            try:
                so, se = p.communicate(timeout=max(left, 1))
            except subprocess.TimeoutExpired:
                p.kill()
                raise
            assert "ORACLE_OK" in so, se[-3000:]
            self.outs[kind] = dict(np.load(self.d / f"{kind}_out.npz"))
        return self.outs[kind]

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module", autouse=True)
def oracles(tmp_path_factory):
    if importlib.util.find_spec("jax") is None:    # the card's machine
        yield None
        return
    o = Oracles(tmp_path_factory.mktemp("oracles"))
    yield o
    o.close()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return tmp_path_factory.mktemp("ranks")


def ranks(fn, world, workdir, *args):
    return run_ranks(fn, world, device="cpu", args=args,
                     deadline_s=DEADLINE_S, workdir=workdir,
                     threads=torch_threads.RANK_THREADS)


def stack(per_rank, key):
    return np.concatenate([to_numpy(r[key]) for r in per_rank])


# --- 1. exchange ----------------------------------------------------------------
@pytest.mark.parametrize("world", [2, 4])
def test_exchange_matches_simulator(world, workdir):
    rng = np.random.RandomState(world)
    cases = [rng.randint(-2**31, 2**31, (world, world, 3, 5), dtype=np.int64)
             .astype(np.int32),                                    # words
             rng.rand(world, world, 4) < 0.5,                      # masks
             np.zeros((world, world, 0, 5), np.int32)]             # empty
    for rank_res in ranks(MR.exchange_rank, world, workdir, cases):
        for got, want in rank_res:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(got, want)


# --- 2. rpc_call + hybrid_lookup at 4 and 8 ranks ----------------------------
@pytest.fixture(scope="module")
def lookup_runs(workdir):
    out = {}
    for world in (4, 8):
        names = [n for n, c in LOOKUPS.items() if c["n_nodes"] == world]
        res = ranks(MR.lookup_rank, world, workdir,
                    [LOOKUPS[n] for n in names])
        for i, n in enumerate(names):
            out[n] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("case", list(LOOKUPS))
def test_protocol_matches_reference(case, lookup_runs, oracles):
    """Replies, found, values, versions and slots bit for bit against the
    JAX package's SimTransport and MeshTransport runs; the arenas; per-rank
    WireStats and hybrid counts against its mesh run; one plain-probe call
    (the CPU's hash_probe) per read round per rank.  The cached case's
    second lookup reads cached addresses (hit lanes)."""
    o = oracles.get("protocol")
    per_rank = lookup_runs[case]
    rep0 = stack(per_rank, "rep0")
    arena = stack(per_rank, "arena")
    for run in ("sim", "mesh"):
        np.testing.assert_array_equal(rep0, o[f"{case}{run}_rep0"])
        np.testing.assert_array_equal(arena, o[f"{case}{run}_arena"])
    for i in range(LOOKUPS[case]["lookups"]):
        looks = [r["looks"][i] for r in per_rank]
        assert [lk["probes"] for lk in looks] == [1] * len(looks)
        for k in ("found", "value", "version", "slot", "overflow"):
            got = stack(looks, k)
            for run in ("sim", "mesh"):
                np.testing.assert_array_equal(got, o[f"{case}{run}{i}_{k}"],
                                              err_msg=f"{run} {i} {k}")
        for k in ("onesided_success", "rpc_fallback", "total",
                  "round_trips", "messages", "ops", "req_bytes",
                  "reply_bytes", "nic_hit_ops", "nic_penalty_us"):
            key = f"{case}mesh{i}_{'wire_' * (k not in ('onesided_success', 'rpc_fallback', 'total'))}{k}"
            np.testing.assert_array_equal(stack(looks, k), o[key], err_msg=k)
    if LOOKUPS[case]["cache_slots"]:
        second = [r["looks"][1] for r in per_rank]
        assert stack(second, "onesided_success").sum() > \
            stack([r["looks"][0] for r in per_rank], "onesided_success").sum()


# --- 3. transactions at 4 ranks ----------------------------------------------
@pytest.fixture(scope="module")
def tx_runs(workdir):
    res = ranks(MR.tx_rank, 4, workdir, list(TXS.values()))
    return {n: [r[i] for r in res] for i, n in enumerate(TXS)}


TX_FIELDS = ("arena", "committed", "read_found", "read_values",
             "aborted_lock", "aborted_validate", "aborted_overflow",
             "aborted_stale", "round_trips", "onesided_success",
             "rpc_fallback", "total")
WIRE_FIELDS = ("round_trips", "messages", "ops", "req_bytes", "reply_bytes",
               "nic_hit_ops", "nic_penalty_us")


@pytest.mark.parametrize("case", list(TXS))
def test_transactions_match_reference(case, tx_runs, oracles):
    """run_transactions (fused and per-phase) on 4 ranks against the JAX
    package's mesh run, bit for bit: arenas, commits, read results, the four
    abort causes, round_trips per rank, hybrid counts and every WireStats
    field per rank; each rank's read round launches the probe once."""
    o = oracles.get("protocol")
    per_rank = tx_runs[case]
    for k in TX_FIELDS:
        np.testing.assert_array_equal(stack(per_rank, k), o[case + k],
                                      err_msg=k)
    for k in WIRE_FIELDS:
        np.testing.assert_array_equal(stack(per_rank, "wire_" + k),
                                      o[f"{case}wire_{k}"], err_msg=k)
    c = TXS[case]
    assert [r["probes"] for r in per_rank] == [int(c["use_onesided"])] * 4
    if c["capacity"] >= 0:
        assert stack(per_rank, "aborted_overflow").any()
    assert stack(per_rank, "committed").any()


@pytest.mark.parametrize("case", list(TXS))
def test_transactions_match_the_ports_simulator(case, tx_runs):
    """The same batch on the port's SimTransport(4) in this process: the
    mesh run's arenas, commits, read results and abort causes, its per-rank
    round_trips with the simulator's as their largest, and additive
    WireStats that sum to the simulator's."""
    state, r = MR.tx_run(SimTransport(4), TXS[case])
    per_rank = tx_runs[case]
    for k in TX_FIELDS[:8]:
        want = state["arena"] if k == "arena" else getattr(r, k)
        np.testing.assert_array_equal(stack(per_rank, k), to_numpy(want),
                                      err_msg=k)
    assert stack(per_rank, "round_trips").max() == float(r.round_trips)
    for k in WIRE_FIELDS[1:]:
        assert stack(per_rank, "wire_" + k).sum() == float(
            getattr(r.metrics.wire, k)), k


# --- 4. Topology.spec_for at production size ---------------------------------
def _keystr(path):
    return "".join(f"['{k}']" for k in path)


def _flat_specs(tree, path=()):
    if not isinstance(tree, dict):
        return {_keystr(path): [list(e) if isinstance(e, tuple) else e
                                for e in tree]}
    out = {}
    for k, v in tree.items():
        out.update(_flat_specs(v, path + (k,)))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
def test_spec_for_matches_reference(multi_pod, oracles):
    """Every leaf of every arch's full-size param_specs under the three rule
    sets on (16, 16) and (2, 16, 16), and cache_specs' axes and kv_mode at
    tp 16, equal to the JAX package's (qwen2.5-32b's 40 heads fall back to
    replication)."""
    ref = json.loads(str(oracles.get("specs")["json"]))
    shape, axes = (((2, 16, 16), ("pod", "data", "model")) if multi_pod
                   else ((16, 16), ("data", "model")))
    mesh = S.AbstractMesh(axes, shape)
    for rname in ("DEFAULT_RULES", "SERVE_RULES", "WIDE_DP_RULES"):
        topo = S.Topology(mesh, dict(getattr(S, rname)))
        for arch in ARCHS:
            key = f"{int(multi_pod)}/{rname}/{arch}"
            cfg = get(arch)
            got = _flat_specs(S.param_specs_pspec(topo, api.param_specs(cfg)))
            assert got == ref[key], key
            assert D.kv_mode(cfg, topo) == ref[key + "/kv_mode"], key
            assert {k: list(ax) for k, (_, ax, _) in D.cache_specs(
                cfg, 2, 64, topo).items()} == ref[key + "/cache"], key
            act = [list(e) if isinstance(e, tuple) else e for e in
                   topo.spec_for((32, 64, cfg.n_heads, cfg.head_dim),
                                 ("batch", None, "heads", None))]
            assert act == ref[key + "/heads"], key
    # qwen2.5-32b's 40 heads do not split over 16: replicated
    qwen = get("qwen2.5-32b")
    assert S.Topology(mesh).spec_for((32, 64, qwen.n_heads, qwen.head_dim),
                                     ("batch", None, "heads", None))[2] is None


def test_topology_block_cuts_the_reference_layout():
    """A rank's block of a (4, 6) tensor under ("batch", "ff") on a
    (pod 2, data 2, model 3) mesh: batch over (pod, data) pod-major."""
    topo = S.Topology(S.AbstractMesh(("pod", "data", "model"), (2, 2, 3)))
    x = torch.arange(24).reshape(4, 6)
    assert topo.spec_for(x.shape, ("batch", "ff")) == (("pod", "data"),
                                                       "model")
    blk = topo.block(x, "batch", "ff", coord={"pod": 1, "data": 0, "model": 2})
    assert torch.equal(blk, x[2:3, 4:6])
    # one device: axes of size 1 apply, and a block is the whole tensor
    assert S.ONE_DEVICE.spec_for((3, 5), ("batch", "vocab")) == ("data",
                                                                  "model")
    y = torch.arange(15).reshape(3, 5)
    assert torch.equal(S.ONE_DEVICE.block(y, "batch", "vocab",
                                          coord={"data": 0, "model": 0}), y)


def test_production_mesh_needs_its_world():
    """The production builders touch nothing at import and refuse a process
    without its 256 / 512 ranks."""
    from repro_torch.launch import mesh
    for multi_pod in (False, True):
        with pytest.raises(RuntimeError, match="init_group"):
            mesh.make_production_mesh(multi_pod=multi_pod, device="cpu")


# --- 5. the sharded branches --------------------------------------------------
@pytest.fixture(scope="module")
def branch_runs(workdir):
    out = {}
    for dp, tp in MESHES:
        name = f"m{dp}x{tp}"
        cases = BRANCHES[name]
        res = ranks(MR.branch_rank, dp * tp, workdir, (dp, tp),
                    list(cases.values()))
        for i, c in enumerate(cases):
            out[name + c] = [r[i] for r in res]
    return out


BRANCH_CASES = [(m, c) for m in BRANCHES for c in BRANCHES[m]]


def _out_axes(c):
    if c["kind"] == "decode" and c["mode"] == "heads":
        return ("batch", "heads", None)
    return ("batch", None, None)


@pytest.mark.parametrize("mesh,case", BRANCH_CASES)
def test_sharded_branch_matches_reference(mesh, case, branch_runs, oracles):
    """Every rank's output block against the same block of the JAX
    package's same mode on the same forced mesh: embed_lookup bit for bit
    (the vocab the axis does not divide takes the local branch), decode
    attention and MoE within REL of the largest |value|; moe_dispatch_mode
    chooses what the reference chooses."""
    o = oracles.get("branches")
    c = BRANCHES[mesh][case]
    dp, tp = (int(v) for v in mesh[1:].split("x"))
    want = torch.from_numpy(o[mesh + case + "out"])
    topo = S.Topology(S.AbstractMesh(("data", "model"), (dp, tp)))
    for coord, got in branch_runs[mesh + case]:
        if c["kind"] == "moe":
            got, chosen = got
            assert chosen == str(o[mesh + case + "auto"])
        exp = topo.block(want, *_out_axes(c), coord=coord)
        assert got.shape == exp.shape
        if c["kind"] == "embed":
            assert torch.equal(got, exp)
        else:
            err = float((got - exp).abs().max())
            assert err <= REL * float(want.abs().max()), err


# --- 6. import isolation --------------------------------------------------------
def test_port_and_chip_smoke_load_no_jax():
    script = (
        "import importlib, pkgutil, sys\n"
        f"sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "from repro_torch.testing.ranks import foreign_modules\n"
        "assert not foreign_modules(), foreign_modules()\n"
        "print('ISOLATED', len([m for m in sys.modules "
        "if m.startswith('repro_torch')]))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env)
    assert "ISOLATED" in res.stdout, res.stderr[-3000:]
    assert int(res.stdout.split()[-1]) > 40


# --- 7. on the card: NCCL at world size 1 -------------------------------------
@pytest.mark.cuda
def test_nccl_world_of_one_matches_simulator():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL)")
    got, want = run_ranks(MR.nccl_rank, 1, device="cuda",
                          deadline_s=DEADLINE_S)[0]
    for k in want:
        assert torch.equal(got[k], want[k]), k
