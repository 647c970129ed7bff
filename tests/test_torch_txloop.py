"""PyTorch port, the whole slice: tx_loop on the bench gate's workload and on
a small TATP mix, each built by both packages from the same numpy seeds and
held bit for bit against the JAX package — populated arenas, final arenas,
commit masks, abort causes, WireStats and round counts.  The TATP mix runs
retry rounds, fed the reference's own backoff permutations through
``perms`` (torch cannot reproduce ``jax.random``)."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import slots as jsl  # noqa: E402
from repro.core import txloop as jtxl  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro_torch.convert import to_numpy, words  # noqa: E402
from repro_torch.core import txloop as ptxl  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402
from repro_torch.testing import workloads as pwl  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = "cpu"


@pytest.fixture(scope="module")
def bench_common():
    """benchmarks/common.py (the reference workload builders), imported
    without leaving benchmarks/ on sys.path."""
    bench_dir = str(ROOT / "benchmarks")
    sys.path.insert(0, bench_dir)
    try:
        import common
    finally:
        sys.path.remove(bench_dir)
    return common


def same(p, j, what=""):
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            same(getattr(p, f.name), getattr(j, f.name), f"{what}.{f.name}")
        return
    np.testing.assert_array_equal(to_numpy(p), np.asarray(j), err_msg=what)


def test_gate_workload_matches_reference_and_baseline(bench_common):
    n_nodes, lanes, max_rounds = 4, 8, 2
    kw = dict(n_nodes=n_nodes, n_buckets=256, bucket_width=1, n_overflow=64,
              max_chain=8)
    jcfg = jht.HashTableConfig(**kw)
    jl = jht.build_layout(jcfg)
    js, rk, wk, wv = bench_common.make_tx_workload(
        JSim(n_nodes), jcfg, jl, jht.init_cluster_state(jcfg), lanes=lanes,
        n_keys=64, seed=5)
    js2, _, jres = jax.jit(lambda st: jtxl.tx_loop(
        JSim(n_nodes), st, jcfg, jl, read_keys=rk, write_keys=wk,
        write_values=wv, max_rounds=max_rounds))(js)

    pcfg = pht.HashTableConfig(**kw)
    pl = pht.build_layout(pcfg)
    ps, prk, pwk, pwv = pwl.make_tx_workload(
        PSim(n_nodes), pcfg, pl, pht.init_cluster_state(pcfg, device=CPU),
        lanes=lanes, n_keys=64, seed=5, device=CPU)
    np.testing.assert_array_equal(to_numpy(ps["arena"]), np.asarray(js["arena"]))
    for a, b in ((prk, rk), (pwk, wk), (pwv, wv)):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    ps, _, pres = ptxl.tx_loop(PSim(n_nodes), ps, pcfg, pl, read_keys=prk,
                               write_keys=pwk, write_values=pwv,
                               max_rounds=max_rounds, device=CPU)
    same(pres, jres)
    np.testing.assert_array_equal(to_numpy(ps["arena"]),
                                  np.asarray(js2["arena"]))

    # the same keys through the port's gate entry point, against the file
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())
    runs = pwl.gate_tx_runs(device=CPU)
    keys = pwl.gate_tx_keys(runs["f0"][1], runs["f1"][1])
    rep = keys.pop("replication")
    assert keys == {k: baseline[k] for k in keys}
    assert keys == {"round_trips": 4.0, "rt_round": 4.0, "commit_rate": 1.0,
                    "wire_bytes_tx": 786.62}
    assert rep == {k: baseline["replication"][k] for k in rep}


def jax_perms(key, max_rounds, N, B):
    """The backoff permutations tx_loop draws (txloop.py:114-131)."""
    out = []
    for _ in range(max_rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.vmap(lambda k: jax.random.permutation(k, B))(
            jax.random.split(sub, N)), np.int64))
    return np.stack(out)


def tatp_draw(rng, klo, khi, n_nodes, lanes, subs, rd=2, wr=1):
    """fig6_tatp.run_config's draw_tx, verbatim in numpy."""
    def pick(n):
        s = rng.randint(0, n_nodes, (n_nodes, lanes, n))
        i = rng.randint(0, subs, (n_nodes, lanes, n))
        return (np.asarray(klo)[s, i], np.asarray(khi)[s, i])
    rl, rh = pick(rd)
    wl, wh = pick(wr)
    kind = rng.rand(n_nodes, lanes)
    is_read = kind < 0.80
    two_reads = kind < 0.40
    read_en = np.ones((n_nodes, lanes, rd), bool)
    read_en[..., 1] = two_reads
    read_en[~is_read, 1] = False
    write_en = np.repeat((~is_read)[..., None], wr, axis=-1)
    rk = jnp.asarray(np.stack([rl, rh], -1), jnp.uint32)
    wk = jnp.asarray(np.stack([wl, wh], -1), jnp.uint32)
    wvals = jsl._mix32(wk[..., 0] + jnp.uint32(99))[..., None] * \
        jnp.ones((jsl.VALUE_WORDS,), jnp.uint32)
    return rk, wk, jnp.asarray(read_en), jnp.asarray(write_en), wvals


def test_tatp_mix_with_reference_permutations(bench_common):
    n_nodes, subs, lanes, max_rounds = 4, 24, 16, 3
    kw = dict(n_nodes=n_nodes, n_buckets=32, bucket_width=1, n_overflow=subs,
              max_chain=12)
    jcfg = jht.HashTableConfig(**kw)
    jl = jht.build_layout(jcfg)
    js, (klo, khi) = bench_common.populate(jcfg, jl, JSim(n_nodes),
                                           jht.init_cluster_state(jcfg), subs,
                                           seed=3)
    jb = tatp_draw(np.random.RandomState(4), klo, khi, n_nodes, lanes, subs)
    js2, _, jres = jax.jit(lambda st: jtxl.tx_loop(
        JSim(n_nodes), st, jcfg, jl, read_keys=jb[0], write_keys=jb[1],
        write_values=jb[4], read_enabled=jb[2], write_enabled=jb[3],
        max_rounds=max_rounds))(js)
    assert int(jres.round_retries.sum()) > 0        # the retry path ran

    pcfg = pht.HashTableConfig(**kw)
    pl = pht.build_layout(pcfg)
    ps, (plo, phi) = pwl.populate(pcfg, pl, PSim(n_nodes),
                                  pht.init_cluster_state(pcfg, device=CPU),
                                  subs, seed=3, device=CPU)
    np.testing.assert_array_equal(to_numpy(ps["arena"]), np.asarray(js["arena"]))
    pb = pwl.tatp_transactions(plo, phi, n_nodes=n_nodes, lanes=lanes,
                               subscribers_per_node=subs,
                               rng=np.random.RandomState(4), device=CPU)
    for a, b in zip(pb, (jb[0], jb[1], jb[2], jb[3], jb[4])):
        np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    perms = jax_perms(jax.random.PRNGKey(0x5707), max_rounds, n_nodes, lanes)
    ps, _, pres = ptxl.tx_loop(
        PSim(n_nodes), ps, pcfg, pl, read_keys=pb[0], write_keys=pb[1],
        write_values=pb[4], read_enabled=pb[2], write_enabled=pb[3],
        max_rounds=max_rounds, perms=torch.from_numpy(perms), device=CPU)
    same(pres, jres)
    np.testing.assert_array_equal(to_numpy(ps["arena"]),
                                  np.asarray(js2["arena"]))


def test_tx_loop_default_generator_is_deterministic():
    cfg = pht.HashTableConfig(n_nodes=2, n_buckets=8, n_overflow=8)
    layout = pht.build_layout(cfg)
    wk = words(np.full((2, 6, 1, 2), 7), CPU)            # one hot key
    outs = []
    for _ in range(2):
        st = pht.init_cluster_state(cfg, device=CPU)
        st, _, res = ptxl.tx_loop(
            PSim(2), st, cfg, layout, read_keys=words(np.zeros((2, 6, 0, 2)),
                                                      CPU),
            write_keys=wk, write_values=words(np.ones((2, 6, 1, 27)), CPU),
            max_rounds=4, device=CPU)
        outs.append((to_numpy(st["arena"]), res.commit_round.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert (outs[0][1] > 0).any()                        # retries committed
