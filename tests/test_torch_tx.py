"""PyTorch port, the transaction path below the retry loop: the one-sided
probe (one hash_probe launch per round on the card), the one-two-sided
hybrid lookup with its address cache, and run_transactions on both
schedules — each held against the JAX package from the same state (the
reference's arenas carried across as word images), bit for bit: results,
abort causes, WireStats and final arenas."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import hybrid as jhy  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import slots as jsl  # noqa: E402
from repro.core import tx as jtx  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro_torch.convert import (state_from_numpy, state_to_numpy,  # noqa: E402
                                 to_numpy, words)
from repro_torch.core import hybrid as phy  # noqa: E402
from repro_torch.core import tx as ptx  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402

CPU = "cpu"
N = 4


def vals_for(k):
    return jsl._mix32(jnp.asarray(k, jnp.uint32)[..., None]
                      + jnp.arange(jsl.VALUE_WORDS, dtype=jnp.uint32))


def same(p, j, what=""):
    if dataclasses.is_dataclass(j):
        for f in dataclasses.fields(j):
            same(getattr(p, f.name), getattr(j, f.name), f"{what}.{f.name}")
        return
    if isinstance(j, dict):
        for k in j:
            same(p[k], j[k], f"{what}[{k}]")
        return
    np.testing.assert_array_equal(to_numpy(p), np.asarray(j), err_msg=what)


@pytest.fixture(scope="module")
def world():
    """A 4-node, width-2 table (the reference's test_core_storm shape) with
    a cache, populated by the reference; 96 of its keys are kept absent."""
    kw = dict(n_nodes=N, n_buckets=32, bucket_width=2, n_overflow=64,
              max_chain=6, cache_slots=16)
    jcfg, pcfg = jht.HashTableConfig(**kw), pht.HashTableConfig(**kw)
    rng = np.random.RandomState(8)
    klo = rng.randint(0, 2**31, size=(N, 48)).astype(np.uint32)
    khi = rng.randint(0, 2**31, size=(N, 48)).astype(np.uint32)
    jl = jht.build_layout(jcfg)
    node, _, _ = jht.lookup_start(jcfg, jl, jnp.asarray(klo[:, :24]),
                                  jnp.asarray(khi[:, :24]))
    st, rep, _, _ = JR.rpc_call(
        JSim(N), jht.init_cluster_state(jcfg), node,
        jht.make_record(JR.OP_INSERT, jnp.asarray(klo[:, :24]),
                        jnp.asarray(khi[:, :24]), value=vals_for(klo[:, :24])),
        jht.make_rpc_handler(jcfg, jl))
    assert np.all(np.asarray(rep[..., 0]) == JR.ST_OK)
    return dict(jcfg=jcfg, pcfg=pcfg, jl=jl, pl=pht.build_layout(pcfg),
                js=st, klo=klo, khi=khi)


def port_state(w):
    return state_from_numpy(jax.device_get(w["js"]), CPU)


@pytest.mark.parametrize("capacity", [None, 3])
def test_onesided_probe(world, capacity):
    w = world
    rng = np.random.RandomState(capacity or 0)
    idx = rng.randint(0, 48, size=(N, 20))               # hits and misses
    klo = np.take_along_axis(w["klo"], idx, 1)
    khi = np.take_along_axis(w["khi"], idx, 1)
    en = rng.rand(N, 20) < 0.8
    j = jhy.onesided_probe(JSim(N), w["js"], jnp.asarray(klo), jnp.asarray(khi),
                           w["jcfg"], w["jl"], capacity=capacity,
                           enabled=jnp.asarray(en))
    p = phy.onesided_probe(PSim(N), port_state(w), words(klo, CPU),
                           words(khi, CPU), w["pcfg"], w["pl"],
                           capacity=capacity, enabled=torch.from_numpy(en))
    same(p, j)
    assert np.asarray(j["success"]).any() and np.asarray(j["need_rpc"]).any()


def test_hybrid_lookup_with_address_cache(world):
    w = world
    klo, khi = w["klo"][:, 16:40], w["khi"][:, 16:40]
    jc = jax.vmap(lambda _: jht.init_cache(w["jcfg"]))(jnp.arange(N))
    pc = pht.init_cache(w["pcfg"], N, device=CPU)
    js, ps = w["js"], port_state(w)
    for _ in range(2):                       # the second pass hits the cache
        jout = jhy.hybrid_lookup(JSim(N), js, jnp.asarray(klo),
                                 jnp.asarray(khi), w["jcfg"], w["jl"],
                                 cache=jc)
        pout = phy.hybrid_lookup(PSim(N), ps, words(klo, CPU),
                                 words(khi, CPU), w["pcfg"], w["pl"],
                                 cache=pc)
        for a, b in zip(pout[2:], jout[2:]):
            same(a, b)
        jc, pc = jout[1], pout[1]
        same(pc, jc)
    assert float(jout[-1].onesided_success) > 0


def _tx_batch(w, seed, B=6, conflict=False):
    rng = np.random.RandomState(seed)
    ridx = rng.randint(0, 40, size=(N, B, 2))
    rk = np.stack([np.take_along_axis(w["klo"][:, :, None], ridx, 1),
                   np.take_along_axis(w["khi"][:, :, None], ridx, 1)], -1)
    widx = rng.randint(8 if conflict else 40, 48 if not conflict else 12,
                       size=(N, B, 1))       # conflicts: a few hot keys
    wk = np.stack([np.take_along_axis(w["klo"][:, :, None], widx, 1),
                   np.take_along_axis(w["khi"][:, :, None], widx, 1)], -1)
    wv = np.asarray(vals_for(wk[..., 0] + 3))
    ren = rng.rand(N, B, 2) < 0.8
    wen = rng.rand(N, B, 1) < 0.7
    return rk.astype(np.uint32), wk.astype(np.uint32), wv, ren, wen


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed,conflict,capacity", [(1, False, None),
                                                    (2, True, None),
                                                    (3, True, 4)])
def test_run_transactions(world, fused, seed, conflict, capacity):
    w = world
    rk, wk, wv, ren, wen = _tx_batch(w, seed, conflict=conflict)
    jrun = jax.jit(lambda st, rk, wk, wv, ren, wen: jtx.run_transactions(
        JSim(N), st, w["jcfg"], w["jl"], read_keys=rk, write_keys=wk,
        write_values=wv, read_enabled=ren, write_enabled=wen,
        capacity=capacity, fused=fused))
    js, _, jres = jrun(w["js"], *(jnp.asarray(x) for x in (rk, wk, wv, ren,
                                                            wen)))
    ps, _, pres = ptx.run_transactions(
        PSim(N), port_state(w), w["pcfg"], w["pl"], read_keys=words(rk, CPU),
        write_keys=words(wk, CPU), write_values=words(wv, CPU),
        read_enabled=torch.from_numpy(ren), write_enabled=torch.from_numpy(wen),
        capacity=capacity, fused=fused)
    same(pres, jres)
    np.testing.assert_array_equal(state_to_numpy(ps)["arena"],
                                  np.asarray(js["arena"]))
    com = np.asarray(jres.committed)
    assert com.any()
    if conflict:
        assert not com.all()
