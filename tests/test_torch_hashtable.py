"""PyTorch port, hash table: the handler ops of tests/test_core_storm.py and
tests/test_hashtable_repair.py driven through BOTH packages with the same
numpy inputs — every reply, overflow mask, WireStats and arena word must
match the JAX package bit for bit — plus lookup_end / probe_end, the
address cache and one-sided reads and writes."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import onesided as josd  # noqa: E402
from repro.core import rpc as JR  # noqa: E402
from repro.core import slots as jsl  # noqa: E402
from repro.core.datastructs import hashtable as jht  # noqa: E402
from repro.core.transport import SimTransport as JSim  # noqa: E402
from repro_torch.convert import to_numpy, words  # noqa: E402
from repro_torch.core import onesided as posd  # noqa: E402
from repro_torch.core import rpc as PR  # noqa: E402
from repro_torch.core.datastructs import hashtable as pht  # noqa: E402
from repro_torch.core.transport import SimTransport as PSim  # noqa: E402

CPU = "cpu"


def vals_for(keys):
    return np.asarray(jsl._mix32(jnp.asarray(keys, jnp.uint32)[..., None]
                                 + jnp.arange(jsl.VALUE_WORDS,
                                              dtype=jnp.uint32)))


def assert_stats(p, j):
    for f in dataclasses.fields(j):
        assert np.float32(to_numpy(getattr(p, f.name))) == \
            np.float32(getattr(j, f.name)), f.name


class Twin:
    """One cluster in each package, driven with identical inputs."""

    def __init__(self, **kw):
        self.jcfg, self.pcfg = jht.HashTableConfig(**kw), pht.HashTableConfig(**kw)
        self.jl, self.pl = jht.build_layout(self.jcfg), pht.build_layout(self.pcfg)
        assert {k: dataclasses.astuple(r) for k, r in self.jl.regions.items()} \
            == {k: dataclasses.astuple(r) for k, r in self.pl.regions.items()}
        n = kw["n_nodes"]
        self.jt, self.pt = JSim(n), PSim(n)
        self.js = jht.init_cluster_state(self.jcfg)
        self.ps = pht.init_cluster_state(self.pcfg, device=CPU)
        self.handlers = {}
        self.check_arena()

    def check_arena(self):
        np.testing.assert_array_equal(to_numpy(self.ps["arena"]),
                                      np.asarray(self.js["arena"]))

    def call(self, op, klo, khi=None, *, node=None, aux=None, values=None,
             vector=False, capacity=None, enabled=None):
        klo = np.asarray(klo, np.uint32)
        khi = np.zeros_like(klo) if khi is None else np.asarray(khi, np.uint32)
        if node is None:
            node = np.asarray(jht.lookup_start(self.jcfg, self.jl,
                                               jnp.asarray(klo),
                                               jnp.asarray(khi))[0])
        node = np.asarray(node, np.int32)
        jrec = jht.make_record(op, jnp.asarray(klo), jnp.asarray(khi),
                               aux=None if aux is None else jnp.asarray(aux, jnp.uint32),
                               value=None if values is None else jnp.asarray(values, jnp.uint32))
        prec = pht.make_record(op, words(klo, CPU), words(khi, CPU),
                               aux=None if aux is None else words(aux, CPU),
                               value=None if values is None else words(values, CPU))
        np.testing.assert_array_equal(to_numpy(prec), np.asarray(jrec))
        key = (vector, capacity)
        if key not in self.handlers:
            # one jitted reference call per (handler, capacity): the eager
            # reference would recompile its lax.scan on every call
            jh = (jht.make_lookup_handler_vector if vector
                  else jht.make_rpc_handler)(self.jcfg, self.jl)
            ph = (pht.make_lookup_handler_vector if vector
                  else pht.make_rpc_handler)(self.pcfg, self.pl)
            self.handlers[key] = (jax.jit(
                lambda st, nd, rc, en, h=jh: JR.rpc_call(
                    self.jt, st, nd, rc, h, capacity=capacity, enabled=en)),
                ph)
        jcall, ph = self.handlers[key]
        if enabled is None:
            enabled = np.ones(klo.shape, bool)
        jen = jnp.asarray(enabled)
        pen = torch.from_numpy(np.array(enabled))
        self.js, jrep, jovf, jst = jcall(self.js, jnp.asarray(node), jrec, jen)
        self.ps, prep, povf, pst = PR.rpc_call(
            self.pt, self.ps, torch.from_numpy(node.copy()), prec,
            ph, capacity=capacity, enabled=pen)
        np.testing.assert_array_equal(to_numpy(prep), np.asarray(jrep))
        np.testing.assert_array_equal(povf.numpy(), np.asarray(jovf))
        assert_stats(pst, jst)
        self.check_arena()
        return np.asarray(jrep)


def keys(n, seed):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 2**31, size=n).astype(np.uint32),
            rng.randint(0, 2**31, size=n).astype(np.uint32))


@pytest.fixture(scope="module")
def storm_twin():
    """test_core_storm's 4-node, width-2 table with 128 inserted keys."""
    tw = Twin(n_nodes=4, n_buckets=64, bucket_width=2, n_overflow=64,
              max_chain=6)
    klo, khi = keys(4 * 32, 3)
    klo, khi = klo.reshape(4, 32), khi.reshape(4, 32)
    rep = tw.call(JR.OP_INSERT, klo, khi, values=vals_for(klo))
    assert (rep[..., 0] == JR.ST_OK).all()
    return tw, klo, khi


def test_insert_lookup_update_delete(storm_twin):
    tw, klo, khi = storm_twin
    rep = tw.call(JR.OP_LOOKUP, klo, khi)
    np.testing.assert_array_equal(rep[..., 3:], vals_for(klo))
    tw.call(JR.OP_LOOKUP, klo, khi, vector=True)
    mlo, mhi = keys(4 * 32, 99)
    rep = tw.call(JR.OP_LOOKUP, mlo.reshape(4, 32), mhi.reshape(4, 32))
    assert (rep[..., 0] == JR.ST_NOT_FOUND).all()
    tw.call(JR.OP_LOOKUP, mlo.reshape(4, 32), mhi.reshape(4, 32), vector=True)
    sub = (klo[:, :8], khi[:, :8])
    tw.call(JR.OP_UPDATE, *sub, values=vals_for(sub[0] + 1))
    tw.call(JR.OP_DELETE, *sub)
    tw.call(JR.OP_LOOKUP, *sub)
    tw.call(JR.OP_INSERT, *sub, values=vals_for(sub[0] + 2))   # reuse slots


def test_lock_commit_abort_and_read_version(storm_twin):
    tw, klo, khi = storm_twin
    lo, hi = klo[:, 8:12], khi[:, 8:12]
    tags = (np.arange(16, dtype=np.uint32).reshape(4, 4) + 1)
    rep = tw.call(JR.OP_LOCK, lo, hi, aux=tags)
    slot_idx = rep[..., 1]
    node = np.asarray(jht.lookup_start(tw.jcfg, tw.jl, jnp.asarray(lo),
                                       jnp.asarray(hi))[0])
    tw.call(JR.OP_LOCK, lo, hi, aux=tags + 100)                  # conflicts
    tw.call(JR.OP_READ_VERSION, lo, hi, node=node, aux=slot_idx)
    commit = np.where(np.arange(4) % 2 == 0, JR.OP_COMMIT_UNLOCK,
                      JR.OP_ABORT_UNLOCK)[None, :].repeat(4, 0)
    # a wrong tag first (refused), then the owners
    for tg in (tags + 7, tags):
        for op in (JR.OP_COMMIT_UNLOCK, JR.OP_ABORT_UNLOCK):
            sel = commit == op
            tw.call(op, np.where(sel, tg, 0), hi, node=node,
                    aux=slot_idx, values=vals_for(lo + 5),
                    enabled=sel)
    # lock-inserts of new keys (placeholders), then abort half of them
    nlo, nhi = keys(16, 77)
    nlo, nhi = nlo.reshape(4, 4), nhi.reshape(4, 4)
    rep = tw.call(JR.OP_LOCK, nlo, nhi, aux=tags)
    nnode = np.asarray(jht.lookup_start(tw.jcfg, tw.jl, jnp.asarray(nlo),
                                        jnp.asarray(nhi))[0])
    tw.call(JR.OP_ABORT_UNLOCK, tags, nhi, node=nnode, aux=rep[..., 1])


def test_placement_owner_check_and_install(storm_twin):
    tw, klo, khi = storm_twin
    # route lock-class ops to the WRONG node: refused with ST_WRONG_EPOCH
    node = np.asarray(jht.lookup_start(tw.jcfg, tw.jl, jnp.asarray(klo[:, :4]),
                                       jnp.asarray(khi[:, :4]))[0])
    rep = tw.call(JR.OP_LOCK, klo[:, :4], khi[:, :4], node=(node + 1) % 4,
                  aux=np.ones((4, 4), np.uint32))
    assert (rep[..., 0] == JR.ST_WRONG_EPOCH).all()
    # OP_PL_INSTALL: [op, part, epoch, 0, copies row ++ alive bits]
    vals = np.zeros((4, 1, jsl.VALUE_WORDS), np.uint32)
    vals[..., :5] = [3, 0, 1, 2, 0b1011]
    tw.call(JR.OP_PL_INSTALL, np.full((4, 1), 2), np.full((4, 1), 9),
            node=np.arange(4)[:, None], values=vals)
    tw.call(JR.OP_BACKUP_WRITE, klo[:, :2], khi[:, :2],
            aux=np.full((4, 2), 6), values=vals_for(klo[:, :2]))


def test_capacity_overflow_and_zero():
    tw = Twin(n_nodes=2, n_buckets=8, bucket_width=1, n_overflow=8)
    klo, khi = keys(8, 5)
    tw.call(JR.OP_INSERT, klo.reshape(2, 4), khi.reshape(2, 4),
            node=np.zeros((2, 4)), values=vals_for(klo.reshape(2, 4)),
            capacity=3)
    tw.call(JR.OP_INSERT, klo.reshape(2, 4), khi.reshape(2, 4),
            values=vals_for(klo.reshape(2, 4)), capacity=0)


@pytest.mark.parametrize("width", [0, 9, 16])
def test_config_rejects_bucket_widths_the_probe_does_not_take(width):
    """A bucket is one hash_probe line, and the kernel takes 1..8 slots: the
    port's table refuses other widths when it is configured."""
    with pytest.raises(ValueError, match="bucket_width"):
        pht.HashTableConfig(n_nodes=2, n_buckets=8, bucket_width=width)
    assert pht.HashTableConfig(n_nodes=2, n_buckets=8,
                               bucket_width=8).n_bucket_slots == 64


# --- the one-node chain scenarios of tests/test_hashtable_repair.py --------
def one_node(n_overflow=8, bucket_width=1, max_chain=12):
    return Twin(n_nodes=1, n_buckets=1, bucket_width=bucket_width,
                n_overflow=n_overflow, max_chain=max_chain)


def c1(tw, op, ks, aux=None, values=None):
    k = np.asarray([ks], np.uint32)
    return tw.call(op, k, node=np.zeros(k.shape),
                   aux=None if aux is None else np.asarray([aux]),
                   values=None if values is None else values[None])[0]


def test_chain_reuse_keeps_links_and_versions():
    tw = one_node()
    c1(tw, JR.OP_INSERT, [10, 20, 30], values=vals_for([10, 20, 30]))
    c1(tw, JR.OP_DELETE, [10])                  # the chain anchor
    c1(tw, JR.OP_INSERT, [40], values=vals_for([40]))
    rep = c1(tw, JR.OP_LOOKUP, [40, 20, 30])
    assert (rep[:, 0] == JR.ST_OK).all()
    c1(tw, JR.OP_DELETE, [20])                  # a middle node
    c1(tw, JR.OP_INSERT, [50], values=vals_for([50]))
    rep = c1(tw, JR.OP_LOCK, [60], aux=[7])     # placeholder into a chain
    c1(tw, JR.OP_ABORT_UNLOCK, [7], aux=[rep[0, 1]])
    c1(tw, JR.OP_LOOKUP, [40, 50, 30, 60])
    c1(tw, JR.OP_DELETE, [40])
    c1(tw, JR.OP_INSERT, [40], values=vals_for([40]))


@pytest.mark.parametrize("seed,width", [(3, 1), (11, 2)])
def test_churn_at_fixed_occupancy(seed, width):
    n_overflow = 5
    tw = one_node(n_overflow=n_overflow, bucket_width=width,
                  max_chain=n_overflow + 4)
    occupancy = width + n_overflow
    rng = np.random.RandomState(seed)
    ks = list(range(100, 100 + occupancy))
    c1(tw, JR.OP_INSERT, ks, values=vals_for(ks))
    nxt = 1000
    for _ in range(occupancy + 3):
        c1(tw, JR.OP_DELETE, [ks.pop(rng.randint(len(ks)))])
        rep = c1(tw, JR.OP_INSERT, [nxt], values=vals_for([nxt]))
        assert (rep[:, 0] == JR.ST_OK).all()
        ks.append(nxt)
        nxt += 1
    c1(tw, JR.OP_INSERT, [5000], values=vals_for([5000]))       # table full
    c1(tw, JR.OP_LOOKUP, ks)


def test_unlock_requires_exact_tag():
    tw = one_node()
    c1(tw, JR.OP_INSERT, [10], values=vals_for([10]))
    rep = c1(tw, JR.OP_LOCK, [10], aux=[77])
    s = rep[0, 1]
    for op in (JR.OP_ABORT_UNLOCK, JR.OP_COMMIT_UNLOCK):
        rep = c1(tw, op, [88], aux=[s], values=vals_for([10]))
        assert (rep[:, 0] == JR.ST_LOCK_FAIL).all()
    c1(tw, JR.OP_LOCK, [10], aux=[99])
    c1(tw, JR.OP_COMMIT_UNLOCK, [77], aux=[s], values=vals_for([11]))
    c1(tw, JR.OP_LOOKUP, [10])


def test_negative_capacity_rejected():
    tw = one_node()
    recs = pht.make_record(JR.OP_LOOKUP, words([[1]], CPU), words([[0]], CPU))
    node = torch.zeros((1, 1), dtype=torch.int32)
    with pytest.raises(ValueError):
        PR.rpc_call(tw.pt, tw.ps, node, recs,
                    pht.make_rpc_handler(tw.pcfg, tw.pl), capacity=-1)
    with pytest.raises(ValueError):
        posd.remote_read(tw.pt, tw.ps["arena"], node,
                         torch.zeros((1, 1), dtype=torch.int32), length=4,
                         capacity=-1)


# --- client side: lookup_end / probe_end / the address cache ----------------
@pytest.mark.parametrize("width", [1, 2, 4])
def test_lookup_end_and_probe_end(width):
    rng = np.random.RandomState(width)
    cfg_kw = dict(n_nodes=2, n_buckets=16, bucket_width=width, n_overflow=8)
    jcfg, pcfg = jht.HashTableConfig(**cfg_kw), pht.HashTableConfig(**cfg_kw)
    jl, pl = jht.build_layout(jcfg), pht.build_layout(pcfg)
    M = 64
    buf = rng.randint(0, 2**32, size=(M, width * 32), dtype=np.uint64).astype(
        np.uint32)
    sl3 = buf.reshape(M, width, 32)
    sl3[..., 2] &= ~np.uint32(rng.rand(M, width) < 0.7)      # mostly even
    sl3[..., 3] *= (rng.rand(M, width) < 0.3).astype(np.uint32)
    pick = rng.randint(0, width, size=M)
    klo = np.where(rng.rand(M) < 0.6, sl3[np.arange(M), pick, 0],
                   rng.randint(0, 2**31, size=M)).astype(np.uint32)
    khi = sl3[np.arange(M), pick, 1]
    hit = rng.rand(M) < 0.3
    off = rng.randint(0, 2**32, size=M, dtype=np.uint64).astype(np.uint32)
    for h in (None, hit):
        jr = jht.lookup_end(jcfg, jnp.asarray(buf), jnp.asarray(klo),
                            jnp.asarray(khi),
                            None if h is None else jnp.asarray(h))
        pr = pht.lookup_end(pcfg, words(buf, CPU), words(klo, CPU),
                            words(khi, CPU),
                            None if h is None else torch.from_numpy(h))
        for a, b in zip(pr, jr):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
    jp = jht.probe_end(jcfg, jl, jnp.asarray(buf), jnp.asarray(klo),
                       jnp.asarray(khi), jnp.asarray(off), jnp.asarray(hit))
    pp = pht.probe_end(pcfg, pl, words(buf, CPU), words(klo, CPU),
                       words(khi, CPU), words(off, CPU), torch.from_numpy(hit))
    for k in jp:
        np.testing.assert_array_equal(to_numpy(pp[k]), np.asarray(jp[k]), k)


def test_address_cache_start_and_update():
    kw = dict(n_nodes=2, n_buckets=16, bucket_width=2, n_overflow=8,
              cache_slots=8)
    jcfg, pcfg = jht.HashTableConfig(**kw), pht.HashTableConfig(**kw)
    jl, pl = jht.build_layout(jcfg), pht.build_layout(pcfg)
    rng = np.random.RandomState(9)
    klo, khi = keys(2 * 12, 21)
    klo, khi = klo.reshape(2, 12), khi.reshape(2, 12)
    node = rng.randint(0, 2, size=(2, 12)).astype(np.int32)
    sidx = rng.randint(0, 40, size=(2, 12)).astype(np.uint32)
    valid = rng.rand(2, 12) < 0.7
    jc = jax.vmap(lambda _: jht.init_cache(jcfg))(jnp.arange(2))
    pc = pht.init_cache(pcfg, 2, device=CPU)
    for _ in range(2):
        jc = jax.vmap(lambda c, a, b, n, s, v: jht.cache_update(
            jcfg, c, a, b, n, s, v))(jc, jnp.asarray(klo), jnp.asarray(khi),
                                    jnp.asarray(node), jnp.asarray(sidx),
                                    jnp.asarray(valid))
        pc = pht.cache_update(pcfg, pc, words(klo, CPU), words(khi, CPU),
                              torch.from_numpy(node), words(sidx, CPU),
                              torch.from_numpy(valid))
        for k in jc:
            np.testing.assert_array_equal(to_numpy(pc[k]), np.asarray(jc[k]), k)
        js = jax.vmap(lambda c, a, b: jht.lookup_start(jcfg, jl, a, b, c))(
            jc, jnp.asarray(klo), jnp.asarray(khi))
        ps = pht.lookup_start(pcfg, pl, words(klo, CPU), words(khi, CPU), pc)
        for a, b in zip(ps, js):
            np.testing.assert_array_equal(to_numpy(a), np.asarray(b))
        valid = ~valid


def test_remote_read_write(storm_twin):
    tw, _, _ = storm_twin
    rng = np.random.RandomState(2)
    N, B = 4, 8
    dest = rng.randint(0, N, size=(N, B)).astype(np.int32)
    slot_ids = rng.choice(tw.jcfg.n_slots, (N, B), replace=False)
    offs = np.asarray(jht.slot_idx_offset(tw.jl, jnp.asarray(slot_ids,
                                                             jnp.uint32)))
    np.testing.assert_array_equal(
        to_numpy(pht.slot_idx_offset(tw.pl, words(slot_ids, CPU))), offs)
    vals = rng.randint(0, 2**31, size=(N, B, 4)).astype(np.uint32)
    en = rng.rand(N, B) < 0.8
    ja, jo, js = josd.remote_write(tw.jt, tw.js["arena"], jnp.asarray(dest),
                                   jnp.asarray(offs), jnp.asarray(vals),
                                   enabled=jnp.asarray(en))
    pa, po, ps = posd.remote_write(tw.pt, tw.ps["arena"],
                                   torch.from_numpy(dest), words(offs, CPU),
                                   words(vals, CPU),
                                   enabled=torch.from_numpy(en))
    np.testing.assert_array_equal(to_numpy(pa), np.asarray(ja))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    assert_stats(ps, js)
    for cap in (None, 2):
        jd, jo, js = josd.remote_read(tw.jt, ja, jnp.asarray(dest),
                                      jnp.asarray(offs), length=6,
                                      capacity=cap, enabled=jnp.asarray(en))
        pd, po, ps = posd.remote_read(tw.pt, pa, torch.from_numpy(dest),
                                      words(offs, CPU), length=6,
                                      capacity=cap,
                                      enabled=torch.from_numpy(en))
        np.testing.assert_array_equal(to_numpy(pd), np.asarray(jd))
        np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
        assert_stats(ps, js)
