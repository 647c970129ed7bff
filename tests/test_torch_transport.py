"""PyTorch port, transport layer: route_by_dest, pick_replies, placement_dest,
the WireStats accounting and the NIC model, held against the JAX package on
the same numpy inputs (bit for bit, float32 counts included)."""
import torch_threads  # noqa: F401  (first: pins torch's threads)
import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import nic as jnic  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core import transport as jtr  # noqa: E402
from repro_torch.convert import to_numpy, words  # noqa: E402
from repro_torch.core import nic as pnic  # noqa: E402
from repro_torch.core import placement as ppl  # noqa: E402
from repro_torch.core import transport as ptr  # noqa: E402

CPU = "cpu"


def _route_case(seed, B, n_dst, park):
    rng = np.random.RandomState(seed)
    dest = rng.randint(0, n_dst, size=B).astype(np.int32)
    if park:
        dest[rng.rand(B) < 0.2] = -1
        dest[0] = n_dst                       # out of range above, too
    payload = rng.randint(0, 2**32, size=(B, 3), dtype=np.uint64).astype(
        np.uint32)
    enabled = rng.rand(B) < 0.8
    return dest, payload, enabled


@pytest.mark.parametrize("B,n_dst,cap,park,use_en", [
    (16, 4, 16, False, False),
    (24, 3, 4, False, True),      # overflow
    (20, 4, 3, True, True),       # parked dest=-1 and overflow
    (12, 2, 0, True, True),       # capacity 0
])
def test_route_by_dest_and_pick_replies(B, n_dst, cap, park, use_en):
    dest, payload, en = _route_case(B + cap, B, n_dst, park)
    jen = jnp.asarray(en) if use_en else None
    pen = torch.from_numpy(en) if use_en else None
    jb, jm, jp, jo = jtr.route_by_dest(jnp.asarray(dest), jnp.asarray(payload),
                                       n_dst, cap, jen)
    pb, pm, pp, po = ptr.route_by_dest(torch.from_numpy(dest),
                                       words(payload, CPU), n_dst, cap, pen)
    np.testing.assert_array_equal(to_numpy(pb), np.asarray(jb))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    # echo replies back through pick_replies
    np.testing.assert_array_equal(
        to_numpy(ptr.pick_replies(pb, torch.from_numpy(dest), pp, po)),
        np.asarray(jtr.pick_replies(jb, jnp.asarray(dest), jp, jo)))


def test_route_by_dest_batched_over_nodes():
    rng = np.random.RandomState(7)
    N, B, n_dst, cap = 3, 10, 3, 2
    dest = rng.randint(-1, n_dst, size=(N, B)).astype(np.int32)
    payload = rng.randint(0, 1000, size=(N, B, 2)).astype(np.uint32)
    en = rng.rand(N, B) < 0.9
    want = jax.vmap(lambda d, p, e: jtr.route_by_dest(d, p, n_dst, cap, e))(
        jnp.asarray(dest), jnp.asarray(payload), jnp.asarray(en))
    got = ptr.route_by_dest(torch.from_numpy(dest), words(payload, CPU), n_dst,
                            cap, torch.from_numpy(en))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_numpy(g), np.asarray(w))


def test_sim_transport_exchange():
    x = np.arange(4 * 4 * 2).reshape(4, 4, 2).astype(np.uint32)
    np.testing.assert_array_equal(
        to_numpy(ptr.SimTransport(4).exchange(words(x, CPU))),
        np.asarray(jtr.SimTransport(4).exchange(jnp.asarray(x))))


def _stats_np(s):
    return {f.name: np.float32(to_numpy(getattr(s, f.name)))
            for f in dataclasses.fields(s)}


def _assert_stats(p, j):
    pn, jn = _stats_np(p), {f.name: np.float32(getattr(j, f.name))
                            for f in dataclasses.fields(j)}
    assert pn == jn, (pn, jn)


@pytest.mark.parametrize("mode", [None, pnic.RC_EXCLUSIVE, pnic.RC_SHARED,
                                  pnic.DCT])
def test_wire_accounting_matches_reference(mode):
    rng = np.random.RandomState(3)
    masks = [rng.rand(4, 4, c) < p for c, p in ((5, 0.3), (3, 0.5), (2, 0.0))]
    masks[1][2] = False                       # a source with no traffic
    req, rep = [31, 1, 31], [30, 32, 0]
    jn = None if mode is None else jnic.ConnTable(96, 20, mode)
    pn = None if mode is None else pnic.ConnTable(96, 20, mode)
    _assert_stats(ptr.wire_for(torch.from_numpy(masks[0]), 31, 30, nic=pn),
                  jtr.wire_for(jnp.asarray(masks[0]), 31, 30, nic=jn))
    _assert_stats(ptr.wire_for(torch.from_numpy(masks[2]), 7, 0, nic=pn),
                  jtr.wire_for(jnp.asarray(masks[2]), 7, 0, nic=jn))
    _assert_stats(
        ptr.wire_for_classes([torch.from_numpy(m) for m in masks], req, rep,
                             nic=pn),
        jtr.wire_for_classes([jnp.asarray(m) for m in masks], req, rep, nic=jn))
    pm, pb = ptr.per_dest_wire([torch.from_numpy(m) for m in masks], req, rep)
    jm, jb = jtr.per_dest_wire([jnp.asarray(m) for m in masks], req, rep)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    z = ptr.WireStats.zero()
    s = ptr.wire_for(torch.from_numpy(masks[0]), 31, 30, nic=pn)
    _assert_stats(z + s, jtr.WireStats.zero() + jtr.wire_for(
        jnp.asarray(masks[0]), 31, 30, nic=jn))
    assert float(s.nic_hit_rate) == pytest.approx(
        float(jtr.wire_for(jnp.asarray(masks[0]), 31, 30, nic=jn).nic_hit_rate))


def test_nic_model_is_a_copy():
    for m in jnic.MODES:
        for n in (4, 32, 96):
            a, b = jnic.ConnTable(n, 20, m), pnic.ConnTable(n, 20, m)
            assert (a.conns_per_node, a.state_bytes, a.cache_hit,
                    a.penalty_us_per_op, a.describe()) == \
                (b.conns_per_node, b.state_bytes, b.cache_hit,
                 b.penalty_us_per_op, b.describe())


@pytest.mark.parametrize("n_nodes", [4, 33])
def test_placement_routing_and_region_image(n_nodes):
    np.testing.assert_array_equal(
        to_numpy(ppl.identity_region_image(n_nodes)),
        np.asarray(jpl.identity_region_image(n_nodes)))
    assert ppl.routing_words(n_nodes) == jpl.routing_words(n_nodes)
    rng = np.random.RandomState(n_nodes)
    pcfg_j, pcfg_p = jpl.PlacementConfig(n_nodes, 2), ppl.PlacementConfig(n_nodes, 2)
    alive = rng.rand(n_nodes) < 0.6
    jt = jpl.initial_table(pcfg_j)
    jt = jpl.PlacementTable(jt.epoch, jt.copies, jnp.asarray(alive))
    pt = ppl.initial_table(pcfg_p)
    pt = ppl.PlacementTable(pt.epoch, pt.copies, torch.from_numpy(alive))
    np.testing.assert_array_equal(pt.copies.numpy(), np.asarray(jt.copies))
    part = rng.randint(0, n_nodes, size=50).astype(np.int32)
    for pf, jf in ((ppl.owner_dest, jpl.owner_dest),
                   (ppl.copy_nodes, jpl.copy_nodes)):
        np.testing.assert_array_equal(pf(pt, torch.from_numpy(part)).numpy(),
                                      np.asarray(jf(jt, jnp.asarray(part))))
    pd, pr = ppl.live_dest(pt, torch.from_numpy(part))
    jd, jr = jpl.live_dest(jt, jnp.asarray(part))
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(to_numpy(ppl.region_image(pcfg_p, pt)),
                                  np.asarray(jpl.region_image(pcfg_j, jt)))
