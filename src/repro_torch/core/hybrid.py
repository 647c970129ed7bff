"""One-two-sided hybrid operations (Storm §4.4, Algorithm 1), PyTorch port of
``repro/core/hybrid.py``.

    1. lookup_start  -> where might the item be? (client-side metadata/cache)
    2. remote_read   -> ONE-SIDED fine-grained read of that location
    3. lookup_end    -> did we get it? (key/version/lock validation)
    4. if not        -> WRITE-BASED RPC; the owner chases the pointers
    5. lookup_end    -> cache the learned address for next time

All lanes move through the phases together; the RPC phase is issued with a
per-lane `enabled` mask so only failed lanes consume handler work and wire
bytes.

The probe is data-structure-generic (Storm Table 3): every entry point takes
``ds=`` — a datastructs module exporting ``lookup_start`` / ``probe_read`` /
``probe_words`` / ``lookup_records`` / ``uses_probe_cache`` /
``cache_update`` and the handler constructors — defaulting to the hash
table, whose ``probe_read`` is one ``hash_probe`` kernel launch.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core import onesided as osd
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core import wireproto as W
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import Transport, WireStats


@dataclasses.dataclass
class HybridMetrics:
    onesided_success: torch.Tensor   # lanes satisfied by the one-sided read
    rpc_fallback: torch.Tensor       # lanes that needed the RPC
    total: torch.Tensor
    wire: WireStats

    @staticmethod
    def zero(device=None):
        z = torch.zeros((), dtype=torch.float32, device=device)
        return HybridMetrics(z, z, z, WireStats.zero(device))


def _count(x):
    return x.to(torch.float32).sum()


def onesided_probe(t: Transport, state, key_lo, key_hi, cfg, layout, *,
                   cache=None, use_onesided: bool = True,
                   capacity: Optional[int] = None, enabled=None, nic=None,
                   ds=ht, ptable=None):
    """Phase 1 of Algorithm 1: lookup_start + one-sided read + lookup_end.

    The read round routes and accounts exactly like ``onesided.remote_read``
    (``onesided.read_round``: overflow, parking, WireStats); the owner-side
    gather and the ``lookup_end`` check of the delivered lanes are ONE
    ``ds.probe_read`` call, which for the hash table is one ``hash_probe``
    kernel launch reading ``state["arena"][dest]`` directly.  That is exact
    on SimTransport, where the exchange is a transpose and the read round
    runs no handler; a transport with one node per device (the reference's
    MeshTransport, a later slice) must move the launch to the owner side.

    Returns a dict with the per-lane probe outcome: node, cache `hit`,
    one-sided `success`, value/version/slot_idx of the hit, `need_rpc`,
    `enabled`, and the read round's WireStats."""
    dev = key_lo.device
    if enabled is None:
        enabled = torch.ones(key_lo.shape, dtype=torch.bool, device=dev)
    use_cache = cache is not None and ds.uses_probe_cache(cfg)
    node, off, hit = ds.lookup_start(cfg, layout, key_lo, key_hi,
                                     cache if use_cache else None,
                                     ptable=ptable)

    if use_onesided:
        delivered, ovf, s_read = osd.read_round(
            t, node, off, length=ds.probe_words(cfg), capacity=capacity,
            enabled=enabled, nic=nic)
        pe = ds.probe_read(cfg, layout, state["arena"], node, off, key_lo,
                           key_hi, hit, delivered)
        success = pe["found"] & ~ovf & enabled
        resolved = pe["resolved"] & ~ovf & enabled
        value, version, slot_idx = pe["value"], pe["version"], pe["slot_idx"]
        need_rpc = ~resolved & enabled
    else:
        success = torch.zeros(key_lo.shape, dtype=torch.bool, device=dev)
        value = torch.zeros(key_lo.shape + (sl.VALUE_WORDS,),
                            dtype=torch.int32, device=dev)
        version = torch.zeros(key_lo.shape, dtype=torch.int32, device=dev)
        slot_idx = torch.zeros(key_lo.shape, dtype=torch.int32, device=dev)
        s_read = WireStats.zero(dev)
        need_rpc = enabled

    return dict(node=node, hit=hit, success=success, value=value,
                version=version, slot_idx=slot_idx, need_rpc=need_rpc,
                enabled=enabled, wire=s_read)


def merge_rpc_fallback(probe, replies, rpc_ovf):
    """Fold the RPC-fallback replies for `probe["need_rpc"]` lanes into the
    one-sided probe outcome (phase 5 of Algorithm 1).  `overflow` marks lanes
    whose final-resort RPC was DROPPED — found=False then means "not
    delivered", NOT "key absent"."""
    need = probe["need_rpc"]
    rpc_ok = need & (replies[..., 0] == W.ST_OK) & ~rpc_ovf
    value = torch.where(rpc_ok[..., None], replies[..., 3:], probe["value"])
    version = torch.where(rpc_ok, replies[..., 2], probe["version"])
    slot_idx = torch.where(rpc_ok, replies[..., 1], probe["slot_idx"])
    return dict(found=probe["success"] | rpc_ok, value=value, version=version,
                slot_idx=slot_idx, rpc_ok=rpc_ok, overflow=need & rpc_ovf)


def update_lookup_cache(cfg, cache, key_lo, key_hi, node, slot_idx, found,
                        ds=ht):
    """lookup_end's caching duty (no-op when caching is off)."""
    if cache is None or not ds.uses_probe_cache(cfg):
        return cache
    return ds.cache_update(cfg, cache, key_lo, key_hi, node, slot_idx, found)


def hybrid_lookup(t: Transport, state, key_lo, key_hi, cfg, layout, *,
                  cache=None, use_onesided: bool = True,
                  rpc_serial: bool = False, capacity: Optional[int] = None,
                  enabled=None, nic=None, ds=ht, ptable=None):
    """Batched one-two-sided lookup.  key_lo/key_hi: (N, B) int32 words.

    Returns (state, cache, found (N,B), value (N,B,V), version (N,B),
    owner (N,B) int32, slot_idx (N,B), overflow (N,B) bool, HybridMetrics).
    """
    probe = onesided_probe(t, state, key_lo, key_hi, cfg, layout, cache=cache,
                           use_onesided=use_onesided, capacity=capacity,
                           enabled=enabled, nic=nic, ds=ds, ptable=ptable)

    # ---- phase 2: write-based RPC for the failed lanes --------------------
    recs = ds.lookup_records(cfg, key_lo, key_hi)
    handler = (ds.make_rpc_handler(cfg, layout) if rpc_serial
               else ds.make_lookup_handler_vector(cfg, layout))
    state, replies, ovf2, s_rpc = R.rpc_call(
        t, state, probe["node"], recs, handler, capacity=capacity,
        enabled=probe["need_rpc"], nic=nic)
    mg = merge_rpc_fallback(probe, replies, ovf2)

    # ---- lookup_end caching duty ------------------------------------------
    cache = update_lookup_cache(cfg, cache, key_lo, key_hi, probe["node"],
                                mg["slot_idx"], mg["found"], ds=ds)

    metrics = HybridMetrics(
        onesided_success=_count(probe["success"]),
        rpc_fallback=_count(probe["need_rpc"]),
        total=_count(probe["enabled"]),
        wire=probe["wire"] + s_rpc,
    )
    return (state, cache, mg["found"], mg["value"], mg["version"],
            probe["node"], mg["slot_idx"], mg["overflow"], metrics)
