"""Workload builders of the port: counterparts of ``benchmarks/common.py``'s
``populate`` / ``make_tx_workload`` and of the TATP transaction draw in
``benchmarks/fig6_tatp.py``, making the SAME ``np.random.RandomState`` draws
in the same order, so a workload built here equals the reference's word for
word.  Every builder takes ``device=`` (default ``"cuda"``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.convert import words
from repro_torch.core import rpc as R
from repro_torch.core import slots as sl
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.device import resolve_device

POPULATE_BATCH = 64      # inserts per node per RPC round, as the reference


def value_for(key_lo):
    """Deterministic per-key slot value (VALUE_WORDS words)."""
    i = torch.arange(sl.VALUE_WORDS, dtype=torch.int32, device=key_lo.device)
    return sl._mix32(key_lo[..., None] + i)


def populate(cfg, layout, t, state, n_keys_per_node, seed=0, device="cuda"):
    """Insert n keys per node (RPC inserts from every node to the keys'
    homes, POPULATE_BATCH per node per round); returns (state, (klo, khi))
    with (N, n) int32 key words."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    N = cfg.n_nodes
    klo = words(rng.randint(0, 2**31, (N, n_keys_per_node)), dev)
    khi = words(rng.randint(0, 2**31, (N, n_keys_per_node)), dev)
    h = ht.make_rpc_handler(cfg, layout)
    for i in range(0, n_keys_per_node, POPULATE_BATCH):
        kl, kh = klo[:, i:i + POPULATE_BATCH], khi[:, i:i + POPULATE_BATCH]
        node, _, _ = ht.lookup_start(cfg, layout, kl, kh)
        state, _, _, _ = R.rpc_call(
            t, state, node,
            ht.make_record(R.OP_INSERT, kl, kh, value=value_for(kl)), h)
    return state, (klo, khi)


def make_tx_workload(t, cfg, layout, state, *, lanes, n_keys, seed,
                     device="cuda"):
    """Populate the table and draw the deterministic one-read/one-write
    transaction batch per lane of the bench gate.

    Returns (state, read_keys (N, lanes, 1, 2), write_keys, write_values)."""
    dev = resolve_device(device)
    state, (klo, khi) = populate(cfg, layout, t, state, n_keys, seed=seed,
                                 device=dev)
    rng = np.random.RandomState(seed + 1)
    s = rng.randint(0, cfg.n_nodes, (cfg.n_nodes, lanes, 1))
    i = rng.randint(0, n_keys, (cfg.n_nodes, lanes, 1))
    lo, hi = klo.cpu().numpy(), khi.cpu().numpy()
    rk = torch.from_numpy(np.stack([lo[s, i], hi[s, i]], -1)).to(dev)
    wk = rk ^ sl.word(0x9E3779B9)          # disjoint write set
    wv = (sl._mix32(wk[..., 0] + (seed + 11))[..., None]
          .expand(wk.shape[:-1] + (sl.VALUE_WORDS,)).contiguous())
    return state, rk, wk, wv


def tatp_transactions(klo, khi, *, n_nodes, lanes, subscribers_per_node,
                      rng, rd=2, wr=1, device="cuda"):
    """One TATP batch (the 80/16/4 mix of ``fig6_tatp.draw_tx``): 80% read
    transactions (half of them read two rows), 16% updates and 4%
    inserts/deletes (1 write each; updates also read 1 row).

    klo/khi: (N, subscribers) populated key words; rng: the RandomState the
    reference draws from.  Returns (read_keys (N, L, rd, 2), write_keys
    (N, L, wr, 2), read_enabled, write_enabled, write_values)."""
    dev = resolve_device(device)
    lo, hi = klo.cpu().numpy(), khi.cpu().numpy()

    def pick(n):
        s = rng.randint(0, n_nodes, (n_nodes, lanes, n))
        i = rng.randint(0, subscribers_per_node, (n_nodes, lanes, n))
        return lo[s, i], hi[s, i]

    rl, rh = pick(rd)
    wl, wh = pick(wr)
    kind = rng.rand(n_nodes, lanes)
    is_read = kind < 0.80                 # read-only tx
    two_reads = kind < 0.40               # GET_NEW_DESTINATION-like
    read_en = np.ones((n_nodes, lanes, rd), bool)
    read_en[..., 1] = two_reads
    read_en[~is_read, 1] = False          # updates read 1 row
    write_en = np.repeat((~is_read)[..., None], wr, axis=-1)
    rk = torch.from_numpy(np.stack([rl, rh], -1)).to(dev)
    wk = torch.from_numpy(np.stack([wl, wh], -1)).to(dev)
    wvals = (sl._mix32(wk[..., 0] + 99)[..., None]
             .expand(wk.shape[:-1] + (sl.VALUE_WORDS,)).contiguous())
    return (rk, wk, torch.from_numpy(read_en).to(dev),
            torch.from_numpy(write_en).to(dev), wvals)


def gate_tx_smoke(device="cuda"):
    """The bench gate's fused tx_loop workload (``bench_gate._tx_smoke``: 4
    nodes, 8 lanes, 256 buckets, 64 keys per node, seed 5, 2 rounds).

    Returns (state, TxLoopResult, keys) with the gate's top-level keys
    ``round_trips`` / ``rt_round`` / ``commit_rate`` / ``wire_bytes_tx``,
    rounded as ``bench_gate.collect`` rounds them."""
    from repro_torch.core import txloop as txl
    from repro_torch.core.transport import SimTransport

    dev = resolve_device(device)
    n_nodes, lanes, max_rounds = 4, 8, 2
    cfg = ht.HashTableConfig(n_nodes=n_nodes, n_buckets=256, bucket_width=1,
                             n_overflow=64, max_chain=8)
    layout = ht.build_layout(cfg)
    t = SimTransport(n_nodes)
    state = ht.init_cluster_state(cfg, device=dev)
    state, rk, wk, wv = make_tx_workload(t, cfg, layout, state, lanes=lanes,
                                         n_keys=64, seed=5, device=dev)
    state, _, res = txl.tx_loop(t, state, cfg, layout, read_keys=rk,
                                write_keys=wk, write_values=wv,
                                max_rounds=max_rounds, device=dev)
    rounds_attempted = int((res.round_attempts > 0).sum())
    n_tx = n_nodes * lanes
    keys = {
        "round_trips": float(res.round_trips),
        "rt_round": round(float(res.round_trips) / max(rounds_attempted, 1), 4),
        "commit_rate": round(float(res.committed.float().mean()), 4),
        "wire_bytes_tx": round(float(res.metrics.wire.total_bytes) / n_tx, 2),
    }
    return state, res, keys
