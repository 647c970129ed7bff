"""OCC transactions under contention: bank-transfer style demo, on the
PyTorch port (the counterpart of ``examples/kvstore_tx.py``, the same
constants, flow and printed lines).

Ten accounts, many concurrent transfer transactions per round; Storm's OCC
protocol (execute / lock / validate / commit, Fig. 3) guarantees exactly one
winner per contended account, and the bounded-retry engine (txloop.tx_loop)
re-runs the losers with randomized-slot backoff until the batch converges —
per-round abort causes are printed so the contention is visible.

From round 1 on the reference draws its backoff permutations from
``jax.random``, which torch cannot reproduce: run alone, this example draws
them from the port's default generator, so its lines after round 0 may
differ from the reference's; ``main(perms=...)`` takes the reference's
draws and then prints its lines exactly.  As in the reference only
accounts 0-5 are inserted (``acc[:, :LANES]``), so the final lookup of
accounts 6-9 misses, and a miss returns slot 0's reply words
(``lookup_end``'s semantics, kept as they are).

    PYTHONPATH=src python examples/torch_kvstore_tx.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.convert import to_numpy
from repro_torch.core import rpc, slots as sl, txloop
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import SimTransport
from repro_torch.device import resolve_device

N_NODES, LANES, ACCOUNTS, ROUNDS = 2, 6, 10, 8


def main(argv=None, device=None, perms=None):
    """Run the demo on ``--device`` (default ``cuda``; ``device`` overrides
    it); ``perms``: optional (ROUNDS, N_NODES, LANES) backoff permutations
    for ``tx_loop``.  Returns {"lines": the printed lines, "state": the
    cluster state, "result": the TxLoopResult, "versions": node 0's view of
    every account's version}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(device or ap.parse_args(argv).device)
    lines = []

    def say(*parts):
        s = " ".join(str(p) for p in parts)
        print(s)
        lines.append(s)

    cfg = ht.HashTableConfig(n_nodes=N_NODES, n_buckets=32, bucket_width=2,
                             n_overflow=32)
    layout = ht.build_layout(cfg)
    t = SimTransport(N_NODES)
    state = ht.init_cluster_state(cfg, device=dev)
    handler = ht.make_rpc_handler(cfg, layout)

    # accounts 0..9, each starting with balance 100 (word 0 of the value)
    acc = torch.arange(ACCOUNTS, dtype=torch.int32,
                       device=dev)[None].repeat(N_NODES, 1)
    acc = acc[:, :LANES] if LANES <= ACCOUNTS else acc
    zeros = torch.zeros_like(acc)
    bal0 = torch.zeros((N_NODES, acc.shape[1], sl.VALUE_WORDS),
                       dtype=torch.int32, device=dev)
    bal0[..., 0] = 100
    owner, _, _ = ht.lookup_start(cfg, layout, acc, zeros)
    state, rep, _, _ = rpc.rpc_call(
        t, state, owner, ht.make_record(rpc.OP_INSERT, acc, zeros, value=bal0),
        handler)

    rng = np.random.RandomState(0)
    # every lane tries to bump ONE random account's balance; heavy contention
    # on ten accounts from 12 lanes.  tx_loop retries the losers: each retry
    # round re-enables exactly the aborted lanes with permuted send-queue
    # slots.
    target = torch.from_numpy(rng.randint(0, ACCOUNTS, (N_NODES, LANES)).astype(
        np.int32)).to(dev)
    tz = torch.zeros_like(target)
    wk = torch.stack([target, tz], -1)[:, :, None, :]
    new_vals = torch.zeros((N_NODES, LANES, 1, sl.VALUE_WORDS),
                           dtype=torch.int32, device=dev)
    new_vals[..., 0] = 101
    state, _, res = txloop.tx_loop(
        t, state, cfg, layout,
        read_keys=torch.zeros((N_NODES, LANES, 0, 2), dtype=torch.int32,
                              device=dev),
        write_keys=wk, write_values=new_vals, max_rounds=ROUNDS, perms=perms,
        device=dev)
    committed = int(res.committed.sum())
    aborted = res.committed.numel() - committed
    say(f"{ROUNDS} retry rounds x {N_NODES*LANES} lanes: "
        f"{committed} committed, {aborted} never converged")
    say("per-round commits:      ", res.round_committed.cpu().numpy())
    say("per-round lock aborts:  ", res.round_abort_lock.cpu().numpy())
    say("per-round valid. aborts:", res.round_abort_validate.cpu().numpy())
    say("single-shot would have committed",
        int(res.round_committed[0]), "and dropped the rest")

    # winners-only accounting: look up ALL ten accounts (from every node —
    # the owner's authoritative reply is identical regardless of who asks)
    # and show node 0's view of each
    acc_all = torch.arange(ACCOUNTS, dtype=torch.int32,
                           device=dev)[None].repeat(N_NODES, 1)
    z_all = torch.zeros_like(acc_all)
    owner_all, _, _ = ht.lookup_start(cfg, layout, acc_all, z_all)
    state, repl, _, _ = rpc.rpc_call(
        t, state, owner_all, ht.make_record(rpc.OP_LOOKUP, acc_all, z_all),
        handler)
    versions = to_numpy(repl[0, :, 2])
    say("final account versions:", versions)
    say("(even versions = consistent, unlocked; each +2 is one committed "
        "write)")
    return {"lines": lines, "state": state, "result": res,
            "versions": versions}


if __name__ == "__main__":
    main()
