"""Quickstart: the Storm dataplane in ~40 lines, on the PyTorch port (the
counterpart of ``examples/quickstart.py``, the same constants, flow and
printed lines).

Builds a 4-node distributed hash table (simulated cluster), inserts keys via
write-based RPCs, reads them back with one-two-sided hybrid lookups (on the
card their one-sided read is the ``hash_probe`` kernel), and runs one OCC
transaction.  Words are int32 bit images of the reference's uint32 words.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import hybrid, rpc, slots as sl, tx
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import SimTransport
from repro_torch.device import resolve_device

N_NODES, LANES = 4, 8


def main(argv=None, device=None):
    """Run the quickstart on ``--device`` (default ``cuda``; ``device``
    overrides it).  Returns {"lines": the printed lines, "state": the
    cluster state, "result": the transaction batch's TxResult}."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(device or ap.parse_args(argv).device)
    lines = []

    def say(s):
        print(s)
        lines.append(s)

    cfg = ht.HashTableConfig(n_nodes=N_NODES, n_buckets=64, bucket_width=1,
                             n_overflow=64)
    layout = ht.build_layout(cfg)
    t = SimTransport(N_NODES)
    state = ht.init_cluster_state(cfg, device=dev)

    # --- insert: every node writes 8 keys through the rpc_handler ----------
    klo = torch.arange(N_NODES * LANES, dtype=torch.int32,
                       device=dev).reshape(N_NODES, LANES)
    khi = torch.zeros_like(klo)
    vals = sl._mix32(klo[..., None] + torch.arange(
        sl.VALUE_WORDS, dtype=torch.int32, device=dev))
    owner, _, _ = ht.lookup_start(cfg, layout, klo, khi)
    handler = ht.make_rpc_handler(cfg, layout)
    state, rep, _, _ = rpc.rpc_call(
        t, state, owner, ht.make_record(rpc.OP_INSERT, klo, khi, value=vals),
        handler)
    say(f"inserted {int((rep[..., 0] == rpc.ST_OK).sum())} keys")

    # --- one-two-sided lookups (Algorithm 1) --------------------------------
    state, _, found, got, _, _, _, _, m = hybrid.hybrid_lookup(
        t, state, klo, khi, cfg, layout, use_onesided=True)
    assert bool(found.all()) and torch.equal(got, vals)
    say(f"lookups: {float(m.onesided_success):.0f}/{float(m.total):.0f} "
        f"served by ONE one-sided read; {float(m.rpc_fallback):.0f} chased "
        f"pointers via RPC; {float(m.wire.total_bytes):.0f} wire bytes")

    # --- one OCC transaction per lane: read 1 key, write 1 fresh key -------
    state, _, res = tx.run_transactions(
        t, state, cfg, layout,
        read_keys=torch.stack([klo[:, :, None], khi[:, :, None]], -1),
        write_keys=torch.stack([klo[:, :, None] + 1000, khi[:, :, None]], -1),
        write_values=vals[:, :, None, :])
    say(f"transactions committed: {int(res.committed.sum())}/"
        f"{res.committed.numel()} in {float(res.round_trips):.0f} pipeline "
        f"round trips")
    return {"lines": lines, "state": state, "result": res}


if __name__ == "__main__":
    main()
