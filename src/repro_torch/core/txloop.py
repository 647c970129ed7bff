"""Multi-round transaction engine: bounded retry with backoff (Storm §5.4),
PyTorch port of ``repro/core/txloop.py::tx_loop``.

``tx.run_transactions`` is single shot; ``tx_loop`` retries aborted
transactions:

  * a Python loop over ``max_rounds`` protocol rounds (the reference's
    ``lax.scan``);
  * per-round lane re-enable masks: committed lanes are parked (no handler
    work, no send-queue capacity, no wire bytes); lanes that aborted for ANY
    cause re-execute the full OCC protocol;
  * randomized-slot backoff: each round >= 1 permutes the surviving lanes'
    send-queue slots, which re-randomizes the lock serialization order.
    Round 0 is always the identity (single shot).

The permutations come from ``perms`` when given — the parity tests feed the
reference's ``jax.random`` draws, which torch cannot reproduce — and
otherwise from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.convert import words
from repro_torch.core import hybrid as hy
from repro_torch.core import slots as sl
from repro_torch.core import tx as txm
from repro_torch.core.datastructs import hashtable as ht
from repro_torch.core.transport import Transport
from repro_torch.device import resolve_device

DEFAULT_SEED = 0x5707


@dataclasses.dataclass
class TxLoopResult:
    committed: torch.Tensor            # (N, B) bool — committed in ANY round
    commit_round: torch.Tensor         # (N, B) int32 — round of commit, -1 if never
    read_found: torch.Tensor           # (N, B, R) bool — from the lane's last attempt
    read_values: torch.Tensor          # (N, B, R, VALUE_WORDS)
    # --- per-round metrics, each (max_rounds,) int32 -----------------------
    round_committed: torch.Tensor      # lanes that committed in round r
    round_attempts: torch.Tensor       # live lanes entering round r
    round_retries: torch.Tensor        # live lanes in round r > 0 (re-attempts)
    round_abort_lock: torch.Tensor     # aborts by cause, per round
    round_abort_validate: torch.Tensor
    round_abort_overflow: torch.Tensor
    round_abort_stale: torch.Tensor
    metrics: hy.HybridMetrics          # totals across all rounds
    round_trips: torch.Tensor          # scalar


def _perm_lanes(x, perm):
    """Permute the lane axis (axis 1) of (N, B, ...) by perm (N, B)."""
    idx = perm.reshape(perm.shape + (1,) * (x.dim() - 2)).expand(
        perm.shape + x.shape[2:])
    return torch.gather(x, 1, idx)


def _as_words(x, dev):
    """Keys/values as int32 word tensors on ``dev`` (numpy uint32 accepted)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return words(x, dev)


def tx_loop(t: Transport, state, cfg: ht.HashTableConfig, layout, *,
            read_keys, write_keys, write_values, read_enabled=None,
            write_enabled=None, cache=None, use_onesided: bool = True,
            capacity: Optional[int] = None, max_rounds: int = 4, perms=None,
            fused: bool = True, nic=None, device="cuda"):
    """Run a batch of transactions to convergence (bounded by max_rounds).

    Arguments mirror tx.run_transactions; additionally:
      max_rounds: retry bound (>= 1).  Round 0 is identical to the
                  single-shot protocol; each later round re-runs only the
                  still-aborted lanes with permuted send-queue slots.
      perms:      optional (max_rounds, N, B) lane permutations (row 0 is
                  ignored: round 0 is the identity); without them a CPU
                  torch.Generator seeded with DEFAULT_SEED draws them.
      device:     where the protocol runs; ``state["arena"]`` must be there.

    Returns (state, cache, TxLoopResult); ``state["arena"]`` is updated in
    place.
    """
    dev = resolve_device(device)
    if state["arena"].device.type != dev.type:
        raise ValueError(f"tx_loop: state is on {state['arena'].device}, "
                         f"expected {dev}")
    dev = state["arena"].device
    read_keys = _as_words(read_keys, dev)
    write_keys = _as_words(write_keys, dev)
    write_values = _as_words(write_values, dev)
    N, B, Rd = read_keys.shape[:3]
    if read_enabled is None:
        read_enabled = torch.ones(read_keys.shape[:3], dtype=torch.bool)
    if write_enabled is None:
        write_enabled = torch.ones(write_keys.shape[:3], dtype=torch.bool)
    read_enabled = torch.as_tensor(read_enabled, dtype=torch.bool).to(dev)
    write_enabled = torch.as_tensor(write_enabled, dtype=torch.bool).to(dev)
    if perms is not None:
        perms = torch.as_tensor(perms, dtype=torch.int64).to(dev)
        if tuple(perms.shape) != (max_rounds, N, B):
            raise ValueError(f"tx_loop: perms must be {(max_rounds, N, B)}, "
                             f"got {tuple(perms.shape)}")
    generator = torch.Generator().manual_seed(DEFAULT_SEED)
    ident = torch.arange(B, device=dev).expand(N, B)

    done = torch.zeros((N, B), dtype=torch.bool, device=dev)
    commit_round = torch.full((N, B), -1, dtype=torch.int32, device=dev)
    rfound = torch.zeros(read_enabled.shape, dtype=torch.bool, device=dev)
    rvals = torch.zeros(read_enabled.shape + (sl.VALUE_WORDS,),
                        dtype=torch.int32, device=dev)
    ys = []
    for rnd in range(max_rounds):
        if rnd == 0:
            perm = ident                              # round 0 == single shot
        elif perms is not None:
            perm = perms[rnd]
        else:
            perm = torch.rand((N, B), generator=generator).argsort(dim=1).to(dev)
        inv = torch.argsort(perm, dim=1)
        active = ~done
        p = lambda x: _perm_lanes(x, perm)
        u = lambda x: _perm_lanes(x, inv)
        act_p = p(active)

        state, cache, res = txm.run_transactions(
            t, state, cfg, layout,
            read_keys=p(read_keys), write_keys=p(write_keys),
            write_values=p(write_values),
            read_enabled=p(read_enabled) & act_p[..., None],
            write_enabled=p(write_enabled) & act_p[..., None],
            cache=cache, use_onesided=use_onesided, capacity=capacity,
            fused=fused, nic=nic)
        # fully-masked (parked) lanes report committed=True — gate on active
        newly = u(res.committed) & active
        done = done | newly
        commit_round = torch.where(newly, rnd, commit_round)
        rfound = torch.where(active[..., None], u(res.read_found), rfound)
        rvals = torch.where(active[..., None, None], u(res.read_values), rvals)
        count = lambda x: x.to(torch.int32).sum()
        ys.append(dict(
            committed=count(newly),
            attempts=count(active),
            retries=count(active) if rnd > 0 else count(active) * 0,
            abort_lock=count(u(res.aborted_lock) & active),
            abort_validate=count(u(res.aborted_validate) & active),
            abort_overflow=count(u(res.aborted_overflow) & active),
            abort_stale=count(u(res.aborted_stale) & active),
            metrics=res.metrics,
            round_trips=res.round_trips,
        ))

    col = lambda k: torch.stack([y[k] for y in ys]).to(torch.int32)
    total = lambda xs: torch.stack(xs).sum(dim=0)
    ms = [y["metrics"] for y in ys]
    wire = type(ms[0].wire)(**{
        f.name: total([getattr(m.wire, f.name) for m in ms])
        for f in dataclasses.fields(ms[0].wire)})
    metrics = hy.HybridMetrics(
        onesided_success=total([m.onesided_success for m in ms]),
        rpc_fallback=total([m.rpc_fallback for m in ms]),
        total=total([m.total for m in ms]), wire=wire)
    result = TxLoopResult(
        committed=done,
        commit_round=commit_round,
        read_found=rfound,
        read_values=rvals,
        round_committed=col("committed"),
        round_attempts=col("attempts"),
        round_retries=col("retries"),
        round_abort_lock=col("abort_lock"),
        round_abort_validate=col("abort_validate"),
        round_abort_overflow=col("abort_overflow"),
        round_abort_stale=col("abort_stale"),
        metrics=metrics,
        round_trips=total([y["round_trips"] for y in ys]),
    )
    return state, cache, result
