"""Write-based RPC (Storm §5.2), PyTorch port of ``repro/core/rpc.py``.

Request records are written into per-owner inbox buffers by one exchange
(the one-sided write of the request); the cell coordinates (src, slot) play
the immediate header; one validity mask per inbox is the single completion
queue; the owner runs the registered handler, and replies come back by the
mirror exchange.

Handlers come in two flavours:
  * ``serial``  — mutating ops, folded record by record through node state
    (``roundsched.serial_apply``): the fold order is the serialization order.
  * ``vector``  — read-only ops (lookups), over all live cells at once.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core import roundsched as rs
from repro_torch.core.roundsched import serial_apply, vector_apply  # noqa: F401  (re-export)
from repro_torch.core.transport import Transport, WireStats  # noqa: F401  (re-export)
from repro_torch.core.wireproto import (  # noqa: F401  (re-export)
    OP_ABORT_UNLOCK, OP_BACKUP_WRITE, OP_COMMIT_UNLOCK, OP_DELETE, OP_INSERT,
    OP_LOCK, OP_LOOKUP, OP_NOP, OP_PL_INSTALL, OP_READ_VERSION, OP_UPDATE,
    ST_BAD_OP, ST_DROPPED, ST_LOCK_FAIL, ST_NOT_FOUND, ST_NO_SPACE, ST_OK,
    ST_WRONG_EPOCH)


@dataclasses.dataclass(frozen=True)
class Handler:
    """A registered rpc_handler (Storm Table 3).  ``prepare`` (serial
    handlers, optional) computes per-record values for a whole fold at once
    (roundsched.serial_apply)."""
    fn: Callable            # see roundsched serial/vector signatures
    reply_words: int
    serial: bool = True
    prepare: Optional[Callable] = None


def rpc_call(t: Transport, state, dest, records, handler: Handler, *,
             capacity: Optional[int] = None, enabled=None, nic=None,
             telemetry=None, phase: int = 0):
    """Batched write-based RPC round (one round trip for B lanes/node) — a
    single-class fused round.

    dest: (N, B) int32; records: (N, B, W) int32 words (word 0 = opcode);
    enabled: optional (N, B) bool.  capacity: per-destination budget
    (``None`` = B, 0 = deliver nothing, negative rejected).

    Returns (state, replies (N, B, R), overflow (N, B), WireStats).
    Overflowed and parked lanes carry ST_DROPPED in reply word 0.
    ``telemetry``/``phase``: the round's flight-recorder event
    (roundsched.fused_round).
    """
    state, ((out, ovf),), stats = rs.fused_round(
        t, state,
        [rs.rpc_class(dest, records, handler, enabled=enabled,
                      capacity=capacity)], nic=nic, telemetry=telemetry,
        phase=phase)
    return state, out, ovf, stats
