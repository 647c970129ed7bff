"""One-sided remote reads and writes (Storm §4.2, §5.1), PyTorch port of
``repro/core/onesided.py``.

The defining property of a one-sided op is that the OWNER RUNS NO
APPLICATION LOGIC: the initiator names (node, offset, length) and the owner
side is an address translation plus a gather/scatter — the work an RDMA NIC
does in hardware.  All ops are batched: each node issues B lanes per round.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import regions as rg
from repro_torch.core import roundsched as rs
from repro_torch.core.transport import Transport, route_by_dest, wire_for, wire_for_classes


def remote_read(t: Transport, arenas, dest, offsets, *, length: int,
                capacity: Optional[int] = None,
                mode: rg.AddressMode | None = None, page_tables=None,
                enabled=None, nic=None):
    """Batched one-sided READ — a single-class fused round.

    arenas: (N, words) int32; dest: (N, B) int32; offsets: (N, B) int32
    word offsets; length: words per read.  Disabled lanes issue nothing and
    read back zeros.  Returns (data (N, B, length), overflow (N, B),
    WireStats)."""
    _, ((out, ovf),), stats = rs.fused_round(
        t, {"arena": arenas},
        [rs.read_class(dest, offsets, length=length, enabled=enabled,
                       capacity=capacity, mode=mode, page_tables=page_tables)],
        nic=nic)
    return out, ovf, stats


def read_round(t: Transport, dest, offsets, *, length: int,
               capacity: Optional[int] = None, enabled=None, nic=None):
    """Route and account a one-sided READ round whose owner-side gather the
    caller performs itself (``hybrid.onesided_probe`` fuses it with the
    probe check in one kernel).

    Returns (delivered (N, B) bool, overflow (N, B) bool, WireStats): the
    lanes that hold a live send-queue cell — exactly those for which
    :func:`remote_read` returns the owner's words instead of zeros — with
    overflow, parking and wire accounting identical to :func:`remote_read`.
    """
    spec = rs.route_class(t.n_nodes, rs.read_class(
        dest, offsets, length=length, enabled=enabled, capacity=capacity))
    stats = wire_for_classes([spec["mask"]], [spec["W"]], [spec["R"]],
                             nic=nic)
    return spec["pos"] < spec["cap"], spec["ovf"], stats


def remote_write(t: Transport, arenas, dest, offsets, values, *,
                 capacity: Optional[int] = None,
                 mode: rg.AddressMode | None = None, page_tables=None,
                 enabled=None, nic=None):
    """Batched one-sided WRITE (no reply payload — transport-level ack only).

    values: (N, B, L) int32; enabled: optional (N, B) bool.
    Returns (new_arenas, overflow, WireStats); the input arenas are not
    modified."""
    B = dest.shape[-1]
    L = values.shape[-1]
    cap = B if capacity is None else int(capacity)
    if cap < 0:
        raise ValueError(f"per-destination capacity must be >= 0, got {cap}")
    if enabled is None:
        enabled = torch.ones(dest.shape, dtype=torch.bool, device=dest.device)
    payload = torch.cat([offsets[..., None].to(torch.int32),
                         values.to(torch.int32)], dim=-1)
    buf, mask, pos, ovf = route_by_dest(dest, payload, t.n_nodes, cap, enabled)
    inbox = t.exchange(buf)
    inbox_mask = t.exchange(mask)
    paged = mode is not None and mode.kind == "paged"
    arenas = rg.arena_write(arenas, inbox[..., 0], inbox[..., 1:],
                            mode=mode if paged else None,
                            page_table=page_tables if paged else None,
                            enabled=inbox_mask)
    stats = wire_for(mask, req_words=1 + L, reply_words=0, nic=nic)
    return arenas, ovf, stats
