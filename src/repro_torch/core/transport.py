"""Transport layer: the "reliable connected" fabric (Storm §4.2), PyTorch port
of ``repro/core/transport.py``.

The single exchange primitive is dest-major -> source-major:

    exchange(x): x[dst, c, ...] (what THIS node wants delivered to `dst`)
             ->  y[src, c, ...] (what `src` delivered to THIS node)

``SimTransport`` simulates an N-node cluster on one device: cluster tensors
carry a leading node axis and exchange is a transpose.  The reference's
``MeshTransport`` (one node per device, an all-to-all collective) belongs to
a later slice of the port.

Protocol code is written once at cluster level: node-state tensors have one
leading node axis (N, ...), and where the reference ``vmap``s per-node code
over it, the port writes the batch axis out.
"""
from __future__ import annotations

import dataclasses
import math

import torch


class Transport:
    n_nodes: int  # global node count

    def exchange(self, x):
        raise NotImplementedError

    def node_ids(self, device=None):
        """Global ids of the nodes in this shard: (n_local,) int32."""
        raise NotImplementedError

    @property
    def n_local(self) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class SimTransport(Transport):
    """Whole cluster on one device; leading axis = node."""
    n_nodes: int

    def exchange(self, x):
        # x: (N_this, N_dst, C, ...) -> (N_this, N_src, C, ...)
        if x.shape[0] != self.n_nodes or x.shape[1] != self.n_nodes:
            raise ValueError(f"exchange expects ({self.n_nodes}, "
                             f"{self.n_nodes}, ...), got {tuple(x.shape)}")
        return x.transpose(0, 1)

    def node_ids(self, device=None):
        return torch.arange(self.n_nodes, dtype=torch.int32, device=device)

    @property
    def n_local(self) -> int:
        return self.n_nodes


# ---------------------------------------------------------------------------
# Client-side routing: pack per-lane requests into the dest-major send buffer
# (the coroutine scheduler's doorbell batching, with a fixed per-destination
# capacity C; overflowed lanes report failure and retry at the app level).
# ---------------------------------------------------------------------------
def route_by_dest(dest, payload, n_dst: int, capacity: int, enabled=None):
    """dest: (..., B) int32 in [0, n_dst); payload: (..., B, W) int32 words.
    Leading axes (the node axis of a cluster call) are batch axes.

    enabled: optional (..., B) bool — lanes that actually issue a request.
    Disabled lanes are parked and do NOT consume destination capacity.  A
    dest outside [0, n_dst) (placement's "unreachable" sentinel -1) is
    parked exactly like a disabled lane.

    Returns:
      buf      (..., n_dst, capacity, W) int32 — dest-major send buffer
      mask     (..., n_dst, capacity)    bool  — which cells hold live requests
      pos      (..., B)                  int64 — cell index of each lane
                                                 (== capacity for parked lanes)
      overflow (..., B)                  bool  — enabled lanes dropped by capacity
    """
    batch = dest.shape[:-1]
    B = dest.shape[-1]
    W = payload.shape[-1]
    dev = dest.device
    G = math.prod(batch)
    dest = dest.to(torch.int64).reshape(G, B)
    payload = payload.reshape(G, B, W)
    live = (torch.ones_like(dest, dtype=torch.bool) if enabled is None
            else enabled.reshape(G, B).clone())
    live &= (dest >= 0) & (dest < n_dst)
    dest = dest.clamp(0, n_dst - 1)
    # rank of each lane within its destination group (stable order, live only)
    onehot = ((dest[..., None] == torch.arange(n_dst, device=dev))
              & live[..., None])
    pos = torch.gather(torch.cumsum(onehot.to(torch.int64), dim=1) - 1, 2,
                       dest[..., None])[..., 0]
    overflow = live & (pos >= capacity)
    # overflowed and disabled lanes land in a trash column that is sliced off
    pos = torch.where(live & ~overflow, pos, capacity)
    g = torch.arange(G, device=dev)[:, None].expand(G, B)
    buf = torch.zeros((G, n_dst, capacity + 1, W), dtype=torch.int32,
                      device=dev)
    buf[g, dest, pos] = payload.to(torch.int32)
    mask = torch.zeros((G, n_dst, capacity + 1), dtype=torch.bool, device=dev)
    mask[g, dest, pos] = live
    return (buf[:, :, :capacity].reshape(batch + (n_dst, capacity, W)),
            mask[:, :, :capacity].reshape(batch + (n_dst, capacity)),
            pos.reshape(batch + (B,)), overflow.reshape(batch + (B,)))


def placement_dest(copies, alive, part):
    """Resolve a partition to its first LIVE copy under a placement table.

    copies: (n_parts, K) int32 — copy list per partition, column 0 = owner,
            -1 = no copy in that slot.  alive: (n_nodes,) bool.  part: any
            batch shape.  Returns (dest, reachable): -1 when every copy is
    dead, which route_by_dest parks (ST_DROPPED back-pressure)."""
    row = copies[part.to(torch.int64)]                          # (..., K)
    ok = (row >= 0) & alive[row.clamp(0, alive.shape[0] - 1).to(torch.int64)]
    idx = torch.argmax(ok.to(torch.int32), dim=-1)             # first live slot
    reachable = ok.any(dim=-1)
    dest = torch.gather(row, -1, idx[..., None])[..., 0]
    return torch.where(reachable, dest, -1).to(torch.int32), reachable


def route_by_placement(table, part, payload, n_dst: int, capacity: int,
                       enabled=None):
    """route_by_dest with the destination resolved THROUGH a placement table
    (anything with ``.copies`` (n_parts, K) int32 and ``.alive`` (n_nodes,)
    bool): each lane goes to its partition's first live copy, and lanes
    whose partition has no live copy route to -1 and are parked.

    Returns (dest, reachable, buf, mask, pos, overflow): the leading pair
    lets callers pick replies by dest and report ``enabled & ~reachable``
    as dead routes."""
    dest, reachable = placement_dest(table.copies, table.alive, part)
    buf, mask, pos, overflow = route_by_dest(dest, payload, n_dst, capacity,
                                             enabled)
    return dest, reachable, buf, mask, pos, overflow


def pick_replies(replies, dest, pos, overflow):
    """replies: (..., n_dst, C, W) dest-major reply buffer (post-exchange);
    returns per-lane replies (..., B, W).  Lanes without a live cell
    (overflowed or parked at pos >= C) read back zeros."""
    C = replies.shape[-2]
    R = replies.shape[-1]
    if C == 0:
        return torch.zeros(dest.shape + (R,), dtype=replies.dtype,
                           device=replies.device)
    invalid = overflow | (pos >= C)
    n_dst = replies.shape[-3]
    cell = (dest.to(torch.int64).clamp(0, n_dst - 1) * C
            + torch.where(invalid, 0, pos))
    flat = replies.reshape(replies.shape[:-3] + (n_dst * C, R))
    out = torch.gather(flat, -2, cell[..., None].expand(cell.shape + (R,)))
    return torch.where(invalid[..., None], torch.zeros_like(out), out)


# ---------------------------------------------------------------------------
# Wire accounting — the hardware-independent metrics the benchmarks report
# (round trips / messages / bytes per op).  Counts are float32 sums, like the
# reference's, so CPU parity is exact.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class WireStats:
    round_trips: torch.Tensor   # scalar f32 — network round trips issued
    messages: torch.Tensor      # scalar f32 — coalesced messages on the wire
    ops: torch.Tensor           # scalar f32 — application-level requests
    req_bytes: torch.Tensor     # scalar f32
    reply_bytes: torch.Tensor   # scalar f32
    nic_hit_ops: torch.Tensor     # sum(ops * cache_hit)
    nic_penalty_us: torch.Tensor  # sum(ops * penalty_us)

    @staticmethod
    def zero(device=None):
        return WireStats(**{f.name: torch.zeros((), dtype=torch.float32,
                                                device=device)
                            for f in dataclasses.fields(WireStats)})

    def __add__(self, o):
        return WireStats(**{f.name: getattr(self, f.name) + getattr(o, f.name)
                            for f in dataclasses.fields(WireStats)})

    @property
    def total_bytes(self):
        return self.req_bytes + self.reply_bytes

    @property
    def nic_hit_rate(self):
        """Ops-weighted modeled NIC-cache hit rate (1.0 when no ConnTable
        was threaded through)."""
        return torch.where(self.ops > 0,
                           self.nic_hit_ops / torch.clamp(self.ops, min=1.0),
                           1.0)

    @property
    def nic_penalty_us_per_op(self):
        """Ops-weighted modeled per-op connection-state penalty (us)."""
        return torch.where(self.ops > 0,
                           self.nic_penalty_us / torch.clamp(self.ops, min=1.0),
                           0.0)


def _f32(x, like):
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _nic_terms(ops, nic):
    """ops-weighted (hit, penalty) terms for one round; nic is a static
    core.nic.ConnTable (or None = perfect, penalty-free NIC)."""
    if nic is None:
        return ops, torch.zeros_like(ops)
    return ops * _f32(nic.cache_hit, ops), ops * _f32(nic.penalty_us_per_op, ops)


def wire_for(mask, req_words: int, reply_words: int, header_words: int = 1,
             nic=None):
    """Stats for one exchange round given the live-cell mask (..., n_dst, C).
    Requests headed for one destination ride ONE coalesced message per live
    (src, dst) pair each way; each message pays the header once, each record
    its payload."""
    f32 = torch.float32
    live = mask.to(f32).sum()
    pairs = mask.any(dim=-1).to(f32).sum()
    reply_pairs = pairs if reply_words > 0 else torch.zeros_like(pairs)
    hit_ops, penalty_us = _nic_terms(live, nic)
    return WireStats(
        round_trips=(pairs > 0).to(f32),
        messages=pairs + reply_pairs,
        ops=live,
        req_bytes=live * 4.0 * req_words + pairs * 4.0 * header_words,
        reply_bytes=live * 4.0 * reply_words + reply_pairs * 4.0 * header_words,
        nic_hit_ops=hit_ops,
        nic_penalty_us=penalty_us,
    )


def _class_pairs(masks, reply_words, reduce_dims):
    """Live (src, dst) pairs of a fused round, all classes OR-ed together:
    (requests, replies), each summed over ``reduce_dims``."""
    f32 = torch.float32
    pair_live = None
    reply_pair_live = None
    for m, rw in zip(masks, reply_words):
        a = m.any(dim=-1)
        pair_live = a if pair_live is None else (pair_live | a)
        if rw > 0:
            reply_pair_live = a if reply_pair_live is None else (reply_pair_live | a)
    zero = torch.zeros(masks[0].shape[-2:-1] if reduce_dims == (0,) else (),
                       dtype=f32, device=masks[0].device)
    pairs = zero if pair_live is None else pair_live.to(f32).sum(dim=reduce_dims)
    reply_pairs = (zero if reply_pair_live is None
                   else reply_pair_live.to(f32).sum(dim=reduce_dims))
    return pairs, reply_pairs


def wire_for_classes(masks, req_words, reply_words, header_words: int = 1,
                     nic=None):
    """Coalesced stats for ONE fused exchange round carrying several traffic
    classes (roundsched.fused_round): a (src, dst) pair is counted ONCE no
    matter how many classes it carries, while `ops` counts every delivered
    application-level request."""
    f32 = torch.float32
    dev = masks[0].device
    zero = torch.zeros((), dtype=f32, device=dev)
    live = [m.to(f32).sum() for m in masks]
    ops = sum(live, zero)
    pairs, reply_pairs = _class_pairs(masks, reply_words,
                                      tuple(range(masks[0].dim() - 1)))
    req_bytes = sum((l * 4.0 * w for l, w in zip(live, req_words)), zero)
    reply_bytes = sum((l * 4.0 * w for l, w in zip(live, reply_words)), zero)
    hit_ops, penalty_us = _nic_terms(ops, nic)
    return WireStats(
        round_trips=(pairs > 0).to(f32),
        messages=pairs + reply_pairs,
        ops=ops,
        req_bytes=req_bytes + pairs * 4.0 * header_words,
        reply_bytes=reply_bytes + reply_pairs * 4.0 * header_words,
        nic_hit_ops=hit_ops,
        nic_penalty_us=penalty_us,
    )


def per_dest_wire(masks, req_words, reply_words, header_words: int = 1):
    """Per-DESTINATION view of :func:`wire_for_classes` for one fused round.
    masks: each (N_src, n_dst, C_k).  Returns ``(msgs, bytes)``, two (n_dst,)
    float32 vectors whose sums reproduce the round's ``messages`` /
    ``total_bytes``."""
    f32 = torch.float32
    n_dst = masks[0].shape[-2]
    zero = torch.zeros((n_dst,), dtype=f32, device=masks[0].device)
    live = [m.to(f32).sum(dim=(0, -1)) for m in masks]          # (n_dst,)
    pairs, reply_pairs = _class_pairs(masks, reply_words, (0,))
    req_bytes = sum((l * 4.0 * w for l, w in zip(live, req_words)), zero)
    reply_bytes = sum((l * 4.0 * w for l, w in zip(live, reply_words)), zero)
    msgs = pairs + reply_pairs
    byts = (req_bytes + reply_bytes + pairs * 4.0 * header_words
            + reply_pairs * 4.0 * header_words)
    return msgs, byts
