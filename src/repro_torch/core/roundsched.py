"""Multi-class fused round scheduler (Storm §4.5 doorbell batching, Fig. 3),
PyTorch port of ``repro/core/roundsched.py``.

``fused_round`` takes several *traffic classes* — each = (dest, payload,
reply shape, owner-side action) — packs them into ONE dest-major send buffer,
performs ONE exchange each way, runs each class's owner action over its
sub-inbox, and returns per-class replies and overflow masks plus a single
coalesced :class:`WireStats`.

Owner-side ordering inside one fused round is fixed, because it is what
makes fusing OCC phases legal:

  1. **vector handlers** observe the round's PRE-handler state;
  2. **serial handlers** fold through node state in class order;
  3. **one-sided gathers** run LAST, on the post-handler state.

Each class reserves its own per-destination sub-budget (``capacity``,
defaulting to its lane count); the shared send buffer is the concatenation
of the class segments.  Overflowed/parked rpc lanes carry ST_DROPPED in reply
word 0; overflowed/parked read lanes read back zeros.

State is a dict of cluster tensors with a leading node axis.  Serial handlers
update ``state["arena"]`` IN PLACE (a copy per record would cost the whole
arena per write); callers that need the pre-round state clone it first.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core import regions as rg
from repro_torch.core.transport import (Transport, pick_replies,
                                        route_by_dest, wire_for_classes)
from repro_torch.core.wireproto import ST_DROPPED


# ---------------------------------------------------------------------------
# Handler application
# ---------------------------------------------------------------------------
def serial_apply(handler, state, records, mask):
    """Fold every node's live records through its state in inbox order.

    handler.fn(state, rec (N, W), valid (N,), pre=..., ops=...) ->
    (state, reply (N, R)) takes ONE record per node, all nodes in one
    batched step.  records: (N, S, C, W); mask: (N, S, C) -> replies
    (N, S, C, R).

    Step k applies every node's k-th LIVE record (its rank in the flattened
    (src, cell) order, the reference's scan order); positions where no node
    has a live record are skipped.  This is exact: a record with valid=False
    writes nothing, and pick_replies never reads a dead cell's reply (a node
    without a k-th live record writes its no-op reply into a dead cell).
    ``pre`` is ``handler.prepare`` of the step's records (computed for the
    whole fold at once) and ``ops`` the set of opcodes among the live
    records."""
    N, S, C, W = records.shape
    R_ = handler.reply_words
    flat_r = records.reshape(N, S * C, W)
    flat_m = mask.reshape(N, S * C)
    replies = torch.zeros((N, S * C, R_), dtype=torch.int32,
                          device=records.device)
    count = flat_m.sum(dim=1)
    steps = int(count.max()) if N * S * C else 0
    if steps == 0:
        return state, replies.reshape(N, S, C, R_)
    # live cells first, each node's in inbox order
    order = torch.sort((~flat_m).to(torch.int8), dim=1,
                       stable=True).indices[:, :steps]
    recs = torch.gather(flat_r, 1, order[..., None].expand(N, steps, W))
    ops = frozenset(flat_r[..., 0][flat_m].unique().tolist())
    pre = handler.prepare(recs) if handler.prepare is not None else None
    out = torch.empty((N, steps, R_), dtype=torch.int32, device=records.device)
    for k in range(steps):
        state, out[:, k] = handler.fn(
            state, recs[:, k], count > k,
            pre=None if pre is None else {n: v[:, k] for n, v in pre.items()},
            ops=ops)
    replies.scatter_(1, order[..., None].expand(N, steps, R_), out)
    return state, replies.reshape(N, S, C, R_)


def vector_apply(handler, state, records, mask):
    """handler.fn(state, records (L, W), node (L,)) -> replies (L, R), for
    the L live cells only; state is read-only on this path.  Dead cells'
    replies stay zero (pick_replies never reads them)."""
    N, S, C, W = records.shape
    replies = torch.zeros((N, S, C, handler.reply_words), dtype=torch.int32,
                          device=records.device)
    node, src, cell = mask.nonzero(as_tuple=True)
    if node.numel():
        replies[node, src, cell] = handler.fn(
            state, records[node, src, cell], node).to(torch.int32)
    return state, replies


# ---------------------------------------------------------------------------
# Traffic-class constructors
# ---------------------------------------------------------------------------
def read_class(dest, offsets, *, length: int, enabled=None,
               capacity: Optional[int] = None,
               mode: "rg.AddressMode | None" = None, page_tables=None):
    """One-sided READ class: owner action is translation + gather only."""
    return dict(kind="read", dest=dest,
                payload=offsets[..., None].to(torch.int32),
                length=length, enabled=enabled, capacity=capacity,
                mode=mode, page_tables=page_tables)


def rpc_class(dest, records, handler, *, enabled=None,
              capacity: Optional[int] = None):
    """Write-based RPC class: owner runs ``handler`` over the sub-inbox."""
    return dict(kind="rpc", dest=dest, payload=records, handler=handler,
                enabled=enabled, capacity=capacity)


def route_class(n_dst: int, c: dict) -> dict:
    """Route one class into its dest-major segment: the spec dict with the
    class, its capacity, record/reply widths and route_by_dest's outputs."""
    dest = c["dest"]
    B_k = dest.shape[-1]
    cap = c.get("capacity")
    cap = B_k if cap is None else int(cap)
    if cap < 0:
        raise ValueError(f"per-destination capacity must be >= 0, got {cap}")
    payload = c["payload"]
    R_k = c["length"] if c["kind"] == "read" else c["handler"].reply_words
    buf, mask, pos, ovf = route_by_dest(dest, payload, n_dst, cap,
                                        c.get("enabled"))
    return dict(cls=c, cap=cap, W=payload.shape[-1], R=R_k,
                buf=buf, mask=mask, pos=pos, ovf=ovf)


def _pad_words(x, width):
    pad = width - x.shape[-1]
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad))


def fused_round(t: Transport, state, classes: Sequence[dict], *,
                arena_key: str = "arena", nic=None):
    """Run one fused exchange round carrying several traffic classes.

    state: dict of cluster tensors; read classes gather from
    ``state[arena_key]``.  Every class's ``dest`` is (N, B_k); rpc payloads
    are (N, B_k, W_k) int32 words, read payloads are built from the (N, B_k)
    offsets by :func:`read_class`.

    Returns ``(state, results, stats)`` where ``results[k]`` is a
    ``(reply (N, B_k, R_k), overflow (N, B_k))`` pair aligned with
    ``classes`` and ``stats`` is ONE coalesced :class:`WireStats`.
    """
    n_dst = t.n_nodes
    specs = [route_class(n_dst, c) for c in classes]

    def stats():
        return wire_for_classes([s["mask"] for s in specs],
                                [s["W"] for s in specs],
                                [s["R"] for s in specs], nic=nic)

    c_total = sum(s["cap"] for s in specs)
    if c_total == 0:
        # nothing can be delivered this round: no exchange, no wire traffic
        return state, [(_dropped_replies(s), s["ovf"]) for s in specs], stats()

    w_max = max(s["W"] for s in specs)
    r_max = max(s["R"] for s in specs)
    send = torch.cat([_pad_words(s["buf"], w_max) for s in specs], dim=2)
    mask_all = torch.cat([s["mask"] for s in specs], dim=2)
    inbox = t.exchange(send)            # (N, n_src, C_total, w_max)
    inbox_mask = t.exchange(mask_all)

    seg = []
    base = 0
    for s in specs:
        seg.append((base, base + s["cap"]))
        base += s["cap"]

    replies = [None] * len(specs)
    # 1) vector (read-only) handlers observe the round's pre-handler state
    for i, s in enumerate(specs):
        c = s["cls"]
        if c["kind"] == "rpc" and not c["handler"].serial and s["cap"] > 0:
            s0, s1 = seg[i]
            _, replies[i] = vector_apply(c["handler"], state,
                                         inbox[:, :, s0:s1, :s["W"]],
                                         inbox_mask[:, :, s0:s1])
    # 2) serial (mutating) handlers fold through node state in class order
    for i, s in enumerate(specs):
        c = s["cls"]
        if c["kind"] == "rpc" and c["handler"].serial and s["cap"] > 0:
            s0, s1 = seg[i]
            state, replies[i] = serial_apply(c["handler"], state,
                                             inbox[:, :, s0:s1, :s["W"]],
                                             inbox_mask[:, :, s0:s1])
    # 3) one-sided gathers run last, on the post-handler state
    for i, s in enumerate(specs):
        c = s["cls"]
        if c["kind"] == "read" and s["cap"] > 0:
            s0, s1 = seg[i]
            replies[i] = _gather_live(state[arena_key], inbox[:, :, s0:s1, 0],
                                      inbox_mask[:, :, s0:s1], c)

    N, n_src = inbox.shape[:2]
    back = t.exchange(torch.cat(
        [_pad_words(replies[i].to(torch.int32), r_max)
         if replies[i] is not None
         else torch.zeros((N, n_src, 0, r_max), dtype=torch.int32,
                          device=inbox.device)
         for i in range(len(specs))], dim=2))

    results = []
    for i, s in enumerate(specs):
        if s["cap"] == 0:
            results.append((_dropped_replies(s), s["ovf"]))
            continue
        s0, s1 = seg[i]
        out = pick_replies(back[:, :, s0:s1, :s["R"]], s["cls"]["dest"],
                           s["pos"], s["ovf"])
        results.append((_finalize_reply(s, out), s["ovf"]))
    return state, results, stats()


def _gather_live(arenas, offsets, live, c):
    """A read class's owner-side gather: ``c["length"]`` words at each LIVE
    cell's offset of its owner's arena (``rg.arena_read``'s addressing);
    dead cells reply zeros, and pick_replies never reads them.  Gathering
    the live cells alone keeps the index tensor at the size of the real
    reads (a cell per lane, not per lane per source per slot)."""
    out = torch.zeros(live.shape + (c["length"],), dtype=torch.int32,
                      device=arenas.device)
    node, src, cell = live.nonzero(as_tuple=True)
    if node.numel():
        out[node, src, cell] = rg.arena_read_rows(
            arenas, node, offsets[node, src, cell], c["length"],
            c.get("mode"), c.get("page_tables"))
    return out


def _dropped_replies(s):
    """All-dropped reply block for a class that could deliver nothing."""
    dest = s["cls"]["dest"]
    out = torch.zeros(dest.shape + (s["R"],), dtype=torch.int32,
                      device=dest.device)
    return _finalize_reply(s, out, all_dropped=True)


def _finalize_reply(s, out, all_dropped: bool = False):
    """Stamp ST_DROPPED into undelivered rpc lanes' status word (a zeroed
    reply's word 0 would alias ST_OK)."""
    c = s["cls"]
    if c["kind"] != "rpc":
        return out
    if all_dropped:
        no_reply = torch.ones(c["dest"].shape, dtype=torch.bool,
                              device=out.device)
    else:
        # pos == cap is route_by_dest's "no live cell": capacity overflow,
        # disabled lanes, and enabled lanes parked by an out-of-range dest
        no_reply = s["pos"] >= s["cap"]
    out = out.clone()
    out[..., 0] = torch.where(no_reply, ST_DROPPED, out[..., 0])
    return out
