"""NIC connection-state model: QP modes and the NIC-cache hit model
(Storm §2.2, §3.4, Fig. 7).

Storm's scaling argument is about CONNECTION STATE, not bytes: every reliable
connection (QP) pins ~375 B of state on the NIC, the NIC caches that state in
a ~2 MiB on-chip cache, and once the cluster grows past the point where the
working set of QP state overflows the cache, every op risks a PCIe fetch of
evicted state.  The mitigations the paper analyses are exactly the three
*connection modes* modeled here:

  * ``rc_exclusive`` — sibling-thread RC (§3.4): every thread owns a private
    QP to every remote thread, conns/node = 2·m·t.  Lock-free and fastest at
    rack scale, but QP state grows with cluster size × thread count and blows
    through the NIC cache beyond ~64 nodes at 20 threads (Fig. 7).
  * ``rc_shared``   — QP sharing across the t sibling threads of one process
    (RDMAvisor-style): conns/node = 2·m, a t-fold state reduction, paid for
    with a modeled per-op synchronization cost that grows with the number of
    sharers (threads serialize on the shared send queue).
  * ``dct``         — dynamically connected transport: O(1) connection state
    per node (one initiator context per thread + one target context),
    INDEPENDENT of cluster size, paid for with a per-message reconnect
    latency (the DC connect/disconnect handshake rides every message train).

Calibration (single source of truth — the constants formerly inlined in
``benchmarks/fig7_emulation.py`` live HERE and nowhere else):

  * ``qp_bytes = 375``        — RC QP state (§2.1);
  * ``qp_cache_bytes = 1 MiB``— the slice of the ~2 MiB NIC cache available
    for QP state (the rest holds WQE/MTT/MPT entries);
  * ``pcie_us = 0.20``        — cost of a PCIe fetch of evicted QP state,
    chosen so the 20-thread RC curve drops 1.57x at 96 nodes (the paper's
    Fig. 7 number) while the 10-thread curve stays flat to 128 nodes; both
    behaviours then EMERGE from the model at every other sweep point;
  * ``share_lock_us``/``share_contention`` — QP-sharing cost: a base
    lock/unlock plus a linear contention term per extra sharer, calibrated so
    sharing LOSES to exclusive RC inside the rack but wins ≥1.3x at 96
    nodes/20 threads (the paper's guideline: share only beyond rack scale);
  * ``dct_reconnect_us``      — per-op reconnect cost, calibrated likewise.

``ConnTable`` is the per-node connection accounting for one (mode, nodes,
threads) point; the protocol stack threads it through ``wire_for`` /
``wire_for_classes`` so every :class:`~repro_torch.core.transport.WireStats`
carries the modeled NIC-cache hit rate and per-op penalty of the transport
configuration it ran under.

Public API: ``NicModel`` (calibration constants), ``ConnTable``
(``conns_per_node`` / ``state_bytes`` / ``cache_hit`` /
``penalty_us_per_op`` / ``describe``), the mode names ``RC_EXCLUSIVE`` /
``RC_SHARED`` / ``DCT`` (``MODES``) and the ``sweep`` generator.  Invariant:
a ``nic=ConnTable`` threaded through any dataplane call PRICES the transport
— protocol results are bit-identical with and without it
(tests/test_nic_model.py).
"""
from __future__ import annotations

import dataclasses

# Connection modes (ConnMode values)
RC_EXCLUSIVE = "rc_exclusive"
RC_SHARED = "rc_shared"
DCT = "dct"
MODES = (RC_EXCLUSIVE, RC_SHARED, DCT)


@dataclasses.dataclass(frozen=True)
class NicModel:
    """Calibration constants of the NIC-cache / connection-cost model."""
    qp_bytes: int = 375               # RC QP state bytes (§2.1)
    dct_bytes: int = 192              # DC initiator/target context bytes
    qp_cache_bytes: float = 1.0 * 1024 * 1024   # NIC cache slice for QP state
    pcie_us: float = 0.20             # DMA fetch of evicted QP state, per op
    share_lock_us: float = 0.003      # QP-sharing base lock cost, per op
    share_contention: float = 0.05    # extra cost fraction per extra sharer
    dct_reconnect_us: float = 0.006   # DC connect/disconnect cost, per op


@dataclasses.dataclass(frozen=True)
class ConnTable:
    """Per-node connection state for one (mode, cluster size, threads) point.

    Static Python object: the hit rate and per-op penalty are plain floats,
    so they enter the protocol code as constants ("the QP mode is fixed when
    the cluster is wired up").
    """
    n_nodes: int
    threads: int = 1
    mode: str = RC_EXCLUSIVE
    model: NicModel = NicModel()

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown connection mode {self.mode!r}; "
                             f"expected one of {MODES}")
        if self.n_nodes < 1 or self.threads < 1:
            raise ValueError(f"n_nodes and threads must be >= 1, got "
                             f"{self.n_nodes}/{self.threads}")

    # ---- connection accounting ---------------------------------------------
    @property
    def conns_per_node(self) -> int:
        """Connections (QP/DC contexts) each node's NIC must hold state for."""
        if self.mode == RC_EXCLUSIVE:
            return 2 * self.n_nodes * self.threads     # sibling-thread RC
        if self.mode == RC_SHARED:
            return 2 * self.n_nodes                    # t-fold sharing
        return self.threads + 1                        # DCT: O(1) in n_nodes

    @property
    def state_bytes(self) -> int:
        """QP/DC state bytes resident for this node's connections."""
        per_conn = self.model.dct_bytes if self.mode == DCT else self.model.qp_bytes
        return self.conns_per_node * per_conn

    # ---- NIC-cache hit model -----------------------------------------------
    @property
    def cache_hit(self) -> float:
        """Modeled NIC-cache hit rate for connection-state accesses."""
        return min(1.0, self.model.qp_cache_bytes / max(self.state_bytes, 1))

    @property
    def mode_cost_us(self) -> float:
        """Per-op cost intrinsic to the mode (sharing locks, DC reconnects)."""
        if self.mode == RC_SHARED:
            return self.model.share_lock_us * (
                1.0 + self.model.share_contention * (self.threads - 1))
        if self.mode == DCT:
            return self.model.dct_reconnect_us
        return 0.0

    @property
    def penalty_us_per_op(self) -> float:
        """Total modeled per-op penalty: PCIe fetches of evicted QP state
        (cache misses) plus the mode-intrinsic cost."""
        return (1.0 - self.cache_hit) * self.model.pcie_us + self.mode_cost_us

    def describe(self) -> str:
        return (f"{self.mode}[m={self.n_nodes},t={self.threads}]: "
                f"conns/node={self.conns_per_node} "
                f"state={self.state_bytes / 1024:.0f}KiB "
                f"hit={self.cache_hit:.3f} "
                f"penalty={self.penalty_us_per_op:.4f}us/op")


def sweep(node_counts, thread_counts, modes=MODES, model: NicModel = NicModel()):
    """Yield a ConnTable per (mode, nodes, threads) sweep point."""
    for mode in modes:
        for t in thread_counts:
            for m in node_counts:
                yield ConnTable(n_nodes=m, threads=t, mode=mode, model=model)
