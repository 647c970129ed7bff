"""Napkin-math cost model behind every hybrid one-sided-vs-RPC decision
(Storm §4.4/§4.5 lifted to a reusable selector; counterpart of
``repro/core/cost_model.py``).

The decision is always the same shape: move DATA to the requester (one-sided
read) or move the REQUEST to the data and compute there (RPC).  We compare
bytes over the interconnect per logical operation, plus a round-trip term.
The same model prices the framework's three integration points:

  * KV-cache decode attention: gather K/V rows vs ship Q + partial results
  * MoE dispatch: all-gather expert weights vs all-to-all token activations
  * vocab-sharded embedding: gather rows vs ship ids

Decisions are made on the host from static shapes, so a schedule is fixed
before anything runs.  ``Fabric``'s defaults are the JAX package's modeled
ones, kept so that the port chooses as the reference does; they are
modeling constants, not figures of the card the port runs on.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.nic import ConnTable


@dataclasses.dataclass(frozen=True)
class Fabric:
    """Per-chip link characteristics (the JAX package's modeled defaults)."""
    link_bytes_per_s: float = 50e9     # per link
    hbm_bytes_per_s: float = 819e9
    flops_per_s: float = 197e12        # bf16
    rt_overhead_s: float = 1e-6        # per collective round fixed cost
    # modeled per-op connection-state penalty (core.nic: NIC-cache misses +
    # QP-sharing locks / DC reconnects).  0 = perfect NIC; use with_nic() to
    # derive a Fabric priced for a concrete connection mode / cluster scale.
    nic_penalty_s: float = 0.0

    def with_nic(self, conn_table: ConnTable) -> "Fabric":
        """A copy of this fabric paying ``conn_table``'s per-op penalty."""
        return dataclasses.replace(
            self, nic_penalty_s=conn_table.penalty_us_per_op * 1e-6)


@dataclasses.dataclass(frozen=True)
class Choice:
    mode: str                 # "onesided" | "rpc"
    onesided_bytes: float
    rpc_bytes: float
    onesided_time: float
    rpc_time: float

    @property
    def ratio(self) -> float:
        return self.onesided_time / max(self.rpc_time, 1e-30)


def choose(onesided_bytes: float, rpc_bytes: float,
           onesided_rounds: float = 1.0, rpc_rounds: float = 1.0,
           fabric: Fabric = Fabric(), rpc_compute_flops: float = 0.0) -> Choice:
    """Pick the cheaper primitive for one logical op (bytes on the wire +
    round-trip overhead + any owner-side compute the RPC must run).  Both
    sides pay the fabric's modeled connection-state penalty once per round
    issued (every round touches the connection's QP/DC state)."""
    t1 = (onesided_bytes / fabric.link_bytes_per_s
          + onesided_rounds * (fabric.rt_overhead_s + fabric.nic_penalty_s))
    t2 = (rpc_bytes / fabric.link_bytes_per_s
          + rpc_rounds * (fabric.rt_overhead_s + fabric.nic_penalty_s)
          + rpc_compute_flops / fabric.flops_per_s)
    mode = "onesided" if t1 <= t2 else "rpc"
    return Choice(mode, onesided_bytes, rpc_bytes, t1, t2)


# ---------------------------------------------------------------------------
# Framework integration points
# ---------------------------------------------------------------------------
def decode_attention_choice(*, seq_len: int, n_kv_heads: int, n_q_heads: int,
                            head_dim: int, batch_per_shard: int, shards: int,
                            bytes_per_el: int = 2,
                            fabric: Fabric = Fabric()) -> Choice:
    """One decode step, KV sharded `shards`-ways along sequence.

    one-sided: gather the remote KV rows to the query's shard:
               2 (K and V) * S * (shards-1)/shards * n_kv * hd bytes / query
    rpc:       broadcast Q to the shards and return (o, m, l) partials:
               (shards-1) * (n_q*hd [q] + n_q*(hd+2) [partials]) bytes.
    """
    b = batch_per_shard
    one = 2 * seq_len * ((shards - 1) / shards) * n_kv_heads * head_dim * bytes_per_el * b
    rpc = (shards - 1) * (n_q_heads * head_dim + n_q_heads * (head_dim + 2)) * bytes_per_el * b
    # owner-side compute the RPC runs: 4*S/shards*n_q*hd flops per shard chain
    flops = 4 * (seq_len / shards) * n_q_heads * head_dim * b
    return choose(one, rpc, fabric=fabric, rpc_compute_flops=flops)


def moe_dispatch_choice(*, tokens_per_shard: int, d_model: int, d_ff: int,
                        n_experts: int, top_k: int, shards: int,
                        bytes_per_el: int = 2,
                        fabric: Fabric = Fabric()) -> Choice:
    """Prices the reference's two sharded schedules (``models.moe``):
    one-sided: all-gather expert weights ((s-1)/s remote) + all-gather the
               1/s-split outputs back — perfectly balanced compute;
    rpc:       local-expert partials + ring all-reduce of (tokens, d)
               (2 (s-1)/s x bytes) — compute lands where the experts live."""
    f = (shards - 1) / shards
    act = tokens_per_shard * d_model * bytes_per_el
    weights = n_experts * 3 * d_model * d_ff * bytes_per_el
    one = f * (weights + act)
    rpc = 2 * f * act
    flops = 6 * tokens_per_shard * top_k * d_model * d_ff / shards
    return choose(one, rpc, fabric=fabric, rpc_compute_flops=flops)


def embedding_lookup_choice(*, tokens_per_shard: int, d_model: int,
                            vocab: int, shards: int, bytes_per_el: int = 2,
                            fabric: Fabric = Fabric()) -> Choice:
    """one-sided: all-gather the vocab-sharded table, take rows locally;
    rpc: every shard contributes its rows, ring all-reduce of (tokens, d)
    (the reference's masked-psum handler in ``models.embedding``)."""
    f = (shards - 1) / shards
    one = f * vocab * d_model * bytes_per_el
    rpc = 2 * f * tokens_per_shard * d_model * bytes_per_el
    return choose(one, rpc, fabric=fabric)
