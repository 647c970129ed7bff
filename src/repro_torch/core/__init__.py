# Storm's transactional dataplane for remote (sharded) data structures,
# ported to PyTorch.  Module for module the counterpart of repro.core:
#   slots      — MICA-style 128B inline slot codec (int32 word images)
#   wireproto  — opcodes and reply statuses
#   regions    — contiguous arenas + flat/paged addressing
#   nic        — connection-state model (QP modes, NIC-cache hit model)
#   transport  — dest-major exchange on the one-device SimTransport
#   roundsched — multi-class fused round scheduler
#   onesided   — one-sided READ/WRITE (owner does address translation only)
#   rpc        — write-based RPC: inbox + completion mask + handlers
#   placement  — the routing table's region image and routing queries
#   telemetry  — phase tags and the percentile summary
#   hybrid     — one-two-sided operations (Algorithm 1)
#   tx         — OCC point transactions (fused 3-4 rounds, 5-round reference)
#   txloop     — bounded-retry transaction engine
