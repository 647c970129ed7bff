# Storm's transactional dataplane for remote (sharded) data structures,
# ported to PyTorch.  Module for module the counterpart of repro.core:
#   slots      — MICA-style 128B inline slot codec (int32 word images)
#   wireproto  — opcodes and reply statuses
#   regions    — contiguous arenas + flat/paged addressing
#   nic        — connection-state model (QP modes, NIC-cache hit model)
#   transport  — dest-major exchange: SimTransport (the cluster on one
#                device) and MeshTransport (one node a rank of a
#                torch.distributed process group)
#   roundsched — multi-class fused round scheduler
#   onesided   — one-sided READ/WRITE (owner does address translation only)
#   rpc        — write-based RPC: inbox + completion mask + handlers
#   placement  — the routing table's region image, routing queries and the
#                generic read fail-over (hash table and B-tree)
#   replication — primary-backup copies riding the commit round; failure
#                injection and reads failing over to a backup
#   telemetry  — phase tags and the percentile summary
#   hybrid     — one-two-sided operations (Algorithm 1)
#   tx         — OCC point transactions and range-scan transactions (fused
#                3-4 rounds, 5-round reference), replicated with rep=
#   txloop     — bounded-retry engines: tx_loop and scan_loop
#   datastructs/hashtable — the MICA hash table
#   datastructs/btree     — the B-link tree (primary and backup trees)
