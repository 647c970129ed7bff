"""Wire protocol registry: every opcode and reply status in ONE place.

A verbatim copy of the JAX package's ``core/wireproto.py``: the port keeps
its own copy so it imports nothing of the reference.

Storm registers each data structure's operations with the dataplane
(Table 3: ``rpc_handler`` per structure); the wire-level contract between
client-built request records and owner-side handlers is the opcode in word 0
of the record and the status in word 0 of the reply.  Those constants used to
be scattered across ``rpc.py`` / ``tx.py`` / ``datastructs/hashtable.py`` —
this module is the single registration point, so a new data structure (e.g.
the ordered B-link index, ``datastructs/btree.py``) claims its opcode block
here and every layer agrees on the numbering by construction.

``rpc.py`` re-exports everything for backward compatibility (``R.OP_LOOKUP``
keeps working), but core modules import this module directly.

Opcode blocks (8 opcodes per block; claim the next free block for a new
subsystem — ``assert_unique_opcodes`` below catches collisions at import):

  ======== =========== ====================================================
  block    opcodes     subsystem
  ======== =========== ====================================================
   0 –  7  OP_NOP..    dataplane + hash table (Storm §5.4/§5.5)
   8 – 15  OP_READ_..  replication / validation fallback
  16 – 23  OP_BT_*     ordered index (B-link tree, ``datastructs/btree.py``)
  24 – 31  OP_PL_*     placement & membership (``core/placement.py``)
  ======== =========== ====================================================

Statuses are shared by every handler: word 0 of every reply is one of the
``ST_*`` codes below.  ``ST_DROPPED`` is special — it is stamped by the
TRANSPORT (roundsched) for requests that were never delivered (send-queue
overflow or parked lane), so it can never alias a handler-returned status.
"""
from __future__ import annotations

# --- dataplane + hash table opcodes (word 0 of every request record) -------
OP_NOP = 0
OP_LOOKUP = 1
OP_INSERT = 2
OP_UPDATE = 3
OP_DELETE = 4
OP_LOCK = 5           # lock write-set entry (returns version at lock time)
OP_COMMIT_UNLOCK = 6  # install value, version += 2, unlock
OP_ABORT_UNLOCK = 7   # release lock without installing

# --- replication / validation fallback block -------------------------------
OP_READ_VERSION = 8   # validation re-read by RPC (fallback path)
OP_BACKUP_WRITE = 9   # install a committed record image on a backup replica

# --- ordered index (B-link tree) opcodes -----------------------------------
OP_BT_LOOKUP = 16     # point lookup (owner-side separator walk)
OP_BT_INSERT = 17     # upsert; may split a full leaf (B-link structural op)
OP_BT_DELETE = 18     # remove a key (no structural merge — leaves persist)
OP_BT_LOCK = 19       # lock the key's LEAF for a tx write (pre-splits a full
                      # leaf so the later commit can never lack space)
OP_BT_COMMIT = 20     # install the write into the locked leaf, bump leaf
                      # version, unlock
OP_BT_ABORT = 21      # release the leaf lock without installing
OP_BT_SCAN = 22       # return the full image of the leaf covering a key
                      # (the range-scan RPC fallback; read-only)
OP_BT_BACKUP = 23     # install a committed (key, value) on a backup replica's
                      # own tree (logical replication of the ordered index)

# --- placement & membership opcodes -----------------------------------------
OP_PL_INSTALL = 24    # install one partition's routing row (+ epoch + alive
                      # bitmap) into the owner-published routing region; the
                      # coordinator broadcasts these on every epoch bump

# --- reply status codes (word 0 of every reply) ----------------------------
ST_OK = 0
ST_NOT_FOUND = 1
ST_LOCK_FAIL = 2
ST_NO_SPACE = 3   # handler-returned: storage full (request WAS delivered)
ST_BAD_OP = 4
ST_DROPPED = 5    # transport-level: request never delivered (send-queue
                  # overflow or parked lane) — retryable back-pressure,
                  # distinct from the permanent ST_NO_SPACE
ST_WRONG_EPOCH = 6  # handler-returned by lock-class ops when the client's
                    # routing table is stale (this node no longer owns the
                    # key's partition) — the lane aborts with cause
                    # ``stale_route``, refreshes its PlacementTable, retries


def assert_unique_opcodes():
    """Self-check: no two ``OP_*`` constants (or two ``ST_*`` constants)
    share a number.  Runs at import so a new opcode block that collides with
    an existing one fails loudly instead of silently aliasing handlers."""
    for prefix in ("OP_", "ST_"):
        seen = {}
        for name, val in sorted(globals().items()):
            if not name.startswith(prefix) or not isinstance(val, int):
                continue
            if val in seen:
                raise AssertionError(
                    f"wireproto collision: {name} and {seen[val]} are both "
                    f"{val}")
            seen[val] = name


assert_unique_opcodes()
