"""MICA-style inline slot codec (Storm §5.5), PyTorch port of
``repro/core/slots.py``.

A slot is SLOT_WORDS 32-bit words (= 128 bytes, the paper's transfer unit)
that inline all per-item metadata next to the value, so one one-sided read
fetches everything ``lookup_end`` needs.

Layout (32-bit words):
  [0] key_lo        [1] key_hi
  [2] version       (seqlock: even = stable, odd = write in progress)
  [3] lock          (0 = free, owner_tag+1 otherwise)
  [4] next_ptr      (global slot index of overflow-chain successor; NULL_PTR = end)
  [5..] value       (VALUE_WORDS words = 108 B payload)

Word type.  The reference keeps words as ``uint32``.  The port keeps them as
``int32`` BIT IMAGES (0xFFFFFFFF is -1), because torch's ``uint32`` lacks the
arithmetic and indexing the dataplane needs.  Equality, ``&``, ``|``, ``^``
and wrapping ``+`` give the same bits in both types; every operation whose
result depends on signedness (``%``, ``//``, ``>>``, ``<``, multiplication
beyond 32 bits) goes through :func:`u32` (the unsigned value as int64) and
back through :func:`i32`.
"""
from __future__ import annotations

import torch

SLOT_WORDS = 32
SLOT_BYTES = SLOT_WORDS * 4          # 128 B, the paper's item size
KEY_LO, KEY_HI, VERSION, LOCK, NEXT_PTR, VALUE0 = 0, 1, 2, 3, 4, 5
VALUE_WORDS = SLOT_WORDS - VALUE0    # 27 words = 108 B
NULL_PTR = -1                        # 0xFFFFFFFF as an int32 bit image
EMPTY_KEY = -1                       # key_lo of an empty slot
MASK32 = 0xFFFFFFFF


def word(x: int) -> int:
    """A Python int in [0, 2**32) as its int32 bit image."""
    x &= MASK32
    return x - (1 << 32) if x >= (1 << 31) else x


def u32(x: torch.Tensor) -> torch.Tensor:
    """Unsigned value (int64) of an int32 bit image (or of an int64)."""
    return x.to(torch.int64) & MASK32


def i32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit image of the low 32 bits of an integer tensor."""
    x = x.to(torch.int64) & MASK32
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def make_empty_slot(device=None) -> torch.Tensor:
    s = torch.zeros((SLOT_WORDS,), dtype=torch.int32, device=device)
    s[KEY_LO] = EMPTY_KEY
    s[NEXT_PTR] = NULL_PTR
    return s


def pack_slot(key_lo, key_hi, version, lock, next_ptr, value) -> torch.Tensor:
    """value: (..., VALUE_WORDS) int32. Returns (..., SLOT_WORDS)."""
    value = torch.as_tensor(value, dtype=torch.int32)
    shp = value.shape[:-1]
    dev = value.device

    def col(x):
        return torch.as_tensor(x, dtype=torch.int32, device=dev).expand(shp)

    head = torch.stack([col(key_lo), col(key_hi), col(version), col(lock),
                        col(next_ptr)], dim=-1)
    return torch.cat([head, value], dim=-1)


def slot_key_lo(slot):   return slot[..., KEY_LO]
def slot_key_hi(slot):   return slot[..., KEY_HI]
def slot_version(slot):  return slot[..., VERSION]
def slot_lock(slot):     return slot[..., LOCK]
def slot_next(slot):     return slot[..., NEXT_PTR]
def slot_value(slot):    return slot[..., VALUE0:]


def slot_matches(slot, key_lo, key_hi):
    """Key match & stable (even version) & unlocked — the ``lookup_end``
    validity predicate for a one-sided read (Storm Algorithm 1, line 7)."""
    return ((slot_key_lo(slot) == key_lo)
            & (slot_key_hi(slot) == key_hi)
            & ((slot_version(slot) & 1) == 0)
            & (slot_lock(slot) == 0))


def window_match(slots, key_lo, key_hi, cache_hit=None):
    """The ``lookup_end`` check over a window of slots (..., width,
    SLOT_WORDS) for keys (...,).  cache_hit: optional (...,) bool; for hit
    lanes only window position 0 (the cached slot itself) may match.
    Returns (found, local_idx int32, slot): slot is the window's slot
    argmax(match), which is slot 0 on a miss."""
    m = slot_matches(slots, key_lo[..., None], key_hi[..., None])
    if cache_hit is not None:
        m = m & ((torch.arange(slots.shape[-2], device=slots.device) == 0)
                 | ~cache_hit[..., None])
    local = torch.argmax(m.to(torch.int32), dim=-1)
    slot = torch.gather(slots, -2, local[..., None, None].expand(
        local.shape + (1, SLOT_WORDS)))[..., 0, :]
    return m.any(dim=-1), local.to(torch.int32), slot


def slot_is_empty(slot):
    return slot_key_lo(slot) == EMPTY_KEY


# ---------------------------------------------------------------------------
# Key hashing: the reference's 64-bit splittable mix done in 32-bit lanes.
# Here every step runs on unsigned values held in int64; products are split
# into 16-bit halves so no intermediate exceeds 2**48 (no int64 overflow).
# ---------------------------------------------------------------------------
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for unsigned x (int64 tensor) and a 32-bit m."""
    hi = ((x >> 16) * m) & 0xFFFF
    return ((hi << 16) + (x & 0xFFFF) * m) & MASK32


def _mix32_u(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def _mix32(x):
    """murmur3 fmix32 of a word tensor (int32 bit image in and out)."""
    return i32(_mix32_u(u32(torch.as_tensor(x))))


def hash_key(key_lo, key_hi):
    """Returns (h_node, h_bucket) — two decorrelated 32-bit hashes, as
    UNSIGNED values in int64 (callers reduce them with ``%``)."""
    a = _mix32_u(u32(key_lo))
    b = _mix32_u((u32(key_hi) + _GOLDEN) & MASK32)
    h1 = _mix32_u((a + _mul32(b, _M1)) & MASK32)
    h2 = _mix32_u((b + _mul32(a, _M2) + _GOLDEN) & MASK32)
    return h1, h2
