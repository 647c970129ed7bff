"""Contiguous memory regions (Storm §4.3, §5.1) and the paged/physical-segment
addressing modes (§6.2.5), PyTorch port of ``repro/core/regions.py``.

Every node owns ONE arena (a flat word array) out of which all data
structures are carved at static offsets; ``RegionTable`` is the NIC's MPT
(region_id -> base, size).  Two addressing modes reproduce the paper's
physical-segment experiment:

  * ``flat``  — "physical segment": address = offset.  One bounds check.
  * ``paged`` — "4KB pages": every access walks a page table (the MTT):
                phys = page_table[offset // page] * page + offset % page.

Arenas are ``int32`` bit images (see ``slots``).  A cluster's arenas are one
``(N, words)`` tensor; :func:`arena_read` / :func:`arena_write` take either a
single arena ``(words,)`` or the cluster ``(N, words)`` with offsets that
carry the same leading node axis.

Out-of-bounds words follow the reference's gather/scatter exactly: a word
address is a 32-bit value (``offset + j`` wraps), reinterpreted as int32; a
READ clamps it into ``[0, words - 1]`` (so addresses >= 2**31 read word 0)
and a WRITE outside ``[0, words)`` is dropped.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import slots as sl


@dataclasses.dataclass(frozen=True)
class Region:
    region_id: int
    base: int          # word offset in the arena
    size: int          # words

    @property
    def end(self) -> int:
        return self.base + self.size


@dataclasses.dataclass
class RegionTable:
    """The MPT analogue. Registration happens at setup time (off the data
    path, like Storm's kernel-mediated physical-segment registration)."""
    regions: Dict[str, Region] = dataclasses.field(default_factory=dict)
    next_base: int = 0
    next_id: int = 0

    def register(self, name: str, size_words: int) -> Region:
        if name in self.regions:
            raise ValueError(f"region {name!r} already registered")
        r = Region(self.next_id, self.next_base, size_words)
        self.regions[name] = r
        self.next_base += size_words
        self.next_id += 1
        return r

    @property
    def total_words(self) -> int:
        return self.next_base

    def __getitem__(self, name: str) -> Region:
        return self.regions[name]


def make_arena(table: RegionTable, device=None) -> torch.Tensor:
    """One contiguous arena per node — the Storm allocator's big chunk."""
    return torch.zeros((table.total_words,), dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Addressing modes
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AddressMode:
    """flat = physical segment; paged = per-page translation (MTT walk)."""
    kind: str = "flat"            # "flat" | "paged"
    page_words: int = 1024        # 4 KiB pages in 32-bit words

    def make_page_table(self, total_words: int, device=None):
        if self.kind == "flat":
            return None
        n_pages = -(-total_words // self.page_words)
        # identity mapping by default; tests permute it to prove the
        # translation is honoured
        return torch.arange(n_pages, dtype=torch.int32, device=device)

    def translate(self, page_table, offsets):
        """offsets: word addresses as unsigned int64 -> physical word
        addresses (unsigned int64, wrapped to 32 bits).  page_table: (P,) or,
        for a cluster, (N, P) with offsets (N, ...)."""
        if self.kind == "flat":
            return offsets
        page = offsets // self.page_words
        within = offsets % self.page_words
        phys_page = sl.u32(_gather_words(page_table, page))
        return (phys_page * self.page_words + within) & sl.MASK32


def _clamp_index(addr: torch.Tensor, n: int) -> torch.Tensor:
    """Unsigned 32-bit addresses -> in-bounds gather indices (the
    reference's int32 reinterpretation, then a clamp into [0, n - 1])."""
    signed = torch.where(addr >= (1 << 31), addr - (1 << 32), addr)
    return signed.clamp(0, n - 1)


def _gather_words(arr: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """arr[addr] with clamped addresses; arr (n,) or (N, n) with addr (N, ...)."""
    idx = _clamp_index(addr, arr.shape[-1])
    if arr.dim() == 1:
        return arr[idx]
    return torch.gather(arr, 1, idx.reshape(arr.shape[0], -1)).reshape(idx.shape)


def in_region(region: Region, offsets, length: int = 1):
    """True where the whole access [offset, offset + length) lies inside
    `region` — the NIC's MPT bounds check.  offsets: word tensor (...,) ->
    (...,) bool.  The bound is computed in Python and compared without any
    arithmetic on the offsets, so a huge offset cannot wrap past the check."""
    off = sl.u32(offsets)
    if length > region.size:
        return torch.zeros(off.shape, dtype=torch.bool, device=off.device)
    return (off >= region.base) & (off <= region.end - length)


def _word_addrs(offsets, length: int, mode, page_table):
    idx = (sl.u32(offsets)[..., None]
           + torch.arange(length, dtype=torch.int64, device=offsets.device)
           ) & sl.MASK32
    if mode is not None and mode.kind == "paged":
        idx = mode.translate(page_table, idx)
    return idx


def arena_read(arena, offsets, length: int, mode: AddressMode | None = None,
               page_table=None, region: Region | None = None):
    """Gather `length` consecutive words starting at each offset — the
    owner-side data movement of a one-sided READ (pure gather).

    arena (words,) with offsets (...,), or arena (N, words) with offsets
    (N, ...) -> (..., length).  region: optional bounds check — lanes whose
    access falls outside the region are REJECTED and read back zeros."""
    out = _gather_words(arena, _word_addrs(offsets, length, mode, page_table))
    if region is not None:
        ok = in_region(region, offsets, length)
        out = torch.where(ok[..., None], out, torch.zeros_like(out))
    return out


def arena_read_rows(arenas, rows, offsets, length: int,
                    mode: AddressMode | None = None, page_tables=None):
    """:func:`arena_read` for lanes that each name their node: arenas (N,
    words), rows (M,) node rows in [0, N), offsets (M,) -> (M, length).
    page_tables: (N, P) when ``mode`` is paged."""
    rows = rows.to(torch.int64)
    paged = mode is not None and mode.kind == "paged"
    addr = _word_addrs(offsets, length, mode if paged else None,
                       page_tables[rows] if paged else None)
    return arenas[rows[:, None], _clamp_index(addr, arenas.shape[-1])]


def arena_write(arena, offsets, values, mode: AddressMode | None = None,
                page_table=None, enabled=None, region: Region | None = None):
    """Scatter consecutive words at each offset (one-sided WRITE).

    values: (..., L); enabled: optional (...,) bool mask of lanes whose write
    happens.  region: optional bounds check — out-of-region writes are
    rejected.  Returns a NEW arena (the input is not modified).  Suppressed
    lanes write nothing; the reference redirects them to the scratch word
    with that word's own value, which leaves the same arena."""
    length = values.shape[-1]
    if region is not None:
        ok = in_region(region, offsets, length)
        enabled = ok if enabled is None else (enabled & ok)
    addr = _word_addrs(offsets, length, mode, page_table)
    n = arena.shape[-1]
    signed = torch.where(addr >= (1 << 31), addr - (1 << 32), addr)
    keep = (signed >= 0) & (signed < n)                   # mode="drop"
    if enabled is not None:
        keep = keep & enabled[..., None]
    vals = values.to(torch.int32).expand(addr.shape)
    out = arena.clone()
    if arena.dim() == 1:
        out[signed[keep]] = vals[keep]
    else:
        rows = torch.arange(arena.shape[0], device=arena.device).reshape(
            (-1,) + (1,) * (addr.dim() - 1)).expand(addr.shape)
        out[rows[keep], signed[keep]] = vals[keep]
    return out


def slot_offset(region: Region, slot_idx):
    """Word offset (int32 bit image) of slot `slot_idx` inside a slot-array
    region."""
    return sl.i32(region.base + sl.u32(slot_idx) * sl.SLOT_WORDS)
