"""Batched MICA bucket probe — the one-sided lookup hot path (remote read +
``lookup_end``) fused in one kernel: ``csrc/hash_probe.cu``, a hand-written
CUDA port of the Pallas TPU kernel ``repro/kernels/hash_probe.py``.

One kernel, two contracts:

  * :func:`probe_lines` — the dataplane's contract (``hashtable.lookup_end``
    after a one-sided read): many arenas, a word offset per lane, a ``live``
    mask (undelivered lanes read all-zero words) and the exact-slot rule for
    cache-hit lanes.  Returns found, version, value and local_idx, where the
    value is that of slot ``argmax(match)`` — slot 0 on a miss, NOT zeros,
    because ``lookup_end`` returns it and it flows into the read values.
  * :func:`hash_probe` — the TPU kernel's contract: one arena with slots at
    word 0, a bucket index per key, ``(B, 29)`` rows
    ``[found, version, 27 value words]`` with zeros for the value on a miss,
    and the start of the line clamped as ``lax.dynamic_slice`` clamps it.

Dispatch: a CPU tensor takes the plain PyTorch version (:func:`probe_lines_plain`),
a CUDA tensor launches the kernel or raises.  ``launches`` counts kernel
launches (the plain version does not count).

Bound: bytes — each live lane reads ``width * 128`` B of slot lines and
every lane moves 135 B of inputs and outputs.  The design (the CUDA source
has it in full): a CTA takes :func:`lanes_per_cta` consecutive lanes, one
thread per lane for the lane inputs, and puts every line of the CTA in
flight at once into a shared-memory tile, lines that need no clamp by their
16 B-aligned span in 16 B loads spread over the CTA and the rest word by
word; it matches from the tile and stores the CTA's value words as one
contiguous span.  PERF.md has the measured times.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import slots as sl

REPLY_WORDS = 2 + sl.VALUE_WORDS      # TPU contract: [found, version, value...]
MAX_WIDTH = 8                         # widest line (slots) the kernel takes

launches = 0                          # kernel launches since the last reset


def lanes_per_cta(width: int) -> int:
    """Lanes one CTA of the kernel probes for a ``width``-slot line: 128 at
    width 1, halving as the line doubles (16 at widths 5-8), so a CTA's tile
    of lines stays near 16 KB and several CTAs share an SM.  The one table
    of it: each launch passes it to the kernel.  Raises ValueError for a
    width the kernel does not take (1..MAX_WIDTH)."""
    if not 1 <= width <= MAX_WIDTH:
        raise ValueError(f"hash_probe: width must be in 1..{MAX_WIDTH}, "
                         f"got {width}")
    return 128 >> (width - 1).bit_length()


def _word_index(start: torch.Tensor, width: int, n_words: int) -> torch.Tensor:
    """(M, width * 32) gather indices: start + j wrapped in 32 bits, read as
    int32, clamped into [0, n_words - 1] (the reference gather)."""
    j = torch.arange(width * sl.SLOT_WORDS, dtype=torch.int64,
                     device=start.device)
    a = (sl.u32(start)[:, None] + j) & sl.MASK32
    return torch.where(a >= (1 << 31), a - (1 << 32), a).clamp(0, n_words - 1)


def probe_lines_plain(arenas, dest, off, key_lo, key_hi, live, cache_hit, *,
                      width: int, zero_miss: bool = False):
    """Plain PyTorch version of the kernel (same arguments and outputs as
    :func:`probe_lines`)."""
    M = dest.shape[0]
    n_nodes, n_words = arenas.shape
    on = live & (dest >= 0) & (dest < n_nodes)
    row = torch.where(on, dest, 0).to(torch.int64)
    idx = _word_index(off, width, n_words)
    words = arenas[row[:, None], idx]
    words = torch.where(on[:, None], words, torch.zeros_like(words))
    found, local, slot = sl.window_match(
        words.reshape(M, width, sl.SLOT_WORDS), key_lo, key_hi, cache_hit)
    value = sl.slot_value(slot)
    if zero_miss:
        value = torch.where(found[:, None], value, torch.zeros_like(value))
    return found, sl.slot_version(slot), value, local


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device:
        raise ValueError(f"hash_probe: {name} must be {dtype} {tuple(shape)} on "
                         f"{device}, got {x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"hash_probe: {name} must be contiguous")


def _launch(arenas, dest, off, key_lo, key_hi, live, cache_hit, *,
            width: int, zero_miss: bool, n_fast: torch.Tensor | None = None):
    """Launch the CUDA kernel on the current stream; raises on any error.
    ``n_fast``, an int32 (1,) tensor on the same card, gets the number of
    lanes whose line the kernel copied whole (its fast path) added to it."""
    global launches
    from repro_torch.kernels import build
    dev = arenas.device
    M = dest.shape[0]
    _check("arenas", arenas, torch.int32, arenas.shape, dev)
    if arenas.dim() != 2:
        raise ValueError("hash_probe: arenas must be (n_nodes, n_words)")
    for name, x, dt in (("dest", dest, torch.int32), ("off", off, torch.int32),
                        ("key_lo", key_lo, torch.int32),
                        ("key_hi", key_hi, torch.int32),
                        ("live", live, torch.bool),
                        ("cache_hit", cache_hit, torch.bool)):
        _check(name, x, dt, (M,), dev)
    if n_fast is not None:
        _check("n_fast", n_fast, torch.int32, (1,), dev)
    found = torch.empty((M,), dtype=torch.bool, device=dev)
    version = torch.empty((M,), dtype=torch.int32, device=dev)
    value = torch.empty((M, sl.VALUE_WORDS), dtype=torch.int32, device=dev)
    local = torch.empty((M,), dtype=torch.int32, device=dev)
    if M == 0:
        return found, version, value, local
    fn = build.load("hash_probe").hash_probe_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] + [ctypes.c_void_p] * 6)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(arenas.data_ptr(), arenas.shape[0], arenas.shape[1],
                 dest.data_ptr(), off.data_ptr(), key_lo.data_ptr(),
                 key_hi.data_ptr(), live.data_ptr(), cache_hit.data_ptr(),
                 width, lanes_per_cta(width), int(zero_miss), M,
                 found.data_ptr(), version.data_ptr(), value.data_ptr(),
                 local.data_ptr(),
                 None if n_fast is None else n_fast.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"hash_probe kernel launch failed: CUDA error {err}")
    launches += 1
    return found, version, value, local


def probe_lines(arenas, dest, off, key_lo, key_hi, live, cache_hit, *,
                width: int, zero_miss: bool = False):
    """Probe M lanes: lane i reads ``width`` slots at word ``off[i]`` of
    ``arenas[dest[i]]`` (nothing, i.e. all-zero words, where ``live[i]`` is
    False) and applies the ``lookup_end`` check.

    arenas (N, words) int32; dest, off, key_lo, key_hi (M,) int32 (off and
    keys are word bit images); live, cache_hit (M,) bool.
    width: 1..MAX_WIDTH slots (ValueError otherwise, on every device).
    Returns found (M,) bool, version (M,) int32, value (M, 27) int32 and
    local_idx (M,) int32 (index of the matching slot in the window)."""
    args = (arenas, dest, off, key_lo, key_hi, live, cache_hit)
    lanes_per_cta(width)                 # the kernel's widths, on every device
    if arenas.device.type == "cpu":
        return probe_lines_plain(*args, width=width, zero_miss=zero_miss)
    if arenas.device.type == "meta":     # a dry run: shapes only
        M = dest.shape[0]
        return (dest.new_empty((M,), dtype=torch.bool), dest.new_empty((M,)),
                dest.new_empty((M, sl.VALUE_WORDS)), dest.new_empty((M,)))
    if arenas.device.type != "cuda":
        raise ValueError(f"hash_probe: unsupported device {arenas.device}")
    return _launch(*(x.contiguous() for x in args), width=width,
                   zero_miss=zero_miss)


def _tpu_lanes(arena, bucket_idx, key_lo, key_hi, width):
    """Arguments of the TPU contract as probe_lines arguments."""
    line = width * sl.SLOT_WORDS
    n = arena.shape[0]
    if n < line:
        raise ValueError(f"hash_probe: arena of {n} words is shorter than a "
                         f"{width}-slot line")
    # the reference's dynamic_slice start: bucket * line in int32, clamped
    # into [0, n - line]
    start = sl.i32(bucket_idx.to(torch.int64) * line).to(torch.int64)
    start = start.clamp(0, n - line).to(torch.int32)
    B = bucket_idx.shape[0]
    dev = arena.device
    on = torch.ones((B,), dtype=torch.bool, device=dev)
    return (arena.reshape(1, n), torch.zeros((B,), dtype=torch.int32, device=dev),
            start, key_lo.to(torch.int32), key_hi.to(torch.int32), on, ~on)


def _tpu_rows(found, version, value):
    return torch.cat([found.to(torch.int32)[:, None], version[:, None], value],
                     dim=1)


def hash_probe_plain(arena, bucket_idx, key_lo, key_hi, *, width: int):
    """Plain PyTorch version of the TPU contract (``ref.hash_probe_ref``)."""
    f, v, val, _ = probe_lines_plain(
        *_tpu_lanes(arena, bucket_idx, key_lo, key_hi, width), width=width,
        zero_miss=True)
    return _tpu_rows(f, v, val)


def hash_probe(arena, bucket_idx, key_lo, key_hi, *, width: int):
    """The TPU kernel's contract: arena (n_words,) int32 with slots at word
    0; bucket_idx (B,) int32; key_lo/key_hi (B,) int32 words.  Returns
    (B, REPLY_WORDS) int32 rows [found, version, value...]; value zeros on a
    miss, no chain walk."""
    f, v, val, _ = probe_lines(
        *_tpu_lanes(arena, bucket_idx, key_lo, key_hi, width), width=width,
        zero_miss=True)
    return _tpu_rows(f, v, val)
