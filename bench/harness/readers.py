"""What the per-layer readers share: each metric's file under ``metrics/``
names its layer, source, unit and the end-to-end metric it moves, and calls
one of these on the run's :class:`harness.context.Context`.  A reader that
finds nothing to read (another kind of cell, no traced stretch, a kernel
or span that did not run) returns None."""
from __future__ import annotations

from harness import counts

# the program's kernels by the names the device trace gives them
KERNELS = {"flash_attention": ("flash_tc_kernel", "flash_fwd_kernel"),
           "ssd_scan": ("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_out")}
LEAST = {"flash_attention": lambda s: counts.flash_least_s(
             s["BH"], s["S"], s["D"], s["group"]),
         "ssd_scan": lambda s: counts.ssd_least_s(
             s["B"], s["nc"], s["Q"], s["H"], s["P"], s["N"])}


def mfu(ctx, kind: str):
    """Model FLOPs of the measured window over the bf16 peak times the
    window, in % (on the card only: the peak is the card's)."""
    if ctx.mix["kind"] != kind or not ctx.window_s or not ctx.cuda:
        return None
    return 100.0 * ctx.window_flops / (counts.PEAK_BF16_FLOP_S * ctx.window_s)


def device_idle(ctx, kind: str):
    """1 - device busy time / wall time of the traced stretch, in %."""
    if ctx.mix["kind"] != kind or ctx.prof is None:
        return None
    return 100.0 * (1.0 - ctx.prof["busy_s"] / ctx.prof["wall_s"])


def kernel_time(ctx, kernel: str) -> float:
    return sum(s for n, s in ctx.prof["kernels"].items()
               if any(k in n for k in KERNELS[kernel]))


def roofline(ctx, kind: str, kernel: str):
    """The least time of the kernel's launches in the traced stretch (each
    at the shape of the forward pass that made it) over the device time of
    its kernels there, in %."""
    if ctx.mix["kind"] != kind or ctx.prof is None:
        return None
    least = sum(n * LEAST[kernel](shape)
                for k, n, shape in ctx.launches if k == kernel)
    spent = kernel_time(ctx, kernel)
    if not least or not spent:
        return None
    return 100.0 * least / spent


def span_share(ctx, kind: str, spans):
    """Device time of the kernels inside the program's spans ``spans`` over
    the device time of every kernel of the traced stretch, in %."""
    if ctx.mix["kind"] != kind or ctx.prof is None:
        return None
    inside = sum(ctx.prof["spans"].get(s, 0.0) for s in spans)
    base = ctx.prof.get("span_base_s", ctx.prof["kernel_s"])
    if not inside or not base:
        return None
    return 100.0 * inside / base
