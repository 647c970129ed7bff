"""The traced window: ``torch.profiler`` over a short steady stretch of the
cell's own work, reduced to what the per-layer readers take.

From the device's timeline it keeps each kernel's time by name, the time
the device was busy (the union of every kernel, copy and fill), the time
of the kernels that ran inside each named span (the program's
``record_function`` spans, which the profiler also marks on the device),
the longest idle gaps with what the host was doing meanwhile, and the
window's length on the host clock.  The device's own timeline is all it
reads: no reading is taken from a span's host-side time.

A traced stretch runs twice: once with the device alone recorded (the busy
share, the kernels' times, the kernels that took the most), once with the
host's operators too (the spans, and what the host did in each idle gap).
"""
from __future__ import annotations

import time

import torch

# host events that only mark the profiler's own work
_HOST_NOISE = ("ProfilerStep", "[memory]")


def _union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _within(kernels, spans):
    """Time of the kernels inside the union of the span intervals."""
    spans = sorted(spans)
    out, j = 0.0, 0
    for s, e in sorted(kernels):
        while j < len(spans) and spans[j][1] <= s:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < e:
            out += max(0.0, min(e, spans[k][1]) - max(s, spans[k][0]))
            k += 1
    return out


def reduce_events(events, wall_s: float, span_names=()):
    """Summarise profiler events (``FunctionEvent``-like: ``name``,
    ``device_type``, ``time_range.start/end`` in us, ``is_user_annotation``)
    of a window of ``wall_s`` host seconds."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in events:
        (dev if e.device_type == cuda else host).append(e)
    span_names = set(span_names)
    is_annot = lambda e: (getattr(e, "is_user_annotation", False)
                          or e.name in span_names)
    annot = [e for e in dev if is_annot(e)]
    kernels = [e for e in dev if not is_annot(e)]
    iv = lambda e: (e.time_range.start / 1e6, e.time_range.end / 1e6)
    by_name = {}
    for e in kernels:
        s, t = iv(e)
        by_name[e.name] = by_name.get(e.name, 0.0) + (t - s)
    kiv = [iv(e) for e in kernels]
    spans = {n: _within(kiv, [iv(e) for e in annot if e.name == n])
             for n in span_names}
    gaps = []
    merged = []
    for s, e in sorted(kiv):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        gaps.append((s1 - e0, e0, s1))
    gaps.sort(reverse=True)
    hosts = [(iv(e), e.name) for e in host
             if not any(e.name.startswith(n) for n in _HOST_NOISE)]
    idle = []
    for g, s, t in gaps[:10]:
        mid = (s + t) / 2
        inside = [(b - a, n) for (a, b), n in hosts if a <= mid <= b]
        idle.append([min(inside)[1] if inside else "no host event", g])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"wall_s": wall_s, "busy_s": _union(kiv), "kernels": by_name,
            "kernel_s": sum(by_name.values()), "spans": spans,
            "breakdown": {"device_ops": [[n, s] for n, s in top],
                          "idle_gaps": idle}}


def profile(fn, span_names=(), host=True):
    """Run ``fn`` once under the profiler, the window closed by a
    synchronise, and reduce it (:func:`reduce_events`).  ``host`` records
    the host's operators too, which the spans and the naming of idle gaps
    need; it slows a host-bound stretch, so the busy share is read from a
    pass without it."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return reduce_events(prof.events(), wall, span_names)
