"""Validate the flight recorder's exported artifacts, the port's
counterpart of ``benchmarks/check_trace.py``.

Hand-rolled structural validation of the two files
``python -m repro_torch.testing.gate --trace`` writes:

  * the Chrome/Perfetto trace-event document: well-formed "M"/"X"/"C"
    events, per-process metadata for every node track, monotone modeled
    timestamps, positive slice durations, the ``otherData`` health block
    (and zero dropped events — a smoke run must fit its buffer);
  * the flat ``metrics.json``: string -> finite number, including the
    latency-percentile keys the bench gate pins.

    python -m repro_torch.testing.check_trace trace.json [metrics.json]

Exit 0 when both validate; every violation is printed as ``TRACE-CHECK
FAIL: ...`` and exits 1.
"""
from __future__ import annotations

import json
import math
import sys

REQUIRED_METRICS = (
    "tatp.latency_us.committed.p50",
    "tatp.latency_us.committed.p99",
    "tatp.commit_rate",
    "tatp.trace_dropped",
)


def check_trace(doc) -> list[str]:
    fails = []

    def need(cond, msg):
        if not cond:
            fails.append(msg)
        return cond

    if not need(isinstance(doc, dict), "trace document is not an object"):
        return fails
    ev = doc.get("traceEvents")
    if not need(isinstance(ev, list) and ev, "traceEvents missing or empty"):
        return fails
    od = doc.get("otherData")
    if need(isinstance(od, dict), "otherData block missing"):
        for k in ("events", "dropped", "n_nodes", "modeled_span_us"):
            need(k in od, f"otherData.{k} missing")
        need(od.get("dropped") == 0,
             f"trace dropped {od.get('dropped')} events — the smoke run "
             f"must fit its buffer")
    pids = set()
    n_slices = 0
    last_ts = -1.0
    for i, e in enumerate(ev):
        if not need(isinstance(e, dict) and "ph" in e,
                    f"traceEvents[{i}] is not an event object"):
            continue
        ph = e["ph"]
        if not need(ph in ("M", "X", "C"),
                    f"traceEvents[{i}]: unknown event type {ph!r}"):
            continue
        if ph == "M":
            need(e.get("name") == "process_name"
                 and isinstance(e.get("args", {}).get("name"), str),
                 f"traceEvents[{i}]: metadata event without a process name")
            pids.add(e.get("pid"))
            continue
        need(isinstance(e.get("ts"), (int, float)) and e["ts"] >= 0,
             f"traceEvents[{i}]: bad ts {e.get('ts')!r}")
        need(e.get("pid") in pids,
             f"traceEvents[{i}]: pid {e.get('pid')!r} has no process "
             f"metadata track")
        if ph == "X":
            n_slices += 1
            need(isinstance(e.get("dur"), (int, float)) and e["dur"] > 0,
                 f"traceEvents[{i}]: slice without positive dur")
            need(isinstance(e.get("name"), str) and e["name"],
                 f"traceEvents[{i}]: unnamed slice")
            args = e.get("args", {})
            for k in ("round", "msgs", "bytes", "ops"):
                need(isinstance(args.get(k), (int, float)),
                     f"traceEvents[{i}]: slice args.{k} missing")
            if isinstance(e.get("ts"), (int, float)):
                need(e["ts"] >= last_ts,
                     f"traceEvents[{i}]: modeled timeline not monotone")
                last_ts = e["ts"]
        else:  # "C"
            need(isinstance(e.get("args"), dict) and e["args"],
                 f"traceEvents[{i}]: counter event without args")
    need(n_slices > 0, "no 'X' slices — the recorder captured no rounds")
    return fails


def check_metrics(doc) -> list[str]:
    fails = []
    if not isinstance(doc, dict) or not doc:
        return ["metrics document is not a non-empty object"]
    for k, v in doc.items():
        if not isinstance(k, str):
            fails.append(f"non-string metrics key {k!r}")
        if not isinstance(v, (int, float)) or (
                isinstance(v, float) and not math.isfinite(v)):
            fails.append(f"metrics[{k!r}] is not a finite number: {v!r}")
    for k in REQUIRED_METRICS:
        if k not in doc:
            fails.append(f"required metrics key missing: {k}")
    if doc.get("tatp.trace_dropped", 0) != 0:
        fails.append(f"tatp.trace_dropped = {doc['tatp.trace_dropped']} "
                     f"(must be 0 for the smoke run)")
    return fails


def main(argv) -> int:
    if not argv:
        print("usage: python -m repro_torch.testing.check_trace trace.json "
              "[metrics.json]")
        return 2
    fails = []
    with open(argv[0]) as f:
        fails += [f"{argv[0]}: {m}" for m in check_trace(json.load(f))]
    if len(argv) > 1:
        with open(argv[1]) as f:
            fails += [f"{argv[1]}: {m}" for m in check_metrics(json.load(f))]
    for m in fails:
        print(f"TRACE-CHECK FAIL: {m}")
    if not fails:
        print(f"# trace check green: {', '.join(argv)} validate")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
