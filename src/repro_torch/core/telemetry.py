"""Telemetry vocabulary, PyTorch port of the part of ``repro/core/telemetry.py``
the port uses so far: the phase tags of the exchange rounds, the percentile
summary and ``MetricsRegistry`` (named counters).  The flight recorder
itself (trace buffer, recorder, Perfetto export) belongs to a later slice;
until then the port's protocol runs with no recorder, which the reference
defines as bit-identical to a recorded run.

Phase tags name the protocol work an exchange round carries: READ / VALIDATE
/ REFRESH rounds are one-sided, FALLBACK / LOCK / COMMIT rounds run RPC
handlers, SUMMARY rows carry a protocol round's abort vector.
"""
from __future__ import annotations

import json

import numpy as np

PH_OTHER = 0      # unclassified single rounds (direct rpc_call/remote_read)
PH_READ = 1       # one-sided read-set probe (hybrid phase 2)
PH_FALLBACK = 2   # read-set RPC fallback in its own round (unfused schedule)
PH_LOCK = 3       # LOCK round; under the fused schedule this single
                  # exchange also carries the fallback + validate classes
PH_VALIDATE = 4   # one-sided validate re-read
PH_COMMIT = 5     # COMMIT/ABORT round (+ backup fan-out classes at f > 0)
PH_REFRESH = 6    # metadata refresh (placement table / separator directory)
PH_SUMMARY = 7    # per-protocol-round summary (abort-cause vector)

PHASE_NAMES = {
    PH_OTHER: "other", PH_READ: "read", PH_FALLBACK: "fallback",
    PH_LOCK: "lock", PH_VALIDATE: "validate", PH_COMMIT: "commit",
    PH_REFRESH: "refresh", PH_SUMMARY: "summary",
}


def summarize(latencies) -> dict:
    """Percentile summary of a latency sample: {p50, p90, p99, mean} floats.
    Empty samples summarize to NaNs."""
    a = np.asarray(latencies, np.float64).ravel()
    if a.size == 0:
        nan = float("nan")
        return dict(p50=nan, p90=nan, p99=nan, mean=nan)
    return dict(p50=float(np.percentile(a, 50)),
                p90=float(np.percentile(a, 90)),
                p99=float(np.percentile(a, 99)),
                mean=float(a.mean()))


class MetricsRegistry:
    """Named host-side counters the benchmarks publish (``metrics.json``):
    plain floats, incremented from a protocol run's results.  ``observe``
    stores a whole latency distribution under dotted percentile keys."""

    def __init__(self):
        self._vals: dict = {}

    def incr(self, name: str, value=1.0):
        self._vals[name] = float(self._vals.get(name, 0.0)) + float(value)

    def set(self, name: str, value):
        self._vals[name] = float(value)

    def observe(self, name: str, latencies):
        for k, v in summarize(latencies).items():
            self._vals[f"{name}.{k}"] = v

    def get(self, name: str, default=0.0) -> float:
        return float(self._vals.get(name, default))

    def as_dict(self) -> dict:
        return dict(sorted(self._vals.items()))

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=2, sort_keys=True)
            f.write("\n")
