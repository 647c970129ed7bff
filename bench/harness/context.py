"""One run of one cell: what the cell's driver (``train_cell`` /
``prefill_cell``) reads and fills, the traced stretch, the per-layer
readers, and the result line."""
from __future__ import annotations

import json
import os
import sys
import time

import torch

from harness import profiling, spec

# top-level module names a run must not hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's spans that per-layer readers take
SPANS = ("adamw", "flash_attention backward", "ssd_scan backward",
         "train forward")


def process_start() -> float:
    """This process's start on the ``time.time`` clock (from
    /proc/self/stat where there is one, else now)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(l.split()[1]) for l in f if l.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


class Context:
    """State of one run.  ``device`` is where it runs: "cuda" for every
    benchmark run; the tests pass "cpu"."""

    def __init__(self, *, workload, model_entry, model_file, mix, limits,
                 seed, seconds, trace, device, t_start):
        self.workload, self.entry = workload, model_entry
        self.model = model_file["model"]
        self.fam = spec.reference(model_file["family"])
        self.mix, self.limits = mix, limits
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.t_start = t_start
        self.e2e, self.checks, self.notes = {}, {}, []
        self.attempted = self.failed = 0
        self.window_s = self.window_flops = 0.0
        self.setup_s = None
        self.memory_peak = 0
        self.prof, self.launches = None, []
        self.forbidden_seen = []
        self.make_trainer = self.make_prefill = None   # set by run.py

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def setup_done(self):
        self.setup_s = time.time() - self.t_start
        self.note(f"setup: {self.setup_s:.1f} s from process start")

    def phase(self, name: str):
        """Note the seconds since the last phase (or the process start)."""
        now = time.time()
        self.note(f"phase {name}: {now - getattr(self, '_last', self.t_start):.2f} s")
        self._last = now

    def window_closed(self):
        self.forbidden_seen = sorted(
            {n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))

    def note(self, line: str):
        self.notes.append(line)

    def launch_counts(self):
        from repro_torch.kernels import flash_attention, ssd_scan
        return {"flash_attention": flash_attention.launches,
                "ssd_scan": ssd_scan.launches}

    def record_launches(self, before: dict, shapes: dict):
        """Launches of each kernel since ``before``, each at ``shapes``."""
        now = self.launch_counts()
        for k, shape in shapes.items():
            if now[k] > before[k]:
                self.launches.append((k, now[k] - before[k], shape))

    def run_traced(self, fn):
        """Profile ``fn`` (the cell's traced stretch) twice: the device
        alone, then with the host (:mod:`harness.profiling`).  Launches are
        counted in the first pass, whose kernel times the rooflines take."""
        self.launches.clear()
        if not self.cuda:
            fn()
            return
        self.prof = profiling.profile(fn, SPANS, host=False)
        launches = list(self.launches)
        with_host = profiling.profile(fn, SPANS)
        self.launches = launches
        self.prof["spans"] = with_host["spans"]
        self.prof["span_base_s"] = with_host["kernel_s"]
        self.prof["breakdown"]["idle_gaps"] = \
            with_host["breakdown"]["idle_gaps"]

    def judge(self, readings: dict):
        """Hold each reading against its limit in the cell's limits file; a
        reading the file gives no limit is noted and not compared."""
        self.checks = {k: (v, self.limits[k]) for k, v in readings.items()
                       if k in self.limits}
        for k, v in readings.items():
            if k not in self.limits:
                self.note(f"reading {k} {v!r} (not compared)")

    def read_memory(self):
        if self.cuda:
            self.memory_peak = torch.cuda.max_memory_allocated()

    def free(self):
        if self.cuda:
            torch.cuda.empty_cache()

    def per_layer(self, names):
        """{metric: value} from each metric's reader; a reader that finds
        nothing to read returns None and the metric is left out."""
        out = {}
        for name in names:
            v = spec.metric_reader(name).read(self)
            if v is not None:
                out[name] = v
        return out

    def result(self, bench):
        """The result line (a dict), its keys in the contract's order with
        the compared numbers last."""
        correct = (not self.forbidden_seen and bool(self.checks) and all(
            v <= lim for v, lim in self.checks.values()))
        kind = "per_layer" if self.trace else "end_to_end"
        metrics = {}
        for m in spec.metrics_of(bench, self.workload, kind):
            if kind == "end_to_end":
                v = self.setup_s if m["name"] == "setup_s" \
                    else self.e2e.get(m["name"])
            else:
                v = self.per_layer([m["name"]]).get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev = {"platform": "gpu" if self.cuda else "cpu",
               "kind": (torch.cuda.get_device_name(0) if self.cuda
                        else "cpu"),
               "count": self.entry.get("chips", 1),
               "memory_peak_bytes": self.memory_peak}
        out = {"correct": correct, "attempted": self.attempted,
               "failed": self.failed, "metrics": metrics, "device": dev}
        if self.trace and self.prof is not None:
            dev["busy_s"] = self.prof["busy_s"]
            dev["window_s"] = self.prof["wall_s"]
            out["breakdown"] = self.prof["breakdown"]
        out["checks"] = {k: {"value": v, "limit": lim}
                         for k, (v, lim) in self.checks.items()}
        return out


def emit(result: dict, notes=()):
    """The compared numbers beside their limits as the last lines of
    standard error, the result as the last line of standard output."""
    for line in notes:
        print(line, file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
