"""Run a function on every rank of a small world of spawned processes.

``run_ranks(fn, world_size, device=...)`` spawns one process a rank, joins
each to the default process group through a ``file://`` rendezvous (no TCP
port, so several worlds can run side by side), calls ``fn(rank,
world_size, *args)`` there and returns the ranks' results in rank order.
Each world has its own deadline: a rank that raises, dies or is still
running when it passes fails the call, and every process of the world is
stopped.  ``fn`` must be importable by the child (a module-level function
of a module that imports what the rank needs, and nothing of the JAX
package: every rank asserts that ``jax`` and ``repro.`` stay unloaded).
Results go back through ``torch.save``, so keep them small and on the CPU.

``collective_log()`` records the collectives a rank calls through
``torch.distributed`` in the dry run's terms (``launch/dryrun.py``), so a
rank's real step can be held against its meta record.
"""
from __future__ import annotations

import contextlib
import multiprocessing as mp
import os
import pathlib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Optional

import torch


def foreign_modules():
    """Modules of the JAX package, or JAX itself, loaded in this process."""
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib")
                  or m == "repro" or m.startswith("repro."))


# the torch.distributed collectives the port's models call (through
# parallel.sharding.Topology), by XLA's op name
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce"}


@contextlib.contextmanager
def collective_log():
    """Record every call of :data:`COLLECTIVES` on this rank while the block
    runs: yields a list that gets (op, the output's bytes, the group's
    size) a call, in call order (``Topology.log``'s entries)."""
    import torch.distributed as dist
    log, saved = [], {n: getattr(dist, n) for n in COLLECTIVES}

    def spy(name):
        def call(out, *a, **k):
            log.append((COLLECTIVES[name], out.numel() * out.element_size(),
                        dist.get_world_size(k.get("group"))))
            return saved[name](out, *a, **k)
        return call
    for n in COLLECTIVES:
        setattr(dist, n, spy(n))
    try:
        yield log
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)


def _rank_main(fn, rank, world_size, device, backend, init_method, args,
               out, threads):
    try:
        import torch.distributed as dist
        if threads is not None:
            torch.set_num_threads(threads)
        from repro_torch.launch.mesh import init_group
        if isinstance(device, (list, tuple)):
            device = device[rank]
        init_group(device, rank=rank, world_size=world_size,
                   init_method=init_method, backend=backend)
        result = fn(rank, world_size, *args)
        loaded = foreign_modules()
        if loaded:
            raise RuntimeError(f"rank {rank} loaded {loaded}")
        dist.barrier()
        dist.destroy_process_group()
        torch.save(result, out)
    except BaseException:
        pathlib.Path(out + ".err").write_text(traceback.format_exc())
        sys.stderr.write(traceback.format_exc())
        sys.stderr.flush()
        os._exit(1)


def run_ranks(fn, world_size: int, *, device, args=(),
              backend: Optional[str] = None, deadline_s: float = 120.0,
              workdir=None, meanwhile=None, threads: Optional[int] = None):
    """``fn(rank, world_size, *args)`` on ``world_size`` spawned ranks, each
    joined to the default process group on ``device`` (one for all ranks,
    or a sequence of one a rank; the backend from the device unless
    ``backend`` names one).  The rendezvous file and the
    results go in a new directory under ``workdir`` (default the temporary
    directory), removed after.  ``meanwhile``, if given, is called here
    once the ranks have started.  ``threads``, if given, pins each rank's
    torch intra-op threads (several ranks sharing a few CPUs).  Returns the
    results in rank order; raises RuntimeError when a rank fails and
    TimeoutError when the world outlives ``deadline_s``."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ranks_", dir=workdir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world_size)]
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, device, backend,
                               init_method, args, outs[r], threads),
                         daemon=True)
             for r in range(world_size)]
    try:
        end = time.monotonic() + deadline_s
        for p in procs:
            p.start()
        if meanwhile is not None:
            meanwhile()
        while True:
            alive = any(p.is_alive() for p in procs)
            bad = [r for r, p in enumerate(procs)
                   if p.exitcode not in (None, 0)]
            if bad:
                errs = [pathlib.Path(outs[r] + ".err") for r in bad]
                raise RuntimeError("rank(s) %s failed:\n%s" % (bad, "\n".join(
                    e.read_text() for e in errs if e.exists())))
            if not alive:
                return [torch.load(o, weights_only=False) for o in outs]
            if time.monotonic() > end:
                raise TimeoutError(f"a world of {world_size} ranks passed its "
                                   f"{deadline_s:.0f} s deadline")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
