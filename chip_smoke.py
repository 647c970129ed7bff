#!/usr/bin/env python3
"""Drive the PyTorch port of the Storm dataplane on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit; build the CUDA kernels
     (``src/repro_torch/csrc``) with nvcc for sm_90a;
  2. every kernel against its plain PyTorch version on the card, bit for
     bit: ``hash_probe`` with the TPU kernel's contract (widths 1/2/4/8,
     hits, misses, chained keys, clamped starts) and with the dataplane's
     contract (cache hits, offsets that clamp, undelivered lanes);
  3. the bench gate's tx_loop workload on the card and on the CPU: identical
     arenas and the gate keys of ``benchmarks/BENCH_BASELINE.json``; a small
     TATP mix with retry rounds, card against CPU;
  4. the main path: TATP through ``txloop.tx_loop`` at 32 simulated nodes
     and 2**15 subscribers per node (1,048,576 subscribers), with the
     kernels' launch counts read around that one run.  Before it, each
     kernel is timed against its plain version at the shapes this run gives
     it; after it, one more protocol round runs under torch.profiler to show
     the device's busy share.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA the script exits
with code 2 and prints no result.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory rate (data sheet)
# the main path: fig6's TATP at the paper's 32 nodes, 2**15 subscribers each
TATP_NODES, TATP_SUBSCRIBERS_PER_NODE, TATP_LANES, TATP_MAX_ROUNDS = \
    32, 2**15, 512, 4


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(name):
    print(f"== {name}", flush=True)


def time_cuda(fn, iters, flush=None):
    """Device time (ms) of each of ``iters`` calls, from CUDA events around
    each call.  The calls are queued behind a device-side sleep, so the
    host's launch overhead does not show up as device time; the optional
    ``flush`` (evicting L2) runs before each call, outside the timed span."""
    import torch
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(400_000_000)            # ~0.2 s of device time
    for a, b in ev:
        if flush is not None:
            flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in ev]


def max_abs_diff(pairs):
    import torch
    err = 0
    for x, y in pairs:
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------------------------
def kernel_checks(dev):
    """hash_probe kernel against its plain version, bit for bit."""
    import torch
    from repro_torch.core import rpc as R
    from repro_torch.core import slots as sl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import SimTransport
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    pairs = []
    # --- the TPU kernel's contract on a populated one-node table -----------
    for width in (1, 2, 4, 8):
        n = 96 * width             # 1.5x the bucket slots: chains form
        cfg = ht.HashTableConfig(n_nodes=1, n_buckets=64, bucket_width=width,
                                 n_overflow=n, max_chain=64)
        layout = ht.build_layout(cfg)
        state = ht.init_cluster_state(cfg, device=dev)
        g = torch.Generator().manual_seed(width)
        klo = torch.randint(0, 2**31, (1, n), generator=g,
                            dtype=torch.int64).to(torch.int32).to(dev)
        khi = torch.randint(0, 2**31, (1, n), generator=g,
                            dtype=torch.int64).to(torch.int32).to(dev)
        node = torch.zeros((1, n), dtype=torch.int32, device=dev)
        state, rep, _, _ = R.rpc_call(
            SimTransport(1), state, node,
            ht.make_record(R.OP_INSERT, klo, khi, value=wl.value_for(klo)),
            ht.make_rpc_handler(cfg, layout))
        check(bool((rep[..., 0] == R.ST_OK).all()), f"insert failed w={width}")
        arena = state["arena"][0]
        _, bucket = ht.home_of(cfg, klo[0], khi[0])
        bucket = bucket.to(torch.int32)
        # out-of-range buckets exercise the clamped start
        bucket[:8] = torch.tensor([-3, -1, 64, 65, 1 << 20, -(1 << 30), 63, 0],
                                  dtype=torch.int32)
        found = []
        for lo in (klo[0], klo[0] + 1):                # hits, then misses
            got = hp.hash_probe(arena, bucket, lo, khi[0], width=width)
            want = hp.hash_probe_plain(arena, bucket, lo, khi[0], width=width)
            check(torch.equal(got, want),
                  f"hash_probe != plain (TPU contract, width {width})")
            pairs.append((got, want))
            found.append(int(got[8:, 0].sum()))
        check(0 < found[0] < n - 8 and found[1] == 0,
              f"width {width}: expected hits, chained keys and misses")
        print(f"tpu contract width={width}: {n} keys, {found[0]} found in "
              f"their bucket, {n - 8 - found[0]} chained", flush=True)

    # --- the dataplane's contract on random arenas --------------------------
    g = torch.Generator().manual_seed(11)
    N, words, M = 4, 4096 + 7, 8192
    for width in (1, 2, 4):
        arenas = torch.randint(-2**31, 2**31, (N, words), generator=g,
                               dtype=torch.int64).to(torch.int32)
        dest = torch.randint(-1, N + 1, (M,), generator=g).to(torch.int32)
        off = torch.randint(0, words, (M,), generator=g)
        kind = torch.randint(0, 4, (M,), generator=g)
        off = torch.where(kind == 1, words - torch.randint(0, 48, (M,),
                                                           generator=g), off)
        off = torch.where(kind == 2, torch.randint(2**31, 2**32, (M,),
                                                   generator=g), off)
        off = torch.where(kind == 3, (off // 32) * 32, off)
        # plant matches: a lane's key equals a stable, unlocked slot's key
        s = torch.randint(0, width, (M,), generator=g)
        plant = (torch.rand((M,), generator=g) < 0.5) & (kind == 3) & \
            (dest >= 0) & (dest < N) & (off + (s + 1) * 32 <= words)
        key_lo = torch.randint(-2**31, 2**31, (M,), generator=g,
                               dtype=torch.int64).to(torch.int32)
        key_hi = torch.randint(-2**31, 2**31, (M,), generator=g,
                               dtype=torch.int64).to(torch.int32)
        base = off + s * 32
        r = dest.clamp(0, N - 1).to(torch.int64)
        for w_, k in ((2, 0), (3, 0)):     # version even, lock free
            arenas[r[plant], base[plant] + w_] = k
        key_lo = torch.where(plant, arenas[r, (base).clamp(0, words - 1)],
                             key_lo)
        key_hi = torch.where(plant, arenas[r, (base + 1).clamp(0, words - 1)],
                             key_hi)
        live = torch.rand((M,), generator=g) < 0.8
        hit = torch.rand((M,), generator=g) < 0.3
        args = [x.to(dev) for x in (arenas, dest, sl.i32(off), key_lo,
                                    key_hi, live, hit)]
        got = hp.probe_lines(*args, width=width)
        want = hp.probe_lines_plain(*args, width=width)
        for a, b, name in zip(got, want, ("found", "version", "value",
                                          "local_idx")):
            check(torch.equal(a, b),
                  f"probe_lines {name} != plain (width {width})")
            pairs.append((a, b))
        print(f"path contract width={width}: {M} lanes, "
              f"{int(got[0].sum())} found", flush=True)
    torch.cuda.synchronize()
    return max_abs_diff(pairs)


def parity_checks(dev, baseline):
    """Gate workload and a small TATP mix: card against CPU."""
    import torch
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import SimTransport
    from repro_torch.testing import workloads as wl
    import numpy as np

    st_c, res_c, keys_c = wl.gate_tx_smoke(device=dev)
    st_h, res_h, keys_h = wl.gate_tx_smoke(device="cpu")
    check(torch.equal(st_c["arena"].cpu(), st_h["arena"]),
          "gate: CUDA arenas differ from the CPU run")
    check(torch.equal(res_c.committed.cpu(), res_h.committed),
          "gate: commit masks differ")
    print(f"gate keys (cuda): {json.dumps(keys_c)}", flush=True)
    for k, v in keys_c.items():
        check(v == baseline[k] and keys_h[k] == baseline[k],
              f"gate key {k}: cuda {v} cpu {keys_h[k]} baseline {baseline[k]}")

    # the fig6 smoke configuration (4 nodes, 160 subscribers, 16 lanes),
    # with retry rounds drawing the same generator permutations
    outs = []
    for d in (dev, "cpu"):
        cfg = ht.HashTableConfig(n_nodes=4, n_buckets=1024, bucket_width=1,
                                 n_overflow=160, max_chain=12)
        layout = ht.build_layout(cfg)
        t = SimTransport(4)
        st = ht.init_cluster_state(cfg, device=d)
        st, (klo, khi) = wl.populate(cfg, layout, t, st, 160, seed=3,
                                     device=d)
        rk, wk, ren, wen, wv = wl.tatp_transactions(
            klo, khi, n_nodes=4, lanes=16, subscribers_per_node=160,
            rng=np.random.RandomState(4), device=d)
        st, _, res = txl.tx_loop(t, st, cfg, layout, read_keys=rk,
                                 write_keys=wk, write_values=wv,
                                 read_enabled=ren, write_enabled=wen,
                                 max_rounds=4, device=d)
        outs.append((st["arena"].cpu(), res))
    check(torch.equal(outs[0][0], outs[1][0]),
          "small TATP: CUDA arenas differ from the CPU run")
    check(torch.equal(outs[0][1].committed.cpu(), outs[1][1].committed),
          "small TATP: commit masks differ")
    print(f"small TATP: commit rate "
          f"{float(outs[0][1].committed.float().mean())}, retries "
          f"{int(outs[0][1].round_retries.sum())}, card == CPU", flush=True)


def tatp_main_path(dev, kernel_rows):
    """Populate TATP_NODES x TATP_SUBSCRIBERS_PER_NODE subscribers, time the
    kernel at the probe shape, then run the TATP batch through tx_loop
    once."""
    import numpy as np
    import torch
    from repro_torch.core import slots as sl
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import SimTransport
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    n_nodes, subs = TATP_NODES, TATP_SUBSCRIBERS_PER_NODE
    lanes, max_rounds = TATP_LANES, TATP_MAX_ROUNDS
    cfg = ht.HashTableConfig(n_nodes=n_nodes, n_buckets=2**18, bucket_width=1,
                             n_overflow=2**15, max_chain=12)
    layout = ht.build_layout(cfg)
    t = SimTransport(n_nodes)
    state = ht.init_cluster_state(cfg, device=dev)
    print(f"tatp: {n_nodes} nodes x {subs} subscribers, arenas "
          f"{state['arena'].numel() * 4 / 1e9:.3f} GB", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, (klo, khi) = wl.populate(cfg, layout, t, state, subs, seed=3,
                                    device=dev)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    print(f"tatp: population {pop_s:.1f} s", flush=True)
    rk, wk, ren, wen, wv = wl.tatp_transactions(
        klo, khi, n_nodes=n_nodes, lanes=lanes, subscribers_per_node=subs,
        rng=np.random.RandomState(4), device=dev)

    # --- hash_probe at the TATP probe shape (round 0's read set) ----------
    rk_lo = rk[..., 0].reshape(n_nodes, -1)
    rk_hi = rk[..., 1].reshape(n_nodes, -1)
    node, off, hit = ht.lookup_start(cfg, layout, rk_lo, rk_hi)
    live = ren.reshape(n_nodes, -1)
    args = [x.reshape(-1).contiguous() for x in (node, off, rk_lo, rk_hi,
                                                 live, hit)]
    args = [state["arena"]] + args
    M = args[1].shape[0]
    got = hp.probe_lines(*args, width=1)
    want = hp.probe_lines_plain(*args, width=1)
    err = max_abs_diff(zip(got, want))
    check(err == 0, "hash_probe != plain at the TATP probe shape")
    scratch = torch.empty(64 * 2**20 // 4, dtype=torch.int32, device=dev)
    flush = lambda: scratch.fill_(1)          # evict L2 (50 MB) between calls
    k_ms = time_cuda(lambda: hp.probe_lines(*args, width=1), 100, flush)
    p_ms = time_cuda(lambda: hp.probe_lines_plain(*args, width=1), 20, flush)
    n_live = int(live.sum())
    byts = n_live * sl.SLOT_BYTES + M * (4 * 4 + 2) + M * (1 + 4 + 4 + 4 * 27)
    bound_ms = byts / HBM_BYTES_PER_S * 1e3
    ks, ps = T.summarize(k_ms), T.summarize(p_ms)
    print(f"hash_probe at the TATP probe shape: M={M} lanes ({n_live} live), "
          f"kernel {ks['mean']:.4f} ms (p50 {ks['p50']:.4f}, p99 "
          f"{ks['p99']:.4f}), plain {ps['mean']:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({byts} B)", flush=True)
    row = kernel_rows["hash_probe"]
    row.update(ms=ks["mean"], plain_ms=ps["mean"], bound_ms=bound_ms,
               max_abs_err=max(row["max_abs_err"], err))
    del scratch

    # --- the main path: one tx_loop run, launch counts read around it -----
    torch.cuda.reset_peak_memory_stats()
    hp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, res = txl.tx_loop(t, state, cfg, layout, read_keys=rk,
                                write_keys=wk, write_values=wv,
                                read_enabled=ren, write_enabled=wen,
                                max_rounds=max_rounds, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row["launches"] = hp.launches
    check(hp.launches > 0, "the main path launched no hash_probe kernel")

    n_tx = n_nodes * lanes
    committed = int(res.committed.sum())
    rounds_attempted = int((res.round_attempts > 0).sum())
    m = res.metrics
    stats = {
        "nodes": n_nodes, "subscribers": n_nodes * subs, "lanes": lanes,
        "population_s": pop_s, "tx_loop_s": wall,
        "committed_tx_per_s": committed / wall,
        "commit_rate": committed / n_tx,
        "rt_round": float(res.round_trips) / max(rounds_attempted, 1),
        "read_rpc_frac": float(m.rpc_fallback) / max(float(m.total), 1.0),
        "bytes_per_tx": float(m.wire.total_bytes) / n_tx,
        "retries": int(res.round_retries.sum()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "hash_probe_launches": hp.launches,
    }
    print("tatp: " + json.dumps(stats), flush=True)

    # --- what came out is right --------------------------------------------
    slots_v = state["arena"][:, :cfg.n_slots * sl.SLOT_WORDS].view(
        n_nodes, cfg.n_slots, sl.SLOT_WORDS)
    check(int((slots_v[..., sl.LOCK] != 0).sum()) == 0,
          "a slot is still locked after tx_loop")
    check(int((slots_v[..., sl.VERSION] & 1).sum()) == 0,
          "a slot is left with an odd version")
    n_keys = len(set(zip(klo.reshape(-1).tolist(), khi.reshape(-1).tolist())))
    occupied = int((slots_v[..., sl.KEY_LO] != sl.EMPTY_KEY).sum())
    check(occupied == n_keys, f"{occupied} occupied slots for {n_keys} keys")
    com = res.committed
    check(bool((res.read_found | ~ren | ~com[..., None]).all()),
          "a committed transaction missed a populated key")
    orig = wl.value_for(rk[..., 0])
    wrote = sl._mix32(rk[..., 0] + 99)[..., None].expand_as(orig)
    ok = ((res.read_values == orig).all(-1) | (res.read_values == wrote).all(-1)
          | ~res.read_found)
    check(bool(ok.all()), "a read returned a value no writer produced")
    check(stats["commit_rate"] > 0.5, "TATP commit rate below 0.5")
    check(float(res.round_trips) <= 4.0 * rounds_attempted,
          "fused schedule exceeded 4 exchanges per round")

    # --- where the time goes: one more protocol round of the same batch ----
    profile_round(lambda: txl.tx_loop(
        t, state, cfg, layout, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen, max_rounds=1, device=dev))
    return stats


def profile_round(fn):
    """Run ``fn`` once under torch.profiler and print its wall time, the
    summed device time of its kernels (the device's busy share; one stream,
    so kernels do not overlap) and the kernels that took the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:5]
    print("tatp profile: " + json.dumps({
        "round_wall_s": wall, "device_busy_s": busy,
        "device_busy_share": busy / wall if busy else "not measured",
        "kernel_launches": sum(e.count for e in kernels),
        "top_kernels": [{"name": e.key[:60], "count": e.count,
                         "device_s": dev_us(e) / 1e6} for e in top]}),
        flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, hash_probe as hp

    dev = "cuda"
    phase("device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    build.load("hash_probe")
    print(f"build: hash_probe {time.perf_counter() - t0:.1f} s", flush=True)
    for line in (build.BUILD_DIR / "hash_probe.log").read_text().splitlines() \
            if (build.BUILD_DIR / "hash_probe.log").exists() else []:
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    phase("kernels against their plain versions")
    err = kernel_checks(dev)
    rows = {"hash_probe": dict(
        name="hash_probe", route="cuda",
        source="src/repro_torch/csrc/hash_probe.cu",
        replaces="src/repro/kernels/hash_probe.py:53", launches=0,
        max_abs_err=err, ms=None, plain_ms=None, bound_ms=None,
        bound_by="bytes", library_ms=None)}

    phase("gate workload and small TATP: card against CPU")
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())
    parity_checks(dev, baseline)

    phase("TATP main path")
    tatp_main_path(dev, rows)

    print(card)                     # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
