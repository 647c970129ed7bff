#!/usr/bin/env python3
"""Drive the PyTorch port of the Storm dataplane on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit; build the CUDA kernels
     (``src/repro_torch/csrc``) with nvcc for sm_90a, one nvcc per source,
     all at once, and print ptxas's registers and spills for every kernel
     beside the dynamic shared memory of each;
  2. every kernel against its plain PyTorch version on the card:
     ``hash_probe`` bit for bit with the TPU kernel's contract (widths
     1/2/4/8, hits, misses, chained keys, clamped starts) and with the
     dataplane's contract, with the kernel's count of its fast lanes
     (widths 1/2/4/8; n_words 0..3 mod 4 and arena bases off 16 B; lines that end
     at the arena's last word, cross it, wrap in 32 bits; dest -1 and N;
     cache hits; undelivered lanes and a CTA of them; M = 1, one CTA and a
     lane, 8192 and 2**18); ``flash_attention`` (causal and not, window,
     softcap, GQA 2 and 4, ragged lengths around the bf16 kernel's 128 x
     128 tiles, D 16-128, bf16 on the tensor-core kernel and float32 on
     the CUDA-core one, a query offset on each; at the serving shape with diffuse and sharp scores, element by
     element, and a dropped kv block as a negative control) and
     ``ssd_scan`` (several Q/H/h_tile, Q not a multiple of its 64-row tile,
     one chunk, initial states) within stated tolerances, then both timed
     at the serving shapes beside their plain versions, their bounds and
     achieved TFLOP/s and, for attention, ``scaled_dot_product_attention``;
  3. the bench gate (``repro_torch.testing.gate.collect``) on the card and
     on the CPU: every key of ``benchmarks/BENCH_BASELINE.json``, the gate
     workload's arenas unreplicated and at f=1, the ordered workload's (4
     nodes x 48 keys), the traced TATP smoke's trace rows (equal card to
     CPU, both exports passing ``check_trace``); the flight recorder's
     appends and pricing under ``torch.cuda.set_sync_debug_mode("error")``
     (no host sync); a small TATP mix with retry rounds and a small B-tree
     membership run (``scan_loop`` through a placement table, kill ->
     rereplicate and a migration over keys above 2**31, a stale-table
     batch), card against CPU;
  4. zamba2-1.2b at full width cut to 7 layers, prefill and 4 decode steps
     on the card and on the CPU (the kernels' plain versions) in float32
     weights: logits and greedy tokens must agree, within a tolerance set
     against the model's measured sensitivity; on the card, prefill 224 and
     32 decode steps against the forward over the same tokens; the bf16 run
     against the CPU's for information; then in bf16 one module at a time
     (a Mamba2 layer's prefill with its states, a decode step, the shared
     block), card against CPU within a few bf16 ulps;
  5. the TATP main path: ``txloop.tx_loop`` at 32 simulated nodes and 2**13
     subscribers per node (262,144 subscribers), with ``hash_probe``'s
     launch count read around that one run.  Before it, the kernel is timed
     against its plain version and its byte bound at the shape this run
     gives it and at a bandwidth shape (2**18 live lanes at widths 1 and 4
     over the same arenas), beside the timing floor; after it,
     one more protocol round runs under torch.profiler to show the
     device's busy share;
  6. replicated TATP: the same batch through ``tx_loop`` at
     ``ReplicaConfig(32, 1)`` from a clone of the populated arenas, with
     ``hash_probe``'s launches read around that run, beside the unreplicated
     run's figures; every committed write read back from its primary and,
     through ``replication.failover_lookup`` with every even and then every
     odd node dead, from its backup, the two slot images equal but for
     next_ptr; one protocol round under torch.profiler;
  7. the flight recorder at full width: the TATP batch at f=0 and f=1
     from clones of the populated arenas, untraced, traced, traced,
     untraced (wall times in turns): each traced run equal to the untraced
     one (arenas, commits, commit rounds, WireStats, round trips,
     ``hash_probe`` launches), its trace dropping nothing, its SUMMARY rows
     the result's round columns, its per-destination tails reconciling,
     its export passing ``check_trace``; ``latency_by_path`` and the
     modeled span printed;
  8. membership on the TATP arenas (``membership_path``): the replicated
     batch again, routed through the epoch-0 placement table, must equal
     the replicated run (arenas, commits, wire, no refresh, the same
     ``hash_probe`` launches); kill node 1 -> ``repair_plan`` ->
     ``rereplicate`` (timed: the recovery a user of the store waits for),
     every record of partition 0 streamed to its new backup and every
     committed write of partitions 0 and 1 read back through
     ``failover_lookup`` from the new owner and, the owner dead, the new
     backup; on a clone of the stable run's arenas ``migrate_partition``
     (0 -> node 3, timed), then the TATP batch from the stale table: round
     0 aborts stale_route on exactly the lanes writing partition 0, one
     refresh of ``routing_words`` per client, commits at the new owner,
     read back from it and from the old owner, now its backup; the stale
     batch again with the flight recorder, equal to it, its REFRESH row
     carrying wire in round 1 alone;
  9. the ordered path: ``range_scan.build_tree`` scaled to 32 nodes x 2**13
     keys (262,144; both B-link trees of every node on the card), a
     pure-scan batch against a numpy sorted-array reference, then
     ``scan_loop`` over the scan-heavy mix at f=0 and f=1 from clones of the
     one tree: equal round trips and commits, equal primary trees, no
     truncated lane, every committed upsert read back from the primary tree
     and from the backup tree once its primary is dead, every partition's
     fence chain sorted and linked; the f=0 mix again with the flight
     recorder, with the directory given (equal to the untraced run) and
     fetched up front (a REFRESH row of round -1), every round's
     directory-refresh row checked; one round under torch.profiler;
 10. the mesh dataplane (``mesh_dataplane``): ``MeshTransport`` over
     ``torch.distributed``, one node a rank.  World size 1 over NCCL
     (``make_smoke_mesh("cuda")``): a gate-sized insert, ``hybrid_lookup``
     and one ``run_transactions`` batch equal to ``SimTransport(1)`` bit
     for bit, ``hash_probe`` launched once per read round.  Then four
     ranks sharing the card over gloo with CUDA tensors (NCCL refuses two
     ranks on one device), with a deadline: TATP at 4 nodes x 2**12
     subscribers, 512 lanes a node, the 80/16/4 mix, f=0 (population by
     ``rpc_call``, one ``run_transactions`` batch, ``hybrid_lookup`` of
     every populated key) equal bit for bit to ``SimTransport(4)`` run here
     meanwhile (arenas, commits, reads, abort causes, lookups; the
     additive WireStats summed over the ranks, round trips per rank with
     the simulator's as their largest), ``hash_probe`` launched once per
     read round per rank; then the protocol's retry loops on the same
     ranks, each equal bit for bit to ``SimTransport(4)`` run here
     meanwhile (lanes, arenas, rounds, the additive WireStats summed over
     the ranks, round trips between the ranks' largest and their sum):
     ``tx_loop`` (4 rounds, the flight recorder on, every exchange's round
     trips the ranks' largest, row by row) over the populated TATP state;
     a replicated state (f=1, 4 x 2**11 subscribers populated through the
     replicated commit path) through ``tx_loop`` with a placement table
     that goes stale once (partition 0 handed to its backup, every rank
     aborting stale in round 0 and refreshing once); ``failover_lookup``
     of every replicated key with node 1 dead; the B-link tree at 4 x
     2**11 keys built on the ranks and its scan mix through ``scan_loop``
     at f=0 and f=1; ``hash_probe`` launched once per read round per rank,
     wall seconds per rank printed; one exchange timed; the sharded
     branches at full
     width on a (1, 4) mesh: deepseek-moe-16b's MoE layer (float32, 512
     tokens) in "rpc" and "replicated" against "local", and "onesided" at
     capacity factor 16 against "local" at 16, routing equal and outputs
     within ``F32_REL_FAMILY``, each mode with torch's sync debug mode set
     to raise outside the collectives' own waits; ``embed_lookup`` "rpc"
     and "onesided" at deepseek's vocab of 102,400 (bf16) equal to the
     plain gather; llava-next-mistral-7b's sequence-sharded decode
     attention (B 4, S 4,096, float32) against ``decode_attention``
     within ``F32_REL_FAMILY``.  The populations are cut to pay for
     phase 11 (PERF.md section 4);
 11. tensor-parallel serving (``tensor_parallel``): eight gloo ranks
     sharing the card, meshed (1, 8) for qwen1.5-4b at full width (20
     heads over 8: the sequence-parallel branch and the "seq" cache) and
     (2, 4) for glm4-9b (32 heads over 4 with its 2 kv heads repeated, the
     batch over data), SERVE_RULES, each rank holding its blocks of the
     seeded weights, the batch and the cache: float32 at 2 layers (B 1 x
     512 + 4 and 2 x 512 + 4) against the one-rank run on the card (logits
     within ``TP_F32_REL`` of the range, greedy tokens equal, each model's
     conditioning printed and held to a quarter of its limit); qwen1.5-4b's
     forward with ``pad_heads`` (24 heads) against without; bf16 at 4
     layers served through ``launch.serve`` (2 x 2,048 + 8 and 4 x 2,048 +
     8) with one ``flash_attention`` launch per layer per rank per
     prefill, prefill and decode ms per rank; the ``q_offset`` kernel at
     each rank's shape against its plain version, timed on the last rank
     beside ``scaled_dot_product_attention`` with the same boolean mask;
 12. the serving main path: zamba2-1.2b at full size (38 layers, seeded
     weights) through ``repro_torch.launch.serve``: 8 requests x 2048-token
     prompts, then 32 greedy tokens, with the launch counts of
     ``flash_attention`` and ``ssd_scan`` read around that one run; finite
     logits, ids in the vocabulary, the cache's length and dtypes; then one
     decode step and one prefill under torch.profiler;
 13. the dense and pure-SSM families (gemma2-27b, qwen2.5-32b, qwen1.5-4b,
     glm4-9b, mamba2-780m) at their smoke() sizes, float32, prefill and 4
     decode steps on the card against the CPU, with the launches of each
     prefill; gemma2-27b at full width cut to 2 layers (one local, one
     global), float32, card against CPU after its conditioning is measured;
 14. ``flash_attention`` at gemma2-27b's two prefill shapes (BH 64, S 8192,
     D 128, group 2, causal, softcap 50, with and without its 4096-token
     window), at the MoE family's (BH 128, S 4096: D 128 for
     deepseek-moe-16b, D 64 and group 2 for granite-moe-1b-a400m), at
     whisper-medium's (BH 128, D 64: the encoder's 1,500 x 1,500 and the
     cross-attention's 416 x 1,500, non-causal; the decoder's causal 416)
     and at llava-next-mistral-7b's (BH 128, S 4096, D 128, group 4), and
     ``ssd_scan`` at mamba2-780m's (B 8, 8 chunks of 256, H 48, P 64, N 128)
     against their plain versions, with the negative control, timed beside
     their bounds, the plain versions and, for attention,
     ``scaled_dot_product_attention`` (the same function at the MoE shapes;
     at gemma2's, without softcap and window, not);
 15. gemma2-27b (46 layers, 2 x 8192-token prompts) and then mamba2-780m (48
     layers, 8 x 2048) served at full size through ``repro_torch.launch.serve``
     with 32 greedy tokens each, as in phase 12, each with its own launch
     counts (46 ``flash_attention`` and 0 ``ssd_scan``; 0 and 48) and its
     peak memory.
 16. the MoE family (deepseek-moe-16b, granite-moe-1b-a400m) at smoke()
     size, float32, prefill and 4 decode steps on the card against the CPU:
     logits, greedy tokens and every layer's routing (experts and keep bits);
 17. deepseek-moe-16b at full width cut to 2 layers, float32, card against
     CPU after its conditioning is measured: routing call by call (a flip
     must lie within 4x the router-logit deviation of the CPU's margin),
     logits before any flip, then each prefill layer from the CPU's input
     (the MoE output compared on the tokens whose routing agrees);
 18. deepseek-moe-16b and then granite-moe-1b-a400m served at full size (8 x
     4096-token prompts, 32 greedy tokens) as in phase 12: 28 and 24
     ``flash_attention`` launches a prefill, the share of expert
     assignments kept at each step, peak memory;
 19. the audio and VLM families (whisper-medium, llava-next-mistral-7b) at
     smoke() size with their frames or patch embeddings, float32, prefill
     and 4 decode steps on the card against the CPU, with the launches of
     each prefill;
 20. whisper-medium at full width cut to 2 encoder and 2 decoder layers
     (all 1,500 frames, a 416-token prompt) and llava-next-mistral-7b cut
     to 2 layers (2,880 patch positions and 192 text tokens), at the full
     models' init scale, B 1, 4 decode steps, float32, card against CPU
     after each one's conditioning is measured: llava's logits within
     ``LLAVA_F32_REL``, each float32 run printed beside its distance from
     a plain float64 forward on the card (``plain_dense_logits``, within
     ``F64_WITNESS_REL``); whisper's encoder output within
     ``WHISPER_ENC_REL`` of its largest value, and its decoder path with
     the CPU's encoder output held on the card within ``WHISPER_F32_REL``
     (the encoder's bf16 roundings make the whole run discontinuous; the
     unheld logits are printed);
 21. whisper-medium (8 x 1,500 frames, 416-token prompts) and then
     llava-next-mistral-7b (4 x 4,096 positions, the first 2,880 patch
     embeddings) served at full size with 32 greedy tokens, as in phase
     12: 72 and 32 ``flash_attention`` launches a prefill, every cache
     entry (whisper's cross K/V included) finite, peak memory;
 22. gradients through the kernels: ``ops.flash_attention``'s Function at
     zamba2's training shape (B 8, S 2048, 32 heads of 64, causal, bf16)
     and granite's (16 heads over 8), ``ops.ssd_scan``'s at zamba2's (B 8,
     8 chunks of 256, H 64, P = N = 64, float32): the forward launches the
     kernel once, every input gradient is nonzero and equals autograd
     straight through the backward's function (``block_attention_jnp``,
     ``ssd_scan_plain``) on the card within a stated limit, and a Function
     whose backward returns zeros is rejected; the forward's and the
     backward's times;
 23. training at smoke() size, every arch, float32 weights: the loss
     and every gradient leaf, card against CPU, with the kernels' launches;
     then one train step's master weights;
 24. zamba2-1.2b (38 layers) and then granite-moe-1b-a400m (24 layers)
     trained at full size: 8 x 2048 tokens a step, seeded weights, AdamW
     and remat at the reference's defaults, a warm-up step and 5 timed
     ones: loss, grad norm, ms and tokens/s of each step, kernel launches
     per step against the layer count and the remat (the recompute
     launches every kernel again), peak memory, granite's kept share of
     expert assignments, one step under torch.profiler;
 25. learnability: qwen1.5-4b at smoke() size, 100 steps on the card, held
     to the two inequalities of the reference's
     ``test_loss_decreases_on_repetitive_stream``;
 26. the checkpoint on the card: zamba2-1.2b at full width cut to 2 layers,
     2 steps, a save through ``CheckpointManager(device="cuda")`` (its
     commit record an OCC transaction on the card, read back through
     ``hybrid_lookup`` and the ``hash_probe`` kernel), every array read
     back bit for bit, then a resumed third step equal to the
     uninterrupted run's.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Without CUDA the script exits
with code 2 and prints no result.
"""
from __future__ import annotations

import contextlib
import functools
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12         # H100 SXM device memory rate (data sheet)
BF16_FLOP_PER_S = 989e12          # dense bf16 tensor-core peak (data sheet)
F32_FLOP_PER_S = 67e12            # float32 peak outside the tensor cores
TF32_FLOP_PER_S = 495e12          # dense TF32 tensor-core peak (data sheet)
# the serving main path: zamba2-1.2b at full size, 8 requests x 2048-token
# prompts, then 32 greedy tokens
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_DECODE = "zamba2-1.2b", 8, 2048, 32
# the dense and pure-SSM families: gemma2-27b at full size over its published
# 8,192-token context, 2 requests, 32 greedy tokens; mamba2-780m, 8 x 2048
DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_DECODE = "gemma2-27b", 2, 8192, 32
SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_DECODE = "mamba2-780m", 8, 2048, 32
# card against CPU: every arch of those families at smoke() size (a prompt
# longer than gemma2's smoke window of 64, three SSD chunks of 32), and
# gemma2-27b at full width cut to 2 layers (one local, one global) with a
# prompt past its 4096-token window, so the local layer's window bites
FAMILY_ARCHS = ("gemma2-27b", "qwen2.5-32b", "qwen1.5-4b", "glm4-9b",
                "mamba2-780m")
SMOKE_PROMPT, SMOKE_DECODE = 96, 4
GEMMA_LAYERS, GEMMA_PROMPT, GEMMA_DECODE = 2, 4608, 4
# the MoE family at full size: deepseek-moe-16b and granite-moe-1b-a400m, 8
# requests x 4,096-token prompts (deepseek's published context), 32 greedy
# tokens; card against CPU at smoke() size (both), and deepseek-moe-16b at
# full width cut to 2 layers, B 1, a 512-token prompt and 4 decode steps
MOE_ARCHS = ("deepseek-moe-16b", "granite-moe-1b-a400m")
MOE_BATCH, MOE_PROMPT, MOE_DECODE = 8, 4096, 32
MOE_LAYERS, MOE_CHECK_PROMPT, MOE_CHECK_DECODE = 2, 512, 4
# the audio and VLM families at full size: whisper-medium, 8 requests x
# 1,500 frames, a 416-token prompt and 32 greedy tokens (448 positions in
# all, its published decoder context n_text_ctx); llava-next-mistral-7b, 4
# requests x 4,096 positions (its 2,880 patch positions, anyres 5 x 576,
# then 1,216 text tokens) and 32 greedy tokens.  Card against CPU at smoke()
# size (both), and each at full width cut to 2 layers (whisper: 2 encoder
# and 2 decoder layers, all 1,500 frames, a 416-token prompt; llava: 2,880
# patch positions and 192 text tokens), B 1, 4 decode steps
AUDIO_VLM_ARCHS = ("whisper-medium", "llava-next-mistral-7b")
WHISPER_BATCH, WHISPER_PROMPT, WHISPER_DECODE = 8, 416, 32
LLAVA_BATCH, LLAVA_PROMPT, LLAVA_DECODE = 4, 4096, 32
CUT_LAYERS, CUT_DECODE = 2, 4
WHISPER_CUT_PROMPT, LLAVA_CUT_TEXT = 416, 192
# card against CPU: zamba2-1.2b at full width cut to 7 layers (one shared
# block application and one tail layer), B 1, 256-token prompt, 4 decode steps
PARITY_LAYERS, PARITY_PROMPT, PARITY_DECODE = 7, 256, 4
# on the card, 7 layers, float32: prefill 224 + 32 teacher-forced decode
# steps against the forward over those 256 tokens (one SSD chunk)
CHECK_PROMPT, CHECK_DECODE = 224, 32
# the main path: fig6's TATP at the paper's 32 nodes, 2**13 subscribers each
# in 2**16 buckets and 2**13 overflow slots a node (73,728 slots); cut from
# 2**15 subscribers in 2**18 + 2**15 slots to keep the script inside its time
# limit on a slow host (population and the membership sweeps are host-bound
# and scale with the slots: 72-78 s and 267-303 s at 2**15, 46 s and 150 s
# at 2**14)
TATP_NODES, TATP_SUBSCRIBERS_PER_NODE, TATP_LANES, TATP_MAX_ROUNDS = \
    32, 2**13, 512, 4
TATP_BUCKETS, TATP_OVERFLOW = 2**16, 2**13
# hash_probe's bandwidth shape (over the TATP arenas) and its largest check
PROBE_LANES = 2**18
# replicated TATP: one backup copy per record on the node ring
REP_F = 1
# the ordered path: range_scan.build_tree at the paper's 32 nodes, 2**13 keys
# each, the scan-heavy mix (90 % scans of 4 keys, gap-key upserts); cut from
# 2**15 to make room for the training phases (its host-bound population took
# 190-215 s at 2**15, 95 s at 2**14)
ORDERED_NODES, ORDERED_KEYS_PER_NODE, ORDERED_LANES, ORDERED_MAX_ROUNDS = \
    32, 2**13, 512, 4
ORDERED_BATCH = 1024              # inserts per node per population round
ORDERED_SCAN_FRAC = 0.9
# training: zamba2-1.2b and granite-moe-1b-a400m at full size, 8 x 2,048
# tokens a step, one warm-up step and 5 timed; the learnability run at
# qwen1.5-4b's smoke() size; the checkpoint at zamba2's full width cut to 2
# layers (~1.9 GB of state on disk)
TRAIN_ARCH, MOE_TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = \
    "zamba2-1.2b", "granite-moe-1b-a400m", 8, 2048, 5
LEARN_ARCH, LEARN_STEPS, CKPT_LAYERS = "qwen1.5-4b", 100, 2
# training limits: the CPU tests' (tests/test_torch_train.py) for float32
# gradients per leaf (of the leaf's largest |grad|) and the float32 loss;
# the kernels' gradients against autograd through the backward's own
# function on the card, of each tensor's largest |grad|
GRAD_REL, LOSS_REL = 5e-3, 1e-5
KGRAD_BF16, KGRAD_F32 = 4 * 2.0 ** -8, 1e-3


@functools.lru_cache(maxsize=None)
def card():
    """The card's name and power limit as nvidia-smi gives them (read once;
    printed beside every time, rate and memory figure of the later
    phases)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


_T0 = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    # every edge the kernel's paths split on: n_words = 0..3 mod 4 and arena
    # bases 0, 4 and 8 B off 16 B (lines at every alignment), M = 1, one CTA
    # and a lane, 8192 and 2**18 lanes, a CTA of dead lanes only
    g = torch.Generator().manual_seed(11)
    N = 4
    for width in (1, 2, 4, 8):
        L = hp.lanes_per_cta(width)
        for r in (1, 2, 3, 4):
            words = 4096 + r
            skew = r % 3                     # the base's words past 16 B
            store = torch.randint(-2**31, 2**31, (N * words + skew,),
                                  generator=g, dtype=torch.int64)
            arenas = store.to(torch.int32).to(dev)[skew:].view(N, words)
            sizes = (1, L + 1, 8192, PROBE_LANES)
            found = []
            for M in sizes:
                args = probe_lanes(arenas, M, width, g)
                want = hp.probe_lines_plain(*args, width=width)
                # the wrapper, then the kernel counting its fast lanes
                n_fast = torch.zeros(1, dtype=torch.int32, device=dev)
                again = hp._launch(*args, width=width, zero_miss=False,
                                   n_fast=n_fast)
                for got in (hp.probe_lines(*args, width=width), again):
                    for a, b, name in zip(got, want, ("found", "version",
                                                      "value", "local_idx")):
                        check(torch.equal(a, b), f"probe_lines {name} != plain"
                              f" (width {width}, n_words {words}, M {M})")
                        pairs.append((a, b))
                found.append(int(got[0].sum()))
                must, may = fast_bounds(args, width)
                check(must <= int(n_fast) <= may, f"width {width}, n_words "
                      f"{words}, M {M}: {int(n_fast)} fast lanes, expected "
                      f"{must}..{may}")
                # the TPU contract on a row view (its base lies 4 * words
                # bytes into the arenas), buckets from the same offsets
                bucket = (sl.u32(args[2]) // (32 * width)).to(torch.int32)
                bucket[: M // 3] = sl.i32(args[2][: M // 3])   # clamped starts
                got = hp.hash_probe(arenas[1], bucket, args[3], args[4],
                                    width=width)
                want = hp.hash_probe_plain(arenas[1], bucket, args[3], args[4],
                                           width=width)
                check(torch.equal(got, want), f"hash_probe != plain (TPU "
                      f"contract, width {width}, n_words {words}, M {M})")
                pairs.append((got, want))
            print(f"path contract width={width} n_words={words}: M {sizes}, "
                  f"found {found}, fast lanes at M={sizes[-1]} (kernel's "
                  f"count) {int(n_fast)} of {may} in bounds", flush=True)
    torch.cuda.synchronize()
    return max_abs_diff(pairs)


def probe_lanes(arenas, M, width, g):
    """M lanes of the dataplane's contract over ``arenas`` (N, words): random
    offsets and ones that end exactly at the arena's last word, cross it,
    wrap through 0 in 32 bits or cross the int32 maximum; ``dest`` -1..N;
    matches planted in half the slot-aligned lanes; 80 % live, 30 % cache
    hits, and lanes L..2L-1 (a whole CTA) dead where M > 2L."""
    import torch
    from repro_torch.core import slots as sl
    from repro_torch.kernels import hash_probe as hp

    N, words = arenas.shape
    line = width * 32
    dev = arenas.device
    r = lambda lo, hi: torch.randint(lo, hi, (M,), generator=g)
    dest = r(-1, N + 1)
    off = r(0, words)
    kind = r(0, 8)
    for k, o in ((1, words - r(0, 48)),               # near the end
                 (2, r(2**31, 2**32)),                # negative as int32
                 (3, (off // 32) * 32),               # slot-aligned
                 (4, torch.full((M,), words - line)), # ends at the last word
                 (5, words - line + r(1, line)),      # crosses the end
                 (6, 2**32 - r(1, line + 1)),         # wraps through 0
                 (7, 2**31 - r(1, line + 1))):        # crosses the int32 max
        off = torch.where(kind == k, o, off)
    s = r(0, width)
    base = off + s * 32
    plant = (torch.rand((M,), generator=g) < 0.5) & (kind == 3) & \
        (dest >= 0) & (dest < N) & (base + 32 <= words)
    key_lo = r(-2**31, 2**31).to(torch.int32)
    key_hi = r(-2**31, 2**31).to(torch.int32)
    live = torch.rand((M,), generator=g) < 0.8
    hit = torch.rand((M,), generator=g) < 0.3
    L = hp.lanes_per_cta(width)
    if M > 2 * L:
        live[L:2 * L] = False
    dest, base, plant = dest.to(dev), base.to(dev), plant.to(dev)
    rows = dest.clamp(0, N - 1).to(torch.int64)
    b = base.clamp(0, words - 2)
    for w_ in (2, 3):                        # version even, lock free
        arenas[rows[plant], b[plant] + w_] = 0
    key_lo = torch.where(plant, arenas[rows, b], key_lo.to(dev))
    key_hi = torch.where(plant, arenas[rows, b + 1], key_hi.to(dev))
    return [arenas, dest.to(torch.int32), sl.i32(off).to(dev), key_lo, key_hi,
            live.to(dev), hit.to(dev)]


def fast_bounds(args, width):
    """(must, may): the dataplane-contract lanes of ``args`` whose line lies
    at least 16 B inside its arena row (the kernel must copy them whole),
    and those whose line is in bounds with no wrap (it may)."""
    from repro_torch.core import slots as sl
    arenas, dest, off, live = args[0], args[1], args[2], args[5]
    N, words = arenas.shape
    o, line = sl.u32(off), 32 * width
    may = live & (dest >= 0) & (dest < N) & (o < 2**31) & (o + line <= words)
    must = may & (o >= 4) & (o + line <= words - 4)
    return int(must.sum()), int(may.sum())


def probe_bound_bytes(n_live, M, width):
    """Bytes hash_probe must move: each live lane's ``width`` x 128 B line
    read once, 18 B of lane inputs read and 117 B of outputs written per
    lane."""
    return n_live * width * 128 + M * (4 * 4 + 2) + M * (1 + 4 + 4 + 4 * 27)


def bandwidth_lanes(arenas, M, width, n_buckets, seed):
    """The bandwidth shape: M live lanes over ``arenas`` (populated), ``dest``
    uniform over the nodes, ``off`` = 32 x a bucket uniform in [0, n_buckets
    - width], half the lanes carrying the key stored at their first slot and
    the rest random keys, cache hits on 30 %."""
    import torch
    g = torch.Generator().manual_seed(seed)
    dev = arenas.device
    N = arenas.shape[0]
    dest = torch.randint(0, N, (M,), generator=g).to(dev)
    off = (32 * torch.randint(0, n_buckets - width + 1, (M,),
                              generator=g)).to(dev)
    stored = (torch.rand((M,), generator=g) < 0.5).to(dev)
    key_lo = torch.randint(-2**31, 2**31, (M,), generator=g).to(dev)
    key_hi = torch.randint(-2**31, 2**31, (M,), generator=g).to(dev)
    row = dest.to(torch.int64)
    key_lo = torch.where(stored, arenas[row, off], key_lo.to(torch.int32))
    key_hi = torch.where(stored, arenas[row, off + 1], key_hi.to(torch.int32))
    live = torch.ones((M,), dtype=torch.bool, device=dev)
    hit = (torch.rand((M,), generator=g) < 0.3).to(dev)
    return [arenas, dest.to(torch.int32), off.to(torch.int32), key_lo,
            key_hi, live, hit]


def probe_shapes(dev, arenas, tatp_args, row, n_buckets):
    """Time hash_probe beside its plain version and its byte bound: at the
    TATP probe shape (``tatp_args``, the kernels line's row), then at the
    bandwidth shape (2**18 live lanes, widths 1 and 4) over the same
    arenas; and the timing floor (a one-element add_).  L2 is flushed before
    each timed call by writing 64 MB (the convention of every time in
    PERF.md), which leaves it full of dirty lines that the call then writes
    back; each kernel time is repeated with a flush that only reads 64 MB,
    and the kernel's count of the lanes it copied whole is read once."""
    import torch
    from repro_torch.core import telemetry as T
    from repro_torch.kernels import hash_probe as hp

    scratch = torch.empty(64 * 2**20 // 4, dtype=torch.int32, device=dev)
    dirty = lambda: scratch.fill_(1)          # evict L2 (50 MB) between calls
    clean = lambda: scratch.max()             # evict it, leaving clean lines
    def ms(fn, n, flush):                     # "mean / p50" of n calls
        t = T.summarize(time_cuda(fn, n, flush))
        return f"{t['mean']:.5f} / {t['p50']:.5f}"
    one = torch.zeros(1, device=dev)
    print(f"timing floor (one-element add_), mean / p50: "
          f"{ms(lambda: one.add_(1), 100, dirty)} ms (64 MB written before "
          f"each), {ms(lambda: one.add_(1), 100, clean)} ms (64 MB read "
          f"before each)", flush=True)
    shapes = [("TATP probe shape", tatp_args, 1)]
    for width in (1, 4):
        shapes.append((f"bandwidth shape width={width}", bandwidth_lanes(
            arenas, PROBE_LANES, width, n_buckets, seed=20 + width), width))
    for name, args, width in shapes:
        got = hp.probe_lines(*args, width=width)
        want = hp.probe_lines_plain(*args, width=width)
        err = max_abs_diff(zip(got, want))
        check(err == 0, f"hash_probe != plain at the {name}")
        n_fast = torch.zeros(1, dtype=torch.int32, device=dev)
        hp._launch(*args, width=width, zero_miss=False, n_fast=n_fast)
        kernel = lambda: hp.probe_lines(*args, width=width)
        k = T.summarize(time_cuda(kernel, 100, dirty))
        plain = lambda: hp.probe_lines_plain(*args, width=width)
        p_ms = T.summarize(time_cuda(plain, 10, dirty))["mean"]
        k_clean = ms(kernel, 100, clean)
        M, live = args[1].shape[0], args[5]
        n_live, fast = int(live.sum()), int(n_fast)
        if args is not tatp_args:              # every lane in bounds
            check(fast == M, f"{fast} of {M} lanes took the fast path at "
                  f"the {name}")
        byts = probe_bound_bytes(n_live, M, width)
        bound_ms = byts / HBM_BYTES_PER_S * 1e3
        print(f"hash_probe at the {name}: M={M} lanes ({n_live} live, "
              f"{int(got[0].sum())} found), kernel {k['mean']:.5f} ms (p50 "
              f"{k['p50']:.5f}, p99 {k['p99']:.5f}; read flush {k_clean}), "
              f"plain {p_ms:.4f} ms, bound {bound_ms:.6f} ms ({byts} B), "
              f"{bound_ms / k['mean']:.3f} of the bound, fast-path share of "
              f"live lanes (kernel's count) {fast / max(n_live, 1):.4f}",
              flush=True)
        if args is tatp_args:
            row.update(ms=k["mean"], plain_ms=p_ms, bound_ms=bound_ms,
                       max_abs_err=max(row["max_abs_err"] or 0, err))
    del scratch


def parity_checks(dev, baseline):
    """The bench gate (``testing.gate.collect``: every key of the baseline,
    the traced TATP smoke), the recorder's host discipline, a B-tree
    membership run and a small TATP mix: card against CPU."""
    import numpy as np
    import torch
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import SimTransport
    from repro_torch.testing import check_trace as ct
    from repro_torch.testing import gate
    from repro_torch.testing import workloads as wl

    keys_c, runs_c = gate.collect(dev)
    keys_h, runs_h = gate.collect("cpu")
    print(f"gate keys (cuda): {json.dumps(keys_c, sort_keys=True)}",
          flush=True)
    check(keys_c == baseline and keys_h == baseline,
          f"gate keys differ from the baseline: cuda {keys_c} cpu {keys_h}")
    for name, x, y in (
            ("gate", runs_c["tx"]["f0"][0], runs_h["tx"]["f0"][0]),
            ("gate f=1", runs_c["tx"]["f1"][0], runs_h["tx"]["f1"][0]),
            ("ordered gate", runs_c["ordered_state"], runs_h["ordered_state"])):
        check(torch.equal(x["arena"].cpu(), y["arena"]),
              f"{name}: CUDA arenas differ from the CPU run")
    check(torch.equal(runs_c["tx"]["f0"][1].committed.cpu(),
                      runs_h["tx"]["f0"][1].committed),
          "gate: commit masks differ")
    (_, doc_c, tel_c), (_, doc_h, tel_h) = runs_c["smoke"], runs_h["smoke"]
    for name, doc in (("cuda", doc_c), ("cpu", doc_h)):
        fails = ct.check_trace(doc)
        check(not fails, f"traced smoke ({name}): check_trace {fails}")
    ev_c, ev_h = T.events(tel_c.trace), T.events(tel_h.trace)
    check(np.array_equal(ev_c, ev_h),
          "traced smoke: the card's trace rows differ from the CPU's")
    lat_c = tel_c.lane_latency_us.cpu().numpy()
    lat_h = tel_h.lane_latency_us.numpy()
    ulps = np.abs(lat_c - lat_h) / np.spacing(np.abs(lat_h))
    check(float(ulps.max()) <= 2,
          f"traced smoke: lane latencies {float(ulps.max())} ulps apart")
    print(f"traced smoke: {tel_c.trace.n} rows equal card == CPU, lane "
          f"latencies within {float(ulps.max())} float32 ulps, both "
          f"exports pass check_trace", flush=True)
    recorder_checks(dev)
    mem = [btree_membership(d) for d in (dev, "cpu")]
    for name, x, y in zip(("rereplicated arenas", "migrated arenas",
                           "rereplication wire", "migration wire",
                           "stale scan_loop"), *mem):
        check(all(torch.equal(a.cpu(), b) for a, b in zip(_tensors(x),
                                                          _tensors(y))),
              f"B-tree membership: the card's {name} differ from the CPU's")
    stale = mem[1][4].round_abort_stale.tolist()
    check(stale[0] > 0 and sum(stale[1:]) == 0
          and bool(mem[1][4].committed.all()),
          f"B-tree membership: stale aborts by round {stale}")
    print(f"B-tree membership (4 nodes, keys above 2**31): rereplication "
          f"{float(mem[0][2].total_bytes)} B, migration "
          f"{float(mem[0][3].total_bytes)} B, stale aborts by round {stale}, "
          f"card == CPU", flush=True)

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


def recorder_checks(dev):
    """The flight recorder reads no value of the card on the host: its
    appends, its latency pricing and a loop's round close run with torch's
    sync debug mode set to raise on any synchronising call."""
    import dataclasses
    import torch
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.transport import WireStats

    n = TATP_NODES
    rec = T.Recorder(T.TelemetryConfig(), T.make_buffer(n, 8, device=dev))
    # round trips 1, messages 2, ops 3, bytes 4 + 5, NIC hits 6, penalty 7
    stats = WireStats(**{f.name: torch.full((), float(i + 1), device=dev)
                         for i, f in enumerate(dataclasses.fields(WireStats))})
    pd = torch.ones((n,), device=dev)
    count = torch.ones((), dtype=torch.int32, device=dev)
    active = torch.ones((n, 4), dtype=torch.bool, device=dev)
    lat = torch.zeros((n, 4), device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rec.set_round(0)
        rec.record(T.PH_READ, stats, n_classes=3, per_dest_msgs=pd,
                   per_dest_bytes=pd)
        rec.record(T.PH_REFRESH, WireStats.zero(dev))
        lat = txl._close_round(rec, 0, lat, active, dict(
            committed=count, attempts=count, abort_lock=count,
            abort_validate=count, abort_overflow=count, abort_stale=count))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ev = T.events(rec.buf)
    want = 1.8 + 7.0 / 3.0 + 9.0 * 8.0e-3 / 100.0   # the READ row alone
    check(ev.shape[0] == 3 and abs(float(lat[0, 0]) - want) < 1e-5,
          f"recorder: rows {ev.shape[0]}, lane latency {float(lat[0, 0])} "
          f"(want {want})")
    print("recorder: appends, pricing and the round close ran under "
          "torch.cuda.set_sync_debug_mode('error') (no host sync)",
          flush=True)


def btree_membership(dev):
    """The CPU tests' B-tree membership scenario on ``dev``: 4 nodes x 32
    leaves, 24 write-only upserts over the whole unsigned key range through
    scan_loop at f=1 routed by the epoch-0 table; kill node 3 -> repair_plan
    -> rereplicate (partitions 2 and 3, keys above 2**31); on a clone of the
    populated tree, migrate partition 2 to node 1, then the same upserts
    again from the stale table.  Returns (rereplicated arenas, migrated
    arenas, rereplication wire, migration wire, the stale run's
    ScanLoopResult), every figure a tensor."""
    import numpy as np
    import torch
    from repro_torch.convert import words
    from repro_torch.core import placement as pl
    from repro_torch.core import replication as repl
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import btree as bt
    from repro_torch.core.transport import SimTransport
    from repro_torch.testing import workloads as wl

    n = 4
    cfg = bt.BTreeConfig(n_nodes=n, n_leaves=32, leaf_width=4)
    layout, t = bt.build_layout(cfg), SimTransport(n)
    rng = np.random.RandomState(29)
    wk = words(rng.randint(0, 2**32, (n, 6, 1), dtype=np.uint32), dev)
    pcfg, rep = pl.PlacementConfig(n, f=1), repl.ReplicaConfig(n, 1)
    table = pl.initial_table(pcfg, device=dev)
    kw = dict(scan_lo=wk[..., 0], scan_hi=wk[..., 0],
              scan_enabled=torch.zeros((n, 6), dtype=torch.bool),
              write_keys=wk, max_rounds=10, rep=rep, ptable=table, pcfg=pcfg,
              device=dev)
    state, _, res = txl.scan_loop(t, bt.init_cluster_state(cfg, device=dev),
                                  cfg, layout, write_values=wl.value_for(wk),
                                  **kw)
    check(bool(res.committed.all()), "B-tree membership: population")
    mig = {"arena": state["arena"].clone()}
    table_r, transfers = pl.repair_plan(pcfg, pl.kill_node(pcfg, table, 3))
    pl.install_local(state, layout, pcfg, table_r, nodes=[0, 1, 2])
    state, s_rr = pl.rereplicate(t, state, cfg, layout, pcfg, transfers)
    _, mig, s_mig, ok = pl.migrate_partition(t, mig, cfg, layout, pcfg,
                                             table, 2, 1)
    check(ok, "B-tree membership: the migration aborted")
    mig, _, stale = txl.scan_loop(t, mig, cfg, layout,
                                  write_values=wl.value_for(wk + 1), **kw)
    return state["arena"], mig["arena"], s_rr, s_mig, stale


def tatp_main_path(dev, rows):
    """Populate TATP_NODES x TATP_SUBSCRIBERS_PER_NODE subscribers, time
    hash_probe at the probe shape and the bandwidth shape over those arenas
    (:func:`probe_shapes`), then run the TATP batch through tx_loop once."""
    import numpy as np
    import torch
    from repro_torch.core import slots as sl
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import SimTransport
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    n_nodes, subs = TATP_NODES, TATP_SUBSCRIBERS_PER_NODE
    lanes, max_rounds = TATP_LANES, TATP_MAX_ROUNDS
    cfg = ht.HashTableConfig(n_nodes=n_nodes, n_buckets=TATP_BUCKETS,
                             bucket_width=1, n_overflow=TATP_OVERFLOW,
                             max_chain=12)
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
    populated = state["arena"].clone()         # the replicated run's start
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
    row = rows["hash_probe"]
    probe_shapes(dev, state["arena"], [state["arena"]] + args, row,
                 cfg.n_buckets)

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
    f0 = dict(stats, round_trips=float(res.round_trips),
              ops_per_tx=float(m.wire.ops) / n_tx)

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
    return dict(stats=f0, cfg=cfg, layout=layout, t=t, res=res,
                populated=populated, batch=(rk, wk, ren, wen, wv))


def _lanes_of(x, n_nodes):
    """Flat per-key tensors (M, ...) as (n_nodes, ceil(M / n_nodes), ...)
    client lanes, padded with zeros, and the mask of the real ones."""
    import torch
    M = x.shape[0]
    B = -(-M // n_nodes)
    pad = torch.zeros((n_nodes * B - M,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    en = torch.arange(n_nodes * B, device=x.device) < M
    return (torch.cat([x, pad]).reshape((n_nodes, B) + x.shape[1:]),
            en.reshape(n_nodes, B))


def replicated_tatp(dev, tatp):
    """The TATP batch through tx_loop at ReplicaConfig(TATP_NODES, REP_F),
    from the arenas the TATP phase populated (population installs primaries
    only; a commit installs its backups), with hash_probe's launches read
    around that one run; its figures beside the unreplicated run's.  Then
    every committed write is read back with every node alive and through
    failover_lookup with every even, then every odd node dead (under the
    ring at f=1 the backups of even primaries sit on odd nodes and vice
    versa): each read finds the record with the committed value words and
    the primary's version, and the primary's and backup's slot images are
    equal but for next_ptr.  Returns the run's figures, its final arenas
    (before the profiled round) and its TxLoopResult; ``tatp["populated"]``
    stays as populated."""
    import torch
    from repro_torch.core import replication as repl
    from repro_torch.core import slots as sl
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.kernels import hash_probe as hp

    cfg, layout, t = tatp["cfg"], tatp["layout"], tatp["t"]
    rk, wk, ren, wen, wv = tatp["batch"]
    f0 = tatp["stats"]
    n_nodes, lanes = TATP_NODES, TATP_LANES
    rep = repl.ReplicaConfig(n_nodes, REP_F)
    state = {"arena": tatp["populated"].clone()}

    torch.cuda.reset_peak_memory_stats()
    hp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, _, res = txl.tx_loop(t, state, cfg, layout, read_keys=rk,
                                write_keys=wk, write_values=wv,
                                read_enabled=ren, write_enabled=wen,
                                max_rounds=TATP_MAX_ROUNDS, rep=rep,
                                device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = hp.launches
    check(launches > 0, "the replicated path launched no hash_probe kernel")
    final = state["arena"].clone()

    n_tx = n_nodes * lanes
    committed = int(res.committed.sum())
    rounds_attempted = int((res.round_attempts > 0).sum())
    m = res.metrics
    keys = ("tx_loop_s", "committed_tx_per_s", "commit_rate", "round_trips",
            "rt_round", "read_rpc_frac", "bytes_per_tx", "ops_per_tx",
            "retries", "max_memory_allocated_gb", "hash_probe_launches")
    stats = {
        "card": card(), "nodes": n_nodes, "f": REP_F, "lanes": lanes,
        "tx_loop_s": wall, "committed_tx_per_s": committed / wall,
        "commit_rate": committed / n_tx,
        "round_trips": float(res.round_trips),
        "rt_round": float(res.round_trips) / max(rounds_attempted, 1),
        "read_rpc_frac": float(m.rpc_fallback) / max(float(m.total), 1.0),
        "bytes_per_tx": float(m.wire.total_bytes) / n_tx,
        "ops_per_tx": float(m.wire.ops) / n_tx,
        "retries": int(res.round_retries.sum()),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "hash_probe_launches": launches,
    }
    print("replicated tatp: " + json.dumps(stats), flush=True)
    print("replicated tatp, the f=0 run beside it: " + json.dumps(
        {k: f0[k] for k in keys if k in f0}), flush=True)
    check(stats["commit_rate"] > 0.5, "replicated TATP commit rate below 0.5")
    check(float(res.round_trips) <= 4.0 * rounds_attempted,
          "replicated schedule exceeded 4 exchanges per round")

    # --- every acknowledged write reads back from both of its copies -------
    item = (wen & res.committed[..., None]).reshape(-1)
    wkeys = wk.reshape(-1, 2)[item]
    wvals = wv.reshape(-1, sl.VALUE_WORDS)[item]
    M = wkeys.shape[0]
    check(M > 0, "no write committed")
    qk, qen = _lanes_of(wkeys, n_nodes)
    qv, _ = _lanes_of(wvals, n_nodes)
    home = ht.home_of(cfg, qk[..., 0], qk[..., 1])[0]
    alive = repl.all_alive(n_nodes, device=dev)
    s0 = layout["slots"].base

    def slot_images(out):
        base = s0 + sl.u32(out["slot_idx"]) * sl.SLOT_WORDS
        idx = base[..., None] + torch.arange(sl.SLOT_WORDS, device=dev)
        rows = out["node"].to(torch.int64).clamp(0, n_nodes - 1)
        return state["arena"][rows[..., None], idx]

    hp.launches = 0
    reads = {}
    for name, dead in (("all alive", None), ("evens dead", 0),
                       ("odds dead", 1)):
        al = alive if dead is None else repl.kill_node(
            alive, torch.arange(dead, n_nodes, 2, device=dev))
        out = repl.failover_lookup(t, state, qk[..., 0], qk[..., 1], cfg,
                                   layout, rep, al, enabled=qen)
        served = home if dead is None else torch.where(
            home % 2 == dead, (home + 1) % n_nodes, home)
        check(bool((out["found"] | ~qen).all()),
              f"replicated tatp ({name}): a committed write was not found")
        check(bool(((out["value"] == qv).all(-1) | ~qen).all()),
              f"replicated tatp ({name}): a read returned other value words")
        check(bool(((out["node"] == served) | ~qen).all()),
              f"replicated tatp ({name}): a read was served by the wrong copy")
        reads[name] = out
    prim = reads["all alive"]
    check(bool((((prim["version"] & 1) == 0) | ~qen).all()),
          "replicated tatp: a committed record has an odd version")
    keep = [j for j in range(sl.SLOT_WORDS) if j != sl.NEXT_PTR]
    pimg = slot_images(prim)[..., keep]
    for name, dead in (("evens dead", 0), ("odds dead", 1)):
        out = reads[name]
        mine = qen & (home % 2 == dead)         # served by the backup here
        check(bool(((out["version"] == prim["version"]) | ~qen).all()),
              f"replicated tatp ({name}): a copy has another version")
        same_img = (slot_images(out)[..., keep] == pimg).all(-1)
        check(bool((same_img | ~mine).all()),
              f"replicated tatp ({name}): backup slot image != primary's")
    print(f"replicated tatp: {M} committed writes read back from primary "
          f"and backup (slot images equal but next_ptr), hash_probe "
          f"launches in the three fail-over reads: {hp.launches}",
          flush=True)

    # --- where the time goes: one more replicated protocol round ----------
    profile_round(lambda: txl.tx_loop(
        t, state, cfg, layout, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen, max_rounds=1, rep=rep,
        device=dev), label="replicated tatp")
    return dict(stats=stats, final=final, res=res)


def same_run(a, b):
    """Two tx_loop / scan_loop results agree: committed lanes, commit
    rounds, every WireStats field and the round trips."""
    import torch
    from repro_torch.core.transport import WireStats
    wa, wb = a.metrics.wire, b.metrics.wire
    return (torch.equal(a.committed, b.committed)
            and torch.equal(a.commit_round, b.commit_round)
            and all(torch.equal(getattr(wa, f), getattr(wb, f))
                    for f in WireStats.__dataclass_fields__)
            and torch.equal(a.round_trips, b.round_trips))


def check_trace_of(tel, res, what, cfg=None):
    """A loop's flight-recorder output against its result: nothing
    dropped, SUMMARY rows equal to the ``round_*`` columns, per-destination
    tails summing to each row's scalars and the rows' wire to the result's
    WireStats (float64 within a relative 1e-6: float32 counts stop being
    exact integers at 2**24), and an export that passes check_trace.
    Returns (host rows, export document)."""
    import numpy as np
    from repro_torch.core import telemetry as T
    from repro_torch.testing import check_trace as ct

    tr = tel.trace
    check(tr.dropped == 0, f"{what}: the trace dropped {tr.dropped} events")
    ev = T.events(tr).astype(np.float64)
    nd = tr.n_dst
    summ = ev[ev[:, T.EV_PHASE] == T.PH_SUMMARY]
    for col, name in ((T.EV_COMMITTED, "committed"),
                      (T.EV_ATTEMPTS, "attempts"),
                      (T.EV_AB_LOCK, "abort_lock"),
                      (T.EV_AB_VALIDATE, "abort_validate"),
                      (T.EV_AB_OVERFLOW, "abort_overflow"),
                      (T.EV_AB_STALE, "abort_stale")):
        want = getattr(res, f"round_{name}").cpu().numpy()
        check(np.array_equal(summ[:, col], want),
              f"{what}: SUMMARY {name} {summ[:, col]} != {want}")
    close = lambda x, y: bool(np.all(np.abs(x - y) <= 1e-6 * np.maximum(
        1.0, np.abs(y))))
    byts = ev[:, T.EV_REQ_BYTES] + ev[:, T.EV_REPLY_BYTES]
    w = res.metrics.wire
    check(close(ev[:, T.EV_WORDS:T.EV_WORDS + nd].sum(1), ev[:, T.EV_MSGS])
          and close(ev[:, T.EV_WORDS + nd:].sum(1), byts),
          f"{what}: per-destination tails do not reconcile")
    check(close(ev[:, T.EV_MSGS].sum(), float(w.messages))
          and close(byts.sum(), float(w.total_bytes))
          and close(ev[:, T.EV_OPS].sum(), float(w.ops))
          and ev[:, T.EV_RT].sum() == float(res.round_trips),
          f"{what}: the trace's wire differs from the result's")
    doc = T.export_trace(tr)
    fails = ct.check_trace(doc)
    check(not fails, f"{what}: check_trace {fails[:3]}")
    return ev, doc


def traced_tatp(dev, tatp, rep_run):
    """The TATP batch at full width with the flight recorder, at f=0 and
    f=1, each from a clone of the populated arenas: untraced, traced,
    traced, untraced (wall times in turns).  Each traced run equals its
    untraced run (arenas, commits, commit rounds, WireStats, round trips,
    hash_probe launches) and the main path's / replicated phase's run; its
    trace drops nothing, its SUMMARY rows are the result's round columns,
    its tails reconcile and its export passes check_trace."""
    import torch
    from repro_torch.core import replication as repl
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.kernels import hash_probe as hp

    cfg, layout, t = tatp["cfg"], tatp["layout"], tatp["t"]
    rk, wk, ren, wen, wv = tatp["batch"]
    kw = dict(read_keys=rk, write_keys=wk, write_values=wv, read_enabled=ren,
              write_enabled=wen, max_rounds=TATP_MAX_ROUNDS, device=dev)
    for f, ref in ((0, tatp["res"]), (REP_F, rep_run["res"])):
        rep = repl.ReplicaConfig(TATP_NODES, f)
        runs, walls = {}, {"untraced": [], "traced": []}
        for name in ("untraced", "traced", "traced", "untraced"):
            st = {"arena": tatp["populated"].clone()}
            tel = T.TelemetryConfig() if name == "traced" else None
            hp.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = txl.tx_loop(t, st, cfg, layout, rep=rep, telemetry=tel, **kw)
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
            runs.setdefault(name, (out, hp.launches))
            del st, out
        (st0, _, r0), l0 = runs["untraced"]
        (st1, _, r1, tel), l1 = runs["traced"]
        what = f"traced tatp (f={f})"
        check(torch.equal(st1["arena"], st0["arena"]),
              f"{what}: the arenas differ from the untraced run's")
        check(same_run(r1, r0) and same_run(r0, ref),
              f"{what}: the run differs from the untraced run")
        check(l1 == l0 > 0, f"{what}: {l1} hash_probe launches, untraced {l0}")
        check(tel.trace.capacity == 10 * TATP_MAX_ROUNDS + 4,
              f"{what}: capacity {tel.trace.capacity}")
        _, doc = check_trace_of(tel, r1, what)
        print(f"{what}: " + json.dumps({
            "card": card(), "rows": tel.trace.n,
            "capacity": tel.trace.capacity, "dropped": tel.trace.dropped,
            "hash_probe_launches": l1,
            "modeled_span_us": doc["otherData"]["modeled_span_us"],
            "latency_by_path": T.latency_by_path(
                tel.lane_latency_us, r1.committed, r1.commit_round),
            "tx_loop_s_untraced_traced_traced_untraced": [
                walls["untraced"][0], walls["traced"][0],
                walls["traced"][1], walls["untraced"][1]]}), flush=True)
        del runs, st0, st1


@contextlib.contextmanager
def counted_refreshes():
    """The WireStats of every placement-table refresh issued inside the
    block (txloop refreshes through ``placement.refresh_table``, entering
    the read in every retry round gated by its stale aborts: a gated-off
    read sends nothing and is dropped from the list when the block
    ends)."""
    from repro_torch.core import placement as pl
    calls, orig = [], pl.refresh_table

    def counted(*args, **kw):
        out = orig(*args, **kw)
        calls.append(out[1])
        return out
    pl.refresh_table = counted
    try:
        yield calls
    finally:
        pl.refresh_table = orig
        calls[:] = [c for c in calls if float(c.ops) > 0]


def node_records(cfg, layout, arena, node, part=None):
    """Node ``node``'s present slots (of partition ``part``, default all) as
    (64-bit keys sorted, their slot images)."""
    import torch
    from repro_torch.core import slots as sl
    from repro_torch.core.datastructs import hashtable as ht
    s0 = layout["slots"].base
    slots = arena[node, s0:s0 + cfg.n_slots * sl.SLOT_WORDS].view(
        cfg.n_slots, sl.SLOT_WORDS)
    keep = slots[:, sl.KEY_LO] != sl.EMPTY_KEY
    if part is not None:
        keep &= ht.part_of(cfg, slots[:, sl.KEY_LO], slots[:, sl.KEY_HI]) \
            == part
    rows = slots[keep]
    key = (sl.u32(rows[:, sl.KEY_LO]) << 32) | sl.u32(rows[:, sl.KEY_HI])
    order = torch.argsort(key)
    return key[order], rows[order]


def held_by(cfg, layout, arena, node, key, rows):
    """(L,) bool: node ``node`` holds each record (key, slot image) with an
    equal key, version and value words."""
    import torch
    from repro_torch.core import slots as sl
    k2, r2 = node_records(cfg, layout, arena, node)
    if k2.numel() == 0:
        return torch.zeros(key.shape, dtype=torch.bool, device=key.device)
    pos = torch.searchsorted(k2, key).clamp(max=k2.numel() - 1)
    cols = [sl.KEY_LO, sl.KEY_HI, sl.VERSION] + list(range(sl.VALUE0,
                                                          sl.SLOT_WORDS))
    return (k2[pos] == key) & (r2[pos][:, cols] == rows[:, cols]).all(-1)


def read_back(t, cfg, layout, state, table, wk, wv, served, what):
    """Every write (keys wk (M, 2), values wv (M, V)) reads back through
    placement.failover_lookup under ``table``, found with its value words
    and served by node ``served`` (M,); returns hash_probe's launches."""
    from repro_torch.core import placement as pl
    from repro_torch.kernels import hash_probe as hp
    qk, qen = _lanes_of(wk, cfg.n_nodes)
    qv, _ = _lanes_of(wv, cfg.n_nodes)
    qs, _ = _lanes_of(served, cfg.n_nodes)
    before = hp.launches
    out = pl.failover_lookup(t, state, cfg, layout, table, qk[..., 0],
                             qk[..., 1], enabled=qen)
    check(bool((out["found"] | ~qen).all()),
          f"membership ({what}): a committed write was not found")
    check(bool(((out["value"] == qv).all(-1) | ~qen).all()),
          f"membership ({what}): a read returned other value words")
    check(bool(((out["node"] == qs) | ~qen).all()),
          f"membership ({what}): a read was served by the wrong copy")
    return hp.launches - before


def membership_path(dev, tatp, rep_run):
    """Membership at the TATP main path's size: (1) the TATP batch through
    tx_loop at f=1 routed through the epoch-0 placement table, from the
    populated arenas, against the replicated phase's run; (2) kill node 1,
    repair_plan, rereplicate, and read every committed write back from the
    new owner and the new backup; (3) migrate partition 0 to node 3 on a
    clone of (1)'s arenas and run the TATP batch from the stale table: one
    refresh, then commits at the new owner."""
    import torch
    from repro_torch.core import placement as pl
    from repro_torch.core import replication as repl
    from repro_torch.core import slots as sl
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.kernels import hash_probe as hp

    cfg, layout, t = tatp["cfg"], tatp["layout"], tatp["t"]
    rk, wk, ren, wen, wv = tatp["batch"]
    n_nodes = cfg.n_nodes
    n_tx = wk.shape[0] * wk.shape[1]
    rep = repl.ReplicaConfig(n_nodes, REP_F)
    pcfg = pl.PlacementConfig(n_nodes, f=REP_F)
    table = pl.initial_table(pcfg, device=dev)
    kw = dict(read_keys=rk, write_keys=wk, write_values=wv, read_enabled=ren,
              write_enabled=wen, max_rounds=TATP_MAX_ROUNDS, rep=rep,
              device=dev)
    out = {"card": card(), "nodes": n_nodes, "f": REP_F,
           "slots_per_node": cfg.n_slots}

    # --- (1) epoch-stable: the replicated run again, through the table ----
    state = {"arena": tatp["populated"].clone()}
    hp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counted_refreshes() as refreshes:
        state, _, res = txl.tx_loop(t, state, cfg, layout, ptable=table,
                                    pcfg=pcfg, **kw)
    torch.cuda.synchronize()
    out["stable_tx_loop_s"] = time.perf_counter() - t0
    out["stable_hash_probe_launches"] = hp.launches
    r0, w0, w1 = rep_run["res"], rep_run["res"].metrics.wire, res.metrics.wire
    check(torch.equal(state["arena"], rep_run["final"]),
          "membership: the epoch-stable run's arenas differ from the "
          "replicated run's")
    check(torch.equal(res.committed, r0.committed),
          "membership: the epoch-stable run committed other lanes")
    check(all(float(getattr(w1, f)) == float(getattr(w0, f)) for f in (
        "round_trips", "messages", "ops", "req_bytes", "reply_bytes"))
          and float(res.round_trips) == float(r0.round_trips),
          "membership: the epoch-stable run's wire differs")
    check(not refreshes and int(res.round_abort_stale.sum()) == 0,
          "membership: the epoch-stable run refreshed or aborted stale")
    check(hp.launches == rep_run["stats"]["hash_probe_launches"] > 0,
          f"membership: {hp.launches} hash_probe launches in the stable run")
    out.update(stable_round_trips=float(res.round_trips),
               stable_bytes_per_tx=float(w1.total_bytes) / n_tx,
               stable_commit_rate=float(res.committed.float().mean()))
    item = (wen & res.committed[..., None]).reshape(-1)
    cwk, cwv = wk.reshape(-1, 2)[item], wv.reshape(-1, sl.VALUE_WORDS)[item]
    cpart = ht.part_of(cfg, cwk[:, 0], cwk[:, 1])
    mig = {"arena": state["arena"].clone()}        # step (3) starts here

    # --- (2) kill node 1 -> repair_plan -> rereplicate ---------------------
    dead = 1
    table_r, transfers = pl.repair_plan(pcfg, pl.kill_node(pcfg, table, dead))
    check(transfers == [(0, 0, 2), (1, 2, 3)],
          f"membership: repair transfers {transfers}")
    k0, rows0 = node_records(cfg, layout, state["arena"], 0, part=0)
    k1, _ = node_records(cfg, layout, state["arena"], dead, part=dead)
    k2, _ = node_records(cfg, layout, state["arena"], 2, part=dead)
    lost = int((~torch.isin(k1, k2)).sum())
    state["arena"][dead] = 0xDEAD
    pl.install_local(state, layout, pcfg, table_r,
                     nodes=[n for n in range(n_nodes) if n != dead])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, s_rr = pl.rereplicate(t, state, cfg, layout, pcfg, transfers)
    torch.cuda.synchronize()
    out.update(
        rereplicate_s=time.perf_counter() - t0, transfers=transfers,
        records_streamed=int(s_rr.ops) - len(transfers) * cfg.n_slots,
        rereplication_bytes=float(s_rr.total_bytes),
        lost_at_f0=lost)
    check(bool(held_by(cfg, layout, state["arena"], 2, k0, rows0).all()),
          "membership: a record of partition 0 did not reach node 2")
    cps = table_r.copies.cpu().tolist()
    launches = 0
    for p in (0, 1):
        m = cpart == p
        own, bk = cps[p][0], cps[p][1]
        launches += read_back(t, cfg, layout, state, table_r, cwk[m], cwv[m],
                              torch.full_like(cpart[m], own), f"part {p}")
        launches += read_back(t, cfg, layout, state,
                              pl.kill_node(pcfg, table_r, own), cwk[m],
                              cwv[m], torch.full_like(cpart[m], bk),
                              f"part {p}, owner dead")
    check(launches > 0, "membership: the fail-over reads launched no "
          "hash_probe kernel")
    out.update(readback_writes=int((cpart < 2).sum()),
               readback_hash_probe_launches=launches)
    del state

    # --- (3) migrate partition 0 -> node 3, then the stale-table batch ----
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table_m, mig, s_mig, ok = pl.migrate_partition(t, mig, cfg, layout, pcfg,
                                                   table, 0, 3)
    torch.cuda.synchronize()
    out.update(migrate_s=time.perf_counter() - t0,
               migration_bytes=float(s_mig.total_bytes))
    check(ok, "membership: the uncontended migration aborted")
    k0, rows0 = node_records(cfg, layout, mig["arena"], 0, part=0)
    k3, rows3 = node_records(cfg, layout, mig["arena"], 3, part=0)
    check(torch.equal(k0, k3) and bool(held_by(cfg, layout, mig["arena"], 3,
                                               k0, rows0).all()),
          "membership: partition 0 on node 3 differs from node 0's")
    s0 = layout["slots"].base
    locks = mig["arena"][0, s0:s0 + cfg.n_slots * sl.SLOT_WORDS].view(
        cfg.n_slots, sl.SLOT_WORDS)[:, sl.LOCK]
    check(int((locks != 0).sum()) == 0, "membership: a lock left on node 0")
    rb = layout["routing"].base
    for n in range(n_nodes):
        got = pl.decode_region(pcfg, mig["arena"][n, rb:rb + pl.routing_words(
            n_nodes)])
        check(int(got.epoch) == int(table_m.epoch)
              and torch.equal(got.copies, table_m.copies)
              and torch.equal(got.alive, table_m.alive),
              f"membership: node {n}'s routing region is not the new table")
    hits0 = wen[..., 0] & (ht.part_of(cfg, wk[..., 0, 0], wk[..., 0, 1]) == 0)
    pre = {"arena": mig["arena"].clone()}          # the traced batch's start
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with counted_refreshes() as refreshes:
        mig, _, res = txl.tx_loop(t, mig, cfg, layout, ptable=table,
                                  pcfg=pcfg, **kw)
    torch.cuda.synchronize()
    stale = res.round_abort_stale.cpu().tolist()
    out.update(stale_tx_loop_s=time.perf_counter() - t0,
               stale_aborts_by_round=stale,
               stale_round_trips=float(res.round_trips),
               stale_commit_rate=float(res.committed.float().mean()),
               refresh_reads=[int(s.ops) for s in refreshes])
    check(stale[0] == int(hits0.sum()) > 0 and sum(stale[1:]) == 0,
          f"membership: stale aborts by round {stale}, "
          f"{int(hits0.sum())} lanes write partition 0")
    check(bool(res.committed[hits0].all())
          and bool((res.commit_round[hits0] > 0).all()),
          "membership: a stale-routed lane did not commit after the refresh")
    words = pl.routing_words(n_nodes)
    check(len(refreshes) == 1 and int(refreshes[0].ops) == n_nodes
          and float(refreshes[0].reply_bytes) == 4.0 * (
              n_nodes * words + float(refreshes[0].messages) / 2),
          f"membership: refreshes {[(float(s.ops), float(s.reply_bytes)) for s in refreshes]}")
    out["refresh_words_per_client"] = words

    # --- the stale batch again, with the flight recorder --------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pre, _, res_t, tel = txl.tx_loop(t, pre, cfg, layout, ptable=table,
                                     pcfg=pcfg, telemetry=T.TelemetryConfig(),
                                     **kw)
    torch.cuda.synchronize()
    out["stale_traced_tx_loop_s"] = time.perf_counter() - t0
    check(torch.equal(pre["arena"], mig["arena"]) and same_run(res_t, res),
          "membership: the traced stale batch differs from the untraced one")
    ev, _ = check_trace_of(tel, res_t, "traced stale batch")
    ref = ev[ev[:, T.EV_PHASE] == T.PH_REFRESH]
    wired = ref[:, T.EV_RT] > 0
    check(ref[:, T.EV_ROUND].tolist() == list(range(TATP_MAX_ROUNDS))
          and wired.tolist() == [r == 1 for r in range(TATP_MAX_ROUNDS)]
          and ref[1, T.EV_OPS] == n_nodes
          and bool((ref[~wired][:, T.EV_RT:] == 0).all()),
          f"membership: the traced stale batch's REFRESH rows "
          f"{ref[:, :T.EV_WORDS].tolist()}")
    out["stale_trace_rows"] = tel.trace.n
    del pre
    item = (wen & res.committed[..., None]).reshape(-1)
    mwk, mwv = wk.reshape(-1, 2)[item], wv.reshape(-1, sl.VALUE_WORDS)[item]
    m = ht.part_of(cfg, mwk[:, 0], mwk[:, 1]) == 0
    check(bool(m.any()), "membership: no write to partition 0 committed")
    read_back(t, cfg, layout, mig, table_m, mwk[m], mwv[m],
              torch.full((int(m.sum()),), 3, dtype=torch.int32, device=dev),
              "migrated partition")
    read_back(t, cfg, layout, mig, pl.kill_node(pcfg, table_m, 3), mwk[m],
              mwv[m], torch.zeros((int(m.sum()),), dtype=torch.int32,
                                  device=dev), "migrated partition's backup")
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print("membership: " + json.dumps(out), flush=True)
    return out


def ordered_path(dev):
    """range_scan.build_tree at ORDERED_NODES x ORDERED_KEYS_PER_NODE keys
    (both trees of every node on the card), a pure-scan batch against a
    numpy sorted-array reference, then scan_loop over the scan-heavy mix at
    f=0 and f=1 from clones of the one tree, with the checks of the module
    docstring."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy
    from repro_torch.core import placement as pl
    from repro_torch.core import replication as repl
    from repro_torch.core import slots as sl
    from repro_torch.core import telemetry as T
    from repro_torch.core import tx as txm
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import btree as bt
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    n_nodes, lanes = ORDERED_NODES, ORDERED_LANES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cfg, layout, t, state, allk, meta = wl.build_tree(
        n_nodes, n_keys=ORDERED_KEYS_PER_NODE, seed=3, batch=ORDERED_BATCH,
        device=dev)
    torch.cuda.synchronize()
    pop_s = time.perf_counter() - t0
    nleaf = state["arena"][:, layout["nleaf"].base]
    print("ordered: " + json.dumps({
        "card": card(), "nodes": n_nodes, "keys": int(allk.size),
        "leaf_width": cfg.leaf_width, "n_leaves": cfg.n_leaves,
        "max_scan_leaves": cfg.max_scan_leaves,
        "arena_gb": state["arena"].numel() * 4 / 1e9,
        "population_s": pop_s, "insert_batch": ORDERED_BATCH,
        "leaves_per_node_mean": float(nleaf.float().mean()),
        "leaves_per_node_max": int(nleaf.max())}), flush=True)

    # --- a pure-scan batch against the sorted key array --------------------
    lo, hi, _, _ = wl.scan_workload(allk, n_nodes, lanes, scan_frac=1.0,
                                    seed=9, device=dev)
    _, res = txm.run_scan_transactions(t, state, cfg, layout, scan_lo=lo,
                                       scan_hi=hi, meta=meta)
    check(bool(res.committed.all()) and not bool(res.truncated.any()),
          "ordered: a pure scan did not commit")
    start = np.searchsorted(allk, to_numpy(lo).astype(np.uint64))
    want = allk[start[..., None] + np.arange(wl.SPAN)]
    check(bool((want[..., -1] == to_numpy(hi)).all()), "ordered: scan bounds")
    msk = res.scan_mask.reshape(n_nodes, lanes, -1)
    got = torch.where(msk, sl.u32(res.scan_keys).reshape(msk.shape), 1 << 33)
    got = got.sort(dim=-1).values[..., :wl.SPAN]
    check(bool((msk.sum(-1) == wl.SPAN).all())
          and np.array_equal(got.cpu().numpy(), want.astype(np.int64)),
          "ordered: a pure scan returned other keys than the sorted array")
    vm = res.scan_mask
    check(bool((res.scan_values[vm] == wl.value_for(res.scan_keys)[vm]).all()),
          "ordered: a scanned record carries other value words")
    print(f"ordered: pure-scan batch of {n_nodes * lanes} lanes equals the "
          f"sorted-array reference ({wl.SPAN} keys and their values each)",
          flush=True)

    # --- the scan-heavy mix at f=0 and f=1 from clones of one tree ----------
    lo, hi, wk, wen = wl.scan_workload(allk, n_nodes, lanes,
                                       scan_frac=ORDERED_SCAN_FRAC, seed=7,
                                       device=dev)
    wv = wl.value_for(wk)
    n_tx = n_nodes * lanes
    pre = state["arena"].clone()              # the traced runs' start
    runs, runs_wall = {}, {}
    for f in (0, REP_F):
        st = {"arena": state["arena"].clone()} if f == 0 else state
        torch.cuda.reset_peak_memory_stats()
        hp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, r = txl.scan_loop(
            t, st, cfg, layout, scan_lo=lo, scan_hi=hi, meta=meta,
            write_keys=wk, write_values=wv, write_enabled=wen,
            max_rounds=ORDERED_MAX_ROUNDS,
            rep=repl.ReplicaConfig(n_nodes, f), device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        m = r.metrics
        rounds_attempted = int((r.round_attempts > 0).sum())
        committed = int(r.committed.sum())
        stats = {
            "card": card(), "f": f, "lanes": lanes,
            "scan_frac": ORDERED_SCAN_FRAC, "scan_loop_s": wall,
            "committed_tx_per_s": committed / wall,
            "commit_rate": committed / n_tx,
            "round_trips": float(r.round_trips),
            "rt_round": float(r.round_trips) / max(rounds_attempted, 1),
            "onesided_frac": float(m.onesided_success) / max(float(m.total),
                                                             1.0),
            "aborts": {k: int(getattr(r, f"round_abort_{k}").sum())
                       for k in ("lock", "validate", "overflow", "stale")},
            "retries": int(r.round_retries.sum()),
            "truncated": int(r.truncated.sum()),
            "bytes_per_tx": float(m.wire.total_bytes) / n_tx,
            "ops_per_tx": float(m.wire.ops) / n_tx,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
            "hash_probe_launches": hp.launches,
        }
        print("ordered scan mix: " + json.dumps(stats), flush=True)
        runs[f] = (st, r)
        runs_wall[f] = wall
    (s0, r0), (s1, r1) = runs[0], runs[REP_F]
    check(float(r1.round_trips) == float(r0.round_trips),
          "ordered: f=1 took other round trips than f=0")
    check(torch.equal(r1.committed, r0.committed),
          "ordered: f=1 committed other lanes than f=0")
    check(not bool(r0.truncated.any() | r1.truncated.any()),
          "ordered: a scan lane was truncated")
    check(float(r1.committed.float().mean()) > 0.5,
          "ordered: commit rate below 0.5")
    bb, pb = layout["bleaves"].base, layout["pbounds"].base
    check(torch.equal(s0["arena"][:, :bb], s1["arena"][:, :bb])
          and torch.equal(s0["arena"][:, pb:], s1["arena"][:, pb:]),
          "ordered: the primary trees differ between f=0 and f=1")

    # --- every committed upsert reads back from primary and backup tree ----
    item = (wen[..., 0] & r1.committed).reshape(-1)
    ukeys = wk.reshape(-1)[item]
    M = ukeys.shape[0]
    check(M > 0, "ordered: no upsert committed")
    distinct = np.unique(to_numpy(ukeys))
    bview = s1["arena"][:, bb:bb + cfg.n_leaves * cfg.leaf_words].view(
        n_nodes, cfg.n_leaves, cfg.leaf_slots, sl.SLOT_WORDS)
    bcount = torch.where(
        torch.arange(cfg.n_leaves, device=dev)[None]
        < s1["arena"][:, layout["bnleaf"].base][:, None],
        bview[:, :, 0, sl.VALUE0], 0).sum()
    check(int(bcount) == distinct.size, f"ordered: {int(bcount)} records in "
          f"the backup trees for {distinct.size} committed keys")
    qk, qen = _lanes_of(ukeys, n_nodes)
    home = bt.home_of(cfg, qk)
    alive = repl.all_alive(n_nodes, device=dev)
    for name, dead in (("all alive", None), ("evens dead", 0),
                       ("odds dead", 1)):
        al = alive if dead is None else repl.kill_node(
            alive, torch.arange(dead, n_nodes, 2, device=dev))
        table = pl.table_from_replica(repl.ReplicaConfig(n_nodes, REP_F), al)
        out = pl.failover_lookup(t, s1, cfg, layout, table, qk,
                                 torch.zeros_like(qk), ds=bt, enabled=qen)
        served = home if dead is None else torch.where(
            home % 2 == dead, (home + 1) % n_nodes, home)
        check(bool((out["found"] | ~qen).all())
              and bool(((out["value"] == wl.value_for(qk)).all(-1)
                        | ~qen).all())
              and bool(((out["node"] == served) | ~qen).all()),
              f"ordered ({name}): a committed upsert did not read back")

    # --- every partition's fence chain is sorted and linked ----------------
    chain = np.concatenate([np.asarray(wl.fence_chain_keys(
        cfg, layout, s1["arena"], n), np.int64) for n in range(n_nodes)])
    check(np.array_equal(chain, np.union1d(allk.astype(np.int64),
                                           distinct.astype(np.int64))),
          "ordered: the fence chains do not hold exactly the committed keys")
    print(f"ordered: {M} committed upserts ({distinct.size} keys) read back "
          f"from the primary trees and, with every even and then every odd "
          f"node dead, from the backup trees; {n_nodes} fence chains sorted "
          f"and linked over {chain.size} keys", flush=True)

    # --- the mix at f=0 again with the flight recorder: with the directory
    # given, and fetched up front (meta=None, a REFRESH row of round -1) ----
    kw = dict(scan_lo=lo, scan_hi=hi, write_keys=wk, write_values=wv,
              write_enabled=wen, max_rounds=ORDERED_MAX_ROUNDS,
              rep=repl.ReplicaConfig(n_nodes, 0),
              telemetry=T.TelemetryConfig(), device=dev)
    traced = {}
    for name, m in (("given", meta), ("fetched", None)):
        st = {"arena": pre.clone()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, _, r, tel = txl.scan_loop(t, st, cfg, layout, meta=m, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(torch.equal(st["arena"], s0["arena"])
              and torch.equal(r.committed, r0.committed)
              and torch.equal(r.commit_round, r0.commit_round),
              f"ordered: the traced mix ({name} directory) differs from the "
              f"untraced f=0 run")
        ev, doc = check_trace_of(tel, r, f"traced scan mix ({name})")
        traced[name] = (r, ev, wall, doc["otherData"]["modeled_span_us"])
        del st
    del pre
    (r_g, ev_g, wall_g, span_g), (r_f, ev_f, wall_f, _) = (
        traced["given"], traced["fetched"])
    check(same_run(r_g, r0), "ordered: the traced scan mix differs from the "
          "untraced f=0 run")
    fetch = ev_f[ev_f[:, T.EV_ROUND] < 0]
    check(len(fetch) == 1 and fetch[0, T.EV_PHASE] == T.PH_REFRESH
          and fetch[0, T.EV_RT] == 1 and not (ev_g[:, T.EV_ROUND] < 0).any()
          and float(r_f.round_trips) == float(r0.round_trips) + 1,
          f"ordered: the up-front fetch's row {fetch.tolist()}")
    for name, ev in (("given", ev_g), ("fetched", ev_f)):
        d = ev[(ev[:, T.EV_PHASE] == T.PH_REFRESH) & (ev[:, T.EV_ROUND] >= 0)]
        check(d[:, T.EV_ROUND].tolist() == list(range(ORDERED_MAX_ROUNDS))
              and bool((d[0, T.EV_RT:] == 0).all())
              and bool((d[1:, T.EV_RT:] == fetch[0, T.EV_RT:]).all()),
              f"ordered ({name} directory): the directory-refresh rows "
              f"{d[:, :T.EV_WORDS].tolist()}")
    print("ordered, traced scan mix (f=0): " + json.dumps({
        "card": card(), "rows": len(ev_g), "modeled_span_us": span_g,
        "scan_loop_s_traced": wall_g, "scan_loop_s_traced_fetched": wall_f,
        "scan_loop_s_untraced": runs_wall[0],
        "refresh_row_bytes": float(fetch[0, T.EV_REQ_BYTES]
                                   + fetch[0, T.EV_REPLY_BYTES])}),
        flush=True)

    # --- where the time goes: one more round of the mix --------------------
    profile_round(lambda: txl.scan_loop(
        t, s0, cfg, layout, scan_lo=lo, scan_hi=hi, meta=meta, write_keys=wk,
        write_values=wv, write_enabled=wen, max_rounds=1,
        rep=repl.ReplicaConfig(n_nodes, 0), device=dev), label="ordered")


# ---------------------------------------------------------------------------
# the serving path's kernels: flash_attention and ssd_scan
# ---------------------------------------------------------------------------
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype): the TPU kernel's
# contract (tests/test_kernels.py's cases and more) and the serving shape
# ---------------------------------------------------------------------------
# The mesh dataplane: MeshTransport over torch.distributed, one node a rank.
# NCCL at world size 1 (the production backend), then four ranks sharing the
# one card over gloo with CUDA tensors (NCCL refuses two ranks on one
# device): TATP at MESH_NODES x MESH_SUBSCRIBERS, then the sharded
# model branches at full width.
# ---------------------------------------------------------------------------
MESH_NODES, MESH_LANES = 4, 512
MESH_DEADLINE_S = 400          # every world of ranks
MESH_MOE_TOKENS = 512          # deepseek-moe-16b's layer, B 1
MESH_EMBED_BATCH, MESH_EMBED_SEQ = 4, 512
# llava-next-mistral-7b's decode shape: B 4 over a 4,096-position cache
MESH_DECODE_BATCH, MESH_DECODE_SEQ = 4, 4096
MESH_ONESIDED_CAPACITY = 16.0  # no assignment drops at this factor
WIRE_ADDITIVE = ("messages", "ops", "req_bytes", "reply_bytes",
                 "nic_hit_ops", "nic_penalty_us")
# the mesh's populations are host-bound serial folds (a rank's TATP
# population took 40.5 s at 2**13 subscribers, the replicated one 35.3 s
# and the tree's 34.3 s at 2**12 a node; PERF.md section 5), so to pay for
# the tensor-parallel phase they are cut: TATP from TATP_SUBSCRIBERS_PER_NODE
# (2**13) to 2**12 a node, the replicated (f=1) state and the B-link tree
# from 2**12 to 2**11; node MESH_DEAD is the one failover_lookup reads
# around
MESH_SUBSCRIBERS = 2**12
MESH_REP_SUBSCRIBERS, MESH_TREE_KEYS, MESH_DEAD = 2**11, 2**11, 1
LOOP_LANE_FIELDS = ("committed", "commit_round")
LOOP_ROUND_FIELDS = ("round_committed", "round_attempts", "round_retries",
                     "round_abort_lock", "round_abort_validate",
                     "round_abort_overflow", "round_abort_stale")


def _wire_of(w):
    return {f: float(getattr(w, f)) for f in ("round_trips",) + WIRE_ADDITIVE}


def mesh_tatp(t, dev, subs):
    """TATP as tatp_main_path sets it up, at MESH_NODES nodes x ``subs``
    subscribers, on transport ``t`` (a rank's node on a MeshTransport, the
    whole cluster on SimTransport): population by rpc_call, one
    run_transactions batch (fused, f=0), then hybrid_lookup of every
    populated key of the local nodes.  Returns the local rows' results on
    the CPU, the hash_probe launches of each read phase and wall times, and
    (cfg, layout, state, klo, khi) for mesh_loops."""
    import numpy as np
    import torch
    from repro_torch.core import hybrid as hy
    from repro_torch.core import tx as txm
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    cfg = ht.HashTableConfig(n_nodes=MESH_NODES, n_buckets=TATP_BUCKETS,
                             bucket_width=1, n_overflow=TATP_OVERFLOW,
                             max_chain=12)
    layout = ht.build_layout(cfg)
    state = {k: t.local(v).clone()
             for k, v in ht.init_cluster_state(cfg, device=dev).items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, (klo, khi) = wl.populate(cfg, layout, t, state, subs, seed=3,
                                    device=dev)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    batch = wl.tatp_transactions(
        klo, khi, n_nodes=MESH_NODES, lanes=MESH_LANES,
        subscribers_per_node=subs, rng=np.random.RandomState(4), device=dev)
    rk, wk, ren, wen, wv = (t.local(x) for x in batch)
    hp.launches = 0
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    state, _, res = txm.run_transactions(
        t, state, cfg, layout, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    tx_launches = hp.launches
    state, _, found, value, version, _, slot, ovf, m = hy.hybrid_lookup(
        t, state, t.local(klo), t.local(khi), cfg, layout)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    cpu = lambda x: x.cpu()
    return dict(
        arena=cpu(state["arena"]), committed=cpu(res.committed),
        read_found=cpu(res.read_found), read_values=cpu(res.read_values),
        aborted=cpu(torch.stack([res.aborted_lock, res.aborted_validate,
                                 res.aborted_overflow, res.aborted_stale])),
        tx_wire=_wire_of(res.metrics.wire),
        tx_round_trips=float(res.round_trips),
        found=cpu(found), value=cpu(value), version=cpu(version),
        slot=cpu(slot), overflow=cpu(ovf), lookup_wire=_wire_of(m.wire),
        tx_launches=tx_launches, lookup_launches=hp.launches - tx_launches,
        population_s=t1 - t0, tx_s=t3 - t2, lookup_s=t4 - t3,
        read_lanes=int(rk[..., 0].numel())), (cfg, layout, state, klo, khi)


def _loop_out(state, res, tel=None):
    """A retry loop's results on the CPU: the arena, the per-lane and
    per-round fields, the reads, round_trips, every WireStats field, and
    the trace rows where traced."""
    reads = (("read_found", "read_values") if hasattr(res, "read_found")
             else ("truncated", "scan_keys", "scan_values", "scan_mask"))
    out = {k: getattr(res, k).cpu() for k in
           LOOP_LANE_FIELDS + LOOP_ROUND_FIELDS + reads}
    out.update(arena=state["arena"].cpu(), wire=_wire_of(res.metrics.wire),
               round_trips=float(res.round_trips))
    if tel is not None:
        out["trace"] = tel.trace.rows[:tel.trace.n].cpu()
    return out


def mesh_loops(t, dev, tatp):
    """The protocol's retry loops on transport ``t`` (a rank's node of a
    MeshTransport, or SimTransport(4)), default draws, every loop with the
    recorder on: tx_loop over the TATP state ``tatp`` (mesh_tatp's), a
    replicated state through tx_loop with a placement table that goes
    stale once, failover_lookup with MESH_DEAD dead, and the B-link tree's
    scan mix through scan_loop at f=0 and f=1.  On SimTransport the
    failover also runs once per node with only that node's lanes enabled:
    the WireStats a rank of the mesh must bill.  Returns the local results
    on the CPU, hash_probe's launches and the wall seconds of each step."""
    import numpy as np
    import torch
    from repro_torch.core import placement as pl
    from repro_torch.core import replication as repl
    from repro_torch.core import telemetry as T
    from repro_torch.core import txloop as txl
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing import workloads as wl

    out, walls = {}, {}

    def timed(name, fn):
        hp.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        out[name + "_launches"] = hp.launches
        return r

    # 1. tx_loop, the recorder on, over the populated TATP state
    cfg, layout, state, klo, khi = tatp
    batch = wl.tatp_transactions(
        klo, khi, n_nodes=MESH_NODES, lanes=MESH_LANES,
        subscribers_per_node=klo.shape[1], rng=np.random.RandomState(5),
        device=dev)
    rk, wk, ren, wen, wv = (t.local(x) for x in batch)
    state, _, res, tel = timed("tx_loop", lambda: txl.tx_loop(
        t, state, cfg, layout, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen, max_rounds=TATP_MAX_ROUNDS,
        telemetry=T.TelemetryConfig(), device=dev))
    out["tx_loop"] = _loop_out(state, res, tel)
    del state, tatp

    # 2. the replicated state, then a table that goes stale once
    rcfg = ht.HashTableConfig(n_nodes=MESH_NODES, n_buckets=TATP_BUCKETS,
                              bucket_width=1, n_overflow=TATP_OVERFLOW,
                              max_chain=12)
    rlay = ht.build_layout(rcfg)
    rep = repl.ReplicaConfig(MESH_NODES, 1)
    pcfg = pl.PlacementConfig(MESH_NODES, f=1)
    old = pl.initial_table(pcfg, device=dev)
    rst = {k: t.local(v).clone()
           for k, v in ht.init_cluster_state(rcfg, device=dev).items()}
    rst, (rlo, rhi) = timed("populate_f1", lambda: wl.populate_replicated(
        rcfg, rlay, t, rst, MESH_REP_SUBSCRIBERS, rep, lanes=MESH_LANES,
        seed=3, ptable=old, pcfg=pcfg, device=dev))
    rst, _ = pl.install_table(t, rst, rlay, pcfg, wl.handoff_table(old, 0),
                              ht.make_rpc_handler(rcfg, rlay), issuer=0)
    batch = wl.tatp_transactions(
        rlo, rhi, n_nodes=MESH_NODES, lanes=MESH_LANES,
        subscribers_per_node=MESH_REP_SUBSCRIBERS,
        rng=np.random.RandomState(6), device=dev)
    rk, wk, ren, wen, wv = (t.local(x) for x in batch)
    rst, _, res, tel = timed("stale_tx_loop", lambda: txl.tx_loop(
        t, rst, rcfg, rlay, read_keys=rk, write_keys=wk, write_values=wv,
        read_enabled=ren, write_enabled=wen, max_rounds=TATP_MAX_ROUNDS,
        rep=rep, ptable=old, pcfg=pcfg, telemetry=T.TelemetryConfig(),
        device=dev))
    out["stale_tx_loop"] = _loop_out(rst, res, tel)
    out["stale_hits"] = (wen[..., 0] & (ht.part_of(
        rcfg, wk[..., 0, 0], wk[..., 0, 1]) == 0)).cpu()

    # 3. every replicated key read with node MESH_DEAD dead
    qlo, qhi = t.local(rlo), t.local(rhi)
    en = (t.node_ids(dev) != MESH_DEAD)[:, None].expand(qlo.shape)
    alive = repl.kill_node(repl.all_alive(MESH_NODES, device=dev), MESH_DEAD)
    fo = timed("failover", lambda: repl.failover_lookup(
        t, rst, qlo, qhi, rcfg, rlay, rep, alive, enabled=en))
    out["failover"] = {k: (_wire_of(v) if k == "wire" else v.cpu())
                       for k, v in fo.items()}
    out["failover"]["enabled"] = en.cpu()
    if t.holds_all_arenas:
        out["failover_by_node"] = [_wire_of(repl.failover_lookup(
            t, rst, qlo, qhi, rcfg, rlay, rep, alive,
            enabled=en & (t.node_ids(dev) == n)[:, None])["wire"])
            for n in range(MESH_NODES)]
    del rst

    # 4. the B-link tree built on the transport, its scan mix at f=0, f=1
    tree = timed("build_tree", lambda: wl.build_tree(
        MESH_NODES, n_keys=MESH_TREE_KEYS, seed=3, batch=ORDERED_BATCH, t=t,
        device=dev))
    bcfg, blay, _, bst, allk, _ = tree
    lo, hi, swk, swen = (t.local(x) for x in wl.scan_workload(
        allk, MESH_NODES, MESH_LANES, scan_frac=ORDERED_SCAN_FRAC, seed=7,
        device=dev))
    for f in (0, 1):
        st = {"arena": bst["arena"].clone()}
        st, _, res, tel = timed(f"scan_loop_f{f}", lambda: txl.scan_loop(
            t, st, bcfg, blay, scan_lo=lo, scan_hi=hi, write_keys=swk,
            write_values=wl.value_for(swk), write_enabled=swen,
            max_rounds=ORDERED_MAX_ROUNDS, rep=repl.ReplicaConfig(
                MESH_NODES, f), telemetry=T.TelemetryConfig(), device=dev))
        out[f"scan_loop_f{f}"] = _loop_out(st, res, tel)
    out["loop_walls"] = walls
    return out


def mesh_world_of_one(rank, world):
    """World size 1 over NCCL: a gate-sized insert and workload, its read
    keys through hybrid_lookup, one run_transactions batch, on
    MeshTransport(1) and on SimTransport(1) in the same process."""
    import torch
    from repro_torch.core import hybrid as hy
    from repro_torch.core import tx as txm
    from repro_torch.core.datastructs import hashtable as ht
    from repro_torch.core.transport import MeshTransport, SimTransport
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.testing import workloads as wl
    import torch.distributed as dist

    mesh = make_smoke_mesh("cuda")
    out = {"backend": dist.get_backend(), "device_mesh": str(mesh)}
    for name, t in (("mesh", MeshTransport(1)), ("sim", SimTransport(1))):
        cfg = ht.HashTableConfig(n_nodes=1, n_buckets=256, bucket_width=1,
                                 n_overflow=64, max_chain=8)
        layout = ht.build_layout(cfg)
        state = ht.init_cluster_state(cfg, device="cuda")
        state, rk, wk, wv = wl.make_tx_workload(
            t, cfg, layout, state, lanes=64, n_keys=64, seed=5,
            device="cuda")
        hp.launches = 0
        state, _, found, value, *_ = hy.hybrid_lookup(
            t, state, rk[..., 0, 0], rk[..., 0, 1], cfg, layout)
        state, _, res = txm.run_transactions(
            t, state, cfg, layout, read_keys=rk, write_keys=wk,
            write_values=wv)
        torch.cuda.synchronize()
        out[name] = dict(
            found=found.cpu(), value=value.cpu(), arena=state["arena"].cpu(),
            committed=res.committed.cpu(), read_values=res.read_values.cpu(),
            read_found=res.read_found.cpu(),
            aborted=torch.stack([res.aborted_lock, res.aborted_validate,
                                 res.aborted_overflow,
                                 res.aborted_stale]).cpu(),
            wire=_wire_of(res.metrics.wire), launches=hp.launches)
    return out


def _without_sync(fn):
    """fn() with torch's sync debug mode set to raise on any call that
    synchronises the host with the card, but for the collectives' own
    waits: gloo stages a CUDA tensor through host memory and its wait
    synchronises (NCCL's does not), so each collective runs with the mode
    at its default and every other call of fn under "error"."""
    import torch
    import torch.distributed as dist

    def unchecked(coll):
        def call(*a, **k):
            torch.cuda.set_sync_debug_mode("default")
            try:
                return coll(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode("error")
        return call
    saved = {n: getattr(dist, n) for n in ("all_reduce",
                                           "all_gather_into_tensor")}
    for n, coll in saved.items():
        setattr(dist, n, unchecked(coll))
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
        for n, coll in saved.items():
            setattr(dist, n, coll)


def _timed(fn, iters=3):
    """Host wall seconds of each of ``iters`` synchronised calls (after a
    warm-up call) and the last result."""
    import torch
    y = fn()
    ts = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return ts, y


def mesh_branches(topo):
    """The sharded branches at full width on this rank: deepseek-moe-16b's
    MoE layer in "rpc", "replicated" and "onesided" against "local" (every
    mode under the sync debug mode set to raise), the vocab-sharded
    embedding against the plain gather, and llava's sequence-sharded decode
    attention against decode_attention over the whole cache.  Every rank
    draws the same global tensors from one seed and cuts its blocks."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.models import embedding as E
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ONE_DEVICE
    from repro_torch.serving import decode as D
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(11)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev)
    out = {}

    # --- MoE: routing recorded call by call --------------------------------
    cfg = get(MOE_ARCHS[0])
    d, E_, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    x = rnd(1, MESH_MOE_TOKENS, d)
    router = rnd(d, E_) * d ** -0.5
    wg, wu = rnd(E_, d, f) * d ** -0.5, rnd(E_, d, f) * d ** -0.5
    wd = rnd(E_, f, d) * f ** -0.5
    inner, calls = moe._router, []

    def router_of(c, xt, rw):
        v, i = inner(c, xt, rw)
        calls.append(i)
        return v, i
    moe._router = router_of
    blk = lambda w: topo.block(w, "expert", None, None)
    res = {}
    try:
        for mode, factor in (("local", None), ("rpc", None),
                             ("replicated", None), ("local", 16.0),
                             ("onesided", 16.0)):
            c = (cfg if factor is None
                 else dataclasses.replace(cfg, capacity_factor=factor))
            ws = ((wg, wu, wd) if mode in ("local", "replicated")
                  else tuple(blk(w) for w in (wg, wu, wd)))
            t_ = ONE_DEVICE if mode == "local" else topo
            calls.clear()
            # "onesided" gathers 2.2 GB of experts a call: one timed call
            ts, y = _timed(lambda: _without_sync(
                lambda: moe.moe_ffn(c, t_, x, router, *ws, mode=mode)),
                iters=1 if mode == "onesided" else 3)
            res[(mode, factor)] = (y, calls[-1])
            out[f"moe_{mode}_{factor or 'default'}_s"] = min(ts)
    finally:
        moe._router = inner
    m = topo.axis_index("model")
    T_my = MESH_MOE_TOKENS // topo.axis_sizes["model"]
    for mode, factor, ref in (("rpc", None, "local"),
                              ("replicated", None, "local"),
                              ("onesided", 16.0, "local")):
        y, topi = res[(mode, factor)]
        want, want_topi = res[(ref, factor)]
        if mode == "onesided":          # the rank routes its slice
            want_topi = want_topi[m * T_my:(m + 1) * T_my]
        out[f"moe_{mode}_routing_equal"] = bool(torch.equal(topi, want_topi))
        out[f"moe_{mode}_rel"] = float((y - want).abs().max()
                                       / want.abs().max())

    # --- embedding: deepseek's vocab, bf16 ------------------------------------
    V = cfg.vocab_padded
    table = rnd(V, d).to(torch.bfloat16)
    tokens = torch.randint(0, V, (MESH_EMBED_BATCH, MESH_EMBED_SEQ),
                           generator=g, device=dev)
    plain = table[tokens]
    out["embed_vocab"], out["embed_block_rows"] = V, V // 4
    for mode in ("rpc", "onesided"):
        ts, y = _timed(lambda: E.embed_lookup(
            topo, topo.block(table, "vocab", None), tokens, mode=mode,
            vocab=V))
        out[f"embed_{mode}_equal"] = bool(torch.equal(y, plain))
        out[f"embed_{mode}_s"] = min(ts)

    # --- decode attention: llava's decode shape, float32 ----------------------
    lc = get(AUDIO_VLM_ARCHS[1])
    B, S = MESH_DECODE_BATCH, MESH_DECODE_SEQ
    q = rnd(B, lc.n_heads, lc.head_dim)
    kc, vc = (rnd(B, S, lc.n_kv_heads, lc.head_dim) for _ in range(2))
    lens = torch.randint(1, S + 1, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    want = D.decode_attention(lc, q, kc, vc, lens)
    ts, y = _timed(lambda: D.hybrid_decode_attention(
        lc, topo, q, topo.block(kc, "batch", "kv_seq", None, None),
        topo.block(vc, "batch", "kv_seq", None, None), lens, mode="seq"))
    out["decode_seq_rel"] = float((y - want).abs().max() / want.abs().max())
    out["decode_seq_s"] = min(ts)
    out["decode_lens"] = lens.tolist()
    return out


def mesh_rank(rank, world, subs):
    """A rank of the four-rank world on the one card: TATP on
    MeshTransport(world), the per-round exchange's time, then the sharded
    branches on a (1, world) ("data", "model") mesh."""
    import torch
    from repro_torch.core.transport import MeshTransport
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import Topology
    t = MeshTransport(world)
    out, tatp = mesh_tatp(t, "cuda", subs)
    out.update(mesh_loops(t, "cuda", tatp))
    del tatp
    # one exchange of the fused round's largest send buffer at this shape
    # (2 read lanes a transaction, the 29-word lookup reply)
    x = torch.zeros((1, world, 2 * MESH_LANES, 29), dtype=torch.int32,
                    device="cuda")
    ts, _ = _timed(lambda: t.exchange(x), iters=10)
    out["exchange_s"] = sorted(ts)[len(ts) // 2]
    topo = Topology(make_mesh((1, world), ("data", "model"), "cuda"))
    out.update(mesh_branches(topo))
    return out


def mesh_loop_checks(ranks, sim):
    """The retry loops of the four ranks (mesh_loops) against
    SimTransport(4)'s: lanes, arenas and reads concatenated, per-round
    counts and the additive WireStats summed over the ranks; every loop's
    trace row by row (every exchange's round trips the ranks' largest, the
    other columns summed) and its round trips the sum of those largest;
    hash_probe once per read round per rank; the stale table refreshed once
    on every rank; failover's reads against the simulator's and each rank's
    WireStats, round trips included, against the simulator's run of that
    node's lanes alone; failover reads found on a live copy."""
    import torch
    cat = lambda name, k: torch.cat([r[name][k] for r in ranks])
    # every rank writes the handed-off partition, so every rank refreshes in
    # round 1 as the simulator's clients do (a rank with no stale abort
    # would keep its table, as the reference's shard does)
    for r in ranks:
        check(r["tx_loop_launches"] >= TATP_MAX_ROUNDS
              and r["stale_tx_loop_launches"] >= TATP_MAX_ROUNDS
              and r["failover_launches"] >= 1,
              "mesh loops: a read round launched no hash_probe")
        st = r["stale_tx_loop"]["round_abort_stale"]
        check(int(st[0]) > 0 and int(st[1:].sum()) == 0,
              f"mesh loops: stale aborts by round {st.tolist()}")
        hits = r["stale_hits"]
        cr = r["stale_tx_loop"]["commit_round"]
        check(bool((cr[hits] != 0).all()) and bool((cr[hits] >= 1).any()),
              "mesh loops: a stale-routed lane committed before the refresh, "
              "or none after it")
    fixed = [0, 1, 2]                       # round, phase, class count
    rt = 3                                  # telemetry.EV_RT
    for name in ("tx_loop", "stale_tx_loop", "scan_loop_f0", "scan_loop_f1"):
        s = sim[name]
        for k in s:
            if k in ("wire", "round_trips", "trace"):
                continue
            got = (torch.stack([r[name][k] for r in ranks]).sum(0).to(
                s[k].dtype) if k in LOOP_ROUND_FIELDS else cat(name, k))
            check(torch.equal(got, s[k]),
                  f"mesh loops: {name} {k} differs from SimTransport(4)")
        for f in WIRE_ADDITIVE:
            check(sum(r[name]["wire"][f] for r in ranks) == s["wire"][f],
                  f"mesh loops: {name} {f} does not sum to the simulator's")
        rows = torch.stack([r[name]["trace"] for r in ranks])
        want = s["trace"]
        add = [c for c in range(want.shape[1]) if c not in fixed + [rt]]
        check(rows.shape[1:] == want.shape
              and torch.equal(rows[:, :, fixed], want[None, :, fixed].expand(
                  rows.shape[0], -1, -1))
              and torch.equal(rows[:, :, rt].max(0).values, want[:, rt])
              and torch.equal(rows[:, :, add].sum(0), want[:, add]),
              f"mesh loops: {name}'s trace rows do not add up to the "
              "simulator's")
        check(float(want[:, rt].sum()) == s["round_trips"]
              and all(float(r[name]["trace"][:, rt].sum())
                      == r[name]["round_trips"] for r in ranks),
              f"mesh loops: {name}'s round trips are not its exchanges'")
    fo = sim["failover"]
    for k in ("found", "value", "version", "node", "slot_idx", "overflow",
              "dead_route"):
        check(torch.equal(cat("failover", k), fo[k]),
              f"mesh loops: failover {k} differs from SimTransport(4)")
    for f in WIRE_ADDITIVE:
        check(sum(r["failover"]["wire"][f] for r in ranks)
              == fo["wire"][f],
              f"mesh loops: failover {f} does not sum to the simulator's")
    for r, own in zip(ranks, sim["failover_by_node"]):
        got = r["failover"]["wire"]
        check(got == own, f"mesh loops: failover's WireStats on a rank "
              f"{got} are not its node's on the simulator {own}")
    en = cat("failover", "enabled")
    check(bool((cat("failover", "found") | ~en).all())
          and not bool((cat("failover", "node")[en] == MESH_DEAD).any()),
          "mesh loops: a replicated key was not found on a live copy")
    committed = {n: int(sim[n]["committed"].sum()) for n in (
        "tx_loop", "stale_tx_loop", "scan_loop_f0", "scan_loop_f1")}
    print("mesh loops: tx_loop, the stale-table tx_loop at f=1, "
          f"failover_lookup with node {MESH_DEAD} dead and scan_loop at f=0 "
          "and f=1 on four ranks equal to SimTransport(4) bit for bit, the "
          "loops' traces exchange by exchange, failover's WireStats rank by "
          "rank; "
          f"committed {committed} of {MESH_NODES * MESH_LANES} [{card()}]",
          flush=True)
    print("mesh loops: " + json.dumps({
        "rank_walls_s": [r["loop_walls"] for r in ranks],
        "sim_walls_s": sim["loop_walls"],
        "round_trips_by_rank": {n: [r[n]["round_trips"] for r in ranks]
                                for n in committed},
        "sim_round_trips": {n: sim[n]["round_trips"] for n in committed},
        "hash_probe_launches_by_rank": {
            n: [r[n + "_launches"] for r in ranks]
            for n in ("tx_loop", "stale_tx_loop", "failover")}}),
        flush=True)


def mesh_dataplane(dev):
    """Four ranks on the card over gloo and, started here while they run,
    world size 1 over NCCL against SimTransport(1), bit for bit, then
    SimTransport(4)'s run: the ranks' TATP against it bit for bit (arenas, commits, reads, abort causes, lookups; the additive
    WireStats summed over the ranks, round_trips per rank with the
    simulator's as their largest), hash_probe launched once per read round
    per rank, the retry loops of mesh_loops against the simulator's
    (mesh_loop_checks), and the sharded branches against their one-rank
    versions."""
    import torch
    from repro_torch.core import slots as sl
    from repro_torch.core.transport import SimTransport
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.testing.ranks import run_ranks

    subs = MESH_SUBSCRIBERS
    ones, sims = [], []       # run here while the four ranks run

    def meanwhile():
        t0 = time.perf_counter()
        ones.append(run_ranks(mesh_world_of_one, 1, device=dev,
                              deadline_s=MESH_DEADLINE_S)[0])
        ones.append(time.perf_counter() - t0)
        t = SimTransport(MESH_NODES)
        sim, tatp = mesh_tatp(t, dev, subs)
        sim.update(mesh_loops(t, dev, tatp))
        sims.append(sim)
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, MESH_NODES, device=dev, backend="gloo",
                      args=(subs,), deadline_s=MESH_DEADLINE_S,
                      meanwhile=meanwhile)
    world_s = time.perf_counter() - t0
    one, one_s = ones
    sim = sims[0]
    check(one["backend"] == "nccl", f"world of one on {one['backend']}")
    for k, v in one["sim"].items():
        same = v == one["mesh"][k] if isinstance(v, (int, dict)) \
            else torch.equal(v, one["mesh"][k])
        check(same, f"mesh at world size 1 (NCCL): {k} differs from "
              "SimTransport(1)")
    check(one["mesh"]["launches"] >= 2,
          "world size 1: hash_probe not launched once per read round")
    print(f"mesh at world size 1 over NCCL ({one['device_mesh']}): insert, "
          f"hybrid_lookup and run_transactions equal to SimTransport(1) bit "
          f"for bit, {one['mesh']['launches']} hash_probe launches; "
          f"{one_s:.1f} s [{card()}]", flush=True)

    cat = lambda k: torch.cat([r[k] for r in ranks])
    for k in ("arena", "committed", "read_found", "read_values", "found",
              "value", "version", "slot", "overflow"):
        check(torch.equal(cat(k), sim[k]),
              f"four ranks: {k} differs from SimTransport({MESH_NODES})")
    check(torch.equal(torch.cat([r["aborted"] for r in ranks], dim=1),
                      sim["aborted"]), "four ranks: abort causes differ")
    for w in ("tx_wire", "lookup_wire"):
        for f in WIRE_ADDITIVE:
            check(sum(r[w][f] for r in ranks) == sim[w][f],
                  f"four ranks: {w} {f} does not sum to the simulator's")
        check(max(r[w]["round_trips"] for r in ranks)
              == sim[w]["round_trips"],
              f"four ranks: {w} round trips above the simulator's")
    for r in ranks:
        check(r["tx_launches"] >= 1 and r["lookup_launches"] >= 1,
              "four ranks: a read round launched no hash_probe")
    committed = int(sim["committed"].sum())
    check(committed > 0, "four ranks: nothing committed")
    print("mesh: four ranks on one card over gloo, TATP at "
          f"{MESH_NODES} x {subs} subscribers, {MESH_LANES} lanes a node: "
          "arenas, commits, reads, abort causes and lookups equal to "
          f"SimTransport({MESH_NODES}) bit for bit; {committed} of "
          f"{MESH_NODES * MESH_LANES} committed [{card()}]", flush=True)
    mesh_loop_checks(ranks, sim)
    print("mesh: " + json.dumps({
        "world_s": world_s,
        "rank_population_s": [r["population_s"] for r in ranks],
        "rank_tx_s": [r["tx_s"] for r in ranks],
        "rank_lookup_s": [r["lookup_s"] for r in ranks],
        "sim_population_s": sim["population_s"], "sim_tx_s": sim["tx_s"],
        "sim_lookup_s": sim["lookup_s"],
        "tx_round_trips_by_rank": [r["tx_round_trips"] for r in ranks],
        "sim_tx_round_trips": sim["tx_round_trips"],
        "hash_probe_launches_by_rank": [
            r["tx_launches"] + r["lookup_launches"] for r in ranks],
        "exchange_ms_by_rank": [r["exchange_s"] * 1e3 for r in ranks]}),
        flush=True)

    # the per-round exchange on the simulator: the transpose, made dense
    x = torch.zeros((MESH_NODES, MESH_NODES, 2 * MESH_LANES, 29),
                    dtype=torch.int32, device=dev)
    sim_ex = time_cuda(lambda: SimTransport(MESH_NODES).exchange(x)
                       .contiguous(), 20)
    # hash_probe at the mesh path's shape: one launch over a rank's
    # returned probe words (one line a lane, off 0)
    M = ranks[0]["read_lanes"]
    g = torch.Generator(device=dev).manual_seed(12)
    lines = torch.randint(-2**31, 2**31 - 1, (M, sl.SLOT_WORDS),
                          generator=g, device=dev, dtype=torch.int32)
    lane = torch.arange(M, dtype=torch.int32, device=dev)
    keys = lines[:, sl.KEY_LO].clone(), lines[:, sl.KEY_HI].clone()
    on = torch.ones(M, dtype=torch.bool, device=dev)
    args = (lines, lane, torch.zeros_like(lane), *keys, on, ~on)
    hp.probe_lines(*args, width=1)
    k_ms = time_cuda(lambda: hp.probe_lines(*args, width=1), 50)
    p_ms = time_cuda(lambda: hp.probe_lines_plain(*args, width=1), 50)
    check(all(torch.equal(a, b) for a, b in zip(
        hp.probe_lines(*args, width=1),
        hp.probe_lines_plain(*args, width=1))),
          "hash_probe at the mesh shape differs from its plain version")
    med = lambda ts: sorted(ts)[len(ts) // 2]
    bound = probe_bound_bytes(M, M, 1) / HBM_BYTES_PER_S * 1e3
    print(f"mesh: hash_probe over a rank's {M} returned lines: kernel "
          f"{med(k_ms):.4f} ms, plain {med(p_ms):.4f} ms, bound "
          f"{bound:.7f} ms (bytes); the simulator's exchange (transpose "
          f"made dense) {med(sim_ex):.4f} ms [{card()}]", flush=True)

    b = ranks[0]
    for mode in ("rpc", "replicated", "onesided"):
        for r in ranks:
            check(r[f"moe_{mode}_routing_equal"],
                  f"MoE {mode}: routing differs from the local path")
            check(r[f"moe_{mode}_rel"] <= F32_REL_FAMILY,
                  f"MoE {mode}: {r[f'moe_{mode}_rel']:.3g} of the largest "
                  f"|value| from local, above {F32_REL_FAMILY}")
    for mode in ("rpc", "onesided"):
        check(all(r[f"embed_{mode}_equal"] for r in ranks),
              f"embed_lookup {mode} differs from the plain gather")
    check(all(r["decode_seq_rel"] <= F32_REL_FAMILY for r in ranks),
          "sequence-sharded decode attention beyond F32_REL_FAMILY")
    print("mesh branches on four ranks: " + json.dumps({
        k: max(r[k] for r in ranks) for k in b
        if k.endswith("_s") or k.endswith("_rel")} | {
        "embed_vocab": b["embed_vocab"], "decode_lens": b["decode_lens"]})
        + f" [{card()}]", flush=True)


FLASH_CASES = [
    (1, 128, 128, 2, 2, 64, True, None, None, "bfloat16"),
    (2, 256, 256, 4, 2, 64, True, None, None, "bfloat16"),      # GQA 2
    (1, 128, 128, 4, 1, 128, True, None, None, "bfloat16"),     # GQA 4
    (1, 256, 256, 2, 2, 64, True, 64, None, "bfloat16"),        # window
    (1, 128, 128, 2, 2, 64, True, None, 50.0, "bfloat16"),      # softcap
    (1, 96, 160, 2, 2, 64, False, None, None, "bfloat16"),      # cross, ragged
    (2, 200, 200, 4, 2, 128, True, 100, 30.0, "bfloat16"),      # all, ragged
    (1, 192, 192, 2, 2, 32, True, None, None, "float32"),
    (2, 100, 100, 4, 4, 16, False, 40, None, "float32"),
    # the bf16 kernel's 128 x 128 tiles at their edges: Sq and Sk not
    # multiples of 128, Sk below one kv tile, a window narrower than a tile,
    # GQA 2 and 4 at D 64 and 128, and D 16 and 32 in bf16
    (1, 300, 300, 4, 2, 64, True, None, None, "bfloat16"),      # GQA 2
    (1, 333, 333, 8, 2, 128, True, None, None, "bfloat16"),     # GQA 4
    (2, 260, 260, 4, 1, 64, False, None, None, "bfloat16"),     # GQA 4
    (1, 130, 257, 4, 2, 128, False, None, None, "bfloat16"),    # GQA 2
    (1, 200, 90, 2, 2, 64, False, None, None, "bfloat16"),      # Sk < tile
    (2, 77, 77, 2, 2, 128, True, None, 20.0, "bfloat16"),       # Sq, Sk < tile
    (1, 384, 384, 2, 2, 64, True, 37, None, "bfloat16"),        # window < tile
    (1, 320, 320, 2, 1, 128, False, 50, None, "bfloat16"),      # window, GQA 2
    (1, 256, 256, 2, 2, 16, True, None, None, "bfloat16"),
    (1, 200, 200, 4, 2, 32, True, 60, None, "bfloat16"),
]
# the query offset (the sequence-parallel rank's rows against every key):
# (B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype, q_offset), rows
# and offsets off the kernels' tiles, one case a kernel
FLASH_QOFF_CASES = [
    (2, 200, 1024, 4, 2, 128, True, None, 30.0, "bfloat16", 600),
    (1, 100, 356, 4, 1, 64, True, 64, None, "float32", 200),
]
# |kernel - plain| <= FLASH_ULPS ulps of (|plain| + the rms of its row),
# element by element.  The limit scales with each value, so it holds the late
# rows of the causal triangle (outputs ~0.5 / sqrt(row) with diffuse scores)
# as tightly as the first.  bf16: the output's own rounding (one ulp) and a
# rounded p that falls the other way; float32: the order of sums over up to
# S keys.
FLASH_ULP = {"bfloat16": 2.0 ** -8, "float32": 2.0 ** -23}
FLASH_ULPS = {"bfloat16": 2, "float32": 128}
# (B, nc, Q, H, P, N, h_tile, with an initial state)
SSD_CASES = [
    (1, 2, 32, 4, 16, 16, 4, False),
    (2, 4, 64, 8, 32, 32, 4, False),
    (1, 3, 16, 2, 64, 128, 2, False),
    (2, 2, 24, 8, 16, 16, 2, False),        # the serving test's chunk of 24
    (1, 2, 100, 4, 64, 64, 1, True),        # ragged tiles, initial state
    (2, 2, 256, 8, 128, 128, 8, False),
    # Q not a multiple of the 64-row tile, one chunk, initial states
    (2, 1, 100, 8, 64, 64, 2, True),
    (1, 1, 24, 4, 32, 16, 4, True),
    (2, 3, 200, 6, 64, 64, 2, True),        # head tile 2 of 6
    (1, 2, 256, 64, 64, 64, 1, True),       # the serving widths
]
SSD_RTOL = 1e-4     # float32: |kernel - plain| <= SSD_RTOL * max(1, max|plain|)


def flash_inputs(B, Sq, Sk, Hq, Hkv, D, dtype, dev, seed, qk_scale=0.5):
    """q, k of qk_scale x randn (scores of std qk_scale^2: 0.25 is a diffuse
    softmax, 2.25 a sharp one), v of 0.5 x randn."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    mk = lambda n, S, a: (torch.randn((n, S, D), generator=g, device=dev,
                                      dtype=torch.float32) * a).to(dt)
    return (mk(B * Hq, Sq, qk_scale), mk(B * Hkv, Sk, qk_scale),
            mk(B * Hkv, Sk, 0.5))


def flash_excess(got, want, dtype):
    """Per element, |got - want| over its limit (> 1 fails), and the limits."""
    w = want.float()
    rms = w.pow(2).mean(-1, keepdim=True).sqrt()
    limit = FLASH_ULPS[dtype] * FLASH_ULP[dtype] * (w.abs() + rms)
    return (got.float() - w).abs() / limit, limit


# which hand-written kernel the C entry point runs for each dtype
FLASH_KERNEL = {"bfloat16": "bf16 tensor-core kernel, wgmma + TMA, 128 x 128",
                "float32": "float32 CUDA-core kernel, 64 x 64"}


def flash_flops(BH, Sq, Sk, D, causal, window=None, q_offset=0):
    """The two products over the (q, k) pairs the mask keeps: causal, and
    within the window (k > q - window) where there is one; the queries at
    positions q_offset on."""
    import numpy as np
    q = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(q, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(q - window + 1, 0) if window is not None else 0
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    return 4 * BH * D * pairs


def flash_bound(BH, Sq, Sk, D, causal, elem_bytes, window=None, group=1,
                q_offset=0):
    """Least time (ms) for one call and what bounds it: the two products
    over the pairs the mask keeps, at the bf16 tensor-core peak, against
    q, k, v (BH / group kv heads) read once and out written once."""
    flops = flash_flops(BH, Sq, Sk, D, causal, window, q_offset)
    byts = elem_bytes * D * (2 * BH * Sq + 2 * (BH // group) * Sk)
    t_ops, t_mem = flops / BF16_FLOP_PER_S, byts / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def flash_checks(dev, rows):
    """flash_attention against its plain version at every case, then at each
    main path's prefill shapes (flash_path_shapes): checked and timed beside
    its plain version and PyTorch's scaled_dot_product_attention.  The
    first shape, zamba2's, fills the kernels row."""
    from repro_torch.kernels import flash_attention as fa
    err = 0.0
    for i, (B, Sq, Sk, Hq, Hkv, D, causal, window, cap, dt) in \
            enumerate(FLASH_CASES):
        q, k, v = flash_inputs(B, Sq, Sk, Hq, Hkv, D, dt, dev, i)
        kw = dict(causal=causal, window=window, softcap=cap, group=Hq // Hkv)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = max(err, _flash_compare(
            f"flash_attention case {i} ({FLASH_KERNEL[dt]}): B={B} Sq={Sq} "
            f"Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} causal={causal} "
            f"window={window} softcap={cap} {dt}", got, want, dt))
    for i, (B, Sq, Sk, Hq, Hkv, D, causal, window, cap, dt, off) in \
            enumerate(FLASH_QOFF_CASES):
        q, k, v = flash_inputs(B, Sq, Sk, Hq, Hkv, D, dt, dev, 50 + i)
        kw = dict(causal=causal, window=window, softcap=cap,
                  group=Hq // Hkv, q_offset=off)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.flash_attention_plain(q, k, v, **kw)
        err = max(err, _flash_compare(
            f"flash_attention q_offset case {i} ({FLASH_KERNEL[dt]}): B={B} "
            f"Sq={Sq} at offset {off}, Sk={Sk} Hq={Hq} Hkv={Hkv} D={D} "
            f"window={window} softcap={cap} {dt}", got, want, dt))
    for n, shape in enumerate(flash_path_shapes()):
        e, ms = flash_at_shape(dev, *shape)
        if n == 0:
            rows["flash_attention"].update(max_abs_err=max(err, e), **ms)


def flash_path_shapes():
    """(label, B, S, Hq, Hkv, D, window, softcap, sharp scores held to,
    seed of the inputs[, causal, kv length]) of
    flash_attention in the main paths' prefills: zamba2's shared block,
    gemma2-27b's global and local layers, the MoE family's layers
    (deepseek-moe-16b at D 128, granite-moe-1b-a400m at D 64, group 2),
    whisper-medium's encoder (non-causal over the 1,500 frames, which are
    not whole 128-row tiles), decoder self-attention and cross-attention
    (the prompt's 416 queries over the 1,500 frames), and
    llava-next-mistral-7b's layers (D 128, group 4).  At the D 128 shapes'
    67M outputs one p that rounds to the other bf16 neighbour, in the
    kernel or in the plain version, can put them 2 ulps apart with both as
    far from the exact answer, so there sharp scores are held to the
    float64 answer."""
    from repro_torch.configs.registry import get
    z, g = get(SERVE_ARCH), get(DENSE_ARCH)
    dense = (DENSE_BATCH, DENSE_PROMPT, g.n_heads, g.n_kv_heads, g.head_dim)
    ds, gr = (get(a) for a in MOE_ARCHS)
    w, lv = (get(a) for a in AUDIO_VLM_ARCHS)
    wh = (w.n_heads, w.n_kv_heads, w.head_dim, None, None, "plain")
    return [("zamba2's shared block", SERVE_BATCH, SERVE_PROMPT, z.n_heads,
             z.n_kv_heads, z.head_dim, None, None, "plain", 99),
            ("gemma2's global layers", *dense, None, g.attn_softcap,
             "float64", 98),
            ("gemma2's local layers", *dense, g.sliding_window,
             g.attn_softcap, "float64", 98),
            ("deepseek-moe-16b's layers", MOE_BATCH, MOE_PROMPT, ds.n_heads,
             ds.n_kv_heads, ds.head_dim, None, None, "float64", 97),
            ("granite-moe-1b-a400m's layers", MOE_BATCH, MOE_PROMPT,
             gr.n_heads, gr.n_kv_heads, gr.head_dim, None, None, "plain", 96),
            ("whisper-medium's encoder", WHISPER_BATCH, w.encoder_seq, *wh,
             95, False),
            ("whisper-medium's decoder self-attention", WHISPER_BATCH,
             WHISPER_PROMPT, *wh, 94),
            ("whisper-medium's cross-attention", WHISPER_BATCH,
             WHISPER_PROMPT, *wh, 93, False, w.encoder_seq),
            ("llava-next-mistral-7b's layers", LLAVA_BATCH, LLAVA_PROMPT,
             lv.n_heads, lv.n_kv_heads, lv.head_dim, None, None, "float64",
             92)]


def flash_at_shape(dev, label, B, S, Hq, Hkv, D, window, cap, sharp_vs,
                   seed, causal=True, Sk=None):
    """flash_attention (bf16) at one main-path shape, S queries over Sk keys
    (S when None), causal or not: with sharp scores (std 2.25) against its
    plain version element by element, or against the float64 answer on the
    rows where kernel and plain differ most and as many at random; with
    diffuse scores (std 0.25) against its plain version element by
    element, with the dropped-kv-block negative control; then timed beside
    its plain version, its bound over the unmasked pairs and
    scaled_dot_product_attention.  Returns the largest |kernel - plain|
    and the kernels row's timing keys."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    t0 = time.perf_counter()
    Sk = S if Sk is None else Sk
    group, BH = Hq // Hkv, B * Hq
    kw = dict(causal=causal, window=window, softcap=cap, group=group)
    mask = "causal" if causal else "non-causal"
    tag = (f"flash_attention at {label} (BH={BH}, Sq={S}, Sk={Sk}, D={D}, "
           f"group {group}, {mask}, window={window}, softcap={cap}, bf16, "
           f"{FLASH_KERNEL['bfloat16']}")
    q, k, v = flash_inputs(B, S, Sk, Hq, Hkv, D, "bfloat16", dev, seed,
                           qk_scale=1.5)
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    if sharp_vs == "plain":
        err = _flash_compare(f"{tag}, scores of std 2.25)", got, want,
                             "bfloat16")
    else:
        gap = flash_excess(got, want, "bfloat16")[0].amax(-1).flatten()
        err = float((got.float() - want.float()).abs().max())
        g = torch.Generator(device=dev).manual_seed(5)
        pick = torch.cat([gap.topk(EXACT_ROWS).indices, torch.randint(
            0, BH * S, (EXACT_ROWS,), device=dev, generator=g)])
        heads, rows = pick // S, pick % S
        exact = exact_rows(q, k, v, heads, rows, window=window, softcap=cap,
                           group=group, causal=causal)
        k_over = float(flash_excess(got[heads, rows], exact,
                                    "bfloat16")[0].max())
        p_over = float(flash_excess(want[heads, rows], exact,
                                    "bfloat16")[0].max())
        print(f"{tag}, scores of std 2.25): kernel vs plain "
              f"{float(gap.max()):.3f} of the limit ({FLASH_ULPS['bfloat16']}"
              f" ulps of |plain| + row rms, information); on "
              f"{2 * EXACT_ROWS} rows (the {EXACT_ROWS} with the largest gaps "
              f"and {EXACT_ROWS} at random) against the float64 answer: "
              f"kernel {k_over:.3f}, plain {p_over:.3f} of the same limit "
              f"around it", flush=True)
        check(k_over <= 1, f"{tag}, sharp scores): kernel != float64 answer")
    q, k, v = flash_inputs(B, S, Sk, Hq, Hkv, D, "bfloat16", dev, seed,
                           qk_scale=0.5)
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    want = fa.flash_attention_plain(q, k, v, **kw)
    err = max(err, _flash_compare(f"{tag}, scores of std 0.25)", got, want,
                                  "bfloat16"))
    # negative control: the plain version with v's rows lo..lo+63 zeroed,
    # held against the kernel in the rows S/2.. that see all of them (diffuse
    # scores, where outputs are least)
    lo = 0 if window is None else S // 2 - 64
    rows = slice(S // 2, S if window is None else lo + window)
    v0 = v.clone()
    v0[:, lo:lo + 64] = 0
    bad = fa.flash_attention_plain(q, k, v0, **kw)
    over, _ = flash_excess(got[:, rows], bad[:, rows], "bfloat16")
    caught = float((over.amax(-1) > 1).float().mean())
    print(f"{tag}) negative control (kv rows {lo}..{lo + 63} dropped from "
          f"v): the limit rejects {caught:.4f} of the rows {rows.start}.."
          f"{rows.stop - 1} (max |diff| "
          f"{float((got - bad)[:, rows].float().abs().max()):.3e})",
          flush=True)
    check(caught > 0.99, f"{tag}): the limit does not reject a dropped kv "
          "block")
    del got, want, bad, v0, over
    q4 = q.reshape(B, Hq, S, D)
    k4, v4 = (t.reshape(B, Hkv, Sk, D) for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ks = _mean(time_cuda(lambda: fa.flash_attention_bhsd(q, k, v, **kw), 20))
    ps = _mean(time_cuda(lambda: fa.flash_attention_plain(q, k, v, **kw), 3))
    ls = _mean(time_cuda(lambda: sdpa(q4, k4, v4, is_causal=causal,
                                      enable_gqa=group > 1), 20))
    bound_ms, bound_by = flash_bound(BH, S, Sk, D, causal, 2, window, group)
    tflop = flash_flops(BH, S, Sk, D, causal, window) / 1e12
    same = (" (the same function)" if window is None and cap is None else
            " (no softcap, no window: not the same function)")
    print(f"{tag}): kernel {ks:.4f} ms ({tflop / ks * 1e3:.1f} TFLOP/s of "
          f"the unmasked pairs), plain {ps:.4f} ms, "
          f"scaled_dot_product_attention(is_causal={causal}, enable_gqa="
          f"{group > 1}) {ls:.4f} ms "
          f"({tflop / ls * 1e3:.1f} TFLOP/s){same}, bound {bound_ms:.5f} ms "
          f"({bound_by}, {tflop * 1e3:.1f} GFLOP at "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16); kernel / SDPA "
          f"{ks / ls:.3f}; {time.perf_counter() - t0:.1f} s; card {card()}",
          flush=True)
    return err, dict(ms=ks, plain_ms=ps, library_ms=ls, bound_ms=bound_ms,
                     bound_by=bound_by)


def exact_rows(q, k, v, heads, rows, *, window, softcap, group,
               causal=True):
    """float64 attention of the (head, row) pairs from the same bf16 inputs
    (causal or not, optional window and softcap): the exact answer."""
    import torch
    D, Sk = q.shape[-1], k.shape[1]
    kpos = torch.arange(Sk, device=q.device)
    out = []
    for h, r in zip(heads.split(32), rows.split(32)):
        s = torch.einsum("nd,nkd->nk", q[h, r].double(),
                         k[h // group].double()) * D ** -0.5
        if softcap is not None:
            s = torch.tanh(s / softcap) * softcap
        keep = (kpos[None] <= r[:, None] if causal
                else torch.ones((len(r), Sk), dtype=torch.bool,
                                device=q.device))
        if window is not None:
            keep &= kpos[None] > r[:, None] - window
        p = torch.softmax(s.masked_fill(~keep, float("-inf")), -1)
        out.append(torch.einsum("nk,nkd->nd", p, v[h // group].double()))
    return torch.cat(out)


# rows of the sharp-score check held against the float64 answer: those with
# the largest kernel-vs-plain gaps, and as many drawn at random
EXACT_ROWS = 128


def _flash_compare(tag, got, want, dtype):
    """Check got against want element by element (flash_excess); print the
    largest error, the share of the limit it used and the typical |want|
    beside the typical limit.  Returns the largest error."""
    over, limit = flash_excess(got, want, dtype)
    e = float((got.float() - want.float()).abs().max())
    print(f"{tag}: max |kernel - plain| {e:.3e}, {float(over.max()):.3f} of "
          f"its limit; median |plain| {float(want.float().abs().median()):.3e}"
          f", median limit {float(limit.median()):.3e} ({FLASH_ULPS[dtype]} "
          f"ulps of |plain| + row rms)", flush=True)
    check(float(over.max()) <= 1, f"{tag}: kernel != plain")
    return e


def ssd_inputs(B, nc, Q, H, P, N, dev, seed):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return (r(B, nc, Q, H, P) * 0.1,
            -torch.rand((B, nc, Q, H), generator=g, device=dev) * 0.5,
            r(B, nc, Q, N) * 0.3, r(B, nc, Q, N) * 0.3)


def ssd_flops(B, nc, Q, H, P, N):
    """Per chunk the causal half of C B^T, the causal half of the
    intra-chunk product per head, the carry-in and state products per
    head."""
    tri = Q * (Q + 1) // 2
    return 2 * B * nc * (tri * N + H * (tri * P + 2 * Q * N * P))


def ssd_bound(B, nc, Q, H, P, N, flop_per_s=F32_FLOP_PER_S, passes=1):
    """Least time (ms) for one call and what bounds it: ssd_flops x passes
    at flop_per_s (the float32 peak by default; 3xTF32 is 3 passes at the
    TF32 peak), against the inputs read once and y and the state written
    once."""
    flops = passes * ssd_flops(B, nc, Q, H, P, N)
    byts = 4 * (2 * B * nc * Q * H * P + B * nc * Q * H + 2 * B * nc * Q * N
                + B * H * N * P)
    t_ops, t_mem = flops / flop_per_s, byts / HBM_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, "operations" if t_ops >= t_mem else "bytes"


def ssd_checks(dev, rows):
    """ssd_scan against its plain version at every case, then at each main
    path's prefill shape (ssd_path_shapes), checked and timed beside its
    plain version and its bounds (no single PyTorch call computes it).  The
    first shape, zamba2's, fills the kernels row."""
    import torch
    from repro_torch.kernels import ssd_scan as ss
    err = 0.0
    for i, (B, nc, Q, H, P, N, h_tile, with_init) in enumerate(SSD_CASES):
        xdt, dA, Bc, Cc = ssd_inputs(B, nc, Q, H, P, N, dev, i)
        init = (torch.randn((B, H, N, P), device=dev) * 0.1 if with_init
                else None)
        err = max(err, _ssd_compare(
            f"ssd_scan case {i}: B={B} nc={nc} Q={Q} H={H} P={P} N={N} "
            f"h_tile={h_tile} init={with_init}", (xdt, dA, Bc, Cc), h_tile,
            init))
    for n, (label, shape) in enumerate(ssd_path_shapes()):
        t0 = time.perf_counter()
        x = ssd_inputs(*shape, dev, len(SSD_CASES) + n)
        tag = f"ssd_scan at {label}'s prefill shape (B, nc, Q, H, P, N) = {shape}"
        e = _ssd_compare(tag, x, 1, None)
        ks = _mean(time_cuda(lambda: ss.ssd_scan(*x, h_tile=1), 10))
        ps = _mean(time_cuda(lambda: ss.ssd_scan_plain(*x), 5))
        bound_ms, bound_by = ssd_bound(*shape)
        tc_ms, tc_by = ssd_bound(*shape, flop_per_s=TF32_FLOP_PER_S, passes=3)
        tflop = ssd_flops(*shape) / 1e12
        print(f"{tag} (3 CUDA kernels: chunk states and C B^T, state "
              f"passing, outputs; 3xTF32 mma.sync): kernel {ks:.4f} ms "
              f"({tflop / ks * 1e3:.2f} TFLOP/s of the causal work), plain "
              f"{ps:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}, float32 "
              f"{F32_FLOP_PER_S / 1e12:.0f} TFLOP/s); 3xTF32 tensor-core "
              f"bound {tc_ms:.5f} ms ({tc_by}, 3 x {tflop * 1e3:.1f} GFLOP at "
              f"{TF32_FLOP_PER_S / 1e12:.0f} TFLOP/s); "
              f"{time.perf_counter() - t0:.1f} s; card {card()}", flush=True)
        if n == 0:
            rows["ssd_scan"].update(max_abs_err=max(err, e), ms=ks,
                                    plain_ms=ps, bound_ms=bound_ms,
                                    bound_by=bound_by)


def _ssd_compare(tag, x, h_tile, init):
    """ssd_scan against its plain version on inputs x = (xdt, dA, B, C):
    y and the final state within SSD_RTOL.  Returns the largest error."""
    from repro_torch.kernels import ssd_scan as ss
    y, st = ss.ssd_scan(*x, h_tile=h_tile, init_state=init)
    yp, sp = ss.ssd_scan_plain(*x, init_state=init)
    e = max(float((y - yp).abs().max()), float((st - sp).abs().max()))
    scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
    print(f"{tag}: max |kernel - plain| {e:.3e} (limit "
          f"{SSD_RTOL * scale:.3e})", flush=True)
    check(e <= SSD_RTOL * scale, f"{tag}: ssd_scan != plain")
    return e


def ssd_shape(arch, batch, prompt):
    """(B, nc, Q, H, P, N) of ssd_scan in ``arch``'s prefill."""
    from repro_torch.configs.registry import get
    cfg = get(arch)
    Q = min(cfg.ssm_chunk, prompt)
    return (batch, prompt // Q, Q, cfg.ssm_heads, cfg.ssm_head_dim,
            cfg.ssm_state)


def ssd_path_shapes():
    """(label, shape) of ssd_scan in the main paths' prefills: zamba2's
    Mamba layers, then mamba2-780m's."""
    return [("zamba2", ssd_shape(SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT)),
            ("mamba2-780m", ssd_shape(SSM_ARCH, SSM_BATCH, SSM_PROMPT))]


def _mean(ms):
    return sum(ms) / len(ms)


# ---------------------------------------------------------------------------
# the serving path: card against CPU at full width, then the main path
# ---------------------------------------------------------------------------
def teacher_forced(cfg, params, tokens, prompt, decode, extra=None):
    """Prefill logits, then the logits of ``decode`` steps fed the next
    tokens of ``tokens`` (not the argmax, so two runs see the same
    inputs), and the final cache.  ``extra``: the audio family's frames or
    the VLM family's patch embeddings, {name: tensor}, for the prefill."""
    from repro_torch.serving.decode import make_decode_step, make_prefill
    logits, cache = make_prefill(cfg, prompt, room=decode)(
        params, dict(extra or {}, tokens=tokens[:, :prompt]))
    out = [logits]
    step = make_decode_step(cfg)
    for t in range(prompt, prompt + decode):
        logits, cache = step(params, cache, tokens[:, t])
        out.append(logits)
    return out, cache


# float32 logits of the 7-layer full-width model agree within this share of
# their range.  The reference's init scales stacked weights by
# 1/sqrt(layer count) (ParamSpec's fan_in is shape[0]), so the model is
# ill-conditioned: a 1e-7 relative change of the embeddings, the size of a
# float32 rounding, moves the logits by a few 1e-3 of their range, and so
# does another order of float32 sums (another CPU thread count, or the
# card).  The script measures that sensitivity in every run and prints it
# beside the comparison; the tolerance sits a few times above it.  In bf16
# the rounding is 2^-8, and card and CPU runs are compared for information.
F32_REL = 1e-2
# The dense and SSM families are well conditioned: gemma2-27b at full width
# and 2 layers moves its float32 logits by ~2e-6 of their range for a 1e-7
# change of the embeddings, and card and CPU runs of it and of the five
# smoke configs came 7e-7 to 6.5e-5 of the range apart (NVIDIA H100 80GB
# HBM3, 700.00 W; PERF.md section 6).  Their limit sits a few times above
# the largest of those readings; gemma2's run measures its conditioning
# first and fails if it is not well below the limit.  The MoE family's
# smoke configs are held to it too.
F32_REL_FAMILY = 3e-4
# deepseek-moe-16b at full width and 2 layers (at the 28-layer init scale)
# is not: a 1e-7 relative change of its embeddings, routing held, moves its
# float32 logits by 1.16e-4 of their range (its random attention scores
# are sharp), and card and CPU came 1.75e-5 to 4.13e-4 of the range apart
# with the same routing (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
# 6).  As for zamba2, its limit sits several times above the measured
# conditioning, and its run fails if the conditioning passes a quarter of
# the limit.  Its modules, one at a time, stay within F32_REL_FAMILY.
MOE_F32_REL = 1e-3
# whisper-medium at full width cut to 2 + 2 layers (at the 24-layer init
# scale) is not either.  Its encoder rounds its input to bf16 (the
# reference's astype), so its first layer's norm returns bf16: one float32
# ulp between card and CPU before that rounding flips bf16 roundings (on
# the CPU another rounding of that norm moved the encoder output by 1.7e-3
# of its largest value, and a 1e-7 relative change of the frames moved the
# logits by 5.0e-2 of their range).  So the decoder path is compared with
# the CPU's encoder output held on the card (held_encoder): its
# conditioning there, 1e-7 on the embeddings and the encoder output, read
# 2.6e-5 to 3.8e-5 of the logit range on the CPU, near a tenth of
# F32_REL_FAMILY;
# by MOE_F32_REL's rule its limit sits several times above it and the run
# fails if the card's reading passes a quarter of it (the card read 7.1e-6,
# and held card and CPU 1.3e-5 to 6.1e-5 apart, unheld up to 2.3e-3).
WHISPER_F32_REL = 3e-4
# whisper's encoder output over all 1,500 frames, card against CPU, as a
# share of its largest value: two bf16 roundings (2^-8 each) of it, above
# what one flipped bf16 rounding of the first norm moves it (1.7e-3 on the
# CPU; the card read 1.179e-3, NVIDIA H100 80GB HBM3, 700.00 W).
WHISPER_ENC_REL = 2 * 2.0 ** -8
# llava-next-mistral-7b at full width cut to 2 layers (at the 32-layer init
# scale), 2,880 patch positions and 192 text tokens, is ill-conditioned
# too: a 1e-7 relative change of its embeddings and patch embeddings moved
# its float32 logits by 3.616e-5 of their range on the card (the CPU read
# 2.72e-5), above the tenth of F32_REL_FAMILY that gemma2's rule asks
# (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6); its random
# attention scores are sharp (std ~128 at that scale, no softcap), and a
# float32 run of it on the CPU was 1.3e-3 to 1.7e-3 of the logit range
# from a float64 run on the same weights (two draws).  A first limit of
# 3e-4 failed: card and CPU came 2.2e-5 to 3.484e-4 apart, while each
# prefill module alone is held to F32_REL_FAMILY (dense_layers_card_vs_cpu).
# This limit was chosen after that reading: 5.7x the largest card-vs-CPU
# reading and above the float32 runs' distance from float64, which every
# run measures again and prints beside it (plain_dense_logits, a plain
# float64 forward on the card); the run fails if the 1e-7 conditioning
# passes a quarter of the limit.
LLAVA_F32_REL = 2e-3
# Each float32 run of llava's cut (card, CPU) against that float64 forward:
# the model's float32 uncertainty read 1.3e-3 to 1.7e-3 of the logit range;
# a fault in either forward (a rotation, a kv group, a norm) moves the
# logits by a share of their range, far above this.
F64_WITNESS_REL = 1e-2


def _compare(tag, got, ref, V, rel):
    """Per step: max |got - ref| against rel x the logit range, and greedy
    tokens equal unless the reference's top-2 margin is within 4x the
    deviation.  rel None: print only."""
    import torch
    for step, (g, r) in enumerate(zip(got, ref)):
        g, r = g.float().cpu()[:, :V], r.float().cpu()[:, :V]
        check(bool(torch.isfinite(g).all()), f"{tag}: non-finite logits")
        d = float((g - r).abs().max())
        rng = float(r.abs().max())
        top2 = r.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        flip = g.argmax(-1) != r.argmax(-1)
        print(f"{tag}, step {step}: max |diff| {d:.4e} = {d / rng:.3e} of "
              f"the logit range {rng:.4f}; greedy equal "
              f"{not bool(flip.any())}, top-2 margin {float(margin.min()):.4e}",
              flush=True)
        if rel is not None:
            check(d <= rel * rng, f"{tag}: logits differ at step {step}")
            check(not bool((flip & (margin > 4 * d)).any()),
                  f"{tag}: greedy token differs at step {step}")


def card_vs_cpu(dev):
    """zamba2-1.2b at full width, cut to PARITY_LAYERS layers, from the same
    seeded weights and tokens: prefill and decode on the card against the
    CPU (which takes the kernels' plain versions), and on the card against
    the model's own forward."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import api, zamba
    from repro_torch.parallel.sharding import init_params
    cfg = dataclasses.replace(get(SERVE_ARCH), n_layers=PARITY_LAYERS)
    V = cfg.vocab_size
    params = init_params(api.param_specs(cfg),
                         torch.Generator().manual_seed(1), "cpu")
    tokens = serve.prompt_batch(cfg, 1, PARITY_PROMPT, PARITY_DECODE,
                                "cpu")["tokens"]
    run = lambda p, toks: teacher_forced(cfg, p, toks, PARITY_PROMPT,
                                         PARITY_DECODE)[0]

    p32 = _map_tree(params, lambda t: t.float())
    t0 = time.perf_counter()
    ref = run(p32, tokens)
    t_cpu = time.perf_counter() - t0
    g = torch.Generator().manual_seed(2)
    e = p32["embed"]
    shaken = dict(p32, embed=e * (1 + 1e-7 * torch.randn(e.shape, generator=g)))
    moved = max(float((a - b)[:, :V].abs().max() / b[:, :V].abs().max())
                for a, b in zip(run(shaken, tokens), ref))
    print(f"sensitivity: a 1e-7 relative change of the embeddings moves the "
          f"float32 logits (CPU) by {moved:.3e} of their range; CPU run "
          f"{t_cpu:.1f} s", flush=True)
    p_dev = _map_tree(p32, lambda t: t.to(dev))
    _compare("card vs cpu, float32", run(p_dev, tokens.to(dev)), ref, V,
             F32_REL)

    # on the card: prefill CHECK_PROMPT + CHECK_DECODE teacher-forced decode
    # steps against the forward over those tokens (one SSD chunk)
    seq = serve.prompt_batch(cfg, 1, CHECK_PROMPT, CHECK_DECODE,
                             dev)["tokens"]
    steps, _ = teacher_forced(cfg, p_dev, seq, CHECK_PROMPT, CHECK_DECODE)
    fwd = zamba.forward(cfg, p_dev, seq)[:, CHECK_PROMPT - 1:]
    _compare(f"card, float32, serving vs forward ({CHECK_PROMPT} + "
             f"{CHECK_DECODE})", steps[:-1], [fwd[:, i] for i in
                                               range(CHECK_DECODE)], V,
             F32_REL)
    del p_dev, p32, shaken

    pb = _map_tree(params, lambda t: t.to(dev))
    _compare("card vs cpu, bf16 (information)", run(pb, tokens.to(dev)),
             run(params, tokens), V, None)
    bf16_blocks(dev, cfg, params, pb)


# bf16 single modules at full width, card against CPU, agree within this many
# bf16 ulps (2^-8) of the largest |value| of each output.  One module is too
# short for the roundings that differ (cuBLAS's order of sums against the
# CPU's, an intermediate that rounds the other way) to compound as they do
# through the 7 layers above; the script prints the ulps each output used.
BF16_ULPS = 4
BF16_PROMPT = 512           # two SSD chunks of 256, eight kv blocks of 64


def bf16_blocks(dev, cfg, params, pb):
    """The bf16 path one module at a time, card against CPU on the same
    weights and inputs: a Mamba2 layer's prefill (ssd_scan and the casts
    around it) returning its conv and SSM states, one decode step from those
    states, and the shared block (flash_attention's bf16 instantiation)."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import mamba2 as M
    from repro_torch.models import zamba
    S, K = BF16_PROMPT, cfg.conv_width
    g = torch.Generator().manual_seed(3)
    h = torch.randn((1, S, cfg.d_model), generator=g).to(torch.bfloat16)
    zero = tuple(torch.zeros((1, K - 1, c), dtype=torch.bfloat16)
                 for c in (cfg.d_inner, cfg.ssm_state, cfg.ssm_state))
    cos, sin = L.rope_tables(torch.arange(S), cfg.head_dim, cfg.rope_theta)
    names = ("prefill h", "prefill conv_x", "prefill conv_B",
             "prefill conv_C", "prefill ssm", "decode h", "decode conv_x",
             "decode ssm", "shared block h")
    outs, states = [], None
    for p, d in ((params, "cpu"), (pb, dev)):
        to = lambda t: t.to(d)
        lp = L.layer(p["layers"], 0)
        hp, (cs, st) = M.mamba_block(cfg, lp, to(h),
                                     conv_state=tuple(map(to, zero)))
        if states is None:                    # both decode from the CPU's
            states = (cs, st)
        hd, (cs1, st1) = M.mamba_block(
            cfg, lp, to(h[:, :1]), conv_state=tuple(map(to, states[0])),
            ssm_state=to(states[1]), decode=True)
        hs = zamba.shared_block(cfg, p["shared"], to(h), to(cos), to(sin))
        outs.append([t.cpu() for t in (hp, *cs, st, hd, cs1[0], st1, hs)])
    for name, want, got in zip(names, *outs):
        check(got.dtype == want.dtype and got.shape == want.shape,
              f"bf16 {name}: card {got.dtype} {tuple(got.shape)}, cpu "
              f"{want.dtype} {tuple(want.shape)}")
        scale = float(want.float().abs().max())
        ulps = float((got.float() - want.float()).abs().max()) / (
            2.0 ** -8 * scale)
        print(f"bf16 {name} ({want.dtype}, max |value| {scale:.4e}): card vs "
              f"cpu max |diff| = {ulps:.3f} bf16 ulps of it (limit "
              f"{BF16_ULPS})", flush=True)
        check(ulps <= BF16_ULPS, f"bf16 {name}: card and CPU differ")


def _map_tree(tree, fn):
    return {k: _map_tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def serve_full_size(dev, arch, batch, prompt, decode, expect):
    """``arch`` at full size through repro_torch.launch.serve: prefill
    batch x prompt tokens, then ``decode`` greedy tokens, with the kernels'
    launch counts set to 0 just before that one run and read just after
    (``expect``: {kernel: launches}) and, for an MoE arch, the share of
    expert assignments kept at each step (``routed``: one sum a layer);
    what came out checked; one more decode step and one more prefill under
    torch.profiler.  Returns the stats."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.serving.decode import (cache_specs, make_decode_step,
                                            make_prefill)

    t0 = time.perf_counter()
    cfg, params = serve.build(arch, seed=0, device=dev)
    leaves = list(_leaves(params))
    print(f"serve: {cfg.name}, {cfg.n_layers} layers, {len(leaves)} leaves "
          f"of {sum(t.numel() for t in leaves)} parameters (the config's "
          f"approximate formula: {cfg.n_params()}), weights "
          f"{sum(t.numel() * t.element_size() for t in leaves) / 1e9:.3f} GB,"
          f" drawn in {time.perf_counter() - t0:.2f} s; card {card()}",
          flush=True)
    del leaves
    inputs = serve.prompt_batch(cfg, batch, prompt, decode, dev)
    tokens = inputs["tokens"]
    # warm-up (cuBLAS handles, allocator) at a small size, outside the count
    w = prompt // 8
    serve.serve(cfg, params, {k: v[:1] for k, v in
                              serve.prompt_inputs(inputs, w).items()}, w, 2)

    torch.cuda.reset_peak_memory_stats()
    fa.launches = ss.launches = 0
    with (routed(logits=False) if cfg.is_moe
          else contextlib.nullcontext()) as calls:
        ids, st = serve.serve(cfg, params, inputs, prompt, decode)
    launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches}
    stats = {
        "arch": arch, "batch": batch, "prompt": prompt, "decode": decode,
        "prefill_ms": st["prefill_ms"],
        "prefill_tok_per_s": batch * prompt / st["prefill_ms"] * 1e3,
        "decode_ms": st["decode_ms"], "decode_tokens": st["decode_tokens"],
        "decode_tok_per_s": st["decode_tok_per_s"],
        "decode_ms_per_step": st["decode_ms"] / (decode - 1),
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "launches_per_prefill": launches,
    }
    if cfg.is_moe:      # the prefill, then each decode step
        stats["kept_share_by_step"] = kept_shares(calls, cfg.n_layers)
    print("serve: " + json.dumps(stats), flush=True)
    check(launches == expect, f"{arch}: launches per prefill {launches}, "
          f"expected {expect}")

    # --- what came out is right ---------------------------------------------
    cache, last = st["cache"], st["last_logits"]
    check(tuple(ids.shape) == (batch, decode), f"{arch}: generated ids shape")
    check(bool(((ids >= 0) & (ids < cfg.vocab_size)).all()),
          f"{arch}: a generated id is outside the real vocabulary")
    check(bool(torch.isfinite(last[:, :cfg.vocab_size]).all()),
          f"{arch}: non-finite logits")
    check(bool((cache["len"] == prompt + decode - 1).all()),
          f"{arch}: cache length")
    for n, (shape, _, dt) in cache_specs(cfg, batch,
                                           prompt + decode).items():
        check(cache[n].dtype == dt and tuple(cache[n].shape) == shape,
              f"{arch}: cache {n}: {cache[n].dtype} {tuple(cache[n].shape)}, "
              f"expected {dt} {shape}")
        # layer by layer: gemma2-27b's K region is 3.1 GB
        check(all(bool(torch.isfinite(x).all()) for x in cache[n]),
              f"{arch}: non-finite {n}")
    # --- one more decode step under the profiler ------------------------------
    step = make_decode_step(cfg)
    tok = ids[:, -1]
    profile_round(lambda: step(params, cache, tok), label=f"{arch} decode step")
    del cache, st
    # --- and one more prefill, to show where its time goes ---------------------
    prefill = make_prefill(cfg, prompt)
    profile_round(lambda: prefill(params, serve.prompt_inputs(inputs, prompt)),
                  label=f"{arch} prefill")
    return stats


def serving_main_path(dev, rows):
    """zamba2-1.2b at full size (serve_full_size); its launch counts are the
    kernels line's."""
    from repro_torch.configs.registry import get
    cfg = get(SERVE_ARCH)
    napps = cfg.n_layers // cfg.shared_attn_every
    stats = serve_full_size(dev, SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT,
                            SERVE_DECODE, {"flash_attention": napps,
                                           "ssd_scan": cfg.n_layers})
    for name, n in stats["launches_per_prefill"].items():
        rows[name]["launches"] = n
    return stats


# ---------------------------------------------------------------------------
# the dense and pure-SSM families: gemma2-27b and mamba2-780m
# ---------------------------------------------------------------------------
def _family_launches(cfg):
    """Kernel launches of one prefill: a flash_attention per dense, MoE or
    VLM layer, three per whisper layer pair (encoder self, decoder self,
    cross), an ssd_scan per Mamba layer."""
    n = cfg.n_layers
    if cfg.family == "audio":
        return {"flash_attention": cfg.encoder_layers + 2 * n, "ssd_scan": 0}
    return ({"flash_attention": n, "ssd_scan": 0}
            if cfg.family in ("dense", "moe", "vlm")
            else {"flash_attention": 0, "ssd_scan": n})


def _stub_inputs(batch):
    """The frames or patch embeddings of a prompt_batch, {} for the other
    families."""
    return {k: v for k, v in batch.items() if k in ("frames", "patch_embeds")}


def family_smoke(dev, archs=FAMILY_ARCHS):
    """Every arch of ``archs`` (the dense and SSM families; the audio and
    VLM ones with their frames or patch embeddings) at its smoke() size,
    from the same float32 weights and inputs: prefill and SMOKE_DECODE
    teacher-forced steps on the card (the kernels) against the CPU (their
    plain versions), within F32_REL_FAMILY of the logit range."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.parallel.sharding import init_params
    for arch in archs:
        t0 = time.perf_counter()
        cfg = get(arch).smoke()
        p32 = _map_tree(init_params(api.param_specs(cfg),
                                    torch.Generator().manual_seed(0), "cpu"),
                        lambda t: t.float())
        batch = serve.prompt_batch(cfg, 2, SMOKE_PROMPT, SMOKE_DECODE, "cpu")
        run = lambda p, b: teacher_forced(cfg, p, b["tokens"], SMOKE_PROMPT,
                                          SMOKE_DECODE, _stub_inputs(b))[0]
        ref = run(p32, batch)
        fa.launches = ss.launches = 0
        got = run(_map_tree(p32, lambda t: t.to(dev)), _map_tree(
            batch, lambda t: t.to(dev)))
        launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches}
        check(launches == _family_launches(cfg),
              f"{arch} smoke: launches {launches}")
        _compare(f"{arch} smoke, card vs cpu, float32", got, ref,
                 cfg.vocab_size, F32_REL_FAMILY)
        print(f"{arch} smoke: launches {json.dumps(launches)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def gemma_card_vs_cpu(dev):
    """gemma2-27b at full width cut to GEMMA_LAYERS layers (one local, one
    global), float32, from the same seeded weights and tokens: prefill and
    decode on the card against the CPU.  First its conditioning: a 1e-7
    relative change of the embeddings, on the card."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.parallel.sharding import init_params
    cfg = dataclasses.replace(get(DENSE_ARCH), n_layers=GEMMA_LAYERS)
    V = cfg.vocab_size
    t0 = time.perf_counter()
    p_dev = _map_tree(init_params(api.param_specs(cfg),
                                  torch.Generator(device=dev).manual_seed(1),
                                  dev), lambda t: t.float())
    tokens = serve.prompt_batch(cfg, 1, GEMMA_PROMPT, GEMMA_DECODE,
                                "cpu")["tokens"]
    run = lambda p, toks: teacher_forced(cfg, p, toks, GEMMA_PROMPT,
                                         GEMMA_DECODE)[0]
    got = run(p_dev, tokens.to(dev))
    g = torch.Generator(device=dev).manual_seed(2)
    e = p_dev["embed"]
    shaken = dict(p_dev, embed=e * (1 + 1e-7 * torch.randn(
        e.shape, generator=g, device=dev)))
    moved = max(float((a - b)[:, :V].abs().max() / b[:, :V].abs().max())
                for a, b in zip(run(shaken, tokens.to(dev)), got))
    del shaken
    print(f"gemma2 sensitivity: a 1e-7 relative change of the embeddings "
          f"moves the float32 logits (card) by {moved:.3e} of their range "
          f"(at most a tenth of the card-vs-CPU limit {F32_REL_FAMILY}); card "
          f"runs and draws {time.perf_counter() - t0:.1f} s", flush=True)
    check(moved <= F32_REL_FAMILY / 10, "gemma2: conditioned worse than the "
          "card-vs-CPU limit assumes")
    p_cpu = _map_tree(p_dev, lambda t: t.cpu())
    del p_dev
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = run(p_cpu, tokens)
    print(f"gemma2 {GEMMA_LAYERS} layers, {GEMMA_PROMPT} + {GEMMA_DECODE} "
          f"tokens: CPU run {time.perf_counter() - t0:.1f} s", flush=True)
    _compare(f"gemma2 {GEMMA_LAYERS} layers, card vs cpu, float32", got, ref,
             V, F32_REL_FAMILY)


def families_served(dev):
    """gemma2-27b, then mamba2-780m, at full size (serve_full_size), each
    with its own launch counts; the card's memory freed between them."""
    import torch
    from repro_torch.configs.registry import get
    for arch, batch, prompt, decode in (
            (DENSE_ARCH, DENSE_BATCH, DENSE_PROMPT, DENSE_DECODE),
            (SSM_ARCH, SSM_BATCH, SSM_PROMPT, SSM_DECODE)):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        stats = serve_full_size(dev, arch, batch, prompt, decode,
                                _family_launches(get(arch)))
        check(stats["max_memory_allocated_gb"] * 1e9
              < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak memory above the card's")
        print(f"{arch} served: {time.perf_counter() - t0:.1f} s of phase",
              flush=True)


# ---------------------------------------------------------------------------
# the MoE family: deepseek-moe-16b and granite-moe-1b-a400m
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def routed(logits=True):
    """Record each call of the MoE layer's routing (``models.moe.route``)
    made inside the block, with no host sync: per call its topi (T, K), its
    keep bits (T*K,) and, with ``logits``, the router's float32 logits
    (T, E), recomputed here from the call's inputs as ``moe._router``
    computes them.  The program's code is unchanged; the wrapper is removed
    on the way out."""
    from repro_torch.models import moe
    inner, calls = moe.route, []

    def route(cfg, x, router_w):
        out = inner(cfg, x, router_w)
        rec = {"topi": out[0], "keep": out[2][4]}
        if logits:
            with moe._no_tf32():
                rec["logits"] = (x.reshape(-1, x.shape[-1]).float()
                                 @ router_w.float())
        calls.append(rec)
        return out
    moe.route = route
    try:
        yield calls
    finally:
        moe.route = inner


@contextlib.contextmanager
def forced_routing(calls):
    """Make the MoE router choose, call by call, the experts recorded in
    ``calls`` (``routed``'s records of another run over the same tokens),
    weighting them from its own float32 logits as ``moe._router`` does; the
    wrapper is removed on the way out."""
    import torch
    from repro_torch.models import moe
    inner, recs = moe._router, iter(calls)

    def router(cfg, xt, router_w):
        topi = next(recs)["topi"].to(xt.device)
        with moe._no_tf32():
            logits = xt.float() @ router_w.float()
        if cfg.router_renorm:
            topv = torch.softmax(logits, -1).gather(1, topi)
            return topv / topv.sum(-1, keepdim=True), topi
        return torch.softmax(logits.gather(1, topi), -1), topi
    moe._router = router
    try:
        yield
    finally:
        moe._router = inner


def kept_shares(calls, n_layers):
    """The share of expert assignments kept (not dropped at an expert's
    capacity) in each step of ``n_layers`` routing calls."""
    import torch
    kept = torch.stack([c["keep"].sum() for c in calls]).cpu().tolist()
    size = [c["keep"].numel() for c in calls]
    return [sum(kept[i:i + n_layers]) / sum(size[i:i + n_layers])
            for i in range(0, len(calls), n_layers)]


def routing_agrees(tag, got, ref, k, strict):
    """Compare the routing of matching calls, card (``got``) against CPU
    (``ref``).  A token whose top-k experts differ (a flip) is printed with
    the CPU's smallest gap between its k + 1 largest router logits; with
    ``strict`` any flip fails, else a gap wider than 4x the call's largest
    logit deviation does.  Keep bits that differ in a call without a flip
    fail.  Returns per call the mask of tokens whose experts and keep bits
    agree, and the index of the first call with a flip (len(ref) if
    none)."""
    import torch
    check(len(got) == len(ref), f"{tag}: {len(got)} routing calls on the "
          f"card, {len(ref)} on the CPU")
    masks, first = [], len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        gt, rt = g["topi"].cpu(), r["topi"].cpu()
        gk, rk = (x["keep"].cpu().view(rt.shape) for x in (g, r))
        flip = (gt != rt).any(-1)
        same = ~flip & (gk == rk).all(-1)
        masks.append(same)
        if not bool(flip.any()):
            check(bool(same.all()), f"{tag}, call {i}: keep bits differ "
                  "with the same experts")
            continue
        first = min(first, i)
        gl, rl = g["logits"].cpu(), r["logits"].cpu()
        dev_l = float((gl - rl).abs().max())
        top = rl.sort(-1, descending=True).values[:, :k + 1]
        gap = (top[:, :-1] - top[:, 1:]).min(-1).values
        for t in flip.nonzero()[:, 0].tolist():
            print(f"{tag}, call {i}: routing flip at token {t}: cpu experts "
                  f"{rt[t].tolist()}, card {gt[t].tolist()}; cpu margin "
                  f"{float(gap[t]):.4e} against 4 x the logit deviation "
                  f"{4 * dev_l:.4e}", flush=True)
        check(not strict, f"{tag}: routing differs in call {i}")
        check(bool((gap[flip] <= 4 * dev_l).all()), f"{tag}: a routing flip "
              "beyond 4x the router-logit deviation")
    return masks, first


def moe_smoke(dev):
    """Both MoE archs at smoke() size, from the same float32 weights and
    tokens: prefill and SMOKE_DECODE teacher-forced steps on the card
    against the CPU, logits within F32_REL_FAMILY of their range, every
    layer's routing equal, and one flash_attention launch a layer."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.parallel.sharding import init_params
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = get(arch).smoke()
        p32 = _map_tree(init_params(api.param_specs(cfg),
                                    torch.Generator().manual_seed(0), "cpu"),
                        lambda t: t.float())
        tokens = serve.prompt_batch(cfg, 2, SMOKE_PROMPT, SMOKE_DECODE,
                                    "cpu")["tokens"]
        run = lambda p, toks: teacher_forced(cfg, p, toks, SMOKE_PROMPT,
                                             SMOKE_DECODE)[0]
        with routed() as r_cpu:
            ref = run(p32, tokens)
        fa.launches = ss.launches = 0
        with routed() as r_dev:
            got = run(_map_tree(p32, lambda t: t.to(dev)), tokens.to(dev))
        launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches}
        check(launches == _family_launches(cfg),
              f"{arch} smoke: launches {launches}")
        _compare(f"{arch} smoke, card vs cpu, float32", got, ref,
                 cfg.vocab_size, F32_REL_FAMILY)
        routing_agrees(f"{arch} smoke", r_dev, r_cpu, cfg.top_k, strict=True)
        print(f"{arch} smoke: launches {json.dumps(launches)}; routing equal "
              f"in all {len(r_cpu)} calls; kept share by step "
              f"{kept_shares(r_cpu, cfg.n_layers)}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    moe_without_sync(dev)


def moe_without_sync(dev):
    """The MoE layer reads no value of the card on the host (a sync a layer
    would stall the host-bound decode step): deepseek-moe-16b's layer at
    full width, on its decode batch of 8 tokens and on a 512-token prefill,
    under torch's sync debug mode set to raise on a synchronising call."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.models import moe
    from repro_torch.parallel.sharding import ONE_DEVICE
    cfg = get(MOE_ARCHS[0])
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    g = torch.Generator(device=dev).manual_seed(4)
    w = [torch.randn(s, generator=g, device=dev).to(torch.bfloat16) * 0.02
         for s in ((d, E), (E, d, f), (E, d, f), (E, f, d))]
    xs = [torch.randn((b, s, d), generator=g, device=dev).to(torch.bfloat16)
          for b, s in ((MOE_BATCH, 1), (1, MOE_CHECK_PROMPT))]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [moe.moe_ffn(cfg, ONE_DEVICE, x, *w) for x in xs]
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(all(bool(torch.isfinite(o).all()) for o in outs),
          "moe_ffn: non-finite output")
    print("moe_ffn (deepseek-moe-16b's layer, 8 decode tokens and a "
          f"{MOE_CHECK_PROMPT}-token prefill) ran under "
          "torch.cuda.set_sync_debug_mode('error') (no host sync)",
          flush=True)


def moe_card_vs_cpu(dev):
    """deepseek-moe-16b at full width cut to MOE_LAYERS layers, float32, from
    the same seeded weights and tokens: prefill and decode on the card
    against the CPU.  The reference's init scales a stacked leaf by
    1/sqrt(its layer count), so the cut's layers are rescaled to the full
    model's (full_scale_stacks): the served model's layers, not sharper
    ones.  Routing is compared call by call under the flip rule
    (routing_agrees), and the logits of the steps before the first flip
    within MOE_F32_REL; the card run again with the CPU's routing choices
    (forced_routing) within MOE_F32_REL at every step; its
    conditioning measured on the card (1e-7 on the embeddings, routing
    held); then each prefill layer one module at a time
    (moe_layers_card_vs_cpu)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.parallel.sharding import init_params
    cfg = dataclasses.replace(get(MOE_ARCHS[0]), n_layers=MOE_LAYERS)
    V, n = cfg.vocab_size, cfg.n_layers
    tag = (f"deepseek-moe-16b {n} layers (the "
           f"{get(MOE_ARCHS[0]).n_layers}-layer init scale)")
    t0 = time.perf_counter()
    p_dev = _map_tree(init_params(api.param_specs(cfg),
                                  torch.Generator(device=dev).manual_seed(1),
                                  dev), lambda t: t.float())
    full_scale_stacks(cfg, get(MOE_ARCHS[0]), p_dev)
    tokens = serve.prompt_batch(cfg, 1, MOE_CHECK_PROMPT, MOE_CHECK_DECODE,
                                "cpu")["tokens"]
    run = lambda p, toks: teacher_forced(cfg, p, toks, MOE_CHECK_PROMPT,
                                         MOE_CHECK_DECODE)[0]
    p_cpu = _map_tree(p_dev, lambda t: t.cpu())
    with routed() as r_cpu:
        ref = run(p_cpu, tokens)
    t_cpu = time.perf_counter() - t0
    with routed() as r_dev:
        got = run(p_dev, tokens.to(dev))
    # the card following the CPU's routing choices: the rest of the path
    # (attention, experts, combine) held to the limit at every step
    with forced_routing(r_cpu):
        held = run(p_dev, tokens.to(dev))
    # conditioning: a 1e-7 relative change of the embeddings, the routing
    # held to the unshaken card run's so that no choice moves
    g = torch.Generator(device=dev).manual_seed(2)
    e = p_dev["embed"]
    shaken = dict(p_dev, embed=e * (1 + 1e-7 * torch.randn(
        e.shape, generator=g, device=dev)))
    with forced_routing(r_dev):
        moved = max(float((a - b)[:, :V].abs().max() / b[:, :V].abs().max())
                    for a, b in zip(run(shaken, tokens.to(dev)), got))
    del shaken
    print(f"{tag} sensitivity: a 1e-7 relative change of the embeddings, "
          f"routing held, moves the float32 logits (card) by {moved:.3e} of "
          f"their range ({moved / MOE_F32_REL:.3f} of the card-vs-CPU "
          f"limit {MOE_F32_REL}, at most a quarter of it); "
          f"{MOE_CHECK_PROMPT} + {MOE_CHECK_DECODE} tokens, CPU run "
          f"{t_cpu:.1f} s, all {time.perf_counter() - t0:.1f} s; kept share "
          f"by step, card {kept_shares(r_dev, n)}, cpu "
          f"{kept_shares(r_cpu, n)}", flush=True)
    check(moved <= MOE_F32_REL / 4,
          f"{tag}: conditioned worse than the card-vs-CPU limit assumes")
    _, first = routing_agrees(tag, r_dev, r_cpu, cfg.top_k, strict=False)
    steps = first // n
    _compare(f"{tag}, card vs cpu, float32", got[:steps], ref[:steps], V,
             MOE_F32_REL)
    if steps < len(ref):
        _compare(f"{tag}, card vs cpu, float32, from step {steps}, after a "
                 "routing flip (information)", got[steps:], ref[steps:], V,
                 None)
    _compare(f"{tag}, card with the CPU's routing vs cpu, float32", held,
             ref, V, MOE_F32_REL)
    moe_layers_card_vs_cpu(tag, cfg, p_dev, p_cpu,
                           tokens[:, :MOE_CHECK_PROMPT], dev)


def moe_layers_card_vs_cpu(tag, cfg, p_dev, p_cpu, tokens, dev):
    """Each layer of the prefill one module at a time, on the card and on
    the CPU from the same input: the attention block from the CPU's input to
    the layer, its output within F32_REL_FAMILY of its largest value; the
    MoE FFN block from the CPU's attention output, its routing under the
    flip rule and its output within F32_REL_FAMILY of its largest value on
    the tokens whose experts and keep bits agree."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed
    from repro_torch.parallel.sharding import ONE_DEVICE
    S = tokens.shape[1]
    h = embed(cfg, p_cpu["embed"], tokens)
    cos, sin = L.rope_tables(torch.arange(S), cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        res, a_c = [], None
        for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
            lp = L.layer(p["layers"], i)
            a = T.attention_block(cfg, ONE_DEVICE, lp, h.to(d), cos.to(d),
                                  sin.to(d), window=None)
            a_in = a if a_c is None else a_c.to(d)
            with routed() as calls:
                y = T.ffn_block(cfg, ONE_DEVICE, lp, a_in)
            res.append((a.cpu(), (y - a_in).cpu(), calls))
            a_c = res[0][0]
        (a_c, f_c, r_c), (a_g, f_g, r_g) = res
        masks, _ = routing_agrees(f"{tag}, prefill layer {i}", r_g, r_c,
                                  cfg.top_k, strict=False)
        same = masks[0].view(f_c.shape[:2])
        for name, x, ref in (("attention block", a_g, a_c),
                             ("MoE FFN, tokens with equal routing",
                              f_g[same], f_c[same])):
            diff = float((x - ref).abs().max())
            scale = float(ref.abs().max())
            print(f"{tag}, prefill layer {i}, {name}: card vs cpu max |diff| "
                  f"{diff:.4e} = {diff / scale:.3e} of its largest value "
                  f"{scale:.4e} (limit {F32_REL_FAMILY}); tokens compared "
                  f"{int(same.sum()) if 'MoE' in name else S} of {S}",
                  flush=True)
            check(diff <= F32_REL_FAMILY * scale, f"{tag}, prefill layer {i}: "
                  f"{name} differs")
        h = a_c + f_c


def moe_served(dev):
    """deepseek-moe-16b, then granite-moe-1b-a400m, at full size
    (serve_full_size), each with its launch counts and its kept shares;
    the card's memory freed between them."""
    import torch
    from repro_torch.configs.registry import get
    for arch in MOE_ARCHS:
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        stats = serve_full_size(dev, arch, MOE_BATCH, MOE_PROMPT, MOE_DECODE,
                                _family_launches(get(arch)))
        check(stats["max_memory_allocated_gb"] * 1e9
              < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak memory above the card's")
        print(f"{arch} served: {time.perf_counter() - t0:.1f} s of phase",
              flush=True)


# ---------------------------------------------------------------------------
# the audio and VLM families: whisper-medium and llava-next-mistral-7b
# ---------------------------------------------------------------------------
def audio_vlm_smoke(dev):
    """Both archs at smoke() size, card against CPU (family_smoke)."""
    family_smoke(dev, AUDIO_VLM_ARCHS)


def full_scale_stacks(cfg, full, params):
    """Multiply every stacked "scaled" leaf of ``cfg``, a cut of ``full`` to
    fewer layers, by sqrt(its layers in the cut / in ``full``), in place:
    the init scale it has in the full model (ParamSpec's fan-in is the
    stacked axis), so the cut's layers are the served model's."""
    import math
    from repro_torch.models import api
    specs = api.param_specs(full)
    for name, stack in api.param_specs(cfg).items():
        for k, spec in (stack.items() if isinstance(stack, dict) else ()):
            if spec.init == "scaled":
                params[name][k].mul_(math.sqrt(spec.shape[0]
                                               / specs[name][k].shape[0]))


@contextlib.contextmanager
def held_encoder(enc):
    """whisper's ``encode`` returning ``enc`` (the CPU's encoder output),
    so the decoder path is compared with the encoder's bf16 rounding
    points held, as ``forced_routing`` holds the MoE routing."""
    from repro_torch.models import whisper
    saved = whisper.encode
    whisper.encode = lambda *args, **kw: enc
    try:
        yield
    finally:
        whisper.encode = saved


def plain_dense_logits(cfg, params, tokens, patch_embeds, dtype):
    """A plain forward of the dense transformer with the VLM's patch
    embeddings in the first positions, written apart from the port's, in
    ``dtype`` throughout (float64: the witness of llava's float32 runs):
    RMSNorm scaled by 1 + w, half-split RoPE, causal GQA softmax attention,
    SwiGLU, the tied head.  Only what llava's config uses: no softcap,
    window, biases, post norms or embedding scale.  tokens (B, S) ->
    logits (B, S, vocab_size)."""
    import math
    import torch
    assert not (cfg.attn_softcap or cfg.logit_softcap or cfg.qkv_bias
                or cfg.post_norms or cfg.embed_scale or cfg.is_moe
                or cfg.local_global_pattern == 2), cfg.name
    f = lambda t: t.to(dtype)
    B, S = tokens.shape
    hd, Hq, Hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    h = f(params["embed"])[tokens.long()]
    h[:, :patch_embeds.shape[1]] = f(patch_embeds)
    half = hd // 2
    ang = (torch.arange(S, dtype=dtype, device=h.device)[:, None]
           * cfg.rope_theta ** (-torch.arange(half, dtype=dtype,
                                              device=h.device) / half))
    cos, sin = ang.cos()[:, None], ang.sin()[:, None]

    def norm(x, w):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * (1 + f(w))

    def rope(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    future = torch.ones(S, S, dtype=torch.bool, device=h.device).triu(1)
    for i in range(cfg.n_layers):
        p = {k: f(v[i]) for k, v in params["layers"].items()}
        x = norm(h, p["attn_norm"])
        q = rope((x @ p["wq"]).view(B, S, Hq, hd)).transpose(1, 2)
        k = rope((x @ p["wk"]).view(B, S, Hkv, hd)).transpose(1, 2)
        v = (x @ p["wv"]).view(B, S, Hkv, hd).transpose(1, 2)
        k = k.repeat_interleave(Hq // Hkv, dim=1)
        v = v.repeat_interleave(Hq // Hkv, dim=1)
        a = (q @ k.transpose(-1, -2) / math.sqrt(hd)).masked_fill(
            future, float("-inf")).softmax(-1) @ v
        h = h + a.transpose(1, 2).reshape(B, S, Hq * hd) @ p["wo"]
        x = norm(h, p["mlp_norm"])
        h = h + (torch.nn.functional.silu(x @ p["w_gate"])
                 * (x @ p["w_up"])) @ p["w_down"]
    table = params.get("lm_head", params["embed"])[:cfg.vocab_size]
    return norm(h, params["final_norm"]) @ f(table).T


def cut_card_vs_cpu(dev, arch):
    """``arch`` at full width cut to CUT_LAYERS layers (whisper: as many
    encoder layers), its stacked leaves at the full model's init scale
    (full_scale_stacks), float32, B 1, from the same seeded weights and
    inputs (all 1,500 frames and a WHISPER_CUT_PROMPT-token prompt;
    llava's patch positions and LLAVA_CUT_TEXT text tokens): prefill and
    CUT_DECODE teacher-forced steps on the card against the CPU.  First
    its conditioning on the card: a 1e-7 relative change of the embeddings
    and of the frames or patch embeddings (in float32).  llava: within a
    quarter of LLAVA_F32_REL, its limit, and each prefill module from the
    CPU's input within F32_REL_FAMILY (dense_layers_card_vs_cpu); each
    float32 run within F64_WITNESS_REL of a plain float64 forward on the
    card (plain_dense_logits), printed beside the card-vs-CPU distance.
    whisper: that change crosses the encoder's bf16 roundings (its input,
    and its first layer's norm, in the bf16 stream's dtype), so it is
    printed only; the encoder's output, card against CPU, within
    WHISPER_ENC_REL of its largest value; the decoder path is held with the
    CPU's encoder output (held_encoder) within WHISPER_F32_REL, after its
    own conditioning (1e-7 on the embeddings and the encoder output) is
    found within a quarter of it."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.launch import serve
    from repro_torch.models import api, whisper
    from repro_torch.parallel.sharding import init_params
    full = get(arch)
    audio = full.family == "audio"
    cfg = dataclasses.replace(full, n_layers=CUT_LAYERS, **(
        {"encoder_layers": CUT_LAYERS} if audio else {}))
    prompt = (WHISPER_CUT_PROMPT if audio
              else full.n_patches + LLAVA_CUT_TEXT)
    V = cfg.vocab_size
    tag = (f"{arch} {CUT_LAYERS}{' + ' + str(CUT_LAYERS) if audio else ''} "
           f"layers (the {full.n_layers}-layer init scale), {prompt} + "
           f"{CUT_DECODE} tokens")
    t0 = time.perf_counter()
    p_dev = _map_tree(init_params(api.param_specs(cfg),
                                  torch.Generator(device=dev).manual_seed(1),
                                  dev), lambda t: t.float())
    full_scale_stacks(cfg, full, p_dev)
    batch = serve.prompt_batch(cfg, 1, prompt, CUT_DECODE, "cpu")
    extra = _stub_inputs(batch)
    run = lambda p, x, d: teacher_forced(
        cfg, p, batch["tokens"].to(d), prompt, CUT_DECODE,
        {k: v.to(d) for k, v in x.items()})[0]
    g = torch.Generator(device=dev).manual_seed(2)
    shake = lambda t: t.to(dev).float() * (1 + 1e-7 * torch.randn(
        t.shape, generator=g, device=dev))
    moved = lambda out, ref: max(
        float((a - b)[:, :V].abs().max() / b[:, :V].abs().max())
        for a, b in zip(out, ref))
    got = run(p_dev, extra, dev)
    m = moved(run(dict(p_dev, embed=shake(p_dev["embed"])),
                  {k: shake(v) for k, v in extra.items()}, dev), got)
    print(f"{tag} sensitivity: a 1e-7 relative change of the embeddings and "
          f"the {' and '.join(extra)} moves the float32 logits (card) by "
          f"{m:.3e} of their range; card runs and draws "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not audio:
        print(f"{tag}: {m / LLAVA_F32_REL:.3f} of the card-vs-CPU limit "
              f"{LLAVA_F32_REL}, at most a quarter of it", flush=True)
        check(m <= LLAVA_F32_REL / 4, f"{tag}: conditioned worse than the "
              "card-vs-CPU limit assumes")
        t0 = time.perf_counter()
        with torch.no_grad():
            wit = plain_dense_logits(
                cfg, p_dev, batch["tokens"][:, :prompt + CUT_DECODE].to(dev),
                extra["patch_embeds"].to(dev), torch.float64)[0, prompt - 1:]
        wit = [r[None].cpu() for r in wit]
        torch.cuda.synchronize()
        print(f"{tag}: plain float64 forward on the card "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        p_cpu = _map_tree(p_dev, lambda t: t.cpu())
        del p_dev
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ref = run(p_cpu, extra, "cpu")
        print(f"{tag}: CPU run {time.perf_counter() - t0:.1f} s", flush=True)
        dense_layers_card_vs_cpu(tag, cfg, _map_tree(p_cpu, lambda t: t.to(
            dev)), p_cpu, batch["tokens"][:, :prompt], extra, dev)
        far = {w: max(float((a.float().cpu()[:, :V] - r).abs().max()
                            / r.abs().max()) for a, r in zip(x, wit))
               for w, x in (("card", got), ("cpu", ref))}
        print(f"{tag}: float32 logits from the float64 forward's, worst "
              f"step: card {far['card']:.3e}, cpu {far['cpu']:.3e} of the "
              f"range (limit {F64_WITNESS_REL}); the card-vs-CPU limit is "
              f"{LLAVA_F32_REL}", flush=True)
        check(max(far.values()) <= F64_WITNESS_REL,
              f"{tag}: a float32 run is far from the float64 forward")
        _compare(f"{tag}, card vs cpu, float32", got, ref, V, LLAVA_F32_REL)
        return
    p_cpu = _map_tree(p_dev, lambda t: t.cpu())
    t0 = time.perf_counter()
    enc_cpu = whisper.encode(cfg, p_cpu, extra["frames"])
    enc_dev = whisper.encode(cfg, p_dev, extra["frames"].to(dev)).cpu()
    check(bool(torch.isfinite(enc_dev).all()), f"{tag}: non-finite encoder")
    e = float((enc_dev - enc_cpu).abs().max() / enc_cpu.abs().max())
    print(f"{tag}: encoder output card vs cpu, float32: max |diff| {e:.3e} "
          f"of its largest |value| (limit {WHISPER_ENC_REL:.4e}, two bf16 "
          "roundings)", flush=True)
    check(e <= WHISPER_ENC_REL, f"{tag}: encoder output differs")
    with held_encoder(enc_cpu.to(dev)):
        held = run(p_dev, extra, dev)
    with held_encoder(shake(enc_cpu)):
        m = moved(run(dict(p_dev, embed=shake(p_dev["embed"])), extra, dev),
                  held)
    print(f"{tag} sensitivity, the encoder held: a 1e-7 relative change of "
          f"the embeddings and the encoder output moves the float32 logits "
          f"(card) by {m:.3e} of their range ({m / WHISPER_F32_REL:.3f} of "
          f"the limit {WHISPER_F32_REL}, at most a quarter of it)",
          flush=True)
    check(m <= WHISPER_F32_REL / 4, f"{tag}: conditioned worse than the "
          "card-vs-CPU limit assumes")
    del p_dev
    torch.cuda.empty_cache()
    with held_encoder(enc_cpu):
        ref = run(p_cpu, extra, "cpu")
    print(f"{tag}: CPU runs {time.perf_counter() - t0:.1f} s", flush=True)
    _compare(f"{tag}, card with the CPU's encoder output vs cpu, float32",
             held, ref, V, WHISPER_F32_REL)
    _compare(f"{tag}, card vs cpu, float32 (information)", got, ref, V, None)


def dense_layers_card_vs_cpu(tag, cfg, p_dev, p_cpu, tokens, extra, dev):
    """Each layer of a dense (or VLM) prefill one module at a time, on the
    card and on the CPU from the same input: the attention block from the
    CPU's input to the layer and the SwiGLU FFN block from the CPU's
    attention output, each within F32_REL_FAMILY of its largest value."""
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.embedding import embed
    from repro_torch.parallel.sharding import ONE_DEVICE
    S = tokens.shape[1]
    h = T.with_patches(embed(cfg, p_cpu["embed"], tokens),
                       extra.get("patch_embeds"))
    cos, sin = L.rope_tables(torch.arange(S), cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        out = []
        for p, d in ((p_cpu, "cpu"), (p_dev, dev)):
            lp = L.layer(p["layers"], i)
            a = T.attention_block(cfg, ONE_DEVICE, lp, h.to(d), cos.to(d),
                                  sin.to(d), window=None)
            a_in = a if not out else out[0][0].to(d)
            y = T.ffn_block(cfg, ONE_DEVICE, lp, a_in)
            out.append((a.cpu(), (y - a_in).cpu()))
        (a_c, f_c), (a_g, f_g) = out
        for name, x, ref in (("attention block", a_g, a_c),
                             ("FFN block", f_g, f_c)):
            diff = float((x - ref).abs().max())
            scale = float(ref.abs().max())
            print(f"{tag}, prefill layer {i}, {name}: card vs cpu max |diff| "
                  f"{diff:.4e} = {diff / scale:.3e} of its largest value "
                  f"{scale:.4e} (limit {F32_REL_FAMILY})", flush=True)
            check(diff <= F32_REL_FAMILY * scale, f"{tag}, prefill layer {i}: "
                  f"{name} differs")
        h = a_c + f_c


def whisper_card_vs_cpu(dev):
    cut_card_vs_cpu(dev, AUDIO_VLM_ARCHS[0])


def llava_card_vs_cpu(dev):
    cut_card_vs_cpu(dev, AUDIO_VLM_ARCHS[1])


def audio_vlm_served(dev):
    """whisper-medium (8 x 1,500 frames, 416 + 32 tokens), then
    llava-next-mistral-7b (4 x 4,096 positions, 2,880 of them patches, + 32
    tokens) at full size (serve_full_size), each with its launch counts
    (72 and 32 flash_attention a prefill); the card's memory freed between
    them."""
    import torch
    from repro_torch.configs.registry import get
    for arch, batch, prompt, decode in (
            (AUDIO_VLM_ARCHS[0], WHISPER_BATCH, WHISPER_PROMPT,
             WHISPER_DECODE),
            (AUDIO_VLM_ARCHS[1], LLAVA_BATCH, LLAVA_PROMPT, LLAVA_DECODE)):
        t0 = time.perf_counter()
        torch.cuda.empty_cache()
        stats = serve_full_size(dev, arch, batch, prompt, decode,
                                _family_launches(get(arch)))
        check(stats["max_memory_allocated_gb"] * 1e9
              < torch.cuda.get_device_properties(0).total_memory,
              f"{arch}: peak memory above the card's")
        print(f"{arch} served: {time.perf_counter() - t0:.1f} s of phase",
              flush=True)


# ---------------------------------------------------------------------------
# training: gradients through the kernels, the train step with AdamW, and the
# checkpoint whose commit record is a Storm transaction
# ---------------------------------------------------------------------------
def _grad_excess(got, want, limit):
    """Tensor by tensor, max |got - want| over limit x max |want| (> 1
    fails)."""
    return max(float((g.float() - w.float()).abs().max())
               / (limit * float(w.float().abs().max()))
               for g, w in zip(got, want))


def _grads_of(fn, inputs, loss):
    """Gradients of loss(fn(*inputs)) with respect to fresh leaves copied from
    ``inputs``."""
    import torch
    leaves = [t.clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(loss(fn(*leaves)), leaves)


def _zero_backward(fn):
    """``fn`` as an autograd Function whose backward returns zeros: the
    negative control of the gradient checks."""
    import torch

    class ZeroBackward(torch.autograd.Function):
        @staticmethod
        def forward(*xs):
            return fn(*xs)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.inputs = inputs

        @staticmethod
        def backward(ctx, *grads):
            return tuple(torch.zeros_like(t) for t in ctx.inputs)
    return ZeroBackward.apply


def flash_grad_check(dev, label, B, S, Hq, Hkv, D):
    """The flash_attention Function at a training shape (bf16, causal): its
    forward launches the kernel once; its dq/dk/dv are nonzero and equal
    autograd straight through ``layers.block_attention_jnp`` (the
    reference's differentiated function, 512 x 512 tiles) on the card within
    KGRAD_BF16 of each tensor's largest |grad|; a Function whose backward
    returns zeros is rejected by the same check.  The loss is
    sum(w * out^2) / 2, so the kernel's forward values enter the gradient."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.models import layers as L
    g = torch.Generator(device=dev).manual_seed(11)
    mk = lambda H, a: (torch.randn((B, S, H, D), generator=g, device=dev)
                       * a).to(torch.bfloat16)
    qkv = (mk(Hq, 0.5), mk(Hkv, 0.5), mk(Hkv, 0.5))
    w = torch.randn((B, S, Hq, D), generator=g, device=dev)
    loss = lambda out: (w * out.float().square()).sum() / 2
    n0 = fa.launches
    got = _grads_of(ops.flash_attention, qkv, loss)
    launched = fa.launches - n0
    want = _grads_of(L.block_attention_jnp, qkv, loss)
    bad = _grads_of(_zero_backward(
        lambda q, k, v: ops._flash(q, k, v, True, None, None)), qkv, loss)
    excess, bad_excess = (_grad_excess(x, want, KGRAD_BF16)
                          for x in (got, bad))
    with torch.no_grad():
        fwd = _mean(time_cuda(lambda: ops.flash_attention(*qkv), 3))
    both = _mean(time_cuda(lambda: _grads_of(ops.flash_attention, qkv, loss),
                           2))
    print(f"flash_attention gradients at {label} (B {B}, S {S}, {Hq} heads "
          f"over {Hkv}, D {D}, causal, bf16): " + json.dumps({
              "kernel_launches_in_forward": launched,
              "max_abs_grad": [float(x.float().abs().max()) for x in got],
              "excess_over_limit": excess,
              "negative_control_excess": bad_excess,
              "forward_kernel_ms": fwd, "forward_and_backward_ms": both,
              "card": card()}), flush=True)
    check(launched == 1, f"flash_attention at {label}: the forward launched "
          f"{launched} kernels, expected 1")
    check(all(float(x.abs().max()) > 0 for x in got),
          f"flash_attention at {label}: a zero gradient")
    check(excess <= 1, f"flash_attention at {label}: gradients differ from "
          f"the backward's function ({excess:.3f} of the limit)")
    check(bad_excess > 1, f"flash_attention at {label}: the negative control "
          "(a zero backward) passed the check")


def ssd_grad_check(dev):
    """The ssd_scan Function at zamba2's training shape (float32): its forward
    launches the kernels once; the four input gradients are nonzero and
    equal autograd straight through ``ssd_scan.ssd_scan_plain`` (the
    reference's chunk step) on the card within KGRAD_F32 of each tensor's
    largest |grad|; a zero backward is rejected."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss
    B, nc, Q, H, P, N = ssd_shape(TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ)
    ins = ssd_inputs(B, nc, Q, H, P, N, dev, 12)
    g = torch.Generator(device=dev).manual_seed(13)
    wy = torch.randn(ins[0].shape, generator=g, device=dev)
    ws = torch.randn((B, H, N, P), generator=g, device=dev)
    loss = lambda out: ((wy * out[0].square()).sum() / 2
                        + (ws * out[1]).sum())
    fn = lambda *xs: ops.ssd_scan(*xs, h_tile=1)
    n0 = ss.launches
    got = _grads_of(fn, ins, loss)
    launched = ss.launches - n0
    want = _grads_of(ss.ssd_scan_plain, ins, loss)
    bad = _grads_of(_zero_backward(lambda *xs: ss.ssd_scan(*xs, h_tile=1)),
                    ins, loss)
    excess, bad_excess = (_grad_excess(x, want, KGRAD_F32) for x in (got, bad))
    with torch.no_grad():
        fwd = _mean(time_cuda(lambda: fn(*ins), 3))
    both = _mean(time_cuda(lambda: _grads_of(fn, ins, loss), 2))
    print(f"ssd_scan gradients at {TRAIN_ARCH}'s training shape (B {B}, {nc} "
          f"chunks of {Q}, H {H}, P {P}, N {N}, float32): " + json.dumps({
              "kernel_launches_in_forward": launched,
              "max_abs_grad": [float(x.abs().max()) for x in got],
              "excess_over_limit": excess,
              "negative_control_excess": bad_excess,
              "forward_kernel_ms": fwd, "forward_and_backward_ms": both,
              "card": card()}), flush=True)
    check(launched == 1, f"ssd_scan: the forward launched {launched} calls")
    check(all(float(x.abs().max()) > 0 for x in got), "ssd_scan: a zero "
          "gradient")
    check(excess <= 1, f"ssd_scan: gradients differ from the backward's "
          f"function ({excess:.3f} of the limit)")
    check(bad_excess > 1, "ssd_scan: the negative control passed the check")


def kernel_gradients(dev):
    """Gradients through the kernels at zamba2's and granite's training
    shapes (flash_grad_check, ssd_grad_check)."""
    from repro_torch.configs.registry import get
    z, gr = get(TRAIN_ARCH), get(MOE_TRAIN_ARCH)
    flash_grad_check(dev, TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, z.n_heads,
                     z.n_kv_heads, z.head_dim)
    flash_grad_check(dev, MOE_TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, gr.n_heads,
                     gr.n_kv_heads, gr.head_dim)
    ssd_grad_check(dev)


def _named_grads(cfg, params, batch, opts):
    """(loss, {path: gradient}) of the float32 loss of one batch."""
    import torch
    from repro_torch.models import api
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.train.loss import lm_loss
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, _ = lm_loss(api.forward(cfg, live, batch, opts=opts),
                      batch["labels"])
    return loss.detach(), dict(zip(_flat(live), torch.autograd.grad(
        loss, tree_leaves(live))))


def _flat(tree, pre=""):
    """{path: leaf} in sorted key order (``optim.adamw.tree_leaves``'s)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out.update(_flat(v, f"{pre}{k}/") if isinstance(v, dict)
                   else {pre + k: v})
    return out


def train_card_vs_cpu(dev):
    """Every ported arch at smoke() size in float32 weights, B 2 x 96 tokens:
    the loss within LOSS_REL and every gradient leaf within GRAD_REL of the
    leaf's largest |grad|, card (the kernels forward, their Functions
    backward) against CPU (the plain versions), with the kernels' launches
    on the card; then one train step from the same state on each: the
    master weights' update within GRAD_REL of its leaf's largest update plus
    two float32 spacings of the leaf's largest weight (AdamW with eps 1, lr
    0.1, no decay, as the CPU tests hold the JAX package)."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import ARCHS, get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import api
    from repro_torch.models.transformer import RunOptions
    from repro_torch.optim.adamw import AdamWConfig, init_opt_state
    from repro_torch.parallel.sharding import init_params
    from repro_torch.train.step import TrainHparams, make_train_step
    opts = RunOptions(q_block=32, kv_block=32, remat=False)
    hp = TrainHparams(opts=opts, optimizer=AdamWConfig(
        lr=0.1, eps=1.0, warmup_steps=1, weight_decay=0.0))
    for arch in sorted(ARCHS):
        t0 = time.perf_counter()
        cfg = get(arch).smoke()
        p32 = _map_tree(init_params(api.param_specs(cfg),
                                    torch.Generator().manual_seed(0), "cpu"),
                        lambda t: t.float())
        batch = synthetic_batch(cfg, ShapeConfig("t", 96, 2, "train"),
                                DataConfig(), 0, "cpu")
        # copies: a train step writes its parameters in place
        on = lambda d: ({k: v.to(d) for k, v in batch.items()},
                        _map_tree(p32, lambda t: t.to(d, copy=True)))
        l_cpu, g_cpu = _named_grads(cfg, p32, batch, opts)
        fa.launches = ss.launches = 0
        b_dev, p_dev = on(dev)
        l_dev, g_dev = _named_grads(cfg, p_dev, b_dev, opts)
        launches = {"flash_attention": fa.launches, "ssd_scan": ss.launches}
        loss_rel = abs(float(l_dev) - float(l_cpu)) / abs(float(l_cpu))
        worst = max((float((g_dev[n].cpu() - g_cpu[n]).abs().max())
                     / float(g_cpu[n].abs().max()), n) for n in g_cpu)
        # one train step from the same state on each device
        master = {}
        for d in ("cpu", dev):
            bd, pd = on(d)
            st = {"params": pd, "opt": init_opt_state(pd)}
            make_train_step(cfg, hp)(st, bd)
            master[d] = {n: t.cpu() for n, t in _flat(st["opt"]["master"]).items()}
        w0 = _flat(p32)
        upd = 0.0
        for n, w in master["cpu"].items():
            u_cpu, u_dev = w - w0[n], master[dev][n] - w0[n]
            floor = 2 * float(np.spacing(np.float32(w.abs().max())))
            lim = GRAD_REL * float(u_cpu.abs().max()) + floor
            upd = max(upd, float((u_dev - u_cpu).abs().max()) / lim)
        expect = ({"flash_attention": 1, "ssd_scan": cfg.n_layers}
                  if cfg.family == "hybrid" else _family_launches(cfg))
        print(f"{arch} smoke training, card vs cpu, float32: " + json.dumps({
            "loss": float(l_cpu), "loss_rel": loss_rel,
            "worst_leaf": worst[1], "worst_leaf_rel": worst[0],
            "master_update_excess_over_limit": upd,
            "launches_forward_and_backward": launches,
            "seconds": time.perf_counter() - t0}), flush=True)
        check(loss_rel <= LOSS_REL, f"{arch}: losses differ")
        check(worst[0] <= GRAD_REL, f"{arch}: gradient {worst[1]} differs")
        check(upd <= 1, f"{arch}: master weights after a step differ")
        check(launches == expect, f"{arch}: launches {launches}, expected "
              f"{expect} (one forward, no remat)")


# the profile spans of a train step (train/step.py, kernels/ops.py); the
# backward is the rest of the step's device time
TRAIN_SPANS = ("train forward", "adamw", "flash_attention backward",
               "ssd_scan backward")


def _train_launches(cfg):
    """Kernel launches of one train step at the default RunOptions: every
    layer body runs twice, in the forward and in its remat recompute (the
    backward launches no kernel)."""
    n = cfg.n_layers
    if cfg.family == "hybrid":
        return {"flash_attention": 2 * (n // cfg.shared_attn_every),
                "ssd_scan": 2 * n}
    return {k: 2 * v for k, v in _family_launches(cfg).items()}


def train_full_size(dev, arch):
    """``arch`` trained at full size on the synthetic stream: TRAIN_BATCH x
    TRAIN_SEQ tokens a step, seeded weights, AdamW and RunOptions at the
    reference's defaults (remat of each layer body, saving the weight
    products); one warm-up step, then TRAIN_STEPS timed steps (host clock
    ending in a synchronise), each with its kernel launches set to 0 just
    before it and read just after, checked against _train_launches; finite
    losses, grad norms > 0; peak memory; for MoE the kept share of expert
    assignments in each step's forward; one more step under torch.profiler."""
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.train.step import init_train_state, make_train_step
    t0 = time.perf_counter()
    cfg = get(arch)
    torch.cuda.empty_cache()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(state)) / 1e9
    print(f"train: {arch}, {cfg.n_layers} layers, {n_params} parameters, "
          f"state {state_gb:.3f} GB, drawn in {time.perf_counter() - t0:.2f} "
          f"s; card {card()}", flush=True)
    step = make_train_step(cfg)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = lambda s: synthetic_batch(cfg, shape, DataConfig(), s, dev)
    step(state, batch(0))                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    expect = _train_launches(cfg)
    rows = []
    for s in range(1, TRAIN_STEPS + 1):
        b = batch(s)
        fa.launches = ss.launches = 0
        with (routed(logits=False) if cfg.is_moe
              else contextlib.nullcontext()) as calls:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _, m = step(state, b)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
        row = {"step": s, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "ms": ms,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
               "launches": {"flash_attention": fa.launches,
                            "ssd_scan": ss.launches}}
        if cfg.is_moe:      # the forward's calls (the recompute's follow)
            row["kept_share"] = kept_shares(calls[:cfg.n_layers],
                                            cfg.n_layers)[0]
        rows.append(row)
        print(f"train {arch}: " + json.dumps(row), flush=True)
        check(row["launches"] == expect, f"{arch}: launches per train step "
              f"{row['launches']}, expected {expect}")
        check(all(map(lambda x: x == x and abs(x) != float("inf"),
                      (row["loss"], row["grad_norm"]))),
              f"{arch}: non-finite loss or grad norm")
        check(row["grad_norm"] > 0, f"{arch}: zero gradient")
    ms = sorted(r["ms"] for r in rows)
    stats = {"arch": arch, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
             "n_params": n_params, "state_gb": state_gb,
             "ms_per_step_median": ms[len(ms) // 2],
             "tokens_per_s_median": TRAIN_BATCH * TRAIN_SEQ / ms[len(ms) // 2]
             * 1e3,
             "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches_per_step": expect, "card": card()}
    print(f"train {arch}: " + json.dumps(stats), flush=True)
    check(stats["max_memory_allocated_gb"] * 1e9
          < torch.cuda.get_device_properties(0).total_memory,
          f"{arch}: peak memory above the card's")
    b = batch(TRAIN_STEPS + 1)
    prof = profile_round(lambda: step(state, b), label=f"{arch} train step",
                         spans=TRAIN_SPANS)
    span = {k: v["device_s"] for k, v in prof["spans"].items()}
    fwd, opt = span.get("train forward", 0.0), span.get("adamw", 0.0)
    back = prof["device_busy_s"] - fwd - opt
    kern = sum(span.get(k, 0.0) for k in TRAIN_SPANS[2:])
    print(f"train {arch}, where a step's device time goes: " + json.dumps({
        "forward_s": fwd, "backward_s": back, "adamw_s": opt,
        "kernels_backward_s": kern,
        "kernels_backward_share_of_step": (
            kern / prof["device_busy_s"] if prof["device_busy_s"]
            else "not measured"),
        "card": card()}), flush=True)
    print(f"{arch} trained: {time.perf_counter() - t0:.1f} s of phase",
          flush=True)
    del state
    return stats


def learn_on_card(dev):
    """tests/test_smoke_archs.py's learnability test on the card:
    qwen1.5-4b at smoke() size, LEARN_STEPS steps of the repetitive stream
    through the kernels, held to its two inequalities."""
    import numpy as np
    import torch
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import RunOptions
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (TrainHparams, init_train_state,
                                        make_train_step)
    t0 = time.perf_counter()
    cfg = get(LEARN_ARCH).smoke()
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(2),
                             dev)
    hp = TrainHparams(opts=RunOptions(q_block=32, kv_block=32, remat=False),
                      optimizer=AdamWConfig(lr=5e-3, warmup_steps=10,
                                            weight_decay=0.0))
    step = make_train_step(cfg, hp)
    shape = ShapeConfig("smoke", 64, 2, "train")
    fa.launches = 0
    losses = [step(state, synthetic_batch(cfg, shape, DataConfig(), s, dev))[1]
              ["loss"] for s in range(LEARN_STEPS)]
    losses = torch.stack(losses).tolist()
    print(f"learnability ({LEARN_ARCH} smoke, {LEARN_STEPS} steps on the "
          f"card): " + json.dumps({
              "first": losses[:5], "last": losses[-10:],
              "flash_attention_launches": fa.launches,
              "seconds": time.perf_counter() - t0}), flush=True)
    check(bool(np.isfinite(losses).all()), "learnability: non-finite loss")
    check(min(losses[-10:]) < losses[0] * 0.99, "learnability: the loss did "
          "not fall by 1 %")
    check(min(losses[-10:]) < min(losses[:5]), "learnability: the last ten "
          "losses are not below the first five")
    check(fa.launches == LEARN_STEPS * cfg.n_layers,
          f"learnability: {fa.launches} flash_attention launches")


def checkpoint_on_card(dev):
    """zamba2-1.2b at full width cut to CKPT_LAYERS layers: two train steps,
    a save through ``CheckpointManager(device="cuda")`` (the commit record
    an OCC transaction on the card, read back by ``latest_committed_step``
    through ``hybrid_lookup``), every array read back bit for bit, the
    committed step, hash_probe's launches in the commit's rounds, then a
    resumed third step equal to the uninterrupted run's (loss and grad
    norm, bit for bit)."""
    import dataclasses
    import shutil
    import torch
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import ShapeConfig
    from repro_torch.configs.registry import get
    from repro_torch.data.pipeline import DataConfig, synthetic_batch
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.train.step import init_train_state, make_train_step
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get(TRAIN_ARCH), n_layers=CKPT_LAYERS)
    state = init_train_state(cfg, torch.Generator(device=dev).manual_seed(0),
                             dev)
    step = make_train_step(cfg)
    shape = ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train")
    batch = lambda s: synthetic_batch(cfg, shape, DataConfig(), s, dev)
    for s in range(2):
        step(state, batch(s))
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    mgr = CheckpointManager(d, device=dev)
    hp.launches = 0
    t1 = time.perf_counter()
    path = mgr.save(2, state)
    save_s = time.perf_counter() - t1
    in_commit = hp.launches
    latest = mgr.latest_committed_step()
    in_lookup = hp.launches - in_commit
    disk_gb = sum(f.stat().st_size for f in path.iterdir()) / 1e9
    t1 = time.perf_counter()
    at, restored = mgr.restore()
    restore_s = time.perf_counter() - t1
    flat_a, flat_b = _flat(state), _flat(restored)
    same = (set(flat_a) == set(flat_b) and all(
        flat_a[k].dtype == flat_b[k].dtype
        and flat_b[k].device == flat_a[k].device
        and torch.equal(flat_a[k], flat_b[k]) for k in flat_a))
    _, m_whole = step(state, batch(2))
    _, m_resumed = step(restored, batch(2))
    pair = {k: (float(m_whole[k]), float(m_resumed[k]))
            for k in ("loss", "grad_norm")}
    shutil.rmtree(d, ignore_errors=True)
    print(f"checkpoint ({TRAIN_ARCH} at full width, {CKPT_LAYERS} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}): " + json.dumps({
              "saved_step": 2, "latest_committed_step": latest,
              "restored_step": at, "arrays": len(flat_a), "disk_gb": disk_gb,
              "save_s": save_s, "restore_s": restore_s,
              "hash_probe_launches_commit_tx": in_commit,
              "hash_probe_launches_read_back": in_lookup,
              "bit_for_bit": same, "third_step_whole_vs_resumed": pair,
              "seconds": time.perf_counter() - t0, "card": card()}),
          flush=True)
    check(latest == 2 and at == 2, f"checkpoint: latest {latest}, restored "
          f"{at}, expected 2")
    check(same, "checkpoint: an array did not come back bit for bit")
    check(in_commit + in_lookup >= 1 and in_lookup >= 1,
          "checkpoint: the commit record's rounds launched no hash_probe")
    check(all(a == b for a, b in pair.values()), f"checkpoint: the resumed "
          f"step differs from the uninterrupted one {pair}")


def _tensors(x):
    """Every tensor of a tensor, a dict or a dataclass of them, in order."""
    import dataclasses
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    else:
        yield x


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def profile_round(fn, label="tatp", spans=()):
    """Run ``fn`` once under torch.profiler and print (and return) its wall
    time, the summed device time of its kernels (the device's busy share;
    one stream, so kernels do not overlap), the kernels that took the most
    of it and, for each named span in ``spans``
    (``torch.profiler.record_function``, launched from the thread that
    records it), the device time of the kernels launched inside it.  The
    host's operators are recorded only where a span needs them: turning the
    recorded events into rows takes host time that grows with their number
    (printed as ``processing_s``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if spans else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_card = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    processing = time.perf_counter() - t0 - wall
    # a span's own row on the card is its annotation, not a kernel
    kernels = [e for e in on_card if e.key not in spans]
    dev_us = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0.0))
    busy = sum(dev_us(e) for e in kernels) / 1e6
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    span_us = lambda e: getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0))
    out = {"wall_s": wall, "device_busy_s": busy,
           "device_busy_share": busy / wall if busy else "not measured",
           "kernel_launches": sum(e.count for e in kernels),
           "top_kernels": [{"name": e.key[:60], "count": e.count,
                            "device_s": dev_us(e) / 1e6} for e in top],
           "host_operators_recorded": bool(spans), "processing_s": processing}
    if spans:
        out["spans"] = {e.key: {"count": e.count,
                                "device_s": span_us(e) / 1e6}
                        for e in on_card if e.key in spans}
    print(f"{label} profile: " + json.dumps(out), flush=True)
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving on the mesh: eight gloo ranks sharing the card, the
# same group meshed (1, 8) and (2, 4), each arch at full width
# ---------------------------------------------------------------------------
TP_DEADLINE_S, TP_SEED = 300, 31
# (arch, mesh, float32 parity (B, prompt, decode), bf16 serving (B, prompt,
# decode)): qwen1.5-4b's 20 heads do not divide 8, so the attention runs
# sequence-parallel and the cache is sequence-sharded ("seq"); glm4-9b's 32
# heads split 4 ways by heads, its 2 kv heads do not (K/V repeated, 64 of a
# kv head's 128 columns a rank), and the batch splits over data;
# mamba2-780m's 48 SSM heads and 3072 d_inner channels split 8 ways alike,
# so ssd_scan runs at 6 heads a rank; zamba2-1.2b's 64 SSM heads run 16 a
# rank and its shared block's 32 heads split by heads, the batch over data
# (one row a rank)
# (a rank); whisper-medium's 16 heads split 8 ways, 2 a rank, in all three
# attentions, its self cache by heads ("heads") and its cross cache by kv
# heads, over the stub frontend's 1,500 frames
TP_CASES = (("qwen1.5-4b", (1, 8), (1, 512, 4), (2, 2048, 8)),
            ("glm4-9b", (2, 4), (2, 512, 4), (4, 2048, 8)),
            ("mamba2-780m", (1, 8), (1, 512, 4), (2, 2048, 8)),
            ("zamba2-1.2b", (2, 4), (2, 512, 4), (2, 2048, 8)),
            ("whisper-medium", (1, 8), (1, 416, 4), (2, 416, 8)))
TP_LAYERS, TP_PARITY_LAYERS = 4, 2
# (float32 parity, bf16 serving) layers where an arch takes others than
# (TP_PARITY_LAYERS, TP_LAYERS): zamba2's 6 Mamba layers, the shared block
# once and 1 tail layer in both.  whisper's encoder is cut to as many
# layers as its decoder (2 + 2, 4 + 4: _tp_cfg)
TP_DEPTH = {"zamba2-1.2b": (7, 7)}
# float32 parity, the ranks against the one-rank run, as a share of the
# logit range.  qwen1.5-4b at 2 layers is well conditioned: a 1e-7
# relative change of its embeddings moved its logits by 1.056e-5 of their
# range, under a quarter of F32_REL_FAMILY.  glm4-9b at 2 layers is not:
# the same change moved its logits by 3.978e-4 of their range (its weights
# at the reference's init scale for 2 stacked layers, 1/sqrt(2), make its
# scores sharp; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section 6).  By
# the rule of MOE_F32_REL and LLAVA_F32_REL its limit sits several times
# above that conditioning, chosen from it before any parity reading, and
# the run fails if the conditioning passes a quarter of the limit.
# mamba2-780m at 2 layers (at its 48-layer init scale, full_scale_stacks)
# is not well conditioned either: the same change moved its logits by
# 9.918e-5 of their range (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md section
# 6), above a quarter of F32_REL_FAMILY, so its limit is 1e-3, ten times
# that conditioning (set after the run that measured it, whose parity read
# 1.243e-4).  zamba2-1.2b's is its card-against-CPU limit F32_REL.
# whisper-medium at 2 + 2 layers (at its 24-layer init scale) is not well
# conditioned either.  A 1e-7 change of its frames crosses the encoder's
# bf16 input rounding (2.445e-2 of the logit range; every rank rounds the
# same frames as the one-rank run does), so its conditioning changes the
# encoder's first continuous values instead, the first layer's q, k and v
# weights, with the embeddings: 2.263e-4 of the range (a second draw,
# seed 32: 2.596e-4), while the decoder path alone (the encoder output
# held, as whisper_card_vs_cpu holds it) read 2.081e-5; its weights at
# the reference's init scale make the encoder's attention sharp (NVIDIA
# H100 80GB HBM3, 700.00 W; PERF.md section 6).  Its limit is 2e-3, ~9x
# that conditioning by the rule above, set after the first parity run,
# which read 2.907e-4 against F32_REL_FAMILY with the held conditioning.
TP_F32_REL = {"qwen1.5-4b": F32_REL_FAMILY, "glm4-9b": 2e-3,
              "mamba2-780m": 1e-3, "zamba2-1.2b": F32_REL,
              "whisper-medium": 2e-3}
# qwen1.5-4b's forward with pad_heads against without, over all 512
# positions, as a share of the largest |logit|.  Both branches reorder
# float32 sums, and over all positions the 2-layer model is ill-conditioned
# (its attention at the reference's init scale is sharp): padded against
# unpadded read 7.978e-4, above F32_REL_FAMILY, and a 1e-7 relative change
# of the embeddings moved the one-rank forward by 7.661e-4, while the last
# position (the parity runs') moved by 1.056e-5 (NVIDIA H100 80GB HBM3,
# 700.00 W; PERF.md section 6).  This limit was chosen after the first of
# those readings, ~6x above it; the run measures the forward's conditioning
# over every position and fails if it passes a quarter of the limit.
TP_PAD_REL = 5e-3


def _tp_steps(cfg, topo, params, tokens, prompt, decode, extra=None):
    """Prefill logits, then ``decode`` teacher-forced steps' logits, each
    the rank's block, with the greedy tokens across the vocab blocks.
    ``extra``: the audio family's frames, {"frames": tensor}."""
    from repro_torch.models.embedding import greedy
    from repro_torch.serving.decode import make_decode_step, make_prefill
    logits, cache = make_prefill(cfg, prompt, decode, topo)(
        params, dict(extra or {}, tokens=tokens[:, :prompt]))
    out = [logits]
    step = make_decode_step(cfg, topo)
    for t in range(prompt, prompt + decode):
        logits, cache = step(params, cache, tokens[:, t])
        out.append(logits)
    return out, [greedy(cfg, x, topo) for x in out]


def _tp_depth(arch):
    """(float32 parity layers, bf16 serving layers) of a TP_CASES arch."""
    return TP_DEPTH.get(arch, (TP_PARITY_LAYERS, TP_LAYERS))


def _tp_cfg(arch, depth):
    """``arch`` cut to ``depth`` layers (whisper: as many encoder layers)."""
    import dataclasses
    from repro_torch.configs.registry import get
    full = get(arch)
    return dataclasses.replace(full, n_layers=depth, **(
        {"encoder_layers": depth} if full.family == "audio" else {}))


@contextlib.contextmanager
def kept_encoder(box):
    """whisper's ``encode`` keeping its output in ``box["enc"]``."""
    from repro_torch.models import whisper
    saved = whisper.encode

    def encode(*args, **kw):
        box["enc"] = out = saved(*args, **kw)
        return out
    whisper.encode = encode
    try:
        yield box
    finally:
        whisper.encode = saved


def _tp_params(cfg, topo, dev, dtype=None):
    """The seeded tree (TP_SEED) drawn leaf by leaf on the card and cut to
    this rank's blocks (topo None: the whole tree), in ``dtype`` if given;
    an SSM, hybrid or audio cut's stacks rescaled to the full depth's init
    (full_scale_stacks), its blocks as the whole tree's."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.models import api
    from repro_torch.parallel.sharding import init_params
    p = init_params(api.param_specs(cfg), torch.Generator(
        device=dev).manual_seed(TP_SEED), dev, topo=topo)
    if dtype is not None:
        p = _map_tree(p, lambda t: t.to(dtype))
    if cfg.ssm_state or cfg.family == "audio":
        full_scale_stacks(cfg, get(cfg.name), p)
    return p


def tp_ssd(topo, cfg, B, S, dev):
    """ssd_scan at the rank's prefill shape (B rows of S tokens, the rank's
    heads of ``cfg``'s Mamba layer): against its plain version on every
    rank; then timed on the last rank alone, beside its plain version and
    its float32 bound, while the other ranks wait (no PyTorch call
    computes it)."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.models import mamba2 as M
    r = dist.get_rank()
    Q = min(cfg.ssm_chunk, S)
    shape = (B, S // Q, Q, M.layout(cfg, topo).hn, cfg.ssm_head_dim,
             cfg.ssm_state)
    x = ssd_inputs(*shape, dev, 60 + r)
    y, st = ss.ssd_scan(*x, h_tile=1)
    yp, sp = ss.ssd_scan_plain(*x)
    err = max(float((y - yp).abs().max()), float((st - sp).abs().max()))
    scale = max(1.0, float(yp.abs().max()), float(sp.abs().max()))
    dist.barrier()
    out = {"ssd_err": err, "ssd_limit": SSD_RTOL * scale,
           "ssd_shape": shape}
    if r == dist.get_world_size() - 1:
        out.update(
            ssd_ms=_mean(time_cuda(lambda: ss.ssd_scan(*x, h_tile=1), 10)),
            ssd_plain_ms=_mean(time_cuda(lambda: ss.ssd_scan_plain(*x), 3)),
            ssd_bound=ssd_bound(*shape))
    dist.barrier()
    return out


def tp_qoffset(topo, B, S, Hq, D, dev):
    """flash_attention with q_offset at the sequence-parallel rank's prefill
    shape (its S/tp query rows of every head against every key, bf16,
    causal): against its plain version within flash_checks' limits, on
    every rank; then timed on rank 0 alone, beside its plain version, its
    bound and scaled_dot_product_attention with the same boolean mask (the
    same function), while the other ranks wait."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    tp = topo.axis_sizes["model"]
    r = topo.axis_index("model")
    Sq, off, BH = S // tp, r * (S // tp), B * Hq
    g = torch.Generator(device=dev).manual_seed(40 + r)
    mk = lambda n, a: (torch.randn((BH, n, D), generator=g, device=dev) *
                       a).to(torch.bfloat16)
    q, k, v = mk(Sq, 0.5), mk(S, 0.5), mk(S, 0.5)
    tag = (f"flash_attention with q_offset {off} on rank {r} (BH={BH}, "
           f"Sq={Sq}, Sk={S}, D={D}, causal, bf16)")
    got = fa.flash_attention_bhsd(q, k, v, q_offset=off)
    err = _flash_compare(tag, got, fa.flash_attention_plain(
        q, k, v, q_offset=off), "bfloat16")
    dist.barrier()
    out = {"qoff_err": err}
    if r == tp - 1 and topo.axis_index("data") == 0:
        # the last rank's rows see the most keys: the heaviest call
        sdpa = torch.nn.functional.scaled_dot_product_attention
        keep = (torch.arange(S, device=dev)[None]
                <= off + torch.arange(Sq, device=dev)[:, None])
        q4, k4, v4 = (t.reshape(B, Hq, -1, D) for t in (q, k, v))
        out.update(
            qoff_ms=_mean(time_cuda(lambda: fa.flash_attention_bhsd(
                q, k, v, q_offset=off), 20)),
            qoff_plain_ms=_mean(time_cuda(lambda: fa.flash_attention_plain(
                q, k, v, q_offset=off), 3)),
            qoff_sdpa_ms=_mean(time_cuda(lambda: sdpa(q4, k4, v4,
                                                      attn_mask=keep), 20)),
            qoff_bound=flash_bound(BH, Sq, S, D, True, 2, q_offset=off),
            qoff_shape=(BH, Sq, S, D, off))
    dist.barrier()
    return out


def tp_whisper_flash(topo, cfg, B, S, dev):
    """flash_attention (bf16) at whisper's three rank shapes in its serving
    prefill (B rows, the rank's heads, D 64): the encoder's self-attention
    over the frames (non-causal), the decoder's causal self-attention over
    the S-token prompt and its cross-attention (S queries over the frames),
    each with diffuse and sharp scores against its plain version within
    flash_checks' limits on every rank; then each timed on rank 0 alone,
    beside its plain version, its bound and scaled_dot_product_attention
    (the same function), while the other ranks wait."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import whisper
    r = dist.get_rank()
    (_, _, H), (_, _, Hkv) = whisper.heads(cfg, topo)
    D, F = cfg.head_dim, cfg.encoder_seq
    shapes = (("encoder", F, F, False), ("decoder self", S, S, True),
              ("cross", S, F, False))
    out = {"wflash_err": 0.0, "wflash": []}
    for i, (label, Sq, Sk, causal) in enumerate(shapes):
        kw = dict(causal=causal, group=H // Hkv)
        for scale in (0.5, 1.5):
            q, k, v = flash_inputs(B, Sq, Sk, H, Hkv, D, "bfloat16", dev,
                                   70 + 8 * i + r, qk_scale=scale)
            tag = (f"flash_attention at whisper's {label} rank shape on rank "
                   f"{r} (BH={B * H}, Sq={Sq}, Sk={Sk}, D={D}, "
                   f"{'causal' if causal else 'non-causal'}, bf16, scores "
                   f"of std {scale * scale})")
            out["wflash_err"] = max(out["wflash_err"], _flash_compare(
                tag, fa.flash_attention_bhsd(q, k, v, **kw),
                fa.flash_attention_plain(q, k, v, **kw), "bfloat16"))
        dist.barrier()
        if r == 0:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            q4 = q.reshape(B, H, Sq, D)
            k4, v4 = (t.reshape(B, Hkv, Sk, D) for t in (k, v))
            out["wflash"].append(dict(
                label=label, shape=(B * H, Sq, Sk, D, causal),
                ms=_mean(time_cuda(lambda: fa.flash_attention_bhsd(
                    q, k, v, **kw), 20)),
                plain_ms=_mean(time_cuda(lambda: fa.flash_attention_plain(
                    q, k, v, **kw), 3)),
                sdpa_ms=_mean(time_cuda(lambda: sdpa(
                    q4, k4, v4, is_causal=causal, enable_gqa=H > Hkv), 20)),
                bound=flash_bound(B * H, Sq, Sk, D, causal, 2,
                                  group=H // Hkv)))
        dist.barrier()
    return out


def tp_rank(rank, world, dev, cases):
    """A rank of the tensor-parallel world on ``dev``: for each of
    ``cases`` (TP_CASES), its mesh
    over the one group (SERVE_RULES), then the float32 parity run at
    its parity depth (prefill and teacher-forced decode; qwen1.5-4b's
    forward with and without pad_heads; whisper's frames, its encoder
    output and flash_attention's launches kept), then bf16 serving at its
    serving depth through launch.serve with flash_attention's and
    ssd_scan's launches counted, qwen1.5-4b's q_offset kernel, the SSM
    archs' ssd_scan and whisper's three attentions at the rank's
    shapes."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.models.embedding import vocab_block
    from repro_torch.models.transformer import RunOptions
    from repro_torch.parallel.sharding import SERVE_RULES, Topology
    torch.backends.cuda.matmul.allow_tf32 = False
    blk = lambda t, topo: topo.block(t, "batch", *(None,) * (t.dim() - 1))
    out = {}
    for arch, shape, (B, P, Dn), (Bs, Ps, Ds) in cases:
        topo = Topology(make_mesh(shape, ("data", "model"), dev),
                        dict(SERVE_RULES))
        res = out[arch] = {"coord": topo.coordinate()}
        depth, serve_depth = _tp_depth(arch)
        cfg = _tp_cfg(arch, depth)
        t0 = time.perf_counter()
        p = _tp_params(cfg, topo, dev, torch.float32)
        batch = serve.prompt_batch(cfg, B, P, Dn, dev)
        toks = blk(batch["tokens"], topo)
        extra = {k: blk(v, topo) for k, v in _stub_inputs(batch).items()}
        fa.launches = 0
        with kept_encoder({}) as box:
            steps, greedy = _tp_steps(cfg, topo, p, toks, P, Dn, extra)
        res["parity_launches"] = fa.launches
        if "enc" in box:
            res["enc"] = box["enc"].cpu()
        res["parity"] = [s.cpu() for s in steps]
        res["greedy"] = [x.cpu() for x in greedy]
        if arch == cases[0][0]:
            lo, n = vocab_block(cfg, topo)
            real = (lo + torch.arange(n, device=dev)) < cfg.vocab_size
            fwd = [api.forward(cfg, p, {"tokens": toks[:, :P]},
                               opts=RunOptions(remat=False, pad_heads=pad),
                               topo=topo)[..., real]
                   for pad in (False, True)]
            res["pad_diff"] = float((fwd[1] - fwd[0]).abs().max())
            res["pad_max"] = float(fwd[0].abs().max())
            del fwd
        res["parity_s"] = time.perf_counter() - t0
        del p
        torch.cuda.empty_cache()
        cfg = _tp_cfg(arch, serve_depth)
        p = _tp_params(cfg, topo, dev)
        batch = {k: blk(v, topo) for k, v in serve.prompt_batch(
            cfg, Bs, Ps, Ds, dev).items()}
        serve.serve(cfg, p, batch, 64, 2, topo)           # warm-up
        fa.launches = ss.launches = 0
        ids, st = serve.serve(cfg, p, batch, Ps, Ds, topo)
        res.update(launches=fa.launches, ssd_launches=ss.launches,
                   ids=ids.cpu(),
                   prefill_ms=st["prefill_ms"],
                   decode_ms_step=st["decode_ms"] / (Ds - 1),
                   finite=bool(torch.isfinite(st["last_logits"]).all()),
                   cache_len=int(st["cache"]["len"].max()),
                   cache_shape={k: tuple(v.shape) for k, v in
                                st["cache"].items() if k != "len"})
        del p, st
        torch.cuda.empty_cache()
        if arch == cases[0][0]:
            res.update(tp_qoffset(topo, Bs, Ps, cfg.n_heads, cfg.head_dim,
                                  dev))
        if cfg.ssm_state:
            res.update(tp_ssd(topo, cfg, batch["tokens"].shape[0], Ps, dev))
        if cfg.family == "audio":
            res.update(tp_whisper_flash(topo, cfg, batch["tokens"].shape[0],
                                        Ps, dev))
    return out


def tp_one_rank(dev, cases):
    """The one-rank float32 runs the ranks' parity runs are held to, on the
    card, with each model's conditioning: the logit change for a 1e-7
    relative change of the embeddings (whisper: and of its first encoder
    layer's q, k and v weights; for information the same change of the
    embeddings with the encoder output held, and with the frames)."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.parallel.sharding import ONE_DEVICE
    from repro_torch.models import api
    from repro_torch.models.transformer import RunOptions
    out = {}
    for arch, _, (B, P, Dn), _ in cases:
        cfg = _tp_cfg(arch, _tp_depth(arch)[0])
        V = cfg.vocab_size
        p = _tp_params(cfg, None, dev, torch.float32)
        batch = serve.prompt_batch(cfg, B, P, Dn, dev)
        toks, extra = batch["tokens"], _stub_inputs(batch)
        run = lambda q, x=extra: _tp_steps(cfg, ONE_DEVICE, q, toks, P, Dn,
                                           x)[0]
        fwd = lambda q: api.forward(cfg, q, {"tokens": toks[:, :P]},
                                    opts=RunOptions(remat=False))[..., :V]
        first = arch == cases[0][0]
        with kept_encoder({}) as box:
            ref = run(p)
        f0 = fwd(p) if first else None
        g = torch.Generator(device=dev).manual_seed(2)
        shake = lambda t: t.float() * (1 + 1e-7 * torch.randn(
            t.shape, generator=g, device=dev))
        moved = lambda got: max(float((a - b)[:, :V].abs().max()
                                      / b[:, :V].abs().max())
                                for a, b in zip(got, ref))
        e = p["embed"]
        p["embed"] = shake(e)
        out[arch] = dict(ref=[x.cpu() for x in ref])
        if "enc" in box:
            # whisper, for information: the encoder output held, then the
            # frames unheld; then the limit's: its first continuous values
            # after the bf16 input rounding, the first layer's q, k and v
            with held_encoder(shake(box["enc"])):
                out[arch]["moved_held"] = moved(run(p))
            out[arch]["moved_frames"] = moved(run(p, {
                k: shake(v) for k, v in extra.items()}))
            out[arch]["enc"] = box["enc"].cpu()
            for n in ("s_wq", "s_wk", "s_wv"):
                w = p["enc_layers"][n]
                w[0] = shake(w[0])
        out[arch]["moved"] = moved(run(p))
        if first:                   # the forward over every position
            out[arch]["fwd_moved"] = float((fwd(p) - f0).abs().max()
                                           / f0.abs().max())
        del p, e, f0, box
        torch.cuda.empty_cache()
    return out


def _tp_launches(cfg):
    """(flash_attention, ssd_scan) launches of one prefill of a TP_CASES
    cut: an attention a dense layer, an application of zamba2's shared
    block, whisper's three a layer pair (_family_launches); a scan a Mamba
    layer."""
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.shared_attn_every, cfg.n_layers
    n = _family_launches(cfg)
    return n["flash_attention"], n["ssd_scan"]


def _tp_gather(ranks, arch, key, i):
    """Step i of the ranks' ``key`` blocks put back together: batch rows
    over data, vocab columns over model."""
    import torch
    rows = {}
    for r in ranks:
        c = r[arch]["coord"]
        rows.setdefault(c["data"], {})[c["model"]] = r[arch][key][i]
    return torch.cat([torch.cat([b[m] for m in sorted(b)], -1)
                      for _, b in sorted(rows.items())], 0)


def tensor_parallel(dev, cases=TP_CASES):
    """TP_WORLD gloo ranks sharing the card (NCCL refuses two ranks on one
    device), with the one-rank float32 runs on the card meanwhile in this
    process: each TP_CASES arch's float32 parity against its one-rank run
    within its TP_F32_REL share of the logit range, greedy tokens equal
    (its conditioning at most a quarter of that limit; whisper's encoder
    output block of each rank printed beside it); qwen1.5-4b's
    forward with pad_heads (20 -> 24 heads) against without within
    TP_PAD_REL; on every rank per prefill, of the parity run and of the
    serving run, one flash_attention launch per attention layer (zamba2:
    per application of the shared block; whisper: three per layer pair)
    and one ssd_scan launch per Mamba layer; the q_offset kernel, ssd_scan
    and whisper's three attentions at the rank's shapes against their
    plain versions on every rank; prefill and decode ms per rank."""
    import torch
    from repro_torch.configs.registry import get
    from repro_torch.testing.ranks import run_ranks
    refs = {}
    world = cases[0][1][0] * cases[0][1][1]
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, world, device=dev, backend="gloo",
                      args=(dev, cases), deadline_s=TP_DEADLINE_S,
                      meanwhile=lambda: refs.update(tp_one_rank(dev, cases)))
    world_s = time.perf_counter() - t0
    for arch, shape, (B, P, Dn), (Bs, Ps, Ds) in cases:
        ref = refs[arch]
        moved, rel = ref["moved"], TP_F32_REL[arch]
        V = get(arch).vocab_size
        got = [_tp_gather(ranks, arch, "parity", i) for i in range(Dn + 1)]
        depth, serve_depth = _tp_depth(arch)
        enc = ("and the first encoder layer's q, k and v weights "
               if "enc" in ref else "")
        print(f"tensor parallel {arch} {shape}: a 1e-7 relative change of "
              f"the embeddings {enc}moves the one-rank float32 logits by "
              f"{moved:.3e} of their range (at most a quarter of the parity "
              f"limit {rel}) [{card()}]", flush=True)
        check(moved <= rel / 4, f"{arch}: conditioned worse than the "
              "tensor-parallel parity limit assumes")
        if "enc" in ref:
            far = [float((r[arch]["enc"] - ref["enc"]).abs().max()
                         / ref["enc"].abs().max()) for r in ranks]
            print(f"tensor parallel {arch} {shape}, information: the same "
                  f"change of the embeddings with the encoder output held "
                  f"(and changed alike) moves them by "
                  f"{ref['moved_held']:.3e}, with the frames (it crosses the "
                  f"encoder's bf16 input rounding) by "
                  f"{ref['moved_frames']:.3e}; each rank's encoder output "
                  f"from the one-rank run's, of its largest |value|: "
                  f"{[f'{x:.3e}' for x in far]}", flush=True)
        _compare(f"tensor parallel {arch} {shape}, {depth} layers"
                 f"{' + ' + str(depth) if 'enc' in ref else ''}"
                 f", {B} x {P} + {Dn}, float32, {world} ranks vs one, limit "
                 f"{rel}", got, ref["ref"], V, rel)
        rows = B // shape[0]               # a rank's batch rows
        for i in range(Dn + 1):
            want = got[i][:, :V].argmax(-1)
            for r in ranks:
                d = r[arch]["coord"]["data"]
                check(torch.equal(r[arch]["greedy"][i],
                                  want[d * rows:(d + 1) * rows]),
                      f"{arch}: a rank's greedy token differs from the "
                      f"argmax of the gathered logits at step {i}")
        n_attn, n_ssd = _tp_launches(_tp_cfg(arch, serve_depth))
        p_attn = _tp_launches(_tp_cfg(arch, depth))[0]
        for r in ranks:
            x = r[arch]
            check(x["launches"] == n_attn and x["ssd_launches"] == n_ssd,
                  f"{arch}: {x['launches']} flash_attention and "
                  f"{x['ssd_launches']} ssd_scan launches on rank "
                  f"{x['coord']} in a {serve_depth}-layer prefill (want "
                  f"{n_attn} and {n_ssd})")
            check(x["parity_launches"] == p_attn,
                  f"{arch}: {x['parity_launches']} flash_attention launches "
                  f"on rank {x['coord']} in the {depth}-layer float32 "
                  f"parity run (want {p_attn})")
            check(x["finite"] and x["cache_len"] == Ps + Ds - 1,
                  f"{arch}: non-finite logits or a wrong cache length")
            check(bool(((x["ids"] >= 0) & (x["ids"] < V)).all()),
                  f"{arch}: ids outside the vocabulary")
        print(f"tensor parallel {arch} {shape}, bf16, {serve_depth} layers"
              f"{' + ' + str(serve_depth) if 'enc' in ref else ''}, "
              f"{Bs} x {Ps} + {Ds}: {n_attn} flash_attention and {n_ssd} "
              f"ssd_scan launches a prefill on every rank ({p_attn} in the "
              f"float32 parity prefill); the cache blocks "
              f"{ranks[0][arch]['cache_shape']} a rank; prefill ms by rank "
              f"{[round(r[arch]['prefill_ms'], 3) for r in ranks]}, decode "
              f"ms a step by rank "
              f"{[round(r[arch]['decode_ms_step'], 3) for r in ranks]} "
              f"({world} ranks time-slice one card: not {world} cards' "
              f"times); the float32 parity runs "
              f"{max(r[arch]['parity_s'] for r in ranks):.1f} s a rank "
              f"[{card()}]", flush=True)
    qa, tp = cases[0][0], cases[0][1][1]
    Hq = get(qa).n_heads
    pad = max(r[qa]["pad_diff"] for r in ranks) / max(
        r[qa]["pad_max"] for r in ranks)
    moved = refs[qa]["fwd_moved"]
    print(f"tensor parallel {qa}: the forward with pad_heads ({Hq} -> "
          f"{-(-Hq // tp) * tp} heads) against without at tp {tp}, all "
          f"{cases[0][2][1]} positions: {pad:.3e} of the largest |logit| "
          f"(limit {TP_PAD_REL}); a 1e-7 relative change of the embeddings "
          f"moves the one-rank forward by {moved:.3e} (at most a quarter of "
          f"the limit) [{card()}]", flush=True)
    check(pad <= TP_PAD_REL, f"{qa}: pad_heads changes the forward")
    check(moved <= TP_PAD_REL / 4, f"{qa}: the forward is conditioned worse "
          "than the pad_heads limit assumes")
    err = max(r[qa]["qoff_err"] for r in ranks)
    t = next(r[qa] for r in ranks if "qoff_ms" in r[qa])
    BH, Sq, S, D, off = t["qoff_shape"]
    bms, bby = t["qoff_bound"]
    print(f"flash_attention with q_offset at {qa}'s rank shape (BH={BH}, "
          f"{Sq} rows at offset {off} over {S} keys, D={D}, causal, bf16): "
          f"max |kernel - plain| over the ranks {err:.3e}; kernel "
          f"{t['qoff_ms']:.4f} ms, plain {t['qoff_plain_ms']:.4f} ms, "
          f"scaled_dot_product_attention with the same boolean mask "
          f"{t['qoff_sdpa_ms']:.4f} ms (the same function), bound "
          f"{bms:.5f} ms ({bby}) [{card()}]", flush=True)
    for arch, shape, _, _ in cases:
        if not get(arch).ssm_state:
            continue
        t = next(r[arch] for r in ranks if "ssd_ms" in r[arch])
        bms, bby = t["ssd_bound"]
        over = max(r[arch]["ssd_err"] / r[arch]["ssd_limit"] for r in ranks)
        print(f"ssd_scan at {arch}'s rank prefill shape on {shape} (B, nc, "
              f"Q, H, P, N) = {t['ssd_shape']}: max |kernel - plain| over "
              f"the ranks {max(r[arch]['ssd_err'] for r in ranks):.3e} "
              f"({over:.3f} of its limit); kernel {t['ssd_ms']:.4f} ms, "
              f"plain {t['ssd_plain_ms']:.4f} ms, bound {bms:.5f} ms "
              f"({bby}, float32) [{card()}]", flush=True)
        check(over <= 1, f"ssd_scan at {arch}'s rank shape != plain")
    for arch, shape, _, _ in cases:
        if get(arch).family != "audio":
            continue
        err = max(r[arch]["wflash_err"] for r in ranks)
        for t in next(r[arch] for r in ranks if r[arch]["wflash"]
                      )["wflash"]:
            BH, Sq, Sk, D, causal = t["shape"]
            bms, bby = t["bound"]
            print(f"flash_attention at {arch}'s {t['label']} rank shape on "
                  f"{shape} (BH={BH}, Sq={Sq}, Sk={Sk}, D={D}, "
                  f"{'causal' if causal else 'non-causal'}, bf16): kernel "
                  f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
                  f"scaled_dot_product_attention(is_causal={causal}) "
                  f"{t['sdpa_ms']:.4f} ms (the same function), bound "
                  f"{bms:.5f} ms ({bby}); max |kernel - plain| of the three "
                  f"shapes over the ranks {err:.3e} [{card()}]", flush=True)
    print(f"tensor parallel: {world} ranks {world_s:.1f} s", flush=True)


KERNELS = {   # name: (source, the TPU kernel it replaces, bound by)
    "hash_probe": ("src/repro_torch/csrc/hash_probe.cu",
                   "src/repro/kernels/hash_probe.py:53", "bytes"),
    "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:93",
                        "operations"),
    "ssd_scan": ("src/repro_torch/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:77", "operations"),
}


def _kernel_name(line):
    """'flash_tc_kernel<64>' from ptxas's line naming a mangled entry."""
    import re
    mangled = line.split("'")[1] if "'" in line else line
    base = re.search(r"\d+((?:flash|ssd|hash)_[a-z_]+)", mangled)
    args = (["float"] if "IfLi" in mangled else []) + re.findall(r"Li(\d+)E",
                                                                  mangled)
    return (base.group(1) if base else mangled) + (f"<{','.join(args)}>"
                                                   if args else "")


def build_kernels():
    """Build every kernel library at once (one nvcc each, in parallel) and
    print the build times and the compiler's register and spill lines."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build

    def one(name):
        t0 = time.perf_counter()
        build.build(name)
        return time.perf_counter() - t0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = dict(zip(KERNELS, pool.map(one, KERNELS)))
    print(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f} s in "
          f"all)", flush=True)
    for name in KERNELS:
        build.load(name)
        log = build.BUILD_DIR / f"{name}.log"
        entry = spills = ""
        for line in log.read_text().splitlines() if log.exists() else []:
            if "Compiling entry" in line:      # one line per kernel
                entry = _kernel_name(line)
            elif "spill" in line:
                spills = line.strip()
            elif "registers" in line:
                print(f"ptxas {name}: {entry}: "
                      f"{line.split(':', 1)[-1].strip()}; {spills}", flush=True)
            elif "arning" in line or "Performance" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    # dynamic shared memory, which ptxas does not report (ssd_scan.cu's
    # run(), flash_attention.cu's tc::Cfg and run(), hash_probe.cu's launch())
    from repro_torch.kernels import hash_probe as hp
    from repro_torch.kernels import ssd_scan as ss
    probe = {w: 4 * hp.lanes_per_cta(w) * (32 * w + 4) for w in range(1, 9)}
    tc = {D: 1024 + 128 * D * 2 + (2 if D == 128 else 3) * 2 * 128 * D * 2
          + 128 for D in (16, 32, 64, 128)}
    f32 = {D: 4 * (64 * (D + 1) * 2 + 64 * D + 64 * 80)
           for D in (16, 32, 64, 128)}
    B, nc, Q, H, P, N = ssd_shape(SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT)
    print(f"dynamic shared memory per CTA: flash_attention bf16 by D "
          f"{json.dumps(tc)}, float32 by D {json.dumps(f32)}; ssd_scan at "
          f"the serving shape {ss.smem_bytes(Q, N, P)} B (the larger of "
          f"its two product kernels); hash_probe's tile by width "
          f"{json.dumps(probe)}", flush=True)


def kernel_rows():
    """One entry of the kernels line per kernel, its numbers still unset."""
    return {name: dict(name=name, route="cuda", source=src, replaces=rep,
                       launches=0, max_abs_err=None, ms=None, plain_ms=None,
                       bound_ms=None, bound_by=by, library_ms=None)
            for name, (src, rep, by) in KERNELS.items()}


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
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 means float32
    torch.backends.cudnn.allow_tf32 = False

    dev = "cuda"
    phase("device")
    print(f"card: {card()}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    build_kernels()
    rows = kernel_rows()

    phase("kernels against their plain versions")
    rows["hash_probe"]["max_abs_err"] = kernel_checks(dev)
    flash_checks(dev, rows)
    ssd_checks(dev, rows)

    phase("gate workload and small TATP: card against CPU")
    baseline = json.loads((ROOT / "benchmarks" / "BENCH_BASELINE.json")
                          .read_text())
    parity_checks(dev, baseline)

    phase("zamba2-1.2b at full width, 7 layers: card against CPU")
    card_vs_cpu(dev)

    phase("TATP main path")
    tatp = tatp_main_path(dev, rows)

    phase("replicated TATP: f=1 on the node ring")
    rep_run = replicated_tatp(dev, tatp)

    phase("traced TATP: the flight recorder at full width, f=0 and f=1")
    traced_tatp(dev, tatp, rep_run)

    phase("membership: epoch-stamped placement, kill -> rereplicate, "
          "migration")
    membership_path(dev, tatp, rep_run)
    del tatp, rep_run

    phase("ordered path: the B-link tree with range-scan transactions")
    ordered_path(dev)

    phase("the mesh dataplane: NCCL at world size 1, four ranks on the card")
    t0 = time.perf_counter()
    mesh_dataplane(dev)
    print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("tensor_parallel: qwen1.5-4b, mamba2-780m and whisper-medium on "
          "(1, 8), glm4-9b and zamba2-1.2b on (2, 4), eight ranks on the "
          "card")
    t0 = time.perf_counter()
    tensor_parallel(dev)
    print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serving main path: zamba2-1.2b")
    serving_main_path(dev, rows)

    t_new = time.perf_counter()
    phase("the dense and SSM families at smoke() size: card against CPU")
    t0 = time.perf_counter()
    family_smoke(dev)
    print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("gemma2-27b at full width, 2 layers: card against CPU")
    t0 = time.perf_counter()
    gemma_card_vs_cpu(dev)
    print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)

    phase("serving gemma2-27b and mamba2-780m at full size")
    families_served(dev)
    print(f"the dense and SSM families' phases: "
          f"{time.perf_counter() - t_new:.1f} s", flush=True)

    t_moe = time.perf_counter()
    phase("the MoE family at smoke() size: card against CPU")
    moe_smoke(dev)
    phase("deepseek-moe-16b at full width, 2 layers: card against CPU")
    t0 = time.perf_counter()
    moe_card_vs_cpu(dev)
    print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)
    phase("serving deepseek-moe-16b and granite-moe-1b-a400m at full size")
    moe_served(dev)
    print(f"the MoE family's phases: {time.perf_counter() - t_moe:.1f} s",
          flush=True)

    t_av = time.perf_counter()
    for title, fn in (
            ("the audio and VLM families at smoke() size: card against CPU",
             audio_vlm_smoke),
            ("whisper-medium at full width, 2 + 2 layers: card against CPU",
             whisper_card_vs_cpu),
            ("llava-next-mistral-7b at full width, 2 layers: card against "
             "CPU", llava_card_vs_cpu),
            ("serving whisper-medium and llava-next-mistral-7b at full size",
             audio_vlm_served)):
        phase(title)
        t0 = time.perf_counter()
        fn(dev)
        print(f"phase: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"the audio and VLM families' phases: "
          f"{time.perf_counter() - t_av:.1f} s", flush=True)

    t_train = time.perf_counter()
    phase("gradients through the kernels at the training shapes")
    kernel_gradients(dev)
    phase("training at smoke() size, every arch: card against CPU")
    train_card_vs_cpu(dev)
    phase("training zamba2-1.2b and granite-moe-1b-a400m at full size")
    train_full_size(dev, TRAIN_ARCH)
    train_full_size(dev, MOE_TRAIN_ARCH)
    phase("learnability through the kernels")
    learn_on_card(dev)
    phase("the Storm-committed checkpoint on the card")
    checkpoint_on_card(dev)
    print(f"the training phases: {time.perf_counter() - t_train:.1f} s",
          flush=True)

    print(f"chip_smoke: {time.perf_counter() - _T0:.1f} s in all", flush=True)
    print(card())                   # name, power limit as nvidia-smi gives them
    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
