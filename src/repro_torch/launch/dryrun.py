"""Dry run of every (architecture x input shape) cell on the production
meshes (counterpart of ``repro/launch/dryrun.py``).

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's memory and cost analyses.  PyTorch has no lowering to inspect,
so this dry run checks memory and layout: for each cell it builds, on the
``meta`` device over an :class:`~repro_torch.parallel.sharding.AbstractMesh`
(no process group, nothing allocated on any device, no forward run), rank
0's blocks of

  * the parameters (``param_specs``),
  * the AdamW state (master, m, v; training shapes),
  * the batch (``data.pipeline.batch_specs``, split over ``batch``),
  * the serving cache (``serving.decode.cache_specs``; prefill and decode),

under the reference's rule choice (its ``build_cell``): ``DEFAULT_RULES``
for training, or ``WIDE_DP_RULES`` under ``--opt tuned`` for the sub-scale
SSM and MoE archs (d_model <= 1536), and ``SERVE_RULES`` for prefill and
decode.  It records per cell the per-device bytes of each, every leaf's
block shape, the attention branch of each layer kind
(``transformer.attention_branch``), ``kv_mode``, the MoE dispatch mode and
``shape_applicable``'s skips, one JSON per cell under ``build/dryrun/``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch glm4-9b \
        --shape decode_32k --mesh multi
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import torch

from repro_torch.configs import SHAPES, shape_applicable
from repro_torch.configs.registry import ARCHS, get
from repro_torch.data.pipeline import batch_specs
from repro_torch.models import api, moe, transformer, whisper
from repro_torch.models.zamba import _shared_cfg
from repro_torch.optim.adamw import opt_state_specs
from repro_torch.parallel.sharding import (DEFAULT_RULES, SERVE_RULES,
                                           WIDE_DP_RULES, AbstractMesh,
                                           ParamSpec, Topology)
from repro_torch.serving.decode import cache_specs, kv_mode

OUT = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"
MESHES = {"single": (("data", "model"), (16, 16)),
          "multi": (("pod", "data", "model"), (2, 16, 16))}


def production_topology(mesh_kind: str, rules) -> Topology:
    axes, shape = MESHES[mesh_kind]
    return Topology(AbstractMesh(axes, shape), dict(rules))


def block_shape(topo: Topology, shape, logical_axes):
    """Rank 0's block of a (shape, logical axes) array, built on ``meta``
    (an AbstractMesh's coordinate is rank 0's)."""
    x = torch.empty(tuple(shape), dtype=torch.int8, device="meta")
    return tuple(topo.block(x, *logical_axes).shape)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def spec_blocks(topo: Topology, tree, path=""):
    """{leaf path: (block shape, dtype)} of a ParamSpec tree."""
    if isinstance(tree, ParamSpec):
        return {path: (block_shape(topo, tree.shape, tree.logical_axes),
                       tree.dtype)}
    out = {}
    for k in sorted(tree):
        out.update(spec_blocks(topo, tree[k], f"{path}['{k}']"))
    return out


def _summary(blocks):
    return {"bytes": sum(_nbytes(s, d) for s, d in blocks.values()),
            "shapes": {k: list(s) for k, (s, _) in blocks.items()}}


def rules_for(cfg, shape, opt: str = "baseline"):
    """The reference's rule set for a cell (``build_cell``)."""
    if shape.kind != "train":
        return SERVE_RULES, "SERVE_RULES"
    wide = (opt == "tuned" and cfg.d_model <= 1536
            and cfg.family in ("ssm", "moe"))
    return ((WIDE_DP_RULES, "WIDE_DP_RULES") if wide
            else (DEFAULT_RULES, "DEFAULT_RULES"))


def attention_branches(cfg, topo: Topology, pad_heads: bool):
    """The attention branch of each layer kind that takes
    ``transformer.attention_block``; the audio family's three attentions
    (``whisper.attention_branch``: the rank's heads, or every head)."""
    if cfg.family == "audio":
        br = whisper.attention_branch(cfg, topo)
        return {k: br for k in ("encoder", "self", "cross")}
    if cfg.family in ("dense", "moe", "vlm"):
        kinds = (("local", "global") if cfg.local_global_pattern == 2
                 else ("global",))
        br = transformer.attention_branch(cfg, topo, pad_heads)
        return {k: br for k in kinds}
    if cfg.family == "hybrid":
        return {"shared": transformer.attention_branch(_shared_cfg(cfg), topo,
                                                       pad_heads)}
    return {}


def build_cell(arch: str, shape_name: str, mesh_kind: str,
               opt: str = "baseline", moe_mode: str = "auto"):
    """The record of one cell (no file written)."""
    cfg, shape = get(arch), SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "opt": opt,
           "moe_mode": moe_mode, "kind": shape.kind}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return dict(rec, status="skipped", skipped=why)
    rules, rname = rules_for(cfg, shape, opt)
    topo = production_topology(mesh_kind, rules)
    rec.update(rules=rname, mesh_shape=dict(topo.axis_sizes))
    pspecs = api.param_specs(cfg)
    rec["params"] = _summary(spec_blocks(topo, pspecs))
    B, S = shape.global_batch, shape.seq_len
    rec["batch"] = _summary({
        k: (block_shape(topo, s, ("batch",) + (None,) * (len(s) - 1)), dt)
        for k, (s, dt) in batch_specs(cfg, shape).items()})
    if shape.kind == "train":
        rec["adamw"] = _summary(spec_blocks(topo, opt_state_specs(pspecs)))
    else:
        rec["cache"] = _summary({
            k: (block_shape(topo, s, ax), dt)
            for k, (s, ax, dt) in cache_specs(cfg, B, S, topo).items()})
    rec["per_device_bytes"] = sum(rec[k]["bytes"] for k in (
        "params", "adamw", "batch", "cache") if k in rec)
    rec["attention_branch"] = attention_branches(cfg, topo, opt == "tuned")
    if cfg.family in ("dense", "moe", "vlm", "audio", "hybrid"):
        rec["kv_mode"] = kv_mode(cfg, topo)
    if cfg.is_moe:
        dp = math.prod(n for a, n in topo.axis_sizes.items()
                       if a in ("pod", "data"))
        tokens = B * (1 if shape.kind == "decode" else S) // dp
        rec["moe_dispatch_mode"] = moe.moe_dispatch(cfg, topo, tokens,
                                                    moe_mode)
    rec["status"] = "ok"
    return rec


def run_cell(arch: str, shape_name: str, mesh_kind: str, *, out=OUT,
             opt: str = "baseline", moe_mode: str = "auto",
             tag_suffix: str = ""):
    """Build one cell and write its JSON under ``out``."""
    rec = build_cell(arch, shape_name, mesh_kind, opt, moe_mode)
    out = pathlib.Path(out)
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{arch}__{shape_name}__{mesh_kind}{tag_suffix}"
    (out / f"{tag}.json").write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", default="baseline", choices=["baseline", "tuned"])
    ap.add_argument("--moe-mode", default="auto",
                    choices=["auto", "rpc", "onesided"])
    ap.add_argument("--tag", default="",
                    help="suffix for the result file (e.g. __tuned)")
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args(argv)
    archs = sorted(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) \
        else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    n_ok = n_skip = 0
    for mesh_kind in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_kind, out=args.out,
                               opt=args.opt, moe_mode=args.moe_mode,
                               tag_suffix=args.tag)
                if rec["status"] == "skipped":
                    n_skip += 1
                    print(f"[skipped ] {arch}__{shape}__{mesh_kind}: "
                          f"{rec['skipped']}")
                    continue
                n_ok += 1
                print(f"[ok      ] {arch}__{shape}__{mesh_kind}: "
                      f"{rec['per_device_bytes'] / 2**30:.3f} GiB a device "
                      f"(params {rec['params']['bytes'] / 2**30:.3f}), "
                      f"attention {rec['attention_branch']}, kv_mode "
                      f"{rec.get('kv_mode')}, moe "
                      f"{rec.get('moe_dispatch_mode')}")
    print(f"\ndone: {n_ok} ok, {n_skip} skipped-by-rule, written under "
          f"{args.out}")
    return n_ok, n_skip


if __name__ == "__main__":
    main()
