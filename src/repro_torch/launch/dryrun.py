"""The dry run of the port (the counterpart of ``repro/launch/dryrun.py``):
``python -m repro_torch.launch.dryrun --all --mesh both``.

For every registry cell (arch x shape, ``cells_for``) it builds the train,
prefill or decode step at full width and analyses one shard of the
production mesh, (data=16, model=16) or (pod=2, data=16, model=16):
matmul FLOPs, an HBM traffic model, collective bytes, argument, output and
peak-live bytes, and the roofline's terms in the H100's rates
(``launch/step_analysis.py``). One JSON record a cell goes to ``--out``
(default ``results/dryrun_torch``), with the reference's fields.

Everything runs on the ``meta`` device: parameters from
``LM.param_shapes()``, the AdamW state from ``adamw_init`` of them, batch
and cache as meta tensors. Nothing is placed on any device, as the
reference lowers on placeholder host devices; that is the design of a dry
run, not a fallback from a card, so it runs the same with or without one.
The records are counts of one step's work, not times: the roofline terms
divide them by datasheet rates. The port has no HLO, so the reference's
``--save-hlo`` has no counterpart here, and ``compile_s`` none either;
``lower_s`` is the wall time of the meta run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import REGISTRY, SHAPES, cells_for, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.distributed.hints import ShardingHints
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.step_analysis import (analyze_step, argument_bytes,
                                              roofline)
from repro_torch.models import make_model
from repro_torch.models.model import _backend
from repro_torch.training.optimizer import AdamWConfig, adamw_init
from repro_torch.training.train import make_train_step

META = torch.device("meta")


def make_hints(opts: set[str], multi_pod: bool) -> ShardingHints | None:
    """--opt flags -> activation-sharding hints."""
    attn = "attn_dp" in opts or "attn_dp_noout" in opts
    moe = "moe_ep" in opts
    ce = "ce_chunk" in opts
    if not attn and not moe and not ce:
        return None
    dp = ("pod", "data") if multi_pod else ("data",)
    out_axes = None if "attn_dp_noout" in opts else dp
    return ShardingHints(attn_dp=dp + ("model",) if attn else None,
                         batch_axes=out_axes,
                         moe_ep="model" if moe else None,
                         dp=dp,
                         ce_chunk=16384 if ce else None)


def train_microbatches(cfg: ModelConfig) -> int:
    n = cfg.num_params
    if n > 20e9:
        return 16
    if n > 2e9:
        return 8
    return 4


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device=META)


def build_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               microbatches: int | None = None, remat: bool = True):
    """Returns (fn, args, rules, info): the step, its meta arguments at the
    cell's global shapes (parameters first), the mesh's sharding rules and
    {"microbatches"}."""
    model = make_model(cfg)
    rules = ShardingRules(mesh, cfg, train=(shape.kind == "train"))
    B, S = shape.global_batch, shape.seq_len
    params = model.param_shapes()
    info = {"microbatches": None}

    def batch():
        b = {}
        if cfg.input_kind == "embeds":
            b["embeds"] = _meta((B, S, cfg.d_model), torch.bfloat16)
        else:
            b["tokens"] = _meta((B, S), torch.int32)
        if shape.kind == "train":
            b["labels"] = _meta((B, S), torch.int32)
        return b

    if shape.kind == "train":
        n_micro = microbatches or train_microbatches(cfg)
        info["microbatches"] = n_micro
        fn = make_train_step(model, AdamWConfig(), num_microbatches=n_micro,
                             remat=remat)
        args = (params, adamw_init(params), batch())
    elif shape.kind == "prefill":
        def fn(params, batch):
            return model.prefill(params, batch, max_len=S)

        args = (params, batch())
    else:  # decode
        cache = _backend(cfg).init_cache(cfg, B, S, torch.bfloat16, META)

        def fn(params, tokens, cache):
            return model.decode_step(params, tokens, cache)

        args = (params, _meta((B,), torch.int32), cache)
    return fn, args, rules, info


# the depths (in layer groups) and microbatch counts a multiplied cell runs
CUT_GROUPS = (2, 3)
CUT_MICRO = (2, 4)


def _line(x0, y0, x1, y1, x):
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


def _extrapolate(runs, groups, n):
    """The counts at ``groups`` layer groups and ``n`` microbatches from
    runs {(g, k): counts} at the ``CUT_GROUPS`` x (``CUT_MICRO`` or (n,)):
    every count is linear in each trip count (the reference's rule: a loop
    body times its trip count), so two points a loop give it exactly."""
    (g0, g1) = CUT_GROUPS
    ks = sorted({k for _, k in runs})
    out = dict(runs[(g1, ks[-1])])
    for key, v in out.items():
        if not isinstance(v, (int, float)) or isinstance(v, bool):
            continue
        at_k = {k: _line(g0, runs[(g0, k)][key], g1, runs[(g1, k)][key],
                         groups) for k in ks}
        x = at_k[ks[0]] if len(ks) == 1 else \
            _line(ks[0], at_k[ks[0]], ks[1], at_k[ks[1]], n)
        out[key] = int(round(x)) if isinstance(v, int) else x
    return out


def analyze_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 microbatches=None, remat=True, hints=None,
                 multiply=True) -> dict:
    """One cell's analysis (``analyze_step`` of ``build_cell``'s step) on
    ``mesh``. With ``multiply`` (the default) the step runs at a cut depth
    (``CUT_GROUPS`` layer groups: layers, or the hybrid's groups of
    ``attn_every`` mamba layers and the shared block) and, in a train step
    of more than ``max(CUT_MICRO)`` microbatches, at ``CUT_MICRO``
    microbatches of the cell's size, and every count is carried to the
    full trip counts (``_extrapolate``). Argument bytes are the full
    depth's own; the top lists (``top_dots``, ``top_collectives``) are the
    largest cut run's. A shard with fewer batch rows than microbatches
    runs one row a microbatch (``shard_microbatches``)."""
    rules = ShardingRules(mesh, cfg, train=(shape.kind == "train"))
    n = (microbatches or train_microbatches(cfg)) \
        if shape.kind == "train" else None
    info = {"microbatches": n}
    if n is not None:
        # a shard whose batch is smaller than the microbatch count runs
        # one row a microbatch
        dp = rules._ax(rules._dp, shape.global_batch)
        axes = () if dp is None else (dp,) if isinstance(dp, str) else dp
        n = min(n, shape.global_batch // math.prod(mesh.shape[a]
                                                   for a in axes))
        info["shard_microbatches"] = n
    per = cfg.attn_every if cfg.family == "hybrid" else 1
    groups = cfg.num_layers // per
    if not multiply or groups <= CUT_GROUPS[-1]:
        fn, args, _, _ = build_cell(cfg, shape, mesh, microbatches=n,
                                    remat=remat)
        res = analyze_step(fn, *args, mesh=mesh, rules=rules, hints=hints)
        return {**info, **res, "microbatch_multiplied": False,
                "layers_multiplied": False}
    ks = CUT_MICRO if n is not None and n > max(CUT_MICRO) else (n,)
    runs = {}
    for g in CUT_GROUPS:
        cut = dataclasses.replace(cfg, num_layers=g * per)
        for k in ks:
            sh = shape if k is None or k == n else dataclasses.replace(
                shape, global_batch=shape.global_batch // n * k)
            fn, args, _, _ = build_cell(cut, sh, mesh, microbatches=k,
                                        remat=remat)
            runs[(g, k)] = analyze_step(fn, *args, mesh=mesh, rules=rules,
                                        hints=hints)
    res = roofline(_extrapolate(runs, groups, n))
    full = build_cell(cfg, shape, mesh, microbatches=n, remat=remat)[1]
    unused = {(int(u.split("/")[0]), tuple(u.split("/")[1:]))
              for u in res["unused_arguments"]}
    res["argument_size_in_bytes"] = argument_bytes(full, mesh, rules, unused)
    res["analyze_s"] = sum(r["analyze_s"] for r in runs.values())
    return {**info, **res,
            "microbatch_multiplied": len(ks) > 1, "layers_multiplied": True,
            "analyzed_layers": [g * per for g in CUT_GROUPS],
            "analyzed_microbatches": list(ks) if n is not None else None}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, *, microbatches=None,
             remat=True, opts: set | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "ok": False,
           "devices": 512 if multi_pod else 256,
           "opts": sorted(opts) if opts else []}
    t0 = time.time()
    opts = opts or set()
    try:
        mesh = make_production_mesh(multi_pod=multi_pod)
        res = analyze_cell(cfg, shape, mesh, microbatches=microbatches,
                           remat=remat, hints=make_hints(opts, multi_pod))
        rec["lower_s"] = round(time.time() - t0, 2)
        rec["flops"] = res["dot_flops"]
        rec["bytes_accessed"] = res["traffic_bytes"]
        rec.update(res)
        rec["ok"] = True
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: OK "
              f"({rec['lower_s']}s, flops {rec['flops']:.3e}, "
              f"coll {rec['collective_bytes']:.3e}B)")
        print(f"[dryrun]   memory: "
              f"args={rec['argument_size_in_bytes'] / 2**30:.2f}GiB "
              f"temp={rec['temp_size_in_bytes'] / 2**30:.2f}GiB "
              f"out={rec['output_size_in_bytes'] / 2**30:.2f}GiB")
    except Exception as e:  # noqa: BLE001 -- record the failure, don't crash the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name}: FAIL "
              f"{rec['error']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{mesh_name}_{arch}_{shape_name}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run on meta")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*SHAPES, None])
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="run every runnable (arch x shape) cell")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--opt", default="",
                    help="comma-separated optimizations, e.g. attn_dp")
    args = ap.parse_args(argv)
    opts = {o for o in args.opt.split(",") if o}

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(name, sh.name) for name, cfg in sorted(REGISTRY.items())
                 for sh in cells_for(cfg)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, sh in cells:
        for mp in meshes:
            rec = run_cell(arch, sh, mp, args.out,
                           microbatches=args.microbatches,
                           remat=not args.no_remat, opts=opts)
            failures += 0 if rec["ok"] else 1
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
