#!/usr/bin/env python3
"""Mesh serving with each mesh position on its own card.

Run from the root of a checkout on a machine with N >= 2 cards:
``python3 scripts/tp_multicard_check.py`` (N = every visible card). It
serves llama3.2-3b at full width on a (1, N) mesh of the visible cards
(``make_local_mesh(1, N)``): 8 requests sharing a 1024-token prefix through
the fused K=8 path with the decode kernel launched once per model shard,
then the kernel tier teacher-forced against the same weights on one card
(``chip_smoke.LOGITS_TOL``), then ``python -m repro_torch.launch.serve
--full --model-shards N``. It prints each card's memory and exits non-zero
on a failed check. ``--data D`` serves on a (D, N / D) mesh instead (the
entry point, which builds (1, N) meshes, is then not run);
``--arch A --layers L`` serves registry config A at full width cut to L
layers: ``--data 2 --arch dbrx-132b --layers 3`` on four cards puts
dbrx-132b's weights FSDP-split over ``data`` by the serving rule's own
threshold, each slice on its own card, and also holds the (D, N / D)
engine's tokens against a (1, N / D) engine's. ``--cpu N`` runs the same
steps on N shards of the CPU at a reduced width (a rehearsal: no kernel
launches, no card).
"""
from __future__ import annotations

import argparse
import copy
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", type=int, default=0,
                    help="rehearse on this many CPU shards (reduced width)")
    ap.add_argument("--data", type=int, default=1,
                    help="size of the mesh's data axis")
    ap.add_argument("--arch", default="llama3.2-3b")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the config to this many layers (0: whole)")
    args = ap.parse_args()

    import dataclasses

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.distributed import sharding
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    D = args.data
    if args.cpu:
        dev = torch.device("cpu")
        mesh = make_local_mesh(D, args.cpu // D, devices=[dev] * args.cpu)
        cfg = reduced(REGISTRY[args.arch])
        sync = lambda: None                                     # noqa: E731
        if D > 1:       # reduced widths never reach the rule's threshold
            sharding.SERVE_FSDP_BYTES = 0
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            cs.fail("needs two or more visible cards")
        _build.build()
        mesh = make_local_mesh(D, torch.cuda.device_count() // D)
        dev = mesh.devices[0]
        cfg = REGISTRY[args.arch]
        sync = torch.cuda.synchronize
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"cards: {cs.nvidia_smi_line()} x {len(mesh.devices)}")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    n, L, V = mesh.shape["model"], cfg.num_layers, cfg.vocab_size
    fsdp = D > 1 and sharding.needs_serve_fsdp(cfg, n)
    print(f"{cfg.name} L={L} on a ({D}, {n}) mesh over {list(mesh.devices)}"
          f"; weights split over data: {fsdp}")
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    ecfg = EngineConfig(backend="paged", use_kernel=True, page_size=64,
                        max_slots=8, max_seq_len=4096,
                        enable_prefix_cache=True, chunked_prefill_budget=512,
                        decode_steps_per_sync=8, mesh=mesh)
    eng = ContinuousBatchingEngine(model, params, ecfg, device=dev)
    be = eng.backend
    homes = [str(p["k"].device) for p in be.pool_shards]
    print(f"pool shards on {homes}, shape {tuple(be.pool_shards[0]['k'].shape)}")
    cs.check(homes == [str(d) for d in mesh.devices[:n]],
             "a pool shard is not on its own device")
    cs.check(be.stack._fsdp == fsdp, "the weights' data split is not the "
             "serving rule's")
    if fsdp:
        print("weight bytes by position (d, m): " + ", ".join(
            f"{p}: {b / 1e9:.3f} GB" for p, b in sorted(
                cs.position_bytes(be.stack.params).items())))
        cs.check(all(p.device == be.shard.replicas[d][m]
                     for m, t in enumerate(be.stack.params)
                     for x in cs.leaves(t)
                     if isinstance(x, sharding.DataSlices)
                     for d, p in enumerate(x.parts)),
                 "a data slice is not on its position's card")
    steps, orig = cs.count_fused_steps(PagedBackend)
    backends.reset_transfer_stats()
    sharding.reset_gather_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    reqs = cs.make_requests(8, 1024, np.linspace(64, 512, 8).astype(int),
                            64, V, seed=0, model=cfg.name)
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    outs = eng.run_to_completion()
    sync()
    wall = time.perf_counter() - t0
    PagedBackend.fused_decode = orig
    launches = dict(_build.LAUNCHES)
    cs.check_outputs("multi-card fused path", outs, 8, 64, V)
    cs.check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
             "the fused path moved logits to the host")
    want = 0 if args.cpu else sum(steps) * L * n
    print(f"8 requests in {wall:.3f} s; launches {launches}; expected "
          f"fused_decode_attention {want} ({sum(steps)} steps x {L} layers "
          f"x {n} shards)")
    cs.check(launches["fused_decode_attention"] == want,
             "fused_decode_attention launches")
    if fsdp:
        print(f"gathers {dict(sharding.GATHER_STATS)}")
    if not args.cpu:
        for i, d in enumerate(mesh.devices):
            print(f"  {d}: {torch.cuda.max_memory_allocated(d) / 2 ** 30:.2f}"
                  f" GiB peak")
    del eng, be
    if D > 1:
        # the same requests on a (1, N / D) mesh of the first row's cards
        one = ContinuousBatchingEngine(model, params, dataclasses.replace(
            ecfg, mesh=make_local_mesh(1, n, devices=mesh.devices[:n])),
            device=dev)
        for r in copy.deepcopy(reqs):
            one.add_request(r)
        ref = one.run_to_completion()
        del one
        cs.check({o.request_id: o.output_tokens for o in ref}
                 == {o.request_id: o.output_tokens for o in outs},
                 f"the ({D}, {n}) engine's tokens differ from the (1, {n}) "
                 f"engine's")
        print(f"tokens equal to a (1, {n}) engine's")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, V, size=k).tolist() for k in (700, 530)]
    if D == 1:
        worst, share, _ = cs.tp_teacher_forced(torch, model, params, mesh,
                                               dev, prompts, 16)
        print(f"teacher-forced: {n} cards vs 1 card logits rel_err "
              f"{worst:.3e} (tolerance {cs.LOGITS_TOL}); greedy tokens that "
              f"match {share:.3f}")
    else:
        # one card, then (1, N / D) on the first row, then (D, N / D), each
        # fed the one card's greedy tokens (MoE routed by its decisions)
        lg, gathers = cs.fsdp_tiers(torch, model, params, dev, {
            "one": None,
            "row": make_local_mesh(1, n, devices=mesh.devices[:n]),
            "mesh": mesh}, prompts, 8)
        worst = max(float(np.abs(m - o).max() / max(np.abs(o).max(), 1e-6))
                    for m, o in zip(lg["row"], lg["one"]))
        same = all(np.array_equal(a, b) for a, b in zip(lg["mesh"],
                                                        lg["row"]))
        print(f"teacher-forced: (1, {n}) vs 1 card logits rel_err "
              f"{worst:.3e} (tolerance {cs.LOGITS_TOL}); ({D}, {n}) vs "
              f"(1, {n}) {'bit-identical' if same else 'DIFFER'}; a decode "
              f"forward's gathers {gathers}")
        cs.check(same, f"({D}, {n}) logits differ from (1, {n})'s")
    cs.check(worst <= cs.LOGITS_TOL, "multi-card logits disagree with 1 card")
    if not args.cpu and D == 1:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--full",
               "--model-shards", str(n), "--requests", "8", "--max-tokens",
               "16", "--stream"]
        print("running " + " ".join(cmd[1:]))
        proc = subprocess.run(cmd, cwd=ROOT, env={
            **__import__("os").environ, "PYTHONPATH": str(ROOT / "src")},
            capture_output=True, text=True, timeout=600)
        print(proc.stdout[-2000:], proc.stderr[-2000:])
        cs.check(proc.returncode == 0, "launch.serve --model-shards failed")
    print("ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
