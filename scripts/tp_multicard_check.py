#!/usr/bin/env python3
"""Tensor-parallel serving with each shard on its own card.

Run from the root of a checkout on a machine with N >= 2 cards:
``python3 scripts/tp_multicard_check.py`` (N = every visible card). It
serves llama3.2-3b at full width on a (1, N) mesh of the visible cards
(``make_local_mesh(1, N)``): 8 requests sharing a 1024-token prefix through
the fused K=8 path with the decode kernel launched once per shard, then
the kernel tier teacher-forced against the same weights on one card
(``chip_smoke.LOGITS_TOL``), then ``python -m repro_torch.launch.serve
--full --model-shards N``. It prints each card's memory and exits non-zero
on a failed check. ``--cpu N`` runs the same steps on N shards of the CPU
at a reduced width (a rehearsal: no kernel launches, no card).
"""
from __future__ import annotations

import argparse
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
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    if args.cpu:
        dev = torch.device("cpu")
        mesh = make_local_mesh(1, args.cpu, devices=[dev] * args.cpu)
        cfg = reduced(REGISTRY["llama3.2-3b"])
        sync = lambda: None                                     # noqa: E731
    else:
        if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
            cs.fail("needs two or more visible cards")
        _build.build()
        mesh = make_local_mesh(1, torch.cuda.device_count())
        dev = mesh.devices[0]
        cfg = REGISTRY["llama3.2-3b"]
        sync = torch.cuda.synchronize
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"cards: {cs.nvidia_smi_line()} x {len(mesh.devices)}")
    n, L, V = len(mesh.devices), cfg.num_layers, cfg.vocab_size
    print(f"{cfg.name} L={L} on a (1, {n}) mesh over {list(mesh.devices)}")
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
    cs.check(homes == [str(d) for d in mesh.devices],
             "a pool shard is not on its own device")
    steps, orig = cs.count_fused_steps(PagedBackend)
    backends.reset_transfer_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    for r in cs.make_requests(8, 1024, np.linspace(64, 512, 8).astype(int),
                              64, V, seed=0):
        eng.add_request(r)
    outs = eng.run_to_completion()
    sync()
    wall = time.perf_counter() - t0
    PagedBackend._fused_kernel_impl = orig
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
    if not args.cpu:
        for i, d in enumerate(mesh.devices):
            print(f"  {d}: {torch.cuda.max_memory_allocated(d) / 2 ** 30:.2f}"
                  f" GiB peak")
    del eng, be
    rng = np.random.default_rng(2)
    worst, share, _ = cs.tp_teacher_forced(
        torch, model, params, mesh, dev,
        [rng.integers(2, V, size=k).tolist() for k in (700, 530)], 16)
    print(f"teacher-forced: {n} cards vs 1 card logits rel_err {worst:.3e} "
          f"(tolerance {cs.LOGITS_TOL}); greedy tokens that match "
          f"{share:.3f}")
    cs.check(worst <= cs.LOGITS_TOL, "multi-card logits disagree with 1 card")
    if not args.cpu:
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
