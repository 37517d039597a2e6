#!/usr/bin/env python3
"""Where the Mamba2 mixer's single-token decode step spends the card's
time, and the mixer decode kernel (``csrc/mixer_decode.cu``) beside its
plain version, on one CUDA card.

Run from the root of a checkout on a machine with a card and ``nvcc``::

    python3 scripts/mixer_decode_probe.py [--parts plain,kernel,cell]

``plain``: the plain decode step of one Zamba2-7B mixer between its
projections (``mamba2._mixer`` with a state) and the cache write-back the
slot engine made after it, at ``zamba2-chat-burst``'s shape (32 slots,
112 heads of 64, N = 64, 2 groups), under ``torch.profiler``: device time
by kernel name per step, and the step's call and device time (CUDA
events, L2 flushed; ``chip_smoke.Kernels.time_ms``).

``kernel``: ``chip_smoke.run_mixer_kernel_checks``, phase 2's part for the
kernel: the kernel against the plain version at that shape, zamba2-2.7b's
and mamba2-130m's, then its call and device time beside the plain step's
and its bound.

``cell``: the cell's engine (Zamba2-7B, its engine settings, random
weights from the seed) with 18 requests decoding at contexts drawn like
the cell's, one fused K = 8 decode call traced after the graph is
captured: device time by kernel name per iteration.

Prints the card's name and power limit first, then each part's numbers,
and last one JSON line of them all.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "portbench")]

B, H, P, N, G = 32, 112, 64, 64, 2


def config():
    """Zamba2-7B's configuration file and model config."""
    from harness.driver import port_config
    conf = json.loads((ROOT / "portbench" / "configs" / "zamba2-7b.json")
                      .read_text())
    return conf, port_config(conf)


def plain_step(p, zx, cache, cfg):
    """The plain step and its write-back, as the slot engine made them."""
    from repro_torch.models.mamba2 import _mixer
    y, st = _mixer(zx, p, cfg, state={"conv": cache["conv"][0],
                                      "ssm": cache["ssm"][0]})
    cache["conv"][0] = st["conv"]
    cache["ssm"][0] = st["ssm"]
    return y


def by_kernel(torch, prof):
    """Device seconds and launches by kernel name."""
    secs, calls = defaultdict(float), defaultdict(int)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            secs[e.name] += e.device_time_total * 1e-6
            calls[e.name] += 1
    return secs, calls


def profile(torch, fn, reps):
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    fn()
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return by_kernel(torch, prof)


def part_plain(torch, dev, out):
    from chip_smoke import Kernels, mixer_case
    _, cfg = config()
    p, zx, cache = mixer_case(torch, dev, cfg, B, 0)
    reps = 20
    secs, calls = profile(torch, lambda: plain_step(p, zx, cache, cfg), reps)
    total = sum(secs.values())
    print(f"plain mixer decode step at B={B} H={H} P={P} N={N} G={G}: "
          f"{total / reps * 1e6:.1f} us of device time a step, "
          f"{sum(calls.values()) / reps:.0f} launches a step")
    rows = sorted(secs.items(), key=lambda kv: -kv[1])
    for name, s in rows:
        print(f"  {s / reps * 1e6:9.1f} us  x{calls[name] / reps:4.1f}  "
              f"{name[:110]}")
    K_ = Kernels(torch, dev)
    r = {"device_us_by_kernel": {n: s / reps * 1e6 for n, s in rows},
         "launches_by_kernel": {n: calls[n] / reps for n, _ in rows},
         "call_ms": K_.time_ms(lambda: plain_step(p, zx, cache, cfg)),
         "device_ms": K_.time_ms(lambda: plain_step(p, zx, cache, cfg),
                                 device=True)}
    print(f"  call {r['call_ms']:.4f} ms, device {r['device_ms']:.4f} ms "
          "(CUDA events, L2 flushed)")
    out["plain"] = r


def part_kernel(torch, dev, out):
    from chip_smoke import run_mixer_kernel_checks
    out["kernel"] = run_mixer_kernel_checks(torch, dev)


def part_cell(torch, dev, out, lens=18, seed=2147483901):
    import numpy as np

    from chip_smoke import slot_lengths
    from harness import weights
    from harness.driver import engine_config, port_config
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)
    from repro_torch.serving.request import InferenceRequest, SamplingParams
    conf, _ = config()
    _build.build(conf["kernels"])
    m = conf["model"]
    params = weights.draw(m, seed, dev)
    eng = ContinuousBatchingEngine(
        make_model(port_config(conf)), params,
        EngineConfig(**engine_config(conf, {})), device=dev)
    rng = np.random.default_rng(5)
    for i, n in enumerate(slot_lengths(lens, 11)):
        eng.add_request(InferenceRequest(
            model=conf["name"], request_id=f"p{i}",
            prompt_tokens=rng.integers(2, m["vocab_size"],
                                       size=min(n, 1000)).tolist(),
            sampling=SamplingParams(max_tokens=400, temperature=0.0)))
    for _ in range(200):             # every prompt in
        eng.step()
        if len(eng.running) == lens and not eng.prefilling \
                and not len(eng.policy):
            break
    for _ in range(2):               # the graph captured, then replayed
        eng.step()
    torch.cuda.synchronize()
    print(f"cell: {len(eng.running)} decoding, graph captured: "
          f"{eng.backend._graph.graph is not None}")
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    with prof_ctx(activities=[ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    secs, calls = by_kernel(torch, prof)
    iters = 8
    total = sum(secs.values())
    print(f"cell: one fused decode call of {iters} iterations: "
          f"{total / iters * 1e3:.3f} ms of device time an iteration")
    rows = sorted(secs.items(), key=lambda kv: -kv[1])
    for name, s in rows[:25]:
        print(f"  {s / iters * 1e3:8.3f} ms  x{calls[name] / iters:6.1f}  "
              f"{name[:110]}")
    out["cell"] = {"device_ms_per_iter": total / iters * 1e3,
                   "by_kernel_ms_per_iter": {n: s / iters * 1e3
                                             for n, s in rows},
                   "launches_per_iter": {n: calls[n] / iters
                                         for n, _ in rows}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parts", default="plain,kernel,cell")
    args = ap.parse_args()
    import subprocess

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    out = {"card": smi}
    parts = {"plain": part_plain, "kernel": part_kernel, "cell": part_cell}
    with torch.no_grad():
        for name in args.parts.split(","):
            parts[name](torch, dev, out)
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
