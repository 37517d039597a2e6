"""One run of one cell, from the configuration's weights to the result's line.

Set-up (``setup_s``): the kernels built (the first run in a checkout
compiles them into ``build/repro_torch_kernels/``; later runs load them),
the weights drawn on the device from the seed, the engine built, the
warm-up served (each shared prefix once and a few requests of the mix, so
that every path of the window has run). Then the window: the traffic
offered for ``seconds``, drained for the mix's ``drain_s`` at most; in a
traced run, the device profiled over the mix's steady sub-window. Then the
peak memory is read, the engine freed and the served tokens judged against
the reference.
"""
from __future__ import annotations

import math
import sys
import time

import torch

from harness import check, driver, spec, stats, trace, traffic, weights
from harness.readings import Readings

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARMUP_LIMIT_S = 300


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def load(cell_name: str, root=spec.ROOT, base=spec.HERE, overrides=None):
    """(benchmark, cell, configuration file, mix, correctness limits) with
    ``overrides`` replacing top-level sections of the configuration file
    (``model``, ``engine``: the CPU tests' reduced sizes), of the mix
    (``mix``) and the limits (``correct``)."""
    bench = spec.load_benchmark(root)
    cell, conf, mix, limits = spec.resolve(bench, cell_name, root, base)
    for key, val in (overrides or {}).items():
        if key == "mix":
            mix = {**mix, **val}
        elif key == "correct":
            limits = val
        else:
            conf = {**conf, key: val}
    return bench, cell, conf, mix, limits


def as_device(device) -> torch.device:
    """A device with its index (the engine compares devices exactly)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def prepare(conf: dict, mix: dict, seed: int, device, clock=None,
            marks=None):
    """Set-up: kernels built, weights drawn, engine built, warm-up served.
    Returns (params, run, shared prefixes). ``clock``: as for
    ``driver.Run``. ``marks``: a list that gets (stage, host-clock time at
    its end) for each stage."""
    marks = [] if marks is None else marks
    m = conf["model"]
    device = as_device(device)

    def mark(stage):
        if device.type == "cuda":
            torch.cuda.synchronize()
        marks.append((stage, time.perf_counter()))
    mark("imports")
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.build(conf["kernels"])
    mark("kernels")
    params = weights.draw(m, seed, device)
    mark("weights")
    r = driver.Run(conf, mix, params, device, clock)
    mark("engine")
    prefixes = traffic.shared_prefixes(mix, seed, m["vocab_size"])
    r.serve(traffic.warmup(mix, seed, m["vocab_size"], prefixes),
            WARMUP_LIMIT_S)
    r.reset_records()
    mark("warm-up")
    return params, r, prefixes


def run(cell_name: str, seed: int, seconds: float, traced: bool,
        t_start: float, device="cuda", root=spec.ROOT, base=spec.HERE,
        overrides=None, log=print, clock=None):
    """Runs the cell once; returns the result's dict. ``clock``: the
    harness's clock (``driver.Run``; the CPU tests pass one that advances
    by a fixed tick, so that a window holds the same steps however loaded
    the machine is)."""
    bench, cell, conf, mix, limits = load(cell_name, root, base, overrides)
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    m = conf["model"]
    marks = [("start", t_start)]
    params, r, prefixes = prepare(conf, mix, seed, device, clock, marks)
    reqs = traffic.generate(mix, seed, m["vocab_size"], seconds, prefixes)
    tracer = None
    if traced:
        tr = mix["trace"]
        tracer = trace.Tracer(tr["start_s"], tr["seconds"], cuda)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log("set-up " + ", ".join(f"{name} {t - marks[i][1]:.3f} s"
                              for i, (name, t) in enumerate(marks[1:])))
    stats0 = dict(r.engine.stats)
    late = r.window(reqs, seconds, mix["drain_s"], tracer)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {len(r.timelines)} requests handed over, "
        f"{len(r.steps)} steps, generator late by {late * 1e3:.3f} ms at "
        f"most, engine stats {_delta(r.engine.stats, stats0)}")
    e2e = stats.chat_metrics(r.timelines.values(), seconds)
    out = {"device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak}}
    metrics = {}
    if traced:
        tracer.finish()
        rd = _readings(r, m, tracer)
        for e in spec.metrics_for(bench, cell_name, True):
            v = spec.reader(e["name"], base).read(rd)
            if v is not None:
                metrics[e["name"]] = {"value": v, "unit": e["unit"]}
        log(f"traced {tracer.lo!r} to {tracer.hi!r} s: {len(rd.steps)} steps, "
            f"{tracer.n_events} device activities read in {tracer.read_s:.3f} s")
        if tracer.trace is not None:
            out["device"]["busy_s"] = tracer.trace.busy(tracer.lo, tracer.hi)
            out["device"]["window_s"] = tracer.hi - tracer.lo
            out["breakdown"] = _breakdown(rd, tracer)
    else:
        got = {"setup_s": setup_s, **e2e}
        for e in spec.metrics_for(bench, cell_name, False):
            if _finite(got.get(e["name"])) is not None:
                metrics[e["name"]] = {"value": got[e["name"]], "unit": e["unit"]}
    log("e2e " + " ".join(f"{k} {v!r}" for k, v in e2e.items()))
    # the judgement, once the window has closed and the engine is gone
    timelines, requests = r.timelines, r.requests
    driver.free(r)
    if cuda:
        torch.cuda.empty_cache()
    ok, numbers = check.judge(conf["model"], limits, params, timelines,
                              requests, seed, log)
    out = {"correct": ok and e2e["failed"] == 0,
           "attempted": e2e["attempted"], "failed": e2e["failed"],
           "metrics": metrics, **out}
    out["checks"] = {k: {"value": _finite(v), "limit": lim}
                     for k, (v, lim) in numbers.items()}
    return out


def _delta(now: dict, then: dict) -> dict:
    return {k: v - then.get(k, 0) for k, v in now.items()
            if v != then.get(k, 0)}


def _readings(r, m, tracer) -> Readings:
    steps = [s for s in r.steps
             if tracer.lo is not None and s.t0 >= tracer.lo
             and (tracer.hi is None or s.t1 <= tracer.hi)]
    lo = tracer.lo
    hi = tracer.hi if tracer.hi is not None else (steps[-1].t1 if steps else lo)
    return Readings(m, r.requests, steps, tracer.counters, tracer.trace, lo,
                    hi)


def _breakdown(rd: Readings, tracer) -> dict:
    spans = []
    for s in rd.steps:
        spans.append(("engine.step (scheduling, sampling, host sync)", s.t0, s.t1))
        spans.extend(s.spans)
    gaps = tracer.trace.gaps(tracer.lo, tracer.hi)
    return {"device_ops": [[n, s] for n, s in tracer.trace.top_kernels(10)],
            "idle_gaps": trace.label_gaps(gaps, spans, 10)}
