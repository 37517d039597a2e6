"""Readings for a cell's ``correct`` limits: the program's numbers over many
seeds, and the control's (the plain reference computed through float8
e4m3, ``reference/common.py``'s ``fp8``) over a few, each judged by the
harness's own comparison (``check.judge``) against the cell's limits in
``correct/<cell>.json``.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--seconds 15]

One process on the card: for each seed the run's own set-up (weights from
the seed, engine, warm-up), a short window of the cell's traffic at its own
load, drained as a run drains it, the engine freed; then the sample of
served requests a run judges, through ``check.judge`` as a run judges it
(the program's reading and verdict) and, for the control's seeds, through
``check.judge`` with the control in the program's place: at each served
position the token the control puts first, and that token's gap in the
float32 reference. The control has to come out not correct. Prints one
JSON line per seed. Not part of a run.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def verdict(who: str, ok: bool, numbers: dict) -> dict:
    """A judgement as one row's fields: each number and the verdict."""
    return {**{f"{who}_{k}": v for k, (v, _) in numbers.items()},
            f"{who}_correct": ok}


def main(argv=None, device="cuda", overrides=None, clock=None):
    """Returns the rows printed. ``overrides`` and ``clock``: as for
    ``harness.cell.run`` (the CPU tests' reduced sizes and tick clock)."""
    import torch

    from harness import cell, check, driver, traffic
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=15.0)
    args = ap.parse_args(argv)
    _, _, conf, mix, c = cell.load(args.workload, overrides=overrides)
    m = conf["model"]
    control = {int(x) for x in args.control_seeds.split(",") if x}
    quiet = lambda s: None   # noqa: E731
    out = []
    for seed in [int(x) for x in args.seeds.split(",")]:
        t = time.perf_counter()
        params, r, prefixes = cell.prepare(conf, mix, seed, device, clock)
        reqs = traffic.generate(mix, seed, m["vocab_size"], args.seconds,
                                prefixes)
        r.window(reqs, args.seconds, mix["drain_s"])
        tls, rq = r.timelines, r.requests
        driver.free(r)
        if device == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        row = {"seed": seed, "limits": c["limits"],
               **verdict("program", *check.judge(m, c, params, tls, rq, seed,
                                                 quiet)),
               "reference_s": time.perf_counter() - t1}
        if seed in control:
            row.update(verdict("control", *check.judge(
                m, c, params, tls, rq, seed, quiet, "fp8")))
        row["seconds"] = time.perf_counter() - t
        print(json.dumps(row), flush=True)
        out.append(row)
        del params
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
