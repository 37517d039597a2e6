"""Finds a chat cell's knee once: the highest Poisson rate of the cell's own
length mix that the current tree sustains with no growing backlog.

    python3 portbench/sweep.py --workload <cell> --rates 1,2,3 --seconds 20 [--seed n]

One process: set-up once, then for each rate a window of ``--seconds`` with
the cell's traffic at that rate, drained.
Prints one JSON line per rate: requests, TTFT and TPOT p50/p90, TTFT p90 of
the window's first and last third, and the queue at the close.
Writes nothing; run it on the card (it is not part of a run).
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]


def main():
    from harness import cell, stats, traffic
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    _, _, conf, mix, _ = cell.load(args.workload)
    t = time.perf_counter()
    params, r, prefixes = cell.prepare(conf, mix, args.seed, "cuda")
    print(f"set-up {time.perf_counter() - t:.1f} s", flush=True)
    V = conf["model"]["vocab_size"]
    for rate in [float(x) for x in args.rates.split(",")]:
        m = {**mix, "arrivals": {**mix["arrivals"], "rate": rate}}
        reqs = traffic.generate(m, args.seed, V, args.seconds, prefixes)
        r.reset_records()
        late = r.window(reqs, args.seconds, 0)
        waiting, running = r.engine.num_waiting, r.engine.num_running
        tls = list(r.timelines.values())
        while r.engine.has_work():
            r.step()
        busy = [st.running for st in r.steps if st.t0 < args.seconds]
        out = {"rate": rate, "late_s": late, "waiting_at_close": waiting,
               "running_at_close": running,
               "running_max": max(busy, default=0),
               "running_mean": sum(busy) / max(len(busy), 1)}
        third = args.seconds / 3
        for name, part in (("first", [x for x in tls if x.due < third]),
                           ("last", [x for x in tls if x.due >= 2 * third])):
            ok = [stats.ttft_ms(x) for x in part if x.first is not None
                  and x.first <= args.seconds]
            out[f"ttft_p90_ms_{name}_third"] = (
                stats.percentile(ok, 90) if ok else None)
            out[f"no_first_token_{name}_third"] = len(part) - len(ok)
        out.update(stats.chat_metrics(tls, args.seconds))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
