"""End-to-end serving driver of the port:
``python -m repro_torch.launch.serve --arch <id>``.

Brings up the port's continuous-batching engine for the selected
architecture and drives a ShareGPT-like request stream through it,
reporting the paper's §5.1 metrics -- the reference's
``repro/launch/serve.py`` with the same flags. The reduced config is the
default; ``--full`` uses the full config (random weights from a seeded
generator). ``--device`` picks where the engine runs: ``cuda`` by
default, which raises without a card; ``--device cpu`` runs it on the
CPU (each kernel wrapper then runs its plain version). ``--model-shards
N`` serves tensor-parallel over a (1, N) mesh of the first N visible
cards (ValueError when fewer are visible, as under ``--device cpu``).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api import StreamAssembler, to_inference_request
from repro_torch.api.schemas import CompletionRequest
from repro_torch.configs import REGISTRY, get_config, list_archs, reduced
from repro_torch.data.workload import make_workload, token_ids_for
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import make_model
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="FIRST serving driver")
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs())
    ap.add_argument("--full", action="store_true",
                    help="full-size config; default reduced")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--rate", type=float, default=float("inf"))
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--backend", default="paged",
                    choices=["slots", "paged"])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=160)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--model-shards", type=int, default=1,
                    help="tensor-parallel width: shard the engine over a "
                         "(1, N) mesh of the first N visible cards")
    ap.add_argument("--stream", action="store_true",
                    help="subscribe every request to the token stream and "
                         "report client-observed TTFT/ITL")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engine (default cuda: raises "
                         "without a card)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch) if args.full else reduced(REGISTRY[args.arch])
    if cfg.family in ("ssm", "hybrid") and args.backend == "paged":
        print(f"[serve] {cfg.family} arch: paged KV does not apply, "
              "using slots backend")
        args.backend = "slots"
    if cfg.family == "audio":
        raise SystemExit("hubert-xlarge is encoder-only: use the embedding "
                         "service (repro_torch.serving.embedding), not "
                         "generate")
    mesh = None
    if args.model_shards > 1:
        mesh = make_local_mesh(1, args.model_shards)
    # "cuda" means the current card (the mesh's first under --model-shards),
    # and raises when there is none
    dev = mesh.devices[0] if mesh is not None \
        else resolve_device(None if args.device == "cuda" else args.device)

    print(f"[serve] arch={args.arch} ({'full' if args.full else 'reduced'}) "
          f"backend={args.backend} slots={args.slots} "
          f"shards={args.model_shards} device={dev}")
    model = make_model(cfg)
    params = model.init_params(
        torch.Generator(device=dev).manual_seed(args.seed))
    engine = ContinuousBatchingEngine(model, params, EngineConfig(
        max_slots=args.slots, max_seq_len=args.max_seq_len,
        backend=args.backend, page_size=16, mesh=mesh), device=dev)
    del params                      # under a mesh the shards hold copies

    wl = make_workload(args.requests, rate=args.rate, seed=args.seed,
                       lo=4, hi=max(8, args.max_seq_len - args.max_tokens - 8))
    t0 = time.monotonic()
    streams: dict[str, StreamAssembler] = {}
    for w in wl:
        # typed /v1 request -> engine request (the serving driver speaks
        # the same contract as the gateway)
        req = CompletionRequest(
            model=cfg.name,
            prompt_tokens=token_ids_for(w, cfg.vocab_size)[:args.max_seq_len
                                                           - args.max_tokens
                                                           - 4],
            request_id=w.request_id,
            max_tokens=min(w.max_tokens, args.max_tokens),
            temperature=0.0, stream=args.stream).validate()
        on_delta = None
        if args.stream:
            streams[req.request_id] = on_delta = \
                StreamAssembler(clock=engine.clock)
        engine.add_request(to_inference_request(req), on_delta=on_delta)
    outs = engine.run_to_completion()
    dt = time.monotonic() - t0
    toks = sum(o.num_output_tokens for o in outs)
    e2e = sorted(o.metrics.e2e_latency for o in outs if o.metrics)
    print(f"[serve] {len(outs)} requests, {toks} output tokens in {dt:.1f}s")
    print(f"[serve] req/s={len(outs)/dt:.2f} tok/s={toks/dt:.1f} "
          f"median_e2e={e2e[len(e2e)//2]:.2f}s steps={engine.stats['steps']}")
    if args.stream:
        for o in outs:
            assert streams[o.request_id].tokens == o.output_tokens, \
                f"stream/output divergence for {o.request_id}"
        gaps = sorted(g for a in streams.values()
                      for g in a.inter_token_gaps)
        ttfts = sorted(a.arrivals[0] - t0 for a in streams.values()
                       if a.arrivals)
        print(f"[serve] streamed: {sum(len(a.deltas) for a in streams.values())}"
              f" frames, median TTFT {ttfts[len(ttfts)//2]:.2f}s, "
              f"median ITL {gaps[len(gaps)//2]*1e3:.1f}ms, "
              f"p99 ITL {gaps[int(0.99*(len(gaps)-1))]*1e3:.1f}ms")


if __name__ == "__main__":
    main()
