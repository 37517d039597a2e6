#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` (PATH or /usr/local/cuda/bin) and no network; it puts
``src`` on ``sys.path`` itself and imports nothing of JAX or of the JAX
package. Phases, each of which raises on a failed check (exit code 1):

1. Header: the card's name and power limit (nvidia-smi), torch and CUDA
   versions, and the time to build every CUDA kernel of the port (one
   ``nvcc`` per source, all started together).
2. Kernel checks: every kernel on the engines' paths against its plain
   PyTorch version on the card, at the main-path shapes of full-width
   llama3.2-3b (paged attention kernels) and zamba2-2.7b / mamba2-130m
   (the SSD scan, dense flash attention), Zamba2-7B's decode step (the
   slot decode attention kernel: 32 slots of 2048, heads of 224, with
   lengths drawn like ``zamba2-chat-burst``'s, timed beside SDPA on the
   pre-gathered cache and its bound, the live K/V bytes once; and at
   heads of 80 and 128, G of 1 to 48, windows, empty, full and overgrown
   slots; the mixer decode kernel: 32 slots, 112 heads of 64, N = 64 in 2
   groups, timed beside the plain step with its cache write-back and its
   bound, the float32 state read and written once; and at zamba2-2.7b's
   and mamba2-130m's mixers), at phase 6's shapes
   (phi3.5-moe's and llava-next-34b's grouping in both paged kernels;
   hubert-xlarge's non-causal (8, 512, 16, 80) batch in the flash kernel,
   timed beside SDPA and its bound), at phase 8's per-shard shapes (the
   paged kernels at a quarter of the kv heads; the flash kernel at 8 of
   zamba2's 32 heads, S = 2048 and 777) and at edge geometries -- for
   the split-K paged decode kernels also at the edges of its splits, its
   launch geometry printed, its device time at two other split sizes and
   the device time of one PyTorch sum over the same K/V bytes; for the
   SSD scan also at the chunk edges (s = Q, Q + 1, 16 chunks, b = 2), the
   launch geometry and workspace of its three bf16 passes, each pass's
   device time (profiler) beside one read and one copy of x, and each
   instantiation's registers, spills and SASS count of tensor-core
   instructions (``cuobjdump -sass``; fails without HGMMA/HMMA); then its
   time (median of CUDA-event timed runs, L2 flushed before each) beside
   the plain version's, a library yardstick's where one PyTorch call
   computes the same function (``scaled_dot_product_attention``, which the
   port never calls; the SSD scan has none), the least time the card
   could take, and the TFLOP/s it achieves. Times are call times (the
   host issues the call inside the timed span); the kernel's and the
   yardstick's device times (the host queues the call behind a spin
   kernel) are printed below them and kept as ``device_ms`` and
   ``library_device_ms``.
3. Engine run at full width (llama3.2-3b, random bf16 weights from a
   seeded generator): after a short warm-up run, 8 requests sharing a
   1024-token prefix through the fused K=8 path with chunked prefill and
   the prefix cache; a decode-only window of the same workload, timed and
   then traced with torch.profiler (device time by kernel group, idle
   share); the same window at K=1 (a host sync every step, for phase
   9a); one prefill step (a 512-token chunk at 1024) timed and traced
   the same way; 2 requests through the per-step path; then a
   teacher-forced comparison of the kernel tier against the plain tier
   (prefill chunks + decode steps). The launch counters are set to 0 just
   before each path and read just after it.
4. Slot engine at full width (zamba2-2.7b, random bf16 weights): after a
   warm-up, 8 prompts of 200..2048 tokens prefilled one-shot at their
   exact length through the kernel tier (54 ``ssd`` and 9
   ``flash_attention`` launches a prompt, each ``ssd`` call one launch of
   each of its three passes, checked) and 64 tokens each
   through the fused K=8 path (9 ``slot_decode_attention`` launches a
   decode step, checked); decode and prefill (one 2048-token
   prompt) windows traced as in phase 3; 2 requests through the per-step
   path; then a teacher-forced comparison of the kernel tier against the
   plain tier, beside the plain tier's own spread when only the order of
   its sums changes.
5. Speculative decoding and swap preemption at full width (llama3.2-3b,
   the phase-3 engine settings, k = 4): 8 requests on the paged engine
   with the target as its own draft (acceptance at least 0.9,
   ``fused_decode_attention`` and ``paged_flash_prefill`` launched), the
   same requests without speculation, one verify round traced (device
   time by kernel group and by profiler range: the draft's loop, the
   verify, its page gathers and its float32 block attention); the verify
   forward's logits against sequential decode steps (teacher-forced,
   LOGITS_TOL); a cold draft (the same widths cut to 2 layers; its
   catch-up must run); the slot engine speculating (``flash_attention``
   launched); swap preemption (one swap out and in, the request finishes
   at its length) and a byte-exact swap round trip at backend level.
6. The moe, vlm and audio families and the serving entry point:
   a. phi3.5-moe at full width, cut to 16 of its 32 layers (the bf16
      weights of all 32 would leave about 1 GB of the card): 8 requests
      sharing a 1024-token prefix through ``offline.run_batch`` on the
      paged engine (phase-3 settings, 32 new tokens), 2 on the per-step
      path, 4 on the slot engine, each kernel's launches checked against
      layers x chunks / steps / prompts; a traced decode window (no device
      copy of an expert stack, the expert bytes read a step against the
      step's device time) and a traced 512-token prefill chunk; then a
      teacher-forced kernel-vs-plain comparison (a 1500-token prompt and
      8 decode steps): free runs, reported with the share of (token,
      layer) routing decisions that flip between the tiers and the
      probability margin at each flip, and the kernel tier routed by the
      plain tier's decisions, held to LOGITS_TOL (with a random router in
      bf16 a flip within rounding changes the hidden state and flips
      more downstream, so free-running logits measure that cascade).
   b. llava-next-34b at full width, cut to 4 of its 60 layers: 4 requests
      on the paged engine, launches checked; ``LM.prefill`` of seeded
      (2, 1024, 7168) embeddings, kernel tier against plain tier.
   c. hubert-xlarge at full width and depth: ``EmbeddingEngine`` on 8
      frame sequences of 100..512 frames padded to 512 (48 non-causal
      ``flash_attention`` launches a batch, checked), its embeddings
      against the plain tier's, a batch's host-clock and device time.
   d. ``python -m repro_torch.launch.serve --arch llama3.2-3b --full
      --requests 8 --max-tokens 16 --stream`` as a subprocess: exit 0,
      with its own stream/output check.
7. Training (float32 on reduced configs, bf16 at full width; TF32 off;
   the kernel launch counters set to 0 before it must read 0 after it):
   a. one ``make_train_step`` step of each reduced family (llama3.2-3b,
      phi3.5-moe, llava-next-34b, mamba2-130m, zamba2-2.7b,
      hubert-xlarge) on the card and on the CPU from the same parameters
      and batch: loss, per-leaf gradients, AdamW moments and parameters;
   b. llama3.2-3b at full width and depth in bf16 (B = 8, S = 1024, two
      microbatches, remat, in-place AdamW): 10 steps on one repeated
      batch, every loss finite and the loss falling by LOSS_DROP; step
      time, tokens/s, ``train_mfu`` and peak memory; one traced step
      (device time by op class, idle share);
   c. (run first, at initialisation) the same width, loss and gradients
      only: one microbatch against two, ``ce_chunk=16384`` against the
      full-logit loss, within the bf16 bounds;
   d. one step (after a warm-up step) each of phi3.5-moe cut to 2 of 32
      layers (grouped dispatch) and zamba2-2.7b cut to 12 of 54 layers at
      S = 2048 (the plain SSD scan's backward): first loss near ln V,
      losses and gradients finite;
   e. a reduced-llama checkpoint saved, loaded onto the card and trained
      on: bit-identical to the uninterrupted run;
   f. ``python -m repro_torch.launch.train`` as subprocesses: 3 steps,
      a rerun to 6 that resumes at 3, a fresh run to 6: equal last loss;
   g. ``flash_attention`` refuses a q that requires grad.
8. Mesh serving: four shards of a ``(1, 4)`` mesh on the one card
   (``make_local_mesh(1, 4, devices=[card] * 4)``; 8e a (2, 2) mesh),
   bf16 random weights, each part after the previous one's weights are
   freed:
   a. llama3.2-3b whole on phase 3's settings (8 kv heads, 2 a shard):
      phase 3's 8 requests through the fused K=8 path
      (``fused_decode_attention`` once per shard, layer and step:
      launches = fused steps x 28 x 4), a decode window timed and traced
      beside phase 3's, 2 requests on the per-step path
      (``paged_attention``: steps x 28 x 4), prefix-cache hit tokens equal
      to phase 3's, no logits transfer, peak memory; then the mesh's
      kernel tier teacher-forced against the 1-device kernel tier
      (LOGITS_TOL);
   b. granite-34b at full width, 4 of 88 layers (one kv head: the cache
      splits over head_dim, pool shards (..., 1, 32), the plain path, no
      kernel launched): 4 requests, then teacher-forced against 1 device;
   c. phi3.5-moe at full width, 4 of 32 layers (4 of 16 experts a shard,
      the router replicated): 4 requests (``fused_decode_attention`` per
      shard), then teacher-forced: free runs with their routing flips
      reported, and the mesh routed by the 1-device decisions held to
      LOGITS_TOL.
   d. zamba2-2.7b whole (54 layers) on the slot backend with the kernel
      tier: in_proj split by columns and gathered, every shard scanning
      its own copy of the replicated ssm/conv state, out_proj by rows, the
      shared attention at 8 of 32 heads a shard. Phase 4's 8 prompts
      one-shot (``ssd``: prompts x 54 x 4 launches, each of its three
      passes once; ``flash_attention``: prompts x 9 x 4), 16 new tokens
      each through the fused K=8 path, no logits transfer; a decode window
      (one fused call timed, one traced: the trace of four shards' steps
      is large) beside phase 4's (host and device ms, idle share),
      peak memory; then teacher-forced against the 1-device kernel tier
      on phase 4's prompts and steps, within max(LOGITS_TOL, SPREAD_FACTOR
      x phase 4's plain-tier spread). Then mamba2-130m whole (24 layers)
      on the same mesh: 4 prompts (``ssd``: prompts x 24 x 4),
      teacher-forced against 1 device within max(LOGITS_TOL,
      SPREAD_FACTOR x its own plain-tier spread).
   e. dbrx-132b at full width, 3 of 40 layers (22.02 GB of bf16 weights:
      over the serving rule's 8 GiB a model shard at M = 2), on a (1, 2)
      mesh and then a (2, 2) mesh of the one card, the (2, 2) weights
      FSDP-split over ``data`` by the rule's own threshold and gathered a
      layer at a time: each position's weight bytes against the specs'
      prediction; 4 requests of 256 to 512 tokens, 16 new tokens each
      (``fused_decode_attention`` = fused steps x 3 x 2 an engine), the
      same tokens and stats on both meshes; each engine's decode step
      (host and device clock) and peak memory; then teacher-forced, every
      tier routed by the 1-device decisions: (2, 2) against (1, 2) bit
      for bit (where not, the first difference is traced and the two are
      held to LOGITS_TOL), (1, 2) against one device within LOGITS_TOL,
      and a (2, 2) decode forward's gathers against the specs'.
9. The control plane and the cost model (``repro_torch.core``,
   ``repro_torch.serving.costmodel`` with its committed H100 constants):
   a. the model against phase 3's llama3.2-3b windows: for K=8, K=1 and
      the prefill chunk the roofline term, the prediction, the measured
      host-clock and device time and their ratios (the per-step path's
      step beside them, a different path), the overhead terms fitted to
      this run (``step(K) = roofline + dispatch + host_sync / K``), the
      chunk's implied ``mfu``; ``ServeSharding.all_reduce`` of four
      (8, 3072) bf16 shards timed (COLLECTIVE_LAUNCH) and phase 5's swap
      rate beside HOST_IO_BW. Fails if a prediction is not finite and
      positive or a roofline term is above the measured device time;
   b. phi3.5-moe (phase 6a's 16 layers and settings) held out: the
      predicted decode step over phase 6a's measured one (printed, no
      gate: the host clock spreads 1.3 to 1.8 times between runs);
   c. ``examples/federated_serving.py``'s scenario and the batch control
      plane of ``examples/batch_inference.py`` on the port's DES at the
      paper's sizes (llama3.3-70b, 8 cards an instance, sophia +
      polaris): the selection rules, a 400-request burst to 2 sophia
      instances, a sophia outage served by polaris, an interactive stream
      jumping a 96-request batch flood (preemptions), 500 JSONL lines
      through ``FirstClient.create_batch``; rates printed as modelled by
      the DES, with its host wall time.
10. The dry run (``repro_torch.launch.dryrun``, its step analysis on the
   ``meta`` device) against the card:
   a. phase 7b's train step analysed, then run on the card under
      ``FlopCounterMode``: the matmul FLOPs and the argument bytes must
      be equal; the predicted peak live bytes over
      ``max_memory_allocated`` and the roofline (compute + memory) over
      the measured step are printed;
   b. a decode step at phase 3's batch and mean context: its roofline
      beside the cost model's and phase 3's measured device time;
   c. ``DRYRUN_CELLS`` on both production meshes, every record ok.
   No port kernel launches in it.
11. A ``{"metrics": ...}`` line (phase 9's under ``core_metrics``, phase
   10's under ``dryrun_metrics``), a
   ``{"kernels": [...]}`` line (each kernel's launches under a mesh as
   ``tp_launches``: phase 8a's decode kernels and 8e's fused path,
   phase 8d's zamba2 ``ssd`` and ``flash_attention``), the nvidia-smi line, and last
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
SPIN_CYCLES = 1_000_000        # queued before a device-timed call: ~0.5 ms
BF16_FLOPS = 989e12            # dense tensor-core bf16, H100 SXM data sheet
# relative-to-output-scale tolerances of kernel vs plain version:
# bf16 -- the output is rounded to bf16 (2^-8 relative) and the plain
# prefill rounds probabilities to bf16 before the PV product;
# f32 -- both accumulate in fp32 in different orders over up to ~2k terms
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# logits of the kernel tier vs the plain tier at full width: the same
# bf16 ulp-level differences in every attention output, carried through
# 28 residual layers and the 128256-wide head
LOGITS_TOL = 5e-2
# zamba2-2.7b's 63 blocks with random weights amplify ulp-level rounding
# differences to about 5e-2 of the logits' scale: the slot phase holds the
# kernel tier to LOGITS_TOL or to this many times the plain tier's own
# spread under a reordering of its sums, measured in the same run
SPREAD_FACTOR = 2.0
# the SSD kernel's float32 final state against the plain scan's, relative
# to its scale: the same float32 products summed in another order (the
# plain scan combines chunk states through exp(segsum) products)
SSD_STATE_TOL = 1e-4


def rel_err(out, ref):
    """(max |out - ref| / max |ref|, max |out - ref|) of two tensors."""
    d = (out.float() - ref.float()).abs().max().item()
    return d / max(ref.float().abs().max().item(), 1e-6), d


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

class Kernels:
    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(1234)
        self.flush_buf = torch.empty(64 * 2 ** 20, dtype=torch.uint8,
                                     device=dev)

    def randn(self, *shape, dtype):
        t = self.torch
        return t.randn(*shape, generator=self.gen, device=self.dev,
                       dtype=t.float32).to(dtype)

    def time_ms(self, fn, n=25, warmup=3, device=False):
        """Median over ``n`` runs of one call, each timed with CUDA events
        after an L2 flush (the engine meets every layer's pages cold). The
        host issues the call inside the timed span, so its own time to do
        so counts where it exceeds the device's. With ``device`` a spin
        kernel of about half a millisecond is queued before the first
        event instead, so the host has queued the whole call before the
        device reaches it and the events time the device's work alone."""
        t = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(n):
            self.flush_buf.zero_()
            if device:
                t.cuda._sleep(SPIN_CYCLES)
            a = t.cuda.Event(enable_timing=True)
            b = t.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    def timings(self, kernel, plain, library=None):
        """Call times of a kernel, its plain version and its library
        yardstick (None where there is none), and the device times of the
        kernel and the yardstick."""
        tm = self.time_ms
        return dict(
            ms=tm(kernel), plain_ms=tm(plain),
            library_ms=None if library is None else tm(library),
            device_ms=tm(kernel, device=True),
            library_device_ms=(None if library is None
                               else tm(library, device=True)))

    def pool(self, NP, page, KH, D, dtype):
        return (self.randn(NP, page, KH, D, dtype=dtype),
                self.randn(NP, page, KH, D, dtype=dtype))

    def tables(self, B, PPS, NP):
        """Distinct random pages per sequence (page 0 is the trash page)."""
        t = self.torch
        perm = t.randperm(NP - 1, generator=self.gen, device=self.dev) + 1
        return perm[:B * PPS].reshape(B, PPS).to(t.int32).contiguous()


def decode_case(K, *, B, H, KH, D, page, PPS, lens, Kt, tails, dtype):
    t = K.torch
    NP = B * PPS + 1
    q = K.randn(B, H, D, dtype=dtype)
    kp, vp = K.pool(NP, page, KH, D, dtype)
    tables = K.tables(B, PPS, NP)
    cl = t.tensor(lens, dtype=t.int32, device=K.dev)
    kt = K.randn(B, Kt, KH, D, dtype=dtype)
    vt = K.randn(B, Kt, KH, D, dtype=dtype)
    tl = t.tensor(tails, dtype=t.int32, device=K.dev)
    return dict(q=q, kp=kp, vp=vp, tables=tables, cl=cl, kt=kt, vt=vt, tl=tl)


def run_kernel_checks(torch, dev):
    from repro_torch.kernels.flash_attention.ops import paged_flash_prefill
    from repro_torch.kernels.flash_attention.ref import (
        paged_prefill_attention_ref)
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention.ops import (
        fused_decode_attention, paged_attention)
    from repro_torch.kernels.paged_attention.ref import (
        fused_decode_attention_ref, gather_kv, paged_attention_ref)
    F = torch.nn.functional
    K = Kernels(torch, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}

    def compare(name, out, ref, dtype, label):
        rel, absd = rel_err(out, ref)
        ok = rel <= TOL[str(dtype).split(".")[-1]]
        print(f"  {name:24s} {label:48s} rel_err={rel:.3e} abs={absd:.3e}"
              f" {'ok' if ok else 'FAIL'}")
        check(bool(torch.isfinite(out.float()).all()), f"{name} {label}: "
              "non-finite output")
        check(ok, f"{name} {label}: kernel disagrees with its plain version")
        return absd

    print("phase 2: kernels vs plain PyTorch versions")
    # -- decode: main-path shape (llama3.2-3b, 8 slots, page 64, Kt = 8) --
    main = dict(B=8, H=24, KH=8, D=128, page=64, PPS=64, Kt=8,
                lens=[1, 64, 65, 1000, 2047, 1536, 1100, 700],
                tails=[0, 1, 2, 3, 5, 6, 7, 8])
    edges = [
        dict(B=2, H=56, KH=8, D=128, page=16, PPS=4, Kt=3, lens=[16, 33],
             tails=[1, 3], dtype=bf16, label="G=7 (yi 56q/8kv)"),
        dict(B=2, H=8, KH=8, D=64, page=16, PPS=2, Kt=1, lens=[16, 20],
             tails=[1, 1], dtype=bf16, label="G=1 MHA, ctx%page==0"),
        dict(B=3, H=8, KH=2, D=64, page=32, PPS=1, Kt=5, lens=[7, 32, 0],
             tails=[5, 0, 0], dtype=bf16, label="single page, empty context"),
        dict(B=8, H=24, KH=8, D=128, page=64, PPS=64, Kt=8,
             lens=main["lens"], tails=main["tails"], dtype=f32,
             label="main shape, f32"),
        dict(B=2, H=56, KH=8, D=128, page=16, PPS=4, Kt=3, lens=[0, 48],
             tails=[0, 2], dtype=f32, label="G=7, empty row, f32"),
    ]
    # the split-K edges, for splits of `split` positions: a context on a
    # boundary and one position either side (S with a tail: a split of
    # tail rows only), a full table, one long sequence, tails across a
    # boundary, pages smaller and larger than a tile, G = 7 and G = 1 and
    # two head groups (G = 16) over several splits, D = 64 in f32
    split = pa_ops.SPLIT_POSITIONS
    edges += [
        dict(B=3, H=24, KH=8, D=128, page=64, PPS=8, Kt=8,
             lens=[split - 1, split, split + 1], tails=[0, 5, 8], dtype=bf16,
             label=f"ctx S-1, S, S+1 (S={split})"),
        dict(B=2, H=24, KH=8, D=128, page=64, PPS=64, Kt=8,
             lens=[4096, 4096], tails=[8, 1], dtype=bf16,
             label="full table: ctx 4096"),
        dict(B=1, H=24, KH=8, D=128, page=64, PPS=64, Kt=8, lens=[4000],
             tails=[6], dtype=bf16, label="B=1, ctx 4000"),
        dict(B=2, H=24, KH=8, D=128, page=64, PPS=8, Kt=8,
             lens=[split - 3, 2 * split - 1], tails=[7, 2], dtype=bf16,
             label="tails straddle a split boundary"),
        dict(B=2, H=24, KH=8, D=128, page=16, PPS=64, Kt=4,
             lens=[1000, 513], tails=[4, 1], dtype=bf16, label="page 16"),
        dict(B=2, H=24, KH=8, D=128, page=128, PPS=16, Kt=4,
             lens=[2047, 300], tails=[3, 4], dtype=bf16, label="page 128"),
        dict(B=2, H=56, KH=8, D=128, page=16, PPS=64, Kt=3,
             lens=[1023, 600], tails=[3, 0], dtype=bf16,
             label="G=7 over several splits"),
        dict(B=2, H=8, KH=8, D=64, page=32, PPS=32, Kt=2,
             lens=[1000, 257], tails=[2, 1], dtype=bf16,
             label="G=1 D=64 over several splits"),
        dict(B=2, H=16, KH=1, D=128, page=16, PPS=32, Kt=2,
             lens=[500, 17], tails=[2, 2], dtype=bf16,
             label="G=16: two head groups"),
        dict(B=2, H=16, KH=4, D=64, page=16, PPS=40, Kt=4,
             lens=[640, 255], tails=[4, 2], dtype=f32,
             label="D=64 G=4 over several splits, f32"),
    ]
    # phase 6's geometries: phi3.5-moe (32 query over 8 kv heads, G = 4)
    # and llava-next-34b (56 over 8, G = 7) at the main decode shape
    edges += [
        dict(main, H=32, dtype=bf16, label="phi3.5-moe G=4, main shape"),
        dict(main, H=56, dtype=bf16, label="llava-next-34b G=7, main shape"),
    ]
    # phase 8's per-shard geometries (a quarter of the kv heads and of
    # their query heads): llama3.2-3b's 6 over 2 (G = 3), phi3.5-moe's 8
    # over 2 (G = 4)
    edges += [
        dict(main, H=6, KH=2, dtype=bf16, label="llama3.2-3b shard: 6/2"),
        dict(main, H=8, KH=2, dtype=bf16, label="phi3.5-moe shard: 8/2"),
    ]
    c = decode_case(K, dtype=bf16, **main)
    args = (c["q"], c["kp"], c["vp"], c["tables"], c["cl"])
    targs = args + (c["kt"], c["vt"], c["tl"])
    err_pa = compare("paged_attention", paged_attention(*args),
                     paged_attention_ref(*args), bf16, "main shape, bf16")
    err_fd = compare("fused_decode_attention", fused_decode_attention(*targs),
                     fused_decode_attention_ref(*targs), bf16,
                     "main shape, bf16")
    for e in edges:
        e = dict(e)
        dtype, label = e.pop("dtype"), e.pop("label")
        ce = decode_case(K, dtype=dtype, **e)
        a = (ce["q"], ce["kp"], ce["vp"], ce["tables"], ce["cl"])
        ta = a + (ce["kt"], ce["vt"], ce["tl"])
        compare("paged_attention", paged_attention(*a),
                paged_attention_ref(*a), dtype, label)
        compare("fused_decode_attention", fused_decode_attention(*ta),
                fused_decode_attention_ref(*ta), dtype, label)
    torch.cuda.synchronize()

    # times and bounds at the main decode shape
    B, H, KH, D, Kt = 8, 24, 8, 128, 8
    G = H // KH
    ctx = sum(main["lens"])
    tail = sum(main["tails"])
    pages_read = sum(-(-n // 64) for n in main["lens"])
    io = 2 * B * H * D * 2 + pages_read * 4 + 3 * B * 4

    def decode_bound(n_pos):
        nbytes = io + n_pos * KH * D * 2 * 2
        flops = n_pos * KH * G * D * 4
        t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
        return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
                flops)

    # library yardstick: SDPA on the pre-gathered context (+ tail)
    S = 64 * 64
    kg = gather_kv(c["kp"], c["tables"]).transpose(1, 2).contiguous()
    vg = gather_kv(c["vp"], c["tables"]).transpose(1, 2).contiguous()
    pos = torch.arange(S, device=dev)
    mask_ctx = (pos[None, :] < c["cl"][:, None])[:, None, None, :]
    qs = c["q"][:, :, None, :]
    kgt = torch.cat([kg, c["kt"].transpose(1, 2)], dim=2).contiguous()
    vgt = torch.cat([vg, c["vt"].transpose(1, 2)], dim=2).contiguous()
    tpos = torch.arange(Kt, device=dev)
    mask_tail = torch.cat(
        [mask_ctx, (tpos[None, :] < c["tl"][:, None])[:, None, None, :]],
        dim=-1)
    b_pa, by_pa, f_pa = decode_bound(ctx)
    b_fd, by_fd, f_fd = decode_bound(ctx + tail)
    results["paged_attention"] = dict(
        max_abs_err=err_pa, bound_ms=b_pa, bound_by=by_pa, flops=f_pa,
        **K.timings(lambda: paged_attention(*args),
                    lambda: paged_attention_ref(*args),
                    lambda: F.scaled_dot_product_attention(
                        qs, kg, vg, attn_mask=mask_ctx, enable_gqa=True)))
    results["fused_decode_attention"] = dict(
        max_abs_err=err_fd, bound_ms=b_fd, bound_by=by_fd, flops=f_fd,
        **K.timings(lambda: fused_decode_attention(*targs),
                    lambda: fused_decode_attention_ref(*targs),
                    lambda: F.scaled_dot_product_attention(
                        qs, kgt, vgt, attn_mask=mask_tail, enable_gqa=True)))
    # the split size: device time at two other sizes, each checked first
    alt = {}
    for sp in (128, 512):
        pa_ops.SPLIT_POSITIONS = sp
        compare("paged_attention", paged_attention(*args),
                paged_attention_ref(*args), bf16, f"main shape, S={sp}")
        compare("fused_decode_attention", fused_decode_attention(*targs),
                fused_decode_attention_ref(*targs), bf16,
                f"main shape, S={sp}")
        alt[sp] = dict(
            paged_attention=K.time_ms(lambda: paged_attention(*args),
                                      device=True),
            fused_decode_attention=K.time_ms(
                lambda: fused_decode_attention(*targs), device=True))
    pa_ops.SPLIT_POSITIONS = split
    # after some thousand calls the outputs still agree and every counter
    # is back at 0
    compare("fused_decode_attention", fused_decode_attention(*targs),
            fused_decode_attention_ref(*targs), bf16,
            "main shape, after the timed calls")
    torch.cuda.synchronize()
    check(not any(cnt.any().item() for _, cnt in pa_ops._WORKSPACE.values()),
          "paged decode: a split counter was left non-zero")
    geometry = decode_geometry(main, c["cl"], c["tl"], split)
    # what one kernel that only reads the main shape's K and V takes,
    # timed the same way: a PyTorch sum over as many bf16 bytes
    kv_bytes = ctx * KH * D * 2 * 2
    xs = torch.empty(kv_bytes // 2, dtype=bf16, device=dev).normal_(
        generator=K.gen)
    geometry["read_floor_device_ms"] = K.time_ms(lambda: xs.sum(),
                                                 device=True)
    print(f"  read floor: torch sum over the main shape's {kv_bytes} B of "
          f"K and V: {geometry['read_floor_device_ms']:.4f} ms (device time)")
    del xs
    for name in ("paged_attention", "fused_decode_attention"):
        for sp, t in alt.items():
            print(f"  time {name:24s} (device time) at S={sp}: "
                  f"{t[name]:.4f} ms")
        results[name]["device_ms_by_split"] = {
            split: results[name]["device_ms"],
            **{sp: t[name] for sp, t in alt.items()}}
    results["paged_attention"]["geometry"] = geometry
    del kg, vg, kgt, vgt

    # -- prefill: 512-token chunks at q_start 0, 1000 (straddles pages) and
    # 1024 (the main path: the tail after a cached 1024-token prefix) --
    def prefill_case(B, C, H, KH, D, page, PPS, start, dtype):
        NP = B * PPS + 1
        q = K.randn(B, C, H, D, dtype=dtype)
        kp, vp = K.pool(NP, page, KH, D, dtype)
        return q, kp, vp, K.tables(B, PPS, NP), start, start + C

    pcases = [
        (dict(B=1, C=512, H=24, KH=8, D=128, page=64, PPS=64, start=0,
              dtype=bf16), "C=512 at 0, bf16"),
        (dict(B=1, C=512, H=24, KH=8, D=128, page=64, PPS=64, start=1000,
              dtype=bf16), "C=512 at 1000 (straddles pages), bf16"),
        (dict(B=2, C=8, H=56, KH=8, D=128, page=16, PPS=2, start=8,
              dtype=bf16), "G=7, tiny chunk, bf16"),
        (dict(B=1, C=37, H=24, KH=8, D=128, page=16, PPS=16, start=100,
              dtype=bf16), "C=37 G=3: rows end mid-tile, bf16"),
        (dict(B=2, C=9, H=56, KH=8, D=128, page=16, PPS=8, start=50,
              dtype=bf16), "C=9 G=7 at 50: rows end mid-tile, bf16"),
        (dict(B=1, C=200, H=24, KH=8, D=128, page=16, PPS=40, start=300,
              dtype=bf16), "page 16: a key tile spans 4 pages, bf16"),
        (dict(B=1, C=100, H=16, KH=4, D=64, page=32, PPS=8, start=77,
              dtype=bf16), "D=64 G=4 page 32, q_start 77, bf16"),
        (dict(B=1, C=300, H=24, KH=8, D=128, page=128, PPS=8, start=600,
              dtype=bf16), "page 128 > key tile, bf16"),
        (dict(B=1, C=5, H=4, KH=1, D=64, page=16, PPS=1, start=0,
              dtype=f32), "MQA, single page, f32"),
        (dict(B=1, C=512, H=24, KH=8, D=128, page=64, PPS=64, start=1024,
              dtype=f32), "C=512 at 1024, f32"),
        (dict(B=1, C=512, H=32, KH=8, D=128, page=64, PPS=64, start=1024,
              dtype=bf16), "phi3.5-moe G=4: C=512 at 1024, bf16"),
        (dict(B=1, C=512, H=56, KH=8, D=128, page=64, PPS=64, start=1024,
              dtype=bf16), "llava-next-34b G=7: C=512 at 1024, bf16"),
    ]
    for kw, label in pcases:
        a = prefill_case(**kw)
        compare("paged_flash_prefill", paged_flash_prefill(*a),
                paged_prefill_attention_ref(*a), kw["dtype"], label)
    pm = prefill_case(B=1, C=512, H=24, KH=8, D=128, page=64, PPS=64,
                      start=1024, dtype=bf16)
    err_pf = compare("paged_flash_prefill", paged_flash_prefill(*pm),
                     paged_prefill_attention_ref(*pm), bf16,
                     "main: C=512 at 1024, bf16")
    C, start = 512, 1024
    kv_len = start + C
    pairs = sum(start + i + 1 for i in range(C)) * G * KH
    flops = pairs * 4 * D
    nbytes = 2 * C * H * D * 2 + kv_len * KH * D * 2 * 2 \
        + -(-kv_len // 64) * 4
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    qsd = pm[0].transpose(1, 2)                           # (1, H, C, D)
    kpg = gather_kv(pm[1], pm[3])[:, :kv_len].transpose(1, 2).contiguous()
    vpg = gather_kv(pm[2], pm[3])[:, :kv_len].transpose(1, 2).contiguous()
    kpos = torch.arange(kv_len, device=dev)
    qpos = start + torch.arange(C, device=dev)
    pmask = kpos[None, :] <= qpos[:, None]
    results["paged_flash_prefill"] = dict(
        max_abs_err=err_pf, bound_ms=max(t_b, t_f) * 1e3,
        bound_by="bytes" if t_b >= t_f else "operations", flops=flops,
        **K.timings(lambda: paged_flash_prefill(*pm),
                    lambda: paged_prefill_attention_ref(*pm),
                    lambda: F.scaled_dot_product_attention(
                        qsd, kpg, vpg, attn_mask=pmask, enable_gqa=True)))
    torch.cuda.synchronize()
    print_times(results)
    return results


def decode_geometry(main, ctx_lens, tail_lens, split):
    """Print and return the paged decode kernels' launch at the main
    shape: split size, blocks, blocks that hold work, ring stages, dynamic
    shared memory and workspace bytes."""
    import ctypes
    from repro_torch.kernels import _build
    B, H, KH, D = main["B"], main["H"], main["KH"], main["D"]
    G = H // KH
    heads, stages = ctypes.c_int(), ctypes.c_int()
    fn = _build.library("paged_attention").paged_attention_geometry
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 2
    smem = fn(G, D, 1, ctypes.byref(heads), ctypes.byref(stages))
    groups = -(-G // heads.value)
    out = {"split": split, "stages": stages.value,
           "dynamic_smem_bytes": smem, "heads_per_block": heads.value}
    ctx = [int(n) for n in ctx_lens.tolist()]
    tails = [int(n) for n in tail_lens.tolist()]
    for name, n_pos, tl in (
            ("paged_attention", main["PPS"] * main["page"], [0] * B),
            ("fused_decode_attention", main["PPS"] * main["page"] + main["Kt"],
             tails)):
        nsplit = -(-n_pos // split)
        active = sum(max(1, -(-(c + t) // split)) for c, t in zip(ctx, tl))
        out[name] = {"blocks": nsplit * KH * groups * B,
                     "active_blocks": active * KH * groups,
                     "workspace_bytes": B * H * nsplit * (D + 2) * 4
                     + B * H * 4}
        print(f"  geometry {name:24s} S={split}: {out[name]['blocks']} blocks"
              f" ({KH * groups} x {B} x {nsplit} splits), "
              f"{out[name]['active_blocks']} with work; {stages.value} "
              f"stages, {smem} B dynamic shared memory, "
              f"{heads.value} heads a block; workspace "
              f"{out[name]['workspace_bytes']} B")
    return out


# ---------------------------------------------------------------------------
# phase 2 (hybrid path): the SSD scan and dense flash attention
# ---------------------------------------------------------------------------

def print_times(results):
    """Each timed kernel beside its plain version, its library yardstick
    and its bound, with the TFLOP/s it achieves on the operations the bound
    counts: call times first, then device times."""
    for name, r in results.items():
        lib, dlib = (("--", "--") if r["library_ms"] is None else
                     (f"{r['library_ms']:.4f} ms",
                      f"{r['library_device_ms']:.4f} ms"))
        print(f"  time {name:24s} kernel {r['ms']:.4f} ms  plain "
              f"{r['plain_ms']:.4f} ms  library {lib}  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  "
              f"{r['flops'] / r['ms'] / 1e9:.1f} TFLOP/s")
        print(f"       {'(device time)':24s} kernel {r['device_ms']:.4f} ms  "
              f"library {dlib}  "
              f"{r['flops'] / r['device_ms'] / 1e9:.1f} TFLOP/s")


def ssd_bound(b, s, h, p, n, Q, elem, g=1):
    """(least ms, 'bytes' | 'operations', operations) of one SSD scan with
    ``g`` groups of B and C: each input and output once at the HBM rate, or
    the products these inputs need at the bf16 tensor-core rate -- C B^T
    once per chunk and group (it is shared by the group's heads), and per
    head the weighted product with x, the state term of every chunk after
    the first (the first enters with a zero state) and the state update."""
    nbytes = b * s * h * p * elem * 2 + b * s * h * 4 \
        + 2 * b * s * g * n * elem + b * h * p * n * 4
    flops = 0
    for c0 in range(0, s, Q):
        q = min(Q, s - c0)
        tri = q * (q + 1) // 2
        flops += b * tri * n * 2 * g
        flops += b * h * (tri * p * 2 + q * p * n * 2
                          + (q * n * p * 2 if c0 else 0))
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            flops)


# the bf16 SSD route's three launches, by kernel name
SSD_PASSES = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
              "ssd_chunk_scan_kernel")
SASS_OPS = ("HGMMA", "HMMA", "LDGSTS")


def ssd_geometry(b, s, h, p, n, Q):
    """Print and return the bf16 SSD route's launch at one shape: each
    pass's grid, threads and dynamic shared memory, and the workspace."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops
    fn = _build.library("ssd").ssd_geometry
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    out = (ctypes.c_int * 15)()
    check(fn(b, s, h, p, n, Q, out) == 0, "ssd_geometry refused the shape")
    ws = ops._entry("ssd_workspace_bytes")(b, s, h, p, n, Q, 1)
    geo = {"workspace_bytes": ws}
    for i, name in enumerate(SSD_PASSES):
        gx, gy, gz, threads, smem = out[5 * i:5 * i + 5]
        geo[name] = {"grid": [gx, gy, gz], "threads": threads,
                     "dynamic_smem_bytes": smem}
        print(f"  geometry ssd {name:22s} b={b} s={s} h={h} n={n}: "
              f"{gx * gy * gz} blocks ({gx} x {gy} x {gz}) of {threads} "
              f"threads, {smem} B dynamic shared memory")
    print(f"  geometry ssd workspace b={b} s={s} h={h} n={n}: {ws} B")
    return geo


def pass_device_ms(torch, K, fn, names, n=20):
    """Device time (ms a call) of each kernel of ``fn`` whose name holds one
    of ``names``, from a torch.profiler trace of ``n`` calls, each after an
    L2 flush; 0.0 where the trace saw no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            K.flush_buf.zero_()
            fn()
        torch.cuda.synchronize()
    out = dict.fromkeys(names, 0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in names:
            if k in e.name:
                out[k] += e.time_range.elapsed_us() / 1e3 / n
    return out


def instantiation(mangled):
    """'ssd_chunk_scan_kernel<64>' for a mangled ssd kernel name, else
    None."""
    for name in SSD_PASSES + ("ssd_fma_kernel",):
        if name in mangled:
            tail = mangled.split(name, 1)[1]
            m = re.match(r"I((?:Li\d+E)+)E", tail)
            args = re.findall(r"Li(\d+)E", m.group(1)) if m else []
            return f"{name}<{', '.join(args)}>" if args else name
    return None


def ssd_sass():
    """Per ssd kernel instantiation: registers and spills from this run's
    ptxas log, and the count of tensor-core (HGMMA, HMMA) and cp.async
    (LDGSTS) instructions in the built library (``cuobjdump -sass``).
    Fails unless both bf16 product passes run on the tensor cores."""
    from repro_torch.kernels import _build
    out = {}
    cur = None
    for line in _build.BUILD_LOG.get("ssd", "").splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            cur = out.setdefault(instantiation(m.group(1)) or m.group(1), {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur is not None:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and cur is not None:
            cur["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(Path(tool).exists(), "cuobjdump not found: no SASS count")
    sass = subprocess.run([tool, "-sass", str(_build._paths("ssd")[1])],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(instantiation(m.group(1)) or m.group(1), {})
            cur.update(dict.fromkeys(SASS_OPS, 0))
            continue
        if cur is not None:
            for op in re.findall(r"\b(" + "|".join(SASS_OPS) + r")\b", line):
                cur[op] += 1
    for name, r in sorted(out.items()):
        print(f"  ssd {name:28s} {r.get('registers', '?')} registers, "
              f"spills {r.get('spill_stores', '?')}/"
              f"{r.get('spill_loads', '?')} B; SASS "
              + ", ".join(f"{r.get(op, 0)} {op}" for op in SASS_OPS))
    for name, r in out.items():
        if name.startswith((SSD_PASSES[0], SSD_PASSES[2])):
            check(r.get("HGMMA", 0) + r.get("HMMA", 0) > 0,
                  f"{name}: no tensor-core instruction in its SASS")
    check(any(n.startswith("ssd_chunk_scan_kernel") for n in out),
          "no ssd_chunk_scan_kernel in the ssd library's SASS")
    return out


def flash_bound(B, S, H, KH, D, window, seq_k, elem, causal=True):
    """(least ms, by what, operations) of dense attention: q, k, v and the
    output once, or 4 * D flops for every visible (query, key) pair."""
    pairs = 0
    for i in range(S):
        lo = max(0, i - window + 1) if window else 0
        pairs += max(0, min(i + 1 if causal else seq_k, seq_k) - lo)
    flops = pairs * B * H * 4 * D
    nbytes = 2 * B * S * H * D * elem + 2 * B * S * KH * D * elem
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations",
            flops)


def run_hybrid_kernel_checks(torch, dev):
    """The two kernels of the slot engine's prefill against their plain
    versions at zamba2-2.7b's and mamba2-130m's shapes and the edge cases,
    then their times at zamba2-2.7b's and Zamba2-7B's prefill of a
    2048-token prompt (the latter: 2 groups of B and C, heads of 224)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssd.ops import ssd
    from repro_torch.kernels.ssd.ref import ssd_chunked
    from repro_torch.models.layers import chunked_attention
    F = torch.nn.functional
    K = Kernels(torch, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    results = {}

    def compare(name, out, ref, dtype, label, tol=None):
        rel, absd = rel_err(out, ref)
        tol = tol or TOL[str(dtype).split(".")[-1]]
        print(f"  {name:24s} {label:48s} rel_err={rel:.3e} abs={absd:.3e}"
              f" {'ok' if rel <= tol else 'FAIL'}")
        check(bool(torch.isfinite(out.float()).all()), f"{name} {label}: "
              "non-finite output")
        check(rel <= tol, f"{name} {label}: kernel disagrees with its plain "
              "version")
        return absd

    # -- SSD: B and C are column views of the conv output, as on the path;
    # with g > 1 groups, (b, s, g, n) views of it --
    def ssd_case(b, s, h, p, n, dtype, g=0):
        x = K.randn(b, s, h, p, dtype=dtype)
        a = -torch.rand(b, s, h, generator=K.gen, device=dev) * 0.5
        gn = max(g, 1) * n
        xbc = K.randn(b, s, h * p + 2 * gn, dtype=dtype)
        B, C = xbc[..., h * p:h * p + gn], xbc[..., h * p + gn:]
        if g:
            B, C = B.unflatten(-1, (g, n)), C.unflatten(-1, (g, n))
        return x, a, B, C

    scases = [
        (dict(b=1, s=2048, h=80, p=64, n=64, dtype=f32),
         "zamba2 s=2048, f32"),
        (dict(b=1, s=1536, h=24, p=64, n=128, dtype=bf16),
         "mamba2-130m n=128 s=1536, bf16"),
        (dict(b=1, s=1536, h=24, p=64, n=128, dtype=f32),
         "mamba2-130m n=128 s=1536, f32"),
        (dict(b=1, s=200, h=80, p=64, n=64, dtype=bf16),
         "s=200 < chunk (Q=200), bf16"),
        (dict(b=1, s=777, h=80, p=64, n=64, dtype=bf16),
         "s=777 ragged last chunk, bf16"),
        (dict(b=1, s=1, h=80, p=64, n=64, dtype=f32), "s=1, f32"),
        (dict(b=2, s=300, h=24, p=64, n=128, dtype=bf16),
         "b=2 s=300 n=128, bf16"),
        (dict(b=1, s=256, h=80, p=64, n=64, dtype=bf16),
         "s=256 = Q: one full chunk, bf16"),
        (dict(b=1, s=257, h=80, p=64, n=64, dtype=bf16),
         "s=257 = Q+1: a one-row last chunk, bf16"),
        (dict(b=1, s=4096, h=80, p=64, n=64, dtype=bf16),
         "s=4096: 16 chunks, bf16"),
        (dict(b=2, s=1000, h=80, p=64, n=64, dtype=bf16),
         "b=2 s=1000 n=64, bf16"),
        # Zamba2-7B's mixer: 112 heads reading 2 groups of B and C
        (dict(b=1, s=2048, h=112, p=64, n=64, dtype=bf16, g=2),
         "zamba2-7b g=2 s=2048, bf16"),
        (dict(b=1, s=2048, h=112, p=64, n=64, dtype=f32, g=2),
         "zamba2-7b g=2 s=2048, f32"),
        (dict(b=1, s=777, h=112, p=64, n=64, dtype=bf16, g=2),
         "zamba2-7b g=2 s=777 ragged, bf16"),
        (dict(b=2, s=300, h=24, p=64, n=128, dtype=bf16, g=3),
         "g=3 b=2 s=300 n=128, bf16"),
    ]
    print("  (SSD: y against ssd_chunked by dtype; final state within "
          f"{SSD_STATE_TOL} of its scale)")
    for kw, label in scases:
        a = ssd_case(**kw)
        y, st = ssd(*a, 256)
        yr, str_ = ssd_chunked(*a, 256)
        compare("ssd", y, yr, kw["dtype"], label)
        compare("ssd (final state)", st, str_, f32, label, SSD_STATE_TOL)
    sm = ssd_case(1, 2048, 80, 64, 64, bf16)
    y, st = ssd(*sm, 256)
    yr, str_ = ssd_chunked(*sm, 256)
    err_ssd = compare("ssd", y, yr, bf16, "main: zamba2 s=2048, bf16")
    compare("ssd (final state)", st, str_, f32, "main: zamba2 s=2048, bf16",
            SSD_STATE_TOL)
    b_ssd, by_ssd, f_ssd = ssd_bound(1, 2048, 80, 64, 64, 256, 2)
    results["ssd"] = dict(
        max_abs_err=err_ssd, bound_ms=b_ssd, bound_by=by_ssd, flops=f_ssd,
        **K.timings(lambda: ssd(*sm, 256), lambda: ssd_chunked(*sm, 256)))
    results["ssd"]["geometry"] = {
        "zamba2 s=2048 n=64": ssd_geometry(1, 2048, 80, 64, 64, 256),
        "mamba2-130m s=1536 n=128": ssd_geometry(1, 1536, 24, 64, 128, 256)}
    passes = pass_device_ms(torch, K, lambda: ssd(*sm, 256), SSD_PASSES)
    results["ssd"]["device_ms_by_pass"] = passes
    for name, ms in passes.items():
        print(f"  time ssd pass {name:24s} (device time, profiler) "
              + (f"{ms:.4f} ms" if ms else "not measured"))
    # what moving the passes' main bytes alone takes, timed the same way:
    # one read of x (pass 1 reads it; pass 3 reads it again from L2 or
    # device memory) and one copy of x (pass 3 reads x and writes y)
    yc = torch.empty_like(sm[0])
    floors = {"read_x": K.time_ms(lambda: sm[0].sum(), device=True),
              "copy_x": K.time_ms(lambda: yc.copy_(sm[0]), device=True)}
    results["ssd"]["floors_device_ms"] = floors
    print(f"  floors: torch sum over x ({sm[0].nbytes} B) "
          f"{floors['read_x']:.4f} ms, copy of x {floors['copy_x']:.4f} ms "
          "(device time)")
    results["ssd"]["sass"] = ssd_sass()
    del sm, y, yr, yc
    # Zamba2-7B's prefill of a 2048-token prompt: x (1, 2048, 112, 64), B
    # and C (1, 2048, 2, 64)
    sz = ssd_case(1, 2048, 112, 64, 64, bf16, g=2)
    y, st = ssd(*sz, 256)
    yr, str_ = ssd_chunked(*sz, 256)
    err_z = compare("ssd", y, yr, bf16, "main: zamba2-7b g=2 s=2048, bf16")
    b_z, by_z, f_z = ssd_bound(1, 2048, 112, 64, 64, 256, 2, g=2)
    results["ssd zamba2-7b"] = dict(
        max_abs_err=err_z, bound_ms=b_z, bound_by=by_z, flops=f_z,
        **K.timings(lambda: ssd(*sz, 256), lambda: ssd_chunked(*sz, 256)))
    del sz, y, yr
    torch.cuda.synchronize()

    # -- dense flash attention, Sq == Sk (start- and end-aligned agree) --
    def flash_case(B, S, H, KH, D, dtype):
        return (K.randn(B, S, H, D, dtype=dtype),
                K.randn(B, S, KH, D, dtype=dtype),
                K.randn(B, S, KH, D, dtype=dtype))

    fcases = [
        (dict(B=1, S=2048, H=32, KH=32, D=80, dtype=f32), 0, None,
         "zamba2 D=80 G=1 S=2048, f32"),
        (dict(B=1, S=4608, H=32, KH=32, D=80, dtype=bf16), 4096, None,
         "zamba2 D=80 S=4608 window 4096, bf16"),
        (dict(B=1, S=1024, H=32, KH=32, D=80, dtype=bf16), 300, None,
         "D=80 S=1024 window 300, bf16"),
        (dict(B=1, S=2048, H=32, KH=32, D=80, dtype=bf16), 0, 1900,
         "D=80 S=2048 padded seq_k=1900, bf16"),
        (dict(B=2, S=1536, H=24, KH=8, D=128, dtype=bf16), 0, None,
         "D=128 G=3 B=2 S=1536, bf16"),
        (dict(B=1, S=4608, H=24, KH=8, D=128, dtype=bf16), 4096, None,
         "D=128 G=3 S=4608 window 4096, bf16"),
        (dict(B=1, S=333, H=24, KH=8, D=128, dtype=f32), 0, 300,
         "D=128 G=3 S=333 seq_k=300, f32"),
        (dict(B=1, S=256, H=8, KH=8, D=64, dtype=bf16), 0, None,
         "D=64 G=1 S=256, bf16"),
        (dict(B=1, S=1024, H=32, KH=32, D=80, dtype=bf16), 300, 900,
         "D=80 window 300, padded seq_k=900, bf16"),
        (dict(B=1, S=300, H=16, KH=8, D=64, dtype=bf16), 100, 280,
         "D=64 G=2 window 100 seq_k=280, bf16"),
        (dict(B=1, S=37, H=24, KH=8, D=128, dtype=bf16), 0, None,
         "D=128 G=3 S=37: rows end mid-tile, bf16"),
        (dict(B=1, S=200, H=32, KH=32, D=80, dtype=bf16, causal=False), 0,
         150, "D=80 not causal, seq_k=150, bf16"),
        # phase 8d's per-shard geometry: zamba2's shared attention at 8 of
        # its 32 heads, at the longest prompt and a ragged one
        (dict(B=1, S=2048, H=8, KH=8, D=80, dtype=bf16), 0, None,
         "zamba2 shard: 8/8 D=80 S=2048, bf16"),
        (dict(B=1, S=777, H=8, KH=8, D=80, dtype=bf16), 0, None,
         "zamba2 shard: 8/8 D=80 S=777, bf16"),
    ]
    for kw, window, seq_k, label in fcases:
        kw = dict(kw)
        causal = kw.pop("causal", True)
        q, k, v = flash_case(**kw)
        out = flash_attention(q, k, v, causal=causal, window=window,
                              seq_k=seq_k)
        compare("flash_attention", out,
                attention_ref(q, k, v, causal=causal, window=window,
                              kv_len=seq_k),
                kw["dtype"], label)
        del q, k, v, out
    # Zamba2-7B's shared attention: 32 heads of 224 at scale (224/2)^-0.5,
    # against the plain version at that scale
    zscale = 112 ** -0.5
    zcases = [
        (dict(B=1, S=2048, H=32, KH=32, D=224, dtype=bf16), 0, None,
         "zamba2-7b D=224 S=2048 scale, bf16"),
        (dict(B=1, S=333, H=32, KH=32, D=224, dtype=f32), 0, 300,
         "zamba2-7b D=224 S=333 seq_k=300 scale, f32"),
        (dict(B=2, S=777, H=8, KH=4, D=224, dtype=bf16), 100, None,
         "D=224 G=2 B=2 S=777 window 100 scale, bf16"),
    ]
    for kw, window, seq_k, label in zcases:
        q, k, v = flash_case(**kw)
        out = flash_attention(q, k, v, window=window, seq_k=seq_k,
                              scale=zscale)
        compare("flash_attention", out,
                chunked_attention(q, k, v, window=window, kv_len=seq_k,
                                  scale=zscale), kw["dtype"], label)
        del q, k, v, out
    q, k, v = flash_case(1, 1024, 32, 32, 224, bf16)
    compare("flash_attention", flash_attention(q, k, v),
            attention_ref(q, k, v), bf16, "D=224 S=1024 default scale, bf16")
    del q, k, v
    fm = flash_case(1, 2048, 32, 32, 80, bf16)
    out = flash_attention(*fm)
    err_fa = compare("flash_attention", out, attention_ref(*fm), bf16,
                     "main: zamba2 S=2048 vs attention_ref, bf16")
    compare("flash_attention", out, chunked_attention(*fm), bf16,
            "main: zamba2 S=2048 vs chunked_attention, bf16")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in fm)
    b_fa, by_fa, f_fa = flash_bound(1, 2048, 32, 32, 80, 0, 2048, 2)
    results["flash_attention"] = dict(
        max_abs_err=err_fa, bound_ms=b_fa, bound_by=by_fa, flops=f_fa,
        **K.timings(lambda: flash_attention(*fm),
                    lambda: chunked_attention(*fm),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True)))
    # -- Zamba2-7B's one-shot prefill of a 2048-token prompt: (1, 2048, 32,
    # 224), causal, scale (224/2)^-0.5 --
    zm = flash_case(1, 2048, 32, 32, 224, bf16)
    err_z = compare("flash_attention",
                    flash_attention(*zm, scale=zscale),
                    chunked_attention(*zm, scale=zscale), bf16,
                    "main: zamba2-7b S=2048 D=224, bf16")
    zt = [t.transpose(1, 2).contiguous() for t in zm]
    b_z, by_z, f_z = flash_bound(1, 2048, 32, 32, 224, 0, 2048, 2)
    results["flash_attention zamba2-7b"] = dict(
        max_abs_err=err_z, bound_ms=b_z, bound_by=by_z, flops=f_z,
        **K.timings(lambda: flash_attention(*zm, scale=zscale),
                    lambda: chunked_attention(*zm, scale=zscale),
                    lambda: F.scaled_dot_product_attention(
                        *zt, is_causal=True, scale=zscale)))
    del zm, zt
    # -- hubert-xlarge's encoder attention (phase 6): non-causal, G = 1,
    # D = 80, a padded batch of 8 sequences of 512 frames --
    hm = flash_case(8, 512, 16, 16, 80, bf16)
    err_h = compare("flash_attention",
                    flash_attention(*hm, causal=False),
                    attention_ref(*hm, causal=False), bf16,
                    "hubert (8, 512, 16, 80) not causal, bf16")
    ht = [t.transpose(1, 2).contiguous() for t in hm]
    b_h, by_h, f_h = flash_bound(8, 512, 16, 16, 80, 0, 512, 2, causal=False)
    results["flash_attention hubert"] = dict(
        max_abs_err=err_h, bound_ms=b_h, bound_by=by_h, flops=f_h,
        **K.timings(lambda: flash_attention(*hm, causal=False),
                    lambda: chunked_attention(*hm, causal=False),
                    lambda: F.scaled_dot_product_attention(*ht)))
    torch.cuda.synchronize()
    print_times(results)
    return results


def slot_lengths(n, seed):
    """Context lengths drawn like ``zamba2-chat-burst``'s rows: a prompt of
    lognormal(5.1, 0.9) tokens in 16..1024 and part of an output of
    lognormal(5.0, 0.8) tokens in 16..512."""
    import numpy as np
    rng = np.random.default_rng(seed)
    prompt = np.clip(rng.lognormal(5.1, 0.9, n), 16, 1024).astype(int)
    out = np.clip(rng.lognormal(5.0, 0.8, n), 16, 512).astype(int)
    return (prompt + rng.integers(0, out)).tolist()


def run_slot_kernel_checks(torch, dev):
    """The slot decode attention kernel against its plain version in
    float32 at Zamba2-7B's decode step, at the slot engines' other head
    dims and groupings and at the edges (empty, one-position, full and
    overgrown slots, split boundaries, windows), then its time at
    Zamba2-7B's step beside the plain version's, SDPA's on the
    pre-gathered cache with a mask of the live positions, and its bound:
    the live K/V bytes once, q and the output, at 3.35 TB/s."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels.slot_attention.ops import slot_decode_attention
    from repro_torch.models.layers import decode_attention_appended
    F = torch.nn.functional
    K = Kernels(torch, dev)
    bf16, f32 = torch.bfloat16, torch.float32
    zscale = 112 ** -0.5
    edges = [0, 1, 255, 256, 257]

    def case(B, KH, G, S, D, dtype, lens):
        return (K.randn(B, 1, KH * G, D, dtype=dtype),
                K.randn(B, KH, S, D, dtype=dtype),
                K.randn(B, KH, S, D, dtype=dtype),
                K.randn(B, KH, D, dtype=dtype),
                K.randn(B, KH, D, dtype=dtype),
                torch.tensor(lens, dtype=torch.int32, device=dev))

    def compare(label, args, window=0, scale=None):
        q, kc, vc, kn, vn, n = args
        out = slot_decode_attention(q, kc, vc, kn, vn, prev_len=n,
                                    window=window, scale=scale)
        ref = decode_attention_appended(
            *(t.float() for t in (q, kc, vc, kn, vn)), prev_len=n,
            window=window, scale=scale)
        rel, absd = rel_err(out, ref)
        tol = TOL[str(q.dtype).split(".")[-1]]
        print(f"  {'slot_decode_attention':24s} {label:48s} rel_err="
              f"{rel:.3e} abs={absd:.3e} {'ok' if rel <= tol else 'FAIL'}")
        check(bool(torch.isfinite(out.float()).all()),
              f"slot_decode_attention {label}: non-finite output")
        check(rel <= tol, f"slot_decode_attention {label}: kernel disagrees "
              "with its plain version")
        return absd

    cases = [
        (dict(B=8, KH=4, G=2, S=700, D=224, dtype=f32), 300, zscale,
         "D=224 G=2 window 300 scale, f32"),
        (dict(B=9, KH=32, G=1, S=4096, D=80, dtype=bf16), 0, None,
         "zamba2-2.7b D=80 G=1 S=4096, bf16"),
        (dict(B=9, KH=8, G=1, S=4096, D=80, dtype=bf16), 0, None,
         "zamba2 shard: 8/8 D=80, bf16"),
        (dict(B=9, KH=8, G=3, S=4096, D=128, dtype=bf16), 0, None,
         "llama D=128 G=3 S=4096, bf16"),
        (dict(B=9, KH=8, G=3, S=1024, D=128, dtype=f32), 100, None,
         "llama D=128 G=3 window 100, f32"),
        (dict(B=9, KH=8, G=4, S=2048, D=128, dtype=bf16), 0, None,
         "phi3.5-moe D=128 G=4, bf16"),
        (dict(B=9, KH=8, G=7, S=2048, D=128, dtype=bf16), 0, None,
         "llava D=128 G=7, bf16"),
        (dict(B=9, KH=1, G=48, S=2048, D=128, dtype=bf16), 37, None,
         "granite MQA D=128 G=48 window 37, bf16"),
        (dict(B=9, KH=2, G=1, S=128, D=64, dtype=bf16), 0, None,
         "D=64 G=1 S=128, bf16"),
    ]
    for kw, window, scale, label in cases:
        S = kw["S"]
        lens = (edges + [S - 1, S, S + 300, 500])[:kw["B"]]
        compare(label, case(**kw, lens=lens), window, scale)
    # -- Zamba2-7B's decode step: 32 slots of 2048, 32 heads of 224, the
    # lengths drawn like the cell's, and one with every edge --
    B, KH, S, D = 32, 32, 2048, 224
    edge_lens = edges + [2047, 2048, 2300] + slot_lengths(B - 8, 7)
    compare("zamba2-7b edges B=32 S=2048 D=224, bf16",
            case(B, KH, 1, S, D, bf16, edge_lens), scale=zscale)
    lens = slot_lengths(B, 11)
    zm = case(B, KH, 1, S, D, bf16, lens)
    err = compare("main: zamba2-7b B=32 S=2048 D=224, bf16", zm,
                  scale=zscale)
    q, kc, vc, kn, vn, n = zm
    # SDPA on the pre-gathered cache: the new token appended, a mask of
    # the live positions
    kf, vf = (torch.cat([c, x[:, :, None]], 2) for c, x in ((kc, kn),
                                                             (vc, vn)))
    pos = torch.arange(S + 1, device=dev)
    mask = ((pos < n[:, None]) | (pos == S))[:, None, None, :]
    qt = q.transpose(1, 2)
    rows = sum(min(x, S) + 1 for x in lens)          # per (b, kh) summed
    nbytes = rows * KH * D * 2 * 2 + 2 * B * KH * D * 2
    flops = 4 * rows * KH * D
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    lib = _build.library("slot_attention")
    hpb, tile, stages = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    ring = lib.slot_attention_geometry(1, D, 1, ctypes.byref(hpb),
                                       ctypes.byref(tile),
                                       ctypes.byref(stages))
    geometry = {"heads_per_block": hpb.value, "tile": tile.value,
                "stages": stages.value, "ring_bytes": ring}
    print(f"  geometry slot_decode_attention D={D} bf16 G=1: {geometry}; "
          f"live rows {rows} of {B * (S + 1)}, mean context "
          f"{sum(lens) / B:.1f}")
    r = dict(max_abs_err=err, bound_ms=bound, bound_by="bytes", flops=flops,
             geometry=geometry, lens=lens,
             **K.timings(
                 lambda: slot_decode_attention(q, kc, vc, kn, vn,
                                               prev_len=n, scale=zscale),
                 lambda: decode_attention_appended(q, kc, vc, kn, vn,
                                                   prev_len=n, scale=zscale),
                 lambda: F.scaled_dot_product_attention(
                     qt, kf, vf, attn_mask=mask, scale=zscale)))
    r["share"] = bound / r["device_ms"]
    print(f"  slot_decode_attention share of its bound by device time "
          f"{r['share']:.3f}")
    results = {"slot_decode_attention": r}
    torch.cuda.synchronize()
    print_times(results)
    return results


def mixer_case(torch, dev, cfg, b, seed):
    """One mixer's bf16 weights (conv bias and D drawn away from 0 and 1),
    a zxbcdt row and a slot cache of one layer."""
    from repro_torch.models.mamba2 import init_mamba
    gen = torch.Generator(device=dev).manual_seed(seed)
    p = {k: v[0] for k, v in init_mamba(gen, cfg, torch.bfloat16, 1).items()}
    p["conv_b"] = (0.1 * torch.randn(p["conv_b"].shape, generator=gen,
                                     device=dev)).bfloat16()
    p["D"] = torch.rand(p["D"].shape, generator=gen, device=dev)
    di, gn, h = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state, cfg.ssm_heads
    zx = torch.randn(b, 1, 2 * di + 2 * gn + h, generator=gen,
                     device=dev).bfloat16()
    cache = {"conv": torch.randn(1, b, cfg.ssm.conv_kernel - 1, di + 2 * gn,
                                 generator=gen, device=dev).bfloat16(),
             "ssm": 0.5 * torch.randn(1, b, h, cfg.ssm.head_dim,
                                      cfg.ssm.d_state, generator=gen,
                                      device=dev)}
    return p, zx, cache


def mixer_bytes(b, cfg):
    """The least bytes of one mixer decode step: the float32 state read and
    written, the row, the window read and written, the weights (the norm's
    too), the output."""
    h, n, k = cfg.ssm_heads, cfg.ssm.d_state, cfg.ssm.conv_kernel
    di, gn = cfg.d_inner, cfg.ssm.n_groups * n
    return (2 * b * h * cfg.ssm.head_dim * n * 4
            + b * (2 * di + 2 * gn + h) * 2 + 2 * b * (k - 1) * (di + 2 * gn)
            * 2 + (k + 1) * (di + 2 * gn) * 2 + 3 * h * 4 + di * 2
            + b * di * 2)


def run_mixer_kernel_checks(torch, dev):
    """The mixer decode kernel against its plain version -- the gated,
    normed output, the new float32 state and the shifted window, two steps
    in turn -- at
    Zamba2-7B's decode step (32 slots, 112 heads of 64, N = 64 in 2
    groups), zamba2-2.7b's (80 heads, 1 group) and mamba2-130m's (24
    heads, N = 128), then its time at Zamba2-7B's step beside the plain
    step with the slot cache's write-back (what the engine ran before the
    kernel) and its bound, :func:`mixer_bytes` at 3.35 TB/s."""
    import dataclasses

    from repro_torch.configs import REGISTRY
    from repro_torch.kernels.mixer_decode.ops import mixer_decode
    from repro_torch.models.mamba2 import mixer_decode_step
    K = Kernels(torch, dev)
    z7 = dataclasses.replace(
        REGISTRY["zamba2-2.7b"], d_model=3584,
        ssm=dataclasses.replace(REGISTRY["zamba2-2.7b"].ssm, n_groups=2))
    cases = [("zamba2-7b B=32 H=112 N=64 G=2", z7, 32),
             ("zamba2-2.7b B=8 H=80 N=64 G=1", REGISTRY["zamba2-2.7b"], 8),
             ("mamba2-130m B=9 H=24 N=128 G=1", REGISTRY["mamba2-130m"], 9)]
    worst = 0.0
    for label, cfg, b in cases:
        p, zx, cache = mixer_case(torch, dev, cfg, b, 3)
        want_st = {k: v[0].clone() for k, v in cache.items()}
        st = {k: v[0] for k, v in cache.items()}
        errs = []
        for row in (zx, zx.flip(0)):
            want, want_st = mixer_decode_step(row, want_st, p, cfg)
            got, st = mixer_decode(row, st, p, cfg)
            got_st = st
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got.float()).all()),
                  f"mixer_decode {label}: non-finite output")
            check(torch.equal(got_st["conv"], want_st["conv"]),
                  f"mixer_decode {label}: the window was not shifted as "
                  "the plain version shifts it")
            y_rel, y_abs = rel_err(got, want)
            s_rel, _ = rel_err(got_st["ssm"], want_st["ssm"])
            same = float((got_st["ssm"] == want_st["ssm"]).float().mean())
            errs.append((y_rel, s_rel, same))
            worst = max(worst, y_abs)
            check(y_rel <= TOL["bfloat16"] and s_rel <= 1e-2
                  and same >= 0.99,
                  f"mixer_decode {label}: kernel disagrees with its plain "
                  f"version (output {y_rel:.3e}, state {s_rel:.3e}, "
                  f"{same:.5f} of the state equal)")
        print(f"  {'mixer_decode':24s} {label:48s} " + "; ".join(
            f"step {i}: y rel_err={e[0]:.3e} state rel_err={e[1]:.3e} "
            f"equal {e[2]:.5f}" for i, e in enumerate(errs)) + " ok")
    B = 32
    p, zx, cache = mixer_case(torch, dev, z7, B, 4)
    st = {k: v[0] for k, v in cache.items()}

    def plain():
        y, new = mixer_decode_step(zx, st, p, z7)
        cache["conv"][0] = new["conv"]
        cache["ssm"][0] = new["ssm"]
        return y
    nbytes = mixer_bytes(B, z7)
    r = dict(max_abs_err=worst, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
             bound_by="bytes", bytes=nbytes,
             flops=6 * B * z7.ssm_heads * 64 * z7.ssm.d_state,
             **K.timings(lambda: mixer_decode(zx, st, p, z7), plain))
    r["plain_device_ms"] = K.time_ms(plain, device=True)
    r["share"] = r["bound_ms"] / r["device_ms"]
    print(f"  mixer_decode at Zamba2-7B's step: {nbytes / 1e6:.1f} MB, "
          f"share of its bound by device time {r['share']:.3f}; the plain "
          f"step's device time {r['plain_device_ms']:.4f} ms")
    results = {"mixer_decode": r}
    torch.cuda.synchronize()
    print_times(results)
    return results


# ---------------------------------------------------------------------------
# phase 3: the engine at full width
# ---------------------------------------------------------------------------

def make_requests(n, prefix_len, tail_lens, max_tokens, vocab, seed,
                  model="llama3.2-3b"):
    import numpy as np
    from repro_torch.serving.request import InferenceRequest, SamplingParams
    rng = np.random.default_rng(seed)
    prefix = rng.integers(2, vocab, size=prefix_len).tolist()
    out = []
    for i in range(n):
        samp = dict(temperature=0.0) if i % 2 == 0 \
            else dict(temperature=0.8, top_p=0.9)
        out.append(InferenceRequest(
            model=model, request_id=f"r{i}",
            prompt_tokens=prefix + rng.integers(
                2, vocab, size=int(tail_lens[i])).tolist(),
            sampling=SamplingParams(max_tokens=max_tokens, seed=100 + i,
                                    **samp)))
    return out


def drive(torch, engine, reqs, counts=None):
    """Run the engine to completion, timing each step on the host clock
    (every step ends in a device->host sync of its sampled ids). Returns
    (outputs, prefill seconds, decode-only seconds, decode-only tokens);
    ``counts["decode_steps"]``, where given, counts the decode-only steps."""
    for r in reqs:
        engine.add_request(r)
    outs, t_prefill, t_decode, n_decode = [], 0.0, 0.0, 0
    while engine.has_work():
        p0 = engine.stats["prefill_tokens"]
        d0 = engine.stats["decode_tokens"]
        t0 = time.perf_counter()
        outs += engine.step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if engine.stats["prefill_tokens"] > p0:
            t_prefill += dt
        else:
            t_decode += dt
            n_decode += engine.stats["decode_tokens"] - d0
            if counts is not None:
                counts["decode_steps"] = counts.get("decode_steps", 0) + 1
    return outs, t_prefill, t_decode, n_decode


# device kernel name -> the port kernel (wrapper) it belongs to
PORT_KERNELS = (("paged_decode_kernel", "paged decode attention"),
                ("slot_decode_kernel", "slot_decode_attention"),
                ("paged_prefill_kernel", "paged_flash_prefill"),
                ("paged_prefill_tc_kernel", "paged_flash_prefill"),
                ("flash_kernel", "flash_attention"),
                ("flash_tc_kernel", "flash_attention"),
                ("ssd_chunk_state_kernel", "ssd"),
                ("ssd_state_pass_kernel", "ssd"),
                ("ssd_chunk_scan_kernel", "ssd"),
                ("ssd_fma_kernel", "ssd"))


def port_kernel(name: str):
    """The port kernel a device activity belongs to, or None."""
    n = name.lower()
    for key, kernel in PORT_KERNELS:
        if key in n:
            return kernel
    return None


def kernel_group(name: str) -> str:
    """Coarse class of a device activity, by its name."""
    n = name.lower()
    if port_kernel(n):
        return "port kernels"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(s in n for s in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmuls"
    return "other (elementwise, reductions, sort, indexing)"


def device_time(prof, skip=()):
    """Device time (us) of a torch.profiler trace by kernel group, by
    kernel name and by port kernel, and the number of device activities.
    ``skip``: names of profiler ranges, whose device-side spans are not
    kernels."""
    from torch.autograd import DeviceType
    by_group, by_name, by_port, n = {}, {}, {}, 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or e.name in skip:
            continue
        n += 1
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + us
        k = port_kernel(e.name)
        if k:
            by_port[k] = by_port.get(k, 0.0) + us
    return by_group, by_name, by_port, n


def print_breakdown(by_group, by_name, by_port, per, unit):
    for g, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        print(f"    {g:48s} {us / 1e3 / per:8.3f} ms {unit}")
    for k, us in sorted(by_port.items(), key=lambda kv: -kv[1]):
        print(f"      of which {k:39s} {us / 1e3 / per:8.3f} ms {unit}")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"    top: {us / 1e3 / per:8.3f} ms  {name[:90]}")


def profile_decode(torch, engine, reqs, steps=2, on_trace=None):
    """A decode-only window with every request running: ``steps`` engine
    steps (each one fused call of K decode steps) timed on the host clock,
    then as many traced with torch.profiler for device time by kernel. The
    device's idle share is 1 - device busy time / the UNtraced window's
    wall time, which keeps the tracer's own host overhead out. The trace
    records device activity alone (host op events only add the tracer's
    cost: a sharded step's took most of a minute to record and parse).
    With ``on_trace``, it also records the host ops with their shapes and
    ``on_trace(prof, peak_rise)`` gets it and the most device memory the
    traced window allocated above what it started with."""
    from torch.profiler import ProfilerActivity, profile
    for r in reqs:
        engine.add_request(r)
    for _ in range(100):
        if len(engine.running) == len(reqs) and not engine.prefilling \
                and not engine.slots.dirty:
            break
        engine.step()
    check(len(engine.running) == len(reqs), "profile: requests not running")
    K = engine.cfg.decode_steps_per_sync
    # mean context of the timed and of the traced window: each step
    # attends over the positions held at its start plus its own
    ctx0 = statistics.fmean(len(r.req.prompt_tokens) + len(r.output_tokens)
                            for r in engine.running.values())
    window_ctx = {"decode_batch": len(reqs),
                  "decode_mean_ctx": ctx0 + (steps * K + 1) / 2,
                  "decode_traced_mean_ctx": ctx0 + steps * K
                  + (steps * K + 1) / 2}

    def window():
        # no collector pass inside the window: earlier traces' events sit
        # in reference cycles, and collecting them costs tens of ms
        d0 = engine.stats["decode_tokens"]
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        return wall, engine.stats["decode_tokens"] - d0

    wall, n_tok = window()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    acts = [ProfilerActivity.CUDA] if on_trace is None \
        else [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts, record_shapes=on_trace is not None) as prof:
        _, n_tok2 = window()
    if on_trace is not None:
        on_trace(prof, torch.cuda.max_memory_allocated() - base)
    check(n_tok == n_tok2 == steps * K * len(reqs),
          f"profile: {n_tok}/{n_tok2} tokens, expected {steps * K * len(reqs)}")
    n_steps = steps * K
    by_group, by_name, by_port, _ = device_time(prof)
    busy_ms = sum(by_group.values()) / 1e3 / n_steps
    wall_ms = wall * 1e3 / n_steps
    print(f"  decode window: {len(reqs)} sequences, {n_steps} decode steps "
          f"(K={K}): {wall_ms:.3f} ms a step on the host clock, "
          f"{n_tok / wall:.1f} tokens/s")
    if not by_group:
        print("  device time by kernel: not measured (the profiler saw no "
              "device activity)")
        return {"decode_window_tok_s": n_tok / wall,
                "decode_step_wall_ms": wall_ms,
                "decode_step_device_ms": None, "device_idle_share": None,
                **window_ctx}
    idle = 1.0 - busy_ms / wall_ms
    print(f"  device busy {busy_ms:.3f} ms a step: idle share {idle:.3f}")
    print_breakdown(by_group, by_name, by_port, n_steps, "a step")
    return {**window_ctx, "decode_window_tok_s": n_tok / wall,
            "decode_step_wall_ms": wall_ms, "decode_step_device_ms": busy_ms,
            "device_idle_share": idle,
            "device_ms_by_group": {g: us / 1e3 / n_steps
                                   for g, us in by_group.items()},
            "device_ms_by_port_kernel": {k: us / 1e3 / n_steps
                                         for k, us in by_port.items()}}


def profile_prefill(torch, engine, reqs, step, what):
    """One prefill step alone on the device: ``reqs`` are three requests of
    one shape (other tokens, one new token each, so no decode runs). The
    first runs to its end untimed, so the engine's first-use costs stay
    out; the second is stepped to its ``step``-th engine step, which is
    timed on the host clock; the third to the same step, which is traced
    with torch.profiler. The device's idle share is 1 - device busy time /
    the untraced step's wall time."""
    from torch.profiler import ProfilerActivity, profile

    def run(req, traced):
        engine.add_request(req)
        for _ in range(step - 1):
            engine.step()
        check(engine.has_work(), f"prefill profile: {req.request_id} "
              f"finished before step {step}")
        p0 = engine.stats["prefill_tokens"]
        gc.collect()    # as in profile_decode's window
        gc.disable()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if traced:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    engine.step()
                    torch.cuda.synchronize()
            else:
                prof = None
                engine.step()
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            gc.enable()
        check(not engine.has_work(), f"prefill profile: {req.request_id} "
              f"not finished at step {step}")
        return wall, engine.stats["prefill_tokens"] - p0, prof

    engine.add_request(reqs[0])
    while engine.has_work():
        engine.step()
    wall, n_tok, _ = run(reqs[1], False)
    _, n_tok2, prof = run(reqs[2], True)
    check(n_tok == n_tok2 > 0, f"prefill profile: {n_tok}/{n_tok2} tokens")
    by_group, by_name, by_port, n_act = device_time(prof)
    wall_ms = wall * 1e3
    print(f"  prefill window ({what}): {n_tok} tokens in {wall_ms:.3f} ms "
          f"on the host clock")
    if not by_group:
        print("  device time by kernel: not measured (the profiler saw no "
              "device activity)")
        return {"prefill_step_wall_ms": wall_ms,
                "prefill_step_device_ms": None,
                "prefill_device_idle_share": None}
    busy_ms = sum(by_group.values()) / 1e3
    idle = 1.0 - busy_ms / wall_ms
    print(f"  device busy {busy_ms:.3f} ms in {n_act} device activities: "
          f"idle share {idle:.3f}")
    print_breakdown(by_group, by_name, by_port, 1, "")
    return {"prefill_step_wall_ms": wall_ms, "prefill_step_device_ms": busy_ms,
            "prefill_device_idle_share": idle,
            "prefill_device_activities": n_act,
            "prefill_device_ms_by_group": {g: us / 1e3
                                           for g, us in by_group.items()},
            "prefill_device_ms_by_port_kernel": {
                k: us / 1e3 for k, us in by_port.items()}}


def run_engine(torch, dev):
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    cfg = REGISTRY["llama3.2-3b"]
    print(f"phase 3: engine at full width: {cfg.name} L={cfg.num_layers} "
          f"d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
          f"hd={cfg.head_dim} ff={cfg.d_ff} V={cfg.vocab_size} "
          f"{cfg.param_dtype}")
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  random weights in {time.perf_counter() - t0:.1f} s")
    ecfg = dict(backend="paged", use_kernel=True, page_size=64, max_slots=8,
                max_seq_len=4096, enable_prefix_cache=True,
                chunked_prefill_budget=512, decode_steps_per_sync=8)
    V = cfg.vocab_size

    # -- warm-up (cuBLAS handles, allocator pools, first launches), so the
    # main run's host-clock metrics are not a measurement of set-up --
    warm = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                    device=dev)
    drive(torch, warm, make_requests(2, 300, [40, 90], 9, V, seed=9))
    del warm

    # -- main path: fused K=8 decode, chunked prefill, prefix cache --
    tails = np.linspace(64, 512, 8).astype(int)
    reqs = make_requests(8, 1024, tails, 64, V, seed=0)
    eng = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                   device=dev)
    torch.cuda.reset_peak_memory_stats()
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, reqs)
    fused_launches = dict(_build.LAUNCHES)
    transfers = dict(backends.TRANSFER_STATS)
    print(f"  fused path launches {fused_launches} transfers {transfers}")
    check(len(outs) == 8, f"{len(outs)} of 8 requests finished")
    for o in outs:
        check(o.finish_reason == "length" and len(o.output_tokens) == 64,
              f"{o.request_id}: {o.finish_reason} after "
              f"{len(o.output_tokens)} tokens, expected length after 64")
        check(all(0 <= t < V for t in o.output_tokens),
              f"{o.request_id}: token id out of range")
    check(transfers["decode_logits_transfers"] == 0,
          "the fused path moved logits to the host")
    stats = eng.cache_stats()
    check(stats["hit_tokens"] > 0, "no prefix-cache hits")
    check(fused_launches["paged_flash_prefill"] > 0,
          "paged_flash_prefill never launched on the main path")
    check(fused_launches["fused_decode_attention"] > 0,
          "fused_decode_attention never launched on the main path")
    ttft = sorted(o.metrics.ttft for o in outs)
    metrics = {
        "prefill_tokens": eng.stats["prefill_tokens"],
        "cached_prompt_tokens": eng.stats["cached_prompt_tokens"],
        "prefill_tok_s": eng.stats["prefill_tokens"] / t_pf,
        "decode_tok_s": n_dec / t_dec if t_dec else float("nan"),
        "ttft_p50_s": statistics.median(ttft),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "decode_syncs": eng.stats["decode_syncs"],
        "hit_tokens": stats["hit_tokens"],
    }
    print(f"  prefill {metrics['prefill_tokens']} tokens "
          f"({metrics['cached_prompt_tokens']} more from the prefix cache) "
          f"in steps taking {t_pf:.3f} s: "
          f"{metrics['prefill_tok_s']:.1f} tokens/s")
    print(f"  decode-only steps: {n_dec} tokens in {t_dec:.3f} s: "
          f"{metrics['decode_tok_s']:.1f} tokens/s; "
          f"TTFT p50 {metrics['ttft_p50_s']:.3f} s; peak memory "
          f"{metrics['peak_mem_gib']:.2f} GiB")
    del eng
    torch.cuda.empty_cache()
    metrics.update(profile_decode(
        torch, ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                        device=dev),
        make_requests(8, 1024, tails, 64, V, seed=3)))
    torch.cuda.empty_cache()
    # -- for phase 9a: the same window with a host sync after every step --
    metrics["k1_window"] = profile_decode(
        torch, ContinuousBatchingEngine(
            model, params,
            EngineConfig(**dict(ecfg, decode_steps_per_sync=1)), device=dev),
        make_requests(8, 1024, tails, 64, V, seed=3), steps=16)
    torch.cuda.empty_cache()
    # -- prefill window: the third 512-token chunk of a 1536-token prompt,
    # at q_start 1024 (phase 2's main prefill shape) --
    metrics.update(profile_prefill(
        torch, ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                        device=dev),
        make_requests(3, 0, [1536] * 3, 1, V, seed=5), step=3,
        what="512-token chunk at 1024"))
    torch.cuda.empty_cache()

    # -- per-step path: fused_decode=False (paged_attention kernel) --
    reqs2 = make_requests(2, 300, [40, 90], 16, V, seed=1)
    eng2 = ContinuousBatchingEngine(
        model, params, EngineConfig(**dict(ecfg, fused_decode=False)),
        device=dev)
    _build.reset_launches()
    counts = {}
    outs2, _, t_dec2, n_dec2 = drive(torch, eng2, reqs2, counts)
    step_launches = dict(_build.LAUNCHES)
    metrics["per_step_path"] = {
        "sequences": 2, "decode_steps": counts["decode_steps"],
        "decode_step_wall_ms": t_dec2 * 1e3 / counts["decode_steps"],
        "decode_tok_s": n_dec2 / t_dec2}
    print(f"  per-step path launches {step_launches}")
    check(len(outs2) == 2 and all(len(o.output_tokens) == 16 for o in outs2),
          "per-step path: requests did not finish with 16 tokens")
    check(step_launches["paged_attention"] > 0,
          "paged_attention never launched on the per-step path")
    del eng2
    torch.cuda.empty_cache()

    # -- teacher-forced: kernel tier vs plain tier on the same state --
    bk = [PagedBackend(model, params, max_slots=2, max_len=4096, page_size=64,
                       use_kernel=uk, device=dev) for uk in (True, False)]
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, V, size=n).tolist() for n in (700, 530)]
    worst = 0.0
    tok = np.zeros((2,), np.int64)
    for sid, pr in enumerate(prompts):
        logits = []
        for b in bk:
            task = b.start_prefill(f"s{sid}", pr)
            lg = None
            while lg is None:
                lg, _ = b.prefill_chunk(task, 512)
            logits.append(lg)
        rel, _ = rel_err(logits[0], logits[1])
        worst = max(worst, rel)
        tok[sid] = int(logits[0].argmax())
        print(f"  teacher-forced prefill s{sid} ({len(pr)} tokens, 512-token "
              f"chunks): logits rel_err {rel:.3e}")
    agree = 0
    steps = 16
    for i in range(steps):
        lk = bk[0].decode_batch(tok)
        lp = bk[1].decode_batch(tok)
        rel = float(np.abs(lk - lp).max() / max(np.abs(lp).max(), 1e-6))
        worst = max(worst, rel)
        agree += int((lk.argmax(-1) == lp.argmax(-1)).sum())
        tok = lk.argmax(-1)
    share = agree / (2 * steps)
    print(f"  teacher-forced decode: {steps} steps x 2 sequences, worst "
          f"logits rel_err {worst:.3e} (tolerance {LOGITS_TOL}); greedy "
          f"tokens that match: {share:.3f}")
    check(worst <= LOGITS_TOL, "kernel tier logits disagree with the plain "
          "tier")
    metrics["teacher_forced_rel_err"] = worst
    metrics["greedy_match_share"] = share
    launches = dict(fused_launches,
                    paged_attention=step_launches["paged_attention"])
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 4: the slot engine at full width (zamba2-2.7b)
# ---------------------------------------------------------------------------

def slot_tiers(dev, tiers, params, n):
    """Slot backends by name, one for each of ``tiers`` ((name, model,
    use_kernel, mesh)) over the same weights, ``n`` slots of 4096."""
    from repro_torch.serving.backends import SlotBackend
    return {name: SlotBackend(m, params, max_slots=n, max_len=4096,
                              use_kernel=uk, mesh=me, device=dev)
            for name, m, uk, me in tiers}


def teacher_forced(backends, prompts, steps, test, ref, feed=None):
    """The ``backends`` (by name) prefill the same prompts one-shot, then
    take ``steps`` decode steps, each fed the greedy tokens of the
    ``feed`` tier (default ``ref``). Fails on a greedy token of ``test``
    that differs from ``ref``'s by more than their logits do (a flip
    between two candidates closer than the tiers differ is a tie, not a
    fault). Returns
    (worst(a, b): tier a's worst logits rel_err against tier b over every
    prefill and step, the share of ``test``'s greedy tokens that match,
    the ties)."""
    import numpy as np
    lg = {name: [] for name in backends}
    for sid, pr in enumerate(prompts):
        for name, b in backends.items():
            lg[name].append(b.prefill(f"s{sid}", pr).float().cpu().numpy()
                            [None])
    feed = feed or ref
    tok = np.array([int(x.argmax()) for x in lg[feed]])
    agree = ties = 0
    for _ in range(steps):
        for name, b in backends.items():
            lg[name].append(b.decode_batch(tok))
        want, got = lg[ref][-1], lg[test][-1]
        diff = float(np.abs(got - want).max())
        for r in range(len(prompts)):
            same = int(got[r].argmax()) == int(want[r].argmax())
            top2 = np.sort(want[r])[-2:]
            agree += same
            ties += (not same) and (top2[1] - top2[0] <= 2 * diff)
        tok = lg[feed][-1].argmax(-1)

    def worst(a, b):
        return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-6))
                   for x, y in zip(lg[a], lg[b]))
    check(agree + ties == steps * len(prompts), f"a greedy token differs "
          f"between {test} and {ref} by more than their logits do")
    return worst, agree / (steps * len(prompts)), ties


def run_hybrid_engine(torch, dev):
    """zamba2-2.7b on the slot backend with the kernel tier: 8 prompts of
    200..2048 tokens through exact-length one-shot prefill and the fused
    K=8 decode, then 2 on the per-step path, then a teacher-forced
    comparison of the kernel tier against the plain tier."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    cfg = REGISTRY["zamba2-2.7b"]
    n_shared = cfg.num_layers // cfg.attn_every
    print(f"phase 4: slot engine at full width: {cfg.name} L={cfg.num_layers}"
          f" d={cfg.d_model} ssm heads={cfg.ssm_heads}x{cfg.ssm.head_dim} "
          f"n={cfg.ssm.d_state} shared attention x{n_shared} "
          f"H={cfg.num_heads} hd={cfg.head_dim} ff={cfg.d_ff} "
          f"V={cfg.vocab_size} {cfg.param_dtype}")
    model = make_model(cfg)
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    print(f"  random weights in {time.perf_counter() - t0:.1f} s")
    ecfg = dict(backend="slots", use_kernel=True, max_slots=8,
                max_seq_len=4096, decode_steps_per_sync=8)
    V = cfg.vocab_size

    def requests(lens, max_tokens, seed):
        return make_requests(len(lens), 0, lens, max_tokens, V, seed,
                             model=cfg.name)

    warm = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                    device=dev)
    drive(torch, warm, requests([200, 300], 9, 9))
    del warm
    torch.cuda.empty_cache()

    # -- main path: exact-length one-shot prefill, fused K=8 decode --
    lens = [200, 300, 512, 777, 1024, 1300, 1800, 2048]
    eng = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                   device=dev)
    steps = count_decode_steps(eng.backend)
    torch.cuda.reset_peak_memory_stats()
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, requests(lens, 64, 4))
    fused_launches = dict(_build.LAUNCHES)
    pass_launches = dict(_build.PASS_LAUNCHES)
    transfers = dict(backends.TRANSFER_STATS)
    print(f"  fused path launches {fused_launches} transfers {transfers}; "
          f"{steps['n']} decode steps")
    print(f"  ssd launches by pass {pass_launches}")
    check(len(outs) == 8, f"{len(outs)} of 8 requests finished")
    for o in outs:
        check(o.finish_reason == "length" and len(o.output_tokens) == 64,
              f"{o.request_id}: {o.finish_reason} after "
              f"{len(o.output_tokens)} tokens, expected length after 64")
        check(all(0 <= t < V for t in o.output_tokens),
              f"{o.request_id}: token id out of range")
    check(transfers["decode_logits_transfers"] == 0,
          "the fused path moved logits to the host")
    check(fused_launches["ssd"] == cfg.num_layers * len(lens),
          f"ssd launched {fused_launches['ssd']} times, expected "
          f"{cfg.num_layers} for each of {len(lens)} prompts")
    check(all(pass_launches[k] == fused_launches["ssd"]
              for k in ("ssd_chunk_state", "ssd_state_pass",
                        "ssd_chunk_scan")) and pass_launches["ssd_fma"] == 0,
          "the bf16 ssd calls did not launch each of their three passes "
          "once")
    check(fused_launches["flash_attention"] == n_shared * len(lens),
          f"flash_attention launched {fused_launches['flash_attention']} "
          f"times, expected {n_shared} for each of {len(lens)} prompts")
    check(steps["n"] > 0 and fused_launches["slot_decode_attention"]
          == n_shared * steps["n"],
          f"slot_decode_attention launched "
          f"{fused_launches['slot_decode_attention']} times, expected "
          f"{n_shared} for each of {steps['n']} decode steps")
    check(fused_launches["mixer_decode"] == cfg.num_layers * steps["n"],
          f"mixer_decode launched {fused_launches['mixer_decode']} times, "
          f"expected {cfg.num_layers} for each of {steps['n']} decode "
          f"steps")
    ttft = sorted(o.metrics.ttft for o in outs)
    metrics = {
        "prefill_tokens": eng.stats["prefill_tokens"],
        "prefill_tok_s": eng.stats["prefill_tokens"] / t_pf,
        "decode_tok_s": n_dec / t_dec if t_dec else float("nan"),
        "ttft_p50_s": statistics.median(ttft),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "decode_syncs": eng.stats["decode_syncs"],
    }
    print(f"  prefill {metrics['prefill_tokens']} tokens in steps taking "
          f"{t_pf:.3f} s: {metrics['prefill_tok_s']:.1f} tokens/s")
    print(f"  decode-only steps: {n_dec} tokens in {t_dec:.3f} s: "
          f"{metrics['decode_tok_s']:.1f} tokens/s; TTFT p50 "
          f"{metrics['ttft_p50_s']:.3f} s; peak memory "
          f"{metrics['peak_mem_gib']:.2f} GiB")
    del eng
    torch.cuda.empty_cache()
    metrics.update(profile_decode(
        torch, ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                        device=dev),
        requests(lens, 64, 3)))
    torch.cuda.empty_cache()
    # -- prefill window: one 2048-token prompt, one-shot --
    metrics.update(profile_prefill(
        torch, ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                        device=dev),
        requests([2048] * 3, 1, 5), step=1, what="2048-token prompt"))
    torch.cuda.empty_cache()

    # -- per-step path: fused_decode=False --
    eng2 = ContinuousBatchingEngine(
        model, params, EngineConfig(**dict(ecfg, fused_decode=False)),
        device=dev)
    _build.reset_launches()
    outs2, _, _, _ = drive(torch, eng2, requests([300, 700], 16, 1))
    step_launches = dict(_build.LAUNCHES)
    print(f"  per-step path launches {step_launches}")
    check(len(outs2) == 2 and all(len(o.output_tokens) == 16 for o in outs2),
          "per-step path: requests did not finish with 16 tokens")
    check(step_launches["ssd"] == 2 * cfg.num_layers
          and step_launches["flash_attention"] == 2 * n_shared,
          "per-step path: the prefill kernels did not launch once a layer")
    del eng2
    torch.cuda.empty_cache()

    # -- teacher-forced: kernel tier vs plain tier on the same tokens, and
    # the plain tier's own spread: the same model with SSD chunks of 128
    # instead of 256 computes the same function with its sums in another
    # order (random weights at this depth amplify ulp-level differences) --
    floor_model = make_model(dataclasses.replace(
        cfg, ssm=dataclasses.replace(cfg.ssm, chunk=128)))
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, V, size=n).tolist() for n in (512, 2048)]
    steps = 16
    worst, share, ties = teacher_forced(
        slot_tiers(dev, [("kernel", model, True, None),
                         ("plain", model, False, None),
                         ("floor", floor_model, False, None)], params, 2),
        prompts, steps, "kernel", "plain", feed="kernel")
    worst, spread = worst("kernel", "plain"), worst("floor", "plain")
    tol = max(LOGITS_TOL, SPREAD_FACTOR * spread)
    print(f"  teacher-forced: prefill and {steps} decode steps x 2 "
          f"sequences, worst logits rel_err {worst:.3e}; plain tier's own "
          f"spread "
          f"{spread:.3e}; tolerance max({LOGITS_TOL}, {SPREAD_FACTOR} x "
          f"spread) = {tol:.3e}; greedy tokens that match: {share:.3f} "
          f"({ties} ties within the error)")
    check(worst <= tol, "kernel tier logits disagree with the plain tier")
    metrics["teacher_forced_rel_err"] = worst
    metrics["plain_spread_rel_err"] = spread
    metrics["greedy_match_share"] = share
    metrics["ssd_launches_by_pass"] = pass_launches
    launches = {"ssd": fused_launches["ssd"],
                "flash_attention": fused_launches["flash_attention"],
                "slot_decode_attention":
                    fused_launches["slot_decode_attention"],
                "mixer_decode": fused_launches["mixer_decode"]}
    return launches, metrics


# ---------------------------------------------------------------------------
# phase 5: speculative decoding and swap preemption at full width
# ---------------------------------------------------------------------------

SPEC_TOKENS = 4
# with the target as its own draft, a proposal is rejected only where the
# draft's decode arithmetic and the verify forward's round a logit apart
# and the seeded sampler's pick moves with it; held in float32, where the
# two routes differ by ~1e-6 of the logits' scale. In bf16 the logits of
# a 128256-wide head are quantized to 8 mantissa bits, and seeded top-p
# assigns its Gumbel noise by sorted rank, so any one-ulp move reorders
# it: the reference itself accepts 0.003 of top-p proposals there
# (scripts/spec_acceptance_probe.py), and the bf16 runs report their
# acceptance by sampling mode without a bound
SPEC_MIN_ACCEPTANCE = 0.9


def count_decode_steps(backend):
    """Counts the slot backend's decode steps (each steps every slot), op
    by op, in the returned dict's ``n``."""
    steps = {"n": 0}

    def around(fn, *a, **kw):
        steps["n"] += 1
        return fn(*a, **kw)
    wrap(backend, "_decode_step", around)
    return steps


def wrap(obj, name, around):
    """Shadow ``obj.name`` with ``around(original, *args)``; returns the
    original."""
    fn = getattr(obj, name)
    setattr(obj, name, lambda *a, **kw: around(fn, *a, **kw))
    return fn


def labelled(torch, fn, label):
    """``fn`` inside a profiler range named ``label``."""
    def run(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return run


def label_device_ms(prof, labels):
    """Device time (ms) of the kernels launched inside each profiler range
    named in ``labels`` (the host-side range events, children included)."""
    from torch.autograd import DeviceType
    out = dict.fromkeys(labels, 0.0)
    for e in prof.events():
        if e.name in out and e.device_type == DeviceType.CPU:
            out[e.name] += getattr(e, "device_time_total", 0.0) / 1e3
    return out


def spec_drive(torch, eng, reqs, max_tokens, V, what, min_rate=None):
    """Run a speculating engine to completion and check it: every request
    finishes at its length, no logits cross to the host, verify rounds
    ran (and, with ``min_rate``, accepted at least that share). Counts the
    tokens the verify rounds emitted and the slots they served. Returns
    (launches, metrics)."""
    from repro_torch.kernels import _build
    from repro_torch.serving import backends
    emitted = {"tokens": 0, "slot_rounds": 0}
    # accepted, proposed, proposed within the generation limit: a round
    # that reaches a request's max_tokens cannot emit the proposals past
    # it, and the engine's rate counts those as rejected
    by_mode = {"greedy": [0, 0, 0], "top-p": [0, 0, 0]}

    def count(verify, draft, *a):
        out, produced, done = verify(draft, *a)
        emitted["tokens"] += int(produced.sum())
        emitted["slot_rounds"] += int((produced > 0).sum())
        k = draft.shape[1]
        for rid, run in eng.running.items():
            mode = by_mode["greedy" if run.req.sampling.temperature <= 0
                           else "top-p"]
            left = run.req.sampling.max_tokens - len(run.output_tokens)
            mode[0] += max(int(produced[eng.backend.slot(rid)]) - 1, 0)
            mode[1] += k
            mode[2] += min(k, left - 1)
        return out, produced, done

    wrap(eng.backend, "spec_verify", count)
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, _, t_dec, n_dec = drive(torch, eng, reqs)
    launches = dict(_build.LAUNCHES)
    rate = eng.spec_acceptance_rate()
    rounds = eng.stats["spec_rounds"]
    per_round = emitted["tokens"] / max(rounds, 1)
    per_seq = emitted["tokens"] / max(emitted["slot_rounds"], 1)
    rates = {m: a / p for m, (a, p, _) in by_mode.items() if p}
    acc, usable = (sum(v[i] for v in by_mode.values()) for i in (0, 2))
    within = acc / usable if usable else 0.0
    print(f"  {what}: {len(outs)} requests, {rounds} verify rounds, "
          f"acceptance {rate:.4f} (by sampling mode "
          f"{ {m: round(r, 4) for m, r in rates.items()} }; of the "
          f"proposals within the generation limit {within:.4f}), "
          f"{per_round:.2f} tokens a round ({per_seq:.3f} a sequence), "
          f"decode-only steps {n_dec / t_dec:.1f} tokens/s; launches "
          f"{launches}")
    check(len(outs) == len(reqs), f"{what}: {len(outs)} of {len(reqs)} "
          f"requests finished")
    for o in outs:
        check(o.finish_reason == "length"
              and len(o.output_tokens) == max_tokens,
              f"{what}: {o.request_id}: {o.finish_reason} after "
              f"{len(o.output_tokens)} tokens, expected length after "
              f"{max_tokens}")
        check(all(0 <= t < V for t in o.output_tokens),
              f"{what}: {o.request_id}: token id out of range")
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          f"{what}: logits crossed to the host")
    check(rounds > 0, f"{what}: no verify round ran")
    if min_rate is not None:
        check(within >= min_rate, f"{what}: acceptance of the proposals "
              f"within the generation limit {within:.4f} below {min_rate}")
    return launches, {"acceptance": rate, "acceptance_by_mode": rates,
                      "acceptance_within_limit": within,
                      "spec_rounds": rounds,
                      "tokens_per_round": per_round,
                      "tokens_per_sequence_round": per_seq,
                      "decode_tok_s": n_dec / t_dec if t_dec else None}


def profile_spec_round(torch, eng, reqs):
    """One verify round traced: the engine steps ``reqs`` until every one
    is decoding, then one round (the draft's proposal loop and the
    target's verify) runs under torch.profiler with profiler ranges
    around the draft's loop, the verify call, and inside it every
    ``gather_kv`` and ``_spec_block_attention``. Prints device time by
    kernel group and by range."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import backends
    for r in reqs:
        eng.add_request(r)
    for _ in range(100):
        if len(eng.running) == len(reqs) and not eng.prefilling \
                and not eng.slots.dirty:
            break
        eng.step()
    check(len(eng.running) == len(reqs), "spec profile: requests not running")
    labels = ("draft proposal loop", "verify", "verify: gather_kv",
              "verify: f32 block attention")
    wrap(eng.draft_backend, "fused_decode",
         labelled(torch, lambda fn, *a: fn(*a), labels[0]))
    wrap(eng.backend, "spec_verify",
         labelled(torch, lambda fn, *a: fn(*a), labels[1]))
    saved = backends.gather_kv, backends._spec_block_attention
    backends.gather_kv = labelled(torch, saved[0], labels[2])
    backends._spec_block_attention = labelled(torch, saved[1], labels[3])
    rounds = eng.stats["spec_rounds"]
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()                       # one round untraced, timed
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            eng.step()
            torch.cuda.synchronize()
    finally:
        backends.gather_kv, backends._spec_block_attention = saved
    check(eng.stats["spec_rounds"] == rounds + 2,
          "spec profile: the timed and traced steps were not verify rounds")
    by_group, by_name, by_port, n_act = device_time(prof, skip=labels)
    busy = sum(by_group.values()) / 1e3
    by_label = label_device_ms(prof, labels)
    print(f"  verify round ({len(reqs)} sequences, k={SPEC_TOKENS}): "
          f"{wall_ms:.3f} ms on the host clock untraced; the next round "
          f"traced: device busy {busy:.3f} ms in {n_act} device activities"
          + (f", idle share {1 - busy / wall_ms:.3f}" if busy else ""))
    print_breakdown(by_group, by_name, by_port, 1, "")
    for label, ms in by_label.items():
        share = f"{ms / busy:.3f} of the round" if busy and ms else \
            "not measured"
        print(f"    range {label:38s} {ms:8.3f} ms  {share}")
    attn = by_label[labels[2]] + by_label[labels[3]]
    return {"spec_round_device_ms": busy, "spec_round_wall_ms": wall_ms,
            "spec_round_device_ms_by_group": {
                g: us / 1e3 for g, us in by_group.items()},
            "spec_round_device_ms_by_range": by_label,
            "verify_gather_attention_share": (attn / busy if busy and attn
                                              else None)}


SPEC_ENGINE = dict(backend="paged", use_kernel=True, page_size=64,
                   max_slots=8, max_seq_len=4096, enable_prefix_cache=True,
                   chunked_prefill_budget=512, decode_steps_per_sync=8)
# the slot engine's rows cut to what these requests need
SLOT_SPEC_ENGINE = dict(backend="slots", max_slots=4, max_seq_len=1024,
                        enable_prefix_cache=False, chunked_prefill_budget=0,
                        spec_tokens=SPEC_TOKENS)
SPEC_TAILS = (64, 91, 118, 146, 173, 201, 228, 256)   # linspace(64, 256, 8)


def spec_engine(torch, dev, model, params, draft=None, **over):
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)
    dm, dp = draft if draft is not None else (None, None)
    return ContinuousBatchingEngine(
        model, params, EngineConfig(**dict(SPEC_ENGINE, **over)),
        draft_model=dm, draft_params=dp, device=dev)


def self_draft_runs(torch, dev, model, params, what, min_rate=None):
    """The target as its own draft (one params object): 8 requests on the
    paged engine (a 512-token shared prefix, tails of 64..256, 48 new
    tokens, half greedy and half seeded top-p), then 4 on the slot engine
    (one-shot prefill, rows of 1024, 24 new tokens). Returns (paged launches, paged metrics,
    slot metrics)."""
    V = model.cfg.vocab_size
    launches, paged = spec_drive(
        torch, spec_engine(torch, dev, model, params, (model, params),
                           spec_tokens=SPEC_TOKENS),
        make_requests(8, 512, SPEC_TAILS, 48, V, seed=6), 48, V,
        f"paged, draft = target, {what}", min_rate=min_rate)
    check(launches["fused_decode_attention"] > 0
          and launches["paged_flash_prefill"] > 0,
          "paged spec path: fused_decode_attention or paged_flash_prefill "
          "never launched")
    torch.cuda.empty_cache()
    slot_launches, slots = spec_drive(
        torch, spec_engine(torch, dev, model, params, (model, params),
                           **SLOT_SPEC_ENGINE),
        make_requests(4, 512, SPEC_TAILS[1::2], 24, V, seed=8), 24, V,
        f"slots, draft = target, {what}", min_rate=min_rate)
    check(slot_launches["flash_attention"] > 0,
          "slot spec path: flash_attention never launched")
    torch.cuda.empty_cache()
    return launches, paged, slots


def run_spec_engine(torch, dev):
    """llama3.2-3b at full width with the phase-3 engine settings:
    speculative decoding with the target as its own draft (paged and slot
    engines) and with a cold 2-layer draft, a teacher-forced check of the
    verify forward, one traced verify round, swap preemption; then the
    self-draft runs again in float32, held to SPEC_MIN_ACCEPTANCE."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.models import make_model
    from repro_torch.serving.backends import PagedBackend

    cfg = REGISTRY["llama3.2-3b"]
    print(f"phase 5: speculative decoding and swap at full width: "
          f"{cfg.name}, k={SPEC_TOKENS}")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    V = cfg.vocab_size

    def engine(draft=None, **over):
        return spec_engine(torch, dev, model, params, draft, **over)

    def requests():
        return make_requests(8, 512, SPEC_TAILS, 48, V, seed=6)

    # -- warm-up of the speculative path (first-use costs stay out) --
    drive(torch, engine((model, params), spec_tokens=SPEC_TOKENS),
          make_requests(2, 300, [40, 90], 9, V, seed=9))

    # -- 1) draft = target, bf16 as configured: paged and slots --
    _, m, ms = self_draft_runs(torch, dev, model, params, cfg.param_dtype)
    metrics = {"paged_self_draft": m, "slots_self_draft": ms}
    _, _, t_dec, n_dec = drive(torch, engine(), requests())
    metrics["nonspec_decode_tok_s"] = n_dec / t_dec
    print(f"  the same requests without speculation (fused K=8): decode-only "
          f"steps {n_dec / t_dec:.1f} tokens/s (speculating: "
          f"{m['decode_tok_s']:.1f})")
    metrics.update(profile_spec_round(
        torch, engine((model, params), spec_tokens=SPEC_TOKENS), requests()))
    torch.cuda.empty_cache()

    # -- 2) teacher-forced: the verify forward against sequential steps --
    be = PagedBackend(model, params, max_slots=2, max_len=4096, page_size=64,
                      use_kernel=True, device=dev)
    rng = np.random.default_rng(2)
    for sid, n in enumerate((700, 530)):
        task = be.start_prefill(f"s{sid}", rng.integers(2, V, size=n).tolist())
        while be.prefill_chunk(task, 512)[0] is None:
            pass
    T = SPEC_TOKENS + 1
    toks = rng.integers(2, V, size=(2, T))
    block = be.verify_logits(toks).float().cpu().numpy()
    worst, agree, ties = 0.0, 0, 0
    for j in range(T):
        step = be.decode_batch(toks[:, j])
        worst = max(worst, float(np.abs(block[:, j] - step).max()
                                 / max(np.abs(step).max(), 1e-6)))
        for b in range(2):
            same = int(block[b, j].argmax()) == int(step[b].argmax())
            top2 = np.sort(step[b])[-2:]
            agree += same
            # a flip between two candidates closer than the routes differ
            # is a tie, not a fault
            ties += (not same) and (top2[1] - top2[0]
                                    <= 2 * np.abs(block[b, j] - step[b]).max())
    share = agree / (2 * T)
    print(f"  teacher-forced verify: (2, {T}, {V}) verify logits against {T} "
          f"decode steps: worst rel_err {worst:.3e} (tolerance "
          f"{LOGITS_TOL}); greedy tokens that match: {share:.3f} ({ties} "
          f"ties within the error)")
    check(worst <= LOGITS_TOL, "verify logits disagree with sequential "
          "decode steps")
    check(agree + ties == 2 * T, "a greedy token differs between the verify "
          "forward and the decode steps by more than their logits do")
    metrics.update(verify_teacher_forced_rel_err=worst,
                   verify_greedy_match_share=share)
    # the verify forward multiplies B * T rows where a decode step
    # multiplies B: whether a row's product depends on the row count
    # (cuBLAS picks kernels by shape) is what separates the two routes'
    # arithmetic beyond the attention
    g = torch.Generator(device=dev).manual_seed(7)
    x = torch.randn(8 * T, cfg.d_model, generator=g, device=dev).to(
        params["embed"].dtype)
    rows = {}
    for name, w in (("wq", params["layers"]["attn"]["wq"][0]),
                    ("wo", params["layers"]["attn"]["wo"][0]),
                    ("w1", params["layers"]["mlp"]["w1"][0]),
                    ("lm_head", params["embed"].T)):
        xi = x[:, :w.shape[0]]
        rows[name] = bool(torch.equal((xi @ w)[::T], xi[::T].contiguous() @ w))
    print(f"  the same rows multiplied among {8 * T} and among 8: bitwise "
          f"equal {rows}")
    metrics["matmul_rows_equal_40_vs_8"] = rows
    del be
    torch.cuda.empty_cache()

    # -- 3) paged, a cold draft: the same widths cut to 2 layers --
    dcfg = dataclasses.replace(cfg, num_layers=2)
    dmodel = make_model(dcfg)
    dparams = dmodel.init_params(torch.Generator(device=dev).manual_seed(1))
    eng = engine((dmodel, dparams), spec_tokens=SPEC_TOKENS)
    catch_ups = []
    wrap(eng.draft_backend, "spec_catch_up",
         lambda fn, *a: (catch_ups.append(a[0]), fn(*a))[1])
    _, m = spec_drive(torch, eng, make_requests(4, 512, SPEC_TAILS[::2], 24,
                                                V, seed=7),
                      24, V, f"paged, cold draft (full width cut to "
                      f"{dcfg.num_layers} layers, seed 1)")
    check(len(catch_ups) > 0, "cold draft: spec_catch_up never ran")
    print(f"  cold draft: spec_catch_up ran {len(catch_ups)} times")
    check(metrics["paged_self_draft"]["acceptance"] > m["acceptance"],
          "the target as its own draft is accepted no more than a cold "
          "draft")
    metrics["paged_cold_draft"] = dict(m, catch_ups=len(catch_ups))
    del eng, dparams
    torch.cuda.empty_cache()

    # -- 4) swap preemption --
    sw = dict(scheduling_policy="priority", enable_preemption=True,
              preempt_swap=True)

    def swap_requests():
        return make_requests(2, 0, [1500, 1530], 32, V, seed=10)

    eng = engine(**sw)
    for r in swap_requests():
        eng.add_request(r)
    base = {o.request_id: o.output_tokens for o in eng.run_to_completion()}
    eng = engine(**sw)
    moved = {}

    def timed(fn, *a):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a)
        torch.cuda.synchronize()
        moved[fn.__name__] = (time.perf_counter() - t0) * 1e3
        blob = out if out is not None else a[-1]
        moved["bytes"] = blob["k"].nbytes + blob["v"].nbytes
        return out

    wrap(eng.backend, "swap_out", timed)
    wrap(eng.backend, "swap_in", timed)
    for r in swap_requests():
        eng.add_request(r)
    outs = []
    for _ in range(100):
        outs += eng.step()
        if "r1" in eng.running and len(eng.running["r1"].output_tokens) >= 4:
            break
    check(eng.preempt("r1"), "swap: r1 was not running")
    outs += eng.run_to_completion()
    got = {o.request_id: o for o in outs}
    check(eng.stats["swap_outs"] == eng.stats["swap_ins"] == 1,
          f"swap: {eng.stats['swap_outs']} swap-outs, "
          f"{eng.stats['swap_ins']} swap-ins, expected 1 and 1")
    r1 = got.get("r1")
    check(r1 is not None and r1.finish_reason == "length"
          and len(r1.output_tokens) == 32,
          "swap: the preempted request did not finish at its length")
    same = float(np.mean([a == b for a, b in zip(r1.output_tokens,
                                                 base["r1"])]))
    print(f"  swap: r1 preempted after {eng.stats['preemptions']} "
          f"preemption(s), finished at its length; tokens equal to the "
          f"uninterrupted run: {same:.3f}; swap_out {moved['swap_out']:.3f} "
          f"ms, swap_in {moved['swap_in']:.3f} ms (host clock) for "
          f"{moved['bytes']} bytes of K and V")
    del eng
    be = PagedBackend(model, params, max_slots=2, max_len=4096, page_size=64,
                      use_kernel=True, device=dev)
    rng = np.random.default_rng(3)
    be.prefill("s", rng.integers(2, V, size=1500).tolist())
    first = be.swap_out("s")
    be.free("s")
    be.prefill("squat", rng.integers(2, V, size=700).tolist())
    be.swap_in("s", 1500, first)
    second = be.swap_out("s")
    check(all(torch.equal(first[n], second[n]) for n in ("k", "v")),
          "swap: swap_out -> swap_in -> swap_out changed the K/V bytes")
    print("  swap round trip (swap_out -> swap_in -> swap_out of 1500 "
          "tokens, into other pages): K and V byte-identical")
    metrics["swap"] = dict(moved, same_tokens_share=same)
    del be, params
    torch.cuda.empty_cache()

    # -- 5) draft = target again in float32, the same widths: the two
    # routes now differ by ~1e-6 of the logits' scale, so only real
    # near-ties reject (SPEC_MIN_ACCEPTANCE) --
    model32 = make_model(dataclasses.replace(cfg, param_dtype="float32"))
    params32 = model32.init_params(torch.Generator(device=dev).manual_seed(0))
    _, m, ms = self_draft_runs(torch, dev, model32, params32, "float32",
                               min_rate=SPEC_MIN_ACCEPTANCE)
    metrics.update(paged_self_draft_float32=m, slots_self_draft_float32=ms)
    del params32
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 5 in {metrics['phase_s']:.1f} s")
    return metrics


# ---------------------------------------------------------------------------
# phase 6: the moe, vlm and audio families and the serving entry point
# ---------------------------------------------------------------------------

FAMILY_ENGINE = dict(backend="paged", use_kernel=True, page_size=64,
                     max_slots=8, max_seq_len=4096, enable_prefix_cache=True,
                     chunked_prefill_budget=512, decode_steps_per_sync=8)
MOE_LAYERS = 16                # of phi3.5-moe's 32: the bf16 weights fit
VLM_LAYERS = 4                 # of llava-next-34b's 60: the phase's time
COPY_BYTES = 100 * 2 ** 20     # a device copy this large in the decode
#                                window would be a copy of an expert stack
# pooled hubert embeddings, kernel tier vs plain tier: the least cosine
EMBED_MIN_COS = 0.999


def count_fused_steps(PagedBackend):
    """Shadow ``PagedBackend.fused_decode`` (every engine of the class) to
    record the steps each kernel-tier call ran (``K_run``, its tokens'
    first axis); reference-tier calls go uncounted. Returns (list of
    K_run, original)."""
    steps = []

    def around(fn, backend, *a, **kw):
        out = fn(backend, *a, **kw)
        if backend.use_kernel:
            steps.append(out[0].shape[0])
        return out
    orig = wrap(PagedBackend, "fused_decode", around)
    return steps, orig


def paged_launch_checks(what, launches, L, chunks, fused_steps):
    """A paged engine's kernels launched once a layer: ``paged_flash_
    prefill`` for every prefill chunk, ``fused_decode_attention`` for every
    fused decode step."""
    print(f"  {what}: launches {launches}; {chunks} prefill chunks, "
          f"{fused_steps} fused decode steps, {L} layers")
    check(launches["paged_flash_prefill"] == L * chunks,
          f"{what}: paged_flash_prefill launched "
          f"{launches['paged_flash_prefill']} times, expected {L} x "
          f"{chunks} chunks")
    check(launches["fused_decode_attention"] == L * fused_steps,
          f"{what}: fused_decode_attention launched "
          f"{launches['fused_decode_attention']} times, expected {L} x "
          f"{fused_steps} steps")


def check_outputs(what, outs, n, max_tokens, V):
    check(len(outs) == n, f"{what}: {len(outs)} of {n} requests finished")
    for o in outs:
        check(o.finish_reason == "length"
              and len(o.output_tokens) == max_tokens,
              f"{what}: {o.request_id}: {o.finish_reason} after "
              f"{len(o.output_tokens)} tokens, expected length after "
              f"{max_tokens}")
        check(all(0 <= t < V for t in o.output_tokens),
              f"{what}: {o.request_id}: token id out of range")


def routing_flips(torch, kernel, plain, k, L):
    """(token, layer) routing decisions whose top-k expert set differs
    between two tiers, from the router probabilities each tier recorded
    call by call (call j is layer j % L). Returns (decisions, flips as
    (margin, rounding) pairs, flips by layer): margin is the plain tier's
    gap between its k-th and (k+1)-th probabilities, rounding the largest
    difference between the tiers' probabilities of that token."""
    check(len(kernel) == len(plain), "routing logs of unequal length")
    n, flips, by_layer = 0, [], [0] * L
    for j, (pk, pp) in enumerate(zip(kernel, plain)):
        sk = torch.sort(pk, dim=-1, descending=True, stable=True)
        sp = torch.sort(pp, dim=-1, descending=True, stable=True)
        ik = sk.indices[:, :k].sort(dim=-1).values
        ip = sp.indices[:, :k].sort(dim=-1).values
        n += pk.shape[0]
        for t in (ik != ip).any(dim=-1).nonzero()[:, 0].tolist():
            flips.append((float(sp.values[t, k - 1] - sp.values[t, k]),
                          float((pk[t] - pp[t]).abs().max())))
            by_layer[j % L] += 1
    return n, flips, by_layer


def run_moe(torch, dev):
    """phi3.5-moe at full width, cut to MOE_LAYERS layers: 8 requests
    through ``offline.run_batch`` on the paged engine (phase-3 settings),
    2 on the per-step path, 4 on the slot engine, each with its launches
    checked; a traced decode window (no copy of an expert stack) and
    prefill chunk; then a teacher-forced comparison of the kernel tier
    against the plain tier, with the routing decisions that flip between
    them."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)
    from repro_torch.serving.offline import run_batch

    full = REGISTRY["phi3.5-moe-42b-a6.6b"]
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS)
    L, V, E, k = cfg.num_layers, cfg.vocab_size, cfg.moe.num_experts, \
        cfg.moe.top_k
    print(f"phase 6a: {cfg.name} at full width, {L} of {full.num_layers} "
          f"layers: d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
          f"hd={cfg.head_dim} experts={E} top-{k} ff={cfg.d_ff} V={V} "
          f"{cfg.param_dtype}")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    print(f"  device memory allocated before the weights "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    moe_p = params["layers"]["moe"]
    expert_bytes = sum(moe_p[n].nbytes for n in ("w1", "w2", "w3"))
    del moe_p
    # what a decode step must read: every layer, the final norm, the head
    step_bytes = sum(t.nbytes for t in leaves(params["layers"])) \
        + params["final_norm"].nbytes + params["lm_head"].nbytes
    print(f"  random weights in {time.perf_counter() - t0:.1f} s: "
          f"{sum(t.nbytes for t in leaves(params)) / 1e9:.2f} GB, "
          f"expert stacks {expert_bytes / 1e9:.2f} GB; device memory "
          f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    metrics = {"layers": L, "expert_bytes": expert_bytes,
               "step_read_bytes": step_bytes,
               "weight_read_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}

    warm = ContinuousBatchingEngine(model, params,
                                    EngineConfig(**FAMILY_ENGINE), device=dev)
    drive(torch, warm, make_requests(2, 300, [40, 90], 9, V, seed=9,
                                     model=cfg.name))
    del warm
    torch.cuda.empty_cache()

    # -- main path: offline.run_batch, fused K=8, chunked prefill, prefix
    # cache; half greedy, half seeded top-p --
    tails = np.linspace(64, 512, 8).astype(int)
    steps, orig = count_fused_steps(PagedBackend)
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, stats = run_batch(model, params,
                            make_requests(8, 1024, tails, 32, V, seed=0,
                                          model=cfg.name),
                            EngineConfig(**FAMILY_ENGINE), device=dev)
    launches = dict(_build.LAUNCHES)
    PagedBackend.fused_decode = orig
    check_outputs("moe run_batch", outs, 8, 32, V)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "moe run_batch: the fused path moved logits to the host")
    check(stats["cached_prompt_tokens"] > 0, "moe run_batch: no prefix-cache "
          "hits")
    paged_launch_checks("moe run_batch", launches, L, stats["prefill_chunks"],
                        sum(steps))
    print(f"  run_batch: {stats['output_tokens']} output tokens in "
          f"{stats['wall_s']:.3f} s: {stats['output_tok_per_s']:.1f} "
          f"tokens/s, {stats['req_per_s']:.2f} requests/s; prefill "
          f"{stats['prefill_tokens']} tokens ({stats['cached_prompt_tokens']}"
          f" from the prefix cache) in {stats['prefill_chunks']} chunks")
    metrics["run_batch"] = {n: stats[n] for n in (
        "wall_s", "output_tokens", "output_tok_per_s", "req_per_s",
        "prefill_tokens", "cached_prompt_tokens", "prefill_chunks",
        "decode_syncs")}
    metrics["launches_main"] = launches
    torch.cuda.empty_cache()

    # -- decode window (no device copy of an expert stack) and prefill chunk
    def no_expert_copy(prof, peak_rise):
        big = [(e.name, e.input_shapes[0]) for e in prof.events()
               if e.name in ("aten::copy_", "aten::clone", "aten::contiguous",
                             "aten::_to_copy") and e.input_shapes
               and e.input_shapes[0]
               and 2 * math.prod(e.input_shapes[0]) >= COPY_BYTES]
        print(f"  decode window: copies of >= {COPY_BYTES} B: {len(big)}; "
              f"most device memory allocated above the window's start "
              f"{peak_rise} B")
        check(not big, f"moe decode window: device copies of an expert "
              f"stack's size: {big[:3]}")
        check(peak_rise < COPY_BYTES, "moe decode window: allocated "
              f"{peak_rise} B above its start, an expert stack's size")
        metrics["decode_window_peak_rise_bytes"] = peak_rise

    metrics.update(profile_decode(
        torch, ContinuousBatchingEngine(model, params,
                                        EngineConfig(**FAMILY_ENGINE),
                                        device=dev),
        make_requests(8, 1024, tails, 64, V, seed=3, model=cfg.name),
        on_trace=no_expert_copy))
    dms = metrics.get("decode_step_device_ms")
    print(f"  decode step: {step_bytes / 1e9:.2f} GB of weights to read "
          f"({expert_bytes / 1e9:.2f} GB of experts): bound "
          f"{metrics['weight_read_bound_ms']:.3f} ms; device "
          + (f"{dms:.3f} ms: experts read at "
             f"{expert_bytes / dms / 1e9:.3f} TB/s over the whole step"
             if dms else "not measured"))
    torch.cuda.empty_cache()
    flops = 2 * 512 * cfg.d_model * cfg.d_ff * 3 * E * L
    print(f"  prefill chunk: the all-expert products of 512 tokens are "
          f"{flops / 1e12:.2f} TFLOP: {flops / BF16_FLOPS * 1e3:.3f} ms at "
          f"the bf16 peak")
    metrics["prefill_chunk_expert_tflop"] = flops / 1e12
    metrics.update(profile_prefill(
        torch, ContinuousBatchingEngine(model, params,
                                        EngineConfig(**FAMILY_ENGINE),
                                        device=dev),
        make_requests(3, 0, [1536] * 3, 1, V, seed=5, model=cfg.name),
        step=3, what="512-token chunk at 1024"))
    torch.cuda.empty_cache()

    # -- per-step path: fused_decode=False (paged_attention) --
    eng = ContinuousBatchingEngine(
        model, params, EngineConfig(**dict(FAMILY_ENGINE, fused_decode=False)),
        device=dev)
    calls = []
    wrap(eng.backend, "decode_batch",
         lambda fn, *a: (calls.append(1), fn(*a))[1])
    _build.reset_launches()
    outs2, _, _, _ = drive(torch, eng, make_requests(2, 300, [40, 90], 16, V,
                                                     seed=1, model=cfg.name))
    step_launches = dict(_build.LAUNCHES)
    check_outputs("moe per-step path", outs2, 2, 16, V)
    print(f"  per-step path: launches {step_launches}; {len(calls)} decode "
          f"steps")
    check(step_launches["paged_attention"] == L * len(calls),
          f"moe per-step path: paged_attention launched "
          f"{step_launches['paged_attention']} times, expected {L} x "
          f"{len(calls)}")
    del eng
    torch.cuda.empty_cache()

    # -- slot engine: one-shot prefill through flash_attention --
    eng = ContinuousBatchingEngine(
        model, params, EngineConfig(backend="slots", use_kernel=True,
                                    max_slots=4, max_seq_len=2048,
                                    decode_steps_per_sync=8), device=dev)
    _build.reset_launches()
    outs3, _, t_dec, n_dec = drive(torch, eng, make_requests(
        4, 0, [300, 600, 900, 1200], 16, V, seed=2, model=cfg.name))
    slot_launches = dict(_build.LAUNCHES)
    check_outputs("moe slot engine", outs3, 4, 16, V)
    print(f"  slot engine: launches {slot_launches}; decode-only steps "
          f"{n_dec / t_dec:.1f} tokens/s")
    check(slot_launches["flash_attention"] == L * 4,
          f"moe slot engine: flash_attention launched "
          f"{slot_launches['flash_attention']} times, expected {L} x 4")
    del eng
    torch.cuda.empty_cache()
    metrics["launches"] = {
        "paged_flash_prefill": launches["paged_flash_prefill"],
        "fused_decode_attention": launches["fused_decode_attention"],
        "paged_attention": step_launches["paged_attention"],
        "flash_attention": slot_launches["flash_attention"]}

    # -- teacher-forced: the same 1500-token prompt (512-token chunks) and
    # the same 8 decode tokens through each tier. Free runs: each tier
    # routes by its own router; the plain tier's own spread is its run
    # with 256-token chunks. Forced run: the kernel tier routed by the
    # plain tier's top-k decisions, call by call, so the two compute the
    # same function and differ by the attention kernels' rounding alone.
    # Every tier's router probabilities are logged call by call --
    log = {"on": None, "force": False}
    orig_routing = moe_mod._routing

    def routing(x, p, c):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        calls = log.setdefault(log["on"], [])
        calls.append(probs.reshape(-1, E))
        if not log["force"]:
            return orig_routing(x, p, c)
        ref = log["plain"][len(calls) - 1]
        idx = moe_mod._top_k(ref, k)[1].reshape(*probs.shape[:-1], k)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return (torch.zeros_like(probs).scatter(-1, idx, gates), gates, idx,
                torch.zeros((), device=x.device))

    moe_mod._routing = routing
    tiers = {"plain": (False, 512), "plain256": (False, 256),
             "kernel": (True, 512), "forced": (True, 512)}
    bk = {n: PagedBackend(model, params, max_slots=1, max_len=2048,
                          page_size=64, use_kernel=uk, device=dev)
          for n, (uk, _) in tiers.items()}
    prompt = np.random.default_rng(2).integers(2, V, size=1500).tolist()
    lg = {}
    for n, b in bk.items():
        log["on"], log["force"] = n, n == "forced"
        task = b.start_prefill("s", prompt)
        out = None
        while out is None:
            out, _ = b.prefill_chunk(task, tiers[n][1])
        lg[n] = [out.float().cpu().numpy()]
    agree = 0
    for _ in range(8):
        tok = int(lg["plain"][-1].argmax())
        for n, b in bk.items():
            log["on"], log["force"] = n, n == "forced"
            lg[n].append(b.decode_batch(np.array([tok]))[0])
        agree += int(lg["kernel"][-1].argmax() == lg["plain"][-1].argmax())
    moe_mod._routing = orig_routing

    def worst(a, b):
        return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-6))
                   for x, y in zip(lg[a], lg[b]))

    err, spread, forced = (worst("kernel", "plain"), worst("plain256", "plain"),
                           worst("forced", "plain"))
    n_route, flips, by_layer = routing_flips(torch, log["kernel"],
                                             log["plain"], k, L)
    _, fflips, _ = routing_flips(torch, log["forced"], log["plain"], k, L)
    free_tol = LOGITS_TOL if not flips else max(LOGITS_TOL,
                                                SPREAD_FACTOR * spread)
    print(f"  teacher-forced, free runs (1500-token prompt + 8 decode "
          f"steps): kernel vs plain logits rel_err {err:.3e}; plain tier's "
          f"own spread (256- against 512-token chunks) {spread:.3e}; "
          f"max({LOGITS_TOL}, {SPREAD_FACTOR} x spread) = {free_tol:.3e} "
          f"{'met' if err <= free_tol else 'NOT met'}; greedy tokens that "
          f"match {agree}/8")
    print(f"    routing: {len(flips)} of {n_route} (token, layer) top-{k} "
          f"sets differ (share {len(flips) / n_route:.3e}), by layer "
          f"{by_layer}; margins at the first flips "
          f"{[f'{m:.2e} (rounding {r:.2e})' for m, r in flips[:8]]}")
    print(f"  teacher-forced, kernel tier routed by the plain tier's "
          f"decisions: logits rel_err {forced:.3e} (tolerance {LOGITS_TOL});"
          f" {len(fflips)} decisions where its own top-{k} would differ "
          f"(share {len(fflips) / n_route:.3e}), margins "
          f"{[f'{m:.2e} (rounding {r:.2e})' for m, r in fflips[:8]]}")
    check(all(m <= 2 * r for m, r in fflips), "moe teacher-forced: under "
          "the same routing a top-k decision differs between the tiers by "
          "more than twice their probabilities' rounding")
    check(forced <= LOGITS_TOL, "moe teacher-forced: under the same routing "
          "the kernel tier's logits disagree with the plain tier's")
    metrics.update(teacher_forced_rel_err=err, plain_spread_rel_err=spread,
                   free_run_tolerance=free_tol,
                   forced_routing_rel_err=forced,
                   routing_decisions=n_route, routing_flips=len(flips),
                   routing_flips_by_layer=by_layer,
                   routing_flip_margins=flips[:64],
                   forced_would_flip=len(fflips),
                   forced_would_flip_margins=fflips, greedy_match=agree / 8)
    del bk, params
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 6a in {metrics['phase_s']:.1f} s")
    return metrics


def leaves(tree):
    """Every tensor of a nested dict of parameters."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in leaves(v)]
    return [tree]


def run_vlm(torch, dev):
    """llava-next-34b at full width, cut to VLM_LAYERS layers: 4 requests
    on the paged engine (phase-3 settings), launches checked; then
    ``LM.prefill`` of seeded (2, 1024, d) embeddings (the stub frontend's
    features) in the kernel tier against the plain tier."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    full = REGISTRY["llava-next-34b"]
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    L, V = cfg.num_layers, cfg.vocab_size
    print(f"phase 6b: {cfg.name} at full width, {L} of {full.num_layers} "
          f"layers: d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
          f"hd={cfg.head_dim} ff={cfg.d_ff} V={V} {cfg.param_dtype}")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    drive(torch, ContinuousBatchingEngine(
        model, params, EngineConfig(**FAMILY_ENGINE), device=dev),
        make_requests(2, 300, [40, 90], 9, V, seed=9, model=cfg.name))
    eng = ContinuousBatchingEngine(model, params,
                                   EngineConfig(**FAMILY_ENGINE), device=dev)
    steps, orig = count_fused_steps(PagedBackend)
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, make_requests(
        4, 512, [100, 300, 500, 700], 16, V, seed=4, model=cfg.name))
    launches = dict(_build.LAUNCHES)
    PagedBackend.fused_decode = orig
    check_outputs("vlm paged engine", outs, 4, 16, V)
    paged_launch_checks("vlm paged engine", launches, L,
                        eng.stats["prefill_chunks"], sum(steps))
    metrics = {"layers": L, "launches": {
        n: launches[n] for n in ("paged_flash_prefill",
                                 "fused_decode_attention")},
        "prefill_tok_s": eng.stats["prefill_tokens"] / t_pf,
        "decode_tok_s": n_dec / t_dec}
    print(f"  paged engine: prefill {metrics['prefill_tok_s']:.1f} tokens/s, "
          f"decode-only steps {metrics['decode_tok_s']:.1f} tokens/s")
    del eng
    torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(3)
    emb = torch.randn(2, 1024, cfg.d_model, generator=g, device=dev) * 0.02
    _build.reset_launches()
    lk, _ = model.prefill(params, {"embeds": emb}, use_kernel=True)
    check(_build.LAUNCHES["flash_attention"] == L,
          f"vlm prefill: flash_attention launched "
          f"{_build.LAUNCHES['flash_attention']} times, expected {L}")
    lp, _ = model.prefill(params, {"embeds": emb})
    rel, _ = rel_err(lk, lp)
    print(f"  LM.prefill of embeddings (2, 1024, {cfg.d_model}): kernel tier "
          f"vs plain tier logits rel_err {rel:.3e} (tolerance {LOGITS_TOL});"
          f" greedy tokens equal "
          f"{(lk.argmax(-1) == lp.argmax(-1)).tolist()}")
    check(bool(torch.isfinite(lk).all()), "vlm prefill: non-finite logits")
    check(rel <= LOGITS_TOL, "vlm prefill: kernel tier logits disagree with "
          "the plain tier")
    metrics["embeds_prefill_rel_err"] = rel
    del params
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 6b in {metrics['phase_s']:.1f} s")
    return metrics


def run_audio(torch, dev):
    """hubert-xlarge at full width and depth: ``EmbeddingEngine`` on 8
    seeded frame sequences of 100..512 frames padded to 512 (48
    ``flash_attention`` launches a batch, checked), the pooled embeddings
    of the kernel tier against the plain tier, and a batch's host-clock
    and device time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.models.transformer import forward
    from repro_torch.serving.embedding import EmbeddingEngine, pool

    cfg = REGISTRY["hubert-xlarge"]
    print(f"phase 6c: {cfg.name} at full width and depth: L="
          f"{cfg.num_layers} d={cfg.d_model} H={cfg.num_heads} "
          f"hd={cfg.head_dim} ff={cfg.d_ff} causal={cfg.causal} "
          f"{cfg.param_dtype}")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    eng = EmbeddingEngine(model, params, device=dev)
    rng = np.random.default_rng(6)
    lens = np.linspace(100, 512, 8).astype(np.int32)
    frames = rng.standard_normal((8, 512, cfg.d_model)).astype(np.float32)
    eng.embed(frames, lens)                                   # warm-up
    _build.reset_launches()
    out = eng.embed(frames, lens)
    n_fa = _build.LAUNCHES["flash_attention"]
    check(n_fa == cfg.num_layers, f"hubert: flash_attention launched {n_fa} "
          f"times a batch, expected {cfg.num_layers}")
    x = torch.from_numpy(frames).to(dev, params["embed"].dtype)
    h, _ = forward(params, x, cfg)
    ref = pool(h, torch.from_numpy(lens).to(dev)).float().cpu().numpy()
    cos = float(((out * ref).sum(-1) / (np.linalg.norm(out, axis=-1)
                                         * np.linalg.norm(ref, axis=-1)))
                .min())
    rel = float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6))
    print(f"  embeddings (8, {cfg.d_model}), kernel tier vs plain tier: "
          f"worst cosine {cos:.6f} (least {EMBED_MIN_COS}), rel_err "
          f"{rel:.3e} (tolerance {LOGITS_TOL}); flash_attention launches "
          f"a batch {n_fa}")
    check(np.isfinite(out).all(), "hubert: non-finite embeddings")
    check(cos >= EMBED_MIN_COS and rel <= LOGITS_TOL,
          "hubert: kernel tier embeddings disagree with the plain tier")
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.embed(frames, lens)           # ends in a device->host copy
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.embed(frames, lens)
    by_group, by_name, by_port, n_act = device_time(prof)
    wall = statistics.median(walls)
    busy = sum(by_group.values()) / 1e3 if by_group else None
    print(f"  a batch of 8 x 512 frames: {wall:.3f} ms on the host clock "
          f"(median of 5), device "
          + (f"busy {busy:.3f} ms in {n_act} device activities: idle share "
             f"{1 - busy / wall:.3f}" if busy else "time not measured"))
    if by_group:
        print_breakdown(by_group, by_name, by_port, 1, "")
    metrics = {"flash_attention_launches_a_batch": n_fa,
               "worst_cosine": cos, "rel_err": rel, "batch_wall_ms": wall,
               "batch_device_ms": busy,
               "device_ms_by_group": {g_: us / 1e3
                                      for g_, us in by_group.items()},
               "device_ms_by_port_kernel": {k_: us / 1e3
                                            for k_, us in by_port.items()}}
    del eng, params, h, x
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 6c in {metrics['phase_s']:.1f} s")
    return metrics


def run_serve_entry_point():
    """``python -m repro_torch.launch.serve`` at llama3.2-3b's full width
    on the card, streamed: it must exit 0, and its own check that every
    stream reassembles to the request's output must hold."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "llama3.2-3b", "--full", "--requests", "8", "--max-tokens", "16",
           "--stream"]
    print(f"phase 6d: the serving entry point: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, env={**os.environ,
                                             "PYTHONPATH": str(SRC)},
                         capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in (out.stdout + out.stderr).strip().splitlines()[-8:]:
        print(f"    {line}")
    check(out.returncode == 0, f"the serving entry point exited "
          f"{out.returncode}")
    check("streamed:" in out.stdout and "8 requests" in out.stdout,
          "the serving entry point did not report 8 streamed requests")
    print(f"  exit 0 in {secs:.1f} s")
    return {"exit": out.returncode, "seconds": secs}


# ---------------------------------------------------------------------------
# phase 7: training on the card
# ---------------------------------------------------------------------------

# 7a: one train step of each family's reduced config, card against CPU
TRAIN_FAMILIES = ("llama3.2-3b", "phi3.5-moe-42b-a6.6b", "llava-next-34b",
                  "mamba2-130m", "zamba2-2.7b", "hubert-xlarge")
# float32 loss and gradients, card vs CPU: the CPU tests' tolerance of the
# port against the JAX package (the same float32 sums in another order)
TRAIN_TOL = dict(atol=2e-5, rtol=1e-4)
TRAIN_LR = 1e-3
# parameters after one AdamW step where the update direction is firm (the
# CPU's sqrt(v_hat) at least 1e-3 of its leaf's largest); elsewhere step 1
# moves an entry by about lr * sign(g), so those are held to 2 lr (1 + wd
# |p|), and they must stay under this share of all entries
TRAIN_PARAM_ATOL = 1e-6
TRAIN_LOOSE_SHARE = 0.05
# (atol, rtol) of the moments after one step: m = 0.1 g, v = 0.05 g^2, held
# as the CPU tests hold the port's against the JAX package's
MOMENT_TOL = {"m": (2e-6, 1e-4), "v": (1e-10, 3e-4)}
# 7b: llama3.2-3b at full width, bf16, on one repeated batch
FULL_TRAIN_BATCH, FULL_TRAIN_SEQ, FULL_TRAIN_MICRO = 8, 1024, 2
FULL_TRAIN_STEPS = 10
FULL_TRAIN_LR = 3e-4
LOSS_DROP = 1.0            # nats from the first of the steps to the last
# 7c: bf16 bounds at full width: |loss difference| relative to the loss,
# and per leaf ||g - g_ref|| / ||g_ref||. Each microbatch's gradients are
# rounded to bf16 before they are summed, and the chunked loss sums its
# chunks' bf16 hidden-state gradients; where a leaf's gradient is a small
# sum of large cancelling parts the rounding is large beside it: a 16-layer
# d 1024 bf16 model on the CPU differs by up to 1.45e-2 in both comparisons
BF16_LOSS_RTOL = 1e-3
BF16_GRAD_RTOL = 5e-2
CE_CHUNK = 16384
# 7d: depth cuts and batches of the two more families
MOE_TRAIN_LAYERS = 2       # of phi3.5-moe's 32
HYBRID_TRAIN_LAYERS = 12   # of zamba2-2.7b's 54: two shared-block groups
INIT_LOSS_WINDOW = 1.0     # |first loss - ln V| at initialisation


def close_count(torch, a, b, atol, rtol):
    """(entries outside atol + rtol |b|, max |a - b|) of two tensors."""
    d = (a.float() - b.float()).abs()
    bad = int((d > atol + rtol * b.float().abs()).sum())
    return bad, float(d.max()) if d.numel() else 0.0


def train_card_vs_cpu(torch, dev):
    """7a: each family's reduced config (float32) through
    ``loss_and_grads`` and one ``make_train_step`` step on the card and on
    the CPU, from the same parameters and batch."""
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data.tokens import TokenDataset
    from repro_torch.models import make_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train import (batch_to, loss_and_grads,
                                            make_train_step)
    from repro_torch.tree import tree_leaves, tree_map
    print("phase 7a: one train step of each reduced family, card vs CPU "
          f"(float32; loss and gradients to {TRAIN_TOL})")
    out = {}
    for arch in TRAIN_FAMILIES:
        cfg = reduced(REGISTRY[arch])
        model = make_model(cfg)
        p_cpu = model.init_params(torch.Generator().manual_seed(0))
        p_dev = tree_map(lambda t: t.to(dev), p_cpu)
        batch = TokenDataset(cfg.vocab_size, 32, 4, seed=1,
                             input_kind=cfg.input_kind,
                             d_model=cfg.d_model).next_batch()
        l_c, g_c = loss_and_grads(model, p_cpu, batch_to(batch, "cpu"))
        l_d, g_d = loss_and_grads(model, p_dev, batch_to(batch, dev))
        bad_l, dl = close_count(torch, l_d.cpu(), l_c, **TRAIN_TOL)
        check(bad_l == 0, f"7a {arch}: loss {float(l_d)} vs CPU {float(l_c)}")
        worst = 0.0
        for a, b in zip(tree_leaves(g_d), tree_leaves(g_c)):
            bad, d = close_count(torch, a.cpu(), b, **TRAIN_TOL)
            check(bad == 0, f"7a {arch}: {bad} gradient entries outside "
                  f"{TRAIN_TOL} (max diff {d:.3e})")
            worst = max(worst, d / max(float(b.abs().max()), 1e-30))
        ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=0)
        step = make_train_step(model, ocfg)
        pc, oc, mc = step(p_cpu, adamw_init(p_cpu), batch)
        pd, od, md = step(p_dev, adamw_init(p_dev), batch)
        check(abs(float(md["lr"]) - float(mc["lr"])) <= 3e-7 * TRAIN_LR,
              f"7a {arch}: lr {float(md['lr'])} vs {float(mc['lr'])}")
        bc2 = 1 - ocfg.beta2
        loose = total = 0
        p_diff = 0.0
        for a, b, v, p0 in zip(tree_leaves(pd), tree_leaves(pc),
                               tree_leaves(oc["v"]), tree_leaves(p_cpu)):
            a = a.cpu()
            sv = torch.sqrt(v / bc2)
            firm = (sv >= 1e-3 * sv.max()) | (sv == 0)
            d = (a - b).abs()
            d_firm = float(d[firm].max()) if firm.any() else 0.0
            check(d_firm <= TRAIN_PARAM_ATOL, f"7a {arch}: a parameter "
                  f"moved {d_firm:.3e} from the CPU's where its update "
                  "direction is firm")
            bound = 2 * TRAIN_LR * (1 + ocfg.weight_decay * p0.abs()) + 1e-6
            check(bool((d <= bound).all()), f"7a {arch}: a parameter moved "
                  "more than 2 lr from the CPU's")
            loose += int((~firm).sum())
            total += firm.numel()
            p_diff = max(p_diff, d_firm)
        check(loose < TRAIN_LOOSE_SHARE * total,
              f"7a {arch}: {loose} of {total} entries without a firm "
              "update direction")
        for name, a, b in (("m", od["m"], oc["m"]), ("v", od["v"], oc["v"])):
            for x, y in zip(tree_leaves(a), tree_leaves(b)):
                bad, d = close_count(torch, x.cpu(), y, *MOMENT_TOL[name])
                check(bad == 0, f"7a {arch}: {name} differs by {d:.3e}")
        print(f"  {arch:22s} loss {float(l_d):.6f} (CPU {float(l_c):.6f}, "
              f"diff {dl:.2e}); worst gradient {worst:.2e} of its leaf's "
              f"largest; params after AdamW within {p_diff:.2e} where firm, "
              f"{loose}/{total} loose")
        out[arch] = {"loss": float(l_d), "loss_diff": dl,
                     "worst_grad_rel": worst, "param_diff": p_diff,
                     "loose": loose, "entries": total}
    return out


def leaf_rel(torch, g, ref):
    """||g - ref|| / ||ref|| in float32."""
    num = torch.linalg.vector_norm((g.float() - ref.float()))
    return float(num / torch.clamp(torch.linalg.vector_norm(ref.float()),
                                   min=1e-30))


def train_full_llama(torch, dev):
    """7c then 7b: llama3.2-3b at full width and depth, bf16."""
    from torch.profiler import ProfilerActivity, profile
    import repro_torch.training.train as train_mod
    from repro_torch.configs import REGISTRY
    from repro_torch.data.tokens import TokenDataset
    from repro_torch.distributed.hints import ShardingHints, use_hints
    from repro_torch.models import make_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train import (batch_to, loss_and_grads,
                                            make_train_step)
    from repro_torch.tree import tree_leaves
    cfg = REGISTRY["llama3.2-3b"]
    model = make_model(cfg)
    B, S, n = FULL_TRAIN_BATCH, FULL_TRAIN_SEQ, FULL_TRAIN_MICRO
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    N = sum(t.numel() for t in tree_leaves(params))
    n_mm = sum(t.numel() for t in tree_leaves(
        {"lm_head": params["lm_head"], "attn": params["layers"]["attn"],
         "mlp": params["layers"]["mlp"]}))
    batch = batch_to(TokenDataset(cfg.vocab_size, S, B, seed=0)
                     .next_batch(), dev)
    tokens = B * S
    print(f"phase 7b/7c: {cfg.name} at full width and depth, bf16: "
          f"L={cfg.num_layers} d={cfg.d_model} {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim} d_ff={cfg.d_ff} "
          f"V={cfg.vocab_size}: {N / 1e9:.3f} B parameters ({n_mm / 1e9:.3f} "
          f"B in matmuls); B={B} S={S}")

    # -- 7c: at initialisation, loss and gradients only (no optimizer
    # state): one microbatch against two, the chunked loss against the
    # full-logit loss --
    t0 = time.perf_counter()
    l1, g1 = loss_and_grads(model, params, batch, 1)
    l2, g2 = loss_and_grads(model, params, batch, n)
    c = {"loss_n1": float(l1), "loss_n2": float(l2)}
    rel_mb = [leaf_rel(torch, a, b) for a, b in zip(tree_leaves(g1),
                                                    tree_leaves(g2))]
    check(all(g.dtype == torch.bfloat16 for g in tree_leaves(g1)),
          "7c: one-microbatch gradients are not in the param dtype")
    check(all(g.dtype == torch.float32 for g in tree_leaves(g2)),
          "7c: accumulated gradients are not float32")
    del g1
    with use_hints(ShardingHints(ce_chunk=CE_CHUNK)):
        l3, g3 = loss_and_grads(model, params, batch, n)
    c["loss_chunked_ce"] = float(l3)
    rel_ce = [leaf_rel(torch, a, b) for a, b in zip(tree_leaves(g3),
                                                    tree_leaves(g2))]
    finite = all(bool(torch.isfinite(g).all()) for g in tree_leaves(g2))
    del g2, g3
    c.update(grad_rel_n1_vs_n2=max(rel_mb), grad_rel_chunked_vs_full=max(
        rel_ce), seconds=time.perf_counter() - t0)
    print(f"  7c: loss n=1 {c['loss_n1']:.6f}, n={n} {c['loss_n2']:.6f}, "
          f"ce_chunk={CE_CHUNK} {c['loss_chunked_ce']:.6f} (ln V "
          f"{math.log(cfg.vocab_size):.4f}); worst leaf ||dg||/||g||: n=1 "
          f"vs n={n} {max(rel_mb):.3e}, chunked vs full {max(rel_ce):.3e} "
          f"(bound {BF16_GRAD_RTOL}); {c['seconds']:.1f} s")
    check(finite, "7c: a gradient is not finite")
    for name, la, lb, rel in (("n=1 vs n=2", l1, l2, rel_mb),
                              ("chunked vs full", l3, l2, rel_ce)):
        check(abs(float(la) - float(lb)) <= BF16_LOSS_RTOL * abs(float(lb)),
              f"7c {name}: loss {float(la)} vs {float(lb)}")
        check(max(rel) <= BF16_GRAD_RTOL,
              f"7c {name}: a leaf's gradient differs by {max(rel):.3e}")
    check(abs(float(l2) - math.log(cfg.vocab_size)) < INIT_LOSS_WINDOW,
          f"7c: the loss at initialisation {float(l2)} is not near ln V")

    # -- 7b: AdamW steps on one repeated batch, in place --
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params)
    step = make_train_step(model, AdamWConfig(lr=FULL_TRAIN_LR,
                                              warmup_steps=0),
                           num_microbatches=n, remat=True, in_place=True)
    losses, secs = [], []
    for _ in range(FULL_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        check(math.isfinite(losses[-1]) and math.isfinite(
            float(m["grad_norm"])), f"7b: step {len(losses)} loss "
            f"{losses[-1]} grad norm {float(m['grad_norm'])}")
    peak = torch.cuda.max_memory_allocated()
    step_s = statistics.median(secs[1:])
    tok_s = tokens / step_s
    mfu = 6 * n_mm * tokens / step_s / BF16_FLOPS
    print(f"  7b: {FULL_TRAIN_STEPS} steps (n={n} microbatches, remat, "
          f"in-place AdamW, lr {FULL_TRAIN_LR}): losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}")
    print(f"  7b: step {step_s * 1e3:.1f} ms (median of steps 2..; first "
          f"{secs[0] * 1e3:.1f} ms), {tok_s:.1f} tokens/s, train_mfu "
          f"{mfu:.4f} (6 x {n_mm / 1e9:.3f} B x {tokens} tokens a step at "
          f"{BF16_FLOPS / 1e12:.0f} TFLOP/s), peak memory "
          f"{peak / 1e9:.2f} GB")
    check(losses[-1] <= losses[0] - LOSS_DROP,
          f"7b: the loss fell {losses[0] - losses[-1]:.4f}, not "
          f"{LOSS_DROP}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < INIT_LOSS_WINDOW,
          f"7b: the first loss {losses[0]} is not near ln V")

    # -- one traced step: device time by op class, idle share --
    orig = train_mod.adamw_update
    train_mod.adamw_update = labelled(torch, orig, "optimizer")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
    finally:
        train_mod.adamw_update = orig
    by_group, by_name, by_port, n_act = device_time(prof, skip=("optimizer",))
    busy = sum(by_group.values()) / 1e3
    trace = {"device_busy_ms": busy, "device_activities": n_act}
    if busy:
        from torch.autograd import DeviceType
        ops = {}
        for e in prof.events():
            if e.device_type == DeviceType.CPU and e.name in (
                    "aten::mm", "aten::addmm", "aten::bmm", "optimizer"):
                us = e.device_time_total if hasattr(
                    e, "device_time_total") else e.cuda_time_total
                ops[e.name] = ops.get(e.name, 0.0) + us / 1e3
        mm = ops.get("aten::mm", 0.0) + ops.get("aten::addmm", 0.0)
        groups = {"bf16 matmuls (aten::mm: projections, MLP, lm head)": mm,
                  "float32 attention einsums (aten::bmm)": ops.get(
                      "aten::bmm", 0.0),
                  "optimizer (adamw_update)": ops.get("optimizer", 0.0)}
        groups["the rest (elementwise, reductions, indexing, copies)"] = \
            busy - sum(groups.values())
        trace.update(device_ms_by_group=groups,
                     idle_share=1.0 - busy / (step_s * 1e3))
        print(f"  7b traced step: device busy {busy:.1f} ms of a "
              f"{step_s * 1e3:.1f} ms step: idle share "
              f"{trace['idle_share']:.3f}; {n_act} device activities")
        for g, ms in groups.items():
            print(f"    {g:56s} {ms:9.1f} ms")
        print_breakdown(by_group, by_name, by_port, 1, "in the step")
    else:
        print("  7b traced step: device time not measured (the profiler "
              "saw no device activity)")
    del params, opt, m
    return {"params": N, "matmul_params": n_mm, "tokens_per_step": tokens,
            "losses": losses, "step_s": secs, "step_ms_median": step_s * 1e3,
            "tokens_per_s": tok_s, "train_mfu": mfu,
            "peak_memory_gb": peak / 1e9, "trace": trace, "grads": c}


def train_two_families(torch, dev):
    """7d: one step each (after a warm-up step) of phi3.5-moe and
    zamba2-2.7b at full width, cut in depth."""
    from repro_torch.configs import REGISTRY
    from repro_torch.data.tokens import TokenDataset
    from repro_torch.models import make_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train import batch_to, make_train_step
    from repro_torch.tree import tree_leaves
    out = {}
    for arch, layers, B, S in (
            ("phi3.5-moe-42b-a6.6b", MOE_TRAIN_LAYERS, 4, 1024),
            ("zamba2-2.7b", HYBRID_TRAIN_LAYERS, 2, 2048)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        full = REGISTRY[arch]
        cfg = dataclasses.replace(full, num_layers=layers)
        if cfg.moe:
            check(S * cfg.moe.top_k >= 4 * cfg.moe.num_experts,
                  "7d: the grouped dispatch would not run")
        model = make_model(cfg)
        params = model.init_params(torch.Generator(device=dev).manual_seed(0))
        N = sum(t.numel() for t in tree_leaves(params))
        opt = adamw_init(params)
        state_gb = sum(t.numel() * (t.element_size() * 2 + 8)
                       for t in tree_leaves(params)) / 1e9
        data = TokenDataset(cfg.vocab_size, S, B, seed=0)
        step = make_train_step(model, AdamWConfig(lr=FULL_TRAIN_LR,
                                                  warmup_steps=0),
                               remat=True, in_place=True)
        what = (f"{arch}, {layers} of {full.num_layers} layers at full "
                f"width")
        print(f"phase 7d: {what}: {N / 1e9:.3f} B parameters, "
              f"{state_gb:.1f} GB of params, grads and AdamW moments; "
              f"B={B} S={S}")
        losses, secs, norms = [], [], []
        for _ in range(2):
            batch = batch_to(data.next_batch(), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        peak = torch.cuda.max_memory_allocated()
        ln_v = math.log(cfg.vocab_size)
        print(f"  losses {losses[0]:.4f}, {losses[1]:.4f} (ln V {ln_v:.4f}); "
              f"gradient norms {norms[0]:.4f}, {norms[1]:.4f}; step "
              f"{secs[1] * 1e3:.1f} ms (first {secs[0] * 1e3:.1f}); peak "
              f"memory {peak / 1e9:.2f} GB")
        # the global norm is finite only if every gradient entry is
        check(all(math.isfinite(x) for x in losses + norms),
              f"7d {arch}: a loss or gradient is not finite")
        check(abs(losses[0] - ln_v) < INIT_LOSS_WINDOW,
              f"7d {arch}: the first loss {losses[0]} is not near ln V")
        check(all(bool(torch.isfinite(t).all()) for t in tree_leaves(params)),
              f"7d {arch}: a parameter is not finite after the steps")
        out[arch] = {"layers": layers, "of_layers": full.num_layers,
                     "params": N, "batch": B, "seq": S, "losses": losses,
                     "grad_norms": norms, "step_ms": secs[1] * 1e3,
                     "first_step_ms": secs[0] * 1e3,
                     "peak_memory_gb": peak / 1e9}
        del params, opt, m, step
    return out


def resume_run(torch, dev, path):
    """3 steps, a checkpoint, 2 more; then the checkpoint loaded onto the
    card and the same 2 steps. Returns the leaves and losses that differ."""
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data.tokens import TokenDataset
    from repro_torch.distributed.checkpoint import (_flatten,
                                                    load_checkpoint,
                                                    save_checkpoint)
    from repro_torch.models import make_model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train import init_training, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = reduced(REGISTRY["llama3.2-3b"])
    model = make_model(cfg)
    params, opt = init_training(model,
                                torch.Generator(device=dev).manual_seed(0))
    ds = TokenDataset(cfg.vocab_size, 32, 4, seed=1)
    step = make_train_step(model, AdamWConfig(lr=5e-3, warmup_steps=0),
                           in_place=True)
    for _ in range(3):
        params, opt, _ = step(params, opt, ds.next_batch())
    save_checkpoint(str(path), {"params": params, "opt": opt}, step=3,
                    metadata={"data": ds.state()})
    target = {"params": params, "opt": opt}
    loss_a = []
    for _ in range(2):
        params, opt, m = step(params, opt, ds.next_batch())
        loss_a.append(float(m["loss"]))
    tree, s, meta = load_checkpoint(str(path), target=target, device=dev)
    check(s == 3 and all(t.device == dev for t in tree_leaves(tree)),
          "7e: the checkpoint did not load onto the card at step 3")
    ds2 = TokenDataset(cfg.vocab_size, 32, 4, seed=1)
    ds2.restore(meta["data"])
    p_b, o_b = tree["params"], tree["opt"]
    loss_b = []
    for _ in range(2):
        p_b, o_b, m = step(p_b, o_b, ds2.next_batch())
        loss_b.append(float(m["loss"]))
    names = [p for p, _ in _flatten({"params": params, "opt": opt})]
    differ = [nm for nm, a, b in zip(
        names, tree_leaves({"params": params, "opt": opt}),
        tree_leaves({"params": p_b, "opt": o_b})) if not torch.equal(a, b)]
    return differ, loss_a, loss_b


def train_resume(torch, dev):
    """7e: save, load onto the card, continue: bit-identical to the
    uninterrupted run. If an op of the step is not deterministic on the
    card, the run says which leaves differed and repeats the comparison
    under ``torch.use_deterministic_algorithms(True)``."""
    path = ROOT / "build" / "train_smoke" / "resume.ckpt"
    differ, la, lb = resume_run(torch, dev, path)
    mode = "default"
    print(f"phase 7e: checkpoint resume on the card (reduced llama3.2-3b, "
          f"float32): losses {la} uninterrupted, {lb} resumed; "
          f"{len(differ)} leaves differ")
    if differ or la != lb:
        print(f"  not bit-identical in the default mode: {differ[:8]}; "
              "again under torch.use_deterministic_algorithms(True)")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            differ, la, lb = resume_run(torch, dev, path)
        finally:
            torch.use_deterministic_algorithms(False)
        mode = "deterministic algorithms"
    check(not differ and la == lb, f"7e: the resumed run differs from the "
          f"uninterrupted one ({mode}): {differ[:8]}, {la} vs {lb}")
    print(f"  bit-identical ({mode})")
    return {"mode": mode, "losses": la}


def train_entry_point():
    """7f: ``python -m repro_torch.launch.train`` on the card: 3 steps with
    a checkpoint at 3, a rerun to 6 on that directory that resumes at 3,
    and a fresh run to 6 (started beside the first); the resumed run's last
    loss must equal the fresh run's."""
    base = ROOT / "build" / "train_smoke"
    shutil.rmtree(base / "a", ignore_errors=True)
    shutil.rmtree(base / "b", ignore_errors=True)
    env = {**os.environ, "PYTHONPATH": str(SRC)}

    def cmd(steps, d):
        return [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "llama3.2-3b", "--steps", str(steps), "--ckpt-every", "3",
                "--ckpt-dir", str(base / d)]
    print(f"phase 7f: the training entry point: {' '.join(cmd(3, 'a')[1:])}"
          f"; then --steps 6 on it; a fresh --steps 6 beside")
    t0 = time.perf_counter()

    def start(steps, d):
        return subprocess.Popen(cmd(steps, d), cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish(proc, what):
        out, _ = proc.communicate(timeout=300)
        for line in out.strip().splitlines()[-4:]:
            print(f"    {what}: {line}")
        check(proc.returncode == 0, f"7f: {what} exited {proc.returncode}")
        found = re.findall(r"last loss (\S+)$", out, re.M)
        check(len(found) == 1, f"7f: {what} printed no last loss")
        return out, float(found[0])

    first, fresh = start(3, "a"), start(6, "b")
    finish(first, "steps 0..3")
    out_f, loss_f = finish(fresh, "fresh 0..6")
    out_r, loss_r = finish(start(6, "a"), "resumed 3..6")
    check("at step 3" in out_r and "resumed from" in out_r,
          "7f: the rerun did not resume at step 3")
    check("resumed" not in out_f, "7f: the fresh run resumed")
    check(loss_r == loss_f, f"7f: resumed last loss {loss_r!r} vs fresh "
          f"{loss_f!r}")
    secs = time.perf_counter() - t0
    print(f"  resumed at step 3; last loss {loss_r!r} in both; {secs:.1f} s")
    return {"last_loss": loss_r, "seconds": secs}


def train_guard(torch, dev):
    """7g: a kernel wrapper refuses an input that requires grad."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q = torch.randn(1, 128, 8, 64, device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.randn(1, 128, 8, 64, device=dev, dtype=torch.bfloat16)
    raised = None
    try:
        flash_attention(q, k, k)
    except RuntimeError as e:
        raised = str(e)
    check(raised is not None and "forward only" in raised,
          "7g: flash_attention ran on a q that requires grad")
    print(f"phase 7g: flash_attention on the card with a q that requires "
          f"grad raises: {raised}")
    return {"raised": raised}


def run_training(torch, dev):
    """Phase 7. The kernel launch counters are set to 0 before it and must
    read 0 after it: the training path runs the plain versions."""
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.reset_launches()
    out = {"card_vs_cpu": train_card_vs_cpu(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["llama_full"] = train_full_llama(torch, dev)
    out["families"] = train_two_families(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    out["resume"] = train_resume(torch, dev)
    out["entry_point"] = train_entry_point()
    out["guard"] = train_guard(torch, dev)
    launched = {k: v for k, v in {**_build.LAUNCHES,
                                  **_build.PASS_LAUNCHES}.items() if v}
    check(not launched, f"phase 7 launched port kernels: {launched}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  no port kernel launched in phase 7; phase 7 in "
          f"{out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 8: tensor-parallel serving, four shards on one card
# ---------------------------------------------------------------------------

TP_SHARDS = 4
TP_GRANITE_LAYERS = 4          # of granite-34b's 88: the phase's time
TP_MOE_LAYERS = 4              # of phi3.5-moe's 32: the phase's time


def tp_mesh(dev):
    """A (1, TP_SHARDS) mesh whose shards all live on ``dev``."""
    from repro_torch.launch.mesh import make_local_mesh
    return make_local_mesh(1, TP_SHARDS, devices=[dev] * TP_SHARDS)


def tp_teacher_forced(torch, model, params, mesh, dev, prompts, steps,
                      on_tier=None):
    """Kernel-tier paged backends, one device and ``mesh``, on the same
    prompts (512-token chunks), then ``steps`` per-step decodes each fed the
    1-device backend's greedy tokens. ``on_tier(name)`` is called before
    each backend computes ("one" / "mesh"). Returns (worst logits rel_err,
    greedy tokens that match, the mesh backend)."""
    import numpy as np
    from repro_torch.serving.backends import PagedBackend
    bk = {name: PagedBackend(model, params, max_slots=len(prompts),
                             max_len=2048, page_size=64, use_kernel=True,
                             mesh=m, device=dev)
          for name, m in (("one", None), ("mesh", mesh))}
    on_tier = on_tier or (lambda name: None)
    lg = {name: [] for name in bk}
    for sid, pr in enumerate(prompts):
        for name, b in bk.items():
            on_tier(name)
            task = b.start_prefill(f"s{sid}", pr)
            out = None
            while out is None:
                out, _ = b.prefill_chunk(task, 512)
            lg[name].append(out.float().cpu().numpy()[None])
    tok = np.array([int(x.argmax()) for x in lg["one"]])
    agree = 0
    for _ in range(steps):
        for name, b in bk.items():
            on_tier(name)
            lg[name].append(b.decode_batch(tok))
        agree += int((lg["mesh"][-1].argmax(-1)
                      == lg["one"][-1].argmax(-1)).sum())
        tok = lg["one"][-1].argmax(-1)
    worst = max(float(np.abs(m - o).max() / max(np.abs(o).max(), 1e-6))
                for m, o in zip(lg["mesh"], lg["one"]))
    return worst, agree / (steps * len(prompts)), bk["mesh"]


def tp_launch_check(what, launches, expect):
    """Per-shard launches of each kernel against layers x steps x shards
    (``expect``: name -> count; every other kernel 0)."""
    for name, n in launches.items():
        want = expect.get(name, 0)
        check(n == want, f"{what}: {name} launched {n} times, expected "
              f"{want}")


def run_tp_llama(torch, dev, one_device):
    """8a: llama3.2-3b whole on 4 shards of one card, phase 3's settings
    (8 kv heads: 2 a shard, both decode kernels once per shard)."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    cfg = REGISTRY["llama3.2-3b"]
    L, V = cfg.num_layers, cfg.vocab_size
    print(f"phase 8a: {cfg.name} whole on {TP_SHARDS} shards of one card "
          f"(L={L}, {cfg.num_kv_heads} kv heads: "
          f"{cfg.num_kv_heads // TP_SHARDS} a shard)")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    mesh = tp_mesh(dev)
    ecfg = dict(backend="paged", use_kernel=True, page_size=64, max_slots=8,
                max_seq_len=4096, enable_prefix_cache=True,
                chunked_prefill_budget=512, decode_steps_per_sync=8,
                mesh=mesh)
    warm = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                    device=dev)
    drive(torch, warm, make_requests(2, 300, [40, 90], 9, V, seed=9))
    del warm
    torch.cuda.empty_cache()

    # -- main path: phase 3's requests through the fused K=8 path --
    tails = np.linspace(64, 512, 8).astype(int)
    eng = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                   device=dev)
    be = eng.backend
    check(be._kernel_sharded, "8a: the decode kernels are not per shard")
    shapes = [tuple(p["k"].shape) for p in be.pool_shards]
    print(f"  pool shards {shapes}")
    check(all(s[3] == cfg.num_kv_heads // TP_SHARDS for s in shapes),
          "8a: pools not split over the kv heads")
    steps, orig = count_fused_steps(PagedBackend)
    torch.cuda.reset_peak_memory_stats()
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, make_requests(
        8, 1024, tails, 64, V, seed=0))
    launches = dict(_build.LAUNCHES)
    PagedBackend.fused_decode = orig
    check_outputs("8a fused path", outs, 8, 64, V)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "8a: the fused path moved logits to the host")
    hit = eng.cache_stats()["hit_tokens"]
    print(f"  fused path launches {launches}: {sum(steps)} fused decode "
          f"steps x {L} layers x {TP_SHARDS} shards; prefix-cache hit tokens "
          f"{hit} (1 device: {one_device['hit_tokens']})")
    tp_launch_check("8a fused path", launches, {
        "fused_decode_attention": sum(steps) * L * TP_SHARDS})
    check(hit == one_device["hit_tokens"], "8a: prefix-cache hit tokens "
          "differ from the 1-device run")
    metrics = {
        "prefill_tok_s": eng.stats["prefill_tokens"] / t_pf,
        "decode_tok_s": n_dec / t_dec if t_dec else float("nan"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "hit_tokens": hit, "fused_steps": sum(steps),
        "launches_fused": launches}
    print(f"  prefill {metrics['prefill_tok_s']:.1f} tokens/s, decode-only "
          f"steps {metrics['decode_tok_s']:.1f} tokens/s (1 device, phase "
          f"3: {one_device['prefill_tok_s']:.1f} / "
          f"{one_device['decode_tok_s']:.1f}); peak memory "
          f"{metrics['peak_mem_gib']:.2f} GiB (the unsharded weights kept "
          f"for the comparison included)")
    del eng, be
    torch.cuda.empty_cache()
    tp = profile_decode(torch, ContinuousBatchingEngine(
        model, params, EngineConfig(**ecfg), device=dev),
        make_requests(8, 1024, tails, 64, V, seed=3))
    metrics.update({f"tp_{k}": v for k, v in tp.items()})
    print(f"  decode step: {tp['decode_step_wall_ms']:.3f} ms on the host "
          f"clock, device "
          + (f"{tp['decode_step_device_ms']:.3f}" if
             tp["decode_step_device_ms"] else "not measured")
          + f" ms (1 device, phase 3: {one_device['decode_step_wall_ms']:.3f}"
          f" / " + (f"{one_device['decode_step_device_ms']:.3f}" if
                    one_device["decode_step_device_ms"] else "not measured")
          + " ms)")
    torch.cuda.empty_cache()

    # -- per-step path: paged_attention once per shard and layer --
    eng = ContinuousBatchingEngine(
        model, params, EngineConfig(**dict(ecfg, fused_decode=False)),
        device=dev)
    calls = []
    wrap(eng.backend, "decode_batch",
         lambda fn, *a: (calls.append(1), fn(*a))[1])
    _build.reset_launches()
    outs2, _, _, _ = drive(torch, eng, make_requests(2, 300, [40, 90], 16, V,
                                                     seed=1))
    step_launches = dict(_build.LAUNCHES)
    check_outputs("8a per-step path", outs2, 2, 16, V)
    print(f"  per-step path launches {step_launches}: {len(calls)} steps x "
          f"{L} layers x {TP_SHARDS} shards")
    tp_launch_check("8a per-step path", step_launches, {
        "paged_attention": len(calls) * L * TP_SHARDS})
    metrics["launches_per_step"] = step_launches
    del eng
    torch.cuda.empty_cache()

    # -- teacher-forced: mesh kernel tier against 1-device kernel tier --
    rng = np.random.default_rng(2)
    worst, share, _ = tp_teacher_forced(
        torch, model, params, mesh, dev,
        [rng.integers(2, V, size=n).tolist() for n in (700, 530)], 16)
    print(f"  teacher-forced (700 / 530-token prompts, 16 decode steps): "
          f"mesh vs 1 device logits rel_err {worst:.3e} (tolerance "
          f"{LOGITS_TOL}); greedy tokens that match {share:.3f}")
    check(worst <= LOGITS_TOL, "8a: mesh logits disagree with 1 device")
    metrics.update(teacher_forced_rel_err=worst, greedy_match_share=share)
    del params
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 8a in {metrics['phase_s']:.1f} s")
    return metrics


def run_tp_granite(torch, dev):
    """8b: granite-34b at full width, TP_GRANITE_LAYERS layers, on 4 shards
    (one kv head: the cache splits over head_dim, the plain path
    serves)."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    full = REGISTRY["granite-34b"]
    cfg = dataclasses.replace(full, num_layers=TP_GRANITE_LAYERS)
    L, V = cfg.num_layers, cfg.vocab_size
    print(f"phase 8b: {cfg.name} at full width, {L} of {full.num_layers} "
          f"layers, on {TP_SHARDS} shards (d={cfg.d_model} "
          f"H={cfg.num_heads}/{cfg.num_kv_heads} hd={cfg.head_dim} "
          f"ff={cfg.d_ff}): head_dim split")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    mesh = tp_mesh(dev)
    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        **dict(FAMILY_ENGINE, mesh=mesh)), device=dev)
    be = eng.backend
    shapes = [tuple(p["k"].shape) for p in be.pool_shards]
    print(f"  _kernel_sharded {be._kernel_sharded}; pool shards {shapes}")
    check(not be._kernel_sharded, "8b: one kv head cannot split 4 ways")
    check(all(s[3:] == (1, cfg.head_dim // TP_SHARDS) for s in shapes),
          "8b: pool shards are not (..., 1, head_dim / 4)")
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, make_requests(
        4, 512, [64, 128, 192, 256], 16, V, seed=4, model=cfg.name))
    launches = dict(_build.LAUNCHES)
    check_outputs("8b", outs, 4, 16, V)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "8b: the fused path moved logits to the host")
    print(f"  4 requests: launches {launches} (the plain head_dim-split "
          f"path); decode-only steps {n_dec / t_dec:.1f} tokens/s")
    tp_launch_check("8b", launches, {})
    del eng, be
    torch.cuda.empty_cache()
    rng = np.random.default_rng(3)
    worst, share, _ = tp_teacher_forced(
        torch, model, params, mesh, dev,
        [rng.integers(2, V, size=n).tolist() for n in (900, 611)], 8)
    print(f"  teacher-forced (900 / 611-token prompts, 8 decode steps): "
          f"mesh vs 1 device logits rel_err {worst:.3e} (tolerance "
          f"{LOGITS_TOL}); greedy tokens that match {share:.3f}")
    check(worst <= LOGITS_TOL, "8b: mesh logits disagree with 1 device")
    del params
    torch.cuda.empty_cache()
    metrics = {"teacher_forced_rel_err": worst, "greedy_match_share": share,
               "decode_tok_s": n_dec / t_dec, "launches": launches,
               "pool_shard_shape": list(shapes[0]),
               "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 8b in {metrics['phase_s']:.1f} s")
    return metrics


def run_tp_moe(torch, dev):
    """8c: phi3.5-moe at full width, TP_MOE_LAYERS layers, on 4 shards: 4
    of the 16 experts a shard, the router replicated; the kernel tier
    routed by the 1-device run's decisions against the 1-device run, and
    the free runs' routing flips reported."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    full = REGISTRY["phi3.5-moe-42b-a6.6b"]
    cfg = dataclasses.replace(full, num_layers=TP_MOE_LAYERS)
    L, V, E, k = cfg.num_layers, cfg.vocab_size, cfg.moe.num_experts, \
        cfg.moe.top_k
    print(f"phase 8c: {cfg.name} at full width, {L} of {full.num_layers} "
          f"layers, on {TP_SHARDS} shards: {E // TP_SHARDS} of {E} experts a "
          f"shard, router replicated")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    mesh = tp_mesh(dev)
    eng = ContinuousBatchingEngine(model, params, EngineConfig(
        **dict(FAMILY_ENGINE, mesh=mesh)), device=dev)
    shards = eng.backend.stack.params
    w1 = [s["layers"]["moe"]["w1"].shape for s in shards]
    print(f"  expert stacks per shard {[tuple(s) for s in w1]}")
    check(all(s[1] == E // TP_SHARDS for s in w1), "8c: experts not split")
    check(all(s["layers"]["moe"]["router"] is params["layers"]["moe"]
              ["router"] for s in shards), "8c: router not replicated")
    steps, orig = count_fused_steps(PagedBackend)
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, _, t_dec, n_dec = drive(torch, eng, make_requests(
        4, 512, [64, 128, 192, 256], 16, V, seed=4, model=cfg.name))
    launches = dict(_build.LAUNCHES)
    PagedBackend.fused_decode = orig
    check_outputs("8c", outs, 4, 16, V)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "8c: the fused path moved logits to the host")
    print(f"  4 requests: launches {launches}: {sum(steps)} fused decode "
          f"steps x {L} layers x {TP_SHARDS} shards; decode-only steps "
          f"{n_dec / t_dec:.1f} tokens/s")
    tp_launch_check("8c", launches, {
        "fused_decode_attention": sum(steps) * L * TP_SHARDS})
    del eng, shards
    torch.cuda.empty_cache()

    # -- teacher-forced: free runs, then the mesh routed by the 1-device
    # run's top-k decisions, call by call (as phase 6a) --
    log = {"on": None, "force": False}
    orig_routing = moe_mod._routing

    def routing(x, p, c):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        calls = log.setdefault(log["on"], [])
        calls.append(probs.reshape(-1, E))
        if not log["force"] or log["on"] != "mesh":
            return orig_routing(x, p, c)
        ref = log["one"][len(calls) - 1]
        idx = moe_mod._top_k(ref, k)[1].reshape(*probs.shape[:-1], k)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return (torch.zeros_like(probs).scatter(-1, idx, gates), gates, idx,
                torch.zeros((), device=x.device))

    def tier(name):
        log["on"] = name

    moe_mod._routing = routing
    prompts = [np.random.default_rng(2).integers(2, V, size=1500).tolist()]
    try:
        free, agree, _ = tp_teacher_forced(torch, model, params, mesh, dev,
                                           prompts, 8, on_tier=tier)
        n_route, flips, by_layer = routing_flips(torch, log["mesh"],
                                                 log["one"], k, L)
        log.clear()
        log.update(on=None, force=True)
        forced, _, _ = tp_teacher_forced(torch, model, params, mesh, dev,
                                         prompts, 8, on_tier=tier)
        _, fflips, _ = routing_flips(torch, log["mesh"], log["one"], k, L)
    finally:
        moe_mod._routing = orig_routing
    print(f"  teacher-forced, free runs (1500-token prompt + 8 decode "
          f"steps): mesh vs 1 device logits rel_err {free:.3e}; greedy "
          f"tokens that match {agree:.3f}; routing: {len(flips)} of "
          f"{n_route} (token, layer) top-{k} sets differ, by layer "
          f"{by_layer}, margins "
          f"{[f'{m:.2e} (rounding {r:.2e})' for m, r in flips[:8]]}")
    print(f"  teacher-forced, the mesh routed by the 1-device decisions: "
          f"logits rel_err {forced:.3e} (tolerance {LOGITS_TOL}); "
          f"{len(fflips)} decisions where its own top-{k} would differ, "
          f"margins {[f'{m:.2e} (rounding {r:.2e})' for m, r in fflips[:8]]}")
    check(all(m <= 2 * r for m, r in fflips), "8c: under the same routing "
          "a top-k decision differs by more than twice the rounding")
    check(forced <= LOGITS_TOL, "8c: under the same routing the mesh logits "
          "disagree with 1 device")
    del params
    torch.cuda.empty_cache()
    metrics = {"free_run_rel_err": free, "forced_routing_rel_err": forced,
               "routing_decisions": n_route, "routing_flips": len(flips),
               "forced_would_flip": len(fflips), "greedy_match_share": agree,
               "decode_tok_s": n_dec / t_dec, "launches": launches,
               "phase_s": time.perf_counter() - t_phase}
    print(f"  phase 8c in {metrics['phase_s']:.1f} s")
    return metrics


TP_HYBRID_LENS = (200, 300, 512, 777, 1024, 1300, 1800, 2048)  # phase 4's
TP_HYBRID_TOKENS = 16          # new tokens a request: two fused K=8 calls
TP_SSM_LENS = (200, 512, 1024, 2048)


def run_tp_hybrid(torch, dev, one_device):
    """8d: zamba2-2.7b whole on 4 shards with the kernel tier (``ssd`` and
    ``flash_attention`` once per shard), then mamba2-130m whole on the same
    mesh; each teacher-forced against its 1-device kernel tier."""
    from repro_torch.configs import REGISTRY
    from repro_torch.kernels import _build
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    cfg = REGISTRY["zamba2-2.7b"]
    L, V, G = cfg.num_layers, cfg.vocab_size, \
        cfg.num_layers // cfg.attn_every
    cols = 2 * cfg.d_inner + 2 * cfg.ssm.d_state + cfg.ssm_heads
    print(f"phase 8d: {cfg.name} whole on {TP_SHARDS} shards of one card "
          f"(L={L}, in_proj {cols} columns, out_proj {cfg.d_inner} rows, "
          f"shared attention {cfg.num_heads // TP_SHARDS} of "
          f"{cfg.num_heads} heads a shard)")
    t_phase = time.perf_counter()
    laps = {}

    def lap(name):
        """Seconds since the previous lap, kept under ``name``."""
        laps[name] = time.perf_counter() - t_phase - sum(laps.values())
        return f"({laps[name]:.1f} s)"

    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    mesh = tp_mesh(dev)
    ecfg = dict(backend="slots", use_kernel=True, max_slots=8,
                max_seq_len=4096, decode_steps_per_sync=8, mesh=mesh)

    def requests(lens, max_tokens, seed, vocab=V, name=cfg.name):
        return make_requests(len(lens), 0, lens, max_tokens, vocab, seed,
                             model=name)

    # -- main path: phase 4's prompts one-shot on the shards, fused K=8 --
    eng = ContinuousBatchingEngine(model, params, EngineConfig(**ecfg),
                                   device=dev)
    be = eng.backend
    shapes = {k: tuple(t.shape) for k, t in be.cache_shards[0].items()}
    print(f"  cache shard {shapes}; in_proj shard "
          f"{tuple(be.stack.layers[0][0]['mamba']['in_proj'].shape)}")
    check(all(c["ssm"].shape[2] == cfg.ssm_heads
              and c["k"].shape[2] == cfg.num_kv_heads // TP_SHARDS
              for c in be.cache_shards),
          "8d: the ssm state is not whole or k/v not split over the heads")
    check(len({c["ssm"].data_ptr() for c in be.cache_shards}) == TP_SHARDS,
          "8d: the shards share one ssm state")
    steps = count_decode_steps(be)
    torch.cuda.reset_peak_memory_stats()
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, t_pf, t_dec, n_dec = drive(torch, eng, requests(
        TP_HYBRID_LENS, TP_HYBRID_TOKENS, 4))
    launches = dict(_build.LAUNCHES)
    passes = dict(_build.PASS_LAUNCHES)
    n = len(TP_HYBRID_LENS)
    check_outputs("8d", outs, n, TP_HYBRID_TOKENS, V)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "8d: the fused path moved logits to the host")
    print(f"  main path launches {launches}: {n} prompts x {L} layers x "
          f"{TP_SHARDS} shards (ssd), x {G} shared-block applications "
          f"(flash_attention), {steps['n']} decode steps x {G} x "
          f"{TP_SHARDS} (slot_decode_attention); ssd passes {passes} "
          f"{lap('main')}")
    tp_launch_check("8d", launches, {
        "ssd": n * L * TP_SHARDS, "flash_attention": n * G * TP_SHARDS,
        "slot_decode_attention": steps["n"] * G * TP_SHARDS,
        "mixer_decode": steps["n"] * L * TP_SHARDS})
    check(all(passes[k] == launches["ssd"] for k in (
        "ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan"))
        and passes["ssd_fma"] == 0,
        "8d: the bf16 ssd calls did not launch each of their passes once")
    metrics = {
        "prefill_tok_s": eng.stats["prefill_tokens"] / t_pf,
        "decode_tok_s": n_dec / t_dec if t_dec else float("nan"),
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": launches}
    print(f"  prefill {metrics['prefill_tok_s']:.1f} tokens/s (1 device, "
          f"phase 4: {one_device['prefill_tok_s']:.1f}); peak memory "
          f"{metrics['peak_mem_gib']:.2f} GiB (the unsharded weights kept "
          f"for the comparison included)")
    del eng, be
    torch.cuda.empty_cache()
    tp = profile_decode(torch, ContinuousBatchingEngine(
        model, params, EngineConfig(**ecfg), device=dev),
        requests(TP_HYBRID_LENS, 64, 3), steps=1)
    metrics.update({f"tp_{k}": v for k, v in tp.items()})
    gc.collect()

    def ms(x):
        return "not measured" if x is None else f"{x:.3f}"
    print(f"  decode step: {tp['decode_step_wall_ms']:.3f} ms on the host "
          f"clock, device {ms(tp['decode_step_device_ms'])} ms, idle "
          f"{ms(tp['device_idle_share'])} (1 device, phase 4: "
          f"{one_device['decode_step_wall_ms']:.3f} / "
          f"{ms(one_device['decode_step_device_ms'])} ms, idle "
          f"{ms(one_device['device_idle_share'])}) {lap('window')}")
    torch.cuda.empty_cache()

    # -- teacher-forced: mesh kernel tier against 1-device kernel tier, on
    # phase 4's prompts and steps, held to phase 4's rule with the plain
    # tier's spread phase 4 measured on the same weights --
    import numpy as np
    rng = np.random.default_rng(2)
    worst, share, ties = teacher_forced(
        slot_tiers(dev, [("one", model, True, None),
                         ("mesh", model, True, mesh)], params, 2),
        [rng.integers(2, V, size=k).tolist() for k in (512, 2048)], 16,
        "mesh", "one")
    worst = worst("mesh", "one")
    spread = one_device["plain_spread_rel_err"]
    tol = max(LOGITS_TOL, SPREAD_FACTOR * spread)
    print(f"  teacher-forced (512 / 2048-token prompts, 16 decode steps): "
          f"mesh vs 1 device logits rel_err {worst:.3e}; tolerance "
          f"max({LOGITS_TOL}, {SPREAD_FACTOR} x phase 4's plain spread "
          f"{spread:.3e}) = {tol:.3e}; greedy tokens that match "
          f"{share:.3f} ({ties} ties within the error) "
          f"{lap('teacher_forced')}")
    check(worst <= tol, "8d: mesh logits disagree with 1 device")
    metrics.update(teacher_forced_rel_err=worst, tolerance=tol,
                   greedy_match_share=share)
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # -- mamba2-130m whole on the same mesh --
    scfg = REGISTRY["mamba2-130m"]
    SL, SV = scfg.num_layers, scfg.vocab_size
    print(f"phase 8d: {scfg.name} whole on {TP_SHARDS} shards (L={SL}, "
          f"d={scfg.d_model}, ssm heads={scfg.ssm_heads}x"
          f"{scfg.ssm.head_dim} n={scfg.ssm.d_state})")
    smodel = make_model(scfg)
    sparams = smodel.init_params(torch.Generator(device=dev).manual_seed(0))
    eng = ContinuousBatchingEngine(smodel, sparams, EngineConfig(**ecfg),
                                   device=dev)
    ssteps = count_decode_steps(eng.backend)
    backends.reset_transfer_stats()
    _build.reset_launches()
    outs, _, _, _ = drive(torch, eng, requests(TP_SSM_LENS, TP_HYBRID_TOKENS,
                                               6, SV, scfg.name))
    slaunches = dict(_build.LAUNCHES)
    check_outputs("8d mamba2", outs, len(TP_SSM_LENS), TP_HYBRID_TOKENS, SV)
    check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
          "8d mamba2: the fused path moved logits to the host")
    print(f"  launches {slaunches}: {len(TP_SSM_LENS)} prompts x {SL} layers "
          f"x {TP_SHARDS} shards {lap('mamba2_main')}")
    tp_launch_check("8d mamba2", slaunches,
                    {"ssd": len(TP_SSM_LENS) * SL * TP_SHARDS,
                     "mixer_decode": ssteps["n"] * SL * TP_SHARDS})
    del eng
    floor = make_model(dataclasses.replace(
        scfg, ssm=dataclasses.replace(scfg.ssm, chunk=128)))
    sworst, sshare, sties = teacher_forced(
        slot_tiers(dev, [("one", smodel, True, None),
                         ("mesh", smodel, True, mesh),
                         ("plain", smodel, False, None),
                         ("floor", floor, False, None)], sparams, 2),
        [rng.integers(2, SV, size=k).tolist() for k in (512, 2048)], 16,
        "mesh", "one")
    sworst, sspread = sworst("mesh", "one"), sworst("floor", "plain")
    stol = max(LOGITS_TOL, SPREAD_FACTOR * sspread)
    print(f"  teacher-forced: mesh vs 1 device logits rel_err "
          f"{sworst:.3e}; plain tier's own spread {sspread:.3e}; tolerance "
          f"{stol:.3e}; greedy tokens that match {sshare:.3f} ({sties} ties "
          f"within the error) {lap('mamba2_teacher_forced')}")
    check(sworst <= stol, "8d mamba2: mesh logits disagree with 1 device")
    metrics["mamba2"] = {"launches": slaunches,
                         "teacher_forced_rel_err": sworst,
                         "plain_spread_rel_err": sspread, "tolerance": stol,
                         "greedy_match_share": sshare}
    del sparams
    torch.cuda.empty_cache()
    metrics["phase_s"] = time.perf_counter() - t_phase
    metrics["laps_s"] = laps
    print(f"  phase 8d in {metrics['phase_s']:.1f} s")
    return metrics


FSDP_LAYERS = 3                # of dbrx-132b's 40: 22.02 GB of bf16 weights,
#                                above the serving rule's 8 GiB a model shard
#                                at M = 2 (2 layers, 15.5 GB, would not be)
FSDP_LENS = (256, 341, 427, 512)     # linspace(256, 512, 4)
FSDP_TOKENS = 16               # new tokens a request: two fused K=8 calls


def position_bytes(shards):
    """Weight bytes each mesh position (d, m) holds: model shard m's
    tensors on (0, m), slice d of a data-split leaf on (d, m)."""
    from repro_torch.distributed.sharding import DataSlices
    got = {}
    for m, tree in enumerate(shards):
        for x in leaves(tree):
            for d, p in enumerate(x.parts if isinstance(x, DataSlices)
                                  else [x]):
                got[(d, m)] = got.get((d, m), 0) + p.numel() \
                    * p.element_size()
    return got


def spec_bytes(sh, params):
    """(the bytes each position (d, m) should hold by the serving specs,
    the bytes one forward gathers, the gathers one forward makes): a
    model-split leaf's 1/M on (0, m), a data-split leaf's 1/(M D) on every
    (d, m), a replicated leaf whole on every (0, m)."""
    from repro_torch.distributed.sharding import _axis_dim
    from repro_torch.tree import tree_leaves
    D, M = sh.data_shards, sh.model_shards
    want = {(d, m): 0 for d in range(D) for m in range(M)}
    specs = sh.rules.param_specs(params)
    gathered = 0
    for name in params:
        for x, spec in zip(tree_leaves(params[name]),
                           tree_leaves(specs[name])):
            n = x.numel() * x.element_size()
            if _axis_dim(spec, "model") is not None:
                n //= M
            split = D > 1 and _axis_dim(spec, "data") is not None
            gathered += n * M if split else 0
            for d, m in want:
                want[(d, m)] += n // D if split else (n if d == 0 else 0)
    per_layer = sum(_axis_dim(s, "data") is not None
                    for s in tree_leaves(specs["layers"])) if D > 1 else 0
    top = sum(_axis_dim(specs[k], "data") is not None
              for k in ("embed", "lm_head") if k in specs) if D > 1 else 0
    calls = (per_layer * sh.cfg.num_layers + top) * M
    return want, gathered, calls


def fsdp_tiers(torch, model, params, dev, tiers, prompts, steps):
    """Kernel-tier paged backends built one at a time (``tiers``: name ->
    mesh, the first one None), each fed the same prompts (512-token
    chunks) and then ``steps`` per-step decodes of the first tier's greedy
    tokens, the MoE routing of every later tier forced to the first
    tier's decisions (as phase 8c). Returns (name -> list of float32
    logits arrays, the gather calls and bytes of the last tier's first
    decode forward)."""
    import numpy as np
    from repro_torch.distributed import sharding
    from repro_torch.models import moe as moe_mod
    from repro_torch.serving.backends import PagedBackend
    moe = model.cfg.moe
    E, k = (moe.num_experts, moe.top_k) if moe else (0, 0)
    first = next(iter(tiers))
    log = {"on": first, "calls": 0, first: []}
    orig_routing = moe_mod._routing

    def routing(x, p, c):
        probs = torch.softmax(x.float() @ p["router"], dim=-1)
        if log["on"] == first:
            log[first].append(probs.reshape(-1, E))
            return orig_routing(x, p, c)
        ref = log[first][log["calls"]]
        log["calls"] += 1
        idx = moe_mod._top_k(ref, k)[1].reshape(*probs.shape[:-1], k)
        gates = probs.gather(-1, idx)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        return (torch.zeros_like(probs).scatter(-1, idx, gates), gates, idx,
                torch.zeros((), device=x.device))

    lg, feed, gathers = {}, [], None
    moe_mod._routing = routing
    try:
        for name, mesh in tiers.items():
            log.update(on=name, calls=0)
            b = PagedBackend(model, params, max_slots=len(prompts),
                             max_len=2048, page_size=64, use_kernel=True,
                             mesh=mesh, device=dev)
            out = []
            for sid, pr in enumerate(prompts):
                task = b.start_prefill(f"s{sid}", pr)
                x = None
                while x is None:
                    x, _ = b.prefill_chunk(task, 512)
                out.append(x.float().cpu().numpy()[None])
            tok = np.array([int(x.argmax()) for x in out])
            for j in range(steps):
                if name == first:
                    feed.append(tok)
                sharding.reset_gather_stats()
                out.append(b.decode_batch(feed[j]))
                if j == 0:
                    gathers = dict(sharding.GATHER_STATS)
                tok = out[-1].argmax(-1)
            lg[name] = out
            del b
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        moe_mod._routing = orig_routing
    return lg, gathers


def fsdp_first_difference(torch, stack, params, dev):
    """Where a (2, 2) stack first departs from the (1, 2) arithmetic:
    layer 0's gathered weights of each model shard against the (1, 2)
    shard's (the whole weight's chunk), then each weight's product with
    the same activations. Returns a list of findings (empty: none)."""
    from repro_torch.distributed.sharding import _model_dim
    sh = stack.shard
    whole = {k: v[0] for k, v in _flat(params["layers"]).items()}
    specs = _flat(sh.rules.param_specs(params)["layers"])
    g = torch.Generator(device=dev).manual_seed(5)
    found = []
    for s in range(stack.n):
        got = _flat(stack._lp(s, 0))
        for path, w in got.items():
            md = _model_dim(specs[path])
            ref = whole[path] if md is None else \
                whole[path].chunk(stack.n, dim=md - 1)[s].contiguous()
            if not torch.equal(w, ref):
                found.append(f"shard {s} {path}: gathered weight differs")
                continue
            if w.dim() >= 2:
                x = torch.randn((8, w.shape[-2]), generator=g, device=dev,
                                dtype=w.dtype)
                if not torch.equal(x @ w, x @ ref):
                    found.append(f"shard {s} {path}: equal weights, the "
                                 f"products differ")
    return found


def _flat(tree, path=""):
    """{"a/b": leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in _flat(t, f"{path}/{n}" if path else n).items()}
    return {path: tree}


def run_tp_fsdp(torch, dev):
    """8e: dbrx-132b at full width, FSDP_LAYERS layers, served on a (1, 2)
    mesh and then on a (2, 2) mesh of the one card, where the serving
    rule's own threshold splits its weights over ``data`` too (FSDP at
    serve): the same tokens, bit-identical teacher-forced logits, (1, 2)
    against one device, each position's weight bytes against the specs,
    the gathers a forward, decode steps and peak memory."""
    import numpy as np
    from repro_torch.configs import REGISTRY
    from repro_torch.distributed import sharding
    from repro_torch.distributed.sharding import ServeSharding
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import make_model
    from repro_torch.serving import backends
    from repro_torch.serving.backends import PagedBackend
    from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                            EngineConfig)

    full = REGISTRY["dbrx-132b"]
    cfg = dataclasses.replace(full, num_layers=FSDP_LAYERS)
    L, V, M = cfg.num_layers, cfg.vocab_size, 2
    pbytes = sharding.param_bytes(cfg)
    print(f"phase 8e: {cfg.name} at full width, {L} of {full.num_layers} "
          f"layers (d={cfg.d_model} H={cfg.num_heads}/{cfg.num_kv_heads} "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} "
          f"ff={cfg.d_ff} V={V}): {pbytes / 1e9:.2f} GB of bf16 weights, "
          f"{pbytes / M / 2 ** 30:.2f} GiB a model shard at M={M} against "
          f"the serving rule's {sharding.SERVE_FSDP_BYTES / 2 ** 30:.0f} "
          f"GiB")
    check(sharding.needs_serve_fsdp(cfg, M), "8e: the serving rule does not "
          "split the weights over data at M = 2")
    t_phase = time.perf_counter()
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    meshes = {"1x2": make_local_mesh(1, M, devices=[dev] * M),
              "2x2": make_local_mesh(2, M, devices=[dev] * 2 * M)}
    ecfg = dict(FAMILY_ENGINE, max_slots=4, max_seq_len=2048)
    out = {"param_bytes": pbytes}
    streams = {}
    for name, mesh in meshes.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        eng = ContinuousBatchingEngine(model, params, EngineConfig(
            **dict(ecfg, mesh=mesh)), device=dev)
        be = eng.backend
        built = torch.cuda.memory_allocated() - base
        sh = be.shard
        have = position_bytes(be.stack.params)
        want, gathered, calls = spec_bytes(sh, params)
        print(f"  {name}: weight bytes by position (d, m) "
              + ", ".join(f"{p}: {have.get(p, 0) / 1e9:.3f} GB (specs "
                          f"{want[p] / 1e9:.3f})" for p in sorted(want))
              + f"; the engine's build allocated {built / 1e9:.2f} GB; data "
              f"split {be.stack._fsdp}")
        check(have == want, f"8e {name}: weight bytes by position differ "
              f"from the specs'")
        check(be.stack._fsdp == (name == "2x2"), f"8e {name}: the data "
              f"split is {be.stack._fsdp}")
        check(be._kernel_sharded, f"8e {name}: decode kernels not per shard")
        steps, orig = count_fused_steps(PagedBackend)
        backends.reset_transfer_stats()
        sharding.reset_gather_stats()
        _build.reset_launches()
        try:
            outs, t_pf, t_dec, n_dec = drive(torch, eng, make_requests(
                len(FSDP_LENS), 0, FSDP_LENS, FSDP_TOKENS, V, seed=8,
                model=cfg.name))
        finally:
            PagedBackend.fused_decode = orig
        launches = dict(_build.LAUNCHES)
        drive_gathers = dict(sharding.GATHER_STATS)
        check_outputs(f"8e {name}", outs, len(FSDP_LENS), FSDP_TOKENS, V)
        check(backends.TRANSFER_STATS["decode_logits_transfers"] == 0,
              f"8e {name}: the fused path moved logits to the host")
        tp_launch_check(f"8e {name}", launches, {
            "fused_decode_attention": sum(steps) * L * M})
        streams[name] = ({o.request_id: o.output_tokens for o in outs},
                         dict(eng.stats))
        peak = torch.cuda.max_memory_allocated()
        print(f"  {name}: {len(FSDP_LENS)} requests, launches {launches} "
              f"({sum(steps)} fused decode steps x {L} layers x {M} "
              f"shards); gathers {drive_gathers['calls']} "
              f"({drive_gathers['bytes'] / 1e9:.2f} GB); prefill "
              f"{eng.stats['prefill_tokens'] / t_pf:.1f} tokens/s; peak "
              f"memory {peak / 2 ** 30:.2f} GiB (the unsharded weights "
              f"kept for the comparison included)")
        del eng, be
        gc.collect()
        torch.cuda.empty_cache()
        tp = profile_decode(torch, ContinuousBatchingEngine(
            model, params, EngineConfig(**dict(ecfg, mesh=mesh)),
            device=dev), make_requests(len(FSDP_LENS), 0, FSDP_LENS, 64, V,
                                       seed=3, model=cfg.name), steps=1)
        out[name] = {"launches": launches, "fused_steps": sum(steps),
                     "position_bytes": {f"{d},{m}": b
                                        for (d, m), b in have.items()},
                     "build_bytes": built, "peak_mem_gib": peak / 2 ** 30,
                     "drive_gathers": drive_gathers,
                     "predicted_gather_calls": calls,
                     "predicted_gather_bytes": gathered,
                     "decode_step_wall_ms": tp["decode_step_wall_ms"],
                     "decode_step_device_ms": tp["decode_step_device_ms"],
                     "device_idle_share": tp["device_idle_share"]}

    def ms(x):
        return "not measured" if x is None else f"{x:.3f}"
    a, b = out["1x2"], out["2x2"]
    ratio = (b["decode_step_device_ms"] / a["decode_step_device_ms"]
             if a["decode_step_device_ms"] and b["decode_step_device_ms"]
             else None)
    print(f"  decode step (4 sequences, K=8): 1x2 "
          f"{a['decode_step_wall_ms']:.3f} ms host clock / "
          f"{ms(a['decode_step_device_ms'])} ms device; 2x2 "
          f"{b['decode_step_wall_ms']:.3f} / {ms(b['decode_step_device_ms'])}"
          f" ms; device ratio {ms(ratio)} (predicted 2 to 3.5)")
    check(streams["1x2"] == streams["2x2"], "8e: the (2, 2) engine's "
          "tokens or stats differ from the (1, 2) engine's")
    gc.collect()
    torch.cuda.empty_cache()

    # -- teacher-forced: one device, (1, 2), (2, 2), each routed by the
    # 1-device decisions --
    rng = np.random.default_rng(2)
    prompts = [rng.integers(2, V, size=n).tolist() for n in (700, 530)]
    lg, gathers = fsdp_tiers(torch, model, params, dev, {
        "one": None, **meshes}, prompts, 8)
    worst = max(float(np.abs(m - o).max() / max(np.abs(o).max(), 1e-6))
                for m, o in zip(lg["1x2"], lg["one"]))
    same = all(np.array_equal(x, y) for x, y in zip(lg["2x2"], lg["1x2"]))
    first_diff = []
    if not same:
        worst22 = max(float(np.abs(m - o).max() / max(np.abs(o).max(), 1e-6))
                      for m, o in zip(lg["2x2"], lg["1x2"]))
        be = PagedBackend(model, params, max_slots=1, max_len=128,
                          page_size=64, use_kernel=True, mesh=meshes["2x2"],
                          device=dev)
        first_diff = fsdp_first_difference(torch, be.stack, params, dev)
        del be
        print(f"  teacher-forced: (2, 2) logits NOT bit-identical to (1, 2): "
              f"rel_err {worst22:.3e}; first difference: "
              f"{first_diff or 'none in layer 0 weights or products'}")
        check(worst22 <= LOGITS_TOL, "8e: (2, 2) logits disagree with (1, 2)")
    want_calls = out["2x2"]["predicted_gather_calls"]
    want_bytes = out["2x2"]["predicted_gather_bytes"]
    print(f"  teacher-forced (700 / 530-token prompts, 8 decode steps, the "
          f"routing of the 1-device run): (2, 2) vs (1, 2) logits "
          f"{'bit-identical' if same else 'differ'}; (1, 2) vs 1 device "
          f"rel_err {worst:.3e} (tolerance {LOGITS_TOL}); a (2, 2) decode "
          f"forward gathers {gathers['calls']} times, "
          f"{gathers['bytes'] / 1e9:.3f} GB (specs: {want_calls}, "
          f"{want_bytes / 1e9:.3f} GB)")
    check(worst <= LOGITS_TOL, "8e: (1, 2) logits disagree with 1 device")
    check(gathers == {"calls": want_calls, "bytes": want_bytes},
          "8e: the gathers of a forward differ from the specs'")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out.update(bit_identical=same, first_difference=first_diff,
               teacher_forced_rel_err=worst, decode_device_ratio=ratio,
               forward_gathers=gathers,
               launches={"fused_decode_attention": sum(
                   out[n]["launches"]["fused_decode_attention"]
                   for n in meshes)},
               phase_s=time.perf_counter() - t_phase)
    print(f"  phase 8e in {out['phase_s']:.1f} s")
    return out


def run_tensor_parallel(torch, dev, one_device, one_device_hybrid):
    """Phase 8: the five parts, each after the previous one's weights are
    freed."""
    out = {}
    for name, run in (("llama", lambda: run_tp_llama(torch, dev, one_device)),
                      ("granite", lambda: run_tp_granite(torch, dev)),
                      ("moe", lambda: run_tp_moe(torch, dev)),
                      ("hybrid", lambda: run_tp_hybrid(torch, dev,
                                                       one_device_hybrid)),
                      ("fsdp", lambda: run_tp_fsdp(torch, dev))):
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = run()
    return out


# ---------------------------------------------------------------------------
# phase 9: the control plane and the cost model on the card
# ---------------------------------------------------------------------------

COLLECTIVE_SHAPE = (8, 3072)     # a decode step's activations, llama3.2-3b
COLLECTIVE_CALLS = 200


def fit_overheads(s8, r8, s1, r1):
    """``dispatch`` and ``host_sync`` (ms) of ``step(K) = roofline +
    dispatch + host_sync / K`` through the K = 8 and K = 1 windows'
    measured host-clock steps ``s`` and roofline terms ``r``. A sync
    cannot cost less than nothing: where the K = 1 step is not the longer
    one, the least-squares fit with ``host_sync >= 0`` is ``host_sync =
    0`` and ``dispatch`` the mean of the two windows' overheads."""
    host_sync = (s1 - r1 - (s8 - r8)) * 8 / 7
    if host_sync < 0:
        return ((s8 - r8) + (s1 - r1)) / 2, 0.0
    return s8 - r8 - host_sync / 8, host_sync


def collective_ms(torch, dev):
    """Median host-clock time of ``ServeSharding.all_reduce`` over four
    shards on the one card (the port's reduce: copy to the lead device and
    sum in float32, not NCCL), with the sum checked."""
    from repro_torch.configs import REGISTRY
    from repro_torch.distributed.sharding import ServeSharding
    sh = ServeSharding(tp_mesh(dev), REGISTRY["llama3.2-3b"])
    g = torch.Generator(device=dev).manual_seed(9)
    parts = [torch.randn(COLLECTIVE_SHAPE, generator=g, device=dev,
                         dtype=torch.bfloat16) for _ in range(TP_SHARDS)]
    want = sum(p.float() for p in parts).to(torch.bfloat16)
    check(all(torch.equal(o, want) for o in sh.all_reduce(parts)),
          "9a: all_reduce is not the sum of the shards")
    times = []
    for i in range(COLLECTIVE_CALLS + 20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sh.all_reduce(parts)
        torch.cuda.synchronize()
        if i >= 20:
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def run_cost_model(torch, dev, engine, swap, moe):
    """9a and 9b: the port's cost model (committed constants) against the
    engine windows phases 3, 5 and 6a measured in this run."""
    from repro_torch.configs import REGISTRY
    from repro_torch.serving import costmodel as cm

    cfg = REGISTRY["llama3.2-3b"]
    cost = cm.InstanceCost(cfg=cfg, chips=1)
    print(f"phase 9a: the cost model (committed constants: peak "
          f"{cm.PEAK_FLOPS:.4g} FLOP/s, HBM {cm.HBM_BW:.4g} B/s, dispatch "
          f"{cm.DISPATCH_OVERHEAD * 1e3:.3f} ms, host sync "
          f"{cm.HOST_SYNC_OVERHEAD * 1e3:.3f} ms) against the engine: "
          f"{cfg.name} whole, chips=1")
    rows = {}
    for name, w, K in (("K=8", engine, 8), ("K=1", engine["k1_window"], 1)):
        check(w["decode_step_device_ms"] is not None,
              f"9a: {name} window has no device time")
        B = w["decode_batch"]
        roof = max(cost._decode_roofline(B, w["decode_mean_ctx"])) * 1e3
        roof_traced = max(cost._decode_roofline(
            B, w["decode_traced_mean_ctx"])) * 1e3
        pred = cost.decode_step_time(B, w["decode_mean_ctx"], K) * 1e3
        host, devm = w["decode_step_wall_ms"], w["decode_step_device_ms"]
        rows[name] = {"batch": B, "mean_ctx": w["decode_mean_ctx"],
                      "roofline_ms": roof, "predicted_ms": pred,
                      "host_ms": host, "device_ms": devm,
                      "predicted_over_host": pred / host,
                      "predicted_over_device": pred / devm,
                      "roofline_over_device": roof_traced / devm}
        print(f"  decode {name} ({B} sequences, mean context "
              f"{w['decode_mean_ctx']:.1f}): roofline {roof:.3f} ms, "
              f"predicted {pred:.3f} ms, measured {host:.3f} ms host clock / "
              f"{devm:.3f} ms device; predicted/host {pred / host:.3f}, "
              f"predicted/device {pred / devm:.3f}, roofline/device "
              f"{roof_traced / devm:.3f}")
        check(math.isfinite(pred) and pred > 0, f"9a: {name} prediction")
        check(roof_traced <= devm, f"9a: the {name} roofline "
              f"{roof_traced:.3f} ms is above the measured device time "
              f"{devm:.3f} ms: a rate or a byte count is wrong")
    ps = engine["per_step_path"]
    print(f"  a different path, per-step (fused_decode=False, "
          f"{ps['sequences']} sequences at ~0.35k): "
          f"{ps['decode_step_wall_ms']:.3f} ms a decode step on the host "
          f"clock over {ps['decode_steps']} steps")
    d, h = fit_overheads(rows["K=8"]["host_ms"], rows["K=8"]["roofline_ms"],
                         rows["K=1"]["host_ms"], rows["K=1"]["roofline_ms"])
    held = " (the K=1 step is not the longer: host_sync held at 0)" \
        if rows["K=1"]["host_ms"] - rows["K=1"]["roofline_ms"] \
        <= rows["K=8"]["host_ms"] - rows["K=8"]["roofline_ms"] else ""
    print(f"  fitted to this run: dispatch_overhead {d:.4f} ms, "
          f"host_sync {h:.4f} ms (step_overhead {d + h:.4f} ms){held}")

    # -- the prefill chunk: 512 tokens at 1024 --
    n = 512
    flops = 2.0 * cfg.num_active_params * n
    roof = max(flops / cost.peak_flops,
               cfg.num_active_params * cost.bytes_per_param
               / cost.hbm_bw) * 1e3
    pred = cost.prefill_time(n) * 1e3
    host, devm = engine["prefill_step_wall_ms"], \
        engine["prefill_step_device_ms"]
    check(devm is not None, "9a: the prefill chunk has no device time")
    mfu_host = flops / cost.peak_flops / (host / 1e3)
    mfu_dev = flops / cost.peak_flops / (devm / 1e3)
    rows["prefill"] = {"tokens": n, "roofline_ms": roof, "predicted_ms": pred,
                       "host_ms": host, "device_ms": devm,
                       "predicted_over_host": pred / host,
                       "predicted_over_device": pred / devm,
                       "roofline_over_device": roof / devm,
                       "implied_mfu_host": mfu_host,
                       "implied_mfu_device": mfu_dev}
    print(f"  prefill chunk ({n} tokens at 1024): roofline {roof:.3f} ms, "
          f"predicted {pred:.3f} ms (mfu {cost.mfu}), measured {host:.3f} ms "
          f"host clock / {devm:.3f} ms device; predicted/host "
          f"{pred / host:.3f}, predicted/device {pred / devm:.3f}; implied "
          f"mfu {mfu_host:.4f} (host clock) / {mfu_dev:.4f} (device)")
    check(math.isfinite(pred) and pred > 0, "9a: prefill prediction")
    check(roof <= devm, f"9a: the prefill roofline {roof:.3f} ms is above "
          f"the measured device time {devm:.3f} ms")

    coll = collective_ms(torch, dev)
    rate = swap["bytes"] / (swap["swap_out"] / 1e3)
    rate_in = swap["bytes"] / (swap["swap_in"] / 1e3)
    print(f"  ServeSharding.all_reduce of {TP_SHARDS} {COLLECTIVE_SHAPE} "
          f"bf16 shards on one card: median {coll * 1e3:.2f} us of "
          f"{COLLECTIVE_CALLS} calls (committed COLLECTIVE_LAUNCH "
          f"{cm.COLLECTIVE_LAUNCH * 1e6:.2f} us)")
    print(f"  swap rate (phase 5): out {rate / 1e9:.3f} GB/s, in "
          f"{rate_in / 1e9:.3f} GB/s for {swap['bytes']} bytes, beside "
          f"HOST_IO_BW {cm.HOST_IO_BW / 1e9:.3f} GB/s (datasheet)")

    # -- 9b: a held-out model, phase 6a's phi3.5-moe --
    mcfg = dataclasses.replace(REGISTRY["phi3.5-moe-42b-a6.6b"],
                               num_layers=MOE_LAYERS)
    K = FAMILY_ENGINE["decode_steps_per_sync"]
    mpred = cm.InstanceCost(cfg=mcfg, chips=1).decode_step_time(
        moe["decode_batch"], moe["decode_mean_ctx"], K) * 1e3
    check(math.isfinite(mpred) and mpred > 0, "9b: prediction")
    ratio = mpred / moe["decode_step_wall_ms"]
    print(f"phase 9b: held out, {mcfg.name} ({MOE_LAYERS} layers, K={K}, "
          f"{moe['decode_batch']} sequences at {moe['decode_mean_ctx']:.1f}):"
          f" predicted {mpred:.3f} ms against phase 6a's "
          f"{moe['decode_step_wall_ms']:.3f} ms a step on the host clock: "
          f"ratio {ratio:.3f}")
    return {"llama": rows, "fit_dispatch_ms": d, "fit_host_sync_ms": h,
            "per_step_path": ps, "collective_ms": coll,
            "swap_out_bytes_s": rate, "swap_in_bytes_s": rate_in,
            "moe_predicted_ms": mpred, "moe_ratio": ratio}


def federation_des(tb, gw, api, wl, hw=None):
    """9c: ``examples/federated_serving.py``'s scenario and the batch
    control plane of ``examples/batch_inference.py``, on the DES at the
    paper's model sizes. ``tb``, ``gw``, ``api``, ``wl``: a package's
    ``core.testbed``, ``core.gateway``, ``api`` and ``data.workload``
    (the port's here; the CPU tests pass the JAX package's too and hold
    the two traces equal). ``hw``: InstanceCost overrides. Returns
    (metrics, trace); fails on a failed check."""
    import numpy as np
    L70 = tb.LLAMA70B
    M = L70.name

    def dep(**kw):
        return tb.default_deployment(L70, max_instances=2, storage_bw=40e9,
                                     scale_cooldown=5.0, hw=hw, **kw)

    system = tb.build_system(
        {"sophia": {M: dep(scheduling_policy="priority",
                           enable_preemption=True, restore_hit_rate=0.9)},
         "polaris": {M: dep()}},
        gateway_config=gw.GatewayConfig(workers=128), startup_delay=5.0)
    picks = [system.router.select_endpoint(M)]
    tb.warm_up(system, M)
    picks.append(system.router.select_endpoint(M))
    print(f"  cold selection -> {picks[0]}, warm -> {picks[1]}: rules "
          f"{[d[2] for d in system.router.decisions]}")
    check(picks == ["sophia-ep", "sophia-ep"]
          and system.router.decisions[0][2] == "free-nodes"
          and system.router.decisions[-1][2] == "active-instance",
          "9c: cold/warm selection rules")

    burst = tb.drive_workload(system, wl.make_workload(
        400, rate=float("inf"), seed=1), M)
    sophia = len(system.endpoints["sophia-ep"].instances[M])
    print(f"  burst of 400: {burst['req_per_s']:.3f} req/s, "
          f"{burst['output_tok_per_s']:.3f} output tokens/s (modelled by the "
          f"DES on the port's H100 cost terms), sophia instances {sophia}, "
          f"errors {burst['errors']}")
    check(burst["errors"] == 0 and burst["completed"] == 400,
          "9c: burst errors")
    check(sophia == 2, f"9c: the burst ended with {sophia} sophia instances")

    system.health.mark_down("sophia-ep")
    system.loop.run_until(system.loop.now() + 15.0)
    client = api.FirstClient(system.gateway, system.token_for("alice"))
    fut = client.chat(model=M, prompt_tokens=64, max_tokens=32)
    system.loop.run_until_idle()
    check(fut.error is None, f"9c: post-outage request: {fut.error}")
    served = fut.result().endpoint_id
    print(f"  after the sophia outage: served by {served} (rule "
          f"{system.router.decisions[-1][2]})")
    check(served == "polaris-ep", "9c: the post-outage request was not "
          "served by polaris-ep")
    jobs = system.gateway.jobs_status()

    system.health.mark_up("sophia-ep")
    system.health.mark_down("polaris-ep")
    system.loop.run_until(system.loop.now() + 15.0)
    t0 = system.loop.now()
    flood = [client.chat(model=M, request_id=f"flood-{j}", prompt_tokens=256,
                         max_tokens=1500, qos="batch") for j in range(96)]
    inter = {}

    def ask():
        inter["fut"], inter["asm"] = client.stream(
            model=M, request_id="chat-1", prompt_tokens=72, max_tokens=24,
            qos="interactive")
        inter["t"] = system.loop.now()

    system.loop.call_at(t0 + 20.0, ask)
    system.loop.run_until_idle()
    check(all(f.error is None for f in flood), "9c: flood errors")
    check(inter["fut"].error is None,
          f"9c: the interactive request: {inter['fut'].error}")
    recs = {r.request_id: r for r in system.metrics.records}
    flood_e2e = sorted(recs[f"flood-{j}"].e2e for j in range(96))
    median = flood_e2e[len(flood_e2e) // 2]
    preempts = sum(i.engine.total_preemptions
                   for i in system.endpoints["sophia-ep"].instances[M])
    asm, resp = inter["asm"], inter["fut"].result()
    ttft = asm.ttft - inter["t"]
    print(f"  QoS: interactive TTFT {ttft:.3f} s, e2e "
          f"{recs['chat-1'].e2e:.3f} s over {len(asm.deltas)} stream frames "
          f"against the flood's median e2e {median:.3f} s; sophia preemptions "
          f"{preempts}")
    check(ttft < median and preempts > 0, "9c: the interactive request did "
          "not jump the flood")
    check(asm.finished and asm.n_tokens == resp.usage.completion_tokens
          == 24, "9c: the streamed frames do not reassemble to the output")
    summary = system.metrics.summary()
    fed = {"records": system.metrics.records, "summary": summary,
           "decisions": system.router.decisions, "jobs": jobs,
           "jobs_end": system.gateway.jobs_status(), "burst": burst,
           "frames": asm.deltas, "response": resp, "now": system.loop.now()}

    # -- the batch control plane: 500 JSONL lines through /v1/batches --
    rng = np.random.default_rng(7)
    lines = [json.dumps({"custom_id": f"b{i}", "method": "POST",
                         "url": "/v1/completions",
                         "body": {"model": M,
                                  "prompt_tokens": int(rng.integers(16, 512)),
                                  "max_tokens": int(rng.integers(16, 256))}})
             for i in range(500)]
    bsys = tb.build_system({"sophia": {M: tb.default_deployment(L70,
                                                                hw=hw)}})
    bclient = api.FirstClient(bsys.gateway, bsys.token_for("alice"))
    bfut = bclient.create_batch([json.loads(line) for line in lines])
    bsys.loop.run_until(120.0)
    bid = bfut.result().id
    loading = bclient.batch_status(bid)
    bsys.loop.run_until_idle()
    st = bclient.batch_status(bid)
    results = bclient.batch_results(bid)
    dur = st.completed_at - st.created_at
    print(f"  batch: {st.status}, {st.completed} of {st.total} requests, "
          f"{st.output_tokens} tokens in {dur:.3f} s: "
          f"{st.output_tokens / dur:.3f} output tokens/s (modelled by the DES "
          f"on the port's H100 cost terms; cold start "
          f"{st.in_progress_at - st.created_at:.3f} s)")
    check(st.status == "completed" and st.completed == 500
          and len(results) == 500 and st.failed == 0,
          "9c: the batch did not complete with 500 results")
    check(all(r.get("error") is None for r in results),
          "9c: a batch result carries an error")
    metrics = {"burst_req_s": burst["req_per_s"],
               "burst_output_tok_s": burst["output_tok_per_s"],
               "sophia_instances": sophia, "post_outage_endpoint": served,
               "interactive_ttft_s": ttft, "flood_median_e2e_s": median,
               "preemptions": preempts,
               "batch_output_tok_s": st.output_tokens / dur,
               "batch_completed": st.completed,
               "summary_req_s": summary["req_per_s"],
               "summary_output_tok_s": summary["output_tok_per_s"]}
    return metrics, {"federation": fed, "batch": {
        "loading": loading, "status": st, "results": results,
        "now": bsys.loop.now()}}


def run_control_plane():
    """9c on the port's package, with the DES's host wall time."""
    from repro_torch import api
    from repro_torch.core import gateway, testbed
    from repro_torch.data import workload
    print("phase 9c: the paper's federation on the port's DES "
          "(llama3.3-70b, 8 cards an instance, sophia + polaris)")
    t0 = time.perf_counter()
    metrics, _ = federation_des(testbed, gateway, api, workload)
    metrics["des_host_s"] = time.perf_counter() - t0
    print(f"  the DES ran in {metrics['des_host_s']:.3f} s of host wall time")
    return metrics


# ---------------------------------------------------------------------------
# phase 10: the dry run's step analysis against the card
# ---------------------------------------------------------------------------

# 10c's cells: llama3.2-3b's three shapes and dbrx-132b's decode, each on
# both production meshes
DRYRUN_CELLS = (("llama3.2-3b", "train_4k"), ("llama3.2-3b", "prefill_32k"),
                ("llama3.2-3b", "decode_32k"), ("dbrx-132b", "decode_32k"))


def meta_like(torch, tree):
    """Meta tensors of ``tree``'s shapes and dtypes (nested dicts)."""
    if isinstance(tree, dict):
        return {k: meta_like(torch, v) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def dry_run_train(torch, dev):
    """10a: phase 7b's step (llama3.2-3b whole, bf16, B=8, S=1024, two
    microbatches, remat, in-place AdamW) analysed on meta, then run on the
    card under FlopCounterMode and timed."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import REGISTRY
    from repro_torch.data.tokens import TokenDataset
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import make_model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train import batch_to, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = REGISTRY["llama3.2-3b"]
    model = make_model(cfg)
    B, S, n = FULL_TRAIN_BATCH, FULL_TRAIN_SEQ, FULL_TRAIN_MICRO
    step = make_train_step(model, AdamWConfig(lr=FULL_TRAIN_LR,
                                              warmup_steps=0),
                           num_microbatches=n, remat=True, in_place=True)
    batch = batch_to(TokenDataset(cfg.vocab_size, S, B, seed=0)
                     .next_batch(), dev)
    shapes = model.param_shapes()
    res = analyze_step(step, shapes, adamw_init(shapes),
                       meta_like(torch, batch))
    print(f"phase 10a: {cfg.name} whole, phase 7b's step (B={B} S={S}, "
          f"{n} microbatches, remat) analysed on meta in "
          f"{res['analyze_s']:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    opt = adamw_init(params)
    card_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves({"p": params, "o": opt,
                                           "b": batch}))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    counted = fc.get_total_flops()
    secs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    check(math.isfinite(float(m["loss"])), "10a: the step's loss is not "
          "finite")
    step_s = statistics.median(secs[1:])
    roof = res["compute_s"] + res["memory_s"]
    predicted_peak = res["argument_size_in_bytes"] + res["temp_size_in_bytes"]
    out = {"dot_flops": res["dot_flops"], "card_flops": counted,
           "argument_bytes": res["argument_size_in_bytes"],
           "card_argument_bytes": card_bytes,
           "temp_bytes": res["temp_size_in_bytes"],
           "predicted_peak_bytes": predicted_peak, "card_peak_bytes": peak,
           "traffic_bytes": res["traffic_bytes"],
           "compute_s": res["compute_s"], "memory_s": res["memory_s"],
           "step_ms": step_s * 1e3, "step_s_all": secs,
           "analyze_s": res["analyze_s"]}
    print(f"  dot_flops: analysis {res['dot_flops']:.0f}, FlopCounterMode on "
          f"the card {counted}; argument bytes: analysis "
          f"{res['argument_size_in_bytes']}, the card's tensors {card_bytes}")
    print(f"  peak live: predicted {predicted_peak / 1e9:.3f} GB (arguments "
          f"+ temp {res['temp_size_in_bytes'] / 1e9:.3f} GB), "
          f"max_memory_allocated {peak / 1e9:.3f} GB: ratio "
          f"{predicted_peak / peak:.3f}")
    print(f"  roofline: compute {res['compute_s'] * 1e3:.1f} ms + memory "
          f"{res['memory_s'] * 1e3:.1f} ms (traffic "
          f"{res['traffic_bytes'] / 1e9:.1f} GB) over the measured step "
          f"{step_s * 1e3:.1f} ms (median of steps 2 and 3): "
          f"{roof / step_s:.3f}")
    check(res["dot_flops"] == counted and res["flop_counter_flops"] ==
          counted, f"10a: the analysis counts {res['dot_flops']} matmul "
          f"FLOPs, FlopCounterMode on the card {counted}")
    check(res["argument_size_in_bytes"] == card_bytes,
          f"10a: argument bytes {res['argument_size_in_bytes']} vs the "
          f"card's {card_bytes}")
    del params, opt, m
    return out


def dry_run_decode(torch, engine):
    """10b: a decode step at phase 3's geometry (its batch and mean
    context) analysed on meta, beside the cost model's roofline and phase
    3's measured device time."""
    from repro_torch.configs import REGISTRY
    from repro_torch.launch.step_analysis import analyze_step
    from repro_torch.models import make_model
    from repro_torch.serving import costmodel as cm
    cfg = REGISTRY["llama3.2-3b"]
    model = make_model(cfg)
    B, ctx = engine["decode_batch"], round(engine["decode_mean_ctx"])
    res = analyze_step(model.decode_step, model.param_shapes(),
                       torch.empty((B,), dtype=torch.int32, device="meta"),
                       model.init_cache(B, ctx, device="meta"))
    roof = max(res["compute_s"], res["memory_s"]) * 1e3
    cost_roof = max(cm.InstanceCost(cfg=cfg, chips=1)._decode_roofline(
        B, ctx)) * 1e3
    devm = engine["decode_step_device_ms"]
    print(f"phase 10b: {cfg.name} decode step, {B} sequences at context "
          f"{ctx} (phase 3's mean), plain path on meta: compute "
          f"{res['compute_s'] * 1e3:.3f} ms, memory {res['memory_s'] * 1e3:.3f}"
          f" ms (traffic {res['traffic_bytes'] / 1e9:.3f} GB): roofline "
          f"{roof:.3f} ms; costmodel roofline {cost_roof:.3f} ms; phase 3 "
          f"measured " + (f"{devm:.3f} ms" if devm else "not measured")
          + " device time a step (kernel path)")
    check(math.isfinite(roof) and roof > 0, "10b: the decode roofline")
    return {"batch": B, "ctx": ctx, "dot_flops": res["dot_flops"],
            "traffic_bytes": res["traffic_bytes"], "roofline_ms": roof,
            "costmodel_roofline_ms": cost_roof, "phase3_device_ms": devm}


def dry_run_sweep():
    """10c: the dry run's cells of ``DRYRUN_CELLS`` on both production
    meshes, records under ``results/dryrun_torch`` (the dry run's default,
    ignored by git)."""
    from repro_torch.launch import dryrun
    out_dir = str(ROOT / "results" / "dryrun_torch")
    print("phase 10c: the dry run on the production meshes (meta)")
    recs = {}
    for arch, shape in DRYRUN_CELLS:
        for multi in (False, True):
            t0 = time.perf_counter()
            rec = dryrun.run_cell(arch, shape, multi, out_dir)
            took = time.perf_counter() - t0
            check(rec["ok"], f"10c: {arch} x {shape} failed: "
                  f"{rec.get('error')}")
            recs[f"{rec['mesh']}_{arch}_{shape}"] = {
                "s": took, "dot_flops": rec["dot_flops"],
                "argument_bytes": rec["argument_size_in_bytes"],
                "collective_bytes": rec["collective_bytes"],
                "compute_s": rec["compute_s"], "memory_s": rec["memory_s"],
                "collective_s": rec["collective_s"]}
            print(f"  {rec['mesh']:6s} {arch} x {shape}: {took:.1f} s")
    return recs


def run_dry_run(torch, dev, engine):
    """Phase 10. No port kernel may launch in it: the analysis and its
    card check run the plain path."""
    from repro_torch.kernels import _build
    t_phase = time.perf_counter()
    _build.reset_launches()
    out = {"train": dry_run_train(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    out["decode"] = dry_run_decode(torch, engine)
    out["sweep"] = dry_run_sweep()
    launched = {k: v for k, v in {**_build.LAUNCHES,
                                  **_build.PASS_LAUNCHES}.items() if v}
    check(not launched, f"phase 10 launched port kernels: {launched}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"  phase 10 in {out['phase_s']:.1f} s")
    return out


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no CUDA device")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    print("phase 1: header")
    print(f"  card: {smi}")
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    print(f"  kernel build: {build_s:.1f} s for {list(_build.SOURCES)}")
    for name, log in _build.BUILD_LOG.items():
        for line in log.splitlines():
            if any(k in line for k in ("registers", "spill", "properties for",
                                       "Performance Loss", "warning")):
                print(f"    {name}: {line.strip()}")

    timing = run_kernel_checks(torch, dev)
    timing.update(run_hybrid_kernel_checks(torch, dev))
    timing.update(run_slot_kernel_checks(torch, dev))
    timing.update(run_mixer_kernel_checks(torch, dev))
    launches, metrics = run_engine(torch, dev)
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_metrics = run_hybrid_engine(torch, dev)
    launches.update(hybrid_launches)
    torch.cuda.empty_cache()
    spec_metrics = run_spec_engine(torch, dev)
    family_metrics = {}
    for name, run in (("moe", run_moe), ("vlm", run_vlm),
                      ("audio", run_audio)):
        # earlier phases' engines sit in reference cycles (wrapped methods
        # close over their engine): free them before the next weights
        gc.collect()
        torch.cuda.empty_cache()
        family_metrics[name] = run(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    family_metrics["serve"] = run_serve_entry_point()
    gc.collect()
    torch.cuda.empty_cache()
    train_metrics = run_training(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    tp_metrics = run_tensor_parallel(torch, dev, metrics, hybrid_metrics)
    gc.collect()
    torch.cuda.empty_cache()
    core_metrics = run_cost_model(torch, dev, metrics,
                                  spec_metrics["swap"], family_metrics["moe"])
    core_metrics["des"] = run_control_plane()
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_metrics = run_dry_run(torch, dev, metrics)

    replaces = {
        "paged_attention": ("src/repro_torch/csrc/paged_attention.cu",
                            "src/repro/kernels/paged_attention/kernel.py:81"),
        "fused_decode_attention": (
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:187"),
        "paged_flash_prefill": (
            "src/repro_torch/csrc/paged_prefill.cu",
            "src/repro/kernels/flash_attention/kernel.py:135"),
        "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention/kernel.py:186"),
        "ssd": ("src/repro_torch/csrc/ssd.cu",
                "src/repro/kernels/ssd/kernel.py:65"),
        "slot_decode_attention": (
            "src/repro_torch/csrc/slot_attention.cu",
            "none: src/repro/models/layers.py decode_attention_appended is "
            "jnp"),
        "mixer_decode": (
            "src/repro_torch/csrc/mixer_decode.cu",
            "none: src/repro/models/mamba2.py _mixer's decode step is jnp"),
    }
    # launches: paged_attention from phase 3's per-step path, the other two
    # paged kernels from its fused main path, ssd, flash_attention,
    # slot_decode_attention and mixer_decode from phase 4's main path
    # per-shard launches under a mesh: phase 8a's fused path and per-step
    # path, phase 8e's two dbrx-132b engines' fused paths, phase 8d's
    # zamba2 main path (ssd, flash_attention); the paged prefill kernel
    # runs under no mesh
    tp_launches = {
        "fused_decode_attention":
            tp_metrics["llama"]["launches_fused"]["fused_decode_attention"]
            + tp_metrics["fsdp"]["launches"]["fused_decode_attention"],
        "paged_attention":
            tp_metrics["llama"]["launches_per_step"]["paged_attention"],
        "ssd": tp_metrics["hybrid"]["launches"]["ssd"],
        "flash_attention": tp_metrics["hybrid"]["launches"]["flash_attention"],
        "slot_decode_attention":
            tp_metrics["hybrid"]["launches"]["slot_decode_attention"],
        "mixer_decode": tp_metrics["hybrid"]["launches"]["mixer_decode"]}
    kernels = []
    for name, (source, repl) in replaces.items():
        r = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": repl,
            "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "device_ms": r["device_ms"],
            "library_device_ms": r["library_device_ms"],
            "tp_launches": tp_launches.get(name, 0)})
    decode = {"geometry": timing["paged_attention"]["geometry"],
              "device_ms_by_split": {
                  n: timing[n]["device_ms_by_split"]
                  for n in ("paged_attention", "fused_decode_attention")}}
    ssd_kernel = {k: timing["ssd"][k]
                  for k in ("geometry", "device_ms_by_pass",
                            "floors_device_ms", "sass")}
    print(json.dumps({"metrics": metrics, "hybrid_metrics": hybrid_metrics,
                      "spec_metrics": spec_metrics,
                      "family_metrics": family_metrics,
                      "train_metrics": train_metrics,
                      "tp_metrics": tp_metrics,
                      "core_metrics": core_metrics,
                      "dryrun_metrics": dryrun_metrics,
                      "hubert_flash_attention": timing[
                          "flash_attention hubert"],
                      "decode_kernel": decode, "ssd_kernel": ssd_kernel,
                      "build_s": build_s}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
