"""Roofline-based service-time model for simulated large-model instances.

A copy of the JAX package's ``repro/serving/costmodel.py``: the same
formulas, the same ``InstanceCost`` fields and methods. Its constants are
the NVIDIA H100 SXM5's own: datasheet rates, and overhead terms fitted on
the card from the port's serving engine (phase 9 of ``chip_smoke.py``).

The discrete-event control plane (``repro_torch.core``) cannot run a 70B
model on the host, but it needs per-step service times. They come from the
roofline of one instance of ``chips`` cards:

  compute  = FLOPs / (chips * 989e12 * eff)
  memory   = bytes / (chips * 3.35e12)
  step     = max(compute, memory) + fixed overhead

Calibration knob ``mfu``/``eff`` defaults to 0.5 for prefill (compute-bound)
and 1.0 for memory streaming (decode is HBM-bound).

The per-step overhead is split to mirror the real engine's two decode
paths: ``dispatch_overhead`` is paid every decode step, while
``host_sync_overhead`` is the cost of a decode sync (token transfer,
sampling, scheduling), paid once per ``steps_per_sync`` steps
(``decode_step_time(steps_per_sync=K)``). In the port's engine the fused
K-step loop still issues every step's operations from the host, so the
fitted ``dispatch_overhead`` is mostly host issue time, not a device floor:
it falls when the decode loop is replayed as a CUDA graph.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig

# H100 SXM5 datasheet: dense bf16 tensor-core peak, per card
PEAK_FLOPS = 989e12
# H100 SXM5 datasheet: HBM3 bandwidth, bytes/s per card
HBM_BW = 3.35e12
# PCIe Gen5 x16, one direction (datasheet): device<->host staging of the
# KV swap path, bytes/s
HOST_IO_BW = 64e9
# NVLink 4, one direction of the 900 GB/s a card (datasheet): the
# all-reduce ring's bandwidth per card, bytes/s
ICI_BW = 450e9
# per-collective floor, an upper stand-in: the median host-clock time
# (96.51 us over four runs) of the port's own ServeSharding.all_reduce
# (copy to the lead device and sum in float32, not NCCL) of four (8, 3072)
# bf16 shards on ONE card, each timed call ending in a device sync,
# chip_smoke.py phase 9a; NVIDIA H100 80GB HBM3, 700.00 W. It is not a
# collective across cards over NVLink, which _collective_time models
COLLECTIVE_LAUNCH = 9.651e-5
# chip_smoke.py's fit_overheads on the medians over three runs of phase
# 9a's llama3.2-3b decode step on the host clock, each window timed with
# the garbage collector off (8 sequences at 1325 positions, whole model,
# one card: K = 8 44.551 ms, K = 1 46.171 ms, roofline 2.516 ms); NVIDIA
# H100 80GB HBM3, 700.00 W. In the port this per-step term is mostly the
# host's issue of every step's operations, which the fused K-step loop
# does not amortize; it is not a device floor
DISPATCH_OVERHEAD = 4.1803e-2
# the same fit: paid once per decode sync (token transfer, sampling,
# scheduling). Weakly resolved: the per-run fits give 0 to 10.1 ms, as the
# K = 8 window alone spreads 37 to 64 ms between runs; their sum is the
# firmer figure
HOST_SYNC_OVERHEAD = 1.8517e-3
STEP_OVERHEAD = DISPATCH_OVERHEAD + HOST_SYNC_OVERHEAD  # legacy K=1 total
# cluster fabric between instances (a 200 Gb/s link), bytes/s: the
# prefill->decode KV handoff
KV_TRANSFER_BW = 25e9
# control-plane hop of one prefill->decode handoff, seconds
HANDOFF_OVERHEAD = 2e-3


def restore_tokens(n_tokens: int, cache_hit_rate: float) -> int:
    """Prompt-stream tokens a preemption *restore* prefill must recompute:
    the fraction the prefix cache does not cover, never less than one (the
    allocator always leaves the final position to recompute — mirrors
    ``PagedKVCache.allocate_with_prefix``). The real engine's
    recompute-via-prefix-cache restore hits the pages the victim published
    on eviction, so a warm restore recomputes only the partial tail page."""
    h = min(max(cache_hit_rate, 0.0), 1.0)
    return max(int(round(n_tokens * (1.0 - h))), 1)


def expected_spec_tokens(accept_rate: float, k: int) -> float:
    """Expected tokens emitted per speculative round: the accepted draft
    prefix plus the guaranteed target token (the residual resample, or the
    bonus token when all k drafts survive). With i.i.d. per-token acceptance
    probability ``a`` this is ``sum_{j=0..k} a^j = (1 - a^(k+1)) / (1 - a)``,
    saturating at ``k + 1`` when every draft is accepted."""
    a = min(max(accept_rate, 0.0), 1.0)
    k = max(int(k), 0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclass
class InstanceCost:
    """Per-phase timing for one model instance on ``chips`` chips.

    ``peak_flops``/``hbm_bw`` default to the H100 SXM5 datasheet rates;
    pass A100 constants (312e12 bf16, 1555e9) to validate the DES against
    the paper's own hardware.

    ``model_shards`` mirrors the real engine's tensor-parallel mesh (the
    ``model`` axis of ``EngineConfig.mesh``): the FLOP/HBM rooflines above
    already scale with ``chips``, so sharding's *cost* is the per-layer
    all-reduce traffic that perfect scaling ignores — 2 collectives per
    layer over the activations (Megatron TP), charged on every forward.
    The default of 1 adds exactly zero and reproduces the unsharded model
    bit-for-bit."""
    cfg: ModelConfig
    chips: int = 8
    mfu: float = 0.5
    bytes_per_param: float = 2.0
    # weight load from cluster storage (bytes/s per instance)
    storage_bw: float = 2e9
    peak_flops: float = PEAK_FLOPS
    hbm_bw: float = HBM_BW
    # total per-token overhead when the host syncs every step (K=1);
    # the per-step dispatch term below is the part that multi-step decode
    # cannot amortize — the remainder is host-sync cost
    step_overhead: float = STEP_OVERHEAD
    dispatch_overhead: float = DISPATCH_OVERHEAD
    host_io_bw: float = HOST_IO_BW   # KV swap-out/in staging bandwidth
    model_shards: int = 1            # TP width (EngineConfig.mesh mirror)
    ici_bw: float = ICI_BW           # all-reduce ring bandwidth per link
    kv_transfer_bw: float = KV_TRANSFER_BW  # prefill->decode handoff link
    handoff_overhead: float = HANDOFF_OVERHEAD  # per-handoff hop floor

    def __post_init__(self):
        n = int(self.model_shards)
        if n < 1:
            raise ValueError(f"model_shards must be >= 1, got {n}")
        if self.chips % n:
            raise ValueError(
                f"model_shards={n} must divide chips={self.chips} "
                f"(each TP group spans chips/model_shards chips)")

    # -- tensor parallelism ------------------------------------------------------
    def _collective_time(self, batch: int, tokens_per_seq: int = 1) -> float:
        """All-reduce wall time for one forward under Megatron-style TP:
        2 collectives per layer (attention output + MLP output) over the
        (batch, tokens, d_model) activations, ring cost ``2(n-1)/n`` times
        the payload per device at ICI bandwidth, plus a per-collective
        launch floor (decode-shaped all-reduces are latency-bound)."""
        n = int(self.model_shards)
        if n <= 1:
            return 0.0
        act = batch * tokens_per_seq * self.cfg.d_model * self.bytes_per_param
        ring = 2.0 * (n - 1) / n * act / self.ici_bw
        return 2 * self.cfg.num_layers * (ring + COLLECTIVE_LAUNCH)

    def hbm_bytes_per_shard(self, batch: int = 1, ctx: int = 1024) -> float:
        """Resident bytes per TP shard: weights split over ``model`` and the
        KV pool split along its head axis, so both divide by the TP width
        (the HBM-headroom argument for sharding a too-large model)."""
        cfg = self.cfg
        w_bytes = cfg.num_params * self.bytes_per_param
        kv_bytes = (cfg.attn_layer_count() * 2 * cfg.kv_dim
                    * self.bytes_per_param * ctx * batch)
        return (w_bytes + kv_bytes) / int(self.model_shards)

    # -- model load (cold start component) -------------------------------------
    def load_time(self) -> float:
        """Weight load from cluster storage into device memory."""
        return self.cfg.num_params * self.bytes_per_param / self.storage_bw

    # -- prefill ---------------------------------------------------------------
    def prefill_time(self, prompt_tokens: int, batch: int = 1) -> float:
        flops = 2.0 * self.cfg.num_active_params * prompt_tokens * batch
        t_c = flops / (self.chips * self.peak_flops * self.mfu)
        t_coll = self._collective_time(batch, prompt_tokens)
        return max(t_c + t_coll, self.step_overhead)

    # -- preemption (QoS scheduling) ---------------------------------------------
    def restore_time(self, n_tokens: int,
                     cache_hit_rate: float = 1.0) -> float:
        """Service time to restore a preempted sequence of ``n_tokens`` by
        recompute-via-prefix-cache: a prefill of whatever the cache does
        not cover (see :func:`restore_tokens`)."""
        return self.prefill_time(restore_tokens(n_tokens, cache_hit_rate))

    def swap_time(self, n_tokens: int) -> float:
        """One leg of the host swap restore path: stage a sequence's KV
        pages across the device<->host link (charged once on swap-out and
        once on swap-in; no recompute)."""
        cfg = self.cfg
        kv_per_tok = (cfg.attn_layer_count() * 2 * cfg.kv_dim
                      * self.bytes_per_param)
        return kv_per_tok * n_tokens / self.host_io_bw

    def handoff_time(self, n_tokens: int) -> float:
        """Transfer hop of a prefill->decode handoff (disaggregated
        serving): the sequence's KV pages for ``n_tokens`` positions cross
        the inter-instance link, plus a fixed control-plane hop. The
        receiving engine's restore prefill (``restore_time``) is charged
        separately by its resume admission path."""
        cfg = self.cfg
        kv_per_tok = (cfg.attn_layer_count() * 2 * cfg.kv_dim
                      * self.bytes_per_param)
        return (self.handoff_overhead
                + kv_per_tok * max(int(n_tokens), 0) / self.kv_transfer_bw)

    # -- decode ------------------------------------------------------------------
    def decode_step_time(self, batch: int, ctx: int = 1024,
                         steps_per_sync: int = 1) -> float:
        """Per-token service time for one decode step.

        ``steps_per_sync`` (K) models the fused multi-step decode loop: the
        host-sync share of the overhead is paid once per K tokens, the
        device dispatch floor and the HBM/FLOP roofline term every token.
        K=1 reproduces the legacy host-driven path exactly.
        """
        t_mem, t_c = self._decode_roofline(batch, ctx)
        k = max(int(steps_per_sync), 1)
        host_sync = max(self.step_overhead - self.dispatch_overhead, 0.0)
        return (max(t_mem, t_c) + self._collective_time(batch)
                + self.dispatch_overhead + host_sync / k)

    def decode_tok_per_s(self, batch: int, ctx: int = 1024,
                         steps_per_sync: int = 1) -> float:
        return batch / self.decode_step_time(batch, ctx, steps_per_sync)

    # -- speculative decoding ----------------------------------------------------
    def _decode_roofline(self, batch: int, ctx: int,
                         tokens_per_seq: int = 1) -> tuple[float, float]:
        """(memory, compute) roofline terms for one decode-shaped forward
        covering ``tokens_per_seq`` positions per sequence: the weights
        stream once regardless (the whole point of batched verification),
        compute scales with the positions."""
        cfg = self.cfg
        w_bytes = cfg.num_active_params * self.bytes_per_param
        kv_per_tok = (cfg.attn_layer_count() * 2 * cfg.kv_dim
                      * self.bytes_per_param)
        kv_bytes = kv_per_tok * ctx * batch
        t_mem = (w_bytes + kv_bytes) / (self.chips * self.hbm_bw)
        flops = 2.0 * cfg.num_active_params * batch * tokens_per_seq
        t_c = flops / (self.chips * self.peak_flops * self.mfu)
        return t_mem, t_c

    def spec_round_time(self, batch: int, draft: "InstanceCost",
                        spec_tokens: int, ctx: int = 1024) -> float:
        """Wall time of one draft-and-verify round mirroring the real
        engine: k+1 draft steps in one fused call (device dispatch floor per
        step, no host sync inside), then ONE target forward verifying all
        k+1 positions (weights read once, compute scaled by k+1), then one
        host sync for the round."""
        k = max(int(spec_tokens), 1)
        t_draft = (k + 1) * draft.decode_step_time(batch, ctx,
                                                   steps_per_sync=k + 1)
        t_mem, t_c = self._decode_roofline(batch, ctx, tokens_per_seq=k + 1)
        host_sync = max(self.step_overhead - self.dispatch_overhead, 0.0)
        t_verify = (max(t_mem, t_c) + self._collective_time(batch, k + 1)
                    + self.dispatch_overhead + host_sync)
        return t_draft + t_verify

    def spec_decode_tok_per_s(self, batch: int, draft: "InstanceCost",
                              spec_tokens: int, accept_rate: float,
                              ctx: int = 1024) -> float:
        tokens = expected_spec_tokens(accept_rate, spec_tokens)
        return (batch * tokens
                / self.spec_round_time(batch, draft, spec_tokens, ctx))
