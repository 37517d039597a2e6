"""The port's serving engine against the JAX package's, end to end.

Both engines serve the same requests on the same weights (the reference's
``init_params``, bridged) and must emit the same token streams, the same
finish reasons, the same ``StreamDelta`` frames (index, offset, tokens) and
the same prefix-cache counters. The JAX engine runs ``backend="paged",
use_kernel=True`` (on this host: its XLA twin of the Pallas kernels); the
port runs on ``device="cpu"``, where each kernel wrapper runs its plain
version. Greedy and seeded top-p must both be token-identical: the port's
sampler reproduces jax's PRNG bit for bit.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model
from repro_torch.serving import backends
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams

GREEDY = dict(temperature=0.0)
TOPP = dict(temperature=0.8, top_p=0.9)
# each variant: engine overrides, sampling, workload
VARIANTS = {
    "pc-chunk16-K4-greedy": (dict(enable_prefix_cache=True,
                                  chunked_prefill_budget=16,
                                  decode_steps_per_sync=4), GREEDY, "shared"),
    "pc-chunk16-K4-topp": (dict(enable_prefix_cache=True,
                                chunked_prefill_budget=16,
                                decode_steps_per_sync=4), TOPP, "shared"),
    "nopc-oneshot-K1-greedy": (dict(), GREEDY, "ramp"),
    "nopc-oneshot-K1-topp": (dict(), TOPP, "ramp"),
    "pc-oneshot-K4-topp": (dict(enable_prefix_cache=True,
                                decode_steps_per_sync=4), TOPP, "shared"),
    "nopc-chunk16-K4-greedy": (dict(chunked_prefill_budget=16,
                                    decode_steps_per_sync=4), GREEDY,
                               "ramp"),
    "legacy-nopc-oneshot-greedy": (dict(fused_decode=False), GREEDY, "ramp"),
    "legacy-pc-chunk16-topp": (dict(fused_decode=False,
                                    enable_prefix_cache=True,
                                    chunked_prefill_budget=16), TOPP,
                               "shared"),
    "plain-tier-pc-chunk16-K4-topp": (dict(use_kernel=False,
                                           enable_prefix_cache=True,
                                           chunked_prefill_budget=16,
                                           decode_steps_per_sync=4), TOPP,
                                      "shared"),
    "max-seq-len-K4-greedy": (dict(max_seq_len=40, decode_steps_per_sync=4),
                              GREEDY, "ramp"),
    "edf-K4-topp": (dict(scheduling_policy="edf", max_slots=2,
                         decode_steps_per_sync=4), TOPP, "deadlines"),
    "priority-page-pressure-preempt": (
        dict(scheduling_policy="priority", enable_preemption=True,
             max_slots=3, max_seq_len=64, page_size=8, num_pages=12,
             decode_steps_per_sync=4), GREEDY, "pressure"),
    "priority-preempt-restore-pc-topp": (
        dict(scheduling_policy="priority", enable_preemption=True,
             enable_prefix_cache=True, chunked_prefill_budget=16,
             decode_steps_per_sync=4), TOPP, "preempt"),
}
STATS = ("prefill_tokens", "cached_prompt_tokens", "prefill_chunks",
         "decode_tokens", "decode_syncs", "finished", "preemptions",
         "restores", "restore_cached_tokens")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def port_llama(llama):
    """The port's LM and the ``llama`` fixture's weights, bridged."""
    _, _, params = llama
    cfg = reduced(REGISTRY["llama3.2-3b"])
    return make_model(cfg), params_from_jax_numpy(
        jax.tree.map(np.asarray, params), cfg, "cpu")


def _workload(kind, vocab, sampling, request_factory):
    if kind == "shared":
        rng = np.random.default_rng(3)
        shared = rng.integers(2, vocab, size=40).tolist()
        prompts = [shared + rng.integers(2, vocab, size=8 + 3 * i).tolist()
                   for i in range(5)]
        return request_factory(vocab, prompts=prompts, max_tokens=18,
                               **sampling)
    if kind == "pressure":
        reqs = request_factory(vocab, n=3, plen=8, max_tokens=24,
                               ramp=False, **sampling)
        for r in reqs:
            r.qos = "batch"
        return reqs
    reqs = request_factory(vocab, n=5, plen=14, max_tokens=20, **sampling)
    if kind == "deadlines":
        for i, r in enumerate(reqs):
            r.deadline = 1e12 - i         # the last arrival is most urgent
    return reqs


def _port_request(r):
    s = r.sampling
    return InferenceRequest(
        model=r.model, prompt_tokens=list(r.prompt_tokens),
        request_id=r.request_id, qos=r.qos, priority=r.priority,
        deadline=r.deadline,
        sampling=SamplingParams(max_tokens=s.max_tokens,
                                temperature=s.temperature, top_p=s.top_p,
                                seed=s.seed, stop_token=s.stop_token))


def _serve(eng, reqs, preempt_at=None):
    """Run to completion; with ``preempt_at = (step, request_id)`` that
    request is preempted after that step. Returns (outputs by id, frames)."""
    frames = []
    for r in reqs:
        eng.add_request(r, on_delta=frames.append)
    outs, step = [], 0
    while eng.has_work():
        outs += eng.step()
        step += 1
        if preempt_at is not None and step == preempt_at[0]:
            assert eng.preempt(preempt_at[1])
    return ({o.request_id: (o.output_tokens, o.finish_reason) for o in outs},
            [(f.id, f.index, f.offset, f.tokens, f.finished, f.finish_reason)
             for f in frames])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_engine_token_identical_to_jax(variant, llama, port_llama,
                                       engine_factory, request_factory):
    overrides, sampling, kind = VARIANTS[variant]
    cfg, model, params = llama
    tmodel, tparams = port_llama
    overrides = dict(dict(use_kernel=True), **overrides)
    reqs = _workload(kind, cfg.vocab_size, sampling, request_factory)
    preempt_at = (3, reqs[1].request_id) if kind == "preempt" else None

    jeng = engine_factory(model, params, **overrides)
    jouts, jframes = _serve(jeng, copy.deepcopy(reqs), preempt_at)

    base = dict(max_slots=4, max_seq_len=128, backend="paged", page_size=16)
    teng = ContinuousBatchingEngine(tmodel, tparams,
                                    EngineConfig(**dict(base, **overrides)),
                                    device="cpu")
    backends.reset_transfer_stats()
    touts, tframes = _serve(teng, [_port_request(r) for r in reqs],
                            preempt_at)

    assert len(touts) == len(reqs)
    assert touts == jouts
    assert tframes == jframes
    assert teng.cache_stats() == jeng.cache_stats()
    assert {k: teng.stats[k] for k in STATS} == \
        {k: jeng.stats[k] for k in STATS}
    if overrides.get("fused_decode", True):
        # the fused path never moves logits to the host
        assert backends.TRANSFER_STATS["decode_logits_transfers"] == 0
    if kind in ("pressure", "preempt"):
        assert teng.stats["preemptions"] > 0 and teng.stats["restores"] > 0
    if kind == "preempt":
        assert teng.stats["restore_cached_tokens"] > 0
    if variant.startswith("max-seq-len"):
        assert "max_seq_len" in {r for _, r in touts.values()}
    if overrides.get("enable_prefix_cache"):
        assert teng.cache_stats()["hit_tokens"] > 0


@pytest.mark.parametrize("case", ["mesh", "mesh-ssm"])
def test_unported_engine_settings_name_their_roadmap_item(port_llama, case):
    """The mesh settings are ported: a mesh engine serves, its tokens
    those of the 1-device engine, on a (1, 4) mesh for an attention family
    (``mesh``) and on a (2, 2) (data, model) mesh for the ssm family
    (``mesh-ssm``). No engine setting is left unported."""
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(1, 4, devices=["cpu"] * 4)
    if case == "mesh-ssm":
        tmodel = make_model(reduced(REGISTRY["mamba2-130m"]))
        tparams = tmodel.init_params(torch.Generator().manual_seed(0))
        mesh = make_local_mesh(2, 2, devices=["cpu"] * 4)
    else:
        tmodel, tparams = port_llama
    outs = []
    for m in (None, mesh):
        eng = ContinuousBatchingEngine(tmodel, tparams, EngineConfig(mesh=m),
                                       device="cpu")
        for i in range(2):
            eng.add_request(InferenceRequest(
                model="m", prompt_tokens=list(range(3, 13 + 5 * i)),
                request_id=f"r{i}", sampling=SamplingParams(max_tokens=6)))
        outs.append({o.request_id: o.output_tokens
                     for o in eng.run_to_completion()})
    assert outs[0] == outs[1] and len(outs[1]) == 2


def test_engine_config_defaults_match_jax():
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    names = [f.name for f in dataclasses.fields(JaxEngineConfig)]
    assert [f.name for f in dataclasses.fields(EngineConfig)] == names
    assert dataclasses.asdict(EngineConfig()) == \
        dataclasses.asdict(JaxEngineConfig())


# each config the reference refuses: (engine overrides, target, draft)
REFUSED = {
    "spec-without-draft": (dict(spec_tokens=4), "llama", None),
    "spec-per-step-decode": (dict(spec_tokens=4, fused_decode=False),
                             "llama", "llama"),
    "spec-ssm-target": (dict(spec_tokens=4), "mamba", "llama"),
    "spec-ssm-draft": (dict(spec_tokens=4), "llama", "mamba"),
    "draft-other-vocab": (dict(spec_tokens=4), "llama", "llama-wide-vocab"),
    "swap-on-slots": (dict(preempt_swap=True), "llama", None),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_configs_raise_the_references_error(case, lm_factory):
    """The port refuses each engine config the reference refuses, with the
    same ValueError (default backend: slots)."""
    from repro.serving.engine import (ContinuousBatchingEngine as JaxEngine,
                                      EngineConfig as JaxEngineConfig)
    overrides, target, draft = REFUSED[case]
    arch = {"llama": ("llama3.2-3b", {}), "mamba": ("mamba2-130m", {}),
            "llama-wide-vocab": ("llama3.2-3b", {"vocab_size": 512})}

    def build(name):
        if name is None:
            return None, None, None
        arch_name, extra = arch[name]
        jcfg, jmodel, jparams = lm_factory(arch_name, **extra)
        tcfg = dataclasses.replace(reduced(REGISTRY[arch_name]), **extra)
        return (jmodel, jparams), make_model(tcfg), params_from_jax_numpy(
            jax.tree.map(np.asarray, jparams), tcfg, "cpu")

    (jm, jp), tm, tp = build(target)
    jdraft, dm, dp = build(draft)
    jdm, jdp = jdraft if jdraft is not None else (None, None)
    with pytest.raises(ValueError) as want:
        JaxEngine(jm, jp, JaxEngineConfig(**overrides), draft_model=jdm,
                  draft_params=jdp)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(tm, tp, EngineConfig(**overrides),
                                 draft_model=dm, draft_params=dp,
                                 device="cpu")
    assert str(got.value) == str(want.value)
