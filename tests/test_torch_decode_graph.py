"""The paged backend's fused decode loop (``serving/backends.py``:
``_DecodeGraph``, the one fused loop ``_StepGraph`` over the paged
backend's static buffers), replayed as a CUDA graph on one card and issued
op by op elsewhere.

On the CPU both tiers run through the same loop: the kernel tier, its tails
sized for K = 8 whatever K a call runs, must give the token streams,
``produced`` and ``done`` of the reference tier, call by call, through a
changed batch (the state uploaded into the static buffers), table
refreshes, a K clamped by a tight pool, a copy-on-write page, and
sequences finishing in the middle of a call. ``decode_graph.eager`` counts
each of their steps. The reference tier, the slot backend and a mesh never
make a graph.

The tests marked ``card`` need an NVIDIA card and skip without one (run
them there with ``python -m pytest --noconftest -q
tests/test_torch_decode_graph.py``): replay against op-by-op issue on the
card, and the tail kernel at ``kt_cap = K_cap`` against ``kt_cap = K``.
This file imports no JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.kernels import _build
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import make_model
from repro_torch.serving import backends
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams
from repro_torch.serving.tracing import RECORDER

ARCH = "phi3.5-moe-42b-a6.6b"
MAX_LEN = 128
PREFIX = list(range(1, 41))          # two full pages of 16 and a part
K_CAP = 8


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def recorder():
    RECORDER.disable()
    RECORDER.refresh()
    RECORDER.enable()
    RECORDER.refresh()
    yield RECORDER
    RECORDER.disable()
    RECORDER.refresh()
    RECORDER.clear()


@pytest.fixture(scope="module")
def lm():
    model = make_model(reduced(REGISTRY[ARCH]))
    return model, model.init_params(torch.Generator().manual_seed(0))


def _engine(model, params, device="cpu", **over):
    kw = dict(backend="paged", page_size=16, max_slots=4,
              max_seq_len=MAX_LEN, num_pages=24, enable_prefix_cache=True,
              chunked_prefill_budget=32, decode_steps_per_sync=K_CAP,
              use_kernel=True)
    kw.update(over)
    return ContinuousBatchingEngine(model, params, EngineConfig(**kw),
                                    device=device)


def _with_tails(eng):
    """The engine's paged backend with its tails sized for K = 8 before
    the first call."""
    eng.backend._graph.reserve(K_CAP)
    return eng


def _record_calls(eng):
    """Wrap the backend's ``fused_decode``: (K asked, out, produced, done)
    of every call."""
    calls, fused = [], eng.backend.fused_decode

    def wrapped(K, host_state=None):
        out = fused(K, host_state)
        calls.append((K, *(np.array(a) for a in out)))
        return out
    eng.backend.fused_decode = wrapped
    return calls


def _req(i, prompt, n, top_p):
    return InferenceRequest(
        model=ARCH, prompt_tokens=prompt, request_id=f"r{i}",
        sampling=SamplingParams(max_tokens=n,
                                temperature=0.9 if top_p else 0.0,
                                top_p=0.9, seed=11 + i))


# scenario -> (num_pages, {step: [(prompt, max_tokens)]})
SCENARIOS = {
    # a 40-token prefix, then its first two pages alone (a page-aligned
    # full hit, recomputed into a copy-on-write page), short budgets that
    # finish inside a call, arrivals while others decode
    "mixed": (24, {0: [(PREFIX, 26), ([7] * 9, 5)],
                   2: [(PREFIX[:32], 13)],
                   5: [(PREFIX + [60 + j for j in range(21)], 30)],
                   9: [([90 + j for j in range(12)], 4), ([3] * 17, 19)]}),
    # five pages for two sequences of two pages each: the first to cross a
    # page takes the last free one, and the call runs as far as the
    # other's page holds
    "tight_pool": (6, {0: [([20 + j for j in range(28)], 4),
                           ([70 + j for j in range(30)], 14)]}),
}


def _serve(eng, scenario: str, top_p: bool):
    arrivals, outs, step = SCENARIOS[scenario][1], {}, 0
    n = 0
    while step <= max(arrivals) or eng.has_work():
        for prompt, max_tokens in arrivals.get(step, ()):
            eng.add_request(_req(n, prompt, max_tokens, top_p))
            n += 1
        for o in eng.step():
            outs[o.request_id] = (o.output_tokens, o.finish_reason)
        step += 1
        assert step < 500
    return outs


@pytest.mark.parametrize("k_run", [1, 3, 8])
@pytest.mark.parametrize("mode", ["greedy", "topp"])
@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_kernel_tier_matches_the_reference_tier_call_by_call(lm, scenario,
                                                             mode, k_run):
    model, params = lm
    top_p = mode == "topp"
    kw = dict(decode_steps_per_sync=k_run, num_pages=SCENARIOS[scenario][0])
    ref = _engine(model, params, use_kernel=False, **kw)
    want_calls = _record_calls(ref)
    want = _serve(ref, scenario, top_p)
    want_counters = dict(RECORDER.counters)
    RECORDER.clear()

    kernel = _with_tails(_engine(model, params, **kw))
    got_calls = _record_calls(kernel)
    got = _serve(kernel, scenario, top_p)
    c = dict(RECORDER.counters)

    assert got == want
    assert all(n for n, _ in got.values())
    assert len(got_calls) == len(want_calls)
    for (k, *a), (wk, *b) in zip(got_calls, want_calls):
        assert k == wk
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert kernel.stats == ref.stats
    assert kernel.cache_stats() == ref.cache_stats()
    # the run's state lives in the static buffers
    be = kernel.backend
    assert be._graph.k_cap == K_CAP and be._graph.graph is None
    assert be._dec_st is be._graph.st
    assert be._dev_tables[0] is be._graph.tables
    assert be._dev_tables[1] is be._graph.lens
    # what the run went through
    runs = [out.shape[0] for _, out, _, _ in got_calls]
    if scenario == "mixed":
        assert len(got) == 6 and be.cache_stats()["cow_copies"] >= 1
        assert c["syncs.upload_state"] > 8 and c["syncs.put.tables"] > 2
        if k_run > 1:
            assert any(done.any() and (produced[done] < out.shape[0]).any()
                       for _, out, produced, done in got_calls), \
                "no sequence finished inside a call"
    elif k_run > 1:
        assert any(n < k for (k, *_), n in zip(got_calls, runs)
                   if k == k_run), "no call was clamped by the pool"
    # every step issued op by op, counted; nothing captured or replayed
    assert c["decode_graph.eager"] == sum(runs) \
        == want_counters["decode_graph.eager"]
    assert "decode_graph.replay" not in c and "decode_graph.capture" not in c
    # no sync span inside a decode.issue span
    issues = {i for i, s in enumerate(RECORDER.spans)
              if s.name == "decode.issue"}
    assert issues and not [s for s in RECORDER.spans if s.name == "sync"
                           and s.parent in issues]


def test_a_larger_k_regrows_the_tails(lm):
    model, params = lm
    eng = _engine(model, params, decode_steps_per_sync=3)
    be = eng.backend
    _serve(eng, "mixed", top_p=False)
    assert be._graph.k_cap == 3
    tails = be._graph.tails
    be._graph.reserve(2)
    assert be._graph.tails is tails
    be._graph.reserve(5)
    assert be._graph.k_cap == 5 and be._graph.tails[0][0].shape[2] == 5


def test_speculation_over_the_static_buffers_matches_eager(lm):
    """Draft and target backends of both tiers through the one loop: the
    draft's proposal loop runs over the static buffers between its length
    resets and catch-ups, and the target's fused calls pick up the state
    the verify left elsewhere; a request run to ``max_seq_len`` makes the
    target fall back to a fused call. The kernel tier serves what the
    reference tier serves."""
    model, params = lm
    scenario = {**SCENARIOS["mixed"][1],
                6: [([40 + j for j in range(100)], 40)]}
    kw = dict(spec_tokens=3, decode_steps_per_sync=1, num_pages=40)
    outs, calls = [], []
    for use_kernel in (False, True):
        eng = ContinuousBatchingEngine(
            model, params, EngineConfig(**dict(
                backend="paged", page_size=16, max_slots=4,
                max_seq_len=MAX_LEN, enable_prefix_cache=True,
                chunked_prefill_budget=32, use_kernel=use_kernel, **kw)),
            draft_model=model, draft_params=params, device="cpu")
        if use_kernel:
            _with_tails(eng)
        calls.append(_record_calls(eng))
        arrivals, got, step, n = scenario, {}, 0, 0
        while step <= max(arrivals) or eng.has_work():
            for prompt, max_tokens in arrivals.get(step, ()):
                eng.add_request(_req(n, prompt, max_tokens, True))
                n += 1
            for o in eng.step():
                got[o.request_id] = (o.output_tokens, o.finish_reason)
            step += 1
        outs.append((got, dict(eng.stats)))
    assert outs[1] == outs[0]
    assert outs[1][1]["spec_rounds"] > 0
    assert len(calls[1]) == len(calls[0]) > 0
    for (k, *a), (wk, *b) in zip(calls[1], calls[0]):
        assert k == wk
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert eng.draft_backend._graph.k_cap == 4
    assert RECORDER.counters["decode_graph.eager"] > 0


@pytest.mark.parametrize("case", ["reference_tier", "slots", "mesh"])
def test_other_paths_never_make_a_graph(lm, case):
    model, params = lm
    over = {"reference_tier": dict(use_kernel=False),
            "slots": dict(backend="slots", enable_prefix_cache=False,
                          num_pages=None),
            "mesh": dict(mesh=make_local_mesh(1, 2, devices=["cpu"] * 2))}
    eng = _engine(model, params, **over[case])
    calls = _record_calls(eng)
    _serve(eng, "mixed", top_p=True)
    c = RECORDER.counters
    assert c["decode_graph.eager"] == sum(out.shape[0]
                                          for _, out, _, _ in calls) > 0
    assert "decode_graph.replay" not in c and "decode_graph.capture" not in c
    g = eng.backend._graph
    assert g.graph is None and not g.capture


def test_the_graph_engages_on_one_cuda_device_on_the_kernel_tier():
    """What the choice rests on: the kernel tier on one CUDA device
    replays; the reference tier, a mesh and the CPU do not."""
    cuda, cpu, shard = torch.device("cuda", 0), torch.device("cpu"), object()
    cfg = REGISTRY[ARCH]

    def captures(*a):
        return backends._captures_decode(cfg, *a, paged=True)
    assert captures(True, None, cuda)
    assert not captures(False, None, cuda)
    assert not captures(True, shard, cuda)
    assert not captures(True, None, cpu)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _card_model(dev):
    """The reduced MoE at a head size the paged kernel takes (64), bf16."""
    cfg = dataclasses.replace(reduced(REGISTRY[ARCH]), head_dim=64,
                              param_dtype="bfloat16")
    model = make_model(cfg)
    return model, model.init_params(
        torch.Generator(device=dev).manual_seed(0))


@pytest.mark.card
@pytest.mark.parametrize("mode", ["greedy", "topp"])
def test_card_replay_matches_eager_issue(card, mode):
    model, params = _card_model(card)
    top_p = mode == "topp"
    runs = {}
    for name in ("eager", "graph"):
        eng = _engine(model, params, device=card, num_pages=64)
        be = eng.backend
        assert be._graph.capture
        if name == "eager":
            be._graph.capture = False
        calls = _record_calls(eng)
        RECORDER.clear()
        _build.reset_launches()
        outs = _serve(eng, "mixed", top_p)
        torch.cuda.synchronize()
        runs[name] = (outs, calls, dict(_build.LAUNCHES),
                      dict(RECORDER.counters), list(RECORDER.spans), be)
    (want, want_calls, want_l, want_c, _, _) = runs["eager"]
    (got, got_calls, got_l, c, spans, be) = runs["graph"]
    assert got == want
    for (k, *a), (wk, *b) in zip(got_calls, want_calls, strict=True):
        assert k == wk
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    steps = sum(out.shape[0] for _, out, _, _ in got_calls)
    # a capture's warm-up is the call's real iteration, issued op by op
    assert c["decode_graph.replay"] + c["decode_graph.eager"] == steps \
        == want_c["decode_graph.eager"]
    assert c["decode_graph.eager"] == c["decode_graph.capture"] <= 2
    assert got_l["fused_decode_attention"] == want_l["fused_decode_attention"] \
        == model.cfg.num_layers * steps
    issues = {i for i, s in enumerate(spans) if s.name == "decode.issue"}
    assert issues and not [s for s in spans if s.name == "sync"
                           and s.parent in issues]
    assert be._graph.graph is not None


@pytest.mark.card
def test_card_tail_kernel_is_the_same_at_any_tail_capacity(card):
    """``fused_decode_attention`` with (B, K_cap, KH, D) tails gives, bit
    for bit, what the first K rows of the same tails give, for tail
    lengths up to K."""
    from repro_torch.kernels.paged_attention.ops import fused_decode_attention
    g = torch.Generator(device=card).manual_seed(3)
    B, KH, G, D, page, pps, NP = 9, 2, 4, 128, 64, 6, 60
    for dtype in (torch.bfloat16, torch.float32):
        def rnd(*shape):
            return torch.randn(shape, generator=g, device=card).to(dtype)
        q, kp, vp = rnd(B, KH * G, D), rnd(NP, page, KH, D), rnd(NP, page,
                                                                  KH, D)
        tables = torch.randint(1, NP, (B, pps), generator=g, device=card,
                               dtype=torch.int32)
        lens = torch.tensor([0, 1, 63, 64, 255, 256, 257, 300, 384],
                            dtype=torch.int32, device=card)
        kt, vt = rnd(B, K_CAP, KH, D), rnd(B, K_CAP, KH, D)
        for k in (1, 3, 7):
            tl = torch.randint(0, k + 1, (B,), generator=g, device=card,
                               dtype=torch.int32)
            full = fused_decode_attention(q, kp, vp, tables, lens, kt, vt, tl)
            cut = fused_decode_attention(q, kp, vp, tables, lens,
                                         kt[:, :k].contiguous(),
                                         vt[:, :k].contiguous(), tl)
            assert torch.equal(full, cut), (dtype, k)
