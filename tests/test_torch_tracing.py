"""The serving engine's spans and counters (``repro_torch.serving.tracing``)
on the tiny paged MoE engine, on the CPU: chunked prefill over a prefix
cache, fused K = 8 decode, arrivals between steps and finishes, one
request long enough to clamp K at ``max_seq_len``. The recorder runs on an
injected tick clock, so every span is strictly ordered.

Held here: the span tree (every span inside its parent, under one
``step``), the K = 1 counters against a count taken by wrapping the
backend, one ``queue`` span per admission, a ``sync`` span at every
blocking transfer site of both backends, the legacy path, swapping and
speculation; tokens, ``stats`` and ``cache_stats()`` unchanged by
recording; nothing recorded while off; a ``torch.profiler`` session
turning recording on, and the next one clearing it.
"""
import collections
import itertools

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams
from repro_torch.serving.tracing import RECORDER, Recorder

ARCH = "phi3.5-moe-42b-a6.6b"
MAX_LEN = 128
SHARED = list(range(1, 40))          # two full pages of 16 and a part


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    model = make_model(reduced(REGISTRY[ARCH]))
    g = torch.Generator(device="cpu")
    g.manual_seed(0)
    return model, model.init_params(g)


@pytest.fixture(autouse=True)
def recorder(monkeypatch):
    """The process's recorder, off and empty, on a clock that ticks by one
    at every reading."""
    ticks = itertools.count(1000)
    monkeypatch.setattr(RECORDER, "clock", lambda: next(ticks))
    RECORDER.disable()
    RECORDER.refresh()
    RECORDER.clear()
    yield RECORDER
    RECORDER.disable()
    RECORDER.refresh()
    RECORDER.clear()


def _engine(lm, draft=False, **over):
    model, params = lm
    kw = dict(backend="paged", page_size=16, max_slots=4,
              max_seq_len=MAX_LEN, num_pages=40, enable_prefix_cache=True,
              chunked_prefill_budget=32, decode_steps_per_sync=8,
              use_kernel=True)
    kw.update(over)
    if draft:
        return ContinuousBatchingEngine(model, params, EngineConfig(**kw),
                                        draft_model=model,
                                        draft_params=params, device="cpu")
    return ContinuousBatchingEngine(model, params, EngineConfig(**kw),
                                    device="cpu")


def _arrivals():
    """{step: requests}: a shared prefix, mixed lengths, half seeded top-p;
    r5's prompt and budget run it to ``max_seq_len``."""
    out = collections.defaultdict(list)
    for i in range(6):
        n = 96 if i == 5 else 5 + 7 * i
        out[(0, 0, 2, 3, 6, 9)[i]].append(InferenceRequest(
            model=ARCH, prompt_tokens=SHARED + [50 + i] * (n - len(SHARED)
                                                           if i == 5 else n),
            request_id=f"r{i}",
            sampling=SamplingParams(max_tokens=40 if i == 5 else 6 + 3 * i,
                                    temperature=0.8 if i % 2 else 0.0,
                                    top_p=0.9, seed=i)))
    return out


def _serve(eng, preempt=None):
    """Steps the engine through the arrivals to the end. ``preempt``:
    (step, rid) preempted after that step. Returns (outputs, frames)."""
    arrivals, frames, outs, step = _arrivals(), [], {}, 0
    while step <= max(arrivals) or eng.has_work():
        for r in arrivals.get(step, ()):
            eng.add_request(r, on_delta=frames.append)
        for o in eng.step():
            outs[o.request_id] = (o.output_tokens, o.finish_reason, o.metrics)
        if preempt and step == preempt[0]:
            assert eng.preempt(preempt[1])
        step += 1
    return outs, [(f.id, f.index, f.offset, f.tokens, f.finished)
                  for f in frames]


def _calls(eng):
    """Wraps the backend's ``fused_decode`` on the instance: each call's
    (K asked, batch re-seeded, prefill in flight, K run)."""
    calls, fused = [], eng.backend.fused_decode

    def counted(K, host_state=None):
        out = fused(K, host_state)
        calls.append((K, host_state is not None, bool(eng.prefilling),
                       out[0].shape[0]))
        return out
    eng.backend.fused_decode = counted
    return calls


def _sites():
    return {s.attrs["site"] for s in RECORDER.spans if s.name == "sync"}


def test_spans_nest_under_one_step(lm):
    RECORDER.enable()
    _serve(_engine(lm))
    spans = RECORDER.spans
    assert spans and RECORDER.dropped == 0
    names = collections.Counter(s.name for s in spans)
    for name in ("step", "admit", "queue", "prefill.chunk", "first_token",
                 "decode.prep", "decode.issue", "decode.sync", "decode.emit",
                 "sync"):
        assert names[name], name
    for i, s in enumerate(spans):
        assert s.t0 < s.t1, s
        if s.name in ("step", "queue"):
            assert s.parent is None, s
            continue
        root = s
        while root.parent is not None:
            parent = spans[root.parent]
            assert root.parent < i and parent.t0 < root.t0 \
                and root.t1 < parent.t1, (root, parent)
            root = parent
        assert root.name == "step", s
    for s in spans:
        if s.name == "step":
            assert set(s.attrs) == {"running", "prefilling", "waiting"}
        if s.name == "sync":
            assert spans[s.parent].name != "sync"


def test_k1_counters_match_a_count_by_cause(lm):
    eng = _engine(lm)
    calls = _calls(eng)
    RECORDER.enable()
    _serve(eng)
    c = RECORDER.counters
    prefill = sum(1 for K, _, pre, _ in calls if K == 1 and pre)
    changed = sum(1 for K, seeded, pre, _ in calls
                  if K == 1 and seeded and not pre)
    clamped = sum(1 for K, _, _, ran in calls if ran < K)
    assert prefill and changed and clamped
    assert all(K in (1, 8) for K, *_ in calls)
    assert c["decode_calls"] == len(calls)
    assert c["decode_k1.prefill"] == prefill
    assert c["decode_k1.batch_changed"] == changed
    issues = [s for s in RECORDER.spans if s.name == "decode.issue"]
    assert [(s.attrs["K"], s.attrs["K_run"]) for s in issues] \
        == [(K, ran) for K, _, _, ran in calls]
    assert all(s.attrs["max_slots"] == 4 and 1 <= s.attrs["live"] <= 4
               for s in issues)


def test_one_queue_span_per_admission(lm):
    eng = _engine(lm)
    admitted, start = [], eng.backend.start_prefill

    def counted(seq_id, prompt):
        admitted.append(seq_id)
        return start(seq_id, prompt)
    eng.backend.start_prefill = counted
    RECORDER.enable()
    outs, _ = _serve(eng)
    queued = [s for s in RECORDER.spans if s.name == "queue"]
    assert sorted(s.rid for s in queued) == sorted(admitted) \
        == sorted(outs)
    admits = {s.rid: s for s in RECORDER.spans if s.name == "admit"}
    for q in queued:
        assert q.t0 < q.t1 and admits[q.rid].t0 < q.t1 < admits[q.rid].t1
    for _, _, m in outs.values():
        assert m.queued_time <= m.admitted_time <= m.first_token_time


# the sites each engine reaches: the paged decode path, the slot
# backend's, the legacy per-step path, a swap preemption, speculation
SITES = {
    "paged": ({}, None, {"put.chunk", "put.tables",
                         "upload_state", "to_host", "first_token",
                         "sample_params"}),
    "slots": ({"backend": "slots", "enable_prefix_cache": False,
               "num_pages": None}, None,
              {"put.chunk", "upload_state", "to_host"}),
    "legacy": ({"fused_decode": False}, None,
               {"put.decode", "logits_to_host"}),
    "swap": ({"enable_preemption": True, "preempt_swap": True}, (4, "r0"),
             {"swap_out", "swap_in", "put.swap_in", "put.swap_out"}),
    "spec": ({"spec_tokens": 2, "decode_steps_per_sync": 1}, None,
             {"put.spec", "put.tables", "to_host"}),
}


@pytest.mark.parametrize("case", SITES)
def test_sync_spans_at_every_transfer_site(lm, case):
    over, preempt, sites = SITES[case]
    eng = _engine(lm, draft=case == "spec", **over)
    RECORDER.enable()
    _serve(eng, preempt)
    assert sites <= _sites(), sites - _sites()
    c = RECORDER.counters
    syncs = [s for s in RECORDER.spans if s.name == "sync"]
    assert sum(v for k, v in c.items() if k.startswith("syncs.")) \
        == sum(s.attrs["n"] for s in syncs)
    assert {s.attrs["h2d"] for s in syncs} == {True, False}
    if case == "spec":
        assert any(s.name == "spec.round" for s in RECORDER.spans)


def test_recording_changes_no_token_and_no_stat(lm):
    off = _engine(lm)
    want, want_frames = _serve(off)
    assert RECORDER.spans == [] and RECORDER.counters == {}
    RECORDER.enable()
    on = _engine(lm)
    got, got_frames = _serve(on)
    assert RECORDER.spans
    assert {k: v[:2] for k, v in got.items()} \
        == {k: v[:2] for k, v in want.items()}
    assert got_frames == want_frames
    assert on.stats == off.stats
    assert on.cache_stats() == off.cache_stats()


def test_off_records_nothing(lm):
    eng = _engine(lm)
    _serve(eng)
    assert not RECORDER.on
    assert RECORDER.spans == [] and RECORDER.counters == {}


def test_a_profiler_session_turns_recording_on_and_the_next_clears(lm):
    eng = _engine(lm)
    for r in _arrivals()[0]:
        eng.add_request(r)
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
        eng.step()
    steps = [s for s in RECORDER.spans if s.name == "step"]
    assert len(steps) == 2
    eng.step()                          # off again: the records stay
    assert not RECORDER.on
    assert [s for s in RECORDER.spans if s.name == "step"] == steps
    with profile(activities=[ProfilerActivity.CPU]):
        eng.step()
    assert len([s for s in RECORDER.spans if s.name == "step"]) == 1
    assert RECORDER.spans[0].t0 > steps[-1].t1


def test_recorder_cap_counts_what_it_drops():
    ticks = itertools.count()
    rec = Recorder(clock=lambda: next(ticks), cap=3)
    rec.enable()
    rec.refresh()
    with rec.span("step"):
        with rec.sync("put.x"):
            pass
        with rec.span("admit", "r0") as sp:
            sp.set(k=1)
            with rec.span("prefill.chunk"):
                pass
    rec.add("queue", 0, "r0")
    assert [s.name for s in rec.spans] == ["step", "sync", "admit"]
    assert rec.dropped == 2
    assert rec.spans[2].attrs == {"k": 1} and rec.spans[2].parent == 0
    assert rec.counters == {"syncs.put.x": 1}
    rec.disable()
    assert not rec.refresh()
    rec.count("decode_calls")
    assert "decode_calls" not in rec.counters
