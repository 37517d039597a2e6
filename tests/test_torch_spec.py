"""Speculative decoding, swap preemption and the engine's control-plane
calls of the port, held against the JAX package.

Both packages get the same inputs: numpy-seeded logits and tokens for the
sampler-level functions, and for the engines the same requests on the same
weights (the reference's ``init_params``, bridged) -- a target, and as
drafts the target itself (everything accepted) or a cold model from
another seed (almost nothing accepted). Token streams, ``StreamDelta``
frames, finish reasons and ``stats`` must be identical under greedy and
seeded top-p on both backends. The rollback contract is held against the
port's own non-speculative replay (the reference's paged cell of it is
red). The port runs on ``device="cpu"``, where each kernel wrapper runs its
plain version.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model
from repro_torch.serving import backends as tbackends
from repro_torch.serving.backends import PagedBackend
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams
from test_torch_engine import _port_request, _serve

PAGE = 16
GREEDY = dict(temperature=0.0)
TOPP = dict(temperature=0.8, top_p=0.9)
SAMPLING = {"greedy": GREEDY, "topp": TOPP}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bridge(jax_lm):
    """The port's LM and a JAX ``(cfg, model, params)``'s weights."""
    cfg, _, params = jax_lm
    tcfg = reduced(REGISTRY[cfg.name])
    return make_model(tcfg), params_from_jax_numpy(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


@pytest.fixture(scope="module")
def port_llama(llama):
    return _bridge(llama)


@pytest.fixture(scope="module")
def cold(lm_factory):
    """A cold draft (same arch, seed 99) for both packages:
    ((jax model, jax params), (port model, port params))."""
    jl = lm_factory(seed=99)
    return jl[1:], _bridge(jl)


def _port_engine(model, params, *, draft=None, **overrides):
    kw = dict(max_slots=4, max_seq_len=128, backend="paged", page_size=PAGE)
    kw.update(overrides)
    dm, dp = draft if draft is not None else (None, None)
    return ContinuousBatchingEngine(model, params, EngineConfig(**kw),
                                    draft_model=dm, draft_params=dp,
                                    device="cpu")


def _both(jeng, teng, reqs, preempt_at=None):
    """Serve ``reqs`` on the JAX engine and the port's; assert identical
    outputs, frames and stats. Returns the port's outputs."""
    jouts, jframes = _serve(jeng, copy.deepcopy(reqs), preempt_at)
    tbackends.reset_transfer_stats()
    touts, tframes = _serve(teng, [_port_request(r) for r in reqs],
                            preempt_at)
    assert len(touts) == len(reqs)
    assert touts == jouts
    assert tframes == jframes
    assert teng.stats == jeng.stats
    assert teng.cache_stats() == jeng.cache_stats()
    # the fused and verify paths never move logits to the host
    assert tbackends.TRANSFER_STATS["decode_logits_transfers"] == 0
    return touts


# ---------------------------------------------------------------------------
# sampler level: the same numpy-seeded inputs through both packages
# ---------------------------------------------------------------------------

def _st(rng, B, *, temps, seed_base, n_gen, stop_tok=None, gen_limit=None,
        active=None):
    """Per-slot decode state as numpy, in the engines' dtypes."""
    return {
        "tokens": rng.integers(0, 64, size=B).astype(np.int32),
        "n_gen": np.asarray(n_gen, np.int32),
        "temps": np.asarray(temps, np.float32),
        "top_ps": np.full((B,), 0.9, np.float32),
        "seed_base": np.asarray(seed_base, np.uint32),
        "stop_tok": np.asarray(stop_tok if stop_tok is not None
                               else [-1] * B, np.int32),
        "gen_limit": np.asarray(gen_limit if gen_limit is not None
                                else [2 ** 31 - 1] * B, np.int32),
        "active": np.asarray(active if active is not None else [True] * B),
    }


def _jst(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _tst(st):
    return tbackends._upload_state(st, "cpu")


@pytest.mark.parametrize("case", ["greedy", "topp", "topp-seed-near-2^32"])
def test_spec_targets_match_jax(case):
    from repro.serving.sampler import spec_targets as jspec_targets
    from repro_torch.serving.sampler import spec_targets
    rng = np.random.default_rng(0)
    B, T, V = 3, 5, 97
    logits = rng.standard_normal((B, T, V)).astype(np.float32) * 3
    temps = [0.0] * B if case == "greedy" else [0.8, 1.0, 0.6]
    # near 2^32 the fold base + n_gen + j wraps inside the block
    bases = ([2 ** 32 - 2, 2 ** 32 - 1, 2 ** 32 - 4]
             if case.endswith("2^32") else [11, 1_000_003, 2 ** 31 - 2])
    st = _st(rng, B, temps=temps, seed_base=bases, n_gen=[0, 3, 9])
    want = np.asarray(jspec_targets(
        jnp.asarray(logits), jnp.asarray(st["temps"]),
        jnp.asarray(st["top_ps"]), jnp.asarray(st["seed_base"]),
        jnp.asarray(st["n_gen"])))
    t = _tst(st)
    got = spec_targets(torch.from_numpy(logits), t["temps"], t["top_ps"],
                       t["seed_base"], t["n_gen"])
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_spec_accept_matches_jax():
    from repro.serving.sampler import spec_accept as jspec_accept
    from repro_torch.serving.sampler import spec_accept
    rng = np.random.default_rng(1)
    B, k = 6, 4
    targets = rng.integers(0, 5, size=(B, k + 1)).astype(np.int32)
    draft = rng.integers(0, 5, size=(B, k)).astype(np.int32)
    draft[0] = targets[0, :k]                  # everything accepted
    draft[1, :2] = targets[1, :2]              # a mismatch at j = 2
    draft[2, 0] = targets[2, 0] + 1            # a mismatch at j = 0
    jemit, jn = jspec_accept(jnp.asarray(targets), jnp.asarray(draft))
    emit, n = spec_accept(torch.from_numpy(targets), torch.from_numpy(draft))
    assert np.array_equal(emit.numpy(), np.asarray(jemit))
    assert np.array_equal(n.numpy(), np.asarray(jn))
    assert n.numpy()[0] == k + 1 and n.numpy()[2] == 1


@pytest.mark.parametrize("sampling", ["greedy", "topp"])
def test_spec_accept_and_latch_matches_jax(sampling):
    """Stop token mid-block (slot 0), generation limit mid-block (slot 1),
    an inactive slot (2), an all-accepted slot (3) and a mismatch (4)."""
    from repro.serving.backends import (
        _spec_accept_and_latch as jspec_accept_and_latch)
    from repro.serving.sampler import spec_targets as jspec_targets
    rng = np.random.default_rng(2)
    B, k, V = 5, 4, 64
    logits = rng.standard_normal((B, k + 1, V)).astype(np.float32) * 4
    temps = [0.0] * B if sampling == "greedy" else [0.9] * B
    st = _st(rng, B, temps=temps, seed_base=[5, 6, 7, 8, 9],
             n_gen=[1, 4, 2, 0, 7], gen_limit=[99, 7, 99, 99, 99],
             active=[True, True, False, True, True])
    targets = np.asarray(jspec_targets(
        jnp.asarray(logits), jnp.asarray(st["temps"]),
        jnp.asarray(st["top_ps"]), jnp.asarray(st["seed_base"]),
        jnp.asarray(st["n_gen"])))
    draft = targets[:, :k].copy()              # accept everything ...
    draft[4, 1] = (targets[4, 1] + 1) % V      # ... but slot 4 at j = 1
    st["stop_tok"][0] = targets[0, 2]          # stop inside the block
    jout = jspec_accept_and_latch(_jst(st), jnp.asarray(logits),
                                  jnp.asarray(draft))
    tout = tbackends._spec_accept_and_latch(
        _tst(st), torch.from_numpy(logits), torch.from_numpy(draft))
    for j, t in zip(jout[:3], tout[:3]):
        assert np.array_equal(t.numpy(), np.asarray(j))
    for key in ("tokens", "n_gen"):
        assert np.array_equal(tout[3][key].numpy(), np.asarray(jout[3][key]))
    produced = tout[1].numpy()
    # slot 0 stops where its stop token first appears (target 2 or earlier)
    assert produced[0] == 1 + int(np.argmax(targets[0] == targets[0, 2]))
    assert produced[1] == 3 and produced[2] == 0
    assert produced[3] == k + 1 and produced[4] == 2
    assert tout[2].numpy().tolist() == [True, True, False, False, False]


@pytest.mark.parametrize("kv_major", [True, False],
                         ids=["kv-heads-major", "seq-major"])
def test_spec_block_attention_matches_jax(kv_major):
    from repro.serving.backends import (
        _spec_block_attention as jspec_block_attention)
    rng = np.random.default_rng(3)
    B, T, H, KH, D, S = 3, 5, 4, 2, 16, 40
    q = rng.standard_normal((B, T, H, D)).astype(np.float32)
    shape = (B, KH, S, D) if kv_major else (B, S, KH, D)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    lens = np.asarray([0, 17, S - T], np.int32)
    want = np.asarray(jspec_block_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        kv_major=kv_major))
    got = tbackends._spec_block_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(lens), kv_major=kv_major).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


# ---------------------------------------------------------------------------
# engine parity: token streams, frames and stats identical to the JAX engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("draft_kind", ["self", "cold"])
@pytest.mark.parametrize("sampling", ["greedy", "topp"])
@pytest.mark.parametrize("backend", ["paged", "slots"])
def test_spec_engine_identical_to_jax(backend, sampling, draft_kind, llama,
                                      port_llama, cold, engine_factory,
                                      request_factory):
    cfg, model, params = llama
    tmodel, tparams = port_llama
    # the kernel tier, as on the card (here each wrapper runs its plain
    # version; the JAX engine its XLA twin of the Pallas kernels)
    kw = dict(max_slots=3, max_seq_len=96, backend=backend, page_size=PAGE,
              spec_tokens=4, use_kernel=True)
    jdraft, tdraft = (((model, params), port_llama) if draft_kind == "self"
                      else cold)
    reqs = request_factory(cfg.vocab_size, n=3, **SAMPLING[sampling])
    teng = _port_engine(tmodel, tparams, draft=tdraft, **kw)
    _both(engine_factory(model, params, draft=jdraft, **kw), teng, reqs)
    assert teng.stats["spec_rounds"] > 0
    rate = teng.spec_acceptance_rate()
    assert rate > 0.8 if draft_kind == "self" else rate < 0.2


@pytest.mark.parametrize("sampling", ["greedy", "topp"])
def test_spec_with_chunked_prefill_and_prefix_cache(sampling, llama,
                                                    port_llama,
                                                    engine_factory,
                                                    request_factory):
    """Rounds pause while prompts ingest; shared pages are COW'd under the
    verify writes."""
    cfg, model, params = llama
    kw = dict(max_slots=3, max_seq_len=128, page_size=PAGE,
              chunked_prefill_budget=24, enable_prefix_cache=True,
              spec_tokens=4)
    rng = np.random.default_rng(3)
    shared = rng.integers(2, cfg.vocab_size, size=2 * PAGE).tolist()
    prompts = [list(shared), list(shared)] + [
        shared + rng.integers(2, cfg.vocab_size, size=9).tolist()
        for _ in range(3)]
    reqs = request_factory(cfg.vocab_size, prompts=prompts, max_tokens=16,
                           **SAMPLING[sampling])
    teng = _port_engine(*port_llama, draft=port_llama, **kw)
    _both(engine_factory(model, params, draft=(model, params), **kw), teng,
          reqs)
    assert teng.stats["spec_rounds"] > 0
    assert teng.cache_stats()["cow_copies"] >= 1
    assert teng.cache_stats()["hit_tokens"] > 0


def test_spec_stop_token_mid_round(llama, port_llama, engine_factory,
                                   request_factory):
    """A stop token inside the accepted prefix truncates the round at
    exactly the token of the per-step path."""
    cfg, model, params = llama
    kw = dict(max_slots=2, max_seq_len=96, page_size=PAGE)
    samp = dict(max_tokens=24, temperature=0.9, top_p=0.95)
    (probe,) = request_factory(cfg.vocab_size, n=1, **samp)
    eng = engine_factory(model, params, **kw)
    eng.add_request(probe)
    toks = eng.run_to_completion()[0].output_tokens
    first = {}
    for j, t in enumerate(toks):
        first.setdefault(t, j)
    # a stop token that lands inside a round, not on its last position
    j0, stop = min((j, t) for t, j in first.items()
                   if 2 <= j < 20 and (j + 1) % 5 != 0)
    reqs = request_factory(cfg.vocab_size, n=2, stop=stop, **samp)
    kw["spec_tokens"] = 4
    touts = _both(engine_factory(model, params, draft=(model, params), **kw),
                  _port_engine(*port_llama, draft=port_llama, **kw), reqs)
    assert touts["r0"][1] == "stop" and len(touts["r0"][0]) == j0 + 1


@pytest.mark.parametrize("backend", ["paged", "slots"])
def test_spec_draft_resyncs_after_fused_fallback(backend, llama, port_llama,
                                                 cold, engine_factory,
                                                 request_factory):
    """A long prompt admitted mid-stream forces fused-fallback rounds (the
    draft cache stands still while the target advances); when speculation
    resumes the draft catches up on the tokens it missed."""
    cfg, model, params = llama
    kw = dict(max_slots=4, max_seq_len=128, backend=backend, page_size=PAGE,
              chunked_prefill_budget=8, spec_tokens=4)

    def drive(eng, request):
        (r0,) = request_factory(cfg.vocab_size, n=1, plen=10, max_tokens=30,
                                seed0=0)
        late = request_factory(cfg.vocab_size, n=1, plen=70, max_tokens=8,
                               seed0=1, rng_seed=11)[0]
        late.request_id = "late"
        frames = []
        eng.add_request(request(r0), on_delta=frames.append)
        eng.step()
        eng.step()                       # r0 decoding, spec rounds begin
        eng.add_request(request(late), on_delta=frames.append)
        outs = eng.run_to_completion()
        return ({o.request_id: o.output_tokens for o in outs},
                [(f.id, f.offset, f.tokens) for f in frames])

    jeng = engine_factory(model, params, draft=cold[0], **kw)
    teng = _port_engine(*port_llama, draft=cold[1], **kw)
    assert drive(teng, _port_request) == drive(jeng, copy.deepcopy)
    assert teng.stats == jeng.stats
    assert teng.stats["spec_rounds"] > 0


def test_spec_preempt_restore(llama, port_llama, engine_factory,
                              request_factory):
    """Preemption composes with speculation: the draft mirror is rebuilt
    on restore."""
    cfg, model, params = llama
    kw = dict(max_slots=3, max_seq_len=96, page_size=PAGE, spec_tokens=3,
              scheduling_policy="priority", enable_preemption=True,
              enable_prefix_cache=True)
    reqs = request_factory(cfg.vocab_size, n=2, plen=20, max_tokens=20,
                           **TOPP)
    teng = _port_engine(*port_llama, draft=port_llama, **kw)
    _both(engine_factory(model, params, draft=(model, params), **kw), teng,
          reqs, preempt_at=(3, "r0"))
    assert teng.stats["restores"] == 1 and teng.stats["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# rollback: the KV a speculating engine leaves == a non-speculative replay
# ---------------------------------------------------------------------------

def _seq_kv(eng, rid):
    """(length, [K rows, V rows] over [0, length)) of one sequence."""
    be = eng.backend
    if isinstance(be, PagedBackend):
        table, n, ps = be.kv._tables[rid], be.kv.length(rid), be.page_size
        return n, [torch.stack([pool[:, table[p // ps], p % ps]
                                for p in range(n)], 1)
                   for pool in (be.pools["k"], be.pools["v"])]
    s = be.slot(rid)
    n = int(be.cache["len"][s])
    return n, [be.cache[c][:, s, :, :n].clone() for c in ("k", "v")]


@pytest.mark.parametrize("backend", ["paged", "slots"])
def test_spec_rollback_leaves_kv_as_nonspec_replay(backend, port_llama, cold,
                                                   request_factory):
    """Mid-generation, the speculating engine's per-sequence KV (COW'd
    prefix pages included) equals a non-speculative engine's replayed to
    the same token counts: equal lengths and streams, KV within 1e-5."""
    tmodel, tparams = port_llama
    vocab = tmodel.cfg.vocab_size
    kw = dict(max_slots=3, max_seq_len=128, backend=backend)
    if backend == "paged":
        kw["enable_prefix_cache"] = True
    rng = np.random.default_rng(3)
    shared = rng.integers(2, vocab, size=2 * PAGE).tolist()
    prompts = [list(shared), list(shared),
               shared + rng.integers(2, vocab, size=7).tolist()]

    def requests():
        return [_port_request(r) for r in request_factory(
            vocab, prompts=prompts, max_tokens=40)]

    es = _port_engine(tmodel, tparams, draft=cold[1], spec_tokens=4, **kw)
    for r in requests():
        es.add_request(r)
    for _ in range(6):                   # stop mid-flight, caches still live
        es.step()
    assert es.running and es.stats["spec_rounds"] > 0
    want = {rid: list(run.output_tokens) for rid, run in es.running.items()}
    spec_kv = {rid: _seq_kv(es, rid) for rid in es.running}

    en = _port_engine(tmodel, tparams, **kw)
    for r in requests():
        en.add_request(r)
    got = {}
    for _ in range(100):
        if len(got) == len(want):
            break
        en.step()
        for rid, run in en.running.items():
            if rid in want and rid not in got \
                    and len(run.output_tokens) == len(want[rid]):
                assert run.output_tokens == want[rid]
                got[rid] = _seq_kv(en, rid)
    assert set(got) == set(want)
    for rid in want:
        (n_s, kv_s), (n_r, kv_r) = spec_kv[rid], got[rid]
        assert n_s == n_r
        for a, b in zip(kv_s, kv_r):
            torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_verify_logits_match_sequential_decode(port_llama):
    """Teacher-forced: the verify forward's (B, T, V) logits equal T
    sequential decode steps fed the same tokens (float32, 1e-4 of
    scale)."""
    tmodel, tparams = port_llama
    V = tmodel.cfg.vocab_size
    rng = np.random.default_rng(4)
    be = PagedBackend(tmodel, tparams, max_slots=3, max_len=96,
                      page_size=PAGE, device="cpu")
    for i, n in enumerate((20, 33)):           # slot 2 stays free
        be.prefill(f"s{i}", rng.integers(2, V, size=n).tolist())
    toks = rng.integers(2, V, size=(3, 5))
    block = be.verify_logits(toks).numpy()
    assert be.kv.length("s0") == 20 and be.kv.length("s1") == 33
    for j in range(toks.shape[1]):
        step = be.decode_batch(toks[:, j])
        live = np.asarray([be.seq_of.get(s) is not None for s in range(3)])
        scale = np.abs(step[live]).max()
        assert np.abs(block[live, j] - step[live]).max() <= 1e-4 * scale


# ---------------------------------------------------------------------------
# swap preemption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling", ["greedy", "topp"])
def test_swap_preempt_restore_identical_to_jax(sampling, llama, port_llama,
                                               engine_factory):
    """The swap cell of the reference's preempt/restore test: tokens equal
    to the JAX engine's (and to an uninterrupted run), one swap out and
    in, and the host blob's K/V equal to the reference's blob."""
    cfg, model, params = llama
    kw = dict(max_slots=3, max_seq_len=96, page_size=PAGE, preempt_swap=True,
              scheduling_policy="priority", enable_preemption=True)
    rng = np.random.default_rng(11)
    req = InferenceRequest(
        model="m", prompt_tokens=rng.integers(2, cfg.vocab_size,
                                              size=20).tolist(),
        request_id="solo", qos="batch",
        sampling=SamplingParams(max_tokens=24, seed=5, **SAMPLING[sampling]))
    from repro.serving.request import (InferenceRequest as JReq,
                                       SamplingParams as JSP)
    jreq = JReq(model="m", prompt_tokens=list(req.prompt_tokens),
                request_id="solo", qos="batch",
                sampling=JSP(max_tokens=24, seed=5, **SAMPLING[sampling]))
    ref_eng = _port_engine(*port_llama, **kw)
    ref_eng.add_request(copy.deepcopy(req))
    ref = ref_eng.run_to_completion()[0].output_tokens

    outs = {}
    blobs = {}
    for name, eng, r in (
            ("jax", engine_factory(model, params, **kw), jreq),
            ("port", _port_engine(*port_llama, **kw), req)):
        eng.add_request(copy.deepcopy(r))
        got = []
        for _ in range(6):
            got += eng.step()
        assert eng.preempt("solo")
        assert eng.num_running == 0 and eng.num_waiting == 1
        blobs[name] = eng._preempted["solo"].swap_blob
        while eng.has_work():
            got += eng.step()
        outs[name] = (got[0].output_tokens, dict(eng.stats))
    assert outs["port"] == outs["jax"]
    assert outs["port"][0] == ref
    stats = outs["port"][1]
    assert stats["swap_outs"] == 1 and stats["swap_ins"] == 1
    assert stats["preemptions"] == 1 and stats["restores"] == 1
    assert blobs["port"]["n_tokens"] == blobs["jax"]["n_tokens"]
    for key in ("k", "v"):
        np.testing.assert_allclose(blobs["port"][key].numpy(),
                                   np.asarray(blobs["jax"][key]),
                                   atol=1e-5, rtol=1e-5)


def test_swap_round_trip_is_exact(port_llama):
    """swap_out -> swap_in -> swap_out of one sequence gives back the same
    bytes, into other pages."""
    tmodel, tparams = port_llama
    rng = np.random.default_rng(5)
    be = PagedBackend(tmodel, tparams, max_slots=2, max_len=96,
                      page_size=PAGE, device="cpu")
    be.prefill("other", rng.integers(2, 200, size=17).tolist())
    be.prefill("s", rng.integers(2, 200, size=37).tolist())
    first = be.swap_out("s")
    pages = list(be.kv._tables["s"])
    be.free("s")
    be.prefill("squat", rng.integers(2, 200, size=40).tolist())
    be.free("other")
    be.swap_in("s", 37, first)
    assert be.kv._tables["s"] != pages and "s" in be.decoding
    second = be.swap_out("s")
    assert second["n_tokens"] == first["n_tokens"] == 37
    for key in ("k", "v"):
        assert first[key].shape == (tmodel.cfg.num_layers, 3, PAGE,
                                    tmodel.cfg.num_kv_heads,
                                    tmodel.cfg.head_dim)
        assert torch.equal(first[key], second[key])
    with pytest.raises(AssertionError, match="swap blob holds"):
        be.swap_in("t", 36, first)


# ---------------------------------------------------------------------------
# control-plane calls
# ---------------------------------------------------------------------------

def _assert_backend_clean(backend, max_slots):
    kv = backend.kv
    assert len(backend.slot_of) == 0 and backend.seq_of == {}
    assert sorted(backend.free_slots) == list(range(max_slots))
    assert backend.decoding == set()
    assert kv._tables == {} and kv._lens == {} and kv._ref == {}
    assert kv.free_pages == kv.num_pages - 1


@pytest.mark.parametrize("where", ["queued", "prefilling", "running"])
def test_abort_identical_to_jax(where, llama, port_llama, engine_factory,
                                shared_prefix_prompts):
    """Abort of a queued, a mid-chunked-prefill and a running request
    (with a speculative draft mirror and the prefix cache): the same
    return values, stats and later outputs as the JAX engine, and every
    slot and page of both backends freed."""
    cfg, model, params = llama
    kw = dict(max_slots=3, max_seq_len=96, page_size=PAGE,
              enable_prefix_cache=True, chunked_prefill_budget=8,
              spec_tokens=2)
    prompts = shared_prefix_prompts(cfg.vocab_size, 2, n_shared=32,
                                    n_tail=16)
    from repro.serving.request import (InferenceRequest as JReq,
                                       SamplingParams as JSP)

    def script(eng, R, S):
        def req(rid, p, n=3):
            return R(model="m", prompt_tokens=list(p), request_id=rid,
                     sampling=S(max_tokens=n))
        eng.add_request(req("twin", prompts[0]))
        eng.run_to_completion()          # its pages park in the LRU
        eng.add_request(req("victim", prompts[1], n=40))
        if where != "queued":
            eng.step()
            assert "victim" in eng.prefilling   # still ingesting its prompt
        for _ in range(4 if where == "running" else 0):
            eng.step()
        assert ("victim" in eng.running) == (where == "running")
        state = (eng.abort("victim"), eng.abort("victim"), eng.has_work(),
                 dict(eng.stats))
        if where != "queued":
            _assert_backend_clean(eng.backend, 3)
            _assert_backend_clean(eng.draft_backend, 3)
        eng.add_request(req("again", prompts[1]))
        outs = eng.run_to_completion()
        return state, [(o.request_id, o.output_tokens, o.finish_reason,
                        o.metrics.cached_prompt_tokens) for o in outs], \
            dict(eng.stats), eng.cache_stats()

    jres = script(engine_factory(model, params, draft=(model, params), **kw),
                  JReq, JSP)
    tres = script(_port_engine(*port_llama, draft=port_llama, **kw),
                  InferenceRequest, SamplingParams)
    assert tres == jres
    assert tres[0][:3] == (True, False, False)
    assert tres[0][3]["aborted"] == 1


@pytest.mark.parametrize("policy", ["fcfs", "priority-budget"])
def test_queue_views_and_saturated_identical_to_jax(policy, llama, port_llama,
                                                    engine_factory,
                                                    request_factory):
    """``num_running``, ``num_waiting``, ``waiting`` (policy order) and
    ``saturated`` step by step, as the JAX engine reports them; the
    budget case covers a queue whose head is over its class budget."""
    cfg, model, params = llama
    kw = dict(max_slots=2, max_seq_len=96, page_size=PAGE)
    if policy == "priority-budget":
        kw.update(scheduling_policy="priority",
                  qos_token_budgets={"batch": 30})
    reqs = request_factory(cfg.vocab_size, n=4, plen=10, max_tokens=6)
    for i, r in enumerate(reqs):
        r.qos = "batch" if i % 2 else "interactive"

    def trace(eng, reqs):
        seen = [(eng.saturated(), eng.num_running, eng.num_waiting)]
        for r in reqs:
            eng.add_request(r)
        while eng.has_work():
            seen.append((eng.saturated(), eng.num_running, eng.num_waiting,
                         [r.request_id for r in eng.waiting]))
            eng.step()
        return seen

    jseen = trace(engine_factory(model, params, **kw), copy.deepcopy(reqs))
    tseen = trace(_port_engine(*port_llama, **kw),
                  [_port_request(r) for r in reqs])
    assert tseen == jseen
    assert any(s[0] for s in tseen[1:])        # a queue formed


@pytest.mark.parametrize("k", [1, 7, 23])
@pytest.mark.parametrize("sampling", ["greedy", "topp"])
def test_resume_request_identical_to_jax(sampling, k, llama, port_llama,
                                         engine_factory, request_factory):
    """Cross-engine resume after k generated tokens: the stitched output
    equals an uninterrupted run and the JAX engine's, frames continue at
    offset k, and the stats match (``resumed_tokens`` included)."""
    cfg, model, params = llama
    (req,) = request_factory(cfg.vocab_size, n=1, plen=20, max_tokens=24,
                             **SAMPLING[sampling])
    ref_eng = _port_engine(*port_llama)
    ref_eng.add_request(_port_request(req))
    (ref,) = ref_eng.run_to_completion()
    assert len(ref.output_tokens) == 24

    def resume(eng, r):
        frames = []
        eng.resume_request(r, ref.output_tokens[:k], on_delta=frames.append)
        (out,) = eng.run_to_completion()
        return (out.output_tokens, dict(eng.stats),
                [(f.index, f.offset, f.n_tokens, f.tokens, f.finished)
                 for f in frames])

    jres = resume(engine_factory(model, params), copy.deepcopy(req))
    tres = resume(_port_engine(*port_llama), _port_request(req))
    assert tres == jres
    toks, stats, frames = tres
    assert toks == ref.output_tokens
    assert stats["resumed_tokens"] == k and stats["restores"] == 1
    assert frames[0][1] == k
    assert [t for f in frames for t in f[3]] == ref.output_tokens[k:]
    assert all(f[1] + f[2] == g[1] for f, g in zip(frames, frames[1:]))
