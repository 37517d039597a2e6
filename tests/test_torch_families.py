"""The moe, vlm and audio families of the port, its embedding and offline
engines, its /v1 API modules and its serving entry point, held against
the JAX package.

Weights come from the reference's own ``init_params`` (reduced configs,
float32) and cross through ``params_from_jax_numpy``; inputs are made with
numpy from a seed. Model outputs agree to 1e-4 (logits, caches) and 1e-5
(pooled embeddings), where the two frameworks differ only in the order of
their sums; engine token streams, ``StreamDelta`` frames, finish reasons
and ``stats`` are identical. The port runs on ``device="cpu"``, where
each kernel wrapper runs its plain version.
"""
import copy
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.api import schemas as jschemas
from repro.serving.embedding import EmbeddingEngine as JaxEmbeddingEngine
from repro.serving.offline import run_batch as jax_run_batch
from repro_torch.api import (FirstClient, StreamAssembler, errors, schemas,
                             to_inference_request)
from repro_torch.configs import REGISTRY, reduced
from repro_torch.launch import serve
from repro_torch.models import make_model
from repro_torch.models import transformer as tf_mod
from repro_torch.serving import engine as tengine
from repro_torch.serving.embedding import EmbeddingEngine
from repro_torch.serving.engine import EngineConfig
from repro_torch.serving.offline import run_batch
from repro_torch.serving.request import InferenceRequest, SamplingParams
from test_torch_engine import _port_request
from test_torch_spec import PAGE, SAMPLING, _both, _bridge, _port_engine

MOE, VLM, AUDIO = "phi3.5-moe-42b-a6.6b", "llava-next-34b", "hubert-xlarge"
TOL = 1e-4
EMB_TOL = 1e-5
GOLDEN = pathlib.Path(__file__).parent / "golden"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pair(lm_factory):
    """``pair(arch)`` -> (jax cfg, jax model, jax params, port model, port
    params), the port's weights bridged from the reference's."""
    cache = {}

    def build(arch):
        if arch not in cache:
            jl = lm_factory(arch)
            cache[arch] = (*jl, *_bridge(jl))
        return cache[arch]

    return build


def _close(t, j, tol=TOL):
    assert_allclose(t.float().numpy(), np.asarray(j), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# model facade
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_lm_builds_every_family(arch):
    """Every architecture of the registry builds, initialises and runs a
    prefill (the audio encoder from embeddings, the others from tokens)."""
    cfg = reduced(REGISTRY[arch])
    model = make_model(cfg)
    params = model.init_params(torch.Generator().manual_seed(0))
    if cfg.is_encoder:
        logits, cache = model.prefill(params, {"embeds": torch.zeros(
            1, 5, cfg.d_model)})
        assert cache is None and tuple(logits.shape) == (1, 5,
                                                         cfg.vocab_size)
    else:
        logits, cache = model.prefill(params, {"tokens": torch.ones(
            1, 5, dtype=torch.long)}, max_len=8)
        assert tuple(logits.shape) == (1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())


PREFILL_CASES = {
    "moe-grouped": (MOE, "tokens", "grouped"),
    "moe-dense": (MOE, "tokens", "dense"),
    "vlm-tokens": (VLM, "tokens", None),
    "vlm-embeds": (VLM, "embeds", None),
}


@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_prefill_and_decode_step_match_jax(pair, case):
    arch, inputs, moe_mode = PREFILL_CASES[case]
    cfg, model, params, tmodel, tparams = pair(arch)
    rng = np.random.default_rng(11)
    B, S, max_len = 2, 11, 16
    if inputs == "tokens":
        x = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    else:
        x = (rng.standard_normal((B, S, cfg.d_model)) * 0.02).astype(
            np.float32)
    kw = {} if moe_mode is None else {"moe_mode": moe_mode}
    jl, jc = model.prefill(params, {inputs: jnp.asarray(x)}, max_len=max_len,
                           **kw)
    tl, tc = tmodel.prefill(tparams, {inputs: torch.from_numpy(x)},
                            max_len=max_len, **kw)
    _close(tl, jl)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    nxt = rng.integers(2, cfg.vocab_size, size=(B,)).astype(np.int32)
    jl2, jc2 = model.decode_step(params, jnp.asarray(nxt), jc)
    tl2, tc2 = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc)
    _close(tl2, jl2)
    _close(tc2["v"], jc2["v"])
    assert tc2["len"].tolist() == [S + 1] * B


@pytest.mark.parametrize("use_kernel", [False, True])
def test_encoder_prefill_returns_every_position(pair, use_kernel):
    """hubert: non-causal, no rope; the logits of every position and no
    cache, as the reference. ``use_kernel`` routes attention through the
    flash wrapper (its plain version on the CPU)."""
    cfg, model, params, tmodel, tparams = pair(AUDIO)
    x = (np.random.default_rng(12).standard_normal((2, 9, cfg.d_model))
         * 0.5).astype(np.float32)
    jl, jc = model.prefill(params, {"embeds": jnp.asarray(x)})
    tl, tc = tmodel.prefill(tparams, {"embeds": torch.from_numpy(x)},
                            use_kernel=use_kernel)
    assert jc is None and tc is None
    assert tuple(tl.shape) == (2, 9, cfg.vocab_size)
    _close(tl, jl)


@pytest.mark.parametrize("arch", [MOE, AUDIO])
def test_forward_matches_jax(pair, arch):
    """``transformer.forward`` (hidden states and the summed aux loss; the
    moe case runs grouped mode with its capacity)."""
    from repro.models import transformer as jax_tf
    cfg, _, params, tmodel, tparams = pair(arch)
    x = (np.random.default_rng(13).standard_normal((2, 24, cfg.d_model))
         * 0.5).astype(np.float32)
    jh, ja = jax_tf.forward(params, jnp.asarray(x), cfg, remat=False)
    th, ta = tf_mod.forward(tparams, torch.from_numpy(x), tmodel.cfg)
    _close(th, jh)
    assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-5)
    if arch == MOE:
        assert float(ta) > 0


# ---------------------------------------------------------------------------
# serving engines: streams, frames and stats identical to the JAX engine
# ---------------------------------------------------------------------------

def _shared_prompts(vocab, n=4, seed=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab, size=2 * PAGE + 5).tolist()
    return [shared + rng.integers(2, vocab, size=6 + 5 * i).tolist()
            for i in range(n)]


ENGINE_CASES = {
    "moe-paged-greedy": (MOE, "paged", "greedy", False),
    "moe-paged-topp": (MOE, "paged", "topp", False),
    "moe-slots-greedy": (MOE, "slots", "greedy", False),
    "moe-slots-topp": (MOE, "slots", "topp", False),
    "moe-paged-spec-topp": (MOE, "paged", "topp", True),
    "vlm-paged-topp": (VLM, "paged", "topp", False),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_identical_to_jax(pair, engine_factory, request_factory,
                                 case):
    """Chunked prefill (budget 16), K = 4 decode, the kernel tier; on the
    paged backend the prefix cache too; the spec case speculates with the
    target as its own draft (k = 3)."""
    arch, backend, sampling, spec = ENGINE_CASES[case]
    cfg, model, params, tmodel, tparams = pair(arch)
    kw = dict(max_slots=3, max_seq_len=96, backend=backend, page_size=PAGE,
              chunked_prefill_budget=16, decode_steps_per_sync=4,
              use_kernel=True, enable_prefix_cache=backend == "paged")
    draft = tdraft = None
    if spec:
        kw["spec_tokens"] = 3
        draft, tdraft = (model, params), (tmodel, tparams)
    reqs = request_factory(cfg.vocab_size,
                           prompts=_shared_prompts(cfg.vocab_size),
                           max_tokens=12, **SAMPLING[sampling])
    teng = _port_engine(tmodel, tparams, draft=tdraft, **kw)
    _both(engine_factory(model, params, draft=draft, **kw), teng, reqs)
    assert teng.stats["prefill_chunks"] > len(reqs)
    if backend == "paged":
        assert teng.cache_stats()["hit_tokens"] > 0
    if spec:
        assert teng.stats["spec_rounds"] > 0


def test_moe_serves_on_every_paged_decode_path(pair):
    """The per-step (legacy) and the fused K-step paths of a moe target
    give the same tokens as its slot engine, greedy."""
    cfg, _, _, tmodel, tparams = pair(MOE)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in (9, 20)]
    outs = []
    for kw in (dict(backend="paged", fused_decode=False),
               dict(backend="paged", decode_steps_per_sync=4),
               dict(backend="slots")):
        eng = _port_engine(tmodel, tparams, max_slots=2, max_seq_len=64,
                           **kw)
        for i, p in enumerate(prompts):
            eng.add_request(InferenceRequest(
                model="m", prompt_tokens=p, request_id=f"r{i}",
                sampling=SamplingParams(max_tokens=8)))
        outs.append({o.request_id: o.output_tokens
                     for o in eng.run_to_completion()})
    assert outs[0] == outs[1] == outs[2]


# ---------------------------------------------------------------------------
# embedding and offline engines
# ---------------------------------------------------------------------------

def _frames(cfg, B=3, S=16, seed=14):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((B, S, cfg.d_model)) * 0.5).astype(np.float32)
    return x, np.array([S, 9, 4][:B], np.int32)


def test_embedding_engine_matches_jax(pair):
    cfg, model, params, tmodel, tparams = pair(AUDIO)
    x, lens = _frames(cfg)
    ref = JaxEmbeddingEngine(model, params).embed(x, lens)
    out = EmbeddingEngine(tmodel, tparams, device="cpu").embed(x, lens)
    assert out.shape == (3, cfg.d_model) and out.dtype == np.float32
    assert_allclose(out, np.asarray(ref), rtol=EMB_TOL, atol=EMB_TOL)
    assert_allclose(np.linalg.norm(out, axis=-1), 1.0, rtol=1e-6)


def test_embedding_attends_padding_like_jax(pair):
    """The encoder runs with no key mask, as the reference: changing only
    the padded frames (past each length) moves the embeddings of the
    padded sequences, in both packages alike, and leaves the full-length
    sequence where it was."""
    cfg, model, params, tmodel, tparams = pair(AUDIO)
    x, lens = _frames(cfg)
    x2 = x.copy()
    for b, n in enumerate(lens):
        x2[b, n:] = np.random.default_rng(b).standard_normal(
            x2[b, n:].shape) * 0.5
    jeng = JaxEmbeddingEngine(model, params)
    teng = EmbeddingEngine(tmodel, tparams, device="cpu")
    ja, jb = (np.asarray(jeng.embed(v, lens)) for v in (x, x2))
    ta, tb = (teng.embed(v, lens) for v in (x, x2))
    assert_allclose(tb, jb, rtol=EMB_TOL, atol=EMB_TOL)
    moved_j = np.abs(ja - jb).max(-1)
    moved_t = np.abs(ta - tb).max(-1)
    assert moved_t[0] == 0 and moved_j[0] == 0
    assert (moved_t[1:] > 1e-3).all() and (moved_j[1:] > 1e-3).all()
    assert_allclose(moved_t, moved_j, rtol=1e-3, atol=EMB_TOL)


def test_embedding_engine_refuses_a_decoder(pair):
    _, _, _, tmodel, tparams = pair(MOE)
    with pytest.raises(ValueError, match="not an encoder"):
        EmbeddingEngine(tmodel, tparams, device="cpu")


def test_run_batch_identical_to_jax(pair, request_factory):
    cfg, model, params, tmodel, tparams = pair(MOE)
    reqs = request_factory(cfg.vocab_size, n=4, plen=10, max_tokens=9,
                           **SAMPLING["topp"])
    kw = dict(max_slots=3, max_seq_len=64, backend="paged", page_size=PAGE,
              decode_steps_per_sync=4)
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    jouts, jstats = jax_run_batch(model, params, copy.deepcopy(reqs),
                                  JaxEngineConfig(**kw))
    touts, tstats = run_batch(tmodel, tparams,
                              [_port_request(r) for r in reqs],
                              EngineConfig(**kw), device="cpu")
    assert [(o.request_id, o.output_tokens, o.finish_reason)
            for o in touts] == [(o.request_id, o.output_tokens,
                                 o.finish_reason) for o in jouts]
    assert set(tstats) == set(jstats)
    timed = {"wall_s", "output_tok_per_s", "req_per_s"}
    assert {k: v for k, v in tstats.items() if k not in timed} \
        == {k: v for k, v in jstats.items() if k not in timed}
    assert tstats["output_tokens"] == sum(len(o.output_tokens) for o in touts)


# ---------------------------------------------------------------------------
# /v1 API modules
# ---------------------------------------------------------------------------

GOLDEN_PARSERS = {
    "chat_completion_request": "ChatCompletionRequest",
    "completion_request_ids": "CompletionRequest",
    "completion_request_count": "CompletionRequest",
    "embedding_request": "EmbeddingRequest",
    "usage": "Usage",
    "chat_completion_response": "ChatCompletionResponse",
    "completion_response": "CompletionResponse",
    "embedding_response": "EmbeddingResponse",
    "stream_delta": "StreamDelta",
    "stream_delta_final": "StreamDelta",
    "batch_request": "BatchRequest",
    "batch_status": "BatchStatus",
}


@pytest.mark.parametrize("name", sorted(GOLDEN_PARSERS))
def test_schemas_round_trip_the_golden_fixtures(name):
    """Parse -> serialize of each committed /v1 fixture is byte-stable
    through the port's schemas, and parses to what the reference's
    parser gives."""
    committed = (GOLDEN / f"{name}.json").read_text().strip()
    cls = GOLDEN_PARSERS[name]
    obj = getattr(schemas, cls).from_dict(json.loads(committed))
    assert schemas.dumps(obj) == committed
    ref = getattr(jschemas, cls).from_dict(json.loads(committed))
    assert obj.to_dict() == ref.to_dict()


def test_error_fixture_round_trips():
    committed = (GOLDEN / "error_rate_limit.json").read_text().strip()
    err = errors.error_from_dict(json.loads(committed))
    assert isinstance(err, errors.RateLimitError)
    assert schemas.dumps(err) == committed


@pytest.mark.parametrize("name", ["chat_completion_request",
                                  "completion_request_ids",
                                  "embedding_request"])
def test_wire_envelope_matches_jax(name):
    d = json.loads((GOLDEN / f"{name}.json").read_text())
    req = getattr(schemas, GOLDEN_PARSERS[name]).from_dict(d)
    jreq = getattr(jschemas, GOLDEN_PARSERS[name]).from_dict(d)
    wire = schemas.to_wire(req)
    assert wire == jschemas.to_wire(jreq)
    back = schemas.from_wire(json.loads(json.dumps(wire)))
    assert type(back) is type(req)
    assert schemas.dumps(back) == schemas.dumps(req)


def test_to_inference_request_matches_jax():
    d = json.loads((GOLDEN / "chat_completion_request.json").read_text())
    d["prompt_tokens"] = [5, 6, 7]
    t = to_inference_request(schemas.ChatCompletionRequest.from_dict(d), 2.5)
    j = jschemas.to_inference_request(
        jschemas.ChatCompletionRequest.from_dict(d), 2.5)
    assert isinstance(t, InferenceRequest)
    for f in ("model", "prompt_tokens", "request_id", "user", "arrival_time",
              "api_endpoint", "qos", "priority", "deadline"):
        assert getattr(t, f) == getattr(j, f), f
    assert vars(t.sampling) == vars(j.sampling)
    with pytest.raises(errors.InvalidRequestError):
        to_inference_request(schemas.CompletionRequest(model="m",
                                                       prompt_tokens=8))


def test_engine_frames_are_the_api_stream_delta(pair):
    """The engine emits the API's ``StreamDelta``; a ``StreamAssembler``
    reassembles the stream into the request's output."""
    assert tengine.StreamDelta is schemas.StreamDelta
    cfg, _, _, tmodel, tparams = pair(MOE)
    eng = _port_engine(tmodel, tparams, max_slots=2, max_seq_len=64)
    req = schemas.CompletionRequest(model=cfg.name, prompt_tokens=[3, 4, 5],
                                    max_tokens=6, stream=True).validate()
    asm = StreamAssembler(clock=eng.clock)
    eng.add_request(to_inference_request(req), on_delta=asm)
    (out,) = eng.run_to_completion()
    assert asm.finished and asm.tokens == out.output_tokens
    assert asm.finish_reason == out.finish_reason


def test_client_drives_a_duck_typed_gateway():
    class Gateway:
        loop = None

        def __init__(self):
            self.calls = []

        def submit(self, token, req, on_delta=None):
            self.calls.append(("submit", token, type(req).__name__))
            return req

        def cancel(self, request_id):
            self.calls.append(("cancel", request_id))
            return True

    gw = Gateway()
    client = FirstClient(gw, "tok")
    req = client.complete(model="m", prompt_tokens=[1, 2], max_tokens=3)
    assert isinstance(req, schemas.CompletionRequest)
    assert client.embed(model="m", input=[1]).endpoint == "embeddings"
    assert client.cancel("x")
    assert [c[0] for c in gw.calls] == ["submit", "submit", "cancel"]


# ---------------------------------------------------------------------------
# the serving entry point
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3.2-3b", MOE])
def test_serve_runs_in_process_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--device", "cpu", "--stream",
                "--requests", "4", "--max-tokens", "6"])
    out = capsys.readouterr().out
    assert "[serve] 4 requests, 24 output tokens" in out
    assert "streamed:" in out


def test_serve_refusals(monkeypatch):
    # --model-shards counts the visible cards, as the reference counts
    # its devices: none here
    with pytest.raises(ValueError, match="visible"):
        serve.main(["--model-shards", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="encoder-only"):
        serve.main(["--arch", AUDIO, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1"])
