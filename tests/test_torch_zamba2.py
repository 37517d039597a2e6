"""The published Zamba2 layout's pieces in the port, on the CPU: the SSD
scan and its decode step with B and C in groups, the one-group scan as it
was, ``flash_attention`` with a softmax scale, rotate-half RoPE, the
parameter counts against the tree ``init_params`` makes, the slot
backend's decode-graph buffers against its eager loop, and the new
records, the slot backend's kernel tier against its reference tier and
the counts of its decode attention and its mixers; on the card (``-m
card``, ``--noconftest``), the slot decode graph replayed against the eager
loop, and its replays' launches and counts of the slot decode kernel and
the mixer decode kernel.

Tolerances: a grouped scan against one-group scans over each group's
heads, 1e-5 of the scale (float32, the same products summed in another
order: the grouped path contracts over a group axis); attention 1e-6 (the
plain version itself, float32).
"""
import dataclasses
import math

import pytest
import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import make_model
from repro_torch.models.layers import chunked_attention, rope
from repro_torch.models.mamba2 import ssd_chunked, ssd_decode_step
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams
from repro_torch.serving.tracing import RECORDER

TINY = ModelConfig(
    name="tiny-zamba2", family="hybrid", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=32, d_ff=128, vocab_size=256,
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_kernel=4, chunk=32,
                  n_groups=2),
    hybrid_layer_ids=(0, 1, 3, 6), num_mem_blocks=2, adapter_rank=8,
    tie_embeddings=True, param_dtype="float32")
ZAMBA2_7B = dataclasses.replace(
    TINY, name="zamba2-7b", num_layers=81, d_model=3584, num_heads=32,
    num_kv_heads=32, head_dim=224, d_ff=14336, vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=2),
    hybrid_layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77),
    adapter_rank=128, param_dtype="bfloat16")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _scan_inputs(g, h=8, groups=2, s=75):
    gen = torch.Generator().manual_seed(g)
    x = torch.randn(2, s, h, 8, generator=gen)
    a = -torch.rand(2, s, h, generator=gen)
    B = torch.randn(2, s, groups, 16, generator=gen)
    C = torch.randn(2, s, groups, 16, generator=gen)
    h0 = torch.randn(2, h, 8, 16, generator=gen)
    return x, a, B, C, h0


@pytest.mark.parametrize("chunk", [32, 75, 128])
def test_grouped_scan_is_one_group_scans_over_each_groups_heads(chunk):
    x, a, B, C, h0 = _scan_inputs(1)
    y, st = ssd_chunked(x, a, B, C, chunk, h0)
    for g, hs in enumerate((slice(0, 4), slice(4, 8))):
        yg, sg = ssd_chunked(x[:, :, hs], a[:, :, hs], B[:, :, g],
                             C[:, :, g], chunk, h0[:, hs])
        assert _rel(y[:, :, hs], yg) < 1e-5
        assert _rel(st[:, hs], sg) < 1e-5


def test_grouped_decode_step_is_one_group_steps():
    x, a, B, C, h0 = _scan_inputs(2)
    y, hn = ssd_decode_step(x[:, 0], a[:, 0], B[:, 0], C[:, 0], h0)
    for g, hs in enumerate((slice(0, 4), slice(4, 8))):
        yg, hg = ssd_decode_step(x[:, 0, hs], a[:, 0, hs], B[:, 0, g],
                                 C[:, 0, g], h0[:, hs])
        assert _rel(y[:, hs], yg) < 1e-6 and _rel(hn[:, hs], hg) < 1e-6


# (float64 sum, element 7) of y, the final state, the decode step's y and
# state on the seeded inputs below, as the one-group scan gave them before
# groups were added
ONE_GROUP = [(234.70445058739278, -0.2686648964881897),
             (-33.23417631955817, 0.50814288854599),
             (40.01300057768822, -0.26866525411605835),
             (-38.97002370655537, -0.550148606300354)]


def test_one_group_scan_is_as_it_was():
    g = torch.Generator().manual_seed(29)
    x = torch.randn(2, 75, 4, 8, generator=g)
    a = -torch.rand(2, 75, 4, generator=g)
    B = torch.randn(2, 75, 16, generator=g)
    C = torch.randn(2, 75, 16, generator=g)
    h0 = torch.randn(2, 4, 8, 16, generator=g)
    got = [*ssd_chunked(x, a, B, C, 32, h0),
           *ssd_decode_step(x[:, 0], a[:, 0], B[:, 0], C[:, 0], h0)]
    for t, (total, elem) in zip(got, ONE_GROUP, strict=True):
        assert float(t.flatten()[7]) == elem
        assert float(t.double().sum()) == pytest.approx(total, rel=1e-12)


@pytest.mark.parametrize("scale", [None, 112 ** -0.5])
def test_flash_attention_cpu_path_takes_a_scale(scale):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 40, 4, 32, generator=g) for _ in range(3))
    got = flash_attention(q, k, v, scale=scale)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * (scale or 32 ** -0.5)
    s = s.masked_fill(torch.ones(40, 40, dtype=torch.bool).triu(1),
                      -math.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert _rel(got, want) < 1e-6
    if scale is None:
        assert torch.equal(got, chunked_attention(q, k, v))


def test_rope_half_rotates_the_halves():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 9, 2, 16, generator=g)
    pos = torch.arange(9)[None]
    got = rope(x, pos, 10000.0, half=True)
    inv = 10000.0 ** (-torch.arange(0, 16, 2).float() / 16)
    ang = torch.cat([pos[0, :, None] * inv] * 2, -1)[None, :, None]
    rot = torch.cat([-x[..., 8:], x[..., :8]], -1)
    assert _rel(got, x * ang.cos() + rot * ang.sin()) < 1e-6
    assert torch.equal(rope(x, pos, 10000.0), rope(x, pos))


def test_zamba2_family_is_the_hybrid_at_the_published_layout():
    """``zamba2`` is read as ``hybrid`` and has to give its layer ids."""
    fields = {f.name: getattr(TINY, f.name) for f in dataclasses.fields(TINY)}
    assert ModelConfig(**{**fields, "family": "zamba2"}) == TINY
    with pytest.raises(ValueError, match="hybrid_layer_ids"):
        ModelConfig(**{**fields, "family": "zamba2", "hybrid_layer_ids": ()})


@pytest.mark.parametrize("cfg", [TINY, ZAMBA2_7B], ids=["tiny", "7b"])
def test_param_counts_are_the_tree_init_params_makes(cfg):
    shapes = make_model(cfg).param_shapes()
    leaves = []

    def walk(t):
        for v in t.values():
            walk(v) if isinstance(v, dict) else leaves.append(v.numel())
    walk(shapes)
    assert sum(leaves) == cfg.param_counts()["total"]
    assert cfg.attn_layer_count() == len(cfg.hybrid_layer_ids)
    if cfg is ZAMBA2_7B:
        assert cfg.param_counts()["total"] == 7_356_749_648
        assert shapes["layers"]["mamba"]["in_proj"].shape[-1] == 14704
        assert shapes["layers"]["mamba"]["conv_w"].shape[-1] == 7424
        assert "lm_head" not in shapes


def _serve(eng, n=3):
    out = {}
    for i in range(n):
        eng.add_request(
            InferenceRequest(model=TINY.name,
                             prompt_tokens=list(range(5 + 7 * i, 30 + 9 * i)),
                             request_id=f"r{i}",
                             sampling=SamplingParams(
                                 max_tokens=10 + i, temperature=i % 2 * 1.0,
                                 top_p=0.9, seed=i)),
            on_delta=lambda f, i=i: out.setdefault(i, []).extend(f.tokens))
    while eng.has_work():
        eng.step()
    return out


def _engine(params, **kw):
    return ContinuousBatchingEngine(
        make_model(TINY), params,
        EngineConfig(backend="slots", use_kernel=True, max_slots=4,
                     max_seq_len=128, decode_steps_per_sync=4, **kw),
        device="cpu")


@pytest.fixture(scope="module")
def tiny_params():
    return make_model(TINY).init_params(torch.Generator().manual_seed(0))


def test_slot_graph_buffers_match_the_eager_loop(tiny_params):
    """The fused loop's static-buffer iteration, issued op by op (off CUDA
    nothing is captured), serves what the engine's per-step path, sampled
    on the host, serves; the call's state stays in the static buffers."""
    want = _serve(_engine(tiny_params, fused_decode=False))
    static = _engine(tiny_params)
    g = static.backend._graph
    assert not g.capture
    assert _serve(static) == want
    assert static.backend._dec_st is g.st and g.graph is None


def test_the_slot_graph_engages_on_the_published_layout_only():
    """The slot backend replays on the kernel tier on one CUDA device, and
    only at the published hybrid layout: the ssm family, the
    ``attn_every`` hybrid and the attention families issue op by op."""
    from repro_torch.configs import REGISTRY
    from repro_torch.serving.backends import _captures_decode

    def captures(cfg, *a):
        return _captures_decode(cfg, *a, paged=False)
    cuda, cpu, shard = torch.device("cuda", 0), torch.device("cpu"), object()
    assert captures(TINY, True, None, cuda)
    assert not captures(TINY, False, None, cuda)
    assert not captures(TINY, True, shard, cuda)
    assert not captures(TINY, True, None, cpu)
    for arch in ("zamba2-2.7b", "mamba2-130m", "llama3.2-3b"):
        assert not captures(REGISTRY[arch], True, None, cuda)


def test_records_of_the_hybrid_slot_path(tiny_params):
    """``decode_rows.stepped`` counts every slot of every iteration,
    ``decode_rows.live`` the rows that produced a token, and
    ``shared_block.apps`` every application of a tied block, in prefill
    and in decode."""
    eng = _engine(tiny_params)
    RECORDER.enable()
    RECORDER.refresh()
    try:
        out = _serve(eng)
    finally:
        RECORDER.disable()
        RECORDER.refresh()
    c = RECORDER.counters
    iters = c["decode_graph.eager"]
    assert c["decode_rows.stepped"] == 4 * iters
    # each request's first token comes from its prefill
    assert c["decode_rows.live"] == sum(len(t) - 1 for t in out.values())
    assert c["shared_block.apps"] == len(TINY.hybrid_layer_ids) * (
        len(out) + iters)


@pytest.mark.parametrize("arch", ["tiny-zamba2", "zamba2-2.7b",
                                  "llama3.2-3b"])
def test_slot_kernel_tier_serves_the_reference_tier_tokens(arch,
                                                           tiny_params):
    """The published layout, the ``attn_every`` hybrid and an attention
    family (G = 2) on the slot backend: the kernel tier's decode attention
    (its wrapper runs the plain version on the CPU) serves the reference
    tier's tokens."""
    from repro_torch.configs import REGISTRY, reduced
    if arch == TINY.name:
        cfg, params = TINY, tiny_params
    else:
        cfg = reduced(REGISTRY[arch])
        params = make_model(cfg).init_params(
            torch.Generator().manual_seed(1))
    outs = [_serve(ContinuousBatchingEngine(
        make_model(cfg), params,
        EngineConfig(backend="slots", use_kernel=use_kernel, max_slots=4,
                     max_seq_len=128, decode_steps_per_sync=4),
        device="cpu")) for use_kernel in (True, False)]
    assert outs[0] == outs[1]


@pytest.mark.parametrize("graphable", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
def test_slot_decode_attention_is_counted_per_application(tiny_params,
                                                          use_kernel,
                                                          graphable):
    """``slot_decode_attn.kernel`` (kernel tier) or ``.plain`` once for
    each application of a tied block, and ``mixer_decode.plain`` once for
    each mixer, in each decode iteration issued op by op; with
    ``graphable`` the counts the loop hands to a replay are what each of
    those iterations counted."""
    eng = ContinuousBatchingEngine(
        make_model(TINY), tiny_params,
        EngineConfig(backend="slots", use_kernel=use_kernel, max_slots=4,
                     max_seq_len=128, decode_steps_per_sync=4),
        device="cpu")
    RECORDER.enable()
    RECORDER.refresh()
    try:
        _serve(eng)
    finally:
        RECORDER.disable()
        RECORDER.refresh()
    c = RECORDER.counters
    apps = len(TINY.hybrid_layer_ids)
    tier, other = ("kernel", "plain") if use_kernel else ("plain", "kernel")
    iters = c["decode_graph.eager"] + c.get("decode_graph.replay", 0)
    assert iters > 0
    assert c[f"slot_decode_attn.{tier}"] == apps * iters
    assert f"slot_decode_attn.{other}" not in c
    # CPU tensors step every mixer by the plain version, on either tier
    assert c["mixer_decode.plain"] == TINY.num_layers * iters
    assert "mixer_decode.kernel" not in c
    if graphable:
        counts = eng.backend._graph.counts
        assert counts == {"shared_block.apps": apps,
                          f"slot_decode_attn.{tier}": apps,
                          "mixer_decode.plain": TINY.num_layers}
        assert c[f"slot_decode_attn.{tier}"] \
            == counts[f"slot_decode_attn.{tier}"] * iters


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


# head and state sizes the kernels take (flash: 64; ssd and the mixer
# decode kernel: 64 and 64)
CARD = dataclasses.replace(
    TINY, param_dtype="bfloat16", head_dim=64, num_heads=2, num_kv_heads=2,
    ssm=dataclasses.replace(TINY.ssm, d_state=64, head_dim=64))


@pytest.mark.card
def test_card_slot_graph_replay_matches_eager(card):
    """The slot graph, its mixers through the mixer decode kernel,
    serves the eager kernel loop's tokens and leaves its bits in the
    cache."""
    from repro_torch.kernels import _build
    model = make_model(CARD)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    runs = []
    for graphable in (True, False):
        eng = ContinuousBatchingEngine(
            model, params,
            EngineConfig(backend="slots", use_kernel=True, max_slots=4,
                         max_seq_len=128, decode_steps_per_sync=4),
            device=card)
        assert eng.backend._graph.capture
        eng.backend._graph.capture = graphable
        _build.reset_launches()
        runs.append((_serve(eng), eng.backend))
        assert _build.LAUNCHES["mixer_decode"] > 0
    (got, be), (want, eager) = runs
    assert got == want
    assert be._graph.graph is not None
    for key in ("conv", "ssm", "k", "v"):
        assert torch.equal(be.cache[key], eager.cache[key])


@pytest.mark.card
@pytest.mark.parametrize("layout", ["tiny", "published"])
def test_card_slot_graph_replays_count_the_kernel(card, layout):
    """The replayed iterations launch the slot decode kernel once an
    application and the mixer decode kernel once a layer (81 an iteration
    at the published layout, at small widths), and count them as the eager
    iteration does."""
    from repro_torch.kernels import _build
    cfg = CARD if layout == "tiny" else dataclasses.replace(
        ZAMBA2_7B, name=TINY.name, d_model=64, num_heads=2, num_kv_heads=2,
        head_dim=64, d_ff=128, vocab_size=256, adapter_rank=8)
    model = make_model(cfg)
    params = model.init_params(torch.Generator(device=card).manual_seed(0))
    eng = ContinuousBatchingEngine(
        model, params,
        EngineConfig(backend="slots", use_kernel=True, max_slots=4,
                     max_seq_len=128, decode_steps_per_sync=4),
        device=card)
    _build.reset_launches()
    RECORDER.enable()
    RECORDER.refresh()
    try:
        _serve(eng)
    finally:
        RECORDER.disable()
        RECORDER.refresh()
    c = RECORDER.counters
    apps = len(cfg.hybrid_layer_ids)
    iters = c["decode_graph.eager"] + c["decode_graph.replay"]
    assert c["decode_graph.replay"] > 0
    assert c["slot_decode_attn.kernel"] == apps * iters
    assert "slot_decode_attn.plain" not in c
    assert _build.LAUNCHES["slot_decode_attention"] == apps * iters
    assert eng.backend._graph.counts["mixer_decode.kernel"] \
        == cfg.num_layers
    assert c["mixer_decode.kernel"] == cfg.num_layers * iters
    assert "mixer_decode.plain" not in c
    assert _build.LAUNCHES["mixer_decode"] == cfg.num_layers * iters
