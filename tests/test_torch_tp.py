"""Tensor-parallel serving of the port, on the CPU.

One process drives four shards that all live on ``cpu``
(``make_local_mesh(1, 4, devices=["cpu"] * 4)``), the counterpart of the
reference's simulated devices. The port's mesh engine is held against the
port's 1-device engine and the JAX package's 1-device engine (the
reference's own 4-device cells are red on jax 0.9), on the reduced
configs:

* ``make_local_mesh`` validation and the shape-only production meshes;
* ``ShardingRules`` specs equal to the reference's for every registry
  config, train and serve, on (16, 16), (2, 16, 16), (1, 4) and (2, 2);
* ``ServeSharding`` placement: ``gather_params(shard_params(p)) == p``,
  pools and slot caches split and joined, the vocab-parallel embedding at
  every shard edge;
* the sharded paged-decode entries against the unsharded plain versions,
  and the head_dim-split attention against unsplit attention;
* engines: qwen (4 kv heads: split over the heads, the decode kernels per
  shard), llama (2 kv heads: head_dim split), phi3.5-moe (4 experts, one a
  shard), llava; both backends, greedy and seeded top-p, prefix cache with
  copy-on-write, speculation; three shards (nothing divides: replicated).
  Greedy tokens must be identical. For seeded top-p a token may differ
  only where the two engines' teacher-forced logits agree within
  ``TF_TOL`` and still sample differently (a draw decided by rounding);
* placement invariants after a run;
* the ssm and hybrid families (mamba2-130m, zamba2-2.7b) on the slot
  backend at (1, 2), (1, 3) and (1, 4): the sharded Mamba2 mixer against
  ``mamba_layer`` (prefill output and final state, one decode step, 1e-5
  in float32), the engines against both 1-device engines (the same token
  rules), the replicated ssm/conv states and split k/v after a run, and
  the kernel wrappers called once per shard; both families also serve on
  a (2, 2) mesh, the (1, 4) engine's greedy tokens (``test_torch_dp.py``
  holds the data axis itself).
"""
import copy

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.distributed.sharding import ShardingRules as JaxRules
from repro.models import make_model as jax_make_model
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.distributed.sharding import ServeSharding, ShardingRules
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.launch.mesh import (Mesh, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import make_model
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.models.layers import head_dim_split_attention
from repro_torch.models.mamba2 import mamba_layer, mamba_layer_sharded
from repro_torch.models.transformer import ServeStack
from repro_torch.serving import backends
from repro_torch.serving.backends import PagedBackend, SlotBackend
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.sampler import fold_seeds, sample_token, seed_base
from test_torch_engine import _port_request

N = 4
CPU = torch.device("cpu")
MHA, GQA, MOE, VLM = ("qwen1.5-4b", "llama3.2-3b", "phi3.5-moe-42b-a6.6b",
                      "llava-next-34b")
SSM, HYBRID = "mamba2-130m", "zamba2-2.7b"
GREEDY = dict(temperature=0.0)
TOPP = dict(temperature=0.8, top_p=0.9)
# teacher-forced logits, mesh against 1 device, relative to their scale:
# float32 sums in another order (row-parallel partials, split scores)
TF_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mesh(n=N):
    return make_local_mesh(1, n, devices=[CPU] * n)


@pytest.fixture(scope="module")
def pair(lm_factory):
    """``pair(arch)`` -> (jax cfg, jax model, jax params, port model, port
    params), the port's weights bridged from the reference's."""
    cache = {}

    def build(arch):
        if arch not in cache:
            cfg, model, params = lm_factory(arch)
            tcfg = reduced(REGISTRY[arch])
            cache[arch] = (cfg, model, params, make_model(tcfg),
                           params_from_jax_numpy(
                               jax.tree.map(np.asarray, params), tcfg, CPU))
        return cache[arch]

    return build


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_make_local_mesh_shapes():
    m = _mesh()
    assert m.axis_names == ("data", "model")
    assert m.shape == {"data": 1, "model": 4}
    assert m.placed_devices() == (CPU,) * 4
    m2 = make_local_mesh(2, 3, devices=["cpu"] * 7)
    assert m2.shape == {"data": 2, "model": 3} and len(m2.devices) == 6


def test_make_local_mesh_rejects_oversize_and_nonpositive(monkeypatch):
    with pytest.raises(ValueError, match="visible"):
        make_local_mesh(1, 5, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="positive"):
        make_local_mesh(0, 4, devices=[CPU] * 4)
    with pytest.raises(ValueError, match="positive"):
        make_local_mesh(1, -2)
    # the default is the visible cards: none without one
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="only 0 are visible"):
        make_local_mesh(1, 1)


def test_production_meshes_are_shape_only():
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    with pytest.raises(ValueError, match="shape-only"):
        make_production_mesh().placed_devices()
    with pytest.raises(ValueError, match="shape-only"):
        ServeSharding(Mesh(("data", "model"), (1, 4)),
                      reduced(REGISTRY[GQA]))


def test_serve_sharding_refuses_wide_data_axes():
    """A data axis above 1 is served (placement in ``test_torch_dp.py``):
    the model shards sit on replica 0. A mesh with no model axis is
    refused."""
    sh = ServeSharding(make_local_mesh(2, 2, devices=[CPU] * 4),
                       reduced(REGISTRY[GQA]))
    assert sh.model_shards == 2 and sh.data_shards == 2
    assert sh.devices == [CPU, CPU] and len(sh.replicas) == 2
    with pytest.raises(ValueError, match="'model' axis"):
        ServeSharding(Mesh(("data",), (1,), (CPU,)), reduced(REGISTRY[GQA]))


# ---------------------------------------------------------------------------
# sharding rules: the reference's specs, entry for entry
# ---------------------------------------------------------------------------

MESHES = {"16x16": make_production_mesh(),
          "2x16x16": make_production_mesh(multi_pod=True),
          "1x4": Mesh(("data", "model"), (1, 4)),
          "2x2": Mesh(("data", "model"), (2, 2))}
_SHAPES = {}


def _shapes(arch):
    """The reference's parameter, cache and batch shapes (no device
    touched)."""
    if arch not in _SHAPES:
        model = jax_make_model(REGISTRY[arch])
        params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
        cache = None if REGISTRY[arch].is_encoder else jax.eval_shape(
            lambda: model.init_cache(256, 4096))
        batch = {"tokens": jax.ShapeDtypeStruct((256, 4096), np.int32),
                 "labels": jax.ShapeDtypeStruct((256, 4096), np.int32)}
        _SHAPES[arch] = params, cache, batch
    return _SHAPES[arch]


def _tuples(specs):
    return jax.tree.map(tuple, specs,
                        is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("train", [True, False], ids=["train", "serve"])
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_sharding_rules_match_the_reference(arch, train, mesh):
    params, cache, batch = _shapes(arch)
    cfg, m = REGISTRY[arch], MESHES[mesh]
    ours, ref = ShardingRules(m, cfg, train), JaxRules(m, cfg, train)
    assert ours.param_specs(params) == _tuples(ref.param_specs(params))
    assert ours.opt_specs(None, params) == _tuples(ref.opt_specs(None,
                                                                 params))
    assert ours.batch_specs(batch) == _tuples(ref.batch_specs(batch))
    if cache is not None:
        assert ours.cache_specs(cache) == _tuples(ref.cache_specs(cache))


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def _equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal_trees(a[k], b[k])
    else:
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("arch", [MHA, GQA, MOE])
def test_gather_params_inverts_shard_params(pair, arch):
    _, _, _, tmodel, tparams = pair(arch)
    cfg = tmodel.cfg
    sh = ServeSharding(_mesh(), cfg)
    shards = sh.shard_params(tparams)
    _equal_trees(sh.gather_params(shards), tparams)
    lay = shards[1]["layers"]
    assert shards[1]["embed"].shape == (cfg.vocab_size // N, cfg.d_model)
    assert lay["attn"]["wq"].shape[-1] == cfg.q_dim // N
    assert lay["attn"]["wo"].shape[-2] == cfg.q_dim // N
    if cfg.moe:
        assert lay["moe"]["w1"].shape[1] == cfg.moe.num_experts // N
        assert lay["moe"]["router"] is tparams["layers"]["moe"]["router"]
    else:
        assert lay["mlp"]["w1"].shape[-1] == cfg.d_ff // N
    # a split leaf is a tensor of its own, not a view of the whole
    assert lay["attn"]["wq"]._base is None
    assert len({t["embed"].data_ptr() for t in shards}) == N


@pytest.mark.parametrize("arch,axis", [(MHA, 3), (GQA, 4)])
def test_pools_and_slot_caches_split_per_shard(pair, arch, axis):
    cfg = pair(arch)[3].cfg
    sh = ServeSharding(_mesh(), cfg)
    assert sh.kv_split == ("heads" if axis == 3 else "head_dim")
    g = torch.Generator().manual_seed(1)
    pools = {n: torch.randn((2, 5, 16, cfg.num_kv_heads, cfg.head_dim),
                            generator=g) for n in ("k", "v")}
    parts = sh.shard_pools(pools)
    for p in parts:
        assert p["k"].shape[axis] == pools["k"].shape[axis] // N
        assert p["k"].is_contiguous() and p["k"]._base is None
    _equal_trees(sh.gather_pools(parts), pools)
    cache = {"k": pools["k"].transpose(2, 3).contiguous(),
             "len": torch.arange(5, dtype=torch.int32)}
    sc = sh.shard_slot_cache(cache)
    kh_axis = 2 if axis == 3 else 4
    assert sc[2]["k"].shape[kh_axis] == cache["k"].shape[kh_axis] // N
    assert torch.equal(sc[3]["len"], cache["len"])


@pytest.mark.parametrize("arch", [MHA, GQA])
def test_vocab_parallel_embedding_and_head_at_shard_edges(pair, arch):
    _, _, _, tmodel, tparams = pair(arch)
    V = tmodel.cfg.vocab_size
    stack = ServeStack(tparams, tmodel.cfg, ServeSharding(_mesh(), tmodel.cfg))
    edges = sorted({e for s in range(N) for e in
                    (s * V // N - 1, s * V // N, s * V // N + 1)} - {-1}
                   | {V - 1})
    ids = torch.tensor([edges, edges[::-1]])
    assert torch.equal(stack.embed(ids), tparams["embed"][ids])
    h = torch.randn((3, tmodel.cfg.d_model), generator=torch.Generator()
                    .manual_seed(2))
    assert_allclose(stack.head(h).numpy(),
                    ServeStack(tparams, tmodel.cfg).head(h).numpy(),
                    rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the sharded attention entries against the unsharded plain versions
# ---------------------------------------------------------------------------

def _decode_inputs(KH=4, G=3, D=16, page=16, B=3, PPS=4, Kt=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    NP = B * PPS + 1
    q = torch.randn((B, KH * G, D), generator=g)
    kp, vp = (torch.randn((NP, page, KH, D), generator=g) for _ in range(2))
    tables = torch.randperm(NP - 1, generator=g)[:B * PPS].reshape(B, PPS) \
        .int() + 1
    lens = torch.tensor([1, 37, PPS * page][:B], dtype=torch.int32)
    kt, vt = (torch.randn((B, Kt, KH, D), generator=g) for _ in range(2))
    tail_lens = torch.tensor([1, Kt, 3][:B], dtype=torch.int32)
    return q, kp, vp, tables, lens, kt, vt, tail_lens


def _heads(x, axis, s):
    return x.chunk(N, dim=axis)[s].contiguous()


@pytest.mark.parametrize("tail", [False, True], ids=["pages", "tail"])
@pytest.mark.parametrize("entry", ["ops", "ref"])
def test_sharded_decode_entries_match_unsharded(tail, entry):
    q, kp, vp, tables, lens, kt, vt, tail_lens = _decode_inputs()
    mod = pa_ops if entry == "ops" else pa_ref
    suffix = "" if entry == "ops" else "_ref"
    rep = [tables] * N, [lens] * N
    qs = [_heads(q, 1, s) for s in range(N)]
    pages = [[_heads(p, 2, s) for s in range(N)] for p in (kp, vp)]
    if tail:
        tails = [[_heads(t, 2, s) for s in range(N)] for t in (kt, vt)]
        got = getattr(mod, "fused_decode_attention_sharded" + suffix)(
            qs, *pages, *rep, *tails, [tail_lens] * N)
        want = pa_ref.fused_decode_attention_ref(q, kp, vp, tables, lens, kt,
                                                 vt, tail_lens)
    else:
        got = getattr(mod, "paged_attention_sharded" + suffix)(qs, *pages,
                                                               *rep)
        want = pa_ref.paged_attention_ref(q, kp, vp, tables, lens)
    assert_allclose(torch.cat(got, dim=1).numpy(), want.numpy(), rtol=1e-5,
                    atol=1e-6)
    assert pa_ops.shardable_kv_heads(4, _mesh())
    assert not pa_ops.shardable_kv_heads(2, _mesh())


def test_head_dim_split_attention_matches_unsplit():
    """Partial scores summed over head_dim slices, one softmax: equal to
    the decode attention over the whole head_dim (pages + tail)."""
    q, kp, vp, tables, lens, kt, vt, tail_lens = _decode_inputs(KH=2, G=2)
    k = torch.cat([pa_ref.gather_kv(kp, tables), kt], 1)
    v = torch.cat([pa_ref.gather_kv(vp, tables), vt], 1)
    n_ctx = pa_ref.gather_kv(kp, tables).shape[1]
    valid = torch.cat([torch.arange(n_ctx)[None] < lens[:, None],
                       torch.arange(kt.shape[1])[None] < tail_lens[:, None]],
                      1)[:, None]
    d = q.shape[-1] // N
    got = head_dim_split_attention(
        [q[:, None, :, s * d:(s + 1) * d] for s in range(N)],
        [k[..., s * d:(s + 1) * d] for s in range(N)],
        [v[..., s * d:(s + 1) * d] for s in range(N)], valid,
        lambda parts: sum(parts[1:], parts[0]))
    want = pa_ref.fused_decode_attention_ref(q, kp, vp, tables, lens, kt, vt,
                                             tail_lens)
    assert_allclose(torch.cat(got, -1)[:, 0].numpy(), want.numpy(),
                    rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# engines: mesh against the port's and the JAX package's 1-device engines
# ---------------------------------------------------------------------------

BASE = dict(max_slots=3, max_seq_len=96, page_size=16)
KERNEL_PC = dict(use_kernel=True, enable_prefix_cache=True,
                 chunked_prefill_budget=16, decode_steps_per_sync=4)
# case: (arch, shards, engine overrides, sampling, spec tokens, vs jax)
ENGINE_CASES = {
    "mha-heads-paged-kernel-greedy": (MHA, 4, dict(KERNEL_PC), GREEDY, 0,
                                      True),
    "mha-heads-paged-kernel-topp": (MHA, 4, dict(KERNEL_PC), TOPP, 0, False),
    "gqa-head_dim-paged-kernel-greedy": (GQA, 4, dict(KERNEL_PC), GREEDY, 0,
                                         False),
    "gqa-head_dim-paged-kernel-topp": (GQA, 4, dict(KERNEL_PC), TOPP, 0,
                                       True),
    "gqa-head_dim-paged-plain-per-step": (
        GQA, 4, dict(fused_decode=False, chunked_prefill_budget=16), TOPP, 0,
        False),
    "moe-experts-paged-greedy": (MOE, 4, dict(KERNEL_PC), GREEDY, 0, False),
    "moe-experts-paged-topp": (MOE, 4, dict(KERNEL_PC), TOPP, 0, False),
    "vlm-paged-greedy": (VLM, 4, dict(KERNEL_PC), GREEDY, 0, False),
    "mha-heads-slots-greedy": (MHA, 4, dict(backend="slots",
                                            decode_steps_per_sync=4),
                               GREEDY, 0, False),
    "gqa-head_dim-slots-topp": (GQA, 4, dict(backend="slots",
                                             chunked_prefill_budget=16,
                                             decode_steps_per_sync=4),
                                TOPP, 0, False),
    "gqa-head_dim-slots-per-step": (GQA, 4, dict(backend="slots",
                                                 fused_decode=False),
                                    GREEDY, 0, False),
    "moe-experts-slots-topp": (MOE, 4, dict(backend="slots"), TOPP, 0,
                               True),
    "mha-spec-paged-topp": (MHA, 4, dict(KERNEL_PC), TOPP, 3, False),
    "gqa-spec-paged-greedy": (GQA, 4, dict(KERNEL_PC), GREEDY, 3, False),
    "gqa-spec-slots-greedy": (GQA, 4, dict(backend="slots"), GREEDY, 3,
                              False),
    "gqa-3-shards-replicated-paged-topp": (GQA, 3, dict(KERNEL_PC), TOPP, 0,
                                           False),
}


def _requests(request_factory, vocab, sampling, n=4, seed=3):
    """(JAX requests, the port's): n - 1 prompts sharing two pages, and
    the shared two pages alone (a whole-page hit whose final token is
    recomputed into a copy of the shared page)."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(2, vocab, size=32).tolist()
    prompts = [shared + rng.integers(2, vocab, size=5 + 4 * i).tolist()
               for i in range(n - 1)] + [list(shared)]
    jreqs = request_factory(vocab, prompts=prompts, max_tokens=10,
                            **sampling)
    # the first holds its pages longest: the last prompt is admitted while
    # they are still shared
    jreqs[0].sampling.max_tokens = 20
    return jreqs, [_port_request(r) for r in jreqs]


def _port_engine(tmodel, tparams, spec, mesh, **kw):
    cfg = dict(dict(BASE, backend="paged"), **kw)
    return ContinuousBatchingEngine(
        tmodel, tparams, EngineConfig(spec_tokens=spec, mesh=mesh, **cfg),
        draft_model=tmodel if spec else None,
        draft_params=tparams if spec else None, device="cpu")


def _serve(eng, reqs):
    for r in copy.deepcopy(reqs):
        eng.add_request(r)
    return {o.request_id: (o.output_tokens, o.finish_reason)
            for o in eng.run_to_completion()}


def _teacher_forced(tmodel, tparams, mesh, tokens):
    """Last-position logits of ``tokens`` through a plain paged backend
    (a slot backend's one-shot prefill for ssm and hybrid), 1 device or
    ``mesh``."""
    if tmodel.cfg.family not in backends.ATTENTION_FAMILIES:
        be = SlotBackend(tmodel, tparams, max_slots=1,
                         max_len=BASE["max_seq_len"], mesh=mesh,
                         device="cpu")
        return be.prefill("s", tokens)
    be = PagedBackend(tmodel, tparams, max_slots=1, max_len=BASE[
        "max_seq_len"], page_size=16, mesh=mesh, device="cpu")
    task = be.start_prefill("s", tokens)
    logits = None
    while logits is None:
        logits, _ = be.prefill_chunk(task, 16)
    return logits


def _assert_streams(got, ref, reqs, sampling, tmodel, tparams, mesh):
    """Greedy: identical. Seeded top-p: at the first differing token the
    two engines' teacher-forced logits agree within TF_TOL, and each
    engine's logits sample its own token with the request's seed there (a
    rounding-decided draw), else the mismatch is a fault."""
    assert got.keys() == ref.keys()
    for r in reqs:
        (gt, gr), (rt, rr) = got[r.request_id], ref[r.request_id]
        if (gt, gr) == (rt, rr):
            continue
        assert sampling is TOPP, f"{r.request_id}: greedy {gt} != {rt}"
        j = next(i for i, (a, b) in enumerate(zip(gt, rt)) if a != b)
        prefix = list(r.prompt_tokens) + rt[:j]
        lr = _teacher_forced(tmodel, tparams, None, prefix)
        lm = _teacher_forced(tmodel, tparams, mesh, prefix)
        err = float((lm - lr).abs().max() / lr.abs().max())
        seed = int(fold_seeds(torch.tensor([seed_base(r.sampling.seed)]),
                              torch.tensor([j]))[0])
        picks = [int(sample_token(x, TOPP["temperature"], TOPP["top_p"],
                                  seed)) for x in (lr, lm)]
        assert err <= TF_TOL and picks == [rt[j], gt[j]], (
            f"{r.request_id} token {j}: {gt[j]} != {rt[j]}, teacher-forced "
            f"logits rel err {err:.2e}, samples {picks}")


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_mesh_engine_matches_one_device(case, pair, engine_factory,
                                        request_factory):
    arch, n, kw, sampling, spec, vs_jax = ENGINE_CASES[case]
    cfg, model, params, tmodel, tparams = pair(arch)
    jreqs, reqs = _requests(request_factory, cfg.vocab_size, sampling)
    mesh = _mesh(n)
    one = _port_engine(tmodel, tparams, spec, None, **kw)
    ref = _serve(one, reqs)
    backends.reset_transfer_stats()
    eng = _port_engine(tmodel, tparams, spec, mesh, **kw)
    got = _serve(eng, reqs)
    _assert_streams(got, ref, reqs, sampling, tmodel, tparams, mesh)
    if vs_jax:
        jeng = engine_factory(model, params, draft=(model, params) if spec
                              else None, spec_tokens=spec,
                              **dict(BASE, **kw))
        _assert_streams(got, _serve(jeng, jreqs), reqs, sampling, tmodel,
                        tparams, mesh)
    if kw.get("fused_decode", True):
        assert backends.TRANSFER_STATS["decode_logits_transfers"] == 0
    assert eng.stats == one.stats
    assert eng.cache_stats() == one.cache_stats()
    be = eng.backend
    assert be.stack.n == n
    kv_split = ServeSharding(mesh, tmodel.cfg).kv_split
    assert be.stack.kv_split == kv_split
    if isinstance(be, PagedBackend):
        assert be._kernel_sharded == (kw.get("use_kernel", False)
                                      and kv_split == "heads")
    if spec:
        assert eng.stats["spec_rounds"] > 0
        assert eng.draft_backend.stack.n == n
    if kw.get("enable_prefix_cache"):
        # the last prompt is the shared prefix alone: two whole pages hit,
        # its final token is recomputed into a copy of the shared page
        assert be.kv.stats["hit_tokens"] > 0 and be.kv.stats["cow_copies"] > 0


def test_mesh_placement_invariants(pair, request_factory):
    """After a sharded run: each shard's pool is a tensor of its own at the
    split shape (page, KH_s, hd_s), the router and norms replicated, and
    the sampler's state, the device tables and lengths whole on the lead
    device."""
    for arch, shape in ((MHA, (16, 1, 16)), (GQA, (16, 2, 4)),
                        (MOE, (16, 2, 4))):
        cfg, _, _, tmodel, tparams = pair(arch)
        eng = _port_engine(tmodel, tparams, 0, _mesh(), **KERNEL_PC)
        backends.reset_transfer_stats()
        _serve(eng, _requests(request_factory, cfg.vocab_size, TOPP)[1])
        be = eng.backend
        assert backends.TRANSFER_STATS["decode_logits_transfers"] == 0
        ptrs = set()
        for p in be.pool_shards:
            for pool in p.values():
                assert pool.shape[0] == cfg.num_layers
                assert pool.shape[2:] == shape
                assert pool.is_contiguous() and pool._base is None
                ptrs.add(pool.data_ptr())
        assert len(ptrs) == 2 * N
        with pytest.raises(AttributeError, match="pool_shards"):
            be.pools
        for p in be.stack.params[1:]:
            assert p["final_norm"] is be.stack.params[0]["final_norm"]
            if cfg.moe:
                assert p["layers"]["moe"]["router"] is \
                    tparams["layers"]["moe"]["router"]
        for name, leaf in be._dec_st.items():
            assert leaf.device == be.device and leaf.shape[0] == \
                BASE["max_slots"], name
        tables, lens = be._dev_tables
        assert tables.shape[0] == lens.shape[0] == BASE["max_slots"]


def test_mesh_swap_round_trip_is_exact(pair):
    """swap_out gathers the shards' pages into the 1-device layout;
    swap_in splits them back: the same bytes, into other pages."""
    tmodel, tparams = pair(GQA)[3:]
    rng = np.random.default_rng(5)
    be = PagedBackend(tmodel, tparams, max_slots=2, max_len=96,
                      page_size=16, mesh=_mesh(), device="cpu")
    one = PagedBackend(tmodel, tparams, max_slots=2, max_len=96,
                       page_size=16, device="cpu")
    prompt = rng.integers(2, 200, size=37).tolist()
    for b in (be, one):
        b.prefill("s", prompt)
    first, ref = be.swap_out("s"), one.swap_out("s")
    assert first["k"].shape == ref["k"].shape == (
        tmodel.cfg.num_layers, 3, 16, tmodel.cfg.num_kv_heads,
        tmodel.cfg.head_dim)
    for key in ("k", "v"):      # the positions written (the 1-device
        # one-shot prefill also fills the last page's padded rows)
        got, want = (b[key].flatten(1, 2)[:, :37].numpy()
                     for b in (first, ref))
        assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    be.free("s")
    be.prefill("squat", rng.integers(2, 200, size=20).tolist())
    be.swap_in("s", 37, first)
    second = be.swap_out("s")
    for key in ("k", "v"):
        assert torch.equal(first[key], second[key])


# ---------------------------------------------------------------------------
# the ssm and hybrid families under a mesh
# ---------------------------------------------------------------------------

SLOT_KERNEL = dict(backend="slots", use_kernel=True, decode_steps_per_sync=4)
# case: (arch, shards, engine overrides, sampling, vs jax)
SSM_CASES = {
    **{f"{name}-{n}-shards-greedy": (arch, n, SLOT_KERNEL, GREEDY, True)
       for name, arch in (("ssm", SSM), ("hybrid", HYBRID))
       for n in (2, 3, 4)},
    "ssm-4-shards-topp": (SSM, 4, SLOT_KERNEL, TOPP, True),
    "hybrid-4-shards-topp": (HYBRID, 4, SLOT_KERNEL, TOPP, True),
    "hybrid-2-shards-per-step": (HYBRID, 2, dict(backend="slots",
                                                 fused_decode=False),
                                 GREEDY, False),
}
_JAX_STREAMS = {}


def _jax_streams(engine_factory, model, params, jreqs, kw, key):
    """The JAX 1-device engine's streams, once per (arch, case key)."""
    if key not in _JAX_STREAMS:
        _JAX_STREAMS[key] = _serve(engine_factory(
            model, params, **dict(BASE, **kw)), jreqs)
    return _JAX_STREAMS[key]


@pytest.mark.parametrize("case", list(SSM_CASES))
def test_ssm_and_hybrid_mesh_engine_matches_one_device(
        case, pair, engine_factory, request_factory):
    arch, n, kw, sampling, vs_jax = SSM_CASES[case]
    cfg, model, params, tmodel, tparams = pair(arch)
    jreqs, reqs = _requests(request_factory, cfg.vocab_size, sampling)
    mesh = _mesh(n)
    one = _port_engine(tmodel, tparams, 0, None, **kw)
    ref = _serve(one, reqs)
    backends.reset_transfer_stats()
    eng = _port_engine(tmodel, tparams, 0, mesh, **kw)
    got = _serve(eng, reqs)
    _assert_streams(got, ref, reqs, sampling, tmodel, tparams, mesh)
    if vs_jax:
        _assert_streams(got, _jax_streams(
            engine_factory, model, params, jreqs, kw,
            (arch, sampling["temperature"], tuple(sorted(kw.items())))),
            reqs, sampling, tmodel, tparams, mesh)
    if kw.get("fused_decode", True):
        assert backends.TRANSFER_STATS["decode_logits_transfers"] == 0
    assert eng.stats == one.stats
    assert eng.backend.stack.n == n and len(eng.backend.cache_shards) == n


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_ssm_and_hybrid_serve_on_model_and_data_meshes(pair,
                                                       request_factory,
                                                       arch):
    """ssm and hybrid models serve under a (1, 4) mesh on the slot backend,
    the 1-device engine's greedy tokens, and under a (2, 2) mesh the
    (1, 4) engine's; the paged backend still takes the attention families
    only."""
    tmodel, tparams = pair(arch)[3:]
    reqs = _requests(request_factory, tmodel.cfg.vocab_size, GREEDY)[1]
    streams = [_serve(_port_engine(tmodel, tparams, 0, m, backend="slots"),
                      reqs) for m in (None, _mesh(),
                                      make_local_mesh(2, 2,
                                                      devices=[CPU] * 4))]
    assert streams[0] == streams[1] == streams[2]
    assert len(streams[1]) == len(reqs)
    with pytest.raises(ValueError, match="attention families"):
        PagedBackend(tmodel, tparams, max_slots=2, max_len=64,
                     mesh=_mesh(), device="cpu")


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_sharded_mixer_matches_mamba_layer(pair, arch, n):
    """The sharded mixer's prefill output and final state, then one
    decode step from that state, against ``mamba_layer`` (float32)."""
    tmodel, tparams = pair(arch)[3:]
    cfg = tmodel.cfg
    sh = ServeSharding(_mesh(n), cfg)
    stack = ServeStack(tparams, cfg, sh)
    i = cfg.num_layers - 1
    whole = ServeStack(tparams, cfg).layers[0][i]["mamba"]
    ps = [lay[i]["mamba"] for lay in stack.layers]
    # reduced widths: in_proj 296 columns, out_proj 128 rows -- both split
    # at 2 and 4 shards, whole on every shard at 3
    split = n != 3
    assert (ps[0]["in_proj"].shape[-1] * n
            == whole["in_proj"].shape[-1]) == split
    assert (ps[0]["out_proj"].shape[0] * n
            == whole["out_proj"].shape[0]) == split
    g = torch.Generator().manual_seed(n)
    x = torch.randn((2, 45, cfg.d_model), generator=g)
    want, wstate = mamba_layer(x, whole, cfg)
    got, states = mamba_layer_sharded(x, ps, cfg, stack.gather,
                                      stack.reduce)
    tol = dict(rtol=1e-5, atol=1e-5)
    assert_allclose(got.numpy(), want.numpy(), **tol)
    assert len(states) == n
    for st in states:
        for key in ("ssm", "conv"):
            assert_allclose(st[key].numpy(), wstate[key].numpy(), **tol)
    x1 = torch.randn((2, 1, cfg.d_model), generator=g)
    want1, wstate1 = mamba_layer(x1, whole, cfg, state=wstate)
    got1, states1 = mamba_layer_sharded(x1, ps, cfg, stack.gather,
                                        stack.reduce, states=states)
    assert_allclose(got1.numpy(), want1.numpy(), **tol)
    for st in states1:
        for key in ("ssm", "conv"):
            assert_allclose(st[key].numpy(), wstate1[key].numpy(), **tol)


def test_ssm_state_replicated_and_kv_split_after_a_run(pair,
                                                        request_factory):
    """After a hybrid run on four shards every shard holds a whole copy of
    its own of the ssm and conv states, equal to the 1-device cache, and
    a quarter of the kv heads of k/v; the length vector is whole on the
    lead device."""
    cfg, _, _, tmodel, tparams = pair(HYBRID)
    reqs = _requests(request_factory, cfg.vocab_size, GREEDY)[1]
    engines = [_port_engine(tmodel, tparams, 0, m, **SLOT_KERNEL)
               for m in (None, _mesh())]
    for e in engines:
        _serve(e, reqs)
    one, be = (e.backend for e in engines)
    G = cfg.num_layers // cfg.attn_every
    ptrs = set()
    for c in be.cache_shards:
        for key in ("ssm", "conv"):
            assert c[key].shape == one.cache[key].shape
            assert_allclose(c[key].numpy(), one.cache[key].numpy(),
                            rtol=1e-5, atol=1e-5)
            ptrs.add(c[key].data_ptr())
        for key in ("k", "v"):
            assert c[key].shape == (G, BASE["max_slots"],
                                    cfg.num_kv_heads // N,
                                    BASE["max_seq_len"], cfg.head_dim)
        assert "len" not in c
    assert len(ptrs) == 2 * N
    assert torch.equal(be.cache["len"], one.cache["len"])


@pytest.mark.parametrize("arch", [SSM, HYBRID])
def test_mesh_prefill_calls_the_kernel_wrappers_once_per_shard(
        pair, monkeypatch, arch):
    """With the kernel tier a one-shot prompt calls ``ssd`` once per layer
    and shard, and the hybrid's ``flash_attention`` once per shared-block
    application and shard, each at the shard's heads (on the CPU the
    wrappers run their plain versions; chip_smoke.py phase 8d counts the
    launches on the card)."""
    tmodel, tparams = pair(arch)[3:]
    cfg = tmodel.cfg
    calls = {"ssd": [], "flash_attention": []}
    for mod, name in ((ssd_ops, "ssd"), (flash_ops, "flash_attention")):
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            calls[_name].append(a[0].shape)
            return _fn(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    be = SlotBackend(tmodel, tparams, max_slots=2, max_len=64,
                     use_kernel=True, mesh=_mesh(), device="cpu")
    prompts = [list(range(3, 3 + s)) for s in (9, 40)]
    for i, p in enumerate(prompts):
        be.prefill(f"s{i}", p)
    G = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
    assert len(calls["ssd"]) == len(prompts) * cfg.num_layers * N
    assert len(calls["flash_attention"]) == len(prompts) * G * N
    assert all(q[2] == cfg.num_heads // N for q in calls["flash_attention"])


def test_mesh_backend_device_is_the_lead(pair):
    tmodel, tparams = pair(GQA)[3:]
    be = SlotBackend(tmodel, tparams, max_slots=2, max_len=64, mesh=_mesh())
    assert be.device == CPU and len(be.cache_shards) == N
    with pytest.raises(ValueError, match="lead device"):
        SlotBackend(tmodel, tparams, max_slots=2, max_len=64, mesh=_mesh(),
                    device="meta")
