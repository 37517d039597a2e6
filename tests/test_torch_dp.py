"""Serving on a ``(data, model)`` mesh, on the CPU.

A data axis changes where weights live, not the function: where the
serving rule splits weights over ``data`` (FSDP at serve,
``needs_serve_fsdp``), every layer's slices are concatenated back, exactly,
before use. So the port's ``(D, M)`` engine must give bit-identical logits
and tokens to its ``(1, M)`` engine, with no tolerance. Reduced configs
never reach the rule's 8 GiB, so "fsdp-on" cases force it with a
monkeypatch of ``SERVE_FSDP_BYTES`` to 0 in the port's sharding module
and, where the reference's specs are compared, in the reference's;
"fsdp-off" cases leave it, and the data axis then only replicates.

* placement: every data slice at the reference's ``NamedSharding``
  shard shape of its spec, slice d on device (d, m), caches and the
  sampler on replica 0, ``gather_params(shard_params(p)) == p`` bit for
  bit;
* engines: the (2, 2) and (2, 1) engines against the (1, 2) and (1, 1)
  engines -- streams, ``stats``, ``cache_stats()`` and teacher-forced
  logits equal, greedy and seeded top-p, paged (kernel tier's CPU
  fallback, prefix cache, fused K = 4) and slots, one case speculating,
  one swapping -- and greedy streams against the JAX 1-device engine;
  the gather counter against the specs for one forward; the MoE router
  whole and run once a layer;
* ``load_checkpoint(..., shardings=)`` onto a (2, 2) mesh from a file of
  either package.
"""
import copy

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from repro.distributed import sharding as jax_sharding
from repro.distributed.sharding import ShardingRules as JaxRules
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (DataSlices, ServeSharding,
                                              _axis_dim)
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.serving import backends
from repro_torch.serving.backends import PagedBackend, SlotBackend
from repro_torch.tree import tree_leaves
from test_torch_engine import _serve as _serve_preempting
from test_torch_tp import (BASE, GQA, GREEDY, HYBRID, KERNEL_PC, MHA, MOE,
                           SSM, TOPP, _jax_streams, _port_engine, _requests,
                           _serve, _tuples, pair)  # noqa: F401 (fixture)

CPU = torch.device("cpu")
META = torch.device("meta")
SLOT_KERNEL = dict(backend="slots", use_kernel=True, decode_steps_per_sync=4)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=["fsdp-on", "fsdp-off"])
def fsdp(request, monkeypatch):
    """Whether the serving rule splits weights over ``data``: forced on
    (test-only) in both packages, or left to the 8 GiB threshold."""
    on = request.param == "fsdp-on"
    if on:
        monkeypatch.setattr(sharding, "SERVE_FSDP_BYTES", 0)
        monkeypatch.setattr(jax_sharding, "SERVE_FSDP_BYTES", 0)
    return on


def _mesh(d, m, devices=None):
    return make_local_mesh(d, m, devices=devices or [CPU] * (d * m))


def _paths(tree, path=()):
    """(path, leaf) pairs of nested dicts."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _paths(tree[k], path + (k,))]
    return [(path, tree)]


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dm", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("arch", [GQA, MHA, MOE, SSM, HYBRID])
def test_slices_take_the_reference_shard_shapes(pair, arch, dm, fsdp):
    jcfg, jmodel, jparams, tmodel, tparams = pair(arch)
    D, M = dm
    sh = ServeSharding(_mesh(D, M), tmodel.cfg)
    jmesh = jax.make_mesh((D, M), ("data", "model"))
    jspecs = JaxRules(jmesh, jcfg, train=False).param_specs(jparams)
    specs = sh.rules.param_specs(tparams)
    assert specs == _tuples(jspecs)
    trees = sh.shard_params(tparams)
    n_split = 0
    for path, whole in _paths(tparams):
        spec = _get(specs, path)
        want = NamedSharding(jmesh, _get(jspecs, path)).shard_shape(
            tuple(whole.shape))
        for m, tree in enumerate(trees):
            leaf = _get(tree, path)
            if _axis_dim(spec, "data") is None:
                assert isinstance(leaf, torch.Tensor)
                assert tuple(leaf.shape) == want, path
                continue
            n_split += 1
            assert isinstance(leaf, DataSlices) and len(leaf.parts) == D
            for part in leaf.parts:
                assert tuple(part.shape) == want, path
                assert part.is_contiguous() and part._base is None
    assert (n_split > 0) == fsdp
    back = sh.gather_params(trees)
    for (path, a), (_, b) in zip(_paths(back), _paths(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b), path


@pytest.mark.parametrize("arch", [GQA, MOE, HYBRID])
def test_slice_d_sits_on_device_d_m(pair, arch, fsdp):
    """Row 0 of a (2, 2) mesh on the CPU, row 1 on ``meta``: slice 0 of
    every data-split leaf is on the CPU, slice 1 on meta; every other leaf,
    the caches, pools and the lead device are on replica 0."""
    tmodel, tparams = pair(arch)[3:]
    mesh = _mesh(2, 2, [CPU, CPU, META, META])
    sh = ServeSharding(mesh, tmodel.cfg)
    assert sh.devices == [CPU, CPU] and sh.lead == CPU
    assert sh.replicas == [[CPU, CPU], [META, META]]
    for tree in sh.shard_params(tparams):
        for leaf in tree_leaves(tree):
            if isinstance(leaf, DataSlices):
                assert [p.device for p in leaf.parts] == [CPU, META]
            else:
                assert leaf.device == CPU
    be = SlotBackend(tmodel, tparams, max_slots=2, max_len=32, mesh=mesh)
    assert be.device == CPU
    assert all(t.device == CPU for c in be.cache_shards for t in c.values())
    if tmodel.cfg.family != "hybrid":
        pb = PagedBackend(tmodel, tparams, max_slots=2, max_len=32,
                          page_size=16, mesh=mesh)
        assert all(t.device == CPU for p in pb.pool_shards
                   for t in p.values())


def test_a_pod_axis_replicates_onto_pod_0(pair, fsdp):
    """A (pod, data, model) mesh, pod 0 on the CPU and pod 1 on ``meta``:
    the model shards of (pod 0, data 0) hold the weights and the data
    slices run along pod 0's data axis; without the rule the data axis
    splits nothing."""
    from repro_torch.launch.mesh import Mesh
    tmodel, tparams = pair(GQA)[3:]
    mesh = Mesh(("pod", "data", "model"), (2, 2, 2), (CPU,) * 4 + (META,) * 4)
    sh = ServeSharding(mesh, tmodel.cfg)
    assert sh.devices == [CPU, CPU] and sh.replicas[1] == [CPU, CPU]
    leaves = [x for t in sh.shard_params(tparams) for x in tree_leaves(t)]
    slices = [x for x in leaves if isinstance(x, DataSlices)]
    assert bool(slices) == fsdp
    assert all(p.device == CPU for x in slices for p in x.parts)
    assert all(x.device == CPU for x in leaves if x not in slices)


# ---------------------------------------------------------------------------
# engines: (D, M) against (1, M), bit for bit
# ---------------------------------------------------------------------------

SLOT_CHUNKED = dict(backend="slots", chunked_prefill_budget=16,
                    decode_steps_per_sync=4)
# case: (arch, (D, M), engine overrides, sampling, spec tokens, vs jax)
ENGINE_CASES = {
    "gqa-paged-kernel-greedy-2x2": (GQA, (2, 2), KERNEL_PC, GREEDY, 0, True),
    "mha-paged-kernel-topp-2x2": (MHA, (2, 2), KERNEL_PC, TOPP, 0, False),
    "moe-paged-kernel-greedy-2x2": (MOE, (2, 2), KERNEL_PC, GREEDY, 0, False),
    "gqa-paged-per-step-topp-2x1": (
        GQA, (2, 1), dict(fused_decode=False, chunked_prefill_budget=16),
        TOPP, 0, False),
    "moe-slots-topp-2x1": (MOE, (2, 1), SLOT_CHUNKED, TOPP, 0, False),
    "gqa-spec-paged-greedy-2x2": (GQA, (2, 2), KERNEL_PC, GREEDY, 3, False),
    "ssm-slots-greedy-2x2": (SSM, (2, 2), SLOT_KERNEL, GREEDY, 0, True),
    "hybrid-slots-topp-2x2": (HYBRID, (2, 2), SLOT_KERNEL, TOPP, 0, False),
    "hybrid-slots-greedy-2x1": (HYBRID, (2, 1), SLOT_KERNEL, GREEDY, 0,
                                False),
}


def _backend(tmodel, tparams, mesh, kw):
    """A backend of the engine case's kind and tier, 3 slots."""
    if tmodel.cfg.family in backends.ATTENTION_FAMILIES \
            and kw.get("backend", "paged") == "paged":
        return PagedBackend(tmodel, tparams, max_slots=3,
                            max_len=BASE["max_seq_len"], page_size=16,
                            use_kernel=kw.get("use_kernel", False),
                            enable_prefix_cache=True, mesh=mesh,
                            device="cpu")
    return SlotBackend(tmodel, tparams, max_slots=3,
                       max_len=BASE["max_seq_len"],
                       use_kernel=kw.get("use_kernel", False), mesh=mesh,
                       device="cpu")


def _teacher_forced(be, prompts, feed):
    """Each prompt's last logits (16-token chunks), then one
    ``decode_batch`` a row of ``feed``; returns the logits and the gather
    calls of each decode forward."""
    out, gathers = [], []
    for i, p in enumerate(prompts):
        task = be.start_prefill(f"s{i}", p)
        logits = None
        while logits is None:
            logits, _ = be.prefill_chunk(task, 16)
        out.append(logits.numpy())
    for tok in feed:
        sharding.reset_gather_stats()
        out.append(be.decode_batch(tok))
        gathers.append(sharding.GATHER_STATS["calls"])
    return out, gathers


def _gathers_per_forward(sh, params, cfg):
    """(data-split leaves a layer x layers + those of the shared block x
    its applications + the embedding's and head's uses) x M, from the
    specs."""
    specs = sh.rules.param_specs(params)

    def split(tree):
        return sum(_axis_dim(s, "data") is not None
                   for s in tree_leaves(tree))
    n = split(specs["layers"]) * cfg.num_layers
    if "shared" in specs:
        n += split(specs["shared"]) * (cfg.num_layers // cfg.attn_every)
    head = specs["lm_head"] if "lm_head" in specs else specs["embed"]
    return (n + split(specs["embed"]) + split(head)) * sh.model_shards


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_data_mesh_engine_is_bit_identical(case, fsdp, pair, engine_factory,
                                           request_factory):
    arch, (D, M), kw, sampling, spec, vs_jax = ENGINE_CASES[case]
    cfg, model, params, tmodel, tparams = pair(arch)
    jreqs, reqs = _requests(request_factory, cfg.vocab_size, sampling)
    one = _port_engine(tmodel, tparams, spec, _mesh(1, M), **kw)
    ref = _serve(one, reqs)
    backends.reset_transfer_stats()
    eng = _port_engine(tmodel, tparams, spec, _mesh(D, M), **kw)
    got = _serve(eng, reqs)
    assert got == ref
    assert eng.stats == one.stats
    assert eng.cache_stats() == one.cache_stats()
    if kw.get("fused_decode", True):
        assert backends.TRANSFER_STATS["decode_logits_transfers"] == 0
    assert eng.backend.stack._fsdp == fsdp
    if spec:
        assert eng.stats["spec_rounds"] > 0
        assert eng.draft_backend.shard.data_shards == D
        assert eng.draft_backend.stack._fsdp == fsdp
    if vs_jax:
        assert got == _jax_streams(
            engine_factory, model, params, jreqs, kw,
            (arch, sampling["temperature"], tuple(sorted(kw.items()))))
    # teacher-forced: the same prompts and fed tokens, logits equal
    rng = np.random.default_rng(1)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).tolist()
               for n in (21, 40, 9)]
    feed = [rng.integers(2, cfg.vocab_size, size=3) for _ in range(3)]
    want, _ = _teacher_forced(_backend(tmodel, tparams, _mesh(1, M), kw),
                              prompts, feed)
    be = _backend(tmodel, tparams, _mesh(D, M), kw)
    have, gathers = _teacher_forced(be, prompts, feed)
    for a, b in zip(have, want):
        assert np.array_equal(a, b)
    per = _gathers_per_forward(be.shard, tparams, tmodel.cfg) if fsdp else 0
    assert gathers == [per] * len(feed)


def test_swap_round_trip_on_a_data_mesh_is_exact(pair, fsdp,
                                                 request_factory):
    """swap_out on (2, 2) gives the (1, 2) backend's bytes; swap_in puts
    them back into other pages; an engine that swaps a request out and in
    emits the (1, 2) engine's streams."""
    tmodel, tparams = pair(GQA)[3:]
    rng = np.random.default_rng(5)
    prompt = rng.integers(2, 200, size=37).tolist()
    blobs = []
    for dm in ((2, 2), (1, 2)):
        be = PagedBackend(tmodel, tparams, max_slots=2, max_len=96,
                          page_size=16, mesh=_mesh(*dm), device="cpu")
        be.prefill("s", prompt)
        blobs.append(be.swap_out("s"))
    first, ref = blobs
    for key in ("k", "v"):
        assert torch.equal(first[key], ref[key])
    be.free("s")
    be.prefill("squat", rng.integers(2, 200, size=20).tolist())
    be.swap_in("s", 37, first)
    second = be.swap_out("s")
    for key in ("k", "v"):
        assert torch.equal(first[key], second[key])
    reqs = _requests(request_factory, tmodel.cfg.vocab_size, TOPP)[1]
    outs = []
    for dm in ((1, 2), (2, 2)):
        eng = _port_engine(tmodel, tparams, 0, _mesh(*dm), preempt_swap=True,
                           **KERNEL_PC)
        outs.append(_serve_preempting(eng, copy.deepcopy(reqs),
                                      (3, reqs[1].request_id))[0])
        assert eng.stats["swap_outs"] == eng.stats["swap_ins"] == 1
    assert outs[0] == outs[1]


def test_moe_router_stays_whole_and_runs_once_a_layer(pair, monkeypatch):
    """Under forced FSDP the expert stacks are data-split and the router
    is not: it is the unsplit leaf itself on every shard, and one decode
    forward routes once a layer."""
    monkeypatch.setattr(sharding, "SERVE_FSDP_BYTES", 0)
    tmodel, tparams = pair(MOE)[3:]
    be = PagedBackend(tmodel, tparams, max_slots=2, max_len=64,
                      page_size=16, mesh=_mesh(2, 2), device="cpu")
    for p in be.stack.params:
        moe = p["layers"]["moe"]
        assert moe["router"] is tparams["layers"]["moe"]["router"]
        assert all(isinstance(moe[k], DataSlices) for k in ("w1", "w3",
                                                            "w2"))
        assert moe["w1"].dim == 3 and moe["w2"].dim == 2
    be.prefill("s", list(range(3, 30)))
    calls = []
    real = moe_mod._routing
    monkeypatch.setattr(moe_mod, "_routing",
                        lambda *a: (calls.append(1), real(*a))[1])
    be.decode_batch(np.array([5, 0]))
    assert len(calls) == tmodel.cfg.num_layers


# ---------------------------------------------------------------------------
# checkpoints onto a (2, 2) mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["reference", "port"])
def test_load_checkpoint_onto_a_data_mesh(tmp_path, pair, writer,
                                          monkeypatch):
    """``load_checkpoint(shardings=ServeSharding((2, 2)))`` with FSDP
    forced: the tree comes back as per-shard trees of data slices, and
    ``gather_params`` gives the saved tree bit for bit."""
    from repro.distributed import checkpoint as jax_ckpt
    from repro_torch.distributed.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    monkeypatch.setattr(sharding, "SERVE_FSDP_BYTES", 0)
    _, _, jparams, tmodel, tparams = pair(GQA)
    path = str(tmp_path / "params.ckpt")
    if writer == "reference":
        jax_ckpt.save_checkpoint(path, jax.tree.map(np.asarray, jparams),
                                 step=3)
    else:
        save_checkpoint(path, tparams, step=3)
    sh = ServeSharding(_mesh(2, 2), tmodel.cfg)
    trees, step, _ = load_checkpoint(path, tmodel.param_shapes(),
                                     device="cpu", shardings=sh)
    assert step == 3 and len(trees) == 2
    wq = trees[1]["layers"]["attn"]["wq"]
    assert isinstance(wq, DataSlices) and len(wq.parts) == 2
    for (p, a), (_, b) in zip(_paths(sh.gather_params(trees)),
                              _paths(tparams)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
