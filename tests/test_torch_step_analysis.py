"""The port's step analysis (``repro_torch.launch.step_analysis``) against
the reference's HLO analysis (``repro.launch.hlo_analysis``) on the same
steps.

The reference's counts come from its compiled steps (``jit(...).lower(...)
.compile()``), one device or a simulated (data, model) mesh of this
process's 8 host devices; the port's from one eager run of its step on the
``meta`` device. Reduced configs, so every head, expert and weight
dimension divides the 4-way model axis.

* One device: the port's ``dot_flops`` equal the reference's for every
  family, prefill, decode and the train step (2 microbatches, remat),
  except the ssm and hybrid train steps, which differ by a named amount
  (``_ssd_backward_gap``).
* One shard of (1, 4) and (2, 4): argument bytes equal the reference's
  ``memory_analysis().argument_size_in_bytes``; prefill and decode
  ``dot_flops`` equal the reference's per-device count; a train step's is
  the one-device count over the shard count.
* Heads that do not divide the model axis: prefill with and without
  ``--opt attn_dp``, and decode.
* The loop, remat and slice rules of ``tests/test_perf_paths.py``'s
  analyzer tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import REGISTRY as JREG
from repro.configs import reduced as jreduced
from repro.distributed.hints import ShardingHints as JaxHints
from repro.distributed.hints import use_hints as jax_use_hints
from repro.distributed.sharding import ShardingRules as JaxRules
from repro.launch.hlo_analysis import analyze
from repro.models import make_model as jax_make_model
from repro.training.optimizer import AdamWConfig as JaxAdamW
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro.training.train import make_train_step as jax_make_train_step
from repro_torch.configs import REGISTRY, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.dryrun import build_cell, make_hints
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.step_analysis import analyze_step

B, S, MICRO = 4, 64, 2
FAMILIES = ["llama3.2-3b", "phi3.5-moe-42b-a6.6b", "mamba2-130m",
            "zamba2-2.7b", "llava-next-34b", "hubert-xlarge"]
MESH_ARCHS = ["llama3.2-3b", "mamba2-130m", "phi3.5-moe-42b-a6.6b",
              "zamba2-2.7b"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _ref_cell(cfg, kind, b, s, mesh=None, hints=None):
    """The reference's compiled step (the lines of ``repro.launch.dryrun
    .build_cell``, which is not imported: it sets ``XLA_FLAGS`` to 512
    devices on import). Returns (``analyze`` of its HLO, its
    memory_analysis)."""
    model = jax_make_model(cfg)
    params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))

    def batch():
        out = {}
        if cfg.input_kind == "embeds":
            out["embeds"] = jax.ShapeDtypeStruct((b, s, cfg.d_model),
                                                 jnp.bfloat16)
        else:
            out["tokens"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
        if kind == "train":
            out["labels"] = jax.ShapeDtypeStruct((b, s), jnp.int32)
        return out

    if kind == "train":
        fn = jax_make_train_step(model, JaxAdamW(), num_microbatches=MICRO,
                                 remat=True)
        args = (params, jax.eval_shape(jax_adamw_init, params), batch())
    elif kind == "prefill":
        def fn(p, bt):
            return model.prefill(p, bt, max_len=s)
        args = (params, batch())
    else:
        def fn(p, t, c):
            return model.decode_step(p, t, c)
        cache = jax.eval_shape(lambda: model.init_cache(b, s, jnp.bfloat16))
        args = (params, jax.ShapeDtypeStruct((b,), jnp.int32), cache)
    ctx = jax_use_hints(hints) if hints else _Null()
    if mesh is None:
        with ctx:
            comp = jax.jit(fn).lower(*args).compile()
    else:
        rules = JaxRules(mesh, cfg, train=(kind == "train"))
        ps = rules.named(rules.param_specs(params))
        if kind == "train":
            os_ = rules.named(rules.opt_specs(args[1], params))
            in_sh = (ps, os_, rules.named(rules.batch_specs(args[2])))
            out_sh = (ps, os_, None)
        elif kind == "prefill":
            in_sh = (ps, rules.named(rules.batch_specs(args[1])))
            _, c = jax.eval_shape(fn, *args)
            out_sh = None if c is None else \
                (None, rules.named(rules.cache_specs(c)))
        else:
            cs = rules.named(rules.cache_specs(args[2]))
            in_sh = (ps, rules.named(rules.batch_specs(args[1])), cs)
            out_sh = (None, cs)
        with mesh, ctx:
            comp = jax.jit(fn, in_shardings=in_sh,
                           out_shardings=out_sh).lower(*args).compile()
    return analyze(comp.as_text()), comp.memory_analysis()


class _Null:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


def _jax_mesh(data, model):
    # Auto axes: the reference's hints constrain under this mesh
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _port(cfg, kind, b, s, mesh=None, hints=None):
    mesh = mesh or Mesh(("data", "model"), (1, 1))
    fn, args, rules, _ = build_cell(cfg, ShapeConfig("t", kind, s, b), mesh,
                                    microbatches=MICRO)
    if mesh.shape == {"data": 1, "model": 1}:
        return analyze_step(fn, *args, hints=hints)
    return analyze_step(fn, *args, mesh=mesh, rules=rules, hints=hints)


def _ssd_backward_gap(cfg, b, s, micro):
    """The train step's matmul FLOPs the reference counts and the port
    does not: the backward of ``ssd_chunked``'s three-operand einsums. JAX
    forms the gradient of the broadcast operand of ``bcqk,bhcqk,bckhp->
    bcqhp`` (the C.B scores, summed over the heads) and of the two decay
    operands of the state einsums (summed over the head dim) as
    dot_generals, 2 b s h Q and twice 2 b s h p FLOPs a mamba layer and
    microbatch; torch's einsum backward forms them as elementwise products
    and sums, which are no matmul FLOPs."""
    mb = b // micro
    h, p = cfg.ssm_heads, cfg.ssm.head_dim
    q = min(cfg.ssm.chunk, s)
    per = 2 * mb * s * h * q + 2 * (2 * mb * s * h * p)
    return cfg.num_layers * micro * per


# ---------------------------------------------------------------------------
# (a) one device, every family
# ---------------------------------------------------------------------------

CASES = [(a, k) for a in FAMILIES for k in ("prefill", "decode", "train")
         if not (k == "decode" and REGISTRY[a].is_encoder)]


@pytest.mark.parametrize("arch,kind", CASES)
def test_one_device_dot_flops_match_reference(arch, kind):
    ref, _ = _ref_cell(jreduced(JREG[arch]), kind, B, S)
    cfg = reduced(REGISTRY[arch])
    mine = _port(cfg, kind, B, S)
    want = ref["dot_flops"]
    if kind == "train" and cfg.family in ("ssm", "hybrid"):
        want -= _ssd_backward_gap(cfg, B, S, MICRO)
    assert mine["dot_flops"] == want
    if kind == "train" and cfg.family == "moe":
        # the backward of the grouped combine einsum ``bskd,bsk->bsd``
        # takes the gates' gradient as a bmm whose contraction is one
        # long: FlopCounterMode counts it, XLA emits a multiply, the
        # analysis counts no matmul work for it
        k, d = cfg.moe.top_k, cfg.d_model
        outer = cfg.num_layers * 2 * B * S * k * d
        assert mine["flop_counter_flops"] - mine["dot_flops"] == outer
    else:
        assert mine["flop_counter_flops"] == mine["dot_flops"]


def test_flop_counter_mode_agrees_on_one_device():
    """``flop_counter_flops`` is FlopCounterMode's own count of the same
    run."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = reduced(REGISTRY["zamba2-2.7b"])
    mesh = Mesh(("data", "model"), (1, 1))
    fn, args, _, _ = build_cell(cfg, ShapeConfig("t", "train", S, B), mesh,
                                microbatches=MICRO)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    fn, args, _, _ = build_cell(cfg, ShapeConfig("t", "train", S, B), mesh,
                                microbatches=MICRO)
    assert analyze_step(fn, *args)["flop_counter_flops"] == \
        fc.get_total_flops()


# ---------------------------------------------------------------------------
# (b) one shard of a simulated mesh
# ---------------------------------------------------------------------------

MESH_CASES = [(a, k, dm) for a in MESH_ARCHS
              for k in ("prefill", "decode", "train")
              for dm in ((1, 4), (2, 4))]


@pytest.mark.parametrize("arch,kind,dm", MESH_CASES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v))
def test_per_shard_counts_match_reference(arch, kind, dm):
    if jax.device_count() < 8:
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_"
                    "count=8 (tests/conftest.py sets it)")
    ref, mem = _ref_cell(jreduced(JREG[arch]), kind, B, S,
                         mesh=_jax_mesh(*dm))
    cfg = reduced(REGISTRY[arch])
    mine = _port(cfg, kind, B, S, mesh=Mesh(("data", "model"), dm))
    assert mine["argument_size_in_bytes"] == mem.argument_size_in_bytes
    if kind != "train":
        assert mine["dot_flops"] == ref["dot_flops"]
    else:
        # the reference's train count is above this on (2, 4): GSPMD
        # rematerialises the attention einsums involuntarily (PERF.md)
        whole = _port(cfg, kind, B, S)["dot_flops"]
        assert mine["dot_flops"] == whole / (dm[0] * dm[1])
    if dm[0] > 1 and kind == "train":
        assert mine["reduce-scatter"] > 0 and mine["all-gather"] > 0


# ---------------------------------------------------------------------------
# (c) --opt attn_dp where the heads do not divide the model axis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dm", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_attn_dp_moves_attention_flops_like_the_reference(dm):
    """Six heads over two kv heads on a 4-way model axis: without a hint
    the attention splits two ways (over the kv heads; the three query
    groups do not divide the rest), in the reference's compiled step and
    in the port's count alike; ``attn_dp`` moves the batch over (data x
    model), and both then count a 1/(data x model) share. The port
    records the hint's reshards as all-to-alls."""
    over = {"num_heads": 6}
    jcfg = dataclasses.replace(jreduced(JREG["llama3.2-3b"]), **over)
    cfg = dataclasses.replace(reduced(REGISTRY["llama3.2-3b"]), **over)
    b = 8
    mesh = Mesh(("data", "model"), dm)
    hints = make_hints({"attn_dp"}, False)
    jhints = JaxHints(**dataclasses.asdict(hints))
    ref0, _ = _ref_cell(jcfg, "prefill", b, S, mesh=_jax_mesh(*dm))
    ref1, _ = _ref_cell(jcfg, "prefill", b, S, mesh=_jax_mesh(*dm),
                        hints=jhints)
    mine0 = _port(cfg, "prefill", b, S, mesh=mesh)
    mine1 = _port(cfg, "prefill", b, S, mesh=mesh, hints=hints)
    assert mine0["dot_flops"] == ref0["dot_flops"]
    assert mine1["dot_flops"] == ref1["dot_flops"]
    L, H, hd = cfg.num_layers, cfg.num_heads, cfg.head_dim
    attention = L * 2 * (2 * (b // dm[0]) * H * S * S * hd)
    assert mine0["dot_flops"] - mine1["dot_flops"] == \
        attention / 2 - attention / dm[1]
    assert mine0["all-to-all"] == 0 and mine1["all-to-all"] > 0
    assert mine1["all-to-all_count"] == 4 * L       # q, k, v and out


@pytest.mark.parametrize("dm", [(1, 4), (2, 4)], ids=["1x4", "2x4"])
def test_decode_with_heads_not_dividing_the_model_axis(dm):
    """The same six heads in a decode step: the products over the cache
    split with its sequence, the new token's score against its own key
    over the kv heads (two ways); equal to the reference per shard."""
    over = {"num_heads": 6}
    jcfg = dataclasses.replace(jreduced(JREG["llama3.2-3b"]), **over)
    cfg = dataclasses.replace(reduced(REGISTRY["llama3.2-3b"]), **over)
    ref, _ = _ref_cell(jcfg, "decode", 8, S, mesh=_jax_mesh(*dm))
    mine = _port(cfg, "decode", 8, S, mesh=Mesh(("data", "model"), dm))
    assert mine["dot_flops"] == ref["dot_flops"]


# ---------------------------------------------------------------------------
# (d) the analyzer rules of tests/test_perf_paths.py
# ---------------------------------------------------------------------------

def test_loops_count_every_trip():
    W = torch.empty(128, 128, device="meta")
    Ws = torch.empty(10, 128, 128, device="meta")
    x = torch.empty(8, 128, device="meta")
    one = 2 * 8 * 128 * 128
    assert analyze_step(lambda x: x @ W, x)["dot_flops"] == one

    def ten(x):
        for w in Ws:
            x = x @ w
        return x
    assert analyze_step(ten, x)["dot_flops"] == 10 * one

    def nested(x):
        from torch.utils.checkpoint import checkpoint
        for _ in range(5):
            for w in Ws:
                x = checkpoint(torch.matmul, x, w, use_reentrant=False)
        return x
    assert analyze_step(nested, x)["dot_flops"] == 50 * one


def test_traffic_slice_aware():
    big = torch.empty(64, 256, device="meta")
    i = torch.zeros(1, dtype=torch.long, device="meta")

    def f(big, i):
        sl = torch.index_select(big, 0, i)
        return torch.sum(sl * 2.0)
    t = analyze_step(f, big, i)["traffic_bytes"]
    # order slice size (a few KB), not the full 64 KB per op
    assert t < 32 * 1024, t
