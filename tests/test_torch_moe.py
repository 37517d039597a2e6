"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the same inputs and the same weights.

Weights come from the reference's own ``init_params`` (reduced phi3.5-moe
and dbrx: 4 experts, top-2) and cross through ``params_from_jax_numpy``;
activations are made with numpy from a seed. Everything is float32, where
the two frameworks differ only in the order of their sums: outputs and the
aux loss agree to 1e-5. Both modes are covered: "dense" (every serving
path; also what "grouped" runs when S * k < 4 * E) and "grouped" with both
combines, including a capacity small enough to drop tokens and routers
whose probabilities tie exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import moe as jax_moe
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model, moe
from repro_torch.models.layers import dense_init, dense_init_stacked

ARCHS = ["phi3.5-moe-42b-a6.6b", "dbrx-132b"]
TOL = 1e-5
MODES = {"dense": ("dense", "gather"),
         "grouped-gather": ("grouped", "gather"),
         "grouped-scatter": ("grouped", "scatter")}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _layer(lm_factory, arch, **moe_overrides):
    """Layer 0's MoE weights of the reduced ``arch`` for both packages:
    (jax cfg, jax leaves, port cfg, port leaves)."""
    cfg, _, params = lm_factory(arch)
    tcfg = reduced(REGISTRY[arch])
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    jl = {k: v[0] for k, v in params["layers"]["moe"].items()}
    tl = {k: v[0] for k, v in tp["layers"]["moe"].items()}
    if moe_overrides:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, **moe_overrides))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **moe_overrides))
    return cfg, jl, tcfg, tl


def _x(cfg, S, seed=0, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _both(x, jl, cfg, tl, tcfg, mode, combine):
    jo, ja = jax_moe.moe_ffn(jnp.asarray(x), jl, cfg, mode=mode,
                             combine=combine)
    to, ta = moe.moe_ffn(torch.from_numpy(x), tl, tcfg, mode=mode,
                         combine=combine)
    assert to.dtype == torch.float32 and tuple(to.shape) == jo.shape
    assert_allclose(to.numpy(), np.asarray(jo), rtol=TOL, atol=TOL)
    assert_allclose(float(ta), float(ja), rtol=TOL, atol=TOL)
    return to


@pytest.mark.parametrize("S", [3, 40])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(lm_factory, arch, mode, S):
    cfg, jl, tcfg, tl = _layer(lm_factory, arch)
    _both(_x(cfg, S), jl, cfg, tl, tcfg, *MODES[mode])


@pytest.mark.parametrize("arch", ARCHS)
def test_grouped_runs_dense_below_four_tokens_an_expert(lm_factory, arch):
    """S * k < 4 * E: "grouped" takes the dense path (no drops even at a
    capacity of 4 tokens an expert); at the threshold it drops."""
    cfg, jl, tcfg, tl = _layer(lm_factory, arch, capacity_factor=0.01)
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    S = 4 * E // k - 1
    x = torch.from_numpy(_x(cfg, S, seed=1))
    dense, _ = moe.moe_ffn(x, tl, tcfg, mode="dense")
    for combine in ("gather", "scatter"):
        grouped, _ = moe.moe_ffn(x, tl, tcfg, mode="grouped",
                                 combine=combine)
        assert torch.equal(grouped, dense)
    # one more token crosses the threshold: grouped runs its own path,
    # whose capacity drops tokens, as the reference's does
    x2 = _x(cfg, S + 1, seed=1)
    g2 = _both(x2, jl, cfg, tl, tcfg, "grouped", "gather")
    d2, _ = moe.moe_ffn(torch.from_numpy(x2), tl, tcfg, mode="dense")
    assert (g2 - d2).abs().max() > 1e-3


@pytest.mark.parametrize("combine", ["gather", "scatter"])
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_jax(lm_factory, arch, combine):
    """capacity_factor 0.25: each expert keeps 8 of the 64 tokens x k its
    gates ask for, so most (token, expert) pairs are dropped."""
    cfg, jl, tcfg, tl = _layer(lm_factory, arch, capacity_factor=0.25)
    x = _x(cfg, 64, seed=2)
    out = _both(x, jl, cfg, tl, tcfg, "grouped", combine)
    dense, _ = moe.moe_ffn(torch.from_numpy(x), tl, tcfg, mode="dense")
    dropped = (out - dense).abs().amax(-1) > 1e-3
    assert dropped.float().mean() > 0.5


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("router", ["all-equal", "pairs"])
def test_routing_ties_break_toward_lower_index(lm_factory, router, mode):
    """Routers whose columns repeat make router probabilities (and so
    gates) tie exactly; the top-k must order them as ``lax.top_k`` does,
    the lower index first. "all-equal": every expert ties, so the routing
    picks experts 0 and 1 for every token, and with a capacity of 8 of 24
    tokens the capacity selection (all gates tied) keeps the first tokens.
    "pairs": experts e and e + 2 tie, so the k = 2 picks are a pair."""
    cfg, jl, tcfg, tl = _layer(lm_factory, ARCHS[0], capacity_factor=0.5)
    w = np.asarray(jl["router"]).copy()
    if router == "all-equal":
        w[:] = w[:, :1]
    else:
        w[:, 2:] = w[:, :2]
    jl = dict(jl, router=jnp.asarray(w))
    tl = dict(tl, router=torch.from_numpy(w))
    x = _x(cfg, 24, seed=4)
    _, _, jidx, _ = jax_moe._routing(jnp.asarray(x), jl, cfg)
    _, _, tidx, _ = moe._routing(torch.from_numpy(x), tl, tcfg)
    assert tidx.tolist() == np.asarray(jidx).tolist()
    if router == "all-equal":
        assert (tidx == torch.tensor([0, 1])).all()
    else:
        assert ((tidx[..., 1] - tidx[..., 0]) == 2).all()
    out = _both(x, jl, cfg, tl, tcfg, *MODES[mode])
    if router == "all-equal" and mode != "dense":
        # tokens past the capacity were dropped: their output is zero
        assert out[:, 8:].abs().max() == 0 and out[:, :8].abs().min() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_jax(lm_factory, arch):
    cfg, jl, tcfg, tl = _layer(lm_factory, arch)
    x = _x(cfg, 17, seed=5)
    jgf, jg, ji, ja = jax_moe._routing(jnp.asarray(x), jl, cfg)
    tgf, tg, ti, ta = moe._routing(torch.from_numpy(x), tl, tcfg)
    assert ti.tolist() == np.asarray(ji).tolist()
    for t, j in ((tgf, jgf), (tg, jg), (ta, ja)):
        assert t.dtype == torch.float32
        assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


class _LargestOutput(TorchDispatchMode):
    """Records the largest tensor any dispatched op returns, leaving out
    views of the storages in ``weights`` (a view is not a copy)."""

    def __init__(self, weights):
        super().__init__()
        self.weights = weights
        self.largest = (0, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.numel() > self.largest[0] \
                    and t.untyped_storage().data_ptr() not in self.weights:
                self.largest = (t.numel(), str(func))
        return out


def test_dense_mode_copies_no_expert_stack(lm_factory):
    """At decode size the dense mode's tensors are activations only: no op
    returns a tensor as large as one expert stack (a permuted copy of w1
    would be one)."""
    _, _, tcfg, tl = _layer(lm_factory, ARCHS[0])
    x = torch.from_numpy(_x(tcfg, 1, seed=6, B=8))
    with _LargestOutput({t.untyped_storage().data_ptr()
                         for t in tl.values()}) as rec:
        moe.moe_ffn(x, tl, tcfg, mode="dense")
    assert rec.largest[0] < tl["w1"].numel(), rec.largest


def test_init_moe_tree_matches_jax(lm_factory):
    """The port's own init: the reference's tree, shapes and dtypes (the
    router stays float32 in a bf16 tree), and the expert stacks' scales."""
    arch = ARCHS[0]
    cfg, _, params = lm_factory(arch, param_dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(REGISTRY[arch]),
                               param_dtype="bfloat16")
    own = make_model(tcfg).init_params(torch.Generator().manual_seed(0))
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), params)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).removeprefix("torch.")), own)
    assert got == ref
    m = own["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    # truncated normal in [-2, 2] has std 0.8796 before scaling
    d, f, L = tcfg.d_model, tcfg.d_ff, tcfg.num_layers
    for name, scale in (("router", 0.02), ("w1", d ** -0.5),
                        ("w3", d ** -0.5), ("w2", (f * 2 * L) ** -0.5)):
        std = m[name].float().std().item()
        assert abs(std / (0.8796 * scale) - 1) < 0.05, (name, std)


def test_stacked_init_draws_one_layer_at_a_time():
    """``dense_init_stacked`` gives what drawing each layer with
    ``dense_init`` in turn gives, in the target dtype."""
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    st = dense_init_stacked(g1, (3, 5, 6, 4), dtype=torch.bfloat16)
    ref = torch.stack([dense_init(g2, (5, 6, 4), dtype=torch.bfloat16)
                       for _ in range(3)])
    assert st.dtype == torch.bfloat16 and torch.equal(st, ref)


def test_bridge_keeps_the_f32_router_of_a_bf16_tree(lm_factory):
    arch = ARCHS[0]
    _, _, params = lm_factory(arch, param_dtype="bfloat16")
    tcfg = dataclasses.replace(reduced(REGISTRY[arch]),
                               param_dtype="bfloat16")
    tp = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg, "cpu")
    m, jm = tp["layers"]["moe"], params["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["w1"].dtype == torch.bfloat16
    for k in m:
        assert_allclose(m[k].float().numpy(),
                        np.asarray(jm[k].astype(jnp.float32)), rtol=0, atol=0)
