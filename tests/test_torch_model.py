"""The port's model stack (``repro_torch.models``, ``repro_torch.bridge``)
against the JAX package's on the same inputs and the same weights.

Weights come from the reference's own ``init_params`` (the ``lm_factory``
fixture) and cross through ``params_from_jax_numpy``; activations are made
with numpy from a seed. Everything is float32, where the two frameworks
differ only in the order of their sums: logits and caches agree to 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.models import layers as jax_layers
from repro_torch.bridge import params_from_jax_numpy, params_to_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import make_model
from repro_torch.models.layers import rms_norm, rope

ARCHS = ["llama3.2-3b", "qwen1.5-4b"]      # GQA (4q / 2kv) and MHA


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _bridged(lm_factory, arch):
    cfg, model, params = lm_factory(arch)
    tcfg = reduced(REGISTRY[arch])
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu")
    return cfg, model, params, tcfg, make_model(tcfg), tparams


def test_rope_interleaved_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16), np.float32)
    pos = rng.integers(0, 4096, size=(2, 5)).astype(np.int32)
    ref = jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = rope(torch.from_numpy(x), torch.from_numpy(pos), 500000.0)
    assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    # pairs (2i, 2i+1) rotate together: at position 0 nothing moves, and a
    # rotation keeps each pair's norm
    x0 = torch.from_numpy(x)
    assert torch.equal(rope(x0, torch.zeros(2, 5, dtype=torch.int32)), x0)
    pair_norm = (out.reshape(2, 5, 3, 8, 2) ** 2).sum(-1)
    assert_allclose(pair_norm.numpy(),
                    (x.reshape(2, 5, 3, 8, 2) ** 2).sum(-1), rtol=1e-5)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_rms_norm_matches_jax(dt):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 7, 64), np.float32) * 3
    w = rng.standard_normal((64,), np.float32)
    ref = jax_layers.rms_norm(jnp.asarray(x, dt), jnp.asarray(w, dt), 1e-5)
    out = rms_norm(torch.from_numpy(x).to(getattr(torch, dt)),
                   torch.from_numpy(w).to(getattr(torch, dt)), 1e-5)
    assert out.dtype == getattr(torch, dt)    # computed in f32, cast back
    tol = 1e-5 if dt == "float32" else 1e-2   # bf16 output rounding
    assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                    rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trip_and_init_shapes(lm_factory, arch):
    cfg, model, params, tcfg, tmodel, tparams = _bridged(lm_factory, arch)
    back = params_to_numpy(tparams)
    flat_ref = jax.tree_util.tree_leaves_with_path(params)
    for path, leaf in flat_ref:
        node = back
        for key in path:
            node = node[key.key]
        assert_allclose(node, np.asarray(leaf), rtol=0, atol=0)
    # the port's own random init has the reference's tree and shapes
    own = tmodel.init_params(torch.Generator().manual_seed(0))
    ref_shapes = jax.tree.map(lambda a: tuple(a.shape), params)
    own_shapes = jax.tree.map(lambda t: tuple(t.shape), own)
    assert own_shapes == ref_shapes


def test_bridge_keeps_bf16_values(lm_factory):
    _, _, params, *_ = _bridged(lm_factory, "llama3.2-3b")
    bf = jax.tree.map(lambda a: np.asarray(a.astype(jnp.bfloat16)), params)
    tcfg = reduced(REGISTRY["llama3.2-3b"])
    tp = params_from_jax_numpy(bf, tcfg, "cpu", torch.bfloat16)
    assert tp["embed"].dtype == torch.bfloat16
    assert_allclose(tp["layers"]["attn"]["wq"].float().numpy(),
                    bf["layers"]["attn"]["wq"].astype(np.float32), rtol=0,
                    atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_step_match_jax(lm_factory, arch):
    cfg, model, params, tcfg, tmodel, tparams = _bridged(lm_factory, arch)
    rng = np.random.default_rng(3)
    B, S, max_len = 2, 11, 16
    toks = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    nxt = rng.integers(2, cfg.vocab_size, size=(B,)).astype(np.int32)

    jl, jc = model.prefill(params, {"tokens": jnp.asarray(toks)},
                           max_len=max_len)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=max_len)
    assert tl.dtype == torch.float32
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for k in ("k", "v"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert_allclose(tc[k].numpy(), np.asarray(jc[k]), rtol=1e-4,
                        atol=1e-4)

    jl2, jc2 = model.decode_step(params, jnp.asarray(nxt), jc)
    tl2, tc2 = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc)
    assert_allclose(tl2.numpy(), np.asarray(jl2), rtol=1e-4, atol=1e-4)
    assert_allclose(tc2["k"].numpy(), np.asarray(jc2["k"]), rtol=1e-4,
                    atol=1e-4)
    assert tc2["len"].tolist() == np.asarray(jc2["len"]).tolist() \
        == [S + 1] * B
