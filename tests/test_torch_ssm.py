"""The port's SSM and hybrid path against the JAX package's, on the CPU.

* The SSD scan: the port's ``ssd`` wrapper (on CPU tensors, its plain
  version ``ssd_chunked``) against the JAX Pallas kernel run with
  ``interpret=True`` on ``tests/test_kernels.py``'s cases plus a prompt
  shorter than the chunk; and the chunked scan against the token-by-token
  recurrence (the SSD duality).
* Dense flash attention: the port's ``flash_attention`` (on CPU tensors,
  ``chunked_attention``) against the JAX Pallas kernel in interpret mode:
  causal, sliding window, an Sk that the kernel pads, G = 1 and G > 1.
  Both are start-aligned. ``attention_ref`` (end-aligned, like the JAX
  oracle) against the JAX oracle.
* Reduced mamba2-130m and zamba2-2.7b: logits and caches of prefill plus 4
  decode steps against the JAX ``LM`` on bridged weights, within 1e-4.
* The slot engine token-identical to the JAX slot engine: llama3.2-3b
  (with chunked prefill), mamba2-130m and zamba2-2.7b; greedy and seeded
  top-p; the legacy path, fused K = 1 and K = 4.
* The bridge keeps the float32 leaves of a bfloat16 reference tree.

Tolerances: SSD as ``tests/test_kernels.py`` holds its kernel, y at 2e-4
(float32) and 5e-2 (bfloat16: y is rounded to bf16 after float32 sums over
a whole chunk taken in other orders), the float32 final state at 1e-4;
attention 1e-5 (float32) and 2e-2 (bfloat16, output rounding); float32
models 1e-4, the sums of two frameworks in different orders.
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention.ops import \
    flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import \
    attention_ref as jax_attention_ref
from repro.kernels.ssd.ops import ssd as jax_ssd
from repro.serving.engine import ContinuousBatchingEngine as JaxEngine
from repro.serving.engine import EngineConfig as JaxEngineConfig
from repro.serving.request import InferenceRequest as JaxRequest
from repro.serving.request import SamplingParams as JaxSampling
from repro_torch.bridge import params_from_jax_numpy
from repro_torch.configs import REGISTRY, reduced
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd.ops import ssd
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_decode_step
from repro_torch.models import make_model
from repro_torch.models.transformer import _scatter_new_kv
from repro_torch.serving.engine import ContinuousBatchingEngine, EngineConfig
from repro_torch.serving.request import InferenceRequest, SamplingParams

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SSD_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=5e-2,
                                                          atol=5e-2)}
ATTN_TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2,
                                                           atol=2e-2)}
SSM_ARCHS = ["mamba2-130m", "zamba2-2.7b"]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(x, dt):
    """One float32 numpy array as (jax array, torch tensor) of dtype
    ``dt``: both round float32 to bf16 to nearest even, the same values."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _bridged(lm_factory, arch, **overrides):
    cfg, model, params = lm_factory(arch, **overrides)
    tcfg = dataclasses.replace(reduced(REGISTRY[arch]), **overrides)
    tparams = params_from_jax_numpy(jax.tree.map(np.asarray, params), tcfg,
                                    "cpu")
    return cfg, model, params, make_model(tcfg), tparams


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------

SSD_CASES = {
    # b, s, h, p, n, chunk (tests/test_kernels.py's, plus s < chunk)
    "chunk64": (2, 256, 4, 64, 64, 64),
    "n128": (1, 512, 8, 32, 128, 128),
    "ragged-seq": (2, 200, 3, 16, 32, 64),
    "mamba2-130m-layout": (1, 256, 24, 64, 128, 128),
    "s-below-chunk": (1, 45, 4, 16, 32, 64),
}


def _ssd_inputs(rng, b, s, h, p, n, dt):
    x = _both(rng.standard_normal((b, s, h, p), np.float32), dt)
    a = -np.abs(rng.standard_normal((b, s, h), np.float32)) * 0.1
    B = _both(rng.standard_normal((b, s, n), np.float32), dt)
    C = _both(rng.standard_normal((b, s, n), np.float32), dt)
    return x, (jnp.asarray(a), torch.from_numpy(a)), B, C


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(SSD_CASES))
def test_ssd_matches_pallas(case, dt):
    b, s, h, p, n, chunk = SSD_CASES[case]
    x, a, B, C = _ssd_inputs(np.random.default_rng(5), b, s, h, p, n, dt)
    yj, stj = jax_ssd(x[0], a[0], B[0], C[0], chunk=chunk, interpret=True)
    yt, stt = ssd(x[1], a[1], B[1], C[1], chunk)
    assert yt.dtype == DTYPES[dt][1] and stt.dtype == torch.float32
    assert_allclose(yt.float().numpy(), np.asarray(yj, np.float32),
                    **SSD_TOL[dt])
    assert_allclose(stt.numpy(), np.asarray(stj), rtol=1e-4, atol=1e-4)


def test_ssd_matches_step_recurrence():
    """The chunked scan equals the token-by-token recurrence (the SSD
    duality), through the port's own ``ssd_decode_step``."""
    b, s, h, p, n = 1, 96, 2, 8, 16
    x, a, B, C = (t[1] for t in _ssd_inputs(np.random.default_rng(3), b, s,
                                            h, p, n, "f32"))
    y, st = ssd_chunked(x, a * 2, B, C, 32)
    hstate = torch.zeros((b, h, p, n))
    ys = []
    for t in range(s):
        yt, hstate = ssd_decode_step(x[:, t], a[:, t] * 2, B[:, t], C[:, t],
                                     hstate)
        ys.append(yt)
    assert_allclose(y.numpy(), torch.stack(ys, 1).numpy(), rtol=1e-4,
                    atol=1e-4)
    assert_allclose(st.numpy(), hstate.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# dense flash attention
# ---------------------------------------------------------------------------

FLASH_CASES = {
    # B, S, H, KH, D, causal, window, block (Pallas q and k block)
    "gqa-causal": (2, 128, 8, 2, 64, True, 0, 64),
    "mha-G1-d80": (1, 96, 4, 4, 80, True, 0, 32),
    "window": (1, 256, 8, 2, 64, True, 48, 64),
    "padded-sk": (2, 100, 4, 2, 32, True, 0, 64),
    "window-padded-sk": (1, 150, 6, 3, 32, True, 40, 64),
    "bidirectional-mqa": (2, 64, 8, 1, 64, False, 0, 32),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_matches_pallas(case, dt):
    B, S, H, KH, D, causal, window, block = FLASH_CASES[case]
    rng = np.random.default_rng(13)
    q = _both(rng.standard_normal((B, S, H, D), np.float32), dt)
    k = _both(rng.standard_normal((B, S, KH, D), np.float32), dt)
    v = _both(rng.standard_normal((B, S, KH, D), np.float32), dt)
    ref = jax_flash_attention(q[0], k[0], v[0], causal=causal, window=window,
                              q_block=block, k_block=block, interpret=True)
    out = flash_attention(q[1], k[1], v[1], causal=causal, window=window)
    assert out.dtype == DTYPES[dt][1]
    assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                    **ATTN_TOL[dt])


def test_flash_attention_seq_k_and_empty_rows():
    """``seq_k`` masks keys past it; a row that sees no key is zeros, as in
    the CUDA kernel (rows 0..4 see nothing: window 3 ends before key 5)."""
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 12, 4, 16),
                                                    np.float32))
               for _ in range(3))
    full = flash_attention(q, k[:, :8], v[:, :8], window=0)
    padded = flash_attention(q, k, v, window=0, seq_k=8)
    assert_allclose(padded.numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
    k2 = k.clone()
    k2[:, :5] = 0.0
    out = flash_attention(q[:, :5], k2[:, :5], v[:, :5], causal=True,
                          window=3, seq_k=0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("Sq,Sk,window,kv_len", [(64, 64, 0, None),
                                                  (16, 64, 0, None),
                                                  (64, 64, 24, 50)])
def test_attention_ref_matches_jax_oracle(Sq, Sk, window, kv_len):
    """End-aligned like the JAX oracle; equal to the start-aligned flash
    path when Sq == Sk."""
    rng = np.random.default_rng(19)
    q = rng.standard_normal((2, Sq, 6, 32), np.float32)
    k, v = (rng.standard_normal((2, Sk, 2, 32), np.float32)
            for _ in range(2))
    ref = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            window=window, kv_len=kv_len)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = attention_ref(*t, window=window, kv_len=kv_len)
    assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    if Sq == Sk:
        flash = flash_attention(*t, window=window, seq_k=kv_len)
        assert_allclose(flash.numpy(), out.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_and_hybrid_logits_match_jax(lm_factory, arch):
    cfg, model, params, tmodel, tparams = _bridged(lm_factory, arch)
    rng = np.random.default_rng(23)
    B, S, max_len = 2, 45, 64               # S is not a multiple of chunk 32
    toks = rng.integers(2, cfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = model.prefill(params, {"tokens": jnp.asarray(toks)},
                           max_len=max_len)
    tl, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)},
                            max_len=max_len)
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    empty = tmodel.init_cache(B, max_len, device="cpu")
    assert set(tc) == set(jc) == set(empty)
    for key in jc:
        assert tuple(tc[key].shape) == tuple(empty[key].shape) \
            == jc[key].shape
    assert tc["ssm"].dtype == empty["ssm"].dtype == torch.float32
    for step in range(4):
        nxt = rng.integers(2, cfg.vocab_size, size=(B,)).astype(np.int32)
        jl, jc = model.decode_step(params, jnp.asarray(nxt), jc)
        tl, tc = tmodel.decode_step(tparams, torch.from_numpy(nxt), tc)
        assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    for key in jc:
        assert_allclose(tc[key].float().numpy(),
                        np.asarray(jc[key], np.float32), rtol=1e-4,
                        atol=1e-4)


def test_prefill_kernel_tier_on_cpu_is_the_plain_tier(lm_factory):
    """On CPU tensors the kernel wrappers run their plain versions, so the
    two tiers agree bit for bit."""
    _, _, _, tmodel, tparams = _bridged(lm_factory, "zamba2-2.7b")
    toks = {"tokens": torch.arange(2, 39)[None]}
    lk, ck = tmodel.prefill(tparams, toks, max_len=48, use_kernel=True)
    lp, cp = tmodel.prefill(tparams, toks, max_len=48, use_kernel=False)
    assert torch.equal(lk, lp)
    assert all(torch.equal(ck[k], cp[k]) for k in ck)


def test_short_prompt_conv_state_is_left_padded(lm_factory):
    """A prompt shorter than the conv's receptive field hands decode a
    zero-left-padded conv tail, as the reference's does."""
    cfg, model, params, tmodel, tparams = _bridged(lm_factory, "mamba2-130m")
    toks = np.array([[5, 9]], np.int32)
    _, jc = model.prefill(params, {"tokens": jnp.asarray(toks)})
    _, tc = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    assert tuple(tc["conv"].shape[2:]) == (cfg.ssm.conv_kernel - 1,
                                           cfg.d_inner + 2 * cfg.ssm.d_state)
    assert torch.equal(tc["conv"][:, :, 0], torch.zeros_like(
        tc["conv"][:, :, 0]))
    assert_allclose(tc["conv"].numpy(), np.asarray(jc["conv"]), rtol=1e-5,
                    atol=1e-5)


def test_scatter_drops_positions_past_the_cache():
    """A free slot keeps stepping and its length grows past the cache; its
    write is dropped (the reference's out-of-bounds scatter), the others
    land at their lengths."""
    cache = torch.zeros((2, 3, 1, 4, 2))
    new = torch.ones((2, 3, 1, 2))
    _scatter_new_kv(cache, new, torch.tensor([1, 4, 9], dtype=torch.int32))
    assert torch.equal(cache[:, 0, :, 1], torch.ones((2, 1, 2)))
    assert cache[:, 1:].abs().sum() == 0
    assert cache[:, 0].sum() == 4


def test_bridge_keeps_float32_leaves_of_a_bf16_tree(lm_factory):
    """The reference keeps a mamba layer's ``A_log``, ``D`` and ``dt_bias``
    in float32 whatever the param dtype; the bridge must too. Through it,
    the bf16 zamba2 stack matches the JAX one within 5e-2 of the logits'
    scale (bf16 activations rounded at other places in the two
    frameworks)."""
    cfg, model, params, tmodel, tparams = _bridged(
        lm_factory, "zamba2-2.7b", param_dtype="bfloat16")
    mamba = tparams["layers"]["mamba"]
    for key, leaf in mamba.items():
        want = torch.float32 if key in ("A_log", "D", "dt_bias") \
            else torch.bfloat16
        assert leaf.dtype == want, key
        assert str(params["layers"]["mamba"][key].dtype) == \
            str(want).removeprefix("torch.")
    assert tparams["shared"]["attn"]["wq"].dtype == torch.bfloat16
    toks = np.random.default_rng(29).integers(
        2, cfg.vocab_size, size=(1, 40)).astype(np.int32)
    jl, _ = model.prefill(params, {"tokens": jnp.asarray(toks)})
    tl, _ = tmodel.prefill(tparams, {"tokens": torch.from_numpy(toks)})
    jl = np.asarray(jl)
    assert np.abs(tl.numpy() - jl).max() <= 5e-2 * np.abs(jl).max()


# ---------------------------------------------------------------------------
# the slot engine against the JAX slot engine
# ---------------------------------------------------------------------------

SLOT_MODES = {
    "legacy": dict(fused_decode=False),
    "K1": dict(decode_steps_per_sync=1),
    "K4": dict(decode_steps_per_sync=4),
}
SLOT_ARCHS = {
    # arch: engine overrides (llama ingests prompts in 8-token chunks)
    "llama3.2-3b": dict(chunked_prefill_budget=8),
    "mamba2-130m": dict(),
    "zamba2-2.7b": dict(),
}


@pytest.mark.parametrize("sampling", ["greedy", "topp"])
@pytest.mark.parametrize("mode", list(SLOT_MODES))
@pytest.mark.parametrize("arch", list(SLOT_ARCHS))
def test_slot_engine_token_identical_to_jax(lm_factory, arch, mode,
                                            sampling):
    cfg, model, params, tmodel, tparams = _bridged(lm_factory, arch)
    samp = dict(temperature=0.0) if sampling == "greedy" \
        else dict(temperature=0.8, top_p=0.9)
    base = dict(backend="slots", max_slots=3, max_seq_len=64,
                **SLOT_ARCHS[arch], **SLOT_MODES[mode])
    rng = np.random.default_rng(7)
    prompts = [rng.integers(2, cfg.vocab_size, size=2 + 7 * i).tolist()
               for i in range(5)]
    reqs = [InferenceRequest(model="m", prompt_tokens=p, request_id=f"r{i}",
                             sampling=SamplingParams(max_tokens=12 + i,
                                                     seed=i, **samp))
            for i, p in enumerate(prompts)]
    jreqs = [JaxRequest(model="m", prompt_tokens=list(p), request_id=f"r{i}",
                        sampling=JaxSampling(max_tokens=12 + i, seed=i,
                                             **samp))
             for i, p in enumerate(prompts)]

    jeng = JaxEngine(model, params, JaxEngineConfig(**base))
    teng = ContinuousBatchingEngine(
        tmodel, tparams, EngineConfig(use_kernel=True, **base), device="cpu")
    outs = []
    for eng, rs in ((jeng, jreqs), (teng, reqs)):
        for r in copy.deepcopy(rs):
            eng.add_request(r)
        outs.append({o.request_id: (o.output_tokens, o.finish_reason)
                     for o in eng.run_to_completion()})
    assert len(outs[1]) == len(reqs)
    assert outs[1] == outs[0]
    assert teng.stats["decode_syncs"] == jeng.stats["decode_syncs"]
    assert teng.stats["prefill_chunks"] == jeng.stats["prefill_chunks"]
    assert teng.cache_stats() == {}


def test_slot_engine_refuses_the_prefix_cache(lm_factory):
    _, _, _, tmodel, tparams = _bridged(lm_factory, "mamba2-130m")
    with pytest.raises(ValueError, match="paged"):
        ContinuousBatchingEngine(
            tmodel, tparams, EngineConfig(backend="slots",
                                          enable_prefix_cache=True),
            device="cpu")
