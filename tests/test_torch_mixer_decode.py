"""The Mamba2 mixer decode kernel's wrapper
(``repro_torch.kernels.mixer_decode``) on the CPU, where it runs its plain
version, ``mamba2.mixer_decode_step``, and on the card (``-m card``,
``--noconftest``) the CUDA kernel against that plain version.

On CPU tensors the wrapper is ``mamba2._mixer``'s decode branch, so it must
give the same bits, and so must the kernel tier's mixer on the CPU.

Tolerances on the card, each over the largest magnitude of the plain
version's result: the shifted conv window must be equal (the kernel copies
it); the gated, normed output, bf16 2e-2 (it is rounded to bf16, whose
spacing is 2^-8 relative, after a float32 readout and a float32 sum of
squares summed in another order than PyTorch's); the new float32 state 1e-2 (the kernel rounds the update's products
and sum as the plain version does, so it differs only where a conv output,
summed in another order than cuBLAS's, rounds to a neighbouring bf16 value:
x * dt then moves by 2^-8 of itself), and at least 99 % of the state's
elements must be equal.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.kernels import _build
from repro_torch.kernels.mixer_decode.ops import mixer_decode, takes
from repro_torch.models.mamba2 import _mixer, init_mamba, mixer_decode_step

# Zamba2-7B's mixer (112 heads of 64, N = 64, 2 groups) and mamba2-130m's
# (24 heads, N = 128, 1 group)
ZAMBA2_7B = ModelConfig(
    name="zamba2-7b-mixer", family="hybrid", num_layers=1, d_model=3584,
    num_heads=32, num_kv_heads=32, head_dim=224, d_ff=14336,
    vocab_size=32000,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256, n_groups=2))
MAMBA2_130M = dataclasses.replace(
    ZAMBA2_7B, name="mamba2-130m-mixer", family="ssm", d_model=768,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_kernel=4,
                  chunk=256))
# five heads in five groups: a row of 1285 elements, not a whole number of
# 16-byte vectors
ODD_HEADS = dataclasses.replace(
    ZAMBA2_7B, name="odd-heads", d_model=160,
    ssm=dataclasses.replace(ZAMBA2_7B.ssm, n_groups=5))


def _small(cfg, d_model):
    return dataclasses.replace(cfg, name=f"{cfg.name}-small",
                               d_model=d_model)


def _layer(cfg, B, dtype, seed=0, device="cpu", layers=1):
    """Mixer weights of one layer, a zxbcdt row and a stacked (layers, ...)
    decode state, as the slot cache holds it."""
    gen = torch.Generator().manual_seed(seed)
    p = {k: v[0].to(device)
         for k, v in init_mamba(gen, cfg, dtype, 1).items()}
    # conv bias and D away from their defaults (0 and 1)
    p["conv_b"] = (0.1 * torch.randn(p["conv_b"].shape, generator=gen)).to(
        dtype).to(device)
    p["D"] = torch.rand(p["D"].shape, generator=gen).to(device)
    di, gn = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
    W, ch = 2 * di + 2 * gn + cfg.ssm_heads, di + 2 * gn
    zx = torch.randn(B, 1, W, generator=gen).to(dtype).to(device)
    cache = {
        "conv": torch.randn(layers, B, cfg.ssm.conv_kernel - 1, ch,
                            generator=gen).to(dtype).to(device),
        "ssm": (0.5 * torch.randn(layers, B, cfg.ssm_heads,
                                  cfg.ssm.head_dim, cfg.ssm.d_state,
                                  generator=gen)).to(device)}
    return p, zx, cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cfg", [_small(ZAMBA2_7B, 128),
                                 _small(MAMBA2_130M, 64),
                                 _small(ODD_HEADS, 160)],
                         ids=lambda c: c.name)
def test_the_wrapper_on_cpu_is_the_plain_version(cfg, dtype):
    """The wrapper, and the mixer's decode branch on either tier, give the
    plain version's bits on CPU tensors, and a new state."""
    p, zx, cache = _layer(cfg, 3, dtype)
    state = {"conv": cache["conv"][0], "ssm": cache["ssm"][0]}
    before = {k: v.clone() for k, v in state.items()}
    got, new = mixer_decode(zx, state, p, cfg)
    want, want_new = mixer_decode_step(zx, state, p, cfg)
    assert got.dtype == dtype and got.shape == (3, 1, cfg.d_inner)
    assert torch.equal(got, want)
    for key in ("conv", "ssm"):
        assert torch.equal(new[key], want_new[key])
        assert new[key] is not state[key]
        assert torch.equal(state[key], before[key])
    for use_kernel in (True, False):
        y, st = _mixer(zx, p, cfg, state=state, use_kernel=use_kernel)
        assert torch.equal(y, want)
        assert all(torch.equal(st[k], want_new[k]) for k in st)


def test_the_plain_step_is_one_token_of_the_conv_and_the_scan():
    """The plain step's window is the prefill's conv input shifted by one
    token, and its state and output are the prefill's over the window's
    tokens followed by the new one (float32: the decode step and the
    chunked scan sum the same products in another order)."""
    cfg = dataclasses.replace(_small(ZAMBA2_7B, 128),
                              param_dtype="float32")
    p, zx, _ = _layer(cfg, 2, torch.float32, seed=4)
    gen = torch.Generator().manual_seed(5)
    rows = torch.randn(2, 7, zx.shape[-1], generator=gen)
    y_all, st = _mixer(rows, p, cfg)
    _, state = _mixer(rows[:, :6], p, cfg)
    y, new = mixer_decode_step(rows[:, 6:], state, p, cfg)
    assert torch.equal(new["conv"], st["conv"])
    assert torch.allclose(new["ssm"], st["ssm"], atol=1e-5, rtol=1e-5)
    assert torch.allclose(y, y_all[:, 6:], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case, want", [
    ("zamba2-7b", True), ("mamba2-130m", True), ("odd heads", True),
    ("cpu", False), ("float32", False), ("heads of 32", False),
    ("state 32", False), ("conv 3", False), ("groups 3 of 112", False)])
def test_the_kernel_takes_what_its_shapes_allow(case, want):
    cuda, bf16 = torch.device("cuda", 0), torch.bfloat16
    ssm = ZAMBA2_7B.ssm
    cfg, dtype, dev = {
        "zamba2-7b": (ZAMBA2_7B, bf16, cuda),
        "mamba2-130m": (MAMBA2_130M, bf16, cuda),
        "odd heads": (ODD_HEADS, bf16, cuda),
        "cpu": (ZAMBA2_7B, bf16, torch.device("cpu")),
        "float32": (ZAMBA2_7B, torch.float32, cuda),
        "heads of 32": (dataclasses.replace(
            ZAMBA2_7B, ssm=dataclasses.replace(ssm, head_dim=32)), bf16,
            cuda),
        "state 32": (dataclasses.replace(
            ZAMBA2_7B, ssm=dataclasses.replace(ssm, d_state=32)), bf16,
            cuda),
        "conv 3": (dataclasses.replace(
            ZAMBA2_7B, ssm=dataclasses.replace(ssm, conv_kernel=3)), bf16,
            cuda),
        "groups 3 of 112": (dataclasses.replace(
            ZAMBA2_7B, ssm=dataclasses.replace(ssm, n_groups=3)), bf16,
            cuda)}[case]
    assert takes(cfg, dtype, dev) is want


def test_the_wrapper_refuses_autograd():
    cfg = _small(ZAMBA2_7B, 128)
    p, zx, cache = _layer(cfg, 2, torch.float32)
    zx.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        mixer_decode(zx, {"conv": cache["conv"][0], "ssm": cache["ssm"][0]},
                     p, cfg)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def _check(got, got_state, want, want_state):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    assert torch.equal(got_state["conv"], want_state["conv"])
    assert _rel(got, want) <= 2e-2
    assert _rel(got_state["ssm"], want_state["ssm"]) <= 1e-2
    same = (got_state["ssm"] == want_state["ssm"]).float().mean()
    assert float(same) >= 0.99


@pytest.mark.card
@pytest.mark.parametrize("cfg, B", [(ZAMBA2_7B, 32), (MAMBA2_130M, 9),
                                    (ODD_HEADS, 5)],
                         ids=["zamba2-7b", "mamba2-130m", "odd-heads"])
def test_card_kernel_matches_the_plain_version(card, cfg, B):
    """The output, the new state and the shifted window against the plain
    version at Zamba2-7B's serving shape, mamba2-130m's, and a row whose
    stride is not whole 16-byte vectors; two steps in turn, so the second
    reads the window the first shifted."""
    p, zx, cache = _layer(cfg, B, torch.bfloat16, seed=1, device=card)
    want_state = {"conv": cache["conv"][0].clone(),
                  "ssm": cache["ssm"][0].clone()}
    state = {"conv": cache["conv"][0], "ssm": cache["ssm"][0]}
    before = dict(_build.LAUNCHES)
    for step in range(2):
        row = zx if step == 0 else zx.flip(0)
        want, want_state = mixer_decode_step(row, want_state, p, cfg)
        got, got_state = mixer_decode(row, state, p, cfg)
        torch.cuda.synchronize()
        assert all(got_state[k] is state[k] for k in state)
        _check(got, got_state, want, want_state)
    assert _build.LAUNCHES["mixer_decode"] == before["mixer_decode"] + 2


@pytest.mark.card
def test_card_kernel_updates_the_cache_in_place(card):
    """The state and window the kernel returns are the cache's own layer
    slices, updated in place: the cache's other layers are untouched and
    the ``_mixer`` decode branch through the kernel gives what the plain
    branch gives."""
    cfg = ZAMBA2_7B
    p, zx, cache = _layer(cfg, 4, torch.bfloat16, seed=2, device=card,
                          layers=3)
    ref = {k: v.clone() for k, v in cache.items()}
    state = {"conv": cache["conv"][1], "ssm": cache["ssm"][1]}
    ptrs = {k: v.data_ptr() for k, v in state.items()}
    y, new = _mixer(zx, p, cfg, state=state, use_kernel=True)
    want, want_state = _mixer(zx, p, cfg, state={"conv": ref["conv"][1],
                                                  "ssm": ref["ssm"][1]})
    torch.cuda.synchronize()
    for key in ("conv", "ssm"):
        assert new[key] is state[key]
        assert new[key].data_ptr() == ptrs[key]
        assert torch.equal(cache[key][0], ref[key][0])
        assert torch.equal(cache[key][2], ref[key][2])
    assert _rel(y, want) <= 2e-2
    _check(y, {"conv": cache["conv"][1], "ssm": cache["ssm"][1]}, want,
           want_state)


@pytest.mark.card
@pytest.mark.parametrize("case", ["float32 row", "bf16 state",
                                  "float32 window", "strided state",
                                  "heads of 32", "cpu state"])
def test_card_kernel_refuses_what_it_does_not_take(card, case):
    cfg = _small(ZAMBA2_7B, 128)
    p, zx, cache = _layer(cfg, 2, torch.bfloat16, device=card)
    state = {"conv": cache["conv"][0], "ssm": cache["ssm"][0]}
    err = TypeError
    if case == "float32 row":
        zx, err = zx.float(), ValueError
    elif case == "bf16 state":
        state["ssm"] = state["ssm"].bfloat16()
    elif case == "float32 window":
        state["conv"] = state["conv"].float()
    elif case == "strided state":
        state["ssm"], err = state["ssm"].transpose(2, 3), ValueError
    elif case == "heads of 32":
        cfg, err = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, head_dim=32)), ValueError
    else:
        state["ssm"], err = state["ssm"].cpu(), ValueError
    with pytest.raises(err):
        mixer_decode(zx, state, p, cfg)
