"""The split-K schedule of the paged decode kernels, modelled on the CPU.

``csrc/paged_attention.cu`` cuts each sequence's positions into splits,
forms each split's softmax state ``(m, l, acc)`` with the kernel's
``-1e30`` / ``l = 0`` convention for a split that holds no valid position,
and combines the splits. ``ref.split_decode_attention_ref`` does the same
in plain PyTorch; here it is held against the unsplit plain versions (what
the CPU path of the wrappers runs) and against the JAX package's Pallas
kernels in interpret mode, at the split edges: a context that ends on a
split boundary, one position before or past it, splits wholly past the
sequence, a split that holds only tail rows, a tail that straddles a
boundary, a tail-only sequence and an empty row (zeros). The CUDA kernel
itself is held against the plain versions at these edges on the card by
``chip_smoke.py``.

Tolerances: those of ``tests/test_torch_kernels.py`` -- float32 1e-5 (the
same float32 sums in another order), bfloat16 2e-2 (outputs rounded to
bf16 after float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.paged_attention.ops import \
    fused_decode_attention as jax_fused_decode_attention
from repro.kernels.paged_attention.ops import \
    paged_attention as jax_paged_attention
from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention.ref import (
    fused_decode_attention_ref, paged_attention_ref,
    split_decode_attention_ref)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
KH, PAGE, KT = 2, 16, 5


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _edges(S):
    """(context lengths, tail lengths) that put every split edge in one
    batch, for splits of S positions."""
    lens = [S - 1, S, S + 1, 0, 0, 2, S - 2, 3 * S]
    tails = [2,    3, 1,     0, 4, 0, 5,     5]
    # S - 1 + 2: the tail straddles the boundary; S + 3: split 1 holds
    # only tail rows; S + 1: one position past it; 0 + 0: an empty row;
    # 0 + 4: tail only; 2: every split but the first is past the sequence
    return lens, tails


def _inputs(G, D, S, seed):
    rng = np.random.default_rng(seed)
    lens, tails = _edges(S)
    B = len(lens)
    PPS = -(-(3 * S + 1) // PAGE) + 1          # room past the longest
    NP = B * PPS + 1
    f = lambda *s: rng.standard_normal(s, np.float32)   # noqa: E731
    tables = (rng.permutation(NP - 1)[:B * PPS] + 1).reshape(B, PPS)
    return dict(q=f(B, KH * G, D), kp=f(NP, PAGE, KH, D),
                vp=f(NP, PAGE, KH, D), tables=tables.astype(np.int32),
                lens=np.asarray(lens, np.int32), kt=f(B, KT, KH, D),
                vt=f(B, KT, KH, D), tails=np.asarray(tails, np.int32))


def _torch(x, dt="f32"):
    t = torch.from_numpy(x.copy())
    return t if x.dtype == np.int32 else t.to(DTYPES[dt][1])


def _jax(x, dt="f32"):
    return jnp.asarray(x) if x.dtype == np.int32 else \
        jnp.asarray(x, DTYPES[dt][0])


@pytest.mark.parametrize("S", [16, 32, 64])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 7])
def test_split_model_matches_unsplit(G, D, S):
    a = {k: _torch(v) for k, v in _inputs(G, D, S, seed=G * 100 + D + S)
         .items()}
    base = (a["q"], a["kp"], a["vp"], a["tables"], a["lens"])
    tail = (a["kt"], a["vt"], a["tails"])
    out = split_decode_attention_ref(*base, *tail, split=S)
    assert_allclose(out.numpy(), fused_decode_attention_ref(*base, *tail)
                    .numpy(), **TOL["f32"])
    out_nt = split_decode_attention_ref(*base, split=S)
    assert_allclose(out_nt.numpy(), paged_attention_ref(*base).numpy(),
                    **TOL["f32"])
    # an empty row is zeros, never a NaN
    for o in (out, out_nt):
        assert torch.isfinite(o).all()
        assert not o[3].any()


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 3, 7])
def test_split_model_matches_pallas(G, D, dt):
    S = 32
    x = _inputs(G, D, S, seed=7 * G + D)
    t = {k: _torch(v, dt) for k, v in x.items()}
    j = {k: _jax(v, dt) for k, v in x.items()}
    names = ("q", "kp", "vp", "tables", "lens")
    tnames = ("kt", "vt", "tails")
    out = split_decode_attention_ref(*(t[n] for n in names + tnames),
                                     split=S)
    ref = jax_fused_decode_attention(*(j[n] for n in names + tnames),
                                     interpret=True)
    assert_allclose(out.float().numpy(), np.asarray(ref, np.float32),
                    **TOL[dt])
    out_nt = split_decode_attention_ref(*(t[n] for n in names), split=S)
    lens = x["lens"]
    ref_nt = np.asarray(jax_paged_attention(*(j[n] for n in names),
                                            interpret=True), np.float32)
    # rows with no valid position: the Pallas kernel and the port give
    # zeros
    assert not out_nt[lens == 0].float().any()
    assert_allclose(out_nt.float().numpy()[lens > 0], ref_nt[lens > 0],
                    **TOL[dt])


def test_wrappers_cpu_path_uses_no_workspace(monkeypatch):
    """CPU tensors run the plain versions: no launch, no workspace."""
    monkeypatch.setattr(ops, "_WORKSPACE", {})
    a = {k: _torch(v) for k, v in _inputs(3, 64, 64, seed=5).items()}
    base = (a["q"], a["kp"], a["vp"], a["tables"], a["lens"])
    tail = (a["kt"], a["vt"], a["tails"])
    before = dict(_build.LAUNCHES)
    out = ops.fused_decode_attention(*base, *tail)
    out_nt = ops.paged_attention(*base)
    assert _build.LAUNCHES == before and ops._WORKSPACE == {}
    assert torch.equal(out, fused_decode_attention_ref(*base, *tail))
    assert torch.equal(out_nt, paged_attention_ref(*base))


def test_workspace_is_cached_and_grows(monkeypatch):
    """One workspace per (device, stream): reused while it is large
    enough, grown (counters zeroed) when a call needs more splits or
    heads, never shrunk."""
    monkeypatch.setattr(ops, "_WORKSPACE", {})
    monkeypatch.setattr(ops, "SPLIT_POSITIONS", 256)
    dev = torch.device("cpu")
    ws, cnt = ops._workspace(dev, 7, B=8, H=24, D=128, n_pos=4096 + 8)
    assert ws.dtype == torch.float32 and cnt.dtype == torch.int32
    assert ws.numel() == 8 * 24 * 17 * 130 and cnt.numel() == 8 * 24
    assert not cnt.any()
    again = ops._workspace(dev, 7, B=8, H=24, D=128, n_pos=4096)
    assert again[0] is ws and again[1] is cnt
    small = ops._workspace(dev, 7, B=2, H=8, D=64, n_pos=512)
    assert small[0] is ws
    other = ops._workspace(dev, 9, B=2, H=8, D=64, n_pos=512)
    assert other[0] is not ws                  # another stream
    monkeypatch.setattr(ops, "SPLIT_POSITIONS", 64)
    grown = ops._workspace(dev, 7, B=8, H=24, D=128, n_pos=4096 + 8)
    assert grown[0].numel() == 8 * 24 * 65 * 130
    assert grown[1].numel() == 8 * 24 and not grown[1].any()
