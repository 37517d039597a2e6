"""The bf16 route of the SSD kernel, modelled pass by pass on the CPU.

``csrc/ssd.cu`` runs bfloat16 inputs through three passes: per-chunk
states (pass 1), the sequential state pass (pass 2) and the chunk scan
(pass 3), rounding to bf16 where its tensor-core products need it: the
decay-weighted x of pass 1 as a hi + lo pair, the state entering a chunk
and the weights W of pass 3. ``ref.ssd_passes_ref`` does the same in
plain PyTorch; here it is held against the JAX package's Pallas kernel in
interpret mode and against ``ssd_chunked`` (what a CPU tensor runs) at
the chunk edges: s = 1, s < Q, s = Q, s = Q + 1, a ragged last chunk,
b = 2, n = 64 and 128, and the engine's Q = 256. The CUDA kernel itself
is held against ``ssd_chunked`` at these edges on the card by
``chip_smoke.py``.

Tolerances, relative to the output's scale (max |ref|), as
``chip_smoke.py`` holds the kernel: y within 2e-2 (W and the entering
state rounded to bf16, y stored in bf16); the float32 final state within
1e-4 (the split keeps about 16 bits of the weighted x). Without the
rounding the passes are the same float32 function as ``ssd_chunked``,
within 1e-5 (sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd.ops import ssd as jax_ssd
from repro_torch.kernels import _build
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_passes_ref

Y_TOL = 2e-2
STATE_TOL = 1e-4
EXACT_TOL = 1e-5

EDGES = {
    # b, s, h, p, n, chunk
    "s=1": (1, 1, 4, 64, 64, 64),
    "s<Q": (1, 40, 4, 64, 64, 64),
    "s=Q": (1, 64, 4, 64, 64, 64),
    "s=Q+1": (1, 65, 4, 64, 64, 64),
    "ragged-last-chunk": (1, 200, 4, 64, 64, 64),
    "b=2": (2, 150, 4, 64, 64, 64),
    "n=128": (1, 130, 4, 64, 128, 64),
    "b=2-n=128-ragged": (2, 100, 4, 64, 128, 64),
    "Q=256-ragged": (1, 300, 4, 64, 64, 256),
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _inputs(b, s, h, p, n, seed=5):
    """bf16 x, B, C and float32 a <= 0 as numpy float32 (x, B, C already
    on the bf16 grid, so both frameworks see the same values)."""
    rng = np.random.default_rng(seed)
    bf = lambda t: torch.from_numpy(t).bfloat16().float().numpy()  # noqa: E731
    x = bf(rng.standard_normal((b, s, h, p), np.float32))
    a = -np.abs(rng.standard_normal((b, s, h), np.float32)) * 0.1
    B = bf(rng.standard_normal((b, s, n), np.float32))
    C = bf(rng.standard_normal((b, s, n), np.float32))
    return x, a, B, C


def _torch(x, a, B, C):
    return (torch.from_numpy(x).bfloat16(), torch.from_numpy(a),
            torch.from_numpy(B).bfloat16(), torch.from_numpy(C).bfloat16())


def _rel(out, ref):
    out = np.asarray(out, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-6))


@pytest.mark.parametrize("case", list(EDGES))
def test_passes_match_pallas(case):
    b, s, h, p, n, chunk = EDGES[case]
    x, a, B, C = _inputs(b, s, h, p, n)
    yj, stj = jax_ssd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(a),
                      jnp.asarray(B, jnp.bfloat16),
                      jnp.asarray(C, jnp.bfloat16), chunk=chunk,
                      interpret=True)
    y, st = ssd_passes_ref(*_torch(x, a, B, C), chunk)
    assert y.dtype == torch.bfloat16 and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    assert _rel(y.float(), yj) <= Y_TOL
    assert _rel(st, stj) <= STATE_TOL


@pytest.mark.parametrize("case", list(EDGES))
def test_passes_match_ssd_chunked(case):
    b, s, h, p, n, chunk = EDGES[case]
    args = _torch(*_inputs(b, s, h, p, n, seed=7))
    yr, str_ = ssd_chunked(*args, chunk)
    y, st = ssd_passes_ref(*args, chunk)
    assert _rel(y.float(), yr.float()) <= Y_TOL
    assert _rel(st, str_) <= STATE_TOL
    # without the kernel's rounding the passes are ssd_chunked's function
    xf, a, Bf, Cf = (t.float() for t in args)
    ye, ste = ssd_passes_ref(xf, a, Bf, Cf, chunk,
                             emulate_kernel_rounding=False)
    yre, stre = ssd_chunked(xf, a, Bf, Cf, chunk)
    assert _rel(ye, yre) <= EXACT_TOL
    assert _rel(ste, stre) <= EXACT_TOL


@pytest.mark.parametrize("case", ["s=Q+1", "ragged-last-chunk",
                                  "Q=256-ragged"])
def test_state_split_is_needed(case):
    """One bf16 for pass 1's decay-weighted x puts the final state outside
    its tolerance; the hi + lo split keeps it well inside."""
    b, s, h, p, n, chunk = EDGES[case]
    args = _torch(*_inputs(b, s, h, p, n, seed=11))
    _, ref = ssd_chunked(*args, chunk)
    _, split = ssd_passes_ref(*args, chunk)
    _, single = ssd_passes_ref(*args, chunk, split_state=False)
    err_split, err_single = _rel(split, ref), _rel(single, ref)
    assert err_split <= STATE_TOL < err_single
    assert err_split * 100 < err_single


def test_cpu_wrapper_runs_plain_version():
    """On CPU tensors the wrapper is ``ssd_chunked``: no kernel launch and
    no pass is counted, and no workspace is made."""
    args = _torch(*_inputs(2, 100, 4, 64, 64))
    before = (dict(_build.LAUNCHES), dict(_build.PASS_LAUNCHES))
    y, st = ops.ssd(*args, 64)
    yr, str_ = ssd_chunked(*args, 64)
    assert (dict(_build.LAUNCHES), dict(_build.PASS_LAUNCHES)) == before
    assert ops._WORKSPACE == {}
    assert torch.equal(y, yr) and torch.equal(st, str_)


def test_reset_launches_clears_pass_counts(monkeypatch):
    monkeypatch.setattr(_build, "LAUNCHES", dict.fromkeys(_build.LAUNCHES, 3))
    monkeypatch.setattr(_build, "PASS_LAUNCHES",
                        dict.fromkeys(_build.PASS_LAUNCHES, 3))
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())
    assert not any(_build.PASS_LAUNCHES.values())
