"""The port's three attention kernels on the CPU, against the JAX package's
Pallas kernels run with ``interpret=True``.

On CPU tensors each wrapper of ``repro_torch.kernels`` runs its kernel's
plain PyTorch version (the CUDA kernels themselves are held against those
plain versions on the card by ``chip_smoke.py``). Inputs are made once with
numpy from a seed and handed to both packages. The geometry cases mirror
``tests/test_kernels.py``: GQA, yi's G = 7, MHA and MQA, a single page,
``ctx % page == 0``, a one-token context, an empty context, tails of odd
length, chunks that straddle a page boundary.

Tolerances: float32 1e-5 (both sides accumulate in float32, in different
orders); bfloat16 2e-2 (the inputs are the same bf16 values on both
sides, and the outputs are rounded to bf16, whose spacing is 2^-8
relative, after float32 sums taken in different orders).
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose

from repro.kernels.flash_attention.ops import \
    paged_flash_prefill as jax_paged_flash_prefill
from repro.kernels.paged_attention.ops import \
    fused_decode_attention as jax_fused_decode_attention
from repro.kernels.paged_attention.ops import \
    paged_attention as jax_paged_attention
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import paged_flash_prefill
from repro_torch.kernels.paged_attention.ops import (fused_decode_attention,
                                                     paged_attention)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _both(x, dt):
    """One float32 numpy array as (jax array, torch tensor) of dtype ``dt``
    (both round float32 to bf16 to nearest even: the same values)."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _ints(x):
    x = np.asarray(x, np.int32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _close(out_t, out_j, dt):
    assert out_t.dtype == DTYPES[dt][1]
    assert_allclose(out_t.float().numpy(), np.asarray(out_j, np.float32),
                    **TOL[dt])


def _pool(rng, NP, page, KH, D):
    return (rng.standard_normal((NP, page, KH, D), np.float32),
            rng.standard_normal((NP, page, KH, D), np.float32))


def _tables(rng, B, PPS, NP):
    """Distinct pages per sequence, never the trash page 0."""
    return (rng.permutation(NP - 1)[:B * PPS] + 1).reshape(B, PPS)


# ---------------------------------------------------------------------------
# single-token paged decode (paged_attention_fwd)
# ---------------------------------------------------------------------------

DECODE_CASES = {
    # B, H, KH, D, page, PPS, lens
    "gqa-ctx%page==0": (3, 6, 2, 64, 16, 4, [16, 33, 64]),
    "yi-G7": (2, 56, 8, 32, 16, 4, [20, 48]),
    "single-page": (2, 4, 2, 32, 16, 1, [7, 16]),
    "one-token": (2, 6, 2, 32, 16, 4, [1, 17]),
    "mha-d128": (2, 4, 4, 128, 16, 2, [9, 32]),
    "empty-context": (2, 4, 2, 32, 16, 2, [0, 20]),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_attention_matches_pallas(case, dt):
    B, H, KH, D, page, PPS, lens = DECODE_CASES[case]
    rng = np.random.default_rng(11)
    NP = B * PPS + 1
    qj, qt = _both(rng.standard_normal((B, H, D), np.float32), dt)
    kn, vn = _pool(rng, NP, page, KH, D)
    (kj, kt), (vj, vt) = _both(kn, dt), _both(vn, dt)
    tj, tt = _ints(_tables(rng, B, PPS, NP))
    lj, lt = _ints(lens)
    before = dict(_build.LAUNCHES)
    out = paged_attention(qt, kt, vt, tt, lt)
    # a CPU tensor runs the plain version: no kernel launch is counted
    assert _build.LAUNCHES == before
    ref = jax_paged_attention(qj, kj, vj, tj, lj, interpret=True)
    _close(out, ref, dt)
    if 0 in lens:               # the kernels give zeros, never a NaN
        assert not out[lens.index(0)].float().any()


def test_paged_attention_rejects_ragged_grouping():
    with pytest.raises(ValueError, match="multiple of kv heads"):
        paged_attention(torch.zeros(1, 6, 64), torch.zeros(4, 16, 4, 64),
                        torch.zeros(4, 16, 4, 64),
                        torch.zeros(1, 2, dtype=torch.int32),
                        torch.ones(1, dtype=torch.int32))


# ---------------------------------------------------------------------------
# fused decode over pages + in-flight tail (paged_decode_tail_fwd)
# ---------------------------------------------------------------------------

FUSED_CASES = {
    # B, H, KH, D, page, PPS, Kt, lens, tail_lens
    "gqa": (3, 8, 2, 64, 16, 4, 4, [5, 32, 64], [1, 2, 4]),
    "yi-G7": (2, 56, 8, 32, 16, 4, 16, [17, 48], [16, 3]),
    "mha-k1": (2, 4, 4, 32, 16, 2, 1, [16, 31], [1, 1]),
    "mqa-odd-tail": (2, 4, 1, 32, 16, 2, 5, [0, 20], [5, 2]),
    "gqa-d128": (2, 6, 2, 128, 16, 2, 8, [32, 3], [8, 7]),
    "empty-row": (2, 4, 2, 32, 16, 2, 3, [0, 20], [0, 2]),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(FUSED_CASES))
def test_fused_decode_attention_matches_pallas(case, dt):
    B, H, KH, D, page, PPS, Kt, lens, tails = FUSED_CASES[case]
    rng = np.random.default_rng(21)
    NP = B * PPS + 1
    qj, qt = _both(rng.standard_normal((B, H, D), np.float32), dt)
    kn, vn = _pool(rng, NP, page, KH, D)
    (kj, kt), (vj, vt) = _both(kn, dt), _both(vn, dt)
    (ktj, ktt), (vtj, vtt) = (
        _both(rng.standard_normal((B, Kt, KH, D), np.float32), dt)
        for _ in range(2))
    tj, tt = _ints(_tables(rng, B, PPS, NP))
    lj, lt = _ints(lens)
    tlj, tlt = _ints(tails)
    out = fused_decode_attention(qt, kt, vt, tt, lt, ktt, vtt, tlt)
    ref = jax_fused_decode_attention(qj, kj, vj, tj, lj, ktj, vtj, tlj,
                                     interpret=True)
    _close(out, ref, dt)


def test_fused_decode_attention_equals_committed_pages():
    """Committing the tail rows into their pages and running plain paged
    attention over context + tail gives the same output: the contract of
    the fused loop's one deferred commit."""
    B, H, KH, D, page, PPS, Kt = 2, 8, 2, 64, 16, 4, 4
    rng = np.random.default_rng(22)
    NP = B * PPS + 1
    q = torch.from_numpy(rng.standard_normal((B, H, D), np.float32))
    kp, vp = (torch.from_numpy(a) for a in _pool(rng, NP, page, KH, D))
    kt, vt = (torch.from_numpy(rng.standard_normal((B, Kt, KH, D),
                                                   np.float32))
              for _ in range(2))
    tables = torch.from_numpy(_tables(rng, B, PPS, NP).astype(np.int32))
    lens = torch.tensor([13, 32], dtype=torch.int32)
    tails = torch.tensor([4, 3], dtype=torch.int32)
    out = fused_decode_attention(q, kp, vp, tables, lens, kt, vt, tails)
    kp2, vp2 = kp.clone(), vp.clone()
    for b in range(B):
        for j in range(int(tails[b])):
            pos = int(lens[b]) + j
            pid = int(tables[b, pos // page])
            kp2[pid, pos % page] = kt[b, j]
            vp2[pid, pos % page] = vt[b, j]
    ref = paged_attention(q, kp2, vp2, tables, lens + tails)
    assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# chunked-prefill flash attention over the pool (paged_flash_prefill_fwd)
# ---------------------------------------------------------------------------

PREFILL_CASES = {
    # B, C, H, KH, D, page, PPS, start
    "fresh-chunk": (2, 16, 8, 2, 64, 16, 4, 0),
    "cached-prefix": (1, 16, 4, 4, 32, 16, 4, 32),
    "yi-G7-tiny": (2, 8, 56, 8, 32, 16, 2, 8),
    "mqa-single-page": (1, 5, 4, 1, 32, 16, 1, 0),
    "straddles-page": (1, 16, 4, 2, 32, 16, 4, 15),
    "gqa-d128": (1, 24, 6, 2, 128, 16, 4, 20),
    # folded rows that end mid-tile, at a start that is no tile multiple
    "ragged-G3": (1, 37, 6, 2, 64, 16, 8, 77),
    "ragged-G7": (1, 9, 56, 8, 32, 16, 4, 50),
}


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(PREFILL_CASES))
def test_paged_flash_prefill_matches_pallas(case, dt):
    B, C, H, KH, D, page, PPS, start = PREFILL_CASES[case]
    rng = np.random.default_rng(31)
    NP = B * PPS + 1
    kv_len = start + C
    assert kv_len <= PPS * page
    qj, qt = _both(rng.standard_normal((B, C, H, D), np.float32), dt)
    kn, vn = _pool(rng, NP, page, KH, D)
    (kj, kt), (vj, vt) = _both(kn, dt), _both(vn, dt)
    tj, tt = _ints(_tables(rng, B, PPS, NP))
    out = paged_flash_prefill(qt, kt, vt, tt, start, kv_len)
    ref = jax_paged_flash_prefill(qj, kj, vj, tj, start, kv_len,
                                  interpret=True)
    _close(out, ref, dt)


# ---------------------------------------------------------------------------
# the kernels' build cache
# ---------------------------------------------------------------------------

def test_build_path_hashes_shared_headers(tmp_path, monkeypatch):
    """A library is named by the hash of its source, the shared headers and
    the flags: editing a ``csrc/*.cuh`` header renames the library of every
    source, so a stale build is never loaded (no nvcc needed to see it)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build._paths(n)[1] for n in _build.SOURCES}
    assert before == {n: _build._paths(n)[1] for n in _build.SOURCES}
    header = csrc / "attention_tc.cuh"
    assert header.is_file()
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._paths(n)[1] for n in _build.SOURCES}
    for n in _build.SOURCES:
        assert after[n] != before[n], n
        assert after[n].parent == _build.BUILD_DIR
    src = csrc / "ssd.cu"
    src.write_text(src.read_text() + "\n")
    assert _build._paths("ssd")[1] != after["ssd"]
    assert _build._paths("paged_prefill")[1] == after["paged_prefill"]
