"""The slot decode attention kernel's wrapper
(``repro_torch.kernels.slot_attention``) and its split-K schedule on the
CPU, and on the card (``-m card``, ``--noconftest``) the CUDA kernel
against its plain version, ``layers.decode_attention_appended``.

On CPU tensors the wrapper runs the plain version itself, so it must give
the same bits. The split model (``ref.split_slot_decode_ref``) cuts each
slot's positions as the kernel does -- the cache rows the window keeps,
then the new token -- and is held to the plain version at the split edges:
a slot that is empty, one position long, ends one before, on or after a
split boundary, fills the cache, or has grown past it (a free slot is
stepped too), with and without a window.

Tolerances: the split model against the plain version, float32 1e-5 (the
same float32 products summed in another order). On the card, the maximum
error over the largest output magnitude: bf16 2e-2 against the plain
version in float32 on the same bf16 values (the kernel stores its output
in bf16, whose spacing is 2^-8 relative, after float32 sums in another
order) and against the plain bf16 path (which also rounds the
probabilities to bf16 before its PV product, where the kernel keeps them
in float32); float32 1e-5 (the same float32 sums in another order).
"""
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.slot_attention.ops import slot_decode_attention
from repro_torch.kernels.slot_attention.ref import split_slot_decode_ref
from repro_torch.models.layers import decode_attention_appended

SPLIT = 8
SMAX = 3 * SPLIT - 2
# empty, one position, a split boundary -1/0/+1, the full cache, grown past
EDGES = [0, 1, SPLIT - 1, SPLIT, SPLIT + 1, SMAX, SMAX + 7]


def _inputs(B, KH, G, S, D, dtype, seed=0, device="cpu"):
    gen = torch.Generator().manual_seed(seed)

    def draw(*shape):
        return torch.randn(*shape, generator=gen).to(dtype).to(device)
    return (draw(B, 1, KH * G, D), draw(B, KH, S, D), draw(B, KH, S, D),
            draw(B, KH, D), draw(B, KH, D))


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("G", [1, 3])
def test_the_wrapper_on_cpu_is_the_plain_version(G, window, dtype):
    q, kc, vc, kn, vn = _inputs(len(EDGES), 2, G, SMAX, 16, dtype)
    lens = torch.tensor(EDGES, dtype=torch.int32)
    got = slot_decode_attention(q, kc, vc, kn, vn, prev_len=lens,
                                window=window, scale=0.3)
    want = decode_attention_appended(q, kc, vc, kn, vn, prev_len=lens,
                                     window=window, scale=0.3)
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("window", [0, 1, 3, SPLIT + 2])
@pytest.mark.parametrize("G", [1, 4])
def test_the_split_schedule_is_the_plain_version(G, window):
    q, kc, vc, kn, vn = _inputs(len(EDGES), 2, G, SMAX, 16, torch.float32,
                                seed=G + window)
    lens = torch.tensor(EDGES, dtype=torch.int32)
    for scale in (None, 0.3):
        got = split_slot_decode_ref(q, kc, vc, kn, vn, lens, window=window,
                                    scale=scale, split=SPLIT)
        want = decode_attention_appended(q, kc, vc, kn, vn, prev_len=lens,
                                         window=window, scale=scale)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_wrapper_refuses_grad():
    q, kc, vc, kn, vn = _inputs(2, 1, 1, 4, 16, torch.float32)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        slot_decode_attention(q, kc, vc, kn, vn,
                              prev_len=torch.tensor([1, 2], dtype=torch.int32))


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)


def _check_kernel(card, B, KH, G, S, D, dtype, lens, window=0, scale=None,
                  seed=0):
    q, kc, vc, kn, vn = _inputs(B, KH, G, S, D, dtype, seed, card)
    prev = torch.tensor(lens, dtype=torch.int32, device=card)
    before = _build.LAUNCHES["slot_decode_attention"]
    got = slot_decode_attention(q, kc, vc, kn, vn, prev_len=prev,
                                window=window, scale=scale)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["slot_decode_attention"] == before + 1
    assert got.dtype == dtype and bool(torch.isfinite(got).all())
    f32 = [t.float() for t in (q, kc, vc, kn, vn)]
    want = decode_attention_appended(*f32, prev_len=prev, window=window,
                                     scale=scale)
    plain = decode_attention_appended(q, kc, vc, kn, vn, prev_len=prev,
                                      window=window, scale=scale)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    assert _rel(got, want) <= tol
    assert _rel(got, plain) <= tol
    # a second call finds the split counters reset
    again = slot_decode_attention(q, kc, vc, kn, vn, prev_len=prev,
                                  window=window, scale=scale)
    assert torch.equal(again, got)


@pytest.mark.card
def test_card_kernel_at_zamba2_7b_decode_shape(card):
    """Zamba2-7B's shape: 32 slots of 2048, 32 heads of 224 (G = 1), its
    scale (224 / 2)^-0.5, ragged lengths with 0, 1, 2047, a full cache and
    one grown past it."""
    gen = torch.Generator().manual_seed(5)
    lens = [0, 1, 2047, 2048, 2300, 255, 256, 257] + torch.randint(
        2, 1600, (24,), generator=gen).tolist()
    _check_kernel(card, 32, 32, 1, 2048, 224, torch.bfloat16, lens,
                  scale=112 ** -0.5)
    _check_kernel(card, 8, 4, 2, 700, 224, torch.float32, lens[:8],
                  window=300, scale=112 ** -0.5)


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("D", [64, 80, 128])
def test_card_kernel_at_other_head_dims(card, D, dtype):
    """Heads of 80 (zamba2-2.7b) and 128 with G = 3 (llama3.2-3b), 64, and
    G of 1 and 7, with and without a window."""
    lens = [0, 1, 63, 64, 65, 511, 512, 900]
    for G, window in ((3, 0), (3, 100), (1, 0), (7, 37)):
        _check_kernel(card, len(lens), 2, G, 512, D, dtype, lens,
                      window=window, seed=G + window)


@pytest.mark.card
def test_card_kernel_replays_in_a_cuda_graph(card):
    """Captured once and replayed after the lengths change on the device:
    the replay reads them there."""
    q, kc, vc, kn, vn = _inputs(4, 2, 3, 300, 128, torch.bfloat16, 3, card)
    prev = torch.tensor([5, 0, 299, 40], dtype=torch.int32, device=card)
    slot_decode_attention(q, kc, vc, kn, vn, prev_len=prev)   # warm-up
    stream = torch.cuda.Stream(card)
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.stream(stream):
        slot_decode_attention(q, kc, vc, kn, vn, prev_len=prev)
    torch.cuda.current_stream(card).wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = slot_decode_attention(q, kc, vc, kn, vn, prev_len=prev)
    for lens in ([5, 0, 299, 40], [260, 7, 1, 300]):
        prev.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        want = decode_attention_appended(q, kc, vc, kn, vn, prev_len=prev)
        assert bool(torch.isfinite(out).all())
        assert _rel(out, want) <= 2e-2
