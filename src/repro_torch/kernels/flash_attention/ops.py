"""Public wrappers for the flash-attention kernels: dense prefill
attention (``csrc/flash_attention.cu``) and paged chunked prefill
(``csrc/paged_prefill.cu``).

Same signatures and layouts as ``flash_attention`` and
``paged_flash_prefill`` in the JAX package's
``repro/kernels/flash_attention/ops.py``. CPU tensors run the plain
PyTorch versions; CUDA tensors launch the kernel or raise. The kernels
read q and write the output in their (B, S, H, D) layout and fold
(token, head of the group) into query rows themselves, so the wrappers
make no fold copies; they allocate the output (and, for the paged kernel,
the (B,) int32 start and length vectors), and launch on the current stream
without synchronising.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import paged_prefill_attention_ref
from repro_torch.kernels.paged_attention.ops import (_DTYPE_CODE, HEAD_DIMS,
                                                     _group)
from repro_torch.models.layers import chunked_attention

FLASH_HEAD_DIMS = (64, 80, 128)


def _check_layout(q, tensors, k, v):
    """The CUDA kernels take contiguous tensors on q's device, with k and v
    starting on a 16-byte boundary (their rows arrive by 16-byte cp.async
    copies or TMA boxes)."""
    for t in tensors:
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("the CUDA kernel takes k and v whose data start on "
                         "a 16-byte boundary only")


def flash_attention(q, k, v, *, causal=True, window=0, seq_k=None):
    """Dense flash attention. q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with
    H % KH == 0. Positions are start-aligned, as in the JAX kernel: query
    i and key i both sit at position i. ``seq_k`` (default Sk) keys are
    valid; ``window`` > 0 limits each query to its last ``window``
    positions. A row with no visible key is zeros. Returns (B, Sq, H, D)
    in q's dtype."""
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    seq_k = Sk if seq_k is None else int(seq_k)
    if H % KH:
        raise ValueError(
            f"query heads ({H}) must be a multiple of kv heads ({KH})")
    _build.forbid_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 kv_len=seq_k)
    _check_layout(q, (q, k, v), k, v)
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share float32 or bfloat16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if k.shape != (B, Sk, KH, D) or v.shape != k.shape \
            or D not in FLASH_HEAD_DIMS:
        raise ValueError(f"k and v must be (B, Sk, KH, D) like q's batch "
                         f"and head dim, with D in {FLASH_HEAD_DIMS}")
    if not 0 <= seq_k <= Sk or window < 0:
        raise ValueError(f"seq_k {seq_k} must lie in [0, {Sk}] and window "
                         f"{window} must not be negative")
    out = torch.empty_like(q)
    lib = _build.library("flash_attention")
    fn = _build.bind(lib, "flash_attention_fwd", 4, 10)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, KH, H // KH, D, seq_k, int(bool(causal)), int(window),
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("flash_attention", "flash_attention_fwd", rc)
    _build.LAUNCHES["flash_attention"] += 1
    return out


def paged_flash_prefill(q, k_pages, v_pages, block_tables, q_offset: int,
                        kv_len: int):
    """Chunked-prefill causal flash attention reading the paged pool.

    q: (B, C, H, D), a chunk whose first token sits at absolute position
    ``q_offset`` and whose own KV is already written into the pages;
    ``kv_len`` counts the valid positions (cached prefix + this chunk);
    block_tables: (B, PPS) int32. No (B, S, KH, D) gather is materialized
    on the kernel path. Returns (B, C, H, D).
    """
    B, C, H, D = q.shape
    KH = k_pages.shape[2]
    if H % KH:
        raise ValueError(
            f"query heads ({H}) must be a multiple of kv heads ({KH})")
    _build.forbid_grad("paged_flash_prefill", q, k_pages, v_pages)
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           q_offset, kv_len)
    _check_layout(q, (q, k_pages, v_pages, block_tables), k_pages,
                  v_pages)
    if q.dtype not in _DTYPE_CODE or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"q and pages must share float32 or bfloat16, got "
                        f"{q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError("block tables must be (B, PPS) int32")
    NP, page, _, Dk = k_pages.shape
    if Dk != D or D not in HEAD_DIMS or page % 16 \
            or v_pages.shape != k_pages.shape:
        raise ValueError(f"head dim {D} must be one of {HEAD_DIMS} and the "
                         f"page size ({page}) a multiple of 16")
    G = _group(q[:, 0], KH)
    starts = torch.full((B,), int(q_offset), dtype=torch.int32,
                        device=q.device)
    lens = torch.full((B,), int(kv_len), dtype=torch.int32, device=q.device)
    out = torch.empty_like(q)
    lib = _build.library("paged_prefill")
    fn = _build.bind(lib, "paged_flash_prefill_fwd", 7, 8)
    rc = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lens.data_ptr(), starts.data_ptr(),
            out.data_ptr(), B, C, KH, G, D, page, block_tables.shape[1],
            _DTYPE_CODE[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check("paged_prefill", "paged_flash_prefill_fwd", rc)
    _build.LAUNCHES["paged_flash_prefill"] += 1
    return out
