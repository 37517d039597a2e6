"""Public wrapper for the paged flash-prefill kernel (``csrc/paged_prefill.cu``).

Same signature and layout as ``paged_flash_prefill`` in the JAX package's
``repro/kernels/flash_attention/ops.py``. CPU tensors run the plain
PyTorch version (``ref.py``); CUDA tensors launch the kernel or raise.
The kernel reads q and writes the output in their (B, C, H, D) layout and
folds (token, head of the group) into query rows itself, so the wrapper
makes no fold copies; it allocates the output and the (B,) int32 start and
length vectors, and launches on the current stream without synchronising.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import paged_prefill_attention_ref
from repro_torch.kernels.paged_attention.ops import (_DTYPE_CODE, HEAD_DIMS,
                                                     _group)


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
    if q.device.type == "cpu":
        return paged_prefill_attention_ref(q, k_pages, v_pages, block_tables,
                                           q_offset, kv_len)
    for t in (q, k_pages, v_pages, block_tables):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernel takes contiguous tensors only")
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
