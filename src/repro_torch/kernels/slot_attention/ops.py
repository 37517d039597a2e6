"""Public wrapper for the slot decode attention kernel
(``csrc/slot_attention.cu``).

Same signature and layouts as its plain version,
:func:`repro_torch.models.layers.decode_attention_appended`: q is
(B, 1, H, D) with H = KH * G query heads grouped over KH kv heads, the
caches (B, KH, Smax, D) kv-heads-major, the new token's k / v (B, KH, D),
``prev_len`` (B,) the positions before it. The slot backend's decode step
calls it on its kernel tier.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain version; CUDA tensors launch the hand-written kernel or raise --
there is no fallback from a kernel to its plain version. The wrapper
checks device, dtype, shape and contiguity, allocates the output, and
launches on the current stream without synchronising; it never reads
``prev_len`` on the host, so a CUDA graph can replay the launch.

The kernel cuts each slot's positions into splits of the paged decode
kernels' ``SPLIT_POSITIONS`` and combines them in the float32 workspace
and counters those kernels keep per (device, stream)
(``paged_attention.ops``): calls on one stream run one after another, and
every call leaves the counters zero.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import (_DTYPE_CODE,
                                                     SPLIT_POSITIONS, _group,
                                                     _workspace)
from repro_torch.models.layers import decode_attention_appended

HEAD_DIMS = (64, 80, 128, 224)


def slot_decode_attention(q, k_cache, v_cache, k_new, v_new, *, prev_len,
                          window=0, scale=None):
    """Single-token attention over each slot's cache rows plus its new
    token's k / v, under one softmax, without writing the new token into
    the cache.

    q: (B, 1, H, D); k_cache / v_cache: (B, KH, Smax, D); k_new / v_new:
    (B, KH, D); prev_len: (B,) int32 valid positions before this token (a
    length past Smax attends the whole cache); ``window``: sliding-window
    size (0 = unlimited); ``scale``: the softmax scale (default
    1/sqrt(D)). Scores, probabilities and sums in float32. Returns
    (B, 1, H, D) in q's dtype.
    """
    B, _, H, D = q.shape
    KH, Smax = k_cache.shape[1], k_cache.shape[2]
    G = _group(q[:, 0], KH)
    _build.forbid_grad("slot_decode_attention", q, k_cache, v_cache, k_new,
                       v_new)
    if q.device.type == "cpu":
        return decode_attention_appended(q, k_cache, v_cache, k_new, v_new,
                                         prev_len=prev_len, window=window,
                                         scale=scale)
    q, k_new, v_new = q.contiguous(), k_new.contiguous(), v_new.contiguous()
    for t in (k_cache, v_cache, k_new, v_new, prev_len):
        if t.device != q.device:
            raise ValueError(f"all inputs must be on {q.device}, "
                             f"got {t.device}")
    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("the CUDA kernel takes contiguous caches only")
    if any(t.data_ptr() % 16 for t in (k_cache, v_cache, k_new, v_new)):
        raise ValueError("the CUDA kernel takes caches and new k / v whose "
                         "data start on a 16-byte boundary only (their rows "
                         "arrive by 16-byte cp.async copies)")
    if q.dtype not in _DTYPE_CODE or any(
            t.dtype != q.dtype for t in (k_cache, v_cache, k_new, v_new)):
        raise TypeError(f"q, the caches and the new k / v must share "
                        f"float32 or bfloat16, got {q.dtype}, "
                        f"{k_cache.dtype}, {v_cache.dtype}, {k_new.dtype}, "
                        f"{v_new.dtype}")
    if prev_len.dtype != torch.int32 or prev_len.shape != (B,):
        raise TypeError("prev_len must be (B,) int32")
    if q.shape[1] != 1 or k_cache.shape != (B, KH, Smax, D) \
            or v_cache.shape != k_cache.shape \
            or k_new.shape != (B, KH, D) or v_new.shape != k_new.shape:
        raise ValueError("q must be (B, 1, H, D), the caches (B, KH, Smax, "
                         "D) and the new k / v (B, KH, D)")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D}; the kernel takes {HEAD_DIMS}")
    if window < 0 or (scale is not None and not scale > 0):
        raise ValueError(f"window {window} must not be negative and scale "
                         f"{scale} must be positive")
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ws, counters = _workspace(q.device, stream, B, H, D, Smax + 1)
    fn = _build.library("slot_attention").slot_decode_attention_fwd
    if fn.argtypes is None:
        # 9 pointers, 8 ints, the scale (0: 1/sqrt(D)), the stream
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            k_new.data_ptr(), v_new.data_ptr(), prev_len.data_ptr(),
            out.data_ptr(), ws.data_ptr(), counters.data_ptr(), B, KH, G, D,
            Smax, window, SPLIT_POSITIONS, _DTYPE_CODE[q.dtype],
            float(scale or 0.0), stream)
    _build.check("slot_attention", "slot_decode_attention_fwd", rc)
    _build.LAUNCHES["slot_decode_attention"] += 1
    return out
