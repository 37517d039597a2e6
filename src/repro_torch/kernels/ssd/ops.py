"""Public wrapper for the SSD chunked-scan kernel (``csrc/ssd.cu``).

Same contract as ``ssd`` in the JAX package's ``repro/kernels/ssd/ops.py``
and as :func:`repro_torch.models.mamba2.ssd_chunked` with ``h0 = 0``.
CPU tensors run the plain version (``ref.py``); CUDA tensors launch the
kernel or raise. The kernel reads x and writes y in their (b, s, h, p)
layout and reads B and C from their (b, s, n) or (b, s, g, n) layout
through their strides, so the wrapper makes no transposes and no per-head copies (the
JAX wrapper's exist for TPU block specs); it allocates y and the final
state and launches on the current stream without synchronising.

bfloat16 runs three chunk-parallel passes on the tensor cores (chunk
states, the sequential state pass, the chunk scan; ``ref.ssd_passes_ref``
models them on the CPU) through a workspace of per-chunk states and
cumulative decays. The workspace is made once per (device, stream) and
grown when a call needs more, so a call allocates nothing but y and the
state. float32 runs the FMA kernel and needs no workspace.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ssd.ref import ssd_chunked

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64,)
STATE_DIMS = (64, 128)
MAX_CHUNK = 256
# (device index, stream) -> uint8 workspace
_WORKSPACE: dict = {}
_ENTRIES: dict = {}


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        lib = _build.library("ssd")
        if name == "ssd_fwd":
            fn = _build.bind(lib, name, 7, 11)
        else:   # ssd_workspace_bytes(b, S, H, P, N, Q, dtype)
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_int] * 7
            fn.restype = ctypes.c_longlong
        _ENTRIES[name] = fn
    return fn


def _workspace(dev, stream: int, nbytes: int):
    """The cached workspace of ``dev`` / ``stream``, at least ``nbytes``."""
    key = (dev.index, stream)
    ws = _WORKSPACE.get(key)
    if ws is None or ws.numel() < nbytes:
        old = 0 if ws is None else ws.numel()
        ws = _WORKSPACE[key] = torch.empty(max(nbytes, old),
                                           dtype=torch.uint8, device=dev)
    return ws


def ssd(x, a, B, C, chunk=256):
    """x: (b, s, h, p) (already * dt); a: (b, s, h) float32; B, C:
    (b, s, n) shared across heads, or (b, s, g, n) in g groups (head i
    reads group i // (h / g)). Returns (y (b, s, h, p) in x's dtype, final
    state (b, h, p, n) float32)."""
    _build.forbid_grad("ssd", x, a, B, C)
    if x.device.type == "cpu":
        return ssd_chunked(x, a, B, C, chunk)
    b, s, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, s)
    # one group: (b, s, n) is (b, s, 1, n) with no group stride
    g, bc_g = (B.shape[2], B.stride(2)) if B.dim() == 4 else (1, 0)
    for t in (x, a, B, C):
        if t.device != x.device:
            raise ValueError(f"all inputs must be on {x.device}, "
                             f"got {t.device}")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype \
            or C.dtype != x.dtype or a.dtype != torch.float32:
        raise TypeError(f"x, B and C must share float32 or bfloat16 and a "
                        f"must be float32, got {x.dtype}/{B.dtype}/"
                        f"{C.dtype}/{a.dtype}")
    if not (x.is_contiguous() and a.is_contiguous()) \
            or a.shape != (b, s, h):
        raise ValueError("x must be a contiguous (b, s, h, p) and a a "
                         "contiguous (b, s, h)")
    if B.shape[:2] != (b, s) or B.shape[-1] != n or B.dim() not in (3, 4) \
            or C.shape != B.shape or B.stride() != C.stride() \
            or B.stride(-1) != 1 or B.stride(0) >= 2 ** 31 or h % g:
        raise ValueError("B and C must be (b, s, n) or (b, s, g, n) with g "
                         "dividing the heads, equal strides, a contiguous "
                         "last axis and int32 strides")
    if p not in HEAD_DIMS or n not in STATE_DIMS or not 0 < Q <= MAX_CHUNK:
        raise ValueError(f"the kernel takes head dim in {HEAD_DIMS}, state "
                         f"dim in {STATE_DIMS} and chunks up to {MAX_CHUNK}; "
                         f"got p={p} n={n} chunk={Q}")
    code = _DTYPE_CODE[x.dtype]
    if code == 1 and (any(t.data_ptr() % 16 for t in (x, B, C))
                      or B.stride(0) % 8 or B.stride(1) % 8 or bc_g % 8):
        raise ValueError("bfloat16 x, B and C rows must start on 16-byte "
                         "boundaries (row strides a multiple of 8)")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    nbytes = _entry("ssd_workspace_bytes")(b, s, h, p, n, Q, code)
    if nbytes < 0:
        raise ValueError(f"ssd_fwd does not take b={b} s={s} h={h} p={p} "
                         f"n={n} Q={Q}")
    ws = _workspace(x.device, stream, nbytes).data_ptr() if nbytes else None
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    rc = _entry("ssd_fwd")(
        x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(), y.data_ptr(),
        state.data_ptr(), ws, b, s, h, p, n, Q, B.stride(0), B.stride(1), g,
        bc_g, code, stream)
    _build.check("ssd", "ssd_fwd", rc)
    _build.LAUNCHES["ssd"] += 1
    for k in (("ssd_chunk_state", "ssd_state_pass", "ssd_chunk_scan")
              if code == 1 else ("ssd_fma",)):
        _build.PASS_LAUNCHES[k] += 1
    return y, state
