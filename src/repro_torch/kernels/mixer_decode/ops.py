"""Public wrapper for the Mamba2 mixer decode kernel
(``csrc/mixer_decode.cu``).

Same arguments and result as its plain version,
:func:`repro_torch.models.mamba2.mixer_decode_step`: one token's in_proj
row ``zxbcdt`` (B, 1, 2 di + 2 G N + H), the layer's decode state
{"conv": (B, K - 1, Ch), "ssm": (B, H, P, N) float32}, the mixer's
weights and its config -> (the gated, normed y (B, 1, di), the new
state). The slot engine's decode step calls it through ``mamba2._mixer``
on its kernel tier, where :func:`takes` holds. A call launches two device
kernels (the step, then the gated norm) and counts one launch of
``mixer_decode``.

Dispatch is by the tensors' device and nothing else: CPU tensors run the
plain version, which returns a new state; CUDA tensors launch the
hand-written kernel, which updates the given conv and ssm tensors in place
and returns them, or raise -- there is no fallback from a kernel to its
plain version. The wrapper checks device, dtype, shape, contiguity and
alignment, allocates the output and launches on the current stream
without synchronising; it reads nothing on the host, so a CUDA graph can
replay the launch.

The kernel counts on B * G int32 counters that start and end each call at
zero: the counters the paged decode kernels keep per (device, stream)
(``paged_attention.ops``), which calls on one stream use one after
another.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ops import _workspace
from repro_torch.models.mamba2 import mixer_decode_step

HEAD_DIM = 64
STATE_DIMS = (64, 128)
CONV_KERNEL = 4
NORM_COLUMNS = 8192         # a group's columns, at most


def takes(cfg, dtype, device) -> bool:
    """Whether the kernel runs the decode step of ``cfg``'s mixer for
    activations of ``dtype`` on ``device``: bf16 on a CUDA device, heads of
    64, a state of 64 or 128, a conv of 4 taps, and groups that divide the
    heads into at most 8192 columns each."""
    s = cfg.ssm
    return (torch.device(device).type == "cuda" and dtype == torch.bfloat16
            and s.head_dim == HEAD_DIM and s.d_state in STATE_DIMS
            and s.conv_kernel == CONV_KERNEL
            and cfg.ssm_heads % s.n_groups == 0
            and cfg.d_inner // s.n_groups <= NORM_COLUMNS)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def mixer_decode(zxbcdt, state, p, cfg):
    """One token of ``cfg``'s Mamba2 mixer between its projections.

    zxbcdt: (B, 1, 2 di + 2 G N + H); state: {"conv": (B, K - 1, di + 2 G
    N) in zxbcdt's dtype, "ssm": (B, H, P, N) float32}; ``p``: the layer's
    mixer weights (``conv_w`` (K, Ch), ``conv_b`` (Ch,), ``norm`` (di,),
    ``A_log``, ``dt_bias``, ``D`` (H,) float32). Returns (the gated, normed
    y (B, 1, di) in zxbcdt's dtype, the new state): on CUDA tensors the
    given ``conv`` and ``ssm``, updated in place.
    """
    conv, ssm = state["conv"], state["ssm"]
    w = [p[k] for k in ("conv_w", "conv_b", "A_log", "dt_bias", "D")]
    norm = p["norm"]
    _build.forbid_grad("mixer_decode", zxbcdt, conv, ssm, *w, norm)
    if zxbcdt.device.type == "cpu":
        return mixer_decode_step(zxbcdt, state, p, cfg)
    dev = zxbcdt.device
    for t in (conv, ssm, *w, norm):
        if t.device != dev:
            raise ValueError(f"all inputs must be on {dev}, got {t.device}")
    if not takes(cfg, zxbcdt.dtype, dev):
        raise ValueError(
            f"the CUDA kernel takes bf16 activations, heads of {HEAD_DIM}, "
            f"states of {STATE_DIMS}, a conv of {CONV_KERNEL} taps and "
            f"groups that divide the heads into at most {NORM_COLUMNS} "
            f"columns; got {zxbcdt.dtype}, "
            f"{cfg.ssm}, {cfg.ssm_heads} heads")
    G, N, H = cfg.ssm.n_groups, cfg.ssm.d_state, cfg.ssm_heads
    di = cfg.d_inner
    B, ch, W = zxbcdt.shape[0], di + 2 * G * N, 2 * di + 2 * G * N + H
    if any(t.dtype != zxbcdt.dtype for t in (conv, w[0], w[1], norm)) \
            or ssm.dtype != torch.float32 \
            or any(t.dtype != torch.float32 for t in w[2:]):
        raise TypeError("zxbcdt, the conv window, conv_w, conv_b and norm "
                        "must be bfloat16; the ssm state, A_log, dt_bias and "
                        "D float32")
    if zxbcdt.shape != (B, 1, W) or conv.shape != (B, CONV_KERNEL - 1, ch) \
            or ssm.shape != (B, H, HEAD_DIM, N) \
            or w[0].shape != (CONV_KERNEL, ch) or w[1].shape != (ch,) \
            or norm.shape != (di,) or any(t.shape != (H,) for t in w[2:]):
        raise ValueError(
            f"zxbcdt must be (B, 1, {W}), the conv window (B, "
            f"{CONV_KERNEL - 1}, {ch}), the ssm state (B, {H}, {HEAD_DIM}, "
            f"{N}), conv_w ({CONV_KERNEL}, {ch}), conv_b ({ch},), norm "
            f"({di},) and A_log, dt_bias, D ({H},)")
    if not all(t.is_contiguous() for t in (zxbcdt, conv, ssm, *w, norm)):
        raise ValueError("the CUDA kernel takes contiguous tensors only")
    if not _aligned(conv, ssm, w[0], w[1], norm):
        raise ValueError("the CUDA kernel takes a conv window, ssm state, "
                         "conv_w, conv_b and norm that start on a 16-byte "
                         "boundary only (they move by 16-byte loads)")
    out = torch.empty((B, 1, di), dtype=zxbcdt.dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _, counters = _workspace(dev, stream, B, G, 0, 1)
    fn = _build.library("mixer_decode").mixer_decode_fwd
    if fn.argtypes is None:
        # 11 pointers, 5 ints, the norm's eps, the stream
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    # the row moves by 16-byte loads where its rows start on 16 bytes
    row_vec = int(W % 8 == 0 and _aligned(zxbcdt))
    rc = fn(zxbcdt.data_ptr(), conv.data_ptr(), ssm.data_ptr(),
            *(t.data_ptr() for t in w), norm.data_ptr(), out.data_ptr(),
            counters.data_ptr(), B, H, G, N, row_vec, float(cfg.norm_eps),
            stream)
    _build.check("mixer_decode", "mixer_decode_fwd", rc)
    _build.LAUNCHES["mixer_decode"] += 1
    return out, state
