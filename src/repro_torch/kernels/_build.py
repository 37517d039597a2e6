"""Build and load the port's CUDA C++ kernels.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface. On first
use it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/repro_torch_kernels/`` in the checkout (listed in ``.gitignore``),
named by a hash of its source, the shared headers (``csrc/*.cuh``) and the
flags, so an edited source or header rebuilds, and loaded with ``ctypes``.
Nothing here runs at import time, and nothing here is reached for CPU
tensors: the CPU tests never need ``nvcc``.

The kernels are forward only: :func:`forbid_grad` makes every wrapper
refuse inputs that require grad while autograd records, on the CPU (where
the wrapper runs its plain version) as on the card (where a kernel's
output would carry no gradient).

Every C entry returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0. ``LAUNCHES`` counts launches per
kernel wrapper, so a run can show that the main path went through the
kernels; ``PASS_LAUNCHES`` counts the passes of a wrapper that launches
several device kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("paged_attention", "paged_prefill", "ssd", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

# launches per kernel wrapper; incremented only where a kernel is launched
LAUNCHES = {"paged_attention": 0, "fused_decode_attention": 0,
            "paged_flash_prefill": 0, "ssd": 0, "flash_attention": 0}
# device kernels per pass of a wrapper that launches several: the SSD
# scan's bf16 route launches its three passes once a call, float32 its one
# FMA kernel
PASS_LAUNCHES = {"ssd_chunk_state": 0, "ssd_state_pass": 0,
                 "ssd_chunk_scan": 0, "ssd_fma": 0}
# source name -> nvcc's output (register / shared-memory use from ptxas)
BUILD_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, PASS_LAUNCHES):
        for k in counts:
            counts[k] = 0


def forbid_grad(name: str, *tensors) -> None:
    """Raise when autograd is recording and one of ``tensors`` requires
    grad: the kernel behind wrapper ``name`` has no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} is forward only (its kernel has no backward): call it "
            f"under torch.no_grad() or with inputs that do not require grad")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "port's CUDA kernels cannot be built")
    return path


def _paths(name: str) -> tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile every named source that has no up-to-date library, one
    ``nvcc`` per source, all started together. Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src, lib = _paths(name)
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, lib))
    failed = []
    for name, proc, tmp, lib in jobs:
        try:
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, _ = proc.communicate()
            out += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        BUILD_LOG[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}:\n{out}")
            continue
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_paths(name)[1]))
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib_name: str, entry: str, code: int) -> None:
    """Raise if a C entry reported a CUDA error."""
    if code != 0:
        msg = getattr(_LIBS[lib_name], f"{lib_name}_error_string")(code)
        raise RuntimeError(f"{entry}: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")


def bind(lib: ctypes.CDLL, entry: str, n_ptr: int, n_int: int):
    """Set argtypes for an entry taking ``n_ptr`` pointers, ``n_int`` ints
    and the stream (pointers and stream as c_void_p, ints as c_int)."""
    fn = getattr(lib, entry)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn
