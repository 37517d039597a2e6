#!/usr/bin/env python3
"""What holds the paged decode kernel (``csrc/paged_attention.cu``) above
its bound: variants of it, timed on one CUDA card.

Run from the root of a checkout on a machine with a card and ``nvcc``::

    python3 scripts/decode_attention_probe.py [--splits 128,256,512]

Each variant is the kernel's source with a few lines substituted (below),
built with the port's ``nvcc`` flags into ``build/decode_probe/`` (all
builds started together) and bound with ``ctypes`` in place of the
wrappers' entries. Every variant is timed by device time -- L2 flushed,
the host queued ahead behind a spin kernel, median of 25 calls
(``chip_smoke.Kernels.time_ms``) -- at five mixes of context lengths on
the llama3.2-3b decode shape (8 sequences, 24 query over 8 kv heads,
head dim 128, page 64, 64 pages a sequence, tails of up to 8, bf16), in
the order variant, ..., variant, ..., first (so each is timed twice). A
variant that computes the same function is first checked against the
plain version (``TOL`` of ``chip_smoke.py``). The kernel itself is also
timed at every split size of ``--splits``. Last, the device time of one
``torch.sum`` over as many bf16 bytes as the main mix's K and V: the
time one PyTorch kernel that only reads those bytes takes, measured the
same way. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "paged_attention.cu"
OUT = ROOT / "build" / "decode_probe"

_COPIES = ("      cp_async_16(smem_u32(kst) + so, kb + row * D + c * VN, "
           "ok);\n      cp_async_16(smem_u32(vst) + so, vb + row * D + "
           "c * VN, ok);\n")
_QK = "    // scores: warp w sums quarter w of D"
_TILE_END = "    __syncthreads();     // the stage and p_s are rewritten next"
_PROLOGUE = "    if (s < ntiles) load_tile(s, start + s * kTile);"
_NEXT = "    if (nt < ntiles) load_tile(nt % STAGES, start + nt * kTile);"
_GRID = "  dim3 grid(a.KH * ((a.G + GC - 1) / GC), a.B, nsplit);"
_BLOCK = ("  const int sp = blockIdx.z, b = blockIdx.y;\n"
          "  const int NG = (G + GC - 1) / GC;\n"
          "  const int kh = blockIdx.x / NG, grp = blockIdx.x % NG;")
_NEVER = "page_size < 0"       # false at run time, unknown to the compiler

# name -> (substitutions, computes the kernel's function)
VARIANTS = {
    "kernel": ([], True),
    # the address arithmetic of every copy, but no copy: compute alone
    "no_copies": ([(_COPIES, f"      if ({_NEVER}) {{\n{_COPIES}"
                    "      }\n")], False),
    # every copy, but no scores, softmax or PV: the loads alone
    "no_compute": ([(_QK, f"    if ({_NEVER}) {{\n{_QK}"),
                    (_TILE_END, f"    }}\n{_TILE_END}")], False),
    # neither copies nor their address arithmetic
    "no_loader": ([(_PROLOGUE, _PROLOGUE.replace("if (", f"if ({_NEVER} && ")),
                   (_NEXT, _NEXT.replace("if (", f"if ({_NEVER} && "))],
                  False),
    # the grid with the split index varying fastest
    "split_fastest": ([(_GRID, "  dim3 grid(nsplit, a.B, a.KH * "
                               "((a.G + GC - 1) / GC));"),
                       (_BLOCK, _BLOCK.replace("blockIdx.z", "blockIdx.t")
                        .replace("blockIdx.x", "blockIdx.z")
                        .replace("blockIdx.t", "blockIdx.x"))], True),
    # a ring of two stages (64 KB at D = 128): three blocks an SM
    "two_stages": ([("constexpr int kRingBudget = 96 * 1024;",
                     "constexpr int kRingBudget = 64 * 1024;")], True),
}

MIXES = {   # name -> (context lengths, tail lengths)
    "main": ([1, 64, 65, 1000, 2047, 1536, 1100, 700],
             [0, 1, 2, 3, 5, 6, 7, 8]),
    "empty": ([0] * 8, [0] * 8),
    "even1020": ([1020] * 8, [3] * 8),
    "full4096": ([4096] * 8, [8] * 8),
    "short64": ([64] * 8, [2] * 8),
}


def build(build_mod) -> dict:
    src = SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, (subs, _) in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: anchor not found once: "
                                 f"{old[:60]!r}")
            text = text.replace(old, new)
        cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
        cu.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [build_mod._nvcc(), *build_mod.NVCC_FLAGS, "-o", str(lib),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate(timeout=build_mod.NVCC_TIMEOUT_S)
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log[-4000:]}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splits", default="128,256,512",
                    help="split sizes to time the kernel at")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.ref import (
        fused_decode_attention_ref, paged_attention_ref)

    print(chip_smoke.nvidia_smi_line())
    libs = build(_build)
    _build.library("paged_attention")     # for the wrappers' error strings
    dev = torch.device("cuda", 0)
    K = chip_smoke.Kernels(torch, dev)
    shape = dict(B=8, H=24, KH=8, D=128, page=64, PPS=64, Kt=8,
                 dtype=torch.bfloat16)
    cases = {m: chip_smoke.decode_case(K, lens=lens, tails=tails, **shape)
             for m, (lens, tails) in MIXES.items()}
    splits = [int(s) for s in args.splits.split(",")]
    default = ops.SPLIT_POSITIONS
    order = list(libs) + list(libs)[::-1]
    times: dict = {}
    for name in order:
        lib = libs[name]
        ops._ENTRIES["paged_attention_fwd"] = _build.bind(
            lib, "paged_attention_fwd", 8, 8)
        ops._ENTRIES["paged_decode_tail_fwd"] = _build.bind(
            lib, "paged_decode_tail_fwd", 11, 9)
        checked = VARIANTS[name][1]
        for mix, c in cases.items():
            a = (c["q"], c["kp"], c["vp"], c["tables"], c["cl"])
            ta = a + (c["kt"], c["vt"], c["tl"])
            for entry, fn, ref, fargs in (
                    ("paged_attention", ops.paged_attention,
                     paged_attention_ref, a),
                    ("fused_decode_attention", ops.fused_decode_attention,
                     fused_decode_attention_ref, ta)):
                for sp in (splits if name == "kernel" else [default]):
                    ops.SPLIT_POSITIONS = sp
                    if checked:
                        rel, _ = chip_smoke.rel_err(fn(*fargs), ref(*fargs))
                        chip_smoke.check(rel <= chip_smoke.TOL["bfloat16"],
                                         f"{name} {mix} {entry} S={sp}: "
                                         f"rel_err {rel:.3e}")
                    t = K.time_ms(lambda: fn(*fargs), device=True)
                    times.setdefault((name, mix, entry, sp), []).append(t)
                ops.SPLIT_POSITIONS = default
    ops._ENTRIES.clear()
    for (name, mix, entry, sp), ts in times.items():
        print(f"{name:14s} {mix:9s} {entry:23s} S={sp:4d}  device ms "
              + " / ".join(f"{t:.4f}" for t in ts))
    n_bytes = sum(min(n, 4096) for n in MIXES["main"][0]) * 8 * 128 * 2 * 2
    x = torch.empty(n_bytes // 2, dtype=torch.bfloat16, device=dev).normal_()
    print(f"torch sum over {n_bytes} B of bf16 (the main mix's K and V): "
          f"device ms {K.time_ms(lambda: x.sum(), device=True):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
