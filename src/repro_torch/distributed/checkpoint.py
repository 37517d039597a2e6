"""Checkpoints in the reference's format (the port of
``repro/distributed/checkpoint.py``): a file either package writes, the
other reads.

A file is a 4-byte magic and a compressed MessagePack map {version, step,
metadata, paths, arrays}: ``paths`` are the leaves' key paths joined with
``/`` in sorted-key order, each array is {dtype (numpy's ``dtype.str``, or
"bfloat16" for bf16 leaves stored as uint16), shape, data}. The port writes
``RPZL`` (zlib) and packs with its own MessagePack subset
(:mod:`repro_torch.distributed._msgpack`); it reads ``RPZL`` and, when
``zstandard`` can be imported, ``RPZS`` and the reference's legacy
headerless zstd files. A write is atomic (tmp + rename). MessagePack's
bin 32 limits each leaf to 4 GiB, as in the reference.

The reference's ``shardings`` argument (elastic restore onto a mesh) waits
for tensor parallelism (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import os
import tempfile
import zlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import _msgpack
from repro_torch.tree import tree_unflatten

FORMAT_VERSION = 1
_MAGIC_ZSTD = b"RPZS"
_MAGIC_ZLIB = b"RPZL"


def _zstandard():
    try:
        import zstandard
    except ImportError:
        return None
    return zstandard


def _decompress(blob: bytes) -> bytes:
    magic, body = blob[:4], blob[4:]
    if magic == _MAGIC_ZLIB:
        return zlib.decompress(body)
    zstd = _zstandard()
    if magic == _MAGIC_ZSTD:
        if zstd is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "zstandard module is not installed")
        return zstd.ZstdDecompressor().decompress(body)
    # legacy (pre-magic) checkpoints were always zstd
    if zstd is not None:
        return zstd.ZstdDecompressor().decompress(blob)
    raise RuntimeError("unrecognized checkpoint compression header")


def _flatten(tree, prefix=""):
    """[(path, leaf)] of nested dicts in the reference's pytree order
    (sorted keys), paths joined with ``/``."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += _flatten(tree[k], f"{prefix}/{k}" if prefix else str(k))
    return out


def _to_numpy(leaf) -> tuple[str, np.ndarray]:
    """(dtype name, array) of a leaf as it is stored."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr.dtype.str, arr


def save_checkpoint(path: str, tree, *, step: int = 0,
                    metadata: dict | None = None, level: int = 3) -> None:
    """Write ``tree`` (nested dicts of tensors or arrays) with ``step`` and
    ``metadata`` (MessagePack-able) to ``path``, zlib at ``level`` (capped
    at 9, as the reference caps its zlib fallback). Atomic: a crash during
    the write never corrupts an earlier file at ``path``."""
    paths, arrays = [], []
    for p, leaf in _flatten(tree):
        dtype, arr = _to_numpy(leaf)
        paths.append(p)
        arrays.append({"dtype": dtype, "shape": list(arr.shape),
                       "data": arr.tobytes()})
    payload = {"version": FORMAT_VERSION, "step": step,
               "metadata": metadata or {}, "paths": paths,
               "arrays": arrays}
    blob = _MAGIC_ZLIB + zlib.compress(_msgpack.packb(payload),
                                       min(level, 9))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _to_tensor(spec, device):
    if spec["dtype"] == "bfloat16":
        arr = np.frombuffer(spec["data"], np.uint16).reshape(spec["shape"])
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    arr = np.frombuffer(spec["data"], np.dtype(spec["dtype"])).reshape(
        spec["shape"])
    return torch.from_numpy(arr.copy()).to(device)


def load_checkpoint(path: str, target=None, device=None):
    """Returns (tree, step, metadata). ``target`` (a tree of the same
    structure) restores the original structure; without it a flat
    {path: tensor} dict is returned. Tensors keep the stored dtype and go
    to ``device`` (default: the CUDA device, RuntimeError without a
    card)."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        payload = _msgpack.unpackb(_decompress(f.read()))
    if payload["version"] != FORMAT_VERSION:
        raise ValueError(f"checkpoint format {payload['version']}, this "
                         f"reader takes {FORMAT_VERSION}")
    by_path = {p: _to_tensor(spec, dev)
               for p, spec in zip(payload["paths"], payload["arrays"])}
    if target is None:
        return by_path, payload["step"], payload["metadata"]
    t_paths = [p for p, _ in _flatten(target)]
    missing = [p for p in t_paths if p not in by_path]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} arrays, "
                       f"e.g. {missing[:3]}")
    tree = tree_unflatten(target, [by_path[p] for p in t_paths])
    return tree, payload["step"], payload["metadata"]


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt_"):
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [f for f in os.listdir(ckpt_dir)
             if f.startswith(prefix) and f.endswith(".ckpt")]
    if not cands:
        return None
    steps = sorted((int(f[len(prefix):-5]), f) for f in cands)
    return os.path.join(ckpt_dir, steps[-1][1])


def checkpoint_path(ckpt_dir: str, step: int, prefix: str = "ckpt_"):
    return os.path.join(ckpt_dir, f"{prefix}{step:08d}.ckpt")
