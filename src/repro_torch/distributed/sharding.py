"""Sharding rules and tensor-parallel placement of the port (the
counterpart of ``repro/distributed/sharding.py``).

A spec is a tuple with one entry per dimension: an axis name, a tuple of
axis names, or None (not split), where the reference writes a
``PartitionSpec``. The rules are the reference's, entry for entry:

  mesh axes     single-pod (data=16, model=16); multi-pod (pod=2, data=16,
                model=16)
  TP ("model")  attention q/k/v columns and o rows, MLP hidden, MoE
                experts, vocab/embedding
  DP (pod,data) batch dimension (training + serving)
  FSDP ("data") second weight dim during training, and at serving when the
                model cannot fit otherwise (dbrx-132b)
  KV caches     kv heads over "model" when divisible, else head_dim over
                "model", else replicated

Every rule degrades to None when a dim is not divisible by the axis size.

:class:`ServeSharding` places a serving engine's tensors on a
``(data=D, model=M)`` mesh. One process drives every shard (the reference
has one controller too): each model shard is a parameter tree and a KV
cache on its own ``torch.device``, and the collectives are explicit calls
on tensors -- :meth:`ServeSharding.all_reduce` sums partials in shard order
on the lead device, :meth:`ServeSharding.all_gather` concatenates on it.
Shards may share one device (several shards on one card, or on the CPU):
they then run one after another on its stream. Where the serving rule
splits the weights over ``data`` as well (``needs_serve_fsdp``, FSDP at
serve), such a weight is held as :class:`DataSlices` across the data
replicas and :meth:`ServeSharding.gather` puts it back together, one layer
at a time, where its model shard computes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig

_REPLICATED_NAMES = {
    "norm", "norm1", "norm2", "final_norm", "A_log", "D", "dt_bias",
    "conv_b", "conv_w", "router", "len",
}

SERVE_FSDP_BYTES = 8 << 30      # params/chip above this forces FSDP at serve

# ServeSharding.gather: the data-split weights put back together, and the
# bytes of the gathered tensors
GATHER_STATS = {"calls": 0, "bytes": 0}


def reset_gather_stats() -> None:
    GATHER_STATS["calls"] = 0
    GATHER_STATS["bytes"] = 0


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def param_bytes(cfg: ModelConfig) -> int:
    bpp = 2 if cfg.param_dtype == "bfloat16" else 4
    return cfg.num_params * bpp


def needs_serve_fsdp(cfg: ModelConfig, model_shards: int = 16) -> bool:
    return param_bytes(cfg) / model_shards > SERVE_FSDP_BYTES


def _walk(tree, fn, path=()):
    """``fn(path, leaf)`` over nested dicts; ``path`` is the tuple of
    keys."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_name(path):
    for k in reversed(path):
        if isinstance(k, str):
            return k
    return None


@dataclass
class ShardingRules:
    """The reference's sharding rules as pure spec logic over a mesh's
    shape (any object with ``shape`` and ``axis_names``, shape-only meshes
    included)."""
    mesh: object
    cfg: ModelConfig
    train: bool = True

    # -- helpers -------------------------------------------------------------
    def _ax(self, axis, size):
        """``axis`` where its size divides ``size``, else None; a 1-tuple
        of axes is written as its one name, as ``PartitionSpec`` does."""
        if axis is None:
            return None
        names = axis if isinstance(axis, tuple) else (axis,)
        if size % math.prod(self.mesh.shape[a] for a in names):
            return None
        return names[0] if len(names) == 1 else names

    @property
    def _fsdp(self):
        if self.train:
            return "data"
        return "data" if needs_serve_fsdp(self.cfg,
                                          self.mesh.shape["model"]) else None

    @property
    def _dp(self):
        return dp_axes(self.mesh)

    # -- params --------------------------------------------------------------
    def _param_spec(self, path, shape) -> tuple:
        name = _leaf_name(path)
        nd = len(shape)
        lead = (None,) * (nd - 2)
        f, m = self._fsdp, "model"
        if name in _REPLICATED_NAMES or nd <= 1:
            return ()
        if name == "embed":
            return (self._ax(m, shape[0]), self._ax(f, shape[1]))
        if name == "lm_head":
            return (self._ax(f, shape[0]), self._ax(m, shape[1]))
        if name in ("wq", "wk", "wv", "w1", "w3", "in_proj"):
            if nd == 4:      # MoE expert stack (L, E, D, F): experts over
                # model, FSDP on F (column split)
                return (None, self._ax(m, shape[1]), None,
                        self._ax(f, shape[3]))
            return (*lead, self._ax(f, shape[-2]), self._ax(m, shape[-1]))
        if name in ("wo", "w2", "out_proj"):
            if nd == 4:      # MoE w2 (L, E, F, D): FSDP on F (row split)
                return (None, self._ax(m, shape[1]),
                        self._ax(f, shape[2]), None)
            return (*lead, self._ax(m, shape[-2]), self._ax(f, shape[-1]))
        if name in ("bq", "bk", "bv"):
            # stacked-per-layer biases are (L, dim): only the LAST dim is TP
            return (*((None,) * (nd - 1)), self._ax(m, shape[-1]))
        return ()            # conservative default: replicate

    def param_specs(self, params):
        """Specs of a parameter tree (leaves: anything with ``.shape``)."""
        return _walk(params, lambda p, x: self._param_spec(p, x.shape))

    def opt_specs(self, opt_shapes, params_shapes):
        """Adam m/v mirror the (train) param layout; step is replicated."""
        pspecs = self.param_specs(params_shapes)
        return {"m": pspecs, "v": pspecs, "step": ()}

    # -- batches -------------------------------------------------------------
    def _batched(self, shape) -> tuple:
        b = self._ax(self._dp, shape[0])
        return (b, *(None,) * (len(shape) - 1))

    def batch_specs(self, batch_shapes):
        return _walk(batch_shapes, lambda p, x: self._batched(x.shape))

    # -- caches --------------------------------------------------------------
    def _cache_spec(self, path, shape) -> tuple:
        name = _leaf_name(path)
        if name == "len":
            return (self._ax(self._dp, shape[0]),)
        b = self._ax(self._dp, shape[1])
        if name in ("k", "v"):
            # (L|G, B, KH, S, hd): batch over DP, sequence over model
            return (None, b, None, self._ax("model", shape[3]), None)
        if name == "ssm":      # (L, B, H, Phead, N)
            return (None, b, self._ax("model", shape[2]), None, None)
        if name == "conv":     # (L, B, K-1, Ch)
            return (None, b, None, self._ax("model", shape[3]))
        return (None,) * len(shape)

    def cache_specs(self, cache_shapes):
        return _walk(cache_shapes, lambda p, x: self._cache_spec(p, x.shape))


def _axis_dim(spec, axis):
    """The dimension a spec splits over ``axis``, or None."""
    for d, a in enumerate(spec):
        if a == axis or (isinstance(a, tuple) and axis in a):
            return d
    return None


def _model_dim(spec):
    """The dimension a spec splits over "model", or None."""
    return _axis_dim(spec, "model")


class DataSlices:
    """A model shard's weight split over the mesh's ``data`` axis too: its
    D slices along ``dim``, slice d a contiguous tensor of its own on
    device (d, m) of the shard's model position m, at the reference's
    shard shape. ``x[i]`` takes index i of every slice's leading dim (a
    stacked leaf's layer view, as ``transformer.layer_params`` takes it);
    nothing computes with the slices: :meth:`ServeSharding.gather` joins
    them first."""
    __slots__ = ("parts", "dim")

    def __init__(self, parts, dim: int):
        self.parts = list(parts)
        self.dim = dim

    def __getitem__(self, i: int):
        return DataSlices([p[i] for p in self.parts], self.dim - 1)


def _concat(leaf: DataSlices, device):
    """A :class:`DataSlices` joined on ``device``: an exact copy of the
    model shard's tensor."""
    return torch.cat([p.to(device) for p in leaf.parts], dim=leaf.dim)


class ServeSharding:
    """Serving-time placement on a ``(data=D, model=M)`` mesh (a ``pod``
    axis may lead).

    * **params** -- split by :class:`ShardingRules` (``train=False``):
      attention q/k/v and MLP columns, wo/w2 rows, MoE expert stacks over
      the experts, embedding and head over the vocabulary; the rest
      replicated. :meth:`shard_params` gives one tree per model shard, each
      split leaf a contiguous tensor of its own. Where the rule also splits
      a weight over ``data`` (FSDP at serve: ``needs_serve_fsdp`` of the
      config at M), that leaf is a :class:`DataSlices` of its D slices,
      slice d on device (d, m), and :meth:`gather` joins them on the model
      shard's compute device (0, m) before use. A ``pod`` axis, and a
      ``data`` axis the rule splits nothing over, only replicate in the
      reference: one controller holds such replicas once, on replica 0.
    * **KV** -- paged pools ``(L, NP, page, KH, hd)`` and slot caches
      ``(L, B, KH, S, hd)`` split the kv-head axis when M divides it
      (``kv_split == "heads"``), else head_dim (``"head_dim"``), else every
      shard holds the whole cache (``None``). Each shard's pool is a
      tensor of its own, never a view of a whole pool. Block tables,
      lengths and refcounts stay on the host, one copy for every shard.
      The ssm and conv states of the ssm and hybrid families are
      replicated, as in the reference: every shard holds a whole copy of
      its own and scans it itself. Caches and states live on replica 0's
      devices (0, m), whatever D is (the reference replicates them over
      ``data``).
    * **the sampler** -- decode state and uploads live on the lead device
      (0, 0), unsharded; it samples from the full logits, so only token
      ids reach the host.
    """

    def __init__(self, mesh, cfg: ModelConfig):
        if "model" not in mesh.axis_names:
            raise ValueError(
                f"serving mesh needs a 'model' axis, got {mesh.axis_names}; "
                f"build one with launch.mesh.make_local_mesh(data, model)")
        self.mesh = mesh
        self.cfg = cfg
        self.rules = ShardingRules(mesh, cfg, train=False)
        placed = mesh.placed_devices()
        # positions are row-major: (d, m) of pod 0 sits at the sum of each
        # coordinate times its axis's stride
        stride, n = {}, 1
        for a, size in reversed(list(zip(mesh.axis_names, mesh.axis_sizes))):
            stride[a], n = n, n * size
        self.data_shards = int(mesh.shape.get("data", 1))
        # replicas[d][m]: the device of position (d, m); row 0 computes
        self.replicas = [[placed[d * stride.get("data", 0)
                                 + m * stride["model"]]
                          for m in range(self.model_shards)]
                         for d in range(self.data_shards)]
        self.devices = self.replicas[0]
        self.lead = self.devices[0]
        self._param_shapes = None       # the last shard_params' leaf shapes

    @property
    def model_shards(self) -> int:
        return int(self.mesh.shape["model"])

    # -- splitting -------------------------------------------------------------
    def _split(self, x, spec, own: bool):
        """One tensor per shard: chunks along the spec's model dimension,
        or ``x`` on every shard's device (a copy of its own when
        ``own``)."""
        d = _model_dim(spec)
        if d is None:
            parts = [x] * self.model_shards
        else:
            parts = list(x.chunk(self.model_shards, dim=d))
            own = True
        if not own:
            return [x.to(dev) for dev in self.devices]
        return [torch.empty(p.shape, dtype=p.dtype, device=dev).copy_(p)
                for p, dev in zip(parts, self.devices)]

    def _join(self, parts, spec):
        """Inverse of :meth:`_split`, on the lead device."""
        parts = [_concat(p, self.lead) if isinstance(p, DataSlices) else p
                 for p in parts]
        d = _model_dim(spec)
        if d is None:
            return parts[0].to(self.lead)
        return torch.cat([p.to(self.lead) for p in parts], dim=d)

    def _data_dim(self, spec):
        """The dimension ``spec`` splits over a data axis above 1, or
        None."""
        return None if self.data_shards == 1 else _axis_dim(spec, "data")

    def _place(self, x, spec):
        """One leaf per model shard: :meth:`_split`'s, or where ``spec``
        splits over ``data`` too, the D slices of each model chunk, slice d
        copied onto device (d, m)."""
        dd = self._data_dim(spec)
        if dd is None:
            return self._split(x, spec, own=False)
        md = _model_dim(spec)
        chunks = [x] * self.model_shards if md is None \
            else x.chunk(self.model_shards, dim=md)
        return [DataSlices(
            [torch.empty(c.shape, dtype=c.dtype, device=dev).copy_(c)
             for c, dev in zip(chunk.chunk(self.data_shards, dim=dd),
                               (r[m] for r in self.replicas))], dd)
            for m, chunk in enumerate(chunks)]

    # -- params ----------------------------------------------------------------
    def shard_params(self, params):
        """The per-model-shard parameter trees (a list of M nested dicts),
        split by the ``train=False`` specs; a leaf the specs split over
        ``data`` as well is a :class:`DataSlices`. Replicated leaves are
        shared where a shard's device is the leaf's own."""
        self._param_shapes = _walk(params, lambda p, x: tuple(x.shape))
        trees = [dict() for _ in range(self.model_shards)]

        def place(path, x):
            parts = self._place(x, self.rules._param_spec(path, x.shape))
            for tree, part in zip(trees, parts):
                node = tree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = part

        _walk(params, place)
        return trees

    def gather_params(self, shards):
        """Inverse of the last :meth:`shard_params`: the whole tree on the
        lead device."""
        def join(path, shape):
            parts = list(shards)
            for k in path:
                parts = [part[k] for part in parts]
            return self._join(parts, self.rules._param_spec(path, shape))
        return _walk(self._param_shapes, join)

    def gather(self, leaf, s: int):
        """Model shard ``s``'s leaf whole on its compute device (0, s): a
        :class:`DataSlices` concatenated along its split dim (counted in
        ``GATHER_STATS``), any other leaf as it is."""
        if not isinstance(leaf, DataSlices):
            return leaf
        out = _concat(leaf, self.devices[s])
        GATHER_STATS["calls"] += 1
        GATHER_STATS["bytes"] += out.numel() * out.element_size()
        return out

    def gather_tree(self, tree, s: int):
        """:meth:`gather` of every leaf of a nested dict."""
        return _walk(tree, lambda p, x: self.gather(x, s))

    # -- KV policy -------------------------------------------------------------
    def _head_axes(self, kh: int, hd: int):
        """(kv-head axis, head_dim axis): kv heads over model when
        divisible, else head_dim over model, else replicate."""
        if self.rules._ax("model", kh) is not None:
            return "model", None
        if self.rules._ax("model", hd) is not None:
            return None, "model"
        return None, None

    @property
    def kv_split(self):
        """"heads", "head_dim" or None (every shard holds the whole
        cache), for this config's kv heads and head_dim."""
        kh, hd = self._head_axes(self.cfg.num_kv_heads, self.cfg.head_dim)
        return "heads" if kh else ("head_dim" if hd else None)

    def pool_spec(self, shape) -> tuple:
        """Paged KV pool (L, num_pages, page_size, KH, hd)."""
        kh, hd = self._head_axes(shape[3], shape[4])
        return (None, None, None, kh, hd)

    def slot_cache_spec(self, name: str, shape) -> tuple:
        """Slot cache leaf by name: k/v are (L, B, KH, S, hd); len and the
        SSM/conv states replicate."""
        if name in ("k", "v"):
            kh, hd = self._head_axes(shape[2], shape[4])
            return (None, None, kh, None, hd)
        return ()

    def shard_pools(self, pools):
        """Per-shard page pools: a list of N ``{name: tensor}`` dicts, each
        tensor a contiguous copy of its own."""
        parts = {n: self._split(a, self.pool_spec(a.shape), own=True)
                 for n, a in pools.items()}
        return [{n: p[s] for n, p in parts.items()}
                for s in range(self.model_shards)]

    def gather_pools(self, parts):
        """Inverse of :meth:`shard_pools`, for pool-shaped tensors of any
        page count: one ``{name: tensor}`` dict on the lead device."""
        d = {"heads": 3, "head_dim": 4}.get(self.kv_split)
        return {n: parts[0][n].to(self.lead) if d is None else
                torch.cat([p[n].to(self.lead) for p in parts], dim=d)
                for n in parts[0]}

    def zeros(self, shape, dtype, spec):
        """Zeroed per-shard tensors of a whole ``shape`` split by
        ``spec``, each on its shard's device."""
        shape = list(shape)
        d = _model_dim(spec)
        if d is not None:
            shape[d] //= self.model_shards
        return [torch.zeros(shape, dtype=dtype, device=dev)
                for dev in self.devices]

    def shard_slot_cache(self, cache):
        """Per-shard slot caches (a list of N dicts), split like the pools;
        every shard gets a copy of its own of a replicated leaf."""
        parts = {n: self._split(a, self.slot_cache_spec(n, a.shape), own=True)
                 for n, a in cache.items()}
        return [{n: p[s] for n, p in parts.items()}
                for s in range(self.model_shards)]

    # -- collectives -----------------------------------------------------------
    def replicate(self, x):
        """``x`` on every shard's device (no copy where it already is)."""
        return [x.to(dev) for dev in self.devices]

    def all_reduce(self, partials):
        """Sum of the shards' partials in shard order, in float32 on the
        lead device, cast to their dtype; the sum on every shard's
        device."""
        if len(partials) == 1:
            return [partials[0]]
        acc = partials[0].to(self.lead, torch.float32)
        for p in partials[1:]:
            acc = acc + p.to(self.lead, torch.float32)
        acc = acc.to(partials[0].dtype)
        return self.replicate(acc)

    def all_gather(self, parts, dim: int = -1):
        """The shards' parts concatenated along ``dim`` on the lead
        device."""
        if len(parts) == 1:
            return parts[0]
        return torch.cat([p.to(self.lead) for p in parts], dim=dim)
