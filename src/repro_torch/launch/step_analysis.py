"""Per-shard analysis of one step, for the dry run (the counterpart of
``repro/launch/hlo_analysis.py``).

The reference parses the compiled, partitioned HLO of a step, multiplying
while-loop bodies by their trip counts because XLA's ``cost_analysis``
visits a scan body once. The port has no HLO: it runs eagerly, so there
is no loop body to multiply, and the Python loops over layers, attention
chunks and microbatches are counted as they run. :func:`analyze_step`
runs the step once on the ``meta`` device (shapes and dtypes; no data, no
allocation) under a ``TorchDispatchMode`` that sees every aten op of the
forward, the rematerialised forward and the backward, and counts:

* ``dot_flops`` -- matmul FLOPs by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``: mm, addmm, bmm, baddbmm);
* ``traffic_bytes`` -- an HBM traffic model: each op reads its tensor
  inputs and writes its outputs once; views are free; a gather
  (``index``, ``index_select``, ``gather``, ``embedding``) moves twice its
  result and a scatter (``index_put_``, ``scatter``, ``index_add_``,
  ``copy_``) twice its update, at slice size, as ``parse_traffic`` counts
  dynamic-slice, gather and scatter;
* ``temp_size_in_bytes`` -- the peak of the bytes that the step's own ops
  hold live (each new storage is released through ``weakref.finalize``),
  the counterpart of XLA's ``temp_size_in_bytes``;
* the collectives of the port's explicit program, by kind (the bytes of
  each collective's result, as ``parse_collectives`` counts them).

The hand-written kernels are bound through ``ctypes`` and no dispatch mode
sees them, so a step is analysed on its plain path (``use_kernel=False``),
as the reference counts its Pallas custom calls as free.

**One shard.** Given a mesh and :class:`ShardingRules`, the step runs at
one shard's *local batch* (each batch and cache leaf's batch dimension
over the data axes its spec names) and the model's full widths; each
product is then divided by the model-axis split that applies to it, as
GSPMD partitions the reference's step (checked against its compiled
steps on small meshes and on the production mesh):

* a product with a weight operand (found by storage: a stacked layer
  weight's per-layer view shares it) by the weight's model split; a
  weight's gradient product (in the backward, its result shaped as a
  weight) likewise;
* in a step over sequences (train, prefill) every other product by the
  model axis too: where a layer's weight does not divide it, the tokens
  split over it instead (a head whose vocabulary does not divide it stays
  whole); attention splits over the kv heads, then the query groups, as
  far as they divide the axis (``_head_split``), or over the batch under
  ``--opt attn_dp``;
* in a decode step (one token a sequence) a product of a replicated
  weight or of activations alone by the split of its layer, the layer of
  the last weight product: attention where the cache's sequence is split,
  the Mamba2 mixer (and its ``conv_w``) where ``in_proj`` is, the MoE
  where the experts are (the new token's score against its own key splits
  over the heads, as in a sequence); the router and any other replicated
  weight stay whole on every shard;
* a product whose contraction is one long, on the device or after the
  split of the experts on a shard, is an elementwise product: XLA emits
  a multiply for it, and it counts no matmul FLOPs.

A split of a weight over a data axis (FSDP) divides no FLOPs: it adds an
all-gather of the weight at each use (forward, rematerialised forward,
backward) and, in a train step, a reduce-scatter of its gradient per
microbatch (an all-reduce over the data axes for a weight they do not
split). The model axis adds the explicit program's collectives
(``distributed/sharding.py``'s ``ServeSharding``): an all-reduce after each
row-parallel product and after the vocab-parallel embedding, an all-gather
after a column-parallel product whose consumer is not split (the logits,
the Mamba2 ``in_proj``, attention whose heads do not divide the axis).
Tensor sizes (traffic, live bytes) are taken on one shard: a weight at its
stored split, an activation at the split its producer gave it.

The keys of ``hlo_analysis.analyze`` that only an XLA module has
(``hlo_bytes``, ``fusions``, ``while_loops``, and ``convert_bytes``, a CPU
backend artifact) are left out.
"""
from __future__ import annotations

import math
import time
import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import hints as _hints
from repro_torch.serving.costmodel import HBM_BW, ICI_BW, PEAK_FLOPS

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

aten = torch.ops.aten

# product op -> (index of the left operand, of the right operand): the
# contraction is the left's last dimension and the right's one before last
_PRODUCTS = {aten.mm: (0, 1), aten.addmm: (1, 2), aten.bmm: (0, 1),
             aten.baddbmm: (1, 2)}
# ops that read and write their result's bytes (a gather at slice size)
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# ops that read and write their update's bytes, in place: the update is the
# argument at the index given
_SCATTERS = {aten.index_put_: 2, aten.index_put: 2, aten._index_put_impl_: 2,
             aten.scatter_: 3, aten.scatter: 3, aten.scatter_add_: 3,
             aten.scatter_add: 3, aten.index_add_: 3, aten.copy_: 1}
# data-free ops besides views: tensor metadata, no bytes moved
_FREE = {aten.detach, aten.alias, aten.lift_fresh}

_ROLES = {"wq": "attn", "wk": "attn", "wv": "attn", "wo": "attn",
          "bq": "attn", "bk": "attn", "bv": "attn", "in_proj": "ssm",
          "out_proj": "ssm", "conv_w": "ssm", "router": "moe",
          "embed": "head", "lm_head": "head"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def _walk(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _split(mesh, spec) -> int:
    """How many pieces ``spec`` cuts a leaf into over ``mesh``."""
    return math.prod(mesh.shape[a] for e in spec for a in _axes(e))


class _Weight:
    """A parameter leaf: its path, its spec's model dimension and split,
    the split of its data (FSDP) dimension, and its role."""

    def __init__(self, path, t, spec, mesh):
        self.path = "/".join(map(str, path))
        self.name = path[-1]
        self.shape = tuple(t.shape)
        self.strides = tuple(t.stride())
        self.model_dim = next((d for d, e in enumerate(spec)
                               if "model" in _axes(e)), None)
        self.model = mesh.shape["model"] if self.model_dim is not None else 1
        self.data = math.prod(mesh.shape[a] for e in spec
                              for a in _axes(e) if a != "model")
        parent = path[-2] if len(path) > 1 else None
        self.role = "moe" if parent == "moe" else \
            _ROLES.get(self.name, "mlp")

    def base_dim(self, view: torch.Tensor, d: int):
        """The leaf dimension that ``view``'s dimension ``d`` walks (by
        stride and size), or None."""
        if view.shape[d] == 1 or view.stride(d) == 0:
            return None
        for j, (n, s) in enumerate(zip(self.shape, self.strides)):
            if s == view.stride(d) and n == view.shape[d]:
                return j
        return None


class StepRecorder(TorchDispatchMode):
    """The dispatch mode of :func:`analyze_step` (see the module
    docstring); ``plan`` holds the mesh facts, None for one device."""

    def __init__(self, plan=None):
        super().__init__()
        self.plan = plan or _Plan()
        self.dot_flops = 0.0
        self.counter_flops = 0.0       # FlopCounterMode's count, undivided
        self.traffic = 0.0
        self.coll = {k: 0.0 for k in COLLECTIVE_OPS}
        self.coll_count = {k: 0 for k in COLLECTIVE_OPS}
        self.sites = defaultdict(float)
        self.dots = defaultdict(float)
        self.frac = {}                 # storage key -> fraction on a shard
        self.live = 0.0
        self.peak = 0.0
        self.region = None             # the last weight product's role
        self.read = set()              # storage keys some op read
        self._seen = set()

    # -- bookkeeping -----------------------------------------------------------
    def collective(self, kind, nbytes, site):
        self.coll[kind] += nbytes
        self.coll_count[kind] += 1
        self.sites[(kind, site)] += nbytes

    def _f(self, t):
        return self.frac.get(_key(t), 1.0)

    def _bytes(self, t):
        return _nbytes(t) * self._f(t)

    def _release(self, key, amount):
        self.live -= amount
        self.frac.pop(key, None)
        self._seen.discard(key)

    def _track(self, t, frac):
        """A new storage of an op's output: its fraction, and its live
        bytes until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        self._seen.add(key)
        self.frac[key] = frac
        amount = st.nbytes() * frac
        self.live += amount
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._release, key, amount)

    def reshard(self, x, spec_axes, kind):
        """A hint's reshard of ``x`` (``hints.constrain*``): an
        all-gather's result is ``x`` whole; an all-to-all's, the piece of
        ``x`` (at the local batch) that one of the named axes' shards
        keeps."""
        p = self.plan
        if p.mesh is None:
            return
        pieces = math.prod(p.mesh.shape[a] for e in spec_axes
                           for a in _axes(e) if a in p.mesh.shape)
        nbytes = _nbytes(x)
        if kind == "all-to-all":
            nbytes *= p.data_split / pieces
        self.collective(kind, nbytes, f"hint {kind} {tuple(x.shape)}")

    # -- the dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.is_view or packet in _FREE:
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        self.read.update(_key(a) for a in ins)
        outs = list(_tensors(out))
        if packet in _PRODUCTS:
            frac = self._product(func, packet, args, kwargs, out)
        elif packet in _GATHERS and _key(args[0]) in self.plan.weights:
            frac = self._lookup(args[0], out)
        else:
            fs = [self._f(a) for a in ins if a.numel() > 1]
            frac = min(fs) if fs else self._created(outs)
        for o in outs:
            self._track(o, frac)
        self.traffic += self._traffic(packet, args, ins, outs)
        return out

    def _lookup(self, table, out):
        """A row lookup in a weight (the embedding): vocab-parallel where
        the weight is split over the model axis, each shard's rows summed
        by an all-reduce. The result is whole on every shard."""
        w = self.plan.weights[_key(table)]
        if w.model_dim is not None:
            self.collective("all-reduce", _nbytes(out),
                            f"{w.path} (vocab-parallel)")
        return 1.0

    def _created(self, outs):
        """The fraction of a tensor no same-sized input gave one: a
        weight-shaped one (a gradient accumulator, the optimizer's) at
        that weight's stored split, else whole."""
        if len(outs) == 1:
            w = self.plan.by_shape.get(tuple(outs[0].shape))
            if w is not None:
                return 1.0 / (w.model * w.data)
        return 1.0

    def _traffic(self, packet, args, ins, outs):
        if packet in _GATHERS:
            return 2.0 * sum(self._bytes(o) for o in outs)
        i = _SCATTERS.get(packet)
        if i is not None and len(args) > i and \
                isinstance(args[i], torch.Tensor):
            return 2.0 * self._bytes(args[i])
        seen, total = set(), 0.0
        for a in ins:
            k = (_key(a), a.storage_offset(), tuple(a.shape))
            if k not in seen:
                seen.add(k)
                total += self._read_bytes(a)
        return total + sum(self._bytes(o) for o in outs)

    def _read_bytes(self, t):
        w = self.plan.weights.get(_key(t))
        if w is not None:
            # a weight is read as its shard holds it after any all-gather
            return _nbytes(t) / w.model
        return self._bytes(t)

    def _product(self, func, packet, args, kwargs, out):
        """Count one product; returns its result's fraction on a shard."""
        fl = float(flop_registry[packet](*args, **kwargs, out_val=out))
        self.counter_flops += fl
        p = self.plan
        li, ri = _PRODUCTS[packet]
        a, b = args[li], args[ri]
        w, op, cdim = None, None, None
        for t, c in ((b, b.dim() - 2), (a, a.dim() - 1)):
            w = p.weights.get(_key(t))
            if w is not None:
                op, cdim = t, c
                break
        site, factor, out_frac = "activations", 1, 1.0
        if w is not None:
            site = w.path
            self.region = w.role
            contracted = w.base_dim(op, cdim)
            if w.model_dim is None:
                factor = p.replicated_factor(w)
                out_frac = 1.0 / factor
            elif contracted == w.model_dim:
                factor = w.model      # row-parallel: partial sums
                self.collective("all-reduce", _nbytes(out),
                                f"{w.path} (row-parallel)")
            else:
                factor = w.model
                if p.gathered(w):
                    self.collective("all-gather", _nbytes(out),
                                    f"{w.path} (column-parallel)")
                else:
                    out_frac = 1.0 / factor
            if w.data > 1:
                self.collective("all-gather", _nbytes(op) / w.model,
                                f"{w.path} (FSDP)")
        else:
            g = p.grad_of(out) if torch._C._current_graph_task_id() != -1 \
                else None
            if g is not None:
                site = f"{g.path} (gradient)"
                factor = g.model if g.model_dim is not None \
                    else p.replicated_factor(g)
                out_frac = 1.0 / (g.model * g.data)
                p.note_grad(self, g, out)
            else:
                factor = p.region_factor(self.region)
                if p.decode and self.region == "attn" and out.shape[-1] == 1:
                    factor = p.heads   # the new token's score: no cache
                if p.one_long_contraction(self.region, a.shape[-1]):
                    factor = 0
                out_frac = 1.0 / max(factor, 1)
        if a.shape[-1] == 1:
            factor = 0        # an elementwise product, no matmul work
        mine = fl / factor if factor else 0.0
        self.dot_flops += mine
        self.dots[site] += mine
        return out_frac


class _Plan:
    """The mesh facts a :class:`StepRecorder` reads: weights by storage and
    by shape, and each layer's split. With no mesh, one device: nothing is
    divided and no collective is recorded."""

    def __init__(self, mesh=None, rules=None, params=None, decode=False,
                 cache_split=False, hints=None):
        self.mesh = mesh
        self.weights, self.by_shape = {}, {}
        self.model = 1
        self.data_split = 1
        self.decode = decode
        self.grad_shapes = {}
        if mesh is None:
            return
        cfg = rules.cfg
        self.model = mesh.shape.get("model", 1)
        self.data_split = math.prod(n for a, n in mesh.shape.items()
                                    if a != "model")

        def add(path, t):
            w = _Weight(path, t, rules._param_spec(path, t.shape), mesh)
            self.weights[_key(t)] = w
            self.by_shape.setdefault(tuple(t.shape), w)
            # a stacked layer weight's gradient products are per layer
            grads.append((tuple(t.shape[1:] if path[0] == "layers"
                                else t.shape), w))
        grads = []
        _walk(params, add)
        for shape, w in grads:
            self.grad_shapes.setdefault(shape, w)
        for shape, w in grads:      # a transposed product (a tied head)
            if len(shape) == 2:
                self.grad_shapes.setdefault(shape[::-1], w)
        m = self.model
        attn_dp = bool(hints is not None and hints.attn_dp
                       and "model" in hints.attn_dp)
        if decode:
            # one token a sequence: attention splits where the cache's
            # sequence does, the mixer where in_proj does, the MoE where
            # the experts do; the rest is whole on every shard
            attn = m if cache_split or attn_dp else 1
            self.heads = _head_split(cfg.num_kv_heads, cfg.num_heads, m)
            ssm = m if any(w.name == "in_proj" and w.model_dim is not None
                           for w in self.weights.values()) else 1
            moe = m if cfg.moe and cfg.moe.num_experts % m == 0 else 1
            rest = 1
        else:
            # a sequence: a product whose weight does not divide the model
            # axis splits its tokens over it instead; attention splits
            # over the kv heads, then the query groups, as far as they
            # divide the axis (GSPMD's split of the reference's einsums),
            # or over the batch under attn_dp
            attn = m if attn_dp else _head_split(cfg.num_kv_heads,
                                                 cfg.num_heads, m)
            ssm = moe = rest = m
        # an embedding or head the vocabulary cannot split stays whole
        self._factor = {"attn": attn, "ssm": ssm, "moe": moe, "mlp": rest,
                        "head": 1}
        self._experts = cfg.moe.num_experts if cfg.moe else 0

    def region_factor(self, region) -> int:
        if self.mesh is None:
            return 1
        return self._factor.get(region, 1)

    def replicated_factor(self, w) -> int:
        """A replicated weight's product takes its layer's split, except
        the router of a decode step's dense-mode MoE."""
        if self.mesh is None or (w.name == "router" and self.decode):
            return 1
        return self._factor.get(w.role, 1)

    def gathered(self, w) -> bool:
        """Is a column-parallel product's result all-gathered (its
        consumer is whole on a shard)?"""
        return w.role == "head" or w.name == "in_proj" or \
            (w.role == "attn" and self._factor["attn"] < self.model)

    def one_long_contraction(self, region, k) -> bool:
        return (self.mesh is not None and region == "moe"
                and self._factor["moe"] > 1 and k == self._experts
                and self._experts // self.model == 1)

    def grad_of(self, out):
        if self.mesh is None or not isinstance(out, torch.Tensor):
            return None
        return self.grad_shapes.get(tuple(out.shape))

    def note_grad(self, rec, w, grad):
        """A train step's gradient leaves the shard once a microbatch:
        reduce-scattered over the data axes that split the weight, else
        all-reduced over them."""
        if self.data_split == 1:
            return
        nbytes = _nbytes(grad) / (w.model * w.data)
        kind = "reduce-scatter" if w.data > 1 else "all-reduce"
        rec.collective(kind, nbytes, f"{w.path} (gradient)")


def _head_split(kv_heads: int, heads: int, m: int) -> int:
    """How many ways full-sequence attention splits over an ``m``-way
    model axis: the kv heads as far as they divide it, then the query
    groups a kv head serves as far as they divide the rest."""
    if not heads:
        return 1
    kv = math.gcd(kv_heads, m)
    return kv * math.gcd(heads // kv_heads, m // kv)


def _local(t, spec, mesh):
    """A meta tensor of ``t``'s shape with each dimension divided by the
    data axes (not the model axis) of its spec entry."""
    shape = list(t.shape)
    for d, e in enumerate(spec):
        n = math.prod(mesh.shape[a] for a in _axes(e) if a != "model")
        if n > 1:
            shape[d] //= n
    return torch.empty(shape, dtype=t.dtype, device="meta")


def arg_specs(rules, args):
    """The spec tree of each argument of a dry-run step: the first is the
    parameters, a {m, v, step} dict the optimizer state, a dict with a
    ``len`` a decode cache, anything else a batch (a dict, or one tensor
    of token ids)."""
    out = []
    for i, a in enumerate(args):
        if i == 0:
            out.append(rules.param_specs(a))
        elif isinstance(a, dict) and {"m", "v", "step"} <= set(a):
            out.append(rules.opt_specs(a, args[0]))
        elif isinstance(a, dict) and "len" in a:
            out.append(rules.cache_specs(a))
        elif isinstance(a, dict):
            out.append(rules.batch_specs(a))
        else:
            out.append(rules._batched(a.shape))
    return out


def _leaves(tree, path=()):
    """(path, tensor) of every tensor leaf of nested dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def argument_bytes(args, mesh=None, rules=None, unused=()) -> int:
    """One shard's bytes of the step's arguments: each leaf's bytes over
    the pieces its spec cuts it into, a storage counted once, the leaves
    in ``unused`` ((argument index, path) pairs) left out, as XLA leaves
    out an argument the step never reads."""
    specs = arg_specs(rules, args) if mesh is not None else [None] * len(args)
    seen, total = set(), 0
    for i, (a, spec) in enumerate(zip(args, specs)):
        for path, t in _leaves(a):
            if (i, path) in unused or _key(t) in seen:
                continue
            seen.add(_key(t))
            total += _nbytes(t) // (_split(mesh, _spec_at(spec, path))
                                    if mesh is not None else 1)
    return total


def analyze_step(fn, *args, mesh=None, rules=None, hints=None) -> dict:
    """Analyse one call ``fn(*args)`` on the ``meta`` device (see the
    module docstring). ``args`` are meta tensors (nested dicts of them) at
    the step's global shapes, the parameters first. With ``mesh`` and
    ``rules`` (a ``ShardingRules``) the counts are one shard's; ``hints``
    (a ``ShardingHints``) is in force during the call. Returns the
    reference's keys where they have a meaning: ``dot_flops``,
    ``top_dots``, ``traffic_bytes``, each collective kind's bytes and
    ``<kind>_count``, ``collective_bytes``, ``top_collectives``; and
    ``argument_size_in_bytes``, ``output_size_in_bytes``,
    ``temp_size_in_bytes``, the roofline's ``compute_s``, ``memory_s`` and
    ``collective_s`` (H100 SXM5 datasheet rates from
    ``serving/costmodel.py``), ``flop_counter_flops`` (``FlopCounterMode``'s
    count of the same run: every product, undivided) and ``analyze_s``
    (wall time)."""
    from contextlib import nullcontext
    t0 = time.time()
    local, fracs = list(args), {}
    plan = _Plan()
    if mesh is not None:
        specs = arg_specs(rules, args)
        local = []
        for i, (a, spec) in enumerate(zip(args, specs)):
            # parameters and optimizer state keep their full shapes
            whole = i == 0 or (isinstance(a, dict) and "step" in a)

            def place(path, t, spec=spec, whole=whole):
                sp = _spec_at(spec, path)
                u = t if whole else _local(t, sp, mesh)
                model = sp and math.prod(mesh.shape["model"] for e in sp
                                         if "model" in _axes(e))
                fracs[_key(u)] = 1.0 / (_split(mesh, sp) if whole
                                        else model or 1)
                return u
            local.append(_walk(a, place))
        caches = [s for a, s in zip(args, specs)
                  if isinstance(a, dict) and "len" in a]
        cache_split = any("model" in _axes(e) for s in caches
                          for k in ("k", "v") if k in s for e in s[k])
        plan = _Plan(mesh, rules, args[0], decode=bool(caches),
                     cache_split=cache_split, hints=hints)
    rec = StepRecorder(plan)
    # before the call: a step may replace a leaf of a dict it was given
    # (the decode cache's ``len``)
    arg_keys = [((i, path), _key(t)) for i, a in enumerate(local)
                for path, t in _leaves(a)]
    rec._seen.update(k for _, k in arg_keys)
    rec.frac.update(fracs)
    hctx = _hints.use_hints(hints) if hints is not None else nullcontext()
    with hctx, _hints.recording(rec), rec:
        out = fn(*local)
    unused = {leaf for leaf, k in arg_keys if k not in rec.read}
    arg_bytes = argument_bytes(args, mesh, rules, unused)
    out_bytes = 0.0
    for t in _unique(_tensors(out)):
        out_bytes += _nbytes(t) * rec.frac.get(_key(t), 1.0)
    res = {"dot_flops": rec.dot_flops,
           "flop_counter_flops": rec.counter_flops,
           "top_dots": [{"site": k, "flops": v} for k, v in sorted(
               rec.dots.items(), key=lambda kv: -kv[1])[:8]],
           "traffic_bytes": rec.traffic}
    res.update(rec.coll)
    res.update({f"{k}_count": v for k, v in rec.coll_count.items()})
    res["collective_bytes"] = float(sum(rec.coll.values()))
    res["top_collectives"] = [
        {"kind": k[0], "site": k[1], "bytes": v} for k, v in sorted(
            rec.sites.items(), key=lambda kv: -kv[1])[:10]]
    res["argument_size_in_bytes"] = int(arg_bytes)
    res["unused_arguments"] = sorted(
        f"{i}/{'/'.join(map(str, path))}" for i, path in unused)
    res["output_size_in_bytes"] = int(out_bytes)
    res["temp_size_in_bytes"] = int(rec.peak)
    res["analyze_s"] = time.time() - t0
    return roofline(res)


def roofline(res: dict) -> dict:
    """``res`` with the roofline's terms of its counts, in seconds on one
    H100 SXM5 at its datasheet rates."""
    res["compute_s"] = res["dot_flops"] / PEAK_FLOPS
    res["memory_s"] = res["traffic_bytes"] / HBM_BW
    res["collective_s"] = res["collective_bytes"] / ICI_BW
    return res


def _spec_at(spec_tree, path):
    for k in path:
        spec_tree = spec_tree[k]
    return spec_tree


def _unique(ts):
    seen = set()
    for t in ts:
        k = (_key(t), t.storage_offset(), tuple(t.shape))
        if k not in seen:
            seen.add(k)
            yield t
