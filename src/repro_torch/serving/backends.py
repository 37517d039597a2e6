"""Engine cache backends (the port of the JAX package's
``repro/serving/backends.py``).

SlotBackend  -- contiguous per-slot cache for every decoder family
                (attention -- dense, moe, vlm -- SSM, hybrid): the cache
                has a batch axis of ``max_slots``; a prefill fills one
                slot's rows in place, decode steps every slot.
PagedBackend -- vLLM-style paged KV pool with block tables, for the
                attention families.

An MoE model's feed-forward runs ``moe_ffn`` in "dense" mode on every
path (prefill, chunks, decode, verify), as in the reference: every expert
computes every token, so no routing drop makes a stream depend on what
else is in the batch.

The paged pools are two tensors (L, num_pages, page_size, KH, hd) on the
backend's device, updated IN PLACE (``index_put_``) where the reference
rebuilt immutable arrays; the host-side allocator is
:class:`~repro_torch.serving.kv_cache.PagedKVCache`.

Three decode calls, as in the reference:

* ``decode_batch(tokens)`` -- legacy host-driven step: one forward, the full
  ``(max_slots, V)`` logits come back to the host and the engine samples
  there (counted in ``TRANSFER_STATS``).
* ``fused_decode(K, host_state)`` -- K decode steps on the device, each
  fusing forward + seeded top-p sampling + stop/length checks; only
  ``(K, max_slots)`` token ids and the ``produced`` / ``done`` vectors
  cross to the host, once per call. Logits never leave the device. One
  loop, :class:`_StepGraph`, runs the K steps of every backend and tier
  over static buffers; each backend gives only its step
  (``SlotBackend._iteration``, ``PagedBackend._kernel_step`` or
  ``_reference_step``). Where :func:`_captures_decode` holds, the loop
  captures the step once as a CUDA graph and replays it; elsewhere it
  issues the step op by op.
* ``spec_verify(draft_tokens, host_state)`` -- speculative decoding's
  verify round (attention families): ONE forward feeds each slot its last
  token and the k draft tokens, writes their KV at ``len..len+k``, attends
  causally (plain PyTorch in float32, as the reference: no Pallas kernel
  there), then samples all k+1 seeded targets, accepts the matching draft
  prefix and latches stops/limits on the device. ``spec_headroom``,
  ``reset_lens`` and ``spec_catch_up`` are its host-side companions (page
  reservation, the draft cache's truncate-on-reject, the draft's resync).

``use_kernel`` picks the attention tier:

* True: the hand-written kernels -- ``paged_flash_prefill`` for prefill
  chunks, ``paged_attention`` for the legacy step, and in the fused loop
  ``fused_decode_attention`` over committed pages plus (L, B, K, KH, hd)
  tail buffers: nothing is written to the pool inside the K-loop and the
  tails are committed with one scatter per call. On one CUDA device the
  step is replayed as a CUDA graph; under a mesh it is issued op by op. On
  CPU tensors each wrapper runs its kernel's plain version; on CUDA
  tensors it launches the kernel or raises.
* False: the plain versions directly (the reference tier), with the
  per-step pool write of the reference's ``_fused_impl``.

On the slot backend ``use_kernel`` picks the tier of prefill and decode
attention: True runs a one-shot prompt's SSD scans (``ssd``) and its
attention without a cache (``flash_attention``), and each decode step's
attention over the slot caches plus the new token
(``slot_decode_attention``, where each shard holds whole heads), through
the hand-written kernels; False runs the plain versions. Its chunked
prefill (attention families), the decode step's mixers and its head_dim
split attention run plain PyTorch in both tiers, as the reference's do;
for the published hybrid layout on one CUDA device the kernel tier
replays its decode iteration as a CUDA graph.

The paged backend also swaps a preempted sequence's KV to host memory and
back (``swap_out`` / ``swap_in``).

Mesh serving (``mesh=``, a ``(data=D, model=N)`` mesh from
``launch/mesh.py``): :class:`~repro_torch.distributed.sharding.ServeSharding`
splits the parameters and the KV cache over the N model shards and
:class:`~repro_torch.models.transformer.ServeStack` runs every layer loop
over them, one shard after another; the residual stream, the sampler and
its state stay on the lead device (0, 0), and only token ids reach the
host. With D > 1 the pools, slot caches and states stay on replica 0's
devices (0, m), as at D = 1; where the serving rule splits weights over
``data`` too (FSDP at serve, ``needs_serve_fsdp``), each layer's slices are
gathered onto (0, m) just before the layer runs, so every op, kernel
dispatch included, is the ``(1, N)`` one on the same tensors.
Kernel dispatch is the reference's: the two paged decode kernels run once
per shard when N divides the kv heads (``_kernel_sharded``); otherwise the
cache splits over head_dim and the plain path serves, summing the shards'
partial scores. Prefill of the attention families under a mesh runs the
plain gather path, and a whole prompt goes through the chunked path in one
chunk. The ssm and hybrid families serve on the slot backend, on one
device or a mesh, through ``hybrid.serve_prefill`` / ``serve_decode_step``
over the stack; under a mesh the mixers' in_proj
column-split and gathered, every shard scanning its own copy of the
replicated ssm/conv state (``ssd`` once per shard and layer under
``use_kernel``), out_proj row-split; the hybrid's shared attention at each
shard's kv heads (``flash_attention`` per shard under ``use_kernel``).

Prefill protocol, shared with the engine::

  task = backend.start_prefill(seq_id, prompt)    # reserve slot/pages
  logits, n = backend.prefill_chunk(task, budget) # compute <= budget tokens
  ... repeat until logits is not None (prompt fully ingested) ...
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import ServeSharding
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import paged_flash_prefill
from repro_torch.kernels.flash_attention.ref import paged_prefill_attention_ref
from repro_torch.kernels.mixer_decode.ops import takes as mixer_kernel_takes
from repro_torch.kernels.paged_attention.ops import (
    cached_workspace, fused_decode_attention_sharded, paged_attention_sharded,
    shardable_kv_heads)
from repro_torch.kernels.paged_attention.ref import (
    fused_decode_attention_sharded_ref, gather_kv,
    paged_attention_sharded_ref)
from repro_torch.models import LM
from repro_torch.models.hybrid import serve_decode_step, serve_prefill
from repro_torch.models.layers import NEG_INF, chunked_attention
from repro_torch.models.model import _window_for
from repro_torch.models.transformer import (ServeStack, _block,
                                            _scatter_new_kv)
from repro_torch.serving.kv_cache import OutOfPages, PagedKVCache
from repro_torch.serving.sampler import (fold_seeds, sample_from_logits,
                                         spec_accept, spec_targets)
from repro_torch.serving.tracing import RECORDER

ATTENTION_FAMILIES = ("dense", "moe", "vlm")

# -- host-transfer accounting -------------------------------------------------
# The fused decode path's contract is that logits never cross to the host;
# every logits device->host conversion in this module goes through
# ``_logits_to_host`` so tests can assert the fused path performs none.
# Every host<->device copy here is from or to pageable memory and blocks
# until the stream drains: each is a ``sync`` span (``serving/tracing.py``).
TRANSFER_STATS = {"decode_logits_transfers": 0, "decode_logits_bytes": 0}


def reset_transfer_stats() -> None:
    TRANSFER_STATS["decode_logits_transfers"] = 0
    TRANSFER_STATS["decode_logits_bytes"] = 0


def _logits_to_host(x) -> np.ndarray:
    x = x.detach().float()
    with RECORDER.sync("logits_to_host", h2d=False):
        out = x.cpu().numpy()
    TRANSFER_STATS["decode_logits_transfers"] += 1
    TRANSFER_STATS["decode_logits_bytes"] += out.nbytes
    return out


def _upload_state(host_state: dict, device, into: dict | None = None) -> dict:
    """Per-slot decode state to the device (a copy). uint32 seed bases
    travel as int64: torch has no complete uint32 op set. ``into``: device
    tensors of the same keys and shapes (a decode graph's static state) to
    copy into, each cast to its dtype, in place of new ones."""
    out = {}
    with RECORDER.sync("upload_state", n=len(host_state)):
        for k, v in host_state.items():
            arr = np.array(v)
            if arr.dtype == np.uint32:
                arr = arr.astype(np.int64)
            out[k] = torch.from_numpy(arr).to(device) if into is None \
                else into[k].copy_(torch.from_numpy(arr))
    return out


def _upload(site: str, x, dtype, device):
    """Host array -> tensor on ``device``: a ``sync`` span at ``put.<site>``
    (the backend step that asked)."""
    with RECORDER.sync("put." + site):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _upload_into(site: str, dst, x):
    """Host array -> into the device tensor ``dst`` (cast to its dtype):
    a ``sync`` span at ``put.<site>``, as :func:`_upload`."""
    with RECORDER.sync("put." + site):
        return dst.copy_(torch.from_numpy(np.asarray(x)))


def _to_host(out, produced, done):
    """A decode call's (n, B) token ids and (B,) produced / done flags to
    the host in ONE device->host copy. Returns numpy (out, produced,
    done)."""
    n = out.shape[0]
    host = torch.cat([out, produced[None], done[None].to(torch.int32)])
    with RECORDER.sync("to_host", h2d=False):
        host = host.cpu().numpy()
    return host[:n], host[n], host[n + 1].astype(bool)


def _sample_and_latch(st, logits, tokens, n_gen, done, produced, live):
    """Device-side sample + stop/limit latch for one fused decode step.
    ``live`` slots take the sampled token and advance; a live slot hitting
    its stop token or generation limit latches ``done`` and freezes from
    the next step on."""
    seeds = fold_seeds(st["seed_base"], n_gen)
    sampled = sample_from_logits(logits, st["temps"], st["top_ps"], seeds)
    tokens = torch.where(live, sampled, tokens)
    step = live.to(torch.int32)
    n_gen = n_gen + step
    hit_stop = (st["stop_tok"] >= 0) & (sampled == st["stop_tok"])
    done = done | (live & (hit_stop | (n_gen >= st["gen_limit"])))
    produced = produced + step
    return tokens, n_gen, done, produced


def _spec_block_attention(q, k, v, lens, *, kv_major):
    """Attention for a speculative verify block of T tokens per slot.

    q: (B, T, H, D). k/v hold history PLUS the block's own KV (already
    written): kv-heads-major (B, KH, S, D) for the slot cache, or
    seq-major (B, S, KH, D) for a gathered page view. ``lens``: (B,) valid
    history length BEFORE the block; query j attends [0, lens + j + 1),
    the positions the sequential decode path sees there. float32 scores,
    probabilities and values, as the reference. Returns (B, T, H, D) in
    q's dtype."""
    B, T, H, D = q.shape
    KH = k.shape[1] if kv_major else k.shape[2]
    qr = q.reshape(B, T, KH, H // KH, D).float()
    sub = "btkgd,bksd->bkgts" if kv_major else "btkgd,bskd->bkgts"
    s = torch.einsum(sub, qr, k.float()) * (1.0 / math.sqrt(D))
    S = s.shape[-1]
    visible = lens.long()[:, None] + 1 + torch.arange(T, device=q.device)
    ok = torch.arange(S, device=q.device) < visible[:, :, None]  # (B, T, S)
    p = torch.softmax(torch.where(ok[:, None, None], s, NEG_INF), dim=-1)
    sub = "bkgts,bksd->btkgd" if kv_major else "bkgts,bskd->btkgd"
    out = torch.einsum(sub, p, v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _spec_accept_and_latch(st, logits, draft):
    """Device-side acceptance + stop/limit latch for one speculative round
    (the verify analogue of :func:`_sample_and_latch`). logits: (B, T, V)
    with T = k + 1; draft: (B, k). Emits the accepted draft prefix and the
    residual resample at the first mismatch (the bonus token when all
    matched), truncated at the first stop-token / generation-limit hit;
    inactive slots produce nothing. Returns (targets (B, T), produced (B,),
    done (B,), st) with st's tokens / n_gen advanced by ``produced``."""
    T = logits.shape[1]
    targets = spec_targets(logits, st["temps"], st["top_ps"],
                           st["seed_base"], st["n_gen"])
    emit, n_emit = spec_accept(targets, draft)
    n2 = st["n_gen"][:, None] + 1 + torch.arange(T, device=logits.device)
    stop = st["stop_tok"][:, None]
    hit = emit & (((stop >= 0) & (targets == stop))
                  | (n2 >= st["gen_limit"][:, None]))
    any_hit = hit.any(dim=1)
    first_hit = torch.argmax(hit.to(torch.int32), dim=1).to(torch.int32)
    produced = torch.where(any_hit, first_hit + 1, n_emit)
    produced = torch.where(st["active"], produced, 0).to(torch.int32)
    done = st["active"] & any_hit
    last = targets.gather(1, torch.clamp(produced - 1, min=0).long()[:, None])
    tokens = torch.where(produced > 0, last[:, 0], st["tokens"])
    st = dict(st, tokens=tokens, n_gen=st["n_gen"] + produced)
    return targets, produced, done, st


def _captures_decode(cfg, use_kernel: bool, shard, device, *,
                     paged: bool) -> bool:
    """Whether a backend's fused decode iteration is captured as a CUDA
    graph and replayed (``_StepGraph.capture``): on the kernel tier, on one
    device, a CUDA one; on the slot backend only at the published hybrid
    layout (``hybrid_layer_ids``), whose replay the card tests hold to
    op-by-op issue (the ssm family, the ``attn_every`` hybrid and the
    attention families issue it op by op there)."""
    return (use_kernel and shard is None and device.type == "cuda"
            and (paged or bool(cfg.hybrid_layer_ids)))


def _lead_device(device, shard) -> torch.device:
    """A backend's device: ``device`` (default: the CUDA card), or under a
    mesh its lead shard's, which ``device`` must name if given."""
    if shard is None:
        return resolve_device(device)
    if device is not None:
        want = torch.device(device)
        if want.type != shard.lead.type or want.index not in (
                None, shard.lead.index):
            raise ValueError(f"device {want} is not the mesh's lead device "
                             f"{shard.lead}")
    return shard.lead


def _causal(q0, n_q: int, n_k: int, device):
    """(1, n_q, n_k) mask of queries at positions q0.. over keys 0..n_k-1:
    key j visible to query t iff j <= q0 + t."""
    qpos = q0 + torch.arange(n_q, device=device)
    return (torch.arange(n_k, device=device)[None, :] <= qpos[:, None])[None]


def _block_visible(lens, T: int, n_k: int):
    """(B, T, n_k) mask of a verify block: query j of slot b sees keys
    [0, lens[b] + j + 1)."""
    dev = lens.device
    limit = lens.long()[:, None] + 1 + torch.arange(T, device=dev)
    return torch.arange(n_k, device=dev)[None, None, :] < limit[:, :, None]


@dataclass
class PrefillTask:
    """In-flight prompt ingestion state (one per admitted sequence)."""
    seq_id: str
    prompt: list
    pos: int = 0                    # next prompt position to compute
    cached_tokens: int = 0          # prefix tokens served from the page cache
    chunks: int = 0                 # chunks computed so far

    @property
    def remaining(self) -> int:
        return len(self.prompt) - self.pos

    @property
    def done(self) -> bool:
        return self.pos >= len(self.prompt)


class SlotBackend:
    """Contiguous cache with ``max_slots`` sequences of up to ``max_len``
    tokens, for every decoder family."""

    def __init__(self, model: LM, params, *, max_slots: int, max_len: int,
                 use_kernel: bool = False, mesh=None, device=None):
        cfg = model.cfg
        self.shard = ServeSharding(mesh, cfg) if mesh is not None else None
        self.device = _lead_device(device, self.shard)
        if self.shard is None and params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"backend on {self.device}")
        self.model = model
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.use_kernel = use_kernel
        self.dtype = getattr(torch, cfg.param_dtype)
        self.stack = ServeStack(params, cfg, self.shard)
        # the model's window for a cache of max_len (the hybrid's long
        # context), as LM.prefill / decode_step derive it
        self.window = _window_for(cfg, max_len)
        if self.shard is None:
            self.cache = model.init_cache(max_slots, max_len,
                                          device=self.device)
            self.cache_shards = [self.cache]
        else:
            # per shard: k/v (L|G, B, KH, S, hd) split by slot_cache_spec,
            # the ssm/conv states whole; len once, on the lead device
            like = model.init_cache(max_slots, max_len, device="meta")
            self.cache = {"len": torch.zeros(like.pop("len").shape,
                                             dtype=torch.int32,
                                             device=self.device)}
            parts = {n: self.shard.zeros(t.shape, t.dtype,
                                         self.shard.slot_cache_spec(
                                             n, t.shape))
                     for n, t in like.items()}
            self.cache_shards = [{n: p[s] for n, p in parts.items()}
                                 for s in range(self.shard.model_shards)]
        self.free_slots = list(range(max_slots - 1, -1, -1))
        self.slot_of: dict[str, int] = {}
        self._dec_st = None         # device-resident per-slot decode state
        self._live = 0              # its active slots (the decode.issue attr)
        # the fused decode loop; a replay counts what the recorded
        # iteration counted, for each application of a tied block and
        # each mixer
        apps = len(cfg.hybrid_layer_ids)
        tier = "kernel" if use_kernel else "plain"
        counts = {"shared_block.apps": apps,
                  f"slot_decode_attn.{tier}": apps} if apps else {}
        if cfg.family not in ATTENTION_FAMILIES:
            mixer = use_kernel and mixer_kernel_takes(cfg, self.dtype,
                                                      self.device)
            counts[f"mixer_decode.{'kernel' if mixer else 'plain'}"] = \
                cfg.num_layers
        self._graph = _StepGraph(
            self.device, max_slots, self._iteration,
            capture=_captures_decode(cfg, use_kernel, self.shard,
                                     self.device, paged=False),
            counts=counts)

    def _put(self, site: str, x, dtype=None):
        """Host array -> tensor on the backend's device; ``site`` names
        the ``sync`` span (``put.<site>``)."""
        return _upload(site, x, dtype, self.device)

    # -- capacity -------------------------------------------------------------
    def can_admit(self, n_prompt: int) -> bool:
        return bool(self.free_slots) and n_prompt < self.max_len

    @property
    def supports_chunked_prefill(self) -> bool:
        # SSM/hybrid state cannot be rebuilt from a cache slice, so those
        # families ingest prompts in one shot whatever the budget
        return self.cfg.family in ATTENTION_FAMILIES

    # -- prefill protocol --------------------------------------------------------
    def start_prefill(self, seq_id: str, prompt: list) -> PrefillTask:
        slot = self.free_slots.pop()
        self.slot_of[seq_id] = slot
        return PrefillTask(seq_id=seq_id, prompt=list(prompt))

    def prefill_chunk(self, task: PrefillTask, budget: int | None = None):
        """Compute up to ``budget`` prompt tokens (all remaining if None, or
        for the SSM/hybrid families). Returns (last_token_logits (V,) on
        the device | None, tokens_computed)."""
        S = len(task.prompt)
        if budget is None or not self.supports_chunked_prefill:
            chunk = task.remaining
        else:
            chunk = min(max(budget, 1), task.remaining)
        if task.pos == 0 and chunk == S and (
                self.shard is None or not self.supports_chunked_prefill):
            logits = self._one_shot(task.seq_id, task.prompt)
            task.pos = S
            task.chunks += 1
            return logits, S
        logits = self._compute_chunk(task, chunk)
        task.pos += chunk
        task.chunks += 1
        if task.done:
            return logits, chunk
        return None, chunk

    def prefill(self, seq_id: str, prompt: list):
        """One-shot convenience: returns last-token logits (V,)."""
        task = self.start_prefill(seq_id, prompt)
        logits, _ = self.prefill_chunk(task, None)
        return logits

    def _one_shot(self, seq_id: str, prompt: list):
        """Whole prompt in one forward at its exact length (the reference
        pads attention prompts to power-of-two buckets for jit, which eager
        torch does not need; SSM/hybrid state would be polluted by padding
        anyway). The result overwrites the slot's rows of every cache
        tensor in place, where the reference inserts a new slot cache.
        The ssm and hybrid families run through ``hybrid.serve_prefill``
        on the stack's shards (one on a single device), each writing its
        own cache; the attention families come here on one device alone
        (under a mesh they take the chunked path)."""
        slot = self.slot_of[seq_id]
        toks = self._put("one_shot", prompt, torch.long)[None]
        if self.cfg.family in ATTENTION_FAMILIES:
            logits, one = self.model.prefill(
                self.stack.params[0], {"tokens": toks}, max_len=self.max_len,
                moe_mode="dense", use_kernel=self.use_kernel)
            ones = [one]
        else:
            logits, ones = serve_prefill(self.stack, toks,
                                         max_len=self.max_len,
                                         window=self.window,
                                         use_kernel=self.use_kernel)
        for cache, one in zip(self.cache_shards, ones):
            for key, val in one.items():
                if key != "len":
                    cache[key][:, slot] = val[:, 0]
        self.cache["len"][slot] = len(prompt)
        return logits[0]

    def _kv(self, i: int):
        """Layer ``i``'s (k, v) slot caches (B, KH_s, S, hd_s), per
        shard."""
        return [(c["k"][i], c["v"][i]) for c in self.cache_shards]

    def _compute_chunk(self, task: PrefillTask, chunk: int):
        """One prefill chunk straight into the slot's rows of the stacked
        cache (attention families): the chunk's KV is written at
        [pos, pos + chunk), then its queries attend over the slot's rows,
        masked to [0, pos + chunk)."""
        st, slot, start = self.stack, self.slot_of[task.seq_id], task.pos
        kv_len = start + chunk
        toks = self._put("chunk", task.prompt[start:kv_len], torch.long)[None]
        h = st.embed(toks)
        positions = start + torch.arange(chunk, device=self.device)[None, :]
        for i in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(i)):
                for (_, k, v), (kc, vc) in zip(qkv, kv):
                    kc[slot, :, start:kv_len] = k[0].transpose(0, 1).to(
                        self.dtype)
                    vc[slot, :, start:kv_len] = v[0].transpose(0, 1).to(
                        self.dtype)
                rows = [(kc[slot].transpose(0, 1)[None],
                         vc[slot].transpose(0, 1)[None]) for kc, vc in kv]
                if st.kv_split == "heads":
                    return [chunked_attention(q, kr, vr, causal=True,
                                              q_offset=start, kv_len=kv_len)
                            for (q, _, _), (kr, vr) in zip(qkv, rows)]
                return st.split_attention(
                    [q for q, _, _ in qkv], lambda s: rows[s],
                    _causal(start, chunk, rows[0][0].shape[1], self.device))

            h = st.block(h, i, positions, attend)
        self.cache["len"][slot] = kv_len
        return st.head(h[:, chunk - 1])[0]

    # -- decode -----------------------------------------------------------------
    def _decode_step(self, tokens):
        """One decode step of every slot: tokens (max_slots,) on the
        device -> logits (max_slots, V) on it, the cache updated in place
        (each layer's new KV written after the loop at position ``len``,
        as ``transformer.decode_step`` does)."""
        st, lens = self.stack, self.cache["len"]
        if self.cfg.family not in ATTENTION_FAMILIES:
            logits = serve_decode_step(st, tokens, self.cache_shards, lens,
                                       window=self.window,
                                       use_kernel=self.use_kernel)
            lens.add_(1)            # in place: a decode graph replays it
            return logits
        lens_s = st.replicate(lens)
        new = [([], []) for _ in range(st.n)]
        h = st.embed(tokens[:, None])
        for i in range(self.cfg.num_layers):
            h = st.block(h, i, lens[:, None].long(),
                         st.decode_attend(self._kv(i), lens, lens_s, new,
                                          use_kernel=self.use_kernel))
        for c, (nk, nv), n in zip(self.cache_shards, new, lens_s):
            _scatter_new_kv(c["k"], torch.stack(nk), n)
            _scatter_new_kv(c["v"], torch.stack(nv), n)
        self.cache["len"] = lens + 1
        return st.head(h[:, 0])

    def decode_batch(self, tokens_by_slot: np.ndarray):
        """tokens_by_slot: (max_slots,). Steps every slot. Returns the
        (max_slots, V) logits on the host."""
        return _logits_to_host(self._decode_step(
            self._put("decode", tokens_by_slot, torch.long)))

    def _iteration(self, st, tokens, n_gen, done, produced):
        """One iteration of the fused loop: the decode step of every slot,
        then sample and latch. A slot stops updating (``done``) once it
        hits its stop token or generation limit; the cache still steps
        every slot, as the legacy path does for freed slots, so live slots
        compute exactly what they would alone. Returns (tokens, n_gen,
        done, produced)."""
        logits = self._decode_step(tokens)
        return _sample_and_latch(st, logits, tokens, n_gen, done, produced,
                                 st["active"] & ~done)

    def fused_decode(self, K: int, host_state: dict | None = None):
        """Run K decode steps on the device; sync only token ids and flags,
        in one device->host copy. ``host_state`` (when the engine's slot
        composition changed) re-seeds the device-resident state. Returns
        (tokens (K, max_slots), produced, done) numpy arrays."""
        g = self._graph
        with RECORDER.span("decode.prep"):
            if host_state is not None:
                self._dec_st = _upload_state(host_state, self.device,
                                             into=g.st)
                self._live = int(np.count_nonzero(host_state["active"]))
        if self._dec_st is None:
            raise RuntimeError("fused_decode needs host_state on the first "
                               "call")
        with RECORDER.span("decode.issue", K=K, K_run=K, live=self._live,
                           max_slots=self.max_slots):
            g.bind(self._dec_st)
            out = g.run(K)
        self._dec_st = g.st
        with RECORDER.span("decode.sync"):
            out, produced, done = _to_host(out, g.produced, g.done)
        if RECORDER.on:
            # every slot is stepped each iteration; a live row is one that
            # produced its token there
            RECORDER.count("decode_rows.stepped", K * self.max_slots)
            RECORDER.count("decode_rows.live", int(produced.sum()))
        return out, produced, done

    @property
    def supports_fused_decode(self) -> bool:
        return True

    # -- speculative decoding ----------------------------------------------------
    @property
    def supports_spec_decode(self) -> bool:
        # the verify block rewrites cache positions; SSM/hybrid state cannot
        # be rolled back, so only attention families speculate
        return self.cfg.family in ATTENTION_FAMILIES

    def spec_headroom(self, k: int) -> int:
        """Draft tokens a verify round can take: the dense cache has no
        page pool to run dry (the engine already bounds k by
        max_seq_len), so always k."""
        return k

    def reset_lens(self, lens_by_seq: dict[str, int]) -> None:
        """The draft cache's truncate-on-reject: rebuild the (max_slots,)
        length vector from the host (every live slot is given; a dead
        slot's length is never read before its next prefill sets it). KV
        rows past a new length are rewritten before the length crosses
        them."""
        lens = np.zeros((self.max_slots,), np.int32)
        for sid, n in lens_by_seq.items():
            lens[self.slot_of[sid]] = n
        self.cache["len"] = self._put("lens", lens)

    def spec_catch_up(self, seq_id: str, tokens: list, from_pos: int):
        """Draft-cache resync after non-speculative rounds advanced the
        emitted stream without the draft: compute KV for
        ``tokens[from_pos:]`` into the sequence's slot through the
        chunked-prefill body, leaving its length at ``len(tokens)``."""
        task = PrefillTask(seq_id=seq_id, prompt=list(tokens), pos=from_pos)
        self._compute_chunk(task, task.remaining)

    def _verify_forward(self, tokens_in, lens, live):
        """One forward of T tokens per slot against the slot cache: writes
        their KV at positions lens..lens+T-1 of each live slot, then query
        j attends [0, lens + j + 1). Returns logits (B, T, V) float32.

        torch has no dropping scatter (the reference writes dead slots at
        ``Smax`` with ``mode="drop"``), so a row that must not be written
        -- a dead slot's, or a live one past the cache -- is routed to
        position ``pos % Smax`` of its own slot and rewrites that row's own
        value: never out of bounds, and never onto a row this block writes
        (a live slot's wrapped positions lie below its ``lens``)."""
        st = self.stack
        B, T = tokens_in.shape
        Smax = self.cache_shards[0]["k"].shape[3]
        positions = lens.long()[:, None] + torch.arange(T, device=self.device)
        write = (live[:, None] & (positions < Smax))[..., None, None]
        wpos = positions % Smax
        bidx = torch.arange(B, device=self.device)[:, None]
        idx = list(zip(st.replicate(bidx), st.replicate(wpos),
                       st.replicate(write), st.replicate(lens)))
        h = st.embed(tokens_in)
        for i in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(i)):
                for (_, k, v), (kc, vc), (b, w, ok, _) in zip(qkv, kv, idx):
                    for c, new in ((kc, k), (vc, v)):   # new: (B, T, KH, hd)
                        c[b, :, w] = torch.where(ok, new.to(self.dtype),
                                                 c[b, :, w])
                if st.kv_split == "heads":
                    return [_spec_block_attention(q, kc, vc, n, kv_major=True)
                            for (q, _, _), (kc, vc), (*_, n) in zip(qkv, kv,
                                                                    idx)]
                return st.split_attention(
                    [q for q, _, _ in qkv],
                    lambda s: tuple(c.transpose(1, 2) for c in kv[s]),
                    _block_visible(lens, T, Smax))

            h = st.block(h, i, positions, attend)
        return st.head(h)

    def spec_verify(self, draft_tokens: np.ndarray, host_state=None):
        """One speculative round's verification: ``draft_tokens`` (B, k)
        from the draft's proposal loop. Verifies, accepts, resamples the
        residual and truncates the cache on the device; logits never reach
        the host. Returns (tokens (k+1, B), produced (B,), done (B,)) numpy
        arrays."""
        if host_state is not None:
            self._dec_st = _upload_state(host_state, self.device)
        if self._dec_st is None:
            raise RuntimeError("spec_verify needs host_state on the first "
                               "call")
        st = self._dec_st
        draft = self._put("spec", draft_tokens, torch.long)
        lens = self.cache["len"]
        logits = self._verify_forward(
            torch.cat([st["tokens"].long()[:, None], draft], dim=1), lens,
            st["active"])
        targets, produced, done, self._dec_st = _spec_accept_and_latch(
            st, logits, draft)
        self.cache["len"] = lens + produced
        return _to_host(targets.T, produced, done)

    # -- lifecycle -----------------------------------------------------------------
    def free(self, seq_id: str):
        slot = self.slot_of.pop(seq_id)
        self.free_slots.append(slot)

    def publish(self, seq_id: str, tokens: list) -> None:
        """Preemption hook: the slot backend has no content-addressed cache
        to publish into; a preempted sequence restores by full
        recompute."""

    def slot(self, seq_id: str) -> int:
        return self.slot_of[seq_id]

    def cache_stats(self) -> dict:
        return {}


class PagedBackend:
    """Paged KV cache backend for the attention families."""

    def __init__(self, model: LM, params, *, max_slots: int, max_len: int,
                 page_size: int = 128, num_pages: int | None = None,
                 use_kernel: bool = False, enable_prefix_cache: bool = False,
                 mesh=None, device=None):
        cfg = model.cfg
        if cfg.family not in ATTENTION_FAMILIES:
            raise ValueError("paged backend supports attention families, "
                             f"not {cfg.family!r}")
        self.shard = ServeSharding(mesh, cfg) if mesh is not None else None
        self.device = _lead_device(device, self.shard)
        if self.shard is None and params["embed"].device != self.device:
            raise ValueError(f"params live on {params['embed'].device}, the "
                             f"backend on {self.device}")
        self.model = model
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = page_size
        self.pages_per_seq = -(-max_len // page_size)
        if num_pages is None:
            num_pages = max_slots * self.pages_per_seq + 1  # +1: trash page 0
        self.kv = PagedKVCache(num_pages, page_size,
                               enable_prefix_cache=enable_prefix_cache)
        L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        self.dtype = getattr(torch, cfg.param_dtype)
        shape = (L, num_pages, page_size, KH, hd)
        if self.shard is None:
            self.pool_shards = [{
                "k": torch.zeros(shape, dtype=self.dtype, device=self.device),
                "v": torch.zeros(shape, dtype=self.dtype, device=self.device),
            }]
        else:
            # pages split along the kv-head axis (else head_dim); the
            # host-side allocator is one copy serving every shard
            spec = self.shard.pool_spec(shape)
            self.pool_shards = [
                {"k": k, "v": v} for k, v in zip(
                    self.shard.zeros(shape, self.dtype, spec),
                    self.shard.zeros(shape, self.dtype, spec))]
        self.stack = ServeStack(params, cfg, self.shard)
        self.use_kernel = use_kernel
        # the decode kernels run once per shard when the kv heads split
        # over the mesh; otherwise the plain head_dim-split path serves
        self._kernel_sharded = use_kernel and shardable_kv_heads(KH, mesh)
        self.free_slots = list(range(max_slots - 1, -1, -1))
        self.slot_of: dict[str, int] = {}
        self.seq_of: dict[int, str] = {}
        self.decoding: set[str] = set()
        self._dec_st = None         # device-resident per-slot decode state
        self._live = 0              # its active slots (the decode.issue attr)
        self._dev_tables = None     # device-resident (tables, lens) pair
        self._dev_tables_key = None  # kv.table_version the pair was built at
        # the fused decode loop, which holds that pair and the tails
        self._graph = _DecodeGraph(self, capture=_captures_decode(
            cfg, use_kernel, self.shard, self.device, paged=True))

    @property
    def pools(self) -> dict:
        """The page pools {"k", "v"} (L, num_pages, page, KH, hd) of an
        unsharded backend; under a mesh each shard's are in
        ``pool_shards``."""
        if self.shard is not None:
            raise AttributeError("a sharded backend's pools are per shard: "
                                 "see pool_shards")
        return self.pool_shards[0]

    def _kv(self, i: int):
        """Layer ``i``'s (k, v) page pools (NP, page, KH_s, hd_s), per
        shard."""
        return [(p["k"][i], p["v"][i]) for p in self.pool_shards]

    # -- capacity -------------------------------------------------------------
    def can_admit(self, n_prompt: int) -> bool:
        return (bool(self.free_slots)
                and self.kv.can_allocate(n_prompt + 1)
                and n_prompt < self.max_len)

    def _put(self, site: str, x, dtype=None):
        """Host array -> tensor on the backend's device; ``site`` names
        the ``sync`` span (``put.<site>``)."""
        return _upload(site, x, dtype, self.device)

    # -- attention dispatch ----------------------------------------------------
    def _attend(self, qs, kv, tables, lens):
        """Per-shard decode attention (kv heads split over the shards)."""
        fn = paged_attention_sharded if self.use_kernel \
            else paged_attention_sharded_ref
        return fn(qs, [k for k, _ in kv], [v for _, v in kv], tables, lens)

    def _prefill_attend(self, q, kp, vp, tables, start, kv_len):
        """Chunked-prefill attention: the paged flash-prefill kernel on one
        device; under a mesh the plain gather path, as the reference."""
        if self.use_kernel and self.shard is None:
            return paged_flash_prefill(q, kp, vp, tables, start, kv_len)
        return paged_prefill_attention_ref(q, kp, vp, tables, start, kv_len)

    def _tail_attend(self, qs, kv, tables, lens, kts, vts, tail_lens):
        """Per-shard decode attention over pages plus tails."""
        fn = fused_decode_attention_sharded if self.use_kernel \
            else fused_decode_attention_sharded_ref
        return fn(qs, [k for k, _ in kv], [v for _, v in kv], tables, lens,
                  kts, vts, tail_lens)

    def _cow(self, src: int, dst: int) -> None:
        """Copy-on-write, in place: duplicate page ``src`` into ``dst``
        across every layer (and shard) before a write diverges a shared
        page."""
        for pools in self.pool_shards:
            for pool in pools.values():
                pool[:, dst] = pool[:, src]

    # -- prefill protocol --------------------------------------------------------
    def start_prefill(self, seq_id: str, prompt: list) -> PrefillTask:
        slot = self.free_slots.pop()
        self.slot_of[seq_id] = slot
        self.seq_of[slot] = seq_id
        prompt = list(prompt)
        _, n_cached = self.kv.allocate_with_prefix(seq_id, prompt)
        return PrefillTask(seq_id=seq_id, prompt=prompt, pos=n_cached,
                           cached_tokens=n_cached)

    def prefill_chunk(self, task: PrefillTask, budget: int | None = None):
        """Compute up to ``budget`` prompt tokens (all remaining if None).
        Returns (last_token_logits (V,) on the device | None,
        tokens_computed)."""
        S = len(task.prompt)
        chunk = task.remaining if budget is None \
            else min(max(budget, 1), task.remaining)
        if (task.pos == 0 and chunk == S and self.shard is None
                and not self.kv.enable_prefix_cache):
            # whole-prompt self-attention, whole-page KV writes
            logits = self._one_shot(task.seq_id, task.prompt)
        else:
            logits = self._compute_chunk(task, chunk)
        task.pos += chunk
        task.chunks += 1
        if task.done:
            self.kv.commit_prefix(task.seq_id, task.prompt)
            self.decoding.add(task.seq_id)
            return logits, chunk
        return None, chunk

    def prefill(self, seq_id: str, prompt: list):
        """One-shot convenience: returns last-token logits (V,)."""
        task = self.start_prefill(seq_id, prompt)
        logits, _ = self.prefill_chunk(task, None)
        return logits

    def _one_shot(self, seq_id: str, prompt: list):
        """Whole prompt in one forward; K/V land in the sequence's pages a
        page at a time (the padded rows of the last page are garbage past
        the sequence length, overwritten before they are ever read)."""
        cfg, ps = self.cfg, self.page_size
        S = len(prompt)
        n_pages = self.kv.pages_needed(S)
        table = self._put("one_shot", self.kv._tables[seq_id][:n_pages],
                          torch.long)
        toks = torch.zeros((1, n_pages * ps), dtype=torch.long,
                           device=self.device)
        toks[0, :S] = self._put("one_shot", prompt, torch.long)
        h = self.stack.embed(toks)
        positions = torch.arange(n_pages * ps, device=self.device)[None, :]
        for i, lp in enumerate(self.stack.layers[0]):
            h, (k, v), _ = _block(h, lp, cfg, positions, moe_mode="dense",
                                  return_kv=True)
            self.pools["k"][i][table] = \
                k[0].reshape(n_pages, ps, *k.shape[2:]).to(self.dtype)
            self.pools["v"][i][table] = \
                v[0].reshape(n_pages, ps, *v.shape[2:]).to(self.dtype)
        return self.stack.head(h[:, S - 1])[0]

    def _compute_chunk(self, task: PrefillTask, chunk: int):
        """One prefill chunk against the page pool: the chunk's KV is
        written first, then its queries attend over [0, pos + chunk) of the
        sequence's pages -- cached prefix pages are read, never
        recomputed."""
        st, ps = self.stack, self.page_size
        pos = task.pos
        # COW any shared page this chunk writes into (only possible for the
        # recomputed final token of a page-aligned full prefix hit)
        for pi in range(pos // ps, (pos + chunk - 1) // ps + 1):
            cow = self.kv.writable_page(task.seq_id, pi * ps)
            if cow is not None:
                self._cow(*cow)
        table = self.kv._tables[task.seq_id]
        p = np.arange(pos, pos + chunk)
        write_pages = self._put("chunk", np.asarray(table)[p // ps],
                                torch.long)
        write_offs = self._put("chunk", p % ps, torch.long)
        n_ctx = self.kv.pages_needed(pos + chunk)
        ctx_table = self._put("chunk",
                              np.asarray(table[:n_ctx], np.int32)[None])
        toks = self._put("chunk", task.prompt[pos:pos + chunk],
                         torch.long)[None]
        idx = list(zip(st.replicate(write_pages), st.replicate(write_offs),
                       st.replicate(ctx_table)))
        h = st.embed(toks)
        positions = pos + torch.arange(chunk, device=self.device)[None, :]
        for i in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(i)):
                for (_, k, v), (kp, vp), (wp, wo, _) in zip(qkv, kv, idx):
                    kp[wp, wo] = k[0].to(self.dtype)
                    vp[wp, wo] = v[0].to(self.dtype)
                if st.kv_split == "heads":
                    return [self._prefill_attend(q, kp, vp, t, pos,
                                                 pos + chunk)
                            for (q, _, _), (kp, vp), (*_, t) in zip(qkv, kv,
                                                                    idx)]
                return st.split_attention(
                    [q for q, _, _ in qkv],
                    lambda s: tuple(gather_kv(c, idx[s][2]) for c in kv[s]),
                    _causal(pos, chunk, n_ctx * ps, self.device))

            h = st.block(h, i, positions, attend)
        return st.head(h[:, chunk - 1])[0]

    # -- decode -----------------------------------------------------------------
    def _decode_forward(self, tokens, tables, lens, page_idx, off):
        """One decode-step forward against the page pool: write each slot's
        new KV at (page_idx, off) in place, attend over [0, lens + 1).
        Returns logits (B, V) on the device."""
        st = self.stack
        ctx = lens + 1
        tabs, ctxs = st.replicate(tables), st.replicate(ctx)
        idx = list(zip(st.replicate(page_idx), st.replicate(off)))
        n_k = tables.shape[1] * self.page_size
        h = st.embed(tokens[:, None])
        for i in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(i)):
                for (_, k, v), (kp, vp), (pi, o) in zip(qkv, kv, idx):
                    kp[pi, o] = k[:, 0].to(self.dtype)
                    vp[pi, o] = v[:, 0].to(self.dtype)
                qs = [q[:, 0] for q, _, _ in qkv]
                if st.kv_split == "heads":
                    return [a[:, None] for a in self._attend(qs, kv, tabs,
                                                             ctxs)]
                valid = torch.arange(n_k, device=self.device)[None, :] \
                    < ctx.long()[:, None]
                return st.split_attention(
                    [q for q, _, _ in qkv],
                    lambda s: tuple(gather_kv(c, tabs[s]) for c in kv[s]),
                    valid[:, None])

            h = st.block(h, i, lens[:, None], attend)
        return st.head(h[:, 0])

    def _host_tables(self) -> tuple[np.ndarray, np.ndarray]:
        """(max_slots, PPS) block tables and (max_slots,) lengths of the
        decoding sequences; other slots hold zeros (the trash page)."""
        tables = np.zeros((self.max_slots, self.pages_per_seq), np.int32)
        lens = np.zeros((self.max_slots,), np.int32)
        for slot, sid in self.seq_of.items():
            if sid in self.decoding:
                tables[slot] = self.kv.table_array([sid],
                                                   self.pages_per_seq)[0]
                lens[slot] = self.kv.length(sid)
        return tables, lens

    def decode_batch(self, tokens_by_slot: np.ndarray):
        """tokens_by_slot: (max_slots,). Inactive / mid-prefill slots write
        to trash page 0. Returns the (max_slots, V) logits on the host."""
        for sid in self.decoding:
            self.kv.ensure_slot(sid)
            # a decode write into a still-shared page must diverge first
            cow = self.kv.writable_page(sid, self.kv.length(sid))
            if cow is not None:
                self._cow(*cow)
        tables, lens = self._host_tables()
        page_idx = tables[np.arange(self.max_slots), lens // self.page_size]
        logits = self._decode_forward(
            self._put("decode", tokens_by_slot, torch.long),
            self._put("decode", tables), self._put("decode", lens),
            self._put("decode", page_idx, torch.long),
            self._put("decode", lens % self.page_size, torch.long))
        for sid in self.decoding:
            self.kv.advance(sid)
        return _logits_to_host(logits)

    # -- fused decode fast path --------------------------------------------------
    def _reference_step(self, st, tokens, n_gen, done, produced, tables,
                        lens0):
        """One step of the reference tier's fused loop: the fed token's KV
        written into the pool at position ``lens0 + produced`` (a live
        step advances the length and ``produced`` together; dead slots
        route to trash page 0), the forward of every slot, then sample and
        latch. Returns (tokens, n_gen, done, produced)."""
        ps = self.page_size
        live = st["active"] & ~done
        lens = lens0 + produced
        page_slot = torch.clamp(lens // ps, max=tables.shape[1] - 1).long()
        page_idx = tables.gather(1, page_slot[:, None])[:, 0]
        page_idx = torch.where(live, page_idx, 0).long()
        off = torch.where(live, lens % ps, 0).long()
        logits = self._decode_forward(tokens, tables, lens, page_idx, off)
        return _sample_and_latch(st, logits, tokens, n_gen, done, produced,
                                 live)

    def _kernel_step(self, st, tokens, n_gen, done, produced, tabs, lens0,
                     lens0s, bidxs, tails):
        """One step of the kernel tier's fused loop, with no pool write:
        every slot's new KV goes to row ``produced`` of the (L, B, Kt, KH,
        hd) tails, and the forward attends committed pages + tail under one
        softmax (``fused_decode_attention``); then sample and latch.
        ``fused_decode`` commits the tails after the loop
        (:meth:`_commit_tails`), so the call emits the reference tier's
        token stream. ``tabs``, ``lens0s``, ``bidxs`` and ``tails`` are per
        shard; the tails hold Kt >= the call's K rows. Returns (tokens,
        n_gen, done, produced)."""
        tp, dev = self.stack, self.device
        Kt = tails[0][0].shape[2]
        n_k = tabs[0].shape[1] * self.page_size
        live = st["active"] & ~done
        # ``produced`` doubles as the tail write cursor: slot b's valid
        # tail rows are [0, produced[b]) and this step writes row
        # produced[b] (dead slots overwrite that row; their outputs are
        # discarded by the live mask)
        h = tp.embed(tokens[:, None])
        positions = (lens0 + produced)[:, None]
        tail_lens = produced + 1
        tls, rows = tp.replicate(tail_lens), tp.replicate(produced.long())
        for l in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(l)):
                for (_, k, v), (kt, vt), b, r in zip(qkv, tails, bidxs,
                                                     rows):
                    kt[l][b, r] = k[:, 0].to(self.dtype)
                    vt[l][b, r] = v[:, 0].to(self.dtype)
                qs = [q[:, 0] for q, _, _ in qkv]
                if tp.kv_split == "heads":
                    return [a[:, None] for a in self._tail_attend(
                        qs, kv, tabs, lens0s, [t[0][l] for t in tails],
                        [t[1][l] for t in tails], tls)]
                ok = torch.cat([
                    torch.arange(n_k, device=dev)[None, :]
                    < lens0.long()[:, None],
                    torch.arange(Kt, device=dev)[None, :]
                    < tail_lens.long()[:, None]], dim=1)

                def context(s):
                    return tuple(torch.cat([gather_kv(c, tabs[s]), t[l]],
                                           dim=1)
                                 for c, t in zip(kv[s], tails[s]))
                return tp.split_attention([q for q, _, _ in qkv],
                                          context, ok[:, None])

            h = tp.block(h, l, positions, attend)
        logits = tp.head(h[:, 0])
        return _sample_and_latch(st, logits, tokens, n_gen, done, produced,
                                 live)

    def _commit_tails(self, tails, tables, lens0, produced) -> None:
        """The deferred commit, one scatter per pool: the (L, B, Kt) tail
        rows below ``produced`` to their pages, every other row to trash
        page 0."""
        ps, dev = self.page_size, self.device
        jj = torch.arange(tails[0][0].shape[2], device=dev)[None, :]
        pos = lens0[:, None] + jj                               # (B, Kt)
        valid = jj < produced[:, None]
        page_slot = torch.clamp(pos // ps, max=tables.shape[1] - 1).long()
        page_idx = torch.where(valid, tables.gather(1, page_slot), 0).long()
        off = torch.where(valid, pos % ps, 0).long()
        tp = self.stack
        for p, t, pi, o in zip(self.pool_shards, tails,
                               tp.replicate(page_idx), tp.replicate(off)):
            p["k"][:, pi, o] = t[0]
            p["v"][:, pi, o] = t[1]

    def fused_decode(self, K: int, host_state: dict | None = None):
        """Run up to K decode steps on the device; sync only token ids and
        flags, in one device->host copy.

        Host-side prep per call: allocate page headroom for K tokens per
        decoding sequence (clamping K down if the pool is tight) and resolve
        copy-on-write for every page the loop will write. Block tables and
        lengths are uploaded only when the allocator state changed
        (``kv.table_version``) or the engine re-seeds the slot state.
        Returns (tokens (K_eff, max_slots), produced, done) numpy arrays.
        """
        g = self._graph
        with RECORDER.span("decode.prep"):
            K_eff = self._reserve_headroom(max(1, K))
            self._resolve_cow(K_eff)
            g.reserve(max(1, K))
            self._refresh_tables(force=host_state is not None)
            if host_state is not None:
                self._dec_st = _upload_state(host_state, self.device,
                                             into=g.st)
                self._live = int(np.count_nonzero(host_state["active"]))
        if self._dec_st is None:
            raise RuntimeError("fused_decode needs host_state on the first "
                               "call")
        tables_d, lens_d = self._dev_tables
        with RECORDER.span("decode.issue", K=K, K_run=K_eff, live=self._live,
                           max_slots=self.max_slots):
            g.bind(self._dec_st, tables_d, lens_d)
            out = g.run(K_eff)
            if self.use_kernel:
                self._commit_tails(g.tails, g.tables, g.lens, g.produced)
            g.lens.add_(g.produced)
        self._dec_st = g.st
        self._dev_tables = (tables_d, g.lens)
        with RECORDER.span("decode.sync"):
            host = _to_host(out, g.produced, g.done)
        return self._advance_decoding(*host)

    @property
    def supports_fused_decode(self) -> bool:
        return True

    def _advance_decoding(self, out, produced, done):
        """Advance every decoding sequence's logical length by what the
        device produced for its slot; passes the host arrays through."""
        for slot, sid in self.seq_of.items():
            if sid in self.decoding:
                self.kv.advance_n(sid, int(produced[slot]))
        return out, produced, done

    def _reserve_headroom(self, n: int) -> int:
        """Reserve page headroom for up to ``n`` token writes per decoding
        sequence. Every live sequence first gets ONE token of headroom
        (raise rather than route a live KV write to the trash page), then
        best-effort up to ``n``. Returns the write count the pool (and
        ``max_len``) can take."""
        for sid in self.decoding:
            if self.kv.ensure_capacity(sid, 1) <= 0:
                raise OutOfPages(f"{sid}: pool exhausted on decode append")
        for sid in self.decoding:
            ahead = max(1, min(n, self.max_len - self.kv.length(sid)))
            n = min(n, max(1, self.kv.ensure_capacity(sid, ahead)))
        return n

    def _resolve_cow(self, n_writes: int) -> None:
        """COW every still-shared page the next ``n_writes`` decode token
        writes of each decoding sequence would land in."""
        ps = self.page_size
        for sid in self.decoding:
            pos0 = self.kv.length(sid)
            for pi in range(pos0 // ps, (pos0 + n_writes - 1) // ps + 1):
                cow = self.kv.writable_page(sid, pi * ps)
                if cow is not None:
                    self._cow(*cow)

    def _refresh_tables(self, force: bool) -> None:
        """(Re)upload the device-resident (block tables, lengths) pair,
        into the fused loop's static pair, when the allocator state moved
        from under the cached copy."""
        if (force or self._dev_tables is None
                or self._dev_tables_key != self.kv.table_version):
            tables, lens = self._host_tables()
            g = self._graph
            self._dev_tables = (_upload_into("tables", g.tables, tables),
                                _upload_into("tables", g.lens, lens))
            self._dev_tables_key = self.kv.table_version

    # -- speculative decoding ----------------------------------------------------
    @property
    def supports_spec_decode(self) -> bool:
        return True

    def spec_headroom(self, k: int) -> int:
        """Reserve page headroom for a verify round of k draft tokens plus
        the guaranteed target token; returns the k the pool can take (the
        reservation policy of ``fused_decode``)."""
        return self._reserve_headroom(k + 1) - 1

    def reset_lens(self, lens_by_seq: dict[str, int]) -> None:
        """Truncate-on-reject for the draft's paged cache between rounds:
        roll each sequence's logical length back (pages stay as headroom;
        ``rollback_to`` bumps ``table_version``, so the device lengths are
        re-uploaded)."""
        for sid, n in lens_by_seq.items():
            self.kv.rollback_to(sid, n)

    def spec_catch_up(self, seq_id: str, tokens: list, from_pos: int):
        """Draft-cache resync after non-speculative rounds advanced the
        emitted stream without the draft: compute KV for
        ``tokens[from_pos:]`` into the sequence's pages through the
        chunked-prefill body, leaving its logical length at
        ``len(tokens)``."""
        self.kv.rollback_to(seq_id, from_pos)
        need = len(tokens) - from_pos
        if self.kv.ensure_capacity(seq_id, need) < need:
            raise OutOfPages(f"{seq_id}: pool exhausted on draft catch-up")
        task = PrefillTask(seq_id=seq_id, prompt=list(tokens), pos=from_pos)
        self._compute_chunk(task, task.remaining)
        self.kv.advance_n(seq_id, need)
        self.kv.table_version += 1       # the device lengths are stale now

    def _ctx_pages(self, T: int) -> int:
        """Block-table columns a verify block of T tokens can see: enough
        for the longest decoding sequence's ``length + T``."""
        longest = max((self.kv.length(sid) for sid in self.decoding),
                      default=0)
        return min(self.pages_per_seq, self.kv.pages_needed(longest + T))

    def _verify_forward(self, tokens_in, tables, lens, live, n_ctx: int):
        """One forward of T tokens per slot against the page pool: writes
        their KV at positions lens..lens+T-1 (dead slots to trash page 0 at
        offset 0, the page slot clamped to the last table column), then
        query j attends [0, lens + j + 1) over the first ``n_ctx`` pages of
        its table, gathered. Returns logits (B, T, V) float32."""
        st, ps = self.stack, self.page_size
        T = tokens_in.shape[1]
        positions = lens.long()[:, None] + torch.arange(T, device=self.device)
        page_slot = torch.clamp(positions // ps, max=tables.shape[1] - 1)
        live = live[:, None]
        page_idx = torch.where(live, tables.gather(1, page_slot), 0).long()
        off = torch.where(live, positions % ps, 0)
        idx = list(zip(st.replicate(page_idx), st.replicate(off),
                       st.replicate(tables[:, :n_ctx]), st.replicate(lens)))
        h = st.embed(tokens_in)
        for i in range(self.cfg.num_layers):
            def attend(qkv, kv=self._kv(i)):
                for (_, k, v), (kp, vp), (pi, o, _, _) in zip(qkv, kv, idx):
                    kp[pi, o] = k.to(self.dtype)
                    vp[pi, o] = v.to(self.dtype)
                if st.kv_split == "heads":
                    return [_spec_block_attention(
                        q, gather_kv(kp, c), gather_kv(vp, c), n,
                        kv_major=False)
                        for (q, _, _), (kp, vp), (_, _, c, n) in zip(qkv, kv,
                                                                      idx)]
                return st.split_attention(
                    [q for q, _, _ in qkv],
                    lambda s: tuple(gather_kv(c, idx[s][2]) for c in kv[s]),
                    _block_visible(lens, T, n_ctx * ps))

            h = st.block(h, i, positions, attend)
        return st.head(h)

    def _prepare_verify(self, T: int, force: bool) -> None:
        """Host-side prep of a verify block of T tokens: copy-on-write for
        every page it writes, then the device (tables, lengths) pair."""
        self._resolve_cow(T)
        self._refresh_tables(force=force)

    def spec_verify(self, draft_tokens: np.ndarray, host_state=None):
        """One speculative round's verification (page headroom already
        reserved by ``spec_headroom``): verify, accept, residual resample
        and truncate on the device; logits never reach the host. Returns
        (tokens (k+1, B), produced (B,), done (B,)) numpy arrays."""
        T = draft_tokens.shape[1] + 1
        self._prepare_verify(T, force=host_state is not None)
        if host_state is not None:
            self._dec_st = _upload_state(host_state, self.device)
        if self._dec_st is None:
            raise RuntimeError("spec_verify needs host_state on the first "
                               "call")
        st = self._dec_st
        tables_d, lens_d = self._dev_tables
        draft = self._put("spec", draft_tokens, torch.long)
        logits = self._verify_forward(
            torch.cat([st["tokens"].long()[:, None], draft], dim=1), tables_d,
            lens_d, st["active"], self._ctx_pages(T))
        targets, produced, done, self._dec_st = _spec_accept_and_latch(
            st, logits, draft)
        self._dev_tables = (tables_d, lens_d + produced)
        return self._advance_decoding(*_to_host(targets.T, produced, done))

    def verify_logits(self, tokens_in: np.ndarray):
        """The verify forward alone, for teacher-forced checks: feeds
        ``tokens_in`` (max_slots, T) to every decoding sequence at its
        length (page headroom reserved, copy-on-write resolved), writes
        their KV and returns the (max_slots, T, V) logits on the device.
        No length moves."""
        T = tokens_in.shape[1]
        if self._reserve_headroom(T) < T:
            raise OutOfPages(f"no page headroom for a verify block of {T}")
        self._prepare_verify(T, force=True)
        tables_d, lens_d = self._dev_tables
        live = self._put("verify", [self.seq_of.get(s) in self.decoding
                                    for s in range(self.max_slots)])
        return self._verify_forward(self._put("verify", tokens_in,
                                              torch.long),
                                    tables_d, lens_d, live, self._ctx_pages(T))

    # -- swap preemption -----------------------------------------------------------
    def swap_out(self, seq_id: str) -> dict:
        """Copy a sequence's computed KV to host memory: the (L, n_pages,
        page, KH, hd) K and V of the pages covering its logical length
        (headroom pages hold no committed KV). The caller frees the
        sequence afterwards; ``swap_in`` restores it into fresh pages."""
        n_tokens = self.kv.length(seq_id)
        n_pages = self.kv.pages_needed(n_tokens)
        table = self._put("swap_out", self.kv._tables[seq_id][:n_pages],
                          torch.long)
        parts = [{n: pool[:, table.to(pool.device)] for n, pool in p.items()}
                 for p in self.pool_shards]
        kv = parts[0] if self.shard is None else self.shard.gather_pools(parts)
        with RECORDER.sync("swap_out", n=2, h2d=False):
            return {"k": kv["k"].cpu(), "v": kv["v"].cpu(),
                    "n_tokens": n_tokens}

    def swap_in(self, seq_id: str, n_tokens: int, blob: dict) -> None:
        """Rebind a swapped-out sequence: reserve a slot, allocate fresh
        pages, write the saved KV back (one indexed store per pool) and
        rejoin the decode set, with no recompute. ``n_tokens`` must equal
        the blob's saved length."""
        assert n_tokens == blob["n_tokens"], \
            f"{seq_id}: swap blob holds {blob['n_tokens']} tokens, " \
            f"restore asked for {n_tokens}"
        slot = self.free_slots.pop()
        self.slot_of[seq_id] = slot
        self.seq_of[slot] = seq_id
        pages = self._put("swap_in", self.kv.allocate(seq_id, n_tokens),
                          torch.long)
        kv = {"k": blob["k"], "v": blob["v"]}
        parts = [kv] if self.shard is None else self.shard.shard_pools(kv)
        with RECORDER.sync("swap_in", n=2 * len(parts)):
            for pools, part in zip(self.pool_shards, parts):
                for name, pool in pools.items():
                    pool[:, pages.to(pool.device)] = part[name].to(pool.device)
        self.decoding.add(seq_id)

    # -- lifecycle -----------------------------------------------------------------
    def free(self, seq_id: str):
        slot = self.slot_of.pop(seq_id)
        self.seq_of.pop(slot, None)
        self.decoding.discard(seq_id)
        self.free_slots.append(slot)
        self.kv.free(seq_id)

    def publish(self, seq_id: str, tokens: list) -> None:
        """Preemption hook: register a preempted sequence's full pages
        (prompt AND decoded tokens) in the content index before they are
        freed, so the restore prefill content-matches them back. No-op
        when the prefix cache is disabled."""
        self.kv.commit_prefix(seq_id, tokens)

    def slot(self, seq_id: str) -> int:
        return self.slot_of[seq_id]

    def cache_stats(self) -> dict:
        s = dict(self.kv.stats)
        s["hit_rate"] = self.kv.hit_rate()
        s["cached_free_pages"] = self.kv.cached_free_pages
        return s


class _StepGraph:
    """The fused decode loop of both backends: K iterations of a backend's
    iteration body over static buffers, each issued op by op or, where
    ``capture`` is set, replayed from a CUDA graph.

    ``forward(st, tokens, n_gen, done, produced)`` is the iteration: from
    the per-slot decode state ``st`` (tokens, n_gen, active, temps, top_ps,
    seed_base, stop_tok, gen_limit) and ``done`` / ``produced`` it returns
    the next (tokens, n_gen, done, produced), which :meth:`step` copies
    back into the static buffers. Whatever else it reads or writes (the
    slot cache; the paged backend's tables, lens and tails) its backend
    keeps at fixed addresses. ``_upload_state`` can copy into ``st``; state
    a call hands in from elsewhere is copied in on the device
    (:meth:`bind`).

    ``capture`` (:func:`_captures_decode`, fixed at construction): the
    first iteration with no graph is issued on a side stream, which makes
    the workspaces cuBLAS and the port's kernels keep per stream (and sets
    the paged kernel's shared-memory attribute); it is the call's real
    iteration (a recurrent state cannot be stepped twice). The same
    iteration is then recorded with the recorder off. A replay adds the
    launches the recorded iteration made to ``_build.LAUNCHES`` and counts
    ``decode_graph.replay`` and ``counts`` (what the recorded iteration
    would have counted); an iteration issued op by op, the warm-up
    included, counts ``decode_graph.eager``. The graph holds the workspace
    that the port's decode kernels cached for its stream, so that a later
    call which grows it cannot free what the recorded launches point
    at."""

    def __init__(self, device, B: int, forward, *, capture: bool,
                 counts: dict | None = None):
        self.device = device
        self.forward = forward
        self.capture = capture
        self.counts = counts or {}
        self.produced = torch.zeros((B,), dtype=torch.int32, device=device)
        self.done = torch.zeros((B,), dtype=torch.bool, device=device)
        self.st = None
        self.graph = None
        self.stream = None
        self.launches = {}
        self.workspace = None   # the decode kernels', while the graph lives

    def bind(self, st: dict) -> None:
        """A call's decode state into the static buffers."""
        if self.st is None:
            self.st = {k: v.clone() for k, v in st.items()}
        elif st is not self.st:
            for k, v in st.items():
                self.st[k].copy_(v)

    def run(self, K: int):
        """K iterations from ``done`` and ``produced`` zeroed: their tokens
        (K, B), each copied out after its iteration."""
        self.done.zero_()
        self.produced.zero_()
        out = torch.zeros((K, self.done.shape[0]), dtype=torch.int32,
                          device=self.device)
        for i in range(K):
            self.iterate()
            out[i] = self.st["tokens"]
        return out

    def step(self) -> None:
        """One iteration on the static buffers, its results copied back
        into them."""
        st = self.st
        new = self.forward(st, st["tokens"], st["n_gen"], self.done,
                           self.produced)
        for dst, src in zip((st["tokens"], st["n_gen"], self.done,
                             self.produced), new):
            dst.copy_(src)

    def iterate(self) -> None:
        """One iteration: a replay where a graph was recorded, else issued
        op by op (and recorded after, with ``capture``)."""
        if self.graph is not None:
            self.graph.replay()
            for name, n in self.launches.items():
                _build.LAUNCHES[name] += n
            RECORDER.count("decode_graph.replay")
            for name, n in self.counts.items():
                RECORDER.count(name, n)
            return
        if self.capture:
            self._record()
        else:
            self.step()
        RECORDER.count("decode_graph.eager")

    def _record(self) -> None:
        """This iteration on the side stream, then the same iteration
        recorded into the graph."""
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        s = self.stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            self.step()
        cur.wait_stream(s)
        warm = dict(_build.LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        on, RECORDER.on = RECORDER.on, False
        try:
            with torch.cuda.graph(graph, stream=s,
                                  capture_error_mode="thread_local"):
                self.step()
        finally:
            RECORDER.on = on
        self.launches = {name: n - warm.get(name, 0)
                         for name, n in _build.LAUNCHES.items()
                         if n != warm.get(name, 0)}
        _build.LAUNCHES.update(warm)
        self.graph = graph
        self.workspace = cached_workspace(dev, s.cuda_stream)
        RECORDER.count("decode_graph.capture")


class _DecodeGraph(_StepGraph):
    """The paged backend's fused decode loop: its step is
    :meth:`PagedBackend._kernel_step` or, on the reference tier,
    :meth:`PagedBackend._reference_step`, at B = ``max_slots``. Beside the
    decode state it holds the device (tables, lens) pair, which
    ``_refresh_tables`` copies into, with its copy on every shard's device
    (the pair itself on one device), and on the kernel tier the per-shard
    (L, B, K_cap, KH_s, hd_s) tails, K_cap the largest K asked so far: a
    larger K regrows the tails and drops the graph, to be captured again.
    The paged kernel reads its lengths on the device and runs at
    ``kt_cap = K_cap``; tail rows past a slot's length are never read, and
    the split-K schedule depends on the length alone, so K_cap rows give
    what K rows give."""

    def __init__(self, backend: PagedBackend, *, capture: bool):
        B, dev, tp = backend.max_slots, backend.device, backend.stack
        super().__init__(dev, B, self._forward, capture=capture)
        self.backend = backend
        self.tables = torch.zeros((B, backend.pages_per_seq),
                                  dtype=torch.int32, device=dev)
        self.lens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.tabs = tp.replicate(self.tables)
        self.lens_s = tp.replicate(self.lens)
        self.bidxs = tp.replicate(torch.arange(B, device=dev))
        self.tails = None
        self.k_cap = 0

    def _forward(self, *state):
        bk = self.backend
        if bk.use_kernel:
            return bk._kernel_step(*state, self.tabs, self.lens, self.lens_s,
                                   self.bidxs, self.tails)
        return bk._reference_step(*state, self.tables, self.lens)

    def reserve(self, K: int) -> None:
        """Kernel tier: tails of at least K rows, regrown, and the graph
        dropped, when K exceeds K_cap."""
        bk = self.backend
        if not bk.use_kernel or K <= self.k_cap:
            return
        self.graph = None
        self.tails = [tuple(
            torch.zeros((bk.cfg.num_layers, bk.max_slots, K,
                         *p[n].shape[3:]), dtype=bk.dtype,
                        device=p[n].device) for n in ("k", "v"))
            for p in bk.pool_shards]
        self.k_cap = K

    def bind(self, st: dict, tables, lens) -> None:
        """A call's state into the static buffers: device copies of what
        is held elsewhere, then the pair to the other shards' devices."""
        super().bind(st)
        for dst, src, copies in ((self.tables, tables, self.tabs),
                                 (self.lens, lens, self.lens_s)):
            if src is not dst:
                dst.copy_(src)
            for c in copies:
                if c is not dst:
                    c.copy_(dst)
