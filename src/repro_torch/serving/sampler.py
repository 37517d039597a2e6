"""Token sampling: greedy / temperature / top-p (nucleus), bit-compatible
with the JAX package's sampler (the port of ``repro/serving/sampler.py``).

Seeded top-p in the reference draws
``jax.random.categorical(jax.random.PRNGKey(seed), masked)``. For the two
packages to emit the same tokens, this module reproduces that draw in torch
integer ops on the device:

* ``PRNGKey(seed)`` for a 32-bit seed is the key pair ``(0, seed)``;
* the bits of a ``(V,)`` draw are threefry2x32 in the partitionable mode
  (jax's default since 0.5): counter ``i`` hashes as the pair
  ``(i >> 32, i & 0xffffffff)`` and the 32-bit output is ``x0 ^ x1``;
* uniforms set the 23 high bits as the mantissa of a float in [1, 2) and
  subtract 1, then map onto ``[tiny, 1)`` (``jax.random._uniform``);
* gumbel noise is ``-log(-log(u))`` (the default "low" mode);
* categorical is ``argmax(gumbel + logits)``, first index on ties.

uint32 arithmetic is emulated in int64 with a 32-bit mask (torch has no
complete uint32 op set). Logs and exps come from torch, not XLA, so a
draw can differ where two candidates are within an ulp of each other.

Seed folding: the engine derives ``seed_base = (seed * 1_000_003) %
SEED_MOD`` once at admission; each step's seed is ``(seed_base + n_gen) %
SEED_MOD`` (:func:`fold_seeds`, uint32 wrap as in the reference).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serving.tracing import RECORDER

SEED_MOD = 2 ** 31 - 1
SEED_MULT = 1_000_003
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
# jax.random._uniform's bounds in float32: tiny, and 1 - tiny (which rounds
# to 1)
_TINY = float(np.finfo(np.float32).tiny)
_SPAN = float(np.float32(1.0) - np.float32(_TINY))


def seed_base(seed: int) -> int:
    """Host-side per-request seed base (fits in uint32/int32)."""
    return (seed * SEED_MULT) % SEED_MOD


def fold_seeds(base, n_gen):
    """base: (B,) uint32-valued seed bases; n_gen: (B,) tokens generated so
    far. Returns (B,) int64 PRNG seeds ``(base + n_gen) mod 2^32 mod
    SEED_MOD``, identical to the host fold."""
    s = ((base.long() & _M32) + (n_gen.long() & _M32)) & _M32
    return s % SEED_MOD


# -- threefry2x32 in int64 ------------------------------------------------------

def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    values; keys broadcast against the counters. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def random_bits(seeds, n: int):
    """``jax.random.bits(PRNGKey(seed), (n,))`` for each seed: (B,) integer
    seeds -> (B, n) int64 holding the uint32 bits."""
    seeds = seeds.long()
    k0 = (seeds >> 32)[:, None] & _M32
    k1 = seeds[:, None] & _M32
    count = torch.arange(n, dtype=torch.int64, device=seeds.device)[None, :]
    y0, y1 = threefry2x32(k0, k1, count >> 32, count & _M32)
    return y0 ^ y1


def gumbel(seeds, n: int):
    """``jax.random.gumbel(PRNGKey(seed), (n,))`` per seed, float32 (B, n).
    Uniforms map onto ``[tiny, 1)`` through Python-float bounds, so a call
    makes no tensor on the host and copies nothing to the device (a CUDA
    graph can hold it)."""
    bits = random_bits(seeds, n)
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)     # [1, 2) as bits
    floats = mant.view(torch.float32) - 1.0
    return -torch.log(-torch.log(torch.clamp(floats * _SPAN + _TINY,
                                             min=_TINY)))


# -- samplers -------------------------------------------------------------------

def sample_from_logits(logits, temperature, top_p, seeds):
    """Batch sampler on the logits' device. logits: (B, V) float32;
    temperature, top_p: (B,) float32; seeds: (B,) integer. temperature == 0
    -> greedy argmax. Returns (B,) int32."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature, min=1e-6)[:, None]
    sort_idx = torch.argsort(-scaled, dim=-1, stable=True)
    sorted_logits = torch.gather(scaled, 1, sort_idx)
    e = torch.exp(sorted_logits - sorted_logits.amax(dim=-1, keepdim=True))
    probs = e / e.sum(dim=-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p[:, None]          # first token always kept
    masked = torch.where(keep, sorted_logits, float("-inf"))
    choice = torch.argmax(gumbel(seeds, logits.shape[-1]) + masked, dim=-1)
    sampled = torch.gather(sort_idx, 1, choice[:, None])[:, 0]
    return torch.where(temperature <= 0.0, greedy, sampled).to(torch.int32)


def _sample_one(lg, temp, tp, seed):
    """lg: (V,) logits; temp/tp: floats; seed: int -> 0-dim int32 tensor."""
    dev = lg.device
    with RECORDER.sync("sample_params", n=3):
        temps = torch.tensor([temp], dtype=torch.float32, device=dev)
        top_ps = torch.tensor([tp], dtype=torch.float32, device=dev)
        seeds = torch.tensor([seed], dtype=torch.int64, device=dev)
    return sample_from_logits(lg.float()[None], temps, top_ps, seeds)[0]


def sample_tokens(logits, temperature, top_p, seeds):
    """Batch sampler for host-side callers (the legacy per-step path):
    array-likes in, (B,) int32 tensor out, on the logits' device."""
    logits = torch.as_tensor(np.asarray(logits) if not torch.is_tensor(logits)
                             else logits)
    dev = logits.device
    return sample_from_logits(
        logits,
        torch.as_tensor(np.asarray(temperature, np.float32), device=dev),
        torch.as_tensor(np.asarray(top_p, np.float32), device=dev),
        torch.as_tensor(np.asarray(seeds, np.int64), device=dev))


def sample_token(logits, temperature, top_p, seed):
    """One sequence's first token from device-resident logits (V,); only
    the sampled id needs to cross to the host."""
    return _sample_one(logits, float(temperature), float(top_p), int(seed))


# -- speculative decoding: acceptance test + residual resampling -------------
# The sampler is deterministic given (seed_base, n_gen): position i of a
# sequence always samples the same token from the same logits. The target's
# distribution at each position is then a point mass on that seeded sample,
# so accept-with-probability-min(1, p/q) collapses to an exact-match test
# and the residual resample at the first mismatch is the target's own
# sample. Speculative streams are token-identical to non-speculative
# decoding for greedy and seeded top-p alike.

def spec_targets(logits, temps, top_ps, seed_base, n_gen):
    """Seeded target samples for a block of verify positions.

    logits: (B, T, V) -- position j holds the target logits after feeding
    verify token j; temps/top_ps: (B,); seed_base: (B,) uint32-valued;
    n_gen: (B,) tokens generated so far. Position j folds seed
    ``seed_base + n_gen + j`` (wrapping at 32 bits, as :func:`fold_seeds`),
    the seed the non-speculative loop folds when emitting that token.
    Returns (B, T) int32."""
    B, T, V = logits.shape
    n2 = n_gen.long()[:, None] + torch.arange(T, device=logits.device)
    seeds = fold_seeds(seed_base.repeat_interleave(T), n2.reshape(-1))
    out = sample_from_logits(logits.reshape(B * T, V),
                             temps.repeat_interleave(T),
                             top_ps.repeat_interleave(T), seeds)
    return out.reshape(B, T)


def spec_accept(targets, draft):
    """Acceptance test. targets: (B, k+1) seeded target samples; draft:
    (B, k) proposals. Returns ``(emit (B, k+1) bool, n_emit (B,) int32)``:
    position 0 (the guaranteed target token) is always emitted, position
    j > 0 iff every draft token before it matched; ``n_emit = 1 +
    accepted``. The token emitted at the first mismatch is ``targets``
    there -- the residual resample."""
    match = (targets[:, :-1] == draft).to(torch.int32)
    prefix = torch.cumprod(match, dim=1)
    first = torch.ones((targets.shape[0], 1), dtype=torch.int32,
                       device=targets.device)
    emit = torch.cat([first, prefix], dim=1).bool()
    return emit, emit.sum(dim=1).to(torch.int32)
