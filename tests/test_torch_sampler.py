"""The port's sampler (``repro_torch.serving.sampler``) against the JAX
package's: the same token for the same logits and seed, exactly.

Seeded top-p in the reference draws ``jax.random.categorical`` under
``PRNGKey(seed)``; the port rebuilds that draw in torch integer ops
(threefry2x32, jax's uniform-float construction, gumbel, argmax). Logits
are made with numpy from a seed and handed to both samplers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import sampler as jax_sampler
from repro_torch.serving import sampler

SEEDS = np.random.default_rng(0).integers(0, sampler.SEED_MOD, size=48)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("n", [1, 7, 256, 4099])
def test_threefry_bits_match_jax(n):
    seeds = np.concatenate([[0, 1, sampler.SEED_MOD - 1], SEEDS[:13]])
    ours = sampler.random_bits(torch.from_numpy(seeds), n).numpy()
    for s, row in zip(seeds, ours):
        ref = np.asarray(jax.random.bits(jax.random.PRNGKey(int(s)), (n,),
                                         jnp.uint32))
        np.testing.assert_array_equal(row.astype(np.uint32), ref)


def test_gumbel_matches_jax():
    seeds = SEEDS[:8]
    ours = sampler.gumbel(torch.from_numpy(seeds), 1000).numpy()
    for s, row in zip(seeds, ours):
        ref = np.asarray(jax.random.gumbel(jax.random.PRNGKey(int(s)),
                                           (1000,)))
        np.testing.assert_allclose(row, ref, rtol=1e-6, atol=1e-6)


def test_seed_fold_matches_jax_including_uint32_wrap():
    base = np.array([0, 5, sampler.SEED_MOD - 1, 2 ** 32 - 3, 2 ** 31],
                    np.uint32)
    n_gen = np.array([0, 7, 1, 5, 2 ** 31 - 1], np.int32)
    ref = np.asarray(jax_sampler.fold_seeds(jnp.asarray(base),
                                            jnp.asarray(n_gen)))
    ours = sampler.fold_seeds(torch.from_numpy(base.astype(np.int64)),
                              torch.from_numpy(n_gen))
    assert ours.tolist() == ref.tolist()
    assert sampler.seed_base(123) == jax_sampler.seed_base(123)


@pytest.mark.parametrize("vocab", [5, 256, 1000, 32003])
@pytest.mark.parametrize("mode", ["greedy", "topp", "temp-only"])
def test_batch_sampler_matches_jax_exactly(vocab, mode):
    rng = np.random.default_rng(vocab)
    B = len(SEEDS)
    logits = (rng.standard_normal((B, vocab)) * 3).astype(np.float32)
    # greedy ties resolve to the first index in both
    logits[0, :] = 1.0
    logits[1, vocab // 2:] = logits[1].max() + 1
    temps = np.full((B,), 0.0 if mode == "greedy" else 0.8, np.float32)
    top_ps = np.full((B,), 0.9 if mode == "topp" else 1.0, np.float32)
    top_ps[::5] = 0.5
    seeds = SEEDS.astype(np.int32)
    ref = np.asarray(jax_sampler.sample_tokens(
        jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ps),
        jnp.asarray(seeds)))
    ours = sampler.sample_tokens(logits, temps, top_ps, seeds)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), ref)
    if mode == "greedy":
        assert ours[0] == 0 and ours[1] == vocab // 2


@pytest.mark.parametrize("vocab", [256, 4096])
def test_single_token_sampler_matches_jax(vocab):
    rng = np.random.default_rng(7)
    for i, seed in enumerate(SEEDS[:12]):
        lg = (rng.standard_normal(vocab) * 2).astype(np.float32)
        temp, tp = (0.0, 1.0) if i % 3 == 0 else (0.7, 0.9)
        ref = int(jax_sampler.sample_token(jnp.asarray(lg), temp, tp,
                                           int(seed)))
        ours = int(sampler.sample_token(torch.from_numpy(lg), temp, tp,
                                        int(seed)))
        assert ours == ref, (i, seed)
