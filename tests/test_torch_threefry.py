"""The port's threefry sampler (``repro_torch.models.threefry``) against
``jax.random`` (threefry2x32, ``jax_threefry_partitionable`` on), bit for
bit on the CPU: keys, folded keys over a grid of (seed, uid, draw) that
includes draws of 2^16 and more, random bits, uniforms, Gumbels, the log
they go through, categorical draws, and ``lm.sample_token`` against the
JAX package's."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jax_lm
from repro_torch.models import lm as t_lm
from repro_torch.models import threefry as tf

SEEDS = [0, 11, 12, 2 ** 31 - 1, 4_000_000_000, -5]
UIDS = [0, 3, 70_000, 2 ** 31 - 1]
DRAWS = [0, 1, 5, 2 ** 16, 2 ** 16 + 1, 123_456, 2 ** 31 - 1]
V = 4099            # odd, so the counter pairs do not split evenly


def jax_key(seed, uid, draw):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 uid), draw)


def t_keys(seed, uids, draws):
    uids = torch.tensor(uids, dtype=torch.int64)
    draws = torch.tensor(draws, dtype=torch.int64)
    return tf.fold_in(tf.fold_in(tf.prng_key(seed), uids), draws)


def test_threefry2x32_known_answers():
    """The Random123 known-answer vectors of Threefry-2x32 with 20 rounds
    (the ones JAX's own tests use)."""
    cases = [((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
              (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
              (0xC4923A9C, 0x483DF7A0))]
    for (k1, k2), (x1, x2), want in cases:
        got = tf.threefry2x32(*(torch.tensor(v, dtype=torch.int64)
                                for v in (k1, k2, x1, x2)))
        assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    assert tf.prng_key(seed).tolist() == \
        np.asarray(jax.random.PRNGKey(seed)).tolist()
    grid = list(itertools.product(UIDS, DRAWS))
    want = np.stack([np.asarray(jax_key(seed, u, d)) for u, d in grid])
    got = t_keys(seed, [u for u, _ in grid], [d for _, d in grid])
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_fold_in_takes_an_int():
    key = tf.prng_key(7)
    assert tf.fold_in(key, 3).tolist() == \
        np.asarray(jax.random.fold_in(jax.random.PRNGKey(7), 3)).tolist()


def test_prng_key_rejects_wider_seeds():
    with pytest.raises(ValueError):
        tf.prng_key(2 ** 32)


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_gumbel_match_jax(seed):
    """Each (uid, draw) row of the grid: ``random_bits``, ``uniform`` at
    both ranges ``sample_token`` and ``jax.random.uniform`` use, and
    ``gumbel``, equal to jax.random's bit for bit."""
    tiny = float(np.finfo(np.float32).tiny)
    keys = t_keys(seed, [u for u in UIDS for _ in DRAWS],
                  [d for _ in UIDS for d in DRAWS])
    bits, u0 = tf.random_bits(keys, V), tf.uniform(keys, V)
    ut, g = tf.uniform(keys, V, minval=tiny), tf.gumbel(keys, V)
    for row, (uid, draw) in enumerate(itertools.product(UIDS, DRAWS)):
        k = jax_key(seed, uid, draw)
        np.testing.assert_array_equal(
            bits[row].numpy(), np.asarray(jax.random.bits(k, (V,)))
            .astype(np.int64))
        np.testing.assert_array_equal(
            u0[row].numpy(), np.asarray(jax.random.uniform(k, (V,))))
        np.testing.assert_array_equal(
            ut[row].numpy(),
            np.asarray(jax.random.uniform(k, (V,), minval=tiny,
                                          maxval=1.0)))
        np.testing.assert_array_equal(
            g[row].numpy(), np.asarray(jax.random.gumbel(k, (V,))))


def test_xla_log_matches_jax_log():
    """``xla_log`` is XLA's float32 log on the CPU bit for bit, over the
    ranges the Gumbel transform feeds it ([tiny, 1) and (0, 88]), and it
    is not ``torch.log`` (which rounds otherwise in a share of cases)."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    x = np.concatenate([
        rng.random(200_000).astype(f32),
        rng.uniform(0, 90, 50_000).astype(f32),
        (np.arange(1, 4096) * 2.0 ** -23).astype(f32),
        (1 - np.arange(1, 1024) * 2.0 ** -24).astype(f32),
        np.array([np.finfo(f32).tiny, 1e-30, 1e-10, 0.5, 0.70710677,
                  0.7071068, 1.0, 2.0, 87.33655], f32)])
    x = x[x > 0]
    want = np.asarray(jax.jit(jnp.log)(x))
    got = tf.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (torch.log(torch.from_numpy(x)).numpy() != want).any()


@pytest.mark.parametrize("seed", [11, 12])
def test_categorical_matches_jax(seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((len(UIDS), V)).astype(np.float32) * 3
    for draw in DRAWS:
        keys = t_keys(seed, UIDS, [draw] * len(UIDS))
        got = tf.categorical(keys, torch.from_numpy(logits)).tolist()
        want = [int(jax.random.categorical(jax_key(seed, u, draw), row))
                for u, row in zip(UIDS, logits)]
        assert got == want, (seed, draw, got, want)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_matches_jax(temperature):
    """``lm.sample_token`` against the JAX package's (vmapped over rows,
    jitted as inside its megastep): greedy argmax and threefry draws."""
    rng = np.random.default_rng(5)
    B = 6
    logits = (rng.standard_normal((B, V)) * 4).astype(np.float32)
    uids = rng.integers(0, 2 ** 31 - 1, B).astype(np.int32)
    draws = np.array([0, 1, 7, 2 ** 16, 99_999, 3], np.int32)
    f = jax.jit(lambda lg, u, d: jax_lm.sample_token(
        lg, u, d, temperature=temperature, seed=21))
    want = np.asarray(f(logits, uids, draws))
    got = t_lm.sample_token(torch.from_numpy(logits), torch.from_numpy(uids),
                            torch.from_numpy(draws),
                            temperature=temperature, seed=21)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
