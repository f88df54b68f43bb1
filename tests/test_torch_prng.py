"""Port parity: ``repro_torch.prng`` against ``jax.random`` (threefry2x32,
partitionable layout, JAX's default), bit for bit.

The inputs are numpy draws from fixed seeds. Integer draws (keys, bits,
``randint``) are exact integer arithmetic in both packages. The float
draws are too: ``uniform`` sets mantissa bits and scales once, and
``gumbel``'s logarithms follow the polynomial that JAX's CPU backend
evaluates, so every value is bitwise JAX's, and ``categorical`` picks
the same index.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax._src import prng as jax_prng

from repro_torch import prng

SEEDS = (0, 7, 2 ** 31 - 1, 123456789)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _words(*shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, shape, dtype=np.uint64).astype(np.uint32)


def _np(a) -> np.ndarray:
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def _key_np(k: torch.Tensor) -> np.ndarray:
    return k.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", range(3))
def test_threefry2x32_matches_jax(seed):
    k1, k2, x1, x2 = (_words(1000, seed=seed * 4 + i) for i in range(4))
    want = jax_prng.threefry2x32_p.bind(*map(jnp.asarray, (k1, k2, x1, x2)))
    got = prng.threefry2x32(*(torch.from_numpy(a.astype(np.int64))
                              for a in (k1, k2, x1, x2)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_fold_in_split_match_jax(seed):
    key = jax.random.PRNGKey(seed)
    k = prng.key(seed)
    np.testing.assert_array_equal(_key_np(k), np.asarray(key))
    data = np.array([0, 1, 5, 30521, 2 ** 31 - 1], np.int64)
    want = np.stack([np.asarray(jax.random.fold_in(key, int(x)))
                     for x in data])
    np.testing.assert_array_equal(
        _key_np(prng.fold_in(k, torch.from_numpy(data))), want)
    for num in (2, 3):
        np.testing.assert_array_equal(_key_np(prng.split(k, num)),
                                      np.asarray(jax.random.split(key, num)))
    # a chain of splits, as LMDecoder walks it
    for _ in range(4):
        key, sub = jax.random.split(key)
        k, s = prng.split(k)
        np.testing.assert_array_equal(_key_np(s), np.asarray(sub))
    np.testing.assert_array_equal(_key_np(k), np.asarray(key))


@pytest.mark.parametrize("bits,dtype", [(8, jnp.uint8), (16, jnp.uint16),
                                        (32, jnp.uint32)])
@pytest.mark.parametrize("shape", [(1,), (7,), (4, 33)])
def test_random_bits_match_jax(bits, dtype, shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(key, shape, dtype)).astype(np.int64)
    got = prng.random_bits(torch.from_numpy(np.asarray(key).astype(
        np.int64)), bits, shape)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("beta", [8, 400])
@pytest.mark.parametrize("lam", [128, 6000])
def test_randint_matches_jax_at_the_builders_shapes(beta, lam):
    """The builder's draws: list l keyed by fold_in(PRNGKey(seed), l),
    positions in [0, max(min(cnt, lam), 1)) for counts of 0, 1, below
    and above lam."""
    counts = np.array([0, 1, 2, 3, lam // 3, lam - 1, lam, lam + 1,
                       5 * lam, 70000, 1 << 20], np.int64)
    seed = 5
    key = jax.random.PRNGKey(seed)
    hi = np.maximum(np.minimum(counts, lam), 1)
    want = jax.vmap(lambda i, c: jax.random.randint(
        jax.random.fold_in(key, i), (beta,), 0, c))(
        jnp.arange(counts.size), jnp.asarray(hi, jnp.int32))
    keys = prng.fold_in(prng.key(seed), torch.arange(counts.size))
    got = prng.randint(keys, (beta,), 0, torch.from_numpy(hi)[:, None])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.min()) >= 0 and (got.numpy() < hi[:, None]).all()


@pytest.mark.parametrize("lo,hi", [(0, 1), (-5, 5), (3, 2), (7, 7),
                                   (-2 ** 31, 2 ** 31 - 1), (0, 65537)])
def test_randint_matches_jax_over_ranges(lo, hi):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.randint(key, (1000,), lo, hi))
    got = prng.randint(prng.key(9), (1000,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0)])
@pytest.mark.parametrize("seed", SEEDS[:2])
def test_uniform_matches_jax(dtype, lo, hi, seed):
    jdt, tdt = DTYPES[dtype]
    want = _np(jax.random.uniform(jax.random.PRNGKey(seed), (20000,), jdt,
                                  lo, hi))
    got = prng.uniform(prng.key(seed), (20000,), tdt, lo, hi)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_matches_jax(dtype, seed):
    jdt, tdt = DTYPES[dtype]
    want = _np(jax.random.gumbel(jax.random.PRNGKey(seed), (100000,), jdt))
    got = prng.gumbel(prng.key(seed), (100000,), tdt)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("vocab", [50, 32000])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_matches_jax(dtype, vocab, seed):
    jdt, tdt = DTYPES[dtype]
    logits = (np.random.default_rng(seed).normal(size=(8, vocab)) * 3) \
        .astype(np.float32)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 1)
    want = np.asarray(jax.random.categorical(key, jnp.asarray(logits, jdt)))
    got = prng.categorical(torch.from_numpy(np.asarray(key).astype(
        np.int64)), torch.from_numpy(logits).to(tdt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_keys_draw_as_each_key_alone():
    """Keys in a batch draw as each key alone does."""
    keys = prng.fold_in(prng.key(1), torch.arange(6))
    batch = prng.randint(keys, (5,), 0, 100)
    for i in range(6):
        assert torch.equal(batch[i], prng.randint(keys[i], (5,), 0, 100))
    with pytest.raises(ValueError, match="bit width"):
        prng.random_bits(keys, 64, (2,))
    with pytest.raises(ValueError, match="dtype"):
        prng.uniform(keys[0], (2,), torch.float16)
