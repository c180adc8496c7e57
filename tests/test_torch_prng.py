"""The port's threefry sampler (``repro_torch/utils/prng.py``) against
``jax.random``: keys, ``fold_in`` and the partitionable ``random_bits``
bitwise; ``uniform`` bitwise; ``gumbel`` within 1e-6 (torch's and XLA's
``log`` may differ in the last bit); ``categorical`` equal on every row
whose two largest perturbed logits are more than 1e-4 apart (asserted
first: on a near tie the two ``log``s may pick different rows).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.utils import prng

torch.set_num_threads(1)

assert jax.config.jax_threefry_partitionable, \
    "the port reproduces the partitionable threefry layout"


def _jax_key(words) -> jax.Array:
    return jnp.asarray(np.asarray(words, np.uint32))


def _keys(n, seed=42):
    """n JAX keys fold_in(PRNGKey(seed), i) and their port twins."""
    jk = np.stack([np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 i)) for i in range(n)])
    return jk, torch.from_numpy(jk.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, -5])
def test_prng_key_is_jax_prngkey(seed):
    want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
    np.testing.assert_array_equal(prng.prng_key(seed).numpy(), want)


def test_prng_key_refuses_wider_seeds():
    with pytest.raises(ValueError):
        prng.prng_key(2 ** 32)


@pytest.mark.parametrize("data", [0, 1, 7, 123456, 2 ** 31, 2 ** 32 - 1])
def test_fold_in_is_bitwise_jax(data):
    key = jax.random.PRNGKey(42)
    want = np.asarray(jax.random.fold_in(key, data)).astype(np.int64)
    got = prng.fold_in(prng.prng_key(42), data)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fold_in_vectorises_over_rows():
    """[B] keys and [B] positions fold in one pass, row i equal to JAX's
    fold_in(key_i, pos_i); int32 positions as the serving state holds
    them."""
    jk, tk = _keys(6)
    pos = np.array([0, 3, 17, 99, 4095, 7], np.int32)
    want = np.stack([np.asarray(jax.random.fold_in(_jax_key(jk[i]),
                                                   int(pos[i])))
                     for i in range(6)]).astype(np.int64)
    got = prng.fold_in(tk, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097])
def test_random_bits_are_bitwise_jax(n):
    jk, tk = _keys(3)
    want = np.stack([np.asarray(jax.random.bits(_jax_key(k), (n,)))
                     for k in jk]).astype(np.int64)
    got = prng.random_bits(tk, n)
    assert got.shape == (3, n) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("minval", [0.0, float(np.finfo(np.float32).tiny)])
def test_uniform_is_bitwise_jax(minval):
    jk, tk = _keys(4)
    n = 5000
    want = np.stack([np.asarray(jax.random.uniform(_jax_key(k), (n,),
                                                   minval=minval))
                     for k in jk])
    got = prng.uniform(tk, n, minval=minval)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_gumbel_within_1e6_of_jax():
    jk, tk = _keys(8)
    n = 20000
    want = np.stack([np.asarray(jax.random.gumbel(_jax_key(k), (n,)))
                     for k in jk])
    got = prng.gumbel(tk, n).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _top2_gap(z: np.ndarray) -> np.ndarray:
    part = np.sort(z, axis=-1)
    return part[..., -1] - part[..., -2]


@pytest.mark.parametrize("temperature", [0.8, 1.0])
def test_categorical_equals_jax_away_from_ties(temperature):
    """64 rows of a 151936-entry vocabulary (qwen3's), each with its own
    fold_in(fold_in(PRNGKey(42), rid), pos), as the serving plane keys
    them."""
    rows, V = 64, 151936
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((rows, V)) * 2.0).astype(np.float32)
    scaled = logits / np.float32(temperature)
    base = jax.random.PRNGKey(42)
    pos = rng.integers(0, 4096, rows)
    jkeys = np.stack([np.asarray(jax.random.fold_in(
        jax.random.fold_in(base, r), int(pos[r]))) for r in range(rows)])
    tkeys = torch.from_numpy(jkeys.astype(np.int64))
    z = prng.gumbel(tkeys, V).numpy() + scaled
    assert _top2_gap(z).min() > 1e-4
    want = np.array([int(jax.random.categorical(_jax_key(jkeys[r]),
                                                jnp.asarray(scaled[r])))
                     for r in range(rows)])
    got = prng.categorical(tkeys, torch.from_numpy(scaled)).numpy()
    np.testing.assert_array_equal(got, want)


def test_categorical_draws_only_unmasked_entries():
    """-inf logits (top-k's mask) are never drawn; two equal finite ones
    are each drawn for some of 32 keys."""
    _, tk = _keys(32)
    logits = torch.full((32, 16), float("-inf"))
    logits[:, 5] = logits[:, 9] = 0.0
    assert set(prng.categorical(tk, logits).tolist()) == {5, 9}
