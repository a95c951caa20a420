"""The port's threefry subset (flake16_framework_tpu_torch/rng.py) against
jax.random. Grade: bitwise, over a sweep of keys and shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flake16_framework_tpu_torch import rng

SEEDS = [0, 1, 42, 2**31 - 1]


@pytest.fixture(autouse=True)
def _jax_x64_off():
    """Run the JAX package as it runs in production, with 64-bit mode off
    (the test harness turns it on for the sklearn parity suites)."""
    with jax.enable_x64(False):
        yield


def _tk(k):
    return torch.from_numpy(np.asarray(k, dtype=np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(rng.prng_key(seed).numpy(), np.asarray(k))
    for num in (2, 3, 10):
        np.testing.assert_array_equal(
            rng.split(_tk(k), num).numpy(), np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    for d in (0, 5, 215, 99999, 2**32 - 1):
        np.testing.assert_array_equal(
            rng.fold_in(_tk(k), d).numpy(),
            np.asarray(jax.random.fold_in(k, np.uint32(d))))
    ids = jnp.arange(37)
    want = jax.vmap(lambda d: jax.random.fold_in(k, d))(ids)
    np.testing.assert_array_equal(
        rng.fold_in(_tk(k), torch.arange(37)).numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (11, 1)])
def test_uniform_bitwise(seed, shape):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.uniform(k, shape))
    got = rng.uniform(_tk(k), shape).numpy()
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


_randint = jax.jit(lambda k, m: jax.random.randint(k, (64,), 0, m))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("maxval", [0, 1, 5, 37, 1000, 65536, 65537,
                                    2**31 - 1])
def test_randint_traced_maxval(seed, maxval):
    k = jax.random.PRNGKey(seed)
    want = np.asarray(_randint(k, jnp.int32(maxval)))
    got = rng.randint(_tk(k), (64,), 0, torch.tensor(maxval)).numpy()
    np.testing.assert_array_equal(got, want)


def test_batched_keys_match_vmap():
    ks = jax.random.split(jax.random.PRNGKey(3), 4)
    tks = _tk(ks)
    want = jax.vmap(lambda k: jax.random.uniform(k, (6,)))(ks)
    assert rng.uniform(tks, (6,)).numpy().tobytes() == \
        np.asarray(want).tobytes()
    np.testing.assert_array_equal(rng.split(tks).numpy(),
                                  np.asarray(jax.vmap(jax.random.split)(ks)))
    # per-node keys of the hist grower: fold_in(tree key, node id), split
    nk = jax.vmap(lambda d: jax.random.fold_in(ks[1], d))(jnp.arange(9))
    want = jax.vmap(jax.random.split)(nk)
    got = rng.split(rng.fold_in(tks[1], torch.arange(9)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seed_out_of_range_raises():
    with pytest.raises(ValueError):
        rng.prng_key(-1)
