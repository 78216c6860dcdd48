"""The port's threefry generator against ``jax.random``, bit for bit.

Partitionable threefry (tests/conftest.py sets it): keys, ``split``,
``fold_in``, int32 ``randint`` over the ranges the round loop draws and
float32 ``uniform``, over a grid of seeds, shapes and key batches.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu_torch import random as trandom

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

SEEDS = [0, 17, 2**31 - 1, -3]


def jkey_data(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in(seed):
    jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
    np.testing.assert_array_equal(tk.numpy(), jkey_data(jk))
    for num in (2, 3, 7):
        np.testing.assert_array_equal(trandom.split(tk, num).numpy(),
                                      jkey_data(jax.random.split(jk, num)))
    for data in (0, 1, 299, 2**31 - 1):
        np.testing.assert_array_equal(
            trandom.fold_in(tk, data).numpy(),
            jkey_data(jax.random.fold_in(jk, data)))


@pytest.mark.parametrize("seed", SEEDS)
def test_batched_keys_match_per_key_draws(seed):
    """The round loop's batched pass: fold_in over a vector of rounds,
    then split, then one draw per key, equals jax key by key."""
    rounds = np.arange(5, 13)
    tk = trandom.split(trandom.fold_in(trandom.PRNGKey(seed, device="cpu"),
                                       torch.from_numpy(rounds)))
    t_draw = trandom.randint(tk[:, 0], (96,), 0, 12)
    t_unif = trandom.uniform(tk[:, 1], (96,))
    for i, r in enumerate(rounds):
        k_edge, k_churn = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed), int(r)))
        np.testing.assert_array_equal(tk[i, 0].numpy(), jkey_data(k_edge))
        np.testing.assert_array_equal(
            t_draw[i].numpy(),
            np.asarray(jax.random.randint(k_edge, (96,), 0, 12, jnp.int32)))
        np.testing.assert_array_equal(
            t_unif[i].numpy().view(np.int32),
            np.asarray(jax.random.uniform(k_churn, (96,))).view(np.int32))


@pytest.mark.parametrize("lo,hi", [
    (0, 2048 // 8), (0, 2048 - 16), (0, 512 // 8), (0, 16384 // 8),
    (0, 65536 - 16), (-7, 9), (0, 2**31 - 1), (5, 6),
])
@pytest.mark.parametrize("shape", [(1,), (33,), (4, 50)])
def test_randint_int32(lo, hi, shape):
    for seed in (1, 99):
        jk, tk = jax.random.PRNGKey(seed), trandom.PRNGKey(seed, device="cpu")
        want = np.asarray(jax.random.randint(jk, shape, lo, hi, jnp.int32))
        got = trandom.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (1000,), (7, 31)])
def test_uniform_float32(shape):
    for seed in SEEDS:
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
        got = trandom.uniform(trandom.PRNGKey(seed, device="cpu"), shape)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy().view(np.int32),
                                      want.view(np.int32))


def test_bad_bounds_and_seeds_raise():
    with pytest.raises(ValueError):
        trandom.randint(trandom.PRNGKey(0, device="cpu"), (3,), 5, 5)
    with pytest.raises(ValueError):
        trandom.PRNGKey(2**31, device="cpu")
