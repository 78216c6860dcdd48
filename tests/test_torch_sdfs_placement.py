"""The port's tensor placement (``sdfs/placement.py``) against the JAX
package's, bit for bit, on the CPU.

* ``random.randint`` with a 0-d tensor bound equals ``jax.random.randint``
  with a traced ``maxval`` (an empty count included: jax's span-1 rule);
* ``first_k_distinct`` and ``sample_members`` equal the JAX functions on
  the same draws and masks (an empty mask gives -1 rows);
* ``place_batch`` returns the JAX indices under both methods over many
  seeds at N up to ``BATCH_GUMBEL_MAX_N`` (the Gumbel ranking by uniform
  bits included), with short and empty masks padding -1, and ``"auto"``
  switching at the same N;
* the host copies (``place``, ``place_batch_np``) equal the JAX package's
  under the same generators.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.sdfs import placement as jp
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.sdfs import placement as tp

torch.set_num_threads(1)


def tkey(seed: int) -> torch.Tensor:
    return trandom.PRNGKey(seed, device="cpu")


@jax.jit
def _j_randint(key, bound):
    return jax.random.randint(key, (7, 33), 0, bound)


@pytest.mark.parametrize("bound", [0, 1, 2, 3, 1000, 99_991, 2**31 - 1])
def test_randint_tensor_bound_matches_traced_jax(bound):
    for seed in (0, 5, 2**31 - 1):
        want = np.asarray(_j_randint(jax.random.PRNGKey(seed),
                                     jnp.int32(bound)))
        got = trandom.randint(tkey(seed), (7, 33), 0,
                              torch.tensor(bound, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)
        if bound > 0:
            # the tensor bound and the Python-int bound agree
            np.testing.assert_array_equal(
                got.numpy(), trandom.randint(tkey(seed), (7, 33), 0,
                                             bound).numpy())


@pytest.mark.parametrize("seed", range(4))
def test_first_k_distinct_matches_jax(seed):
    rng = np.random.default_rng(seed)
    nodes = rng.integers(-1, 6, size=(40, 24)).astype(np.int32)
    for k in (1, 4, 6, 24):
        want = np.asarray(jp.first_k_distinct(jnp.asarray(nodes), k))
        got = tp.first_k_distinct(torch.from_numpy(nodes), k).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("frac", [0.0, 0.003, 0.5, 1.0])
def test_sample_members_matches_jax(frac):
    n = 1000
    for seed in range(3):
        mask = np.random.default_rng(seed).random(n) < frac
        want = np.asarray(jp.sample_members(jax.random.PRNGKey(seed),
                                            jnp.asarray(mask), 17, 32))
        got = tp.sample_members(tkey(seed), torch.from_numpy(mask), 17, 32)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32
        if not mask.any():
            assert (got == -1).all()


_jplace = jax.jit(jp.place_batch, static_argnums=(2, 3, 4))


@pytest.mark.parametrize("method", ["gumbel", "sampled"])
@pytest.mark.parametrize("n,frac", [(16, 1.0), (300, 0.9), (3000, 0.5),
                                    (8192, 0.97)])
def test_place_batch_matches_jax_over_seeds(method, n, frac):
    """The indices JAX returns, seed after seed (12 each), at N up to
    BATCH_GUMBEL_MAX_N: the Gumbel method ranks by the uniform bits."""
    assert n <= tp.BATCH_GUMBEL_MAX_N == jp.BATCH_GUMBEL_MAX_N
    for seed in range(12):
        alive = np.random.default_rng(1000 + seed).random(n) < frac
        want = np.asarray(_jplace(jax.random.PRNGKey(seed),
                                  jnp.asarray(alive), 24, 4, method))
        got = tp.place_batch(tkey(seed), torch.from_numpy(alive), 24, 4,
                             method=method)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got.dtype == torch.int32


@pytest.mark.parametrize("method", ["gumbel", "sampled"])
@pytest.mark.parametrize("n_alive", [0, 1, 3, 4, 5])
def test_place_batch_short_masks(method, n_alive):
    """Fewer live nodes than replicas: -1 pads the dead slots, as in the
    JAX package (an empty mask gives all -1)."""
    n = 64
    alive = np.zeros(n, dtype=bool)
    alive[np.random.default_rng(n_alive).permutation(n)[:n_alive]] = True
    for seed in range(4):
        want = np.asarray(_jplace(jax.random.PRNGKey(seed),
                                  jnp.asarray(alive), 24, 4, method))
        got = tp.place_batch(tkey(seed), torch.from_numpy(alive), 24, 4,
                             method=method).numpy()
        np.testing.assert_array_equal(got, want)
        assert ((got >= 0).sum(axis=1) <= n_alive).all()
        if method == "gumbel":
            assert ((got >= 0).sum(axis=1) == min(n_alive, 4)).all()


def test_auto_switches_at_the_same_n():
    for n in (tp.BATCH_GUMBEL_MAX_N, tp.BATCH_GUMBEL_MAX_N + 1):
        alive = np.ones(n, dtype=bool)
        want = np.asarray(jp.place_batch(jax.random.PRNGKey(3),
                                         jnp.asarray(alive), 5))
        got = tp.place_batch(tkey(3), torch.from_numpy(alive), 5)
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="unknown placement method"):
        tp.place_batch(tkey(0), torch.ones(8, dtype=torch.bool), 2,
                       method="bogus")


def test_host_copies_match_jax():
    members = list(range(3, 40, 3))
    for seed in range(5):
        assert tp.place(members, random.Random(seed)) == \
            jp.place(members, random.Random(seed))
        assert tp.place(members[:3], random.Random(seed)) == members[:3]
        np.testing.assert_array_equal(
            tp.place_batch_np(np.random.default_rng(seed),
                              np.asarray(members), 9),
            jp.place_batch_np(np.random.default_rng(seed),
                              np.asarray(members), 9))
    assert tp.place_batch_np(np.random.default_rng(0), np.asarray([]),
                             3).shape == (3, 0)
