"""The port's state and topology against the JAX package, bit for bit.

``init_state`` (with and without a member mask), aligned and plain arc
bases, the explicit arc edges and ``churn_masks``, from the same keys.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core import topology as jtopo
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.core.state import member_counts as jax_member_counts
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.core import topology as ttopo
from gossipfs_tpu_torch.core.rounds import rr_packed_init
from gossipfs_tpu_torch.core.state import init_state, member_counts

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")


@pytest.mark.parametrize("masked", [False, True])
def test_init_state_matches_jax(masked):
    n = 256
    mask = np.random.default_rng(2).random(n) < 0.7 if masked else None
    jst = jax_init_state(JaxConfig(n=n, **HEADLINE),
                         None if mask is None else jnp.asarray(mask))
    cfg = SimConfig(n=n, **HEADLINE)
    tst = init_state(cfg, None if mask is None else torch.from_numpy(mask),
                     device="cpu")
    for name in ("hb", "age", "status", "alive", "hb_base"):
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert tst.round == int(jst.round) == 0
    np.testing.assert_array_equal(member_counts(tst).numpy(),
                                  np.asarray(jax_member_counts(jst)))
    hb, asl, alive, hb_base, rnd, counts = rr_packed_init(
        cfg, None if mask is None else torch.from_numpy(mask), device="cpu")
    np.testing.assert_array_equal(counts.numpy(),
                                  np.asarray(jax_member_counts(jst)))
    assert torch.equal(asl, tst.asl) and rnd == 0


@pytest.mark.parametrize("n,fanout,align", [
    (2048, 16, 8), (512, 16, 8), (16384, 16, 8), (1024, 32, 8), (512, 8, 4),
])
@pytest.mark.parametrize("seed", [0, 5, 123])
def test_aligned_arc_bases_match_jax(n, fanout, align, seed):
    jk = jax.random.PRNGKey(seed)
    want = np.asarray(jtopo.random_arc_bases_aligned(jk, n, fanout, align))
    got = ttopo.random_arc_bases_aligned(trandom.PRNGKey(seed, device="cpu"),
                                         n, fanout,
                                         align)
    np.testing.assert_array_equal(got.numpy(), want)
    cfg_kw = dict(HEADLINE, fanout=fanout, arc_align=align)
    np.testing.assert_array_equal(
        ttopo.in_edges(SimConfig(n=n, **cfg_kw),
                       trandom.PRNGKey(seed, device="cpu")).numpy(),
        np.asarray(jtopo.in_edges(JaxConfig(n=n, **cfg_kw), jk, None)))
    np.testing.assert_array_equal(ttopo.arc_edges(got, fanout).numpy(),
                                  np.asarray(jtopo.arc_edges(want, fanout)))


@pytest.mark.parametrize("n,fanout", [(512, 16), (2048, 11), (100, 3)])
@pytest.mark.parametrize("seed", [1, 77])
def test_plain_arc_bases_match_jax(n, fanout, seed):
    want = np.asarray(jtopo.random_arc_bases(jax.random.PRNGKey(seed), n,
                                             fanout))
    got = ttopo.random_arc_bases(trandom.PRNGKey(seed, device="cpu"), n,
                                 fanout)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("crash_rate,rejoin_rate", [
    (0.01, 0.0), (0.3, 0.2), (0.0, 0.5),
])
@pytest.mark.parametrize("seed", [0, 9])
def test_churn_masks_match_jax(crash_rate, rejoin_rate, seed):
    n = 4000
    alive = np.random.default_rng(seed).random(n) < 0.8
    jc, jj = jtopo.churn_masks(jax.random.PRNGKey(seed), jnp.asarray(alive),
                               crash_rate, rejoin_rate)
    tc, tj = ttopo.churn_masks(trandom.PRNGKey(seed, device="cpu"),
                               torch.from_numpy(alive),
                               crash_rate, rejoin_rate)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tj.numpy(), np.asarray(jj))


def test_config_fields_and_defaults_match_jax():
    """Same field names and defaults, so configurations compare field
    for field; the semantic validation rejects the same values."""
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(SimConfig)}
    assert jf == tf
    for bad in (dict(n=1), dict(fanout=0), dict(topology="ring", fanout=4),
                dict(arc_align=3), dict(t_fail=63),
                dict(hb_dtype="int8", view_dtype="int16", topology="random"),
                dict(topology="random", fanout=2, view_dtype="int8",
                     t_fail=30)):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            SimConfig(**bad)
