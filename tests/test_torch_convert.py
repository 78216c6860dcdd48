"""Carrying a run across the two packages (gossipfs_tpu_torch/convert.py).

A JAX run for 40 rounds, converted, continues for 40 more rounds in both
packages (with the metrics carry threaded through ``mcarry0``): the two
continuations are bit-identical.  And ``to_numpy`` inverts
``from_jax_arrays``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")
STATE = ("hb", "age", "status", "alive", "hb_base", "round")
CARRY = ("first_detect", "first_observer", "converged", "first_suspect")


def _jax_fields(st, carry) -> dict:
    out = {k: np.asarray(getattr(st, k)) for k in STATE}
    out.update({k: np.asarray(getattr(carry, k)) for k in CARRY})
    return out


def test_state_carries_across_and_continues_identically():
    n = 512
    jcfg = JaxConfig(n=n, merge_kernel="xla", **HEADLINE)
    tcfg = SimConfig(n=n, **HEADLINE)
    key = jax.random.PRNGKey(23)
    st, carry, _ = jax_run_rounds(jax_init_state(jcfg), jcfg, 40, key,
                                  crash_rate=0.02)
    x = _jax_fields(st, carry)
    tst, tcarry = from_jax_arrays(**x, device="cpu")
    assert tst.round == 40
    # both sides continue from round 40 with the same key and carry
    js, jc, jm = jax_run_rounds(st, jcfg, 40, key, crash_rate=0.02,
                                mcarry0=carry)
    ts, tc, tm = run_rounds(tst, tcfg, 40, trandom.PRNGKey(23, device="cpu"),
                            crash_rate=0.02, mcarry0=tcarry)
    want = _jax_fields(js, jc)
    got = to_numpy(ts, tc)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for f in jm._fields:
        np.testing.assert_array_equal(getattr(tm, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert (want["first_detect"] >= 40).any()   # detections after the hop


@pytest.mark.parametrize("seed", [0, 1])
def test_to_numpy_inverts_from_jax_arrays(seed):
    rng = np.random.default_rng(seed)
    n = 64
    x = {
        "hb": rng.integers(-128, 128, (n, n), dtype=np.int8),
        "age": rng.integers(0, 64, (n, n), dtype=np.int8),
        "status": rng.integers(0, 4, (n, n), dtype=np.int8),
        "alive": rng.random(n) < 0.5,
        "hb_base": rng.integers(0, 1000, n).astype(np.int32),
        "round": np.int32(rng.integers(0, 10_000)),
    }
    x.update({k: rng.integers(-1, 500, n).astype(np.int32) for k in CARRY})
    st, carry = from_jax_arrays(**x, device="cpu")
    back = to_numpy(st, carry)
    assert set(back) == set(x)
    for k, v in x.items():
        assert back[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)
    st2, none = from_jax_arrays(**{k: x[k] for k in STATE}, device="cpu")
    assert none is None
    assert set(to_numpy(st2)) == set(STATE)


@pytest.mark.parametrize("hb_dtype", ["int8", "int16", "int32"])
def test_round_trip_from_jax_init_state_every_hb_dtype(hb_dtype):
    """JAX ``init_state`` (a partial cohort) carried over and back, for
    each heartbeat lane dtype: the dtype survives, and the carried state
    equals the port's own ``init_state``."""
    n = 96
    kw = dict(n=n, topology="random", fanout=4, view_dtype="int8",
              hb_dtype=hb_dtype)
    mask = np.random.default_rng(4).random(n) < 0.7
    jst = jax_init_state(JaxConfig(**kw), jax.numpy.asarray(mask))
    x = {k: np.asarray(getattr(jst, k)) for k in STATE}
    tst, carry = from_jax_arrays(**x, device="cpu")
    assert carry is None and tst.hb.dtype == getattr(torch, hb_dtype)
    back = to_numpy(tst)
    for k in STATE:
        assert back[k].dtype == x[k].dtype, k
        np.testing.assert_array_equal(back[k], x[k], err_msg=k)
    own = init_state(SimConfig(**kw), torch.from_numpy(mask), device="cpu")
    assert torch.equal(own.hb, tst.hb) and torch.equal(own.asl, tst.asl)
