"""SWIM suspicion + Lifeguard on the port's round loops, bit for bit
against JAX.

The port's ``run_rounds`` with ``SimConfig.suspicion`` against JAX
``run_rounds`` on the same keys: lanes (through ``convert.to_numpy``),
carry (``first_suspect`` included) and all six per-round metrics, Lifeguard
off and on (``lh_multiplier > 0``), for

* ``random`` N=256 in config 3's dtypes under crash and rejoin churn (K2);
* ``ring`` N=64 with SUSPECT entries kept as ring targets, under
  scheduled crashes, LEAVE broadcasts and joins;
* aligned and plain ``random_arc`` N=256 under rejoin churn (K4);
* the ``suspicion_rr`` profile (``merge_kernel="pallas_rr"``, random
  edges, all-int8) N=512 under crash and rejoin churn, which the port
  sends to K5's plain version, held against JAX's ``merge_kernel="xla"``
  run (the oracle the JAX suite pins its stripe kernel to);

plus ``gossip_round`` under suspicion, a JAX state carrying SUSPECT lanes
continued in both packages, the configuration checks and profiles, and
the merge-kernel rule.  The lean loop's suspicion form is in
tests/test_torch_suspicion_lean.py.  Every comparison is exact equality:
the protocol arithmetic is integer, and the Lifeguard compare is the same
float32 one.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core import topology as jtopo
from gossipfs_tpu.core.rounds import gossip_round as jax_gossip_round
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import RoundEvents as JaxEvents
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core import topology as ttopo
from gossipfs_tpu_torch.core.rounds import (
    gossip_round, merge_kernel, run_rounds)
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

STATE = ("hb", "age", "status", "alive", "hb_base")
CARRY = ("first_detect", "first_observer", "converged", "first_suspect")
CONFIG3 = dict(topology="random", fanout=8, remove_broadcast=False,
               fresh_cooldown=True, t_cooldown=12, view_dtype="int8",
               hb_dtype="int16", t_fail=3)
HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8", t_fail=3)
# Lifeguard off, and on at a threshold the churn below crosses on some
# rows and not others
LH = {"off": dict(t_suspect=2),
      "on": dict(t_suspect=3, lh_multiplier=4, lh_frac=0.03125)}


def assert_runs_equal(j_out, t_out):
    (js, jc, jm), (ts, tc, tm) = j_out, t_out
    got = to_numpy(ts, tc)
    for k in STATE:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                      err_msg=k)
    for k in CARRY:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jc, k)),
                                      err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert ts.round == int(js.round)


def run_both(kw: dict, sus: dict, rounds: int, seed: int, events=None,
             jax_kw=None, **run):
    """The same suspicion scan in both packages from fresh states;
    ``jax_kw`` overrides the JAX configuration (default: its XLA oracle);
    ``events`` are numpy (crash, leave, join) masks."""
    jcfg = JaxConfig(**{**kw, "merge_kernel": "xla", **(jax_kw or {})},
                     suspicion=JaxSus(**sus))
    tcfg = SimConfig(**kw, suspicion=SuspicionParams(**sus))
    jev = tev = None
    if events is not None:
        jev = JaxEvents(*(jnp.asarray(e) for e in events))
        tev = RoundEvents(*(torch.from_numpy(e) for e in events))
    j_out = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                           jax.random.PRNGKey(seed), events=jev, **run)
    merge.reset_launch_counts()
    t_out = run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                       trandom.PRNGKey(seed, device="cpu"), events=tev, **run)
    assert all(v == 0 for v in merge.LAUNCH_COUNTS.values())  # plain on CPU
    assert_runs_equal(j_out, t_out)
    jm = j_out[2]
    assert int(jnp.sum(jm.suspects_entered)) > 0
    return j_out, t_out


@pytest.mark.parametrize("lh", list(LH))
def test_random_k2_matches_jax(lh):
    cfg = SimConfig(n=256, **CONFIG3)
    assert merge_kernel(cfg) == "fused_merge_update"
    (_, jc, jm), _ = run_both(dict(n=256, **CONFIG3), LH[lh], 40, 5,
                              crash_rate=0.05, rejoin_rate=0.05)
    assert int(jnp.sum(jm.refutations)) > 0
    assert int(jnp.sum(jm.true_detections)) > 0
    assert (np.asarray(jc.first_suspect) >= 0).any()


def test_ring_keeps_suspects_as_targets_and_matches_jax():
    n, rounds = 64, 60
    crash, leave, join = (np.zeros((rounds, n), bool) for _ in range(3))
    crash[5, [3, 9]] = True
    leave[8, [20, 21]] = True
    join[25, [3, 20]] = True
    crash[30, 40] = True
    join[45, [40, 9]] = True
    kw = dict(n=n, remove_broadcast=False, fresh_cooldown=True, t_fail=3)
    (_, _, jm), _ = run_both(kw, LH["off"], rounds, 3,
                             events=(crash, leave, join), crash_rate=0.02)
    assert int(jnp.sum(jm.refutations)) > 0


@pytest.mark.parametrize("lh", list(LH))
@pytest.mark.parametrize("align", [8, 1], ids=["aligned", "plain"])
def test_arcs_under_joins_match_jax(align, lh):
    kw = dict(n=256, **dict(HEADLINE, arc_align=align))
    assert merge_kernel(SimConfig(**kw)) == "arc_merge_update"
    run_both(kw, LH[lh], 40, 7, crash_rate=0.03, rejoin_rate=0.05)


@pytest.mark.parametrize("lh", list(LH))
def test_suspicion_rr_runs_k5_and_matches_the_xla_oracle(lh):
    """The ``suspicion_rr`` profile: every round of its horizon under
    rejoin churn takes the separate-pass round on K5 (the plain version
    here), against the JAX package's XLA run of the same protocol."""
    n = 512
    cfg = SimConfig.suspicion_rr(n, **({} if lh == "off" else
                                       dict(suspicion=SuspicionParams(
                                           **LH[lh]))))
    assert merge_kernel(cfg) == "stripe_merge_update"
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "suspicion"}
    (_, _, jm), _ = run_both(kw, LH[lh], 30, 9, jax_kw=dict(
        merge_kernel="xla"), crash_rate=0.02, rejoin_rate=0.02)
    assert int(jnp.sum(jm.true_detections)) > 0


def test_gossip_round_with_suspicion_matches_jax():
    """The one-round step on the flagship config with suspicion armed:
    crashes, a LEAVE broadcast, quiet rounds through suspect and confirm,
    then rejoins."""
    n = 256
    kw = dict(n=n, topology="random", fanout=SimConfig.log_fanout(n),
              remove_broadcast=False, fresh_cooldown=True, t_fail=3,
              merge_kernel="pallas", view_dtype="int8", hb_dtype="int16")
    jcfg = JaxConfig(**kw, suspicion=JaxSus(t_suspect=2))
    tcfg = SimConfig(**kw, suspicion=SuspicionParams(t_suspect=2))
    js, ts = jax_init_state(jcfg), init_state(tcfg, device="cpu")
    z = np.zeros(n, bool)
    crash, leave = z.copy(), z.copy()
    crash[[3, 50]] = True
    leave[7] = True
    schedule = [(crash, z, z), (z, leave, z)] + [(z, z, z)] * 8 + [
        (z, z, np.isin(np.arange(n), [3, 7]))]
    sus_seen = 0
    for r, ev in enumerate(schedule):
        edges = jtopo.random_in_edges(jax.random.PRNGKey(r), n, tcfg.fanout)
        js, jm, jfail, jfobs = jax_gossip_round(
            js, JaxEvents(*(jnp.asarray(e) for e in ev)), edges, jcfg)
        tedges = ttopo.random_in_edges(trandom.PRNGKey(r, device="cpu"), n,
                                       tcfg.fanout)
        ts, tm, tfail, tfobs = gossip_round(
            ts, RoundEvents(*(torch.from_numpy(e) for e in ev)), tedges, tcfg)
        got = to_numpy(ts)
        for k in STATE:
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"round {r}: {k}")
        for k in jm._fields:
            assert int(getattr(tm, k)) == int(getattr(jm, k)), (r, k)
        np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
        np.testing.assert_array_equal(tfobs.numpy(), np.asarray(jfobs))
        sus_seen += int(jm.suspects_entered)
    assert sus_seen > 0


def test_carried_suspect_lanes_continue_identically():
    """A JAX run stopped with SUSPECT entries in its lanes, converted, and
    continued for 20 rounds in both packages under rejoin churn."""
    n = 256
    kw = dict(n=n, **CONFIG3)
    jcfg = JaxConfig(merge_kernel="xla", **kw, suspicion=JaxSus(t_suspect=3))
    tcfg = SimConfig(**kw, suspicion=SuspicionParams(t_suspect=3))
    key = jax.random.PRNGKey(21)
    js, jc, _ = jax_run_rounds(jax_init_state(jcfg), jcfg, 15, key,
                               crash_rate=0.05)
    assert (np.asarray(js.status) == 3).any()
    x = {k: np.asarray(getattr(js, k)) for k in STATE + ("round",)}
    x.update({k: np.asarray(getattr(jc, k)) for k in CARRY})
    ts, tc = from_jax_arrays(**x, device="cpu")
    np.testing.assert_array_equal(to_numpy(ts)["status"], x["status"])
    j_out = jax_run_rounds(js, jcfg, 20, key, crash_rate=0.03,
                           rejoin_rate=0.1, mcarry0=jc)
    t_out = run_rounds(ts, tcfg, 20, trandom.PRNGKey(21, device="cpu"),
                       crash_rate=0.03, rejoin_rate=0.1, mcarry0=tc)
    assert_runs_equal(j_out, t_out)


def test_suspicion_config_checks_and_profiles_match_jax():
    with pytest.raises(ValueError, match="SuspicionParams"):
        SimConfig(n=64, **HEADLINE, suspicion=object())
    with pytest.raises(ValueError, match="remove_broadcast"):
        SimConfig(n=64, suspicion=SuspicionParams())
    with pytest.raises(ValueError, match="fresh_cooldown"):
        SimConfig(n=64, remove_broadcast=False,
                  suspicion=SuspicionParams())
    with pytest.raises(ValueError, match="AGE_CLAMP"):
        SimConfig(n=64, **dict(HEADLINE, t_fail=10),
                  suspicion=SuspicionParams(t_suspect=9, lh_multiplier=5))
    SimConfig(n=64, **dict(HEADLINE, t_fail=10),
              suspicion=SuspicionParams(t_suspect=9, lh_multiplier=4))
    for bad in (dict(t_suspect=0), dict(lh_multiplier=-1),
                dict(lh_frac=1.0)):
        with pytest.raises(ValueError):
            SuspicionParams(**bad)
    p = SuspicionParams(t_suspect=3, lh_multiplier=4, lh_frac=0.015625)
    assert SuspicionParams.from_json(p.to_json()) == p
    assert p.max_confirm_after(3) == JaxSus(3, 4, 0.015625
                                            ).max_confirm_after(3) == 18
    for name in ("suspicion_rr", "packed_rr"):
        t = getattr(SimConfig, name)(16_384)
        j = getattr(JaxConfig, name)(16_384)
        td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
        assert td == jd, name


def test_merge_kernel_rule():
    """K5 for the explicit edges of stripe-family configurations it
    admits (int8 view, N <= 28,416), K2 for the rest, K4 for arcs."""
    assert merge_kernel(SimConfig.packed_rr(16_384)) == "stripe_merge_update"
    assert merge_kernel(SimConfig.packed_rr(28_416)) == "stripe_merge_update"
    assert merge_kernel(SimConfig.packed_rr(32_768)) == "fused_merge_update"
    stripe = SimConfig(n=4096, topology="random", fanout=6,
                       merge_kernel="pallas_stripe", view_dtype="int8")
    assert merge_kernel(stripe) == "stripe_merge_update"
    assert merge_kernel(dataclasses.replace(
        stripe, view_dtype="int16")) == "fused_merge_update"
    assert merge_kernel(dataclasses.replace(
        stripe, merge_kernel="pallas")) == "fused_merge_update"
    assert merge_kernel(SimConfig(n=64)) == "fused_merge_update"
    assert merge_kernel(SimConfig.headline(1024)) == "arc_merge_update"
