"""The lean loop's SWIM suspicion + Lifeguard form, bit for bit against
JAX.

The port's lean loop (aligned arcs, crash-only; each round one call of the
resident round, here its plain version) with ``SimConfig.suspicion``:

* against the JAX rr scan running its resident-round kernel in interpret
  mode, N=1024 for 20 rounds, Lifeguard off and on (the carried
  per-receiver suspect counts and flags bit 4), lanes, carry and all six
  metrics;
* the Lifeguard stretch really acting (the same horizon with and without
  it parts);
* a tracked-crash ``summarize`` report equal to JAX's, ``ttd_suspect`` and
  ``suspect_to_confirm`` included.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.bench.run import tracked_crash_events as jax_tracked
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.metrics.detection import summarize as jax_summarize
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.bench import tracked_crash_events
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core.rounds import run_rounds
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8", t_fail=3)
# Lifeguard off, and on at a threshold (1/32 of the list) that 1 % crash
# churn at N=1024 crosses on some rows and rounds and not on others
LH = {"off": dict(t_suspect=3),
      "on": dict(t_suspect=3, lh_multiplier=4, lh_frac=0.03125)}


@pytest.mark.parametrize("lh", list(LH))
def test_lean_loop_matches_jax_rr_scan_interpret(lh):
    """The lean loop's suspicion form (the resident round's plain version,
    with the carried suspect counts and flags bit 4 under Lifeguard)
    against the JAX rr scan running its kernel in interpret mode."""
    n, rounds, seed = 1024, 20, 17
    jcfg = JaxConfig(n=n, **HEADLINE, merge_kernel="pallas_rr_interpret",
                     merge_block_c=512, rr_resident="on",
                     suspicion=JaxSus(**LH[lh]))
    tcfg = SimConfig(n=n, **HEADLINE, suspicion=SuspicionParams(**LH[lh]))
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                                jax.random.PRNGKey(seed), crash_rate=0.01)
    merge.reset_launch_counts()
    ts, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                            trandom.PRNGKey(seed, device="cpu"),
                            crash_rate=0.01)
    assert merge.LAUNCH_COUNTS["resident_round"] == 0   # plain on CPU
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert int(jnp.sum(jm.true_detections)) > 0
    assert int(jnp.sum(jm.fp_suppressed)) > 0


def test_lifeguard_stretch_changes_the_lean_run():
    """The same horizon with and without the Lifeguard lane: the stretch
    holds suspects longer, so the two runs part."""
    n = 1024
    outs = {}
    for lh in LH:
        cfg = SimConfig(n=n, **HEADLINE,
                        suspicion=SuspicionParams(**dict(LH["on"],
                                                         lh_multiplier=0
                                                         if lh == "off"
                                                         else 4)))
        outs[lh] = run_rounds(init_state(cfg, device="cpu"), cfg, 20,
                              trandom.PRNGKey(17, device="cpu"),
                              crash_rate=0.01)[2]
    assert (int(outs["on"].true_detections.sum())
            < int(outs["off"].true_detections.sum()))


def test_tracked_crash_report_matches_jax():
    """Tracked crashes on the lean loop under suspicion: an equal
    ``summarize`` report, ``ttd_suspect`` and ``suspect_to_confirm``
    included."""
    n, rounds = 512, 40
    sus = LH["on"]
    jcfg = JaxConfig(n=n, merge_kernel="xla", **HEADLINE,
                     suspicion=JaxSus(**sus))
    tcfg = SimConfig(n=n, **HEADLINE, suspicion=SuspicionParams(**sus))
    jev, jcr, jok = jax_tracked(jcfg, rounds, 6, 10)
    tev, tcr, tok = tracked_crash_events(tcfg, rounds, 6, 10, device="cpu")
    _, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                               jax.random.PRNGKey(4), events=jev,
                               crash_rate=0.01, churn_ok=jok,
                               crash_only_events=True)
    _, tc, tm = run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                           trandom.PRNGKey(4, device="cpu"), events=tev,
                           crash_rate=0.01, churn_ok=tok,
                           crash_only_events=True)
    want = jax_summarize(jc, jm, jcr).as_dict()
    got = summarize(tc, tm, tcr).as_dict()
    assert got == want
    assert len(got["suspect_to_confirm"]) == len(jcr)
    assert got["fp_suppressed"] > 0
