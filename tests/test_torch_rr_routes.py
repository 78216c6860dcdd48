"""The rr production profile on the lean loop: the XLA oracle, the reports,
the separate-pass twin and the routing rule.

* the lean loop on ``packed_rr``, ``suspicion_rr`` (Lifeguard off and on)
  and plain arcs against the JAX package's ``merge_kernel="xla"`` run of
  the same protocol: lanes, carry and all six metrics equal;
* a tracked-crash ``summarize`` report equal to JAX's, and the frontier
  entry point's report on a padded literal N equal to JAX's on the same
  padded cohort;
* the lean loop equal to the port's own separate-pass loop on the same
  configuration (the loop for every configuration the lean loop does not
  take), which computes the same function;
* the routing rule: every configuration ``_lean_ok`` admits has a form the
  CUDA resident round launches, ``arc_align != 8`` arcs included (the
  kernel takes them as plain arcs), and a ragged N takes the
  separate-pass round.
"""

from __future__ import annotations

import dataclasses

import jax
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
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
from gossipfs_tpu_torch.frontier import frontier_config
from gossipfs_tpu_torch.frontier import run as run_frontier
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

LH_ON = dict(t_suspect=3, lh_multiplier=4, lh_frac=0.03125)
# name -> (factory, overrides, JAX suspicion, port suspicion)
PROFILES = {
    "packed_rr": ("packed_rr", {}, None, None),
    "suspicion_rr": ("suspicion_rr", {}, None, None),
    "suspicion_rr lh": ("suspicion_rr", {}, JaxSus(**LH_ON),
                        SuspicionParams(**LH_ON)),
    "plain arcs": ("packed_rr", dict(topology="random_arc", fanout=16),
                   None, None),
}


def configs(name: str, n: int):
    factory, over, jsus, tsus = PROFILES[name]
    jkw, tkw = dict(over), dict(over)
    if jsus is not None:
        jkw["suspicion"], tkw["suspicion"] = jsus, tsus
    jcfg = getattr(JaxConfig, factory)(n, 512, **jkw)
    return (dataclasses.replace(jcfg, merge_kernel="xla"),
            getattr(SimConfig, factory)(n, 512, **tkw))


def assert_equal_runs(js, jc, jm, ts, tc, tm):
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("name", list(PROFILES))
def test_lean_loop_matches_the_xla_oracle(name):
    n, rounds = 512, 20
    jcfg, tcfg = configs(name, n)
    assert R.route(tcfg)[0] == "lean"
    js, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                                jax.random.PRNGKey(21), crash_rate=0.02)
    ts, tc, tm = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                              trandom.PRNGKey(21, device="cpu"),
                              crash_rate=0.02)
    assert_equal_runs(js, jc, jm, ts, tc, tm)
    assert int(np.asarray(jm.true_detections).sum()) > 0


@pytest.mark.parametrize("name", ["packed_rr", "suspicion_rr lh"])
def test_tracked_crash_report_matches_jax(name):
    n, rounds = 512, 40
    jcfg, tcfg = configs(name, n)
    jev, jcr, jok = jax_tracked(jcfg, rounds, 6, 10)
    tev, tcr, tok = tracked_crash_events(tcfg, rounds, 6, 10, device="cpu")
    assert tcr == jcr
    _, jc, jm = jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                               jax.random.PRNGKey(4), events=jev,
                               crash_rate=0.01, churn_ok=jok,
                               crash_only_events=True)
    _, tc, tm = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                             trandom.PRNGKey(4, device="cpu"), events=tev,
                             crash_rate=0.01, churn_ok=tok,
                             crash_only_events=True)
    want = jax_summarize(jc, jm, jcr).as_dict()
    got = summarize(tc, tm, tcr).as_dict()
    assert got == want
    assert all(v >= 0 for v in got["ttd_first"].values())


@pytest.mark.parametrize("name", list(PROFILES))
def test_lean_loop_equals_the_separate_pass_loop(name):
    n, rounds = 512, 12
    _, cfg = configs(name, n)
    outs = []
    for run in (R._run_lean, R._run_general):
        merge.reset_launch_counts()
        outs.append(run(init_state(cfg, device="cpu"), cfg, rounds,
                        trandom.PRNGKey(6, device="cpu"), None, 0.03, 0.0,
                        None, None, False, False))
        assert not any(merge.LAUNCH_COUNTS.values())   # plain on CPU
    (a, b, c), (d, e, f) = outs
    for x, y in zip((a.hb, a.asl, a.alive, a.hb_base, *b, *c),
                    (d.hb, d.asl, d.alive, d.hb_base, *e, *f)):
        assert torch.equal(x, y)


def test_lean_core_threads_carried_counts():
    """Two calls of the lean core with the carried counts threaded through
    equal one call over both horizons (the detectors' use)."""
    cfg = SimConfig.suspicion_rr(256, suspicion=SuspicionParams(**LH_ON))
    key = trandom.PRNGKey(8, device="cpu")

    def fresh():
        return R.rr_packed_init(cfg, device="cpu")

    hb, asl, alive, base, rnd, counts = fresh()
    one = R.run_lean_packed(hb, asl, alive, base, rnd, cfg, key, 16,
                            crash_rate=0.03)
    hb, asl, alive, base, rnd, counts = fresh()
    mid = R.run_lean_packed(hb, asl, alive, base, rnd, cfg, key, 9,
                            crash_rate=0.03, counts0=counts)
    two = R.run_lean_packed(*mid[:5], cfg, key, 7, crash_rate=0.03,
                            mcarry0=mid[7], counts0=mid[5],
                            sus_counts0=mid[6])
    assert two[4] == one[4] == 16
    for x, y in zip((*one[:4], one[5], one[6], *one[7]),
                    (*two[:4], two[5], two[6], *two[7])):
        assert torch.equal(x, y)
    for x, y in zip(one[8], two[8]):
        assert torch.equal(x[9:], y)


ROUTES = [
    (SimConfig.packed_rr(16_384), False, ("lean", "edges/onepass")),
    (SimConfig.suspicion_rr(16_384), False, ("lean", "edges/onepass")),
    (SimConfig.packed_rr(16_384), True, ("separate", "stripe_merge_update")),
    # past the narrow blocking's shared memory: the wide one (16 x 16)
    (SimConfig.packed_rr(49_152), False, ("lean", "edges/onepass")),
    # past the wide one's too: the two-launch form
    (SimConfig.packed_rr(131_072), False, ("lean", "edges")),
    (SimConfig.headline(16_384), False, ("lean", "aligned_group/onepass")),
    # arc_align != 8: the kernel's plain-arc form (F consecutive rows)
    (SimConfig.headline(16_384, arc_align=4), False, ("lean", "arc/onepass")),
    (SimConfig.headline(16_384, arc_align=16), False,
     ("lean", "arc/onepass")),
    (SimConfig.headline(16_384, arc_align=2), False, ("lean", "arc/onepass")),
    (SimConfig.packed_rr(16_384, topology="random_arc", fanout=16), False,
     ("lean", "arc/onepass")),
    (SimConfig.headline(16_384), True, ("separate", "arc_merge_update")),
    # off the rr gate: other merge kernels, the fused-tick knob off
    (SimConfig.packed_rr(16_384, merge_kernel="pallas"), False,
     ("separate", "fused_merge_update")),
    (SimConfig.packed_rr(16_384, fused_tick="off"), False,
     ("separate", "stripe_merge_update")),
    (SimConfig.packed_rr(16_384, topology="random_arc", fanout=16,
                         merge_kernel="xla"), False,
     ("separate", "arc_merge_update")),
    (SimConfig.packed_rr(16_384, hb_dtype="int16", view_dtype="int8"),
     False, ("separate", "stripe_merge_update")),
    (SimConfig.packed_rr(16_384, remove_broadcast=True), False,
     ("separate", "stripe_merge_update")),
    # a ragged N (N % 4 != 0) stays out of the kernel
    (SimConfig.packed_rr(1_030), False, ("separate", "stripe_merge_update")),
    (SimConfig.headline(1_030, arc_align=2, fanout=16), False,
     ("separate", "arc_merge_update")),
]


@pytest.mark.parametrize("cfg,matrix_events,want", ROUTES)
def test_route_rule(cfg, matrix_events, want):
    got = R.route(cfg, matrix_events)
    assert got == want
    if got[0] == "lean":
        # the CUDA resident round takes every lean configuration, the
        # one-pass form every one that it holds
        form = got[1].removesuffix("/onepass")
        assert cfg.n % merge.KERNEL_VEC == 0 and form in merge.FORMS
        assert merge.onepass_fits(cfg.n, cfg.n, form) == (form != got[1])
        if form == "aligned_group":
            assert cfg.n % merge.KERNEL_ALIGN == 0
            assert cfg.fanout % merge.KERNEL_ALIGN == 0


def test_frontier_padded_run_matches_jax():
    """The frontier entry point at a literal N (1,000 padded to 1,024 with
    dead pad nodes) reports what the JAX package's XLA run of the same
    padded cohort, schedule and key reports."""
    n, n_pad, rounds = 1000, 1024, 12
    doc = run_frontier(n=n, rounds=rounds, block_c=512, seed=2,
                       device="cpu")
    assert (doc["n_padded"], doc["pad_nodes"]) == (n_pad, n_pad - n)
    jcfg = dataclasses.replace(JaxConfig.packed_rr(n_pad, 512),
                               merge_kernel="xla")
    jev, jcr, jok = jax_tracked(jcfg, rounds, 8, 3, n_live=n)
    _, jc, jm = jax_run_rounds(
        jax_init_state(jcfg, jax.numpy.arange(n_pad) < n), jcfg, rounds,
        jax.random.PRNGKey(2), events=jev, crash_rate=0.01, churn_ok=jok,
        crash_only_events=True)
    want = jax_summarize(jc, jm, jcr, n_effective=n)
    ttd = [v for v in want.ttd_first.values() if v >= 0]
    assert doc["tracked_crashes"] == len(jcr) == 8
    assert doc["detected"] == len(ttd) > 0
    assert doc["ttd_first_max"] == max(ttd)
    assert doc["false_positive_rate"] == want.false_positive_rate


@pytest.mark.parametrize("kw,want", [
    (dict(n=65_536), ("lean", "edges/onepass")),
    (dict(n=100_000), ("lean", "edges/onepass")),
    (dict(n=49_152, topology="random_arc", arc_align=16),
     ("lean", "arc/onepass")),
    (dict(n=65_536, topology="random_arc", arc_align=8), ("lean",
                                                          "aligned_group/onepass")),
])
def test_frontier_configs_take_the_lean_loop(kw, want):
    """The frontier's configurations (and the padding of a literal N to
    the JAX package's quantum) all have a CUDA route."""
    cfg, n_pad = frontier_config(**kw)
    assert cfg.n == n_pad and n_pad >= kw["n"]
    assert n_pad % 1024 == 0
    assert R.route(cfg) == want
