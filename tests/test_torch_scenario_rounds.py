"""``run_rounds(..., scenario=...)`` in the port against the JAX package:
final lanes, carry, every per-round metric and the ``DetectionReport``.

The same ``FaultScenario`` compiles on both sides; the port runs on the CPU
(its kernels' plain versions), the JAX package on its XLA oracle
(``merge_kernel="xla"``); tests/test_torch_scenario_lean.py holds the
lean loop against the Pallas form itself (``pallas_rr_interpret``).
Cases:

* ring, int32 lanes, a partition (edges filtered inside the round);
* random edges, int16 and int8 lanes, partition + Bernoulli loss (K2's
  plain version);
* the ``suspicion_rr`` shape (random, all int8) under split + slow on the
  lean loop (filtered edges into the resident round) and with joins on the
  separate-pass loop (K5's plain version);
* aligned arcs (align 8) under split + slow + flap + outage, suspicion
  with and without the Lifeguard lane, on the lean loop's ``edge_filter``
  form; align 4; with joins (the separate-pass masked group form);
* a run split in two calls with ``mcarry0``, armed mid-run (``round0``);
* ``gossip_round_scenario`` round by round; ``route()`` under a scenario.
Tolerance: exact.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core import rounds as JR
from gossipfs_tpu.core.state import RoundEvents as JaxEvents
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.core.topology import in_edges as jax_in_edges
from gossipfs_tpu.metrics.detection import summarize as jax_summarize
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.topology import in_edges
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.ops import merge
from gossipfs_tpu_torch.scenarios import tensor as ttensor
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

GOSSIP = dict(remove_broadcast=False, fresh_cooldown=True)
SUS = dict(t_suspect=2)
LH = dict(t_suspect=3, lh_multiplier=4, lh_frac=0.03125)


def configs(sus=None, jax_kernel="xla", **kw):
    """(JAX config, port config) of the same fields; the JAX side runs
    ``jax_kernel``."""
    jkw, tkw = dict(kw), dict(kw)
    if sus is not None:
        jkw["suspicion"] = JaxSus(**sus)
        tkw["suspicion"] = SuspicionParams(**sus)
    return JaxConfig(**dict(jkw, merge_kernel=jax_kernel)), SimConfig(**tkw)


def scenario(mod, n, loss=False, arcs=False):
    """A split riding beside slow senders, flappers and an outage (and,
    off arcs, two Bernoulli loss rules)."""
    kw = dict(
        partitions=(mod.Partition(start=2, end=9,
                                  groups=(tuple(range(n // 2)),)),),
        slow_nodes=(mod.SlowNode(start=0, end=12, stride=3,
                                 nodes=tuple(range(n // 32))),),
    )
    if arcs:
        kw.update(
            flapping=(mod.Flapping(start=1, end=14, up=2, down=2,
                                   nodes=tuple(range(n // 2, n // 2 + 12))),),
            outages=(mod.CorrelatedOutage(start=4, end=10,
                                          nodes=tuple(range(40, 47))),))
    if loss:
        kw.update(link_faults=(
            mod.LinkFault(start=0, end=12, rate=0.3,
                          src=tuple(range(n // 4, n // 2)),
                          dst=tuple(range(n))),
            mod.LinkFault(start=3, end=8, rate=1.0, src=(5,), dst=(6, 7))))
    return mod.FaultScenario(name="mix", n=n, **kw)


def compare(js, jc, jm, ts, tc, tm):
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)
    assert ts.round == int(js.round)
    assert (summarize(tc, tm).as_dict() == jax_summarize(jc, jm).as_dict())


def run_pair(jcfg, tcfg, rounds, seed, loss=False, arcs=False, round0=0,
             **kw):
    n = tcfg.n
    jsc = jtensor.compile_tensor(scenario(jscn, n, loss, arcs), round0)
    tsc = ttensor.compile_tensor(scenario(tscn, n, loss, arcs), round0,
                                 device="cpu")
    jout = JR.run_rounds(jax_init_state(jcfg), jcfg, rounds,
                         jax.random.PRNGKey(seed), scenario=jsc, **kw)
    merge.reset_launch_counts()
    tout = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                        trandom.PRNGKey(seed, device="cpu"), scenario=tsc,
                        **kw)
    assert not any(merge.LAUNCH_COUNTS.values())      # plain on the CPU
    compare(*jout, *tout)
    return jout, tout


def test_ring_int32_partition():
    jcfg, tcfg = configs(n=64, topology="ring", fanout=3, t_cooldown=6,
                         **GOSSIP)
    assert R.route(tcfg, scenario=object()) == ("separate",
                                                "fused_merge_update")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 16, 2, crash_rate=0.02)
    assert int(np.asarray(jm.false_positives).sum()) > 0


@pytest.mark.parametrize("hb_dtype", ["int16", "int8"])
def test_random_partition_and_loss(hb_dtype):
    jcfg, tcfg = configs(n=256, topology="random", fanout=8, t_cooldown=6,
                         view_dtype="int8", hb_dtype=hb_dtype, **GOSSIP)
    assert R.route(tcfg, scenario=object()) == ("separate",
                                                "fused_merge_update")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 16, 5, loss=True, crash_rate=0.02)
    assert int(np.asarray(jm.true_detections).sum()) > 0


RR = dict(topology="random", fanout=9, t_cooldown=12, view_dtype="int8",
          hb_dtype="int8", t_fail=3, fused_tick="auto", **GOSSIP)


def test_suspicion_rr_shape_lean_filtered_edges():
    """Random edges, all int8, suspicion: the lean loop, its sampled edges
    rewritten before the resident round's gather."""
    n = 512
    jcfg, tcfg = configs(SUS, n=n, merge_block_c=512, **RR)
    tcfg = dataclasses.replace(tcfg, merge_kernel="pallas_rr")
    assert R.route(tcfg, scenario=object()) == ("lean", "edges/onepass")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 14, 3, loss=True, crash_rate=0.02,
                             crash_only_events=True)
    assert int(np.asarray(jm.suspects_entered).sum()) > 0
    assert int(np.asarray(jm.refutations).sum()) > 0


def test_suspicion_rr_shape_with_joins_separate_pass():
    """The same profile under rejoin churn: matrix events send every round
    to the separate-pass loop (K5's plain version on filtered edges)."""
    jcfg, tcfg = configs(SUS, n=256, **RR)
    tcfg = dataclasses.replace(tcfg, merge_kernel="pallas_rr")
    assert R.route(tcfg, True, object()) == ("separate",
                                             "stripe_merge_update")
    run_pair(jcfg, tcfg, 14, 3, loss=True, crash_rate=0.03,
             rejoin_rate=0.03)


ARC = dict(topology="random_arc", fanout=16, t_cooldown=12,
           view_dtype="int8", hb_dtype="int8", t_fail=3, **GOSSIP)


@pytest.mark.parametrize("sus,align", [(SUS, 8), (LH, 8), (None, 8),
                                       (SUS, 4)],
                         ids=["sus", "lh", "crash-only", "align4"])
def test_aligned_arcs_lean_edge_filter(sus, align):
    """Aligned arcs under split + slow + flap + outage on the lean loop's
    ``edge_filter`` form (the plain version of the resident round),
    against the XLA oracle."""
    n = 1024
    jcfg, tcfg = configs(sus, n=n, arc_align=align, merge_block_c=512,
                         **ARC)
    form = "filter_group" if align == 8 else "filter_rows"
    assert R.route(tcfg, scenario=object()) == ("lean", form + "/onepass")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 16, 3, arcs=True, crash_rate=0.02,
                             crash_only_events=True)
    if sus is not None:
        assert int(np.asarray(jm.suspects_entered).sum()) > 0
        assert int(np.asarray(jm.refutations).sum()) > 0
    else:
        assert int(np.asarray(jm.false_positives).sum()) > 0


@pytest.mark.parametrize("sus", [None, SUS], ids=["crash-only", "suspicion"])
def test_aligned_arcs_with_joins_separate_pass_group_form(sus):
    """Joins are matrix events: the armed arc run takes the separate-pass
    loop and its masked group form in torch ops (no K4)."""
    jcfg, tcfg = configs(sus, n=256, arc_align=8, **ARC)
    assert R.route(tcfg, True, object()) == ("separate",
                                             "arc_group_merge_update")
    assert R.route(tcfg, True) == ("separate", "arc_merge_update")
    run_pair(jcfg, tcfg, 16, 4, arcs=True, crash_rate=0.03, rejoin_rate=0.03)


def test_int16_arcs_separate_pass_group_form_without_events():
    """An armed arc run the lean gate does not admit (int16 lanes): the
    separate-pass loop crash-only, detection stats from the merge."""
    jcfg, tcfg = configs(n=256, arc_align=8, **dict(ARC, hb_dtype="int16"))
    assert R.route(tcfg, scenario=object()) == ("separate",
                                                "arc_group_merge_update")
    run_pair(jcfg, tcfg, 14, 6, arcs=True, crash_rate=0.03)


@pytest.mark.parametrize("topology", ["random_arc", "random"])
def test_split_run_armed_mid_run_with_mcarry0(topology):
    """Two calls (the second continuing the carry) equal one call, on both
    sides, with the scenario armed at round 3 (``round0``): ``rel`` starts
    negative."""
    n, seed = 512, 8
    shape = (dict(ARC, arc_align=8) if topology == "random_arc"
             else dict(RR, merge_kernel="pallas_rr"))
    jcfg, tcfg = configs(SUS, n=n, **{k: v for k, v in shape.items()
                                      if k != "merge_kernel"})
    if topology == "random":
        tcfg = dataclasses.replace(tcfg, merge_kernel="pallas_rr")
    arcs = topology == "random_arc"
    (js, jc, jm), (ts, tc, tm) = run_pair(
        jcfg, tcfg, 18, seed, arcs=arcs, round0=3, crash_rate=0.02,
        crash_only_events=True)
    tsc = ttensor.compile_tensor(scenario(tscn, n, False, arcs), 3,
                                 device="cpu")
    key = trandom.PRNGKey(seed, device="cpu")
    kw = dict(crash_rate=0.02, crash_only_events=True, scenario=tsc)
    s1, c1, m1 = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, 7, key,
                              **kw)
    s2, c2, m2 = R.run_rounds(s1, tcfg, 11, key, mcarry0=c1, **kw)
    assert torch.equal(s2.hb, ts.hb) and torch.equal(s2.asl, ts.asl)
    for a, b in zip(c2, tc):
        assert torch.equal(a, b)
    for a, b, c in zip(m1, m2, tm):
        assert torch.equal(torch.cat([a, b]), c)


@pytest.mark.parametrize("topology", ["ring", "random", "random_arc"])
def test_gossip_round_scenario_matches_jax(topology):
    n = 64
    kw = {"ring": dict(topology="ring", fanout=3),
          "random": dict(topology="random", fanout=6, view_dtype="int8",
                         hb_dtype="int16"),
          "random_arc": dict(topology="random_arc", fanout=16, arc_align=8,
                             view_dtype="int8", hb_dtype="int8")}[topology]
    sus = None if topology == "ring" else SUS
    jcfg, tcfg = configs(sus, n=n, t_cooldown=6, t_fail=3, **kw, **GOSSIP)
    arcs = topology == "random_arc"
    sc_kw = dict(loss=not arcs, arcs=arcs)
    jsc = jtensor.compile_tensor(scenario(jscn, n, **sc_kw), 1)
    tsc = ttensor.compile_tensor(scenario(tscn, n, **sc_kw), 1, device="cpu")
    js, ts = jax_init_state(jcfg), init_state(tcfg, device="cpu")
    jkey, tkey = jax.random.PRNGKey(6), trandom.PRNGKey(6, device="cpu")
    fired = 0
    for r in range(16):
        crash = np.zeros(n, bool)
        crash[[3, 50]] = r == 2
        none = np.zeros(n, bool)
        jk, tk = jax.random.fold_in(jkey, r), trandom.fold_in(tkey, r)
        je = te = None
        if topology != "ring":
            je = jax_in_edges(jcfg, jk, None)
            te = in_edges(tcfg, tk)
            np.testing.assert_array_equal(te.numpy(), np.asarray(je))
        js, jmet, jfail, jobs = JR.gossip_round_scenario(
            js, JaxEvents(crash=jax.numpy.asarray(crash),
                          leave=jax.numpy.asarray(none),
                          join=jax.numpy.asarray(none)),
            je, jcfg, jsc, jax.random.fold_in(jk, 0x5CE))
        ts, tmet, tfail, tobs = R.gossip_round_scenario(
            ts, RoundEvents(*(torch.from_numpy(m) for m in
                              (crash, none, none))),
            te, tcfg, tsc, trandom.fold_in(tk, 0x5CE))
        got = to_numpy(ts)
        for k in ("hb", "age", "status", "alive", "hb_base"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                          err_msg=f"{k} round {r}")
        for k in jmet._fields:
            assert int(getattr(tmet, k)) == int(getattr(jmet, k)), (k, r)
        np.testing.assert_array_equal(tfail.numpy(), np.asarray(jfail))
        where = np.asarray(jfail)
        np.testing.assert_array_equal(tobs.numpy()[where],
                                      np.asarray(jobs)[where])
        fired += int(where.sum())
    assert fired > 0


def test_route_and_gates_under_a_scenario():
    head = SimConfig.headline(1024)
    assert R.route(head) == ("lean", "aligned_group/onepass")
    assert R.route(head, scenario=object()) == ("lean",
                                                "filter_group/onepass")
    assert R.route(SimConfig.headline(1024, arc_align=4),
                   scenario=object()) == ("lean", "filter_rows/onepass")
    assert R.route(SimConfig.headline(1024, arc_align=16),
                   scenario=object()) == ("lean", "filter_rows/onepass")
    rr = SimConfig.suspicion_rr(1024)
    assert R.route(rr, scenario=object()) == ("lean", "edges/onepass")
    # more than 31 window groups: no edge_filter form, and run_rounds
    # rejects the scenario as the reference does
    wide = SimConfig.headline(1024, fanout=128, arc_align=4)
    assert R.route(wide) == ("lean", "arc/onepass")
    assert R.route(wide, scenario=object()) == ("separate",
                                                "arc_group_merge_update")
    tsc = ttensor.compile_tensor(tscn.split_halves(1024, 2, 6), device="cpu")
    with pytest.raises(ValueError, match="must be <= 31"):
        R.run_rounds(init_state(wide, device="cpu"), wide, 2,
                     trandom.PRNGKey(0, device="cpu"), scenario=tsc)
    # plain arcs on the lean loop have no scenario form at all
    plain_arc = dataclasses.replace(SimConfig.packed_rr(1024),
                                    topology="random_arc", fanout=16)
    with pytest.raises(ValueError, match="arc_align > 1"):
        R.run_rounds(init_state(plain_arc, device="cpu"), plain_arc, 2,
                     trandom.PRNGKey(0, device="cpu"), scenario=tsc)
    with pytest.raises(ValueError, match="remove_broadcast"):
        cfg = SimConfig(n=64)
        R.run_rounds(init_state(cfg, device="cpu"), cfg, 2,
                     trandom.PRNGKey(0, device="cpu"),
                     scenario=ttensor.compile_tensor(
                         tscn.split_halves(64, 2, 6), device="cpu"))
