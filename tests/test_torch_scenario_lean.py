"""The lean loop under a scenario against the JAX package's rr scan running
its Pallas resident round in interpret mode (``pallas_rr_interpret``): the
kernel form itself is the counterpart here, as in the JAX package's own
``tests/test_scenarios.py::TestFastPathUnification``.

* aligned arcs (align 8 and 4) under split + slow + flap + outage,
  suspicion with and without the Lifeguard lane: the port's ``edge_filter``
  form (the resident round's plain version) against
  ``resident_round_blocked(edge_filter=True)``;
* the ``suspicion_rr`` shape under split + slow + two Bernoulli loss
  rules: rewritten edges into the explicit-edge form on both sides.
Final lanes, carry, every per-round metric and the ``DetectionReport``,
exact.  tests/test_torch_scenario_rounds.py holds the same runs against the
XLA oracle, and the separate-pass loop.
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
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.metrics.detection import summarize as jax_summarize
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import init_state
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


RR = dict(topology="random", fanout=9, t_cooldown=12, view_dtype="int8",
          hb_dtype="int8", t_fail=3, fused_tick="auto", **GOSSIP)
ARC = dict(topology="random_arc", fanout=16, t_cooldown=12,
           view_dtype="int8", hb_dtype="int8", t_fail=3, **GOSSIP)
KERNEL = "pallas_rr_interpret"


def test_suspicion_rr_shape_against_pallas_interpret():
    n = 512
    jcfg, tcfg = configs(SUS, KERNEL, n=n, merge_block_c=512, **RR)
    tcfg = dataclasses.replace(tcfg, merge_kernel="pallas_rr")
    assert R.route(tcfg, scenario=object()) == ("lean", "edges/onepass")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 14, 3, loss=True, crash_rate=0.02,
                             crash_only_events=True)
    assert int(np.asarray(jm.suspects_entered).sum()) > 0
    assert int(np.asarray(jm.refutations).sum()) > 0


@pytest.mark.parametrize("sus,align", [(SUS, 8), (LH, 8), (SUS, 4)],
                         ids=["sus", "lh", "align4"])
def test_aligned_arcs_edge_filter_against_pallas_interpret(sus, align):
    n = 1024
    jcfg, tcfg = configs(sus, KERNEL, n=n, arc_align=align,
                         merge_block_c=512, **ARC)
    # the JAX scan really takes its rr kernel here
    assert JR._rr_scan_eligible(jcfg, n, n, False, JR.LOCAL_CTX,
                                scenario=object())
    form = "filter_group" if align == 8 else "filter_rows"
    assert R.route(tcfg, scenario=object()) == ("lean", form + "/onepass")
    (_, _, jm), _ = run_pair(jcfg, tcfg, 16, 3, arcs=True, crash_rate=0.02,
                             crash_only_events=True)
    assert int(np.asarray(jm.suspects_entered).sum()) > 0
    assert int(np.asarray(jm.refutations).sum()) > 0
