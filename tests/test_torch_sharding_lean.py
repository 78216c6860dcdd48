"""Subject-axis sharding on the lean loop: 2- and 4-rank gloo runs on the
CPU against the JAX package, exact.

Each case runs ``parallel.mesh.run_rounds_sharded`` in 2 or 4 processes
(``parallel.distributed.launch``, a file rendezvous, gloo, one thread a
rank), each rank on its ``[N, N / ranks]`` column shard: the resident
round's column-shard form, here through its plain version.  The blocks,
gathered on rank 0, must equal the JAX package's single-device run of the
same configuration (its XLA round, which the JAX package pins its rr scan
to) in the lanes, the carry and every RoundMetrics field, so each rank's
shard is that run's column slice; the aligned-arc and explicit-edge
cases are held against the JAX package's rr scan too (its Pallas
resident round in interpret mode).  Cases: aligned arcs (align 8 and 4),
explicit edges (``packed_rr``), plain arcs, suspicion with the Lifeguard
lane under heavy churn (its degraded rows read the summed SUSPECT counts:
the run is checked to differ from the same run without the lane), a
small-group threshold between a shard's partial counts and the whole
counts (from round 0 a shard's own counts would flag every receiver), the
SWAR form, and one scenario-armed run (the ``edge_filter`` form).
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import _use_rr
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.parallel import distributed, mesh
from gossipfs_tpu_torch.scenarios import tensor as ttensor
from gossipfs_tpu_torch.suspicion import SuspicionParams

torch.set_num_threads(1)

SEED = 42
HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")
LH = dict(t_suspect=2, lh_multiplier=4, lh_frac=0.03125)


def split(mod, n):
    """A half/half partition for rounds 2-9 beside slow senders."""
    return mod.FaultScenario(
        name="split", n=n,
        partitions=(mod.Partition(start=2, end=9,
                                  groups=(tuple(range(n // 2)),)),),
        slow_nodes=(mod.SlowNode(start=0, end=12, stride=3,
                                 nodes=tuple(range(n // 32))),))


def pair(factory, n, sus=None, **kw):
    """(JAX config on its XLA round, port config) of the same fields."""
    if factory == "fields":
        jcfg, tcfg = JaxConfig(n=n, **kw), SimConfig(n=n, **kw)
    else:
        jcfg = getattr(JaxConfig, factory)(n, 512, **kw)
        tcfg = getattr(SimConfig, factory)(n, 512, **kw)
    if sus is not None:
        jcfg = dataclasses.replace(jcfg, suspicion=JaxSus(**sus))
        tcfg = dataclasses.replace(tcfg, suspicion=SuspicionParams(**sus))
    return dataclasses.replace(jcfg, merge_kernel="xla"), tcfg


# name -> (JAX config, port config, run kwargs, rounds, expected route)
CASES = {
    "aligned arcs": (*pair("fields", 1024, **HEADLINE),
                     dict(crash_rate=0.02), 12,
                     ("lean", "aligned_group/onepass")),
    "arcs align 4": (*pair("fields", 512, **dict(HEADLINE, arc_align=4)),
                     dict(crash_rate=0.02), 12, ("lean", "arc/onepass")),
    "explicit edges": (*pair("packed_rr", 512), dict(crash_rate=0.02), 12,
                       ("lean", "edges/onepass")),
    "plain arcs": (*pair("packed_rr", 512, topology="random_arc",
                         fanout=16), dict(crash_rate=0.02), 12,
                   ("lean", "arc/onepass")),
    "suspicion + lh": (*pair("suspicion_rr", 512, sus=LH),
                       dict(crash_rate=0.05), 30, ("lean", "edges/onepass")),
    "min_group 200": (*pair("fields", 512, **dict(HEADLINE, min_group=200)),
                      dict(crash_rate=0.03), 16,
                      ("lean", "aligned_group/onepass")),
    "swar": (*pair("fields", 512, **dict(HEADLINE, elementwise="swar")),
             dict(crash_rate=0.02), 12,
             ("lean", "aligned_group/swar/onepass")),
    "swar suspicion": (*pair("fields", 512, sus=dict(t_suspect=2), t_fail=3,
                             **dict(HEADLINE, elementwise="swar")),
                       dict(crash_rate=0.03), 16,
                       ("lean", "aligned_group/swar/onepass")),
    "scenario": (*pair("fields", 512, sus=dict(t_suspect=2), t_fail=3,
                       **HEADLINE), dict(crash_rate=0.01, scenario="split"),
                 14, ("lean", "filter_group/onepass")),
}
WORLDS = {name: (2, 4) for name in CASES}


def port_kw(kw, n):
    if kw.get("scenario") == "split":
        return dict(kw, scenario=ttensor.compile_tensor(split(tscn, n), 0,
                                                        device="cpu"))
    return kw


@functools.lru_cache(maxsize=None)
def jax_run(name: str, lh_off: bool = False, rr: bool = False):
    jcfg, _, kw, rounds, _ = CASES[name]
    if rr:
        jcfg = dataclasses.replace(jcfg, merge_kernel="pallas_rr_interpret",
                                   merge_block_c=512)
        assert _use_rr(jcfg, jcfg.n, jcfg.n)
    if lh_off:
        jcfg = dataclasses.replace(
            jcfg, suspicion=dataclasses.replace(jcfg.suspicion,
                                                lh_multiplier=0))
    if kw.get("scenario") == "split":
        kw = dict(kw, scenario=jtensor.compile_tensor(split(jscn, jcfg.n), 0))
    return jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                          jax.random.PRNGKey(SEED), **kw)


@pytest.fixture(scope="module")
def sharded():
    """Every case in one launch of each world size, the two launches side
    by side."""
    def run(world):
        names = [k for k in CASES if world in WORLDS[k]]
        jobs = [dict(config=CASES[k][1], rounds=CASES[k][3], seed=SEED,
                     **port_kw(CASES[k][2], CASES[k][1].n))
                for k in names]
        ranks = distributed.launch(mesh.run_jobs, world, (jobs,),
                                   device="cpu", threads=1, timeout=600)
        return {(name, world): [r[i] for r in ranks]
                for i, name in enumerate(names)}

    with ThreadPoolExecutor(2) as pool:
        parts = list(pool.map(run, (2, 4)))
    return {**parts[0], **parts[1]}


def compare(head, jout):
    js, jc, jm = jout
    got = to_numpy(head["state"], head["carry"])
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(head["metrics"], k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_lean_matches_jax(sharded, name, world):
    """Gathered shards == the JAX run; every rank took the same lean
    route on its shard, with one collective a round (plus the initial
    count and the metrics sum)."""
    ranks = sharded[name, world]
    _, tcfg, _, rounds, route = CASES[name]
    for r in ranks:
        assert r["route"] == route
        assert r["nloc"] == tcfg.n // world
        assert r["collectives"]["calls"] == rounds + 2 + (
            name == "suspicion + lh")
    compare(ranks[0], jax_run(name))


@pytest.mark.parametrize("name", ["aligned arcs", "explicit edges"])
def test_sharded_lean_matches_jax_rr_scan(sharded, name):
    """The 4-rank run against the JAX package's rr scan itself (its
    resident round in interpret mode, 512 columns a stripe)."""
    compare(sharded[name, 4][0], jax_run(name, rr=True))


def test_lifeguard_lane_mattered():
    """The Lifeguard case's degraded rows changed the run (so its summed
    SUSPECT counts were exercised): the same run without the lane ends
    elsewhere."""
    on, off = jax_run("suspicion + lh"), jax_run("suspicion + lh", True)
    assert not np.array_equal(np.asarray(on[0].status),
                              np.asarray(off[0].status))


def test_min_group_case_sits_between_partial_and_whole():
    """The small-group case's threshold is above every 4-rank shard's
    partial listed count and below the whole counts, so a shard that did
    not sum its counts would flag every receiver a refresher."""
    _, tcfg, *_ = CASES["min_group 200"]
    assert tcfg.n // 4 < tcfg.min_group < tcfg.n * 0.8
