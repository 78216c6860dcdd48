"""Subject-axis sharding on the separate-pass loop, and the sharded entry
point's checks: 2- and 4-rank gloo runs on the CPU against the JAX
package, exact.

The twins of the JAX package's ``tests/test_sharding.py``:

* ``TestShardMapRunner::test_matches_single_device``: N = 1,024, random
  fanout 8, two crashes at round 5 and one join at round 20, 1 % random
  crash churn, 30 rounds, int32 and int16 lanes, against the JAX
  package's ``run_rounds_sharded`` on its 8-device virtual mesh (and its
  single-device ``run_rounds``, which that run equals);
* ``test_non_lane_aligned_shard_falls_back_to_xla``: a shard width the
  resident round cannot take (the headline at N = 1,032 over 4 ranks:
  258 columns, not a multiple of 4) runs the separate-pass loop, where
  one device runs the lean loop, with the same outputs;
* ``test_ring_rejected``; and the port's other checks: N not divisible
  by the ranks, the crash-only promise.

Beside them the SWAR tick of the separate-pass round (the eventful
headline) and the suspicion + Lifeguard rounds of ``suspicion_rr`` under
rejoins (K5's function; the degraded rows read the summed counts) on
shards.  Gathered on rank 0, the blocks must equal the JAX run in the
lanes, the carry and every RoundMetrics field.
"""

from __future__ import annotations

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import RoundEvents as JaxEvents
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.parallel.mesh import make_mesh, shard_state
from gossipfs_tpu.parallel.mesh import run_rounds_sharded as jax_sharded
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import shard_from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import RoundEvents, init_shard, init_state
from gossipfs_tpu_torch.parallel import distributed, mesh
from gossipfs_tpu_torch.suspicion import SuspicionParams

torch.set_num_threads(1)

SEED = 42
HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")
LH = dict(t_suspect=2, lh_multiplier=4, lh_frac=0.03125)


def twin_events(rounds: int, n: int):
    """test_sharding.py's schedule: nodes 7 and 300 crash at round 5,
    node 7 rejoins at round 20."""
    crash = np.zeros((rounds, n), bool)
    crash[5, [7, 300]] = True
    join = np.zeros((rounds, n), bool)
    join[20, 7] = True
    return crash, np.zeros((rounds, n), bool), join


def pair(n, sus=None, **kw):
    """(JAX config on its XLA round, port config) of the same fields."""
    jcfg = JaxConfig(n=n, merge_kernel="xla", **kw)
    tcfg = SimConfig(n=n, **kw)
    if sus is not None:
        jcfg = dataclasses.replace(jcfg, suspicion=JaxSus(**sus))
        tcfg = dataclasses.replace(tcfg, suspicion=SuspicionParams(**sus))
    return jcfg, tcfg


def rr_pair(n, **kw):
    jcfg = JaxConfig.suspicion_rr(n, 512, **kw)
    tcfg = SimConfig.suspicion_rr(n, 512, **kw)
    return (dataclasses.replace(jcfg, merge_kernel="xla",
                                suspicion=JaxSus(**LH)),
            dataclasses.replace(tcfg, suspicion=SuspicionParams(**LH)))


# name -> (JAX config, port config, run kwargs, rounds, worlds, route)
CASES = {
    "twin int32": (*pair(1024, topology="random", fanout=8),
                   dict(events="twin", crash_rate=0.01), 30, (2, 4),
                   ("separate", "fused_merge_update")),
    "twin int16": (*pair(1024, topology="random", fanout=8,
                         hb_dtype="int16"),
                   dict(events="twin", crash_rate=0.01), 30, (2, 4),
                   ("separate", "fused_merge_update")),
    "narrow shard": (*pair(1032, **HEADLINE), dict(crash_rate=0.02), 10,
                     (4,), ("separate", "arc_merge_update")),
    "swar tick, rejoins": (*pair(512, **dict(HEADLINE, elementwise="swar")),
                           dict(crash_rate=0.03, rejoin_rate=0.03), 12,
                           (2, 4), ("separate", "arc_merge_update")),
    "suspicion_rr lh, rejoins": (*rr_pair(512),
                                 dict(crash_rate=0.05, rejoin_rate=0.02),
                                 16, (2,), ("separate",
                                            "stripe_merge_update")),
}


def port_kw(kw, n, rounds, device="cpu"):
    if kw.get("events") == "twin":
        ev = RoundEvents(*(torch.from_numpy(a).to(device)
                           for a in twin_events(rounds, n)))
        return dict(kw, events=ev)
    return kw


@functools.lru_cache(maxsize=None)
def jax_run(name: str, sharded: bool = False):
    jcfg, _, kw, rounds, _, _ = CASES[name]
    if kw.get("events") == "twin":
        kw = dict(kw, events=JaxEvents(*(jnp.asarray(a) for a in
                                         twin_events(rounds, jcfg.n))))
    if sharded:
        m = make_mesh()
        return jax_sharded(shard_state(jax_init_state(jcfg), m), jcfg,
                           rounds, jax.random.PRNGKey(SEED), m, **kw)
    return jax_run_rounds(jax_init_state(jcfg), jcfg, rounds,
                          jax.random.PRNGKey(SEED), **kw)


@pytest.fixture(scope="module")
def sharded():
    """Every case in one launch of each world size, the two launches side
    by side."""
    def run(world):
        names = [k for k in CASES if world in CASES[k][4]]
        jobs = [dict(config=CASES[k][1], rounds=CASES[k][3], seed=SEED,
                     **port_kw(CASES[k][2], CASES[k][1].n, CASES[k][3]))
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


PARAMS = [(k, w) for k in CASES for w in CASES[k][4]]


@pytest.mark.parametrize("name,world", PARAMS,
                         ids=[f"{k}-{w}" for k, w in PARAMS])
def test_sharded_separate_pass_matches_jax(sharded, name, world):
    """Gathered shards == the JAX run; every rank took the same route."""
    ranks = sharded[name, world]
    tcfg, route = CASES[name][1], CASES[name][5]
    for r in ranks:
        assert r["route"] == route
        assert r["nloc"] == tcfg.n // world
    compare(ranks[0], jax_run(name))


@pytest.mark.parametrize("hb_dtype", ["int32", "int16"])
def test_twin_matches_jax_shard_map(sharded, hb_dtype):
    """The JAX package's own sharded run (``run_rounds_sharded`` over its
    8-device virtual mesh) gives what the port's 4-rank run gives."""
    compare(sharded[f"twin {hb_dtype}", 4][0],
            jax_run(f"twin {hb_dtype}", sharded=True))


def test_narrow_shard_takes_the_separate_pass_loop():
    """One device runs the headline at N = 1,032 on the lean loop; its
    258-column shards do not pack 4 subjects a vector, so they take the
    separate-pass round."""
    cfg = CASES["narrow shard"][1]
    assert R.route(cfg) == ("lean", "aligned_group")
    assert R.route(cfg, nloc=cfg.n // 2) == ("lean", "aligned_group")
    assert R.route(cfg, nloc=cfg.n // 4) == ("separate", "arc_merge_update")


def test_shard_continues_a_jax_state():
    """``convert.shard_from_jax_arrays`` hands a rank the column block of
    a JAX state mid-run; that block continued by the port's sharded
    rounds (one process, offset 0 of 1 rank) is the JAX run's block."""
    jcfg, tcfg = pair(512, topology="random", fanout=8, hb_dtype="int16")
    js, jc, _ = jax_run_rounds(jax_init_state(jcfg), jcfg, 8,
                               jax.random.PRNGKey(3), crash_rate=0.02)
    ctx = R.ShardCtx(offset=0, nloc=tcfg.n)
    st, carry = shard_from_jax_arrays(
        ctx, js.hb, js.age, js.status, js.alive, js.hb_base, js.round,
        *(jc[i] for i in range(4)), device="cpu")
    ts, tc, tm = mesh.run_rounds_sharded(st, tcfg, 6, trandom.PRNGKey(
        4, device="cpu"), ctx, crash_rate=0.02)
    jx = jax_run_rounds(js, jcfg, 6, jax.random.PRNGKey(4), crash_rate=0.02,
                        mcarry0=jc)
    got = to_numpy(ts)
    np.testing.assert_array_equal(got["hb"], np.asarray(jx[0].hb))
    # a block of a JAX state: columns 256..512 of 512
    blk = R.ShardCtx(offset=256, nloc=256)
    bs, bc = shard_from_jax_arrays(blk, js.hb, js.age, js.status, js.alive,
                                   js.hb_base, js.round,
                                   *(jc[i] for i in range(4)), device="cpu")
    assert bs.hb.shape == (tcfg.n, 256) and bc.converged.shape == (256,)
    np.testing.assert_array_equal(bs.hb.numpy(),
                                  np.asarray(js.hb)[:, 256:512])


def test_ring_rejected():
    cfg = SimConfig(n=64, topology="ring", fanout=3)
    with pytest.raises(ValueError, match="ring"):
        mesh.run_rounds_sharded(init_state(cfg, device="cpu"), cfg, 5,
                                trandom.PRNGKey(0, device="cpu"),
                                R.LOCAL_CTX)


def test_crash_only_promise_enforced():
    cfg = SimConfig(n=64, topology="random", fanout=4)
    rounds = 4
    crash, leave, join = (torch.zeros((rounds, 64), dtype=torch.bool)
                          for _ in range(3))
    join[2, 5] = True
    with pytest.raises(ValueError, match="crash_only_events"):
        mesh.run_rounds_sharded(init_state(cfg, device="cpu"), cfg, rounds,
                                trandom.PRNGKey(0, device="cpu"),
                                R.LOCAL_CTX,
                                events=RoundEvents(crash, leave, join),
                                crash_only_events=True)


def test_n_not_divisible_over_ranks_rejected():
    """Every rank raises before any collective; the launch kills the rest
    and names the cause."""
    cfg = SimConfig(n=1025, topology="random", fanout=4)
    with pytest.raises(RuntimeError, match="must divide over 2 ranks"):
        distributed.launch(mesh.run_job, 2,
                           (dict(config=cfg, rounds=2, seed=0),),
                           device="cpu", threads=1, timeout=120)


def test_shard_init_is_the_square_init_sliced():
    """``init_shard`` builds a rank's block in place: the square initial
    state's column slice, member mask included."""
    cfg = SimConfig(n=96, topology="random", fanout=4, hb_dtype="int16")
    mask = torch.ones(96, dtype=torch.bool)
    mask[[3, 40, 70]] = False
    full = init_state(cfg, mask, device="cpu")
    for off in (0, 32, 64):
        ctx = R.ShardCtx(offset=off, nloc=32)
        blk = init_shard(cfg, ctx, mask, device="cpu")
        assert torch.equal(blk.hb, full.hb[:, off:off + 32])
        assert torch.equal(blk.asl, full.asl[:, off:off + 32])
        assert torch.equal(blk.hb_base, full.hb_base[off:off + 32])
        assert torch.equal(blk.alive, full.alive)
        assert torch.equal(mesh.shard_state(full, ctx).asl, blk.asl)
