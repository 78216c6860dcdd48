"""The port's separate-pass round loop, bit for bit against JAX.

The port's ``run_rounds`` against JAX ``run_rounds(merge_kernel="xla")``:
lanes (through ``convert.to_numpy``), carry and all six per-round
metrics, and an equal ``summarize`` report, for

* ``ring`` N=64 in int32 lanes with REMOVE broadcast and the reference
  cooldown, under scheduled crashes, LEAVE broadcasts and joins, and
  BASELINE config 1 as published (N=10, 120 rounds) under churn;
* ``random`` N=256 in config 3's dtypes (int8 view, int16 lanes) under
  crash and rejoin churn;
* aligned ``random_arc`` N=256 under rejoin churn (K4, off the lean loop);
* plain arcs, crash-only, for 200 rounds: past the 126-round int8 window;
* a carried int16 state whose bases sit near the window and above their
  subjects' counters (``shift_b < 0``), continued under rejoins;

``gossip_round`` against JAX ``gossip_round`` on the flagship one-round
step's config (``__graft_entry__``), and the pieces the loop draws its
edges from: ``random_in_edges`` (jax's uint16 draw) for N around 2^16 and
``ring_edges_from_status``.  The port's presets equal the JAX package's
field for field.  Every comparison is exact equality.
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
from gossipfs_tpu.metrics.detection import summarize as jax_summarize
from gossipfs_tpu.models import presets as jax_presets
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core import topology as ttopo
from gossipfs_tpu_torch.core.rounds import gossip_round, run_rounds
from gossipfs_tpu_torch.core.state import RoundEvents, init_state
from gossipfs_tpu_torch.metrics.detection import summarize
from gossipfs_tpu_torch.models import presets
from gossipfs_tpu_torch.ops import merge

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

STATE = ("hb", "age", "status", "alive", "hb_base")
CARRY = ("first_detect", "first_observer", "converged", "first_suspect")
CONFIG3 = dict(topology="random", fanout=8, remove_broadcast=False,
               fresh_cooldown=True, t_cooldown=12, view_dtype="int8",
               hb_dtype="int16")
HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8")


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


def run_both(kw: dict, rounds: int, seed: int, events=None, **run):
    """The same scan in both packages from fresh states; ``events`` are
    numpy (crash, leave, join) masks."""
    jcfg = JaxConfig(merge_kernel="xla", **kw)
    tcfg = SimConfig(**kw)
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
    return j_out, t_out


def test_ring_int32_remove_broadcast_with_events():
    n, rounds = 64, 60
    crash, leave, join = (np.zeros((rounds, n), bool) for _ in range(3))
    crash[5, [3, 9]] = True
    leave[8, [20, 21]] = True
    join[25, [3, 20]] = True
    crash[30, 40] = True
    join[45, [40, 9]] = True
    leave[50, 0] = True          # the introducer leaves: later joins are lost
    join[55, 21] = True
    (_, jc, jm), (_, tc, tm) = run_both(dict(n=n), rounds, 3,
                                        events=(crash, leave, join))
    crashed = {3: 5, 9: 5, 40: 30}
    want = jax_summarize(jc, jm, crashed).as_dict()
    assert summarize(tc, tm, crashed).as_dict() == want
    assert want["true_detections"] > 0


def test_config1_parity_10_as_published():
    """BASELINE config 1 from the port's presets, at its published size
    and horizon (N=10, 120 rounds: the ragged N the kernels' element loads
    serve), under crash and rejoin churn."""
    sc = presets.ALL["parity-10"]
    kw = dataclasses.asdict(sc.config)
    del kw["merge_kernel"]             # run_both asks JAX for its XLA oracle
    (_, _, jm), _ = run_both(kw, sc.rounds, 13, crash_rate=0.05,
                             rejoin_rate=0.1)
    assert int(jnp.sum(jm.true_detections)) > 0


def test_random_config3_dtypes_crash_and_rejoin():
    (_, _, jm), _ = run_both(dict(n=256, **CONFIG3), 40, 5, crash_rate=0.05,
                             rejoin_rate=0.05)
    assert int(jnp.sum(jm.true_detections)) > 0


def test_aligned_arcs_with_rejoin():
    run_both(dict(n=256, **HEADLINE), 40, 7, crash_rate=0.03,
             rejoin_rate=0.05)


def test_plain_arcs_crash_only_past_the_int8_window():
    (js, _, _), _ = run_both(dict(n=256, **dict(HEADLINE, arc_align=1)),
                             200, 8, crash_rate=0.005)
    assert int(jnp.max(js.hb_base)) > 0


def test_carried_state_with_bases_above_their_counters():
    """A state carried from JAX whose subjects' bases sit near the int16
    window and above their own counters (``shift_b < 0`` on the first
    rounds), continued in both packages under rejoins."""
    n = 256
    kw = dict(n=n, **CONFIG3)
    jcfg, tcfg = JaxConfig(merge_kernel="xla", **kw), SimConfig(**kw)
    key = jax.random.PRNGKey(11)
    js, jc, _ = jax_run_rounds(jax_init_state(jcfg), jcfg, 20, key,
                               crash_rate=0.02)
    shift = np.where(np.arange(n) % 4 == 1, 16_300, 0).astype(np.int32)
    js = js._replace(hb_base=js.hb_base + jnp.asarray(shift))
    colmax = np.diagonal(np.asarray(js.hb)) + np.asarray(js.hb_base) + 1
    assert (np.maximum(colmax - 16_384, 0) < np.asarray(js.hb_base)).any()
    x = {k: np.asarray(getattr(js, k)) for k in STATE + ("round",)}
    x.update({k: np.asarray(getattr(jc, k)) for k in CARRY})
    ts, tc = from_jax_arrays(**x, device="cpu")
    j_out = jax_run_rounds(js, jcfg, 30, key, crash_rate=0.03,
                           rejoin_rate=0.2, mcarry0=jc)
    t_out = run_rounds(ts, tcfg, 30, trandom.PRNGKey(11, device="cpu"),
                       crash_rate=0.03,
                       rejoin_rate=0.2, mcarry0=tc)
    assert_runs_equal(j_out, t_out)


def test_gossip_round_matches_jax_flagship_step():
    """The flagship one-round step (``__graft_entry__``'s config) over nine
    rounds: two crashes, a LEAVE broadcast, quiet rounds past detection,
    then the rejoin of a crashed node and of the leaver."""
    n = 256
    kw = dict(n=n, topology="random", fanout=SimConfig.log_fanout(n),
              remove_broadcast=False, fresh_cooldown=True,
              merge_kernel="pallas", view_dtype="int8", hb_dtype="int16")
    jcfg, tcfg = JaxConfig(**kw), SimConfig(**kw)
    js, ts = jax_init_state(jcfg), init_state(tcfg, device="cpu")
    z = np.zeros(n, bool)
    crash, leave, join = z.copy(), z.copy(), z.copy()
    crash[[3, 50]] = True
    leave[7] = True
    schedule = [(crash, z, z), (z, leave, z)] + [(z, z, z)] * 6 + [
        (z, z, np.isin(np.arange(n), [3, 7]))]
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
    assert ts.round == int(js.round) == len(schedule)
    assert bool(np.asarray(js.alive)[[3, 7]].all())


@pytest.mark.parametrize("n", [256, 10_240, 65_535, 65_536, 65_537])
@pytest.mark.parametrize("seed", [0, 77])
def test_random_in_edges_match_jax_uint16_draw(n, seed):
    """jax draws these edges in uint16 while n - 1 fits (sampled at 32
    bits and cast), in int32 beyond: the port's draw equals both."""
    fanout = 3 if n > 20_000 else 14
    want = np.asarray(jtopo.random_in_edges(jax.random.PRNGKey(seed), n,
                                            fanout))
    got = ttopo.random_in_edges(trandom.PRNGKey(seed, device="cpu"), n, fanout)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        ttopo.in_edges(SimConfig(n=n, topology="random", fanout=fanout),
                       trandom.PRNGKey(seed, device="cpu")).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_edges_match_jax(seed):
    """Random tables, with rows holding no, one and two other members
    (the self-edge fallbacks) and the diagonal listed or not."""
    rng = np.random.default_rng(seed)
    n = 97
    status = rng.integers(0, 3, (n, n)).astype(np.int8)
    status[5] = 0
    status[6] = 0
    status[6, 40] = 1
    status[7] = 0
    status[7, [7, 2, 90]] = 1
    want = np.asarray(jtopo.ring_edges_from_status(jnp.asarray(status)))
    got = ttopo.ring_edges_from_status(torch.from_numpy(status))
    np.testing.assert_array_equal(got.numpy(), want)


def test_presets_match_jax_field_for_field():
    assert set(presets.ALL) == set(jax_presets.ALL)
    for name, js in jax_presets.ALL.items():
        ts = presets.ALL[name]
        assert dataclasses.asdict(ts.config) == dataclasses.asdict(js.config)
        for f in dataclasses.fields(js):
            if f.name != "config":
                assert getattr(ts, f.name) == getattr(js, f.name), (name, f)
