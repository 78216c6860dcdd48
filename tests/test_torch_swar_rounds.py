"""The separate-pass round's SWAR form, bit for bit against JAX.

``elementwise="swar"`` on the separate-pass loop: the tick runs on packed
words (core/rounds._tick_swar, in the port's packed age|status layout),
and the scenario-armed aligned-arc merge runs the SWAR epilogue
(ops/merge_update.membership_update_swar); the merge kernels K2/K4/K5
keep their lanes epilogue, as the JAX package's kernels do.  Against the
JAX package's ``run_rounds`` with ``elementwise="swar"`` and
``merge_kernel="xla"`` (its SWAR tick and SWAR epilogue in XLA):

* suspicion off and on (with the Lifeguard lane), churn with joins;
* REMOVE broadcast (the tick's second pass) and the reference cooldown
  (a detection keeps its age);
* the deep-shift int8 wrap regime: 300 rounds with rejoins, past the
  126-round rebase window, the bases following rejoined diagonals down;
* aligned arcs under a scenario with joins (the SWAR epilogue);
* a ragged N, which takes the lanes tick as in the JAX package;

lanes, carry and all six metrics exact.  Then ``_tick_swar`` and
``membership_update_swar`` against the JAX package's ``_tick_swar`` and
``_membership_update_swar`` directly, on random lanes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu import scenarios as jscn
from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core import rounds as JR
from gossipfs_tpu.core.state import SimState as JaxState
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.scenarios import tensor as jtensor
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch import random as trandom
from gossipfs_tpu_torch import scenarios as tscn
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import from_jax_arrays, to_numpy
from gossipfs_tpu_torch.core import rounds as R
from gossipfs_tpu_torch.core.state import (
    MEMBER, SUSPECT, init_state, swar_lanes_ok)
from gossipfs_tpu_torch.ops import merge, merge_update, swar
from gossipfs_tpu_torch.scenarios import tensor as ttensor
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

HEADLINE = dict(topology="random_arc", fanout=16, arc_align=8,
                remove_broadcast=False, fresh_cooldown=True, t_cooldown=12,
                view_dtype="int8", hb_dtype="int8", elementwise="swar")
RANDOM = dict(topology="random", fanout=8, view_dtype="int8",
              hb_dtype="int8", elementwise="swar")
LH = dict(t_suspect=2, lh_multiplier=3, lh_frac=0.03125)


def configs(kw: dict, sus: dict | None = None):
    jkw, tkw = dict(kw), dict(kw)
    if sus is not None:
        jkw["suspicion"] = JaxSus(**sus)
        tkw["suspicion"] = SuspicionParams(**sus)
    return JaxConfig(merge_kernel="xla", **jkw), SimConfig(**tkw)


def compare(jout, tout):
    (js, jc, jm), (ts, tc, tm) = jout, tout
    got = to_numpy(ts, tc)
    for k in ("hb", "age", "status", "alive", "hb_base", *jc._fields):
        want = getattr(js, k) if hasattr(js, k) else getattr(jc, k)
        np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=k)
    for k in jm._fields:
        np.testing.assert_array_equal(getattr(tm, k).numpy(),
                                      np.asarray(getattr(jm, k)), err_msg=k)


def run_pair(jcfg, tcfg, rounds: int, seed: int, jsc=None, tsc=None, **kw):
    jout = JR.run_rounds(jax_init_state(jcfg), jcfg, rounds,
                         jax.random.PRNGKey(seed), scenario=jsc, **kw)
    merge.reset_launch_counts()
    tout = R.run_rounds(init_state(tcfg, device="cpu"), tcfg, rounds,
                        trandom.PRNGKey(seed, device="cpu"), scenario=tsc,
                        **kw)
    assert not any(merge.LAUNCH_COUNTS.values())     # plain on the CPU
    compare(jout, tout)
    return jout


CASES = {
    "headline, joins": (dict(n=256, **HEADLINE), None),
    "headline, suspicion + lh, joins": (dict(n=256, **dict(HEADLINE,
                                                           t_fail=3)), LH),
    "random, REMOVE broadcast": (dict(n=256, **RANDOM), None),
    "random, gossip-only, reference cooldown": (
        dict(n=256, remove_broadcast=False, **RANDOM), None),
    "random, suspicion": (
        dict(n=256, remove_broadcast=False, fresh_cooldown=True, t_fail=3,
             **RANDOM), dict(t_suspect=2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_separate_pass_swar_matches_jax(case):
    kw, sus = CASES[case]
    jcfg, tcfg = configs(kw, sus)
    assert R.route(tcfg, matrix_events=True)[0] == "separate"
    _, _, jm = run_pair(jcfg, tcfg, 40, 3, crash_rate=0.03, rejoin_rate=0.05)
    assert int(np.asarray(jm.true_detections).sum()) > 0
    if sus is not None:
        assert int(np.asarray(jm.suspects_entered).sum()) > 0


def test_deep_shift_int8_wrap_regime():
    """300 rounds with rejoins at N = 256: past the 126-round window, and
    a rejoin drops the subject's base, so shifts fall below -128 and the
    lanes' int8 arithmetic wraps (the JAX package's swar parity runs)."""
    jcfg, tcfg = configs(dict(n=256, **HEADLINE))
    js, _, _ = run_pair(jcfg, tcfg, 300, 11, crash_rate=0.01,
                        rejoin_rate=0.05)
    assert int(jnp.max(js.hb_base)) > 126


def arc_scenario(mod, n):
    return mod.FaultScenario(
        name="split+flap", n=n,
        partitions=(mod.Partition(start=2, end=12,
                                  groups=(tuple(range(n // 2)),)),),
        flapping=(mod.Flapping(start=1, end=16, up=2, down=2,
                               nodes=tuple(range(n // 2, n // 2 + 12))),))


@pytest.mark.parametrize("sus", [None, LH], ids=["crash-only", "sus+lh"])
def test_armed_arcs_with_joins_run_the_swar_epilogue(sus):
    """Joins put an armed aligned-arc run on the separate-pass loop, whose
    masked group max and epilogue (``arc_group_merge_update``) run on
    packed words under ``elementwise="swar"``, as the JAX package's XLA
    path does."""
    n = 256
    jcfg, tcfg = configs(dict(n=n, **dict(HEADLINE, t_fail=3)), sus)
    jsc = jtensor.compile_tensor(arc_scenario(jscn, n))
    tsc = ttensor.compile_tensor(arc_scenario(tscn, n), device="cpu")
    assert R.route(tcfg, True, tsc) == ("separate", "arc_group_merge_update")
    _, _, jm = run_pair(jcfg, tcfg, 20, 5, jsc, tsc, crash_rate=0.03,
                        rejoin_rate=0.05)
    assert int(np.asarray(jm.true_detections).sum()) > 0


def test_ragged_n_takes_the_lanes_tick():
    """N % 4 != 0: the SWAR form cannot pack the lanes, so the tick runs
    its lanes form (the JAX package's dispatch), and the run still equals
    the JAX package's SWAR-configured one."""
    jcfg, tcfg = configs(dict(n=254, **RANDOM))
    assert not swar_lanes_ok(init_state(tcfg, device="cpu").hb)
    assert R.route(tcfg) == ("separate", "fused_merge_update")
    run_pair(jcfg, tcfg, 20, 2, crash_rate=0.03)


def random_jax_state(n: int, seed: int, sus: bool) -> JaxState:
    rng = np.random.default_rng(seed)
    hb = rng.integers(-128, 128, (n, n), dtype=np.int8)
    hb[rng.random((n, n)) < 0.05] = -128
    st = rng.integers(0, 4 if sus else 3, (n, n)).astype(np.int8)
    age = np.where(st == 3, rng.integers(2, 14, (n, n)),
                   rng.integers(0, 64, (n, n))).astype(np.int8)
    return JaxState(hb=jnp.asarray(hb), age=jnp.asarray(age),
                    status=jnp.asarray(st),
                    alive=jnp.asarray(rng.random(n) < 0.9),
                    round=jnp.int32(7),
                    hb_base=jnp.asarray(rng.integers(0, 400, n)
                                        .astype(np.int32)))


TICKS = {
    "fresh cooldown": (dict(remove_broadcast=False, fresh_cooldown=True,
                            t_cooldown=12), None),
    "REMOVE broadcast": (dict(), None),
    "reference cooldown": (dict(remove_broadcast=False), None),
    "suspicion": (dict(remove_broadcast=False, t_fail=3,
                       fresh_cooldown=True), dict(t_suspect=2)),
    "suspicion + lh, fresh": (dict(remove_broadcast=False, t_fail=3,
                                   fresh_cooldown=True), LH),
}


@pytest.mark.parametrize("case", list(TICKS))
def test_tick_swar_matches_the_jax_package(case):
    """One tick on random lanes (every status, ages to the clamp, floor
    sentinels, large bases, mixed sender / refresher rows): the lanes,
    the detections per subject and their first observer, and the
    entries that entered SUSPECT."""
    n = 128
    kw, sus = TICKS[case]
    jcfg, tcfg = configs(dict(n=n, **dict(RANDOM, **kw)), sus)
    js = random_jax_state(n, 4, sus is not None)
    rng = np.random.default_rng(9)
    small = rng.random(n) < 0.3
    alive = np.asarray(js.alive)
    active, refresher = alive & ~small, alive & small
    jout, jfail = JR._tick_swar(js, jcfg, active=jnp.asarray(active),
                                refresher=jnp.asarray(refresher))
    ts, _ = from_jax_arrays(js.hb, js.age, js.status, js.alive, js.hb_base,
                            js.round, device="cpu")
    n_det, first_obs, entered = R._tick_swar(
        ts, tcfg, torch.from_numpy(active), torch.from_numpy(refresher),
        stats=True)
    got = to_numpy(ts)
    for k in ("hb", "age", "status"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jout, k)),
                                      err_msg=k)
    fail = np.asarray(jfail)
    np.testing.assert_array_equal(n_det.numpy(), fail.sum(0))
    np.testing.assert_array_equal(first_obs.numpy(), fail.argmax(0))
    assert fail.sum() > 0
    if sus is not None:
        went = ((np.asarray(js.status) == MEMBER)
                & (np.asarray(jout.status) == SUSPECT))
        np.testing.assert_array_equal(entered.numpy(), went.sum(0))
        assert went.sum() > 0


@pytest.mark.parametrize("sus", [False, True], ids=["crash-only", "suspicion"])
def test_membership_update_swar_matches_the_jax_package(sus):
    """The SWAR epilogue on random lanes, views and deep shifts (both
    signs of ``shift_b``, ``shift_a`` below -128) against the JAX
    package's ``_membership_update_swar``."""
    n = 128
    jcfg, tcfg = configs(dict(n=n, remove_broadcast=False,
                              fresh_cooldown=True, **RANDOM),
                         dict(t_suspect=2) if sus else None)
    js = random_jax_state(n, 6, sus)
    rng = np.random.default_rng(8)
    best = rng.integers(-1, 127, (n, n)).astype(np.int8)
    best[rng.random((n, n)) < 0.3] = -1
    sa = rng.integers(-300, 60, n).astype(np.int32)
    sb = np.where(rng.random(n) < 0.5, sa,
                  rng.integers(-300, 60, n)).astype(np.int32)
    hb, age, status = JR._membership_update_swar(
        js, jnp.asarray(best), jnp.asarray(sa), jnp.asarray(sb), jcfg)
    ts, _ = from_jax_arrays(js.hb, js.age, js.status, js.alive, js.hb_base,
                            js.round, device="cpu")
    t = torch.from_numpy
    vw = swar.pack(merge.threshold_stack(t(sa), t(sb), t(sa) * 0, 0))
    hw, aw, *_ = merge_update.membership_update_swar(
        swar.pack(t(best)), swar.pack(ts.hb), swar.pack(ts.asl),
        swar.bool_mask(ts.alive)[:, None], vw, 63, sus)
    out, _ = from_jax_arrays(hb, age, status, js.alive, js.hb_base,
                             js.round, device="cpu")
    assert torch.equal(swar.unpack(hw), out.hb)
    assert torch.equal(swar.unpack(aw), out.asl)
