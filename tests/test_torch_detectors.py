"""The port's ``PackedDetector``: the capacity path of the FailureDetector
seam, against the JAX package.

``SimConfig.packed_rr(1024, fanout=8)``, as the JAX package's own
PackedDetector tests (``tests/test_rounds.py``), on the CPU (the resident
round's plain version):

* a crash is detected at crash + t_fail with its first observer, the one
  the JAX package's run of the same schedule reports;
* a join (an O(N) column and row rewrite between rounds) leaves lanes,
  liveness and bases bit-equal to JAX ``run_rounds`` (XLA merge) with the
  same scheduled matrix events, and restarts the joiner's clocks;
* a crash and a join of one node in one round end with it alive;
* a rejoin within the fail-list cooldown is not re-added by the receivers
  that hold the FAILED entry, only by the introducer;
* membership drops a crashed node once gossip converges;
* on the Lifeguard lane the carried suspect and member counts equal a
  recount of the lanes, across a join.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.core.rounds import run_rounds as jax_run_rounds
from gossipfs_tpu.core.state import RoundEvents as JaxEvents
from gossipfs_tpu.core.state import init_state as jax_init_state
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.convert import to_numpy
from gossipfs_tpu_torch.core.state import member_counts, suspect_counts
from gossipfs_tpu_torch.detector.api import FailureDetector
from gossipfs_tpu_torch.detector.sim import PackedDetector
from gossipfs_tpu_torch.suspicion import SuspicionParams

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N, FANOUT = 1024, 8
LH = dict(t_suspect=2, lh_multiplier=3, lh_frac=0.03125)


def port_cfg(lh: bool = False) -> SimConfig:
    if lh:
        return SimConfig.suspicion_rr(N, fanout=FANOUT,
                                      suspicion=SuspicionParams(**LH))
    return SimConfig.packed_rr(N, fanout=FANOUT)


def jax_cfg(lh: bool = False) -> JaxConfig:
    if lh:
        cfg = JaxConfig.suspicion_rr(N, fanout=FANOUT,
                                     suspicion=JaxSus(**LH))
    else:
        cfg = JaxConfig.packed_rr(N, fanout=FANOUT)
    return dataclasses.replace(cfg, merge_kernel="xla")


def jax_schedule(rounds: int, crash: dict, join: dict, lh: bool = False):
    """JAX ``run_rounds`` (XLA merge) with scheduled matrix events:
    ``crash``/``join`` map a round to the nodes of that round."""
    ev = np.zeros((rounds, N), dtype=bool)
    jn = np.zeros((rounds, N), dtype=bool)
    for r, nodes in crash.items():
        ev[r, nodes] = True
    for r, nodes in join.items():
        jn[r, nodes] = True
    z = jnp.zeros((rounds, N), dtype=bool)
    cfg = jax_cfg(lh)
    return jax_run_rounds(jax_init_state(cfg), cfg, rounds,
                          jax.random.PRNGKey(3),
                          events=JaxEvents(crash=jnp.asarray(ev), leave=z,
                                           join=jnp.asarray(jn)))


def assert_lanes_equal(d: PackedDetector, js):
    got = to_numpy(d.lanes())
    for k in ("hb", "age", "status", "alive", "hb_base"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(js, k)),
                                      err_msg=k)


def test_crash_detected_at_t_fail_with_first_observer():
    d = PackedDetector(port_cfg(), seed=3, device="cpu")
    assert isinstance(d, FailureDetector)
    d.advance(3)
    d.crash(5)
    d.advance(8)
    ev = [e for e in d.drain_events() if e.subject == 5]
    assert len(ev) == 1 and ev[0].round == 8      # crash@3 + t_fail 5
    assert not ev[0].false_positive
    assert 5 not in d.alive_nodes() and d.round == 11
    _, jc, _ = jax_schedule(11, {3: [5]}, {})
    assert int(jc.first_detect[5]) == 8
    assert ev[0].observer == int(jc.first_observer[5])


def test_join_matches_matrix_scan_bit_for_bit():
    d = PackedDetector(port_cfg(), seed=3, device="cpu")
    d.advance(2)
    d.crash(7)
    d.advance(10)          # detection (t_fail 5) + cooldown expiry
    d.join(7)
    d.advance(8)
    assert 7 in d.alive_nodes()
    js, _, _ = jax_schedule(20, {2: [7]}, {12: [7]})
    assert_lanes_equal(d, js)
    # a rejoin restarts the subject's detection clock in the carry
    assert int(d._mcarry.first_detect[7]) == -1


def test_same_round_crash_and_join_leaves_node_alive():
    d = PackedDetector(port_cfg(), seed=3, device="cpu")
    d.advance(2)
    d.crash(7)
    d.join(7)
    d.advance(3)
    assert 7 in d.alive_nodes()
    js, _, _ = jax_schedule(5, {2: [7]}, {2: [7]})
    assert_lanes_equal(d, js)


def test_rejoin_within_cooldown_is_suppressed():
    cfg = port_cfg()
    d = PackedDetector(cfg, seed=3, device="cpu")
    d.advance(2)
    d.crash(7)
    d.advance(7)   # detected at round 7, inside the t_cooldown 12 window
    d.join(7)
    d.advance(1)
    assert 7 in d.alive_nodes()
    assert 7 in d.membership(7)
    others = [m for m in (1, 2, 3) if m != cfg.introducer]
    assert any(7 not in d.membership(m) for m in others)
    # gossip re-spreads the fresh incarnation once the cooldown expires
    d.advance(30)
    assert 7 in d.membership(others[0])


def test_membership_drops_after_convergence():
    d = PackedDetector(port_cfg(), device="cpu")
    d.advance(3)
    d.crash(9)
    d.advance(16)  # detection + gossip diameter
    assert 9 not in d.membership(0)
    assert len(d.membership(0)) == N - 1


def test_lifeguard_lane_carries_counts_across_a_join():
    d = PackedDetector(port_cfg(lh=True), seed=3, device="cpu")
    d.advance(2)
    d.crash(7)
    d.leave(11)
    d.advance(10)
    d.join(7)
    d.advance(6)
    js, jc, _ = jax_schedule(18, {2: [7, 11]}, {12: [7]}, lh=True)
    assert_lanes_equal(d, js)
    lanes = d.lanes()
    assert torch.equal(d._counts, member_counts(lanes, True))
    assert torch.equal(d._sus_counts, suspect_counts(lanes))
    assert int(d._sus_counts.sum()) > 0
    np.testing.assert_array_equal(d._mcarry.first_suspect.numpy(),
                                  np.asarray(jc.first_suspect))


def test_rejects_configs_off_the_lean_loop():
    for cfg in (SimConfig(n=64), SimConfig.packed_rr(1_030),
                SimConfig.packed_rr(N, merge_kernel="xla")):
        with pytest.raises(ValueError, match="resident-round"):
            PackedDetector(cfg, device="cpu")
    d = PackedDetector(port_cfg(), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        d.crash(N)
