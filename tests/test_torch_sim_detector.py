"""The port's ``SimDetector`` against the JAX package's, and its snapshots.

A crash / leave / join session with SWIM suspicion armed (N = 64, random
edges, the XLA merge on the JAX side; the port's separate-pass round on
the CPU):

* the interactive path (one ``gossip_round`` per round, the edge key
  ``fold_in(key, round)`` with no split) gives the JAX detector's event
  stream, lanes, membership, suspects and suspicion vitals;
* the bulk path (``run_rounds`` per call) gives the JAX bulk stream;
* ``advance_bulk(snapshot_every=k)`` equals one bulk call, and a snapshot
  read after later chunks have rewritten the lanes in place still holds
  its own round's status;
* what is not ported yet (the flight recorder) raises
  ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from gossipfs_tpu.config import SimConfig as JaxConfig
from gossipfs_tpu.detector.sim import SimDetector as JaxDetector
from gossipfs_tpu.suspicion import SuspicionParams as JaxSus
from gossipfs_tpu_torch.config import SimConfig
from gossipfs_tpu_torch.detector.api import FailureDetector
from gossipfs_tpu_torch.detector.sim import SimDetector
from gossipfs_tpu_torch.scenarios import split_halves
from gossipfs_tpu_torch.suspicion import SuspicionParams
from gossipfs_tpu_torch.utils.snapshot import SnapshotBuffer

# one intra-op thread: tier-1 runs several test workers side by side,
# some of them wall-clock socket engines
torch.set_num_threads(1)

N = 64
KW = dict(n=N, topology="random", fanout=6, remove_broadcast=False,
          fresh_cooldown=True, t_fail=3, t_cooldown=6, view_dtype="int8",
          hb_dtype="int16")


def pair():
    j = JaxDetector(JaxConfig(**KW, suspicion=JaxSus(t_suspect=2)), seed=5)
    t = SimDetector(SimConfig(**KW, suspicion=SuspicionParams(t_suspect=2)),
                    seed=5, device="cpu")
    return j, t


def script(d, advance):
    advance(d, 2)
    d.crash(5)
    d.leave(9)
    advance(d, 8)
    d.join(5)
    advance(d, 4)
    d.crash(20)
    advance(d, 7)


def same_state(j, t):
    np.testing.assert_array_equal(t.state.hb.numpy(), np.asarray(j.state.hb))
    np.testing.assert_array_equal(t.state.status.numpy(),
                                  np.asarray(j.state.status))
    np.testing.assert_array_equal(t.state.alive.numpy(),
                                  np.asarray(j.state.alive))
    assert t.state.round == int(j.state.round)


@pytest.mark.parametrize("path", ["interactive", "bulk"])
def test_event_stream_matches_jax(path):
    j, t = pair()
    assert isinstance(t, FailureDetector)
    if path == "interactive":
        def advance(d, r):
            d.advance(r)
    else:
        def advance(d, r):
            d.advance_bulk(r)
    script(j, advance)
    script(t, advance)
    # the two packages' DetectionEvent classes, field for field
    want = [dataclasses.astuple(e) for e in j.drain_events()]
    got = [dataclasses.astuple(e) for e in t.drain_events()]
    assert got == want and any(e[2] == 20 for e in got)
    same_state(j, t)
    assert t.suspicion_status() == j.suspicion_status()
    assert t.suspicion_status()["refutations"] > 0
    for obs in (0, 5, 33):
        assert t.membership(obs) == j.membership(obs)
        assert t.suspects(obs) == j.suspects(obs)
    assert t.alive_nodes() == j.alive_nodes()


def test_snapshots_equal_one_bulk_call_and_own_their_round():
    _, one = pair()
    _, chunked = pair()
    for d in (one, chunked):
        d.advance(2)
        d.crash(5)
    one.advance_bulk(24)
    # a history-keeping buffer (advance_bulk reuses the detector's buffer)
    chunked._snap_buffer = SnapshotBuffer(keep_history=True)
    buf = chunked.advance_bulk(24, snapshot_every=10)
    events = chunked.drain_events()
    assert events and events == one.drain_events()
    for a, b in ((one.state.hb, chunked.state.hb),
                 (one.state.asl, chunked.state.asl),
                 (one.state.alive, chunked.state.alive)):
        assert torch.equal(a, b)
    snaps = buf.history
    assert [s.round for s in snaps] == [12, 22, 26]
    assert buf.latest() is snaps[-1]
    # the first snapshot, read after two more chunks rewrote the lanes in
    # place, still holds round 12: the same as a detector stopped there
    _, ref = pair()
    ref.advance(2)
    ref.crash(5)
    ref.advance_bulk(10)
    first = snaps[0]
    np.testing.assert_array_equal(first.status, ref.state.status.numpy())
    np.testing.assert_array_equal(first.alive, ref.state.alive.numpy())
    assert first.membership(0) == [int(x) for x in np.nonzero(
        ref.state.status[0].numpy() == 1)[0]]
    assert not np.array_equal(first.status, snaps[-1].status)


def test_bulk_failure_reraises_on_the_next_read():
    _, t = pair()
    t._key = None          # the pipeline thread's first chunk fails
    t.advance_bulk(4, snapshot_every=2)
    with pytest.raises(RuntimeError, match="bulk advancement failed"):
        t.drain_events()


def test_unported_surfaces_raise():
    _, t = pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        t.attach_recorder(object())
    # scenarios are ported (tests/test_torch_partition.py): what raises is
    # a scenario of another cluster size
    with pytest.raises(ValueError, match="scenario is for n=8"):
        t.load_scenario(split_halves(8, 0, 2))
    with pytest.raises(ValueError, match="out of range"):
        t.join(N)
