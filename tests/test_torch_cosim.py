"""The port's co-simulation (``cosim.py``) against the JAX package's, on
the CPU.

Both ``CoSim`` objects run the same script over the traffic harness's
protocol profile (N = 32-64, random fanout log2 N, gossip-only, the
port's rounds on K2's plain version): puts, tracked crashes with
detection and delayed re-replication, a master crash with its election
and metadata rebuild, a half/half partition armed on both planes (the
control plane's reachability confined to the master's side), deletes,
and a wipe-out, in both redundancy modes, for ~50 rounds.  After every
step the event log, the detections, the master's metadata, the stores,
the vitals and the traffic status are equal, and the flight-recorder
streams are equal record for record.  ``select_observer`` is a copy.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from gossipfs_tpu import cosim as jcosim
from gossipfs_tpu.obs.recorder import FlightRecorder as JRecorder
from gossipfs_tpu.scenarios import split_halves as jsplit
from gossipfs_tpu.traffic.harness import traffic_config as jconfig
from gossipfs_tpu_torch import cosim as tcosim
from gossipfs_tpu_torch.obs.recorder import FlightRecorder as TRecorder
from gossipfs_tpu_torch.scenarios import split_halves as tsplit
from gossipfs_tpu_torch.traffic.harness import traffic_config as tconfig

torch.set_num_threads(1)


def plain(x):
    if dataclasses.is_dataclass(x):
        return dataclasses.asdict(x)
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


class Pair:
    def __init__(self, n: int, seed: int, **kw):
        self.j = jcosim.CoSim(jconfig(n), seed=seed, **kw)
        self.t = tcosim.CoSim(tconfig(n), seed=seed, device="cpu", **kw)
        self.jrec, self.trec = JRecorder(), TRecorder()
        self.j.attach_recorder(self.jrec)
        self.t.attach_recorder(self.trec)

    def both(self, fn):
        a, b = fn(self.j), fn(self.t)
        assert plain(b) == plain(a)
        return b

    def check(self):
        j, t = self.j, self.t
        assert t.log.entries == j.log.entries
        assert plain(t.events) == plain(j.events)
        assert t.round == j.round
        assert plain(t.cluster.master.files) == plain(j.cluster.master.files)
        assert plain(t.cluster.master.stripes) == \
            plain(j.cluster.master.stripes)
        assert t.cluster.master_node == j.cluster.master_node
        assert {i: s.listing() for i, s in t.cluster.stores.items()} == \
            {i: s.listing() for i, s in j.cluster.stores.items()}
        assert t.vitals() == j.vitals()
        assert t.traffic_status() == j.traffic_status()
        assert [e.to_record() for e in self.trec.events] == \
            [e.to_record() for e in self.jrec.events]

    def tick(self, rounds: int):
        self.j.tick(rounds)
        self.t.tick(rounds)
        self.check()


def payload(i: int) -> bytes:
    return (b"%d|" % i) * (40 + 7 * i)


def run_script(p: Pair, n: int) -> None:
    yes = lambda: True  # noqa: E731
    p.tick(3)
    for i in range(12):
        assert p.both(lambda s: s.put(f"f{i}.txt", payload(i)))
    p.both(lambda s: s.put_batch([(f"g{i}.txt", payload(50 + i))
                                  for i in range(6)], confirm=yes))
    # two replica holders of f0 crash: detection, then re-replication
    # RECOVERY_DELAY rounds later
    victims = [x for x in p.t.cluster.ls("f0.txt")
               if x not in (p.t.cluster.master_node, 0) and x >= 0][:2]
    for v in victims:
        p.both(lambda s: s.detector.crash(v))
    p.tick(8)
    p.tick(8)
    assert p.t.repairs_done > 0
    assert all(e.subject in victims for e in p.t.events
               if not e.false_positive)
    p.both(lambda s: s.get("f0.txt"))
    # the master crashes: its successor is elected and rebuilds metadata
    old = p.t.cluster.master_node
    p.both(lambda s: s.detector.crash(old))
    p.tick(10)
    assert p.t.cluster.master_node != old
    assert p.t.log.grep("Elected new master")
    for i in range(12):
        p.both(lambda s: s.get(f"f{i}.txt"))
    # a half/half split: far-side replicas stop answering the master
    p.both(lambda s: s.load_scenario(
        (jsplit if s is p.j else tsplit)(n, start=1, end=9)))
    p.tick(2)
    for i in range(4):
        p.both(lambda s: s.put(f"f{i}.txt", payload(200 + i), confirm=yes))
        p.both(lambda s: s.put(f"h{i}.txt", payload(300 + i)))
    p.both(lambda s: s.scenario_status())
    p.tick(9)
    p.both(lambda s: s.clear_scenario())
    p.tick(6)
    assert p.both(lambda s: s.delete("f5.txt"))
    for i in range(12):
        p.both(lambda s: s.get(f"f{i}.txt"))
    p.tick(4)


@pytest.mark.parametrize("n,seed", [(32, 0), (48, 5)])
def test_replica_cosim_matches_jax(n, seed):
    p = Pair(n, seed)
    run_script(p, n)
    assert p.t.log.grep("Re-replicated")
    assert any(e.kind == "replica_repair" for e in p.trec.events)


def test_stripe_cosim_matches_jax():
    n = 64
    p = Pair(n, 2, redundancy="stripe", rack_size=8, repair_budget=3)
    run_script(p, n)
    assert p.t.log.grep("Re-encoded")
    assert "stripes_degraded" in p.t.traffic_status()


def test_election_rpc_mode_and_select_observer():
    n = 32
    p = Pair(n, 1, election="rpc")
    p.tick(3)
    old = p.t.cluster.master_node
    p.both(lambda s: s.detector.crash(old))
    p.tick(10)
    # rpc mode: the cluster only flags the pending election
    assert p.t.cluster.master_node == old
    assert p.t.cluster.election_pending
    for view, reach, master in (([1, 2, 3], {2, 3}, 1), ([4, 5], {5, 6}, 4),
                                ([4, 5], set(), 4), ([1], {7, 9}, 1)):
        assert tcosim.select_observer(view, reach, master) == \
            jcosim.select_observer(view, reach, master)
    with pytest.raises(ValueError, match="election"):
        tcosim.CoSim(tconfig(8), election="bogus", device="cpu")
