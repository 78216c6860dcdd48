"""The port's asyncio UDP engine against the JAX package's, in lockstep.

Both packages' ``UdpCluster`` run with no socket and no event loop: every
node's ``_now`` reads one shared fake clock, its transport is an
in-memory queue that ``_send`` writes through (the scenario hook and the
wire accounting run as on a socket), and a tick is every live node's
``tick()`` followed by delivering the queue, in order, until it is empty.
The per-node random streams are the packages' own.  For seeded runs of
30 ticks with a crash, a leave, suspicion on, and a scenario armed, the
two packages end with the same member tables and fail lists, drain the
same detection events, record the same obs rows and report the same
vitals.
"""

from __future__ import annotations

import collections
import json

import pytest

from gossipfs_tpu.detector import udp as judp
from gossipfs_tpu.obs.recorder import FlightRecorder as JRecorder
from gossipfs_tpu.scenarios.schedule import FaultScenario as JScenario
from gossipfs_tpu.suspicion.params import SuspicionParams as JSus
from gossipfs_tpu_torch.detector import udp as tudp
from gossipfs_tpu_torch.obs.recorder import FlightRecorder as TRecorder
from gossipfs_tpu_torch.scenarios.schedule import FaultScenario as TScenario
from gossipfs_tpu_torch.suspicion.params import SuspicionParams as TSus

N = 10
BASE = 40_000   # addresses only: nothing binds in lockstep
TICKS = 30
PKGS = {
    "jax": (judp, JRecorder, JScenario, JSus),
    "torch": (tudp, TRecorder, TScenario, TSus),
}

SCENARIO = {
    "name": "lockstep", "n": N, "seed": 3,
    "flapping": [{"start": 2, "end": 20, "up": 2, "down": 2,
                  "nodes": [7]}],
    "outages": [{"start": 12, "end": 17, "nodes": [2, 3]}],
    "link_faults": [{"start": 0, "end": 30, "rate": 0.2,
                     "src": [1, 5], "dst": [0, 8, 9]}],
    "slow_nodes": [{"start": 4, "end": 14, "stride": 2, "nodes": [6]}],
}

CONFIGS = {
    # the reference ring: REMOVE broadcast, faithful cooldown
    "ring": dict(cluster=dict(push="ring"), suspicion=None,
                 scenario=False, plan={6: ("crash", 4), 11: ("leave", 8)}),
    # the campaign profile with SWIM suspicion and Lifeguard, scenario on
    "random_suspicion": dict(
        cluster=dict(push="random", fanout=3, remove_broadcast=False,
                     fresh_cooldown=True),
        suspicion=dict(t_suspect=2, lh_multiplier=2, lh_frac=0.25),
        scenario=True, plan={5: ("crash", 4), 9: ("leave", 8)}),
    # ring with suspicion: all-peer SUSPECT broadcasts, incarnation bumps
    "ring_suspicion": dict(
        cluster=dict(push="ring", fresh_cooldown=True),
        suspicion=dict(t_suspect=3, lh_multiplier=0, lh_frac=0.25),
        scenario=True, plan={8: ("crash", 1), 14: ("leave", 9)}),
    # delta piggyback frames between full anti-entropy pushes
    "delta": dict(
        cluster=dict(push="random", fanout=2, remove_broadcast=False,
                     fresh_cooldown=True, delta=True, delta_entries=3,
                     anti_entropy_every=2),
        suspicion=None, scenario=True, plan={10: ("crash", 6)}),
}


class _Queue:
    """An in-memory transport: ``sendto`` appends (dst index, bytes)."""

    def __init__(self, q):
        self.q = q

    def sendto(self, data: bytes, addr) -> None:
        self.q.append((addr[1] - BASE, data))

    def close(self) -> None:
        pass


def _run(pkg: str, conf: dict) -> dict:
    udp, Recorder, Scenario, Sus = PKGS[pkg]
    clock = [1_000.0]
    q = collections.deque()
    sus = None if conf["suspicion"] is None else Sus(**conf["suspicion"])
    cluster = udp.UdpCluster(N, base_port=BASE, period=1.0, t_fail=3,
                             t_cooldown=5, min_group=4, suspicion=sus,
                             **conf["cluster"])
    for node in cluster.nodes:
        node._now = lambda: clock[0]
        node.alive = True
        node.transport = _Queue(q)
        node.members = {m.addr: udp._Member(0, clock[0])
                        for m in cluster.nodes}
    rec = Recorder(source="lockstep", n=N)
    cluster.attach_recorder(rec)
    if conf["scenario"]:
        cluster.load_scenario(Scenario.from_json(json.dumps(SCENARIO)))
    for r in range(TICKS):
        op = conf["plan"].get(r)
        if op is not None:
            getattr(cluster, op[0])(op[1])
        for node in cluster.nodes:
            if node.alive:
                node.tick()
        while q:
            dst, data = q.popleft()
            cluster.nodes[dst].handle(data.decode(), None)
        clock[0] += cluster.period
        cluster._round += 1
    return {
        "members": [{a: (m.hb, m.ts, m.ver) for a, m in node.members.items()}
                    for node in cluster.nodes],
        "fail_lists": [dict(node.fail_list) for node in cluster.nodes],
        "suspects": [cluster.suspects(i) for i in range(N)],
        "events": [(e.round, e.observer, e.subject, e.false_positive)
                   for e in cluster.drain_events()],
        "obs": [e.to_record() for e in rec.events],
        "vitals": cluster.vitals(),
        "suspicion": cluster.suspicion_status(),
    }


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_lockstep_matches_jax(name):
    conf = CONFIGS[name]
    want = _run("jax", conf)
    got = _run("torch", conf)
    assert got == want
    # the run exercised what it was built for: a detection of the crashed
    # node, and (with suspicion) the suspect/refute lifecycle
    crashed = next(v[1] for v in conf["plan"].values() if v[0] == "crash")
    assert any(e[2] == crashed and not e[3] for e in got["events"])
    kinds = {r["kind"] for r in got["obs"]}
    assert "confirm" in kinds and "remove" in kinds
    if conf["suspicion"] is not None:
        assert "suspect" in kinds
    if conf["cluster"].get("delta"):
        assert got["vitals"]["frames_delta"] > 0
        assert got["vitals"]["frames_full"] > 0


def test_node_random_stream_matches_jax():
    for idx in range(N):
        a = judp.UdpNode(None, idx, BASE + idx)._rng
        b = tudp.UdpNode(None, idx, BASE + idx)._rng
        assert [a.random() for _ in range(8)] == [b.random() for _ in range(8)]
