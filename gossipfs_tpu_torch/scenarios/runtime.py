"""Per-message scenario evaluation for the socket engines.

The reference implementation of the drop semantics in
``scenarios.schedule``: the asyncio UDP cluster and the per-process
deployment both consult :meth:`ScenarioRuntime.drops` from their
datagram send hook (``detector/udp.py`` ``UdpNode._send``), so a
datagram either leaves the sender or it does not — receivers never know
the scenario exists, exactly like a real netsplit.

Bernoulli loss draws come from one ``random.Random`` stream per runtime
(seeded from the scenario's ``seed``); socket engines are real-time and
not bit-reproducible anyway, so per-message stream position is fine.
The tensor engine uses counter-based draws instead
(``scenarios.tensor.filter_edges``) to stay scan/jit-deterministic.

The port's own copy of the JAX package's ``scenarios/runtime.py``: the
per-message semantics the tensor backend is held against in the tests.
"""

from __future__ import annotations

import random

from gossipfs_tpu_torch.scenarios.schedule import FaultScenario


class ScenarioRuntime:
    """Evaluates one armed scenario: ``drops(src, dst, rnd)`` per message.

    ``rnd`` is the engine's round counter minus the arming round (the
    caller owns the clock: the in-process UDP cluster counts periods,
    the deployment divides wall time since ``ScenarioLoad`` by the
    gossip period).
    """

    def __init__(self, scenario: FaultScenario):
        self.scenario = scenario
        self._rng = random.Random(scenario.seed)
        # frozen-set membership per rule: the hook runs per datagram
        sc = scenario
        self._parts = [(p.start, p.end, p.pid(sc.n)) for p in sc.partitions]
        self._losses = [
            (f.start, f.end, f.rate, frozenset(f.src), frozenset(f.dst))
            for f in sc.link_faults
        ]
        self._slows = [
            (s.start, s.end, s.stride, frozenset(s.nodes))
            for s in sc.slow_nodes
        ]
        self._flaps = [
            (f, frozenset(f.nodes)) for f in sc.flapping
        ]
        self._outs = [
            (o.start, o.end, frozenset(o.nodes)) for o in sc.outages
        ]

    def drops(self, src: int, dst: int, rnd: int) -> bool:
        """Whether the src -> dst message at round ``rnd`` is dropped."""
        for start, end, pid in self._parts:
            if start <= rnd < end and pid[src] != pid[dst]:
                return True
        for start, end, stride, nodes in self._slows:
            if start <= rnd < end and src in nodes and rnd % stride != 0:
                return True
        for rule, nodes in self._flaps:
            # dark-phase flappers: every outgoing datagram drops (the
            # node keeps ticking — gray failure, not crash)
            if src in nodes and rule.down_at(rnd):
                return True
        for start, end, nodes in self._outs:
            # correlated blackout: the group talks to NO ONE, itself
            # included (the shared switch died)
            if start <= rnd < end and (src in nodes or dst in nodes):
                return True
        for start, end, rate, src_set, dst_set in self._losses:
            if (start <= rnd < end and src in src_set and dst in dst_set
                    and self._rng.random() < rate):
                return True
        return False

    def status(self, rnd: int) -> dict:
        """One status document (the ``scenario status`` verb / RPC)."""
        return self.scenario.status(rnd)
