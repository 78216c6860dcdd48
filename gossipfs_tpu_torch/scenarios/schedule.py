"""Declarative fault scenarios: timed partitions, link faults, slow nodes.

The reference's fault model is crash-stop (CTRL+C) plus voluntary
leave/join — the ``RoundEvents`` masks.  Real gossip deployments die from
*partial* failures instead: netsplits, lossy links, asymmetric
reachability, nodes that lag.  A :class:`FaultScenario` is a typed,
JSON-loadable schedule of such faults that compiles onto all three
transport engines from ONE file:

  * the tensor sim — edge filters on the sampled [N, F] in-edge set
    (``scenarios.tensor.filter_edges``, applied inside the round scan);
  * the asyncio UDP engine — a drop rule at the datagram send hook
    (``detector/udp.py`` ``UdpNode._send``);
  * the per-process deployment — the same rule table pushed to every
    node daemon over the control plane (``ScenarioLoad`` RPC).

Semantics, identical everywhere (``scenarios.runtime.ScenarioRuntime``
is the reference implementation): a message from ``src`` to ``dst`` at
round ``r`` (rounds counted from the moment the scenario is ARMED on
that engine) is dropped iff any active rule says so —

  * :class:`Partition`  — active and src/dst fall in different groups;
  * :class:`LinkFault`  — active, src in ``src_set``, dst in
    ``dst_set``: Bernoulli drop with probability ``rate`` (``rate=1.0``
    in one direction only models an asymmetric link);
  * :class:`SlowNode`   — active, src is slow, and the round is not a
    multiple of ``stride``: the node's messages only get out every
    ``stride``-th round (it lags, synchronous-round style);
  * :class:`Flapping`   — active, src flaps, and the duty cycle is in
    its dark phase: the node's outgoing datagrams all drop for ``down``
    consecutive rounds out of every ``up + down`` (Lifeguard's gray
    failure — the node looks dead long enough to be suspected, then
    comes back and looks like a false positive);
  * :class:`CorrelatedOutage` — active and src OR dst sits in the
    group: a rack/zone-sized blackout (the top-of-rack switch died —
    members cannot even reach each other), the correlated-failure
    class that makes per-node-independent repair placement lose whole
    replica sets at once.

Faults affect TRANSPORT only — nodes keep ticking, bumping their own
heartbeats and detecting; what changes is which datagrams arrive.  Heal
events are just the ``end`` round of each rule window.

Node selectors in JSON: an int list ``[0, 3, 7]``, a half-open range
``{"range": [0, 512]}``, or ``"all"``.  Example::

    {"name": "halves", "n": 1024, "seed": 0,
     "partitions": [{"start": 5, "end": 40,
                     "groups": [{"range": [0, 512]}]}],
     "link_faults": [{"start": 0, "end": 5, "rate": 0.3,
                      "src": "all", "dst": [7]}]}

Nodes left out of every partition group form one implicit "rest" group.

The port's own copy of the JAX package's ``scenarios/schedule.py`` (numpy
only; the port imports nothing of that package), kept equal to it: the
JSON codec and every query give the same answers.  Of the three engines
above the port holds the tensor one (``scenarios/tensor.py``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence

import numpy as np

Selector = object  # "all" | list[int] | {"range": [lo, hi)}


def expand_selector(sel: Selector, n: int) -> tuple[int, ...]:
    """Normalize a JSON node selector to a sorted id tuple (see module doc)."""
    if sel == "all":
        return tuple(range(n))
    if isinstance(sel, dict):
        lo, hi = sel["range"]
        if not 0 <= lo < hi <= n:
            raise ValueError(f"range {sel['range']} outside [0, {n})")
        return tuple(range(int(lo), int(hi)))
    nodes = tuple(sorted(int(x) for x in sel))
    for x in nodes:
        if not 0 <= x < n:
            raise ValueError(f"node id {x} out of range [0, {n})")
    if len(set(nodes)) != len(nodes):
        raise ValueError(f"duplicate node ids in selector: {sel}")
    return nodes


@dataclasses.dataclass(frozen=True)
class Partition:
    """Cluster split over rounds [start, end): cross-group messages drop.

    ``groups`` are disjoint; nodes in none of them form the implicit
    rest group.  ``end`` is the heal round (the first round messages
    flow again).
    """

    start: int
    end: int
    groups: tuple[tuple[int, ...], ...]

    def pid(self, n: int) -> np.ndarray:
        """int32 [N] partition id: group k -> k+1, the rest -> 0."""
        pid = np.zeros((n,), dtype=np.int32)
        for k, g in enumerate(self.groups):
            pid[list(g)] = k + 1
        return pid


@dataclasses.dataclass(frozen=True)
class LinkFault:
    """Bernoulli loss on the directed src -> dst links over [start, end).

    ``rate=1.0`` is a total directional blackout — one such rule without
    its reverse models asymmetric reachability.
    """

    start: int
    end: int
    rate: float
    src: tuple[int, ...]
    dst: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class SlowNode:
    """Lagging senders: over [start, end) their messages only get out on
    rounds that are multiples of ``stride``."""

    start: int
    end: int
    stride: int
    nodes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Flapping:
    """Flapping senders: over [start, end) the nodes cycle ``up`` rounds
    healthy then ``down`` rounds DARK (every outgoing datagram drops),
    repeating.  The node itself keeps ticking — bumping its own
    heartbeat, detecting — so each recovery re-announces a counter that
    advanced through the dark phase: the gray-failure shape that storms
    a raw short t_fail with false positives and that SWIM suspicion
    exists to absorb (a ``down`` within the suspect window refutes; a
    ``down`` past it confirms a live node FAILED).
    """

    start: int
    end: int
    up: int
    down: int
    nodes: tuple[int, ...]

    def down_at(self, rnd: int) -> bool:
        """Whether the rule's nodes are in the dark phase at ``rnd``."""
        if not self.start <= rnd < self.end:
            return False
        return (rnd - self.start) % (self.up + self.down) >= self.up


@dataclasses.dataclass(frozen=True)
class CorrelatedOutage:
    """Correlated-failure group: over [start, end) every message with
    src OR dst in the group drops — a rack/zone blackout (the shared
    switch died; group members cannot even reach each other).  Unlike a
    :class:`Partition` group (which keeps internal connectivity) the
    whole group goes dark at once, and unlike crash events the nodes
    keep running: at ``end`` they resurface with views frozen at the
    outage start."""

    start: int
    end: int
    nodes: tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One declarative fault schedule (see module docstring).

    Round numbers are RELATIVE to when the scenario is armed on an
    engine (``load_scenario`` / construction), so the same file drives
    a sim started at round 0 and a socket cluster armed mid-run.
    """

    name: str
    n: int
    partitions: tuple[Partition, ...] = ()
    link_faults: tuple[LinkFault, ...] = ()
    slow_nodes: tuple[SlowNode, ...] = ()
    seed: int = 0  # Bernoulli-loss stream id (each engine derives its own)
    # round-13 gray-failure primitives (after ``seed`` so positional
    # construction of the round-7 fields stays valid)
    flapping: tuple[Flapping, ...] = ()
    outages: tuple[CorrelatedOutage, ...] = ()

    def __post_init__(self) -> None:
        if self.n < 2:
            raise ValueError(f"n must be >= 2, got {self.n}")
        for p in self.partitions:
            self._check_window(p.start, p.end, "partition")
            seen: set[int] = set()
            for g in p.groups:
                if not g:
                    raise ValueError("empty partition group")
                overlap = seen & set(g)
                if overlap:
                    raise ValueError(
                        f"partition groups overlap on nodes {sorted(overlap)}"
                    )
                seen |= set(g)
                for x in g:
                    self._check_node(x)
        for lf in self.link_faults:
            self._check_window(lf.start, lf.end, "link_fault")
            if not 0.0 < lf.rate <= 1.0:
                raise ValueError(f"link fault rate must be in (0, 1], got {lf.rate}")
            for x in (*lf.src, *lf.dst):
                self._check_node(x)
        for s in self.slow_nodes:
            self._check_window(s.start, s.end, "slow_node")
            if s.stride < 2:
                raise ValueError(f"slow stride must be >= 2, got {s.stride}")
            for x in s.nodes:
                self._check_node(x)
        for fl in self.flapping:
            self._check_window(fl.start, fl.end, "flapping")
            if fl.up < 1 or fl.down < 1:
                raise ValueError(
                    f"flapping needs up >= 1 and down >= 1, got "
                    f"up={fl.up} down={fl.down}")
            if not fl.nodes:
                raise ValueError("empty flapping node set")
            for x in fl.nodes:
                self._check_node(x)
        for o in self.outages:
            self._check_window(o.start, o.end, "outage")
            if not o.nodes:
                raise ValueError("empty outage group")
            for x in o.nodes:
                self._check_node(x)

    def _check_window(self, start: int, end: int, kind: str) -> None:
        if start < 0 or end <= start:
            raise ValueError(f"{kind} window must have 0 <= start < end, "
                             f"got [{start}, {end})")

    def _check_node(self, x: int) -> None:
        if not 0 <= x < self.n:
            raise ValueError(f"node id {x} out of range [0, {self.n})")

    # -- queries ------------------------------------------------------------
    def _rules(self):
        return (*self.partitions, *self.link_faults, *self.slow_nodes,
                *self.flapping, *self.outages)

    @property
    def horizon(self) -> int:
        """First round past every rule window (all links healthy after)."""
        return max((r.end for r in self._rules()), default=0)

    def active_at(self, rnd: int) -> bool:
        """Any rule active at (armed-relative) round ``rnd``."""
        return any(r.start <= rnd < r.end for r in self._rules())

    def unreachable_at(self, rnd: int) -> set[int]:
        """Nodes no datagram can LEAVE at round ``rnd`` — outage-group
        members and flapping nodes in their dark phase.  The control
        plane's reachability model (cosim._reachable) subtracts these:
        an scp to a blacked-out rack fails like one to a dead VM."""
        out: set[int] = set()
        for o in self.outages:
            if o.start <= rnd < o.end:
                out |= set(o.nodes)
        for fl in self.flapping:
            if fl.down_at(rnd):
                out |= set(fl.nodes)
        return out

    def pid_at(self, rnd: int) -> np.ndarray | None:
        """Combined int32 [N] partition id at round ``rnd``, None if no
        partition is active.  Multiple active partitions compose by
        refinement: src/dst communicate iff NO active rule separates
        them — exactly the per-rule OR the engines apply.
        """
        pid = None
        for p in self.partitions:
            if p.start <= rnd < p.end:
                rule = p.pid(self.n)
                pid = rule if pid is None else pid * (len(p.groups) + 1) + rule
        return pid

    def status(self, rnd: int) -> dict:
        """THE status document every engine surface serves (CLI
        ``scenario status``, the deploy ``ScenarioStatus`` RPC, detector
        ``scenario_status``) — one producer, so the fields cannot drift
        between engines."""
        return {
            "name": self.name,
            "round": int(rnd),
            "active": self.active_at(rnd),
            "horizon": self.horizon,
            "rules": self.active_rules(rnd),
        }

    def active_rules(self, rnd: int) -> list[str]:
        """Human-readable descriptions of the rules active at ``rnd``."""
        out = []
        for p in self.partitions:
            if p.start <= rnd < p.end:
                sizes = [len(g) for g in p.groups]
                rest = self.n - sum(sizes)
                out.append(f"partition[{p.start},{p.end}) groups={sizes}"
                           + (f"+rest({rest})" if rest else ""))
        for lf in self.link_faults:
            if lf.start <= rnd < lf.end:
                out.append(f"link_loss[{lf.start},{lf.end}) rate={lf.rate} "
                           f"{len(lf.src)}->{len(lf.dst)} nodes")
        for s in self.slow_nodes:
            if s.start <= rnd < s.end:
                out.append(f"slow[{s.start},{s.end}) stride={s.stride} "
                           f"nodes={len(s.nodes)}")
        for fl in self.flapping:
            if fl.start <= rnd < fl.end:
                out.append(f"flap[{fl.start},{fl.end}) up={fl.up} "
                           f"down={fl.down} nodes={len(fl.nodes)}"
                           f"{' DARK' if fl.down_at(rnd) else ''}")
        for o in self.outages:
            if o.start <= rnd < o.end:
                out.append(f"outage[{o.start},{o.end}) "
                           f"nodes={len(o.nodes)}")
        return out

    # -- JSON codec ---------------------------------------------------------
    def to_json(self) -> str:
        def sel(nodes: Sequence[int]) -> object:
            nodes = list(nodes)
            if len(nodes) == self.n:
                return "all"
            if nodes and nodes == list(range(nodes[0], nodes[-1] + 1)):
                return {"range": [nodes[0], nodes[-1] + 1]}
            return nodes

        doc = {
            "name": self.name,
            "n": self.n,
            "seed": self.seed,
            "partitions": [
                {"start": p.start, "end": p.end,
                 "groups": [sel(g) for g in p.groups]}
                for p in self.partitions
            ],
            "link_faults": [
                {"start": f.start, "end": f.end, "rate": f.rate,
                 "src": sel(f.src), "dst": sel(f.dst)}
                for f in self.link_faults
            ],
            "slow_nodes": [
                {"start": s.start, "end": s.end, "stride": s.stride,
                 "nodes": sel(s.nodes)}
                for s in self.slow_nodes
            ],
            "flapping": [
                {"start": f.start, "end": f.end, "up": f.up,
                 "down": f.down, "nodes": sel(f.nodes)}
                for f in self.flapping
            ],
            "outages": [
                {"start": o.start, "end": o.end, "nodes": sel(o.nodes)}
                for o in self.outages
            ],
        }
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, text: str) -> "FaultScenario":
        doc = json.loads(text)
        n = int(doc["n"])
        return cls(
            name=str(doc.get("name", "scenario")),
            n=n,
            seed=int(doc.get("seed", 0)),
            partitions=tuple(
                Partition(
                    start=int(p["start"]), end=int(p["end"]),
                    groups=tuple(expand_selector(g, n) for g in p["groups"]),
                )
                for p in doc.get("partitions", [])
            ),
            link_faults=tuple(
                LinkFault(
                    start=int(f["start"]), end=int(f["end"]),
                    rate=float(f["rate"]),
                    src=expand_selector(f.get("src", "all"), n),
                    dst=expand_selector(f.get("dst", "all"), n),
                )
                for f in doc.get("link_faults", [])
            ),
            slow_nodes=tuple(
                SlowNode(
                    start=int(s["start"]), end=int(s["end"]),
                    stride=int(s["stride"]),
                    nodes=expand_selector(s["nodes"], n),
                )
                for s in doc.get("slow_nodes", [])
            ),
            flapping=tuple(
                Flapping(
                    start=int(f["start"]), end=int(f["end"]),
                    up=int(f["up"]), down=int(f["down"]),
                    nodes=expand_selector(f["nodes"], n),
                )
                for f in doc.get("flapping", [])
            ),
            outages=tuple(
                CorrelatedOutage(
                    start=int(o["start"]), end=int(o["end"]),
                    nodes=expand_selector(o["nodes"], n),
                )
                for o in doc.get("outages", [])
            ),
        )

    @classmethod
    def from_file(cls, path: str) -> "FaultScenario":
        with open(path) as f:
            return cls.from_json(f.read())


def split_halves(n: int, start: int, end: int,
                 name: str = "halves", seed: int = 0) -> FaultScenario:
    """The canonical netsplit: nodes [0, n/2) vs the rest over [start, end)."""
    return FaultScenario(
        name=name, n=n, seed=seed,
        partitions=(Partition(start=start, end=end,
                              groups=(tuple(range(n // 2)),)),),
    )
