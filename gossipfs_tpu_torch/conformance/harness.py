"""The reference oracle and the tensor column of the conformance harness.

The port of the JAX package's ``conformance/harness.py``.  One
``gossipfs-conformance/v1`` case doc (``schedules.py``) runs through:

  * **reference**: a synchronous per-node model built directly on the
    contract's per-node lifecycle API (``suspicion/runtime.py``) with
    the udp engine's handler table transcribed rule for rule (max-merge,
    cooldown suppression, the refute-once-per-period rate limit, the
    min_group refresh-only guard, the hb<=1 detection grace).  It runs
    on a logical round clock (period = 1.0), so its prediction is
    deterministic.  Plain Python, copied verbatim from the JAX package;
  * **tensor**: the port's ``detector/sim.py`` via the injection verbs
    and the scenario plane (no datagram seam: wire-verb families exclude
    it), on the device named by ``device`` (on the card its rounds run
    the explicit-edge merge kernel).

The socket columns (``udp``: the asyncio engine, ``native``: the C++
epoll engine) drive engines the port does not carry yet; their runners
raise ``NotImplementedError`` (ROADMAP Queue 1 item 9).

Every column returns the same *bundle* shape::

    {"engine": ..., "events": [{round, observer, subject, kind}, ...],
     "final": {subject: "member"|"suspect"|"gone"},
     "checkpoints": {round: {subject: status}},
     "incarnations": {subject: hb} | {},      # engines that expose hb
     "counters": {...}}

with event rounds schedule-relative (warmup happens off the clock on
every engine) and filtered to the contract's lifecycle kinds;
``verdict.py`` consumes nothing else.
"""

from __future__ import annotations

import random

from gossipfs_tpu_torch.analysis import protocol_spec
from gossipfs_tpu_torch.conformance.schedules import TRACKED_KINDS, validate
from gossipfs_tpu_torch.scenarios.schedule import (CorrelatedOutage,
                                                   FaultScenario)
from gossipfs_tpu_torch.suspicion.params import SuspicionParams
from gossipfs_tpu_torch.suspicion.runtime import SuspicionRuntime

# The socket engines' wire separators (the JAX package's
# ``detector/udp.py``: ENTRY_SEP, FIELD_SEP, CMD_SEP, DELTA_MARK), copied
# as constants: the oracle speaks the engines' own codec.
ENTRY_SEP = "<#ENTRY#>"
FIELD_SEP = "<#INFO#>"
CMD_SEP = "<CMD>"
DELTA_MARK = "<#DELTA#>"

#: hb value for a REPLAYED/stale incarnation (below any live counter
#: past the warmup grace)
STALE_HB = 1

#: warmup rounds the reference runs off the clock (counters past the
#: hb<=1 grace, mirroring the socket engines' warmed start)
_WARMUP = 3


def suspicion_params(cfg: dict) -> SuspicionParams | None:
    if not cfg.get("suspicion", True):
        return None
    return SuspicionParams(t_suspect=int(cfg["t_suspect"]),
                           lh_multiplier=int(cfg["lh_multiplier"]),
                           lh_frac=float(cfg["lh_frac"]))


def case_scenario(case: dict) -> FaultScenario | None:
    """The schedule's blackout windows as the scenario plane's rule
    table (CorrelatedOutage: src OR dst dark -> drop), armed at
    schedule round 0 on every engine."""
    if not case["blackouts"]:
        return None
    return FaultScenario(
        name=f"conformance-{case['family']}",
        n=case["n"],
        outages=tuple(
            CorrelatedOutage(start=b["start"], end=b["end"],
                             nodes=tuple(b["nodes"]))
            for b in case["blackouts"]),
    )


# ---------------------------------------------------------------------------
# wire payloads (the adversary speaks the engines' own codec)
# ---------------------------------------------------------------------------


def wire_verb(verb: str, about_addr: str, hb: int | None = None) -> str:
    """One control datagram, byte-compatible with both socket engines'
    codecs (detector/udp.py handle() / native HandleDatagram)."""
    if verb not in protocol_spec.WIRE_VERBS:
        raise ValueError(f"unknown wire verb {verb!r}")
    if verb == "REFUTE":
        return f"{about_addr}{FIELD_SEP}{hb if hb is not None else 0}" \
               f"{CMD_SEP}REFUTE"
    return f"{about_addr}{CMD_SEP}{verb}"


def malformed_payload(style: str, about_addr: str | None = None,
                      hb: int | None = None) -> str:
    """Codec-hardening payloads.  ``mixed_refresh`` is the sharp one: a
    VALID entry (an incarnation advance for ``about_addr``) followed by
    a malformed chunk — a hardened decoder salvages the valid entry, a
    brittle one throws on the bad chunk and loses the whole datagram."""
    if style == "garbage":
        return "!!not-a-protocol-datagram!!"
    if style == "empty_hb":
        return f"x{FIELD_SEP}"
    if style == "bad_hb":
        return f"127.0.0.1:1{FIELD_SEP}notanumber"
    if style == "unknown_verb":
        return f"127.0.0.1:1{CMD_SEP}FROB"
    if style == "mixed_refresh":
        return (f"{about_addr}{FIELD_SEP}{hb}{FIELD_SEP}0.0"
                f"{ENTRY_SEP}x{FIELD_SEP}")
    # delta wire format (round 20, protocol_spec.DELTA_GOSSIP).  Every
    # engine must dispatch a marked frame through the SAME hardened
    # max-merge as a full list, whatever its own dissemination mode.
    if style == "truncated_delta":
        # a delta frame cut mid-entry: the valid advance in front must
        # still merge (hardened salvage), the truncated tail is skipped
        return (f"{DELTA_MARK}{about_addr}{FIELD_SEP}{hb}{FIELD_SEP}0.0"
                f"{ENTRY_SEP}x{FIELD_SEP}")
    if style == "delta_refresh":
        # a well-formed single-entry delta advance — the race/zombie
        # probes' carrier (delta_stale_race, delta_unknown_member)
        return f"{DELTA_MARK}{about_addr}{FIELD_SEP}{hb}{FIELD_SEP}0.0"
    if style == "stale_full_replay":
        # a replayed full-list fragment with a STALE counter: max-merge
        # must neither regress the entry nor re-stamp its freshness
        return f"{about_addr}{FIELD_SEP}{STALE_HB}{FIELD_SEP}0.0"
    raise ValueError(f"unknown malformed style {style!r}")


#: malformed styles whose payload carries a live incarnation advance for
#: ``about`` (the drivers compute hb = current + hb_boost at fire time)
_ADVANCE_STYLES = ("mixed_refresh", "truncated_delta", "delta_refresh")


def _steps_by_round(case: dict) -> dict[int, list[dict]]:
    by_round: dict[int, list[dict]] = {}
    for step in case["steps"]:
        by_round.setdefault(step["round"], []).append(step)
    return by_round


def _targets(step: dict, alive: list[int]) -> list[int]:
    """Resolve a step's ``to`` spec against the engine's live set at
    fire time (``"live"`` = every live node, ``"others"`` = every live
    node except the subject)."""
    to = step["to"]
    if to == "live":
        return list(alive)
    if to == "others":
        return [i for i in alive if i != step.get("about")]
    return list(to)


# ---------------------------------------------------------------------------
# reference oracle
# ---------------------------------------------------------------------------


class _Member:
    __slots__ = ("hb", "ts")

    def __init__(self, hb: int, ts: float):
        self.hb = int(hb)
        self.ts = ts


class _RefNode:
    """One reference process: the udp engine's handler table + tick,
    transcribed onto a logical round clock (period = 1.0) with the
    contract's per-node lifecycle API carrying the suspicion state."""

    def __init__(self, world: "ReferenceEngine", idx: int):
        self.world = world
        self.idx = idx
        self.addr = f"ref:{idx}"
        self.alive = True
        self.members: dict[str, _Member] = {}
        self.fail_list: dict[str, float] = {}
        self.rt = (SuspicionRuntime(world.params)
                   if world.params is not None else None)
        self._last_refute = float("-inf")
        self.refute_broadcasts = 0
        # same stream construction as UdpNode's push draw — the oracle's
        # dissemination is a faithful peer, not a bit-twin (socket runs
        # are wall-jittered anyway; the prediction is the OBSERVABLE
        # surface, which the schedule margins make draw-independent)
        self._rng = random.Random(0x5EED ^ (idx * 2654435761))

    # -- receive dispatch (mirrors UdpNode.handle) --------------------------
    def handle(self, payload: str) -> None:
        if not self.alive:
            return
        if CMD_SEP in payload:
            arg, verb = payload.split(CMD_SEP, 1)
            if verb == "JOIN":
                self._add_member(arg)
            elif verb in ("LEAVE", "REMOVE"):
                self._remove_member(arg)
            elif verb == "SUSPECT":
                self._on_suspect(arg)
            elif verb == "REFUTE":
                self._on_refute(arg)
            # unknown verbs: silent no-op (codec hardening contract)
        elif payload.startswith(DELTA_MARK):
            # delta frame: strip the marker, run the SAME hardened
            # max-merge (the udp/native dispatch rule — a truncated or
            # replayed delta degrades to a smaller merge, never an error)
            self._merge(self._decode(payload[len(DELTA_MARK):]))
        else:
            self._merge(self._decode(payload))

    @staticmethod
    def _decode(payload: str) -> list[tuple[str, int]]:
        # the HARDENED decode is the contract: malformed chunks are
        # skipped, valid entries in the same datagram still merge
        out = []
        for chunk in payload.split(ENTRY_SEP):
            parts = chunk.split(FIELD_SEP)
            if len(parts) >= 2:
                try:
                    out.append((parts[0], int(float(parts[1]))))
                except ValueError:
                    continue
        return out

    def _on_suspect(self, addr: str) -> None:
        if self.rt is None:
            return
        now = self.world.now
        if addr == self.addr:
            me = self.members.get(self.addr)
            if me is None:
                return
            if now - self._last_refute < 1.0:
                return  # refute once per period (RATE_LIMITS row)
            self._last_refute = now
            me.hb += 1
            me.ts = now
            self.refute_broadcasts += 1
            msg = f"{self.addr}{FIELD_SEP}{me.hb}{CMD_SEP}REFUTE"
            for peer in list(self.members):
                if peer != self.addr:
                    self.world.send(self.idx, peer, msg)
        elif addr in self.members:
            self.rt.adopt(addr, now)

    def _on_refute(self, arg: str) -> None:
        parts = arg.split(FIELD_SEP)
        addr = parts[0]
        try:
            hb = int(float(parts[1])) if len(parts) > 1 else 0
        except ValueError:
            hb = 0
        m = self.members.get(addr)
        if m is None:
            return
        if hb > m.hb:
            m.hb = hb
        m.ts = self.world.now  # an explicit REFUTE re-stamps freshness
        if self.rt is not None and self.rt.refute(addr):
            self.world.obs("refute", self.idx, addr)

    def _add_member(self, addr: str) -> None:
        if addr not in self.members:
            self.members[addr] = _Member(0, self.world.now)
        msg = self._encode()
        for peer in list(self.members):
            if peer != self.addr:
                self.world.send(self.idx, peer, msg)

    def _remove_member(self, addr: str) -> None:
        member = self.members.pop(addr, None)
        if member is not None and addr not in self.fail_list:
            # fresh_cooldown profile: stamp removal time
            self.fail_list[addr] = self.world.now
            self.world.obs("remove", self.idx, addr)
        if self.rt is not None:
            self.rt.drop(addr)

    def _merge(self, remote: list[tuple[str, int]]) -> None:
        now = self.world.now
        for addr, hb in remote:
            local = self.members.get(addr)
            if local is not None:
                if hb > local.hb:
                    local.hb = hb
                    local.ts = now
                    if self.rt is not None and self.rt.refute(addr):
                        self.world.obs("refute", self.idx, addr)
            elif addr not in self.fail_list:
                self.members[addr] = _Member(hb, now)

    def _encode(self) -> str:
        return ENTRY_SEP.join(
            f"{a}{FIELD_SEP}{m.hb}{FIELD_SEP}{m.ts}"
            for a, m in self.members.items())

    # -- heartbeat tick (mirrors UdpNode.tick; unit = 1 round) --------------
    def tick(self) -> None:
        if not self.alive:
            return
        w = self.world
        now = w.now
        if len(self.members) < w.min_group:
            for m in self.members.values():
                m.ts = now  # refresh-only guard
            return
        me = self.members.get(self.addr)
        if me is not None:
            me.hb += 1
            me.ts = now
        for addr in list(self.members):
            if addr == self.addr:
                continue
            m = self.members[addr]
            stale = m.hb > 1 and m.ts < now - w.t_fail
            if not stale:
                if self.rt is not None:
                    self.rt.drop(addr)  # fresh entry: adoption discarded
                continue
            if self.rt is not None:
                if self.rt.suspect(addr, now):
                    self.world.obs("suspect", self.idx, addr)
                    msg = f"{addr}{CMD_SEP}SUSPECT"
                    w.send(self.idx, addr, msg)
                    peers = [a for a in self.members
                             if a != self.addr and a != addr]
                    for peer in self._rng.sample(
                            peers, min(w.fanout, len(peers))):
                        w.send(self.idx, peer, msg)
                    continue
                window = self.rt.t_suspect_window(1.0, len(self.members))
                if not self.rt.expired(addr, now, window):
                    # per-tick re-notification (round 16 contract)
                    w.send(self.idx, addr, f"{addr}{CMD_SEP}SUSPECT")
                    continue
                self.rt.confirm(addr)
            w.confirm(self.idx, addr)
            self._remove_member(addr)
        for addr in list(self.fail_list):
            if self.fail_list[addr] < now - w.t_cooldown:
                del self.fail_list[addr]
        msg = self._encode()
        peers = [a for a in self.members if a != self.addr]
        for peer in self._rng.sample(peers, min(w.fanout, len(peers))):
            w.send(self.idx, peer, msg)


class ReferenceEngine:
    """The deterministic world the reference nodes live in: synchronous
    per-round delivery (datagram latency << period on every real
    engine), blackout gates on organic sends only (injected datagrams
    model an adversary inside the network, exactly like the raw-socket
    injection the socket drivers use)."""

    def __init__(self, case: dict):
        cfg = case["config"]
        self.case = case
        self.n = case["n"]
        self.params = suspicion_params(cfg)
        self.t_fail = int(cfg["t_fail"])
        self.t_cooldown = int(cfg["t_cooldown"])
        self.min_group = int(cfg["min_group"])
        self.fanout = int(cfg["fanout"])
        self.now = 0.0
        self.recording = False
        self.events: list[dict] = []
        self.confirms = 0
        self.nodes = [_RefNode(self, i) for i in range(self.n)]
        for node in self.nodes:  # steady-state start, like the engines
            node.members = {p.addr: _Member(0, 0.0) for p in self.nodes}
        self._queue: list[tuple[int, str]] = []

    # -- plumbing ----------------------------------------------------------
    def addr_of(self, idx: int) -> str:
        return self.nodes[idx].addr

    def _dark(self, idx: int) -> bool:
        return any(b["start"] <= self.now < b["end"] and idx in b["nodes"]
                   for b in self.case["blackouts"])

    def send(self, src: int, peer_addr: str, msg: str) -> None:
        dst = int(peer_addr.rsplit(":", 1)[1])
        if self._dark(src) or self._dark(dst):
            return
        self._queue.append((dst, msg))

    def inject(self, dst: int, payload: str) -> None:
        self._queue.append((dst, payload))

    def _drain(self) -> None:
        # to fixpoint: a delivered SUSPECT triggers a REFUTE broadcast
        # that lands the same round (datagram latency << period); the
        # refute-per-period rate limit bounds the cascade
        while self._queue:
            batch, self._queue = self._queue, []
            for dst, msg in batch:
                self.nodes[dst].handle(msg)

    def obs(self, kind: str, observer: int, subject_addr: str,
            **detail) -> None:
        if not self.recording:
            return
        subject = int(subject_addr.rsplit(":", 1)[1]) \
            if ":" in subject_addr else -1
        self.events.append({"round": int(self.now), "observer": observer,
                            "subject": subject, "kind": kind})

    def confirm(self, observer: int, subject_addr: str) -> None:
        self.confirms += 1
        self.obs("confirm", observer, subject_addr)

    def status(self, observer: int, subject: int) -> str:
        node = self.nodes[observer]
        addr = self.addr_of(subject)
        if node.rt is not None and addr in node.rt.suspects:
            return "suspect"
        return "member" if addr in node.members else "gone"

    # -- the schedule loop --------------------------------------------------
    def _apply(self, step: dict) -> None:
        op = step["op"]
        if op == "crash":
            node = self.nodes[step["node"]]
            node.alive = False
            self.obs("crash", -1, node.addr)
            self.obs("hb_freeze", -1, node.addr)
        elif op == "leave":
            node = self.nodes[step["node"]]
            msg = f"{node.addr}{CMD_SEP}LEAVE"
            for peer in list(node.members):
                if peer != node.addr:
                    self.send(node.idx, peer, msg)
            node.alive = False
            self.obs("leave", -1, node.addr)
        elif op == "join":
            node = self.nodes[step["node"]]
            node.alive = True
            node.members = {node.addr: _Member(0, self.now)}
            node.fail_list = {}
            if node.rt is not None:
                node.rt = SuspicionRuntime(self.params)
            self.send(node.idx, self.addr_of(0),
                      f"{node.addr}{CMD_SEP}JOIN")
            self.obs("join", -1, node.addr)
        elif op in ("verb", "malformed"):
            alive = [i for i in range(self.n) if self.nodes[i].alive]
            about = step.get("about")
            about_addr = self.addr_of(about) if about is not None else None
            for t in _targets(step, alive):
                if op == "verb":
                    hb = None
                    if step.get("hb") == "stale":
                        hb = STALE_HB
                    payload = wire_verb(step["verb"], about_addr, hb=hb)
                else:
                    hb = None
                    if step["style"] in _ADVANCE_STYLES:
                        m = self.nodes[t].members.get(about_addr)
                        hb = (m.hb if m else 0) + int(step["hb_boost"])
                    payload = malformed_payload(step["style"],
                                                about_addr=about_addr,
                                                hb=hb)
                for _ in range(int(step.get("copies", 1))):
                    self.inject(t, payload)

    def run(self) -> dict:
        case = self.case
        steps = _steps_by_round(case)
        # warmup off the clock: counters past the hb<=1 grace
        for r in range(-_WARMUP, 0):
            self.now = float(r)
            for node in self.nodes:
                node.tick()
            self._drain()
        self.recording = True
        checkpoints: dict[int, dict[int, str]] = {}
        for r in range(case["rounds"]):
            self.now = float(r)
            for step in steps.get(r, ()):
                self._apply(step)
            self._drain()
            for node in self.nodes:
                node.tick()
            self._drain()
            for cp in case["checkpoints"]:
                if cp["round"] == r:
                    checkpoints[r] = {
                        s: self.status(0, s) for s in case["tracked"]}
        final = {s: self.status(0, s) for s in case["tracked"]}
        incarnations = {}
        for s in case["tracked"]:
            m = self.nodes[0].members.get(self.addr_of(s))
            if m is not None:
                incarnations[s] = m.hb
        return {
            "engine": "reference",
            "events": self.events,
            "final": final,
            "checkpoints": checkpoints,
            "incarnations": incarnations,
            "counters": {
                "confirms": self.confirms,
                "refute_broadcasts": sum(
                    n.refute_broadcasts for n in self.nodes),
            },
        }


def run_case_reference(case: dict) -> dict:
    validate(case)
    return ReferenceEngine(case).run()


# ---------------------------------------------------------------------------
# shared driver plumbing
# ---------------------------------------------------------------------------


def _lifecycle_events(recorder_events, round0: int = 0) -> list[dict]:
    return [
        {"round": e.round - round0, "observer": e.observer,
         "subject": e.subject, "kind": e.kind}
        for e in recorder_events if e.kind in TRACKED_KINDS
    ]


def _classify(membership: list[int], suspects: list[int],
              subject: int) -> str:
    if subject in suspects:
        return "suspect"
    return "member" if subject in membership else "gone"


# ---------------------------------------------------------------------------
# tensor column (injection verbs + scenario plane; no datagram seam)
# ---------------------------------------------------------------------------


def run_case_tensor(case: dict, device="cuda") -> dict:
    """The tensor column: the port's ``SimDetector`` on ``device`` (the
    card unless the caller names another), stepped one interactive round
    at a time through the case's injections and blackouts, its flight
    recorder armed after the warmup."""
    from gossipfs_tpu_torch.config import SimConfig
    from gossipfs_tpu_torch.detector.sim import SimDetector
    from gossipfs_tpu_torch.obs.recorder import FlightRecorder

    validate(case)
    for step in case["steps"]:
        if step["op"] in ("verb", "malformed"):
            raise ValueError(
                f"family {case['family']!r} carries wire-plane steps; "
                "the tensor engine has no datagram seam (schedules.py "
                "engines gating)")
    cfg = case["config"]
    sim_cfg = SimConfig(
        n=case["n"], topology="random", fanout=int(cfg["fanout"]),
        t_fail=int(cfg["t_fail"]), t_cooldown=int(cfg["t_cooldown"]),
        min_group=int(cfg["min_group"]), remove_broadcast=False,
        fresh_cooldown=True, suspicion=suspicion_params(cfg),
    )
    det = SimDetector(sim_cfg, device=device)
    det.advance(_WARMUP)  # off the clock: counters past the hb<=1 grace
    rec = FlightRecorder(source="tensor-conformance", n=case["n"],
                         case=case["family"])
    det.attach_recorder(rec)
    r0 = int(det.state.round)
    sc = case_scenario(case)
    if sc is not None:
        det.load_scenario(sc)
    steps = _steps_by_round(case)
    checkpoints: dict[int, dict[int, str]] = {}
    for r in range(case["rounds"]):
        for step in steps.get(r, ()):
            getattr(det, step["op"])(step["node"])
        det.advance(1)
        for cp in case["checkpoints"]:
            if cp["round"] == r:
                membership = det.membership(0)
                suspects = det.suspects(0)
                checkpoints[r] = {
                    s: _classify(membership, suspects, s)
                    for s in case["tracked"]}
    membership = det.membership(0)
    suspects = det.suspects(0)
    return {
        "engine": "tensor",
        "events": _lifecycle_events(rec.events, round0=r0),
        "final": {s: _classify(membership, suspects, s)
                  for s in case["tracked"]},
        "checkpoints": checkpoints,
        # the tensor state exposes no per-entry incarnation surface at
        # the detector API: absent, not fabricated (the n/a rule)
        "incarnations": {},
        "counters": {},
    }


# ---------------------------------------------------------------------------
# socket columns (not in the port yet)
# ---------------------------------------------------------------------------


def _socket_column(engine: str):
    raise NotImplementedError(
        f"the {engine} conformance column drives a socket engine the port "
        "does not carry yet (ROADMAP Queue 1 item 9); run the reference "
        "and tensor columns")


def run_case_udp(case: dict, **kw) -> dict:
    """The asyncio udp engine's column: not ported (raises)."""
    _socket_column("udp")


def run_case_native(case: dict, **kw) -> dict:
    """The C++ epoll engine's column: not ported (raises)."""
    _socket_column("native")


#: the runner table (``verdict.run_case`` passes ``device`` to the tensor
#: column)
RUNNERS = {
    "reference": run_case_reference,
    "tensor": run_case_tensor,
    "udp": run_case_udp,
    "native": run_case_native,
}
