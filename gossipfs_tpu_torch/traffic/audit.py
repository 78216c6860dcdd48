# The port's own copy of the JAX package's gossipfs_tpu/traffic/audit.py,
# kept verbatim (the port shares nothing with it by import).
"""Durability facts derived from flight-recorder events ALONE.

The traffic harness reports durability from cluster state (it can read
every store).  This module re-derives the same facts by replaying the
event stream — ``replica_put`` (acked version + acking nodes), ``crash``
/ ``join`` (ground-truth liveness), ``replica_repair`` (landed copies),
``replica_delete`` — with no access to the run.  ``tools/timeline.py``
attaches this to its analysis whenever a stream carries traffic events,
and ``tools/verify_claims.py``'s ``traffic_durability`` claim requires
the two accountings to agree EXACTLY (the observability subsystem's
standing-oracle pattern, applied to the data plane).

The erasure plane rides the same machine: ``stripe_put`` (slot-aligned
acking fragment holders + the stripe's k) and ``stripe_repair`` (landed
slot/target pairs) maintain a PER-SLOT ledger, and a stripe counts lost
when fewer than k distinct slots retain a live fresh holder — the MDS
bound, audited from events alone.

Conservative by construction: read-repair refills (a stale replica
pulling fresh bytes during a get) emit no event, so the event-side
replica sets can only UNDER-count copies — an event-side "zero lost"
verdict is therefore at least as strong as the harness's.

Round 13: the replay is a CLASS (:class:`DurabilityReplay`) so the
streaming monitor (``obs/monitor.py``) maintains the same ledger
incrementally, one event at a time; :func:`durability_from_events` is
the post-hoc wrapper over it — one state machine, two consumption
modes, so the two accountings cannot drift.

Pure python + stdlib only (the obs package convention), so the deploy
lane's jax-free tooling can import it too.
"""

from __future__ import annotations


class DurabilityReplay:
    """The event-replay durability state machine, one event at a time.

    ``observe`` consumes events in stream order.  Within one round the
    canonical ordering puts ground-truth liveness verbs (crash/join)
    before data-plane rows — the recorder streams emit them that way
    (the detector ticks before the control plane reacts), and the
    post-hoc wrapper enforces it with an explicit sort, so the
    incremental and sorted replays walk identical sequences on any
    round-ordered stream.
    """

    def __init__(self) -> None:
        self.dead: set[int] = set()
        # file -> {node: version} as far as events can know it
        self.holders: dict[str, dict[int, int]] = {}
        # stripe mode: file -> {slot: {node: version}} — PER SLOT, because
        # loss is counted in distinct recoverable slots: a rejoined stale
        # holder and its repair replacement can both hold the SAME slot,
        # and flattening them to nodes would double-count that fragment
        self.stripe_slots: dict[str, dict[int, dict[int, int]]] = {}
        self.stripe_k: dict[str, int] = {}
        self.acked_version: dict[str, int] = {}
        self.acked_writes = 0
        self.repair_events = 0
        self.repair_complete_round: int | None = None

    def observe(self, e) -> None:
        d = e.detail
        if e.kind == "crash":
            self.dead.add(e.subject)
        elif e.kind == "join":
            self.dead.discard(e.subject)
        elif e.kind == "replica_put":
            self.acked_writes += 1
            name, version = d.get("file"), int(d.get("version", 0))
            self.acked_version[name] = version
            h = self.holders.setdefault(name, {})
            for nd in d.get("replicas", []):
                h[int(nd)] = version
        elif e.kind == "replica_repair":
            self.repair_events += 1
            self.repair_complete_round = e.round
            name, version = d.get("file"), int(d.get("version", 0))
            h = self.holders.setdefault(name, {})
            for nd in d.get("targets", []):
                h[int(nd)] = version
        elif e.kind == "stripe_put":
            self.acked_writes += 1
            name, version = d.get("file"), int(d.get("version", 0))
            self.acked_version[name] = version
            self.stripe_k[name] = int(d.get("k", 0))
            slots = self.stripe_slots.setdefault(name, {})
            for slot, nd in enumerate(d.get("fragments", [])):
                if int(nd) >= 0:
                    slots.setdefault(slot, {})[int(nd)] = version
        elif e.kind == "stripe_repair":
            self.repair_events += 1
            self.repair_complete_round = e.round
            name, version = d.get("file"), int(d.get("version", 0))
            slots = self.stripe_slots.setdefault(name, {})
            for slot, nd in zip(d.get("slots", []), d.get("targets", [])):
                slots.setdefault(int(slot), {})[int(nd)] = version
        elif e.kind == "replica_delete":
            # mode-neutral delete verb: drops replica and stripe state
            self.acked_version.pop(d.get("file"), None)
            self.holders.pop(d.get("file"), None)
            self.stripe_slots.pop(d.get("file"), None)
            self.stripe_k.pop(d.get("file"), None)

    def _slots_alive(self, name: str, version: int) -> int:
        """Distinct slots with >= 1 event-known live holder at the acked
        version (stripe files only)."""
        return sum(
            1
            for nodes in self.stripe_slots.get(name, {}).values()
            if any(nd not in self.dead and v >= version
                   for nd, v in nodes.items())
        )

    def lost_files(self) -> list[str]:
        """Files whose last-acked version survives on NO event-known
        live replica right now (end-of-stream: the durability verdict).
        Stripe files are lost below k live fresh SLOTS — the MDS
        reconstruction bound, counted per slot."""
        out = []
        for name, version in self.acked_version.items():
            if name in self.stripe_k:
                if self._slots_alive(name, version) < self.stripe_k[name]:
                    out.append(name)
            elif not any(
                nd not in self.dead and v >= version
                for nd, v in self.holders.get(name, {}).items()
            ):
                out.append(name)
        return sorted(out)

    def facts(self) -> dict:
        lost_files = self.lost_files()
        return {
            "acked_writes": self.acked_writes,
            "files_acked": len(self.acked_version),
            "repair_events": self.repair_events,
            "repair_complete_round": self.repair_complete_round,
            "lost": len(lost_files),
            "lost_files": lost_files,
        }


def durability_from_events(events) -> dict:
    """Replay a (round-ordered) event stream into durability facts.

    Returns the comparable fact set: ``acked_writes`` (replica_put event
    count), ``files_acked`` (distinct files with an undeleted acked
    write), ``repair_events``, ``lost`` + ``lost_files`` (files whose
    last-acked version survives on NO event-known live replica at end of
    stream), and ``repair_complete_round`` (the last repair's round — the
    repair-storm completion mark).
    """
    replay = DurabilityReplay()
    for e in sorted(
        events, key=lambda e: (e.round, 0 if e.kind in ("crash", "join")
                               else 1)
    ):
        replay.observe(e)
    return replay.facts()
