# The port's own copy of the JAX package's gossipfs_tpu/obs/schema.py,
# kept verbatim (the port shares nothing with it by import).
"""The versioned, typed observability event schema — ONE language for
what happened, across all three transport engines.

Before this module the repo's detection lifecycles lived in three
disjoint forms: ``RoundMetrics`` arrays out of the tensor scan, per-
process free-text-ish log files in deploy, and ``ScenarioStatus`` vitals
over gRPC — answering "what happened to node 777 between crash and
repair" meant hand-correlating artifacts.  SWIM (PAPERS.md #2) and
Lifeguard (PAPERS.md #3) both argue from *per-event* evidence
(suspect/refute/confirm sequences, local-health signals); this schema
makes that evidence streamable and machine-checkable.

One record shape everywhere::

    {"round": r, "observer": i, "subject": j, "kind": k, "detail": {...}}

``observer``/``subject`` are node ids; ``-1`` means "not a single node"
(cluster-wide / ground-truth events).  Streams are JSONL whose FIRST row
is a header (``{"schema": SCHEMA, "source": ..., "n": ...}``) so every
artifact is self-describing; ``tools/timeline.py`` merges streams, and
``obs/recorder.py`` holds the three producers (post-scan decoder, the
``UdpNode`` seam hook, the deploy daemons' structured log).

The maps at the bottom are the LINT surface (tests/test_obs.py): every
``RoundMetrics``/``MetricsCarry`` field and every deploy/cosim log site
must map to a schema kind or be explicitly listed as unexported — new
metrics cannot silently bypass the recorder.
"""

from __future__ import annotations

import dataclasses
import json

# Version tag stamped into every stream header.  Bump on any breaking
# record-shape change; the analyzer refuses unknown majors.
SCHEMA = "gossipfs-obs/v1"

# Sibling schema for the profiler artifacts (ROUNDPROF_*.jsonl /
# stub-bisect rows): a header row stamped by bench/roundprof.py and
# tools/stub_bisect.py so old and new profile artifacts are
# self-describing and the analyzer can ingest them.
ROUNDPROF_SCHEMA = "gossipfs-roundprof/v1"

# ---------------------------------------------------------------------------
# Event kinds — the full lifecycle
# ---------------------------------------------------------------------------

EVENT_KINDS: dict[str, str] = {
    # -- time / per-round observables
    "round_tick": "one completed protocol round; detail carries the "
                  "round's scalar counters (n_alive, true_detections, "
                  "false_positives, suspects_entered, refutations, "
                  "fp_suppressed) — the RoundMetrics row, as an event",
    # -- ground-truth membership events (observer == -1)
    "crash": "subject crash-stopped (CTRL+C / kill -9 / scheduled fault)",
    "hb_freeze": "subject's own heartbeat counter stopped advancing "
                 "(emitted alongside crash: a dead process bumps nothing)",
    "leave": "subject broadcast LEAVE and exited voluntarily",
    "join": "subject (re)joined through the introducer",
    # -- the SWIM detection lifecycle (suspicion/)
    "suspect": "observer marked subject SUSPECT (first local staleness "
               "evidence; observer -1 = 'some observer', from the scan's "
               "any-observer carry)",
    "refute": "a pending suspicion of subject was cancelled by evidence "
              "of life (heartbeat/incarnation advance)",
    "confirm": "a detector declared subject FAILED (the lifecycle's "
               "actual failure declaration; detail.false_positive is "
               "ground truth where the engine knows it)",
    "remove": "subject dropped from a membership list; observer -1 = "
              "dropped from EVERY live observer's list (the scan's "
              "convergence carry)",
    # -- fault injection (scenarios/)
    "scenario_arm": "a FaultScenario rule table was armed",
    "scenario_clear": "the armed scenario was cleared / healed",
    "suspicion_arm": "SuspicionParams armed (suspicion/)",
    "suspicion_clear": "suspicion disarmed",
    # -- SDFS control plane
    "election": "a master election resolved (subject = the new master)",
    "replica_put": "a file version committed (detail.file / version / "
                   "replicas — the nodes that acked; the durability "
                   "audit's write record)",
    "replica_repair": "a replica re-replicated after loss "
                      "(detail.file / source / target)",
    "replica_delete": "a file's metadata + replicas dropped by a client "
                      "delete (detail.file)",
    "replica_lost": "no live replica of a file remains",
    # -- erasure plane (gossipfs_tpu/erasure/, redundancy="stripe")
    "stripe_put": "a striped file version committed (detail.file / "
                  "version / k / m / fragments — the slot-aligned holder "
                  "list, -1 where the fragment did not land; the "
                  "durability audit's stripe write record)",
    "stripe_repair": "missing fragments re-encoded from k survivors "
                     "(detail.file / version / slots / targets; observer "
                     "= the coordinating master)",
    "stripe_lost": "a stripe fell below k live fragments — "
                   "unreconstructable (the MDS data-loss line, not "
                   "total wipeout)",
    # -- traffic plane (traffic/)
    "client_op": "one SDFS client operation completed (detail.op / file / "
                 "bytes / ms / ok) — the open-loop load generator's and "
                 "bench/sdfs_ops.py's per-op latency row",
    # -- online health plane (obs/monitor.py, campaigns/)
    "invariant_violation": "the streaming monitor caught a protocol "
                           "invariant breaking (detail.invariant names "
                           "the row of obs.monitor.INVARIANTS; the "
                           "violating evidence rides detail) — emitted "
                           "INTO the stream so timeline.py and the "
                           "recorder lint maps stay the single source "
                           "of truth",
    "campaign_verdict": "one campaign run's machine-checked verdict "
                        "(tools/campaign.py ledger row: detail carries "
                        "the scenario point, the monitor estimators and "
                        "the violation list)",
    # -- operational
    "node_start": "a deploy node process came up",
}

# Kinds that constitute a subject's detection-lifecycle timeline, in
# canonical order — tools/timeline.py renders/validates against this.
# This tuple is held in exact bijection with the protocol contract's
# emit kinds (analysis/protocol_spec.py): adding a kind here without a
# contract transition/injection row — or vice versa — fails the
# spec-obs-kind-coverage rule and tests/test_protocol_spec.py.
LIFECYCLE_KINDS = (
    "crash", "hb_freeze", "leave", "join",
    "suspect", "refute", "confirm", "remove",
)


@dataclasses.dataclass(frozen=True)
class Event:
    """One schema record (see module docstring for field semantics)."""

    round: int
    observer: int
    subject: int
    kind: str
    detail: dict = dataclasses.field(default_factory=dict)

    def to_record(self) -> dict:
        rec = {"round": self.round, "observer": self.observer,
               "subject": self.subject, "kind": self.kind}
        if self.detail:
            rec["detail"] = self.detail
        return rec

    @staticmethod
    def from_record(rec: dict) -> "Event":
        # deploy node logs carry the writing node as "node" (their
        # Machine.log heritage) — it IS the observer for schema purposes
        observer = rec.get("observer", rec.get("node", -1))
        return Event(
            round=int(rec.get("round", -1)),
            observer=int(observer),
            subject=int(rec.get("subject", -1)),
            kind=rec["kind"],
            detail=rec.get("detail") or {},
        )


def header(source: str, n: int | None = None, **meta) -> dict:
    """The self-describing first row of every event stream."""
    doc = {"schema": SCHEMA, "source": source}
    if n is not None:
        doc["n"] = int(n)
    doc.update(meta)
    return doc


def is_header(rec: dict) -> bool:
    return "schema" in rec and "kind" not in rec


def dumps(rec: dict) -> str:
    return json.dumps(rec, separators=(",", ":"))


# ---------------------------------------------------------------------------
# Uniform vitals — the counter set every engine's `metrics` surface renders
# ---------------------------------------------------------------------------

# One ordered field list for the CLI `metrics` verb, the shim/deploy
# `Vitals` RPC, and the launcher's collector.  A field an engine cannot
# know (ground-truth aliveness off the sim; per-refute aliveness off the
# socket engines) is ABSENT from its document and rendered as `n/a` —
# never as a measured 0 (the round-8 status-shape convention).
VITALS_FIELDS = (
    "engine",           # "sim" | "udp" | "deploy"
    "round",            # the engine's protocol-round clock
    "n_alive",          # ground-truth live count (sim/udp only)
    "members",          # size of the reporting node's view (deploy rows)
    "detections",       # cumulative detector firings seen by the surface
    "false_positives",  # of those, subject actually alive (ground truth)
    "suspects_now",     # live SUSPECT entries (suspicion armed only)
    "suspects_entered",
    "refutations",
    "confirms",
    "fp_suppressed",    # sim-only: refutations of actually-alive subjects
    # -- online health plane (obs/monitor.py): live invariant verdicts.
    # Present only when a StreamMonitor is attached AND the engine can
    # evaluate the invariants (deploy has no ground truth, so its rows
    # omit the field and render n/a — never a fabricated clean 0)
    "invariant_violations",
    # -- traffic plane (traffic/; the CLI `traffic status` verb's set) —
    # engines without an SDFS data plane (udp, deploy today) simply omit
    # them and render n/a, per the round-8 absent-not-zero rule
    "ops_issued",       # client ops (put/get/delete) issued via this plane
    "ops_acked",        # of those, completed (quorum-acked / found / ok)
    "repairs_pending",  # under-replicated files awaiting a repair pass
    "repairs_done",     # re-replication plans executed so far
    # -- erasure plane (redundancy="stripe" only): replica-mode documents
    # OMIT both fields — they render n/a, never a fabricated clean 0,
    # and a clean stripe-mode run reports a real measured 0
    "stripes_degraded",  # stripes below full strength but >= k live
    "fragments_lost",    # missing fragments summed over placed stripes
    # -- wire plane (socket engines only; round 20 delta gossip A/B):
    # cumulative payload bytes actually handed to sendto, and the
    # full-list vs delta-frame split.  The tensor engine has no wire,
    # so its documents omit all three and render n/a
    "bytes_sent",
    "frames_full",      # full member-list frames (anti-entropy included)
    "frames_delta",     # <#DELTA#>-marked bounded frames
)


def na(value):
    """The absent-not-zero rendering, owned HERE: an unknowable counter
    renders as the string ``n/a`` — never as a fabricated clean 0.
    Every surface that prints vitals-shaped values (render_vitals below,
    the CLI ``metrics``/``traffic status``/suspicion verbs) routes
    through this helper; gossipfs-lint's na-render-ownership rule flags
    any other literal ``n/a`` in the tree."""
    return "n/a" if value is None else value


def render_vitals(doc: dict) -> str:
    """One-line uniform rendering; absent fields print as ``n/a``."""
    return " ".join(f"{f}={na(doc.get(f))}" for f in VITALS_FIELDS)


# ---------------------------------------------------------------------------
# Lint maps — how every existing metric/log site reaches this schema
# ---------------------------------------------------------------------------

# core.rounds.RoundMetrics / MetricsCarry field -> the event kind (or
# round_tick counter) the post-scan decoder exports it through.  The
# schema-lint test asserts every field of both NamedTuples appears here
# or in SCAN_UNEXPORTED.
SCAN_FIELD_MAP: dict[str, str] = {
    # RoundMetrics -> round_tick detail counters (one row per round)
    "true_detections": "round_tick",
    "false_positives": "round_tick",
    "n_alive": "round_tick",
    "suspects_entered": "round_tick",
    "refutations": "round_tick",
    "fp_suppressed": "round_tick",
    # MetricsCarry -> per-subject lifecycle events
    "first_detect": "confirm",     # confirm.round
    "first_observer": "confirm",   # confirm.observer
    "converged": "remove",         # remove.round (observer -1)
    "first_suspect": "suspect",    # suspect.round (observer -1)
}

# Scan fields deliberately NOT exported as events (none today; list them
# here WITH a reason if that ever changes, so the lint keeps passing
# honestly instead of being loosened).
SCAN_UNEXPORTED: dict[str, str] = {}

# deploy/node.py + cosim.py log-site kind -> schema kind.  NodeDaemon.log
# rewrites through this map at write time, so the per-node JSONL logs ARE
# schema streams (the structured replacement for the free-text logs) and
# tools/timeline.py ingests them directly.
LOG_KIND_MAP: dict[str, str] = {
    "detect": "confirm",
    "failure_detected": "confirm",   # cosim's EventLog kind
    "re_replicate": "replica_repair",
    "reput": "replica_repair",
    "put": "replica_put",
    "delete": "replica_delete",
    "lost": "replica_lost",
    "elected": "election",
    "new_master": "election",
    "scenario": "scenario_arm",
    "suspicion": "suspicion_arm",
    "start": "node_start",
}

# Log sites that are operational noise, not lifecycle evidence — each
# with the reason it stays out of the event stream.  The lint test
# asserts every `log("<kind>"...)` / `kind="<kind>"` site is in
# LOG_KIND_MAP, UNEXPORTED_LOG_KINDS, or already a schema kind.
UNEXPORTED_LOG_KINDS: dict[str, str] = {
    "repair_error": "per-attempt RPC failure; the retry loop re-detects "
                    "the deficit — the outcome events are replica_repair "
                    "/ replica_lost",
    "reput_miss": "a refused RemoteReput (no local copy); the master's "
                  "retry rotates sources — outcome events cover it",
    "scenario_error": "a rejected ScenarioLoad payload (bad JSON / wrong "
                      "n); nothing armed, no lifecycle state changed",
    "suspicion_error": "a rejected SuspicionLoad payload; same",
    "election_stall": "a no-majority election attempt; retried every "
                      "control tick — the outcome event is `election`",
    "control_error": "control-loop exception kept non-fatal; diagnostics, "
                     "not protocol evidence",
}
