# The port's own copy of the JAX package's
# gossipfs_tpu/analysis/protocol_spec.py, kept verbatim (pure data; the
# port shares nothing with it by import).
"""gossipfs-spec: THE machine-readable protocol contract.

The SWIM suspect/refute lifecycle (PAPERS.md #2) and the Lifeguard
local-health stretch (PAPERS.md #3) are implemented three times — the
tensor tick/merge (``core/rounds.py`` + ``ops/merge_pallas.py``), the
asyncio engine (``detector/udp.py``) and the C++ epoll engine
(``native/engine.cc``) — and until this module every drift between them
was found only at runtime by knife-edge campaign parity (the per-member
lh-window divergence of round 16; the ENTRY-broadcast asymmetry the
round-17 satellite closed).  This module is the single contract the three
implementations are *statically* diffed against by ``rules_spec.py``:

* :data:`STATES` / :data:`TRANSITIONS` — the lifecycle state machine,
  every edge carrying its guard (a :data:`THRESHOLDS` key) and the
  ``obs/schema.py`` event kind it emits when taken.
* :data:`INJECTIONS` — ground-truth fault-injection events (observer
  ``-1``): not protocol transitions, but every engine's injection seam
  must emit them, so they are contract rows too.
* :data:`WIRE_VERBS` — the control-verb vocabulary of the socket
  engines' wire (``<arg><CMD>VERB`` datagrams).
* :data:`RATE_LIMITS` — protocol back-pressure rules (SWIM refutes once
  per incarnation: one REFUTE broadcast per period, not one per
  received SUSPECT copy).
* :data:`DISSEMINATION` — who hears about an event, per protocol
  profile.  The load-bearing row: a NEW suspicion under the campaign
  profile (``push=random``) reaches the subject plus a fanout-sized
  random sample — never all peers (O(suspects x N) at cohort sizes; the
  measured 26 s tick / 73k-FP storm documented in ``native/engine.cc``).
* :data:`THRESHOLDS` — the guard formulas, written once.  The rules
  check each engine's implementation *structurally* against these rows
  (which names/attributes must appear, in which statement order), not
  by string equality.

C++ has no AST here, so ``native/engine.cc`` carries lightweight
structured annotations the extractor parses and cross-checks BOTH ways
(every annotation must match a contract row; every lifecycle ``ObsEmit``
must be dominated by a matching annotation)::

    // @gfs:transition SUSPECT->FAILED guard=confirm_window
    // @gfs:verb SUSPECT
    // @gfs:rate_limit refute_broadcast
    // @gfs:dissemination new_suspect profile=campaign bound=subject+fanout
    // @gfs:inject crash

This module is pure data — stdlib ``dataclasses`` only, importable from
the AST rules and the tier-1 tests without jax.  tests/
test_protocol_spec.py holds the contract itself to the schema: every
``LIFECYCLE_KINDS`` entry maps to a row here and vice versa, so a new
lifecycle state cannot ship without a contract row.
"""

from __future__ import annotations

import dataclasses

# The three engines the contract binds.  "tensor" is the scan path
# (core/rounds.py tick/merge + the ops/merge_pallas.py fused kernels —
# one implementation, pinned bit-identical by the parity tests).
ENGINES = ("tensor", "udp", "native")

# Lifecycle states.  The socket engines represent them positionally —
# MEMBER = listed, SUSPECT = listed + suspects entry, FAILED = on the
# fail list (cooldown suppression), UNKNOWN = in neither structure —
# while the tensor engine stores them as status codes (core/rounds.py).
STATES = ("UNKNOWN", "MEMBER", "SUSPECT", "FAILED")


@dataclasses.dataclass(frozen=True)
class Transition:
    """One lifecycle edge: ``src -> dst`` when ``guard`` holds.

    ``emits`` is the obs/schema.py event kind the edge emits when taken
    (None for silent bookkeeping edges); ``engines`` lists which
    implementations carry the edge.
    """

    src: str
    dst: str
    guard: str           # key into THRESHOLDS
    emits: str | None    # obs/schema.py EVENT_KINDS kind, or None
    engines: tuple = ENGINES


@dataclasses.dataclass(frozen=True)
class Injection:
    """A ground-truth fault-injection event (observer -1): stamped at
    the injection seam, not produced by a protocol transition."""

    name: str
    emits: str


@dataclasses.dataclass(frozen=True)
class RateLimit:
    """A protocol back-pressure rule (who may send what, how often)."""

    name: str
    scope: str
    window: str
    engines: tuple


@dataclasses.dataclass(frozen=True)
class Dissemination:
    """Who hears about ``event`` under ``profile``.

    ``annotated`` marks rows the native extractor requires an explicit
    ``@gfs:dissemination`` annotation for (the drift-prone ones).
    """

    event: str
    profile: str     # "campaign" (push=random) | "reference" | "any"
    bound: str       # "subject+fanout" | "all_peers"
    engines: tuple
    annotated: bool = False


TRANSITIONS = (
    # Learned of a peer: JOIN through the introducer, an introducer
    # full-list push, or an unknown list-gossip entry NOT on the fail
    # list (cooldown suppression wins over resurrection).
    Transition("UNKNOWN", "MEMBER", "join_or_merge_add", None, ENGINES),
    # First local staleness evidence: the entry enters SUSPECT (and the
    # suspicion is disseminated — see DISSEMINATION).  With suspicion
    # disarmed (t_suspect == 0) this edge is skipped and `stale`
    # confirms directly (the MEMBER->FAILED row below).
    Transition("MEMBER", "SUSPECT", "stale", "suspect", ENGINES),
    # Evidence of life while SUSPECT — a heartbeat/incarnation advance
    # via merge, or an explicit REFUTE — cancels the pending failure.
    Transition("SUSPECT", "MEMBER", "refute_evidence", "refute", ENGINES),
    # The suspect window (Lifeguard-stretched while the observer is
    # degraded) expired without refuting evidence: declare failure.
    Transition("SUSPECT", "FAILED", "confirm_window", "confirm", ENGINES),
    # Suspicion disarmed: staleness past t_fail confirms directly.
    Transition("MEMBER", "FAILED", "stale", "confirm", ENGINES),
    # Verb-driven removal (LEAVE / a peer's REMOVE) or the removal a
    # local confirm causes: the entry moves to the fail list and the
    # membership drop is emitted as `remove`.
    Transition("MEMBER", "FAILED", "leave_or_remove", "remove", ENGINES),
    # Fail-list cooldown expiry: the entry is forgotten and may rejoin.
    Transition("FAILED", "UNKNOWN", "cooldown_expiry", None, ENGINES),
)

INJECTIONS = (
    Injection("crash", "crash"),
    Injection("hb_freeze", "hb_freeze"),
    Injection("leave", "leave"),
    Injection("join", "join"),
)

# Control-verb vocabulary of the socket wire (detector/udp.py handle()
# and native/engine.cc HandleDatagram dispatch on exactly this set).
WIRE_VERBS = ("JOIN", "LEAVE", "REMOVE", "SUSPECT", "REFUTE")

RATE_LIMITS = (
    # SWIM refutes once per incarnation: k observers suspecting the same
    # episode each disseminate SUSPECT, so O(k x fanout) copies land at
    # the subject — one incarnation bump + ONE REFUTE broadcast per
    # heartbeat period answers the whole episode instead of amplifying
    # to O(k x N) datagrams.  (The tensor engine refutes implicitly by
    # merge, so it has no broadcast to limit.)
    RateLimit(
        "refute_broadcast",
        scope="per node, as the suspected subject",
        window="one REFUTE broadcast per heartbeat period",
        engines=("udp", "native"),
    ),
)

DISSEMINATION = (
    # THE drift-prone row (the round-17 satellite fix): a NEW suspicion
    # under the campaign profile reaches the subject (its active
    # incarnation-bump refute is the point) plus a fanout-sized random
    # sample — O(fanout) per new suspicion, like every other push in
    # this mode.  All-peers here is O(suspects x N) per round: at n=256
    # a rack outage makes ~250 observers suspect 8 nodes in one tick.
    Dissemination("new_suspect", "campaign", "subject+fanout",
                  ("udp", "native"), annotated=True),
    # Reference-faithful mode (ring push): all-peers broadcast, kept
    # verbatim for the small-n udp-parity lane.
    Dissemination("new_suspect", "reference", "all_peers",
                  ("udp", "native"), annotated=True),
    # The REFUTE answer goes to all peers in both profiles — it is
    # rate-limited at the source instead (RATE_LIMITS above).
    Dissemination("refute", "any", "all_peers", ("udp", "native")),
    # Delta-piggyback membership refresh (round 20): under the delta
    # profile the per-round push carries a BOUNDED slice of the view —
    # recently-changed entries first (per-peer change cursor over a
    # monotone entry version), round-robin refresh of the stable tail
    # in any leftover capacity — instead of the full O(N) list.  The
    # selection rule and the anti-entropy cadence live in DELTA_GOSSIP;
    # both socket engines are structurally diffed against it by the
    # spec-delta-dissemination rule.
    Dissemination("membership_refresh", "delta", "changed+rr_tail+capped",
                  ("udp", "native"), annotated=True),
)

# Delta-piggyback dissemination knobs (the membership_refresh/delta row
# above, written once).  SWIM piggybacks *changes* on dissemination
# (PAPERS.md #2) and van Renesse's analysis says correctness needs only
# eventual max-merge (PAPERS.md #1) — so the wire payload shrinks from
# O(N) to O(cap) per datagram provided a periodic full-list
# anti-entropy push bounds every entry's refresh gap:
#
# * ``wire_mark`` — delta frames are the full-list wire format prefixed
#   by this marker; the receiver strips it and runs the SAME hardened
#   per-entry max-merge (a truncated or replayed delta degrades to a
#   smaller merge, never a protocol error).
# * ``max_entries`` — the per-datagram cap.  Selection: entries whose
#   version advanced past the per-peer cursor, most recent first, then
#   round-robin tail refresh in any leftover slots.  A peer with no
#   cursor yet (first contact) gets the full list.
# * ``anti_entropy_every`` — every K-th round (cluster-round aligned)
#   pushes the FULL list so a lost delta can never wedge convergence;
#   Pittel's bound stays the reconvergence oracle.  K must stay
#   strictly below t_fail (2x margin recommended: a 1.33x margin
#   manufactured a quiet-cluster FP at n=256).
# * ``freshness`` — in delta mode ONLY, the merge also max-merges the
#   wire ``ts`` on EQUAL heartbeat counters, clamped to local now.
#   Without it, ts refreshes only on hb ADVANCE, and a synchronized
#   anti-entropy round equalizes counters cluster-wide so the NEXT
#   full push can't refresh many pairs — at n=1024 staleness crossed
#   t_fail on a quiet cluster (a 7k-FP storm).  Live nodes keep
#   stamping fresh ts into their own pushes, so the rule propagates
#   liveness; a crashed node's copies converge to a constant max, so
#   staleness still grows globally and crash detection is preserved.
#
# This dict is a pure literal: the lint extractor reads the defaults
# without importing the engines, and the engines' own defaults must
# match it exactly (spec-delta-dissemination goes red on drift).
DELTA_GOSSIP = {
    "event": "membership_refresh",
    "profile": "delta",
    "bound": "changed+rr_tail+capped",
    "wire_mark": "<#DELTA#>",
    "max_entries": 16,
    "anti_entropy_every": 4,
    "selection": ("changed_first", "rr_tail", "capped"),
    "constraint": "anti_entropy_every < t_fail",
    "freshness": "equal_hb_wire_ts_max_merge",
}

# Guard formulas, written once.  `period` is the heartbeat period (the
# tensor engine's unit round); `age` is time since the entry's last
# local stamp; `hb > hb_grace` is the reference's hb<=1 detection grace
# (a just-added entry is undetectable until its counter advances).
THRESHOLDS = {
    "stale": "hb > hb_grace and age > t_fail * period",
    "confirm_window": (
        "age_suspect > t_suspect * (1 + (lh_multiplier if degraded "
        "else 0)) * period, recomputed PER MEMBER at expiry check"
    ),
    "degraded": "len(suspects) > lh_frac * len(listed)",
    "refute_evidence": (
        "heartbeat/incarnation advance observed while SUSPECT "
        "(list-gossip merge or an explicit REFUTE)"
    ),
    "leave_or_remove": "LEAVE or REMOVE verb received, or a local confirm",
    "cooldown_expiry": "age_on_fail_list > t_cooldown * period",
    "join_or_merge_add": (
        "JOIN / introducer push / unknown list-gossip entry, unless "
        "fail-listed (cooldown suppression wins)"
    ),
}


# ---------------------------------------------------------------------------
# Lookup helpers (the rules_spec extractors and the completeness tests)
# ---------------------------------------------------------------------------

def lifecycle_emit_kinds() -> set[str]:
    """Every event kind the contract emits — must equal
    obs.schema.LIFECYCLE_KINDS exactly (tests/test_protocol_spec.py)."""
    kinds = {t.emits for t in TRANSITIONS if t.emits is not None}
    kinds.update(i.emits for i in INJECTIONS)
    return kinds


def transition(src: str, dst: str, guard: str) -> Transition | None:
    for t in TRANSITIONS:
        if (t.src, t.dst, t.guard) == (src, dst, guard):
            return t
    return None


def injection(name: str) -> Injection | None:
    for i in INJECTIONS:
        if i.name == name:
            return i
    return None


def rate_limit(name: str) -> RateLimit | None:
    for r in RATE_LIMITS:
        if r.name == name:
            return r
    return None


def dissemination_row(event: str, profile: str) -> Dissemination | None:
    for d in DISSEMINATION:
        if (d.event, d.profile) == (event, profile):
            return d
    return None
