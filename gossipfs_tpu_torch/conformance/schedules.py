# The port's own copy of the JAX package's
# gossipfs_tpu/conformance/schedules.py, kept verbatim.
"""Adversarial schedule generator, driven by ``analysis/protocol_spec.py``.

Each *family* probes one guard edge (or rate limit, or codec invariant)
of the protocol contract under a hostile message ordering the static
drift lint cannot see: a REFUTE delayed past the confirm window, a
replayed stale incarnation reviving a dead entry's freshness, SUSPECT
floods past the refute-once-per-period limit, a forged REMOVE of a live
member, malformed datagrams through the wire codec.  A schedule is a
seed-pure ``gossipfs-conformance/v1`` JSON case doc: the same
``(family, seed)`` always serializes byte-identically, so corpus slices
are pinnable (``tools/verify_claims.py spec_conformance``) and failing
cases replay exactly (``shrink.py`` -> ``regressions/``).

Every probe a family declares is validated against the contract's own
transition table — ``generate()`` refuses a probe string that names an
edge ``protocol_spec.TRANSITIONS`` does not carry, which is what makes
the generator *spec-driven* rather than a hand-rolled scenario list.
``coverage()`` proves the family set exercises every wire verb, every
injection seam, and every lifecycle transition (the
``conformance-verb-coverage`` lint rule checks the same closure
statically from the :data:`FAMILIES` literal).

Schedule vocabulary (``steps``; rounds are schedule-relative, armed
after each engine's warmup):

  * ``crash`` / ``leave`` / ``join`` — engine injection seams
    (``protocol_spec.INJECTIONS``; every engine carries them);
  * ``blackouts`` (top-level) — scenario-plane correlated outages
    (``scenarios.CorrelatedOutage``, armed at schedule round 0);
  * ``verb`` — one crafted control datagram per target through the
    engine's real wire codec (udp/native sockets; the reference applies
    it to its handler table).  The tensor engine has no datagram seam,
    so verb/malformed steps are wire-plane-only and families that need
    them exclude ``tensor`` from ``engines``;
  * ``malformed`` — codec-hardening payloads (garbage, unparsable
    heartbeats, unknown verbs, and ``mixed_refresh``: a valid
    incarnation-advance entry with a trailing malformed chunk — a
    hardened codec salvages the valid entry, a brittle one drops the
    whole datagram).  Round 20 adds the delta wire format's styles:
    ``truncated_delta`` (a marked frame cut mid-entry), ``delta_refresh``
    (a clean single-entry delta advance — the race/zombie carrier) and
    ``stale_full_replay`` (a full-list fragment with a stale counter) —
    the dispatch contract says marked frames run the SAME hardened
    max-merge as full lists, whatever the receiver's dissemination mode.

The cluster profile is the campaign/north-star protocol mode shared by
``campaigns/engines.py`` (random fanout push, gossip-only removal,
fresh cooldown) — the one profile all four surfaces can run, since the
tensor engine's suspicion gate requires exactly that mode.
"""

from __future__ import annotations

import json
import random

from gossipfs_tpu_torch.analysis import protocol_spec

SCHEMA = "gossipfs-conformance/v1"

# One profile for the whole corpus (see module docstring).  t_suspect is
# wide (10 rounds) so socket-engine wall-clock jitter of a round or two
# never crosses a checkpoint boundary; every checkpoint below keeps >= 2
# rounds of margin to the nearest predicted transition.
N = 8
CONFIG = {
    "t_fail": 5,
    "t_suspect": 10,
    "t_cooldown": 6,
    "min_group": 4,
    "push": "random",
    "fanout": 3,
    "remove_broadcast": False,
    "fresh_cooldown": True,
    "lh_multiplier": 0,
    "lh_frac": 0.25,
}

# Family metadata as a PURE literal dict: the conformance-verb-coverage
# lint rule parses it straight off this module's AST (framework
# literal_dict), so the verb/injection closure is checkable without
# importing (and the import-time coverage() check keeps it honest
# against the generators).  engines lists which surfaces can run the
# family at all — wire-verb and codec families have no tensor seam.
FAMILIES = {
    "refute_race": {
        "doc": "rack blackout heals mid-suspect-window: the REFUTE wave "
               "must win the confirm race (delayed-refute edge)",
        "verbs": ["SUSPECT", "REFUTE"],
        "injections": [],
        "probes": ["MEMBER->SUSPECT:stale", "SUSPECT->MEMBER:refute_evidence"],
        "engines": ["reference", "tensor", "udp", "native"],
    },
    "confirm_expiry": {
        "doc": "crash with no refuting evidence: SUSPECT must hold the "
               "full window, then confirm and remove",
        "verbs": ["SUSPECT"],
        "injections": ["crash", "hb_freeze"],
        "probes": ["MEMBER->SUSPECT:stale", "SUSPECT->FAILED:confirm_window"],
        "engines": ["reference", "tensor", "udp", "native"],
    },
    "direct_confirm": {
        "doc": "suspicion disarmed: stale confirms directly, no SUSPECT "
               "detour (the disarmed MEMBER->FAILED row)",
        "verbs": [],
        "injections": ["crash", "hb_freeze"],
        "probes": ["MEMBER->FAILED:stale"],
        "engines": ["reference", "tensor", "udp", "native"],
    },
    "leave_broadcast": {
        "doc": "graceful leave: the LEAVE broadcast removes the member "
               "everywhere with no detection lifecycle",
        "verbs": ["LEAVE"],
        "injections": ["leave"],
        "probes": ["MEMBER->FAILED:leave_or_remove"],
        "engines": ["reference", "tensor", "udp", "native"],
    },
    "rejoin_cooldown": {
        "doc": "confirm -> cooldown expiry -> introducer rejoin; plus a "
               "duplicate JOIN about an already-listed member (must be "
               "a silent no-op)",
        "verbs": ["JOIN"],
        "injections": ["crash", "hb_freeze", "join"],
        "probes": [
            "SUSPECT->FAILED:confirm_window",
            "FAILED->UNKNOWN:cooldown_expiry",
            "UNKNOWN->MEMBER:join_or_merge_add",
        ],
        # the duplicate-JOIN probe is a wire datagram, so the tensor sim
        # (no datagram seam) sits this family out
        "engines": ["reference", "udp", "native"],
    },
    "suspect_flood": {
        "doc": "SUSPECT verb flood about a LIVE member, past the "
               "refute-once-per-period rate limit: the subject bumps + "
               "refutes, observers must not confirm",
        "verbs": ["SUSPECT", "REFUTE"],
        "injections": [],
        "probes": ["SUSPECT->MEMBER:refute_evidence"],
        "engines": ["reference", "udp", "native"],
    },
    "stale_refute_replay": {
        "doc": "replayed REFUTE with a stale incarnation mid-window: it "
               "cancels the suspicion and re-freshens the entry (the "
               "explicit-REFUTE rule), delaying — not preventing — the "
               "confirm",
        "verbs": ["REFUTE"],
        "injections": ["crash", "hb_freeze"],
        "probes": [
            "MEMBER->SUSPECT:stale",
            "SUSPECT->MEMBER:refute_evidence",
            "SUSPECT->FAILED:confirm_window",
        ],
        "engines": ["reference", "udp", "native"],
    },
    "remove_poison": {
        "doc": "forged REMOVE of a live member: removal + cooldown "
               "suppression, then the victim's own gossip re-adds it "
               "after expiry — no detection lifecycle may fire",
        "verbs": ["REMOVE"],
        "injections": [],
        "probes": [
            "MEMBER->FAILED:leave_or_remove",
            "FAILED->UNKNOWN:cooldown_expiry",
            "UNKNOWN->MEMBER:join_or_merge_add",
        ],
        "engines": ["reference", "udp", "native"],
    },
    "malformed_codec": {
        "doc": "codec hardening: pure-garbage datagrams are no-ops, and "
               "a mixed datagram (valid incarnation advance + trailing "
               "malformed chunk) must still deliver the refute",
        "verbs": [],
        "injections": ["crash", "hb_freeze"],
        "probes": ["MEMBER->SUSPECT:stale", "SUSPECT->MEMBER:refute_evidence",
                   "SUSPECT->FAILED:confirm_window"],
        "engines": ["reference", "udp", "native"],
    },
    "truncated_delta": {
        "doc": "delta wire hardening (round 20): a delta frame cut "
               "mid-entry — the valid incarnation advance in front must "
               "still merge and deliver the refute, the truncated tail "
               "is skipped (a lost/garbled delta degrades to a smaller "
               "merge, never a protocol error)",
        "verbs": [],
        "injections": ["crash", "hb_freeze"],
        "probes": ["MEMBER->SUSPECT:stale", "SUSPECT->MEMBER:refute_evidence",
                   "SUSPECT->FAILED:confirm_window"],
        "engines": ["reference", "udp", "native"],
    },
    "delta_stale_race": {
        "doc": "a stale full-list replay racing a delta advance about "
               "the same member: max-merge must keep the advance "
               "whatever the arrival order — an engine that regresses "
               "the counter never re-stales and the confirm dies",
        "verbs": [],
        "injections": ["crash", "hb_freeze"],
        "probes": ["MEMBER->SUSPECT:stale", "SUSPECT->MEMBER:refute_evidence",
                   "SUSPECT->FAILED:confirm_window"],
        "engines": ["reference", "udp", "native"],
    },
    "delta_unknown_member": {
        "doc": "a delta frame about a member the receivers no longer "
               "list (graceful leave, mid-cooldown): the fail-list "
               "suppression must beat the merge-add — no zombie "
               "resurrection from a marked frame",
        "verbs": [],
        "injections": ["leave"],
        "probes": ["MEMBER->FAILED:leave_or_remove"],
        "engines": ["reference", "udp", "native"],
    },
}

#: event kinds the verdict plane compares (protocol lifecycle + the
#: injection ground truth; everything else — round_tick, scenario_arm —
#: is bookkeeping noise)
TRACKED_KINDS = tuple(sorted(protocol_spec.lifecycle_emit_kinds()))


def _check_probe(probe: str) -> None:
    """A probe string names a contract edge: ``SRC->DST:guard`` must be
    a ``protocol_spec.TRANSITIONS`` row — the generator is spec-driven,
    not a free-form scenario list."""
    edge, _, guard = probe.partition(":")
    src, _, dst = edge.partition("->")
    if protocol_spec.transition(src, dst, guard) is None:
        raise ValueError(f"probe {probe!r} is not a protocol_spec transition")


def _base(family: str, seed: int, rounds: int, suspicion: bool = True) -> dict:
    meta = FAMILIES[family]
    for probe in meta["probes"]:
        _check_probe(probe)
    for verb in meta["verbs"]:
        if verb not in protocol_spec.WIRE_VERBS:
            raise ValueError(f"unknown wire verb {verb!r}")
    for inj in meta["injections"]:
        if protocol_spec.injection(inj) is None:
            raise ValueError(f"unknown injection {inj!r}")
    cfg = dict(CONFIG)
    cfg["suspicion"] = suspicion
    return {
        "schema": SCHEMA,
        "family": family,
        "seed": seed,
        "n": N,
        "rounds": rounds,
        "config": cfg,
        "engines": list(meta["engines"]),
        "verbs": list(meta["verbs"]),
        "injections": list(meta["injections"]),
        "probes": list(meta["probes"]),
        "blackouts": [],
        "steps": [],
        "tracked": [],
        "expect": {},
        "checkpoints": [],
    }


def _subject(rng: random.Random) -> int:
    # never the introducer (node 0): rejoin rides through it
    return rng.randrange(1, N)


def _gen_refute_race(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("refute_race", seed, rounds=22)
    # blackout [2, 12): observers go stale at ~7-9 and SUSPECT at <= 10;
    # the heal at 12 floods fresh counters back in, so the refute lands
    # ~13-14 — five-plus rounds ahead of the confirm deadline (~18-20)
    case["blackouts"] = [{"start": 2, "end": 12, "nodes": [s]}]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "member",
                               "forbid": ["confirm", "remove"],
                               "optional": []}}
    case["checkpoints"] = [{"round": 11, "status": {str(s): "suspect"}}]
    return case


def _gen_confirm_expiry(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("confirm_expiry", seed, rounds=26)
    case["steps"] = [{"round": 2, "op": "crash", "node": s}]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone",
                               "forbid": ["refute"],
                               "optional": []}}
    # suspect enters <= 10, confirm >= 17: round 14 is mid-window with
    # >= 3 rounds of margin on both sides
    case["checkpoints"] = [{"round": 14, "status": {str(s): "suspect"}}]
    return case


def _gen_direct_confirm(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("direct_confirm", seed, rounds=16, suspicion=False)
    case["steps"] = [{"round": 2, "op": "crash", "node": s}]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone",
                               "forbid": ["suspect", "refute"],
                               "optional": []}}
    case["checkpoints"] = [{"round": 12, "status": {str(s): "gone"}}]
    return case


def _gen_leave_broadcast(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    # rounds end BEFORE the fail-list cooldown expires (~9-10): a rare
    # dropped LEAVE datagram could otherwise re-gossip the entry back
    case = _base("leave_broadcast", seed, rounds=8)
    case["steps"] = [{"round": 3, "op": "leave", "node": s}]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone",
                               "forbid": ["suspect", "confirm", "refute"],
                               "optional": []}}
    case["checkpoints"] = [{"round": 6, "status": {str(s): "gone"}}]
    return case


def _gen_rejoin_cooldown(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    s2 = rng.choice([i for i in range(1, N) if i != s])
    case = _base("rejoin_cooldown", seed, rounds=36)
    case["steps"] = [
        {"round": 2, "op": "crash", "node": s},
        # duplicate JOIN about a live, already-listed member: the
        # introducer re-adds idempotently — no lifecycle event for s2
        {"round": 5, "op": "verb", "verb": "JOIN", "about": s2, "to": [0],
         "copies": 2},
        # confirm ~17-20, fail-list expiry ~23-26: round 29 rejoins
        # through the introducer with the cooldown safely spent
        {"round": 29, "op": "join", "node": s},
    ]
    case["tracked"] = [s, s2]
    case["expect"] = {
        str(s): {"final": "member", "forbid": ["refute"], "optional": []},
        str(s2): {"final": "member",
                  "forbid": ["suspect", "refute", "confirm", "remove"],
                  "optional": []},
    }
    case["checkpoints"] = [
        {"round": 25, "status": {str(s): "gone"}},
        {"round": 34, "status": {str(s): "member"}},
    ]
    return case


def _gen_suspect_flood(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    observers = rng.sample([i for i in range(N) if i != s], 2)
    case = _base("suspect_flood", seed, rounds=12)
    # 3 copies straight at the subject + 1 at each of two observers,
    # four rounds running: 20 SUSPECT datagrams about one live member.
    # The subject answers each round's burst with ONE incarnation bump +
    # REFUTE broadcast (the refute_broadcast rate limit); observers
    # adopt the suspicion and drop it at their next tick — the entry is
    # locally fresh, so adoption is refuting-evidence-free bookkeeping.
    case["steps"] = [
        {"round": r, "op": "verb", "verb": "SUSPECT", "about": s,
         "to": [s, s, s] + observers, "copies": 1}
        for r in (3, 4, 5, 6)
    ]
    case["tracked"] = [s]
    # whether an observer's adopted suspicion is popped by the REFUTE
    # datagram (-> a "refute" event) or dropped silently at its next
    # tick is a benign arrival-order race — "refute" is optional, the
    # hard requirements are no confirm/remove and final membership
    case["expect"] = {str(s): {"final": "member",
                               "forbid": ["confirm", "remove"],
                               "optional": ["refute", "suspect"]}}
    case["checkpoints"] = [{"round": 10, "status": {str(s): "member"}}]
    return case


def _gen_stale_refute_replay(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("stale_refute_replay", seed, rounds=34)
    case["steps"] = [
        {"round": 2, "op": "crash", "node": s},
        # mid-suspect-window (suspect <= 10, confirm >= 17): a REPLAYED
        # REFUTE carrying a stale incarnation (hb=1).  The counter does
        # not advance (max-merge), but the explicit REFUTE rule cancels
        # the suspicion and re-stamps freshness — the entry re-stales
        # from here, pushing the confirm out by a full t_fail+t_suspect
        {"round": 13, "op": "verb", "verb": "REFUTE", "about": s,
         "hb": "stale", "to": "live", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone", "forbid": [],
                               "optional": []}}
    case["checkpoints"] = [
        {"round": 15, "status": {str(s): "member"}},   # replay revived it
        {"round": 24, "status": {str(s): "suspect"}},  # re-staled, window 2
    ]
    return case


def _gen_remove_poison(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("remove_poison", seed, rounds=22)
    case["steps"] = [
        # forged REMOVE about a LIVE member to every other node: all of
        # them fail-list s (cooldown suppression holds ~6 rounds), then
        # s's own list gossip re-adds it after expiry — the protocol
        # self-heals a poisoned removal without any detection lifecycle
        {"round": 4, "op": "verb", "verb": "REMOVE", "about": s,
         "to": "others", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "member",
                               "forbid": ["suspect", "confirm"],
                               "optional": []}}
    case["checkpoints"] = [{"round": 7, "status": {str(s): "gone"}}]
    return case


def _gen_malformed_codec(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("malformed_codec", seed, rounds=34)
    case["steps"] = [
        {"round": 2, "op": "crash", "node": s},
        # pure garbage through the wire codec: every style must be a
        # complete no-op (no ghost members, no aborted ticks)
        {"round": 3, "op": "malformed", "style": "garbage", "to": "live",
         "copies": 1},
        {"round": 3, "op": "malformed", "style": "empty_hb", "to": "live",
         "copies": 1},
        {"round": 4, "op": "malformed", "style": "unknown_verb",
         "to": "live", "copies": 1},
        {"round": 4, "op": "malformed", "style": "bad_hb", "to": "live",
         "copies": 1},
        # the codec-hardening probe: one datagram carrying a VALID
        # incarnation advance for the crashed subject plus a trailing
        # malformed chunk.  A hardened decoder salvages the valid entry
        # (refute-by-advance fires, mirroring the engine that skips bad
        # chunks); a brittle one throws and drops the whole datagram —
        # the refute never lands and the checkpoint below goes red
        {"round": 13, "op": "malformed", "style": "mixed_refresh",
         "about": s, "hb_boost": 100, "to": "live", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone", "forbid": [],
                               "optional": []}}
    case["checkpoints"] = [
        {"round": 15, "status": {str(s): "member"}},
        {"round": 24, "status": {str(s): "suspect"}},
    ]
    return case


def _gen_truncated_delta(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("truncated_delta", seed, rounds=34)
    case["steps"] = [
        {"round": 2, "op": "crash", "node": s},
        # mid-suspect-window: a DELTA frame carrying a valid incarnation
        # advance for the crashed subject, cut mid-entry after it.  The
        # dispatch contract: a marked frame runs the SAME hardened
        # max-merge as a full list, so the advance is salvaged
        # (refute-by-advance revives s) and the truncated chunk is
        # skipped — a brittle delta decoder drops the whole frame and
        # the revive checkpoint goes red (timings mirror malformed_codec)
        {"round": 13, "op": "malformed", "style": "truncated_delta",
         "about": s, "hb_boost": 100, "to": "live", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone", "forbid": [],
                               "optional": []}}
    case["checkpoints"] = [
        {"round": 15, "status": {str(s): "member"}},
        {"round": 24, "status": {str(s): "suspect"}},
    ]
    return case


def _gen_delta_stale_race(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    case = _base("delta_stale_race", seed, rounds=34)
    case["steps"] = [
        {"round": 2, "op": "crash", "node": s},
        # the race: a clean delta advance for the crashed subject AND a
        # replayed stale full-list fragment (hb=1) about the same
        # member, the stale copy injected LAST.  Max-merge is
        # order-free: the advance must survive (revive at ~13), the
        # stale replay must neither regress the counter nor re-stamp
        # freshness.  An engine that adopts the stale counter leaves
        # hb=1 — inside the detection grace, so s never re-stales and
        # the suspect checkpoint goes red
        {"round": 13, "op": "malformed", "style": "delta_refresh",
         "about": s, "hb_boost": 100, "to": "live", "copies": 2},
        {"round": 13, "op": "malformed", "style": "stale_full_replay",
         "about": s, "to": "live", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone", "forbid": [],
                               "optional": []}}
    case["checkpoints"] = [
        {"round": 15, "status": {str(s): "member"}},
        {"round": 24, "status": {str(s): "suspect"}},
    ]
    return case


def _gen_delta_unknown_member(seed: int) -> dict:
    rng = random.Random(seed)
    s = _subject(rng)
    # rounds end BEFORE the fail-list cooldown expires (~9-10), like
    # leave_broadcast: past expiry a re-injected advance legitimately
    # re-adds (the cooldown intentionally scopes zombie suppression)
    case = _base("delta_unknown_member", seed, rounds=9)
    case["steps"] = [
        {"round": 3, "op": "leave", "node": s},
        # mid-cooldown: a clean delta advance about the departed member,
        # whom no receiver lists any more.  The merge-add guard is the
        # probe: fail-listed entries are NOT resurrected, marked frame
        # or not — a brittle engine re-adds the zombie and the gone
        # checkpoint goes red
        {"round": 6, "op": "malformed", "style": "delta_refresh",
         "about": s, "hb_boost": 100, "to": "live", "copies": 2},
    ]
    case["tracked"] = [s]
    case["expect"] = {str(s): {"final": "gone",
                               "forbid": ["suspect", "confirm", "refute"],
                               "optional": []}}
    case["checkpoints"] = [{"round": 8, "status": {str(s): "gone"}}]
    return case


_GENERATORS = {
    "refute_race": _gen_refute_race,
    "confirm_expiry": _gen_confirm_expiry,
    "direct_confirm": _gen_direct_confirm,
    "leave_broadcast": _gen_leave_broadcast,
    "rejoin_cooldown": _gen_rejoin_cooldown,
    "suspect_flood": _gen_suspect_flood,
    "stale_refute_replay": _gen_stale_refute_replay,
    "remove_poison": _gen_remove_poison,
    "malformed_codec": _gen_malformed_codec,
    "truncated_delta": _gen_truncated_delta,
    "delta_stale_race": _gen_delta_stale_race,
    "delta_unknown_member": _gen_delta_unknown_member,
}


def generate(family: str, seed: int = 0) -> dict:
    """One seed-pure case doc (same inputs -> byte-identical
    :func:`serialize` output)."""
    if family not in _GENERATORS:
        raise ValueError(f"unknown schedule family {family!r}; "
                         f"have {sorted(_GENERATORS)}")
    case = _GENERATORS[family](seed)
    validate(case)
    return case


def generate_corpus(seeds=(0,)) -> list[dict]:
    """The full corpus: every family x every seed, generation order
    stable (family table order, then seed order)."""
    return [generate(family, seed) for family in FAMILIES for seed in seeds]


def serialize(case: dict) -> str:
    """Canonical byte form (sorted keys): the seed-determinism and
    round-trip contract the tests pin."""
    return json.dumps(case, sort_keys=True, indent=2) + "\n"


def parse(text: str) -> dict:
    case = json.loads(text)
    validate(case)
    return case


def validate(case: dict) -> dict:
    """Structural + spec validation of a case doc (generated or loaded
    from ``regressions/``)."""
    if case.get("schema") != SCHEMA:
        raise ValueError(f"not a {SCHEMA} doc: {case.get('schema')!r}")
    if case["family"] not in FAMILIES:
        raise ValueError(f"unknown family {case['family']!r}")
    for probe in case["probes"]:
        _check_probe(probe)
    for verb in case["verbs"]:
        if verb not in protocol_spec.WIRE_VERBS:
            raise ValueError(f"unknown wire verb {verb!r}")
    for inj in case["injections"]:
        if protocol_spec.injection(inj) is None:
            raise ValueError(f"unknown injection {inj!r}")
    for step in case["steps"]:
        op = step["op"]
        if op not in ("crash", "leave", "join", "verb", "malformed"):
            raise ValueError(f"unknown step op {op!r}")
        if not 0 <= step["round"] < case["rounds"]:
            raise ValueError(f"step round {step['round']} outside schedule")
        if op == "verb" and step["verb"] not in protocol_spec.WIRE_VERBS:
            raise ValueError(f"unknown wire verb {step['verb']!r}")
    for subject in case["tracked"]:
        if str(subject) not in case["expect"]:
            raise ValueError(f"tracked subject {subject} has no expect row")
        exp = case["expect"][str(subject)]
        if exp["final"] not in ("member", "suspect", "gone"):
            raise ValueError(f"bad final status {exp['final']!r}")
        for kind in exp["forbid"] + exp["optional"]:
            if kind not in TRACKED_KINDS:
                raise ValueError(f"unknown event kind {kind!r}")
    for cp in case["checkpoints"]:
        if not 0 <= cp["round"] < case["rounds"]:
            raise ValueError(f"checkpoint round {cp['round']} outside run")
        for status in cp["status"].values():
            if status not in ("member", "suspect", "gone"):
                raise ValueError(f"bad checkpoint status {status!r}")
    return case


def coverage() -> dict:
    """The corpus-wide closure over the contract: which wire verbs,
    injection seams, and transitions the family set exercises.  The
    import-time assert below keeps :data:`FAMILIES` honest; the
    ``conformance-verb-coverage`` lint rule re-derives the same closure
    statically for drift protection."""
    verbs: set[str] = set()
    injections: set[str] = set()
    probes: set[str] = set()
    for meta in FAMILIES.values():
        verbs.update(meta["verbs"])
        injections.update(meta["injections"])
        probes.update(meta["probes"])
    covered_edges = set()
    for probe in probes:
        _check_probe(probe)
        edge, _, guard = probe.partition(":")
        src, _, dst = edge.partition("->")
        covered_edges.add((src, dst, guard))
    missing_edges = [
        f"{t.src}->{t.dst}:{t.guard}" for t in protocol_spec.TRANSITIONS
        if (t.src, t.dst, t.guard) not in covered_edges
    ]
    return {
        "families": len(FAMILIES),
        "verbs": sorted(verbs),
        "verbs_missing": sorted(set(protocol_spec.WIRE_VERBS) - verbs),
        "injections": sorted(injections),
        "injections_missing": sorted(
            {i.name for i in protocol_spec.INJECTIONS} - injections),
        "transitions_missing": missing_edges,
        "complete": (verbs == set(protocol_spec.WIRE_VERBS)
                     and injections >= {i.name
                                        for i in protocol_spec.INJECTIONS}
                     and not missing_edges),
    }
