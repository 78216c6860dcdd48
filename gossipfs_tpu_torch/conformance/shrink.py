# The port's own copy of the JAX package's
# gossipfs_tpu/conformance/shrink.py, kept verbatim.
"""Greedy delta-debugging for failing schedules.

A fuzzer-found divergence is only actionable once it is SMALL: the
minimal repro names the one message ordering the engines disagree on.
:func:`shrink` takes a failing case doc and a ``still_fails`` predicate
(the caller decides what "fails" means — usually "this engine's verdict
row is not ok", see ``tools/conformance.py``) and greedily minimizes:

  0. search NEIGHBOURING CORPUS SEEDS first: when the doc carries its
     ``(family, seed)`` provenance, regenerate the draws at seeds within
     ``seed_radius`` and restart from any failing draw that is smaller
     (fewer steps, then fewer rounds, then fewer total datagram copies,
     then the lowest seed as a canonical tiebreak).  Generator draws
     differ only in which nodes the rng picks, so a neighbouring seed
     can hand ddmin a strictly easier starting point for free — one
     engine run per candidate, before the O(steps^2) pass begins;
  1. drop schedule steps one at a time, to fixpoint (classic ddmin with
     chunk size 1 — schedules are tens of steps, not thousands, so the
     O(steps^2) pass costs less than one socket-engine run);
  2. drop mid-run checkpoints the failure does not need;
  3. reduce per-step datagram ``copies`` to 1;
  4. truncate trailing rounds the failure does not need (binary search
     down, keeping a small settling pad after the last step).

Every candidate is re-validated against the schedule schema before the
predicate sees it, so the minimized doc is replayable by the same
harness — minimal repros are committed under ``regressions/`` and
replayed by tier-1 exactly like the campaign storm cases.
"""

from __future__ import annotations

import copy

from gossipfs_tpu_torch.conformance.harness import run_case_reference
from gossipfs_tpu_torch.conformance.schedules import (FAMILIES, generate,
                                                serialize, validate)


def _try(candidate: dict, still_fails) -> bool:
    try:
        validate(candidate)
    except ValueError:
        return False
    return bool(still_fails(candidate))


def _size(case: dict):
    """Smaller-is-better ordering for whole draws: steps dominate (each
    is a datagram the repro must explain), rounds break ties, then total
    injected copies; the seed itself is last so equal-size failing draws
    canonicalize to the lowest seed in the neighbourhood."""
    return (len(case["steps"]), case["rounds"],
            sum(int(s.get("copies", 1)) for s in case["steps"]),
            case.get("seed", 0))


def _seed_pass(case: dict, still_fails, radius: int) -> dict:
    fam, seed = case.get("family"), case.get("seed")
    if radius <= 0 or fam not in FAMILIES or not isinstance(seed, int):
        return case
    best = case
    for s in range(max(0, seed - radius), seed + radius + 1):
        if s == seed:
            continue
        cand = generate(fam, seed=s)
        if _size(cand) < _size(best) and _try(cand, still_fails):
            best = cand
    return best


def shrink(case: dict, still_fails, *, settle_pad: int = 6,
           seed_radius: int = 2) -> dict:
    """Minimize ``case`` while ``still_fails(candidate)`` stays true.

    The predicate is called on structurally-valid candidates only and
    should be deterministic-ish (socket-engine flakes make the shrink
    conservative, never wrong: a candidate that fails to reproduce is
    simply kept out).  Returns a new doc; the input is not mutated.
    """
    case = copy.deepcopy(case)
    if not _try(case, still_fails):
        raise ValueError("shrink needs a failing case to start from")

    # 0) seed-neighbourhood search — restart ddmin from the smallest
    # failing draw within seed_radius of this one's corpus seed
    case = _seed_pass(case, still_fails, seed_radius)

    # 1) drop steps to fixpoint
    changed = True
    while changed:
        changed = False
        for i in reversed(range(len(case["steps"]))):
            trial = copy.deepcopy(case)
            del trial["steps"][i]
            if _try(trial, still_fails):
                case = trial
                changed = True

    # 2) drop checkpoints the failure does not need
    for i in reversed(range(len(case["checkpoints"]))):
        trial = copy.deepcopy(case)
        del trial["checkpoints"][i]
        if _try(trial, still_fails):
            case = trial

    # 3) single copies
    for i, step in enumerate(case["steps"]):
        if int(step.get("copies", 1)) > 1:
            trial = copy.deepcopy(case)
            trial["steps"][i]["copies"] = 1
            if _try(trial, still_fails):
                case = trial

    # 4) truncate trailing rounds (keep a settling pad after the last
    # step / checkpoint so confirm windows still run out)
    floor = 1
    if case["steps"]:
        floor = max(floor, max(s["round"] for s in case["steps"]) + 1)
    if case["checkpoints"]:
        floor = max(floor,
                    max(c["round"] for c in case["checkpoints"]) + 1)
    lo, hi = floor + settle_pad, case["rounds"]
    while lo < hi:
        mid = (lo + hi) // 2
        trial = copy.deepcopy(case)
        trial["rounds"] = mid
        if _try(trial, still_fails):
            hi = mid
        else:
            lo = mid + 1
    if hi < case["rounds"]:
        trial = copy.deepcopy(case)
        trial["rounds"] = hi
        if _try(trial, still_fails):
            case = trial

    # 5) resync the declared expectation to the MINIMIZED doc's oracle:
    # step/round minimization legitimately changes the predicted endgame
    # (truncating rounds before a re-confirm window closes turns a
    # declared 'gone' into 'suspect'), and a committed repro whose own
    # oracle selfcheck fails would blame the generator instead of the
    # engine it indicts.
    ref = run_case_reference(case)
    for s in case["tracked"]:
        exp = case["expect"][str(s)]
        exp["final"] = ref["final"][s]
        emitted = {e["kind"] for e in ref["events"] if e["subject"] == s}
        exp["forbid"] = sorted(set(exp["forbid"]) - emitted)

    validate(case)
    return case


def save(case: dict, path) -> None:
    """Write a minimized repro in the canonical byte form (the same
    serializer the seed-determinism tests pin)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(serialize(case))
