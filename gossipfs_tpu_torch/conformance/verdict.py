"""The per-(schedule, engine) conformance matrix.

The port of the JAX package's ``conformance/verdict.py``.  ``compare()``
holds one engine bundle against the reference prediction for the same
case; ``run_matrix()`` sweeps a corpus x engine grid and aggregates
``all_agree``, in the shape of the JAX package's ``CONFORMANCE_r19.json``.
The port runs every column: the oracle (whose self-check row runs for
every case), ``tensor`` (the port's ``SimDetector`` on ``device``) and the
two socket engines, ``udp`` and ``native`` (host code).

What is compared (and, as deliberately, what is not):

  * **final_status** / **checkpoints**: the membership classification
    of every tracked subject at observer 0 (member / suspect / gone),
    at the end and at the schedule's mid-run checkpoints;
  * **expected_kinds**: the reference's lifecycle kind-set per tracked
    subject (minus the family's declared ``optional`` kinds) must appear
    in the engine's flight-recorder stream.  Kind SETS, not sequences:
    engines attribute observers differently (the tensor recorder is
    cluster-wide);
  * **forbidden_kinds**: the family's declared must-not-fire kinds are
    absent for the subject;
  * **causal_order**: cluster-wide, first ``suspect`` at or before first
    ``confirm`` per subject whenever suspicion is armed;
  * **incarnation_grace**: on engines exposing per-entry incarnations
    (the reference; NOT the tensor sim, whose detector API carries no hb
    surface: skipped, not fabricated), a tracked subject that finished
    as a member must carry a counter past the hb<=1 detection grace.

Round *numbers* of events are never compared; the checkpoints are the
timing assert.
"""

from __future__ import annotations

from gossipfs_tpu_torch.conformance import harness, schedules

#: the columns the port runs: all four of the JAX package's
PORTED = ("reference", "tensor", "udp", "native")


def _kinds(bundle: dict, subject: int) -> set[str]:
    return {e["kind"] for e in bundle["events"] if e["subject"] == subject}


def _first_round(bundle: dict, subject: int, kind: str):
    rounds = [e["round"] for e in bundle["events"]
              if e["subject"] == subject and e["kind"] == kind]
    return min(rounds) if rounds else None


def compare(case: dict, ref: dict, eng: dict) -> dict:
    """One matrix row: engine bundle vs the reference prediction."""
    checks: dict[str, dict] = {}

    mismatched = {
        str(s): {"engine": eng["final"].get(s), "reference": ref["final"][s]}
        for s in case["tracked"] if eng["final"].get(s) != ref["final"][s]
    }
    checks["final_status"] = {"ok": not mismatched, "mismatched": mismatched}

    cp_mismatch = {}
    for r, ref_status in ref["checkpoints"].items():
        eng_status = eng["checkpoints"].get(r, {})
        for s in case["tracked"]:
            if eng_status.get(s) != ref_status[s]:
                cp_mismatch[f"round {r} subject {s}"] = {
                    "engine": eng_status.get(s), "reference": ref_status[s]}
    checks["checkpoints"] = {"ok": not cp_mismatch,
                             "mismatched": cp_mismatch}

    missing_kinds = {}
    forbidden_hit = {}
    for s in case["tracked"]:
        exp = case["expect"][str(s)]
        required = _kinds(ref, s) - set(exp["optional"])
        got = _kinds(eng, s)
        if not required <= got:
            missing_kinds[str(s)] = sorted(required - got)
        hit = got & set(exp["forbid"])
        if hit:
            forbidden_hit[str(s)] = sorted(hit)
    checks["expected_kinds"] = {"ok": not missing_kinds,
                                "missing": missing_kinds}
    checks["forbidden_kinds"] = {"ok": not forbidden_hit,
                                 "fired": forbidden_hit}

    causal_bad = {}
    if case["config"].get("suspicion", True):
        for s in case["tracked"]:
            confirm_at = _first_round(eng, s, "confirm")
            if confirm_at is None:
                continue
            suspect_at = _first_round(eng, s, "suspect")
            if suspect_at is None or suspect_at > confirm_at:
                causal_bad[str(s)] = {"first_suspect": suspect_at,
                                      "first_confirm": confirm_at}
    checks["causal_order"] = {"ok": not causal_bad, "violations": causal_bad}

    if eng["incarnations"]:
        stale_members = {
            str(s): eng["incarnations"].get(s)
            for s in case["tracked"]
            if eng["final"].get(s) == "member"
            and not eng["incarnations"].get(s, 0) > 1
        }
        checks["incarnation_grace"] = {"ok": not stale_members,
                                       "stale": stale_members}
    else:
        checks["incarnation_grace"] = {"ok": True, "skipped": True}

    return {
        "family": case["family"],
        "seed": case["seed"],
        "engine": eng["engine"],
        "ok": all(c["ok"] for c in checks.values()),
        "checks": checks,
    }


def oracle_selfcheck(case: dict, ref: dict) -> dict:
    """The reference prediction must itself satisfy the family's
    DECLARED expectations (final status, checkpoint statuses, forbidden
    kinds).  A schedule whose oracle run disagrees with its own family
    sheet is a generator timing bug, not an engine divergence — this
    row catches it before any engine is blamed."""
    problems = []
    for s in case["tracked"]:
        exp = case["expect"][str(s)]
        if ref["final"][s] != exp["final"]:
            problems.append(
                f"subject {s}: predicted final {ref['final'][s]!r} != "
                f"declared {exp['final']!r}")
        hit = _kinds(ref, s) & set(exp["forbid"])
        if hit:
            problems.append(
                f"subject {s}: prediction emits forbidden {sorted(hit)}")
    for cp in case["checkpoints"]:
        got = ref["checkpoints"].get(cp["round"], {})
        for s_str, status in cp["status"].items():
            if got.get(int(s_str)) != status:
                problems.append(
                    f"checkpoint round {cp['round']} subject {s_str}: "
                    f"predicted {got.get(int(s_str))!r} != declared "
                    f"{status!r}")
    return {
        "family": case["family"],
        "seed": case["seed"],
        "engine": "reference",
        "ok": not problems,
        "checks": {"oracle_selfcheck": {"ok": not problems,
                                        "problems": problems}},
    }


def run_case(case: dict, engines=None, device="cuda") -> list[dict]:
    """All matrix rows for one case: the oracle selfcheck plus one
    compare row per requested engine the family can run.  ``engines=None``
    runs every engine the family declares; the tensor column runs on
    ``device``."""
    ref = harness.run_case_reference(case)
    rows = [oracle_selfcheck(case, ref)]
    for engine in case["engines"]:
        if engine == "reference":
            continue
        if engines is not None and engine not in engines:
            continue
        if engine == "tensor":
            bundle = harness.run_case_tensor(case, device=device)
        else:
            bundle = harness.RUNNERS[engine](case)
        rows.append(compare(case, ref, bundle))
    return rows


def run_matrix(corpus, engines=None, device="cuda") -> dict:
    """The corpus x engine conformance matrix.  ``engines=None`` runs
    every engine each family declares; a subset restricts the
    socket/tensor columns while the oracle selfcheck always runs.
    ``device`` is where the tensor column's rounds run."""
    rows = []
    for case in corpus:
        rows.extend(run_case(case, engines=engines, device=device))
    failing = [r for r in rows if not r["ok"]]
    return {
        "schema": "gossipfs-conformance-matrix/v1",
        "cases": len(corpus),
        "rows": rows,
        "engines_run": sorted({r["engine"] for r in rows}),
        "coverage": schedules.coverage(),
        "all_agree": not failing,
        "disagreements": [
            {"family": r["family"], "seed": r["seed"], "engine": r["engine"],
             "failed_checks": sorted(k for k, c in r["checks"].items()
                                     if not c["ok"])}
            for r in failing
        ],
    }
