"""The conformance corpus must keep pace with the contract (the port's twin).

``protocol_spec`` is the port's copy of the machine-readable protocol
contract; the conformance fuzzer (``conformance/``) is its dynamic twin.
The seam between them is the ``FAMILIES`` table in
``gossipfs_tpu_torch/conformance/schedules.py``: each family declares
which wire verbs and injection verbs its schedules exercise.  This rule is
the static half of ``schedules.coverage()``: a contract row (a wire verb,
an injection) without a family exercising it, or a family declaring a
verb outside the contract, fails lint before any fuzz run.
"""

from __future__ import annotations

from . import protocol_spec as spec
from .framework import Finding, module_literal, rule

_SCHEDULES = "gossipfs_tpu_torch/conformance/schedules.py"


@rule(
    "conformance-verb-coverage",
    "every protocol_spec wire verb and injection verb must be exercised "
    "by at least one conformance schedule family (schedules.FAMILIES), "
    "and every family's declared verbs/injections must exist in the "
    "contract -- the corpus cannot silently fall behind the contract",
    fixture="lint/conformance_verb_coverage.py",
    fixture_at=_SCHEDULES,
)
def conformance_verb_coverage(index) -> list[Finding]:
    findings: list[Finding] = []
    tree = index.tree(_SCHEDULES)
    families = module_literal(tree, "FAMILIES")
    if not isinstance(families, dict) or not families:
        return [Finding(
            "conformance-verb-coverage", _SCHEDULES, 1,
            "extractor went blind: the FAMILIES literal was not found -- "
            "the analyzer cannot see the corpus's declared coverage",
        )]

    covered_verbs: set[str] = set()
    covered_inj: set[str] = set()
    for name, fam in families.items():
        if not isinstance(fam, dict):
            findings.append(Finding(
                "conformance-verb-coverage", _SCHEDULES, 1,
                f"family {name!r} is not a declaration dict",
            ))
            continue
        verbs = set(fam.get("verbs", ()))
        injections = set(fam.get("injections", ()))
        unknown_v = verbs - set(spec.WIRE_VERBS)
        if unknown_v:
            findings.append(Finding(
                "conformance-verb-coverage", _SCHEDULES, 1,
                f"family {name!r} declares wire verbs outside the "
                f"contract: {sorted(unknown_v)} (protocol_spec.WIRE_VERBS)",
            ))
        unknown_i = injections - {i.name for i in spec.INJECTIONS}
        if unknown_i:
            findings.append(Finding(
                "conformance-verb-coverage", _SCHEDULES, 1,
                f"family {name!r} declares injections outside the "
                f"contract: {sorted(unknown_i)} (protocol_spec.INJECTIONS)",
            ))
        covered_verbs |= verbs & set(spec.WIRE_VERBS)
        covered_inj |= injections & {i.name for i in spec.INJECTIONS}

    missing_verbs = set(spec.WIRE_VERBS) - covered_verbs
    if missing_verbs:
        findings.append(Finding(
            "conformance-verb-coverage", _SCHEDULES, 1,
            f"contract wire verbs with NO exercising schedule family: "
            f"{sorted(missing_verbs)} -- add a family (or extend one) "
            "before the verb ships untested",
        ))
    missing_inj = {i.name for i in spec.INJECTIONS} - covered_inj
    if missing_inj:
        findings.append(Finding(
            "conformance-verb-coverage", _SCHEDULES, 1,
            f"contract injection verbs with NO exercising schedule "
            f"family: {sorted(missing_inj)}",
        ))
    return findings
