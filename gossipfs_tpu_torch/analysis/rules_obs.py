"""Obs-schema coverage rules over the port (the JAX package's ``rules_obs``).

Every ``RoundMetrics``/``MetricsCarry`` field of the port's
``core/rounds.py`` and every log site of its ``deploy/node.py`` daemon and
``cosim.py`` must map into the port's event schema (``obs/schema.py``) or
sit in an explicit unexported list with a reason: adding a metric or a
log site without deciding its observability story is a finding.

All checks are pure AST: the NamedTuple fields come from the class
definitions' annotations and the schema maps from their literal
assignments, so the rules run without importing torch or the package.
"""

from __future__ import annotations

import ast

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    const_str,
    module_literal,
    namedtuple_fields,
    rule,
)

_ROUNDS = "gossipfs_tpu_torch/core/rounds.py"
_SCHEMA = "gossipfs_tpu_torch/obs/schema.py"
_NODE = "gossipfs_tpu_torch/deploy/node.py"
_COSIM = "gossipfs_tpu_torch/cosim.py"


def _schema_maps(index: RepoIndex, names: tuple[str, ...],
                 rule_name: str) -> tuple[dict, list[Finding]]:
    """Literal-evaluate the named schema maps; a map that stopped being
    a literal dict is itself a finding (the rules would go blind)."""
    tree = index.tree(_SCHEMA)
    maps, out = {}, []
    for name in names:
        d = module_literal(tree, name)
        if d is None:
            out.append(Finding(
                rule_name, _SCHEMA, 1,
                f"{name} is no longer a literal dict -- the schema "
                "coverage rules cannot statically read it",
            ))
            d = {}
        maps[name] = d
    return maps, out


@rule(
    "obs-scan-coverage",
    "every RoundMetrics/MetricsCarry field maps to a schema event kind "
    "(obs.schema.SCAN_FIELD_MAP) or is explicitly unexported "
    "(SCAN_UNEXPORTED); mapped kinds must exist in EVENT_KINDS",
    fixture="lint/obs_scan_coverage.py",
    fixture_at="gossipfs_tpu_torch/core/rounds.py",
)
def check_scan_coverage(index: RepoIndex) -> list[Finding]:
    maps, out = _schema_maps(
        index, ("SCAN_FIELD_MAP", "SCAN_UNEXPORTED", "EVENT_KINDS"),
        "obs-scan-coverage")
    field_map, unexported, kinds = (maps["SCAN_FIELD_MAP"],
                                    maps["SCAN_UNEXPORTED"],
                                    maps["EVENT_KINDS"])
    tree = index.tree(_ROUNDS)
    for cls in ("RoundMetrics", "MetricsCarry"):
        fields = namedtuple_fields(tree, cls)
        if fields is None:
            out.append(Finding(
                "obs-scan-coverage", _ROUNDS, 1,
                f"{cls} NamedTuple definition not found -- the scan-field "
                "coverage rule went blind",
            ))
            continue
        for f in fields:
            if f not in field_map and f not in unexported:
                out.append(Finding(
                    "obs-scan-coverage", _ROUNDS, 1,
                    f"{cls}.{f} is neither mapped to a schema event kind "
                    "(obs.schema.SCAN_FIELD_MAP) nor explicitly "
                    "unexported (SCAN_UNEXPORTED)",
                ))
    for f, kind in field_map.items():
        if kind not in kinds:
            out.append(Finding(
                "obs-scan-coverage", _SCHEMA, 1,
                f"SCAN_FIELD_MAP[{f!r}] -> {kind!r} is not an EVENT_KINDS "
                "kind",
            ))
    return out


def _node_log_sites(tree: ast.Module) -> list[tuple[str, int]]:
    """``self.log("<kind>", ...)`` call sites in deploy/node.py."""
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute) \
                and node.func.attr == "log" and node.args:
            kind = const_str(node.args[0])
            if kind is not None:
                sites.append((kind, node.lineno))
    return sites


def _cosim_kind_sites(tree: ast.Module) -> list[tuple[str, int]]:
    """``kind="<kind>"`` keyword sites in cosim.py."""
    sites = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "kind":
                    kind = const_str(kw.value)
                    if kind is not None:
                        sites.append((kind, node.lineno))
    return sites


@rule(
    "obs-logsite-coverage",
    "every deploy-daemon log(\"<kind>\") site and every cosim "
    "kind=\"<kind>\" site maps into the schema (LOG_KIND_MAP), is a "
    "schema kind already, or is listed unexported with a reason",
    fixture="lint/obs_logsite_coverage.py",
    fixture_at="gossipfs_tpu_torch/cosim.py",
)
def check_logsite_coverage(index: RepoIndex) -> list[Finding]:
    maps, out = _schema_maps(
        index, ("LOG_KIND_MAP", "UNEXPORTED_LOG_KINDS", "EVENT_KINDS"),
        "obs-logsite-coverage")
    known = (set(maps["LOG_KIND_MAP"]) | set(maps["UNEXPORTED_LOG_KINDS"])
             | set(maps["EVENT_KINDS"]))
    for rel, extract in ((_NODE, _node_log_sites),
                         (_COSIM, _cosim_kind_sites)):
        sites = extract(index.tree(rel))
        if not sites:
            out.append(Finding(
                "obs-logsite-coverage", rel, 1,
                "no log sites found (the extractor drifted from the "
                "logging idiom?)",
            ))
        for kind, line in sites:
            if kind not in known:
                out.append(Finding(
                    "obs-logsite-coverage", rel, line,
                    f"log site kind {kind!r} bypasses the schema: add it "
                    "to obs.schema.LOG_KIND_MAP or UNEXPORTED_LOG_KINDS",
                ))
    for k, v in maps["LOG_KIND_MAP"].items():
        if v not in maps["EVENT_KINDS"]:
            out.append(Finding(
                "obs-logsite-coverage", _SCHEMA, 1,
                f"LOG_KIND_MAP[{k!r}] -> {v!r} is not an EVENT_KINDS kind",
            ))
    return out
