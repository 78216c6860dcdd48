"""Config-gate documentation consistency, over the port's gates.

The port's capability gates are ``SimConfig.__post_init__`` (its
``raise ValueError`` sites) and the loop picker of ``core/rounds.py``:
``_lean_ok``, which decides the lean resident-round loop (the JAX
package's ``_use_rr``), and ``route``, with the helpers of that module it
calls (the lean merge form, K3's one-pass gate, the separate-pass merge
kernel).  Every config FIELD a gate tests must have a documented row --
a table row starting with the backticked field name -- in BASELINE.md's
``**Config-gate matrix**`` (the JAX package's, read and never edited) or
in the ``**Config-gate matrix (port)**`` block of README.md's port
section, where the port documents what its own gates add.  A row of the
port's block must name a ``SimConfig`` field: a renamed field cannot leave
a stale row behind.
"""

from __future__ import annotations

import ast
import re

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    func,
    line_of,
    rule,
)

_CONFIG = "gossipfs_tpu_torch/config.py"
_ROUNDS = "gossipfs_tpu_torch/core/rounds.py"
_BASELINE = "BASELINE.md"
_README = "README.md"

# A matrix is the region from its bold marker to the next bold marker or
# heading: rows of other tables must not count as documentation.
BASELINE_MARKER = "**Config-gate matrix**"
PORT_MARKER = "**Config-gate matrix (port)**"
_MATRIX_END = re.compile(r"^(\*\*|#)", re.MULTILINE)
_DOC_ROW = re.compile(r"^\s*\|\s*`([a-z_]+)`", re.MULTILINE)

# the loop picker's entry points: gates by returning False or another loop
GATE_FUNCTIONS = ("_lean_ok", "route")


def documented_rows(text: str, marker: str) -> list[tuple[str, int]] | None:
    """(field, line) of every row of the matrix under ``marker``, None
    where the marker is absent."""
    start = text.find(marker)
    if start < 0:
        return None
    body_at = start + len(marker)
    body = text[body_at:]
    end = _MATRIX_END.search(body)
    if end is not None:
        body = body[:end.start()]
    return [(m.group(1), line_of(text, body_at + m.start(1)))
            for m in _DOC_ROW.finditer(body)]


def _config_fields(tree: ast.Module) -> set[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "SimConfig":
            return {
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            }
    return set()


def _attrs_of(node: ast.AST, base: str) -> dict[str, int]:
    """Attribute names read off ``<base>.<attr>`` within the node, with
    their first line."""
    out: dict[str, int] = {}
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and isinstance(sub.value,
                                                         ast.Name) \
                and sub.value.id == base:
            out.setdefault(sub.attr, sub.lineno)
    return out


def _raise_gated(fn: ast.AST, base: str) -> dict[str, int]:
    """Fields referenced by an If test whose body raises."""
    gated: dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and any(
                isinstance(s, ast.Raise) for s in ast.walk(node)):
            for attr in _attrs_of(node.test, base):
                gated.setdefault(attr, node.lineno)
    return gated


def gate_functions(tree: ast.Module) -> list[ast.FunctionDef]:
    """``_lean_ok``, ``route`` and every function of the module that
    ``route`` reaches by name: the loop picker, whole."""
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    todo = [n for n in GATE_FUNCTIONS if n in defs]
    seen: list[str] = []
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.append(name)
        for node in ast.walk(defs[name]):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in defs and node.func.id not in seen:
                todo.append(node.func.id)
    return [defs[n] for n in seen]


@rule(
    "config-gate-docs",
    "every config field tested by a capability gate "
    "(SimConfig.__post_init__ raise sites, core/rounds._lean_ok / route "
    "and the helpers route calls) has a documented row (| `field` ...) in "
    "BASELINE.md's config-gate matrix or README.md's port block, and "
    "every row of the port block names a SimConfig field",
    fixture="lint_torch/config_gate_docs.py",
    fixture_at=_ROUNDS,
)
def check_config_gates(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    base_rows = documented_rows(index.source(_BASELINE), BASELINE_MARKER)
    if base_rows is None:
        return [Finding(
            "config-gate-docs", _BASELINE, 1,
            f"BASELINE.md has no {BASELINE_MARKER} section -- the gate "
            "documentation rule went blind",
        )]
    readme = index.source(_README)
    port_rows = documented_rows(readme, PORT_MARKER) or []
    documented = {f for f, _ in base_rows} | {f for f, _ in port_rows}

    cfg_tree = index.tree(_CONFIG)
    fields = _config_fields(cfg_tree)
    if not fields or func(cfg_tree, "__post_init__", "SimConfig") is None:
        return [Finding("config-gate-docs", _CONFIG, 1,
                        "SimConfig or its __post_init__ not found -- the "
                        "gate rule went blind")]
    if not gate_functions(index.tree(_ROUNDS)):
        out.append(Finding(
            "config-gate-docs", _ROUNDS, 1,
            f"none of {GATE_FUNCTIONS} found -- the loop-picker half of "
            "the gate rule went blind"))
    gates = gate_sites(index)

    for f in sorted(gates):
        if f not in documented:
            rel, ln = gates[f]
            out.append(Finding(
                "config-gate-docs", rel, ln,
                f"capability gate tests `{f}` but neither BASELINE.md's "
                f"config-gate matrix nor README.md's {PORT_MARKER} block "
                f"has a row for `{f}` -- document the constraint",
            ))
    for f, ln in port_rows:
        if f not in fields:
            out.append(Finding(
                "config-gate-docs", _README, ln,
                f"README.md's port gate row `{f}` names no SimConfig "
                "field -- a renamed or removed field left it behind",
            ))
    return out


def gate_sites(index: RepoIndex) -> dict[str, tuple[str, int]]:
    """field -> (path, line) of the first gate testing it: post_init's
    raise sites, then the loop picker, which gates by returning False or
    another loop (every config attribute it consults is a capability
    input)."""
    cfg_tree = index.tree(_CONFIG)
    fields = _config_fields(cfg_tree)
    post_init = func(cfg_tree, "__post_init__", "SimConfig")
    out = {f: (_CONFIG, ln) for f, ln in _raise_gated(post_init,
                                                       "self").items()
           if f in fields}
    for fn in gate_functions(index.tree(_ROUNDS)):
        for f, ln in _attrs_of(fn, "config").items():
            if f in fields:
                out.setdefault(f, (_ROUNDS, ln))
    return out
