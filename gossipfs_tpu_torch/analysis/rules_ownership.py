"""Single-ownership rules: owned expressions re-derived anywhere else flag.

The port's twin of the JAX package's ``rules_ownership``.  The port's
correctness leans on a handful of formulas each having exactly ONE owner
module: quorum arithmetic (``sdfs/quorum.py``), the bounded-backoff
schedule (``shim/retry.py``), obs event-line parsing (``obs/``), the
latency quantile rollup (``traffic/workload.py``), the ``n/a``-not-0
vitals rendering (``obs/schema.py``) and the kernels' shared-memory
budgets (the ``.cuh`` headers under ``csrc/`` and their Python mirrors in
``ops/``).  These rules catch the *shape* of a re-derivation, so a new
module cannot quietly fork the math.
"""

from __future__ import annotations

import ast
import re

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    const_str,
    dotted,
    functions,
    line_of,
    names_in,
    rule,
)

_PKG = "gossipfs_tpu_torch"

# ---------------------------------------------------------------------------
# quorum arithmetic -- owner: gossipfs_tpu_torch/sdfs/quorum.py
# ---------------------------------------------------------------------------

_QUORUM_OWNER = f"{_PKG}/sdfs/quorum.py"


def _is_const(node: ast.AST, value: int) -> bool:
    return isinstance(node, ast.Constant) and node.value == value


def _is_quorum_expr(node: ast.AST) -> bool:
    """``(x + 1) // 2`` or ``x // 2 + 1``: the int forms of
    floor/ceil((n+1)/2) the quorums derive from."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.FloorDiv):
        if _is_const(node.right, 2) and isinstance(node.left, ast.BinOp) \
                and isinstance(node.left.op, ast.Add) \
                and (_is_const(node.left.left, 1)
                     or _is_const(node.left.right, 1)):
            return True
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        for half, one in ((node.left, node.right), (node.right, node.left)):
            if _is_const(one, 1) and isinstance(half, ast.BinOp) \
                    and isinstance(half.op, ast.FloorDiv) \
                    and _is_const(half.right, 2):
                return True
    return False


@rule(
    "quorum-ownership",
    "W/R quorum arithmetic ((x+1)//2, x//2+1) may appear only in "
    "sdfs/quorum.py; every other module imports the named functions",
    fixture="lint/quorum_ownership.py",
    fixture_at=f"{_PKG}/traffic/_lint_fixture.py",
)
def check_quorum(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel == _QUORUM_OWNER:
            continue
        for node in ast.walk(index.tree(rel)):
            if _is_quorum_expr(node):
                out.append(Finding(
                    "quorum-ownership", rel, node.lineno,
                    "quorum arithmetic re-derived here -- import "
                    "read_quorum/write_quorum from "
                    "gossipfs_tpu_torch.sdfs.quorum",
                ))
    return out


# ---------------------------------------------------------------------------
# stripe quorum arithmetic -- owner: gossipfs_tpu_torch/sdfs/quorum.py
# ---------------------------------------------------------------------------

_STRIPE_NAMES = {"k", "m", "stripe_k", "stripe_m", "STRIPE_K", "STRIPE_M"}


def _is_stripe_threshold(node: ast.AST) -> bool:
    """``k + m - slack`` used as a COMPARISON bound: the stripe
    write-quorum shape (``acks >= k + m - f``).  ``k + m`` alone (a
    stripe width, a loop bound) is legal everywhere."""
    if not isinstance(node, ast.Compare):
        return False
    for comp in [node.left, *node.comparators]:
        if isinstance(comp, ast.BinOp) and isinstance(comp.op, ast.Sub) \
                and isinstance(comp.left, ast.BinOp) \
                and isinstance(comp.left.op, ast.Add) \
                and len(names_in(comp.left) & _STRIPE_NAMES) >= 2:
            return True
    return False


@rule(
    "stripe-quorum-ownership",
    "the stripe threshold shape (acks >= k + m - slack, k-of-(k+m) "
    "bounds) may appear only in sdfs/quorum.py; erasure/traffic/bench "
    "import stripe_read_quorum/stripe_write_quorum",
    fixture="lint/stripe_quorum_ownership.py",
    fixture_at=f"{_PKG}/erasure/_lint_fixture.py",
)
def check_stripe_quorum(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel == _QUORUM_OWNER:
            continue
        for node in ast.walk(index.tree(rel)):
            if _is_stripe_threshold(node):
                out.append(Finding(
                    "stripe-quorum-ownership", rel, node.lineno,
                    "stripe threshold arithmetic (k + m - slack in a "
                    "comparison) re-derived here -- import "
                    "stripe_read_quorum/stripe_write_quorum from "
                    "gossipfs_tpu_torch.sdfs.quorum",
                ))
    return out


# ---------------------------------------------------------------------------
# exponential backoff -- owner: gossipfs_tpu_torch/shim/retry.py
# ---------------------------------------------------------------------------

_BACKOFF_OWNER = f"{_PKG}/shim/retry.py"
_SLEEPS = {"time.sleep", "asyncio.sleep"}


def _grows_geometrically(loop: ast.AST, name: str) -> bool:
    """True if ``name`` GROWS geometrically inside the loop: ``delay *=
    2``, ``delay = delay * k`` (capped or not) and ``delay = base **
    attempt``.  A product that does not feed the name back into itself
    (linear steps, jitter) is not a backoff schedule."""
    for node in ast.walk(loop):
        if isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name) \
                and node.target.id == name \
                and isinstance(node.op, (ast.Mult, ast.Pow)):
            return True
        if isinstance(node, ast.Assign):
            targets = {t.id for t in node.targets if isinstance(t, ast.Name)}
            if name in targets:
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.BinOp) and (
                            isinstance(sub.op, ast.Pow)
                            or (isinstance(sub.op, ast.Mult)
                                and name in names_in(sub))):
                        return True
    return False


@rule(
    "backoff-ownership",
    "retry loops with a geometrically-growing sleep re-derive the "
    "bounded-backoff schedule; call shim.retry.call_with_backoff",
    fixture="lint/backoff_ownership.py",
    fixture_at=f"{_PKG}/deploy/_lint_fixture.py",
)
def check_backoff(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel == _BACKOFF_OWNER:
            continue
        for loop in ast.walk(index.tree(rel)):
            if not isinstance(loop, (ast.For, ast.While)):
                continue
            for node in ast.walk(loop):
                if isinstance(node, ast.Call) \
                        and dotted(node.func) in _SLEEPS:
                    for name in names_in(node):
                        if _grows_geometrically(loop, name):
                            out.append(Finding(
                                "backoff-ownership", rel, node.lineno,
                                "exponential retry backoff re-derived "
                                "here -- use shim.retry.call_with_backoff "
                                "(the one bounded-backoff discipline)",
                            ))
                            break
    return out


# ---------------------------------------------------------------------------
# obs event-line parsing -- owner: gossipfs_tpu_torch/obs/ (timeline.py is
# the port's tools/timeline.py)
# ---------------------------------------------------------------------------

_OBS_PARSE_OWNER = f"{_PKG}/obs/"


@rule(
    "obsparse-ownership",
    "hand-parsing obs event lines (json.loads + the \"kind\" key in one "
    "function) outside obs/; use obs.schema.Event.from_record / "
    "obs.recorder.load_stream",
    fixture="lint/obsparse_ownership.py",
    fixture_at=f"{_PKG}/campaigns/_lint_fixture.py",
)
def check_obsparse(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel.startswith(_OBS_PARSE_OWNER):
            continue
        for fn in functions(index.tree(rel)):
            loads_line = None
            touches_kind = False
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and dotted(node.func) == "json.loads":
                    loads_line = loads_line or node.lineno
                if const_str(node) == "kind":
                    touches_kind = True
            if loads_line is not None and touches_kind:
                out.append(Finding(
                    "obsparse-ownership", rel, loads_line,
                    f"{fn.name}() json.loads-parses records and reads "
                    "their \"kind\" by hand -- route through "
                    "obs.schema.Event.from_record / obs.recorder."
                    "load_stream so schema changes stay one-owner",
                ))
    return out


# ---------------------------------------------------------------------------
# latency quantile rollup -- owner: gossipfs_tpu_torch/traffic/workload.py
# ---------------------------------------------------------------------------

_QUANTILE_OWNER = f"{_PKG}/traffic/workload.py"
_QUANTILE_KEYS = {"p50_ms", "p95_ms"}


@rule(
    "quantile-ownership",
    "the p50/p95 nearest-rank rollup convention has one owner "
    "(traffic.workload.quantiles); building those keys by hand or "
    "calling statistics.quantiles re-derives it",
    fixture="lint/quantile_ownership.py",
    fixture_at=f"{_PKG}/bench/_lint_fixture.py",
)
def check_quantiles(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel == _QUANTILE_OWNER:
            continue
        for node in ast.walk(index.tree(rel)):
            if isinstance(node, ast.Dict):
                keys = {const_str(k) for k in node.keys if k is not None}
                if keys & _QUANTILE_KEYS:
                    out.append(Finding(
                        "quantile-ownership", rel, node.lineno,
                        "p50/p95 rollup keys built by hand -- call "
                        "traffic.workload.quantiles (the one "
                        "nearest-rank convention)",
                    ))
            if isinstance(node, ast.Call) \
                    and dotted(node.func) == "statistics.quantiles":
                out.append(Finding(
                    "quantile-ownership", rel, node.lineno,
                    "statistics.quantiles re-derives the latency rollup "
                    "-- call traffic.workload.quantiles",
                ))
    return out


# ---------------------------------------------------------------------------
# "n/a" vitals rendering -- owner: gossipfs_tpu_torch/obs/schema.py
# ---------------------------------------------------------------------------

_NA_OWNER = f"{_PKG}/obs/schema.py"


@rule(
    "na-render-ownership",
    "the n/a-not-0 vitals rule has one renderer (obs.schema.render_vitals"
    " / obs.schema.na); a literal \"n/a\" anywhere else is a re-derived "
    "copy that can drift into fabricating clean zeros",
    fixture="lint/na_ownership.py",
    fixture_at=f"{_PKG}/shim/_lint_fixture.py",
)
def check_na(index: RepoIndex) -> list[Finding]:
    out = []
    for rel in index.py_files():
        if rel == _NA_OWNER:
            continue
        for node in ast.walk(index.tree(rel)):
            if const_str(node) == "n/a":
                out.append(Finding(
                    "na-render-ownership", rel, node.lineno,
                    "literal \"n/a\" rendered outside obs/schema.py -- "
                    "use obs.schema.na(value) / render_vitals so the "
                    "absent-not-zero convention stays one-owner",
                ))
    return out


# ---------------------------------------------------------------------------
# shared-memory budgets -- owners: the csrc/*.cuh budget functions, and
# their Python mirrors in ops/ (the JAX package's vmem-scratch-ownership)
# ---------------------------------------------------------------------------

_CSRC = f"{_PKG}/csrc"
_OPS = f"{_PKG}/ops/"
# the Python budget constants: module-level definitions live in ops/ only
BUDGET_CONSTANTS = ("ONEPASS_SMEM", "STRIPE_MAX_N", "MAX_KERNEL_FANOUT",
                    "ARC_MATCH_MAX_GROUPS")

# the size sites of a launch: the launch config's dynamic shared memory,
# the opt-in attribute's size, the third argument of <<<grid, block, smem,
# stream>>>, and an offset into the extern dynamic array
_SITE_RES = (
    re.compile(r"\.dynamicSmemBytes\s*=\s*([^;]+);"),
    re.compile(r"cudaFuncAttributeMaxDynamicSharedMemorySize\s*,\s*"
               r"([^;]+?)\)\s*;"),
)
_LAUNCH_RE = re.compile(r"<<<(.*?)>>>", re.S)
_EXTERN_RE = re.compile(r"extern\s+__shared__[^;]*?\b(\w+)\s*\[\s*\]\s*;")
_DEF_RE = re.compile(r"(?:constexpr|inline|_HD)\s+(?:[\w:<>]+\s+)*?"
                     r"(\w+)\s*\([^;{]*\)\s*\{", re.S)
_CAST_RE = re.compile(r"^\(\s*(?:size_t|int|long|unsigned|long long|"
                      r"unsigned int)\s*\)\s*")


def _budget_functions(index: RepoIndex) -> set[str]:
    """Names of the functions the ``csrc/*.cuh`` headers define."""
    names: set[str] = set()
    for rel in index.files((_CSRC,), (".cuh",)):
        names |= set(_DEF_RE.findall(index.source(rel)))
    return names


def _strip(expr: str) -> str:
    expr = expr.strip()
    while True:
        new = _CAST_RE.sub("", expr).strip()
        if new.startswith("(") and _balanced_outer(new):
            new = new[1:-1].strip()
        if new == expr:
            return expr
        expr = new


def _balanced_outer(s: str) -> bool:
    """Whether the parenthesis opening ``s`` closes at its very end."""
    depth = 0
    for i, ch in enumerate(s):
        depth += ch == "("
        depth -= ch == ")"
        if depth == 0:
            return i == len(s) - 1
    return False


def _top_split(expr: str, ops: str) -> list[str]:
    """``expr`` split at top-level (unparenthesised) operators ``ops``."""
    parts, depth, cur = [], 0, ""
    for ch in expr:
        depth += ch in "(["
        depth -= ch in ")]"
        if depth == 0 and ch in ops:
            parts.append(cur)
            cur = ""
        else:
            cur += ch
    return parts + [cur]


def _owned(expr: str, src: str, before: int, budget: set[str],
           header_types: set[str], depth: int = 0) -> bool:
    """Whether a size expression comes from a named header budget
    function: a call to one (any namespace, any cast), 0 (no dynamic
    shared memory), a ternary whose arms are owned, a local whose latest
    definition before the site is owned, or a field of a struct the
    headers define and fill (``gring::Grid``)."""
    e = _strip(expr)
    if depth > 4:
        return False
    if e == "0":
        return True
    if "?" in e:
        arms = e.split("?", 1)[1].split(":", 1)
        return len(arms) == 2 and all(
            _owned(a, src, before, budget, header_types, depth + 1)
            for a in arms)
    if len(_top_split(e, "+-*/")) > 1:
        return False    # a local sum or product: the budget re-derived
    m = re.fullmatch(r"(?:\w+::)*(\w+)\s*\(.*\)", e, re.S)
    if m:
        return m.group(1) in budget
    m = re.fullmatch(r"(\w+)(?:\.|->)\w+", e)
    if m:
        decl = re.search(rf"(?:\w+::)*(\w+)\s*\*?\s*\b{m.group(1)}\s*[;=]",
                         src[:before])
        return decl is not None and decl.group(1) in header_types
    if re.fullmatch(r"\w+", e) and not e.isdigit():
        defs = list(re.finditer(rf"\b{e}\s*=\s*([^;=][^;]*);", src[:before]))
        return bool(defs) and _owned(defs[-1].group(1), src,
                                     defs[-1].start(), budget, header_types,
                                     depth + 1)
    return False


@rule(
    "smem-budget-ownership",
    "every dynamic shared-memory size a csrc/*.cu launch asks for "
    "(dynamicSmemBytes, the opt-in attribute, <<<..., smem, ...>>>, an "
    "offset into the extern array) comes from a named budget function of "
    "a csrc/*.cuh header, never a literal or a local sum; the Python "
    "budget constants (ONEPASS_SMEM, STRIPE_MAX_N, MAX_KERNEL_FANOUT, "
    "ARC_MATCH_MAX_GROUPS) are defined in ops/ only",
    fixture="lint_torch/smem_budget_ownership.cu",
    fixture_at=f"{_CSRC}/_lint_fixture.cu",
)
def check_smem_budget(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    budget = _budget_functions(index)
    header_types = set()
    for rel in index.files((_CSRC,), (".cuh",)):
        header_types |= set(re.findall(r"\bstruct\s+(\w+)\s*\{",
                                       index.source(rel)))
    sources = index.files((_CSRC,), (".cu",))
    if not budget or not sources:
        return [Finding("smem-budget-ownership", _CSRC, 1,
                        "no csrc/*.cuh budget functions or no csrc/*.cu "
                        "launches found -- the rule went blind")]
    for rel in sources:
        src = index.source(rel)
        for expr, pos in _sites(src):
            if not _owned(expr, src, pos, budget, header_types):
                out.append(Finding(
                    "smem-budget-ownership", rel, line_of(src, pos),
                    f"shared-memory size `{expr.strip()}` is not a csrc "
                    "header budget function -- the budget probe "
                    "(smem-budget-probe) cannot reconcile it with ops/'s "
                    "Python formula",
                ))
    for rel in index.py_files():
        if rel.startswith(_OPS):
            continue
        for node in index.tree(rel).body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = [t.id for t in node.targets
                           if isinstance(t, ast.Name)]
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                targets = [node.target.id]
            for name in set(targets) & set(BUDGET_CONSTANTS):
                out.append(Finding(
                    "smem-budget-ownership", rel, node.lineno,
                    f"budget constant {name} defined outside ops/ -- "
                    "import it from gossipfs_tpu_torch.ops so the probe's "
                    "reconciliation covers the value in use",
                ))
    return out


def _sites(src: str) -> list[tuple[str, int]]:
    """(size expression, offset) of every size site of one source."""
    sites = [(m.group(1), m.start(1)) for r in _SITE_RES
             for m in r.finditer(src)]
    for m in _LAUNCH_RE.finditer(src):
        args = _top_split(m.group(1), ",")
        if len(args) > 2:
            sites.append((args[2], m.start(1) + len(",".join(args[:2])) + 1))
    for arr in _EXTERN_RE.findall(src):
        # ``arr + <offset>``: the offset runs to the statement's end or the
        # call's closing parenthesis, nested calls included
        for m in re.finditer(rf"\b{arr}\s*\+\s*", src):
            depth, end = 0, m.end()
            while end < len(src) and src[end] != ";" and not (
                    depth == 0 and src[end] in ",)"):
                depth += src[end] == "("
                depth -= src[end] == ")"
                end += 1
            sites.append((src[m.end():end], m.end()))
    return sites


def smem_sites(index: RepoIndex) -> list[tuple[str, int, str]]:
    """(path, line, size expression) of every size site the rule reads:
    what the tests hold against a vacuous pass."""
    out = []
    for rel in index.files((_CSRC,), (".cu",)):
        src = index.source(rel)
        out += [(rel, line_of(src, pos), expr) for expr, pos in _sites(src)]
    return out
