"""gossipfs-lint for the port: the rule registry and the repo source index.

The port's copy of the JAX package's analyzer core
(``gossipfs_tpu/analysis/framework.py``), with its own registry and its
own scan set: the rules here read the port's sources
(``gossipfs_tpu_torch/``, ``chip_smoke.py``) and the text files beside
them (``native/engine.cc``, ``native/codec.h``, ``BASELINE.md``,
``README.md``, the CUDA sources under ``gossipfs_tpu_torch/csrc/``), and
never import what they read.  Declarative :class:`Rule` objects over a
cached :class:`RepoIndex`, runnable as a library (``run_rules``) and as a
CLI (``python -m gossipfs_tpu_torch.analysis``, exit code 1 on any
finding).

Two rule kinds:

* ``"ast"`` -- source analysis with the standard library's ``ast`` and
  ``re`` only; no project imports, no torch.  These run everywhere.
* ``"probe"`` -- checks that execute code: the shared-memory budget probe
  compiles the kernels' budget headers and, on the card, reads the built
  kernels' attributes.  The CLI runs them only with ``--probe``.

Every rule names a fixture that makes it fire, mounted over the index via
``overlay``: the analyzer is tested (``tests/test_torch_analysis.py``),
not trusted.
"""

from __future__ import annotations

import ast
import dataclasses
import pathlib
from typing import Callable, Iterable

REPO_ROOT = pathlib.Path(__file__).resolve().parents[2]

# What the AST rules walk by default.  tests/ is out: fixtures must mount
# without tripping the repo-clean check, and test code quotes forbidden
# idioms when pinning them.  The analyzer itself is out for the same
# reason (its messages and matchers quote the idioms they forbid), and so
# is the gitignored kernel build directory.
DEFAULT_SCAN = ("gossipfs_tpu_torch", "chip_smoke.py")
_SKIP = ("gossipfs_tpu_torch/analysis/", "gossipfs_tpu_torch/_build/")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation, anchored to a source line."""

    rule: str
    path: str       # repo-relative posix path
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    description: str
    check: Callable[["RepoIndex"], list[Finding]]
    kind: str = "ast"               # "ast" | "probe"
    fixture: str | None = None      # tests/fixtures/<fixture> (lint/...)
    fixture_at: str | None = None   # virtual repo path the fixture mounts at


REGISTRY: dict[str, Rule] = {}


def rule(name: str, description: str, *, kind: str = "ast",
         fixture: str | None = None, fixture_at: str | None = None):
    """Register a rule in the port's registry.  ``fixture`` is a path
    under ``tests/fixtures/`` (``lint/...`` for the JAX package's fixtures
    the port mounts as they are, ``lint_torch/...`` for the port's own);
    ``RepoIndex(overlay={fixture_at: tests/fixtures/<fixture>})`` must make
    the rule produce at least one finding."""

    def deco(fn: Callable[["RepoIndex"], list[Finding]]):
        if name in REGISTRY:
            raise ValueError(f"duplicate rule name: {name}")
        REGISTRY[name] = Rule(name, description, fn, kind, fixture,
                              fixture_at)
        return fn

    return deco


# (real path, mtime, size) -> [source, tree]: one read and one parse of a
# file a process, shared by every index over it (the rules never mutate
# the trees they walk)
_FILES: dict[tuple, list] = {}


def _parsed(path: pathlib.Path, rel: str, tree: bool = False) -> list:
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    hit = _FILES.get(key)
    if hit is None:
        hit = _FILES[key] = [path.read_text(encoding="utf-8"), None]
    if tree and hit[1] is None:
        hit[1] = ast.parse(hit[0], filename=rel)
    return hit


class RepoIndex:
    """Cached source + AST access over the repo tree, with an overlay.

    ``overlay`` maps *virtual* repo-relative paths to real files on disk:
    an overlaid path joins every listing whose prefix (and suffix) matches
    and SHADOWS a real file at the same path -- how the fixture tests
    inject a violating module (or a violating stand-in for ``config.py``)
    without touching the tree.  ``device`` is where probe rules run
    (``"cuda"``, the default as for every entry point of the port, or
    ``"cpu"`` where the caller asks for it).
    """

    def __init__(self, root: pathlib.Path | str = REPO_ROOT,
                 overlay: dict[str, pathlib.Path | str] | None = None,
                 device: str = "cuda"):
        self.root = pathlib.Path(root)
        self.device = device        # where probe rules run their card half
        self.overlay = {k: pathlib.Path(v) for k, v in (overlay or {}).items()}
        self._src: dict[str, str] = {}
        self._tree: dict[str, ast.Module] = {}

    # -- file access --------------------------------------------------------
    def _real(self, rel: str) -> pathlib.Path:
        return self.overlay.get(rel, self.root / rel)

    def exists(self, rel: str) -> bool:
        return self._real(rel).is_file()

    def source(self, rel: str) -> str:
        if rel not in self._src:
            self._src[rel] = _parsed(self._real(rel), rel)[0]
        return self._src[rel]

    def tree(self, rel: str) -> ast.Module:
        if rel not in self._tree:
            self._tree[rel] = _parsed(self._real(rel), rel, True)[1]
        return self._tree[rel]

    def files(self, prefixes: Iterable[str], suffixes: tuple[str, ...],
              skip: tuple[str, ...] = _SKIP) -> list[str]:
        """Repo-relative posix paths of every file ending in one of
        ``suffixes`` under ``prefixes`` (a directory, or a file named
        outright), overlay included, ``skip`` prefixes left out."""
        out: set[str] = set()
        for pre in prefixes:
            base = self.root / pre
            if base.is_dir():
                for p in base.rglob("*"):
                    if "__pycache__" in p.parts or not p.is_file() \
                            or not p.name.endswith(suffixes):
                        continue
                    rel = p.relative_to(self.root).as_posix()
                    if not rel.startswith(skip):
                        out.add(rel)
            elif base.is_file():
                out.add(pre)
            for virt in self.overlay:
                if (virt == pre or virt.startswith(pre.rstrip("/") + "/")) \
                        and virt.endswith(suffixes):
                    out.add(virt)
        return sorted(out)

    def py_files(self, *prefixes: str) -> list[str]:
        """Every ``.py`` file under the prefixes (the default scan set when
        none given), overlay included."""
        return self.files(prefixes or DEFAULT_SCAN, (".py",))


# ---------------------------------------------------------------------------
# Shared AST helpers (used by every rules_* module)
# ---------------------------------------------------------------------------

def dotted(node: ast.AST) -> str | None:
    """``a.b.c`` for Attribute/Name chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def names_in(node: ast.AST) -> set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def functions(tree: ast.AST) -> Iterable[ast.FunctionDef | ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def func(tree: ast.AST, name: str, cls: str | None = None):
    """The (first) function ``name``, inside class ``cls`` when given."""
    scope = tree
    if cls is not None:
        scope = next((n for n in ast.walk(tree)
                      if isinstance(n, ast.ClassDef) and n.name == cls), None)
        if scope is None:
            return None
    for node in ast.walk(scope):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def module_literal(tree: ast.Module, name: str):
    """Evaluate a module-level ``NAME = <literal>`` assignment (None if
    there is none, or it is not a literal)."""
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
            value = node.value
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            targets, value = [node.target.id], node.value
        else:
            continue
        if name in targets and value is not None:
            try:
                return ast.literal_eval(value)
            except ValueError:
                return None
    return None


def assign_line(tree: ast.Module, name: str) -> int:
    """The line of the module-level assignment of ``name`` (1 if none)."""
    for node in tree.body:
        targets = []
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                           ast.Name):
            targets = [node.target.id]
        if name in targets:
            return node.lineno
    return 1


def namedtuple_fields(tree: ast.Module, class_name: str) -> list[str] | None:
    """Annotated field names of a ``class X(NamedTuple)`` definition."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return [
                stmt.target.id
                for stmt in node.body
                if isinstance(stmt, ast.AnnAssign)
                and isinstance(stmt.target, ast.Name)
            ]
    return None


def line_of(src: str, pos: int) -> int:
    """1-based line of character offset ``pos`` in ``src``."""
    return src.count("\n", 0, pos) + 1


def run_rules(index: RepoIndex | None = None,
              names: Iterable[str] | None = None,
              kinds: Iterable[str] = ("ast",)) -> list[Finding]:
    """Run the selected rules and return every finding, stably ordered."""
    index = index or RepoIndex()
    kinds = set(kinds)
    wanted = None if names is None else set(names)
    findings: list[Finding] = []
    for name, r in sorted(REGISTRY.items()):
        if wanted is not None and name not in wanted:
            continue
        if wanted is None and r.kind not in kinds:
            continue
        findings.extend(r.check(index))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
