"""device-hygiene for ``core/`` and ``ops/``: the round stays on the card.

The port's twin of the JAX package's ``jit-hygiene``.  There a host call
froze into a traced program; here the round loops are Python driving the
card, and the same invariants keep them a device program:

* no host randomness anywhere in ``core/`` and ``ops/``: no stdlib
  ``random``, no ``numpy.random``, no torch RNG call without an explicit
  ``generator=`` (and no reseeding of torch's global RNG).  The port draws
  every random bit from its threefry ``gossipfs_tpu_torch.random``, keyed
  by round, which is what makes it replay the JAX package bit for bit;
* no host clock there, apart from the owned collective timer
  (:data:`CLOCK_OWNERS`);
* no per-round host sync -- ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``bool``/``int``/``float`` of a device value,
  ``torch.cuda.synchronize``, ``print`` -- and no Python branch on a device
  value inside the round: the bodies of the round loops of
  ``run_lean_packed`` (the lean loop) and ``_run_general`` (the
  separate-pass loop, which ``run_rounds`` dispatches to), and every
  function of ``core/rounds.py`` those bodies reach by name (the
  separate-pass round ``_round_core`` and its stages).  Each such sync
  makes the host wait for the card once a round, so the launches of the
  next round cannot queue behind the current one.

A site that is a deliberate exception sits in :data:`ALLOWLIST` with its
reason, as the schema's ``SCAN_UNEXPORTED`` does for unexported metrics.
"""

from __future__ import annotations

import ast

from gossipfs_tpu_torch.analysis.framework import (
    Finding,
    RepoIndex,
    dotted,
    rule,
)

_SCAN_DIRS = ("gossipfs_tpu_torch/core", "gossipfs_tpu_torch/ops")
_ROUNDS = "gossipfs_tpu_torch/core/rounds.py"

# the round loops: (function, the loop's range argument)
ROUND_LOOPS = (("run_lean_packed", "num_rounds"),
               ("_run_general", "num_rounds"))

# The owned host clock: the shards' all-reduce timer behind
# rounds.COLLECTIVES, the seconds a rank waits in its one collective a
# round (roundprof and the sharded phases read them).  It times a host
# wait that happens anyway; nothing of the round reads the clock.
CLOCK_OWNERS = {
    "ShardCtx.psum": "the collective timer behind rounds.COLLECTIVES: "
                     "host seconds a rank waits in its all-reduce, read by "
                     "the profilers, never by the round",
}

# Deliberate syncs and branches inside the round: (function, the sync
# call or the branch test, as ast.unparse writes it) -> reason.
ALLOWLIST = {
    ("_apply_events", "bool((leave | eff).any())"):
        "rounds with matrix events only (joins, LEAVE broadcast; never the "
        "lean loop): one host read of whether anyone leaves or joins this "
        "round skips the two row passes over the [N, N] lanes that the "
        "events would rewrite",
    ("_apply_events", "not bool((leave | eff).any())"):
        "the branch of that early return, on the same one host read",
}

# module names whose calls draw host randomness or read the host clock
_RANDOM_MODULES = {"random", "numpy.random"}
_CLOCK_MODULES = {"time", "datetime"}
_TORCH_RNG = {"rand", "randn", "randint", "randperm", "rand_like",
              "randn_like", "randint_like", "normal", "bernoulli",
              "multinomial", "poisson"}
_TENSOR_RNG = {"uniform_", "normal_", "random_", "bernoulli_",
               "exponential_", "geometric_", "cauchy_", "log_normal_"}
_TORCH_RESEED = {"torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
                 "torch.cuda.manual_seed_all", "torch.cuda.seed",
                 "torch.cuda.seed_all"}

_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy"}
_SYNC_CALLS = {"print", "breakpoint", "torch.cuda.synchronize",
               "np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_CASTS = {"bool", "int", "float"}

# reads of a tensor that stay on the host (metadata), and calls whose
# result is host metadata whatever their arguments
_STATIC_ATTRS = {"shape", "dtype", "device", "ndim", "is_cuda", "layout",
                 "size", "dim", "numel", "element_size", "_fields"}
_STATIC_CALLS = {"len", "isinstance", "swar_lanes_ok", "torch.iinfo",
                 "torch.finfo", "torch.device", "torch.Size"}
# parameter annotations that name host values
_HOST_TYPES = {"SimConfig", "ShardCtx", "bool", "int", "float", "str",
               "None", "dict", "list", "dtype", "device"}
# unannotated parameters of the round that hold host values
_HOST_PARAMS = {"self", "config", "ctx", "plain", "matrix_events",
                "num_rounds", "crash_rate", "rejoin_rate", "stats",
                "scenario", "edge_filter"}


def _imports(tree: ast.Module) -> dict[str, str]:
    """local name -> module for every ``import m [as x]`` and ``from
    pkg import m [as x]`` in the module."""
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out


def _qualnames(tree: ast.Module) -> dict[int, str]:
    """id(node) -> ``Class.function`` qualified name of its function."""
    out: dict[int, str] = {}

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                name = f"{prefix}{child.name}"
                if not isinstance(child, ast.ClassDef):
                    for sub in ast.walk(child):
                        out.setdefault(id(sub), name)
                visit(child, name + ".")
            else:
                visit(child, prefix)

    visit(tree, "")
    return out


def host_calls(tree: ast.Module) -> list[tuple[ast.Call, str, str]]:
    """(call, "random"|"clock", name) of every host-randomness or
    host-clock call in a module, import aliases resolved (so the port's
    own ``random`` module, imported as ``trandom``, is not stdlib's)."""
    imports = _imports(tree)
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        has_gen = any(kw.arg == "generator" for kw in node.keywords)
        head, _, rest = (name or "").partition(".")
        full = f"{imports[head]}.{rest}" if head in imports and rest else ""
        mod, _, fn = full.rpartition(".")
        if mod in _RANDOM_MODULES or full.startswith("numpy.random."):
            out.append((node, "random", name))
        elif mod.split(".")[0] in _CLOCK_MODULES:
            out.append((node, "clock", name))
        elif (mod == "torch" and fn in _TORCH_RNG and not has_gen) \
                or full in _TORCH_RESEED:
            out.append((node, "random", name))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in _TENSOR_RNG and not has_gen:
            out.append((node, "random", name or node.func.attr))
    return out


def round_scope(tree: ast.Module) -> list[tuple[str, list[ast.AST],
                                                 ast.FunctionDef]]:
    """(function name, nodes to check, function) of the round: the loop
    bodies of :data:`ROUND_LOOPS` and every module function they reach by
    name, transitively."""
    defs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    out, seen, todo = [], set(), []
    for name, bound in ROUND_LOOPS:
        fn = defs.get(name)
        if fn is None:
            continue
        for loop in ast.walk(fn):
            if isinstance(loop, ast.For) and isinstance(loop.iter, ast.Call) \
                    and dotted(loop.iter.func) == "range" \
                    and any(isinstance(a, ast.Name) and a.id == bound
                            for a in loop.iter.args):
                out.append((name, loop.body, fn))
                todo += [c.func.id for stmt in loop.body
                         for c in ast.walk(stmt)
                         if isinstance(c, ast.Call)
                         and isinstance(c.func, ast.Name)]
    while todo:
        name = todo.pop()
        if name in seen or name not in defs:
            continue
        seen.add(name)
        fn = defs[name]
        out.append((name, fn.body, fn))
        todo += [c.func.id for c in ast.walk(fn)
                 if isinstance(c, ast.Call) and isinstance(c.func, ast.Name)]
    return out


def _annotation_host(ann: ast.AST | None) -> bool | None:
    """True/False where an annotation names host/device values, None
    where there is no annotation."""
    if ann is None:
        return None
    names, todo = set(), [ann]
    while todo:
        node = todo.pop()
        if isinstance(node, ast.BinOp):             # X | None
            todo += [node.left, node.right]
        elif isinstance(node, ast.Subscript):       # list[int]
            todo.append(node.value)
        elif isinstance(node, ast.Constant):
            names.add("None" if node.value is None else str(node.value))
        else:
            names.add((dotted(node) or "?").rsplit(".", 1)[-1])
    return names <= _HOST_TYPES


def _static_occurrences(node: ast.AST) -> set[int]:
    """ids of the Name nodes under host-metadata reads: ``x.shape``,
    ``x.size()``, ``x is None``, ``len(x)``, ``swar_lanes_ok(x)``."""
    out: set[int] = set()
    for sub in ast.walk(node):
        under = None
        if isinstance(sub, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops):
            under = sub
        elif isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            under = sub
        elif isinstance(sub, ast.Call) and dotted(sub.func) in _STATIC_CALLS:
            under = sub
        if under is not None:
            out |= {id(n) for n in ast.walk(under) if isinstance(n, ast.Name)}
    return out


def _device_expr(node: ast.AST, device: set[str]) -> bool:
    """Whether an expression holds a device value: a live occurrence of
    a device name, or a torch call that makes a tensor."""
    static = _static_occurrences(node)
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in device \
                and id(sub) not in static:
            return True
        if isinstance(sub, ast.Call):
            name = dotted(sub.func) or ""
            if name.startswith("torch.") and name not in _STATIC_CALLS \
                    and not name.startswith("torch.cuda."):
                return True
    return False


def _bound_names(targets) -> list[str]:
    """The names an assignment binds (not those read inside a subscript
    or attribute target such as ``hb[r0:r1] = ...``)."""
    out, todo = [], list(targets)
    while todo:
        t = todo.pop()
        if isinstance(t, ast.Name):
            out.append(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            todo += t.elts
        elif isinstance(t, ast.Starred):
            todo.append(t.value)
    return out


def device_names(fn: ast.FunctionDef) -> set[str]:
    """The names of ``fn`` that hold device values: tensor parameters,
    then every local bound to a device expression (to a fixed point)."""
    device = set()
    args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
    for a in args:
        host = _annotation_host(a.annotation)
        if host is False or (host is None and a.arg not in _HOST_PARAMS):
            device.add(a.arg)
    binds = []
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if node.value is not None:
                binds.append((targets, node.value))
        elif isinstance(node, (ast.For, ast.comprehension)):
            binds.append(([node.target], node.iter))
        elif isinstance(node, (ast.FunctionDef, ast.Lambda)) \
                and node is not fn:
            for a in node.args.args:
                host = _annotation_host(getattr(a, "annotation", None))
                if host is not True:
                    device.add(a.arg)
    changed = True
    while changed:
        changed = False
        for targets, value in binds:
            if not _device_expr(value, device):
                continue
            for name in _bound_names(targets):
                if name not in device:
                    device.add(name)
                    changed = True
    return device


def round_sites(tree: ast.Module) -> list[tuple[str, str, int, str]]:
    """(function, "sync"|"branch", line, what) of every host sync and
    Python branch on a device value in the round (:func:`round_scope`)."""
    out = []
    for name, body, fn in round_scope(tree):
        device = device_names(fn)
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Call):
                    d = dotted(node.func)
                    attr = (node.func.attr
                            if isinstance(node.func, ast.Attribute) else None)
                    if d in _SYNC_CALLS or attr in _SYNC_ATTRS \
                            or (d in _CASTS and node.args
                                and _device_expr(node.args[0], device)):
                        out.append((name, "sync", node.lineno,
                                    ast.unparse(node)))
                test = getattr(node, "test", None)
                if isinstance(node, (ast.If, ast.While, ast.IfExp,
                                     ast.Assert)) \
                        and _device_expr(test, device):
                    out.append((name, "branch", node.lineno,
                                ast.unparse(test)))
    return out


@rule(
    "device-hygiene",
    "core/ and ops/ keep the round on the card: no host randomness "
    "(random., np.random., torch RNG without generator=) and no host clock "
    "(bar the owned collective timer), and no per-round host sync "
    "(.item/.tolist/.cpu/bool() of a tensor/synchronize/print) or Python "
    "branch on a device value in the round loops of run_lean_packed and "
    "_run_general and the round functions they reach, bar the allowlist",
    fixture="lint_torch/device_hygiene.py",
    fixture_at=_ROUNDS,
)
def check_device_hygiene(index: RepoIndex) -> list[Finding]:
    out: list[Finding] = []
    for rel in index.py_files(*_SCAN_DIRS):
        tree = index.tree(rel)
        qual = _qualnames(tree)
        for node, kind, name in host_calls(tree):
            owner = qual.get(id(node), "<module>")
            if kind == "clock" and rel == _ROUNDS and owner in CLOCK_OWNERS:
                continue
            what = ("host randomness" if kind == "random"
                    else "host clock")
            out.append(Finding(
                "device-hygiene", rel, node.lineno,
                f"{what} {name}() in {owner} -- the round draws its bits "
                "from gossipfs_tpu_torch.random (threefry, keyed by round) "
                "and reads no host state" if kind == "random" else
                f"{what} {name}() in {owner} -- only the owned collective "
                "timer (ShardCtx.psum) reads the host clock in core/ and "
                "ops/",
            ))
    if not index.exists(_ROUNDS):
        return out
    tree = index.tree(_ROUNDS)
    scope = round_scope(tree)
    if not any(name == loop for name, _, _ in scope
               for loop, _ in ROUND_LOOPS):
        out.append(Finding(
            "device-hygiene", _ROUNDS, 1,
            "extractor went blind: the round loops of "
            f"{[n for n, _ in ROUND_LOOPS]} not found"))
    for name, kind, line, what in round_sites(tree):
        if (name, what) in ALLOWLIST:
            continue
        msg = (f"per-round host sync {what} in {name}() -- the host waits "
               "for the card once a round" if kind == "sync" else
               f"Python branch on a device value ({what}) in {name}() -- "
               "a host read of the card once a round; use torch.where")
        out.append(Finding("device-hygiene", _ROUNDS, line, msg))
    return out
