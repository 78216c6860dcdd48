"""gossipfs-spec extractors over the port: statically recover each
engine's implemented protocol and diff it against the port's copy of
``protocol_spec``.

One rule per drift class, each with a committed seeded-drift fixture
asserted to fire it (the JAX package's ``tests/fixtures/lint/spec_*``,
mounted as they are at the port's paths, for the rules whose idiom
carries over; ``tests/fixtures/lint_torch/`` for the two rewritten for
the port's seams):

* ``spec-dissemination`` -- the new-suspicion SUSPECT push of the port's
  ``detector/udp.py`` (and of ``native/engine.cc``) honors the contract's
  campaign bound: subject + fanout sample, never an all-peers broadcast.
* ``spec-delta-dissemination`` -- the delta-piggyback membership refresh
  (``protocol_spec.DELTA_GOSSIP``) keeps its entry selection, cadence,
  defaults and construction constraint in both socket engines.
* ``spec-refute-rate-limit`` -- both socket engines rate-limit the REFUTE
  broadcast to once per period (compare-then-stamp).
* ``spec-transition-order`` -- the port's ``_tick`` and ``_tick_swar``
  compute the SUSPECT->FAILED confirm mask from PRE-WRITE status, then
  write SUSPECT, then FAILED, read in whatever form the port writes them
  (``torch.where`` assignments, in-place masked writes, SWAR word selects
  and ORs, per row chunk); the confirm window is built from the
  contract's t_fail / t_suspect / lh_multiplier.
* ``spec-runtime-protocol`` -- the port's ``suspicion/runtime.py`` carries
  the full lifecycle verb set and the degraded / stretched-window
  formulas.
* ``spec-native-annotations`` -- engine.cc's ``// @gfs:`` annotations,
  cross-checked both ways against the contract.
* ``spec-obs-kind-coverage`` -- the port's schema ``LIFECYCLE_KINDS`` and
  the contract's emit kinds are the same set.
* ``scan-carry-arity`` -- the port's seams agree in arity: the lean
  loop's return (``run_lean_packed``) against every unpack of it
  (``PackedDetector`` included), the separate-pass round's
  (``_round_core``) against its callers', the per-round stats against
  ``RoundMetrics``, and every ``MetricsCarry``/``RoundMetrics``
  construction and unpack against the NamedTuples.
"""

from __future__ import annotations

import ast
import re

from . import protocol_spec as spec
from .framework import (Finding, assign_line, dotted, func, line_of,
                        module_literal, names_in, namedtuple_fields, rule)

_UDP = "gossipfs_tpu_torch/detector/udp.py"
_RUNTIME = "gossipfs_tpu_torch/suspicion/runtime.py"
_ROUNDS = "gossipfs_tpu_torch/core/rounds.py"
_MESH = "gossipfs_tpu_torch/parallel/mesh.py"
_SIM = "gossipfs_tpu_torch/detector/sim.py"
_ENGINE = "native/engine.cc"
_SCHEMA = "gossipfs_tpu_torch/obs/schema.py"


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _attrs_in(node: ast.AST) -> set[str]:
    return {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _compares_push_random(test: ast.AST) -> bool:
    """True for a ``<x>.push == "random"`` (or reversed) comparison."""
    for node in ast.walk(test):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left] + list(node.comparators)
        names = set()
        consts = set()
        for s in sides:
            if isinstance(s, ast.Attribute):
                names.add(s.attr)
            elif isinstance(s, ast.Name):
                names.add(s.id)
            elif isinstance(s, ast.Constant) and isinstance(s.value, str):
                consts.add(s.value)
        if "push" in names and "random" in consts:
            return True
    return False


# ---------------------------------------------------------------------------
# spec-dissemination
# ---------------------------------------------------------------------------

@rule(
    "spec-dissemination",
    "new-suspicion SUSPECT dissemination must honor the contract bound: "
    "campaign profile (push=random) = subject + fanout sample, never an "
    "unconditional all-peers broadcast (protocol_spec.DISSEMINATION)",
    fixture="lint/spec_udp_widened.py",
    fixture_at=_UDP,
)
def spec_dissemination(index) -> list[Finding]:
    findings: list[Finding] = []
    row = spec.dissemination_row("new_suspect", "campaign")
    # -- udp engine: the rt.suspect(...) branch of UdpNode.tick is the
    # one place a NEW suspicion is disseminated
    tree = index.tree(_UDP)
    fn = func(tree, "tick")
    branch = None
    if fn is not None:
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            for call in ast.walk(node.test):
                if isinstance(call, ast.Call):
                    d = dotted(call.func)
                    if d is not None and d.endswith(".suspect"):
                        branch = node
                        break
            if branch is not None:
                break
    if branch is None:
        findings.append(Finding(
            "spec-dissemination", _UDP, 1,
            "extractor went blind: UdpNode.tick's rt.suspect(...) branch "
            "not found — the analyzer cannot see the new-suspicion "
            "dissemination it exists to bound",
        ))
    else:
        bounded = False
        for sub in ast.walk(branch):
            if not isinstance(sub, ast.If) \
                    or not _compares_push_random(sub.test):
                continue
            gated_attrs: set[str] = set()
            gated_calls: set[str] = set()
            for stmt in sub.body:
                gated_attrs |= _attrs_in(stmt)
                for c in ast.walk(stmt):
                    if isinstance(c, ast.Call):
                        d = dotted(c.func)
                        if d is not None:
                            gated_calls.add(d.rsplit(".", 1)[-1])
            if "fanout" in gated_attrs and "sample" in gated_calls:
                bounded = True
        if not bounded:
            findings.append(Finding(
                "spec-dissemination", _UDP, branch.lineno,
                "new-suspicion SUSPECT dissemination is not bounded under "
                f"the campaign profile: the contract row requires "
                f"'{row.bound}' there (a push == \"random\" gate sending "
                "to the subject plus an rng.sample(..., fanout) draw) — "
                "found an unconditional broadcast, O(suspects x N) per "
                "round at cohort sizes",
            ))
    # -- native engine: the newly_suspect loop must carry the same gate
    src = index.source(_ENGINE)
    pos = src.find("newly_suspect)")
    if pos < 0:
        findings.append(Finding(
            "spec-dissemination", _ENGINE, 1,
            "extractor went blind: the newly_suspect dissemination loop "
            "was not found in the native Tick",
        ))
    else:
        window = src[pos:pos + 2500]
        if "push_random" not in window or "fanout" not in window:
            findings.append(Finding(
                "spec-dissemination", _ENGINE, line_of(src, pos),
                "native newly-suspect dissemination lost its campaign "
                f"bound: the contract row requires '{row.bound}' behind "
                "a push_random gate with a fanout-sized sample",
            ))
    return findings


# ---------------------------------------------------------------------------
# spec-delta-dissemination
# ---------------------------------------------------------------------------

_CODEC_H = "native/codec.h"


def _ctor_defaults(tree: ast.Module, cls_name: str):
    """{param: literal default} for ``cls_name.__init__``, or None."""
    for node in ast.walk(tree):
        if not (isinstance(node, ast.ClassDef) and node.name == cls_name):
            continue
        for f in node.body:
            if not (isinstance(f, ast.FunctionDef)
                    and f.name == "__init__"):
                continue
            out: dict[str, object] = {}
            a = f.args
            pos = a.args[len(a.args) - len(a.defaults):]
            for arg, d in list(zip(pos, a.defaults)) + [
                    (k, v) for k, v in zip(a.kwonlyargs, a.kw_defaults)
                    if v is not None]:
                try:
                    out[arg.arg] = ast.literal_eval(d)
                except ValueError:
                    pass
            return out, f
    return None, None


@rule(
    "spec-delta-dissemination",
    "the delta-piggyback membership refresh must match "
    "protocol_spec.DELTA_GOSSIP in both socket engines: changed-first "
    "+ rr-tail + capped entry selection, cluster-round-aligned "
    "anti-entropy cadence, contract-identical defaults, and the "
    "anti_entropy_every < t_fail constraint enforced at construction",
    fixture="lint/spec_delta_dissemination.py",
    fixture_at=_UDP,
)
def spec_delta_dissemination(index) -> list[Finding]:
    findings: list[Finding] = []
    dg = spec.DELTA_GOSSIP
    # -- udp engine: wire mark literal
    tree = index.tree(_UDP)
    mark = module_literal(tree, "DELTA_MARK")
    if mark != dg["wire_mark"]:
        findings.append(Finding(
            "spec-delta-dissemination", _UDP,
            assign_line(tree, "DELTA_MARK"),
            f"udp DELTA_MARK is {mark!r} where the contract wire mark "
            f"is {dg['wire_mark']!r} — delta frames would stop "
            "dispatching through the hardened merge on one side",
        ))
    # -- udp engine: the entry-selection rule lives in _encode_delta
    fn = func(tree, "_encode_delta")
    if fn is None:
        findings.append(Finding(
            "spec-delta-dissemination", _UDP, 1,
            "extractor went blind: UdpNode._encode_delta not found — "
            "the delta entry-selection rule the contract bounds is "
            "invisible",
        ))
    else:
        attrs = _attrs_in(fn)
        recent_first = any(
            isinstance(c, ast.Call)
            and (dotted(c.func) or "").endswith(".sort")
            and any(kw.arg == "reverse"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True for kw in c.keywords)
            for c in ast.walk(fn))
        missing = []
        if "_sent_ver" not in attrs:
            missing.append("per-peer change cursor (_sent_ver)")
        if "ver" not in attrs:
            missing.append("monotone entry version (ver)")
        if not recent_first:
            missing.append("most-recent-first sort (reverse=True)")
        if "_refresh_pos" not in attrs:
            missing.append("round-robin stable-tail refresh "
                           "(_refresh_pos)")
        if "delta_entries" not in attrs:
            missing.append("per-datagram cap (delta_entries)")
        if missing:
            findings.append(Finding(
                "spec-delta-dissemination", _UDP, fn.lineno,
                "udp _encode_delta drifted from the contract selection "
                f"rule '{dg['bound']}' — lost: " + "; ".join(missing),
            ))
    # -- udp engine: anti-entropy cadence in tick (cluster-round mod)
    fn = func(tree, "tick")
    cadence = fn is not None and any(
        isinstance(node, ast.Compare)
        and isinstance(node.left, ast.BinOp)
        and isinstance(node.left.op, ast.Mod)
        and {"rounds", "anti_entropy_every"} <= _attrs_in(node)
        for node in ast.walk(fn))
    if not cadence:
        findings.append(Finding(
            "spec-delta-dissemination", _UDP,
            fn.lineno if fn is not None else 1,
            "udp tick lost the cluster-round-aligned anti-entropy "
            "cadence (rounds % anti_entropy_every == 0 pushing the "
            "FULL list) — a lost delta could wedge convergence forever",
        ))
    # -- udp engine: defaults + construction constraint
    defaults, init = _ctor_defaults(tree, "UdpCluster")
    if defaults is None:
        findings.append(Finding(
            "spec-delta-dissemination", _UDP, 1,
            "extractor went blind: UdpCluster.__init__ not found — the "
            "delta knob defaults cannot be diffed against the contract",
        ))
    else:
        for knob, key in (("delta_entries", "max_entries"),
                          ("anti_entropy_every", "anti_entropy_every")):
            if defaults.get(knob) != dg[key]:
                findings.append(Finding(
                    "spec-delta-dissemination", _UDP, init.lineno,
                    f"udp default {knob}={defaults.get(knob)!r} drifted "
                    f"from the contract's {key}={dg[key]} — the two "
                    "socket engines would ship different wire shapes "
                    "under identical case configs",
                ))
        guarded = any(
            isinstance(sub, ast.If)
            and {"anti_entropy_every", "t_fail"} <= {
                n.id for n in ast.walk(sub.test)
                if isinstance(n, ast.Name)}
            and any(isinstance(s, ast.Raise) for s in sub.body)
            for sub in ast.walk(init))
        if not guarded:
            findings.append(Finding(
                "spec-delta-dissemination", _UDP, init.lineno,
                f"udp UdpCluster dropped the '{dg['constraint']}' "
                "construction guard — an anti-entropy gap past the "
                "detection window manufactures false positives",
            ))
    # -- native engine: annotated cadence + selection tokens
    src = index.source(_ENGINE)
    pos = src.find("membership_refresh profile=delta")
    if pos < 0:
        findings.append(Finding(
            "spec-delta-dissemination", _ENGINE, 1,
            "extractor went blind: the @gfs:dissemination "
            "membership_refresh annotation is gone from the native Tick",
        ))
    else:
        window = src[pos:pos + 2000]
        if "anti_entropy_every" not in window \
                or "PushRefresh" not in window:
            findings.append(Finding(
                "spec-delta-dissemination", _ENGINE, line_of(src, pos),
                "native Tick's annotated delta push lost its shape: the "
                "annotation must dominate the anti_entropy_every cadence "
                "and the PushRefresh per-peer selection call",
            ))
    for knob, key in (("delta_entries", "max_entries"),
                      ("anti_entropy_every", "anti_entropy_every")):
        m = re.search(rf"int\s+{knob}\s*=\s*(\d+)\s*;", src)
        if m is None or int(m.group(1)) != dg[key]:
            findings.append(Finding(
                "spec-delta-dissemination", _ENGINE,
                line_of(src, m.start()) if m else 1,
                f"native default {knob} drifted from the contract's "
                f"{key}={dg[key]}",
            ))
    if not re.search(
            r"delta\s*&&\s*cfg_\.anti_entropy_every\s*>=\s*cfg_\.t_fail",
            src):
        findings.append(Finding(
            "spec-delta-dissemination", _ENGINE, 1,
            f"native gfs_configure dropped the '{dg['constraint']}' "
            "reject — the knob combination that manufactures false "
            "positives must not start loops",
        ))
    csrc = index.source(_CODEC_H)
    if f'kDeltaMark[] = "{dg["wire_mark"]}"' not in csrc:
        findings.append(Finding(
            "spec-delta-dissemination", _CODEC_H, 1,
            f"native kDeltaMark no longer equals the contract wire "
            f"mark {dg['wire_mark']!r}",
        ))
    return findings


# ---------------------------------------------------------------------------
# spec-refute-rate-limit
# ---------------------------------------------------------------------------

@rule(
    "spec-refute-rate-limit",
    "the REFUTE broadcast must be rate-limited to once per heartbeat "
    "period in both socket engines (protocol_spec.RATE_LIMITS "
    "refute_broadcast: compare-then-stamp on the last-refute clock)",
    fixture="lint/spec_refute_rate_limit.py",
    fixture_at=_UDP,
)
def spec_refute_rate_limit(index) -> list[Finding]:
    findings: list[Finding] = []
    limit = spec.rate_limit("refute_broadcast")
    # -- udp engine: _on_suspect must early-return inside the period and
    # stamp the clock before bumping/broadcasting
    tree = index.tree(_UDP)
    fn = func(tree, "_on_suspect")
    if fn is None:
        findings.append(Finding(
            "spec-refute-rate-limit", _UDP, 1,
            "extractor went blind: UdpNode._on_suspect not found — the "
            "analyzer cannot see the refute path it rate-limits",
        ))
    else:
        guarded = any(
            isinstance(sub, ast.If)
            and "_last_refute_t" in _attrs_in(sub.test)
            and "period" in _attrs_in(sub.test)
            and any(isinstance(s, ast.Return) for s in sub.body)
            for sub in ast.walk(fn)
        )
        stamped = any(
            isinstance(sub, ast.Assign)
            and any(
                isinstance(t, ast.Attribute) and t.attr == "_last_refute_t"
                for t in sub.targets
            )
            for sub in ast.walk(fn)
        )
        if not (guarded and stamped):
            findings.append(Finding(
                "spec-refute-rate-limit", _UDP, fn.lineno,
                f"udp _on_suspect dropped the refute rate limit "
                f"({limit.window}): it must compare now against "
                "self._last_refute_t (early return inside the period) "
                "and stamp it before bumping — without it, k suspectors "
                "amplify one episode to O(k x N) REFUTE datagrams",
            ))
    # -- native engine: OnSuspect carries the same compare-then-stamp
    src = index.source(_ENGINE)
    if "last_refute_t_" not in src:
        findings.append(Finding(
            "spec-refute-rate-limit", _ENGINE, 1,
            "extractor went blind: last_refute_t_ not found in the "
            "native engine — the refute rate-limit clock is gone",
        ))
    else:
        compared = re.search(r"last_refute_t_\s*<", src)
        stamped = re.search(r"last_refute_t_\s*=\s*now", src)
        if not (compared and stamped):
            miss = compared or stamped
            findings.append(Finding(
                "spec-refute-rate-limit", _ENGINE,
                line_of(src, miss.start()) if miss else 1,
                f"native OnSuspect dropped the refute rate limit "
                f"({limit.window}): the last_refute_t_ clock must be "
                "compared against cfg.period AND stamped",
            ))
    return findings


# ---------------------------------------------------------------------------
# spec-transition-order
# ---------------------------------------------------------------------------

_STATE = "gossipfs_tpu_torch/core/state.py"
# the port's ticks: the lanes form and the SWAR form on packed words
TICKS = ("_tick", "_tick_swar")
# calls that build a SWAR word from a status code (w = swar.word)
_WORD_CALLS = {"w", "word", "splat"}
# wrappers a status write puts around its mask (bytes of a word mask)
_MASK_WRAPS = {"to_bytes", "bool_mask"}


def _state_codes(index) -> dict[str, int]:
    """MEMBER/SUSPECT/FAILED/UNKNOWN codes from the port's core/state.py."""
    tree = index.tree(_STATE)
    out = {}
    for name in ("UNKNOWN", "MEMBER", "SUSPECT", "FAILED"):
        v = module_literal(tree, name)
        if isinstance(v, int):
            out[name] = v
    return out


def _mask_name(node: ast.AST) -> str | None:
    """The mask a write selects by: a name, or a name inside the byte
    wrappers (``swar.to_bytes(fail)``)."""
    while isinstance(node, ast.Call) and len(node.args) == 1 \
            and (dotted(node.func) or "").rsplit(".", 1)[-1] in _MASK_WRAPS:
        node = node.args[0]
    return node.id if isinstance(node, ast.Name) else None


def _writes_state(node: ast.AST, state: str, codes: dict[str, int],
                  or_form: bool = False) -> bool:
    """Whether a written value is ``state``: its name, a call named after
    it (``failed_word(aslw)``) or a SWAR word of it (``w(SUSPECT)``).  In
    the OR form (``aslw | (mask & w(k))``, over MEMBER entries) a word of
    the constant ``k`` writes the state whose code is ``MEMBER | k``."""
    if isinstance(node, ast.Name):
        return node.id == state
    if isinstance(node, ast.Call):
        name = (dotted(node.func) or "").rsplit(".", 1)[-1]
        if state.lower() in name.lower():
            return True
        if name in _WORD_CALLS and len(node.args) == 1:
            a = node.args[0]
            if isinstance(a, ast.Name):
                return a.id == state
            if or_form and isinstance(a, ast.Constant) \
                    and isinstance(a.value, int) and "MEMBER" in codes:
                return codes["MEMBER"] | a.value == codes.get(state)
    return False


def status_writes(fn: ast.AST, state: str,
                  codes: dict[str, int]) -> list[tuple[int, str]]:
    """(line, mask name) of every write of ``state`` into a status
    carrier in ``fn``, in the forms the port writes them:

    * ``st = torch.where(M, STATE, st)`` (any ``*.where``) and the SWAR
      select ``aslw = swar.sel(to_bytes(M), <STATE word>, aslw)``;
    * ``st[M] = STATE`` and ``st.masked_fill_(M, STATE)``;
    * the SWAR OR ``aslw = aslw | (to_bytes(M) & w(<code>))``."""
    out = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            if isinstance(t, ast.Name) and isinstance(v, ast.Call) \
                    and (dotted(v.func) or "").rsplit(".", 1)[-1] in (
                        "where", "sel") and len(v.args) == 3 \
                    and isinstance(v.args[2], ast.Name) \
                    and v.args[2].id == t.id \
                    and _writes_state(v.args[1], state, codes):
                m = _mask_name(v.args[0])
                if m is not None:
                    out.append((node.lineno, m))
            elif isinstance(t, ast.Name) and isinstance(v, ast.BinOp) \
                    and isinstance(v.op, ast.BitOr) \
                    and isinstance(v.left, ast.Name) and v.left.id == t.id \
                    and isinstance(v.right, ast.BinOp) \
                    and isinstance(v.right.op, ast.BitAnd):
                a, b = v.right.left, v.right.right
                for mask, val in ((a, b), (b, a)):
                    m = _mask_name(mask)
                    if m is not None and _writes_state(val, state, codes,
                                                         or_form=True):
                        out.append((node.lineno, m))
            elif isinstance(t, ast.Subscript) \
                    and _writes_state(v, state, codes):
                m = _mask_name(t.slice)
                if m is not None:
                    out.append((node.lineno, m))
        if isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr == "masked_fill_" and len(node.args) == 2 \
                and _writes_state(node.args[1], state, codes):
            m = _mask_name(node.args[0])
            if m is not None:
                out.append((node.lineno, m))
    return sorted(out)


def _defs(fn: ast.AST) -> dict[str, list[tuple[int, ast.AST]]]:
    """name -> [(line, value)] of every plain assignment in ``fn``."""
    out: dict[str, list[tuple[int, ast.AST]]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            out.setdefault(node.targets[0].id, []).append(
                (node.lineno, node.value))
    for v in out.values():
        v.sort(key=lambda lv: lv[0])
    return out


def _latest_def(defs, name: str, before: int):
    got = [(ln, v) for ln, v in defs.get(name, ()) if ln < before]
    return got[-1] if got else None


def _tests_state(value: ast.AST, state: str) -> bool:
    """Whether an expression tests status against ``state`` itself: a
    comparison with its name, or a SWAR ``eq`` against its word."""
    for sub in ast.walk(value):
        if isinstance(sub, ast.Compare) and any(
                isinstance(o, ast.Name) and o.id == state
                for o in [sub.left, *sub.comparators]):
            return True
        if isinstance(sub, ast.Call) \
                and (dotted(sub.func) or "").rsplit(".", 1)[-1] == "eq" \
                and any(_writes_state(a, state, {}) for a in sub.args):
            return True
    return False


def _reads_state(value: ast.AST, defs, before: int, state: str) -> bool:
    """Whether a mask tests ``state`` status: directly, or through a local
    test mask defined before it (``sus_pre = swar.eq(st, w(SUSPECT))``)."""
    if _tests_state(value, state):
        return True
    for sub in ast.walk(value):
        if isinstance(sub, ast.Name):
            d = _latest_def(defs, sub.id, before)
            # a status carrier's own update (st = where(m, X, st)) is the
            # status, not a test of it
            if d is not None and sub.id not in names_in(d[1]) \
                    and _tests_state(d[1], state):
                return True
    return False


def transition_order(fn: ast.AST, codes: dict[str, int]):
    """(confirm, suspect, failed) lines of ``fn``'s suspicion transition,
    the confirm mask's definition, the SUSPECT write and the FAILED write
    (None where a part is not found): the FAILED write whose mask tests
    SUSPECT status is the confirm, the SUSPECT write the latest before
    it."""
    defs = _defs(fn)
    sus = status_writes(fn, "SUSPECT", codes)
    for f_line, mask in status_writes(fn, "FAILED", codes):
        d = _latest_def(defs, mask, f_line)
        if d is None or not _reads_state(d[1], defs, d[0], "SUSPECT"):
            continue
        before = [ln for ln, _ in sus if ln < f_line]
        return d[0], (before[-1] if before else None), f_line
    return None, None, None


@rule(
    "spec-transition-order",
    "the port's _tick and _tick_swar must compute the confirm mask from "
    "PRE-WRITE status, then write SUSPECT, then FAILED (an entry always "
    "spends >= 1 round SUSPECT before it can confirm), in whatever form "
    "they write it (torch.where, in-place masked writes, SWAR selects and "
    "ORs, per chunk), with the confirm window built from the contract's "
    "t_fail/t_suspect/lh_multiplier",
    fixture="lint_torch/spec_transition_order.py",
    fixture_at=_ROUNDS,
)
def spec_transition_order(index) -> list[Finding]:
    findings: list[Finding] = []
    tree = index.tree(_ROUNDS)
    codes = _state_codes(index)
    for name in TICKS:
        fn = func(tree, name)
        if fn is None:
            findings.append(Finding(
                "spec-transition-order", _ROUNDS, 1,
                f"extractor went blind: {name} not found -- the analyzer "
                "cannot see the tensor transition ordering it pins",
            ))
            continue
        confirm_line, suspect_line, failed_line = transition_order(fn, codes)
        formula_ok = any(
            isinstance(node, ast.Assign)
            and {"t_fail", "t_suspect", "lh_multiplier"}
            <= _attrs_in(node.value)
            for node in ast.walk(fn))
        if None in (confirm_line, suspect_line, failed_line):
            findings.append(Finding(
                "spec-transition-order", _ROUNDS, fn.lineno,
                f"extractor went blind: {name} no longer carries the "
                "recognizable confirm-mask / SUSPECT-write / FAILED-write "
                "statements the contract orders",
            ))
        elif not (confirm_line < suspect_line < failed_line):
            findings.append(Finding(
                "spec-transition-order", _ROUNDS, suspect_line,
                f"reordered transition guard: {name} must compute the "
                "confirm mask from PRE-WRITE status BEFORE writing SUSPECT "
                f"and FAILED (found confirm@{confirm_line}, SUSPECT-write@"
                f"{suspect_line}, FAILED-write@{failed_line}) -- writing "
                "SUSPECT first lets a same-round entry satisfy the confirm "
                "compare and skip its suspect window entirely",
            ))
        elif not formula_ok:
            findings.append(Finding(
                "spec-transition-order", _ROUNDS, confirm_line,
                f"{name}'s confirm window no longer references the "
                "contract formula names (t_fail + t_suspect stretched by "
                "lh_multiplier while degraded): "
                + spec.THRESHOLDS["confirm_window"],
            ))
    return findings


# ---------------------------------------------------------------------------
# spec-runtime-protocol
# ---------------------------------------------------------------------------

# The per-node lifecycle verb set SuspicionRuntime must expose: the
# socket engines mirror these semantics method-for-method.
_RUNTIME_VERBS = ("suspect", "adopt", "expired", "refute", "confirm",
                  "drop", "degraded", "t_suspect_window")


@rule(
    "spec-runtime-protocol",
    "suspicion/runtime.py must carry the full contract lifecycle verb "
    "set plus the degraded and Lifeguard-stretched-window formulas "
    "(protocol_spec.THRESHOLDS degraded / confirm_window)",
    fixture="lint/spec_runtime_drift.py",
    fixture_at=_RUNTIME,
)
def spec_runtime_protocol(index) -> list[Finding]:
    findings: list[Finding] = []
    tree = index.tree(_RUNTIME)
    cls = None
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == "SuspicionRuntime":
            cls = node
            break
    if cls is None:
        return [Finding(
            "spec-runtime-protocol", _RUNTIME, 1,
            "extractor went blind: SuspicionRuntime not found — the "
            "reference lifecycle semantics the socket engines mirror "
            "are gone",
        )]
    methods = {
        n.name: n for n in cls.body
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
    }
    for verb in _RUNTIME_VERBS:
        if verb not in methods:
            findings.append(Finding(
                "spec-runtime-protocol", _RUNTIME, cls.lineno,
                f"SuspicionRuntime lost lifecycle verb `{verb}` — every "
                "contract transition needs its runtime method (the "
                "socket engines mirror them method-for-method)",
            ))
    deg = methods.get("degraded")
    if deg is not None and "lh_frac" not in _attrs_in(deg):
        findings.append(Finding(
            "spec-runtime-protocol", _RUNTIME, deg.lineno,
            "degraded() no longer implements the contract formula "
            f"({spec.THRESHOLDS['degraded']})",
        ))
    win = methods.get("t_suspect_window")
    if win is not None:
        attrs = _attrs_in(win)
        if not {"t_suspect", "lh_multiplier", "degraded"} <= attrs:
            findings.append(Finding(
                "spec-runtime-protocol", _RUNTIME, win.lineno,
                "t_suspect_window() dropped the Lifeguard stretch: the "
                "contract window is "
                + spec.THRESHOLDS["confirm_window"],
            ))
    return findings


# ---------------------------------------------------------------------------
# spec-native-annotations
# ---------------------------------------------------------------------------

_ANN_RE = re.compile(r"//\s*@gfs:(\w+)[ \t]+([^\n]*)")
_OBS_RE = re.compile(r'ObsEmit\(\s*"([a-z_]+)"')
_TRANSITION_RE = re.compile(r"^(\w+)->(\w+)\s+guard=([\w-]+)\s*$")
_DISSEM_RE = re.compile(r"^(\w+)\s+profile=(\w+)\s+bound=([\w+]+)\s*$")

# How far above an ObsEmit a dominating annotation may sit (lines).
_DOMINATION_WINDOW = 30


def _parse_annotations(src: str):
    """[(line, tag, payload, emits-or-None, matches_spec)] for every
    ``// @gfs:`` annotation in the native source."""
    out = []
    for m in _ANN_RE.finditer(src):
        tag, payload = m.group(1), m.group(2).strip()
        line = line_of(src, m.start())
        emits, ok = None, False
        if tag == "transition":
            tm = _TRANSITION_RE.match(payload)
            if tm:
                row = spec.transition(tm.group(1), tm.group(2), tm.group(3))
                if row is not None and "native" in row.engines:
                    ok, emits = True, row.emits
        elif tag == "verb":
            ok = payload in spec.WIRE_VERBS
        elif tag == "rate_limit":
            row = spec.rate_limit(payload)
            ok = row is not None and "native" in row.engines
        elif tag == "dissemination":
            dm = _DISSEM_RE.match(payload)
            if dm:
                row = spec.dissemination_row(dm.group(1), dm.group(2))
                ok = row is not None and row.bound == dm.group(3) \
                    and "native" in row.engines
        elif tag == "inject":
            row = spec.injection(payload)
            if row is not None:
                ok, emits = True, row.emits
        out.append((line, tag, payload, emits, ok))
    return out


@rule(
    "spec-native-annotations",
    "engine.cc's // @gfs: annotations are the native protocol "
    "extraction, cross-checked both ways: every annotation must match "
    "a contract row, every lifecycle ObsEmit must be dominated by a "
    "matching annotated transition/injection, and every native "
    "contract row must be annotated",
    fixture="lint/spec_native_annotations.cc",
    fixture_at=_ENGINE,
)
def spec_native_annotations(index) -> list[Finding]:
    findings: list[Finding] = []
    src = index.source(_ENGINE)
    anns = _parse_annotations(src)
    sites = [(line_of(src, m.start()), m.group(1))
             for m in _OBS_RE.finditer(src)]
    if not anns and not sites:
        return [Finding(
            "spec-native-annotations", _ENGINE, 1,
            "extractor went blind: no @gfs: annotations and no ObsEmit "
            "sites found — the native protocol surface is invisible",
        )]
    # 1) forward: every annotation matches a contract row
    for line, tag, payload, _emits, ok in anns:
        if not ok:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, line,
                f"annotation `@gfs:{tag} {payload}` matches no "
                "protocol_spec row (native engines column included) — "
                "either the annotation drifted or the contract is "
                "missing a row",
            ))
    # 2) domination: every lifecycle ObsEmit kind is declared by a
    # matching annotation within the preceding window
    lifecycle = spec.lifecycle_emit_kinds()
    for line, kind in sites:
        if kind not in lifecycle:
            continue
        declared = {
            emits for aline, _t, _p, emits, ok in anns
            if ok and emits is not None
            and line - _DOMINATION_WINDOW <= aline < line
        }
        if kind not in declared:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, line,
                f'lifecycle ObsEmit("{kind}") is not dominated by a '
                "matching @gfs:transition/@gfs:inject annotation in the "
                f"preceding {_DOMINATION_WINDOW} lines — the native "
                "emission has no declared contract edge",
            ))
    # 3) reverse: every native contract row is annotated somewhere
    ok_anns = [(tag, payload) for _l, tag, payload, _e, ok in anns if ok]
    for t in spec.TRANSITIONS:
        if t.emits is None or "native" not in t.engines:
            continue
        want = f"{t.src}->{t.dst} guard={t.guard}"
        if ("transition", want) not in ok_anns:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, 1,
                f"contract transition `{want}` (emits {t.emits}) has no "
                "@gfs:transition annotation in the native engine",
            ))
    for verb in spec.WIRE_VERBS:
        if ("verb", verb) not in ok_anns:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, 1,
                f"wire verb `{verb}` has no @gfs:verb annotation at the "
                "native dispatch",
            ))
    for r in spec.RATE_LIMITS:
        if "native" in r.engines and ("rate_limit", r.name) not in ok_anns:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, 1,
                f"rate limit `{r.name}` has no @gfs:rate_limit "
                "annotation in the native engine",
            ))
    for d in spec.DISSEMINATION:
        if not (d.annotated and "native" in d.engines):
            continue
        want = f"{d.event} profile={d.profile} bound={d.bound}"
        if ("dissemination", want) not in ok_anns:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, 1,
                f"dissemination row `{want}` has no @gfs:dissemination "
                "annotation in the native engine",
            ))
    for i in spec.INJECTIONS:
        if ("inject", i.name) not in ok_anns:
            findings.append(Finding(
                "spec-native-annotations", _ENGINE, 1,
                f"injection `{i.name}` has no @gfs:inject annotation at "
                "the native injection seam",
            ))
    return findings


# ---------------------------------------------------------------------------
# spec-obs-kind-coverage
# ---------------------------------------------------------------------------

@rule(
    "spec-obs-kind-coverage",
    "obs/schema.py LIFECYCLE_KINDS and the contract's emit kinds must "
    "be the same set, and every emit kind an EVENT_KINDS entry — a new "
    "lifecycle state cannot ship without a contract row",
    fixture="lint/spec_obs_kinds.py",
    fixture_at=_SCHEMA,
)
def spec_obs_kind_coverage(index) -> list[Finding]:
    findings: list[Finding] = []
    tree = index.tree(_SCHEMA)
    kinds = module_literal(tree, "EVENT_KINDS")
    lifecycle = module_literal(tree, "LIFECYCLE_KINDS")
    if not isinstance(kinds, dict) or not isinstance(lifecycle, tuple):
        return [Finding(
            "spec-obs-kind-coverage", _SCHEMA, 1,
            "extractor went blind: EVENT_KINDS / LIFECYCLE_KINDS are no "
            "longer module-level literals the contract can diff against",
        )]
    line = assign_line(tree, "LIFECYCLE_KINDS")
    spec_kinds = spec.lifecycle_emit_kinds()
    for k in sorted(spec_kinds - set(lifecycle)):
        findings.append(Finding(
            "spec-obs-kind-coverage", _SCHEMA, line,
            f"the contract emits `{k}` but schema LIFECYCLE_KINDS lacks "
            "it — the lifecycle timeline would silently drop a contract "
            "event",
        ))
    for k in sorted(set(lifecycle) - spec_kinds):
        findings.append(Finding(
            "spec-obs-kind-coverage", _SCHEMA, line,
            f"schema lifecycle kind `{k}` has no contract "
            "transition/injection row — add the protocol_spec row "
            "before shipping the state",
        ))
    for k in sorted(spec_kinds - set(kinds)):
        findings.append(Finding(
            "spec-obs-kind-coverage", _SCHEMA, line,
            f"contract emit kind `{k}` is missing from EVENT_KINDS",
        ))
    return findings


# ---------------------------------------------------------------------------
# scan-carry-arity
# ---------------------------------------------------------------------------

# the port's seams whose tuple return is unpacked elsewhere: the lean
# loop's core and the separate-pass round
SEAMS = ("run_lean_packed", "_round_core")
_SEAM_FILES = (_ROUNDS, _MESH, _SIM)


def _tuple_arity(node: ast.AST, fn: ast.AST) -> int | None:
    """The arity of a tuple expression: a literal, a local name bound to a
    literal, or a sum of those (``stats + (z, z, z)``)."""
    if isinstance(node, ast.Tuple):
        if any(isinstance(e, ast.Starred) for e in node.elts):
            return None
        return len(node.elts)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        a, b = _tuple_arity(node.left, fn), _tuple_arity(node.right, fn)
        return None if a is None or b is None else a + b
    if isinstance(node, ast.Name):
        vals = [n.value for n in ast.walk(fn)
                if isinstance(n, ast.Assign) and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == node.id]
        arities = {_tuple_arity(v, fn) for v in vals}
        return arities.pop() if len(arities) == 1 else None
    return None


def return_arities(fn: ast.AST) -> set:
    """The arities of ``fn``'s own (not nested functions') returns."""
    out = set()
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return) and node.value is not None:
            out.add(_tuple_arity(node.value, fn))
        stack.extend(ast.iter_child_nodes(node))
    return out


def seam_unpacks(index, name: str) -> list[tuple[str, int, int, bool]]:
    """(path, line, targets, starred) of every tuple unpack of a call to
    ``name`` (bare or as ``R.name``/``rounds.name``) in the seam files."""
    out = []
    for path in _SEAM_FILES:
        for node in ast.walk(index.tree(path)):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            t, v = node.targets[0], node.value
            if isinstance(t, ast.Tuple) and isinstance(v, ast.Call) \
                    and (dotted(v.func) or "").rsplit(".", 1)[-1] == name:
                star = any(isinstance(e, ast.Starred) for e in t.elts)
                out.append((path, node.lineno, len(t.elts) - star, star))
    return out


def tuple_constructions(index, fields: dict[str, list[str] | None]):
    """(path, line, class, got) of every non-starred MetricsCarry /
    RoundMetrics construction and every tuple unpack of a parameter
    annotated as one, in the seam files."""
    out = []
    for path in _SEAM_FILES:
        tree = index.tree(path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Call):
                last = (dotted(node.func) or "").rsplit(".", 1)[-1]
                if last in fields and not any(
                        isinstance(a, ast.Starred) for a in node.args) \
                        and all(kw.arg is not None for kw in node.keywords):
                    out.append((path, node.lineno, last,
                                len(node.args) + len(node.keywords)))
        for fn in ast.walk(tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            typed = {a.arg: (dotted(a.annotation) or "").rsplit(".", 1)[-1]
                     for a in fn.args.args + fn.args.kwonlyargs
                     if a.annotation is not None}
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Tuple) \
                        and isinstance(node.value, ast.Name) \
                        and typed.get(node.value.id) in fields \
                        and not any(isinstance(e, ast.Starred)
                                    for e in node.targets[0].elts):
                    out.append((path, node.lineno, typed[node.value.id],
                                len(node.targets[0].elts)))
    return out


@rule(
    "scan-carry-arity",
    "the port's seams agree in arity: run_lean_packed's return against "
    "every unpack of it (PackedDetector's step included), _round_core's "
    "against its callers', _round_stats' scalars against RoundMetrics, "
    "and every MetricsCarry/RoundMetrics construction or unpack in "
    "core/rounds.py, parallel/mesh.py and detector/sim.py against the "
    "NamedTuple definitions",
    fixture="lint_torch/spec_scan_carry_arity.py",
    fixture_at=_SIM,
)
def scan_carry_arity(index) -> list[Finding]:
    findings: list[Finding] = []
    rtree = index.tree(_ROUNDS)
    fields = {"MetricsCarry": namedtuple_fields(rtree, "MetricsCarry"),
              "RoundMetrics": namedtuple_fields(rtree, "RoundMetrics")}
    if None in fields.values():
        findings.append(Finding(
            "scan-carry-arity", _ROUNDS, 1,
            "extractor went blind: MetricsCarry / RoundMetrics "
            "NamedTuple definitions not found",
        ))
    # -- the seams' returns against their unpacks
    for name in SEAMS:
        fn = func(rtree, name)
        arities = return_arities(fn) if fn is not None else set()
        if fn is None or len(arities) != 1 or None in arities:
            findings.append(Finding(
                "scan-carry-arity", _ROUNDS, fn.lineno if fn else 1,
                f"extractor went blind: {name}'s return tuple is not "
                f"recognizable (arities {sorted(map(str, arities))})",
            ))
            continue
        want = arities.pop()
        unpacks = seam_unpacks(index, name)
        if name == "run_lean_packed" and not any(
                p == _SIM for p, *_ in unpacks):
            findings.append(Finding(
                "scan-carry-arity", _SIM, 1,
                "extractor went blind: PackedDetector's unpack of the "
                "lean loop's step (run_lean_packed) not found",
            ))
        for path, line, got, star in unpacks:
            if (got > want) if star else (got != want):
                findings.append(Finding(
                    "scan-carry-arity", path, line,
                    f"unpacks {got}{'+' if star else ''} values from "
                    f"{name} where it returns {want} -- a silently "
                    "shifted slot corrupts every downstream counter",
                ))
    # -- the per-round stats feed RoundMetrics
    rm = fields["RoundMetrics"]
    stats = func(rtree, "_round_stats")
    ar = return_arities(stats) if stats is not None else set()
    if rm is not None and (stats is None or ar != {len(rm)}):
        findings.append(Finding(
            "scan-carry-arity", _ROUNDS, stats.lineno if stats else 1,
            f"_round_stats returns {sorted(map(str, ar))} scalars where "
            f"RoundMetrics has {len(rm)} fields ({', '.join(rm)})",
        ))
    # -- constructions and unpacks of the NamedTuples
    for path, line, cls, got in tuple_constructions(index, fields):
        want = fields[cls]
        if want is not None and got != len(want):
            findings.append(Finding(
                "scan-carry-arity", path, line,
                f"{cls}(...) built or unpacked with {got} fields where "
                f"core.rounds defines {len(want)} ({', '.join(want)}) -- "
                "threaded metrics would bind to the wrong slots",
            ))
    return findings
