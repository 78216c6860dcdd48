"""gossipfs-lint over the port (gossipfs_tpu_torch/analysis/ and
``python -m gossipfs_tpu_torch.analysis``): the twin of test_analysis.py.

The port's analyzer is tested, not trusted:

* it registers a counterpart of each of the JAX package's rules (three
  under a new name: the shared-memory budget ownership rule and probe,
  device hygiene);
* every rule has a committed fixture that makes it FIRE, under its own
  name only, anchored to the mounted path (tests/fixtures/lint/ for the
  JAX package's fixtures the port mounts as they are,
  tests/fixtures/lint_torch/ for the port's own);
* the port's tree is CLEAN under every AST rule, and every rule's
  extractor sees at least one real site of the tree, so a rule that went
  blind cannot pass vacuously;
* the CLI exits 0 on clean, 1 on findings, 2 on usage errors, and its
  --list, --json and --overlay work;
* the budget probe's header half passes on the CPU (g++ over the csrc
  headers) and fires when a formula drops a term.
"""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from gossipfs_tpu_torch.analysis import (
    REGISTRY, RepoIndex, probes, rules_config, rules_device,
    rules_native, rules_obs, rules_ownership as own, rules_spec, run_rules)
from gossipfs_tpu_torch.analysis.__main__ import main as lint_main
from gossipfs_tpu_torch.analysis.framework import (
    const_str, dotted, functions, module_literal, namedtuple_fields, names_in)

REPO = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
PKG = "gossipfs_tpu_torch"

_AST_RULES = sorted(n for n, r in REGISTRY.items() if r.kind == "ast")
# the JAX package's rule names, and the port's names for the three that
# were rewritten for the port's idiom
JAX_RULES = (
    "asyncio-hygiene", "backoff-ownership", "config-gate-docs",
    "conformance-verb-coverage", "jit-hygiene", "na-render-ownership",
    "native-obs-kinds", "obs-logsite-coverage", "obs-scan-coverage",
    "obsparse-ownership", "quantile-ownership", "quorum-ownership",
    "rr-scratch-budget", "scan-carry-arity", "spec-delta-dissemination",
    "spec-dissemination", "spec-native-annotations", "spec-obs-kind-coverage",
    "spec-refute-rate-limit", "spec-runtime-protocol", "spec-transition-order",
    "stripe-quorum-ownership", "vmem-scratch-ownership")
RENAMED = {"vmem-scratch-ownership": "smem-budget-ownership",
           "jit-hygiene": "device-hygiene",
           "rr-scratch-budget": "smem-budget-probe"}


def _mount(name: str, **kw) -> RepoIndex:
    r = REGISTRY[name]
    return RepoIndex(overlay={r.fixture_at: FIXTURES / r.fixture}, **kw)


# ---------------------------------------------------------------------------
# the registry: a counterpart for every JAX rule, each with its fixture
# ---------------------------------------------------------------------------


def test_registry_has_a_counterpart_of_every_jax_rule():
    assert set(REGISTRY) == {RENAMED.get(n, n) for n in JAX_RULES}
    assert [n for n, r in REGISTRY.items() if r.kind == "probe"] == [
        "smem-budget-probe"]


@pytest.mark.parametrize("name", sorted(REGISTRY))
def test_every_rule_has_a_committed_fixture(name):
    r = REGISTRY[name]
    assert r.fixture and (FIXTURES / r.fixture).is_file(), (name, r.fixture)
    top = r.fixture.split("/")[0]
    assert top in ("lint", "lint_torch")
    # the rewritten rules carry the port's own fixtures; the others mount
    # the JAX package's as they are
    rewritten = {"smem-budget-ownership", "device-hygiene",
                 "smem-budget-probe", "spec-transition-order",
                 "scan-carry-arity", "config-gate-docs"}
    assert (top == "lint_torch") == (name in rewritten), name
    if r.kind == "ast":
        assert r.fixture_at, f"ast rule {name} has no mount point"


# ---------------------------------------------------------------------------
# each rule fires on its fixture, and only under its own name
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", _AST_RULES)
def test_rule_fires_on_fixture(name):
    r = REGISTRY[name]
    findings = r.check(_mount(name))
    assert findings, f"rule {name} did not fire on its fixture"
    assert all(f.rule == name for f in findings)
    assert any(f.path == r.fixture_at for f in findings), findings


def test_smem_rule_fires_on_budget_constants_outside_ops():
    virt = f"{PKG}/core/_lint_fixture.py"
    idx = RepoIndex(overlay={
        virt: FIXTURES / "lint_torch" / "smem_budget_constants.py"})
    got = {(f.path, f.line) for f in own.check_smem_budget(idx)}
    assert got == {(virt, 6), (virt, 7)}


def test_smem_rule_flags_each_unowned_launch_site():
    r = REGISTRY["smem-budget-ownership"]
    lines = sorted(f.line for f in r.check(_mount("smem-budget-ownership"))
                   if f.path == r.fixture_at)
    # the local sum behind dynamicSmemBytes, the literal opt-in size, the
    # literal <<<..., smem, ...>>>
    assert lines == [14, 16, 18]


def test_device_hygiene_fixture_finds_each_class():
    msgs = [f.message for f in REGISTRY["device-hygiene"].check(
        _mount("device-hygiene"))]
    assert sum("host randomness" in m for m in msgs) == 2
    assert sum("per-round host sync" in m for m in msgs) == 2
    assert sum("Python branch" in m for m in msgs) == 1


def test_transition_order_reads_in_place_writes():
    """The fixture's lanes tick writes status in place (st[m] = SUSPECT);
    its SWAR tick keeps the order: only the lanes tick is flagged."""
    fs = REGISTRY["spec-transition-order"].check(
        _mount("spec-transition-order"))
    assert len(fs) == 1 and "_tick must" in fs[0].message, fs


def test_jax_scan_carry_fixture_fires_on_the_port_mesh():
    """The JAX package's fixture (a MetricsCarry out-spec of 3 fields)
    mounted over the port's parallel/mesh.py fires the port's rule too."""
    idx = RepoIndex(overlay={
        f"{PKG}/parallel/mesh.py":
            FIXTURES / "lint" / "spec_scan_carry_arity.py"})
    fs = REGISTRY["scan-carry-arity"].check(idx)
    assert [(f.path, f.line) for f in fs] == [(f"{PKG}/parallel/mesh.py", 17)]


# ---------------------------------------------------------------------------
# the port's tree runs clean -- the enforcement
# ---------------------------------------------------------------------------


def test_port_clean_under_all_ast_rules():
    findings = run_rules(RepoIndex())
    assert not findings, "\n".join(str(f) for f in findings)


def test_scan_set_is_the_port():
    files = RepoIndex().py_files()
    assert "chip_smoke.py" in files
    assert f"{PKG}/core/rounds.py" in files
    assert not any(f.startswith(("gossipfs_tpu/", "tools/", "tests/",
                                 f"{PKG}/analysis/", f"{PKG}/_build/"))
                   for f in files)


# ---------------------------------------------------------------------------
# no extractor passes vacuously: each sees a real site of the tree
# ---------------------------------------------------------------------------


def _owner_sites(path: str, pred) -> int:
    return sum(1 for node in ast.walk(RepoIndex().tree(path)) if pred(node))


def _imports_of(names: set[str]) -> int:
    idx = RepoIndex()
    return sum(1 for rel in idx.py_files()
               for node in ast.walk(idx.tree(rel))
               if isinstance(node, ast.ImportFrom)
               and {a.name for a in node.names} & names)


def _obsparse_owner_sites() -> int:
    idx = RepoIndex()
    n = 0
    for rel in idx.py_files(f"{PKG}/obs"):
        for fn in functions(idx.tree(rel)):
            calls = {dotted(c.func) for c in ast.walk(fn)
                     if isinstance(c, ast.Call)}
            kinds = any(const_str(c) == "kind" for c in ast.walk(fn))
            n += "json.loads" in calls and kinds
    return n


def _backoff_owner_sites() -> int:
    tree = RepoIndex().tree(f"{PKG}/shim/retry.py")
    return sum(1 for loop in ast.walk(tree)
               if isinstance(loop, (ast.For, ast.While))
               for c in ast.walk(loop)
               if isinstance(c, ast.Call) and dotted(c.func) in own._SLEEPS
               and any(own._grows_geometrically(loop, nm)
                       for nm in names_in(c)))


def _spec_sites(name: str) -> int:
    idx = RepoIndex()
    udp = idx.tree(rules_spec._UDP)
    if name == "spec-dissemination":
        tick = rules_spec.func(udp, "tick")
        return sum(1 for node in ast.walk(tick) if isinstance(node, ast.If)
                   for c in ast.walk(node.test) if isinstance(c, ast.Call)
                   and (dotted(c.func) or "").endswith(".suspect"))
    if name == "spec-delta-dissemination":
        return int(rules_spec.func(udp, "_encode_delta") is not None)
    if name == "spec-refute-rate-limit":
        return int(rules_spec.func(udp, "_on_suspect") is not None)
    if name == "spec-transition-order":
        tree = idx.tree(rules_spec._ROUNDS)
        codes = rules_spec._state_codes(idx)
        return sum(None not in rules_spec.transition_order(
            rules_spec.func(tree, t), codes) for t in rules_spec.TICKS)
    if name == "spec-runtime-protocol":
        return int(any(isinstance(n, ast.ClassDef)
                       and n.name == "SuspicionRuntime"
                       for n in ast.walk(idx.tree(rules_spec._RUNTIME))))
    if name == "spec-native-annotations":
        return len(rules_spec._parse_annotations(
            idx.source(rules_spec._ENGINE)))
    if name == "spec-obs-kind-coverage":
        return len(rules_spec.module_literal(idx.tree(rules_spec._SCHEMA),
                                             "LIFECYCLE_KINDS") or ())
    raise KeyError(name)


def _scan_carry_sites() -> int:
    idx = RepoIndex()
    unpacks = [u for s in rules_spec.SEAMS
               for u in rules_spec.seam_unpacks(idx, s)]
    fields = {"MetricsCarry": 1, "RoundMetrics": 1}
    assert any(p == rules_spec._SIM for p, *_ in unpacks)
    return min(len(rules_spec.seam_unpacks(idx, s))
               for s in rules_spec.SEAMS) * len(
        rules_spec.tuple_constructions(idx, fields))


def _config_sites() -> int:
    sites = rules_config.gate_sites(RepoIndex()).values()
    files = {p for p, _ in sites}
    rows = rules_config.documented_rows(
        (REPO / "README.md").read_text(), rules_config.PORT_MARKER) or []
    return len(files) == 2 and len(rows)


def _device_sites() -> int:
    idx = RepoIndex()
    tree = idx.tree(rules_device._ROUNDS)
    scope = {n for n, _, _ in rules_device.round_scope(tree)}
    assert {"run_lean_packed", "_run_general", "_round_core",
            "_tick"} <= scope
    clocks = [c for c, k, _ in rules_device.host_calls(tree) if k == "clock"]
    return len(clocks) * len(rules_device.round_sites(tree))


SITES = {
    "quorum-ownership": lambda: _owner_sites(
        f"{PKG}/sdfs/quorum.py", own._is_quorum_expr),
    "stripe-quorum-ownership": lambda: _imports_of(
        {"stripe_read_quorum", "stripe_write_quorum"}),
    "backoff-ownership": _backoff_owner_sites,
    "obsparse-ownership": _obsparse_owner_sites,
    "quantile-ownership": lambda: _owner_sites(
        f"{PKG}/traffic/workload.py",
        lambda n: isinstance(n, ast.Dict) and {
            const_str(k) for k in n.keys if k is not None}
        & own._QUANTILE_KEYS),
    "na-render-ownership": lambda: _owner_sites(
        f"{PKG}/obs/schema.py", lambda n: const_str(n) == "n/a"),
    "smem-budget-ownership": lambda: len(
        [s for s in own.smem_sites(RepoIndex()) if s[2].strip() != "0"]),
    "obs-scan-coverage": lambda: len(namedtuple_fields(
        RepoIndex().tree(f"{PKG}/core/rounds.py"), "RoundMetrics") or ()),
    "obs-logsite-coverage": lambda: min(
        len(rules_obs._node_log_sites(RepoIndex().tree(rules_obs._NODE))),
        len(rules_obs._cosim_kind_sites(RepoIndex().tree(rules_obs._COSIM)))),
    "native-obs-kinds": lambda: min(
        len(rules_native._OBS_RE.findall(RepoIndex().source(
            rules_native._ENGINE))),
        len(rules_native._VITAL_RE.findall(RepoIndex().source(
            rules_native._ENGINE)))),
    "asyncio-hygiene": lambda: sum(
        1 for rel in RepoIndex().py_files()
        for n in ast.walk(RepoIndex().tree(rel))
        if isinstance(n, ast.AsyncFunctionDef)),
    "conformance-verb-coverage": lambda: len(module_literal(
        RepoIndex().tree(f"{PKG}/conformance/schedules.py"), "FAMILIES")
        or {}),
    "config-gate-docs": _config_sites,
    "device-hygiene": _device_sites,
    "scan-carry-arity": _scan_carry_sites,
    **{n: (lambda n=n: _spec_sites(n)) for n in (
        "spec-dissemination", "spec-delta-dissemination",
        "spec-refute-rate-limit", "spec-transition-order",
        "spec-runtime-protocol", "spec-native-annotations",
        "spec-obs-kind-coverage")},
}


def test_every_ast_rule_has_a_site_check():
    assert set(SITES) == set(_AST_RULES)


@pytest.mark.parametrize("name", _AST_RULES)
def test_extractor_sees_a_real_site(name):
    assert SITES[name]() >= 1, f"{name}'s extractor saw no real site"


def test_device_allowlist_entries_all_match_a_site():
    """A stale allowlist entry (its site gone) fails: each names a live
    sync or branch of the round."""
    tree = RepoIndex().tree(rules_device._ROUNDS)
    live = {(n, what) for n, _, _, what in rules_device.round_sites(tree)}
    assert set(rules_device.ALLOWLIST) <= live
    assert all(reason for reason in rules_device.ALLOWLIST.values())
    assert set(rules_device.CLOCK_OWNERS) == {"ShardCtx.psum"}


# ---------------------------------------------------------------------------
# CLI contract
# ---------------------------------------------------------------------------


def _cli(capsys, *args):
    rc = lint_main(list(args))
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_cli_as_a_process_exits_zero_on_the_port():
    out = subprocess.run(
        [sys.executable, "-m", "gossipfs_tpu_torch.analysis"],
        capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    # the AST rules import neither torch nor the package's modules
    probe = ("import sys; import gossipfs_tpu_torch.analysis.__main__; "
             "print(sorted(m for m in sys.modules if m == 'torch' or "
             "m.startswith('gossipfs_tpu_torch.') and '.analysis' not in m))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, cwd=REPO, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_cli_lists_every_rule(capsys):
    rc, out, _ = _cli(capsys, "--list")
    assert rc == 0
    for name, r in REGISTRY.items():
        assert f"{name} [{r.kind}]" in out


def test_cli_exits_one_on_findings_and_emits_json(capsys):
    overlay = (f"{PKG}/traffic/_lint_fixture.py="
               f"{FIXTURES / 'lint' / 'quorum_ownership.py'}")
    rc, out, _ = _cli(capsys, "--overlay", overlay, "--json")
    assert rc == 1
    findings = json.loads(out)
    assert {f["rule"] for f in findings} == {"quorum-ownership"}
    assert all(f["path"] == f"{PKG}/traffic/_lint_fixture.py"
               for f in findings)
    assert _cli(capsys, "--overlay", overlay, "--rule",
                "quorum-ownership")[0] == 1
    rc, out, _ = _cli(capsys, "--overlay", overlay, "--rule",
                      "backoff-ownership", "--json")
    assert rc == 0 and json.loads(out) == []


def test_cli_usage_errors_exit_two(capsys):
    assert _cli(capsys, "--rule", "no-such-rule")[0] == 2
    assert _cli(capsys, "--overlay", "missing-equals")[0] == 2
    assert _cli(capsys, "--overlay", f"{PKG}/traffic/_x.py=/nonexistent.py",
                "--rule", "quorum-ownership")[0] == 2
    with pytest.raises(SystemExit) as e:
        lint_main(["--device", "tpu"])
    assert e.value.code == 2


def test_cli_probe_without_a_card_exits_two(capsys, monkeypatch):
    """``--probe`` runs on the card unless the caller asks for the CPU:
    without one it is an internal error (2), never a silent CPU run."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, _, err = _cli(capsys, "--probe", "--rule", "smem-budget-probe")
    assert rc == 2 and "no CUDA device" in err


# ---------------------------------------------------------------------------
# the shared-memory budget probe
# ---------------------------------------------------------------------------


def test_probe_header_half_passes_on_the_cpu(capsys):
    assert probes.reconcile("cpu") == ([], None)
    rc, _, _ = _cli(capsys, "--probe", "--device", "cpu", "--rule",
                    "smem-budget-probe")
    assert rc == 0


def test_probe_fires_on_its_fixture():
    r = REGISTRY["smem-budget-probe"]
    findings = probes.fixture_findings(FIXTURES / r.fixture)
    assert findings and all(f.rule == "smem-budget-probe" for f in findings)
    assert any("K5" in f.message for f in findings)


@pytest.mark.parametrize("term", probes.DROP_TERMS)
def test_probe_catches_each_dropped_term(term):
    findings, _ = probes.reconcile("cpu", drop=term)
    assert findings and all(f.rule == "smem-budget-probe" for f in findings)


def test_probe_envelope_edges():
    from gossipfs_tpu_torch.ops import merge, merge_update as mu

    lib = probes._harness()
    assert mu.stripe_row_bytes(mu.STRIPE_MAX_N) == lib.ms_row_bytes(
        mu.STRIPE_MAX_N) == 64
    assert lib.ms_limit() == merge.ONEPASS_SMEM
    assert lib.gr_max_staged_fanout() == mu.MAX_KERNEL_FANOUT
    # K4's tile holds F up to 1,305, van Herk past it
    assert mu.arc_tile_fits(1_305) and not mu.arc_tile_fits(1_306)


@pytest.mark.cuda
def test_probe_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    findings, rep = probes.reconcile("cuda")
    assert not findings, findings
    assert all(r["launched"] >= 1 for r in rep.values() if "launched" in r)
