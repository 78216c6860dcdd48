"""The port's conformance schedules, oracle and shrink against the JAX
package's (``gossipfs_tpu_torch/conformance/``, ``analysis/protocol_spec``,
``suspicion/runtime``).

* the copied contract equals the JAX package's row for row;
* ``generate``/``serialize`` give the same bytes for every family at seeds
  0-2, ``validate`` refuses the same drifted docs with the same message,
  and ``coverage()`` is equal;
* the reference oracle gives equal bundles for every family at seeds 0
  and 1, and equal self-check rows;
* ``shrink`` reaches the JAX package's minimal case on its own test's
  predicates;
* the socket columns (udp, native) raise, naming ROADMAP Queue 1 item 9.

Plain Python throughout: no tensor runs here (the tensor column is in
``test_torch_conformance_tensor.py``).
"""

from __future__ import annotations

import copy
import json

import pytest

from gossipfs_tpu.analysis import protocol_spec as jax_spec
from gossipfs_tpu.conformance import harness as jax_harness
from gossipfs_tpu.conformance import schedules as jax_schedules
from gossipfs_tpu.conformance import shrink as jax_shrink
from gossipfs_tpu.conformance import verdict as jax_verdict
from gossipfs_tpu.detector import udp as jax_udp
from gossipfs_tpu.suspicion.params import SuspicionParams as JaxSus
from gossipfs_tpu.suspicion.runtime import SuspicionRuntime as JaxRuntime
from gossipfs_tpu_torch import conformance
from gossipfs_tpu_torch.analysis import protocol_spec
from gossipfs_tpu_torch.conformance import harness, schedules, shrink, verdict
from gossipfs_tpu_torch.suspicion.params import SuspicionParams
from gossipfs_tpu_torch.suspicion.runtime import SuspicionRuntime

FAMILIES = list(jax_schedules.FAMILIES)


def test_contract_equals_the_jax_package():
    for name in ("ENGINES", "STATES", "WIRE_VERBS", "TRANSITIONS",
                 "INJECTIONS", "RATE_LIMITS", "DISSEMINATION",
                 "DELTA_GOSSIP", "THRESHOLDS"):
        got, want = getattr(protocol_spec, name), getattr(jax_spec, name)
        assert repr(got) == repr(want), name
    assert protocol_spec.lifecycle_emit_kinds() == \
        jax_spec.lifecycle_emit_kinds()
    for t in jax_spec.TRANSITIONS:
        assert repr(protocol_spec.transition(t.src, t.dst, t.guard)) == \
            repr(t)
    assert protocol_spec.transition("MEMBER", "FAILED", "nope") is None
    for i in jax_spec.INJECTIONS:
        assert repr(protocol_spec.injection(i.name)) == repr(i)
    for r in jax_spec.RATE_LIMITS:
        assert repr(protocol_spec.rate_limit(r.name)) == repr(r)


def test_wire_separators_equal_the_udp_engine():
    for name in ("CMD_SEP", "DELTA_MARK", "ENTRY_SEP", "FIELD_SEP"):
        assert getattr(harness, name) == getattr(jax_udp, name), name


@pytest.mark.parametrize("lh", [0, 2])
def test_suspicion_runtime_matches_jax(lh):
    """The same verb sequence through both runtimes: equal returns,
    windows and status documents."""
    kw = dict(t_suspect=3, lh_multiplier=lh, lh_frac=0.25)
    a, b = SuspicionRuntime(SuspicionParams(**kw)), JaxRuntime(JaxSus(**kw))
    script = [("suspect", "x", 1.0), ("suspect", "y", 1.0),
              ("adopt", "z", 2.0), ("suspect", "x", 2.0),
              ("degraded", 4), ("t_suspect_window", 1.0, 4),
              ("expired", "x", 5.5, 3.0), ("refute", "y"), ("refute", "q"),
              ("confirm", "x"), ("drop", "z"), ("degraded", 40),
              ("t_suspect_window", 0.5, 40)]
    for verb, *args in script:
        assert getattr(a, verb)(*args) == getattr(b, verb)(*args), verb
        assert a.status() == b.status()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("family", FAMILIES)
def test_generate_serializes_byte_equal(family, seed):
    got = schedules.serialize(schedules.generate(family, seed))
    assert got == jax_schedules.serialize(jax_schedules.generate(family,
                                                                 seed))
    assert schedules.serialize(schedules.parse(got)) == got


def test_corpus_families_and_coverage_equal():
    assert schedules.FAMILIES == jax_schedules.FAMILIES
    assert schedules.TRACKED_KINDS == jax_schedules.TRACKED_KINDS
    assert schedules.coverage() == jax_schedules.coverage()
    assert schedules.coverage()["complete"]
    assert conformance.coverage() == schedules.coverage()
    assert ([schedules.serialize(c) for c in
             conformance.generate_corpus((0, 1))]
            == [jax_schedules.serialize(c) for c in
                jax_schedules.generate_corpus((0, 1))])


def _drifted() -> list[dict]:
    """Docs each validator must refuse, one defect apiece."""
    case = jax_schedules.generate("rejoin_cooldown", seed=0)
    s = str(case["tracked"][0])
    edits = [
        lambda d: d.update(schema="gossipfs-conformance/v2"),
        lambda d: d.update(family="nope"),
        lambda d: d["probes"].append("MEMBER->FAILED:nope"),
        lambda d: d["verbs"].append("FROB"),
        lambda d: d["injections"].append("meteor"),
        lambda d: d["steps"].append({"round": 1, "op": "frobnicate",
                                     "node": 1}),
        lambda d: d["steps"].append({"round": 99, "op": "crash",
                                     "node": 1}),
        lambda d: d["steps"].append({"round": 1, "op": "verb",
                                     "verb": "FROB", "to": [0]}),
        lambda d: d["expect"].pop(s),
        lambda d: d["expect"][s].update(final="zombie"),
        lambda d: d["expect"][s]["forbid"].append("teleport"),
        lambda d: d["checkpoints"].append({"round": 99, "status": {}}),
        lambda d: d["checkpoints"][0]["status"].update({s: "zombie"}),
    ]
    out = []
    for edit in edits:
        doc = copy.deepcopy(case)
        edit(doc)
        out.append(doc)
    return out


@pytest.mark.parametrize("i", range(len(_drifted())))
def test_validate_refuses_as_the_jax_package(i):
    doc = _drifted()[i]
    with pytest.raises(ValueError) as want:
        jax_schedules.validate(copy.deepcopy(doc))
    with pytest.raises(ValueError) as got:
        schedules.validate(copy.deepcopy(doc))
    assert str(got.value) == str(want.value)


def test_generate_refuses_an_unknown_family():
    with pytest.raises(ValueError) as want:
        jax_schedules.generate("nope")
    with pytest.raises(ValueError) as got:
        schedules.generate("nope")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_oracle_bundle_matches_jax(family, seed):
    case = jax_schedules.generate(family, seed)
    want = jax_harness.run_case_reference(case)
    got = harness.run_case_reference(case)
    assert got == want
    assert verdict.oracle_selfcheck(case, got) == \
        jax_verdict.oracle_selfcheck(case, want)
    assert verdict.oracle_selfcheck(case, got)["ok"]


def test_compare_matches_jax_on_a_doctored_bundle():
    """A bundle that breaks every check gives the JAX package's row."""
    case = jax_schedules.generate("confirm_expiry", seed=0)
    ref = harness.run_case_reference(case)
    s = case["tracked"][0]
    bad = {"engine": "tensor", "final": {s: "member"},
           "checkpoints": {}, "incarnations": {s: 1},
           "events": [{"round": 3, "observer": 1, "subject": s,
                       "kind": "confirm"},
                      {"round": 4, "observer": 1, "subject": s,
                       "kind": "refute"}],
           "counters": {}}
    got = verdict.compare(case, ref, bad)
    assert got == jax_verdict.compare(case, ref, bad)
    assert not got["ok"]
    assert json.dumps(verdict.compare(case, ref, ref)) == \
        json.dumps(jax_verdict.compare(case, ref, ref))


def _crash_only(cand):
    return any(s["op"] == "crash" for s in cand["steps"])


def _seed_and_crash(cand):
    return cand.get("seed", 0) >= 1 and _crash_only(cand)


@pytest.mark.parametrize("family,seed,pred,kw", [
    ("malformed_codec", 0, _crash_only, dict(settle_pad=2)),
    ("malformed_codec", 3, _seed_and_crash, dict(settle_pad=2)),
    ("malformed_codec", 3, _crash_only, dict(settle_pad=2, seed_radius=0)),
    ("rejoin_cooldown", 1, _crash_only, {}),
])
def test_shrink_reaches_the_jax_minimal_case(family, seed, pred, kw):
    case = jax_schedules.generate(family, seed)
    want = jax_shrink.shrink(case, pred, **kw)
    got = shrink.shrink(case, pred, **kw)
    assert schedules.serialize(got) == jax_schedules.serialize(want)
    assert [s["op"] for s in got["steps"]] == ["crash"]


def test_shrink_save_and_refusal(tmp_path):
    case = schedules.generate("malformed_codec", seed=0)
    small = shrink.shrink(case, _crash_only, settle_pad=2)
    shrink.save(small, tmp_path / "port.json")
    jax_shrink.save(small, tmp_path / "jax.json")
    assert (tmp_path / "port.json").read_bytes() == \
        (tmp_path / "jax.json").read_bytes()
    with pytest.raises(ValueError, match="failing case"):
        shrink.shrink(case, lambda cand: False)


@pytest.mark.parametrize("engine", ["udp", "native"])
def test_socket_columns_raise_naming_queue_1_item_9(engine):
    case = schedules.generate("leave_broadcast", seed=0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        harness.RUNNERS[engine](case)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        verdict.run_case(case, engines=(engine,), device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        verdict.run_matrix([case], engines=("reference", engine),
                           device="cpu")


def test_tensor_column_refuses_wire_families():
    case = schedules.generate("suspect_flood", seed=0)
    with pytest.raises(ValueError) as want:
        jax_harness.run_case_tensor(case)
    with pytest.raises(ValueError) as got:
        harness.run_case_tensor(case, device="cpu")
    assert str(got.value) == str(want.value)


def test_oracle_only_matrix_equals_jax():
    """A corpus of wire-plane families (no tensor column) gives the JAX
    package's whole matrix document, with engines left to default."""
    corpus = [jax_schedules.generate(f, 0) for f in
              ("suspect_flood", "remove_poison", "malformed_codec")]
    want = jax_verdict.run_matrix(corpus, engines=("reference",))
    assert verdict.run_matrix(corpus, device="cpu") == want
    assert verdict.run_matrix(corpus, engines=("reference",),
                              device="cpu") == want
