"""The port's verify_claims: a twin for every claim, the same predicates.

``python -m gossipfs_tpu_torch.verify_claims`` re-runs the JAX package's
headline claims (``tools/verify_claims.py``, loaded by path: it imports
no JAX at module level) through the port's surfaces.  Here: every claim
name has a twin and no twin command runs the JAX package or its tools;
every twin extractor equals the JAX tool's on the same documents (the
committed artifacts where they carry the keys, built ones elsewhere); no
claimed value is a TPU figure; one cheap claim end to end on the CPU.
"""

from __future__ import annotations

import contextlib
import copy
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from gossipfs_tpu_torch import verify_claims as vc

ROOT = Path(__file__).resolve().parent.parent
TWINS = vc.claims("cpu")


def jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_verify_claims", ROOT / "tools" / "verify_claims.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = jax_tool().CLAIMS


def artifact(name: str) -> dict:
    return json.loads((ROOT / name).read_text())


def ladder(rows):
    """A ladder document with both packages' keys a row."""
    return {"ladder": [
        {"n_global": n, "merge_block_c": c, "admissible": ok,
         "shard_bytes": b, "row_budget_bytes": b, "budget_limit_bytes": 10}
        for n, c, ok, b in rows]}


def traffic(**over):
    du = {"match": True, "harness": {"lost": 0, "files_acked": 3},
          "events": {"lost": 0}, "monitor": {"ok": True,
                                             "match_events": True}}
    du.update(over)
    return {"partition_race": {"durability": du,
                               "rejected_during_split": 2}}


def erasure(**over):
    doc = copy.deepcopy(artifact("ERASURE_r18.json"))
    doc["erasure_matrix"].update(over)
    return doc


# documents a claim's extractors are held on: both packages' keys
DOCS = {
    "headline": [{"value": 490.0}, {"value": 12.5}],
    "frontier_65536": [{"rounds_per_sec": 30.0, "detected": 8},
                       {"rounds_per_sec": 30.0, "detected": 7}],
    "ceiling_86016": [{"rounds_per_sec": 20.0, "detected": 8},
                      {"rounds_per_sec": 20.0, "detected": 0}],
    "soak": [{"all_equal": True}, {"all_equal": False}],
    "anchor_98304": [{"implied_rounds_per_sec": 41.5,
                      "implied_rounds_per_sec_v5e8": 41.5}],
    "partition_reconv": [artifact("PARTITION_r07.json"),
                         {"rows": [{"cross_hb_advances": 1,
                                    "reconverge_rounds": 3,
                                    "reconverge_bound": 9}]},
                         {"rows": [{"cross_hb_advances": 0,
                                    "reconverge_rounds": 12,
                                    "reconverge_bound": 9}]}],
    "suspicion_fpr": [artifact("SUSPECT_r08.json")],
    "rr_row_budget": [
        ladder([(65_536, 1024, True, 5), (524_288, 512, True, 9)]),
        ladder([(65_536, 1024, True, 11), (524_288, 512, True, 9)]),
        ladder([(65_536, 1024, True, 5), (393_216, 512, True, 9)]),
        ladder([(524_288, 1024, True, 9)])],
    "fastpath_parity": [
        {"all_equal": True, "total_suspects": 4, "total_refutations": 2},
        {"all_equal": True, "total_suspects": 4, "total_refutations": 0},
        {"all_equal": False, "total_suspects": 4, "total_refutations": 2}],
    "trace_invariants": [{"ok": True}, {"ok": False}],
    "monitor_parity": [
        {"ok": True, "monitor_parity": True, "monitor_violations": 0},
        {"ok": True, "monitor_parity": True, "monitor_violations": 1},
        {"ok": True, "monitor_parity": False, "monitor_violations": 0}],
    "outage_absorption": [{"absorbed": True}, {"absorbed": False}],
    "native_cohort": [{"reproduced": True}, {"reproduced": False}],
    "delta_cohort": [{"ok": True}, {"ok": False}],
    "spec_clean": [{"ok": True}, {"ok": False}],
    "spec_conformance": [{"ok": True, "coverage_complete": True},
                         {"ok": True, "coverage_complete": False}],
    "erasure_durability": [artifact("ERASURE_r18.json"),
                           erasure(losses_total=1),
                           erasure(matches_all=False)],
    "traffic_durability": [traffic(), traffic(match=False),
                           traffic(monitor={"ok": True,
                                            "match_events": False})],
}


def test_every_claim_has_a_twin():
    assert list(TWINS) == list(REF)
    assert set(DOCS) == set(REF)


@pytest.mark.parametrize("name", list(REF))
def test_no_twin_runs_the_jax_package_or_its_tools(name):
    cmd = " ".join(TWINS[name][0])
    assert "gossipfs_tpu." not in cmd and "tools/" not in cmd
    assert "gossipfs_tpu_torch." in cmd
    if "spec_verify" not in cmd:
        assert cmd.endswith("--device cpu")


@pytest.mark.parametrize("name", list(REF))
def test_twin_extractor_equals_the_jax_tools(name):
    for doc in DOCS[name]:
        assert TWINS[name][1](doc) == REF[name][1](doc), doc


def test_row_budget_holds_the_ports_admission():
    """A row refused for its bytes (the port's (786,432, 16)) keeps the
    claim true; the JAX claim wanted every row admitted."""
    doc = ladder([(524_288, 512, True, 9), (786_432, 512, False, 11)])
    assert TWINS["rr_row_budget"][1](doc) == 1.0
    assert REF["rr_row_budget"][1](doc) == 0.0


@pytest.mark.parametrize("name", list(REF))
def test_no_claimed_value_is_a_tpu_figure(name):
    _, _, want, tol, source = TWINS[name]
    ref_want = REF[name][2]
    if ref_want == 1.0 and REF[name][3] == 0.0:
        assert (want, tol, source) == (1.0, 0.0, "a predicate")
    elif want is None:
        assert source is None
    else:
        assert want != ref_want and "PERF.md" in source and tol == 0.3


def test_unmeasured_claims_print_measured_and_errors_fail(monkeypatch):
    claim = (["true"], lambda d: 5.0, None, 0.3, None)
    row = vc.verify("anchor_98304", claim)
    assert row["result"] == "FAIL" and row["measured"].startswith("ERROR")
    monkeypatch.setattr(vc, "run_json", lambda cmd: {})
    row = vc.verify("anchor_98304", claim)
    assert row == {"claim": "anchor_98304", "claimed": None, "measured": 5.0,
                   "tolerance": 0.3, "result": "MEASURED", "source": None}


def test_one_claim_end_to_end_on_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = vc.main(["--device", "cpu", "--only", "rr_row_budget"])
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0 and rows[-1] == {"all_pass": True}
    assert rows[0]["claim"] == "rr_row_budget"
    assert rows[0]["result"] == "PASS" and rows[0]["measured"] == 1.0


def test_the_card_is_the_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        vc.main(["--only", "spec_clean"])
