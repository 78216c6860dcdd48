"""The port's campaign driver (tensor replay) against the JAX package's.

* ``run_case`` of the three gossip regression cases gives the JAX
  replay's whole result: verdict, ``by_invariant`` counts, estimators,
  violations and the violating event window;
* ``sweep_axis`` and ``bisect_axis`` (with their ledgers) and a small
  ``knob_surface`` equal the JAX package's;
* the scenario families, the campaign profile, the monitor knobs and the
  case files are the JAX package's; the traffic-plane case replays (and
  one whose expectation the run does not meet is refused: not
  reproduced).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import pytest
import torch

from gossipfs_tpu.campaigns import driver as jdrv
from gossipfs_tpu_torch.campaigns import driver as tdrv

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CASES = ("flap_storm_n256", "outage_storm_n256", "outage_absorbed_n256")


@pytest.mark.parametrize("case", CASES)
def test_regression_case_matches_jax(case):
    path = REPO / "regressions" / f"{case}.json"
    want = jdrv.run_case(path)
    got = tdrv.run_case(path, device="cpu")
    assert got == want
    assert got["reproduced"]


def test_sweep_axis_matches_jax():
    want = jdrv.sweep_axis("flap", 64, (2,))
    got = tdrv.sweep_axis("flap", 64, (2,), device="cpu")
    assert got == want and got["breaking"] == []


def test_bisect_axis_and_ledger_match_jax(tmp_path):
    out = {}
    for side, mod, kw in (("jax", jdrv, {}), ("torch", tdrv,
                                              {"device": "cpu"})):
        path = tmp_path / f"{side}.jsonl"
        ledger = mod.CampaignLedger(path, "flap", 64, "down")
        out[side] = mod.bisect_axis("flap", 64, 1, 6, ledger=ledger, **kw)
        ledger.close()
    assert out["torch"] == out["jax"]
    assert out["torch"]["breaking_point"] == 3
    assert ((tmp_path / "torch.jsonl").read_bytes()
            == (tmp_path / "jax.jsonl").read_bytes())


def test_knob_surface_matches_jax():
    kw = dict(rounds=30)
    want = jdrv.knob_surface(64, (4,), ((1, 0.25),), **kw)
    got = tdrv.knob_surface(64, (4,), ((1, 0.25),), device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("family", sorted(jdrv.FAMILIES))
def test_families_and_profile_match_jax(family):
    assert tdrv.FAMILIES == jdrv.FAMILIES
    avoid = {0, 3, 9}
    assert (tdrv.make_scenario(family, 64, 20, avoid=avoid).to_json()
            == jdrv.make_scenario(family, 64, 20, avoid=avoid).to_json())
    for t_suspect, lh in ((0, 0), (2, 1)):
        tcfg = tdrv.campaign_config(64, t_fail=3, t_suspect=t_suspect,
                                    lh_multiplier=lh)
        jcfg = jdrv.campaign_config(64, t_fail=3, t_suspect=t_suspect,
                                    lh_multiplier=lh)
        tfields = dataclasses.asdict(tcfg)
        assert {k: v for k, v in dataclasses.asdict(jcfg).items()
                if k in tfields} == tfields
        assert (dataclasses.asdict(tdrv.default_monitor_params(tcfg, 17))
                == dataclasses.asdict(jdrv.default_monitor_params(jcfg, 17)))
    assert tdrv.campaign_rounds(20, 10, 9) == jdrv.campaign_rounds(20, 10, 9)
    with pytest.raises(ValueError, match="requires the SWIM lifecycle"):
        tdrv.campaign_config(64, lh_multiplier=1)


def test_case_files_match_jax(tmp_path):
    sc = {m: m.make_scenario("outage", 64, 10, size=4)
          for m in (tdrv, jdrv)}
    for m in (tdrv, jdrv):
        m.write_case(tmp_path / f"{m.__name__}.json", sc[m], t_fail=5,
                     t_suspect=0, seed=0, track=4,
                     params=m.MonitorParams(reconverge_bound=9),
                     expect={"verdict": "violated",
                             "invariants": ["fpr_storm"]})
    paths = [tmp_path / f"{m.__name__}.json" for m in (tdrv, jdrv)]
    assert paths[0].read_bytes() == paths[1].read_bytes()
    doc = tdrv.load_case(paths[0])
    row = {"verdict": "violated", "monitor": {"by_invariant": {
        "fpr_storm": 1}}}
    assert tdrv.case_verdict_ok(row, doc["expect"])
    assert not tdrv.case_verdict_ok(dict(row, verdict="pass"),
                                    doc["expect"])
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"schema": "other"}))
    with pytest.raises(ValueError, match="not a"):
        tdrv.load_case(bad)


def test_traffic_case_is_refused():
    """The traffic-plane case replays on the port's co-sim (its result
    equal to the JAX replay's); a copy of it that expects a violation is
    refused by both replays alike (not reproduced)."""
    doc = tdrv.load_case(REPO / "regressions" / "stripe_rackkill_n256.json")
    got = tdrv.run_case_doc(doc, device="cpu")
    assert got == jdrv.run_case_doc(doc)
    assert got["reproduced"] and got["row"]["verdict"] == "pass"
    wrong = dict(doc, expect={"verdict": "violated", "lost": 1})
    got = tdrv.run_case_doc(wrong, device="cpu")
    assert not got["reproduced"]
    assert got == jdrv.run_case_doc(wrong)