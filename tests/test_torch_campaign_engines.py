"""The port's socket-engine campaign plumbing against the JAX package's
(``gossipfs_tpu_torch/campaigns/engines.py``), deterministic parts only.

* ``scale_case`` of every campaign-generated committed case at n = 8, 24
  and 64, and ``_case_plan`` of every committed and rescaled case, equal
  the JAX package's;
* ``verdict_agreement`` over the committed replays and doctored engine
  rows, ``_wire_delta``, and the engines' default periods
  (``udp_period``, ``native_period``, the conformance
  ``udp_case_period``) equal the JAX package's;
* ``run_case_engine(..., engine="tensor", device="cpu")`` gives the JAX
  package's result on each committed gossip case the driver test does
  not already replay, and on a rescaled case.

Socket runs are wall-clock and are not compared bit for bit: their
verdicts are held in ``test_torch_socket_engines.py`` and the slow lane.
"""

from __future__ import annotations

import copy
import json
import pathlib

import pytest
import torch

from gossipfs_tpu.campaigns import engines as jeng
from gossipfs_tpu.conformance import harness as jharness
from gossipfs_tpu_torch import campaigns
from gossipfs_tpu_torch.campaigns import driver as tdrv
from gossipfs_tpu_torch.campaigns import engines as teng
from gossipfs_tpu_torch.conformance import harness

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
GOSSIP_CASES = sorted(
    p.stem for p in (REPO / "regressions").glob("*.json")
    if json.loads(p.read_text()).get("schema")
    == "gossipfs-campaign-case/v1"
    and json.loads(p.read_text())["family"] != "rack_kill")


def _doc(case: str) -> dict:
    return tdrv.load_case(REPO / "regressions" / f"{case}.json")


def _plan(plan) -> tuple:
    n, sc, crash_at, rounds, victims = plan
    return n, sc.to_json(), crash_at, rounds, list(victims)


def test_gossip_cases():
    assert GOSSIP_CASES == [
        "flap_storm_n256", "outage_absorbed_n256", "outage_absorbed_udp_n64",
        "outage_mild_delta_native_n1024", "outage_mild_delta_udp_n24",
        "outage_mild_udp_n24", "outage_storm_n256"]
    assert teng.ENGINES == jeng.ENGINES


@pytest.mark.parametrize("n", [8, 24, 64])
@pytest.mark.parametrize("case", GOSSIP_CASES)
def test_scale_case_and_plan_match_jax(case, n):
    doc = _doc(case)
    got = teng.scale_case(copy.deepcopy(doc), n)
    want = jeng.scale_case(copy.deepcopy(doc), n)
    assert got == want
    assert got["config"]["n"] == n and got["scaled_from"] == doc["config"]["n"]
    assert _plan(teng._case_plan(got)) == _plan(jeng._case_plan(want))


@pytest.mark.parametrize("case", GOSSIP_CASES)
def test_committed_case_plan_matches_jax(case):
    doc = _doc(case)
    assert _plan(teng._case_plan(doc)) == _plan(jeng._case_plan(doc))
    assert teng._wire_knobs(doc["config"]) == jeng._wire_knobs(doc["config"])
    sus, jsus = (teng._suspicion_params(doc["config"]),
                 jeng._suspicion_params(doc["config"]))
    assert (sus is None) == (jsus is None)
    if sus is not None:
        assert sus.to_json() == jsus.to_json()


def test_scale_case_refuses_hand_written_docs():
    with pytest.raises(ValueError) as want:
        jeng.scale_case({"config": {"n": 8}}, 4)
    with pytest.raises(ValueError) as got:
        teng.scale_case({"config": {"n": 8}}, 4)
    assert str(got.value) == str(want.value)


def _engine_rows(tensor_row: dict) -> list[dict]:
    """Doctored engine rows: equal, one invariant flipped, fpr_storm
    unobservable (no round ticks), an extra invariant the tensor run
    did not check."""
    same = copy.deepcopy(tensor_row)
    flipped = copy.deepcopy(tensor_row)
    checked = flipped["monitor"]["invariants_checked"]
    inv = checked[0]
    by = flipped["monitor"]["by_invariant"]
    if by.get(inv):
        by.pop(inv)
    else:
        by[inv] = 3
    no_ticks = copy.deepcopy(flipped)
    no_ticks["observed_round_ticks"] = 0
    extra = copy.deepcopy(tensor_row)
    extra["monitor"]["invariants_checked"] = checked + ["made_up"]
    extra["monitor"]["by_invariant"]["made_up"] = 1
    return [same, flipped, no_ticks, extra]


@pytest.mark.parametrize("case", ["flap_storm_n256", "outage_mild_udp_n24"])
def test_verdict_agreement_matches_jax(case):
    tensor = tdrv.run_case(REPO / "regressions" / f"{case}.json",
                           device="cpu")["row"]
    for row in _engine_rows(tensor):
        got = teng.verdict_agreement(tensor, row)
        assert got == jeng.verdict_agreement(tensor, row)
    assert teng.verdict_agreement(tensor, tensor)["match"]
    assert not teng.verdict_agreement(tensor, _engine_rows(tensor)[1])[
        "match"]


def test_wire_delta_and_periods_match_jax():
    v0 = {"bytes_sent": 100, "frames_full": 3, "frames_delta": 1}
    v1 = {"bytes_sent": 9_100, "frames_full": 40, "frames_delta": 77}
    for rounds in (0, 1, 24):
        assert teng._wire_delta(v0, v1, rounds) == \
            jeng._wire_delta(v0, v1, rounds)
    for n in (4, 8, 10, 24, 32, 64, 256, 512, 1024, 4096):
        assert teng.udp_period(n) == jeng.udp_period(n)
        assert teng.native_period(n) == jeng.native_period(n)
        assert harness.udp_case_period(n) == jharness.udp_case_period(n)


@pytest.mark.parametrize("case", [
    "outage_absorbed_udp_n64", "outage_mild_delta_native_n1024",
    "outage_mild_delta_udp_n24", "outage_mild_udp_n24"])
def test_tensor_engine_rows_match_jax(case):
    path = REPO / "regressions" / f"{case}.json"
    got = campaigns.run_case_engine(path, engine="tensor", device="cpu")
    assert got == jeng.run_case_engine(path, engine="tensor")
    assert got["reproduced"] and got["engine"] == "tensor"


def test_tensor_engine_rescaled_row_matches_jax():
    path = REPO / "regressions" / "flap_storm_n256.json"
    got = campaigns.run_case_engine(path, engine="tensor", scale_n=24,
                                    device="cpu")
    assert got == jeng.run_case_engine(path, engine="tensor", scale_n=24)
    assert got["n"] == 24


def test_run_case_engine_refuses_an_unknown_engine():
    with pytest.raises(ValueError) as want:
        jeng.run_case_engine("x.json", engine="carrier-pigeon")
    with pytest.raises(ValueError) as got:
        teng.run_case_engine("x.json", engine="carrier-pigeon",
                             device="cpu")
    assert str(got.value) == str(want.value)
