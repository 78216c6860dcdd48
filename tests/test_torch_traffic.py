"""The port's traffic plane (``traffic/workload.py``, ``traffic/harness.py``,
``traffic_bench.py``, ``sdfs_ops.py``) and the traffic campaign case
against the JAX package's, on the CPU.

* the workload generator is a copy: op streams, payloads and digests;
  ``drive_shim`` makes the JAX package's calls on a stub client;
* the harness's four runs (steady state, churn, partition race, repair
  storm) and the bench's cosim lane and erasure matrix give the JAX
  package's documents, timing fields aside: every count, repair curve,
  byte counter and durability triple, every ``match`` true, nothing lost;
* ``campaigns.run_case`` on ``regressions/stripe_rackkill_n256.json``
  gives the JAX replay's result (verdict ``pass``, lost 0);
* ``sdfs_ops`` gives the JAX rows, latencies aside;
* the bench's CLI prints its document and refuses the card without one.
"""

from __future__ import annotations

import json
import pathlib

import pytest
import torch

from gossipfs_tpu.bench import sdfs_ops as jops
from gossipfs_tpu.bench import traffic_bench as jbench
from gossipfs_tpu.campaigns import driver as jdrv
from gossipfs_tpu.traffic import harness as jh
from gossipfs_tpu.traffic import workload as jwl
from gossipfs_tpu_torch import sdfs_ops as tops
from gossipfs_tpu_torch import traffic_bench as tbench
from gossipfs_tpu_torch.campaigns import driver as tdrv
from gossipfs_tpu_torch.traffic import harness as th
from gossipfs_tpu_torch.traffic import workload as twl

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def strip(doc):
    """Drop wall-clock fields (``*_ms``) everywhere in a document."""
    if isinstance(doc, dict):
        return {k: strip(v) for k, v in doc.items()
                if not k.endswith("_ms")}
    if isinstance(doc, list):
        return [strip(v) for v in doc]
    return doc


def test_workload_is_a_copy():
    kw = dict(rate=5.5, n_keys=20, seed=4, put_frac=0.4, delete_frac=0.1)
    jw, tw = jwl.Workload(jwl.WorkloadSpec(**kw)), \
        twl.Workload(twl.WorkloadSpec(**kw))
    for r in range(12):
        assert [(o.kind, o.key, o.size) for o in tw.ops(r)] == \
            [(o.kind, o.key, o.size) for o in jw.ops(r)]
        assert tw.payload("f1.txt", r, 70_000) == \
            jw.payload("f1.txt", r, 70_000)
    assert twl.payload_digest(b"abc") == jwl.payload_digest(b"abc")
    assert twl.quantiles([3.0, 1.0, 2.0]) == jwl.quantiles([3.0, 1.0, 2.0])
    with pytest.raises(ValueError):
        twl.WorkloadSpec(redundancy="mirror")
    calls = {}
    for name, mod, wl in (("jax", jwl, jw), ("port", twl, tw)):
        stub = StubClient()
        doc = mod.drive_shim(stub, wl, 3, start_round=2)
        calls[name] = (stub.calls, {k: v for k, v in doc.items()
                                    if k != "by_op"})
    assert calls["port"] == calls["jax"]
    assert calls["port"][1]["rounds"] == 3


class StubClient:
    """Records each shim call; puts and deletes succeed, gets find."""

    def __init__(self):
        self.calls = []
        self.round = 2

    def call(self, method, **req):
        self.calls.append((method, sorted(req.items())))
        if method == "Advance":
            self.round += req["rounds"]
            return {"round": self.round}
        return {"ok": True, "found": True}


SPEC = dict(rate=4.0, n_keys=16, put_frac=0.5)


@pytest.mark.parametrize("redundancy", ["replica", "stripe"])
def test_harness_runs_match_jax(redundancy):
    spec_kw = dict(SPEC, redundancy=redundancy)
    runs = (
        lambda m, w, **kw: m.steady_state(16, 8, w(**spec_kw), **kw),
        lambda m, w, **kw: m.churn(24, 10, w(**spec_kw), crashes=3, **kw),
        lambda m, w, **kw: m.partition_race(32, w(**spec_kw), split_rounds=14,
                                            rounds_each=4, **kw),
        lambda m, w, **kw: m.repair_storm(
            32, w(**dict(spec_kw, payload_cap=4096)), files=24, rack=(8, 8),
            repair_budget=4, **kw),
    )
    for run in runs:
        want = run(jh, jwl.WorkloadSpec)
        got = run(th, twl.WorkloadSpec, device="cpu")
        assert strip(got) == strip(want)
        d = got["durability"]
        assert d["match"] and d["monitor"]["match_events"]
        assert d["harness"]["lost"] == 0


def test_cosim_lane_and_erasure_matrix_match_jax():
    want = jbench.cosim_lane(32, 12, 4.0, 1, only="churn")
    got = tbench.cosim_lane(32, 12, 4.0, 1, only="churn", device="cpu")
    assert strip(got) == strip(want)
    want = jbench.erasure_matrix(32, 12, 4.0, 0)
    got = tbench.erasure_matrix(32, 12, 4.0, 0, device="cpu")
    assert strip(got) == strip(want)
    assert got["matches_all"] and got["losses_total"] == 0
    assert got["repair_bandwidth"]["per_unit_ratio"] is not None


def test_traffic_campaign_case_matches_jax():
    path = REPO / "regressions" / "stripe_rackkill_n256.json"
    want = jdrv.run_case(path)
    got = tdrv.run_case(path, device="cpu")
    assert strip(got) == strip(want)
    assert got["reproduced"] and got["row"]["verdict"] == "pass"
    assert got["row"]["lost"] == 0


def test_sdfs_ops_rows_match_jax():
    kw = dict(sizes=(4096, 65_536), reps=1)
    latency = ("insert_ms", "update_ms", "read_ms")
    for red in ("replica", "stripe"):
        want = jops.run(redundancy=red, **kw)
        got = tops.run(redundancy=red, **kw)
        assert [{k: v for k, v in r.items() if k not in latency}
                for r in got["rows"]] == \
            [{k: v for k, v in r.items() if k not in latency}
             for r in want["rows"]]
        assert set(got["reference_claims_reproduced"]) == \
            set(want["reference_claims_reproduced"])


def test_bench_cli(tmp_path, capsys):
    out = tmp_path / "t.json"
    doc = tbench.main(["--scale", "--scale-n", "2048", "--scale-files",
                       "64", "--scale-budget", "128", "--device", "cpu",
                       "--out", str(out)])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(out.read_text()) == \
        json.loads(json.dumps(doc))
    assert doc["device"] == "cpu" and doc["scale"]["n"] == 2048
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA device"):
            tbench.main(["--steady"])
